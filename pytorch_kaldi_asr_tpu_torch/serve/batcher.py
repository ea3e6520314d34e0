"""Request coalescing (the port's ``MicroBatcher`` of
``pytorch_kaldi_asr_tpu.recipes.serve``): concurrent ``/recognize`` calls
that arrive within ``window_ms`` of the first ride one batched search of
``max_batch`` rows (padded rows masked out) instead of queueing one by one;
the shapes stay (max_batch, bucket), one per bucket, warmed like the
single ones.  Works over either recognizer (in hybrid mode the AM forward
batches and the graph searches stay per utterance)."""

from __future__ import annotations

import queue
import threading
import time


class MicroBatcher:
    def __init__(self, recognizer, *, max_batch=8, window_ms=5.0):
        self.rec = recognizer
        self.max_batch = max_batch
        self.window_s = window_ms / 1e3
        self._q = queue.Queue()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def warmup(self):
        # only the (max_batch, bucket) shapes: every request through the
        # batcher takes batch_pad=max_batch
        self.rec.warmup_batched(self.max_batch)

    def _run(self):
        while True:
            first = self._q.get()
            group = [first]
            deadline = time.time() + self.window_s
            while len(group) < self.max_batch:
                timeout = deadline - time.time()
                if timeout <= 0:
                    break
                try:
                    group.append(self._q.get(timeout=timeout))
                except queue.Empty:
                    break
            try:
                feats = [g["feats"] for g in group]
                nbest = max(g["nbest"] for g in group)
                outs, decoded = self.rec.recognize_many(
                    feats, nbest=nbest, batch_pad=self.max_batch)
                for g, out, d in zip(group, outs, decoded):
                    g["result"] = (out[:g["nbest"]], d)
                    g["event"].set()
            except Exception as e:  # noqa: BLE001 — fail the whole group
                for g in group:
                    g["error"] = e
                    g["event"].set()

    def recognize(self, feats, nbest=1):
        """Recognizer.recognize's contract; blocks until the batch holding
        this request is done."""
        # validated here, in the request's thread: a malformed request
        # raises to its own caller, never fails the coalesced group
        entry = {"feats": self.rec.check_features(feats), "nbest": nbest,
                 "event": threading.Event()}
        self._q.put(entry)
        entry["event"].wait()
        if "error" in entry:
            raise entry["error"]
        return entry["result"]

    def reload(self, model_file=None):
        # batches in flight finish on the old weights (the recognizer's
        # lock orders the swap); queued ones take the new ones
        return self.rec.reload(model_file)

    def __getattr__(self, name):
        # everything else the HTTP layer reads (cfg, buckets, beam sizes,
        # check_features, new_stream, ...) is the recognizer's: the
        # batcher only takes the offline recognize path
        rec = self.__dict__.get("rec")
        if rec is None:
            raise AttributeError(name)
        return getattr(rec, name)
