"""Incremental partial hypotheses for attention-mode streaming sessions (the
port's ``_AttentionStream`` of ``pytorch_kaldi_asr_tpu.recipes.serve``).

A carried streaming encoder (models/streaming.py, exact against the
offline encoder) grows the session's cross-attention memory chunk by
chunk, and each partial restarts the KV-cached beam from the previous
partial's stable prefix (decode/fast_beam.fast_beam_search_memory with a
forced prefix): each frame is encoded once, and the forced prefix skips
the beam bookkeeping of tokens that have converged.  ``finish`` does not
come here: the server decodes the whole audio offline, as the decode CLI
would.

Three things differ from the JAX package's class, on purpose (ROADMAP.md,
"Deliberate differences"):

- **The memory is capped.**  Its capacity doubles from ``MEM_PAD`` up to
  ``encoder_max_len`` rounded up to a power of two from ``MEM_PAD``, and
  no frame past ``encoder_max_len`` is encoded or appended; from then on
  ``truncated`` is set and the server's partial carries ``"truncated":
  true``, as ``/recognize`` does for audio past its largest bucket.  (JAX's
  memory doubles without a bound.)
- **The catch-up runs under the session's lock.**  :meth:`feed` pushes the
  accumulated audio the encoder has not seen under this session's own
  lock; only the memory search of :meth:`partial` takes the recognizer's
  lock.  (JAX runs both under the recognizer's.)  The parameters are
  pinned when the stream is made, so a session finishes its partials on
  the model it started with across a ``/reload``.
- **The server feeds the stream from the session's first partial push**
  (serve/http.py), while the dispatch stays JAX's: re-decode while the
  audio fits the largest bucket, the incremental stream past it.  The
  partials are JAX's, and the push that crosses over pays no catch-up.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from pytorch_kaldi_asr_tpu_torch.decode.fast_beam import fast_beam_search_memory
from pytorch_kaldi_asr_tpu_torch.decode.runner import (
    ids_to_words,
    nbest_from_result,
)


class _AttentionStream:
    PREFIX_QUANT = 32   # forced-prefix lengths: multiples of this
    STABLE_TAIL = 2     # a partial's last tokens may flip; never force them
    MEM_PAD = 128       # memory capacity quantum (doubles from here)

    def __init__(self, recognizer, frontend, params):
        self.rec = recognizer
        self.frontend = frontend
        self.params = params  # pinned: a /reload does not reach a session
        self.lock = threading.Lock()  # this session's
        self.max_frames = recognizer.cfg.encoder_max_len
        self.max_capacity = self.MEM_PAD
        while self.max_capacity < self.max_frames:
            self.max_capacity *= 2
        self.frames = 0          # frames already fed to the frontend
        self.truncated = False   # audio past max_frames was not encoded
        self._mem = None         # [1, capacity, d] memory on the device
        self._mem_t = 0          # valid frames in _mem
        self._prev_ids = []      # previous partial's token ids (no BOS/EOS)

    def _append_mem(self, emit):
        """Append an encoder chunk [1, t, d], doubling the capacity from
        MEM_PAD as needed (never past ``max_capacity``: at most
        ``max_frames`` frames are kept)."""
        emit = emit[:, :self.max_frames - self._mem_t]
        t_new = self._mem_t + emit.shape[1]
        cap = 0 if self._mem is None else self._mem.shape[1]
        if t_new > cap:
            new_cap = self.MEM_PAD
            while new_cap < t_new:
                new_cap *= 2
            buf = emit.new_zeros((1, new_cap, emit.shape[2]))
            if self._mem is not None:
                buf[:, :self._mem_t] = self._mem[:, :self._mem_t]
            self._mem = buf
        self._mem[:, self._mem_t:t_new] = emit
        self._mem_t = t_new

    def feed(self, chunks):
        """Push the frames of ``chunks`` (the session's whole chunk list)
        that the encoder has not seen yet, up to ``max_frames``, under this
        session's lock."""
        with self.lock:
            total = sum(c.shape[0] for c in chunks)
            if total > self.max_frames:
                self.truncated = True
            end = min(total, self.max_frames)
            if end <= self.frames:
                return
            acc = np.concatenate(chunks, axis=0)[self.frames:end]
            emit = self.frontend.push(acc[None].astype(np.float32))
            self.frames = end
            if emit is not None:
                self._append_mem(emit)

    def partial(self):
        """The running hypothesis over the memory so far, or None when the
        encoder has emitted nothing yet (the server then re-decodes).  The
        text lags the audio by up to the re-chunk size (the carried
        remainder is not flushed mid-stream)."""
        with self.lock:
            if self._mem_t == 0:
                return None
            enc, t = self._mem, self._mem_t
            mask = torch.zeros((1, enc.shape[1]), device=enc.device)
            mask[0, :t] = 1.0
            max_len = self.rec.max_len
            p = len(self._prev_ids) - self.STABLE_TAIL
            p = max(0, min(p, max_len - self.PREFIX_QUANT))
            p -= p % self.PREFIX_QUANT
            prefix = torch.tensor([self._prev_ids[:p]], dtype=torch.int64)
            with self.rec.lock:  # the device's searches, one at a time
                result = fast_beam_search_memory(
                    self.params, self.rec.cfg, enc, mask, prefix,
                    beam_size=self.rec.partial_beam, max_len=max_len)
            hyps = nbest_from_result(result, 1)[0]
            if not hyps:
                self._prev_ids = []
                return ""
            seq, _score = hyps[0]
            self._prev_ids = [int(x) for x in seq[1:-1]]
            return " ".join(ids_to_words(self._prev_ids, self.rec.idx2word))

    def sync(self, chunks):
        """:meth:`feed` then :meth:`partial` (the JAX class's one call)."""
        self.feed(chunks)
        return self.partial()
