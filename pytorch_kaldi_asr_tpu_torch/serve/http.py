"""The recognition server's HTTP surface (the port's ``make_handler``,
``serve`` and ``_features_from_request`` of
``pytorch_kaldi_asr_tpu.recipes.serve``; stdlib ``http.server``, the JSON
shapes of docs/SERVING.md):

- ``POST /recognize``: JSON ``{"features": [[...], ...], "nbest": k}`` (a
  frames x dim matrix) or WAV bytes with ``Content-Type: audio/wav`` (fbank
  of ``src_dim`` bins on the recognizer's device, tools/fbank.py) →
  ``{"nbest": [{"text", "score"}], "frames", "latency_ms"}``, with
  ``"truncated": true`` when the audio ran past the largest bucket.
- ``POST /stream/start`` → ``{"id"}``; ``POST /stream/<id>/push`` with
  ``{"features": [...], "partial": true}``; ``POST /stream/<id>/finish``
  → the final n-best of the whole audio.  Attention mode: a partial is a
  re-decode of the audio while it fits the largest bucket, past it the
  session's incremental stream (serve/attention_stream.py), which is fed
  from the session's first partial push.  Hybrid mode: every push returns
  the live partial of the carried-token decoder.
- ``POST /reload`` with ``{"model_file"}`` (optional): hot swap of weights
  of the same configuration; another configuration is a 400 and the old
  weights keep serving.
- ``GET /healthz``: status, mode, model, buckets, beam, request counters
  and the latency histogram with p50/p95/p99; in hybrid mode the graph
  searches, with ``"native": true`` (the graph search runs in the port's
  native C++ core, decode/latgen.py).
"""

from __future__ import annotations

import json
import os
import signal
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from pytorch_kaldi_asr_tpu_torch.serve.sessions import (
    ServerStats,
    SessionStore,
)
from pytorch_kaldi_asr_tpu_torch.utils.logging import info


def _features_from_request(body, content_type, src_dim, device="cuda"):
    """JSON feature matrix or WAV bytes → ([T, D] features, payload)."""
    if content_type.startswith("audio/"):
        from pytorch_kaldi_asr_tpu_torch.tools.fbank import (
            FbankConfig,
            compute_fbank,
        )
        from pytorch_kaldi_asr_tpu_torch.tools.wav import read_wav

        fd, path = tempfile.mkstemp(suffix=".wav")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(body)
            samples, rate = read_wav(path)
        finally:
            os.unlink(path)
        if samples.ndim > 1:
            samples = samples[:, 0]
        cfg = FbankConfig(sample_rate=rate, num_bins=src_dim)
        return np.asarray(compute_fbank(samples, cfg, device=device)), {}
    payload = json.loads(body.decode("utf-8"))
    return np.asarray(payload["features"], np.float32), payload


def _is_hybrid(recognizer):
    return hasattr(recognizer, "new_stream")


def make_handler(recognizer, sessions=None, stats=None):
    sessions = sessions if sessions is not None else SessionStore()
    stats = stats if stats is not None else ServerStats()
    device = str(recognizer.device)

    class Handler(BaseHTTPRequestHandler):
        def handle(self):
            # in flight for the whole connection, so the SIGTERM drain
            # cannot end while an accepted request is served
            stats.enter()
            try:
                super().handle()
            finally:
                stats.leave()

        def _send(self, code, obj):
            data = json.dumps(obj).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, fmt, *args):
            info("http: " + fmt, *args)

        def do_GET(self):
            if self.path != "/healthz":
                self._send(404, {"error": "unknown path"})
                return
            out = {
                "status": "ok",
                "mode": "hybrid" if _is_hybrid(recognizer) else "attention",
                "encoder_type": recognizer.cfg.encoder_type,
                "src_dim": recognizer.cfg.src_dim,
                "model_file": recognizer.model_file,
                "buckets": list(recognizer.buckets),
            }
            if _is_hybrid(recognizer):
                out["beam"] = recognizer.beam
                with recognizer._search_lock:
                    n = recognizer.graph_searches
                    ms = recognizer.graph_search_ms_total
                out["graph_search"] = {
                    "native": True,
                    "decode_workers": recognizer.decode_workers,
                    "searches": n,
                    "mean_ms": round(ms / n, 3) if n else None,
                }
            else:
                out["beam_size"] = recognizer.beam_size
                out["vocab_size"] = recognizer.cfg.vocab_size
            out["stats"] = stats.summary()
            self._send(200, out)

        def _read_body(self):
            length = int(self.headers.get("Content-Length", "0"))
            return self.rfile.read(length)

        def _features(self, body):
            ctype = self.headers.get("Content-Type", "application/json")
            return _features_from_request(body, ctype,
                                          recognizer.cfg.src_dim, device)

        def do_POST(self):
            # handlers return (code, payload, verdict); the stats are
            # recorded before the response goes out, so a client's next
            # request sees them
            t0 = time.time()
            try:
                if self.path == "/recognize":
                    code, out, verdict = self._recognize()
                elif self.path == "/reload":
                    code, out, verdict = self._reload()
                elif self.path == "/stream/start":
                    code, out, verdict = 200, {"id": sessions.start()}, "ok"
                elif self.path.startswith("/stream/"):
                    code, out, verdict = self._stream()
                else:
                    code, out, verdict = 404, {"error": "unknown path"}, None
            except Exception as e:  # noqa: BLE001 — the server must not die
                code, out, verdict = 400, {"error": repr(e)[:500]}, None
            # "decode": a latency sample; "ok": a plain request; None: an
            # error (404/410/exception)
            if verdict == "decode":
                stats.record(decode_ms=(time.time() - t0) * 1e3)
            elif verdict == "ok":
                stats.record()
            else:
                stats.record(error=True)
            self._send(code, out)

        def _recognize(self):
            feats, payload = self._features(self._read_body())
            nbest = int(payload.get("nbest", 1))
            t0 = time.time()
            hyps, decoded = recognizer.recognize(feats, nbest=nbest)
            out = {
                "nbest": [{"text": t, "score": s} for t, s in hyps],
                "frames": decoded,
                "latency_ms": round((time.time() - t0) * 1e3, 1),
            }
            if decoded < np.asarray(feats).shape[0]:
                out["truncated"] = True  # past the largest bucket
            return 200, out, "decode"

        def _reload(self):
            body = self._read_body()
            payload = json.loads(body.decode("utf-8")) if body else {}
            try:
                meta = recognizer.reload(payload.get("model_file"))
            except (ValueError, OSError) as e:
                return 400, {"error": str(e)[:500]}, None
            return 200, {"status": "reloaded",
                         "model_file": recognizer.model_file,
                         "epoch": meta.get("epoch"),
                         "step": meta.get("step")}, "ok"

        def _stream(self):
            parts = self.path.split("/")  # ['', 'stream', sid, verb]
            if len(parts) != 4 or parts[3] not in ("push", "finish"):
                return 404, {"error": "unknown stream path"}, None
            sid, verb = parts[2], parts[3]
            if _is_hybrid(recognizer):
                return self._stream_hybrid(sid, verb)
            if verb == "push":
                return self._push(sid)
            return self._finish(sid)

        def _push(self, sid):
            feats, payload = self._features(self._read_body())
            # validated before it is kept: a bad chunk must not poison the
            # session's audio
            feats = recognizer.check_features(feats)
            frames = sessions.append(sid, feats)
            if frames is None:
                return 404, {"error": f"no session {sid}"}, None
            out = {"frames": frames}
            if not payload.get("partial"):
                return 200, out, "ok"
            chunks = sessions.snapshot(sid)
            if not chunks:
                return 200, out, "ok"
            total = sum(c.shape[0] for c in chunks)
            # fed on every partial push, under the session's own lock, so
            # the push that crosses past the largest bucket pays no
            # catch-up
            astream = sessions.get_astream(sid,
                                           recognizer.new_attention_stream)
            if astream is not None:
                astream.feed(chunks)
            partial = None
            if total > max(recognizer.buckets) and astream is not None:
                partial = astream.partial()
                if astream.truncated:
                    out["truncated"] = True
            if partial is None:
                # a re-decode of the audio: flat in the session's age while
                # it fits the largest bucket
                hyps, decoded = recognizer.recognize(
                    np.concatenate(chunks, axis=0), nbest=1)
                partial = hyps[0][0] if hyps else ""
                if decoded < total:
                    out["truncated"] = True
            out["partial"] = partial
            return 200, out, "decode"

        def _finish(self, sid):
            # decode from a snapshot first, pop only after success, so a
            # failed decode leaves the session retryable
            chunks = sessions.snapshot(sid)
            if chunks is None:
                return 404, {"error": f"no session {sid}"}, None
            if not chunks:
                sessions.finish(sid)
                return 200, {"nbest": [], "frames": 0}, "ok"
            body = self._read_body()
            payload = json.loads(body.decode("utf-8")) if body else {}
            acc = np.concatenate(chunks, axis=0)
            t0 = time.time()
            hyps, decoded = recognizer.recognize(
                acc, nbest=int(payload.get("nbest", 1)))
            sessions.finish(sid)
            out = {
                "nbest": [{"text": t, "score": s} for t, s in hyps],
                "frames": decoded,
                "latency_ms": round((time.time() - t0) * 1e3, 1),
            }
            if decoded < acc.shape[0]:
                out["truncated"] = True
            return 200, out, "decode"

        def _stream_hybrid(self, sid, verb):
            if verb == "push":
                feats, _payload = self._features(self._read_body())
                feats = recognizer.check_features(feats)
                stream = sessions.get_stream(sid, recognizer)
                if stream is None:
                    return 404, {"error": f"no session {sid}"}, None
                frames, partial = stream.push(feats)
                if not sessions.touch(sid):  # swept mid-push
                    return 410, {"error": f"session {sid} expired"}, None
                return 200, {"frames": frames, "partial": partial}, "decode"
            exists, stream = sessions.peek_stream(sid)
            if not exists:
                return 404, {"error": f"no session {sid}"}, None
            if stream is None or stream.frames == 0:
                # nothing was pushed: the attention mode's empty answer
                sessions.finish(sid)
                return 200, {"nbest": [], "frames": 0}, "ok"
            t0 = time.time()
            res = stream.finish()
            sessions.finish(sid)
            if res is None:
                return 200, {"nbest": [], "frames": stream.frames,
                             "error": "no surviving path"}, "decode"
            text, score = res
            return 200, {
                "nbest": [{"text": text, "score": score}],
                "frames": stream.frames,
                "latency_ms": round((time.time() - t0) * 1e3, 1),
            }, "decode"

    return Handler


def serve(recognizer, port, *, host="127.0.0.1"):
    """The blocking server loop (ThreadingHTTPServer; the device work is
    serialized by the recognizer's lock).  Port 0 binds a free port; the
    ``serving on HOST:PORT`` line names it.  SIGTERM stops the accept loop,
    then in-flight requests drain (30 s at most) before it returns."""
    stats = ServerStats()
    httpd = ThreadingHTTPServer((host, port),
                                make_handler(recognizer, stats=stats))
    bound = httpd.server_address[1]
    if _is_hybrid(recognizer):
        info("serving on %s:%d (hybrid, buckets %s, graph beam %.1f)",
             host, bound, recognizer.buckets, recognizer.beam)
    else:
        info("serving on %s:%d (buckets %s, beam %d)", host, bound,
             recognizer.buckets, recognizer.beam_size)

    def _term(_sig, _frame):
        info("SIGTERM: stop accepting, draining in-flight requests")
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    try:
        signal.signal(signal.SIGTERM, _term)
    except ValueError:  # not the main thread (tests)
        pass
    httpd.serve_forever()
    # the accept loop is closed, but handler threads may be mid-decode:
    # wait for them, so no client gets a reset connection (the short sleep
    # lets the threads of just-accepted connections reach enter())
    time.sleep(0.2)
    if stats.wait_idle(timeout=30.0):
        info("server drained and stopped")
    else:
        info("server stopped with requests still in flight after 30s")
    httpd.server_close()
