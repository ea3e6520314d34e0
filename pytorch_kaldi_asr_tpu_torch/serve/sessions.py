"""Streaming sessions and request statistics for the recognition server
(the port's ``SessionStore`` and ``ServerStats`` of
``pytorch_kaldi_asr_tpu.recipes.serve``): sessions keyed by id with a
time-to-live swept on access, and the counters, latency histogram and
p50/p95/p99 that ``/healthz`` reports."""

from __future__ import annotations

import threading
import time


class SessionStore:
    """Streaming sessions: accumulated feature chunks keyed by id, with
    TTL-based expiry swept on access.  All chunk mutation happens under
    the store lock — a concurrent sweep/finish can never lose a chunk a
    push already acknowledged."""

    def __init__(self, ttl=600.0):
        self.ttl = ttl
        self._sessions = {}
        self._lock = threading.Lock()
        self._counter = 0

    def _sweep(self, now):
        dead = [k for k, s in self._sessions.items()
                if now - s["touched"] > self.ttl]
        for k in dead:
            del self._sessions[k]

    def start(self):
        with self._lock:
            now = time.time()
            self._sweep(now)
            self._counter += 1
            sid = f"s{self._counter:06d}"
            self._sessions[sid] = {"chunks": [], "touched": now}
            return sid

    def append(self, sid, feats):
        """Append a chunk; returns the total frame count, or None if the
        session does not exist (expired/finished)."""
        with self._lock:
            self._sweep(time.time())
            s = self._sessions.get(sid)
            if s is None:
                return None
            s["touched"] = time.time()
            s["chunks"].append(feats)
            return sum(c.shape[0] for c in s["chunks"])

    def snapshot(self, sid):
        """A stable copy of the accumulated chunks (or None)."""
        with self._lock:
            s = self._sessions.get(sid)
            if s is None:
                return None
            s["touched"] = time.time()
            return list(s["chunks"])

    def get_stream(self, sid, recognizer):
        """Hybrid mode: the session's _HybridStream, created on first use
        (or None for an unknown/expired session)."""
        with self._lock:
            self._sweep(time.time())
            s = self._sessions.get(sid)
            if s is None:
                return None
            s["touched"] = time.time()
            if "stream" not in s:
                s["stream"] = recognizer.new_stream()
            return s["stream"]

    def get_astream(self, sid, factory):
        """Attention mode: the session's incremental-partial stream
        (_AttentionStream), created on first use; ``factory`` may return
        None (model cannot stream exactly), which is cached so the probe
        runs once per session.  The factory runs OUTSIDE the store lock
        (it may dequantize a whole int8 tree); a same-session race keeps
        the first stream stored."""
        with self._lock:
            s = self._sessions.get(sid)
            if s is None:
                return None
            s["touched"] = time.time()
            if "astream" in s:
                return s["astream"]
        built = factory()
        with self._lock:
            s = self._sessions.get(sid)
            if s is None:
                return None
            if "astream" not in s:
                s["astream"] = built
            return s["astream"]

    def peek_stream(self, sid):
        """(exists, stream-or-None) without creating a stream — finish
        must not build per-session state just to tear it down."""
        with self._lock:
            s = self._sessions.get(sid)
            if s is None:
                return False, None
            s["touched"] = time.time()
            return True, s.get("stream")

    def touch(self, sid):
        """True if the session still exists (refreshes its TTL)."""
        with self._lock:
            s = self._sessions.get(sid)
            if s is None:
                return False
            s["touched"] = time.time()
            return True

    def finish(self, sid):
        with self._lock:
            return self._sessions.pop(sid, None)


class ServerStats:
    """Cheap request counters + latency aggregates for /healthz."""

    #: fixed log-scale bucket upper edges (ms); the last bucket is open
    HIST_EDGES = (5, 10, 20, 50, 100, 200, 500, 1000, 2000, 5000)

    def __init__(self):
        self._lock = threading.Lock()
        self.requests = 0
        self.errors = 0
        self.decode_ms_total = 0.0
        self.decodes = 0
        self.inflight = 0
        self.started = time.time()
        self.hist = [0] * (len(self.HIST_EDGES) + 1)
        self.max_decode_ms = 0.0

    def enter(self):
        with self._lock:
            self.inflight += 1

    def leave(self):
        with self._lock:
            self.inflight -= 1

    def wait_idle(self, timeout=30.0):
        """Block until no requests are in flight (or timeout); True if
        idle was reached — the drain barrier SIGTERM waits on."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            with self._lock:
                if self.inflight == 0:
                    return True
            time.sleep(0.05)
        return False

    def record(self, error=False, decode_ms=None):
        with self._lock:
            self.requests += 1
            if error:
                self.errors += 1
            if decode_ms is not None:
                self.decodes += 1
                self.decode_ms_total += decode_ms
                self.max_decode_ms = max(self.max_decode_ms, decode_ms)
                i = 0
                while (i < len(self.HIST_EDGES)
                       and decode_ms > self.HIST_EDGES[i]):
                    i += 1
                self.hist[i] += 1

    def _percentile(self, q):
        """Latency percentile estimated from the histogram (linear
        interpolation inside the containing bucket; the open last bucket
        interpolates toward the max seen).  None with no samples."""
        total = sum(self.hist)
        if not total:
            return None
        target = q * total
        seen = 0.0
        for i, count in enumerate(self.hist):
            if seen + count >= target and count:
                lo = self.HIST_EDGES[i - 1] if i else 0.0
                hi = (self.HIST_EDGES[i] if i < len(self.HIST_EDGES)
                      else max(self.max_decode_ms, lo))
                frac = (target - seen) / count
                # an estimate must not exceed the largest sample seen
                return min(lo + frac * (hi - lo), self.max_decode_ms)
            seen += count
        return self.max_decode_ms

    def summary(self):
        with self._lock:
            avg = (self.decode_ms_total / self.decodes
                   if self.decodes else None)
            out = {
                "requests": self.requests,
                "errors": self.errors,
                "decodes": self.decodes,
                "avg_decode_ms": round(avg, 1) if avg is not None else None,
                "uptime_s": round(time.time() - self.started, 1),
            }
            if self.decodes:
                out["max_decode_ms"] = round(self.max_decode_ms, 1)
                for name, q in (("p50_ms", 0.5), ("p95_ms", 0.95),
                                ("p99_ms", 0.99)):
                    p = self._percentile(q)
                    out[name] = round(p, 1) if p is not None else None
                # {"<=5": n, ..., "<=5000": n, ">5000": n}, zero buckets
                # skipped so small servers stay readable
                hist = {}
                for i, count in enumerate(self.hist):
                    if not count:
                        continue
                    key = (f"<={self.HIST_EDGES[i]}"
                           if i < len(self.HIST_EDGES)
                           else f">{self.HIST_EDGES[-1]}")
                    hist[key] = count
                out["latency_hist_ms"] = hist
            return out
