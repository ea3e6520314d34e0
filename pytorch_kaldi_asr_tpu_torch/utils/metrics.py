"""Observability: stage timers and structured metric logging (the JAX
package's ``utils/metrics.py``; its ``profile_trace`` wraps the JAX
profiler and is not ported).  A ``MetricsLogger`` appends JSONL records
(step, epoch, loss, accuracy, ...) that tooling can tail."""

from __future__ import annotations

import contextlib
import json
import os
import time


class StageTimer:
    """Accumulates wall-clock per named stage; reentrant via context
    manager."""

    def __init__(self):
        self.totals = {}
        self.counts = {}

    @contextlib.contextmanager
    def stage(self, name):
        start = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - start
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self):
        return {
            name: {
                "total_s": round(self.totals[name], 4),
                "calls": self.counts[name],
                "mean_s": round(self.totals[name] / self.counts[name], 6),
            }
            for name in self.totals
        }


class MetricsLogger:
    """Append-only JSONL metrics stream (one dict per record)."""

    def __init__(self, path):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.path = path
        self._f = open(path, "a", encoding="utf-8")

    def log(self, **record):
        record.setdefault("ts", time.time())
        self._f.write(json.dumps(record, default=float) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
