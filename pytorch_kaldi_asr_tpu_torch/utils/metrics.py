"""Observability: stage timers, structured metric logging, profiler hooks
(the port's ``pytorch_kaldi_asr_tpu.utils.metrics``).  A ``MetricsLogger``
appends JSONL records (step, epoch, loss, accuracy, ...) that tooling can
tail, and ``profile_trace`` wraps a block in a ``torch.profiler`` trace
(tools/trace_summary.py summarises it; perfetto or chrome://tracing show
it)."""

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


@contextlib.contextmanager
def profile_trace(log_dir, *, with_flops=False):
    """Capture a torch.profiler trace of the enclosed block: the host's
    ops, and on a card its CUDA kernels, copies and fills too.  On exit a
    gzipped Chrome trace, ``<worker>.<time>.pt.trace.json.gz``, is written
    under ``log_dir`` (``tools.trace_summary.find_trace_files`` finds it);
    ``with_flops`` records each op's FLOPs (and input shapes).  Yields the
    profiler."""
    import torch
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, with_flops=with_flops,
                 record_shapes=with_flops,
                 on_trace_ready=tensorboard_trace_handler(
                     log_dir, use_gzip=True)) as prof:
        try:
            yield prof
        finally:
            if cuda:
                torch.cuda.synchronize()
