"""The port's measuring tools (utils/metrics.profile_trace,
tools/trace_summary.py, tools/devices.py, tools/bench_rtf.py) against the
JAX package's, on the CPU.

- ``trace_summary.summarize`` and ``format_md``: byte for byte JAX's on a
  Chrome trace that ``profile_trace`` writes here and on a synthetic
  JAX-profiler trace; ``summarize_by_source`` (the device time by the host
  op that launched it, through the correlation ids) on a synthetic torch
  trace with known sums, its markdown headed "by launching op" and "by
  category"; the CLI on both.
- ``devices`` without a card: an empty list, and the CLI exits non-zero.
- Each ``bench_rtf`` function at tiny sizes with ``device="cpu"``: JAX's
  keys (from JAX's own functions where they run cheaply on the CPU, else
  from bench_rtf.py's literal records); the synthetic hybrid graph and
  posteriors are JAX's; the CLI passes ``--device`` (``cuda`` by default),
  and without a card ``cuda`` raises.
"""

import gzip
import io
import json
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

from pytorch_kaldi_asr_tpu.tools import bench_rtf as jax_bench
from pytorch_kaldi_asr_tpu.tools import trace_summary as jax_ts
from pytorch_kaldi_asr_tpu_torch.tools import bench_rtf, devices
from pytorch_kaldi_asr_tpu_torch.tools import trace_summary as ts
from pytorch_kaldi_asr_tpu_torch.utils.metrics import profile_trace

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]


def _write_trace(path, events):
    path.parent.mkdir(parents=True, exist_ok=True)
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)


@pytest.fixture(scope="module")
def torch_trace(tmp_path_factory):
    """A trace of a few ops and a user range, by profile_trace on the
    CPU."""
    log_dir = tmp_path_factory.mktemp("prof")
    with profile_trace(str(log_dir), with_flops=True) as prof:
        a = torch.randn(32, 32)
        with torch.profiler.record_function("block"):
            b = torch.relu(a @ a)
        b.sum()
    assert prof is not None
    return log_dir


def _jax_style_events():
    """A jax.profiler-like trace: a TPU track with XLA ops (hlo_category,
    source, bytes_accessed, model_flops) and a host track."""
    ev = [{"ph": "M", "name": "process_name", "pid": 1,
           "args": {"name": "/device:TPU:0"}},
          {"ph": "M", "name": "process_name", "pid": 2,
           "args": {"name": "/host:CPU"}}]
    rng = np.random.default_rng(0)
    for i in range(40):
        ev.append({"ph": "X", "pid": 1, "tid": 1, "name": f"fusion.{i % 7}",
                   "ts": 10.0 * i, "dur": float(rng.integers(1, 90)) + 0.5,
                   "args": {"hlo_category": ["convolution", "loop fusion",
                                             "data formatting"][i % 3],
                            "source": f"models/x.py:{i % 5}",
                            "bytes_accessed": str(1000 * i),
                            "model_flops": str(7 * i)}})
        ev.append({"ph": "X", "pid": 2, "tid": 3, "name": f"py_{i % 4}",
                   "ts": 10.0 * i, "dur": 3.25 * (i % 6)})
    ev.append({"ph": "i", "pid": 2, "name": "marker", "ts": 1.0})
    return ev


def test_summarize_and_format_md_equal_jax_on_a_torch_trace(torch_trace):
    assert ts.find_trace_files(str(torch_trace)) == \
        jax_ts.find_trace_files(str(torch_trace))
    files = ts.find_trace_files(str(torch_trace))
    assert len(files) == 1 and files[0].endswith(".pt.trace.json.gz")
    got, want = (m.summarize(str(torch_trace), top=5) for m in (ts, jax_ts))
    assert got == want
    assert any(r[0] == "block" for rows in got.values()
               for r in rows["rows"])
    assert ts.format_md(got) == jax_ts.format_md(want)
    assert ts.load_events(files[0]) == jax_ts.load_events(files[0])


def test_summarize_and_format_md_equal_jax_on_a_jax_trace(tmp_path):
    _write_trace(tmp_path / "plugins" / "profile" / "run" /
                 "host.trace.json.gz", _jax_style_events())
    (tmp_path / "bare.trace.json").write_text(json.dumps(
        _jax_style_events()[:20]))  # a bare event array
    for top in (3, 10):
        got, want = (m.summarize(str(tmp_path), top=top)
                     for m in (ts, jax_ts))
        assert got == want
        assert ts.format_md(got, title="T") == jax_ts.format_md(want,
                                                                title="T")
    # XLA's device args are not a torch trace's: no launching ops
    assert ts.summarize_by_source(str(tmp_path)) == {}
    with pytest.raises(FileNotFoundError):
        ts.summarize(str(tmp_path / "nothing"))


def _torch_style_events():
    """A torch.profiler-like trace on a card, with known sums:

    - aten::linear (0-100) > aten::addmm (10-60, 2 GFLOP): two kernels,
      gemm (40 us) and bias (8 us), launched at 20 and 30;
    - user range banded_attention (200-230) launches
      banded_attention_kernel<float> (25 us) at 210, inside no cpu_op;
    - aten::copy_ (300-320) launches a 4 MB copy (10 us) at 305;
    - a kernel whose launch is not in the trace (5 us): no launching op;
    - another thread's aten::mul spans 0-400 but launches nothing."""
    host, dev = 4242, 0
    X = "X"
    ev = [{"ph": "M", "name": "process_name", "pid": host,
           "args": {"name": "python3"}},
          # torch.profiler names a card's process after the host's and
          # labels it "GPU n"
          {"ph": "M", "name": "process_name", "pid": dev,
           "args": {"name": "python3"}},
          {"ph": "M", "name": "process_labels", "pid": dev,
           "args": {"labels": "GPU 0"}},
          {"ph": X, "cat": "cpu_op", "name": "aten::mul", "pid": host,
           "tid": 2, "ts": 0.0, "dur": 400.0, "args": {}},
          {"ph": X, "cat": "cpu_op", "name": "aten::linear", "pid": host,
           "tid": 1, "ts": 0.0, "dur": 100.0, "args": {}},
          {"ph": X, "cat": "cpu_op", "name": "aten::addmm", "pid": host,
           "tid": 1, "ts": 10.0, "dur": 50.0, "args": {"flops": 2e9}}]
    launches = [(1, 20.0, "cuda_runtime", "cudaLaunchKernel"),
                (2, 30.0, "cuda_driver", "cuLaunchKernel"),
                (3, 210.0, "cuda_runtime", "cudaLaunchKernel"),
                (4, 305.0, "cuda_runtime", "cudaMemcpyAsync")]
    ev += [{"ph": X, "cat": "user_annotation", "name": "banded_attention",
            "pid": host, "tid": 1, "ts": 200.0, "dur": 30.0, "args": {}},
           {"ph": X, "cat": "cpu_op", "name": "aten::copy_", "pid": host,
            "tid": 1, "ts": 300.0, "dur": 20.0, "args": {}}]
    for corr, t, cat, name in launches:
        ev.append({"ph": X, "cat": cat, "name": name, "pid": host, "tid": 1,
                   "ts": t, "dur": 2.0, "args": {"correlation": corr}})
    for corr, name, cat, dur, extra in (
            (1, "gemm", "kernel", 40.0, {}),
            (2, "bias", "kernel", 8.0, {}),
            (3, "banded_attention_kernel<float>", "kernel", 25.0, {}),
            (4, "Memcpy HtoD", "gpu_memcpy", 10.0, {"bytes": 4_000_000}),
            (99, "orphan", "kernel", 5.0, {})):
        ev.append({"ph": X, "cat": cat, "name": name, "pid": dev, "tid": 7,
                   "ts": 500.0 + corr, "dur": dur,
                   "args": {"correlation": corr, "device": 0, **extra}})
        ev.append({"ph": "f", "cat": "ac2g", "name": "ac2g", "id": corr,
                   "pid": dev, "tid": 7, "ts": 500.0 + corr})
    ev.append({"ph": X, "cat": "gpu_user_annotation",
               "name": "banded_attention", "pid": dev, "tid": 7,
               "ts": 503.0, "dur": 25.0, "args": {}})
    return ev


def test_summarize_by_source_attributes_device_time(tmp_path):
    _write_trace(tmp_path / "w.1.pt.trace.json.gz", _torch_style_events())
    out = ts.summarize_by_source(str(tmp_path))
    assert set(out) == {"GPU 0"}
    gpu = out["GPU 0"]
    assert gpu["total_us"] == 88.0
    rows = {r[0]: r[1:] for r in gpu["rows"]}
    assert rows == {
        "aten::addmm": (48.0, 0, 2e9, 2),
        "banded_attention": (25.0, 0, 0, 1),
        "aten::copy_": (10.0, 4_000_000, 0, 1),
        ts.NO_OP: (5.0, 0, 0, 1)}
    assert [r[0] for r in gpu["rows"]] == [
        "aten::addmm", "banded_attention", "aten::copy_", ts.NO_OP]
    cats = {r[0]: r[1:] for r in gpu["category_rows"]}
    assert cats == {"kernel": (78.0, 0, 2e9, 4),
                    "gpu_memcpy": (10.0, 4_000_000, 0, 1)}
    md = ts.format_source_md(out)
    assert "## GPU 0 — by launching op (total 0.09 ms)" in md
    assert "## GPU 0 — by category (total 0.09 ms)" in md
    assert "| `banded_attention` | 0.025 | 0.000 | 0.00 | 1 | 28.4 |" in md
    assert "| `aten::copy_` | 0.010 | 0.004 | 0.00 | 1 | 11.4 |" in md
    assert "| `aten::addmm` | 0.048 | 0.000 | 2.00 | 2 | 54.5 |" in md
    # the same trace's per-track view is JAX's
    assert ts.summarize(str(tmp_path)) == jax_ts.summarize(str(tmp_path))
    assert ts.summarize_by_source(str(tmp_path), top=1)["GPU 0"]["rows"] \
        == [("aten::addmm", 48.0, 0, 2e9, 2)]


def test_trace_summary_cli(tmp_path, torch_trace):
    _write_trace(tmp_path / "gpu" / "w.pt.trace.json.gz",
                 _torch_style_events())
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert ts.main([str(tmp_path / "gpu"), "-top", "4", "-md",
                        str(tmp_path / "s.md")]) == 0
    text = buf.getvalue()
    assert "# Profiler trace summary" in text
    assert "by launching op" in text and "by category" in text
    assert (tmp_path / "s.md").read_text() == text
    # a CPU-only trace has no device rows: the per-track table only
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert ts.main([str(torch_trace)]) == 0
    assert ts.summarize_by_source(str(torch_trace)) == {}
    assert buf.getvalue().startswith("# Profiler trace summary")


def test_devices_without_a_card():
    assert devices.available_devices() == []
    err = io.StringIO()
    from contextlib import redirect_stderr

    with redirect_stderr(err):
        assert devices.main([]) != 0
    assert "no CUDA device" in err.getvalue()
    proc = subprocess.run(
        [sys.executable, "-m", "pytorch_kaldi_asr_tpu_torch.tools.devices"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and not proc.stdout.strip()


# --- bench_rtf ---

# the keys of the records of JAX's functions that do not run cheaply on the
# CPU (XLA compiles of the device searches): bench_rtf.py:280-287, :303-391,
# :475-485
JAX_KEYS = {
    "hybrid_device": {"metric", "value", "unit", "batch", "frames_per_sec",
                      "graph_states"},
    "frontier": {
        "frontier_small_rtf", "frontier_small_agreement", "native_small_rtf",
        "small_graph_states", "frontier_big_rtf", "frontier_big_agreement",
        "native_big_rtf", "big_graph_states", "frontier_big_vs_native",
        "frontier_tuned_rtf", "frontier_tuned_agreement", "native_tuned_rtf",
        "frontier_tuned_vs_native", "tuned_batch", "tuned_max_active"},
    "serve_contention": {"metric", "value", "unit", "n_streams",
                         "max_active", "graph_states", "agreement", "rows",
                         "crossover_contention", "host_cores"},
}
CPU = {"device": "cpu"}
PARTIALS = dict(total_frames=96, chunk=16, partial_every=2, beam=2,
                max_len=6, en_layers=1, de_layers=1, en_d_model=32,
                de_d_model=32, d_k=8, d_v=8, n_head=1)


@pytest.fixture(scope="module")
def tiny_graph():
    return bench_rtf.hybrid_bench_setup(n_words=30, n_phones=12,
                                        n_sents=60)


@pytest.fixture
def tiny_graphs(monkeypatch):
    """bench_rtf's synthetic graphs at 30 words (the big one at 40)."""
    setup = bench_rtf.hybrid_bench_setup

    def tiny(n_words=30, n_phones=12, n_sents=60, seed=0):
        return setup(n_words=min(n_words, 40), n_phones=12,
                     n_sents=min(n_sents, 60), seed=seed)

    monkeypatch.setattr(bench_rtf, "hybrid_bench_setup", tiny)
    return tiny()


def test_hybrid_bench_setup_equals_jax(tiny_graph):
    graph, posts = tiny_graph
    jgraph, jposts = jax_bench.hybrid_bench_setup(n_words=30, n_phones=12,
                                                  n_sents=60)
    assert np.array_equal(posts, jposts)
    assert graph.start == jgraph.start and graph.final == jgraph.final
    assert [[(a.ilabel, a.olabel, a.weight, a.nextstate) for a in arcs]
            for arcs in graph.arcs] == \
        [[(a.ilabel, a.olabel, a.weight, a.nextstate) for a in arcs]
         for arcs in jgraph.arcs]
    got, want = (m._batched_posts(x, 3) for m, x in ((bench_rtf, posts),
                                                      (jax_bench, jposts)))
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])


def test_bench_offline_posteriors_keys():
    r = bench_rtf.bench_offline_posteriors(batch=2, frames=24, feat_dim=8,
                                           n_targets=8, steps=1, **CPU)
    want = jax_bench.bench_offline_posteriors(batch=2, frames=24, feat_dim=8,
                                              n_targets=8, steps=1)
    assert set(r) == set(want)
    assert r["metric"] == "posterior_rtf_offline" and r["value"] > 0


def test_bench_decode_keys():
    r = bench_rtf.bench_decode(batch=1, frames=24, feat_dim=8, beam=2,
                               max_len=4, steps=1, **CPU)
    want = jax_bench.bench_decode(batch=1, frames=24, feat_dim=8, beam=2,
                                  max_len=4, steps=1)
    assert set(r) == set(want)
    assert r["metric"] == "decode_rtf_beam25" and r["ms_per_batch"] > 0


def test_bench_streaming_conformer_keys():
    r = bench_rtf.bench_streaming_conformer(frames=32, chunk=16, steps=1,
                                            n_targets=8, **CPU)
    want = jax_bench.bench_streaming_conformer(frames=32, chunk=16, steps=1,
                                               n_targets=8)
    assert set(r) == set(want)
    assert r["metric"] == "streaming_conformer_rtf" and r["push_ms_p50"] > 0


def test_bench_hybrid_keys(tiny_graphs):
    r = bench_rtf.bench_hybrid(repeats=1, **CPU)
    want = jax_bench.bench_hybrid(repeats=1)
    assert set(r) == set(want)
    assert r["native"] is True and r["native_speedup_vs_python"] > 1.0
    assert r["concurrency_scaling_x2"] > 0 and r["value"] > 0


def test_bench_hybrid_device_keys(tiny_graphs):
    r = bench_rtf.bench_hybrid_device(batch=2, repeats=1, **CPU)
    assert set(r) == JAX_KEYS["hybrid_device"]
    assert r["graph_states"] == tiny_graphs[0].num_states


def test_bench_frontier_crossover_keys(tiny_graphs):
    r = bench_rtf.bench_frontier_crossover(batch=2, repeats=1, big_words=40,
                                           big_sents=60, **CPU)
    assert set(r) == JAX_KEYS["frontier"]
    assert r["frontier_small_agreement"] == 1.0
    assert r["tuned_batch"] == 8 and r["tuned_max_active"] == 256


def test_bench_serve_contention_keys(tiny_graphs):
    r = bench_rtf.bench_serve_contention(n_streams=2, contention=(0, 1),
                                         repeats=1, big_words=40,
                                         big_sents=60, **CPU)
    assert set(r) == JAX_KEYS["serve_contention"]
    assert [row["contention"] for row in r["rows"]] == [0, 1]
    assert r["agreement"] == 1.0


def test_bench_partials_keys():
    r = bench_rtf.bench_partials(**PARTIALS, **CPU)
    want = jax_bench.bench_partials(**PARTIALS)
    assert set(r) == set(want)
    assert r["partials_timed"] == want["partials_timed"] == 3
    for row in (r["first_ms"], r["mid_ms"], r["last_ms"]):
        assert set(row) == {"frames", "incremental", "redecode"}


def test_bench_cli_passes_the_device(monkeypatch):
    """``--device`` reaches every benchmark, ``cuda`` unless asked; the
    choices and --session_sec/--partial_beam are JAX's."""
    seen = {}

    def fake(name):
        def run(**kw):
            seen[name] = kw
            return {"metric": name}
        return run

    for name in ("bench_offline_posteriors", "bench_decode",
                 "bench_streaming_conformer", "bench_hybrid",
                 "bench_hybrid_device", "bench_frontier_crossover",
                 "bench_partials", "bench_serve_contention"):
        monkeypatch.setattr(bench_rtf, name, fake(name))
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert bench_rtf.main(["--session_sec", "6", "--partial_beam",
                               "3"]) == 0
    lines = [json.loads(l) for l in buf.getvalue().splitlines()]
    assert [l["metric"] for l in lines] == [
        "bench_offline_posteriors", "bench_decode",
        "bench_streaming_conformer", "bench_hybrid", "bench_hybrid_device",
        "bench_frontier_crossover", "bench_partials"]
    assert all(kw["device"] == "cuda" for kw in seen.values())
    assert seen["bench_partials"]["total_frames"] == 600
    assert seen["bench_partials"]["partial_beam"] == 3
    seen.clear()
    with redirect_stdout(io.StringIO()):
        bench_rtf.main(["--which", "serve_contention", "--device", "cpu"])
    assert seen == {"bench_serve_contention": {"device": "cpu"}}


def test_bench_needs_a_card_unless_cpu():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_rtf.bench_offline_posteriors(batch=1, frames=8, steps=1)
