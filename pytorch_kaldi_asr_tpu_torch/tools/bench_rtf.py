"""Posterior-generation, decode and graph-search RTF benchmarks (the port's
``pytorch_kaldi_asr_tpu.tools.bench_rtf``: the same benchmarks, defaults
and JSON keys, on the port's modules).

Prints one JSON line per benchmark.  Real-time factor = compute seconds
per second of audio (frames x 10 ms).  Every function takes ``device``
(``cuda`` by default; ``cpu`` off the card) and times on the card's own
clock: ``torch.cuda.synchronize()`` before and after each timed block, so
a time holds the device work it queued.  Random weights from fixed seeds.

- ``bench_offline_posteriors``: the ``tdnn`` AM in bfloat16 compute over a
  [8, 500, 40] batch;
- ``bench_decode``: the KV-cached beam search (beam 25, 100 tokens) of the
  ``tdnn`` encoder-decoder;
- ``bench_streaming_conformer``: chunked pushes through the conformer's
  ``StreamingAM`` (band (-100, 0), causal convolution; each chunk attends
  to [cache | chunk] by einsum, as JAX's does), posteriors read back per
  push;
- ``bench_hybrid``: the host graph search in the native C++ core against
  the Python token passer, and two threads against one;
- ``bench_hybrid_device``: the dense device search (decode/device_latgen);
- ``bench_frontier_crossover``: the frontier device search against the
  native core on a recipe-scale and a ~114k-state graph;
- ``bench_serve_contention``: 32 streams, native threads against one
  frontier batch, under 0, 1 and 3 busy processes;
- ``bench_partials``: a streaming session's incremental attention partials
  against a full re-decode of the audio so far.

Usage: python -m pytorch_kaldi_asr_tpu_torch.tools.bench_rtf
           [--which NAME] [--device cuda|cpu] [--session_sec S]
           [--partial_beam B]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def _sync(device):
    """Wait for the work queued on ``device`` (a card); no-op on the CPU."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _to(params, device):
    from pytorch_kaldi_asr_tpu_torch.models.transformer import tree_map

    return tree_map(lambda t: t.to(device), params)


def _device(device):
    from pytorch_kaldi_asr_tpu_torch.utils.device import resolve_device

    return resolve_device(str(device))


def bench_offline_posteriors(batch=8, frames=500, feat_dim=40,
                             n_targets=512, steps=20, device="cuda"):
    """Full-utterance AM posterior generation (TDNN encoder, bfloat16
    compute)."""
    import torch

    from pytorch_kaldi_asr_tpu_torch.models import am
    from pytorch_kaldi_asr_tpu_torch.models.transformer import (
        TransformerConfig,
    )

    device = _device(device)
    cfg = TransformerConfig(src_dim=feat_dim, vocab_size=52,
                            compute_dtype="bfloat16")
    params = _to(am.init_am(torch.Generator().manual_seed(0), cfg,
                            n_targets), device)
    rng = np.random.default_rng(0)
    src = torch.as_tensor(rng.normal(size=(batch, frames, feat_dim))
                          .astype(np.float32), device=device)
    mask = torch.ones((batch, frames), dtype=torch.uint8, device=device)

    with torch.no_grad():
        am.am_log_posteriors(params, cfg, src, mask)  # warm
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(steps):
            am.am_log_posteriors(params, cfg, src, mask)
        _sync(device)
    dt = (time.perf_counter() - t0) / steps
    audio_sec = batch * frames * 0.01
    return {"metric": "posterior_rtf_offline", "value": round(dt / audio_sec, 6),
            "unit": "rtf", "ms_per_batch": round(dt * 1e3, 3)}


def bench_decode(batch=8, frames=500, feat_dim=40, beam=25, max_len=100,
                 steps=5, device="cuda"):
    """Beam-search decode RTF with the KV-cached search."""
    import torch

    from pytorch_kaldi_asr_tpu_torch.decode.fast_beam import fast_beam_search
    from pytorch_kaldi_asr_tpu_torch.models.transformer import (
        TransformerConfig,
        init_transformer,
    )

    device = _device(device)
    cfg = TransformerConfig(src_dim=feat_dim, vocab_size=52)
    params = _to(init_transformer(torch.Generator().manual_seed(0), cfg),
                 device)
    rng = np.random.default_rng(0)
    src = torch.as_tensor(rng.normal(size=(batch, frames, feat_dim))
                          .astype(np.float32), device=device)
    mask = torch.ones((batch, frames), dtype=torch.uint8, device=device)

    fast_beam_search(params, cfg, src, mask, beam_size=beam,
                     max_len=max_len)  # warm
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        fast_beam_search(params, cfg, src, mask, beam_size=beam,
                         max_len=max_len)
    _sync(device)
    dt = (time.perf_counter() - t0) / steps
    audio_sec = batch * frames * 0.01
    return {"metric": "decode_rtf_beam25", "value": round(dt / audio_sec, 6),
            "unit": "rtf", "ms_per_batch": round(dt * 1e3, 3)}


def streaming_conformer_setup(frames=400, feat_dim=40, n_targets=512,
                              device="cuda"):
    """The streaming bench's conformer AM (band (-100, 0), causal
    convolution, dropout 0) on ``device`` and its seeded [1, frames,
    feat_dim] features: (StreamingAM, features)."""
    import torch

    from pytorch_kaldi_asr_tpu_torch.models import am
    from pytorch_kaldi_asr_tpu_torch.models.streaming import StreamingAM
    from pytorch_kaldi_asr_tpu_torch.models.transformer import (
        TransformerConfig,
    )

    cfg = TransformerConfig(
        src_dim=feat_dim, vocab_size=52, encoder_type="conformer",
        encoder_sub_sequence=(-100, 0), conformer_causal_conv=True,
        en_dropout=0.0,
    )
    params = _to(am.init_am(torch.Generator().manual_seed(0), cfg,
                            n_targets), _device(device))
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(1, frames, feat_dim)).astype(np.float32)
    return StreamingAM(params, cfg), feats


def stream_session(stream, feats, chunk, latencies=None):
    """One session: ``stream`` reset, then ``feats`` pushed ``chunk``
    frames at a time, each push's posteriors read back to the host (the
    serving path's sync), each push's wall seconds appended to
    ``latencies``.  Returns the session's wall seconds."""
    stream.reset()
    t0 = time.perf_counter()
    for lo in range(0, feats.shape[1], chunk):
        t1 = time.perf_counter()
        out = stream.push(feats[:, lo:lo + chunk])
        if out is not None:
            out.cpu()
        if latencies is not None:
            latencies.append(time.perf_counter() - t1)
    return time.perf_counter() - t0


def bench_streaming_conformer(frames=400, chunk=40, feat_dim=40,
                              n_targets=512, steps=3, device="cuda"):
    """True-streaming Conformer AM posterior RTF: chunked pushes through
    the carried-cache StreamingConformer frontend + AM head.  Each push
    reads its posteriors back to the host, so the sync is inherent: wall
    clock per push IS the serving latency."""
    stream, feats = streaming_conformer_setup(frames, feat_dim, n_targets,
                                              device)
    stream_session(stream, feats, chunk)  # warm every cache shape
    _sync(device)
    lat = []
    t_total = sum(stream_session(stream, feats, chunk, lat)
                  for _ in range(steps))
    _sync(device)
    audio_sec = steps * frames * 0.01
    lat.sort()
    return {
        "metric": "streaming_conformer_rtf",
        "value": round(t_total / audio_sec, 6),
        "unit": "rtf",
        "chunk_frames": chunk,
        "push_ms_p50": round(lat[len(lat) // 2] * 1e3, 3),
        "push_ms_p95": round(lat[int(len(lat) * 0.95)] * 1e3, 3),
    }


def hybrid_bench_setup(n_words=200, n_phones=40, n_sents=400, seed=0):
    """Synthetic lexicon + bigram LM -> compiled HLG-style graph, plus
    peaked log-posteriors along a random in-grammar phone path (the
    realistic pruning regime; uniform posteriors would defeat the beam)."""
    from pytorch_kaldi_asr_tpu_torch.fst.graph import mkgraph
    from pytorch_kaldi_asr_tpu_torch.lm.ngram import train_ngram_lm

    rng = np.random.default_rng(seed)
    phones = {f"p{i}": i + 1 for i in range(n_phones)}
    phone_names = list(phones)
    lexicon = {
        f"w{i}": [phone_names[j] for j in
                  rng.integers(0, n_phones, size=rng.integers(3, 7))]
        for i in range(n_words)
    }
    words = sorted(lexicon)
    word_syms = {w: i + 1 for i, w in enumerate(words)}
    sents = [[words[j] for j in rng.integers(0, n_words,
                                             size=rng.integers(3, 9))]
             for _ in range(n_sents)]
    lm = train_ngram_lm(sents, order=2)
    graph, _ = mkgraph(lexicon, lm, word_syms, phones)

    # peaked posteriors along a random word sequence's phone path
    path = []
    for w in [words[j] for j in rng.integers(0, n_words, size=12)]:
        for ph in lexicon[w]:
            path.extend([phones[ph]] * int(rng.integers(2, 5)))
    T = len(path)
    logits = rng.normal(size=(T, n_phones)).astype(np.float64)
    logits[np.arange(T), np.asarray(path) - 1] += 6.0
    log_posts = logits - np.log(np.exp(logits).sum(1, keepdims=True))
    return graph, log_posts


def bench_hybrid(beam=16.0, max_active=2000, repeats=3, device="cuda"):
    """Hybrid-path graph-search RTF: frame-synchronous Viterbi over a
    compiled graph on the HOST (the role Kaldi's C++ decoders play for the
    reference), in the native C++ core (built at first use; a failed build
    raises), against the Python token passer, and the core on two threads
    against one (ctypes releases the GIL).  No device work: ``device``
    only keeps the benchmarks' call uniform."""
    from concurrent.futures import ThreadPoolExecutor

    from pytorch_kaldi_asr_tpu_torch import native
    from pytorch_kaldi_asr_tpu_torch.decode.latgen import latgen

    native.load()
    graph, log_posts = hybrid_bench_setup()
    audio_sec = log_posts.shape[0] * 0.01

    def best_of(fn):
        fn()  # warm (graph conversion, caches)
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            res = fn()
            best = min(best, time.perf_counter() - t0)
        assert res is not None, "hybrid bench decode died"
        return best

    def run(native_flag=True):
        return latgen(graph, log_posts, beam=beam, max_active=max_active,
                      native=native_flag)

    t_prod = best_of(run)
    t_py = best_of(lambda: run(False))
    # two threads decoding distinct utterances over the SHARED graph scale
    # with the host's cores (about 2x on >= 2 cores, 1x on 1)
    n_jobs = 8

    def serial():
        for _ in range(n_jobs):
            run()

    def threaded():
        with ThreadPoolExecutor(max_workers=2) as pool:
            list(pool.map(lambda _: run(), range(n_jobs)))

    serial()  # warm
    t0 = time.perf_counter()
    serial()
    t_ser = time.perf_counter() - t0
    t0 = time.perf_counter()
    threaded()
    t_thr = time.perf_counter() - t0
    return {
        "metric": "hybrid_rtf",
        "value": round(t_prod / audio_sec, 6),
        "unit": "rtf",
        "frames_per_sec": round(log_posts.shape[0] / t_prod, 1),
        "native": True,
        "native_speedup_vs_python": round(t_py / t_prod, 1),
        "concurrency_scaling_x2": round(t_ser / max(t_thr, 1e-9), 2),
    }


def _batched_posts(log_posts, batch, seed=1):
    """``batch`` noisy copies of ``log_posts`` (normal noise of scale 0.1,
    renormalised), float32, and their lengths."""
    T, P = log_posts.shape
    rng = np.random.default_rng(seed)
    posts = np.zeros((batch, T, P), np.float32)
    for b in range(batch):
        v = log_posts + rng.normal(scale=0.1, size=log_posts.shape)
        posts[b] = v - np.log(np.exp(v).sum(1, keepdims=True))
    return posts, np.full(batch, T, np.int32)


def bench_hybrid_device(beam=16.0, max_active=2000, batch=8, repeats=3,
                        device="cuda"):
    """Batched ON-DEVICE graph-search RTF (decode/device_latgen.py, the
    dense Viterbi): `batch` utterances per call, only the word/phone
    buffers returning to the host.  RTF counts the full batch's audio;
    compare against bench_hybrid()'s per-utterance host search."""
    from pytorch_kaldi_asr_tpu_torch.decode.device_latgen import DeviceLatgen

    graph, log_posts = hybrid_bench_setup()
    posts, lens = _batched_posts(log_posts, batch)
    T = log_posts.shape[0]
    audio_sec = batch * T * 0.01

    dec = DeviceLatgen(graph, beam=beam, max_active=max_active,
                       device=device)
    res = dec.decode_batch(posts, lens)  # warm: tables and caches
    assert all(r is not None for r in res), "device hybrid bench died"
    best = float("inf")
    for _ in range(repeats):
        _sync(dec.device)
        t0 = time.perf_counter()
        dec.decode_batch(posts, lens)
        _sync(dec.device)
        best = min(best, time.perf_counter() - t0)
    return {
        "metric": "hybrid_device_rtf",
        "value": round(best / audio_sec, 6),
        "unit": "rtf",
        "batch": batch,
        "frames_per_sec": round(batch * T / best, 1),
        "graph_states": graph.num_states,
    }


def bench_frontier_crossover(beam=16.0, max_active=2000, batch=8,
                             repeats=3, big_words=4000, big_sents=12000,
                             device="cuda"):
    """Frontier-device vs host-native graph-search crossover: times the
    top-K frontier decoder (decode/frontier_latgen.py) on the recipe-scale
    graph AND on a ~114k-state graph (past the dense path's [T, S, B]
    memory wall), against the host native C++ latgen on the same batch,
    and at the frontier's best regime (4x the batch, max_active 256 on
    both paths).  Emits per-path RTF and the device/host ratios."""
    from pytorch_kaldi_asr_tpu_torch.decode.frontier_latgen import (
        FrontierLatgen,
    )
    from pytorch_kaldi_asr_tpu_torch.decode.latgen import latgen

    out = {}

    def time_device(dec, posts, lens):
        res = dec.decode_batch(posts, lens)  # warm: tables and caches
        if not all(r is not None for r in res):
            raise RuntimeError("frontier bench beam died")
        best = float("inf")
        for _ in range(repeats):
            _sync(dec.device)
            t0 = time.perf_counter()
            dec.decode_batch(posts, lens)
            _sync(dec.device)
            best = min(best, time.perf_counter() - t0)
        return best, res

    def time_native(graph, posts, lens):
        best = float("inf")
        ref = [latgen(graph, posts[b, :lens[b]].astype(np.float64),
                      beam=beam, max_active=max_active)
               for b in range(len(posts))]
        for _ in range(repeats):
            t0 = time.perf_counter()
            for b in range(len(posts)):
                latgen(graph, posts[b, :lens[b]].astype(np.float64),
                       beam=beam, max_active=max_active)
            best = min(best, time.perf_counter() - t0)
        return best, ref

    def agreement(dev, ref):
        hit = sum(1 for d, r in zip(dev, ref)
                  if d is not None and r is not None and d[0] == r[0])
        return round(hit / max(len(ref), 1), 3)

    # recipe-scale graph (dense comfort zone)
    graph_s, log_posts_s = hybrid_bench_setup()
    posts_s, lens_s = _batched_posts(log_posts_s, batch)
    audio_s = batch * log_posts_s.shape[0] * 0.01
    dec = FrontierLatgen(graph_s, beam=beam, max_active=max_active,
                         device=device)
    t, res = time_device(dec, posts_s, lens_s)
    tn, ref = time_native(graph_s, posts_s, lens_s)
    out["frontier_small_rtf"] = round(t / audio_s, 6)
    out["frontier_small_agreement"] = agreement(res, ref)
    out["native_small_rtf"] = round(tn / audio_s, 6)
    out["small_graph_states"] = graph_s.num_states

    # past the dense wall: ~114k states
    graph_b, log_posts_b = hybrid_bench_setup(
        n_words=big_words, n_phones=40, n_sents=big_sents, seed=0)
    posts_b, lens_b = _batched_posts(log_posts_b, batch)
    audio_b = batch * log_posts_b.shape[0] * 0.01
    dec = FrontierLatgen(graph_b, beam=beam, max_active=max_active,
                         device=device)
    t, res = time_device(dec, posts_b, lens_b)
    tn, ref = time_native(graph_b, posts_b, lens_b)
    out["frontier_big_rtf"] = round(t / audio_b, 6)
    out["frontier_big_agreement"] = agreement(res, ref)
    out["native_big_rtf"] = round(tn / audio_b, 6)
    out["big_graph_states"] = graph_b.num_states
    out["frontier_big_vs_native"] = round(
        out["native_big_rtf"] / max(out["frontier_big_rtf"], 1e-9), 2)

    # the frontier's best measured regime: realistic pruning width and
    # batch amortization, max_active matched on both paths
    B2, MA2 = 4 * batch, 256
    posts_t, lens_t = _batched_posts(log_posts_b, B2)
    audio_t = B2 * log_posts_b.shape[0] * 0.01
    dec = FrontierLatgen(graph_b, beam=beam, max_active=MA2, device=device)
    t, res = time_device(dec, posts_t, lens_t)
    tn, ref = time_native(graph_b, posts_t, lens_t)
    out["frontier_tuned_rtf"] = round(t / audio_t, 6)
    out["frontier_tuned_agreement"] = agreement(res, ref)
    out["native_tuned_rtf"] = round(tn / audio_t, 6)
    out["frontier_tuned_vs_native"] = round(
        out["native_tuned_rtf"] / max(out["frontier_tuned_rtf"], 1e-9), 2)
    out["tuned_batch"] = B2
    out["tuned_max_active"] = MA2
    return out


def bench_serve_contention(n_streams=32, max_active=256, beam=16.0,
                           contention=(0, 1, 3), repeats=3,
                           big_words=4000, big_sents=12000, device="cuda"):
    """Multi-stream serving A/B under host load: N concurrent serve
    sessions on a host whose cores are contended by the server's other
    work.  On the ~114k-state graph at the tuned width:

    - host-native leg: N streams decoded by a thread pool over the C++
      latgen (GIL released: threads timeshare whatever cores the co-load
      leaves);
    - device-frontier leg: the same N streams decoded as ONE batch on the
      card (the host only dispatches);

    each under C background busy PROCESSES.  Emits aggregate RTF per leg
    per C and the crossover C (the smallest contention at which the
    frontier wins)."""
    import subprocess
    import sys as _sys
    from concurrent.futures import ThreadPoolExecutor

    from pytorch_kaldi_asr_tpu_torch.decode.frontier_latgen import (
        FrontierLatgen,
    )
    from pytorch_kaldi_asr_tpu_torch.decode.latgen import latgen

    graph, log_posts = hybrid_bench_setup(
        n_words=big_words, n_phones=40, n_sents=big_sents, seed=0)
    posts, lens = _batched_posts(log_posts, n_streams)
    audio_s = n_streams * log_posts.shape[0] * 0.01

    dec = FrontierLatgen(graph, beam=beam, max_active=max_active,
                         device=device)
    res = dec.decode_batch(posts, lens)  # warm: tables and caches
    if not all(r is not None for r in res):
        raise RuntimeError("serve-contention bench beam died")
    pool = ThreadPoolExecutor(max_workers=min(n_streams, 8))

    def native_all():
        def one(b):
            return latgen(graph, posts[b, :lens[b]].astype(np.float64),
                          beam=beam, max_active=max_active)
        return list(pool.map(one, range(n_streams)))

    def frontier_all():
        out = dec.decode_batch(posts, lens)
        _sync(dec.device)
        return out

    ref = native_all()  # warm page caches; agreement baseline
    agree = sum(1 for d, r in zip(res, ref)
                if d is not None and r is not None and d[0] == r[0])

    def timed(fn):
        best = float("inf")
        for _ in range(repeats):
            _sync(dec.device)
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
        return best

    rows = []
    crossover = None
    try:
        for c in contention:
            burners = [
                subprocess.Popen(
                    [_sys.executable, "-c",
                     "while True:\n    sum(i*i for i in range(10000))"])
                for _ in range(c)
            ]
            try:
                tn = timed(native_all)
                tf = timed(frontier_all)
            finally:
                for p in burners:
                    p.kill()
                for p in burners:
                    p.wait()
            row = {"contention": c,
                   "native_rtf": round(tn / audio_s, 6),
                   "frontier_rtf": round(tf / audio_s, 6),
                   "frontier_vs_native": round(tn / max(tf, 1e-9), 2)}
            rows.append(row)
            if crossover is None and tf < tn:
                crossover = c
    finally:
        pool.shutdown()
    return {
        "metric": "serve_contention_frontier_vs_native",
        "value": rows[-1]["frontier_vs_native"],
        "unit": "x (native_time/frontier_time at max contention)",
        "n_streams": n_streams,
        "max_active": max_active,
        "graph_states": graph.num_states,
        "agreement": round(agree / n_streams, 3),
        "rows": rows,
        "crossover_contention": crossover,
        "host_cores": os.cpu_count(),
    }


def bench_partials(total_frames=1500, chunk=40, feat_dim=40, beam=8,
                   partial_every=4, max_len=60, seed=0, partial_beam=None,
                   device="cuda", **cfg_overrides):
    """Incremental attention-mode partials vs full re-decode.

    One growing streaming session: every ``partial_every`` pushes, time
    (a) the incremental path, serve/attention_stream's ``sync``: carried
    streaming encoder + KV-cached beam restarted from the previous
    partial's stable prefix, against (b) an offline re-decode of ALL
    accumulated audio (``Recognizer.recognize``).  A full warmup session
    runs first (the serving warmup contract).  The headline is the
    END-of-session latency ratio: the incremental path's cost is flat in
    session age while the re-decode path grows with it."""
    import shutil
    import tempfile

    import torch

    from pytorch_kaldi_asr_tpu_torch.models.transformer import (
        TransformerConfig,
        init_transformer,
    )
    from pytorch_kaldi_asr_tpu_torch.serve.recognizer import Recognizer
    from pytorch_kaldi_asr_tpu_torch.train.checkpoint import save_checkpoint

    cfg = TransformerConfig(src_dim=feat_dim, vocab_size=52,
                            encoder_max_len=total_frames + 100,
                            decoder_max_len=max_len + 4, **cfg_overrides)
    params = init_transformer(torch.Generator().manual_seed(seed), cfg)
    tmp = tempfile.mkdtemp(prefix="bench_partials_")
    try:
        ckpt = os.path.join(tmp, "model")
        save_checkpoint(ckpt, params, cfg)
        vocab = os.path.join(tmp, "vocab.txt")
        with open(vocab, "w") as f:
            for i in range(cfg.vocab_size):
                f.write(f"w{i} {i}\n")
        q = max(chunk * partial_every, 100)
        buckets = tuple(q * i for i in range(1, -(-total_frames // q) + 1))
        rec = Recognizer(ckpt, vocab, beam_size=beam,
                         max_token_seq_len=max_len, buckets=buckets,
                         partial_beam=partial_beam, device=device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(total_frames, feat_dim)).astype(np.float32)

    def run_session(timed):
        astream = rec.new_attention_stream(stream_chunk=chunk)
        assert astream is not None, "model must stream exactly"
        chunks, rows = [], []
        for i, lo in enumerate(range(0, total_frames, chunk)):
            chunks.append(feats[lo:lo + chunk])
            if (i + 1) % partial_every:
                continue
            _sync(rec.device)
            t0 = time.perf_counter()
            astream.sync(list(chunks))
            _sync(rec.device)
            t_inc = time.perf_counter() - t0
            acc = np.concatenate(chunks, axis=0)
            t0 = time.perf_counter()
            rec.recognize(acc)
            _sync(rec.device)
            t_full = time.perf_counter() - t0
            if timed:
                rows.append((len(chunks) * chunk, t_inc, t_full))
        return rows

    run_session(timed=False)  # every memory-pad/prefix/bucket shape once
    rows = run_session(timed=True)
    first, last = rows[0], rows[-1]
    mid = rows[len(rows) // 2]
    return {
        "metric": "partials_incremental_vs_redecode",
        "value": round(last[2] / max(last[1], 1e-9), 2),
        "unit": "x faster at end-of-session",
        "session_sec": round(total_frames * 0.01, 1),
        "partial_beam": partial_beam or beam,
        "partials_timed": len(rows),
        "first_ms": {"frames": first[0], "incremental": round(first[1] * 1e3, 1),
                     "redecode": round(first[2] * 1e3, 1)},
        "mid_ms": {"frames": mid[0], "incremental": round(mid[1] * 1e3, 1),
                   "redecode": round(mid[2] * 1e3, 1)},
        "last_ms": {"frames": last[0], "incremental": round(last[1] * 1e3, 1),
                    "redecode": round(last[2] * 1e3, 1)},
        "session_total_ms": {
            "incremental": round(sum(r[1] for r in rows) * 1e3, 1),
            "redecode": round(sum(r[2] for r in rows) * 1e3, 1)},
    }


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--which",
                        choices=["posterior", "decode", "streaming",
                                 "hybrid", "hybrid_device", "frontier",
                                 "partials", "serve_contention", "all"],
                        default="all")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default; raises without a card), "
                             "cuda:N or cpu")
    parser.add_argument("--session_sec", type=float, default=15.0,
                        help="partials bench session length")
    parser.add_argument("--partial_beam", type=int, default=0,
                        help="narrow beam for the partial path only "
                             "(0 = full beam)")
    opt = parser.parse_args(argv)
    device = opt.device
    if opt.which in ("posterior", "all"):
        print(json.dumps(bench_offline_posteriors(device=device)))
    if opt.which in ("decode", "all"):
        print(json.dumps(bench_decode(device=device)))
    if opt.which in ("streaming", "all"):
        print(json.dumps(bench_streaming_conformer(device=device)))
    if opt.which in ("hybrid", "all"):
        print(json.dumps(bench_hybrid(device=device)))
    if opt.which in ("hybrid_device", "all"):
        print(json.dumps(bench_hybrid_device(device=device)))
    if opt.which in ("frontier", "all"):
        print(json.dumps(bench_frontier_crossover(device=device)))
    if opt.which in ("partials", "all"):
        print(json.dumps(bench_partials(
            total_frames=int(opt.session_sec * 100),
            partial_beam=opt.partial_beam or None, device=device)))
    if opt.which == "serve_contention":  # not in "all": ~114k-state build
        print(json.dumps(bench_serve_contention(device=device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
