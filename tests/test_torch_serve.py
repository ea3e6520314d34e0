"""The port's recognition server (pytorch_kaldi_asr_tpu_torch/serve/,
recipes/serve.py) on the CPU.

- The assertions of the JAX package's tests/test_serve.py, on the port:
  buckets and n-best, bad dimensions, HTTP end to end over a real socket,
  WAV input, sessions and their expiry, the micro-batcher, the statistics,
  reload and its mismatch, hybrid offline and streaming, interleaved
  sessions, the score convention, conformer streaming against offline, the
  incremental attention partials and the partial beam.
- Against the JAX package's Recognizer and HybridRecognizer on the same
  checkpoint: texts equal, scores within 1e-5, the JSON keys the same; the
  forced-prefix memory search against JAX's.
- One test for each of the three repairs of the attention stream (the
  memory cap, the catch-up outside the recognizer's lock, the stream fed
  before the crossover).
- The CLI as a process: it serves on a free port and exits 0 on SIGTERM
  with its launch log.

Every HTTP test binds port 0, sets socket timeouts and shuts its server
down in a ``finally``.
"""

import contextlib
import functools
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from pytorch_kaldi_asr_tpu.models import init_transformer
from pytorch_kaldi_asr_tpu.recipes import serve as jax_serve
from pytorch_kaldi_asr_tpu.train import save_checkpoint
from pytorch_kaldi_asr_tpu_torch.decode.fast_beam import (
    fast_beam_search_memory,
)
from pytorch_kaldi_asr_tpu_torch.models.transformer import encode
from pytorch_kaldi_asr_tpu_torch.serve import attention_stream, http
from pytorch_kaldi_asr_tpu_torch.serve.batcher import MicroBatcher
from pytorch_kaldi_asr_tpu_torch.serve.hybrid import HybridRecognizer
from pytorch_kaldi_asr_tpu_torch.serve.recognizer import Recognizer
from pytorch_kaldi_asr_tpu_torch.serve.sessions import (
    ServerStats,
    SessionStore,
)
from tests.test_models import small_cfg

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SCORE_ATOL = 1e-5
CPU = dict(device="cpu")


def _write_model(path, cfg, seed, **kw):
    save_checkpoint(str(path), init_transformer(jax.random.PRNGKey(seed),
                                                cfg), cfg, **kw)


def _write_vocab(path):
    words = ["<blank>", "<unk>", "<s>", "</s>", "aa", "bb", "cc", "dd"]
    path.write_text("".join(f"{w} {i}\n" for i, w in enumerate(words)))


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve")
    cfg = small_cfg()
    _write_model(tmp / "model", cfg, 0, epoch=0)
    _write_vocab(tmp / "vocab.txt")
    return tmp, cfg


@pytest.fixture(scope="module")
def recognizer(model_dir):
    tmp, _ = model_dir
    rec = Recognizer(str(tmp / "model"), str(tmp / "vocab.txt"),
                     beam_size=3, buckets=(8, 16), **CPU)
    rec.warmup()
    return rec


@pytest.fixture(scope="module")
def banded_model_dir(tmp_path_factory):
    """A causal banded-encoder checkpoint: the family the incremental
    attention partials serve."""
    tmp = tmp_path_factory.mktemp("serve_banded")
    cfg = small_cfg(encoder_type="banded", encoder_sub_sequence=(-8, 0))
    _write_model(tmp / "model", cfg, 1, epoch=0)
    _write_model(tmp / "model2", cfg, 3, epoch=2)
    _write_vocab(tmp / "vocab.txt")
    return tmp, cfg


@contextlib.contextmanager
def _server(rec, sessions=None):
    """The port's handler on a free port in a thread; yields post/get."""
    httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                http.make_handler(rec, sessions=sessions))
    httpd.timeout = 30
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield _Client(base)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)


class _Client:
    def __init__(self, base):
        self.base = base

    def post(self, path, obj=None, data=None, ctype="application/json"):
        if data is None:
            data = json.dumps(obj).encode() if obj is not None else b""
        req = urllib.request.Request(self.base + path, data=data,
                                     headers={"Content-Type": ctype})
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read())

    def get(self, path):
        with urllib.request.urlopen(self.base + path, timeout=30) as r:
            return json.loads(r.read())

    def error(self, path, obj=None, data=None):
        with pytest.raises(urllib.error.HTTPError) as e:
            self.post(path, obj, data)
        return e.value.code


def _feats(cfg, t, seed):
    return np.random.default_rng(seed).normal(
        size=(t, cfg.src_dim)).astype(np.float32)


# ---------------------------------------------------------------------------
# the JAX package's tests/test_serve.py, on the port
# ---------------------------------------------------------------------------


def test_recognize_buckets_and_nbest(recognizer, model_dir):
    _, cfg = model_dir
    for t in (5, 12):  # buckets 8 and 16
        hyps, decoded = recognizer.recognize(_feats(cfg, t, t), nbest=2)
        assert decoded == t
        assert 1 <= len(hyps) <= 2
        for text, score in hyps:
            assert isinstance(text, str) and np.isfinite(score)
    # longer than the largest bucket: cut to it, not a crash
    hyps, decoded = recognizer.recognize(_feats(cfg, 64, 0))
    assert decoded == 16 and hyps


def test_recognize_rejects_wrong_dim(recognizer):
    with pytest.raises(ValueError):
        recognizer.recognize(np.zeros((5, 3), np.float32))


def test_http_end_to_end(recognizer, model_dir):
    _, cfg = model_dir
    with _server(recognizer) as c:
        health = c.get("/healthz")
        assert health["status"] == "ok" and health["src_dim"] == cfg.src_dim
        assert health["mode"] == "attention"
        out = c.post("/recognize", {"features": _feats(cfg, 10, 1).tolist(),
                                    "nbest": 2})
        assert out["frames"] == 10 and 1 <= len(out["nbest"]) <= 2
        assert "latency_ms" in out
        # malformed request: 400, and the server lives on
        assert c.error("/recognize", data=b"{not json") == 400
        assert c.error("/nowhere", {}) == 404
        health = c.get("/healthz")
        assert health["stats"]["requests"] >= 2
        assert health["stats"]["errors"] >= 1
        assert health["stats"]["decodes"] >= 1


def test_http_streaming_session(recognizer, model_dir):
    _, cfg = model_dir
    with _server(recognizer) as c:
        sid = c.post("/stream/start")["id"]
        r1 = c.post(f"/stream/{sid}/push",
                    {"features": _feats(cfg, 4, 2).tolist()})
        assert r1["frames"] == 4 and "partial" not in r1
        r2 = c.post(f"/stream/{sid}/push",
                    {"features": _feats(cfg, 5, 3).tolist(),
                     "partial": True})
        assert r2["frames"] == 9 and isinstance(r2["partial"], str)
        final = c.post(f"/stream/{sid}/finish", {"nbest": 2})
        assert final["frames"] == 9 and 1 <= len(final["nbest"]) <= 2
        # the session is gone after finish
        assert c.error(f"/stream/{sid}/push",
                       {"features": [[0.0] * cfg.src_dim]}) == 404


def test_session_store_expiry_and_locked_append():
    store = SessionStore(ttl=0.05)
    sid = store.start()
    chunk = np.zeros((3, 4), np.float32)
    assert store.append(sid, chunk) == 3
    assert store.append(sid, chunk) == 6
    assert len(store.snapshot(sid)) == 2
    time.sleep(0.1)
    store.start()  # sweeps
    assert store.append(sid, chunk) is None
    assert store.snapshot(sid) is None


@pytest.fixture(scope="module")
def hybrid_setup(tmp_path_factory):
    """A tiny AM checkpoint (tdnn and causal conformer) and an HLG graph
    dir, written by the JAX package's tools."""
    from pytorch_kaldi_asr_tpu.fst.graph import mkgraph
    from pytorch_kaldi_asr_tpu.fst.openfst_io import write_const_fst
    from pytorch_kaldi_asr_tpu.lm.ngram import train_ngram_lm
    from pytorch_kaldi_asr_tpu.models import TransformerConfig
    from pytorch_kaldi_asr_tpu.models.am import init_am
    from pytorch_kaldi_asr_tpu.recipes.mkgraph import write_symbol_table

    tmp = tmp_path_factory.mktemp("hybrid")
    phones = {p: i + 1 for i, p in enumerate("abkt")}
    lexicon = {"bat": list("bat"), "at": list("at"), "tab": list("tab")}
    lm = train_ngram_lm([s.split() for s in
                         ["bat at", "at tab", "tab bat at"]], order=2)
    word_syms = {w: i + 1 for i, w in enumerate(sorted(lexicon))}
    graph, _ = mkgraph(lexicon, lm, word_syms, phones, sil_phone=None,
                       hmm_loops=True)
    (tmp / "graph").mkdir()
    write_const_fst(graph, str(tmp / "graph" / "HLG.fst"))
    write_symbol_table(str(tmp / "graph" / "words.txt"), word_syms)
    base = dict(src_dim=6, vocab_size=8, en_layers=1, de_layers=1, n_head=1,
                en_d_model=16, de_d_model=16, d_k=8, d_v=8,
                encoder_max_len=64, en_dropout=0.0, de_dropout=0.0)
    cfgs = {"am": TransformerConfig(tdnn_contexts=((-1, 0, 1),), **base),
            "am_conformer": TransformerConfig(
                encoder_type="conformer", encoder_sub_sequence=(-8, 0),
                conformer_kernel=5, conformer_causal_conv=True, **base)}
    for name, cfg in cfgs.items():
        save_checkpoint(str(tmp / name),
                        init_am(jax.random.PRNGKey(0), cfg, len(phones)),
                        cfg, epoch=1, extra={"n_targets": len(phones),
                                             "model_kind": "am"})
    save_checkpoint(str(tmp / "am2"),
                    init_am(jax.random.PRNGKey(5), cfgs["am"], len(phones)),
                    cfgs["am"], epoch=3, extra={"n_targets": len(phones),
                                                "model_kind": "am"})
    save_checkpoint(str(tmp / "am_bad"),
                    init_am(jax.random.PRNGKey(6), cfgs["am"], 2),
                    cfgs["am"], epoch=1, extra={"n_targets": 2,
                                                "model_kind": "am"})
    return tmp, cfgs["am"]


def _hybrid(tmp, name="am", **kw):
    return HybridRecognizer(str(tmp / name), str(tmp / "graph"), beam=1e9,
                            **CPU, **kw)


def test_hybrid_server_offline_and_streaming(hybrid_setup):
    tmp, cfg = hybrid_setup
    rec = _hybrid(tmp)
    rec.warmup()
    with _server(rec) as c:
        health = c.get("/healthz")
        assert health["mode"] == "hybrid"
        # the graph search runs in the port's native C++ core by default
        # (decode/latgen.py), as JAX's health reports when its core is built
        assert health["graph_search"]["native"] is True
        feats = _feats(cfg, 24, 4)
        off = c.post("/recognize", {"features": feats.tolist(), "nbest": 3})
        assert off["frames"] == 24 and off["nbest"]
        sid = c.post("/stream/start")["id"]
        for lo in range(0, 24, 6):
            r = c.post(f"/stream/{sid}/push",
                       {"features": feats[lo:lo + 6].tolist()})
            assert isinstance(r["partial"], str)
        assert r["frames"] == 24
        final = c.post(f"/stream/{sid}/finish")
        assert final["frames"] == 24 and final["nbest"]
        assert final["nbest"][0]["text"] == off["nbest"][0]["text"]
        assert c.get("/healthz")["graph_search"]["searches"] >= 1


def test_hybrid_interleaved_sessions_are_independent(hybrid_setup):
    tmp, cfg = hybrid_setup
    rec = _hybrid(tmp)
    a, b = _feats(cfg, 18, 9), _feats(cfg, 18, 10)
    solo = {}
    for name, feats in (("a", a), ("b", b)):
        st = rec.new_stream()
        for lo in range(0, 18, 6):
            st.push(feats[lo:lo + 6])
        solo[name] = st.finish()
    sa, sb = rec.new_stream(), rec.new_stream()
    for lo in range(0, 18, 6):
        sa.push(a[lo:lo + 6])
        sb.push(b[lo:lo + 6])
    assert sa.finish() == solo["a"] and sb.finish() == solo["b"]


def _wav_bytes(tmp_path, n=3200, seed=5):
    from pytorch_kaldi_asr_tpu_torch.tools.wav import write_wav

    samples = (np.random.default_rng(seed).normal(size=n) * 0.1).astype(
        np.float32)
    write_wav(str(tmp_path / "a.wav"), samples, 16000)
    return (tmp_path / "a.wav").read_bytes()


def test_http_wav_input(model_dir, tmp_path):
    """Raw WAV bytes: fbank of num_bins = the model's src_dim, on the fly
    (on the recognizer's device)."""
    tmp, _ = model_dir
    rec = Recognizer(str(tmp / "model"), str(tmp / "vocab.txt"), beam_size=2,
                     buckets=(8, 16), **CPU)
    with _server(rec) as c:
        out = c.post("/recognize", data=_wav_bytes(tmp_path),
                     ctype="audio/wav")
    # 3200 samples at 16 kHz, 25 ms windows every 10 ms: 18 frames, cut to
    # the largest bucket (16)
    assert out["frames"] == 16 and out["truncated"] and out["nbest"]


def test_recognize_many_matches_singles(recognizer, model_dir,
                                       banded_model_dir):
    """One batched search gives each utterance its solo texts; for the
    banded encoder, whose valid frames do not see the padding, its scores
    too (the tdnn's last frames read the bucket's padding)."""
    _, cfg = model_dir
    tmp, bcfg = banded_model_dir
    banded = Recognizer(str(tmp / "model"), str(tmp / "vocab.txt"),
                        beam_size=3, buckets=(8, 16), **CPU)
    for rec, c in ((recognizer, cfg), (banded, bcfg)):
        feats = [_feats(c, t, 6 + t) for t in (5, 12, 7)]
        singles = [rec.recognize(f, nbest=2) for f in feats]
        batched, decoded = rec.recognize_many(feats, nbest=2, batch_pad=8)
        assert decoded == [s[1] for s in singles]
        for (s_hyps, _), b_hyps in zip(singles, batched):
            assert [t for t, _ in b_hyps] == [t for t, _ in s_hyps]
            if rec is banded:
                for (_, s), (_, b) in zip(s_hyps, b_hyps):
                    assert abs(s - b) <= 1e-4


def test_micro_batcher_coalesces_and_is_correct(model_dir):
    """Concurrent requests through the MicroBatcher: each gets its solo
    result, in fewer searches than requests."""
    tmp, cfg = model_dir
    rec = Recognizer(str(tmp / "model"), str(tmp / "vocab.txt"),
                     beam_size=3, buckets=(8, 16), **CPU)
    calls = {"n": 0}
    inner = rec.search

    def counting_search(*a, **kw):
        calls["n"] += 1
        return inner(*a, **kw)

    rec.search = counting_search
    mb = MicroBatcher(rec, max_batch=4, window_ms=200.0)
    mb.warmup()
    feats = [_feats(cfg, 6 + i, 7 + i) for i in range(8)]
    solo = [rec.recognize(f) for f in feats]
    calls["n"] = 0
    results = [None] * 8

    def worker(i):
        results[i] = mb.recognize(feats[i])

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert all(r is not None for r in results)
    for got, want in zip(results, solo):
        assert got[1] == want[1]
        assert [t for t, _ in got[0]] == [t for t, _ in want[0]]
    assert calls["n"] <= 4, calls["n"]
    with pytest.raises(ValueError):  # raised to its own caller
        mb.recognize(np.zeros((4, 3), np.float32))


def test_hybrid_score_convention_and_empty_finish(hybrid_setup):
    tmp, cfg = hybrid_setup
    rec = _hybrid(tmp, buckets=(32,))
    with _server(rec) as c:
        feats = _feats(cfg, 20, 11)
        off = c.post("/recognize", {"features": feats.tolist(), "nbest": 3})
        scores = [h["score"] for h in off["nbest"]]
        assert scores == sorted(scores, reverse=True)  # higher is better
        sid = c.post("/stream/start")["id"]
        for lo in range(0, 20, 5):
            c.post(f"/stream/{sid}/push",
                   {"features": feats[lo:lo + 5].tolist()})
        fin = c.post(f"/stream/{sid}/finish")
        assert abs(fin["nbest"][0]["score"] - off["nbest"][0]["score"]) < 1.0
        sid2 = c.post("/stream/start")["id"]
        assert c.post(f"/stream/{sid2}/finish") == {"nbest": [], "frames": 0}


def test_server_stats_histogram_and_percentiles():
    st = ServerStats()
    assert st.summary().get("p50_ms") is None
    for ms in (3.0, 7.0, 15.0, 40.0, 40.0, 90.0, 150.0, 400.0, 900.0, 7000.0):
        st.record(decode_ms=ms)
    s = st.summary()
    assert s["decodes"] == 10 and s["max_decode_ms"] == 7000.0
    hist = s["latency_hist_ms"]
    assert hist["<=5"] == 1 and hist["<=10"] == 1
    assert hist["<=20"] == 1 and hist["<=50"] == 2
    assert hist[">5000"] == 1 and sum(hist.values()) == 10
    assert 0 < s["p50_ms"] <= s["p95_ms"] <= s["p99_ms"] <= 7000.0
    assert s["p50_ms"] <= 100.0
    st2 = ServerStats()
    st2.record(decode_ms=42.0)
    s2 = st2.summary()
    assert 20.0 < s2["p50_ms"] <= s2["p99_ms"] <= 42.0


def test_reload_hot_swap_and_config_mismatch(model_dir):
    tmp, cfg = model_dir
    _write_model(tmp / "model2", cfg, 1, epoch=7, step=123)
    cfg_bad = small_cfg(en_d_model=16)
    _write_model(tmp / "model_bad", cfg_bad, 2, epoch=1)
    rec = Recognizer(str(tmp / "model"), str(tmp / "vocab.txt"), beam_size=2,
                     buckets=(8,), **CPU)
    feats = _feats(cfg, 6, 12)
    before = rec.recognize(feats)
    old = rec.params["decoder"]["word_proj"]["w"].clone()
    meta = rec.reload(str(tmp / "model2"))
    assert meta["epoch"] == 7 and meta["step"] == 123
    assert rec.model_file == str(tmp / "model2")
    assert rec.recognize(feats)[1] == before[1]
    assert not torch.allclose(old, rec.params["decoder"]["word_proj"]["w"])
    with pytest.raises(ValueError, match="differs from the serving"):
        rec.reload(str(tmp / "model_bad"))
    assert rec.model_file == str(tmp / "model2")
    assert rec.recognize(feats)[1] == 6


def test_http_reload_endpoint(model_dir):
    tmp, cfg = model_dir
    _write_model(tmp / "model2", cfg, 1, epoch=7, step=9)
    _write_model(tmp / "model_bad", small_cfg(en_d_model=16), 2, epoch=1)
    rec = Recognizer(str(tmp / "model"), str(tmp / "vocab.txt"), beam_size=2,
                     buckets=(8,), **CPU)
    with _server(rec) as c:
        out = c.post("/reload", {"model_file": str(tmp / "model2")})
        assert out["status"] == "reloaded" and out["epoch"] == 7
        assert c.get("/healthz")["model_file"] == str(tmp / "model2")
        assert c.error("/reload",
                       {"model_file": str(tmp / "model_bad")}) == 400
        out = c.post("/recognize", {"features": _feats(cfg, 5, 13).tolist()})
        assert out["frames"] == 5 and out["nbest"]


def test_hybrid_recognize_many_matches_singles(hybrid_setup):
    tmp, cfg = hybrid_setup
    rec = _hybrid(tmp, buckets=(32,))
    feats = [_feats(cfg, t, 14 + t) for t in (12, 20, 16)]
    singles = [rec.recognize(f, nbest=2) for f in feats]
    batched, lens = rec.recognize_many(feats, nbest=2, batch_pad=4)
    assert lens == [s[1] for s in singles]
    for (s_hyps, _), b_hyps in zip(singles, batched):
        assert [t for t, _ in b_hyps] == [t for t, _ in s_hyps]


def test_hybrid_reload(hybrid_setup):
    tmp, _ = hybrid_setup
    rec = _hybrid(tmp, buckets=(32,))
    assert rec.reload(str(tmp / "am2"))["epoch"] == 3
    assert rec.model_file == str(tmp / "am2")
    with pytest.raises(ValueError):
        rec.reload(str(tmp / "am_bad"))


def test_hybrid_conformer_streaming_matches_offline(hybrid_setup):
    """A causal conformer AM: true streaming sessions (StreamingAM behind
    FixedChunkStream) give the offline decode."""
    tmp, cfg = hybrid_setup
    rec = _hybrid(tmp, "am_conformer", stream_chunk=4)
    feats = _feats(cfg, 18, 5)
    off, _ = rec.recognize(feats, nbest=1)
    st = rec.new_stream()
    for lo in range(0, 18, 7):
        st.push(feats[lo:lo + 7])
    text, score = st.finish()
    assert text == off[0][0] and abs(score - off[0][1]) <= 1e-4


def test_attention_stream_incremental_partials(banded_model_dir):
    """The stream grows the memory with the carried encoder; its last
    partial is the offline decode (the padded memory masked as the
    bucket's pad is)."""
    tmp, cfg = banded_model_dir
    rec = Recognizer(str(tmp / "model"), str(tmp / "vocab.txt"), beam_size=3,
                     buckets=(16,), **CPU)
    astream = rec.new_attention_stream(stream_chunk=4)
    assert astream is not None
    audio = _feats(cfg, 12, 7)
    chunks, partials = [], []
    for i in range(3):
        chunks.append(audio[4 * i:4 * (i + 1)])
        partials.append(astream.sync(chunks))
    assert astream.frames == 12
    assert all(isinstance(p, str) for p in partials)
    mem = astream._mem[0, :astream._mem_t]
    off, _ = encode(rec.params, cfg, torch.from_numpy(audio[None]),
                    torch.ones((1, 12), dtype=torch.uint8))
    np.testing.assert_allclose(mem.numpy(), off[0].numpy(), atol=2e-5)
    assert astream._mem.shape[1] >= astream._mem_t
    assert float(astream._mem[0, astream._mem_t:].abs().max()) == 0.0
    hyps, _ = rec.recognize(audio, nbest=1)
    assert partials[-1] == hyps[0][0]


def test_attention_stream_prefix_restart(banded_model_dir, monkeypatch):
    tmp, cfg = banded_model_dir
    monkeypatch.setattr(attention_stream._AttentionStream, "PREFIX_QUANT", 2)
    rec = Recognizer(str(tmp / "model"), str(tmp / "vocab.txt"), beam_size=2,
                     buckets=(16,), **CPU)
    astream = rec.new_attention_stream(stream_chunk=4)
    audio = _feats(cfg, 16, 9)
    chunks, forced = [], False
    for i in range(4):
        chunks.append(audio[4 * i:4 * (i + 1)])
        last = astream.sync(chunks)
        forced = forced or len(astream._prev_ids) >= 4
    assert isinstance(last, str) and forced


def test_attention_stream_none_for_noncausal(model_dir):
    tmp, _ = model_dir
    rec = Recognizer(str(tmp / "model"), str(tmp / "vocab.txt"), beam_size=2,
                     buckets=(16,), **CPU)
    assert rec.new_attention_stream() is not None  # the tdnn streams
    from pytorch_kaldi_asr_tpu_torch.models.transformer import (
        TransformerConfig,
    )

    rec.cfg = TransformerConfig(**{**vars(rec.cfg), "encoder_type": "banded",
                                   "encoder_sub_sequence": (-8, 2)})
    rec._stream_params = None
    assert rec.new_attention_stream() is None


def test_attention_stream_partial_beam(banded_model_dir):
    """partial_beam narrows only the partials; a greedy partial over the
    whole memory is the beam-1 offline result."""
    tmp, cfg = banded_model_dir
    rec = Recognizer(str(tmp / "model"), str(tmp / "vocab.txt"), beam_size=3,
                     partial_beam=1, buckets=(16,), **CPU)
    assert rec.partial_beam == 1 and rec.beam_size == 3
    astream = rec.new_attention_stream(stream_chunk=4)
    audio = _feats(cfg, 12, 7)
    chunks = []
    for i in range(3):
        chunks.append(audio[4 * i:4 * (i + 1)])
        p = astream.sync(chunks)
    rec1 = Recognizer(str(tmp / "model"), str(tmp / "vocab.txt"),
                      beam_size=1, buckets=(16,), **CPU)
    assert p == rec1.recognize(audio, nbest=1)[0][0][0]


# ---------------------------------------------------------------------------
# against the JAX package's server
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["tdnn", "banded"])
def test_recognizer_matches_jax(model_dir, banded_model_dir, kind):
    tmp, cfg = model_dir if kind == "tdnn" else banded_model_dir
    args = (str(tmp / "model"), str(tmp / "vocab.txt"))
    kw = dict(beam_size=3, buckets=(8, 16))
    ours, theirs = Recognizer(*args, **kw, **CPU), jax_serve.Recognizer(
        *args, **kw)
    feats = [_feats(cfg, t, 20 + t) for t in (5, 12, 30)]
    for f in feats:
        got, want = ours.recognize(f, nbest=3), theirs.recognize(f, nbest=3)
        assert got[1] == want[1]
        assert [t for t, _ in got[0]] == [t for t, _ in want[0]]
        for (_, a), (_, b) in zip(got[0], want[0]):
            assert abs(a - b) <= SCORE_ATOL
    got, _ = ours.recognize_many(feats, nbest=2, batch_pad=4)
    want, _ = theirs.recognize_many(feats, nbest=2, batch_pad=4)
    assert [[t for t, _ in h] for h in got] == [[t for t, _ in h]
                                                for h in want]


def _jax_client(rec):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), jax_serve.make_handler(rec))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, _Client(f"http://127.0.0.1:{httpd.server_address[1]}")


def _keys(obj):
    if isinstance(obj, dict):
        return {k: _keys(v) for k, v in obj.items()
                if k != "latency_hist_ms"}
    if isinstance(obj, list):
        return [_keys(v) for v in obj[:1]]
    return type(obj).__name__


def test_http_json_matches_jax(banded_model_dir, hybrid_setup, monkeypatch):
    """The same requests to the port's and JAX's handlers: the same JSON
    keys and texts, scores within 1e-5, in both modes."""
    monkeypatch.setenv("PKA_NATIVE_LATGEN", "0")
    tmp, cfg = banded_model_dir
    htmp, hcfg = hybrid_setup
    pairs = [
        (Recognizer(str(tmp / "model"), str(tmp / "vocab.txt"), beam_size=3,
                    buckets=(8, 16), **CPU),
         jax_serve.Recognizer(str(tmp / "model"), str(tmp / "vocab.txt"),
                              beam_size=3, buckets=(8, 16)), cfg),
        (_hybrid(htmp, buckets=(32,)),
         jax_serve.HybridRecognizer(str(htmp / "am"), str(htmp / "graph"),
                                    beam=1e9, buckets=(32,)), hcfg)]
    for ours, theirs, c in pairs:
        httpd, jc = _jax_client(theirs)
        try:
            with _server(ours) as pc:
                replies = []
                for client in (pc, jc):
                    # within the largest bucket: no "truncated" partial,
                    # which JAX's server never sends
                    feats = _feats(c, 14, 31)
                    r = [client.post("/recognize",
                                     {"features": feats.tolist(),
                                      "nbest": 2})]
                    sid = client.post("/stream/start")["id"]
                    r.append(client.post(f"/stream/{sid}/push",
                                         {"features": feats.tolist(),
                                          "partial": True}))
                    r.append(client.post(f"/stream/{sid}/finish"))
                    r.append(client.get("/healthz"))
                    replies.append(r)
                for got, want in zip(*replies):
                    got.pop("latency_ms", None)
                    want.pop("latency_ms", None)
                    assert _keys(got) == _keys(want)
                for got, want in zip(replies[0][:3], replies[1][:3]):
                    for g, w in zip(got.get("nbest", []),
                                    want.get("nbest", [])):
                        assert g["text"] == w["text"]
                        assert abs(g["score"] - w["score"]) <= SCORE_ATOL
                    assert got.get("partial") == want.get("partial")
        finally:
            httpd.shutdown()
            httpd.server_close()


def test_hybrid_recognizer_matches_jax(hybrid_setup, monkeypatch):
    monkeypatch.setenv("PKA_NATIVE_LATGEN", "0")
    tmp, cfg = hybrid_setup
    for name in ("am", "am_conformer"):
        ours = _hybrid(tmp, name, buckets=(32,), stream_chunk=4)
        theirs = jax_serve.HybridRecognizer(
            str(tmp / name), str(tmp / "graph"), beam=1e9, buckets=(32,),
            stream_chunk=4)
        for t in (12, 24):
            feats = _feats(cfg, t, 40 + t)
            for nbest in (1, 3):
                got, want = (r.recognize(feats, nbest=nbest)
                             for r in (ours, theirs))
                assert got[1] == want[1]
                assert [x for x, _ in got[0]] == [x for x, _ in want[0]]
                for (_, a), (_, b) in zip(got[0], want[0]):
                    assert abs(a - b) <= SCORE_ATOL
            streams = [r.new_stream() for r in (ours, theirs)]
            for lo in range(0, t, 5):
                pa, pb = (s.push(feats[lo:lo + 5]) for s in streams)
                assert pa == pb
            (text, score), (jtext, jscore) = (s.finish() for s in streams)
            assert text == jtext and abs(score - jscore) <= SCORE_ATOL


def test_memory_search_with_prefix_matches_jax(banded_model_dir):
    """fast_beam_search_memory with a forced prefix (the incremental
    partials' search) against JAX's."""
    from pytorch_kaldi_asr_tpu.decode.fast_beam import (
        fast_beam_search_memory as jax_memory_search,
    )
    from pytorch_kaldi_asr_tpu.train.checkpoint import (
        load_checkpoint as jax_load,
    )
    from pytorch_kaldi_asr_tpu_torch.train.checkpoint import load_checkpoint

    tmp, cfg = banded_model_dir
    params = load_checkpoint(str(tmp / "model"))["params"]
    jparams = jax_load(str(tmp / "model"))["params"]
    feats = _feats(cfg, 14, 50)
    enc, _ = encode(params, cfg, torch.from_numpy(feats[None]),
                    torch.ones((1, 14), dtype=torch.uint8))
    mask = np.zeros((1, 16), np.float32)
    mask[0, :14] = 1
    mem = torch.zeros((1, 16, enc.shape[-1]))
    mem[:, :14] = enc
    for prefix in ([], [4], [5, 6, 4]):
        p = np.asarray([prefix], np.int32).reshape(1, len(prefix))
        got = fast_beam_search_memory(params, cfg, mem, torch.from_numpy(mask),
                                      p, beam_size=3, max_len=10)
        want = jax_memory_search(jparams, cfg, jax.numpy.asarray(mem.numpy()),
                                 jax.numpy.asarray(mask), jax.numpy.asarray(p),
                                 beam_size=3, max_len=10)
        np.testing.assert_array_equal(got.tokens.numpy(),
                                      np.asarray(want.tokens))
        np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                                   atol=SCORE_ATOL)


# ---------------------------------------------------------------------------
# the three repairs of the attention stream
# ---------------------------------------------------------------------------


def test_repair_a_stream_memory_is_capped(banded_model_dir, monkeypatch):
    """The memory's capacity stops doubling at encoder_max_len rounded up
    to a power of two from MEM_PAD, no frame past encoder_max_len is kept,
    and the partials past it say "truncated"."""
    tmp, cfg = banded_model_dir  # encoder_max_len 32
    monkeypatch.setattr(attention_stream._AttentionStream, "MEM_PAD", 8)
    rec = Recognizer(str(tmp / "model"), str(tmp / "vocab.txt"), beam_size=2,
                     buckets=(16,), **CPU)
    astream = rec.new_attention_stream(stream_chunk=4)
    assert astream.max_capacity == 32
    audio, chunks = _feats(cfg, 60, 60), []
    for lo in range(0, 60, 4):
        chunks.append(audio[lo:lo + 4])
        astream.sync(chunks)
        assert astream._mem.shape[1] <= 32
        assert astream.truncated == (lo + 4 > 32)
    assert astream._mem_t == 32 and astream.frames == 32
    # over HTTP: partials past the largest bucket come from the stream,
    # and from encoder_max_len on they carry "truncated"
    rec.new_attention_stream = functools.partial(
        Recognizer.new_attention_stream, rec, stream_chunk=4)
    with _server(rec) as c:
        sid = c.post("/stream/start")["id"]
        for lo in range(0, 48, 4):
            r = c.post(f"/stream/{sid}/push",
                       {"features": audio[lo:lo + 4].tolist(),
                        "partial": True})
            assert r.get("truncated", False) == (lo + 4 > 32), r
            assert isinstance(r["partial"], str)


def test_repair_b_catch_up_runs_outside_the_recognizer_lock(
        banded_model_dir):
    """The streaming encoder's catch-up takes the session's lock, not the
    recognizer's; only the memory search waits for the recognizer.  The
    session keeps the parameters it started with across a reload."""
    tmp, cfg = banded_model_dir
    rec = Recognizer(str(tmp / "model"), str(tmp / "vocab.txt"), beam_size=2,
                     buckets=(16,), **CPU)
    astream = rec.new_attention_stream(stream_chunk=4)
    audio = _feats(cfg, 12, 70)
    done, got = threading.Event(), {}
    with rec.lock:  # another search holds the device
        feeder = threading.Thread(
            target=lambda: (astream.feed([audio]), done.set()), daemon=True)
        feeder.start()
        assert done.wait(timeout=60), "the catch-up waited for the lock"
        assert astream.frames == 12 and astream._mem_t == 12
        searcher = threading.Thread(
            target=lambda: got.setdefault("p", astream.partial()),
            daemon=True)
        searcher.start()
        searcher.join(timeout=0.5)
        assert searcher.is_alive() and "p" not in got  # waits for the lock
    searcher.join(timeout=60)
    assert isinstance(got["p"], str)
    # a reload mid-session: the session's partials stay on its model
    rec.reload(str(tmp / "model2"))
    assert astream.partial() == got["p"]
    fresh = rec.new_attention_stream(stream_chunk=4)
    assert fresh.params is not astream.params


def test_repair_c_stream_is_fed_before_the_crossover(banded_model_dir):
    """From the session's first partial push the stream is fed, so when
    the audio crosses the largest bucket the stream has every earlier
    frame already; while the audio fits, partials are re-decodes (JAX's
    dispatch), equal to /recognize of the same audio."""
    tmp, cfg = banded_model_dir
    rec = Recognizer(str(tmp / "model"), str(tmp / "vocab.txt"), beam_size=2,
                     buckets=(8, 16), **CPU)
    rec.new_attention_stream = functools.partial(
        Recognizer.new_attention_stream, rec, stream_chunk=4)
    store = SessionStore()
    audio = _feats(cfg, 28, 80)
    with _server(rec, sessions=store) as c:
        sid = c.post("/stream/start")["id"]
        for lo in range(0, 28, 4):
            fed_before = (store._sessions[sid]["astream"].frames
                          if "astream" in store._sessions[sid] else 0)
            assert fed_before == lo  # nothing left to catch up
            r = c.post(f"/stream/{sid}/push",
                       {"features": audio[lo:lo + 4].tolist(),
                        "partial": True})
            assert store._sessions[sid]["astream"].frames == lo + 4
            if lo + 4 <= 16:
                assert r["partial"] == rec.recognize(
                    audio[:lo + 4])[0][0][0]
        final = c.post(f"/stream/{sid}/finish")
        assert final["nbest"][0]["text"] == rec.recognize(audio)[0][0][0]


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------


def test_cli_serves_on_a_free_port_and_exits_on_sigterm(model_dir, tmp_path):
    tmp, cfg = model_dir
    log = tmp_path / "serve.log"
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    with open(log, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "pytorch_kaldi_asr_tpu_torch.recipes.serve",
             "-read_model_file", str(tmp / "model"), "-read_vocab_file",
             str(tmp / "vocab.txt"), "-device", "cpu", "-port", "0",
             "-buckets", "8,16", "-beam_size", "2", "-max_batch", "2"],
            cwd=REPO, env=env, stdout=out, stderr=subprocess.STDOUT)
    try:
        port, deadline = None, time.time() + 120
        while port is None and time.time() < deadline:
            assert proc.poll() is None, log.read_text()
            for line in log.read_text().splitlines():
                if "serving on 127.0.0.1:" in line:
                    port = int(line.split("127.0.0.1:")[1].split()[0])
            time.sleep(0.2)
        assert port, log.read_text()
        c = _Client(f"http://127.0.0.1:{port}")
        assert c.get("/healthz")["status"] == "ok"
        out = c.post("/recognize", {"features": _feats(cfg, 7, 90).tolist()})
        assert out["frames"] == 7 and out["nbest"]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    text = log.read_text()
    assert "warmed batched bucket 16" in text
    assert "kernel launches on cpu" in text
    assert "started in" in text
