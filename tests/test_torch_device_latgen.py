"""The port's dense batched Viterbi search (decode/device_latgen.py) against
the JAX package's, on the CPU, with the same seeded inputs: the cases of
tests/test_device_latgen.py, each run through both packages.

Both search in float32 with the same sum order, so the words and phone
frames must be equal and the costs within 1e-5 relative (they agree to
the bit here).  Also: planted score ties, where the port keeps JAX's
winners (the lowest arc id); the words-cap overflow, whose host fallback
the port counts; ``decode_posterior_stream``'s padded batches; the
size-based choice of decoder; the latgen CLI's ``-device_search`` on
``-device cpu``, byte for byte JAX's; and the card asked for where there
is none.
"""

import numpy as np
import pytest
import torch

from pytorch_kaldi_asr_tpu.decode import device_latgen as jax_dl
from pytorch_kaldi_asr_tpu.decode import frontier_latgen as jax_fl
from pytorch_kaldi_asr_tpu_torch.decode import device_latgen as dl
from pytorch_kaldi_asr_tpu_torch.decode import frontier_latgen as fl
from pytorch_kaldi_asr_tpu_torch.decode.latgen import StreamingLatgen
from tests.torch_search_helpers import (
    LEXICON,
    PHONES,
    SENTS,
    assert_same,
    batch,
    both,
    dead_graph,
    lexicon_graphs,
    no_eps_graph,
    posts,
    tie_graph,
    tie_posts,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def graphs():
    return lexicon_graphs()


def _priors():
    rng = np.random.default_rng(11)
    pri = rng.normal(scale=0.3, size=len(PHONES))
    return pri - np.log(np.exp(pri).sum())


# name -> (graph builder or None for the lexicon graph, posteriors,
# lengths, decoder keywords); JAX's test_device_latgen.py cases
CASES = {
    "batched": (None, lambda: batch([60, 45, 30, 60]),
                np.array([60, 45, 30, 60]), dict(beam=16.0, max_active=2000)),
    "single_2d": (None, lambda: posts(40, seed=7).astype(np.float32), None,
                  dict(beam=16.0)),
    "priors_and_acoustic_scale": (
        None, lambda: posts(50, seed=3).astype(np.float32)[None], None,
        dict(acoustic_scale=0.7, beam=16.0, log_priors=_priors())),
    "tight_beam": (None, lambda: posts(50, seed=5).astype(np.float32)[None],
                   None, dict(beam=4.0, max_active=2000)),
    "tight_max_active": (
        None, lambda: posts(50, seed=5).astype(np.float32)[None], None,
        dict(beam=16.0, max_active=8)),
    "tight_both": (None, lambda: posts(50, seed=5).astype(np.float32)[None],
                   None, dict(beam=3.0, max_active=5)),
    "no_epsilon_graph": (
        no_eps_graph, lambda: posts(6, seed=0, n=4).astype(np.float32), None,
        {}),
    "dead_beam": (dead_graph,
                  lambda: np.log(np.full((5, 3), 1 / 3.0, np.float32)), None,
                  {}),
}


def _graph(graphs, build):
    return graphs if build is None else both(build)


def _compare(res, jres):
    if isinstance(jres, list):
        assert len(res) == len(jres)
        for r, j in zip(res, jres):
            assert_same(r, j)
    else:
        assert_same(res, jres)


@pytest.mark.parametrize("case", list(CASES))
def test_dense_decode_equals_jax(graphs, case):
    build, make_posts, lengths, kw = CASES[case]
    g, jg = _graph(graphs, build)
    x = make_posts()
    dec = dl.DeviceLatgen(g, device="cpu", **kw)
    res = dec.decode_batch(x, lengths)
    _compare(res, jax_dl.DeviceLatgen(jg, **kw).decode_batch(x, lengths))
    assert dec.host_fallbacks == 0
    if case == "dead_beam":
        assert res is None


def test_dense_planted_ties_keep_jax_winner():
    """Every path of the tie graph costs the same: the emit step's argmin
    and the closure's pick the lowest arc id, as in JAX."""
    g, jg = both(tie_graph)
    x = tie_posts()
    res = dl.device_latgen(g, x, device="cpu")
    assert_same(res, jax_dl.device_latgen(jg, x))
    assert res[0] == [10]  # the first hub's word: the lowest arc id


def test_dense_words_cap_overflow_falls_back(graphs):
    """words_cap=1 overflows the traceback: the host decoder takes the
    utterance over (counted) and returns the full hypothesis, JAX's."""
    g, jg = graphs
    x = posts(60, seed=2).astype(np.float32)[None]
    dec = dl.DeviceLatgen(g, beam=16.0, max_active=2000, words_cap=1,
                          device="cpu")
    res = dec.decode_batch(x)
    want = jax_dl.DeviceLatgen(jg, beam=16.0, max_active=2000,
                               words_cap=1).decode_batch(x)
    assert dec.host_fallbacks == 1 and len(res[0][0]) > 1
    assert_same(res[0], want[0])
    assert dec.decode_batch(x, np.array([60])) and dec.host_fallbacks == 2


def test_dense_streaming_oracle_agrees_with_batch(graphs):
    """The port's host decoder fed in chunks gives the device search's
    words and phones (float64 against float32 costs)."""
    g, jg = graphs
    x = posts(48, seed=9)
    dec = StreamingLatgen(g, beam=16.0, max_active=2000)
    assert dec.push(x[:20]) and dec.push(x[20:])
    host = dec.finish()
    res = dl.device_latgen(g, x.astype(np.float32)[None], device="cpu")[0]
    assert res[:2] == host[:2] and abs(res[2] - host[2]) < 5e-3
    assert_same(res, jax_dl.device_latgen(jg, x.astype(np.float32)[None])[0])


@pytest.mark.parametrize("mode", ["dense", "frontier"])
def test_decode_posterior_stream_equals_jax(graphs, mode):
    """Padded batches of 2 over 3 utterances (the last batch ragged): the
    same (key, words, cost) stream as JAX's, in input order."""
    g, jg = graphs
    word_syms = {w: i + 1 for i, w in enumerate(sorted(LEXICON))}
    stream = [(f"u{i}", posts(T, seed=i).astype(np.float32))
              for i, T in enumerate([42, 30, 57])]
    got = list(dl.decode_posterior_stream(g, iter(stream), word_syms,
                                          batch_size=2, beam=16.0,
                                          mode=mode, device="cpu"))
    want = list(jax_dl.decode_posterior_stream(jg, iter(stream), word_syms,
                                               batch_size=2, beam=16.0,
                                               mode=mode))
    assert [k for k, _, _ in got] == ["u0", "u1", "u2"]
    for (k, w, c), (jk, jw, jc) in zip(got, want):
        assert (k, w) == (jk, jw) and abs(c - jc) <= 1e-5 * abs(jc)


def test_auto_dispatch_picks_by_graph_size(graphs):
    """JAX's bounds, JAX's choices: dense for the lexicon graph, the
    frontier past DENSE_MAX_STATES; an unknown mode is refused."""
    g, jg = graphs
    assert (dl.DENSE_MAX_STATES, dl.DENSE_MAX_ARCS) == \
        (jax_dl.DENSE_MAX_STATES, jax_dl.DENSE_MAX_ARCS)
    assert isinstance(dl.make_device_latgen(g, device="cpu"),
                      dl.DeviceLatgen)
    assert isinstance(jax_dl.make_device_latgen(jg), jax_dl.DeviceLatgen)
    assert isinstance(dl.make_device_latgen(g, mode="frontier",
                                            device="cpu"), fl.FrontierLatgen)

    def chain(big):
        states = [big.add_state() for _ in range(dl.DENSE_MAX_STATES + 808)]
        big.start = states[0]
        for i in range(len(states) - 1):
            big.add_arc(states[i], 1, 0, 0.0, states[i + 1])
        big.set_final(states[-1])

    big, jbig = both(chain)
    assert dl.pick_mode(big) == "frontier"
    assert isinstance(dl.make_device_latgen(big, device="cpu"),
                      fl.FrontierLatgen)
    assert isinstance(jax_dl.make_device_latgen(jbig), jax_fl.FrontierLatgen)
    with pytest.raises(ValueError, match="unknown device-search mode"):
        dl.make_device_latgen(g, mode="sparse", device="cpu")


def test_device_search_needs_a_card_or_cpu(graphs):
    """The entry points run on the card unless the caller asks for the
    CPU; without a card they raise rather than fall back."""
    g, _ = graphs
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    for cls in (dl.DeviceLatgen, fl.FrontierLatgen):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(g)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dl.make_device_latgen(g)


def _cli_setup(tmp_path):
    from pytorch_kaldi_asr_tpu.io.kaldi_io import ArkWriter
    from pytorch_kaldi_asr_tpu.lm.arpa import write_arpa
    from pytorch_kaldi_asr_tpu.lm.ngram import train_ngram_lm
    from pytorch_kaldi_asr_tpu_torch.recipes import mkgraph as mkgraph_cli

    (tmp_path / "phones.txt").write_text(
        "".join(f"{p} {i}\n" for p, i in PHONES.items()))
    (tmp_path / "lexicon.txt").write_text("".join(
        f"{w} {' '.join(ph)}\n" for w, ph in LEXICON.items()))
    write_arpa(train_ngram_lm([s.split() for s in SENTS], order=2),
               str(tmp_path / "lm.arpa"))
    assert mkgraph_cli.main([
        "-phones", str(tmp_path / "phones.txt"), "-lexicon",
        str(tmp_path / "lexicon.txt"), "-lm", str(tmp_path / "lm.arpa"),
        "-graph_dir", str(tmp_path / "graph")]) == 0
    with ArkWriter(str(tmp_path / "post.ark")) as w:
        for i, T in enumerate([42, 30, 57]):  # uneven lengths: padding
            w.write(f"u{i}", posts(T, seed=i).astype("float32"))
    return ["-graph_dir", str(tmp_path / "graph"), "-rspecifier",
            f"ark:{tmp_path / 'post.ark'}", "-beam", "16.0"]


@pytest.mark.parametrize("mode", ["auto", "dense", "frontier"])
def test_latgen_cli_device_search_equals_jax(tmp_path, mode, monkeypatch):
    """recipes/latgen.py -device_search -device cpu writes JAX's CLI's
    bytes and the host decoder's hypotheses, and logs the decoder it ran
    and its host fallbacks."""
    from pytorch_kaldi_asr_tpu.recipes import latgen as jax_latgen_cli
    from pytorch_kaldi_asr_tpu_torch.recipes import latgen as latgen_cli

    logged = []
    monkeypatch.setattr(latgen_cli, "info",
                        lambda msg, *args: logged.append(msg % args))
    base = _cli_setup(tmp_path)
    flags = ["-device_search", "-device_batch", "2", "-device_mode", mode]
    outs = {}
    for name, cli, extra in (("host", latgen_cli, []),
                             ("port", latgen_cli, flags + ["-device", "cpu"]),
                             ("jax", jax_latgen_cli, flags)):
        outs[name] = tmp_path / f"{name}.txt"
        assert cli.main(base + ["-save_result_file", str(outs[name]),
                                *extra]) == 0
    assert outs["port"].read_bytes() == outs["jax"].read_bytes()
    assert outs["port"].read_bytes() == outs["host"].read_bytes()
    assert len(outs["port"].read_text().splitlines()) == 3
    err = "\n".join(logged)
    picked = "dense" if mode == "auto" else mode
    assert f"device search: {picked} decoder (-device_mode {mode}) on cpu" \
        in err
    assert "device search: 0 host fallbacks" in err
