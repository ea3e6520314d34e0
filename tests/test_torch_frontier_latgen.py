"""The port's top-K frontier Viterbi search (decode/frontier_latgen.py)
against the JAX package's, on the CPU, with the same seeded inputs: the
cases of tests/test_frontier_latgen.py, each run through both packages.

Words and phone frames must be equal and costs within 1e-5 relative.
Also: the split graph's tables equal to JAX's; planted score ties at the
top-K cut and in the closure, where the port keeps JAX's winners (the
four-key sort's order, ``lax.top_k``'s lower index first); the
post-closure cap, where the port gives JAX's divergent answer; the
closure-round cap and the words cap, whose host fallbacks the port counts.
"""

import numpy as np
import pytest
import torch

from pytorch_kaldi_asr_tpu.decode import frontier_latgen as jax_fl
from pytorch_kaldi_asr_tpu_torch.decode import frontier_latgen as fl
from pytorch_kaldi_asr_tpu_torch.decode.latgen import latgen
from pytorch_kaldi_asr_tpu_torch.fst.core import EPS
from tests.torch_search_helpers import (
    PHONES,
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


def _one(T, seed):
    return lambda: posts(T, seed=seed).astype(np.float32)[None]


# name -> (graph builder or None for the lexicon graph, posteriors,
# lengths, decoder keywords); JAX's test_frontier_latgen.py cases
CASES = {
    "batched": (None, lambda: batch([60, 45, 30, 60]),
                np.array([60, 45, 30, 60]), dict(beam=16.0, max_active=2000)),
    "small_arc_budget_splits_states": (
        None, _one(50, 4), None, dict(beam=16.0, max_active=2000, de=2,
                                      dz=2)),
    "priors_and_acoustic_scale": (
        None, _one(50, 3), None,
        dict(acoustic_scale=0.7, beam=16.0, log_priors=_priors())),
    "tight_beam": (None, _one(50, 5), None, dict(beam=4.0, max_active=2000)),
    "tight_max_active": (None, _one(50, 5), None,
                         dict(beam=16.0, max_active=8)),
    "tight_both": (None, _one(50, 5), None, dict(beam=3.0, max_active=5)),
    "narrow_frontier": (None, lambda: batch([60, 41], seed0=6),
                        np.array([60, 41]),
                        dict(beam=16.0, max_active=4, frontier_width=6)),
    "no_epsilon_graph": (
        no_eps_graph, lambda: posts(6, seed=0, n=4).astype(np.float32), None,
        {}),
    "dead_beam": (dead_graph,
                  lambda: np.log(np.full((5, 3), 1 / 3.0, np.float32)), None,
                  {}),
}


def _compare(res, jres):
    if isinstance(jres, list):
        assert len(res) == len(jres)
        for r, j in zip(res, jres):
            assert_same(r, j)
    else:
        assert_same(res, jres)


@pytest.mark.parametrize("case", list(CASES))
def test_frontier_decode_equals_jax(graphs, case):
    build, make_posts, lengths, kw = CASES[case]
    g, jg = graphs if build is None else both(build)
    x = make_posts()
    dec = fl.FrontierLatgen(g, device="cpu", **kw)
    res = dec.decode_batch(x, lengths)
    _compare(res, jax_fl.FrontierLatgen(jg, **kw).decode_batch(x, lengths))
    # a dead frontier's walk starts from no state and breaks: the overflow
    # check comes first, as in JAX, and the host decoder finds no path
    assert dec.host_fallbacks == (case == "dead_beam")
    if case == "small_arc_budget_splits_states":
        assert dec.packed.n_virtual > 0
    if case == "dead_beam":
        assert res is None


def _star(g):
    hub = g.add_state()
    g.start = hub
    for i in range(100):
        leaf = g.add_state()
        g.add_arc(hub, (i % 5) + 1, i + 1, 0.01 * i, leaf)
        g.set_final(leaf)


def test_fat_state_split_structure():
    """A 100-arc star state with de=dz=4 becomes leaves behind a 4-ary
    epsilon tree, table for table JAX's; every real arc survives with its
    labels and weight, and the hub keeps only epsilon links."""
    g, jg = both(_star)
    p = fl._FrontierGraph(g, sym_offset=1, de=4, dz=4)
    jp = jax_fl._FrontierGraph(jg, sym_offset=1, de=4, dz=4)
    for name in ("e_col", "e_il", "e_ol", "e_dst", "e_w", "z_ol", "z_dst",
                 "z_w", "finals", "scores0", "back_init"):
        np.testing.assert_array_equal(getattr(p, name), getattr(jp, name),
                                      err_msg=name)
    assert (p.num_states, p.n_virtual, p.ae, p.has_eps) == \
        (jp.num_states, jp.n_virtual, jp.ae, jp.has_eps)
    assert p.n_virtual >= 25
    got = sorted((int(p.e_ol[s, d]), float(p.e_w[s, d]))
                 for s in range(p.num_states) for d in range(p.de)
                 if np.isfinite(p.e_w[s, d]))
    assert got == [(i + 1, pytest.approx(0.01 * i)) for i in range(100)]
    assert not np.isfinite(p.e_w[0]).any()
    x = np.log(np.full((1, 5), 0.2, np.float32))
    assert_same(fl.frontier_latgen(g, x, de=4, dz=4, device="cpu"),
                jax_fl.frontier_latgen(jg, x, de=4, dz=4))


@pytest.mark.parametrize("width", [None, 3, 4])
def test_frontier_planted_ties_keep_jax_winners(width):
    """Every path of the tie graph costs the same: which states survive a
    top-K cut through equal scores, and which arc wins each state, are the
    sort order's alone; the port keeps JAX's at the default width and at
    widths that cut through the ties."""
    g, jg = both(tie_graph)
    x = tie_posts()
    res = fl.frontier_latgen(g, x, frontier_width=width, device="cpu")
    assert_same(res, jax_fl.frontier_latgen(jg, x, frontier_width=width))
    assert res[0] in ([10], [20])


def test_frontier_words_cap_overflow_falls_back(graphs):
    g, jg = graphs
    x = posts(60, seed=2).astype(np.float32)[None]
    dec = fl.FrontierLatgen(g, beam=16.0, max_active=2000, words_cap=1,
                            device="cpu")
    res = dec.decode_batch(x)
    want = jax_fl.FrontierLatgen(jg, beam=16.0, max_active=2000,
                                 words_cap=1).decode_batch(x)
    assert dec.host_fallbacks == 1 and len(res[0][0]) > 1
    assert_same(res[0], want[0])


def _long_chain(g, n=fl.MAX_EPS_ROUNDS + 40):
    """An epsilon chain longer than the closure's round cap behind the
    first frame, and a direct emitting path that the beam keeps."""
    s0 = g.add_state()
    g.start = s0
    c = g.add_state()
    g.add_arc(s0, 1, 1, 0.0, c)
    for _ in range(n):
        nxt = g.add_state()
        g.add_arc(c, EPS, 0, 0.001, nxt)
        c = nxt
    fin = g.add_state()
    g.set_final(fin)
    g.add_arc(c, 2, 2, 0.0, fin)


def test_closure_round_cap_falls_back():
    """A frame whose closure needs more than MAX_EPS_ROUNDS rounds sets the
    overflow flag (each utterance counts its own rounds, the one-frame
    utterance beside it too): the host decoder takes both over, as in
    JAX."""
    g, jg = both(_long_chain)
    x = np.log(np.array([[[0.9, 0.1], [0.1, 0.9]],
                         [[0.9, 0.1], [0.5, 0.5]]], np.float32))
    dec = fl.FrontierLatgen(g, device="cpu")
    res = dec.decode_batch(x, np.array([2, 1]))
    want = jax_fl.FrontierLatgen(jg).decode_batch(x, np.array([2, 1]))
    host = latgen(g, x[0].astype(np.float64))
    assert dec.host_fallbacks == 2 and res[0][0] == [1, 2]
    _compare(res, want)
    assert_same(res[0], host, rtol=1e-6)


def _layered(g):
    """JAX's ~20k-state layered graph (fat fan-outs included)."""
    rng = np.random.default_rng(42)
    n_layers, width, P = 40, 500, 20
    layers = [[g.add_state() for _ in range(width)]
              for _ in range(n_layers)]
    g.start = layers[0][0]
    for li in range(n_layers - 1):
        for si, s in enumerate(layers[li]):
            fan = 3 if si else 64  # state 0 of each layer is fat
            for t in rng.integers(0, width, size=fan):
                il = int(rng.integers(1, P + 1))
                g.add_arc(s, il, il, float(rng.uniform(0, 2)),
                          layers[li + 1][int(t)])
        for _ in range(8):
            a, b = rng.integers(0, width, size=2)
            g.add_arc(layers[li][int(a)], EPS, EPS,
                      float(rng.uniform(0, 0.5)), layers[li][int(b)])
    for s in layers[-1]:
        g.set_final(s, 0.0)


def test_large_synthetic_graph_equals_jax():
    g, jg = both(_layered)
    assert g.num_states >= 20000
    rng = np.random.default_rng(42)
    x = rng.normal(size=(39, 20))
    x = (x - np.log(np.exp(x).sum(1, keepdims=True))).astype(np.float32)
    kw = dict(beam=8.0, max_active=512)
    res = fl.frontier_latgen(g, x[None], device="cpu", **kw)
    assert_same(res[0], jax_fl.frontier_latgen(jg, x[None], **kw)[0])
    assert_same(res[0], latgen(g, x.astype(np.float64), **kw), rtol=2e-2)


def _closure_fan(g, M=100):
    s0 = g.add_state()
    g.start = s0
    hub = g.add_state()
    g.add_arc(s0, 1, 0, 0.0, hub)
    fin = g.add_state()
    g.set_final(fin, 0.0)
    for i in range(1, M + 1):
        si = g.add_state()
        g.add_arc(hub, EPS, 0, 0.01 * i, si)
        g.add_arc(si, 2, i, 0.0 if i == M else 5.0, fin)


def test_post_closure_cap_divergence_from_host():
    """JAX's documented divergence: the frontier width (64 at max_active
    16) also caps the post-closure states, so the frontier loses the best
    branch, which the host keeps; the port gives JAX's divergent answer,
    with no fallback, and agrees with the host once the width covers every
    live state."""
    g, jg = both(_closure_fan)
    x = np.log(np.array([[0.9, 0.1], [0.1, 0.9]], np.float32))
    host = latgen(g, x.astype(np.float64), beam=1e5, max_active=16)
    dec = fl.FrontierLatgen(g, beam=1e5, max_active=16, device="cpu")
    res = dec.decode_batch(x)
    assert_same(res, jax_fl.frontier_latgen(jg, x, beam=1e5, max_active=16))
    assert host[0] == [100] and res[0] == [1] and res[2] > host[2] + 3.0
    assert dec.host_fallbacks == 0
    wide = fl.frontier_latgen(g, x, beam=1e5, max_active=2000, device="cpu")
    assert_same(wide, host)
