"""Shared inputs of tests/test_torch_device_latgen.py and
tests/test_torch_frontier_latgen.py: the 4-word lexicon's bigram graph
built by each package's mkgraph, hand-built graphs in both packages' Fst,
seeded posteriors, and the comparison of two decoders' outputs."""

import numpy as np

from pytorch_kaldi_asr_tpu.fst.core import Fst as JaxFst
from pytorch_kaldi_asr_tpu.fst.graph import mkgraph as jax_mkgraph
from pytorch_kaldi_asr_tpu.lm.ngram import train_ngram_lm as jax_train
from pytorch_kaldi_asr_tpu_torch.fst.core import EPS, Fst
from pytorch_kaldi_asr_tpu_torch.fst.graph import mkgraph
from pytorch_kaldi_asr_tpu_torch.lm.ngram import train_ngram_lm

PHONES = {p: i + 1 for i, p in enumerate(["a", "b", "k", "t", "sil"])}
LEXICON = {
    "bat": ["b", "a", "t"],
    "back": ["b", "a", "k"],
    "at": ["a", "t"],
    "tab": ["t", "a", "b"],
}
SENTS = ["bat at tab", "back at bat", "tab tab at", "bat back",
         "at tab back bat"]
COST_RTOL = 1e-5


def lexicon_graphs():
    """(port graph, JAX graph): the lexicon's bigram HLG, each package's
    own mkgraph."""
    word_syms = {w: i + 1 for i, w in enumerate(sorted(LEXICON))}
    sents = [s.split() for s in SENTS]
    port, _ = mkgraph(LEXICON, train_ngram_lm(sents, order=2), word_syms,
                      PHONES)
    jax, _ = jax_mkgraph(LEXICON, jax_train(sents, order=2), word_syms,
                         PHONES)
    return port, jax


def both(build):
    """``build(fst)`` run on a fresh port Fst and a fresh JAX Fst."""
    graphs = []
    for cls in (Fst, JaxFst):
        g = cls()
        build(g)
        graphs.append(g)
    return tuple(graphs)


def posts(T=60, seed=0, peak=5.0, n=len(PHONES)):
    """Seeded [T, n] log-posteriors peaked on a random phone path."""
    rng = np.random.default_rng(seed)
    path = rng.integers(1, n + 1, size=T)
    logits = rng.normal(size=(T, n))
    logits[np.arange(T), path - 1] += peak
    return logits - np.log(np.exp(logits).sum(1, keepdims=True))


def batch(lens, seed0=0):
    """A zero-padded [B, max(lens), P] float32 batch of ``posts``."""
    out = np.zeros((len(lens), max(lens), len(PHONES)), np.float32)
    for b, L in enumerate(lens):
        out[b, :L] = posts(L, seed=seed0 + b)
    return out


def no_eps_graph(g):
    states = [g.add_state() for _ in range(4)]
    g.start = states[0]
    for i in range(3):
        g.add_arc(states[i], i + 1, i + 1, 0.1 * i, states[i + 1])
        g.add_arc(states[i], 3 - i if 3 - i > 0 else 1, 0, 0.5,
                  states[i])  # emitting self-loop, no output
    g.set_final(states[3], 0.25)


def dead_graph(g):
    # the only emitting label has no posterior column: the beam dies
    s0, s1 = g.add_state(), g.add_state()
    g.start = s0
    g.add_arc(s0, 99, 1, 0.0, s1)
    g.set_final(s1)


def tie_graph(g, fan=6):
    """Planted exact ties: from the start, ``fan`` emitting arcs of phone 1
    (weight 0.5, one word each) reach ``fan`` hub states that all emit
    phone 2 into ONE final state at the same weight, so every path costs
    the same and the winner is decided by the tie-break alone (the dense
    search's lowest arc id, the frontier's (age, arc) order).  A second
    branch joins through epsilon arcs of equal weight, so the closure
    ties as well."""
    s0 = g.add_state()
    g.start = s0
    fin = g.add_state()
    g.set_final(fin, 0.0)
    for i in range(fan):
        hub = g.add_state()
        g.add_arc(s0, 1, 10 + i, 0.5, hub)
        g.add_arc(hub, 2, 0, 0.25, fin)
        via = g.add_state()
        g.add_arc(hub, EPS, 20 + i, 0.0, via)
        g.add_arc(via, 2, 0, 0.25, fin)


def tie_posts(T=2):
    """Frames that make phone 1 then phone 2 equally likely everywhere:
    the planted ties stay exact in float32."""
    return np.log(np.full((T, 2), 0.5, np.float32))


def assert_same(got, want, rtol=COST_RTOL):
    """Two decoders' outputs: None alike, else the same words and phones
    and costs within ``rtol`` relative."""
    assert (got is None) == (want is None), (got, want)
    if want is None:
        return
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert abs(got[2] - want[2]) <= rtol * max(1.0, abs(want[2])), \
        (got[2], want[2])
