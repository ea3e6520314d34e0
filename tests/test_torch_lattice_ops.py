"""The port's lattice decode and lattice verbs (decode/latgen.py's
``latgen_lattice`` and ``_prune_lattice``, decode/lattice_io.py's
WordLattice, decode/lattice_ops.py) against the JAX package's Python
paths, on the CPU, on the phone-loop HLG and posterior ark of
tests/test_torch_latgen.py's fixture.

Lattices equal node for node and link for link (words equal, costs within
1e-9); n-best, best path, pruning, scaling and the oracle WER give the same
words, costs within 1e-9; the lattice's 1-best is latgen's.
"""

import numpy as np
import pytest

from pytorch_kaldi_asr_tpu.decode import latgen as jax_latgen
from pytorch_kaldi_asr_tpu.decode import lattice_ops as jax_ops
from pytorch_kaldi_asr_tpu.fst.openfst_io import read_fst as jax_read_fst
from pytorch_kaldi_asr_tpu_torch.decode import latgen, lattice_ops
from pytorch_kaldi_asr_tpu_torch.fst.openfst_io import read_fst
from pytorch_kaldi_asr_tpu_torch.io.kaldi_io import read_mat_scp
from pytorch_kaldi_asr_tpu_torch.recipes.mkgraph import read_symbol_table
from tests.test_torch_latgen import setup  # noqa: F401  (the fixture)

COST_ATOL = 1e-9
SETTINGS = {"wide": dict(beam=14.0, lattice_beam=5.0, acoustic_scale=1.0),
            "narrow": dict(beam=6.0, lattice_beam=3.0, acoustic_scale=0.7,
                           max_active=20)}


@pytest.fixture
def lattices(setup, monkeypatch, request):  # noqa: F811
    """Each utterance's lattice from both packages' Python token loops
    (the port's with ``native=False``) at one setting, with log-priors."""
    work, log_priors = setup
    monkeypatch.setenv("PKA_NATIVE_LATGEN", "0")
    graph = read_fst(str(work / "graph" / "HLG.fst"))
    jgraph = jax_read_fst(str(work / "graph" / "HLG.fst"))
    words = read_symbol_table(str(work / "graph" / "words.txt"))
    id2word = {i: w for w, i in words.items()}
    kw = dict(SETTINGS[request.param], log_priors=log_priors,
              id2word=id2word)
    out = []
    for key, mat in read_mat_scp(str(work / "post.scp")):
        got = latgen.latgen_lattice(graph, mat, utt=key, native=False,
                                    **kw)
        want = jax_latgen.latgen_lattice(jgraph, mat, utt=key, **kw)
        assert got is not None and want is not None, key
        out.append((key, mat, got, want))
    return graph, kw, out


def _assert_same_lattice(got, want):
    assert got.node_times == want.node_times
    assert len(got.links) == len(want.links)
    for g, w in zip(got.links, want.links):
        assert (g.start, g.end, g.word) == (w.start, w.end, w.word)
        assert abs(g.acoustic - w.acoustic) <= COST_ATOL
        assert abs(g.graph - w.graph) <= COST_ATOL
    assert got.finals.keys() == want.finals.keys()
    for n, c in got.finals.items():
        assert abs(c - want.finals[n]) <= COST_ATOL
    assert got.utt == want.utt


def _assert_same_hyps(got, want):
    assert [list(h[0]) for h in got] == [list(h[0]) for h in want]
    for g, w in zip(got, want):
        for a, b in zip(g[1:], w[1:]):
            assert abs(a - b) <= COST_ATOL


@pytest.mark.parametrize("lattices", list(SETTINGS), indirect=True)
def test_latgen_lattice_equals_jax(lattices):
    graph, kw, utts = lattices
    for key, mat, got, want in utts:
        _assert_same_lattice(got, want)
        # the lattice's best path is latgen's 1-best
        words, cost = got.best_path()
        best = latgen.latgen(graph, mat, beam=kw["beam"],
                             acoustic_scale=kw["acoustic_scale"],
                             max_active=kw.get("max_active", 2000),
                             log_priors=kw["log_priors"])
        assert words == [kw["id2word"][w] for w in best[0]]
        assert abs(cost - best[2]) <= 1e-6


@pytest.mark.parametrize("lattices", list(SETTINGS), indirect=True)
def test_prune_lattice_equals_jax(lattices):
    _, _, utts = lattices
    for _, _, got, want in utts:
        for beam in (0.0, 1.5, 4.0):
            _assert_same_lattice(latgen._prune_lattice(got, beam),
                                 jax_latgen._prune_lattice(want, beam))
            _assert_same_lattice(lattice_ops.prune_lattice(got, beam),
                                 jax_ops.prune_lattice(want, beam))


def _assert_extends(got, want, n):
    """The port's n-best is JAX's where JAX's search finished; where JAX's
    gave up at its pop cap (fewer than n, a warning), JAX's is a prefix of
    the port's, which expands each (node, words) state once."""
    assert len(got) >= len(want) and len(got) <= n
    _assert_same_hyps(got[:len(want)], want)


@pytest.mark.parametrize("lattices", list(SETTINGS), indirect=True)
def test_nbest_and_best_path_equal_jax(lattices):
    _, _, utts = lattices
    for _, _, got, want in utts:
        for n in (1, 4):
            _assert_extends(lattice_ops.nbest(got, n),
                            jax_ops.nbest(want, n), n)
        _assert_extends(
            lattice_ops.nbest(got, 2, acoustic_scale=0.5, lm_scale=2.0,
                              with_components=True),
            jax_ops.nbest(want, 2, acoustic_scale=0.5, lm_scale=2.0,
                          with_components=True), 2)
        hyps = lattice_ops.nbest(got, 4)
        assert [c for _, c in hyps] == sorted(c for _, c in hyps)
        assert len({tuple(w) for w, _ in hyps}) == len(hyps)
        _assert_same_hyps([lattice_ops.best_path(got, lm_scale=1.5)],
                          [jax_ops.best_path(want, lm_scale=1.5)])
        assert hyps[0][0] == lattice_ops.best_path(got)[0]


@pytest.mark.parametrize("lattices", ["wide"], indirect=True)
def test_scale_and_oracle_equal_jax(lattices, setup):  # noqa: F811
    work, _ = setup
    _, _, utts = lattices
    text = {line.split()[0]: line.split()[1:]
            for line in (work / "text").read_text().splitlines()}
    for key, _, got, want in utts:
        for inplace in (False, True):
            g = lattice_ops.scale_lattice(got, acoustic_scale=0.3,
                                          lm_scale=1.7, inplace=inplace)
            w = jax_ops.scale_lattice(want, acoustic_scale=0.3, lm_scale=1.7,
                                      inplace=inplace)
            _assert_same_lattice(g, w)
        assert lattice_ops.oracle_wer(got, text[key]) == \
            jax_ops.oracle_wer(want, text[key])
        errors, words = lattice_ops.oracle_wer(got, text[key])
        assert errors <= len(text[key]) and isinstance(words, list)
        a, b, total = got.alpha_beta()
        ja, jb, jtotal = want.alpha_beta()
        np.testing.assert_allclose(a, ja, atol=COST_ATOL)
        assert abs(total - jtotal) <= COST_ATOL
        posts = [p for _, p in got.forward_backward()]
        jposts = [p for _, p in want.forward_backward()]
        np.testing.assert_allclose(posts, jposts, atol=COST_ATOL)


def _random_lattice(seed, n_nodes=9, n_links=26):
    """A random DAG lattice: links go forward in node order, some words
    epsilon, several final nodes."""
    from pytorch_kaldi_asr_tpu_torch.decode.lattice_io import WordLattice

    rng = np.random.default_rng(seed)
    lat = WordLattice(node_times=list(range(n_nodes)))
    for i in range(n_nodes - 1):  # a path through every node
        lat.add_link(i, i + 1, str(rng.choice(["a", "b", "<eps>"])),
                     float(rng.uniform(0, 3)), float(rng.uniform(0, 2)))
    for _ in range(n_links - n_nodes + 1):
        a, b = sorted(rng.choice(n_nodes, size=2, replace=False))
        lat.add_link(int(a), int(b), str(rng.choice(["a", "b", "c",
                                                     "<eps>"])),
                     float(rng.uniform(0, 3)), float(rng.uniform(0, 2)))
    for node in (n_nodes - 1, n_nodes - 2, n_nodes // 2):
        lat.finals[node] = float(rng.uniform(0, 1))
    return lat


@pytest.mark.parametrize("seed", range(6))
def test_nbest_is_exact_against_every_path(seed):
    """Every path of a small lattice enumerated: the cheapest cost of each
    distinct word sequence, the n lowest, are the port's n-best (the
    search that expands each (node, words) state once loses nothing)."""
    lat = _random_lattice(seed)
    out = lat.out_links()
    best = {}

    def walk(node, words, cost):
        if node in lat.finals:
            total = cost + lat.finals[node]
            best[words] = min(best.get(words, np.inf), total)
        for link in out[node]:
            w = words if link.word == "<eps>" else words + (link.word,)
            walk(link.end, w, cost + link.cost)

    walk(0, (), 0.0)
    want = sorted(best.items(), key=lambda kv: kv[1])
    for n in (1, 3, 10):
        got = lattice_ops.nbest(lat, n)
        assert len(got) == min(n, len(want))
        for (words, cost), (w_words, w_cost) in zip(got, want):
            assert abs(cost - w_cost) <= COST_ATOL
            assert abs(best[tuple(words)] - cost) <= COST_ATOL


def test_dead_beam_gives_no_lattice(setup):  # noqa: F811
    work, _ = setup
    graph = read_fst(str(work / "graph" / "HLG.fst"))
    _, mat = next(iter(read_mat_scp(str(work / "post.scp"))))
    # no graph arc reads a column past the posteriors' width
    assert latgen.latgen_lattice(graph, mat[:, :0]) is None
