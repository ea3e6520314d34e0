"""The port's confusion networks, consensus (MBR) decoding, CTM lines,
ROVER (decode/confusion.py), posterior best paths (decode/best_path.py)
and CTM refinement (decode/align.refine_ctm_times) against the JAX
package's, on the CPU.

Over the 4-word lexicon's latgen lattices (tests/torch_lattice_helpers.py)
and random lattices: the sausage's bins (spans, words, posteriors within
1e-12), the consensus entries and their CTM lines byte for byte;
``read_ctm``, ``rover`` and ``rover_ctms`` equal; the best-path tables and
the frame error rate equal; ``refine_ctm_times``' lines equal.
"""

import numpy as np
import pytest
import torch

from pytorch_kaldi_asr_tpu.decode import align as jax_align
from pytorch_kaldi_asr_tpu.decode import best_path as jax_best_path
from pytorch_kaldi_asr_tpu.decode import confusion as jax_confusion
from pytorch_kaldi_asr_tpu.decode import lattice_io as jax_lio
from pytorch_kaldi_asr_tpu.io.kaldi_io import ArkWriter
from pytorch_kaldi_asr_tpu_torch.decode import align, best_path, confusion
from pytorch_kaldi_asr_tpu_torch.decode.lattice_io import WordLattice
from tests.torch_lattice_helpers import build, lattices

torch.set_num_threads(1)

POST_ATOL = 1e-12


@pytest.fixture(scope="module")
def lats(tmp_path_factory):
    return lattices(build(tmp_path_factory.mktemp("confusion")))[0]


def _random_pair(seed, n_nodes=10, n_links=24):
    """A random DAG lattice in both packages: node times increasing, a
    path through every node, some epsilon links, a repeated word, two
    final nodes."""
    rng = np.random.default_rng(seed)
    times = sorted(int(t) for t in rng.choice(4 * n_nodes, size=n_nodes,
                                              replace=False))
    links = [(i, i + 1) for i in range(n_nodes - 1)]
    links += [tuple(sorted(int(x) for x in rng.choice(n_nodes, 2, False)))
              for _ in range(n_links - n_nodes + 1)]
    got = WordLattice(node_times=list(times), utt=f"r{seed}")
    want = jax_lio.WordLattice(node_times=list(times), utt=f"r{seed}")
    for a, b in links:
        word = str(rng.choice(["aa", "bb", "cc", "<eps>"]))
        ac, gr = float(rng.uniform(0, 4)), float(rng.uniform(0, 2))
        got.add_link(a, b, word, ac, gr)
        want.add_link(a, b, word, ac, gr)
    for n in (n_nodes - 1, n_nodes - 2):
        got.finals[n] = want.finals[n] = float(rng.uniform(0, 1))
    return got, want


def _pairs(lats):
    """The latgen lattices, small random ones, and larger random ones
    whose clusters open and join many bins."""
    return list(lats.values()) + [_random_pair(s) for s in range(5)] + [
        _random_pair(s, n_nodes=40, n_links=160) for s in range(5, 9)]


def _same_bins(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.start, g.end) == (w.start, w.end)
        assert sorted(g.words) == sorted(w.words)
        for word, p in g.words.items():
            assert abs(p - w.words[word]) <= POST_ATOL
        assert g.best()[0] == w.best()[0]


@pytest.mark.parametrize("scales", [(1.0, 1.0, 1e-4), (0.3, 1.5, 1e-3)])
def test_confusion_network_equals_jax(lats, scales):
    acoustic_scale, lm_scale, prune = scales
    for got, want in _pairs(lats):
        kw = dict(acoustic_scale=acoustic_scale, lm_scale=lm_scale,
                  prune=prune)
        _same_bins(confusion.confusion_network(got, **kw),
                   jax_confusion.confusion_network(want, **kw))


def test_consensus_mbr_and_ctm_lines_equal_jax(lats):
    for got, want in _pairs(lats):
        entries = confusion.consensus(confusion.confusion_network(
            got, acoustic_scale=0.5))
        jentries = jax_confusion.consensus(jax_confusion.confusion_network(
            want, acoustic_scale=0.5))
        assert [e[0] for e in entries] == [e[0] for e in jentries]
        for frame_rate, channel in ((0.01, 1), (0.03, "A")):
            assert confusion.ctm_lines(got.utt, entries,
                                       frame_rate=frame_rate,
                                       channel=channel) == \
                jax_confusion.ctm_lines(want.utt, jentries,
                                        frame_rate=frame_rate,
                                        channel=channel)
        words, confs = confusion.mbr_decode(got, lm_scale=2.0)
        jwords, jconfs = jax_confusion.mbr_decode(want, lm_scale=2.0)
        assert words == jwords
        np.testing.assert_allclose(confs, jconfs, atol=POST_ATOL)
    # on the latgen lattices the consensus is the spoken sentence
    got, _ = lats["u1"]
    assert confusion.mbr_decode(got)[0] == ["bat", "at", "tab"]


def test_read_ctm_equals_jax(tmp_path):
    path = tmp_path / "x.ctm"
    path.write_text(";; a comment\nu2 1 0.50 0.10 bb 0.9\n"
                    "u1 1 0.30 0.20 aa\nu1 1 0.10 0.10 cc 0.25\nshort line\n"
                    "u2 1 0.00 0.30 aa 0.75\n")
    assert confusion.read_ctm(str(path)) == jax_confusion.read_ctm(str(path))


ROVER_CASES = [
    [[("a", 0.9), ("b", 0.8), ("c", 0.7)], [("a", 0.6), ("x", 0.9)],
     [("a", 0.5), ("b", 0.4), ("c", 0.9), ("d", 0.2)]],
    [[("a", 1.0)], [], [("b", 0.3), ("a", 0.9)]],
    [[("s", 0.5), ("s", 0.5), ("t", 0.1)]],
    [],
]


@pytest.mark.parametrize("case", range(len(ROVER_CASES)))
@pytest.mark.parametrize("alpha,null_conf", [(0.5, 0.7), (0.2, 0.3)])
def test_rover_equals_jax(case, alpha, null_conf):
    hyps = ROVER_CASES[case]
    assert confusion.rover(hyps, alpha=alpha, null_conf=null_conf) == \
        jax_confusion.rover(hyps, alpha=alpha, null_conf=null_conf)


def test_rover_ctms_equals_jax(tmp_path):
    systems = []
    for i, text in enumerate(["u1 1 0 1 a 0.9\nu1 1 1 1 b 0.8\n"
                              "u2 1 0 1 c 0.5\n",
                              "u1 1 0 1 a 0.4\nu1 1 1 1 c 0.95\n",
                              "u1 1 0 1 a 0.7\nu2 1 0 1 d 0.6\n"
                              "u3 1 0 1 e 0.1\n"]):
        (tmp_path / f"{i}.ctm").write_text(text)
        systems.append(str(tmp_path / f"{i}.ctm"))
    got = confusion.rover_ctms([confusion.read_ctm(p) for p in systems])
    want = jax_confusion.rover_ctms([jax_confusion.read_ctm(p)
                                     for p in systems])
    assert got == want and sorted(got) == ["u1", "u2", "u3"]


@pytest.fixture(scope="module")
def posterior_table(tmp_path_factory):
    """A posterior ark with runs of one class, a blank class, and frame
    alignments (one utterance without)."""
    work = tmp_path_factory.mktemp("best_path")
    rng = np.random.default_rng(4)
    ali = {}
    with ArkWriter(str(work / "post.ark"), str(work / "post.scp")) as w:
        for u in range(4):
            ids = np.repeat(rng.integers(0, 6, size=7),
                            rng.integers(1, 4, size=7))
            x = rng.normal(size=(len(ids), 6))
            x[np.arange(len(ids)), ids] += 2.0
            w.write(f"utt{u}", x.astype(np.float32))
            if u != 2:
                noisy = np.where(rng.random(len(ids)) < 0.2, 0, ids)
                ali[f"utt{u}"] = " ".join(map(str, noisy))
    return work, ali


@pytest.mark.parametrize("collapse,blank", [(True, None), (True, 0),
                                            (False, None)])
def test_best_path_tables_equal_jax(posterior_table, collapse, blank):
    work, _ = posterior_table
    id2label = {i: f"p{i}" for i in range(5)}
    for spec in (f"ark:{work / 'post.ark'}", f"scp:{work / 'post.scp'}"):
        for labels in (None, id2label):
            got = best_path.decode_posterior_table(
                spec, collapse=collapse, blank=blank, id2label=labels)
            want = jax_best_path.decode_posterior_table(
                spec, collapse=collapse, blank=blank, id2label=labels)
            assert got == want and len(got) == 4
    mat = np.log(np.eye(4)[[0, 0, 1, 1, 0, 2, 2, 3]] + 1e-3)
    assert best_path.best_path(mat, blank=0) == \
        jax_best_path.best_path(mat, blank=0) == [1, 2, 3]


def test_frame_error_rate_equals_jax(posterior_table):
    work, ali = posterior_table
    spec = f"ark:{work / 'post.ark'}"
    got = best_path.frame_error_rate(spec, ali)
    assert got == jax_best_path.frame_error_rate(spec, ali)
    assert 0.0 < got[0] < 1.0 and got[1] > 0


def test_refine_ctm_times_equals_jax():
    """Utterances whose CTM words match their alignment get its times;
    a mismatch and an utterance without an alignment keep theirs."""
    id2word = {1: "aa", 2: "bb", 3: "cc"}
    segments = [(1, 0, 4), (2, 5, 11), (3, 12, 12)]

    def pair(mod):
        return mod.Alignment([mod.WordSegment(*s) for s in segments],
                             [0] * 13, 1.0)

    ctm = ["u1 1 0.00 0.03 aa 0.91", "u1 1 0.03 0.05 bb 0.50",
           "u1 1 0.08 0.01 cc 1.00", "", "u2 1 0.00 0.02 aa 0.70",
           "u3 1 0.10 0.02 aa 0.40 extra"]
    got = align.refine_ctm_times(
        ctm, {"u1": (pair(align), id2word), "u2": (pair(align), id2word)},
        frame_rate=0.02)
    want = jax_align.refine_ctm_times(
        ctm, {"u1": (pair(jax_align), id2word),
              "u2": (pair(jax_align), id2word)}, frame_rate=0.02)
    assert got == want
    assert got[1] == 1 and got[0][0] == "u1 1 0.00 0.10 aa 0.91"
