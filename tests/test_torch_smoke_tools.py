"""chip_smoke.py's tools phase, its CPU parts rehearsed on the CPU: the
lattice gate (``lattice_form``: the native core's lattice and the Python
token passer's say the same, and a planted change says otherwise), the
noisy posteriors (bench_rtf's noise, renormalised), and the proto DNN's
step and mask check (``_proto_step_on``, ``proto_masks_equal``) at a
narrow width, with ``card_vs_cpu_step``'s gate."""

import copy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke as cs  # noqa: E402
from pytorch_kaldi_asr_tpu_torch.decode.latgen import latgen_lattice  # noqa
from pytorch_kaldi_asr_tpu_torch.decode.lattice_io import Link  # noqa
from pytorch_kaldi_asr_tpu_torch.fst.graph import mkgraph  # noqa: E402
from pytorch_kaldi_asr_tpu_torch.lm.ngram import train_ngram_lm  # noqa

torch.set_num_threads(1)
PHONES = {p: i + 1 for i, p in enumerate(["a", "b", "k", "t"])}
LEXICON = {"bat": ["b", "a", "t"], "back": ["b", "a", "k"],
           "at": ["a", "t"], "tab": ["t", "a", "b"]}


@pytest.fixture(scope="module")
def lattices():
    """Both decoders' lattices of a noisy utterance over the 4-word HLG,
    at a beam that records duplicate links."""
    words = sorted(LEXICON)
    lm = train_ngram_lm([s.split() for s in ["bat at tab", "back at bat",
                                             "tab tab at", "at tab back"]],
                        order=2)
    graph, _ = mkgraph(LEXICON, lm, {w: i + 1 for i, w in enumerate(words)},
                       PHONES)
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(50, len(PHONES)))
    logits[np.arange(50), rng.integers(0, len(PHONES), 50)] += 3.0
    posts = logits - np.log(np.exp(logits).sum(1, keepdims=True))
    kw = dict(beam=14.0, lattice_beam=8.0, max_active=2000,
              id2word={i + 1: w for i, w in enumerate(words)}, utt="u")
    return (latgen_lattice(graph, posts, **kw),
            latgen_lattice(graph, posts, native=False, **kw))


def test_lattice_form_holds_native_against_python(lattices):
    native, python = lattices
    assert cs.lattice_form(native) == cs.lattice_form(python)
    # the form reads no node numbering: renumbered, the same
    times = native.node_times
    order = sorted(range(len(times)), key=lambda n: (times[n], -n))
    new = {old: i for i, old in enumerate(order)}
    moved = copy.deepcopy(native)
    moved.node_times = [times[o] for o in order]
    moved.links = [Link(new[l.start], new[l.end], l.word, l.acoustic,
                        l.graph) for l in native.links]
    moved.finals = {new[n]: w for n, w in native.finals.items()}
    assert cs.lattice_form(moved) == cs.lattice_form(native)


@pytest.mark.parametrize("fault", ["cost", "word", "final", "link"])
def test_lattice_form_sees_a_planted_change(lattices, fault):
    native, _ = lattices
    bad = copy.deepcopy(native)
    i = next(i for i, l in enumerate(bad.links)
             if l.word != "<eps>" and bad.node_times[l.start] > 0)
    l = bad.links[i]
    if fault == "cost":
        bad.links[i] = Link(l.start, l.end, l.word, l.acoustic + 1e-9,
                            l.graph)
    elif fault == "word":
        bad.links[i] = Link(l.start, l.end, "#0", l.acoustic, l.graph)
    elif fault == "final":
        n = next(iter(bad.finals))
        bad.finals[n] += 0.5
    else:  # a link from the start node: its times are no link's
        bad.links.append(Link(0, l.end, l.word, l.acoustic, l.graph))
    assert cs.lattice_form(bad) != cs.lattice_form(native)


def test_noisy_posteriors_are_bench_rtfs_noise():
    from pytorch_kaldi_asr_tpu_torch.tools.bench_rtf import _batched_posts

    rng = np.random.default_rng(3)
    posts = {k: np.log(rng.dirichlet(np.ones(6), size=t)).astype(np.float32)
             for k, t in (("b", 9), ("a", 12))}
    keys = sorted(posts)
    noisy = cs.noisy_posteriors(posts, keys)
    assert list(noisy) == keys
    for i, k in enumerate(keys):
        assert noisy[k].shape == posts[k].shape
        np.testing.assert_allclose(np.exp(noisy[k]).sum(1), 1.0, rtol=1e-5)
        assert np.array_equal(noisy[k], _batched_posts(
            posts[k].astype(np.float64), 1, seed=1 + i)[0][0])
        assert 0 < np.abs(noisy[k] - posts[k]).max() < 1.0


@pytest.fixture
def narrow_proto(monkeypatch):
    monkeypatch.setitem(cs.TOOLS, "proto", ("dnn", "44", "30", "2", "24",
                                            "--with-dropout", "0.1"))
    monkeypatch.setitem(cs.TOOLS, "proto_feat_dim", 4)
    monkeypatch.setitem(cs.TOOLS, "proto_utts", 2)
    monkeypatch.setitem(cs.TOOLS, "proto_frames", 20)
    return cs.proto_setup(torch)


def test_proto_setup_is_the_splice_and_dnn(narrow_proto):
    text, comps, params, (feats, labels) = narrow_proto
    assert [c["type"] for c in comps][:3] == ["<Splice>", "<AffineTransform>",
                                             "<Sigmoid>"]
    assert comps[0]["Context"] == "-5:-4:-3:-2:-1:0:1:2:3:4:5"
    assert comps[0]["OutputDim"] == "44" and comps[-1]["type"] == "<Softmax>"
    assert feats.shape == (2, 20, 4) and labels.max() < 30
    assert sum(c["type"] == "<Dropout>" for c in comps) == 2


def test_proto_step_and_masks_on_the_cpu(narrow_proto):
    _, comps, params, batch = narrow_proto
    loss, grads = cs._proto_step_on(torch, "cpu", params, comps, batch)
    again = cs._proto_step_on(torch, "cpu", params, comps, batch)
    assert loss == again[0] and all(torch.equal(grads[k], again[1][k])
                                    for k in grads)
    other = cs._proto_step_on(torch, "cpu", params, comps, batch, seed=1)
    assert other[0] != loss  # other dropout seeds, other masks
    assert set(grads) == {(i, k) for i, p in enumerate(params) for k in p}
    out = cs.card_vs_cpu_step(torch, "cpu", params, comps, batch,
                              step_on=cs._proto_step_on)
    assert out["loss_rel_err"] == 0.0 and out["grad_rel_err"] == 0.0
    assert cs.proto_masks_equal(torch, comps, batch, "cpu") == [0, 0]
