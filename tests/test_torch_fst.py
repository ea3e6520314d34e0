"""The port's host WFST pieces (fst/, recipes/mkgraph.py) against the JAX
package's, on the CPU.

- ``mkgraph``'s ``HLG.fst``, ``words.txt`` and ``phones.txt`` are byte for
  byte JAX's: the identity lexicon of a phone table (the long-form
  recipe's ``-self_lexicon``) and a lexicon with homophones, prefix
  pronunciations, pronunciation probabilities and optional silence, in the
  VectorFst and the ConstFst layout.
- ``fst/openfst_io``: the port writes the hand-assembled golden VectorFst
  stream of tests/test_fst.py, reads the golden ConstFst v1 and v2
  streams, and on random machines writes the bytes JAX writes and reads
  back what JAX reads.
- compose, determinize, rmepsilon, minimize and shortest_path give JAX's
  machines on random inputs.
- ``mkgraph -topo`` gives JAX's files with a 3-state topology, and a
  missing topology file is refused as JAX refuses it.
"""

import math
import random
import struct

import pytest

from pytorch_kaldi_asr_tpu.fst import openfst_io as jax_io
from pytorch_kaldi_asr_tpu.fst import ops as jax_ops
from pytorch_kaldi_asr_tpu.fst.core import Fst as JaxFst
from pytorch_kaldi_asr_tpu.recipes import mkgraph as jax_mkgraph
from pytorch_kaldi_asr_tpu.recipes import train_lm as jax_train_lm
from pytorch_kaldi_asr_tpu_torch.fst import openfst_io, ops
from pytorch_kaldi_asr_tpu_torch.fst.core import Fst
from pytorch_kaldi_asr_tpu_torch.recipes import mkgraph

PHONES = ["sil", "ah", "ae", "iy", "k", "t", "d"]


def _lang(tmp_path):
    """phones.txt, a lexicon with homophones, a prefix pronunciation and
    probabilities, and a 3-gram LM trained by JAX's train_lm on seeded
    text over the lexicon's words."""
    (tmp_path / "phones.txt").write_text(
        "".join(f"{p} {i + 1}\n" for i, p in enumerate(PHONES)))
    (tmp_path / "lexicon.txt").write_text(
        "cat 1.0 k ae t\n"
        "kat 1.0 k ae t\n"        # homophone of cat
        "ca 0.6 k ae\n"           # prefix of cat
        "ca 0.4 k ah\n"
        "tea 1.0 t iy\n"
        "dee 1.0 d iy\n")
    rng = random.Random(3)
    words = ["cat", "kat", "ca", "tea", "dee"]
    (tmp_path / "text").write_text("".join(
        f"u{i} " + " ".join(rng.choice(words) for _ in range(rng.randint(2, 7)))
        + "\n" for i in range(40)))
    (tmp_path / "phone_text").write_text("".join(
        f"u{i} " + " ".join(rng.choice(PHONES) for _ in range(rng.randint(3, 9)))
        + "\n" for i in range(40)))
    for text, lm in (("text", "lm.gz"), ("phone_text", "phone_lm.gz")):
        assert jax_train_lm.main(["-text", str(tmp_path / text), "-order",
                                  "3", "-lm", str(tmp_path / lm)]) == 0
    return tmp_path


GRAPHS = {
    "self_lexicon": ["-self_lexicon", "-lm", "phone_lm.gz"],
    "self_lexicon_const": ["-self_lexicon", "-lm", "phone_lm.gz",
                           "-fst_type", "const"],
    "lexicon_sil": ["-lexicon", "lexicon.txt", "-pron_probs", "-lm", "lm.gz",
                    "-sil_phone", "sil", "-sil_prob", "0.3",
                    "-self_loop_prob", "0.7"],
    "lexicon_no_loops": ["-lexicon", "lexicon.txt", "-pron_probs", "-lm",
                         "lm.gz", "-no_hmm_loops"],
}


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_mkgraph_files_equal_jax(tmp_path, graph):
    lang = _lang(tmp_path)
    args = [a if not a.endswith((".txt", ".gz")) else str(lang / a)
            for a in GRAPHS[graph]]
    base = ["-phones", str(lang / "phones.txt"), *args]
    assert jax_mkgraph.main(base + ["-graph_dir", str(tmp_path / "jax")]) == 0
    assert mkgraph.main(base + ["-graph_dir", str(tmp_path / "port")]) == 0
    for name in ("HLG.fst", "words.txt", "phones.txt"):
        want = (tmp_path / "jax" / name).read_bytes()
        assert (tmp_path / "port" / name).read_bytes() == want, name
    hlg = openfst_io.read_fst(str(tmp_path / "port" / "HLG.fst"))
    assert hlg.num_states > 10 and hlg.start >= 0 and hlg.final


def test_mkgraph_refuses_topo(tmp_path):
    """A topology file that is not there is refused, as by JAX's mkgraph;
    a 3-state Bakis topology (tools/lang.gen_topo) gives JAX's files."""
    from pytorch_kaldi_asr_tpu_torch.tools.lang import gen_topo

    lang = _lang(tmp_path)
    base = ["-phones", str(lang / "phones.txt"), "-self_lexicon", "-lm",
            str(lang / "phone_lm.gz")]
    for cli in (mkgraph, jax_mkgraph):
        with pytest.raises(FileNotFoundError):
            cli.main(base + ["-topo", "x", "-graph_dir", str(tmp_path / "g")])
    (tmp_path / "topo").write_text(gen_topo(range(2, len(PHONES) + 1), [1],
                                            num_sil_states=3))
    base += ["-topo", str(tmp_path / "topo")]
    assert jax_mkgraph.main(base + ["-graph_dir", str(tmp_path / "jax")]) == 0
    assert mkgraph.main(base + ["-graph_dir", str(tmp_path / "port")]) == 0
    for name in ("HLG.fst", "words.txt", "phones.txt"):
        want = (tmp_path / "jax" / name).read_bytes()
        assert (tmp_path / "port" / name).read_bytes() == want, name


def test_vector_fst_golden_bytes(tmp_path):
    f = Fst()
    s0, s1 = f.add_state(), f.add_state()
    f.start = s0
    f.add_arc(s0, 3, 4, 0.5, s1)
    f.set_final(s1, 0.25)
    f.write_binary(str(tmp_path / "g.fst"))
    expect = b"".join([
        struct.pack("<i", 2125659606),
        struct.pack("<i", 6), b"vector",
        struct.pack("<i", 8), b"standard",
        struct.pack("<iiQ", 2, 0, 0),
        struct.pack("<qqq", 0, 2, 1),
        struct.pack("<f", math.inf), struct.pack("<q", 1),
        struct.pack("<iifi", 3, 4, 0.5, 1),
        struct.pack("<f", 0.25), struct.pack("<q", 0),
    ])
    assert (tmp_path / "g.fst").read_bytes() == expect


@pytest.mark.parametrize("version", [2, 1])
def test_read_golden_const_fst(tmp_path, version):
    blob = b"".join([
        struct.pack("<i", 2125659606),
        struct.pack("<i", 5), b"const",
        struct.pack("<i", 8), b"standard",
        struct.pack("<ii", version, 0), struct.pack("<Q", 1),
        struct.pack("<qqq", 0, 2, 2)])
    if version == 1:
        blob += b"\0" * ((-len(blob)) % 16)
    blob += struct.pack("<fIIII", math.inf, 0, 2, 1, 0)
    blob += struct.pack("<fIIII", 0.75, 2, 0, 0, 0)
    if version == 1:
        blob += b"\0" * ((-len(blob)) % 16)
    blob += struct.pack("<iifi", 0, 9, 0.5, 1)
    blob += struct.pack("<iifi", 2, 2, 1.5, 1)
    (tmp_path / "c.fst").write_bytes(blob)
    got = openfst_io.read_fst(str(tmp_path / "c.fst"))
    assert _structure(got) == _structure(jax_io.read_fst(
        str(tmp_path / "c.fst")))
    assert got.final_weight(1) == 0.75
    assert [tuple(a) for a in got.arcs[0]] == [(0, 9, 0.5, 1), (2, 2, 1.5, 1)]


def _structure(g):
    return (g.start, g.num_states,
            [[(a.ilabel, a.olabel, a.weight, a.nextstate) for a in arcs]
             for arcs in g.arcs], sorted(g.final.items()))


def _random_pair(rnd, n_max=8, arcs_max=20, labels=6, eps=True,
                 acyclic=False):
    """The same random machine as a port Fst and a JAX Fst (with
    ``acyclic``, every arc leads to a higher state)."""
    pair = (Fst(), JaxFst())
    n = rnd.randint(1, n_max)
    for f in pair:
        for _ in range(n):
            f.add_state()
    start = rnd.randrange(n)
    arcs = [(rnd.randrange(n), rnd.randint(0 if eps else 1, labels),
             rnd.randint(0 if eps else 1, labels),
             round(rnd.uniform(0, 3), 3), rnd.randrange(n))
            for _ in range(rnd.randint(0, arcs_max))]
    if acyclic:
        start = 0
        arcs = [(min(s, d), il, ol, w, max(s, d)) for s, il, ol, w, d in arcs
                if s != d]
    finals = [(s, round(rnd.uniform(0, 2), 3)) for s in range(n)
              if rnd.random() < 0.4]
    for f in pair:
        f.start = start
        for s, il, ol, w, d in arcs:
            f.add_arc(s, il, ol, w, d)
        for s, w in finals:
            f.set_final(s, w)
    return pair


def test_binary_round_trips_equal_jax(tmp_path):
    rnd = random.Random(13)
    for trial in range(12):
        ours, theirs = _random_pair(rnd, n_max=12, arcs_max=30, labels=9)
        for name, write_port, write_jax in (
                ("v", ours.write_binary, theirs.write_binary),
                ("c", lambda p: openfst_io.write_const_fst(ours, p),
                 lambda p: jax_io.write_const_fst(theirs, p))):
            pp, pj = (str(tmp_path / f"{trial}{name}.{who}")
                      for who in ("port", "jax"))
            write_port(pp)
            write_jax(pj)
            assert open(pp, "rb").read() == open(pj, "rb").read()
            assert _structure(openfst_io.read_fst(pp)) == _structure(
                jax_io.read_fst(pj))
    empty = Fst()
    empty.write_binary(str(tmp_path / "e.fst"))
    assert openfst_io.read_fst(str(tmp_path / "e.fst")).start == -1


def test_algorithms_equal_jax():
    rnd = random.Random(7)
    for _ in range(25):
        a, ja = _random_pair(rnd)
        b, jb = _random_pair(rnd)
        for got, want in (
                (ops.compose(a, b), jax_ops.compose(ja, jb)),
                (ops.rmepsilon(a), jax_ops.rmepsilon(ja)),
                (ops.push_weights(a), jax_ops.push_weights(ja))):
            assert _structure(got) == _structure(want)
        # determinize and minimize take acyclic epsilon-free acceptors here
        # (determinizable; minimize's contract: a deterministic machine)
        a, ja = _random_pair(rnd, eps=False, acyclic=True)
        for f in (a, ja):
            for arcs in f.arcs:
                for arc in arcs:
                    arc.olabel = arc.ilabel
        det, jdet = ops.determinize(a), jax_ops.determinize(ja)
        assert _structure(det) == _structure(jdet)
        assert _structure(ops.minimize(det)) == _structure(
            jax_ops.minimize(jdet))
        assert ops.shortest_path(a) == jax_ops.shortest_path(ja)
        assert ops.shortest_distance(a, reverse=True) == \
            jax_ops.shortest_distance(ja, reverse=True)
