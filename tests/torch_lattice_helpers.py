"""Shared setup of the tests that hold the port's lattice tools against the
JAX package's (tests/test_torch_lattice_io.py, test_torch_confusion.py,
test_torch_lattice_tools.py): the 4-word lexicon of
tests/test_lattice_tools.py, a bigram LM over its sentences, the HLG that
the JAX package's mkgraph CLI compiles from them, and a posterior ark whose
frames follow each utterance's phones with noise."""

import numpy as np

from pytorch_kaldi_asr_tpu.io.kaldi_io import ArkWriter
from pytorch_kaldi_asr_tpu.lm.arpa import write_arpa
from pytorch_kaldi_asr_tpu.lm.ngram import train_ngram_lm
from pytorch_kaldi_asr_tpu.recipes import mkgraph as jax_mkgraph

PHONES = {p: i + 1 for i, p in enumerate(["a", "b", "k", "t"])}
LEXICON = {"bat": ["b", "a", "t"], "back": ["b", "a", "k"],
           "at": ["a", "t"], "tab": ["t", "a", "b"]}
SENTS = [s.split() for s in [
    "bat at tab", "back at bat", "tab tab at", "bat back", "at tab back",
]]
# the utterances: (key, words, seed of their posteriors' noise, noise)
UTTS = [("u1", "bat at tab", 0, 0.5), ("u2", "back at bat", 1, 1.2),
        ("u3", "tab tab at", 2, 0.9), ("u4", "at tab back", 3, 1.5)]
LATGEN_FLAGS = ["-beam", "30.0", "-max_active", "200"]


def posts_for(words, seed, noise, frames_per_phone=3, sharp=6.0):
    """[T, 4] log-posteriors: each phone of ``words`` for
    ``frames_per_phone`` frames, its column near 0, the others near
    ``-sharp``, plus normal noise."""
    rng = np.random.default_rng(seed)
    rows = []
    for p in (PHONES[p] for w in words.split() for p in LEXICON[w]):
        for _ in range(frames_per_phone):
            row = np.full(len(PHONES), -sharp) + rng.normal(
                scale=noise, size=len(PHONES))
            row[p - 1] = -0.05
            rows.append(row)
    return np.array(rows)


def build(work):
    """phones.txt, lexicon.txt, lm.arpa, the graph dir ``graph`` (JAX's
    mkgraph CLI), post.ark/post.scp and text under ``work``."""
    work.mkdir(parents=True, exist_ok=True)
    (work / "phones.txt").write_text(
        "".join(f"{p} {i}\n" for p, i in PHONES.items()))
    (work / "lexicon.txt").write_text("".join(
        f"{w} {' '.join(ph)}\n" for w, ph in LEXICON.items()))
    write_arpa(train_ngram_lm(SENTS, order=2), str(work / "lm.arpa"))
    assert jax_mkgraph.main([
        "-phones", str(work / "phones.txt"), "-lexicon",
        str(work / "lexicon.txt"), "-lm", str(work / "lm.arpa"),
        "-graph_dir", str(work / "graph")]) == 0
    with ArkWriter(str(work / "post.ark"), str(work / "post.scp")) as w:
        for key, words, seed, noise in UTTS:
            w.write(key, posts_for(words, seed, noise).astype(np.float32))
    (work / "text").write_text("".join(f"{key} {words}\n"
                                       for key, words, _, _ in UTTS))
    return work


def lattices(work, lattice_beam=12.0):
    """{key: (port WordLattice, JAX WordLattice)} of latgen_lattice over
    each utterance, both packages' Python token loops (the port's with
    ``native=False``) on the same graph file."""
    import os

    from pytorch_kaldi_asr_tpu.decode import latgen as jax_latgen
    from pytorch_kaldi_asr_tpu.fst.openfst_io import read_fst as jax_read
    from pytorch_kaldi_asr_tpu_torch.decode import latgen
    from pytorch_kaldi_asr_tpu_torch.fst.openfst_io import read_fst
    from pytorch_kaldi_asr_tpu_torch.io.kaldi_io import read_mat_scp
    from pytorch_kaldi_asr_tpu_torch.recipes.mkgraph import read_symbol_table

    graph = read_fst(str(work / "graph" / "HLG.fst"))
    jgraph = jax_read(str(work / "graph" / "HLG.fst"))
    words = read_symbol_table(str(work / "graph" / "words.txt"))
    id2word = {i: w for w, i in words.items()}
    kw = dict(beam=30.0, lattice_beam=lattice_beam, max_active=200,
              id2word=id2word)
    native = os.environ.get("PKA_NATIVE_LATGEN")
    os.environ["PKA_NATIVE_LATGEN"] = "0"
    try:
        out = {}
        for key, mat in read_mat_scp(str(work / "post.scp")):
            out[key] = (latgen.latgen_lattice(graph, mat, utt=key,
                                              native=False, **kw),
                        jax_latgen.latgen_lattice(jgraph, mat, utt=key,
                                                  **kw))
    finally:
        if native is None:
            del os.environ["PKA_NATIVE_LATGEN"]
        else:
            os.environ["PKA_NATIVE_LATGEN"] = native
    return out, words


def assert_same_lattice(got, want, atol=0.0):
    """Nodes, links (words, costs within ``atol``), finals and key equal."""
    assert got.node_times == want.node_times
    assert len(got.links) == len(want.links)
    for g, w in zip(got.links, want.links):
        assert (g.start, g.end, g.word) == (w.start, w.end, w.word)
        assert abs(g.acoustic - w.acoustic) <= atol
        assert abs(g.graph - w.graph) <= atol
    assert got.finals.keys() == want.finals.keys()
    for n, c in got.finals.items():
        assert abs(c - want.finals[n]) <= atol
    assert got.utt == want.utt
