"""The port's host graph search and forced alignment (decode/latgen.py,
decode/align.py, recipes/latgen.py, tools/align_ctm.py) against the JAX
package's, on the CPU, on one posterior ark.

- ``latgen``: word ids, phone frames and costs equal to JAX's (costs to
  1e-9) at two beams, with log-priors and an acoustic scale, against JAX's
  dispatch (its C++ core when built) and its Python decoder; a streamed
  decode in chunks, its traceback arena compacted, equals the one-shot
  decode, its partial hypotheses JAX's.
- The latgen CLI's decode.txt is byte for byte JAX's, also with
  ``-device_search -device cpu`` (each device-search flag), and the
  device search raises without a card unless ``-device cpu`` is given.
- ``forced_align`` gives JAX's alignment, and the align_ctm CLI's CTM is
  byte for byte JAX's (with and without an optional silence phone, and
  through a 3-state topology, ``-topo``).
"""

import os

import numpy as np
import pytest
import torch

from pytorch_kaldi_asr_tpu.decode import align as jax_align
from pytorch_kaldi_asr_tpu.decode import latgen as jax_latgen
from pytorch_kaldi_asr_tpu.fst.openfst_io import read_fst as jax_read_fst
from pytorch_kaldi_asr_tpu.io.kaldi_io import ArkWriter
from pytorch_kaldi_asr_tpu.recipes import latgen as jax_latgen_cli
from pytorch_kaldi_asr_tpu.recipes import mkgraph as jax_mkgraph
from pytorch_kaldi_asr_tpu.recipes import train_lm as jax_train_lm
from pytorch_kaldi_asr_tpu.tools import align_ctm as jax_align_ctm
from pytorch_kaldi_asr_tpu_torch.decode import align, latgen
from pytorch_kaldi_asr_tpu_torch.fst.openfst_io import read_fst
from pytorch_kaldi_asr_tpu_torch.io.kaldi_io import read_mat_scp
from pytorch_kaldi_asr_tpu_torch.recipes import latgen as latgen_cli
from pytorch_kaldi_asr_tpu_torch.recipes.mkgraph import read_symbol_table
from pytorch_kaldi_asr_tpu_torch.tools import align_ctm

COST_ATOL = 1e-9
PHONES = ["sil", "ah", "ae", "iy", "k", "t", "d", "s"]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A phone-loop HLG (identity lexicon, 3-gram phone LM) compiled by
    JAX's mkgraph, transcripts, and an ark of noisy log-posteriors whose
    frames follow each transcript's phones."""
    work = tmp_path_factory.mktemp("latgen")
    rng = np.random.default_rng(0)
    (work / "phones.txt").write_text(
        "".join(f"{p} {i + 1}\n" for i, p in enumerate(PHONES)))
    (work / "lexicon.txt").write_text("".join(f"{p} {p}\n" for p in PHONES))
    texts = {f"utt{u}": list(rng.choice(PHONES, size=int(rng.integers(4, 12))))
             for u in range(6)}
    (work / "text").write_text("".join(f"{k} {' '.join(v)}\n"
                                       for k, v in texts.items()))
    (work / "lm_text").write_text("".join(
        f"l{i} " + " ".join(rng.choice(PHONES, size=int(rng.integers(3, 10))))
        + "\n" for i in range(60)))
    assert jax_train_lm.main(["-text", str(work / "lm_text"), "-order", "3",
                              "-lm", str(work / "lm.gz")]) == 0
    assert jax_mkgraph.main(["-phones", str(work / "phones.txt"),
                             "-self_lexicon", "-lm", str(work / "lm.gz"),
                             "-graph_dir", str(work / "graph")]) == 0
    with ArkWriter(str(work / "post.ark"), str(work / "post.scp")) as w:
        for key, words in texts.items():
            ids = np.repeat([PHONES.index(p) for p in words],
                            rng.integers(3, 9, size=len(words)))
            x = rng.normal(scale=1.5, size=(len(ids), len(PHONES)))
            x[np.arange(len(ids)), ids] += 3.0
            x -= np.log(np.exp(x).sum(1, keepdims=True))
            w.write(key, x.astype(np.float32))
    log_priors = np.log(rng.dirichlet(np.ones(len(PHONES))))
    np.save(work / "priors.npy", log_priors)
    return work, log_priors


def _jax_decoders(monkeypatch):
    """JAX's latgen as it dispatches (its C++ core when built), then its
    Python decoder."""
    yield "dispatch"
    monkeypatch.setenv("PKA_NATIVE_LATGEN", "0")
    yield "python"


@pytest.mark.parametrize("beam,scale,priors", [(14.0, 1.0, False),
                                               (6.0, 0.7, True)])
def test_latgen_equals_jax(setup, monkeypatch, beam, scale, priors):
    work, log_priors = setup
    graph = read_fst(str(work / "graph" / "HLG.fst"))
    jgraph = jax_read_fst(str(work / "graph" / "HLG.fst"))
    kw = dict(acoustic_scale=scale, beam=beam, max_active=2000,
              log_priors=log_priors if priors else None)
    posts = list(read_mat_scp(str(work / "post.scp")))
    for _ in _jax_decoders(monkeypatch):
        for key, mat in posts:
            got = latgen.latgen(graph, mat, **kw)
            want = jax_latgen.latgen(jgraph, mat, **kw)
            assert got is not None and want is not None, key
            assert got[0] == list(want[0]) and got[1] == list(want[1])
            assert abs(got[2] - want[2]) <= COST_ATOL
            assert len(got[1]) == mat.shape[0]  # one phone per frame
    # streamed in chunks with the traceback arena compacted after each,
    # the same result as one push; the partial best hypothesis midway is
    # JAX's Python decoder's
    dec = latgen.StreamingLatgen(graph, compact_threshold=64, **kw)
    jdec = jax_latgen.StreamingLatgen(jgraph, compact_threshold=64, **kw)
    key, mat = posts[0]
    for lo in range(0, mat.shape[0], 5):
        assert dec.push(mat[lo:lo + 5]) and jdec.push(mat[lo:lo + 5])
        words, cost = dec.partial()
        jwords, jcost = jdec.partial()
        assert words == jwords and abs(cost - jcost) <= COST_ATOL
    assert dec.tracebacks == jdec.tracebacks  # compacted alike
    assert dec.finish() == latgen.latgen(graph, mat, **kw)


def test_latgen_cli_equals_jax(setup, monkeypatch):
    work, _ = setup
    args = ["-graph_dir", str(work / "graph"), "-rspecifier",
            f"scp:{work / 'post.scp'}", "-beam", "10", "-max_active", "50",
            "-priors_file", str(work / "priors.npy")]
    assert latgen_cli.main(args + ["-save_result_file",
                                   str(work / "port.txt")]) == 0
    for decoder in _jax_decoders(monkeypatch):
        out = work / f"jax_{decoder}.txt"
        assert jax_latgen_cli.main(args + ["-save_result_file",
                                           str(out)]) == 0
        assert (work / "port.txt").read_bytes() == out.read_bytes()
    assert len((work / "port.txt").read_text().splitlines()) == 6
    for i, flag in enumerate((["-device_search"],
                              ["-device_search", "-device_batch", "4"],
                              ["-device_search", "-device_mode", "dense"])):
        jax_out, out = work / f"jax_dev{i}.txt", work / f"port_dev{i}.txt"
        assert jax_latgen_cli.main(args + ["-save_result_file", str(jax_out),
                                           *flag]) == 0
        assert latgen_cli.main(args + ["-save_result_file", str(out), *flag,
                                       "-device", "cpu"]) == 0
        assert out.read_bytes() == jax_out.read_bytes()
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                latgen_cli.main(args + ["-save_result_file", "y", *flag])


def test_forced_align_equals_jax(setup):
    work, _ = setup
    phone_syms = read_symbol_table(str(work / "phones.txt"))
    lexicon = {p: [(1.0, [p])] for p in PHONES}
    word_syms = align.word_syms_from_lexicon(lexicon)
    text = {line.split()[0]: line.split()[1:]
            for line in (work / "text").read_text().splitlines()}
    for key, mat in read_mat_scp(str(work / "post.scp")):
        kw = dict(sil_phone="sil")
        graph, ext = align.align_graph(text[key], lexicon, word_syms,
                                       phone_syms, **kw)
        jgraph, jext = jax_align.align_graph(text[key], lexicon, word_syms,
                                             phone_syms, **kw)
        assert ext == jext
        sil = {phone_syms["sil"]}
        got = align.forced_align(graph, mat, sil_ids=sil)
        want = jax_align.forced_align(jgraph, mat, sil_ids=sil)
        assert got.words == want.words
        assert got.phone_frames == want.phone_frames
        assert abs(got.cost - want.cost) <= COST_ATOL
    with pytest.raises(ValueError, match="not in the lexicon"):
        align.align_graph(["zz"], lexicon, word_syms, phone_syms)


@pytest.mark.parametrize("sil", [[], ["-sil_phone", "sil"]],
                         ids=["no_silence", "silence"])
def test_align_ctm_equals_jax(setup, sil):
    work, _ = setup
    args = ["-lexicon", str(work / "lexicon.txt"), "-phones",
            str(work / "phones.txt"), "-text", str(work / "text"),
            "-acoustic_scale", "0.8", *sil, f"scp:{work / 'post.scp'}"]
    name = "sil" if sil else "nosil"
    assert align_ctm.main(args + [str(work / f"port_{name}.ctm")]) == 0
    assert jax_align_ctm.main(args + [str(work / f"jax_{name}.ctm")]) == 0
    got = (work / f"port_{name}.ctm").read_bytes()
    assert got == (work / f"jax_{name}.ctm").read_bytes()
    lines = got.decode().splitlines()
    assert len(lines) == sum(len(line.split()) - 1 for line in
                             (work / "text").read_text().splitlines())
    assert all(float(line.split()[3]) > 0 for line in lines)
    from pytorch_kaldi_asr_tpu_torch.tools.lang import gen_topo

    topo = work / f"topo_{name}"
    topo.write_text(gen_topo(range(2, len(PHONES) + 1), [1],
                             num_nonsil_states=3, num_sil_states=3))
    with_topo = args[:-1] + ["-topo", str(topo), args[-1]]
    assert align_ctm.main(with_topo + [str(work / f"port_{name}_t.ctm")]) == 0
    assert jax_align_ctm.main(with_topo + [str(work / f"jax_{name}_t.ctm")]) \
        == 0
    got = (work / f"port_{name}_t.ctm").read_bytes()
    assert got == (work / f"jax_{name}_t.ctm").read_bytes()
    assert [line.split()[4] for line in got.decode().splitlines()] == \
        [line.split()[4] for line in lines]
    assert os.path.exists(work / "graph" / "words.txt")
