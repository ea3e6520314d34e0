"""The port's lattice tools (tools/{lattice_copy, lattice_rescore,
lattice_to_ctm, rover, kws, show_lattice, ctm, align_ctm -refine_ctm})
against the JAX package's CLIs, on the CPU, over the lattice ark that
both packages' latgen CLIs write alike from the 4-word lexicon's graph
(tests/torch_lattice_helpers.py).

- ``lattice_copy``: binary to text and back, scale, prune, n-best and
  oracle files byte for byte JAX's; an ``scp:`` table reads as its ark;
- ``lattice_rescore``: with ``-lm`` and with a neural LM that JAX's
  ``train_nlm`` trained (tests/test_lattice_rescore.py's), the same
  transcripts, the hypotheses' NLM scores within the tolerance that
  tests/test_torch_nlm.py holds ``score_sentences`` to; ``-nlm_model_dir``
  raises without a card unless ``-device cpu``;
- ``lattice_to_ctm``, ``align_ctm -refine_ctm`` over its CTM, ``rover``,
  ``kws`` search and post-processing (the kwslist XML), ``show_lattice``
  and ``ctm`` (``convert_ctm``, ``fix_ctm``, the CLI): byte for byte.
"""

import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pytorch_kaldi_asr_tpu.recipes import latgen as jax_latgen_cli
from pytorch_kaldi_asr_tpu.tools import align_ctm as jax_align_ctm
from pytorch_kaldi_asr_tpu.tools import ctm as jax_ctm
from pytorch_kaldi_asr_tpu.tools import kws as jax_kws
from pytorch_kaldi_asr_tpu.tools import lattice_copy as jax_lattice_copy
from pytorch_kaldi_asr_tpu.tools import lattice_rescore as jax_rescore
from pytorch_kaldi_asr_tpu.tools import lattice_to_ctm as jax_to_ctm
from pytorch_kaldi_asr_tpu.tools import rover as jax_rover
from pytorch_kaldi_asr_tpu.tools import show_lattice as jax_show
from pytorch_kaldi_asr_tpu_torch.decode.lattice_io import (
    read_text_lattice_archive,
)
from pytorch_kaldi_asr_tpu_torch.recipes import latgen as latgen_cli
from pytorch_kaldi_asr_tpu_torch.tools import (
    align_ctm,
    ctm,
    kws,
    lattice_copy,
    lattice_rescore,
    lattice_to_ctm,
    rover,
    show_lattice,
)
from tests.torch_lattice_helpers import LATGEN_FLAGS, build

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
NLM_SCORE_ATOL = 1e-4  # log10, tests/test_torch_nlm.py's


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The helpers' corpus and the port latgen CLI's lattices: binary ark
    with its .scp and the Kaldi-text archive (JAX's CLI writes the same
    bytes: tests/test_torch_lattice_io.py)."""
    work = build(tmp_path_factory.mktemp("lattice_tools"))
    assert latgen_cli.main([
        "-graph_dir", str(work / "graph"), "-rspecifier",
        f"scp:{work / 'post.scp'}", *LATGEN_FLAGS, "-lattice_beam", "10",
        "-save_result_file", str(work / "decode.txt"),
        "-save_lattice_file", str(work / "lat.txt"),
        "-save_lattice_ark", str(work / "lat.ark")]) == 0
    return work


def _both(tmp_path, run, name):
    """``run(main, out_dir)`` with the port's and JAX's main: the two out
    dirs."""
    dirs = {}
    for pkg, main in name.items():
        dirs[pkg] = tmp_path / pkg
        dirs[pkg].mkdir()
        assert run(main, dirs[pkg]) in (0, None)
    return dirs["port"], dirs["jax"]


def _same_files(port, jax, *names):
    for name in names:
        assert (port / name).read_bytes() == (jax / name).read_bytes(), name


def test_lattice_copy_binary_text_round_trip_equals_jax(setup, tmp_path):
    work = setup
    words = str(work / "graph" / "words.txt")

    def run(main, out):
        assert main(["-words", words, f"ark:{work / 'lat.ark'}",
                     f"ark,t:{out / 'lat.txt'}"]) == 0
        return main(["-words", words, f"ark,t:{out / 'lat.txt'}",
                     f"ark,scp:{out / 'lat2.ark'},{out / 'lat2.scp'}"])

    port, jax = _both(tmp_path, run, {"port": lattice_copy.main,
                                      "jax": jax_lattice_copy.main})
    _same_files(port, jax, "lat.txt", "lat2.ark")
    # through the binary ark the costs are float32 and the links grouped
    # by start node; links and words stay
    def links(path):
        return sorted(line.split()[:3] for line in
                      path.read_text().splitlines()
                      if len(line.split()) >= 3)

    assert links(port / "lat.txt") == links(work / "lat.txt")
    assert (port / "lat2.scp").read_text().replace(str(port), "") == \
        (jax / "lat2.scp").read_text().replace(str(jax), "")


@pytest.mark.parametrize("flags", [
    ["-acoustic_scale", "0.5", "-prune_beam", "20.0", "-nbest", "5"],
    ["-lm_scale", "2.0", "-prune_beam", "3.0", "-nbest", "3"],
    ["-nbest", "4"]], ids=["scale_prune", "lm_scale_prune", "nbest"])
def test_lattice_copy_prune_nbest_oracle_equal_jax(setup, tmp_path, flags):
    work = setup
    (tmp_path / "ref.txt").write_text("u1 bat at tab\nu2 back at tab\n"
                                      "u3 tab at\nu4 at tab back at\n")

    def run(main, out):
        return main(["-words", str(work / "graph" / "words.txt"), *flags,
                     "-oracle_ref", str(tmp_path / "ref.txt"),
                     f"ark:{work / 'lat.ark'}", f"ark:{out / 'out.ark'}"])

    port, jax = _both(tmp_path, run, {"port": lattice_copy.main,
                                      "jax": jax_lattice_copy.main})
    _same_files(port, jax, "out.ark", "out.ark.nbest", "out.ark.oracle")
    oracle = (port / "out.ark.oracle").read_text().splitlines()
    assert oracle[-1].startswith("OVERALL") and len(oracle) == 5


@pytest.mark.parametrize("seed", range(4))
def test_oracle_errors_equal_jax_oracle_wer(setup, seed):
    """lattice_copy's oracle count (``oracle_errors``, the DP a row at a
    time) is the error count of JAX's ``oracle_wer``, on the latgen
    lattices and on random ones, for references that match, miss, run
    long and are empty."""
    from pytorch_kaldi_asr_tpu.decode import lattice_ops as jax_ops
    from pytorch_kaldi_asr_tpu.fst.openfst_io import (
        read_lattice_ark as jax_read,
    )
    from pytorch_kaldi_asr_tpu_torch.decode import lattice_ops
    from pytorch_kaldi_asr_tpu_torch.fst.openfst_io import read_lattice_ark
    from tests.test_torch_confusion import _random_pair

    work = setup
    words = {int(v): w for w, v in (line.split() for line in
                                    open(work / "graph" / "words.txt"))}
    pairs = list(zip((lat for _, lat in read_lattice_ark(
        str(work / "lat.ark"), words)), (lat for _, lat in jax_read(
            str(work / "lat.ark"), words))))
    pairs += [_random_pair(seed), _random_pair(seed + 10, 30, 90)]
    rng = np.random.default_rng(seed)
    vocab = ["bat", "at", "tab", "back", "aa", "bb", "cc", "zz"]
    for got, want in pairs:
        for n in (0, 1, 3, 8):
            ref = list(rng.choice(vocab, size=n))
            assert lattice_ops.oracle_errors(got, ref) == \
                jax_ops.oracle_wer(want, ref)[0]


def test_lattice_copy_reads_scp_as_its_ark(setup, tmp_path):
    work = setup
    args = ["-words", str(work / "graph" / "words.txt"), "-nbest", "3",
            "-nbest_file"]
    assert lattice_copy.main(args + [str(tmp_path / "a.nbest"),
                                     f"ark:{work / 'lat.ark'}",
                                     f"ark,t:{tmp_path / 'a.txt'}"]) == 0
    assert lattice_copy.main(args + [str(tmp_path / "s.nbest"),
                                     f"scp:{work / 'lat.ark.scp'}",
                                     f"ark,t:{tmp_path / 's.txt'}"]) == 0
    for ext in ("nbest", "txt"):
        assert (tmp_path / f"a.{ext}").read_bytes() == \
            (tmp_path / f"s.{ext}").read_bytes()
    with pytest.raises(ValueError, match="unsupported rspecifier"):
        list(lattice_copy.read_lattices("foo:x", {}))


def test_lattice_rescore_with_arpa_equals_jax(setup, tmp_path):
    work = setup

    def run(main, out):
        for scale in ("1.0", "0.2"):
            assert main(["-words", str(work / "graph" / "words.txt"),
                         "-lm", str(work / "lm.arpa"), "-acoustic_scale",
                         scale, "-graph_scale", "0.5", "-n", "5",
                         f"ark:{work / 'lat.ark'}",
                         str(out / f"best_{scale}.txt")]) == 0

    port, jax = _both(tmp_path, run, {"port": lattice_rescore.main,
                                      "jax": jax_rescore.main})
    _same_files(port, jax, "best_1.0.txt", "best_0.2.txt")
    assert len((port / "best_1.0.txt").read_text().splitlines()) == 4


@pytest.fixture(scope="module")
def jax_nlm(tmp_path_factory):
    """tests/test_lattice_rescore.py's corpus: a neural LM trained by JAX's
    train_nlm on 'aa bb' only, its vocabulary and words, and a two-path
    lattice whose acoustically cheaper path is 'cc dd'."""
    from pytorch_kaldi_asr_tpu.fst.openfst_io import write_lattice_ark
    from pytorch_kaldi_asr_tpu.recipes.train_nlm import train_nlm
    from tests.test_lattice_rescore import _two_way_lattice

    work = tmp_path_factory.mktemp("nlm")
    vocab = {"<blank>": 0, "<unk>": 1, "<s>": 2, "</s>": 3, "aa": 4,
             "bb": 5, "cc": 6, "dd": 7}
    (work / "vocab.txt").write_text("".join(f"{w} {i}\n"
                                            for w, i in vocab.items()))
    (work / "words.txt").write_text("<eps> 0\n" + "".join(
        f"{w} {vocab[w] - 3}\n" for w in ("aa", "bb", "cc", "dd")))
    (work / "text.lm").write_text("".join(f"utt{i} aa bb\n"
                                          for i in range(60)))
    train_nlm(str(work / "text.lm"), str(work / "vocab.txt"),
              str(work / "nlm"), epochs=6, batch_size=16, d_model=16,
              layers=1, n_head=2, max_len=8, dropout=0.0, lr=0.02)
    word2id = {"<eps>": 0, "aa": 1, "bb": 2, "cc": 3, "dd": 4}
    write_lattice_ark([_two_way_lattice()], str(work / "lat.ark"), word2id)
    return work


@pytest.mark.parametrize("scales", [
    ["-acoustic_scale", "0.1", "-lm_scale", "1.0"],
    ["-acoustic_scale", "1.0", "-graph_scale", "1.0", "-lm_scale", "0.0"]],
    ids=["nlm_wins", "acoustic_wins"])
def test_lattice_rescore_with_a_jax_trained_nlm_equals_jax(jax_nlm, tmp_path,
                                                           scales):
    work = jax_nlm

    def run(main, out):
        extra = ["-device", "cpu"] if main is lattice_rescore.main else []
        return main(["-words", str(work / "words.txt"), "-nlm_model_dir",
                     str(work / "nlm"), "-read_vocab_file",
                     str(work / "vocab.txt"), *scales, *extra,
                     f"ark:{work / 'lat.ark'}", str(out / "best.txt")])

    port, jax = _both(tmp_path, run, {"port": lattice_rescore.main,
                                      "jax": jax_rescore.main})
    _same_files(port, jax, "best.txt")
    want = "u1 aa bb" if scales[1] == "0.1" else "u1 cc dd"
    assert (port / "best.txt").read_text().strip() == want


def test_lattice_hypotheses_nlm_scores_equal_jax(jax_nlm):
    """The single scoring call's inputs, every hypothesis of the lattice,
    scored by the port's NLM (the JAX checkpoint loaded) and by JAX's."""
    from pytorch_kaldi_asr_tpu.data.instances import (
        read_vocab as jax_read_vocab,
    )
    from pytorch_kaldi_asr_tpu.models.nlm import (
        load_nlm as jax_load_nlm,
        score_sentences as jax_score,
    )
    from pytorch_kaldi_asr_tpu_torch.data import read_vocab
    from pytorch_kaldi_asr_tpu_torch.decode.lattice_ops import nbest
    from pytorch_kaldi_asr_tpu_torch.models.nlm import (
        load_nlm,
        score_sentences,
    )
    from tests.test_lattice_rescore import _two_way_lattice

    work = jax_nlm
    hyps = nbest(_two_way_lattice(), 20, acoustic_scale=0.1,
                 with_components=True)
    seqs = [h[0] for h in hyps] + [["aa"], ["dd", "cc", "aa", "zz"]]
    params, cfg, _ = load_nlm(str(work / "nlm"), device="cpu")
    got = score_sentences(params, cfg, seqs, read_vocab(
        str(work / "vocab.txt")))
    jparams, jcfg, _ = jax_load_nlm(str(work / "nlm"))
    want = jax_score(jparams, jcfg, seqs, jax_read_vocab(
        str(work / "vocab.txt")))
    np.testing.assert_allclose(got, want, atol=NLM_SCORE_ATOL)
    costs = [-s * math.log(10.0) for s in got]
    assert costs[0] < costs[1]  # the LM prefers 'aa bb'


def test_lattice_rescore_nlm_needs_a_card_or_cpu(jax_nlm, tmp_path,
                                                 monkeypatch):
    work = jax_nlm
    args = ["-words", str(work / "words.txt"), "-nlm_model_dir",
            str(work / "nlm"), "-read_vocab_file", str(work / "vocab.txt"),
            f"ark:{work / 'lat.ark'}", str(tmp_path / "best.txt")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="-device cpu"):
        lattice_rescore.main(args)
    with pytest.raises(RuntimeError, match="-device cpu"):
        lattice_rescore.main(args + ["-device", "cuda"])
    assert not (tmp_path / "best.txt").exists()
    with pytest.raises(SystemExit):  # exactly one LM
        lattice_rescore.main(args + ["-lm", str(work / "x.arpa")])


def test_lattice_to_ctm_and_rover_equal_jax(setup, tmp_path):
    work = setup

    def run(main_pair, out):
        to_ctm, rov = main_pair
        for name, scale in (("a", "1.0"), ("b", "0.3")):
            assert to_ctm(["-words", str(work / "graph" / "words.txt"),
                           "-acoustic_scale", scale, "-frame_rate", "0.02",
                           f"ark:{work / 'lat.ark'}", str(out / f"{name}.ctm"),
                           "-text", str(out / f"{name}.tra")]) == 0
        return rov(["-o", str(out / "rover.tra"), "-conf_output",
                    str(out / "rover.conf"), "-alpha", "0.4",
                    str(out / "a.ctm"), str(out / "b.ctm"),
                    str(out / "a.ctm")])

    port, jax = _both(tmp_path, run, {
        "port": (lattice_to_ctm.main, rover.main),
        "jax": (jax_to_ctm.main, jax_rover.main)})
    _same_files(port, jax, "a.ctm", "a.tra", "b.ctm", "b.tra", "rover.tra",
                "rover.conf")
    assert (port / "a.tra").read_text().splitlines()[0] == "u1 bat at tab"


def test_align_ctm_refine_equals_jax(setup, tmp_path):
    """The consensus CTM refined by forced alignment over the same
    posteriors, both CLIs: the same lines; the utterances whose consensus
    matches their transcript take the alignment's times."""
    work = setup
    assert lattice_to_ctm.main(["-words", str(work / "graph" / "words.txt"),
                                f"ark:{work / 'lat.ark'}",
                                str(tmp_path / "c.ctm")]) == 0
    args = ["-lexicon", str(work / "lexicon.txt"), "-phones",
            str(work / "phones.txt"), "-text", str(work / "text"),
            "-refine_ctm", str(tmp_path / "c.ctm"),
            f"scp:{work / 'post.scp'}"]
    for name, main in (("port", align_ctm.main),
                       ("jax", jax_align_ctm.main)):
        assert main(args + [str(tmp_path / f"{name}.ctm")]) == 0
    got = (tmp_path / "port.ctm").read_bytes()
    assert got == (tmp_path / "jax.ctm").read_bytes()
    assert got != (tmp_path / "c.ctm").read_bytes()  # times refined
    assert [line.split()[4] for line in got.decode().splitlines()] == \
        [line.split()[4] for line in
         (tmp_path / "c.ctm").read_text().splitlines()]


KEYWORDS = "KW1 at\nKW2 bat\nKW3 back\nKW4 tab at\nKW5 zz\n"


@pytest.mark.parametrize("flags", [[], ["-threshold", "0.2", "-normalize",
                                        "kst", "-duptime", "5"]],
                         ids=["defaults", "kst"])
def test_kws_search_and_post_process_equal_jax(setup, tmp_path, flags):
    work = setup
    (tmp_path / "kw.txt").write_text(KEYWORDS)

    def run(main, out):
        assert main(["search", "-keywords", str(tmp_path / "kw.txt"),
                     "-lattices", str(work / "lat.txt"), "-output",
                     str(out / "kws.xml"), *flags]) == 0
        return main(["post-process", str(out / "kws.xml"),
                     str(out / "post.xml"), "-threshold", "0.9",
                     "-remove_no", "-normalize", "kst"])

    port, jax = _both(tmp_path, run, {"port": kws.main, "jax": jax_kws.main})
    _same_files(port, jax, "kws.xml", "post.xml")
    xml = (port / "kws.xml").read_text()
    assert all(f'kwid="KW{i}"' in xml for i in (1, 2, 3, 4))
    assert 'kwid="KW5"' not in xml


def test_search_lattice_hits_equal_jax(setup):
    from pytorch_kaldi_asr_tpu.decode.lattice_io import (
        read_text_lattice_archive as jax_read,
    )

    work = setup
    keywords = {k: v for k, *v in (line.split() for line in
                                   KEYWORDS.splitlines())}
    for (_, got), (_, want) in zip(
            read_text_lattice_archive(str(work / "lat.txt")),
            jax_read(str(work / "lat.txt"))):
        hits = kws.search_lattice(got, keywords, acoustic_scale=0.5)
        jhits = jax_kws.search_lattice(want, keywords, acoustic_scale=0.5)
        assert [(h.kwid, h.utt, h.tbeg, h.dur) for h in hits] == \
            [(h.kwid, h.utt, h.tbeg, h.dur) for h in jhits]
        np.testing.assert_allclose([h.score for h in hits],
                                   [h.score for h in jhits], atol=1e-12)


def test_show_lattice_equals_jax(setup, tmp_path):
    work = setup
    for utt in ("u3", None):
        extra = ["-utt", utt] if utt else []
        for name, main in (("port", show_lattice.main),
                           ("jax", jax_show.main)):
            assert main(["-lattices", str(work / "lat.txt"), *extra,
                         "-output", str(tmp_path / f"{name}.dot")]) == 0
        assert (tmp_path / "port.dot").read_bytes() == \
            (tmp_path / "jax.dot").read_bytes()
    assert show_lattice.main(["-lattices", str(work / "lat.txt"), "-utt",
                              "nope"]) == 1


CTM = ("u1 1 0.10 0.20 aa 0.9\nu1 1 0.30 0.25 bb\n"
       "u2 A 1.00 0.50 cc 0.3\nu3 1 0.00 9.00 dd 0.1\n")


def test_convert_and_fix_ctm_equal_jax(tmp_path):
    (tmp_path / "segments").write_text("u1 rec1 10.0 12.0\n"
                                       "u2 rec1 20.0 20.6\n")
    (tmp_path / "r2f").write_text("rec1 file1 A\n")
    segments = ctm.read_segments(str(tmp_path / "segments"))
    assert segments == jax_ctm.read_segments(str(tmp_path / "segments"))
    reco = ctm.read_reco2file_and_channel(str(tmp_path / "r2f"))
    assert reco == jax_ctm.read_reco2file_and_channel(str(tmp_path / "r2f"))
    lines = CTM.splitlines()
    assert list(ctm.convert_ctm(lines, segments, reco, skip_unknown=True)) \
        == list(jax_ctm.convert_ctm(lines, segments, reco,
                                    skip_unknown=True))
    with pytest.raises(KeyError, match="u3"):
        list(ctm.convert_ctm(lines, segments, reco))
    (tmp_path / "stm").write_text("u1 x\nu2 x\nu4 x\n")
    for name, fix in (("port", ctm.fix_ctm), ("jax", jax_ctm.fix_ctm)):
        (tmp_path / f"{name}.ctm").write_text(CTM.replace("u3", "u2"))
        assert fix(str(tmp_path / "stm"), str(tmp_path / f"{name}.ctm"))
    assert (tmp_path / "port.ctm").read_bytes() == \
        (tmp_path / "jax.ctm").read_bytes()
    (tmp_path / "bad.ctm").write_text(CTM)
    assert not ctm.fix_ctm(str(tmp_path / "stm"), str(tmp_path / "bad.ctm"))


def test_ctm_cli_equals_jax(tmp_path):
    (tmp_path / "segments").write_text("u1 rec1 10.0 12.0\n"
                                       "u2 rec1 20.0 20.6\n")
    (tmp_path / "r2f").write_text("rec1 file1 A\n")
    (tmp_path / "in.ctm").write_text(CTM)
    out = {}
    for name in ("pytorch_kaldi_asr_tpu_torch", "pytorch_kaldi_asr_tpu"):
        out[name] = subprocess.run(
            [sys.executable, "-m", f"{name}.tools.ctm",
             str(tmp_path / "segments"), str(tmp_path / "r2f"),
             str(tmp_path / "in.ctm"), "--skip-unknown"], cwd=str(REPO),
            capture_output=True, text=True, timeout=120,
            env={"PYTHONPATH": str(REPO), "JAX_PLATFORMS": "cpu",
                 "PATH": "/usr/bin:/bin"})
        assert out[name].returncode == 0, out[name].stderr
    assert out["pytorch_kaldi_asr_tpu_torch"].stdout == \
        out["pytorch_kaldi_asr_tpu"].stdout
    assert out["pytorch_kaldi_asr_tpu_torch"].stdout.splitlines()[0] == \
        "file1 A 10.10 0.20 aa 0.9"
