"""The pin of the port's recipes against the JAX package's: one tiny
combined checkpoint trained with the JAX CLIs (stages 3-4) on a synthetic
corpus, then stage 5 through both packages.

- Both packages' ``decode`` CLIs decode it: the same keys, words and n-best
  order, scores within SCORE_ATOL (the files write full float reprs, so
  they differ in their last digits).
- JAX's ``decode.txt`` through both packages' stage-5 scoring, as run.sh
  calls it: ``score_lm -lm``, ``rescore`` at the recipe's weights,
  ``compute_wer --mode=present`` and ``best_wer`` into ``result.txt``.
  Every output file is byte-identical.
- ``tools.sweep_fusion`` with a neural LM trained by JAX's ``train_nlm``:
  both packages write the same ``sweep.txt``, and per weight the same
  1-best words.
"""

import contextlib
import io
import os

import pytest
import torch

from pytorch_kaldi_asr_tpu.recipes import decode as jax_decode
from pytorch_kaldi_asr_tpu.recipes import initialize_model as jax_init
from pytorch_kaldi_asr_tpu.recipes import rescore as jax_rescore
from pytorch_kaldi_asr_tpu.recipes import score_lm as jax_score_lm
from pytorch_kaldi_asr_tpu.recipes import train as jax_train
from pytorch_kaldi_asr_tpu.recipes import train_lm as jax_train_lm
from pytorch_kaldi_asr_tpu.recipes import train_nlm as jax_train_nlm
from pytorch_kaldi_asr_tpu.tools import best_wer as jax_best_wer
from pytorch_kaldi_asr_tpu.tools import compute_wer as jax_compute_wer
from pytorch_kaldi_asr_tpu.tools import make_synthetic_data as jax_synth
from pytorch_kaldi_asr_tpu.tools import sweep_fusion as jax_sweep
from pytorch_kaldi_asr_tpu_torch.recipes import (
    decode,
    prepare_vocab,
    rescore,
    score_lm,
)
from pytorch_kaldi_asr_tpu_torch.tools import best_wer, compute_wer, sweep_fusion
from tests.test_torch_recipe_tools import assert_same_tree

torch.set_num_threads(1)

SCORE_ATOL = 1e-5
WEIGHTS = "10,11,12,13,13.5,14,14.5,15,15.5,16,16.5,17,18,19,20,1000"
DECODE = ["-max_token_seq_len", "12", "-batch_size", "4", "-beam_size", "4",
          "-nbest", "3"]


def _quiet(fn, args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = fn(args)
    assert code in (0, None), fn
    return out.getvalue()


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A synthetic corpus, its vocab and 3-gram LM, and a banded model
    trained two epochs by the JAX CLIs and combined."""
    root = tmp_path_factory.mktemp("pin")
    _quiet(jax_synth.main, ["-out_dir", str(root), "-n_train", "24",
                            "-n_dev", "8", "-n_test", "4", "-feat_dim", "13",
                            "-seed", "4"])
    data = root / "data"
    vocab = data / "vocab.txt"
    _quiet(prepare_vocab.main, ["-read_instances_file", str(data / "train"
                                                            / "text"),
                                "-save_vocab_file", str(vocab)])
    _quiet(jax_train_lm.main, ["-text", str(data / "train" / "text"),
                               "-order", "3", "-lm", str(data / "lm.3k.gz")])
    _quiet(jax_init.main, [
        "-read_feats_scp_file", str(data / "train" / "feats.scp"),
        "-read_vocab_file", str(vocab), "-lda_mat_file", "none",
        "-save_model_file", str(root / "exp" / "model.init"),
        "-encoder_max_len", "64", "-decoder_max_len", "16",
        "-encoder_sub_sequence", "(-16,0)", "-decoder_sub_sequence", "(-4,0)",
        "-en_layers", "1", "-de_layers", "1", "-n_head", "2",
        "-en_d_model", "32", "-de_d_model", "32", "-d_k", "16", "-d_v", "16",
        "-en_dropout", "0.1", "-de_dropout", "0.1", "-encoder_type",
        "banded"])
    _quiet(jax_train.main, [
        "-read_train_dir", str(data / "train"), "-read_dev_dir",
        str(data / "dev"), "-read_test_dir", str(data / "test"),
        "-read_vocab_file", str(vocab), "-load_model_file",
        str(root / "exp" / "model.init"), "-save_model_dir",
        str(root / "exp"), "-epoch", "2", "-batch_size", "8",
        "-save_interval", "1", "-optim_soft_coefficient", "25000"])
    combined = sorted((root / "exp").glob("combined*"))
    assert len(combined) == 1
    return root, data, vocab, combined[0]


def _decode_args(data, vocab, model, out):
    return ["-read_data_dir", str(data / "dev"), "-read_vocab_file",
            str(vocab), "-load_model_file", str(model),
            "-save_result_file", str(out), *DECODE]


def _lines(path):
    return [line.rstrip("\n").split("\t") for line in open(path)]


def test_stage5_decode_matches_jax(trained):
    root, data, vocab, model = trained
    _quiet(jax_decode.main, _decode_args(data, vocab, model,
                                         root / "jax_decode.txt"))
    _quiet(decode.main, _decode_args(data, vocab, model,
                                     root / "port_decode.txt")
           + ["-device", "cpu"])
    want, got = _lines(root / "jax_decode.txt"), _lines(root
                                                         / "port_decode.txt")
    assert len(got) == len(want) == 8 * 3
    for (gk, gs, gw), (wk, ws, ww) in zip(got, want):
        assert (gk, gw) == (wk, ww)
        assert abs(float(gs) - float(ws)) <= SCORE_ATOL
    # a trained model, not one that stops at once
    assert any(words for _, _, words in got)


def test_stage5_scoring_of_jax_decode_is_byte_identical(trained, tmp_path):
    root, data, vocab, model = trained
    nbest = tmp_path / "decode.txt"
    _quiet(jax_decode.main, _decode_args(data, vocab, model, nbest))
    text = data / "dev" / "text"
    for name, sl, rs, cw, bw, device in (
            ("jax", jax_score_lm, jax_rescore, jax_compute_wer,
             jax_best_wer, []),
            ("port", score_lm, rescore, compute_wer, best_wer,
             ["-device", "cpu"])):
        d = tmp_path / name
        d.mkdir()
        _quiet(sl.main, ["-decode_file", str(nbest), "-lm",
                         str(data / "lm.3k.gz"), "-save_score_file",
                         str(d / "lm.3k.score.txt"), *device])
        (d / "scoring").mkdir()
        (d / "scoring" / "scoring.log").write_text(_quiet(rs.main, [
            "-decode_file", str(nbest), "-lm_score",
            str(d / "lm.3k.score.txt"), "-inv_weight_list", WEIGHTS,
            "-save_dir", str(d / "scoring")]))
        for f in sorted(os.listdir(d / "scoring")):
            if f.startswith("rescore"):
                (d / "scoring" / f"{f}_wer").write_text(_quiet(
                    cw.main, ["--mode=present", f"ark:{text}",
                              f"ark:{d}/scoring/{f}"]))
        cwd = os.getcwd()
        os.chdir(d)
        try:
            line = _quiet(bw.main, ["scoring*/*_wer"])
        finally:
            os.chdir(cwd)
        (d / "result.txt").write_text("[INFO] best wer presented in file:\n"
                                      + line)
    assert_same_tree(tmp_path / "jax", tmp_path / "port")
    assert "%WER" in (tmp_path / "port" / "result.txt").read_text()
    assert len(list((tmp_path / "port" / "scoring").glob("*_wer"))) == 16


def test_sweep_fusion_matches_jax(trained, tmp_path):
    root, data, vocab, model = trained
    nlm = tmp_path / "nlm"
    _quiet(jax_train_nlm.main, ["-text", str(data / "train" / "text"),
                                "-read_vocab_file", str(vocab),
                                "-save_model_dir", str(nlm), "-epoch", "2",
                                "-d_model", "16", "-layers", "1",
                                "-max_len", "14"])
    args = ["-read_data_dir", str(data / "dev"), "-read_vocab_file",
            str(vocab), "-load_model_file", str(model), "-nlm_model_dir",
            str(nlm), "-weights", "0,0.5", "-max_token_seq_len", "12",
            "-batch_size", "4", "-beam_size", "4"]
    _quiet(jax_sweep.main, [*args, "-save_dir", str(tmp_path / "jax")])
    _quiet(sweep_fusion.main, [*args, "-save_dir", str(tmp_path / "port"),
                               "-device", "cpu"])
    got = (tmp_path / "port" / "sweep.txt").read_text()
    assert got == (tmp_path / "jax" / "sweep.txt").read_text()
    assert got.splitlines()[-1].startswith("best\tweight ")
    for w in ("0", "0.5"):
        want = _lines(tmp_path / "jax" / f"decode_w{w}.txt")
        port = _lines(tmp_path / "port" / f"decode_w{w}.txt")
        assert [(k, t) for k, _, t in port] == [(k, t) for k, _, t in want]
        for (_, gs, _), (_, ws, _) in zip(port, want):
            assert abs(float(gs) - float(ws)) <= SCORE_ATOL
