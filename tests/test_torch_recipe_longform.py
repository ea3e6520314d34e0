"""The long-form hybrid recipe on the port, on the CPU.

- ``recipes/longform-conformer-cuda/run.sh`` stages 0-4 with
  ``device=cpu`` at the sizes of tests/test_longform_sp.py (16/4/4
  utterances of 20-30 words x 8 frames, 10-dim features, 4 epochs,
  d_model 64, band (-16, 0)) but on one device (``seq_shards`` 1): %WER
  under 60 %, a CTM line with a positive duration for at least 80 % of the
  test words, and the device-running CLIs logging the CPU.
- The recipe calls modules of the port only.
- A conformer AM trained by the JAX package's ``train_am`` goes through
  both packages' ``dump_posteriors`` (posteriors within 1e-5) and
  ``latgen`` over the port's HLG (decode.txt byte for byte), and with a
  priors file (tools/compute_priors.py) through both dumps again.
"""

import os
import subprocess
from pathlib import Path

import numpy as np
import torch

from pytorch_kaldi_asr_tpu.io.kaldi_io import read_mat_scp as jax_read_scp
from pytorch_kaldi_asr_tpu.recipes import dump_posteriors as jax_dump
from pytorch_kaldi_asr_tpu.recipes import latgen as jax_latgen
from pytorch_kaldi_asr_tpu.recipes import train_am as jax_train_am
from pytorch_kaldi_asr_tpu.tools import compute_priors as jax_priors
from pytorch_kaldi_asr_tpu_torch.io.kaldi_io import read_mat_scp
from pytorch_kaldi_asr_tpu_torch.recipes import (
    dump_posteriors,
    latgen,
    mkgraph,
    train_lm,
)
from pytorch_kaldi_asr_tpu_torch.tools import compute_priors
from pytorch_kaldi_asr_tpu_torch.tools import make_synthetic_data

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
RECIPE = REPO / "recipes" / "longform-conformer-cuda"
POST_ATOL = 1e-5
KNOBS = dict(device="cpu", seq_shards="1", n_train="16", n_dev="4",
             n_test="4", feat_dim="10", min_words="20", max_words="30",
             frames_per_word="8", epochs="4", batch_size="4",
             en_d_model="64", encoder_sub_sequence="(-16,0)", lr="0.003")


def test_longform_recipe_on_the_cpu(tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""), **KNOBS)
    proc = subprocess.run(["bash", str(RECIPE / "run.sh")], env=env,
                          cwd=str(tmp_path), capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    wer_text = (tmp_path / "exp" / "wer").read_text()
    wer = float(wer_text.split("%WER")[1].split()[0])
    assert wer < 60.0, wer_text
    ctm = (tmp_path / "exp" / "test.ctm").read_text().strip().splitlines()
    assert len(ctm) >= 20 * 4 * 0.8
    for line in ctm:
        parts = line.split()
        assert len(parts) == 6 and float(parts[3]) > 0
    # train_am and dump_posteriors ran on the CPU, as asked
    assert proc.stdout.count("kernel launches on cpu") == 2


def test_longform_recipe_calls_only_the_port():
    scripts = sorted(RECIPE.rglob("*.sh"))
    assert [p.name for p in scripts] == ["path.sh", "run.sh"]
    text = "".join(p.read_text() for p in scripts)
    assert "pytorch_kaldi_asr_tpu." not in text
    assert text.count("python3 -m pytorch_kaldi_asr_tpu_torch.") == 9


def _posteriors(scp, reader):
    return dict(reader(str(scp)))


def test_jax_trained_am_dumps_and_decodes_alike(tmp_path):
    make_synthetic_data.main(["-out_dir", str(tmp_path), "-n_train", "8",
                              "-n_dev", "4", "-n_test", "5", "-feat_dim",
                              "10"])
    data = tmp_path / "data"
    model = tmp_path / "am"
    jax_train_am.train_am(str(data / "train"), str(data / "dev"), str(model),
                          encoder_type="conformer", epochs=2, batch_size=4,
                          lr=0.003, en_d_model=32,
                          encoder_sub_sequence=(-8, 4), en_dropout=0.1)
    train_lm.main(["-text", str(data / "train" / "text"), "-order", "3",
                   "-lm", str(tmp_path / "lm.gz")])
    mkgraph.main(["-phones", str(data / "phones.txt"), "-self_lexicon",
                  "-lm", str(tmp_path / "lm.gz"), "-graph_dir",
                  str(tmp_path / "graph")])
    for priors in (False, True):
        extra = []
        if priors:
            ali = str(data / "train" / "ali.txt")
            assert compute_priors.main(["-ali", ali, "-n_targets", "12",
                                        "-save_priors_file",
                                        str(tmp_path / "p.txt")]) == 0
            assert jax_priors.main(["-ali", ali, "-n_targets", "12",
                                    "-save_priors_file",
                                    str(tmp_path / "pj.txt")]) == 0
            assert (tmp_path / "p.txt").read_bytes() == \
                (tmp_path / "pj.txt").read_bytes()
            extra = ["-priors_file", str(tmp_path / "p.txt")]
        dump = ["-read_data_dir", str(data / "test"), "-load_model_file",
                str(model), "-batch_size", "2", *extra]
        assert dump_posteriors.main(dump + [
            "-wspecifier", f"ark,scp:{tmp_path}/p.ark,{tmp_path}/p.scp",
            "-device", "cpu"]) == 0
        assert jax_dump.main(dump + [
            "-wspecifier", f"ark,scp:{tmp_path}/j.ark,{tmp_path}/j.scp"]) == 0
        got = _posteriors(tmp_path / "p.scp", read_mat_scp)
        want = _posteriors(tmp_path / "j.scp", jax_read_scp)
        assert list(got) == list(want) and len(got) == 5
        for key in want:
            assert got[key].shape == want[key].shape
            np.testing.assert_allclose(got[key], want[key], atol=POST_ATOL)
        decode = ["-graph_dir", str(tmp_path / "graph"), "-beam", "14"]
        assert latgen.main(decode + ["-rspecifier", f"scp:{tmp_path}/p.scp",
                                     "-save_result_file",
                                     str(tmp_path / "p.txt.dec")]) == 0
        assert jax_latgen.main(decode + [
            "-rspecifier", f"scp:{tmp_path}/j.scp", "-save_result_file",
            str(tmp_path / "j.txt.dec")]) == 0
        assert (tmp_path / "p.txt.dec").read_bytes() == \
            (tmp_path / "j.txt.dec").read_bytes()
