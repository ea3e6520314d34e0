"""The port's TIMIT recipe, ``recipes/attention-transformer-timit-cuda/
run.sh``, stages 0-5 end to end on the CPU (``device=cpu``) at the JAX
recipe test's scaled knobs (tests/test_recipe_e2e.py), with the banded
encoder, ``cmvn=true`` and ``nlm_rescore=true``.  Stage 0 starts from a
``wav.scp``, so the port's fbank runs, then feat-to-len, the length filter
and CMVN with per-speaker stats; stage 5 decodes, scores with both LMs,
rescores and writes the WER reports and ``result.txt``.

Without a card, ``device=cuda`` (the default) fails at its first device
step rather than fall back to the CPU.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from pytorch_kaldi_asr_tpu_torch.io import kaldi_io
from pytorch_kaldi_asr_tpu_torch.ops.launches import LOG_RE
from pytorch_kaldi_asr_tpu_torch.tools.wav import write_wav
from pytorch_kaldi_asr_tpu_torch.utils.logging import STARTUP_RE

REPO = Path(__file__).resolve().parents[1]
RUN_SH = REPO / "recipes" / "attention-transformer-timit-cuda" / "run.sh"
WORDS = ["sil", "ah", "ae", "iy", "uw", "k", "t", "d", "s", "m", "n", "r"]
KNOBS = dict(
    epochs="3", batch_size="8", beam_size="4", nbest="2", decode_batch="4",
    max_token_seq_len="12", en_layers="1", de_layers="1", en_d_model="32",
    de_d_model="32", encoder_max_len="64", decoder_max_len="16",
    model_dir="exp/model_test", clean_dir="false", nlm_rescore="true",
    nlm_epochs="3", cmvn="true", lda_mat="none", encoder_type="banded",
)

# the CLIs run.sh runs at KNOBS, stages 0-5
CLIS = {"fbank", "feat_to_len", "trim_instance_length", "compute_cmvn_stats",
        "cmvn", "prepare_vocab", "train_lm", "train_nlm", "initialize_model",
        "launch", "train", "decode", "score_lm", "rescore", "compute_wer",
        "best_wer"}


def write_wav_corpus(root, sizes=(("train", 24), ("dev", 8), ("test", 8)),
                     seed=0):
    """Data dirs of 16 kHz WAVs (0.3-0.6 s of noise, 4 utterances a
    speaker): wav.scp, text and utt2spk."""
    rng = np.random.default_rng(seed)
    for split, n in sizes:
        d = root / "data" / split
        d.mkdir(parents=True)
        scp, text, utt2spk = [], [], []
        for u in range(n):
            spk = f"{split}spk{u // 4}"
            key = f"{spk}_u{u:03d}"
            samples = rng.normal(scale=1000,
                                 size=int(16000 * rng.uniform(0.3, 0.6)))
            write_wav(str(d / f"{key}.wav"), samples, 16000)
            scp.append(f"{key} {d / key}.wav\n")
            words = rng.choice(WORDS, size=int(rng.integers(2, 5)))
            text.append(f"{key} {' '.join(words)}\n")
            utt2spk.append(f"{key} {spk}\n")
        (d / "wav.scp").write_text("".join(scp))
        (d / "text").write_text("".join(text))
        (d / "utt2spk").write_text("".join(utt2spk))


def run_recipe(cwd, **knobs):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               **knobs)
    return subprocess.run(["bash", str(RUN_SH)], cwd=str(cwd), env=env,
                          capture_output=True, text=True, timeout=600)


def test_run_sh_stages_0_to_5_on_the_cpu(tmp_path):
    write_wav_corpus(tmp_path)
    proc = run_recipe(tmp_path, device="cpu", **KNOBS)
    sys.stdout.write(proc.stdout[-3000:])
    sys.stderr.write(proc.stderr[-3000:])
    assert proc.returncode == 0

    data = tmp_path / "data"
    # stage 0: fbank features from the wavs, then CMVN'd into the filtered
    # dirs
    feats = dict(kaldi_io.read_mat_scp(str(data / "train" / "feats.scp")))
    assert len(feats) == 24 and all(m.shape[1] == 23 for m in feats.values())
    normed = dict(kaldi_io.read_mat_scp(
        str(data / "train_filtered" / "feats.scp")))
    assert set(normed) == set(feats)
    assert (data / "train_filtered" / "cmvn.scp").exists()
    spk = np.concatenate([normed[k] for k in normed if "spk0_" in k])
    np.testing.assert_allclose(spk.mean(axis=0), 0.0, atol=1e-4)
    # stages 1-2
    vocab = (data / "language" / "vocab.txt").read_text().split("\n")
    assert vocab[-2] == f"#0 {len(vocab) - 2}"
    assert (data / "language" / "lm.3k.gz").exists()
    assert (data / "language" / "nlm" / "params.msgpack").exists()
    # stages 3-5
    model_dir = tmp_path / "exp" / "model_test"
    assert (model_dir / "model.init" / "params.msgpack").exists()
    assert list(model_dir.glob("combined*"))
    train_log = (model_dir / "train.log").read_text()
    assert "# Ended (code 0)" in train_log
    launches = re.search(LOG_RE, train_log)
    assert launches and launches.group(1) == "cpu"
    for split in ("dev", "test"):
        decode_dir = model_dir / f"decode_{split}"
        nbest = (decode_dir / "decode.txt").read_text().splitlines()
        assert len(nbest) == 8 * 2
        assert re.search(LOG_RE, (decode_dir / "decode.log").read_text())
        for scores in ("lm.3k.score.txt", "nlm.score.txt"):
            assert len((decode_dir / scores).read_text().split()) == 16
        for scoring, n in (("scoring", 16), ("scoring_nlm", 7)):
            reports = sorted((decode_dir / scoring).glob("*_wer"))
            assert len(reports) == n
            assert all(r.read_text().startswith("%WER ") for r in reports)
        result = (decode_dir / "result.txt").read_text().splitlines()
        assert result[0] == "[INFO] best wer presented in file:"
        assert re.match(rf"exp/model_test/decode_{split}/scoring(_nlm)?/"
                        r"rescore_\S+_wer: %WER [0-9.]+ \[", result[1])
    # every CLI the recipe ran logged its start-up: to run.sh's stderr, or
    # through the launcher to its job's log
    logs = [proc.stderr, train_log,
            *((model_dir / f"decode_{s}" / "decode.log").read_text()
              for s in ("dev", "test"))]
    started = {name for text in logs for name, _ in re.findall(STARTUP_RE,
                                                              text)}
    assert started == CLIS


@pytest.mark.parametrize("stage,what", [("0", "fbank"), ("2", "train_nlm")])
def test_run_sh_without_a_card_fails_rather_than_fall_back(tmp_path, stage,
                                                           what):
    """Without a card, the default ``device=cuda`` fails at the stage's
    first device step: fbank in stage 0, the neural LM in stage 2."""
    write_wav_corpus(tmp_path, sizes=(("train", 2), ("dev", 1),
                                      ("test", 1)))
    (tmp_path / "data" / "language").mkdir()  # stage 1's
    proc = run_recipe(tmp_path, **dict(KNOBS, stage=stage))
    assert proc.returncode != 0
    assert "no CUDA device is visible" in proc.stderr
    assert what in proc.stderr
