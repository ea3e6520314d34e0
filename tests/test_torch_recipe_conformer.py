"""The port's conformer recipe, ``recipes/conformer-librispeech-cuda/
run.sh``, stages 0-5 end to end on the CPU (``device=cpu``) at the JAX
recipe test's tiny knobs (tests/test_librispeech_recipe.py): stage 0
synthesizes a LibriSpeech-shaped corpus in several ark shards, stage 4
packs the training set into ``.npz`` archives and trains the conformer
from them, stage 5 decodes with length buckets, rescores and scores.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

from pytorch_kaldi_asr_tpu_torch.ops.launches import LOG_RE

REPO = Path(__file__).resolve().parents[1]
RUN_SH = REPO / "recipes" / "conformer-librispeech-cuda" / "run.sh"


def test_conformer_run_sh_stages_0_to_5_on_the_cpu(tmp_path):
    env = dict(
        os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", device="cpu",
        scale="0.002", vocab_size="60", epochs="2", batch_size="4",
        size_archive="16", beam_size="3", nbest="2", decode_batch="4",
        decode_buckets="2", max_token_seq_len="16", en_layers="1",
        de_layers="1", n_head="2", en_d_model="32", de_d_model="32",
        encoder_max_len="256", decoder_max_len="20",
        encoder_sub_sequence="(-64,64)", model_dir="exp/conformer_test",
        clean_dir="false",
    )
    proc = subprocess.run(["bash", str(RUN_SH)], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=600)
    sys.stdout.write(proc.stdout[-3000:])
    sys.stderr.write(proc.stderr[-3000:])
    assert proc.returncode == 0

    data = tmp_path / "data"
    manifest = json.loads(
        (data / "train_archives" / "data.manifest.json").read_text())
    assert manifest["archives"] and manifest["src_pad"] <= 256
    assert (data / "language" / "lm.3k.gz").exists()
    model_dir = tmp_path / "exp" / "conformer_test"
    config = json.loads((model_dir / "model.init" / "config.json")
                        .read_text())
    assert config["encoder_type"] == "conformer"
    assert config["conformer_stream_dtype"] == "bfloat16"  # as it ships
    assert list(model_dir.glob("combined*"))
    launches = re.search(LOG_RE, (model_dir / "train.log").read_text())
    assert launches and launches.group(1) == "cpu"
    for split in ("dev", "test"):
        decode_dir = model_dir / f"decode_{split}"
        n_utts = len((data / f"{split}_filtered" / "text").read_text()
                     .splitlines())
        assert len((decode_dir / "decode.txt").read_text()
                   .splitlines()) == 2 * n_utts
        reports = sorted((decode_dir / "scoring").glob("*_wer"))
        assert len(reports) == 7
        result = (decode_dir / "result.txt").read_text().splitlines()
        assert re.match(rf"exp/conformer_test/decode_{split}/scoring/"
                        r"rescore_\S+_wer: %WER [0-9.]+ \[", result[1])
