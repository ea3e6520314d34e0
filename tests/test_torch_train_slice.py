"""Slice 2 end to end: stage-4 ``train`` (which ends in ``combine``) and the
standalone ``combine`` CLI, the JAX package's against the port's
(``-device cpu``).

- From one JAX-written ``model.init`` of the banded-encoder transformer,
  with dropout off, both ``recipes.train`` runs write the same checkpoint
  names over two epochs (the names carry the dev accuracies), the same
  ``metrics.jsonl`` steps and accuracies, and losses within 1e-5 relative.
- ``recipes.combine`` over the same JAX checkpoints writes the same
  ``combined.accuXX.XX`` and parameters within 1e-6.
- With jax, flax, optax, msgpack and the JAX package blocked, the port's
  initialize_model → train → combine → decode runs on the CPU.
- The train CLI refuses what it cannot do and exits 75 after preemption.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from pytorch_kaldi_asr_tpu.recipes import combine as jax_combine
from pytorch_kaldi_asr_tpu.recipes import initialize_model as jax_init
from pytorch_kaldi_asr_tpu.recipes import train as jax_train
from pytorch_kaldi_asr_tpu.train.checkpoint import load_checkpoint as jax_load
from pytorch_kaldi_asr_tpu_torch.recipes import combine, train
from pytorch_kaldi_asr_tpu_torch.train import TrainResult, load_checkpoint
from pytorch_kaldi_asr_tpu_torch.utils.constants import PREEMPT_EXIT_CODE
from tests.torch_port_helpers import leaves, write_data_dir

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-5

MODEL_FLAGS = [
    "-encoder_max_len", "48", "-decoder_max_len", "12",
    "-encoder_sub_sequence", "(-8,0)", "-decoder_sub_sequence", "(-3,0)",
    "-en_layers", "2", "-de_layers", "2", "-n_head", "2",
    "-en_d_model", "32", "-de_d_model", "16", "-d_k", "8", "-d_v", "8",
    "-en_dropout", "0", "-de_dropout", "0", "-encoder_type", "banded",
]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """train/dev/test dirs and a JAX-written model.init."""
    root = tmp_path_factory.mktemp("corpus")
    dirs = {name: write_data_dir(root / name, n_utts=n, seed=seed)
            for name, n, seed in (("train", 12, 1), ("dev", 5, 2),
                                  ("test", 5, 3))}
    assert jax_init.main([
        "-read_feats_scp_file", str(dirs["train"] / "feats.scp"),
        "-lda_mat_file", "identity", "-read_vocab_file",
        str(dirs["train"] / "vocab.txt"), "-seed", "7",
        "-save_model_file", str(root / "model.init"), *MODEL_FLAGS]) == 0
    return root, dirs


def _train_args(root, dirs, out):
    return ["-read_train_dir", str(dirs["train"]), "-read_dev_dir",
            str(dirs["dev"]), "-read_test_dir", str(dirs["test"]),
            "-read_vocab_file", str(dirs["train"] / "vocab.txt"),
            "-load_model_file", str(root / "model.init"),
            "-save_model_dir", str(out), "-epoch", "2", "-batch_size", "4",
            "-save_interval", "1", "-optim_start_lr", "0.003",
            "-optim_soft_coefficient", "25000"]


def _checkpoints(path):
    return sorted(p for p in os.listdir(path) if (Path(path) / p).is_dir())


def _records(path):
    return [json.loads(line) for line in open(Path(path) / "metrics.jsonl")]


def test_train_and_combine_clis_match_jax(corpus, tmp_path):
    root, dirs = corpus
    assert jax_train.main(_train_args(root, dirs, tmp_path / "jax")) == 0
    assert train.main(_train_args(root, dirs, tmp_path / "port")
                      + ["-device", "cpu"]) == 0

    names = _checkpoints(tmp_path / "jax")
    assert names == _checkpoints(tmp_path / "port")
    assert {"epoch.1", "epoch.2"} <= set(names)
    assert any(n.startswith("best.epoch") for n in names)
    assert any(n.startswith("combined.accu") for n in names)
    want, got = _records(tmp_path / "jax"), _records(tmp_path / "port")
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert (g["epoch"], g["step"]) == (w["epoch"], w["step"])
        for key in ("train_accu", "dev_accu", "test_accu"):
            assert g[key] == pytest.approx(w[key], abs=1e-9), key
        assert g["train_loss"] == pytest.approx(w["train_loss"],
                                                rel=LOSS_RTOL)
    assert (tmp_path / "port" / "epoch.2" / "opt_state.pt").exists()

    # the standalone combine over the JAX run's checkpoints
    models = ",".join(str(tmp_path / "jax" / f"epoch.{e}") for e in (2, 1))
    args = ["-model_list", models, "-read_data_dir", str(dirs["test"]),
            "-read_vocab_file", str(dirs["train"] / "vocab.txt"),
            "-batch_size", "4"]
    assert jax_combine.main(args + ["-save_model_dir",
                                    str(tmp_path / "cj")]) == 0
    assert combine.main(args + ["-save_model_dir", str(tmp_path / "cp"),
                                "-device", "cpu"]) == 0
    (name,) = _checkpoints(tmp_path / "cj")
    assert _checkpoints(tmp_path / "cp") == [name]
    ours = load_checkpoint(str(tmp_path / "cp" / name))["params"]
    theirs = jax_load(str(tmp_path / "cj" / name))["params"]
    for a, b in zip(leaves(ours), jax.tree_util.tree_leaves(theirs)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


_NO_JAX = textwrap.dedent("""
    import importlib.abc, sys
    from pathlib import Path

    BLOCKED = {"jax", "jaxlib", "flax", "optax", "msgpack",
               "pytorch_kaldi_asr_tpu"}

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("blocked import: " + name)
            return None

    sys.meta_path.insert(0, Block())
    import numpy as np
    from pytorch_kaldi_asr_tpu_torch.io.kaldi_io import ArkWriter
    from pytorch_kaldi_asr_tpu_torch.recipes import (
        combine, decode, initialize_model, train)

    work = Path(sys.argv[1])
    rng = np.random.default_rng(0)
    words = ["<blank>", "<unk>", "<s>", "</s>", "a", "b", "c"]
    (work / "vocab.txt").write_text(
        "".join(f"{w} {i}\\n" for i, w in enumerate(words)))
    with ArkWriter(str(work / "feats.ark"), str(work / "feats.scp")) as ark:
        for u in range(4):
            ark.write(f"u{u}", rng.normal(size=(10 + 7 * u, 6))
                      .astype(np.float32))
    (work / "text").write_text("u0 a b\\nu1 c\\nu2 a c a\\nu3 b\\n")
    data = ["-read_vocab_file", str(work / "vocab.txt")]
    initialize_model.main([
        "-read_feats_scp_file", str(work / "feats.scp"), "-lda_mat_file",
        "identity", *data, "-encoder_max_len", "40", "-decoder_max_len", "8",
        "-en_layers", "1", "-de_layers", "1", "-n_head", "2",
        "-en_d_model", "16", "-de_d_model", "8", "-d_k", "4", "-d_v", "4",
        "-encoder_type", "banded", "-save_model_file", str(work / "m")])
    assert train.main(["-read_train_dir", str(work), "-read_dev_dir",
                       str(work), "-read_test_dir", str(work), *data,
                       "-load_model_file", str(work / "m"),
                       "-save_model_dir", str(work / "exp"), "-epoch", "2",
                       "-batch_size", "2", "-save_interval", "1",
                       "-device", "cpu"]) == 0
    combined = sorted((work / "exp").glob("combined.*"))[-1]
    assert combine.main(["-model_list", f"{work}/exp/epoch.2,{work}/exp/epoch.1",
                         "-read_data_dir", str(work), *data,
                         "-save_model_dir", str(work / "c"), "-batch_size",
                         "2", "-device", "cpu"]) == 0
    decode.main(["-read_data_dir", str(work), *data, "-load_model_file",
                 str(combined), "-save_result_file", str(work / "decode.txt"),
                 "-max_token_seq_len", "6", "-batch_size", "2",
                 "-beam_size", "3", "-nbest", "2", "-device", "cpu"])
    assert not BLOCKED & set(m.split(".")[0] for m in sys.modules)
    print("lines", len((work / "decode.txt").read_text().splitlines()))
""")


def test_port_trains_and_decodes_with_jax_blocked(tmp_path):
    proc = subprocess.run([sys.executable, "-c", _NO_JAX, str(tmp_path)],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "lines 8"
    assert len(list((tmp_path / "c").glob("combined.accu*"))) == 1


def test_train_cli_refuses_what_it_cannot_do(tmp_path, monkeypatch):
    args = ["-read_train_dir", "x", "-read_dev_dir", "x", "-read_test_dir",
            "x", "-read_vocab_file", "x", "-load_model_file", "x",
            "-save_model_dir", str(tmp_path)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="-device cpu"):
        train.main(args)
    with pytest.raises(RuntimeError, match="-device cpu"):
        combine.main(["-model_list", "x", "-read_data_dir", "x",
                      "-read_vocab_file", "x", "-save_model_dir", "x"])
    # -specaugment is ported (tests/test_torch_specaugment.py): it runs on
    # the card, or on the CPU when asked, as every other flag
    with pytest.raises(RuntimeError, match="-device cpu"):
        train.main(args + ["-specaugment"])


def test_train_cli_exits_preempt_code(tmp_path, monkeypatch):
    """A preempted run exits 75 and skips the combine stage."""
    combined = []
    monkeypatch.setattr(train, "load_checkpoint",
                        lambda p: {"params": {}, "cfg": None})
    monkeypatch.setattr(train, "read_vocab", lambda p: {})
    monkeypatch.setattr(train, "make_batch_loader", lambda *a, **k: None)
    monkeypatch.setattr(train, "train_model",
                        lambda *a, **k: TrainResult({}, 0, 0.0, True))
    monkeypatch.setattr(train, "combine_checkpoints",
                        lambda *a, **k: combined.append(1))
    rc = train.main(["-read_train_dir", "x", "-read_dev_dir", "x",
                     "-read_test_dir", "x", "-read_vocab_file", "x",
                     "-load_model_file", "x", "-save_model_dir",
                     str(tmp_path), "-device", "cpu"])
    assert rc == PREEMPT_EXIT_CODE == 75
    assert combined == []
