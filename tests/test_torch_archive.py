"""Batch archives (data/archive.py, recipes/generate_archive.py) and the
train CLI's ``-train_archive_dir``, the port's against the JAX package's.

- Archives written by either package load in the other's
  ``ArchiveBatchLoader`` and give the same batches in the same order for a
  given seed and epoch, in ``drop`` and ``all`` modes.
- Both ``generate_archive`` CLIs write the same manifest and arrays.
- From one JAX-written conformer ``model.init`` (dropout off), both train
  CLIs streaming the archives write the same checkpoint names and
  ``metrics.jsonl`` records over two epochs, straight and resumed (losses
  within 1e-5 relative).
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from pytorch_kaldi_asr_tpu.data.archive import (
    ArchiveBatchLoader as JaxArchiveLoader,
    generate_archives as jax_generate,
)
from pytorch_kaldi_asr_tpu.data.loader import build_triples as jax_triples
from pytorch_kaldi_asr_tpu.recipes import generate_archive as jax_generate_cli
from pytorch_kaldi_asr_tpu.recipes import initialize_model as jax_init
from pytorch_kaldi_asr_tpu.recipes import train as jax_train
from pytorch_kaldi_asr_tpu_torch.data import read_vocab
from pytorch_kaldi_asr_tpu_torch.data.archive import (
    ArchiveBatchLoader,
    generate_archives,
)
from pytorch_kaldi_asr_tpu_torch.data.loader import build_triples
from pytorch_kaldi_asr_tpu_torch.recipes import generate_archive, train
from tests.torch_port_helpers import write_data_dir

torch.set_num_threads(1)

LOSS_RTOL = 1e-5


def _triples(data):
    return build_triples(str(data / "feats.scp"), str(data / "text"),
                         read_vocab(str(data / "vocab.txt")))


def _same_batches(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.keys == y.keys
        for u, v in zip(x[1:], y[1:]):
            assert u.dtype == v.dtype
            np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("mode", ["drop", "all"])
def test_archives_load_in_both_packages_with_the_same_batches(tmp_path,
                                                              writer, mode):
    data = write_data_dir(tmp_path / "data", n_utts=13, seed=2)
    write = generate_archives if writer == "port" else jax_generate
    manifest = write(_triples(data), str(tmp_path / "ar"), size_archive=5)
    assert manifest["archives"] == [f"data{i}.archive.npz" for i in range(3)]
    for seed in (0, 4):
        ours = ArchiveBatchLoader(str(tmp_path / "ar"), 4, mode=mode,
                                  seed=seed)
        theirs = JaxArchiveLoader(str(tmp_path / "ar"), 4, mode=mode,
                                  seed=seed)
        epochs = [list(ours) for _ in range(3)]
        for got in epochs:
            _same_batches(got, list(theirs))
        assert epochs[0][0].keys != epochs[1][0].keys  # reshuffled per epoch
        n = sum(int(b.valid.sum()) for b in epochs[0])
        assert n == (12 if mode == "drop" else 13)


@pytest.mark.parametrize("prefix", [None, "dev"])
def test_generate_archive_clis_write_the_same_archives(tmp_path, prefix):
    data = write_data_dir(tmp_path / "data", n_utts=9, seed=3)
    args = ["-read_data_dir", str(data), "-read_vocab_file",
            str(data / "vocab.txt"), "-size_archive", "4"]
    if prefix:
        args += ["-prefix", prefix]
    assert generate_archive.main(args + ["-save_archive_dir",
                                         str(tmp_path / "port")]) == 0
    assert jax_generate_cli.main(args + ["-save_archive_dir",
                                         str(tmp_path / "jax")]) == 0
    name = f"{prefix or 'data'}.manifest.json"
    manifest = json.loads((tmp_path / "port" / name).read_text())
    assert manifest == json.loads((tmp_path / "jax" / name).read_text())
    assert manifest["archives"] == [f"{prefix or 'data'}{i}.archive.npz"
                                    for i in range(3)]
    assert manifest["total"] == len(jax_triples(
        str(data / "feats.scp"), str(data / "text"),
        read_vocab(str(data / "vocab.txt")))) == 9
    for name in manifest["archives"]:
        with np.load(tmp_path / "port" / name) as a, \
                np.load(tmp_path / "jax" / name) as b:
            assert sorted(a.files) == sorted(b.files)
            for key in a.files:
                np.testing.assert_array_equal(a[key], b[key])


MODEL_FLAGS = [
    "-encoder_max_len", "48", "-decoder_max_len", "12",
    "-encoder_sub_sequence", "(-8,8)", "-decoder_sub_sequence", "(-3,0)",
    "-en_layers", "1", "-de_layers", "1", "-n_head", "2",
    "-en_d_model", "16", "-de_d_model", "16", "-d_k", "8", "-d_v", "8",
    "-en_dropout", "0", "-de_dropout", "0", "-encoder_type", "conformer",
    "-lda_mat_file", "none",
]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """train/dev/test dirs, the train set's archives (three, the last one
    short) and a JAX-written conformer model.init."""
    root = tmp_path_factory.mktemp("corpus")
    dirs = {name: write_data_dir(root / name, n_utts=n, seed=seed)
            for name, n, seed in (("train", 11, 1), ("dev", 5, 2),
                                  ("test", 5, 3))}
    vocab = str(dirs["train"] / "vocab.txt")
    assert generate_archive.main([
        "-read_data_dir", str(dirs["train"]), "-read_vocab_file", vocab,
        "-save_archive_dir", str(root / "archives"), "-size_archive",
        "5"]) == 0
    assert jax_init.main([
        "-read_feats_scp_file", str(dirs["train"] / "feats.scp"),
        "-read_vocab_file", vocab, "-seed", "5",
        "-save_model_file", str(root / "model.init"), *MODEL_FLAGS]) == 0
    return root, dirs


def _train_args(root, dirs, out, epochs):
    return ["-read_train_dir", str(dirs["train"]), "-train_archive_dir",
            str(root / "archives"), "-read_dev_dir", str(dirs["dev"]),
            "-read_test_dir", str(dirs["test"]), "-read_vocab_file",
            str(dirs["train"] / "vocab.txt"), "-load_model_file",
            str(root / "model.init"), "-save_model_dir", str(out),
            "-epoch", str(epochs), "-batch_size", "4", "-save_interval", "1",
            "-optim_start_lr", "0.003", "-optim_soft_coefficient", "25000"]


def _checkpoints(path):
    return sorted(p for p in os.listdir(path) if (Path(path) / p).is_dir())


def _records(path):
    return [json.loads(line) for line in open(Path(path) / "metrics.jsonl")]


def _same_runs(port, jax_dir):
    assert _checkpoints(port) == _checkpoints(jax_dir)
    want, got = _records(jax_dir), _records(port)
    assert len(got) == len(want) == 2  # one per epoch
    for g, w in zip(got, want):
        assert (g["epoch"], g["step"]) == (w["epoch"], w["step"])
        for key in ("train_accu", "dev_accu", "test_accu"):
            assert g[key] == pytest.approx(w[key], abs=1e-9), key
        assert g["train_loss"] == pytest.approx(w["train_loss"],
                                                rel=LOSS_RTOL)


@pytest.mark.parametrize("resumed", [False, True], ids=["straight", "resumed"])
def test_train_cli_streams_archives_like_jax(corpus, tmp_path, resumed):
    """Two epochs from the archives (two steps each: 11 utterances, batch 4,
    the remainder carried across archives and dropped); resumed = one
    epoch, then ``-epoch 2 -resume`` in a new loader, as a rerun does."""
    root, dirs = corpus
    for name, run in (("jax", jax_train.main),
                      ("port", lambda a: train.main(a + ["-device", "cpu"]))):
        out = tmp_path / name
        if resumed:
            assert run(_train_args(root, dirs, out, 1)) == 0
            assert run(_train_args(root, dirs, out, 2) + ["-resume"]) == 0
        else:
            assert run(_train_args(root, dirs, out, 2)) == 0
    _same_runs(tmp_path / "port", tmp_path / "jax")
    names = _checkpoints(tmp_path / "port")
    assert {"epoch.1", "epoch.2"} <= set(names)
    assert any(n.startswith("combined.accu") for n in names)
    assert [r["step"] for r in _records(tmp_path / "port")][-1] == 4
