"""The port's Kaldi I/O and data loading (io/kaldi_io.py, data/*) against the
JAX package's: the port reads arks written by the JAX ArkWriter (plain,
compressed CM/CM2/CM3, text) to the same arrays, and its BatchLoader yields
the same batches.  Exact: no arithmetic differs."""

import numpy as np
import pytest
import torch

from pytorch_kaldi_asr_tpu.data import loader as jax_loader
from pytorch_kaldi_asr_tpu.data.instances import read_vocab as jax_read_vocab
from pytorch_kaldi_asr_tpu.io import kaldi_io as jax_io
from pytorch_kaldi_asr_tpu_torch.data import loader, read_vocab
from pytorch_kaldi_asr_tpu_torch.io import kaldi_io
from tests.torch_port_helpers import write_data_dir

torch.set_num_threads(1)


def _mats(seed=0):
    rng = np.random.default_rng(seed)
    return {f"u{i}": (rng.normal(size=(n, 7)) * 3).astype(np.float32)
            for i, n in enumerate([1, 5, 17, 40])}


@pytest.mark.parametrize("compress", [False, "CM", "CM2", "CM3"])
def test_reads_arks_written_by_jax(tmp_path, monkeypatch, compress):
    """Exact against the JAX package's pure-Python readers (its optional
    native parser rounds the compressed codes in float32 instead)."""
    monkeypatch.setattr(jax_io, "_native", lambda: None)
    mats = _mats()
    ark, scp = tmp_path / "f.ark", tmp_path / "f.scp"
    with jax_io.ArkWriter(str(ark), str(scp), compress=compress) as w:
        for key, mat in mats.items():
            w.write(key, mat)
    got = dict(kaldi_io.read_mat_scp(str(scp)))
    want = dict(jax_io.read_mat_scp(str(scp)))
    assert list(got) == list(mats)
    for key, mat in mats.items():
        np.testing.assert_array_equal(got[key], want[key])
        assert got[key].dtype == np.float32
        step = {False: 0, "CM": 0.5, "CM2": 1 / 65535, "CM3": 1 / 255}[compress]
        spread = float(max(m.max() for m in mats.values())
                       - min(m.min() for m in mats.values()))
        np.testing.assert_allclose(got[key], mat,
                                   atol=step * spread + 1e-6)
    for key, rx in kaldi_io.scp_entries(str(scp)):
        assert kaldi_io.mat_num_rows(rx) == mats[key].shape[0]


def test_reads_text_and_double_matrices(tmp_path):
    mats = _mats(1)
    with jax_io.ArkWriter(str(tmp_path / "t.ark"), str(tmp_path / "t.scp"),
                          text=True) as w:
        for key, mat in mats.items():
            w.write(key, mat)
    for key, rx in kaldi_io.scp_entries(str(tmp_path / "t.scp")):
        np.testing.assert_array_equal(kaldi_io.read_mat(rx),
                                      jax_io.read_mat(rx))
    with jax_io.ArkWriter(str(tmp_path / "d.ark"),
                          str(tmp_path / "d.scp")) as w:
        w.write("dbl", mats["u2"].astype(np.float64))
    (_, rx), = kaldi_io.scp_entries(str(tmp_path / "d.scp"))
    got = kaldi_io.read_mat(rx)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, mats["u2"].astype(np.float64))


def test_port_ark_writer_reads_back_in_jax(tmp_path):
    mats = _mats(2)
    with kaldi_io.ArkWriter(str(tmp_path / "p.ark"),
                            str(tmp_path / "p.scp")) as w:
        for key, mat in mats.items():
            w.write(key, mat)
    got = dict(jax_io.read_mat_scp(str(tmp_path / "p.scp")))
    for key, mat in mats.items():
        np.testing.assert_array_equal(got[key], mat)


@pytest.mark.parametrize("num_buckets", [1, 4])
def test_batch_loader_matches_jax(tmp_path, num_buckets):
    data = write_data_dir(tmp_path, n_utts=11, lengths=(3, 40))
    vocab = read_vocab(str(data / "vocab.txt"))
    assert vocab == jax_read_vocab(str(data / "vocab.txt"))
    kw = dict(mode="all", shuffle=False, num_buckets=num_buckets)
    ours = list(loader.make_batch_loader(str(data), vocab, 3, **kw))
    theirs = list(jax_loader.make_batch_loader(str(data), vocab, 3, **kw))
    assert len(ours) == len(theirs) >= 4
    for a, b in zip(ours, theirs):
        assert a.keys == b.keys
        for name in ("src", "src_mask", "tgt", "tgt_mask", "valid"):
            x, y = getattr(a, name), getattr(b, name)
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y)

    shuffled = dict(mode="drop", shuffle=True, num_buckets=num_buckets,
                    seed=5)
    ours = loader.make_batch_loader(str(data), vocab, 2, **shuffled)
    theirs = jax_loader.make_batch_loader(str(data), vocab, 2, **shuffled)
    for _epoch in range(2):
        assert [b.keys for b in ours] == [b.keys for b in theirs]


def test_to_device_keeps_arrays():
    batch = loader.Batch(keys=("a",), src=np.ones((1, 3, 2), np.float32),
                         src_mask=np.ones((1, 3), np.uint8),
                         tgt=np.array([[2, 5, 3]], np.int32),
                         tgt_mask=np.ones((1, 3), np.uint8),
                         valid=np.ones(1, np.uint8))
    moved = loader.to_device(batch, "cpu")
    assert moved.keys == ("a",)
    assert moved.src.dtype == torch.float32 and moved.tgt.dtype == torch.int64
    np.testing.assert_array_equal(moved.tgt.numpy(), batch.tgt)
