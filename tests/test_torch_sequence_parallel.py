"""The port's sequence parallelism (pytorch_kaldi_asr_tpu_torch/parallel/
sequence.py) against the JAX package's on its 8-device CPU mesh
(tests/conftest.py): 8 gloo ranks of tests/torch_parallel_worker.py, one
world for every case of this module, started by the port's ``launch
--gang``; the JAX package's weights carried over (params_from_jax), the
inputs from numpy seeds.  JAX's bars (tests/test_sequence_parallel.py,
tests/test_longform_sp.py):

- the halo's contents exactly;
- the banded (three bands) and conformer forwards within 2e-5 and 3e-5
  of JAX's ``sp_*_encode`` (the conformer on the valid frames);
- the gradients of a squared-output loss within 1e-5 of each leaf's
  largest, summed over the ranks;
- ``sp_frame_ce_loss`` within 2e-5 with the counts equal, at unequal valid
  frames per shard and with a last shard that is all padding, and the
  gradients of the loss over the GLOBAL frame count within 1e-5 of JAX's
  (a rank normalising by its own frames would miss);
- the validation errors with JAX's messages;
- independent dropout streams per shard, reproducible per step seed;
- ``train_am -seq_shards 8 -device cpu`` for one epoch, and its
  checkpoint read back by ``dump_posteriors``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_kaldi_asr_tpu.models import am as jax_am
from pytorch_kaldi_asr_tpu.models.transformer import (
    TransformerConfig as JaxConfig,
)
from pytorch_kaldi_asr_tpu.models.transformer import init_transformer
from pytorch_kaldi_asr_tpu.parallel import sequence as jax_sp
from pytorch_kaldi_asr_tpu_torch.train.checkpoint import params_from_jax
from tests.torch_parallel_helpers import run_world

torch.set_num_threads(1)

N = 8
BANDS = [(-8, 0), (-8, 2), (-5, 5)]
CE_LENGTHS = {"unequal": (60, 41), "padded_last_shard": (50, 41)}


def _small(**kw):
    base = dict(src_dim=13, vocab_size=11, encoder_max_len=64,
                decoder_max_len=16, decoder_sub_sequence=(-3, 0),
                en_layers=2, de_layers=2, n_head=2, en_d_model=32,
                de_d_model=16, d_k=8, d_v=8, en_dropout=0.0, de_dropout=0.0,
                tdnn_contexts=((-1, 0, 1), (-3, 0, 3)))
    base.update(kw)
    return base


def _enc(kw, seed):
    params = jax.jit(init_transformer, static_argnums=1)(
        jax.random.PRNGKey(seed), JaxConfig(**kw))["encoder"]
    return params, params_from_jax(jax.device_get(params))


def _batch(kw, seed, pad_row=True):
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(2, 64, kw["src_dim"])).astype(np.float32)
    mask = np.ones((2, 64), np.uint8)
    if pad_row:
        mask[1, 54:] = 0  # a padded tail crossing the last shard
    return src, mask


AM_KW = dict(src_dim=8, vocab_size=11, en_layers=2, n_head=2, en_d_model=32,
             d_k=16, d_v=16, encoder_max_len=64, encoder_sub_sequence=(-6, 2),
             en_dropout=0.0, encoder_type="banded")


def _am_case(lengths):
    params = jax.jit(jax_am.init_am, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), JaxConfig(**AM_KW), 11)
    rng = np.random.default_rng(1)
    src = rng.normal(size=(2, 64, 8)).astype(np.float32)
    mask = (np.arange(64)[None, :] < np.array(lengths)[:, None]).astype(
        np.uint8)
    tgt = rng.integers(0, 11, size=(2, 64)).astype(np.int32)
    return params, src, mask, tgt


@pytest.fixture(scope="module")
def cases():
    """The JAX side of every case: weights, inputs, and the port's
    inputs."""
    jx, inputs = {}, {}
    for band in BANDS:
        kw = _small(encoder_type="banded", encoder_sub_sequence=band)
        jparams, params = _enc(kw, 0)
        src, mask = _batch(kw, 0)
        jx[f"banded{band}"] = (kw, jparams, src, mask)
        inputs[f"banded{band}"] = dict(kind="fwd", cfg=kw, params=params,
                                       src=src, mask=mask)
    kw = _small(encoder_type="conformer", encoder_sub_sequence=(-8, 0),
                conformer_kernel=7)
    jparams, params = _enc(kw, 3)
    src, mask = _batch(kw, 3)
    jx["conformer"] = (kw, jparams, src, mask)
    inputs["conformer"] = dict(kind="fwd", cfg=kw, params=params, src=src,
                               mask=mask)
    kw = _small(encoder_type="conformer", encoder_sub_sequence=(-8, 0),
                conformer_kernel=7, compute_dtype="bfloat16",
                conformer_stream_dtype="bfloat16")
    jkw = dict(kw, compute_dtype=jnp.bfloat16,
               conformer_stream_dtype=jnp.bfloat16)
    jparams, params = _enc(jkw, 5)
    src, mask = _batch(kw, 5, pad_row=False)
    jx["conformer_bf16"] = (jkw, jparams, src, mask)
    inputs["conformer_bf16"] = dict(kind="fwd", cfg=kw, params=params,
                                    src=src, mask=mask)
    kw = _small(encoder_type="banded", encoder_sub_sequence=(-8, 0))
    jparams, params = _enc(kw, 0)
    src, mask = _batch(kw, 0, pad_row=False)
    jx["grad"] = (kw, jparams, src, mask)
    inputs["grad"] = dict(kind="grad", cfg=kw, params=params, src=src,
                          mask=mask)
    inputs["errors"] = dict(kind="errors", cfg=kw, params=params, src=src,
                            mask=mask)
    for name, lengths in CE_LENGTHS.items():
        jparams, src, mask, tgt = _am_case(lengths)
        jx[f"ce_{name}"] = (jparams, src, mask, tgt)
        inputs[f"ce_{name}"] = dict(
            kind="ce", cfg=AM_KW, params=params_from_jax(
                jax.device_get(jparams)), src=src, mask=mask, tgt=tgt,
            utt_valid=np.ones(2, np.uint8))
    for enc in ("banded", "conformer"):
        kw = _small(encoder_type=enc, encoder_sub_sequence=(-8, 0),
                    en_dropout=0.3, conformer_kernel=7)
        jparams, params = _enc(kw, 2)
        src, mask = _batch(kw, 2, pad_row=False)
        inputs[f"dropout_{enc}"] = dict(kind="dropout", cfg=kw,
                                        params=params, src=src, mask=mask)
    return jx, inputs


@pytest.fixture(scope="module")
def world(cases, tmp_path_factory):
    return run_world("sp", N, tmp_path_factory.mktemp("sp_world"), cases[1])


def _whole(world, name, key=None):
    parts = [o[name] if key is None else o[name][key] for o in world]
    return torch.cat(parts, dim=1).numpy()


def test_halo_exchange_contents(world):
    got = np.stack([o["halo"].reshape(3).numpy() for o in world])
    for i in range(N):
        if i == 0:
            assert (got[0, :2] == 0).all()  # boundary: zero left halo
        else:  # the last 2 frames of shard i-1
            assert got[i, 0] == 4 * i - 2 and got[i, 1] == 4 * i - 1
        if i == N - 1:
            assert got[i, 2] == 0  # boundary: zero right halo
        else:
            assert got[i, 2] == 4 * (i + 1)  # the first frame of shard i+1


@pytest.mark.parametrize("band", BANDS)
def test_sp_banded_matches_jax(cases, world, band):
    kw, jparams, src, mask = cases[0][f"banded{band}"]
    want = jax_sp.sp_banded_encode(jparams, JaxConfig(**kw), jnp.asarray(src),
                                   jnp.asarray(mask), jax_sp.make_seq_mesh(N))
    np.testing.assert_allclose(_whole(world, f"banded{band}"),
                               np.asarray(want), atol=2e-5, rtol=2e-5)


def test_sp_conformer_matches_jax(cases, world):
    kw, jparams, src, mask = cases[0]["conformer"]
    want = jax_sp.sp_conformer_encode(
        jparams, JaxConfig(**kw), jnp.asarray(src), jnp.asarray(mask),
        jax_sp.make_seq_mesh(N))
    m = mask.astype(bool)
    np.testing.assert_allclose(_whole(world, "conformer")[m],
                               np.asarray(want)[m], atol=3e-5, rtol=3e-5)


def test_sp_conformer_bf16_stream_matches_jax(cases, world):
    """The bfloat16 stream and compute (the conformer recipe as it ships):
    the SP forward keeps the dtype contract, within JAX's bar (0.05 of the
    output's range, tests/test_sequence_parallel.py)."""
    kw, jparams, src, mask = cases[0]["conformer_bf16"]
    want = jax_sp.sp_conformer_encode(
        jparams, JaxConfig(**kw), jnp.asarray(src), jnp.asarray(mask),
        jax_sp.make_seq_mesh(N))
    got = torch.cat([o["conformer_bf16"] for o in world], dim=1)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    err = np.abs(got.float().numpy() - want).max()
    assert err < 0.05 * np.abs(want).max(), err


def test_sp_gradients_match_jax(cases, world):
    kw, jparams, src, mask = cases[0]["grad"]
    mesh = jax_sp.make_seq_mesh(N)
    cfg = JaxConfig(**kw)
    want = jax.grad(lambda p: jnp.sum(jax_sp.sp_banded_encode(
        p, cfg, jnp.asarray(src), jnp.asarray(mask), mesh) ** 2))(jparams)
    want = [np.asarray(w) for w in jax.tree_util.tree_leaves(want)]
    for r in range(N):  # every rank holds the summed gradients
        got = list(world[r]["grad"].values())
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()


@pytest.mark.parametrize("name", list(CE_LENGTHS))
def test_sp_frame_ce_loss_matches_jax(cases, world, name):
    jparams, src, mask, tgt = cases[0][f"ce_{name}"]
    cfg = JaxConfig(**AM_KW)
    utt = jnp.asarray([1, 1], jnp.uint8)
    want = jax_sp.sp_frame_ce_loss(jparams, cfg, jnp.asarray(src),
                                   jnp.asarray(mask), jnp.asarray(tgt),
                                   jax_sp.make_seq_mesh(N), utt_valid=utt)

    def loss(p):
        l, _, n = jax_am.frame_ce_loss(p, cfg, src, mask, tgt, utt_valid=utt)
        return l / n

    grads = [np.asarray(g) for g in jax.tree_util.tree_leaves(
        jax.grad(loss)(jparams))]
    for r in range(N):
        got = world[r][f"ce_{name}"]
        for sums in (got["sums"], got["eval"]):
            assert np.isfinite(sums).all()
            np.testing.assert_allclose(sums[0], float(want[0]), rtol=2e-5)
            assert sums[1] == int(want[1]) and sums[2] == int(want[2])
        for g, w in zip(got["grads"].values(), grads):
            assert np.isfinite(g.numpy()).all()
            assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()
    if name == "padded_last_shard":  # shard 7 holds no valid frame
        assert mask[:, 56:].sum() == 0


def test_sp_validation_errors_match_jax(cases, world):
    kw, jparams, src, mask = cases[0]["grad"]
    cfg, mesh = JaxConfig(**kw), jax_sp.make_seq_mesh(N)
    calls = {
        "band": lambda: jax_sp.sp_banded_encode(
            jparams, cfg.replace(encoder_sub_sequence=(-12, 0)), src, mask,
            mesh),
        "length": lambda: jax_sp.sp_banded_encode(
            jparams, cfg, src[:, :-4], mask[:, :-4], mesh),
        "encoder": lambda: jax_sp.sp_encode(
            jparams, cfg.replace(encoder_type="tdnnf"), src, mask, mesh),
        "fold": lambda: jax_sp.sp_frame_ce_loss(
            {"encoder": jparams}, cfg.replace(src_fold=2), src, mask,
            mask.astype(np.int32), mesh),
    }
    for name, call in calls.items():
        with pytest.raises(ValueError) as err:
            call()
        for r in range(N):
            assert world[r]["errors"][name] == str(err.value), name


def test_per_shard_streams_differ(world):
    streams = {tuple(o["streams"].tolist()) for o in world}
    assert len(streams) == N


@pytest.mark.parametrize("enc", ["banded", "conformer"])
def test_sp_train_dropout_applies_and_reproduces(world, enc):
    """With the step's generator, SP training dropout perturbs the output,
    is the same for the same step seed and differs for another; without
    one, the training forward is the dropout-free one (through K2a's plain
    version, the inference forward's K1 plain version summing in another
    order: 1.2e-6 on entries near 1)."""
    parts = {k: _whole(world, f"dropout_{enc}", k)
             for k in ("infer", "a", "a2", "b", "none")}
    assert np.isfinite(parts["a"]).all()
    assert not np.array_equal(parts["a"], parts["infer"])
    np.testing.assert_array_equal(parts["a"], parts["a2"])
    assert not np.array_equal(parts["a"], parts["b"])
    np.testing.assert_allclose(parts["none"], parts["infer"], atol=1e-6,
                               rtol=1e-5)


def test_train_am_seq_shards_smoke(tmp_path):
    """``train_am -seq_shards 8 -device cpu`` (JAX's
    ``test_train_am_seq_shards_smoke``): one epoch on a tiny corpus over 8
    gloo ranks it starts itself; a finite dev accuracy, pads that divide
    over the shards, every rank's launch line from rank 0, and the
    checkpoint read back by ``dump_posteriors`` on one device."""
    import subprocess
    import sys

    from pytorch_kaldi_asr_tpu.tools.make_synthetic_data import make_dataset
    from tests.torch_parallel_helpers import REPO

    shape = dict(min_words=20, max_words=30, frames_per_word=8)
    wm = make_dataset(str(tmp_path / "train"), 4, seed=0, **shape)
    make_dataset(str(tmp_path / "dev"), 2, seed=1, word_means=wm, **shape)
    env = dict(__import__("os").environ, PYTHONPATH=str(REPO),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "pytorch_kaldi_asr_tpu_torch.recipes.train_am",
         "-read_train_dir", str(tmp_path / "train"), "-read_dev_dir",
         str(tmp_path / "dev"), "-save_model_dir", str(tmp_path / "am"),
         "-encoder_type", "conformer", "-epoch", "1", "-batch_size", "2",
         "-seq_shards", "8", "-encoder_sub_sequence", "(-16,0)",
         "-en_d_model", "32", "-device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = proc.stdout
    acc = float(out.split("dev frame-acc ")[1].split()[0])
    assert 0.0 <= acc <= 1.0
    for r in range(8):
        assert f"kernel launches on cpu#rank{r}: " in out
    assert out.count("epoch 1: train frame-acc") == 1  # rank 0 alone logs
    from pytorch_kaldi_asr_tpu_torch.recipes import dump_posteriors
    from pytorch_kaldi_asr_tpu_torch.train.checkpoint import load_checkpoint

    cfg = load_checkpoint(str(tmp_path / "am"))["cfg"]
    assert cfg.encoder_max_len % 8 == 0
    assert dump_posteriors.main([
        "-read_data_dir", str(tmp_path / "dev"), "-load_model_file",
        str(tmp_path / "am"), "-wspecifier",
        f"ark,scp:{tmp_path / 'post.ark'},{tmp_path / 'post.scp'}",
        "-device", "cpu"]) == 0
    assert len((tmp_path / "post.scp").read_text().splitlines()) == 2
