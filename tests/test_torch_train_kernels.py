"""The trainable banded attention of the port (ops/banded_attention.py)
against the JAX package's, on the CPU.

- ``dropout_keep`` equals JAX ``_dropout_keep`` bit for bit over seeds up to
  2**31 - 2, batch-heads up to 199, positions up to 4095 and three rates.
- ``banded_attention_trainable`` (the autograd function whose kernel calls
  take their plain versions on the CPU) and autograd of
  ``banded_attention_trainable_reference`` both match JAX
  ``banded_attention_trainable`` in interpret mode under ``jax.vjp``:
  out within 2e-5, dq/dk/dv within 1e-4, at dropout 0 and 0.35, three
  bands, dv != d, padded tails and an empty row; and at the shapes that
  reach each tile skip of the CUDA backward (band edges on a tile
  boundary, the conformer's band over several tiles, whole invalid key
  tiles and dead query tiles, d 64 with dv 32, d 12).
- The plain versions of K2b and K2c equal autograd of the plain forward,
  and K2b's returns delta = rowsum(dout * out) beside dq.
The CUDA kernels run only on a card (tests/test_torch_cuda.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_kaldi_asr_tpu.ops.banded_attention import (
    _dropout_keep,
    banded_attention_trainable as jax_trainable,
)
from pytorch_kaldi_asr_tpu_torch.ops import banded_attention as ba

torch.set_num_threads(1)

OUT_ATOL = 2e-5
GRAD_ATOL = 1e-4


@pytest.mark.parametrize("rate", [0.1, 0.35, 0.5])
def test_dropout_keep_is_jax_bit_for_bit(rate):
    q_pos = np.arange(0, 4096, 7, dtype=np.int32)[:, None]
    k_pos = np.concatenate([np.arange(0, 4096, 11), [4095]]).astype(
        np.int32)[None, :]
    for seed in (0, 1, 77, 123456789, 2**31 - 2):
        for bh in (0, 1, 100, 199):
            want = np.asarray(_dropout_keep(jnp.int32(seed), bh,
                                            jnp.asarray(q_pos),
                                            jnp.asarray(k_pos), rate))
            got = ba.dropout_keep(seed, bh, torch.from_numpy(q_pos),
                                  torch.from_numpy(k_pos), rate).numpy()
            np.testing.assert_array_equal(got, want)
    # the keep share is about 1 - rate
    assert abs(got.mean() - (1.0 - rate)) < 0.01


def test_mul32_wraps_like_uint32():
    """The products that overflow int64 as one multiply come out mod 2**32."""
    x = torch.tensor([0, 1, 2**31, 2**32 - 1, 0xDEADBEEF], dtype=torch.int64)
    for c in (2654435761, 2246822519, 3266489917, 0x7FEB352D, 0x846CA68B):
        want = [(int(v) * c) % 2**32 for v in x]
        assert ba._mul32(x, c).tolist() == want


def _inputs(bh, s, d, dv, lengths, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(bh, s, d)).astype(np.float32)
    k = rng.normal(size=(bh, s, d)).astype(np.float32)
    v = rng.normal(size=(bh, s, dv)).astype(np.float32)
    dout = rng.normal(size=(bh, s, dv)).astype(np.float32)
    valid = (np.arange(s)[None, :] < np.asarray(lengths)[:, None]).astype(
        np.int32)
    return q, k, v, valid, dout


def _jax_vjp(q, k, v, valid, dout, seed, start, end, scale, rate):
    out, vjp = jax.vjp(
        lambda q, k, v: jax_trainable(q, k, v, jnp.asarray(valid),
                                      jnp.int32(seed), start, end, scale,
                                      rate, 128, True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(x) for x in (out, *vjp(jnp.asarray(dout)))]


def _torch_vjp(fn, q, k, v, dout):
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = fn(q, k, v)
    out.backward(torch.from_numpy(dout))
    return [x.detach().numpy() for x in (out, q.grad, k.grad, v.grad)]


def _assert_close(got, want):
    for g, w, tol in zip(got, want, (OUT_ATOL,) + (GRAD_ATOL,) * 3):
        np.testing.assert_allclose(g, w, atol=tol)


@pytest.mark.parametrize("rate", [0.0, 0.35])
@pytest.mark.parametrize("start,end", [(-100, 0), (-10, 0), (-64, 32)])
def test_trainable_matches_jax_kernels(rate, start, end):
    # dv != d, a padded tail and a row with no valid key at all
    q, k, v, valid, dout = _inputs(3, 256, 16, 8, [256, 150, 0],
                                   seed=-start + end)
    seed, scale = 2024, 0.125
    want = _jax_vjp(q, k, v, valid, dout, seed, start, end, scale, rate)
    tvalid = torch.from_numpy(valid)
    before = [f.launches for f in (ba.banded_attention_fwd,
                                   ba.banded_attention_dq,
                                   ba.banded_attention_dkv)]
    got = _torch_vjp(lambda q, k, v: ba.banded_attention_trainable(
        q, k, v, tvalid, seed, start=start, end=end, scale=scale,
        dropout_rate=rate), q, k, v, dout)
    _assert_close(got, want)
    plain = _torch_vjp(lambda q, k, v: ba.banded_attention_trainable_reference(
        q, k, v, tvalid, seed, start, end, scale, rate)[0], q, k, v, dout)
    _assert_close(plain, want)
    # no kernel on the CPU; the empty row is exact zeros, gradients too
    assert [f.launches for f in (ba.banded_attention_fwd,
                                 ba.banded_attention_dq,
                                 ba.banded_attention_dkv)] == before
    for x in got:
        assert not np.any(x[2])


# (bh, s, d, dv, lengths, start, end): each reaches a skip of the CUDA
# backward's tiling (K2b, K2c) on the card; here the plain versions
TILE_EDGE_CASES = {
    "band (-64,64) on tile edges": (3, 256, 16, 16, [256, 200, 30], -64, 64),
    "band (-65,0)": (3, 256, 16, 16, [256, 130, 64], -65, 0),
    "band (-256,256) at S 640": (2, 640, 8, 8, [640, 200], -256, 256),
    "invalid key tiles, dead query tiles": (3, 512, 8, 8, [512, 130, 0],
                                            -30, 30),
    "d 64, dv 32": (2, 256, 64, 32, [256, 180], -64, 32),
    "d 12": (2, 256, 12, 12, [256, 90], -40, 8),
}


@pytest.mark.parametrize("rate", [0.0, 0.35])
@pytest.mark.parametrize("case", list(TILE_EDGE_CASES))
def test_trainable_matches_jax_at_tile_edges(case, rate):
    bh, s, d, dv, lengths, start, end = TILE_EDGE_CASES[case]
    q, k, v, valid, dout = _inputs(bh, s, d, dv, lengths, seed=s + d + dv)
    seed, scale = 31, 1.0 / np.sqrt(d)
    want = _jax_vjp(q, k, v, valid, dout, seed, start, end, scale, rate)
    tvalid = torch.from_numpy(valid)
    got = _torch_vjp(lambda q, k, v: ba.banded_attention_trainable(
        q, k, v, tvalid, seed, start=start, end=end, scale=scale,
        dropout_rate=rate), q, k, v, dout)
    _assert_close(got, want)
    # rows with no valid key in band, and invalid keys: exact zeros
    pos = np.arange(s)
    empty = pos[None, :] + start >= np.asarray(lengths)[:, None]
    assert empty.any()
    assert not got[0][empty].any() and not got[1][empty].any()
    assert not got[2][valid == 0].any() and not got[3][valid == 0].any()


@pytest.mark.parametrize("s", [200, 37])
def test_trainable_pads_any_length(s):
    """The JAX kernel needs S % 128 == 0; the port pads to its 64-frame
    tile and slices back, which leaves padded query rows with dout = 0."""
    q, k, v, valid, dout = _inputs(2, s, 8, 12, [s, s - 20], seed=s)
    tvalid = torch.from_numpy(valid)
    kw = dict(start=-30, end=4, scale=0.3, dropout_rate=0.35)
    got = _torch_vjp(lambda q, k, v: ba.banded_attention_trainable(
        q, k, v, tvalid, 5, **kw), q, k, v, dout)
    assert got[0].shape == (2, s, 12)
    want = _torch_vjp(lambda q, k, v: ba.banded_attention_trainable_reference(
        q, k, v, tvalid, 5, kw["start"], kw["end"], kw["scale"],
        kw["dropout_rate"])[0], q, k, v, dout)
    _assert_close(got, want)


def test_backward_plain_versions_equal_autograd():
    """K2b's and K2c's plain versions, given the forward's lse and
    delta = rowsum(dout * out), are the gradient of the plain forward."""
    q, k, v, valid, dout = _inputs(2, 128, 8, 8, [128, 60], seed=9)
    args = [torch.from_numpy(x) for x in (q, k, v, valid)]
    kw = dict(start=-20, end=3, scale=0.5, dropout_rate=0.35)
    band = (kw["start"], kw["end"], kw["scale"], kw["dropout_rate"])
    out, lse = ba.banded_attention_trainable_reference(*args, 11, *band)
    # rows 80+ of the second sequence see no valid key: lse = -inf
    assert torch.isinf(lse[1, 80:]).all() and torch.isfinite(lse[1, :80]).all()
    tdout = torch.from_numpy(dout)
    dq, delta = ba.banded_attention_dq(*args, tdout, out, lse, 11, **kw)
    dk, dv = ba.banded_attention_dkv(*args, tdout, lse, delta, 11, **kw)
    want = _torch_vjp(lambda q, k, v: ba.banded_attention_trainable_reference(
        q, k, v, args[3], 11, *band)[0], q, k, v, dout)
    for g, w in zip((dq, dk, dv), want[1:]):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5)


def test_plain_dq_returns_delta():
    """K2b's plain version returns (dq, delta): delta is rowsum(dout * out)
    (what K2c reads), and dq is still autograd's, at dropout 0 and 0.35."""
    q, k, v, valid, dout = _inputs(2, 192, 12, 8, [192, 70], seed=4)
    args = [torch.from_numpy(x) for x in (q, k, v, valid)]
    tdout = torch.from_numpy(dout)
    for rate in (0.0, 0.35):
        band = (-65, 0, 0.4, rate)
        out, lse = ba.banded_attention_trainable_reference(*args, 8, *band)
        dq, delta = ba.banded_attention_dq_reference(*args, tdout, out, lse,
                                                     8, *band)
        assert delta.shape == lse.shape
        assert torch.equal(delta, (tdout * out).sum(dim=-1))
        # rows of the second sequence past 135 see no key: out and delta 0
        assert not delta[1, 135:].any() and delta[1, :135].any()
        want = _torch_vjp(
            lambda q, k, v: ba.banded_attention_trainable_reference(
                q, k, v, args[3], 8, *band)[0], q, k, v, dout)
        np.testing.assert_allclose(dq.numpy(), want[1], atol=1e-5)


def test_trainable_rejects_bad_arguments():
    q, k, v, valid, _ = (torch.from_numpy(x) for x in
                         _inputs(2, 64, 8, 8, [64, 64], seed=0))
    with pytest.raises(ValueError, match="seed"):
        ba.banded_attention_trainable(q, k, v, valid, 2**31 - 1, start=-4,
                                      end=0, scale=1.0)
    with pytest.raises(ValueError, match="dropout_rate"):
        ba.banded_attention_trainable(q, k, v, valid, 0, start=-4, end=0,
                                      scale=1.0, dropout_rate=1.0)
    with pytest.raises(ValueError, match="band"):
        ba.banded_attention_trainable(q, k, v, valid, 0, start=1, end=2,
                                      scale=1.0)
