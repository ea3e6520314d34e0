"""The banded plain versions of the trainable attention kernels
(``*_blocked`` in pytorch_kaldi_asr_tpu_torch/ops/banded_attention.py),
which a CPU tensor trains through, against the full [BH, S, S] plain
versions that the kernels are held against on the card, and against the
JAX package's Pallas kernels in interpret mode.

- The forward with lse (at rate 0 also the inference function), dq with
  delta, and dk/dv at
  S 1-300 across the bands (-40, 40), (-100, 0), (-100, 50) and (0, 0),
  ragged key validity (a row with no valid key, holes), dropout 0 and
  0.35: float32 within 1e-6 of each tensor's largest entry (at least 1,
  the inputs' scale), bfloat16 at
  most one bfloat16 ulp of the row's scale (``bf16_ulps``); the rows with
  no valid key exact zeros and lse -inf in both.
- The dropout mask over the band windows is the full version's, bit for
  bit.
- The CPU's trainable path (the autograd function over K2a-c's wrappers)
  runs the banded versions and never builds [S, S] scores.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_kaldi_asr_tpu.ops.banded_attention import (
    banded_attention_pallas,
    banded_attention_trainable as jax_trainable,
)
from pytorch_kaldi_asr_tpu_torch.ops import banded_attention as ba

torch.set_num_threads(1)

F32_RTOL = 1e-6  # of each tensor's largest entry
BF16_ULPS = 1.0
BANDS = [(-40, 40), (-100, 0), (-100, 50), (0, 0)]
LENGTHS = (1, 37, 64, 130, 300)


def _inputs(s, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    bh, d, dv = 3, 16, 8
    q, k, dout = (torch.randn(bh, s, d, generator=g) for _ in range(3))
    v = torch.randn(bh, s, dv, generator=g)
    dout = torch.randn(bh, s, dv, generator=g)
    valid = (torch.arange(s)[None, :]
             < torch.tensor([s, (s + 1) // 2, 0])[:, None]).to(torch.int32)
    valid[0, 3::7] = 0  # holes in a full row
    return [x.to(dtype) for x in (q, k, v, dout)] + [valid]


def _assert_close(got, want, what):
    if want.dtype == torch.bfloat16:
        ulps = float(ba.bf16_ulps(got, want).max()) if want.numel() else 0.0
        assert ulps <= BF16_ULPS, (what, ulps)
        return
    # at least 1: the inputs are unit normals, and a gradient that cancels
    # to about 0 (dq over a single key) carries the rounding of its terms
    scale = max(float(want.abs().max()), 1.0) if want.numel() else 1.0
    err = float((got - want).abs().max()) if want.numel() else 0.0
    assert err <= F32_RTOL * scale, (what, err, scale)


@pytest.mark.parametrize("rate", [0.0, 0.35])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("start,end", BANDS)
def test_banded_plain_matches_full_plain(start, end, dtype, rate):
    scale, seed = 0.3, 77
    for s in LENGTHS:
        q, k, v, dout, valid = _inputs(s, dtype, seed=s - start + end)
        args = (q, k, v, valid)
        if rate == 0.0:  # the inference function
            _assert_close(
                ba.banded_attention_trainable_blocked(
                    *args, seed, start, end, scale)[0],
                ba.banded_attention_reference(*args, start, end, scale),
                ("inference", s))
        out, lse = ba.banded_attention_trainable_reference(
            *args, seed, start, end, scale, rate)
        got_out, got_lse = ba.banded_attention_trainable_blocked(
            *args, seed, start, end, scale, rate)
        _assert_close(got_out, out, ("out", s))
        assert torch.equal(torch.isinf(got_lse), torch.isinf(lse))
        live = torch.isfinite(lse)
        _assert_close(got_lse[live], lse[live], ("lse", s))
        # a row with no valid key: exact zeros
        assert not bool(got_out[2].float().abs().max() if s else 0.0)
        dq, delta = ba.banded_attention_dq_reference(
            *args, dout, out, lse, seed, start, end, scale, rate)
        got_dq, got_delta = ba.banded_attention_dq_blocked(
            *args, dout, out, lse, seed, start, end, scale, rate)
        _assert_close(got_dq, dq, ("dq", s))
        assert torch.equal(got_delta, delta)
        dk, dv = ba.banded_attention_dkv_reference(
            *args, dout, lse, delta, seed, start, end, scale, rate)
        got_dk, got_dv = ba.banded_attention_dkv_blocked(
            *args, dout, lse, delta, seed, start, end, scale, rate)
        _assert_close(got_dk, dk, ("dk", s))
        _assert_close(got_dv, dv, ("dv", s))


@pytest.mark.parametrize("start,end", BANDS + [(-300, 3)])
def test_band_window_dropout_mask_is_the_full_mask(start, end):
    s, seed, rate = 256, 12345, 0.35  # a multiple of the block: no padded rows
    valid = torch.ones((4, s), dtype=torch.int32)
    win = ba._Windows(valid, start, end)
    keep = win.keep(seed, rate)
    full = ba._keep_mask(seed, 4, win.s_pad, rate, "cpu")
    q_pos = win.q_pos.expand(-1, -1, win.w)
    k_pos = win.k_pos.expand(win.nb, win.bq, -1)
    inside = (k_pos >= 0) & (k_pos < win.s_pad)
    for b in range(4):
        want = full[b][q_pos[inside], k_pos[inside]]
        assert torch.equal(keep[b][inside], want)
    # every in-band pair of the full [S, S] grid lies in some window
    rel = torch.arange(s)[None, :] - torch.arange(s)[:, None]
    in_band = int(((rel >= start) & (rel <= end)).sum()) * 4
    assert int(win.allowed.sum()) == in_band


def test_cpu_training_takes_the_banded_version(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the full [S, S] plain version ran")

    for name in ("banded_attention_trainable_reference",
                 "banded_attention_dq_reference",
                 "banded_attention_dkv_reference"):
        monkeypatch.setattr(ba, name, refuse)
    q, k, v, dout, valid = _inputs(150, torch.float32, seed=3)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = ba.banded_attention_trainable(*leaves, valid, 9, start=-100, end=50,
                                        scale=0.2, dropout_rate=0.35)
    out.backward(dout)
    assert all(x.grad is not None for x in leaves)


def _jax_vjp(q, k, v, valid, dout, seed, start, end, scale, rate):
    import jax

    out, vjp = jax.vjp(
        lambda q, k, v: jax_trainable(q, k, v, jnp.asarray(valid),
                                      jnp.int32(seed), start, end, scale,
                                      rate, 128, True),
        *(jnp.asarray(x) for x in (q, k, v)))
    return [np.asarray(x) for x in (out, *vjp(jnp.asarray(dout)))]


@pytest.mark.parametrize("rate", [0.0, 0.35])
@pytest.mark.parametrize("start,end", [(-100, 0), (-64, 32)])
def test_banded_plain_matches_jax_interpret_kernels(start, end, rate):
    """The CPU's trainable path (the banded versions behind the autograd
    function) against the Pallas kernels in interpret mode: out within
    2e-5, gradients within 1e-4, as tests/test_torch_train_kernels.py holds
    the full versions."""
    q, k, v, dout, valid = (x.numpy() for x in _inputs(256, torch.float32,
                                                        seed=5))
    seed, scale = 2024, 0.125
    want = _jax_vjp(q, k, v, valid, dout, seed, start, end, scale, rate)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = ba.banded_attention_trainable(
        *leaves, torch.from_numpy(valid), seed, start=start, end=end,
        scale=scale, dropout_rate=rate)
    out.backward(torch.from_numpy(dout))
    got = [x.detach().numpy() for x in (out, *(t.grad for t in leaves))]
    for g, w, tol in zip(got, want, (2e-5, 1e-4, 1e-4, 1e-4)):
        np.testing.assert_allclose(g, w, atol=tol)
    if rate == 0.0:  # the inference kernel
        kernel = np.asarray(banded_attention_pallas(
            *(jnp.asarray(x) for x in (q, k, v, valid)), start=start,
            end=end, scale=scale, block_q=128, interpret=True))
        got = ba.banded_attention_trainable_blocked(
            *(torch.from_numpy(x) for x in (q, k, v, valid)), 0, start, end,
            scale)[0]
        np.testing.assert_allclose(got.numpy(), kernel, atol=1e-6)
