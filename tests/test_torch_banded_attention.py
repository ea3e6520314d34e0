"""The port's banded attention (ops/banded_attention.py) against the JAX
package's: the plain PyTorch version against JAX ``banded_attention_pallas``
in interpret mode and against JAX ``banded_attention_reference``, at the
cases of tests/test_banded_attention.py, to atol 2e-5 (float32; the sums run
in another order).  The wrapper's padding path is held to the plain version
at lengths the JAX kernel rejects.  The CUDA kernel itself runs only on a
card (tests/test_torch_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_kaldi_asr_tpu.ops.banded_attention import (
    banded_attention_pallas,
    banded_attention_reference as jax_reference,
)
from pytorch_kaldi_asr_tpu_torch.ops import banded_attention as ba

torch.set_num_threads(1)

ATOL = 2e-5


def _inputs(bh=4, s=256, d=32, dv=None, seed=0, pad_tail=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(bh, s, d)).astype(np.float32)
    k = rng.normal(size=(bh, s, d)).astype(np.float32)
    v = rng.normal(size=(bh, s, dv or d)).astype(np.float32)
    valid = np.ones((bh, s), np.int32)
    if pad_tail:
        valid[:, -pad_tail:] = 0
    return q, k, v, valid


def _port(q, k, v, valid, start, end, scale):
    return ba.banded_attention_reference(
        *(torch.from_numpy(x) for x in (q, k, v, valid)), start, end,
        scale).numpy()


def _jax_kernel(q, k, v, valid, start, end, scale):
    return np.asarray(banded_attention_pallas(
        *(jnp.asarray(x) for x in (q, k, v, valid)), start=start, end=end,
        scale=scale, block_q=128, interpret=True))


@pytest.mark.parametrize("start,end", [(-100, 0), (-10, 0), (-64, 32),
                                       (-300, 0)])
def test_plain_version_matches_jax_kernel_and_reference(start, end):
    q, k, v, valid = _inputs()
    scale = 1.0 / np.sqrt(256.0)
    ours = _port(q, k, v, valid, start, end, scale)
    np.testing.assert_allclose(ours, _jax_kernel(q, k, v, valid, start, end,
                                                 scale), atol=ATOL)
    np.testing.assert_allclose(
        ours, np.asarray(jax_reference(q, k, v, valid, start, end, scale)),
        atol=ATOL)


def test_plain_version_padding_and_fully_masked_rows():
    q, k, v, valid = _inputs(bh=2, s=256, d=16, pad_tail=128)
    ours = _port(q, k, v, valid, -10, 0, 0.1)
    np.testing.assert_allclose(ours, _jax_kernel(q, k, v, valid, -10, 0, 0.1),
                               atol=ATOL)
    # queries past the valid keys by more than the window: exactly zero
    np.testing.assert_array_equal(ours[:, 140:, :], 0.0)


def test_plain_version_dv_not_equal_dk():
    q, k, v, valid = _inputs(bh=2, s=256, d=16, dv=8, seed=11, pad_tail=40)
    ours = _port(q, k, v, valid, -100, 0, 0.125)
    assert ours.shape == (2, 256, 8)
    np.testing.assert_allclose(
        ours, _jax_kernel(q, k, v, valid, -100, 0, 0.125), atol=ATOL)


@pytest.mark.parametrize("s,pad_tail", [(200, 0), (504, 0), (504, 77),
                                        (37, 30)])
def test_wrapper_pads_any_length(s, pad_tail):
    """The JAX kernel rejects S that is not a multiple of its block; the
    port's wrapper pads to its 64-frame tile with invalid keys and slices
    the padding off — on the CPU through the plain version."""
    q, k, v, valid = _inputs(bh=3, s=s, d=16, dv=12, seed=s, pad_tail=pad_tail)
    scale = 0.25
    args = [torch.from_numpy(x) for x in (q, k, v, valid)]
    before = ba.banded_attention.launches
    got = ba.banded_attention(*args, start=-100, end=0, scale=scale).numpy()
    assert ba.banded_attention.launches == before  # no kernel on the CPU
    assert got.shape == (3, s, 12)
    np.testing.assert_allclose(
        got, np.asarray(jax_reference(q, k, v, valid, -100, 0, scale)),
        atol=ATOL)
    np.testing.assert_allclose(
        got, ba.banded_attention_reference(*args, -100, 0, scale).numpy(),
        atol=ATOL)


def test_wrapper_rejects_bad_band_and_shapes():
    q, k, v, valid = (torch.from_numpy(x) for x in _inputs(bh=2, s=64, d=8))
    with pytest.raises(ValueError):
        ba.banded_attention(q, k, v, valid, start=1, end=2, scale=1.0)
    with pytest.raises(ValueError):
        ba.banded_attention(q, k[:, :32], v, valid, start=-4, end=0,
                            scale=1.0)

