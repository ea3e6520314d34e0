"""Fused dropout (ops/fused_dropout.py, the port of the TPU kernel K3) on the
CPU: its plain version against the JAX package's ``fused_dropout`` and
against the properties of its own generator.

The JAX function draws its mask from TPU hardware bits on a TPU and from
``jax.random.bernoulli`` elsewhere; the port from Philox4x32-10.  So the
two are compared in distribution (keep rate within 3 sigma, kept values
``x / (1 - rate)`` within rtol 1e-6, the identity cases, the gradient's
mask equal to the forward's), and the port's bits are pinned by
Random123's known-answer vectors and by statistical tests: keep rates for
both thresholds, exact scaling, seeds, no correlation between neighbours
or seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_kaldi_asr_tpu.ops.fused_dropout import (
    fused_dropout as jax_fused_dropout,
)
from pytorch_kaldi_asr_tpu_torch.models.common import dropout
from pytorch_kaldi_asr_tpu_torch.ops import fused_dropout as fd

torch.set_num_threads(1)

SHAPE = (400, 512)


def _x(seed=0, shape=SHAPE):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _three_sigma(p, n):
    return 3 * np.sqrt(p * (1 - p) / n)


# ---------------------------------------------------------------------------
# against the JAX package's fused_dropout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rate", [0.1, 0.35])
def test_keep_rate_and_scale_match_jax_fused_dropout(rate):
    x = _x(1)
    want = np.asarray(jax_fused_dropout(jnp.asarray(x), rate,
                                        jax.random.PRNGKey(0), True))
    got = fd.fused_dropout(torch.from_numpy(x), rate, 7, True).numpy()
    for out in (want, got):
        kept = out != 0
        assert abs(kept.mean() - (1 - rate)) <= _three_sigma(1 - rate,
                                                              x.size)
        np.testing.assert_allclose(out[kept], x[kept] / (1 - rate),
                                   rtol=1e-6)


def test_identity_cases_match_jax_fused_dropout():
    x = _x(2, (8, 16))
    jx, px = jnp.asarray(x), torch.from_numpy(x)
    key = jax.random.PRNGKey(0)
    for rate, rng, seed, train in [(0.35, key, 3, False), (0.0, key, 3, True),
                                   (0.35, None, None, True)]:
        assert jax_fused_dropout(jx, rate, rng, train) is jx
        assert fd.fused_dropout(px, rate, seed, train) is px


def test_gradient_mask_equals_the_forward_mask_as_in_jax():
    x = _x(3, (64, 96))
    w = _x(4, (64, 96))
    rate = 0.35

    def jax_loss(v):
        return (jax_fused_dropout(v, rate, jax.random.PRNGKey(1), True)
                * w).sum()

    jout = np.asarray(jax_fused_dropout(jnp.asarray(x), rate,
                                        jax.random.PRNGKey(1), True))
    jgrad = np.asarray(jax.grad(jax_loss)(jnp.asarray(x)))
    px = torch.from_numpy(x).requires_grad_()
    out = fd.fused_dropout(px, rate, 11, True)
    (out * torch.from_numpy(w)).sum().backward()
    for fwd, grad in ((jout, jgrad), (out.detach().numpy(), px.grad.numpy())):
        kept = fwd != 0
        np.testing.assert_array_equal(grad != 0, kept)
        np.testing.assert_allclose(grad[kept], w[kept] / (1 - rate),
                                   rtol=1e-6)


# ---------------------------------------------------------------------------
# the generator
# ---------------------------------------------------------------------------


# Random123's known-answer vectors for philox4x32_10
KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("counter,key,want", KAT)
def test_philox_matches_the_known_answers(counter, key, want):
    got = fd.philox4x32(tuple(torch.tensor([c]) for c in counter), key)
    assert tuple(int(w) for w in got) == want


def test_bits_are_lanes_of_philox_at_counter_index_over_4():
    seed = (5 << 32) | 123
    bits = fd.dropout_bits(seed, 10)
    for i in (0, 3, 4, 9):
        g = torch.tensor([i // 4])
        words = fd.philox4x32((g, g * 0, g * 0, g * 0), (123, 5))
        assert int(bits[i]) == int(words[i % 4])
    assert bits.min() >= 0 and bits.max() < 2**32


def _thresholds(rate):
    """(threshold, scale, keep probability) of both users of the kernel."""
    q = round((1 - rate) * 256)
    return [((256 - q) << 24, 256.0 / q, q / 256),
            (fd.fused_dropout_threshold(rate), 1 / (1 - rate), 1 - rate)]


@pytest.mark.parametrize("which", ["8-bit", "exact"])
@pytest.mark.parametrize("rate", [0.1, 0.35])
def test_keep_rate_and_exact_scale(rate, which):
    threshold, scale, p = _thresholds(rate)[which == "exact"]
    x = torch.from_numpy(_x(5))
    y = fd.fused_dropout_reference(x, 17, threshold, np.float32(scale))
    kept = y != 0
    assert abs(kept.float().mean().item() - p) <= _three_sigma(p, x.numel())
    assert torch.equal(y[kept], x[kept] * np.float32(scale))


def test_same_seed_same_mask_other_seed_other_mask():
    a, b, c = (fd.dropout_bits(s, 4096) >= 2**31 for s in (3, 3, 4))
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


def _corr(a, b):
    return float(np.corrcoef(a.ravel().astype(np.float64),
                             b.ravel().astype(np.float64))[0, 1])


def test_no_correlation_between_neighbours_or_seeds():
    """Adjacent rows and columns of one mask, and the masks of seeds that
    differ by small or structured steps (also shifted against each other),
    are uncorrelated within 4 sigma."""
    rows, cols = 256, 384
    mask = (fd.dropout_bits(9, rows * cols) >= 2**31).numpy().reshape(rows,
                                                                       cols)
    bound = 4 / np.sqrt(rows * cols)
    assert abs(_corr(mask[:, 1:], mask[:, :-1])) < bound
    assert abs(_corr(mask[1:], mask[:-1])) < bound
    for delta in (1, 2, cols, 2**20):
        other = (fd.dropout_bits(9 + delta, rows * cols) >= 2**31).numpy()
        flat = mask.ravel()
        for shift in (0, 1, cols):
            n = flat.size - shift
            assert abs(_corr(flat[shift:], other[:n])) < 4 / np.sqrt(n)


def test_mask_follows_the_flat_index_whatever_the_shape():
    x = torch.from_numpy(_x(6, (24, 40)))
    flat = fd.fused_dropout_reference(x.reshape(-1), 21, 2**31, 2.0)
    for shaped in (x, x.reshape(6, 4, 40), x.reshape(960, 1)):
        got = fd.fused_dropout_reference(shaped, 21, 2**31, 2.0)
        assert got.shape == shaped.shape
        assert torch.equal(got.reshape(-1), flat)
    # a non-contiguous input is masked in its logical row-major order
    xt = x.t()
    assert torch.equal(fd.fused_dropout_reference(xt, 21, 2**31, 2.0),
                       fd.fused_dropout_reference(xt.contiguous(), 21,
                                                  2**31, 2.0))


def test_cpu_takes_the_plain_version_and_counts_no_launch():
    x = torch.from_numpy(_x(7, (33, 7)))  # 231 elements: not a multiple of 4
    before = dict(fd.fused_dropout.launches)
    got = fd.dropout_mask_pass(x, 5, 2**30, 1.5, direction="backward")
    assert torch.equal(got, fd.fused_dropout_reference(x, 5, 2**30, 1.5))
    assert fd.fused_dropout.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        fd.dropout_mask_pass(torch.empty(4, device="meta"), 5, 2**30, 1.5)


def test_model_dropout_uses_the_kernel_with_the_8bit_threshold():
    """models.common.dropout is the 8-bit draw through K3: its output equals
    the kernel's plain version at threshold (256 - q) * 2**24, scale 256/q,
    and its gradient is the same masked scaling."""
    rate = 0.35
    q = round((1 - rate) * 256)
    x = torch.from_numpy(_x(8, (50, 30))).requires_grad_()
    y = dropout(x, rate, 12, train=True)
    want = fd.fused_dropout_reference(x.detach(), 12, (256 - q) << 24,
                                      np.float32(256 / q))
    assert torch.equal(y.detach(), want)
    y.sum().backward()
    assert torch.equal(x.grad, fd.fused_dropout_reference(
        torch.ones_like(x), 12, (256 - q) << 24, np.float32(256 / q)))
