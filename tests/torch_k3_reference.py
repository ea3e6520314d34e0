"""The plain K3's Philox words as ops/fused_dropout.py first computed them,
kept as the tests' reference: each 32 x 32-bit product built from 16-bit
halves in int64, every product below 2**49, so no int64 product wraps.
tests/test_torch_fused_dropout.py pins the port's faster plain version
(one wrapped int64 multiply per product, the CPU's counters in
cache-sized passes, the forward's mask kept for the backward) against
these words bit for bit."""

import torch

_M32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)  # round multipliers
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)  # key increments (Weyl sequence)


def _mulhilo(a, m):
    """(hi, lo) 32-bit words of ``a * m`` for int64 ``a`` in [0, 2**32) and
    a constant ``m`` < 2**32, from 16-bit halves of ``m`` so every product
    stays below 2**49 (a plain int64 product would overflow)."""
    p_lo = a * (m & 0xFFFF)
    mid = a * (m >> 16) + (p_lo >> 16)
    return mid >> 16, ((mid & 0xFFFF) << 16) | (p_lo & 0xFFFF)


def philox4x32(counter, key):
    """Philox4x32-10 of four int64 tensors holding 32-bit words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(10):
        if r:
            k0, k1 = (k0 + _PHILOX_W[0]) & _M32, (k1 + _PHILOX_W[1]) & _M32
        hi0, lo0 = _mulhilo(c0, _PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def dropout_bits(seed, n, device=None):
    """The kernel's 32-bit words for flat indices ``0 .. n-1``, as int64
    [n]: lane ``i % 4`` of Philox4x32-10 at counter ``i // 4``."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    g = torch.arange(-(-n // 4), dtype=torch.int64, device=device)
    zero = torch.zeros_like(g)
    words = philox4x32((g & _M32, g >> 32, zero, zero),
                       (seed & _M32, seed >> 32))
    return torch.stack(words, dim=1).reshape(-1)[:n]


def fused_dropout_reference(x, seed, threshold, scale):
    """``x * scale`` in float32 where the element's word is at least
    ``threshold``, else 0, rounded once to x's dtype, in x's shape."""
    keep = dropout_bits(seed, x.numel(), x.device) >= int(threshold)
    flat = x.reshape(-1)
    if flat.dtype == torch.bfloat16:
        flat = flat.float()
    return torch.where(keep, flat * float(scale), 0.0).to(x.dtype) \
        .reshape(x.shape)
