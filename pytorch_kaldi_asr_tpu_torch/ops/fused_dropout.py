"""Fused dropout: a hand-written CUDA kernel for Hopper beside its plain
PyTorch version.

Inverted dropout with the mask drawn inside the pass: element ``i`` of the
tensor (its flat row-major index) is kept, and scaled by ``scale``, iff the
32-bit word ``bits(seed, i) >= threshold``.  ``bits`` is lane ``i % 4`` of
Philox4x32-10 (the counter-based generator cuRAND and PyTorch's CUDA
dropout use) with key = the 64-bit seed and counter = ``i // 4``.  The mask
depends only on (seed, i), never on the launch shape or the device, so the
kernel, its backward and the plain version all draw the same mask, bit for
bit, and no mask is ever stored.

:func:`dropout_mask_pass` is one pass over a tensor: a CUDA tensor launches
the kernel of ``csrc/fused_dropout.cu``, a CPU tensor takes
:func:`fused_dropout_reference`; ``fused_dropout.launches`` counts kernel
launches, forward and backward apart.  :func:`masked_dropout` makes it
differentiable through one ``torch.autograd.Function`` whose backward is
the same pass on the cotangent with the same seed, so nothing but the seed
is saved.  Two thresholds use it:

- :func:`fused_dropout`, the JAX package's ``ops.fused_dropout`` (the TPU
  kernel K3): ``threshold = min(int(rate * 2**32), 2**32 - 1)``, scale
  ``float32(1 / (1 - rate))``;
- ``models.common.dropout``, the JAX package's default 8-bit draw: keep
  probability exactly q/256 with ``threshold = (256 - q) * 2**24``, scale
  256/q.

The bits are not the TPU's (``pltpu.prng_random_bits`` is TPU hardware) nor
``jax.random``'s: the packages agree in distribution, not in masks.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
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
    """Philox4x32-10 of four int64 tensors holding 32-bit words
    (``counter``) under the two 32-bit key words ``key``; returns the four
    output words.  Matches Random123's ``philox4x32_10``."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(10):
        if r:
            k0, k1 = (k0 + _PHILOX_W[0]) & _M32, (k1 + _PHILOX_W[1]) & _M32
        hi0, lo0 = _mulhilo(c0, _PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _key(seed):
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return seed & _M32, seed >> 32


def dropout_bits(seed, n, device=None):
    """The kernel's 32-bit words for flat indices ``0 .. n-1``, as int64
    [n]: lane ``i % 4`` of Philox4x32-10 at counter ``i // 4``."""
    g = torch.arange(-(-n // 4), dtype=torch.int64, device=device)
    zero = torch.zeros_like(g)
    words = philox4x32((g & _M32, g >> 32, zero, zero), _key(seed))
    return torch.stack(words, dim=1).reshape(-1)[:n]


def fused_dropout_reference(x, seed, threshold, scale):
    """Plain version of the kernel: ``x * scale`` where the element's word
    is at least ``threshold``, else 0, in x's shape and dtype."""
    keep = dropout_bits(seed, x.numel(), x.device) >= int(threshold)
    flat = x.reshape(-1)
    return torch.where(keep, flat * float(scale), 0.0).to(x.dtype) \
        .reshape(x.shape)


def dropout_mask_pass(x, seed, threshold, scale, *, direction="forward"):
    """One pass of K3 over ``x`` (any shape): a CUDA tensor launches the
    kernel, counted under ``direction`` in ``fused_dropout.launches``; a
    CPU tensor takes the plain version."""
    if x.device.type == "cpu":
        return fused_dropout_reference(x, seed, threshold, scale)
    if not x.is_cuda:
        raise ValueError(f"fused_dropout: unsupported device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError("fused_dropout kernel takes float32 tensors")
    if not 0 <= int(threshold) <= _M32:
        raise ValueError(f"threshold {threshold} is not a 32-bit word")
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()  # the kernel reads float4
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    args = (x.data_ptr(), out.data_ptr(), x.numel(), *_key(seed),
            int(threshold), float(scale),
            torch._C._cuda_getCurrentRawStream(x.device.index))
    # every dropout site of a train step launches here twice: the device
    # guard (about 10 us of host time per call on the H100's host) only
    # where the tensor is not on the current device
    if x.device.index == torch.cuda.current_device():
        err = _kernel_fn()(*args)
    else:
        with torch.cuda.device(x.device):
            err = _kernel_fn()(*args)
    if err != 0:
        raise RuntimeError(f"fused_dropout kernel launch failed: CUDA error "
                           f"{err}")
    fused_dropout.launches[direction] += 1
    return out


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """The C entry point, built at first use, with its signature:
    (x, out, n, key_lo, key_hi, threshold, scale, stream)."""
    from pytorch_kaldi_asr_tpu_torch.ops import _build

    fn = _build.load("fused_dropout").fused_dropout_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
                   ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


class _MaskedDropout(torch.autograd.Function):
    """The pass forward; the same pass on the cotangent backward (the same
    seed regenerates the same mask)."""

    @staticmethod
    def forward(ctx, x, seed, threshold, scale):
        ctx.args = (seed, threshold, scale)
        return dropout_mask_pass(x, seed, threshold, scale)

    @staticmethod
    def backward(ctx, g):
        return (dropout_mask_pass(g, *ctx.args, direction="backward"),
                None, None, None)


def masked_dropout(x, seed, threshold, scale):
    """Differentiable K3: keep where the word is at least ``threshold``,
    scale kept values by ``scale`` (rounded once to float32, as the kernel
    takes it)."""
    return _MaskedDropout.apply(x, int(seed), int(threshold),
                                float(np.float32(scale)))


def fused_dropout_threshold(rate):
    """The TPU kernel's threshold, ``min(int(rate * 2**32), 2**32 - 1)``."""
    return min(int(rate * (1 << 32)), _M32)


def fused_dropout(x, rate, seed, train):
    """The JAX package's ``fused_dropout``: keep where the word is at least
    :func:`fused_dropout_threshold`, scale by ``float32(1 / (1 - rate))``.
    ``seed`` is an int (the JAX function's rng); identity when not
    training, at rate 0, or without a seed."""
    if not train or rate == 0.0 or seed is None:
        return x
    return masked_dropout(x, seed, fused_dropout_threshold(rate),
                          1.0 / (1.0 - rate))


fused_dropout.launches = {"forward": 0, "backward": 0}
