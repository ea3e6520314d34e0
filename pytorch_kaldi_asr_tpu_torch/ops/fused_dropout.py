"""Fused dropout: a hand-written CUDA kernel for Hopper beside its plain
PyTorch version.

Inverted dropout with the mask drawn inside the pass: element ``i`` of the
tensor (its flat row-major index) is kept, and scaled by ``scale``, iff the
32-bit word ``bits(seed, i) >= threshold``.  float32 and bfloat16 tensors
each have a kernel; a kept bfloat16 value is ``float(x) * scale`` rounded
once to bfloat16.  ``bits`` is lane ``i % 4`` of
Philox4x32-10 (the counter-based generator cuRAND and PyTorch's CUDA
dropout use) with key = the 64-bit seed and counter = ``i // 4``.  The mask
depends only on (seed, i), never on the launch shape or the device, so the
kernel, its backward and the plain version all draw the same mask, bit for
bit, and no mask is ever stored.  The mask does not depend on the dtype
either: a bfloat16 tensor draws the float32 kernel's bits.

:func:`dropout_mask_pass` is one pass over a tensor: a CUDA tensor launches
the kernel of ``csrc/fused_dropout.cu`` for its dtype, a CPU tensor takes
:func:`fused_dropout_reference`; ``fused_dropout.launches`` counts kernel
launches, forward and backward apart, under ``forward``/``backward`` for
float32 and ``forward_bf16``/``backward_bf16`` for bfloat16.  :func:`masked_dropout` makes it
differentiable through one ``torch.autograd.Function`` whose backward is
the same pass on the cotangent with the same seed, so nothing but the seed
is saved (on the CPU the plain version keeps its mask instead).  Two
thresholds use it:

- :func:`fused_dropout`, the JAX package's ``ops.fused_dropout`` (the TPU
  kernel K3): ``threshold = min(int(rate * 2**32), 2**32 - 1)``, scale
  ``float32(1 / (1 - rate))``;
- ``models.common.dropout``, the JAX package's default 8-bit draw: keep
  probability exactly q/256 with ``threshold = (256 - q) * 2**24``, scale
  256/q (on bfloat16, 256/q rounded to bfloat16, as the JAX package's weak
  Python float is).

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


# counters per CPU pass of ``dropout_bits``: few enough that a pass's
# words stay near the cores through its ten rounds, enough that each of its
# elementwise ops is worth spreading over the intra-op threads
_CPU_CHUNK = 1 << 18


def philox4x32(counter, key):
    """Philox4x32-10 of four int64 tensors holding 32-bit words
    (``counter``) under the two 32-bit key words ``key``; returns the four
    output words.  Matches Random123's ``philox4x32_10``.  Each 32 x 32-bit
    product is one int64 multiply, which wraps past 2**63: its low 64 bits
    are the product's, so a mask reads both 32-bit halves (the high half's
    sign extension masked off)."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(10):
        if r:
            k0, k1 = (k0 + _PHILOX_W[0]) & _M32, (k1 + _PHILOX_W[1]) & _M32
        p0 = c0 * _PHILOX_M[0]
        p1 = c2 * _PHILOX_M[1]
        c0 = (p1 >> 32).bitwise_and_(_M32).bitwise_xor_(c1).bitwise_xor_(k0)
        c2 = (p0 >> 32).bitwise_and_(_M32).bitwise_xor_(c3).bitwise_xor_(k1)
        c1, c3 = p1.bitwise_and_(_M32), p0.bitwise_and_(_M32)
    return c0, c1, c2, c3


def _key(seed):
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return seed & _M32, seed >> 32


def dropout_bits(seed, n, device=None):
    """The kernel's 32-bit words for flat indices ``0 .. n-1``, as int64
    [n]: lane ``i % 4`` of Philox4x32-10 at counter ``i // 4``.  On the CPU
    the counters go through in passes of ``_CPU_CHUNK``."""
    m = -(-n // 4)
    device = torch.device(device or "cpu")
    chunk = _CPU_CHUNK if device.type == "cpu" else max(m, 1)
    key = _key(seed)
    out = torch.empty((m, 4), dtype=torch.int64, device=device)
    for lo in range(0, m, chunk):
        g = torch.arange(lo, min(lo + chunk, m), dtype=torch.int64,
                         device=device)
        zero = torch.zeros_like(g)
        out[lo:lo + chunk] = torch.stack(
            philox4x32((g & _M32, g >> 32, zero, zero), key), dim=1)
    return out.reshape(-1)[:n]


def _apply_keep(x, keep, scale):
    """``x * scale`` in float32 where ``keep`` (flat, bool) is set, else 0,
    rounded once to x's dtype, in x's shape."""
    flat = x.reshape(-1)
    if flat.dtype == torch.bfloat16:
        flat = flat.float()
    return torch.where(keep, flat * float(scale), 0.0).to(x.dtype) \
        .reshape(x.shape)


def fused_dropout_reference(x, seed, threshold, scale):
    """Plain version of the kernels: ``x * scale`` in float32 where the
    element's word is at least ``threshold``, else 0, rounded once to x's
    dtype, in x's shape."""
    return _apply_keep(
        x, dropout_bits(seed, x.numel(), x.device) >= int(threshold), scale)


def dropout_mask_pass(x, seed, threshold, scale, *, direction="forward"):
    """One pass of K3 over ``x`` (any shape): a CUDA tensor launches the
    kernel, counted under ``direction`` in ``fused_dropout.launches``; a
    CPU tensor takes the plain version."""
    if x.device.type == "cpu":
        return fused_dropout_reference(x, seed, threshold, scale)
    if not x.is_cuda:
        raise ValueError(f"fused_dropout: unsupported device {x.device}")
    if x.dtype not in _ENTRY:
        raise TypeError(f"fused_dropout has no kernel for {x.dtype}")
    if not 0 <= int(threshold) <= _M32:
        raise ValueError(f"threshold {threshold} is not a 32-bit word")
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()  # the kernels read 16 bytes at a time
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    args = (x.data_ptr(), out.data_ptr(), x.numel(), *_key(seed),
            int(threshold), float(scale),
            torch._C._cuda_getCurrentRawStream(x.device.index))
    # every dropout site of a train step launches here twice: the device
    # guard (about 10 us of host time per call on the H100's host) only
    # where the tensor is not on the current device
    entry, suffix = _ENTRY[x.dtype]
    if x.device.index == torch.cuda.current_device():
        err = _kernel_fn(entry)(*args)
    else:
        with torch.cuda.device(x.device):
            err = _kernel_fn(entry)(*args)
    if err != 0:
        raise RuntimeError(f"fused_dropout kernel launch failed: CUDA error "
                           f"{err}")
    fused_dropout.launches[direction + suffix] += 1
    return out


# dtype → (C entry point, suffix of its launch counts)
_ENTRY = {torch.float32: ("fused_dropout_f32", ""),
          torch.bfloat16: ("fused_dropout_bf16", "_bf16")}


def kernel_entry(library, entry):
    """The C entry point ``entry`` (``fused_dropout_f32`` or
    ``fused_dropout_bf16``) of a ``ctypes.CDLL`` built from
    csrc/fused_dropout.cu, signature set: (x, out, n, key_lo, key_hi,
    threshold, scale, stream)."""
    fn = getattr(library, entry)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
                   ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _kernel_fn(entry="fused_dropout_f32"):
    """The C entry point ``entry``, built at first use."""
    from pytorch_kaldi_asr_tpu_torch.ops import _build

    return kernel_entry(_build.load("fused_dropout"), entry)


class _MaskedDropout(torch.autograd.Function):
    """The pass forward; the same pass on the cotangent backward (the same
    seed regenerates the same mask).  On the CPU the plain version draws
    the mask once and keeps it for the backward, which then only applies
    it: the same mask, bit for bit, at half the draws."""

    @staticmethod
    def forward(ctx, x, seed, threshold, scale):
        ctx.args = (seed, threshold, scale)
        ctx.keep = None
        if x.device.type != "cpu":
            return dropout_mask_pass(x, seed, threshold, scale)
        ctx.keep = dropout_bits(seed, x.numel()) >= int(threshold)
        return _apply_keep(x, ctx.keep, scale)

    @staticmethod
    def backward(ctx, g):
        if ctx.keep is not None and g.device.type == "cpu":
            return _apply_keep(g, ctx.keep, ctx.args[2]), None, None, None
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


fused_dropout.launches = {"forward": 0, "backward": 0, "forward_bf16": 0,
                          "backward_bf16": 0}
