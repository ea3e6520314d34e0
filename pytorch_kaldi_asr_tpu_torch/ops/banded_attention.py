"""Banded (time-restricted) attention: a hand-written CUDA kernel for Hopper
beside its plain PyTorch version.

Position t attends keys ``[t+start, t+end]`` (``start <= 0 <= end``) that
are also marked valid; scores are scaled by the caller's ``scale`` (the
model uses 1/sqrt(d_model)); a query row with no valid key in its band
outputs exact zeros.  Layout: q, k ``[BH, S, D]``, v ``[BH, S, Dv]``,
key_valid ``[BH, S]``, out ``[BH, S, Dv]``.

:func:`banded_attention` is what the model calls.  It pads S up to the
kernel's tile (padded keys invalid), then sends a CPU tensor to
:func:`banded_attention_reference` and a CUDA tensor to the kernel in
``csrc/banded_attention.cu``, and slices the padding off.  There is no
length threshold and no fall back: a CUDA tensor the kernel cannot take
raises.  ``banded_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from pytorch_kaldi_asr_tpu_torch.models.common import masked_softmax

BLOCK = 64  # query and key tile of the kernel (BLOCK_Q = BLOCK_K in the .cu)
MAX_HEAD_DIM = 128  # largest d and dv the kernel takes


def banded_attention_reference(q, k, v, key_valid, start, end, scale):
    """Plain PyTorch version: full [BH, S, S] scores + band/validity mask."""
    s = q.shape[1]
    logits = torch.einsum("bqd,bkd->bqk", q, k) * scale
    pos = torch.arange(s, device=q.device)
    rel = pos[None, :] - pos[:, None]
    band = (rel >= start) & (rel <= end)
    mask = band[None, :, :] & (key_valid[:, None, :] > 0)
    p = masked_softmax(logits, ~mask)
    return torch.einsum("bqk,bkd->bqd", p, v)


def _pad_seq(x, s_pad):
    return F.pad(x, (0, 0, 0, s_pad - x.shape[1])) if s_pad > x.shape[1] else x


def banded_attention(q, k, v, key_valid, *, start, end, scale):
    """Banded attention; CUDA tensors run the Hopper kernel, CPU tensors the
    plain version.  Any S: the sequence is padded to a multiple of
    ``BLOCK`` with invalid keys, and the padded rows are dropped."""
    if not start <= 0 <= end:
        raise ValueError("band must satisfy start <= 0 <= end")
    bh, s, d = q.shape
    if k.shape != (bh, s, d) or v.shape[:2] != (bh, s) \
            or key_valid.shape != (bh, s):
        raise ValueError("q/k [BH,S,D], v [BH,S,Dv] and key_valid [BH,S] "
                         "must agree")
    s_pad = -(-s // BLOCK) * BLOCK
    q, k, v = (_pad_seq(x, s_pad) for x in (q, k, v))
    key_valid = F.pad(key_valid.to(torch.int32), (0, s_pad - s))
    if q.is_cuda:
        out = _launch(q, k, v, key_valid, start, end, scale)
    elif q.device.type == "cpu":
        out = banded_attention_reference(q, k, v, key_valid, start, end,
                                         scale)
    else:
        raise ValueError(f"banded_attention: unsupported device {q.device}")
    return out[:, :s]


banded_attention.launches = 0


def _launch(q, k, v, key_valid, start, end, scale):
    """Run the CUDA kernel on PyTorch's current stream; S % BLOCK == 0."""
    bh, s, d = q.shape
    dv = v.shape[-1]
    tensors = (q, k, v, key_valid)
    if any(t.device != q.device for t in tensors):
        raise ValueError("banded_attention: inputs on different devices")
    if q.dtype != torch.float32 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("banded_attention kernel takes float32 q/k/v")
    if d % 4 or dv % 4 or d > MAX_HEAD_DIM or dv > MAX_HEAD_DIM:
        raise ValueError(f"banded_attention kernel needs d, dv multiples of 4 "
                         f"and <= {MAX_HEAD_DIM}, got {d}, {dv}")
    # contiguous and 16-byte aligned: the kernel reads rows as float4
    q, k, v, key_valid = (t.contiguous() for t in tensors)
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    out = torch.empty((bh, s, dv), dtype=q.dtype, device=q.device)
    kernel = _kernel_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = kernel(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), key_valid.data_ptr(),
            out.data_ptr(), bh, s, d, dv, int(start), int(end), float(scale),
            stream)
    if err != 0:
        raise RuntimeError(f"banded_attention kernel launch failed: CUDA "
                           f"error {err}")
    banded_attention.launches += 1
    return out


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """The C entry point, built at first use, with its signature declared:
    (q, k, v, key_valid, out, bh, s, d, dv, start, end, scale, stream)."""
    from pytorch_kaldi_asr_tpu_torch.ops import _build

    fn = _build.load("banded_attention").banded_attention_f32
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn
