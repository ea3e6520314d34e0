"""Banded (time-restricted) attention: hand-written CUDA kernels for Hopper
beside their plain PyTorch versions.

Position t attends keys ``[t+start, t+end]`` (``start <= 0 <= end``) that
are also marked valid; scores are scaled by the caller's ``scale`` (the
model uses 1/sqrt(d_model)); a query row with no valid key in its band
outputs exact zeros.  Layout: q, k ``[BH, S, D]``, v ``[BH, S, Dv]``,
key_valid ``[BH, S]``, out ``[BH, S, Dv]``.

:func:`banded_attention` is the inference path.  It pads S up to the
kernel's tile (padded keys invalid), then sends a CPU tensor to
:func:`banded_attention_reference` and a CUDA tensor to the kernel in
``csrc/banded_attention.cu``, and slices the padding off.  There is no
length threshold and no fall back: a CUDA tensor the kernel cannot take
raises.  ``banded_attention.launches`` counts kernel launches.

:func:`banded_attention_trainable` is the training path: the same function
plus attention-probability dropout, differentiable through one
``torch.autograd.Function`` whose forward runs :func:`banded_attention_fwd`
(K2a) and whose backward runs :func:`banded_attention_dq` (K2b, which
also computes delta = rowsum(dout * out)) and :func:`banded_attention_dkv`
(K2c), the kernels of ``csrc/banded_attention_train.cu``.  Each of the
three sends a CUDA tensor to its kernel and a CPU tensor to its plain
version, and counts its kernel launches in ``.launches``.  The dropout
mask is :func:`dropout_keep`, the JAX package's hash, bit for bit, so a
run is reproducible across the two packages and the kernels regenerate the
forward's mask in the backward.
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


def _check_and_pad(q, k, v, key_valid, start, end):
    """Validate the band and shapes; pad S to a multiple of ``BLOCK`` (zero
    rows, invalid keys).  Returns the padded (q, k, v, key_valid int32)."""
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
    return q, k, v, key_valid


def banded_attention(q, k, v, key_valid, *, start, end, scale):
    """Banded attention; CUDA tensors run the Hopper kernel, CPU tensors the
    plain version.  Any S: the sequence is padded to a multiple of
    ``BLOCK`` with invalid keys, and the padded rows are dropped."""
    s = q.shape[1]
    q, k, v, key_valid = _check_and_pad(q, k, v, key_valid, start, end)
    if q.is_cuda:
        out = _launch(q, k, v, key_valid, start, end, scale)
    elif q.device.type == "cpu":
        out = banded_attention_reference(q, k, v, key_valid, start, end,
                                         scale)
    else:
        raise ValueError(f"banded_attention: unsupported device {q.device}")
    return out[:, :s]


banded_attention.launches = 0


def _kernel_operands(name, floats, ints=()):
    """Checks shared by every kernel wrapper: one device, float32 vectors
    whose head dims the kernels take, then contiguous copies, the vectors
    16-byte aligned (the kernels read rows as float4)."""
    tensors = (*floats, *ints)
    if any(t.device != tensors[0].device for t in tensors):
        raise ValueError(f"{name}: inputs on different devices")
    if any(t.dtype != torch.float32 for t in floats):
        raise TypeError(f"{name} kernel takes float32 tensors")
    dims = {t.shape[-1] for t in floats if t.dim() == 3}
    if any(x % 4 or x > MAX_HEAD_DIM for x in dims):
        raise ValueError(f"{name} kernel needs d, dv multiples of 4 and <= "
                         f"{MAX_HEAD_DIM}, got {sorted(dims)}")
    floats = [t.contiguous() for t in floats]
    floats = [t if t.data_ptr() % 16 == 0 else t.clone() for t in floats]
    return floats, [t.contiguous() for t in ints]


def _run(name, fn, device, *args):
    """Call C entry point ``fn`` on PyTorch's current stream of ``device``;
    raise if the launch was refused."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _launch(q, k, v, key_valid, start, end, scale):
    """Run the CUDA kernel on PyTorch's current stream; S % BLOCK == 0."""
    (q, k, v), (key_valid,) = _kernel_operands("banded_attention", (q, k, v),
                                               (key_valid,))
    bh, s, d = q.shape
    dv = v.shape[-1]
    out = torch.empty((bh, s, dv), dtype=q.dtype, device=q.device)
    _run("banded_attention", _kernel_fn(), q.device, q.data_ptr(),
         k.data_ptr(), v.data_ptr(), key_valid.data_ptr(), out.data_ptr(),
         bh, s, d, dv, int(start), int(end), float(scale))
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


# ---------------------------------------------------------------------------
# trainable path: K2a/K2b/K2c and their plain versions
# ---------------------------------------------------------------------------

MAX_SEED = 2**31 - 2  # seeds are int32 draws from [0, 2**31 - 1)
_M32 = 0xFFFFFFFF


def dropout_threshold(rate):
    """The hash threshold of ``rate``: a 32-bit hash at or above it keeps
    the entry.  Computed in Python double, as the JAX package does."""
    return int(rate * 0xFFFFFFFF)


def _mul32(x, c):
    """(x * c) mod 2**32 for int64 ``x`` in [0, 2**32) and ``c`` < 2**32,
    in products that stay below 2**49 (a plain int64 product would
    overflow for the two larger hash constants)."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def dropout_keep(seed, bh, q_pos, k_pos, rate):
    """Keep mask of the attention-probability dropout: the JAX package's
    ``_dropout_keep`` (a lowbias32-style uint32 hash of the seed, the
    b-major batch-head index and the GLOBAL query/key positions) bit for
    bit, in int64 arithmetic masked to 32 bits.  ``bh``, ``q_pos`` and
    ``k_pos`` are ints or int64 tensors that broadcast."""
    x = (_mul32(torch.as_tensor(q_pos, dtype=torch.int64), 2654435761)
         + _mul32(torch.as_tensor(k_pos, dtype=torch.int64), 2246822519)
         + _mul32(torch.as_tensor(bh, dtype=torch.int64), 3266489917)
         + int(seed)) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x >= dropout_threshold(rate)


def _keep_mask(seed, bh, s, rate, device):
    """The [BH, S, S] keep mask, or None when ``rate`` is 0."""
    if rate <= 0.0:
        return None
    pos = torch.arange(s, device=device)
    rows = torch.arange(bh, device=device)[:, None, None]
    return dropout_keep(seed, rows, pos[None, :, None], pos[None, None, :],
                        rate)


def _allowed(s, start, end, key_valid):
    """[BH, S, S]: key in the query's band and valid."""
    pos = torch.arange(s, device=key_valid.device)
    rel = pos[None, :] - pos[:, None]
    band = (rel >= start) & (rel <= end)
    return band[None] & (key_valid[:, None, :] > 0)


def _drop(x, keep, rate):
    """x where kept, scaled by 1/(1 - rate), as the Pallas kernels write it."""
    return x if keep is None else torch.where(keep, x, 0.0) / (1.0 - rate)


def banded_attention_trainable_reference(q, k, v, key_valid, seed, start,
                                         end, scale, dropout_rate=0.0):
    """Plain, autograd-differentiable version of K2a: returns (out, lse).

    ``out = drop(p) @ v / l`` with ``p = exp(s - m)`` over the band's valid
    keys and ``l`` the sum of the UNdropped p, so the dropout acts on the
    normalised probabilities; ``lse = m + log(l)``, -inf for a row with no
    key (whose output is exact zeros)."""
    bh, s, _ = q.shape
    allowed = _allowed(s, start, end, key_valid)
    logits = torch.einsum("bqd,bkd->bqk", q, k) * scale
    logits = logits.masked_fill(~allowed, float("-inf"))
    # softmax is shift-invariant: the max carries no gradient
    m = logits.detach().amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    p = _drop(p, _keep_mask(seed, bh, s, dropout_rate, q.device),
              dropout_rate)
    out = torch.einsum("bqk,bkd->bqd", p, v) / torch.where(
        l == 0.0, torch.ones_like(l), l)
    lse = torch.where(l > 0.0, m + torch.log(torch.where(l > 0.0, l, 1.0)),
                      float("-inf"))
    return out, lse[..., 0].detach()


def _probs(q, k, key_valid, lse, start, end, scale):
    """a = exp(s - lse) over the band's valid keys, 0 elsewhere and on rows
    with lse = -inf."""
    live = torch.isfinite(lse)[..., None]
    lse_safe = torch.where(live, lse[..., None], 0.0)
    logits = torch.einsum("bqd,bkd->bqk", q, k) * scale
    mask = _allowed(q.shape[1], start, end, key_valid) & live
    return torch.where(mask, torch.exp(logits - lse_safe), 0.0)


def banded_attention_dq_reference(q, k, v, key_valid, dout, out, lse, seed,
                                  start, end, scale, dropout_rate=0.0):
    """Plain version of K2b: (dq, delta) with delta = rowsum(dout * out) and
    dq = scale * (a * (drop(dout v^T) - delta)) k."""
    delta = (dout * out).sum(dim=-1)
    a = _probs(q, k, key_valid, lse, start, end, scale)
    keep = _keep_mask(seed, q.shape[0], q.shape[1], dropout_rate, q.device)
    dp = _drop(torch.einsum("bqd,bkd->bqk", dout, v), keep, dropout_rate)
    ds = a * (dp - delta[..., None])
    return torch.einsum("bqk,bkd->bqd", ds, k) * scale, delta


def banded_attention_dkv_reference(q, k, v, key_valid, dout, lse, delta,
                                   seed, start, end, scale, dropout_rate=0.0):
    """Plain version of K2c: (dk, dv) with dv = drop(a)^T dout and
    dk = scale * (a * (drop(dout v^T) - delta))^T q."""
    a = _probs(q, k, key_valid, lse, start, end, scale)
    keep = _keep_mask(seed, q.shape[0], q.shape[1], dropout_rate, q.device)
    dv = torch.einsum("bqk,bqd->bkd", _drop(a, keep, dropout_rate), dout)
    dp = _drop(torch.einsum("bqd,bkd->bqk", dout, v), keep, dropout_rate)
    ds = a * (dp - delta[..., None])
    return torch.einsum("bqk,bqd->bkd", ds, q) * scale, dv


def _dropout_args(seed, rate):
    """(seed, threshold, keep probability, on) as the C entry points take
    them; the threshold in Python double, the keep probability rounded once
    to float32 by ctypes, as the Pallas kernels' 1 - rate is."""
    return (int(seed), dropout_threshold(rate), 1.0 - rate, int(rate > 0.0))


def banded_attention_fwd(q, k, v, key_valid, seed, *, start, end, scale,
                         dropout_rate=0.0):
    """K2a: (out, lse [BH, S]) of the trainable forward; S % BLOCK == 0.
    A CUDA tensor launches the kernel, a CPU tensor takes the plain version."""
    if not q.is_cuda:
        out, lse = banded_attention_trainable_reference(
            q, k, v, key_valid, seed, start, end, scale, dropout_rate)
        return out.detach(), lse
    (q, k, v), (key_valid,) = _kernel_operands("banded_attention_fwd",
                                               (q, k, v), (key_valid,))
    bh, s, d = q.shape
    dv = v.shape[-1]
    out = torch.empty((bh, s, dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((bh, s), dtype=torch.float32, device=q.device)
    _run("banded_attention_fwd", _train_kernel_fn("fwd"), q.device,
         q.data_ptr(), k.data_ptr(), v.data_ptr(), key_valid.data_ptr(),
         out.data_ptr(), lse.data_ptr(), bh, s, d, dv, int(start), int(end),
         float(scale), *_dropout_args(seed, dropout_rate))
    banded_attention_fwd.launches += 1
    return out, lse


def banded_attention_dq(q, k, v, key_valid, dout, out, lse, seed, *, start,
                        end, scale, dropout_rate=0.0):
    """K2b: (dq, delta) of the trainable attention, delta = rowsum(dout *
    out) [BH, S] for K2c; S % BLOCK == 0.  A CUDA tensor launches the kernel
    (which computes delta too), a CPU tensor takes the plain version."""
    if not q.is_cuda:
        return banded_attention_dq_reference(q, k, v, key_valid, dout, out,
                                             lse, seed, start, end, scale,
                                             dropout_rate)
    (q, k, v, dout, out, lse), (key_valid,) = _kernel_operands(
        "banded_attention_dq", (q, k, v, dout, out, lse), (key_valid,))
    bh, s, d = q.shape
    dv = v.shape[-1]
    dq = torch.empty_like(q)
    delta = torch.empty_like(lse)
    _run("banded_attention_dq", _train_kernel_fn("dq"), q.device,
         q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
         out.data_ptr(), lse.data_ptr(), key_valid.data_ptr(), dq.data_ptr(),
         delta.data_ptr(), bh, s, d, dv, int(start), int(end), float(scale),
         *_dropout_args(seed, dropout_rate))
    banded_attention_dq.launches += 1
    return dq, delta


def banded_attention_dkv(q, k, v, key_valid, dout, lse, delta, seed, *,
                         start, end, scale, dropout_rate=0.0):
    """K2c: (dk, dv) of the trainable attention; S % BLOCK == 0.  A CUDA
    tensor launches the kernel, a CPU tensor takes the plain version."""
    if not q.is_cuda:
        return banded_attention_dkv_reference(q, k, v, key_valid, dout, lse,
                                              delta, seed, start, end, scale,
                                              dropout_rate)
    (q, k, v, dout, lse, delta), (key_valid,) = _kernel_operands(
        "banded_attention_dkv", (q, k, v, dout, lse, delta), (key_valid,))
    bh, s, d = q.shape
    dv = v.shape[-1]
    dk = torch.empty_like(k)
    dv_out = torch.empty_like(v)
    _run("banded_attention_dkv", _train_kernel_fn("dkv"), q.device,
         q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
         lse.data_ptr(), delta.data_ptr(), key_valid.data_ptr(), dk.data_ptr(),
         dv_out.data_ptr(), bh, s, d, dv, int(start), int(end), float(scale),
         *_dropout_args(seed, dropout_rate))
    banded_attention_dkv.launches += 1
    return dk, dv_out


banded_attention_fwd.launches = 0
banded_attention_dq.launches = 0
banded_attention_dkv.launches = 0


@functools.lru_cache(maxsize=None)
def _train_kernel_fn(which):
    """The C entry point ``banded_attention_{which}_f32`` of
    csrc/banded_attention_train.cu, built at first use, with its signature:
    pointers, then (bh, s, d, dv, start, end) ints, scale, then the dropout
    (seed, threshold as uint32, keep probability, on) and the stream."""
    from pytorch_kaldi_asr_tpu_torch.ops import _build

    return train_entry(_build.load("banded_attention_train"), which)


def train_entry(library, which):
    """``banded_attention_{which}_f32`` of a ``ctypes.CDLL`` built from
    csrc/banded_attention_train.cu (or a version of it), signature set."""
    n_ptr = {"fwd": 6, "dq": 9, "dkv": 9}[which]
    fn = getattr(library, f"banded_attention_{which}_f32")
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_uint32, ctypes.c_uint32,
                      ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


class _BandedAttentionTrainable(torch.autograd.Function):
    """K2a forward; K2b then K2c backward.  K2b also computes delta =
    rowsum(dout * out), which K2c reads, so on the card one backward is
    exactly two launches.  S % BLOCK == 0; padded query rows get dout = 0
    from the slice, so their delta and their ds are exactly 0."""

    @staticmethod
    def forward(ctx, q, k, v, key_valid, seed, start, end, scale, rate):
        out, lse = banded_attention_fwd(q, k, v, key_valid, seed, start=start,
                                        end=end, scale=scale,
                                        dropout_rate=rate)
        ctx.save_for_backward(q, k, v, key_valid, out, lse)
        ctx.args = dict(start=start, end=end, scale=scale, dropout_rate=rate)
        ctx.seed = seed
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, key_valid, out, lse = ctx.saved_tensors
        dout = dout.contiguous()  # once for both kernels
        dq, delta = banded_attention_dq(q, k, v, key_valid, dout, out, lse,
                                        ctx.seed, **ctx.args)
        dk, dv = banded_attention_dkv(q, k, v, key_valid, dout, lse, delta,
                                      ctx.seed, **ctx.args)
        return dq, dk, dv, None, None, None, None, None, None


def banded_attention_trainable(q, k, v, key_valid, seed, *, start, end, scale,
                               dropout_rate=0.0):
    """Differentiable banded attention with attention-probability dropout
    (``dropout(softmax(banded(q k^T scale))) @ v``), the JAX package's
    ``banded_attention_trainable``.  ``seed`` is a Python int in
    [0, MAX_SEED]; the mask is :func:`dropout_keep` of it.  Any S: padded
    to a multiple of ``BLOCK`` with invalid keys, the padded rows dropped.
    A CUDA tensor runs the kernels K2a/K2b/K2c, a CPU tensor their plain
    versions, through the same autograd function."""
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {dropout_rate}")
    if not 0 <= int(seed) <= MAX_SEED:
        raise ValueError(f"seed must be in [0, {MAX_SEED}], got {seed}")
    s = q.shape[1]
    q, k, v, key_valid = _check_and_pad(q, k, v, key_valid, start, end)
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"banded_attention_trainable: unsupported device "
                         f"{q.device}")
    out = _BandedAttentionTrainable.apply(q, k, v, key_valid, int(seed),
                                          int(start), int(end), float(scale),
                                          float(dropout_rate))
    # no slice when nothing was padded: its backward would add two launches
    return out if out.shape[1] == s else out[:, :s]
