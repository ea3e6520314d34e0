"""Shared model building blocks: positional tables, attention masks, frame
folding, masked softmax, layer norm, splicing, dropout, init.

Each function keeps a numerical quirk of the reference model family that
the JAX package pins (``pytorch_kaldi_asr_tpu.models.common``); missing any
of them moves WER without an error:

- the sinusoid table is built in float64 and has a zero row 0;
- banded masks: query t may attend keys ``[t+start, t+end]`` inclusive;
- fully masked softmax rows are exact zeros, not NaN;
- layer norm divides by the UNBIASED std with ``eps`` added to the std,
  and is the identity when the sequence axis has length 1 (``skip_len1``);
- frame folding subsamples the mask at ``[fold-1::fold]``;
- dropout keeps each element with probability q/256,
  ``q = round((1 - rate) * 256)``, and scales kept values by exactly 256/q
  (on bfloat16, by 256/q rounded to bfloat16: 1.109375 at rate 0.1, not
  1.1130, as the JAX package's weak-typed Python float rounds it);
- layer norm on bfloat16 takes its statistics in float32 from one-pass
  moments, ``var = max(Σz² - n·mu², 0) / (n - 1)``, and rounds its output
  back to bfloat16;
- a product with a bias in bfloat16 compute rounds twice, as XLA computes
  JAX's ``x @ w + b`` on bfloat16: the product, then the sum (``linear``;
  ``F.linear`` and ``addmm`` add the bias in float32 and round once).

The products run in float32 or, with ``compute_dtype=bfloat16``, in
bfloat16 (``cast``, ``linear``, ``spliced_linear``); the conformer's
residual stream (and so layer norm and dropout on it) may be bfloat16.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from pytorch_kaldi_asr_tpu_torch.ops.fused_dropout import masked_dropout


def position_encoding_table(n_position, d_model, device=None):
    """Sinusoid position table [n_position, d_model] float32; row 0 zeros."""
    pos = np.arange(n_position, dtype=np.float64)[:, None]
    j = np.arange(d_model, dtype=np.float64)[None, :]
    angle = pos / np.power(10000.0, 2 * (j // 2) / d_model)
    table = np.zeros((n_position, d_model), dtype=np.float64)
    table[1:, 0::2] = np.sin(angle[1:, 0::2])
    table[1:, 1::2] = np.cos(angle[1:, 1::2])
    return torch.from_numpy(table.astype(np.float32)).to(device)


def padding_attn_mask(mask_q, mask_k):
    """True where attention must be BLOCKED because the key is padding.
    ``mask_q``/``mask_k`` are [B, L] validity masks (1 = real); returns
    [B, Lq, Lk] bool."""
    blocked = (mask_k == 0)[:, None, :]
    return blocked.expand(mask_q.shape[0], mask_q.shape[1], mask_k.shape[1])


def banded_attn_mask(length, start, end, device=None):
    """True where attention must be BLOCKED by the (start, end) band:
    position t may attend ``[t+start, t+end]`` inclusive.  [L, L] bool."""
    q = torch.arange(length, device=device)[:, None]
    k = torch.arange(length, device=device)[None, :]
    rel = k - q
    return ~((rel >= start) & (rel <= end))


def fold_seq_and_mask(seq, pad_mask, fold):
    """Stack ``fold`` consecutive frames: [B, L, D] → [B, L//fold, D*fold];
    the validity mask is subsampled at ``[fold-1::fold]``."""
    if fold == 1:
        return seq, pad_mask
    if fold < 1:
        raise ValueError("invalid data fold parameter")
    b, l, d = seq.shape
    l_trim = l - l % fold
    seq = seq[:, :l_trim].reshape(b, l_trim // fold, d * fold)
    pad_mask = pad_mask[:, fold - 1 :: fold][:, : l_trim // fold]
    return seq, pad_mask


def masked_softmax(logits, blocked):
    """Exact softmax over unblocked entries of the last axis; fully blocked
    rows → all zeros (the reference's masked_fill(-inf) → softmax →
    re-zero, without NaNs).  ``blocked`` broadcasts against ``logits``."""
    logits = logits.masked_fill(blocked, float("-inf"))
    m = logits.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(logits - m)
    s = e.sum(dim=-1, keepdim=True)
    attn = e / torch.where(s == 0.0, torch.ones_like(s), s)
    return attn.masked_fill(blocked, 0.0)


def layer_norm(z, gamma, beta, eps=1e-3, skip_len1=True):
    """Reference-style layer norm over the last axis of [B, L, D]: unbiased
    std (÷(N-1)), ``eps`` added to the std, identity when L == 1 and
    ``skip_len1``.  A bfloat16 ``z`` is normalised in float32 with the
    one-pass moments and the result rounded back to bfloat16."""
    if skip_len1 and z.shape[1] == 1:
        return z
    n = z.shape[-1]
    if z.dtype == torch.bfloat16:
        zf = z.float()
        mu = zf.sum(dim=-1, keepdim=True) / n
        s2 = (zf * zf).sum(dim=-1, keepdim=True)
        var = torch.clamp_min(s2 - n * mu * mu, 0.0) / (n - 1)
    else:
        zf = z
        mu = z.mean(dim=-1, keepdim=True)
        var = ((z - mu) ** 2).sum(dim=-1, keepdim=True) / (n - 1)
    # safe sqrt: the same value, but a constant row (var == 0) gets a zero
    # gradient instead of inf * 0 = NaN
    safe = var > 0
    sigma = torch.where(safe, torch.sqrt(torch.where(safe, var, 1.0)), 0.0)
    return ((zf - mu) / (sigma + eps) * gamma + beta).to(z.dtype)


def splice_frames(x, context):
    """Concatenate zero-padded shifted copies of x [B, L, D] along the
    feature axis, in context order → [B, L, D*len(context)]."""
    context = list(context)
    pad_head = max(0, -context[0])
    pad_end = max(0, context[-1])
    l = x.shape[1]
    padded = F.pad(x, (0, 0, pad_head, pad_end))
    pieces = [padded[:, c + pad_head : c + pad_head + l] for c in context]
    return torch.cat(pieces, dim=2)


def cast(x, dtype):
    """``x`` in ``dtype``; ``x`` itself where ``dtype`` is None (float32
    compute keeps the tensors' own dtype)."""
    return x if dtype is None else x.to(dtype)


def linear(x, w, b, dtype=None):
    """``x @ w + b`` in ``dtype`` (None: ``w``'s dtype), as the JAX package
    writes it: on bfloat16 the product is rounded to bfloat16 (its sum
    taken in float32) and the bias add rounded again.  ``b`` may be
    None."""
    out = cast(x, dtype or w.dtype) @ cast(w, dtype)
    return out if b is None else out + cast(b, dtype)


def spliced_linear(x, w, b, context, dtype=None):
    """``splice_frames(x, context) @ w + b`` without building the spliced
    tensor when the context is evenly spaced: a dilated 1-D convolution.
    In ``dtype`` as :func:`linear` (the JAX package's ``dtype=``): x, w and
    b cast, the convolution rounded, then the bias add.

    x: [B, T, D]; w: [D·K, D_out] with row blocks in context order."""
    x, w = cast(x, dtype), cast(w, dtype)
    context = list(context)
    k = len(context)
    steps = [context[i + 1] - context[i] for i in range(k - 1)]
    if k > 1 and len(set(steps)) == 1 and steps[0] > 0:
        d_in = x.shape[-1]
        # [K, D, D_out] → conv1d weight [D_out, D, K]
        kernel = w.reshape(k, d_in, -1).permute(2, 1, 0)
        xp = F.pad(x.transpose(1, 2), (-context[0], context[-1]))
        out = F.conv1d(xp, kernel, dilation=steps[0]).transpose(1, 2)
    else:
        out = splice_frames(x, context) @ w
    if b is not None:
        out = out + cast(b, dtype)
    return out


class DropoutRngs:
    """The randomness of one training step: ``seeds``, a CPU generator that
    draws one seed per dropout site (the fused-dropout kernel's and the
    banded-attention kernels') as a Python int, so taking one never waits
    on the card, and the masks are the same on every device."""

    def __init__(self, seeds):
        self.seeds = seeds

    def seed(self):
        """A kernel seed in [0, 2**31 - 2], as the JAX package draws it."""
        return int(torch.randint(0, 2**31 - 1, (), generator=self.seeds))


def dropout(x, rate, seed, train):
    """Inverted dropout, the JAX package's 8-bit threshold draw: each element
    is kept with probability q/256, ``q = round((1 - rate) * 256)``, and
    scaled by 256/q, so the estimate stays unbiased.  The mask comes from
    the fused-dropout kernel (ops/fused_dropout.py) keyed by ``seed``: kept
    iff its 32-bit word is at least ``(256 - q) * 2**24``, which has
    probability exactly q/256.  On bfloat16 the scale is 256/q rounded to
    bfloat16, as the JAX package's weak-typed Python float is, so kept
    values are ``bf16(float(x) * bf16(256/q))``.  Identity when not
    training, when ``rate == 0``, without a seed, or when q >= 256."""
    if not train or rate == 0.0 or seed is None:
        return x
    q = round((1.0 - rate) * 256)
    if q >= 256:
        return x
    q = max(q, 1)
    scale = 256.0 / q
    if x.dtype == torch.bfloat16:
        scale = float(torch.tensor(scale, dtype=torch.bfloat16))
    return masked_dropout(x, seed, (256 - q) << 24, scale)


def xavier_normal(generator, shape, fan_in, fan_out):
    """Xavier/Glorot normal with explicit fans (float32, CPU)."""
    std = float(np.sqrt(2.0 / (fan_in + fan_out)))
    return std * torch.randn(shape, generator=generator)


def torch_default_uniform(generator, shape, fan_in):
    """nn.Linear/nn.Conv1d's default init U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = float(1.0 / np.sqrt(fan_in))
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound
