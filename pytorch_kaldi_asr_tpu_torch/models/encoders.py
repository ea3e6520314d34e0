"""Encoder families beyond the flagship TDNN/LDA frontend.

Ported so far:

- ``banded``, the self-attention encoder with a banded window (the
  reference's ``Encoder`` class made alive): src projection, one sinusoid
  position table added before the layer stack and again after it, post-LN
  MHA + FFN layers, band (start, end) from ``encoder_sub_sequence``.
- ``conformer``: src projection + positions, then per layer a macaron
  half-step FFN (pre-LN, swish, x0.5), banded MHSA (post-LN), the conv
  module (pointwise GLU, pre-conv mask, depthwise conv centered or causal,
  LN, swish, pointwise) and a second half-step FFN.  The conv module uses
  layer norm where the paper has batch norm, as the JAX package does.

Both run their banded self-attention the same way.  Inference
(``train=False``) goes through ``ops.banded_attention`` (K1); training
through ``ops.banded_attention_trainable`` (K2a/K2b/K2c), with the
attention probabilities dropped by the kernels' hash mask from a seed drawn
per site and step.  Either takes the Hopper kernels for CUDA tensors and the
plain PyTorch versions for CPU tensors.  Unlike the JAX package there is no
length threshold, environment knob or config switch: the JAX package trains
short banded sequences through masked full attention with ``jax.random``
dropout and the conformer through its blocked XLA attention, the port always
through the trainable kernel's path (the JAX package's own function, taken
there when its kernel is on; the same function as the blocked path at
dropout 0).

The conformer's residual stream is ``conformer_stream_dtype``: float32, or
bfloat16 as the conformer recipe ships it.  The casts sit where the JAX
package writes them: the stream is rounded after the input positions, after
the MHSA's residual sum (taken in float32), after each half-step FFN's
second projection and after the conv module's depthwise conv and its second
projection; layer norm and the dropouts on the stream run in its dtype, the
matrix products, the attention and the other dropouts in the compute dtype.

With ``compute_dtype=bfloat16`` every product (the projections, q/k/v, the
FFNs, the conv module's pointwise and depthwise convolutions) is bfloat16
with the JAX package's casts, and the attention takes bfloat16 q, k, v
through the bfloat16 kernels.  The banded encoder keeps its float32 stream
(the JAX package's ``x.astype(float32) + pos``); its attention block
follows the JAX package's ``multi_head_attention`` casts around the
kernel, whose scale multiplies the float32 scores (JAX off the TPU trains
it through masked XLA attention, whose logits are rounded to bfloat16 and
divided by a bfloat16 sqrt(d_model): a deliberate difference, ROADMAP.md
queue 3).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pytorch_kaldi_asr_tpu_torch.models.common import (
    cast,
    layer_norm,
    linear,
    position_encoding_table,
    xavier_normal,
)
from pytorch_kaldi_asr_tpu_torch.models.transformer import (
    ROADMAP_ENCODERS,
    _drop,
    _init_ffn,
    _init_mha,
    compute_dtype,
    feed_forward,
)
from pytorch_kaldi_asr_tpu_torch.ops.banded_attention import (
    banded_attention,
    banded_attention_trainable,
)


def init_banded_encoder(generator, cfg):
    d_in = cfg.src_dim * cfg.src_fold
    return {
        "src_proj": {
            "w": xavier_normal(generator, (d_in, cfg.en_d_model), d_in,
                               cfg.en_d_model)
        },
        "layers": [
            {
                "slf": _init_mha(generator, cfg.en_d_model, cfg.n_head,
                                 cfg.d_k, cfg.d_v),
                "ffn": _init_ffn(generator, cfg.en_d_model, cfg.en_d_model),
            }
            for _ in range(cfg.en_layers)
        ],
    }


def _banded_self_attention(p, x, src_mask, cfg, rate, rngs, train):
    """Banded self-attention block (post-LN).

    Heads fold b-major into the kernel's batch axis: [B, H, S, D] →
    [B·H, S, D], with the key mask repeated per head to match.  Training
    draws one kernel seed per call; without ``rngs`` the attention dropout
    rate is 0, as the JAX package does without an rng.  It is also the
    conformer's MHSA block (the JAX package's ``_conformer_mhsa``)."""
    b, s, d_model = x.shape
    h = p["w_qs"].shape[0]
    start, end = cfg.encoder_sub_sequence
    dtype = compute_dtype(cfg)
    # float32 compute: a bfloat16 stream attends in float32
    xf = x.to(dtype or p["w_qs"].dtype)
    qs, ks, vs = (torch.einsum("bld,hdk->bhlk", xf, cast(p[w], dtype))
                  .reshape(b * h, s, -1) for w in ("w_qs", "w_ks", "w_vs"))
    key_valid = torch.repeat_interleave(src_mask.to(torch.int32), h, dim=0)
    scale = 1.0 / float(d_model) ** 0.5
    if train:
        out = banded_attention_trainable(
            qs, ks, vs, key_valid, 0 if rngs is None else rngs.seed(),
            start=start, end=end, scale=scale,
            dropout_rate=0.0 if rngs is None else float(rate))
    else:
        out = banded_attention(qs, ks, vs, key_valid, start=start, end=end,
                               scale=scale)
    out = out.reshape(b, h, s, -1).transpose(1, 2).reshape(b, s, -1)
    out = linear(out, p["proj"]["w"], p["proj"]["b"], dtype)
    out = _drop(out, rate, rngs, train)
    # the residual sum in float32, rounded once to the stream's dtype
    return layer_norm((out + x).to(x.dtype), p["ln"]["gamma"],
                      p["ln"]["beta"], skip_len1=cfg.ln_skip_len1)


def banded_encode(params, cfg, src_seq, src_mask, *, train=False, rngs=None):
    s = src_seq.shape[1]
    rate = cfg.en_dropout
    # the sinusoid table is closed-form: sequences longer than
    # encoder_max_len extrapolate exactly
    pos = position_encoding_table(max(cfg.encoder_max_len, s), cfg.en_d_model,
                                  device=src_seq.device)[:s]
    dtype = compute_dtype(cfg)
    x = linear(src_seq, params["src_proj"]["w"], None, dtype)
    x = (x if dtype is None else x.float()) + pos[None]
    x = _drop(x, rate, rngs, train)
    for layer in params["layers"]:
        x = _banded_self_attention(layer["slf"], x, src_mask, cfg, rate, rngs,
                                   train)
        x = feed_forward(layer["ffn"], x, cfg, rate, rngs, train)
    x = x + pos[None]  # positions again after the stack
    return _drop(x, rate, rngs, train), src_mask


# ---------------------------------------------------------------------------
# conformer
# ---------------------------------------------------------------------------


def _init_conv_module(generator, d, kernel):
    return {
        "ln": {"gamma": torch.ones(d), "beta": torch.zeros(d)},
        "pw1": {"w": xavier_normal(generator, (d, 2 * d), d, 2 * d),
                "b": torch.zeros(2 * d)},
        "dw": {"w": xavier_normal(generator, (kernel, d), kernel, d),
               "b": torch.zeros(d)},
        "norm": {"gamma": torch.ones(d), "beta": torch.zeros(d)},
        "pw2": {"w": xavier_normal(generator, (d, d), d, d),
                "b": torch.zeros(d)},
    }


def init_conformer_encoder(generator, cfg):
    d = cfg.en_d_model
    d_in = cfg.src_dim * cfg.src_fold
    return {
        "src_proj": {"w": xavier_normal(generator, (d_in, d), d_in, d)},
        "layers": [
            {
                "ffn1": _init_ffn(generator, d, 4 * d),
                "mhsa": _init_mha(generator, d, cfg.n_head, cfg.d_k, cfg.d_v),
                "conv": _init_conv_module(generator, d, cfg.conformer_kernel),
                "ffn2": _init_ffn(generator, d, 4 * d),
            }
            for _ in range(cfg.en_layers)
        ],
    }


def _half_ffn(p, x, cfg, rate, rngs, train):
    """Macaron half-step FFN: x + 0.5·FFN(LN(x)) (pre-LN, swish), dropout
    after the swish (the compute dtype) and after the second projection (in
    the stream's dtype)."""
    dtype = compute_dtype(cfg)
    h = layer_norm(x, p["ln"]["gamma"], p["ln"]["beta"], skip_len1=False)
    h = _swish(linear(h, p["w1"]["w"], p["w1"]["b"], dtype))
    h = _drop(h, rate, rngs, train)
    h = linear(h, p["w2"]["w"], p["w2"]["b"], dtype)
    h = _drop(h.to(x.dtype), rate, rngs, train)
    return x + 0.5 * h


def _conv_module(p, x, mask, cfg, rate, rngs, train):
    """Pointwise GLU → pre-conv mask → depthwise conv along time → LN →
    swish → pointwise.  Zeroing the padded frames before the conv (all
    above it is position-wise) keeps valid frames pad-invariant.  The
    depthwise conv is ``F.conv1d`` with one group per channel (the JAX
    package leaves it to XLA too): centered SAME padding, or causal (past
    frames only) with ``conformer_causal_conv``.  The depthwise conv's
    output is rounded to the stream's dtype, and its layer norm, swish and
    final dropout run there.  In bfloat16 compute the GLU, its sigmoid
    (``_SigmoidBF16``) and the depthwise conv are bfloat16 too, the conv
    rounded and then its bias add, as XLA computes JAX's on bfloat16."""
    dtype = compute_dtype(cfg)
    h = layer_norm(x, p["ln"]["gamma"], p["ln"]["beta"], skip_len1=False)
    h = linear(h, p["pw1"]["w"], p["pw1"]["b"], dtype)
    a, b = h.chunk(2, dim=-1)
    h = (a * _sigmoid(b)) * mask[..., None].to(h.dtype)  # GLU, mask
    kernel = cast(p["dw"]["w"], dtype)  # [K, D]
    k, d = kernel.shape
    pad = k - 1 if cfg.conformer_causal_conv else (k - 1) // 2
    h = F.conv1d(F.pad(h.transpose(1, 2), (pad, k - 1 - pad)),
                 kernel.t()[:, None, :], groups=d).transpose(1, 2)
    h = layer_norm((h + cast(p["dw"]["b"], dtype)).to(x.dtype),
                   p["norm"]["gamma"], p["norm"]["beta"], skip_len1=False)
    h = linear(_swish(h), p["pw2"]["w"], p["pw2"]["b"], dtype)
    return x + _drop(h.to(x.dtype), rate, rngs, train)


class _SwishBF16(torch.autograd.Function):
    """``jax.nn.swish`` on bfloat16 with the JAX package's gradient, every
    step rounded to bfloat16 as XLA computes it on the CPU with each
    written rounding kept: forward ``s = 1 / (1 + exp(-h))`` (its three
    steps rounded), ``h * s``; backward ``g s + (g h) (s (1 - s))``, the
    VJPs of the product and of ``lax.logistic``.  (Autograd of the forward's
    steps rounds other intermediates: the step's gradients then sat up to
    0.92 of the bfloat16 stream's own error from JAX's, against 0.02 with
    this backward; tests/test_torch_bf16_stream.py.)"""

    @staticmethod
    def forward(ctx, h):
        s = torch.reciprocal(torch.exp(-h) + 1)
        ctx.save_for_backward(h, s)
        return h * s

    @staticmethod
    def backward(ctx, g):
        h, s = ctx.saved_tensors
        return g * s + (g * h) * (s * (1 - s))


def _swish(h):
    """``jax.nn.swish`` in ``h``'s dtype: on bfloat16 :class:`_SwishBF16`
    (``F.silu`` on bfloat16 rounds once)."""
    if h.dtype == torch.bfloat16:
        return _SwishBF16.apply(h)
    return F.silu(h)


class _SigmoidBF16(torch.autograd.Function):
    """``jax.nn.sigmoid`` (``lax.logistic``) on bfloat16 as XLA computes it
    on the CPU with each written rounding kept: ``1 / (1 + exp(-b))``, its
    three steps rounded to bfloat16; backward ``g (s (1 - s))``, the VJP of
    ``lax.logistic`` (the sigmoid of :class:`_SwishBF16`)."""

    @staticmethod
    def forward(ctx, b):
        s = torch.reciprocal(torch.exp(-b) + 1)
        ctx.save_for_backward(s)
        return s

    @staticmethod
    def backward(ctx, g):
        (s,) = ctx.saved_tensors
        return g * (s * (1 - s))


def _sigmoid(b):
    """The GLU's sigmoid in ``b``'s dtype: on bfloat16
    :class:`_SigmoidBF16`."""
    if b.dtype == torch.bfloat16:
        return _SigmoidBF16.apply(b)
    return torch.sigmoid(b)


def conformer_encode(params, cfg, src_seq, src_mask, *, train=False,
                     rngs=None):
    s = src_seq.shape[1]
    rate = cfg.en_dropout
    # closed-form sinusoids: sequences past encoder_max_len extrapolate
    pos = position_encoding_table(max(cfg.encoder_max_len, s), cfg.en_d_model,
                                  device=src_seq.device)[:s]
    stream = getattr(torch, cfg.conformer_stream_dtype)
    x = linear(src_seq, params["src_proj"]["w"], None, compute_dtype(cfg))
    x = x.to(stream) + pos[None].to(stream)
    x = _drop(x, rate, rngs, train)
    for layer in params["layers"]:
        x = _half_ffn(layer["ffn1"], x, cfg, rate, rngs, train)
        x = _banded_self_attention(layer["mhsa"], x, src_mask, cfg, rate,
                                   rngs, train)
        x = _conv_module(layer["conv"], x, src_mask, cfg, rate, rngs, train)
        x = _half_ffn(layer["ffn2"], x, cfg, rate, rngs, train)
    return x, src_mask


_ENCODERS = {
    "banded": (init_banded_encoder, banded_encode),
    "conformer": (init_conformer_encoder, conformer_encode),
}


def _family(encoder_type):
    if encoder_type not in _ENCODERS:
        raise NotImplementedError(
            f"encoder_type={encoder_type!r} is not ported yet "
            f"({ROADMAP_ENCODERS})")
    return _ENCODERS[encoder_type]


def encoder_init(encoder_type):
    """Init function of an encoder family (raises for unported ones)."""
    return _family(encoder_type)[0]


def encoder_apply(encoder_type):
    """Apply function of an encoder family (raises for unported ones)."""
    return _family(encoder_type)[1]
