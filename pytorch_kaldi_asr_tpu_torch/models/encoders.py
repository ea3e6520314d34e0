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
dropout 0).  The conformer's residual stream is float32 only
(models/transformer.py refuses another ``conformer_stream_dtype``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pytorch_kaldi_asr_tpu_torch.models.common import (
    layer_norm,
    position_encoding_table,
    xavier_normal,
)
from pytorch_kaldi_asr_tpu_torch.models.transformer import (
    ROADMAP_ENCODERS,
    _drop,
    _init_ffn,
    _init_mha,
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
    qs = torch.einsum("bld,hdk->bhlk", x, p["w_qs"]).reshape(b * h, s, -1)
    ks = torch.einsum("bld,hdk->bhlk", x, p["w_ks"]).reshape(b * h, s, -1)
    vs = torch.einsum("bld,hdv->bhlv", x, p["w_vs"]).reshape(b * h, s, -1)
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
    out = out @ p["proj"]["w"] + p["proj"]["b"]
    out = _drop(out, rate, rngs, train)
    return layer_norm(out + x, p["ln"]["gamma"], p["ln"]["beta"],
                      skip_len1=cfg.ln_skip_len1)


def banded_encode(params, cfg, src_seq, src_mask, *, train=False, rngs=None):
    s = src_seq.shape[1]
    rate = cfg.en_dropout
    # the sinusoid table is closed-form: sequences longer than
    # encoder_max_len extrapolate exactly
    pos = position_encoding_table(max(cfg.encoder_max_len, s), cfg.en_d_model,
                                  device=src_seq.device)[:s]
    x = src_seq @ params["src_proj"]["w"] + pos[None]
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
    after the swish and after the second projection."""
    h = layer_norm(x, p["ln"]["gamma"], p["ln"]["beta"], skip_len1=False)
    h = F.silu(h @ p["w1"]["w"] + p["w1"]["b"])
    h = _drop(h, rate, rngs, train)
    h = h @ p["w2"]["w"] + p["w2"]["b"]
    h = _drop(h, rate, rngs, train)
    return x + 0.5 * h


def _conv_module(p, x, mask, cfg, rate, rngs, train):
    """Pointwise GLU → pre-conv mask → depthwise conv along time → LN →
    swish → pointwise.  Zeroing the padded frames before the conv (all
    above it is position-wise) keeps valid frames pad-invariant.  The
    depthwise conv is ``F.conv1d`` with one group per channel (the JAX
    package leaves it to XLA too): centered SAME padding, or causal (past
    frames only) with ``conformer_causal_conv``."""
    h = layer_norm(x, p["ln"]["gamma"], p["ln"]["beta"], skip_len1=False)
    h = h @ p["pw1"]["w"] + p["pw1"]["b"]
    a, b = h.chunk(2, dim=-1)
    h = (a * torch.sigmoid(b)) * mask[..., None].to(h.dtype)  # GLU, mask
    kernel = p["dw"]["w"]  # [K, D]
    k, d = kernel.shape
    pad = k - 1 if cfg.conformer_causal_conv else (k - 1) // 2
    h = F.conv1d(F.pad(h.transpose(1, 2), (pad, k - 1 - pad)),
                 kernel.t()[:, None, :], groups=d).transpose(1, 2)
    h = layer_norm(h + p["dw"]["b"], p["norm"]["gamma"], p["norm"]["beta"],
                   skip_len1=False)
    h = F.silu(h) @ p["pw2"]["w"] + p["pw2"]["b"]
    return x + _drop(h, rate, rngs, train)


def conformer_encode(params, cfg, src_seq, src_mask, *, train=False,
                     rngs=None):
    s = src_seq.shape[1]
    rate = cfg.en_dropout
    # closed-form sinusoids: sequences past encoder_max_len extrapolate
    pos = position_encoding_table(max(cfg.encoder_max_len, s), cfg.en_d_model,
                                  device=src_seq.device)[:s]
    x = src_seq @ params["src_proj"]["w"] + pos[None]
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
