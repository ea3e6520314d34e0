"""Encoder families beyond the flagship TDNN/LDA frontend.

Ported so far: ``banded``, the self-attention encoder with a banded window
(the reference's ``Encoder`` class made alive): src projection, one
sinusoid position table added before the layer stack and again after it,
post-LN MHA + FFN layers, band (start, end) from ``encoder_sub_sequence``.
Inference (``train=False``) runs the self-attention through
``ops.banded_attention`` (K1); training through
``ops.banded_attention_trainable`` (K2a/K2b/K2c), with the attention
probabilities dropped by the kernels' hash mask from a seed drawn per site
and step.  Either takes the Hopper kernels for CUDA tensors and the plain
PyTorch versions for CPU tensors.  Unlike the JAX package there is no
length threshold or config switch: the JAX package trains short sequences
through masked full attention with ``jax.random`` dropout, the port always
through the trainable kernel's path (the JAX package's own function, taken
there when its kernel is on).
"""

from __future__ import annotations

import torch

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
    rate is 0, as the JAX package does without an rng."""
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


_ENCODERS = {"banded": (init_banded_encoder, banded_encode)}


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
