"""Import reference-format weights into the port's parameter tree.

The reference checkpoints pickle the whole ``Transformer`` module; the key
schema of its ``state_dict()`` is fixed by the reference's Models.py,
SubLayers.py, Modules.py and TDNN.py:

- ``encoder_test.lda_layer.weight`` is stored already transposed to
  [in, out];
- every ``Linear`` is the ``BottleLinear`` wrapper, so weights live under
  ``<name>.linear.weight`` with torch's [out, in] layout;
- the attention's per-head tensors ``w_qs/w_ks/w_vs`` are [H, d_model,
  d_k], the layout the port uses too;
- layer norms are ``a_2``/``b_2``;
- the FFN is two 1x1 Conv1d's, weight [out, in, 1].

:func:`state_dict_to_params` turns a {key: array or tensor} mapping of that
schema into the tree ``models.transformer.init_transformer`` builds (float32
tensors on the CPU), so a model trained by the reference decodes or trains
with the port, and the reference code's recorded activations pin the port
(tests/test_torch_reference_goldens.py).  A copy of the JAX package's
``models/torch_import.py``, returning tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from pytorch_kaldi_asr_tpu_torch.models.transformer import TransformerConfig


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def _lin(sd, name):
    """BottleLinear weights → {w: [in, out], b?}."""
    out = {"w": _t(sd[name + ".linear.weight"].T)}
    if name + ".linear.bias" in sd:
        out["b"] = _t(sd[name + ".linear.bias"])
    return out


def _ln(sd, prefix):
    return {"gamma": _t(sd[prefix + ".layer_norm.a_2"]),
            "beta": _t(sd[prefix + ".layer_norm.b_2"])}


def _mha(sd, prefix):
    return {
        "w_qs": _t(sd[prefix + ".w_qs"]),
        "w_ks": _t(sd[prefix + ".w_ks"]),
        "w_vs": _t(sd[prefix + ".w_vs"]),
        "proj": _lin(sd, prefix + ".proj"),
        "ln": _ln(sd, prefix),
    }


def _ffn(sd, prefix):
    def conv1x1(name):
        return {"w": _t(sd[name + ".weight"][:, :, 0].T),  # [in, out]
                "b": _t(sd[name + ".bias"])}

    return {"w1": conv1x1(prefix + ".w_1"), "w2": conv1x1(prefix + ".w_2"),
            "ln": _ln(sd, prefix)}


def state_dict_to_params(sd, cfg: TransformerConfig):
    """A reference-schema state dict (numpy arrays or tensors) as the port's
    parameter tree for the flagship TDNN-encoder model."""
    sd = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
              else np.asarray(v)) for k, v in sd.items()}

    encoder = {
        # the LDA layer stores its weight as [in, out] already
        "lda": {"w": _t(sd["encoder_test.lda_layer.weight"]),
                "b": _t(sd["encoder_test.lda_layer.bias"])},
        "src_proj": _lin(sd, "encoder_test.src_projection"),
        "tdnn": [],
    }
    i = 0
    while f"encoder_test.tdnn_stack.{i}.proj.weight" in sd:
        encoder["tdnn"].append({
            "w": _t(sd[f"encoder_test.tdnn_stack.{i}.proj.weight"].T),
            "b": _t(sd[f"encoder_test.tdnn_stack.{i}.proj.bias"]),
        })
        i += 1
    if len(encoder["tdnn"]) != len(cfg.tdnn_contexts):
        raise ValueError(
            f"state dict has {len(encoder['tdnn'])} TDNN layers but the config "
            f"declares {len(cfg.tdnn_contexts)} contexts")

    decoder = {
        "embed": _t(sd["decoder.tgt_word_emb.weight"]),
        "enc_dec_proj": _lin(sd, "decoder.enc_dec_projection"),
        "word_proj": _lin(sd, "decoder.tgt_word_proj"),
        "layers": [],
    }
    i = 0
    while f"decoder.layer_stack.{i}.slf_attn.w_qs" in sd:
        prefix = f"decoder.layer_stack.{i}"
        decoder["layers"].append({
            "slf": _mha(sd, prefix + ".slf_attn"),
            "enc": _mha(sd, prefix + ".enc_attn"),
            "ffn": _ffn(sd, prefix + ".pos_ffn"),
        })
        i += 1
    if len(decoder["layers"]) != cfg.de_layers:
        raise ValueError(
            f"state dict has {len(decoder['layers'])} decoder layers but the "
            f"config declares {cfg.de_layers}")
    return {"encoder": encoder, "decoder": decoder}


def config_from_model_options(opts: dict) -> TransformerConfig:
    """A TransformerConfig from the reference checkpoint's ``model_options``
    dict (the reference's initialize_model.py)."""

    def _pair(v):
        if isinstance(v, str):
            v = v.strip("() ").split(",")
        a, b = (int(x) for x in v)
        return (a, b)

    return TransformerConfig(
        src_dim=int(opts["n_src_dim"]),
        vocab_size=int(opts["n_tgt_vocab"]),
        encoder_max_len=int(opts["encoder_max_len"]),
        decoder_max_len=int(opts["decoder_max_len"]),
        src_fold=int(opts.get("src_fold", 1)),
        encoder_sub_sequence=_pair(opts.get("encoder_sub_sequence",
                                            (-100, 0))),
        decoder_sub_sequence=_pair(opts.get("decoder_sub_sequence",
                                            (-10, 0))),
        en_layers=int(opts.get("en_layers", 3)),
        de_layers=int(opts.get("de_layers", 3)),
        n_head=int(opts.get("n_head", 2)),
        en_d_model=int(opts.get("en_d_model", 256)),
        de_d_model=int(opts.get("de_d_model", 128)),
        d_k=int(opts.get("d_k", 64)),
        d_v=int(opts.get("d_v", 64)),
        en_dropout=float(opts.get("en_dropout", 0.35)),
        de_dropout=float(opts.get("de_dropout", 0.35)),
        tdnn_contexts=tuple(tuple(c) for c in opts["tdnn_contexts"])
        if "tdnn_contexts" in opts else TransformerConfig.tdnn_contexts,
    )
