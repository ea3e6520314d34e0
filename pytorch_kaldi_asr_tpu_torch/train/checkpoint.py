"""Checkpoints in the JAX package's on-disk layout.

A checkpoint is a directory::

    <name>/
      config.json       # TransformerConfig fields
      meta.json         # epoch, step, user extras
      params.msgpack    # flax-serialized parameter tree

``params.msgpack`` is read and written with the port's own msgpack codec
(utils/msgpack.py): flax's layout, with lists stored as maps keyed "0",
"1", ....  A checkpoint written by the JAX package's ``save_checkpoint``
loads here bit for bit, and one written here loads there.  Optimizer state
is not read (this slice only decodes).
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from pytorch_kaldi_asr_tpu_torch.models.transformer import TransformerConfig
from pytorch_kaldi_asr_tpu_torch.utils import msgpack


def config_to_json(cfg):
    return dataclasses.asdict(cfg)


def config_from_json(d):
    d = dict(d)
    for key in ("encoder_sub_sequence", "decoder_sub_sequence", "lda_context"):
        if key in d:
            d[key] = tuple(d[key])
    if "tdnn_contexts" in d:
        d["tdnn_contexts"] = tuple(tuple(c) for c in d["tdnn_contexts"])
    return TransformerConfig(**d)


def params_from_jax(tree, device=None):
    """The JAX parameter tree (numpy or tensor leaves; lists, or flax's maps
    keyed "0", "1", ...) as the port's tree of tensors on ``device``."""
    if isinstance(tree, dict):
        keys = list(tree)
        if keys and keys == [str(i) for i in range(len(keys))]:
            return [params_from_jax(tree[k], device) for k in keys]
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device) for v in tree]
    t = tree if isinstance(tree, torch.Tensor) else torch.from_numpy(
        np.array(tree))
    return t if device is None else t.to(device)


def _state_dict(tree):
    """flax's state dict of a parameter tree: keys sorted (as a JAX pytree
    flattens a dict), lists as maps keyed "0", "1", ... in order."""
    if isinstance(tree, dict):
        return {k: _state_dict(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return {str(i): _state_dict(v) for i, v in enumerate(tree)}
    return tree


def save_checkpoint(path, params, cfg, *, epoch=0, step=0, extra=None):
    """Write a checkpoint directory (created if needed)."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config_to_json(cfg), f, indent=1)
    meta = {"epoch": int(epoch), "step": int(step)}
    if extra:
        meta.update(extra)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    with open(os.path.join(path, "params.msgpack"), "wb") as f:
        f.write(msgpack.packb(_state_dict(params)))
    return path


def load_checkpoint(path, device=None):
    """Load a checkpoint directory; parameters land on ``device``.

    Returns dict with keys: params, cfg, epoch, step, meta."""
    with open(os.path.join(path, "config.json")) as f:
        cfg = config_from_json(json.load(f))
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    with open(os.path.join(path, "params.msgpack"), "rb") as f:
        params = params_from_jax(msgpack.unpackb(f.read()), device)
    return {
        "params": params,
        "cfg": cfg,
        "epoch": meta.get("epoch", 0),
        "step": meta.get("step", 0),
        "meta": meta,
    }
