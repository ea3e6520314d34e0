"""Checkpoints in the JAX package's on-disk layout.

A checkpoint is a directory::

    <name>/
      config.json       # TransformerConfig fields
      meta.json         # epoch, step, user extras
      params.msgpack    # flax-serialized parameter tree
      opt_state.pt      # optional: the port's Adam state (torch.save)

``params.msgpack`` is read and written with the port's own msgpack codec
(utils/msgpack.py): flax's layout, with lists stored as maps keyed "0",
"1", ....  A checkpoint written by the JAX package's ``save_checkpoint``
loads here bit for bit, and one written here loads there.  Optimizer state
is port-native: ``opt_state.pt`` holds ``torch.optim.Adam.state_dict()``;
the JAX package's ``opt_state.msgpack`` (optax's tree) is neither read nor
written, so a JAX checkpoint resumes here with fresh Adam moments and the
step carried over (train/loop.py).
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


OPT_STATE_FILE = "opt_state.pt"


def save_checkpoint(path, params, cfg, *, epoch=0, step=0, optimizer=None,
                    extra=None):
    """Write a checkpoint directory (created if needed); with
    ``optimizer``, its state goes to ``opt_state.pt``."""
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
    if optimizer is not None:
        torch.save(optimizer.state_dict(), os.path.join(path, OPT_STATE_FILE))
    return path


def read_checkpoint_config(path):
    """Just the (cfg, meta) of a checkpoint, without reading parameters."""
    with open(os.path.join(path, "config.json")) as f:
        cfg = config_from_json(json.load(f))
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    return cfg, meta


def load_checkpoint(path, device=None):
    """Load a checkpoint directory; parameters land on ``device``.

    Returns dict with keys: params, cfg, epoch, step, meta, opt_state (the
    optimizer's state dict from ``opt_state.pt``, or None)."""
    cfg, meta = read_checkpoint_config(path)
    with open(os.path.join(path, "params.msgpack"), "rb") as f:
        params = params_from_jax(msgpack.unpackb(f.read()), device)
    opt_path = os.path.join(path, OPT_STATE_FILE)
    opt_state = (torch.load(opt_path, map_location="cpu", weights_only=True)
                 if os.path.exists(opt_path) else None)
    return {
        "params": params,
        "cfg": cfg,
        "epoch": meta.get("epoch", 0),
        "step": meta.get("step", 0),
        "meta": meta,
        "opt_state": opt_state,
    }


def average_params(params_list=None, *, running=None, new=None, count=None):
    """Parameter averaging, as the JAX package's:
    ``average_params([p1, p2, ...])`` is the arithmetic mean of a list;
    ``average_params(running=r, new=p, count=i)`` the progressive update
    ``r * (1 - 1/(i+1)) + p * (1/(i+1))``, where ``count`` models are
    already in ``running``."""
    if params_list is not None:
        n = len(params_list)
        return _zip_map(lambda *xs: sum(xs) / n, *params_list)
    factor = 1.0 / (count + 1)
    return _zip_map(lambda r, p: r * (1.0 - factor) + p * factor, running,
                    new)


def _zip_map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _zip_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return [_zip_map(fn, *xs) for xs in zip(*trees)]
    return fn(*(t.detach() for t in trees))
