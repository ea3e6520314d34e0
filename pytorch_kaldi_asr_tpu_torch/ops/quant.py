"""Weight-only int8 for decoding: every float leaf with ndim >= 2 and at
least ``min_size`` entries (the matmul weights) is stored as int8 with a
symmetric per-output-channel scale over the last axis (``max|w| / 127``),
the JAX package's ``ops/quant.py``.  Biases, layer-norm gains and small
tables stay exact.

A quantized leaf is the dict ``{"q8": int8, "scale": float32}``, as in the
JAX package, so :func:`tree_bytes` counts what the JAX package counts.
:func:`quantize_array` and :func:`quantize_tree` are the JAX package's
numpy code, so the int8 values and the scales are bit-identical to its.
:func:`dequantize_tree` computes ``q8.to(dtype) * scale`` on the leaves'
device; the decode runs it once per search call (decode/runner.py), the
scope of the JAX package's ``quantized_search_fn``.
"""

from __future__ import annotations

import numpy as np
import torch


def _is_quant(leaf):
    return isinstance(leaf, dict) and set(leaf) == {"q8", "scale"}


def quantize_array(w):
    """Symmetric per-output-channel (last axis) int8 quantization of a
    numpy array: the quantized-leaf dict of numpy arrays."""
    w = np.asarray(w)
    reduce_axes = tuple(range(w.ndim - 1))
    amax = np.max(np.abs(w), axis=reduce_axes)
    # exact-zero channels quantize to all-zero q with scale 1 (no inf/nan)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.rint(w / scale), -127, 127).astype(np.int8)
    return {"q8": q, "scale": scale}


def quantize_tree(params, *, min_size=1024):
    """Quantize every float leaf with ndim >= 2 and size >= min_size of a
    tree of tensors; the int8 leaves land on the device of the leaf they
    replace.  Returns (quantized tree, number of quantized leaves)."""
    n = 0

    def visit(tree):
        nonlocal n
        if isinstance(tree, dict):
            return {k: visit(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [visit(v) for v in tree]
        if tree.is_floating_point() and tree.dim() >= 2 \
                and tree.numel() >= min_size:
            n += 1
            leaf = quantize_array(tree.detach().cpu().numpy())
            return {k: torch.from_numpy(v).to(tree.device)
                    for k, v in leaf.items()}
        return tree

    out = visit(params)
    return out, n


def dequantize_tree(params, dtype=torch.float32):
    """The float tree of a (possibly partially) quantized one, computed on
    the leaves' device."""
    if _is_quant(params):
        return params["q8"].to(dtype) * params["scale"].to(dtype)
    if isinstance(params, dict):
        return {k: dequantize_tree(v, dtype) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [dequantize_tree(v, dtype) for v in params]
    return params


def tree_bytes(params):
    """Total parameter bytes (a quantized leaf counts its int8 and its
    scale)."""
    if isinstance(params, dict):
        return sum(tree_bytes(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(tree_bytes(v) for v in params)
    return params.numel() * params.element_size()
