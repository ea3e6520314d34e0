"""Optimizer and LR schedule: the reference's Adam(0.9, 0.999, eps 1e-8)
under the per-step hyperbolic decay ``lr(k) = start_lr * soft / (k + soft)``
(not Noam), with k = 0 at the first update, as the JAX package's optax
chain counts.  The LDA affine of the ``tdnn`` encoder is frozen: it is left
out of the optimizer and never receives an update."""

from __future__ import annotations

import torch


def hyperbolic_schedule(start_lr=0.001, soft_coefficient=25000.0):
    """lr(step) = start_lr * soft / (step + soft)."""

    def schedule(step):
        return start_lr * soft_coefficient / (step + soft_coefficient)

    return schedule


def is_frozen(path):
    """True for the leaves under the encoder's ``lda`` affine."""
    return "lda" in path


def named_leaves(tree, path=()):
    """(path, tensor) of every leaf, in the JAX package's flattening order
    (dict keys sorted, lists in order)."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from named_leaves(tree[key], path + (key,))
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            yield from named_leaves(value, path + (i,))
    else:
        yield path, tree


def trainable_leaves(params):
    """The leaves the optimizer updates, in flattening order."""
    return [t for path, t in named_leaves(params) if not is_frozen(path)]


def make_optimizer(params, start_lr=0.001):
    """Adam(0.9, 0.999, eps 1e-8) over the trainable leaves of ``params``;
    its learning rate is set before each update by
    :func:`set_learning_rate`."""
    return torch.optim.Adam(trainable_leaves(params), lr=start_lr,
                            betas=(0.9, 0.999), eps=1e-8)


def set_learning_rate(optimizer, lr):
    for group in optimizer.param_groups:
        group["lr"] = lr


def fast_forward(optimizer, step):
    """Fresh Adam moments whose step count is ``step``: the resume of a
    checkpoint without optimizer state, as the JAX package fast-forwards
    every optax count (loop.py ``_fast_forward_counts``) — the bias
    corrections continue from the global step, and the LR schedule, which
    the train state counts, does too."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            optimizer.state[p] = {
                "step": torch.tensor(float(step)),
                "exp_avg": torch.zeros_like(p,
                                            memory_format=torch.preserve_format),
                "exp_avg_sq": torch.zeros_like(
                    p, memory_format=torch.preserve_format),
            }
