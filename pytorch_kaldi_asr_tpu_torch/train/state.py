"""Train state and the train and eval steps (the JAX package's
``train/state.py``, eagerly).

A step shifts the targets for teacher forcing (goal = tgt[:, 1:], decoder
input = tgt[:, :-1]), runs the model's training branch, sums the CE loss,
backpropagates through it (the banded encoder's attention through the
K2a/K2b/K2c kernels on the card) and applies Adam at the step's learning
rate.  Metrics come back as 0-d tensors on the device: the caller sums
them and reads them once, so no step waits for the card.  The step's
dropout randomness is a pure function of (seed, step), as the JAX
package's ``fold_in(rng, step)`` is, so a resumed run draws what the
uninterrupted run would have drawn."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pytorch_kaldi_asr_tpu_torch.models.common import DropoutRngs
from pytorch_kaldi_asr_tpu_torch.models.transformer import transformer_forward
from pytorch_kaldi_asr_tpu_torch.ops.specaugment import spec_augment
from pytorch_kaldi_asr_tpu_torch.parallel.collectives import (
    all_reduce_,
    all_reduce_tensors_,
    tensor_parallel,
)
from pytorch_kaldi_asr_tpu_torch.parallel.sequence import per_shard_rng
from pytorch_kaldi_asr_tpu_torch.train.loss import cross_entropy_loss
from pytorch_kaldi_asr_tpu_torch.train.optim import (
    hyperbolic_schedule,
    make_optimizer,
    set_learning_rate,
    trainable_leaves,
)


@dataclasses.dataclass
class TrainState:
    """``params`` (a tree of tensors on the training device; the trainable
    leaves require grad), the Adam ``optimizer`` over them, the number of
    updates taken (``step``), the dropout ``seed`` and the LR schedule."""

    params: dict
    optimizer: torch.optim.Optimizer
    step: int
    seed: int
    schedule: object


def create_train_state(params, *, start_lr=0.001, soft_coefficient=25000.0,
                       seed=0):
    """A fresh state at step 0 over ``params`` (used in place)."""
    for leaf in trainable_leaves(params):
        leaf.requires_grad_(True)
    return TrainState(params, make_optimizer(params, start_lr), 0, int(seed),
                      hyperbolic_schedule(start_lr, soft_coefficient))


def step_rngs(seed, step):
    """The dropout randomness of update ``step`` under ``seed``: a CPU
    generator of the per-site kernel seeds, seeded from (seed, step) on the
    host, so the same step draws the same masks on every device."""
    mixed = int(np.random.SeedSequence([int(seed), int(step)])
                .generate_state(1, np.uint64)[0] >> 1)
    return DropoutRngs(torch.Generator().manual_seed(mixed ^ 0x5DEECE66D))


def shift_for_teacher_forcing(tgt, tgt_mask):
    """(decoder input, its mask, goal) = (tgt[:, :-1], mask[:, :-1],
    tgt[:, 1:])."""
    return tgt[:, :-1], tgt_mask[:, :-1], tgt[:, 1:]


def loss_and_metrics(params, cfg, src, src_mask, tgt, tgt_mask, *,
                     train=False, rngs=None, smoothing=False,
                     extra_mask=None):
    """(loss_sum, n_correct, n_words) of the teacher-forced forward."""
    tgt_in, tgt_in_mask, goal = shift_for_teacher_forcing(tgt, tgt_mask)
    logits = transformer_forward(params, cfg, src, src_mask, tgt_in,
                                 tgt_in_mask, train=train, rngs=rngs)
    return cross_entropy_loss(logits, goal, smoothing=smoothing,
                              extra_mask=extra_mask)


def sum_grads(params, axis):
    """Sum every trainable leaf's gradient over ``axis`` in place (one
    all_reduce per dtype); a leaf with no gradient takes part as zeros, so
    every rank reduces the same list."""
    leaves = trainable_leaves(params)
    for leaf in leaves:
        if leaf.grad is None:
            leaf.grad = torch.zeros_like(leaf)
    all_reduce_tensors_([leaf.grad for leaf in leaves], axis)


def _data_rngs(rngs, mesh):
    """The step's randomness for this rank's rows: with the batch split
    over ``data``, each data rank draws its own stream (the ``model``
    ranks of one row block share it)."""
    if mesh is None or mesh.size("data") == 1:
        return rngs
    return per_shard_rng(rngs, mesh.index("data"))


def train_step(state, cfg, src, src_mask, tgt, tgt_mask, *, smoothing=False,
               specaugment=False, mesh=None):
    """One update of ``state`` in place.  Returns the step's metrics
    ({loss, n_correct, n_words}, detached, on the device).  With
    ``specaugment`` the features are masked first (ops/specaugment.py, the
    JAX package's defaults), from the step's generator before it draws the
    dropout seeds.

    With a ``("data", "model")`` ``mesh`` (parallel/mesh.py) the arrays are
    this rank's rows (``shard_batch_arrays``) and ``state.params`` its
    slices (``shard_params``): the forward runs tensor-parallel over
    ``model``, the gradients of the summed loss are summed over ``data``
    (the global batch's gradient), and the metrics are the global
    batch's."""
    rngs = _data_rngs(step_rngs(state.seed, state.step), mesh)
    if specaugment:
        src = spec_augment(rngs.seeds, src, src_mask)
    with tensor_parallel(None if mesh is None else mesh.axis("model")):
        loss, n_correct, n_words = loss_and_metrics(
            state.params, cfg, src, src_mask, tgt, tgt_mask, train=True,
            rngs=rngs, smoothing=smoothing)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    metrics = {"loss": loss.detach(), "n_correct": n_correct,
               "n_words": n_words}
    if mesh is not None:
        sum_grads(state.params, mesh.axis("data"))
        metrics = _sum_metrics(metrics, mesh)
    set_learning_rate(state.optimizer, state.schedule(state.step))
    state.optimizer.step()
    state.step += 1
    return metrics


def _sum_metrics(metrics, mesh):
    values = torch.stack([metrics[k].float() for k in sorted(metrics)])
    all_reduce_(values, mesh.axis("data"))
    return dict(zip(sorted(metrics), values))


@torch.no_grad()
def eval_step(params, cfg, src, src_mask, tgt, tgt_mask, valid,
              smoothing=False, mesh=None):
    """Metrics of the inference forward; ``valid`` excludes the loader's
    padded tail rows.  With a ``mesh``, as :func:`train_step`: this rank's
    rows and parameter slices, the global batch's metrics."""
    with tensor_parallel(None if mesh is None else mesh.axis("model")):
        loss, n_correct, n_words = loss_and_metrics(
            params, cfg, src, src_mask, tgt, tgt_mask, smoothing=smoothing,
            extra_mask=valid)
    metrics = {"loss": loss, "n_correct": n_correct, "n_words": n_words}
    return metrics if mesh is None else _sum_metrics(metrics, mesh)
