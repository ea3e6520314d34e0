"""The port's training pieces (train/, models dropout) against the JAX
package's, on the CPU.

Tolerances found at these sizes (float32; the two packages sum in other
orders): losses agree to 1e-6 relative, gradients to 1e-5 of the largest
gradient, parameters after three Adam steps to 1e-5 absolute.  Adam's
early updates are about lr * sign(g), so a gradient that differs in its
last bits moves a parameter by at most a few ulp more per step.
"""

import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_kaldi_asr_tpu.models.transformer import (
    init_transformer as jax_init,
    transformer_forward as jax_forward,
)
from pytorch_kaldi_asr_tpu.train import (
    average_params as jax_average,
    create_train_state as jax_state,
    cross_entropy_loss as jax_ce,
    make_train_step,
    save_checkpoint as jax_save,
)
from pytorch_kaldi_asr_tpu.train.loop import _fast_forward_counts
from pytorch_kaldi_asr_tpu.train.optim import make_optimizer as jax_optimizer
from pytorch_kaldi_asr_tpu_torch.data.loader import BatchLoader
from pytorch_kaldi_asr_tpu_torch.models.common import dropout
from pytorch_kaldi_asr_tpu_torch.models.transformer import tree_map
from pytorch_kaldi_asr_tpu_torch.train import (
    average_params,
    create_train_state,
    cross_entropy_loss,
    load_checkpoint,
    params_from_jax,
    save_checkpoint,
    train_model,
    train_step,
)
from pytorch_kaldi_asr_tpu_torch.train.optim import (
    fast_forward,
    named_leaves,
    set_learning_rate,
)
from tests.torch_port_helpers import configs, leaves, t

torch.set_num_threads(1)

LOSS_RTOL = 1e-6
GRAD_RTOL = 1e-5  # of the largest |gradient| of the leaf
PARAM_ATOL = 1e-5


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoothing", [False, True])
@pytest.mark.parametrize("extra", [None, "rows", "cells"])
def test_cross_entropy_matches_jax(smoothing, extra):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 5, 7)).astype(np.float32)
    goal = np.array([[4, 3, 0, 0, 0], [2, 6, 6, 1, 0], [5, 0, 0, 0, 0]],
                    np.int32)
    extra_mask = {None: None,
                  "rows": np.array([1, 0, 1], np.uint8),
                  "cells": (rng.random((3, 5)) > 0.3).astype(np.float32)}[extra]
    want = jax_ce(jnp.asarray(logits), jnp.asarray(goal), smoothing=smoothing,
                  extra_mask=None if extra_mask is None
                  else jnp.asarray(extra_mask))
    got = cross_entropy_loss(t(logits), t(goal), smoothing=smoothing,
                             extra_mask=None if extra_mask is None
                             else t(extra_mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-6)


# ---------------------------------------------------------------------------
# optimizer: schedule, Adam, frozen LDA
# ---------------------------------------------------------------------------


def _tiny_tree(rng):
    return {"encoder": {"lda": {"w": rng.normal(size=(3, 3)),
                                "b": rng.normal(size=(3,))},
                        "tdnn": [{"w": rng.normal(size=(3, 2))}]},
            "decoder": {"embed": rng.normal(size=(4, 2))}}


def test_adam_and_schedule_match_optax_over_three_steps():
    """soft 2 makes the hyperbolic decay steep (lr, lr*2/3, lr/2), so an
    off-by-one in the schedule's count shows; the LDA affine stays put."""
    rng = np.random.default_rng(1)
    tree = tree_map(lambda a: np.asarray(a, np.float32), _tiny_tree(rng))
    grads = [tree_map(lambda a: rng.normal(size=a.shape).astype(np.float32),
                      tree) for _ in range(3)]
    tx = jax_optimizer(tree, 0.01, 2.0)
    jparams, opt_state = tree, tx.init(tree)

    state = create_train_state(params_from_jax(tree), start_lr=0.01,
                               soft_coefficient=2.0)
    for g in grads:
        updates, opt_state = tx.update(g, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for (path, leaf), gl in zip(named_leaves(state.params),
                                    leaves(params_from_jax(g))):
            leaf.grad = None if "lda" in path else gl
        set_learning_rate(state.optimizer, state.schedule(state.step))
        state.optimizer.step()
        state.step += 1
        for a, b in zip(leaves(state.params), jax.tree_util.tree_leaves(
                jparams)):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       rtol=1e-6, atol=1e-7)
    assert state.schedule(0) == 0.01 and state.schedule(2) == 0.005
    np.testing.assert_array_equal(
        state.params["encoder"]["lda"]["w"].detach().numpy(),
        tree["encoder"]["lda"]["w"])


def test_fast_forward_matches_jax_fast_forward_counts():
    """A checkpoint without optimizer state resumes with fresh moments and
    every count at the global step, as the JAX loop does."""
    rng = np.random.default_rng(2)
    tree = {"w": rng.normal(size=(4,)).astype(np.float32)}
    g = {"w": rng.normal(size=(4,)).astype(np.float32)}
    tx = jax_optimizer(tree, 0.001, 3.0)
    opt_state = _fast_forward_counts(tx.init(tree), 7)
    updates, _ = tx.update(g, opt_state, tree)
    want = optax.apply_updates(tree, updates)["w"]

    state = create_train_state({"w": t(tree["w"])}, start_lr=0.001,
                               soft_coefficient=3.0)
    fast_forward(state.optimizer, 7)
    state.step = 7
    state.params["w"].grad = t(g["w"])
    set_learning_rate(state.optimizer, state.schedule(state.step))
    state.optimizer.step()
    np.testing.assert_allclose(state.params["w"].detach().numpy(),
                               np.asarray(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# dropout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rate", [0.1, 0.35, 0.5])
def test_dropout_statistics(rate):
    x = torch.ones(400, 500)
    y = dropout(x, rate, 3, train=True)
    q = round((1.0 - rate) * 256)
    kept = y != 0
    n = x.numel()
    p = q / 256
    assert abs(kept.float().mean().item() - p) <= 4 * np.sqrt(p * (1 - p) / n)
    assert torch.all(y[kept] == 256.0 / q)  # the scale, exactly


def test_dropout_identity_cases():
    x = torch.randn(8, 8)
    seed = 0
    assert dropout(x, 0.35, seed, train=False) is x
    assert dropout(x, 0.0, seed, train=True) is x
    assert dropout(x, 0.35, None, train=True) is x
    assert dropout(x, 0.001, seed, train=True) is x  # q rounds to 256


# ---------------------------------------------------------------------------
# three train steps against JAX make_train_step
# ---------------------------------------------------------------------------


def _toy_batch(cfg, b=4, s=10, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(b, s, cfg.src_dim)).astype(np.float32)
    src_mask = np.ones((b, s), np.uint8)
    src_mask[3, 6:] = 0
    tgt = np.array([[2, 4, 5, 6, 3, 0], [2, 6, 7, 8, 3, 0],
                    [2, 5, 4, 3, 0, 0], [2, 7, 3, 0, 0, 0]], np.int32)[:b]
    return src, src_mask, tgt, (tgt != 0).astype(np.uint8)


@pytest.mark.parametrize("encoder_type", ["banded", "tdnn"])
def test_three_train_steps_match_jax(encoder_type):
    jcfg, pcfg = configs(encoder_type=encoder_type)
    lda_mat = None
    if encoder_type == "tdnn":
        lda_in = jcfg.src_dim * len(jcfg.lda_context)
        lda_mat = np.random.default_rng(2).normal(size=(20, lda_in + 1)) * 0.2
    jparams = jax_init(jax.random.PRNGKey(0), jcfg, lda_mat)
    pparams = params_from_jax(jax.device_get(jparams))
    batch = _toy_batch(jcfg)

    # the first step's gradient, from the JAX forward's autodiff
    src, src_mask, tgt, tgt_mask = (jnp.asarray(x) for x in batch)

    def jax_loss(p):
        logits = jax_forward(p, jcfg, src, src_mask, tgt[:, :-1],
                             tgt_mask[:, :-1], train=True,
                             rng=jax.random.PRNGKey(1))
        return jax_ce(logits, tgt[:, 1:])[0]

    jgrads = jax.jit(jax.grad(jax_loss))(jparams)

    jstate, tx = jax_state(jparams, start_lr=0.01, soft_coefficient=2.0)
    jstep = make_train_step(jcfg, tx, donate=False)
    state = create_train_state(pparams, start_lr=0.01, soft_coefficient=2.0)
    lda_before = (None if encoder_type != "tdnn" else
                  state.params["encoder"]["lda"]["w"].detach().clone())
    for i in range(3):
        jstate, jm = jstep(jstate, *batch)
        m = train_step(state, pcfg, *(t(x) for x in batch))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
        assert float(m["n_correct"]) == float(jm["n_correct"])
        assert float(m["n_words"]) == float(jm["n_words"])
        if i == 0:
            for (path, leaf), g in zip(named_leaves(state.params),
                                       jax.tree_util.tree_leaves(jgrads)):
                if "lda" in path:
                    assert leaf.grad is None  # frozen: not even a gradient
                    continue
                g = np.asarray(g)
                np.testing.assert_allclose(
                    leaf.grad.numpy(), g,
                    atol=GRAD_RTOL * max(np.abs(g).max(), 1e-30),
                    err_msg=str(path))
    assert state.step == int(jstate.step) == 3
    for a, b in zip(leaves(state.params),
                    jax.tree_util.tree_leaves(jstate.params)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=PARAM_ATOL)
    if lda_before is not None:
        assert torch.equal(state.params["encoder"]["lda"]["w"], lda_before)


# ---------------------------------------------------------------------------
# checkpoints: optimizer state, resume, preemption, averaging
# ---------------------------------------------------------------------------


def test_opt_state_round_trip_resumes_exactly(tmp_path):
    _, pcfg = configs()
    batch = [t(x) for x in _toy_batch(pcfg)]
    init = params_from_jax(jax.device_get(
        jax_init(jax.random.PRNGKey(4), configs()[0])))

    straight = create_train_state(tree_map(torch.clone, init), seed=5)
    for _ in range(3):
        train_step(straight, pcfg, *batch)

    first = create_train_state(tree_map(torch.clone, init), seed=5)
    for _ in range(2):
        train_step(first, pcfg, *batch)
    save_checkpoint(str(tmp_path / "ck"), first.params, pcfg, epoch=1,
                    step=first.step, optimizer=first.optimizer)
    assert (tmp_path / "ck" / "opt_state.pt").exists()
    assert not (tmp_path / "ck" / "opt_state.msgpack").exists()
    ck = load_checkpoint(str(tmp_path / "ck"))
    resumed = create_train_state(ck["params"], seed=5)
    resumed.optimizer.load_state_dict(ck["opt_state"])
    resumed.step = ck["step"]
    train_step(resumed, pcfg, *batch)
    for a, b in zip(leaves(resumed.params), leaves(straight.params)):
        assert torch.equal(a, b)


def _triples(cfg, n, seed):
    rng = np.random.default_rng(seed)
    return [(f"u{i}", rng.normal(size=(8, cfg.src_dim)).astype(np.float32),
             np.array([2, 4, 5, 3])) for i in range(n)]


class _SignalAfterFirstBatch(BatchLoader):
    """A loader that sends the process SIGTERM once its first batch is out,
    as a preemption notice arriving mid-epoch (train_model's handler
    catches it)."""

    def __iter__(self):
        for i, batch in enumerate(super().__iter__()):
            yield batch
            # only into train_model's own handler, never the default action
            if i == 0 and callable(signal.getsignal(signal.SIGTERM)) \
                    and not getattr(self, "fired", False):
                self.fired = True
                os.kill(os.getpid(), signal.SIGTERM)


def test_preempt_snapshot_and_resume(tmp_path):
    jcfg, pcfg = configs()
    params = params_from_jax(jax.device_get(jax_init(jax.random.PRNGKey(3),
                                                     jcfg)))
    triples = _triples(pcfg, 12, 3)
    train = _SignalAfterFirstBatch(triples, batch_size=4, mode="drop")
    ev = BatchLoader(triples, batch_size=4, mode="all")
    mdir = tmp_path / "exp"
    handler = signal.getsignal(signal.SIGTERM)
    res = train_model(params, pcfg, train, ev, ev, str(mdir), epochs=3,
                      device="cpu")
    assert signal.getsignal(signal.SIGTERM) is handler  # restored
    assert res.preempted
    meta = json.loads((mdir / "preempt" / "meta.json").read_text())
    # the signal lands after the first update; the next batch is not begun
    assert (meta["epoch"], meta["step"], meta["preempted_in_epoch"]) == \
        (0, 1, 1)
    assert (mdir / "preempt" / "opt_state.pt").exists()

    res = train_model(params, pcfg, BatchLoader(triples, 4, mode="drop"), ev,
                      ev, str(mdir), epochs=2, resume=True, device="cpu",
                      metrics_path=str(mdir / "metrics.jsonl"))
    assert not res.preempted and res.best_epoch in (1, 2)
    records = [json.loads(x) for x in open(mdir / "metrics.jsonl")]
    assert [r["step"] for r in records] == [1 + 3, 1 + 6]
    assert sorted(p for p in os.listdir(mdir) if p.startswith("epoch.")) == \
        ["epoch.1", "epoch.2"]


def test_resume_from_a_jax_checkpoint_fast_forwards(tmp_path):
    """A JAX-written epoch checkpoint (no opt_state.pt) resumes at its step
    with fresh Adam moments."""
    jcfg, pcfg = configs()
    jparams = jax_init(jax.random.PRNGKey(6), jcfg)
    mdir = tmp_path / "exp"
    jax_save(str(mdir / "epoch.1"), jparams, jcfg, epoch=1, step=40,
             extra={"dev_accu": 0.0})
    triples = _triples(pcfg, 8, 6)
    loader = BatchLoader(triples, batch_size=4, mode="drop")
    res = train_model(None, pcfg, loader, loader, loader, str(mdir), epochs=2,
                      resume=True, device="cpu",
                      metrics_path=str(mdir / "metrics.jsonl"))
    record = json.loads(open(mdir / "metrics.jsonl").read())
    assert (record["epoch"], record["step"]) == (2, 42)
    assert res.best_epoch in (1, 2) and not res.preempted
    assert (mdir / "epoch.2" / "opt_state.pt").exists()


def test_average_params_matches_jax():
    jcfg, _ = configs()
    trees = [jax_init(jax.random.PRNGKey(i), jcfg) for i in range(3)]
    ported = [params_from_jax(jax.device_get(x)) for x in trees]
    mean = average_params(ported)
    for a, b in zip(leaves(mean), jax.tree_util.tree_leaves(
            jax_average(trees))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    running, jrunning = ported[0], trees[0]
    for i in (1, 2):
        running = average_params(running=running, new=ported[i], count=i)
        jrunning = jax_average(running=jrunning, new=trees[i], count=i)
    for a, b in zip(leaves(running), jax.tree_util.tree_leaves(jrunning)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


# ---------------------------------------------------------------------------
# loader workers, metrics logging
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["drop", "all"])
def test_loader_workers_keep_content_and_order(mode):
    """-loader_workers > 1 hands over the same batches in the same order,
    as the JAX package's ordered thread pool does."""
    from pytorch_kaldi_asr_tpu.data.loader import BatchLoader as JaxLoader

    _, pcfg = configs()
    rng = np.random.default_rng(8)
    triples = [(f"u{i}", rng.normal(size=(int(rng.integers(5, 30)),
                                          pcfg.src_dim)).astype(np.float32),
                np.array([2] + list(rng.integers(4, 9, size=3)) + [3]))
               for i in range(23)]
    kw = dict(batch_size=4, mode=mode, num_buckets=3, seed=5)
    one = list(BatchLoader(triples, **kw))
    many = list(BatchLoader(triples, num_workers=3, **kw))
    jax_many = list(JaxLoader(triples, num_workers=3, **kw))
    assert len(one) == len(many) == len(jax_many) > 4
    for a, b, c in zip(one, many, jax_many):
        assert a.keys == b.keys == c.keys
        for x, y, z in zip(a[1:], b[1:], c[1:]):
            np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(x, z)


def test_stage_timer_and_metrics_logger(tmp_path):
    from pytorch_kaldi_asr_tpu_torch.utils.metrics import (
        MetricsLogger,
        StageTimer,
    )

    timer = StageTimer()
    for _ in range(3):
        with timer.stage("step"):
            pass
    summary = timer.summary()
    assert summary["step"]["calls"] == 3 and summary["step"]["total_s"] >= 0
    with MetricsLogger(str(tmp_path / "m" / "metrics.jsonl")) as log:
        log.log(epoch=1, loss=np.float32(0.5))
        log.log(epoch=2, loss=0.25, ts=7.0)
    records = [json.loads(x) for x in open(tmp_path / "m" / "metrics.jsonl")]
    assert [r["epoch"] for r in records] == [1, 2]
    assert records[0]["loss"] == 0.5 and records[1]["ts"] == 7.0
