"""Epoch driver: the JAX package's ``train/loop.py`` control flow (the
reference's train()/combine()) over the port's eager steps.

Cadence kept: per epoch, a full train pass, then eval on 10 train batches,
full dev, full test; the best model is tracked by dev token accuracy;
checkpoints are written every ``save_interval`` epochs plus every epoch in
the final window; combining averages up to 30 checkpoints counting down
from the best epoch and keeps the prefix average with the best accuracy.
Checkpoint names, ``meta.json`` fields and ``metrics.jsonl`` records are
the JAX package's: ``epoch.N``, ``preempt``, ``best.epoch{N}.accu{XX.XX}``,
``combined.accu{XX.XX}``."""

from __future__ import annotations

import glob
import os
import signal
import time
from typing import Any, NamedTuple

from pytorch_kaldi_asr_tpu_torch.data.loader import to_device
from pytorch_kaldi_asr_tpu_torch.models.transformer import (
    compute_dtype,
    tree_map,
)
from pytorch_kaldi_asr_tpu_torch.train.checkpoint import (
    average_params,
    load_checkpoint,
    read_checkpoint_config,
    save_checkpoint,
)
from pytorch_kaldi_asr_tpu_torch.train.optim import fast_forward
from pytorch_kaldi_asr_tpu_torch.train.state import (
    create_train_state,
    eval_step,
    train_step,
)
from pytorch_kaldi_asr_tpu_torch.utils.logging import info, procedure, warning
from pytorch_kaldi_asr_tpu_torch.utils.metrics import MetricsLogger

EVAL_TRAIN_BATCHES = 10  # the reference evaluates 10 train batches per epoch


def _sum_metrics(totals, metrics):
    return dict(metrics) if totals is None else {
        k: totals[k] + metrics[k] for k in totals}


def _per_word(totals):
    """(loss per word, accuracy) from summed metrics, read from the device
    once."""
    if totals is None:
        return 0.0, 0.0
    words = max(float(totals["n_words"]), 1.0)
    return float(totals["loss"]) / words, float(totals["n_correct"]) / words


def run_train_epoch(state, cfg, loader, device, *, smoothing=False,
                    stop_flag=None):
    """One full training pass over ``loader``, updating ``state`` in place;
    returns (loss per word, accuracy).  The metric sums stay on the device
    until the pass ends.  ``stop_flag`` (a callable) ends the pass after
    the current batch: the preemption hook.  In bfloat16 compute the
    features go to the device as bfloat16, as the JAX package's loop sends
    them: every encoder casts them there first, so the step's numbers are
    the same and the copy half the bytes."""
    src_dtype = compute_dtype(cfg)
    totals = None
    for batch in loader:
        if stop_flag is not None and stop_flag():
            break
        b = to_device(batch, device, src_dtype)
        totals = _sum_metrics(totals, train_step(
            state, cfg, b.src, b.src_mask, b.tgt, b.tgt_mask,
            smoothing=smoothing))
    return _per_word(totals)


def run_eval(params, cfg, loader, device, max_batches=None):
    """Evaluation pass; respects the loader's ``valid`` tail mask.
    ``max_batches`` implements the reference's train-set eval."""
    totals = None
    for i, batch in enumerate(loader):
        b = to_device(batch, device)
        totals = _sum_metrics(totals, eval_step(
            params, cfg, b.src, b.src_mask, b.tgt, b.tgt_mask, b.valid))
        if max_batches is not None and i + 1 >= max_batches:
            break
    return _per_word(totals)


def latest_epoch_checkpoint(save_model_dir):
    """(path, epoch) of the newest epoch.N checkpoint dir, or (None, 0)."""
    best = (None, 0)
    if os.path.isdir(save_model_dir):
        for name in os.listdir(save_model_dir):
            if name.startswith("epoch.") and name[6:].isdigit():
                e = int(name[6:])
                if e > best[1]:
                    best = (os.path.join(save_model_dir, name), e)
    return best


class TrainResult(NamedTuple):
    """What train_model hands back.  ``preempted`` means the run stopped
    on the preemption signal after saving the ``preempt`` checkpoint: the
    caller skips post-training work and exits with PREEMPT_EXIT_CODE."""

    best_params: Any
    best_epoch: int
    best_accu: float
    preempted: bool


def _host_copy(params):
    return tree_map(lambda t: t.detach().to("cpu", copy=True), params)


def _resume_point(save_model_dir):
    """(checkpoint path, its epoch) to resume from: the newest epoch.N, or
    the preempt snapshot when it is at least as new."""
    path, last_epoch = latest_epoch_checkpoint(save_model_dir)
    preempt_path = os.path.join(save_model_dir, "preempt")
    if os.path.isdir(preempt_path):
        _, pmeta = read_checkpoint_config(preempt_path)
        if path is None or pmeta.get("epoch", -1) >= last_epoch:
            path, last_epoch = preempt_path, pmeta.get("epoch", 0)
            info("found preemption checkpoint (interrupted epoch %d)",
                 last_epoch + 1)
    return path, last_epoch


def _best_so_far(save_model_dir):
    """(dev accuracy, epoch) of the best epoch.N checkpoint written before a
    resume, from the dev_accu each one records; (-1.0, None) if none."""
    best_accu, best_epoch = -1.0, None
    for name in os.listdir(save_model_dir):
        if not (name.startswith("epoch.") and name[6:].isdigit()):
            continue
        try:
            _, meta = read_checkpoint_config(os.path.join(save_model_dir,
                                                          name))
        except (OSError, ValueError):
            continue
        accu = meta.get("dev_accu")
        if accu is not None and accu > best_accu:
            best_accu, best_epoch = accu, int(name[6:])
    return best_accu, best_epoch


def train_model(params, cfg, train_loader, dev_loader, test_loader,
                save_model_dir, *, epochs=500, start_lr=0.001,
                soft_coefficient=25000.0, save_interval=1, smoothing=False,
                seed=0, resume=False, metrics_path=None, device="cuda"):
    """Full training driver on ``device``; returns a ``TrainResult``.

    ``resume=True`` continues from the newest epoch.N checkpoint or the
    newer preempt snapshot: params, Adam state (``opt_state.pt``) and step.
    A checkpoint without ``opt_state.pt`` (one written by the JAX package)
    resumes with fresh Adam moments and the step, so the LR schedule and
    Adam's bias corrections continue from the global step.

    SIGTERM arms preemption: training stops before the next batch and
    saves a ``preempt`` checkpoint (params, optimizer state, global step).
    The previous handler is restored on return.  Off the main thread no
    handler can be installed, and the run has no preemption hook."""
    os.makedirs(save_model_dir, exist_ok=True)
    preempted = {"flag": False}

    def _on_preempt(_sig, _frame):
        warning("preemption signal received: will checkpoint after the "
                "current batch")
        preempted["flag"] = True

    try:
        previous, installed = signal.signal(signal.SIGTERM, _on_preempt), True
    except ValueError:  # not the main thread
        previous, installed = None, False
    try:
        return _train(params, cfg, train_loader, dev_loader, test_loader,
                      save_model_dir, preempted, epochs=epochs,
                      start_lr=start_lr, soft_coefficient=soft_coefficient,
                      save_interval=save_interval, smoothing=smoothing,
                      seed=seed, resume=resume, metrics_path=metrics_path,
                      device=device)
    finally:
        if installed:
            signal.signal(signal.SIGTERM, previous)


def _train(params, cfg, train_loader, dev_loader, test_loader, save_model_dir,
           preempted, *, epochs, start_lr, soft_coefficient, save_interval,
           smoothing, seed, resume, metrics_path, device):
    opts = dict(start_lr=start_lr, soft_coefficient=soft_coefficient,
                seed=seed)
    start_epoch = 1
    resumed_epoch = 0
    state = None
    if resume:
        path, last_epoch = _resume_point(save_model_dir)
        if path is not None:
            ckpt = load_checkpoint(path, device=device)
            state = create_train_state(ckpt["params"], **opts)
            if ckpt["opt_state"] is not None:
                state.optimizer.load_state_dict(ckpt["opt_state"])
            else:
                warning("%s has no opt_state.pt: Adam moments reset; LR "
                        "schedule fast-forwarded to step %d", path,
                        ckpt["step"])
                fast_forward(state.optimizer, ckpt["step"])
            state.step = int(ckpt["step"])
            start_epoch = last_epoch + 1
            resumed_epoch = last_epoch
            info("resuming from %s (epoch %d, step %d)", path, last_epoch,
                 ckpt["step"])
    if state is None:
        state = create_train_state(
            tree_map(lambda t: t.detach().to(device, copy=True), params),
            **opts)

    metrics = MetricsLogger(metrics_path) if metrics_path else None

    # start below zero so the first epoch always becomes the initial best;
    # when resuming, re-establish the pre-interruption best from the
    # dev_accu each epoch checkpoint records
    best_accu, best_epoch = -1.0, resumed_epoch
    best_params = _host_copy(state.params) if resumed_epoch else params
    if resumed_epoch:
        accu, epoch = _best_so_far(save_model_dir)
        if epoch is not None:
            best_accu, best_epoch = accu, epoch
            best_params = load_checkpoint(os.path.join(
                save_model_dir, f"epoch.{epoch}"))["params"]
            info("restored best-so-far from epoch %d (dev accu %3.2f %%)",
                 best_epoch, 100 * best_accu)

    train_start = time.time()
    for epoch in range(start_epoch, epochs + 1):
        info("trainning epoch %d.", epoch)
        start = time.time()
        loss, accu = run_train_epoch(state, cfg, train_loader, device,
                                     smoothing=smoothing,
                                     stop_flag=lambda: preempted["flag"])
        if preempted["flag"]:
            ppath = os.path.join(save_model_dir, "preempt")
            save_checkpoint(
                ppath, state.params, cfg, epoch=epoch - 1, step=state.step,
                optimizer=state.optimizer,
                extra={"preempted_in_epoch": epoch})
            info("preempted: saved %s at step %d (epoch %d interrupted); "
                 "rerun with -resume to continue", ppath, state.step, epoch)
            if best_accu < 0:
                best_params = _host_copy(state.params)
                best_epoch = max(epoch - 1, 0)
            break
        info("-----(Training)----- accuracy: %3.2f %%, elapse: %3.2f min",
             100 * accu, (time.time() - start) / 60)

        _, tr_accu = run_eval(state.params, cfg, train_loader, device,
                              max_batches=EVAL_TRAIN_BATCHES)
        info("-----(evaluating train set for %d batch)----- accuracy: "
             "%3.2f %%", EVAL_TRAIN_BATCHES, 100 * tr_accu)
        _, dev_accu = run_eval(state.params, cfg, dev_loader, device)
        info("-----(evaluating dev set)----- accuracy: %3.2f %%",
             100 * dev_accu)
        if dev_accu > best_accu:
            best_accu, best_epoch = dev_accu, epoch
            best_params = _host_copy(state.params)
        _, test_accu = run_eval(state.params, cfg, test_loader, device)
        info("-----(evaluating test set)----- accuracy: %3.2f %%",
             100 * test_accu)

        if metrics is not None:
            metrics.log(epoch=epoch, step=state.step, train_loss=loss,
                        train_accu=accu, dev_accu=dev_accu,
                        test_accu=test_accu)
        if epoch % save_interval == 0 or epochs - epoch < save_interval:
            path = os.path.join(save_model_dir, f"epoch.{epoch}")
            save_checkpoint(
                path, state.params, cfg, epoch=epoch, step=state.step,
                optimizer=state.optimizer,
                extra={"dev_accu": float(dev_accu)})
            info("checkpoint of epoch %d is saved to %s", epoch, path)

    info("trainning finish. time consume: %3.2f minute; best valid accuracy: "
         "%3.2f %%, on epoch %d", (time.time() - train_start) / 60,
         100 * best_accu, best_epoch)
    best_path = os.path.join(
        save_model_dir, f"best.epoch{best_epoch}.accu{100 * best_accu:3.2f}")
    save_checkpoint(best_path, best_params, cfg, epoch=best_epoch,
                    extra={"dev_accu": best_accu})
    info("best model is saved to %s", best_path)
    if metrics is not None:
        metrics.close()
    return TrainResult(best_params, best_epoch, best_accu, preempted["flag"])


def combine_checkpoints(save_model_dir, best_epoch=None, cfg=None,
                        eval_loader=None, *, num_model=30, paths=None,
                        device="cuda"):
    """Progressive checkpoint averaging: average epochs ``best_epoch,
    best_epoch-1, ...`` (or an explicit ``paths`` list, best first),
    evaluating each prefix average on ``eval_loader`` and keeping the best.
    Saves ``combined.accuXX`` under ``save_model_dir`` and returns
    (params, accu, path)."""
    procedure("combining model with model averaging...")
    if paths is not None:
        candidates = list(paths)
    else:
        candidates = []
        for e in range(best_epoch, max(best_epoch - num_model, 0), -1):
            path = os.path.join(save_model_dir, f"epoch.{e}")
            if os.path.isdir(path):
                candidates.append(path)
        if not os.path.isdir(os.path.join(save_model_dir,
                                          f"epoch.{best_epoch}")):
            # save_interval > 1 can leave the best epoch unsaved; the
            # best.epochN.* checkpoint carries its parameters
            best_saved = sorted(glob.glob(
                os.path.join(save_model_dir, f"best.epoch{best_epoch}.*")))
            if best_saved:
                candidates.insert(0, best_saved[-1])
            else:
                warning("epoch.%d (the best epoch) has no checkpoint; "
                        "averaging the %d nearest saved epochs instead",
                        best_epoch, len(candidates))
    if not candidates:
        raise FileNotFoundError(f"no epoch.* checkpoints under "
                                f"{save_model_dir}")
    info("model loaded (%d candidates)", len(candidates))

    best_accu, best_params, running = -1.0, None, None
    for i, path in enumerate(candidates):
        params = load_checkpoint(path, device=device)["params"]
        running = params if i == 0 else average_params(
            running=running, new=params, count=i)
        info("averaging %d models", i + 1)
        _, accu = run_eval(running, cfg, eval_loader, device)
        info("-----(evaluating combining set)----- accuracy: %3.2f %%",
             100 * accu)
        if accu > best_accu:
            best_accu, best_params = accu, running

    info("best combined model with accuracy: %3.2f %%", 100 * best_accu)
    out = os.path.join(save_model_dir, f"combined.accu{100 * best_accu:3.2f}")
    save_checkpoint(out, best_params, cfg, extra={"combined_accu": best_accu})
    return best_params, best_accu, out
