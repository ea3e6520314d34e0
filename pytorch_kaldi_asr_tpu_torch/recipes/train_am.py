"""Hybrid AM training entry point: feats + frame alignments → posterior
model (the port's ``pytorch_kaldi_asr_tpu.recipes.train_am``), on the
card.

Alignments are a ``key id id ...`` text table (the shape of Kaldi
``ali-to-pdf | copy-int-vector ark,t:-`` output).  Same flags as the JAX
CLI plus ``-device`` (``cuda`` by default; ``cpu`` on request; without a
visible card and without ``-device cpu`` it raises rather than fall
back).  The step is the frame-level cross entropy of models/am.py under
Adam with the hyperbolic schedule over every leaf, as the JAX CLI's optax
chain; the ``tdnnf`` encoder takes a ``semi_orthogonal_step`` every 4
updates; ``-specaugment`` masks the features inside every step
(ops/specaugment.py).  The dropout masks and SpecAugment's come from the
port's per-step generator (train/state.py ``step_rngs``), not from
``jax.random``.  ``-seq_shards`` above 1 (sequence parallelism) is not
ported yet (ROADMAP.md, queue 1 item 12): on one card the recipe trains
with ``seq_shards`` 1, the JAX CLI's single-device branch."""

import argparse
import os

import numpy as np
import torch

from pytorch_kaldi_asr_tpu_torch.data.loader import BatchLoader, to_device
from pytorch_kaldi_asr_tpu_torch.io import kaldi_io
from pytorch_kaldi_asr_tpu_torch.models import am
from pytorch_kaldi_asr_tpu_torch.models.encoders import semi_orthogonal_step
from pytorch_kaldi_asr_tpu_torch.models.transformer import (
    TransformerConfig,
    tree_map,
)
from pytorch_kaldi_asr_tpu_torch.ops.launches import log_launch_counts
from pytorch_kaldi_asr_tpu_torch.ops.specaugment import spec_augment
from pytorch_kaldi_asr_tpu_torch.recipes.initialize_model import str2tuple
from pytorch_kaldi_asr_tpu_torch.train.checkpoint import save_checkpoint
from pytorch_kaldi_asr_tpu_torch.train.optim import (
    hyperbolic_schedule,
    named_leaves,
    set_learning_rate,
)
from pytorch_kaldi_asr_tpu_torch.train.state import TrainState, step_rngs
from pytorch_kaldi_asr_tpu_torch.utils.device import disable_tf32, resolve_device
from pytorch_kaldi_asr_tpu_torch.utils.logging import info, log_startup, procedure


def am_batch_loader(data_dir, batch_size, mode="drop", **kw):
    """Loader whose targets are per-frame alignment ids (padded with 0).
    Alignment length must equal the utterance's frame count — a mismatch
    would silently score real frames against the PAD fill."""
    feats = dict(kaldi_io.scp_entries(os.path.join(data_dir, "feats.scp")))
    ali = kaldi_io.read_key_value_text(os.path.join(data_dir, "ali.txt"))
    triples = []
    for key, rx in feats.items():
        if key not in ali:
            continue
        ids = np.array([int(a) for a in ali[key].split()], np.int32)
        n_frames = kaldi_io.mat_num_rows(rx)
        if len(ids) != n_frames:
            raise ValueError(
                f"utterance {key!r}: {len(ids)} alignment ids vs "
                f"{n_frames} feature frames (subsampled alignments?)"
            )
        triples.append((key, rx, ids))
    info("matched %d utterances with alignments in %s", len(triples),
         data_dir)
    return BatchLoader(triples, batch_size, mode=mode, frame_targets=True,
                       **kw)


def create_am_state(params, *, lr=0.001, soft_coefficient=25000.0, seed=0):
    """A train state at step 0 over ``params`` (used in place): Adam(0.9,
    0.999, eps 1e-8) over every leaf, the AM's LDA affine included, as the
    JAX CLI's optax chain updates the whole tree."""
    leaves = [p.requires_grad_(True) for _, p in named_leaves(params)]
    optimizer = torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    return TrainState(params, optimizer, 0, int(seed),
                      hyperbolic_schedule(lr, soft_coefficient))


def am_train_step(state, cfg, src, src_mask, tgt, *, specaugment=None):
    """One update of ``state`` in place on the mean frame cross entropy.
    ``specaugment``: None, True (the defaults) or a dict of
    ops/specaugment.py's keyword arguments; the masks are drawn from the
    step's generator before the dropout seeds.  Returns (loss, frame
    accuracy) as 0-d tensors on the device."""
    rngs = step_rngs(state.seed, state.step)
    if specaugment:
        kw = specaugment if isinstance(specaugment, dict) else {}
        src = spec_augment(rngs.seeds, src, src_mask, **kw)
    loss, n_correct, n = am.frame_ce_loss(state.params, cfg, src, src_mask,
                                          tgt, train=True, rngs=rngs)
    loss = loss / n
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    set_learning_rate(state.optimizer, state.schedule(state.step))
    state.optimizer.step()
    state.step += 1
    return loss.detach(), n_correct / n


@torch.no_grad()
def am_eval_step(params, cfg, src, src_mask, tgt, valid):
    """(n_correct, n_frames) of the inference forward over the valid
    rows."""
    _, n_correct, n = am.frame_ce_loss(params, cfg, src, src_mask, tgt,
                                       utt_valid=valid)
    return n_correct, n


def am_setup(data_dir, dev_dir, batch_size, *, encoder_type="tdnnf",
             n_targets=None, en_d_model=256, encoder_sub_sequence=None,
             en_dropout=0.1, seed=0):
    """The train and dev loaders, the config and the initial parameters
    (on the CPU, drawn from ``seed``) of :func:`train_am`."""
    loader = am_batch_loader(data_dir, batch_size)
    dev_loader = am_batch_loader(dev_dir, batch_size, mode="all")
    if n_targets is None:
        n_targets = 1 + max(int(l.max()) for l in loader.labels)
    # dev ids beyond the head would be silently clamped by the gather in
    # frame_ce_loss — validate both splits up front
    for name, ld in (("train", loader), ("dev", dev_loader)):
        top = max(int(l.max()) for l in ld.labels)
        if top >= n_targets:
            raise ValueError(
                f"{name} alignments contain id {top} >= n_targets "
                f"{n_targets}; pass the true inventory size via -n_targets"
            )
    cfg_kw = {}
    if encoder_sub_sequence is not None:
        cfg_kw["encoder_sub_sequence"] = tuple(encoder_sub_sequence)
    cfg = TransformerConfig(
        src_dim=loader.feat_dim,
        vocab_size=n_targets,  # unused by the AM head, kept coherent
        encoder_type=encoder_type,
        en_d_model=en_d_model,
        encoder_max_len=loader.src_pad,
        en_dropout=en_dropout,
        **cfg_kw,
    )
    params = am.init_am(torch.Generator().manual_seed(seed), cfg, n_targets)
    return loader, dev_loader, cfg, params


def train_am(data_dir, dev_dir, save_dir, *, encoder_type="tdnnf",
             n_targets=None, epochs=10, batch_size=16, lr=0.001,
             soft_coefficient=25000.0, en_d_model=256, seed=0,
             semi_orth_interval=4, seq_shards=0, encoder_sub_sequence=None,
             en_dropout=0.1, specaugment=None, device="cuda"):
    """Train an AM on ``data_dir`` (evaluating each epoch on ``dev_dir``)
    and save it to ``save_dir``.  Returns (params, cfg, the last epoch's
    dev frame accuracy, the number of updates)."""
    if seq_shards > 1:
        raise ValueError(
            "train_am -seq_shards > 1 (sequence parallelism) is not ported "
            "to pytorch_kaldi_asr_tpu_torch yet (ROADMAP.md, queue 1 item "
            "12: parallelism on torch.distributed)")
    device = torch.device(device)
    loader, dev_loader, cfg, params = am_setup(
        data_dir, dev_dir, batch_size, encoder_type=encoder_type,
        n_targets=n_targets, en_d_model=en_d_model,
        encoder_sub_sequence=encoder_sub_sequence, en_dropout=en_dropout,
        seed=seed)
    state = create_am_state(tree_map(lambda t: t.to(device), params), lr=lr,
                            soft_coefficient=soft_coefficient, seed=seed + 1)

    dev_acc = 0.0
    for epoch in range(1, epochs + 1):
        accs = []
        for batch in loader:
            b = to_device(batch, device)
            _, acc = am_train_step(state, cfg, b.src, b.src_mask, b.tgt,
                                   specaugment=specaugment)
            accs.append(acc)
            if encoder_type == "tdnnf" \
                    and state.step % semi_orth_interval == 0:
                fixed = semi_orthogonal_step(state.params)
                with torch.no_grad():  # in place: Adam keeps its moments
                    for (_, p), (_, q) in zip(named_leaves(state.params),
                                              named_leaves(fixed)):
                        if q is not p:
                            p.copy_(q)
        n_c = n_t = 0.0
        for batch in dev_loader:
            b = to_device(batch, device)
            c, n = am_eval_step(state.params, cfg, b.src, b.src_mask, b.tgt,
                                b.valid)
            n_c, n_t = n_c + c, n_t + n
        dev_acc = float(n_c) / max(float(n_t), 1.0)
        info("epoch %d: train frame-acc %.3f, dev frame-acc %.3f",
             epoch, float(torch.stack(accs).mean()) if accs else 0.0,
             dev_acc)

    save_checkpoint(save_dir, state.params, cfg, epoch=epochs,
                    step=state.step,
                    extra={"n_targets": cfg.vocab_size, "model_kind": "am"})
    info("AM saved to %s after %d updates", save_dir, state.step)
    return state.params, cfg, dev_acc, state.step


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-read_train_dir", required=True)
    parser.add_argument("-read_dev_dir", required=True)
    parser.add_argument("-save_model_dir", required=True)
    parser.add_argument("-encoder_type", default="tdnnf")
    parser.add_argument("-n_targets", type=int, default=None,
                        help="posterior inventory size (default: inferred "
                             "from the train alignments — pass the true pdf "
                             "count when rare classes may be absent)")
    parser.add_argument("-epoch", type=int, default=10)
    parser.add_argument("-batch_size", type=int, default=16)
    parser.add_argument("-en_d_model", type=int, default=256)
    parser.add_argument("-optim_start_lr", type=float, default=0.001)
    parser.add_argument("-en_dropout", type=float, default=0.1)
    parser.add_argument("-seq_shards", type=int, default=0,
                        help="shard the TIME axis over this many devices: "
                             "not ported yet above 1")
    parser.add_argument("-encoder_sub_sequence", default=None,
                        help="attention band '(start,end)', e.g. '(-100,0)'")
    parser.add_argument("-specaugment", action="store_true",
                        help="SpecAugment time/frequency masking inside the "
                             "train step (ops/specaugment.py)")
    parser.add_argument("-specaug_freq_masks", type=int, default=2)
    parser.add_argument("-specaug_freq_width", type=int, default=15)
    parser.add_argument("-specaug_time_masks", type=int, default=2)
    parser.add_argument("-specaug_time_width", type=int, default=50)
    parser.add_argument("-specaug_max_time_frac", type=float, default=0.2)
    parser.add_argument("-device", default="cuda",
                        help="cuda (default), cuda:N or cpu")
    opt = parser.parse_args(argv)

    device = resolve_device(opt.device)
    disable_tf32()
    sub_seq = (str2tuple(opt.encoder_sub_sequence)
               if opt.encoder_sub_sequence else None)
    specaug = None
    if opt.specaugment:
        specaug = {
            "n_freq_masks": opt.specaug_freq_masks,
            "freq_width": opt.specaug_freq_width,
            "n_time_masks": opt.specaug_time_masks,
            "time_width": opt.specaug_time_width,
            "max_time_frac": opt.specaug_max_time_frac,
        }

    procedure("hybrid AM training")
    train_am(
        opt.read_train_dir, opt.read_dev_dir, opt.save_model_dir,
        encoder_type=opt.encoder_type, n_targets=opt.n_targets,
        epochs=opt.epoch, batch_size=opt.batch_size, lr=opt.optim_start_lr,
        en_d_model=opt.en_d_model, en_dropout=opt.en_dropout,
        seq_shards=opt.seq_shards, encoder_sub_sequence=sub_seq,
        specaugment=specaug, device=device,
    )
    log_launch_counts(device)
    return 0


if __name__ == "__main__":
    log_startup()
    raise SystemExit(main())
