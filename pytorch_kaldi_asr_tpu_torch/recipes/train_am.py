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
``jax.random``.

``-seq_shards N`` above 1 is the long-form path (parallel/sequence.py):
the TIME axis split over N ranks, so utterances whose activations one
device cannot hold still train.  The command stays one: ``train_am``
starts the N ranks itself, one process each (the JAX CLI's one process
spans its devices), on ``cuda:(rank % cards)`` or the CPU, joined under
``-dist_backend`` (``nccl`` on ``cuda``, ``gloo`` on ``cpu`` by default;
``gloo`` lets the ranks share one card, and NCCL refuses that layout).
Every rank reads the same batches in the same order (padded to a multiple
of lcm(8, N) frames), draws the same SpecAugment masks, steps on its time
shard through ``sp_frame_ce_loss`` (the loss over the global frame count,
dropout from a per-shard stream), sums the gradients over the ranks
before Adam, and evaluates the dev set the same way; rank 0 alone logs
and writes the checkpoint (``dump_posteriors`` reads it unchanged) and
logs every rank's kernel launches, one ``kernel launches on
<device>#rank<r>`` line each.  A failed rank stops the others and fails
the command."""

import argparse
import json
import math
import os
import sys
import tempfile

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
from pytorch_kaldi_asr_tpu_torch.ops.launches import (
    launch_counts,
    log_launch_counts,
)
from pytorch_kaldi_asr_tpu_torch.ops.specaugment import spec_augment
from pytorch_kaldi_asr_tpu_torch.parallel import multihost
from pytorch_kaldi_asr_tpu_torch.parallel.collectives import gather_rows
from pytorch_kaldi_asr_tpu_torch.parallel.sequence import (
    SP_ENCODERS,
    make_seq_mesh,
    sp_frame_ce_loss,
)
from pytorch_kaldi_asr_tpu_torch.recipes.initialize_model import str2tuple
from pytorch_kaldi_asr_tpu_torch.train.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from pytorch_kaldi_asr_tpu_torch.train.optim import (
    hyperbolic_schedule,
    named_leaves,
    set_learning_rate,
)
from pytorch_kaldi_asr_tpu_torch.train.state import (
    TrainState,
    step_rngs,
    sum_grads,
)
from pytorch_kaldi_asr_tpu_torch.utils.device import disable_tf32, resolve_device
from pytorch_kaldi_asr_tpu_torch.utils.logging import (
    info,
    log_startup,
    procedure,
    quiet,
)


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
             en_dropout=0.1, seed=0, pad_multiple=8):
    """The train and dev loaders, the config and the initial parameters
    (on the CPU, drawn from ``seed``) of :func:`train_am`."""
    loader = am_batch_loader(data_dir, batch_size, pad_multiple=pad_multiple)
    dev_loader = am_batch_loader(dev_dir, batch_size, mode="all",
                                 pad_multiple=pad_multiple)
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


def am_sp_train_step(state, cfg, src, src_mask, tgt, mesh, *,
                     specaugment=None):
    """:func:`am_train_step` on this rank's time shard of the global batch
    (every rank passes the same ``src``): the loss over the global frame
    count, the gradients summed over the mesh before Adam, so the
    replicated parameters stay equal.  Returns (loss, frame accuracy) of
    the global batch."""
    rngs = step_rngs(state.seed, state.step)
    if specaugment:  # the same masks on every rank: the same generator
        kw = specaugment if isinstance(specaugment, dict) else {}
        src = spec_augment(rngs.seeds, src, src_mask, **kw)
    loss, n_correct, n = sp_frame_ce_loss(state.params, cfg, src, src_mask,
                                          tgt, mesh, train=True, rngs=rngs)
    loss = loss / n
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    sum_grads(state.params, mesh.axis("seq"))
    set_learning_rate(state.optimizer, state.schedule(state.step))
    state.optimizer.step()
    state.step += 1
    return loss.detach(), n_correct / n


def _spawn_shards(spec):
    """Start ``spec["seq_shards"]`` ranks of :func:`run_rank`, wait, and
    return rank 0's (dev accuracy, updates)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "spec.json")
        with open(path, "w", encoding="utf-8") as f:
            json.dump(dict(spec, result=os.path.join(tmp, "result.json")), f)
        multihost.spawn_local(
            [sys.executable, "-c",
             "import sys; from pytorch_kaldi_asr_tpu_torch.recipes.train_am "
             "import run_rank; sys.exit(run_rank(sys.argv[1]))", path],
            spec["seq_shards"])
        with open(os.path.join(tmp, "result.json"), encoding="utf-8") as f:
            result = json.load(f)
    return result["dev_acc"], result["steps"]


def run_rank(spec_path):
    """One rank of ``train_am -seq_shards N`` (started by
    :func:`train_am`, the world from the environment of
    parallel/multihost.py)."""
    with open(spec_path, encoding="utf-8") as f:
        spec = json.load(f)
    torch.set_num_threads(1)
    if os.environ.get("PKA_PROCESS_ID", "0") != "0":  # rank 0 alone logs
        quiet()
    rank, world = multihost.initialize(backend=spec["dist_backend"],
                                       device=spec["device"])
    if world != spec["seq_shards"]:
        raise RuntimeError(f"rank {rank}: a world of {world}, expected "
                           f"{spec['seq_shards']}")
    device = multihost.rank_device(spec["device"], rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        disable_tf32()
    kw = {k: v for k, v in spec.items()
          if k not in ("dist_backend", "device", "result")}
    if kw["encoder_sub_sequence"] is not None:
        kw["encoder_sub_sequence"] = tuple(kw["encoder_sub_sequence"])
    dev_acc, steps = _train_sp(device=device, **kw)
    if rank == 0:
        with open(spec["result"], "w", encoding="utf-8") as f:
            json.dump({"dev_acc": dev_acc, "steps": steps}, f)
    torch.distributed.destroy_process_group()
    return 0


def _train_sp(data_dir, dev_dir, save_dir, *, encoder_type, n_targets,
              epochs, batch_size, lr, soft_coefficient, en_d_model, seed,
              semi_orth_interval, seq_shards, encoder_sub_sequence,
              en_dropout, specaugment, device):
    """The sequence-parallel training of one rank: the single-device loop
    of :func:`train_am` over :func:`am_sp_train_step`."""
    del semi_orth_interval  # the tdnnf has no sequence-parallel forward
    rank = torch.distributed.get_rank()
    pad_multiple = 8 * seq_shards // math.gcd(8, seq_shards)
    loader, dev_loader, cfg, params = am_setup(
        data_dir, dev_dir, batch_size, encoder_type=encoder_type,
        n_targets=n_targets, en_d_model=en_d_model,
        encoder_sub_sequence=encoder_sub_sequence, en_dropout=en_dropout,
        seed=seed, pad_multiple=pad_multiple)
    mesh = make_seq_mesh(seq_shards)
    if rank == 0:
        info("sequence-parallel training: time axis over %d shards "
             "(%d-frame pads, %d local frames)", seq_shards, loader.src_pad,
             loader.src_pad // seq_shards)
    state = create_am_state(tree_map(lambda t: t.to(device), params), lr=lr,
                            soft_coefficient=soft_coefficient, seed=seed + 1)
    dev_acc = 0.0
    for epoch in range(1, epochs + 1):
        accs, losses = [], []
        for batch in loader:
            b = to_device(batch, device)
            loss, acc = am_sp_train_step(state, cfg, b.src, b.src_mask,
                                         b.tgt, mesh,
                                         specaugment=specaugment)
            accs.append(acc)
            losses.append(loss)
        n_c = n_t = 0.0
        with torch.no_grad():
            for batch in dev_loader:
                b = to_device(batch, device)
                _, c, n = sp_frame_ce_loss(state.params, cfg, b.src,
                                           b.src_mask, b.tgt, mesh,
                                           utt_valid=b.valid)
                n_c, n_t = n_c + c, n_t + n
        dev_acc = float(n_c) / max(float(n_t), 1.0)
        if rank == 0:
            info("epoch %d: train frame-acc %.3f, dev frame-acc %.3f",
                 epoch, float(torch.stack(accs).mean()) if accs else 0.0,
                 dev_acc)
            info("epoch %d: mean train loss %.6f over %d steps", epoch,
                 float(torch.stack(losses).mean()) if losses else 0.0,
                 len(losses))
    if rank == 0:
        save_checkpoint(save_dir, state.params, cfg, epoch=epochs,
                        step=state.step,
                        extra={"n_targets": cfg.vocab_size,
                               "model_kind": "am"})
        info("AM saved to %s after %d updates", save_dir, state.step)
    counts = launch_counts()
    rows = gather_rows(torch.tensor([float(counts[k]) for k in counts]),
                       mesh.axis("seq"))
    if rank == 0:
        for r, row in enumerate(rows.tolist()):
            info("kernel launches on %s#rank%d: %s", device, r,
                 json.dumps(dict(zip(counts, map(int, row)))))
    return dev_acc, state.step


def train_am(data_dir, dev_dir, save_dir, *, encoder_type="tdnnf",
             n_targets=None, epochs=10, batch_size=16, lr=0.001,
             soft_coefficient=25000.0, en_d_model=256, seed=0,
             semi_orth_interval=4, seq_shards=0, encoder_sub_sequence=None,
             en_dropout=0.1, specaugment=None, device="cuda",
             dist_backend=None):
    """Train an AM on ``data_dir`` (evaluating each epoch on ``dev_dir``)
    and save it to ``save_dir``.  Returns (params, cfg, the last epoch's
    dev frame accuracy, the number of updates).  ``seq_shards`` > 1
    trains sequence-parallel on that many ranks of this host, joined
    under ``dist_backend`` (module docstring); the returned parameters are
    then the checkpoint's, on the CPU."""
    if seq_shards > 1:
        if encoder_type not in SP_ENCODERS:
            raise ValueError(
                f"encoder_type {encoder_type!r} has no sequence-parallel "
                f"forward (available: {sorted(SP_ENCODERS)})")
        backend = dist_backend or multihost.default_backend(device)
        multihost.check_backend(backend, device, seq_shards)
        if torch.device(device).type == "cuda":
            resolve_device(str(device))
        dev_acc, steps = _spawn_shards(dict(
            data_dir=data_dir, dev_dir=dev_dir, save_dir=save_dir,
            encoder_type=encoder_type, n_targets=n_targets, epochs=epochs,
            batch_size=batch_size, lr=lr,
            soft_coefficient=soft_coefficient, en_d_model=en_d_model,
            seed=seed, semi_orth_interval=semi_orth_interval,
            seq_shards=seq_shards,
            encoder_sub_sequence=encoder_sub_sequence, en_dropout=en_dropout,
            specaugment=specaugment, device=str(device),
            dist_backend=backend))
        ckpt = load_checkpoint(save_dir)
        return ckpt["params"], ckpt["cfg"], dev_acc, steps
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
                        help="shard the TIME axis over this many ranks, "
                             "started here, one process each (long-form "
                             "utterances; banded/conformer encoders only — "
                             "see parallel/sequence.py)")
    parser.add_argument("-dist_backend", choices=("nccl", "gloo"),
                        default=None,
                        help="torch.distributed backend of -seq_shards "
                             "(default: nccl on cuda, gloo on cpu; gloo "
                             "lets the ranks share one card)")
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
        specaugment=specaug, device=device, dist_backend=opt.dist_backend,
    )
    if opt.seq_shards <= 1:  # rank 0 logged the ranks' counts
        log_launch_counts(device)
    return 0


if __name__ == "__main__":
    log_startup()
    raise SystemExit(main())
