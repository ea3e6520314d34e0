"""Stage-4 entry point: train the acoustic model.  Loads model.init, builds
the train/dev/test loaders, runs the epoch driver on the card, then
combines the final checkpoints.

Same flags as ``pytorch_kaldi_asr_tpu.recipes.train`` plus ``-device``
(``cuda`` by default; ``cpu`` on request).  Without a visible card and
without ``-device cpu`` it raises rather than fall back.  Exits with
PREEMPT_EXIT_CODE (75) after a preemption.  ``-use_gpu`` is accepted for
recipe compatibility.  ``-train_archive_dir`` streams the training set from
pre-packed archives (recipes.generate_archive) with the archives' own
epoch shuffling, seeded by ``-seed`` (the JAX CLI leaves that loader at
seed 0; the two agree at the default seed).  ``-specaugment`` masks the
features inside every train step (ops/specaugment.py)."""

import argparse
import os

from pytorch_kaldi_asr_tpu_torch.data import read_vocab
from pytorch_kaldi_asr_tpu_torch.data.archive import ArchiveBatchLoader
from pytorch_kaldi_asr_tpu_torch.data.loader import make_batch_loader
from pytorch_kaldi_asr_tpu_torch.ops.launches import log_launch_counts
from pytorch_kaldi_asr_tpu_torch.train import (
    combine_checkpoints,
    load_checkpoint,
    train_model,
)
from pytorch_kaldi_asr_tpu_torch.utils.constants import PREEMPT_EXIT_CODE
from pytorch_kaldi_asr_tpu_torch.utils.device import disable_tf32, resolve_device
from pytorch_kaldi_asr_tpu_torch.utils.logging import info, log_startup, procedure


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-read_train_dir", required=True)
    parser.add_argument("-read_dev_dir", required=True)
    parser.add_argument("-read_test_dir", required=True)
    parser.add_argument("-read_vocab_file", required=True)
    parser.add_argument("-load_model_file", required=True)
    parser.add_argument("-save_model_dir", required=True)
    parser.add_argument("-seq_error_prob", type=float, default=0,
                        help="accepted for recipe compatibility")
    parser.add_argument("-epoch", type=int, default=50)
    parser.add_argument("-optim_start_lr", type=float, default=0.001)
    parser.add_argument("-optim_soft_coefficient", type=float, default=1000)
    parser.add_argument("-batch_size", type=int, default=64)
    parser.add_argument("-num_buckets", type=int, default=1,
                        help="length buckets (>1 reduces padding waste)")
    parser.add_argument("-loader_workers", type=int, default=1,
                        help="host batch-assembly threads (ordered handoff)")
    parser.add_argument("-train_archive_dir", default=None,
                        help="stream the training set from the .npz batch "
                             "archives of recipes.generate_archive instead "
                             "of preloading read_train_dir")
    parser.add_argument("-label_smoothing", action="store_true")
    parser.add_argument("-save_interval", type=int, default=10)
    parser.add_argument("-seed", type=int, default=0,
                        help="training seed (epoch shuffling + dropout)")
    parser.add_argument("-resume", action="store_true",
                        help="continue from the newest epoch.* checkpoint "
                             "or the newer preempt snapshot")
    parser.add_argument("-use_gpu", action="store_true",
                        help="accepted for recipe compatibility")
    parser.add_argument("-specaugment", action="store_true",
                        help="SpecAugment masking inside the train step "
                             "(ops/specaugment.py defaults; off by "
                             "default, as the reference has no feature "
                             "augmentation)")
    parser.add_argument("-device", default="cuda",
                        help="cuda (default), cuda:N or cpu")
    opt = parser.parse_args(argv)

    device = resolve_device(opt.device)
    disable_tf32()

    procedure("prepare trainning.")
    ckpt = load_checkpoint(opt.load_model_file)
    params, cfg = ckpt["params"], ckpt["cfg"]
    info("loading model with parameter:\n\t%s", cfg)

    vocab = read_vocab(opt.read_vocab_file)
    info("reading training data...")
    if opt.train_archive_dir:
        train_loader = ArchiveBatchLoader(opt.train_archive_dir,
                                          opt.batch_size, mode="drop",
                                          seed=opt.seed)
    else:
        train_loader = make_batch_loader(opt.read_train_dir, vocab,
                                         opt.batch_size, mode="drop",
                                         num_buckets=opt.num_buckets,
                                         seed=opt.seed,
                                         num_workers=opt.loader_workers)
    info("reading dev data...")
    dev_loader = make_batch_loader(opt.read_dev_dir, vocab, opt.batch_size,
                                   mode="all")
    info("reading test data...")
    test_loader = make_batch_loader(opt.read_test_dir, vocab, opt.batch_size,
                                    mode="all")
    info("batch loader is initialized")

    procedure("trainning start...")
    result = train_model(
        params, cfg, train_loader, dev_loader, test_loader,
        opt.save_model_dir,
        epochs=opt.epoch,
        start_lr=opt.optim_start_lr,
        soft_coefficient=opt.optim_soft_coefficient,
        save_interval=opt.save_interval,
        smoothing=opt.label_smoothing,
        seed=opt.seed,
        resume=opt.resume,
        metrics_path=os.path.join(opt.save_model_dir, "metrics.jsonl"),
        device=device,
        specaugment=opt.specaugment,
    )
    if result.preempted:
        procedure("preempted: exiting %d for launcher resubmission"
                  % PREEMPT_EXIT_CODE)
        return PREEMPT_EXIT_CODE

    procedure("combining start on best epoch %d" % result.best_epoch)
    num_model = 30 if opt.epoch > 30 else opt.epoch
    combine_checkpoints(opt.save_model_dir, result.best_epoch, cfg,
                        dev_loader, num_model=num_model, device=device)
    log_launch_counts(device)
    return 0


if __name__ == "__main__":
    log_startup()
    raise SystemExit(main())
