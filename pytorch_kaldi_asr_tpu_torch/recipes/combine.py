"""Standalone checkpoint-combining entry point: progressively average an
explicit list of checkpoints, evaluate each prefix average on a data dir,
and save the best as combined.accuXX.

Same flags as ``pytorch_kaldi_asr_tpu.recipes.combine`` plus ``-device``
(``cuda`` by default; ``cpu`` on request; without a card and without
``-device cpu`` it raises).  A thin CLI over ``train.loop.
combine_checkpoints`` with an explicit path list."""

import argparse

from pytorch_kaldi_asr_tpu_torch.data import read_vocab
from pytorch_kaldi_asr_tpu_torch.data.loader import make_batch_loader
from pytorch_kaldi_asr_tpu_torch.train import (
    combine_checkpoints,
    read_checkpoint_config,
)
from pytorch_kaldi_asr_tpu_torch.utils.device import disable_tf32, resolve_device
from pytorch_kaldi_asr_tpu_torch.utils.logging import log_startup


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-model_list", required=True,
                        help="comma-separated checkpoint dirs, best first")
    parser.add_argument("-read_data_dir", required=True)
    parser.add_argument("-read_vocab_file", required=True)
    parser.add_argument("-save_model_dir", required=True)
    parser.add_argument("-batch_size", type=int, default=64)
    parser.add_argument("-device", default="cuda",
                        help="cuda (default), cuda:N or cpu")
    opt = parser.parse_args(argv)

    device = resolve_device(opt.device)
    disable_tf32()
    paths = [p for p in opt.model_list.split(",") if p]
    cfg, _ = read_checkpoint_config(paths[0])
    vocab = read_vocab(opt.read_vocab_file)
    loader = make_batch_loader(opt.read_data_dir, vocab, opt.batch_size,
                               mode="all")
    combine_checkpoints(opt.save_model_dir, cfg=cfg, eval_loader=loader,
                        paths=paths, device=device)
    return 0


if __name__ == "__main__":
    log_startup()
    raise SystemExit(main())
