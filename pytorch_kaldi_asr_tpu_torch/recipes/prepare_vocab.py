"""Stage-1 entry point: build and save the label vocabulary from a
transcript table."""

import argparse

from pytorch_kaldi_asr_tpu_torch.data import instances as instances_handler
from pytorch_kaldi_asr_tpu_torch.utils.logging import log_startup


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-read_instances_file", required=True)
    parser.add_argument("-save_vocab_file", required=True)
    parser.add_argument("-min_word_count", type=int, default=0)
    opt = parser.parse_args(argv)

    instances = instances_handler.read_instances(opt.read_instances_file)
    vocab = instances_handler.build_vocab(instances, opt.min_word_count)
    instances_handler.save_vocab(vocab, opt.save_vocab_file)
    return 0


if __name__ == "__main__":
    log_startup()
    raise SystemExit(main())
