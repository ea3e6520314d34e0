"""Stage-2 entry point: train the n-gram LM from transcripts (in place of
``ngram-count -text - -order 3 -lm lm.gz``)."""

import argparse
import contextlib
import sys

from pytorch_kaldi_asr_tpu_torch.lm import train_ngram_lm, write_arpa
from pytorch_kaldi_asr_tpu_torch.utils.logging import info, log_startup


def sentences_from_text_table(path, drop_keys=True):
    """Read transcript sentences.  ``drop_keys`` drops the first column,
    the utterance key (the recipe's ``cut -d' ' -f2-``)."""
    sentences = []
    ctx = (contextlib.nullcontext(sys.stdin) if path == "-"
           else open(path, encoding="utf-8"))
    with ctx as f:
        for line in f:
            words = line.split()
            if not words:
                continue
            sentences.append(words[1:] if drop_keys else words)
    return sentences


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-text", required=True,
                        help="transcript table ('-' for stdin)")
    parser.add_argument("-order", type=int, default=3)
    parser.add_argument("-lm", required=True, help="output ARPA (.gz ok)")
    parser.add_argument("-no_keys", action="store_true",
                        help="input lines are plain sentences, no utt key")
    parser.add_argument("-discounting", choices=["gt", "wb"], default="gt")
    opt = parser.parse_args(argv)

    sentences = sentences_from_text_table(opt.text,
                                          drop_keys=not opt.no_keys)
    info("read %d sentences", len(sentences))
    lm = train_ngram_lm(sentences, order=opt.order,
                        discounting=opt.discounting)
    write_arpa(lm, opt.lm)
    info("LM saved to %s", opt.lm)
    return 0


if __name__ == "__main__":
    log_startup()
    raise SystemExit(main())
