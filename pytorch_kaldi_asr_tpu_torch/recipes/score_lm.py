"""Stage-5 LM scoring: one log10 LM probability per hypothesis of an n-best
file, line-aligned with it, for the rescoring combine.  ``-lm`` scores
with an ARPA n-gram model (lm/), ``-nlm_model_dir`` with a neural LM
(models/nlm.py) on the device.

Same flags as ``pytorch_kaldi_asr_tpu.recipes.score_lm`` plus ``-device``
(``cuda`` by default; ``cpu`` on request; without a visible card and
without ``-device cpu`` it raises, whichever LM is given).  As in the JAX
package, the whole hypothesis text is scored: the reference recipe's ``cut
-d' ' -f2-`` on the tab-separated decode.txt, which drops each
hypothesis's first word, is not reproduced."""

import argparse

from pytorch_kaldi_asr_tpu_torch.ops.launches import log_launch_counts
from pytorch_kaldi_asr_tpu_torch.utils.device import disable_tf32, resolve_device
from pytorch_kaldi_asr_tpu_torch.utils.logging import info, log_startup


def read_hypotheses(path):
    """The word lists of a ``key\\tscore\\ttext`` n-best file, blank lines
    skipped."""
    out = []
    with open(path, encoding="utf-8") as fin:
        for line in fin:
            if not line.strip():
                continue
            _key, _am, text = line.rstrip("\n").split("\t")
            out.append(text.split())
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-decode_file", required=True,
                        help="n-best file: key\\tscore\\ttext per line")
    parser.add_argument("-lm", default=None, help="ARPA LM (.gz ok)")
    parser.add_argument("-nlm_model_dir", default=None,
                        help="neural LM checkpoint (recipes/train_nlm.py) "
                             "to score with instead of an ARPA model")
    parser.add_argument("-read_vocab_file", default=None,
                        help="vocab for -nlm_model_dir (the one the neural "
                             "LM was trained with)")
    parser.add_argument("-batch_size", type=int, default=64,
                        help="neural scoring batch")
    parser.add_argument("-save_score_file", required=True,
                        help="output: one log10-prob per input line")
    parser.add_argument("-device", default="cuda",
                        help="cuda (default), cuda:N or cpu")
    opt = parser.parse_args(argv)
    if bool(opt.lm) == bool(opt.nlm_model_dir):
        parser.error("pass exactly one of -lm / -nlm_model_dir")
    if opt.nlm_model_dir and not opt.read_vocab_file:
        parser.error("-nlm_model_dir needs -read_vocab_file")
    device = resolve_device(opt.device)
    disable_tf32()

    hyps = read_hypotheses(opt.decode_file)
    if opt.nlm_model_dir:
        from pytorch_kaldi_asr_tpu_torch.data import read_vocab
        from pytorch_kaldi_asr_tpu_torch.models.nlm import (
            load_nlm,
            score_sentences,
        )

        params, cfg, _meta = load_nlm(opt.nlm_model_dir, device=device)
        scores = score_sentences(params, cfg, hyps,
                                 read_vocab(opt.read_vocab_file),
                                 batch_size=opt.batch_size)
        what = "the neural LM"
    else:
        from pytorch_kaldi_asr_tpu_torch.lm import read_arpa

        lm = read_arpa(opt.lm)
        scores = [lm.sentence_logprob(words)[0] for words in hyps]
        what = opt.lm
    with open(opt.save_score_file, "w", encoding="utf-8") as fout:
        for lp in scores:
            fout.write(f"{lp:.4f}\n")
    info("scored %d hypotheses with %s -> %s", len(scores), what,
         opt.save_score_file)
    log_launch_counts(device)
    return 0


if __name__ == "__main__":
    log_startup()
    raise SystemExit(main())
