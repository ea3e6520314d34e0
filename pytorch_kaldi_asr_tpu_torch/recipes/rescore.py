"""Stage-5 rescore entry point: combine AM and LM scores per hypothesis at
a list of inverse LM weights and write one 1-best file per weight."""

import argparse

from pytorch_kaldi_asr_tpu_torch.score.rescore import rescore_nbest
from pytorch_kaldi_asr_tpu_torch.utils.logging import log_startup


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-decode_file", required=True)
    parser.add_argument("-lm_score", required=True)
    parser.add_argument("-save_dir", required=True)
    parser.add_argument("-inv_weight_list", required=True)
    opt = parser.parse_args(argv)

    weights = [float(w) for w in opt.inv_weight_list.split(",")]
    rescore_nbest(opt.decode_file, opt.lm_score, weights, opt.save_dir)
    return 0


if __name__ == "__main__":
    log_startup()
    raise SystemExit(main())
