"""Random paired train/valid split of parallel src/tgt text files
(reference pytorch/utils/divide_train_valid.py:24-47 — an NMT-lineage
utility kept for capability parity)."""

import argparse
import random

from pytorch_kaldi_asr_tpu_torch.utils.logging import info


def divide_train_valid(src_file, tgt_file, valid_rate, out_prefix, seed=0):
    with open(src_file, encoding="utf-8") as f:
        src_lines = f.readlines()
    with open(tgt_file, encoding="utf-8") as f:
        tgt_lines = f.readlines()
    if len(src_lines) != len(tgt_lines):
        raise ValueError("src/tgt line counts differ")
    idx = list(range(len(src_lines)))
    random.Random(seed).shuffle(idx)
    n_valid = int(len(idx) * valid_rate)
    valid = set(idx[:n_valid])
    outputs = {
        f"{out_prefix}.train.src": [src_lines[i] for i in idx[n_valid:]],
        f"{out_prefix}.train.tgt": [tgt_lines[i] for i in idx[n_valid:]],
        f"{out_prefix}.valid.src": [src_lines[i] for i in idx[:n_valid]],
        f"{out_prefix}.valid.tgt": [tgt_lines[i] for i in idx[:n_valid]],
    }
    for path, lines in outputs.items():
        with open(path, "w", encoding="utf-8") as f:
            f.writelines(lines)
    info("divided %d pairs: %d train / %d valid", len(idx),
         len(idx) - n_valid, n_valid)
    return outputs


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-src_file", required=True)
    parser.add_argument("-tgt_file", required=True)
    parser.add_argument("-valid_rate", type=float, default=0.1)
    parser.add_argument("-out_prefix", required=True)
    parser.add_argument("-seed", type=int, default=0)
    opt = parser.parse_args(argv)
    divide_train_valid(opt.src_file, opt.tgt_file, opt.valid_rate,
                       opt.out_prefix, opt.seed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
