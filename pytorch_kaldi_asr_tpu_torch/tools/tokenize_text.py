"""Word segmentation of raw text files (role of the reference's
pytorch/utils/jieba_cutter.py — Chinese segmentation via jieba).

jieba is not a baked-in dependency; when unavailable, a character-level
fallback segments CJK runs per character and keeps Latin tokens whole, which
is the standard jieba-free degradation for ASR label prep."""

import argparse
import re

from pytorch_kaldi_asr_tpu_torch.utils.logging import info, warning

_CJK = re.compile(r"([一-鿿])")


def segment_line(line, cutter=None):
    if cutter is not None:
        return " ".join(w for w in cutter(line.strip()) if w.strip())
    # fallback: split CJK chars, keep other tokens whole
    spaced = _CJK.sub(r" \1 ", line.strip())
    return " ".join(spaced.split())


def segment_file(read_file, save_file, language="chinese"):
    cutter = None
    if language == "chinese":
        try:
            import jieba  # optional dependency

            cutter = jieba.cut
        except ImportError:
            warning("jieba not installed; using per-character CJK fallback")
    n = 0
    with open(read_file, encoding="utf-8") as fin, \
            open(save_file, "w", encoding="utf-8") as fout:
        for line in fin:
            fout.write(segment_line(line, cutter) + "\n")
            n += 1
    info("segmented %d lines -> %s", n, save_file)
    return n


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-read_file", required=True)
    parser.add_argument("-save_file", required=True)
    parser.add_argument("-language", default="chinese")
    opt = parser.parse_args(argv)
    segment_file(opt.read_file, opt.save_file, opt.language)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
