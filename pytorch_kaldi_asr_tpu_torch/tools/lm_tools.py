"""CLI entry points for the LM-directory tool group (the port's copy of
``pytorch_kaldi_asr_tpu.tools.lm_tools``).

One executable per reference script (reference kaldi/utils/):

  map-arpa          map_arpa_lm.pl       words <-> ints in an ARPA stream
  reverse-arpa      reverse_arpa.py      exact LM reversal
  find-arpa-oovs    find_arpa_oovs.pl    ARPA words missing from words.txt
  build-const-arpa  build_const_arpa_lm.sh  compact binary LM
  format-lm         format_lm.sh         lang dir + ARPA -> lang dir + G.fst

Usage: python -m pytorch_kaldi_asr_tpu_torch.tools.lm_tools <subcommand> ...
"""

from __future__ import annotations

import argparse
import sys

from pytorch_kaldi_asr_tpu_torch.lm.tools import (
    ConstArpaLm,
    find_arpa_oovs,
    format_lm,
    map_arpa,
    reverse_arpa,
)
from pytorch_kaldi_asr_tpu_torch.utils.logging import log_startup


def _read_syms(path):
    syms = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                syms[parts[0]] = int(parts[1])
    return syms


def main(argv=None):
    parser = argparse.ArgumentParser(prog="lm_tools")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("map-arpa")
    p.add_argument("words_txt")
    p.add_argument("arpa_in")
    p.add_argument("arpa_out")
    p.add_argument("--sym2int", choices=["true", "false"], default="true")

    p = sub.add_parser("reverse-arpa")
    p.add_argument("arpa_in")
    p.add_argument("arpa_out")

    p = sub.add_parser("find-arpa-oovs")
    p.add_argument("words_txt")
    p.add_argument("arpa_in")

    p = sub.add_parser("build-const-arpa")
    p.add_argument("arpa_in")
    p.add_argument("const_out")

    p = sub.add_parser("format-lm")
    p.add_argument("lang_dir")
    p.add_argument("arpa_in")
    p.add_argument("out_dir")

    opt = parser.parse_args(argv)
    if opt.cmd == "map-arpa":
        map_arpa(opt.arpa_in, opt.arpa_out, _read_syms(opt.words_txt),
                 sym2int=opt.sym2int == "true")
    elif opt.cmd == "reverse-arpa":
        reverse_arpa(opt.arpa_in, opt.arpa_out)
    elif opt.cmd == "find-arpa-oovs":
        for w in find_arpa_oovs(opt.arpa_in, _read_syms(opt.words_txt)):
            print(w)
    elif opt.cmd == "build-const-arpa":
        ConstArpaLm.from_arpa(opt.arpa_in).save(opt.const_out)
    elif opt.cmd == "format-lm":
        format_lm(opt.lang_dir, opt.arpa_in, opt.out_dir)
    return 0


if __name__ == "__main__":
    log_startup()
    sys.exit(main())
