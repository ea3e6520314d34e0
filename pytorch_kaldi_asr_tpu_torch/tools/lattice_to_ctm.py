"""lattice-to-ctm-conf clone: lattice archives -> NIST CTM with word
confidences via confusion-network consensus (MBR) decoding (the port's
copy of ``pytorch_kaldi_asr_tpu.tools.lattice_to_ctm``).

The reference's scoring chain would shell out to Kaldi's
lattice-mbr-decode / lattice-to-ctm-conf for this (the steps/get_ctm.sh
role downstream of its vendored convert_slf.pl outputs); this tool runs
the native sausage pipeline in decode/confusion.py over the lattice arks
recipes/latgen.py emits.

Usage::

    python3 -m pytorch_kaldi_asr_tpu_torch.tools.lattice_to_ctm \
        -words graph/words.txt -acoustic_scale 0.1 \
        ark:lat.ark out.ctm -text out.tra
"""

from __future__ import annotations

import argparse
import sys

from pytorch_kaldi_asr_tpu_torch.decode.confusion import (
    confusion_network,
    consensus,
    ctm_lines,
)
from pytorch_kaldi_asr_tpu_torch.tools.lattice_copy import (
    _read_words,
    read_lattices,
)
from pytorch_kaldi_asr_tpu_torch.utils.logging import log_startup


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="lattice -> CTM with confidences (consensus/MBR)")
    parser.add_argument("-words", required=True,
                        help="word symbol table (words.txt)")
    parser.add_argument("-acoustic_scale", type=float, default=1.0)
    parser.add_argument("-lm_scale", type=float, default=1.0)
    parser.add_argument("-frame_rate", type=float, default=0.01,
                        help="seconds per frame in CTM times")
    parser.add_argument("-channel", type=int, default=1)
    parser.add_argument("-prune", type=float, default=1e-4,
                        help="drop sausage alternatives below this "
                             "posterior")
    parser.add_argument("-text", default=None,
                        help="also write the consensus transcripts "
                             "('utt w1 w2 ...' lines, compute_wer input)")
    parser.add_argument("rspecifier")
    parser.add_argument("ctm_out")
    opt = parser.parse_args(argv)
    word2id = _read_words(opt.words)
    n = 0
    text_f = open(opt.text, "w", encoding="utf-8") if opt.text else None
    with open(opt.ctm_out, "w", encoding="utf-8") as ctm_f:
        for utt, lat in read_lattices(opt.rspecifier, word2id):
            entries = consensus(confusion_network(
                lat, acoustic_scale=opt.acoustic_scale,
                lm_scale=opt.lm_scale, prune=opt.prune))
            for line in ctm_lines(utt, entries, frame_rate=opt.frame_rate,
                                  channel=opt.channel):
                ctm_f.write(line + "\n")
            if text_f is not None:
                words = " ".join(w for w, _, _, _ in entries)
                text_f.write(f"{utt} {words}\n".rstrip() + "\n")
            n += 1
    if text_f is not None:
        text_f.close()
    print(f"[INFO] wrote CTM for {n} lattices", file=sys.stderr)
    return 0


if __name__ == "__main__":
    log_startup()
    sys.exit(main())
