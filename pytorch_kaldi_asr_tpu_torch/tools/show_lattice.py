"""Render a word lattice as GraphViz dot (reference kaldi/utils/
show_lattice.sh role, minus the external dot/ps toolchain: emits .dot text
you can feed to graphviz; the port's copy of
``pytorch_kaldi_asr_tpu.tools.show_lattice``).

Usage: python -m pytorch_kaldi_asr_tpu_torch.tools.show_lattice \
           -lattices lat.txt -utt <key> [-output out.dot]
"""

from __future__ import annotations

import argparse
import sys

from pytorch_kaldi_asr_tpu_torch.decode.lattice_io import (
    read_text_lattice_archive,
)
from pytorch_kaldi_asr_tpu_torch.utils.logging import log_startup


def read_lattice_archive(path):
    """Yield (utt, WordLattice) from a kaldi-text lattice archive
    (delegates to decode.lattice_io.read_text_lattice_archive)."""
    yield from read_text_lattice_archive(path)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-lattices", required=True)
    parser.add_argument("-utt", default=None,
                        help="which utterance (default: first)")
    parser.add_argument("-output", default="-")
    opt = parser.parse_args(argv)

    for utt, lat in read_lattice_archive(opt.lattices):
        if opt.utt is None or utt == opt.utt:
            dot = lat.to_dot()
            if opt.output == "-":
                sys.stdout.write(dot + "\n")
            else:
                with open(opt.output, "w", encoding="utf-8") as f:
                    f.write(dot + "\n")
            return 0
    sys.stderr.write(f"utterance {opt.utt!r} not found in {opt.lattices}\n")
    return 1


if __name__ == "__main__":
    log_startup()
    sys.exit(main())
