"""ROVER system combination over CTM files (SCTK ``rover`` role; the
port's copy of ``pytorch_kaldi_asr_tpu.tools.rover``).

Combines N systems' CTM outputs (e.g. from tools/lattice_to_ctm.py runs
over different models or decoding configs) by word-transition-network
alignment + confidence-weighted voting (decode/confusion.py:rover).
Emits combined transcripts ready for tools/compute_wer.py.

Usage::

    python3 -m pytorch_kaldi_asr_tpu_torch.tools.rover \
        -alpha 0.5 -null_conf 0.7 -o combined.tra \
        sys1.ctm sys2.ctm sys3.ctm
"""

from __future__ import annotations

import argparse
import sys

from pytorch_kaldi_asr_tpu_torch.decode.confusion import read_ctm, rover_ctms
from pytorch_kaldi_asr_tpu_torch.utils.logging import log_startup


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="ROVER combination of CTM hypothesis files")
    parser.add_argument("-alpha", type=float, default=0.5,
                        help="vote = alpha*frequency + (1-alpha)*conf")
    parser.add_argument("-null_conf", type=float, default=0.7,
                        help="confidence prior of the NULL (absent) word")
    parser.add_argument("-o", "--output", required=True,
                        help="combined transcript output "
                             "('utt w1 w2 ...' lines)")
    parser.add_argument("-conf_output", default=None,
                        help="also write per-word vote scores "
                             "('utt word score' lines)")
    parser.add_argument("ctms", nargs="+", help="input CTM files")
    opt = parser.parse_args(argv)
    if len(opt.ctms) < 2:
        print("[WARNING] rover over a single system is the identity",
              file=sys.stderr)
    systems = [read_ctm(p) for p in opt.ctms]
    combined = rover_ctms(systems, alpha=opt.alpha, null_conf=opt.null_conf)
    with open(opt.output, "w", encoding="utf-8") as f:
        for utt in sorted(combined):
            words = " ".join(w for w, _ in combined[utt])
            f.write(f"{utt} {words}".rstrip() + "\n")
    if opt.conf_output:
        with open(opt.conf_output, "w", encoding="utf-8") as f:
            for utt in sorted(combined):
                for w, s in combined[utt]:
                    f.write(f"{utt} {w} {s:.3f}\n")
    print(f"[INFO] combined {len(systems)} systems over "
          f"{len(combined)} utterances", file=sys.stderr)
    return 0


if __name__ == "__main__":
    log_startup()
    sys.exit(main())
