"""compute-wer CLI clone::

    python3 -m pytorch_kaldi_asr_tpu_torch.tools.compute_wer --mode=present \
        ark:data/test/text ark:scoring/rescore_10

Prints the %WER/%SER report to stdout in the Kaldi binary's shape, so
``best_wer`` parses it unchanged."""

import sys

from pytorch_kaldi_asr_tpu_torch.io import kaldi_io
from pytorch_kaldi_asr_tpu_torch.score.wer import compute_wer, format_wer_report
from pytorch_kaldi_asr_tpu_torch.utils.logging import log_startup


def _read_text_table(spec):
    path = spec.split(":", 1)[1] if ":" in spec else spec
    return kaldi_io.read_key_value_text(path)


def main(argv=None):
    argv = list(argv or sys.argv[1:])
    mode = "strict"
    rest = []
    for a in argv:
        if a.startswith("--mode="):
            mode = a.split("=", 1)[1]
        else:
            rest.append(a)
    if len(rest) != 2:
        print("usage: compute_wer [--mode=present|all|strict] "
              "<ref-rspecifier> <hyp-rspecifier>", file=sys.stderr)
        return 1
    ref = _read_text_table(rest[0])
    hyp = _read_text_table(rest[1])
    stats = compute_wer(ref, hyp, mode=mode)
    sys.stdout.write(format_wer_report(stats))
    return 0


if __name__ == "__main__":
    log_startup()
    sys.exit(main())
