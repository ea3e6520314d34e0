"""best_wer CLI (Kaldi's best_wer.sh): print the line with the lowest
%WER.  Two modes:

- no arguments: filter stdin (``grep WER */wer | best_wer``);
- arguments: WER report files or a glob (how the recipe calls it).
"""

import re
import sys

from pytorch_kaldi_asr_tpu_torch.score.best_wer import best_wer
from pytorch_kaldi_asr_tpu_torch.utils.logging import log_startup

_WER_RE = re.compile(r"%WER\s+(\d+(?:\.\d+)?)")


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        best_line, best_value = None, float("inf")
        for line in sys.stdin:
            m = _WER_RE.search(line)
            if m and float(m.group(1)) < best_value:
                best_line, best_value = line.strip(), float(m.group(1))
        if best_line is None:
            print("no WER lines found", file=sys.stderr)
            return 1
        print(best_line)
        return 0
    target = argv[0] if len(argv) == 1 else argv
    line, _path, _value = best_wer(target)
    if line is None:
        print("no WER lines found", file=sys.stderr)
        return 1
    print(line)
    return 0


if __name__ == "__main__":
    log_startup()
    sys.exit(main())
