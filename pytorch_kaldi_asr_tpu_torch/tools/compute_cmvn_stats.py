"""compute-cmvn-stats CLI clone: accumulate per-speaker (or per-utterance)
CMVN statistics.

Usage::

    python3 -m pytorch_kaldi_asr_tpu_torch.tools.compute_cmvn_stats \
        [--spk2utt=ark:data/x/spk2utt | --utt2spk=ark:data/x/utt2spk] \
        scp:data/x/feats.scp ark,scp:data/x/cmvn.ark,data/x/cmvn.scp

(The recipe's stage 0 runs it on demand, so data dirs need no cmvn.scp.)"""

import sys

from pytorch_kaldi_asr_tpu_torch.tools.cmvn import compute_cmvn_stats, table_path
from pytorch_kaldi_asr_tpu_torch.utils.logging import log_startup


def main(argv=None):
    argv = list(argv or sys.argv[1:])
    utt2spk = None
    rest = []
    for a in argv:
        if a.startswith("--utt2spk="):
            utt2spk = table_path(a.split("=", 1)[1])
        elif a.startswith("--spk2utt="):
            # the same speakers as utt -> spk
            utt2spk = {}
            with open(table_path(a.split("=", 1)[1]), encoding="utf-8") as f:
                for line in f:
                    parts = line.split()
                    for utt in parts[1:]:
                        utt2spk[utt] = parts[0]
        else:
            rest.append(a)
    if len(rest) != 2:
        print(
            "usage: compute_cmvn_stats [--utt2spk=ark:f|--spk2utt=ark:f] "
            "<feats-rspecifier> <stats-wspecifier>",
            file=sys.stderr,
        )
        return 1
    compute_cmvn_stats(rest[0], rest[1], utt2spk=utt2spk)
    return 0


if __name__ == "__main__":
    log_startup()
    sys.exit(main())
