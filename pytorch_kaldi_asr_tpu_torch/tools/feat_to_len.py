"""feat-to-len clone: emit per-utterance frame counts.

Usage (the Kaldi binary's CLI contract)::

    python3 -m pytorch_kaldi_asr_tpu_torch.tools.feat_to_len \
        scp:data/train/feats.scp ark,t:data/train/feats.length

Through an scp only matrix headers are decoded."""

import sys

from pytorch_kaldi_asr_tpu_torch.io import kaldi_io
from pytorch_kaldi_asr_tpu_torch.utils.logging import log_startup


def feat_to_len(rspecifier, wspecifier=None):
    kind, _, path = kaldi_io.parse_specifier(rspecifier)
    if kind == "scp":
        lengths = {
            key: kaldi_io.mat_num_rows(rx)
            for key, rx in kaldi_io.scp_entries(path)
        }
    else:
        lengths = {key: mat.shape[0]
                   for key, mat in kaldi_io.read_mat_ark(path)}
    if wspecifier is None:
        return lengths
    _, _opts, out_path = kaldi_io.parse_specifier(wspecifier)
    kaldi_io.write_key_value_text(out_path, lengths)
    return lengths


def main(argv=None):
    argv = argv or sys.argv[1:]
    if len(argv) != 2:
        print("usage: feat_to_len <rspecifier> <wspecifier>", file=sys.stderr)
        return 1
    feat_to_len(argv[0], argv[1])
    return 0


if __name__ == "__main__":
    log_startup()
    sys.exit(main())
