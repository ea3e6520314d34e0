"""feat-to-len clone: emit per-utterance frame counts.

Usage (the Kaldi binary's CLI contract)::

    python3 -m pytorch_kaldi_asr_tpu_torch.tools.feat_to_len \
        scp:data/train/feats.scp ark,t:data/train/feats.length

Only matrix headers are read, by the native core (native/src/ark_io.cc):
an ``scp:`` table's matrices one by one (``kaldi_io.mat_num_rows``), an
``ark:`` archive in one scan of the file (``native.scan_ark``).  An archive
whose first object is not a binary matrix (a text archive), a pipe and
``-`` are read through the Python readers.  ``pka-feat-to-len`` (native/,
scp input only) writes the same file byte for byte."""

import sys

from pytorch_kaldi_asr_tpu_torch import native
from pytorch_kaldi_asr_tpu_torch.io import kaldi_io
from pytorch_kaldi_asr_tpu_torch.utils.logging import log_startup


def _binary_ark(path):
    """Whether ``path`` is a plain file whose first object is a binary
    matrix of the native core's (its first key, then the header)."""
    if path == "-" or path.endswith("|"):
        return False
    with open(path, "rb") as f:
        key = kaldi_io._read_key(f)
        offset = f.tell()
    return key is not None and kaldi_io.native_object(f"{path}:{offset}")


def feat_to_len(rspecifier, wspecifier=None):
    kind, _, path = kaldi_io.parse_specifier(rspecifier)
    if kind == "scp":
        lengths = {
            key: kaldi_io.mat_num_rows(rx)
            for key, rx in kaldi_io.scp_entries(path)
        }
    elif _binary_ark(path):
        lengths = {key: rows for key, rows, _cols in native.scan_ark(path)}
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
