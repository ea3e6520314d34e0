"""copy-feats clone: copy/convert feature tables between representations
(binary ark, text ark, ark+scp pairs) — the everyday Kaldi plumbing verb for
re-materializing archives.

Usage::

    python3 -m pytorch_kaldi_asr_tpu_torch.tools.copy_feats \
        scp:feats.scp ark,scp:copy.ark,copy.scp
    python3 -m pytorch_kaldi_asr_tpu_torch.tools.copy_feats ark:in.ark ark,t:out.ark
"""

import sys

from pytorch_kaldi_asr_tpu_torch.io import kaldi_io


# Kaldi's --compression-method numbering (compressed-matrix.h):
# 1 kAutomaticMethod (speech features -> column-header format),
# 2 kSpeechFeature, 3 kTwoByteAuto, 4 kTwoByteSignedInteger (two-byte),
# 5 kOneByteAuto, 6 kOneByteUnsignedInteger, 7 kOneByteZeroOne (one-byte)
_METHODS = {1: "CM", 2: "CM", 3: "CM2", 4: "CM2", 5: "CM3", 6: "CM3",
            7: "CM3"}


def copy_feats(rspecifier, wspecifier, compress=False):
    n = 0
    with kaldi_io.open_writer(wspecifier, compress=compress) as w:
        for key, mat in kaldi_io.read_table(rspecifier):
            w.write(key, mat)
            n += 1
    return n


def main(argv=None):
    argv = list(argv or sys.argv[1:])
    compress, method = False, 1
    pos = []
    for a in argv:
        if a.startswith("--compression-method"):
            method = int(a.partition("=")[2])
        elif a.startswith("--compress"):
            _, _, v = a.partition("=")
            compress = v.lower() in ("", "true", "1")
        else:
            pos.append(a)
    if len(pos) != 2:
        print(
            "usage: copy_feats [--compress=true] [--compression-method=N] "
            "<rspecifier> <wspecifier>",
            file=sys.stderr,
        )
        return 1
    if compress and method not in _METHODS:
        print(f"unknown --compression-method={method} (know 1-7)",
              file=sys.stderr)
        return 1
    n = copy_feats(pos[0], pos[1],
                   compress=_METHODS[method] if compress else False)
    print(f"[INFO] copied {n} feature matrices", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
