"""Cepstral mean/variance normalization: stats computation and application
(the Kaldi pair ``compute-cmvn-stats`` / ``apply-cmvn`` behind the recipe's
``cmvn=true``: per-speaker stats via ``--utt2spk``, the output written as a
fresh ark+scp pair).

Stats use Kaldi's layout: a [2, dim+1] matrix, row 0 the per-dim sums with
the frame count in the last column, row 1 the per-dim sums of squares (last
column unused), so stat arks are interchangeable with Kaldi's."""

from __future__ import annotations

import sys

import numpy as np

from pytorch_kaldi_asr_tpu_torch.io import kaldi_io
from pytorch_kaldi_asr_tpu_torch.utils.logging import log_startup


def table_path(spec):
    """The file of a ``--utt2spk=ark:f`` style option value."""
    return spec.split(":", 1)[1] if ":" in spec else spec


def accumulate_cmvn_stats(feats_iter, spk_of=None):
    """Accumulate per-speaker (or per-utterance) stats.

    feats_iter: iterable of (utt_key, matrix); spk_of: {utt: spk} or None
    for per-utterance stats.  Returns {spk: [2, dim+1] float64}."""
    stats = {}
    for key, mat in feats_iter:
        spk = spk_of[key] if spk_of is not None else key
        mat = np.asarray(mat, dtype=np.float64)
        s = stats.get(spk)
        if s is None:
            s = np.zeros((2, mat.shape[1] + 1))
            stats[spk] = s
        s[0, :-1] += mat.sum(axis=0)
        s[0, -1] += mat.shape[0]
        s[1, :-1] += (mat ** 2).sum(axis=0)
    return stats


def apply_cmvn_matrix(mat, stats, norm_vars=False):
    """Normalize one utterance with its speaker's stats."""
    count = stats[0, -1]
    mean = stats[0, :-1] / count
    out = np.asarray(mat, dtype=np.float64) - mean
    if norm_vars:
        var = stats[1, :-1] / count - mean ** 2
        out = out / np.sqrt(np.maximum(var, 1e-20))
    return out.astype(np.float32)


def compute_cmvn_stats(feats_rspecifier, stats_wspecifier, utt2spk=None):
    """``utt2spk``: a ``utt spk`` table's path, a {utt: spk} mapping, or
    None for per-utterance stats."""
    spk_of = (kaldi_io.read_key_value_text(utt2spk)
              if isinstance(utt2spk, str) else utt2spk)
    stats = accumulate_cmvn_stats(
        kaldi_io.read_table(feats_rspecifier), spk_of
    )
    with kaldi_io.open_writer(stats_wspecifier) as w:
        for spk, s in stats.items():
            w.write(spk, s)
    return stats


def apply_cmvn(stats_rspecifier, feats_rspecifier, out_wspecifier, *,
               utt2spk=None, norm_vars=False):
    stats = dict(kaldi_io.read_table(stats_rspecifier))
    spk_of = kaldi_io.read_key_value_text(utt2spk) if utt2spk else None
    n = 0
    with kaldi_io.open_writer(out_wspecifier) as w:
        for key, mat in kaldi_io.read_table(feats_rspecifier):
            spk = spk_of[key] if spk_of is not None else key
            w.write(key, apply_cmvn_matrix(mat, stats[spk],
                                           norm_vars=norm_vars))
            n += 1
    return n


def main(argv=None):
    """CLI: apply-cmvn [--utt2spk=ark:f] [--norm-vars=true] <stats-rspec>
    <feats-rspec> <out-wspec>   (the Kaldi CLI contract)"""
    argv = list(argv or sys.argv[1:])
    utt2spk = None
    norm_vars = False
    rest = []
    for a in argv:
        if a.startswith("--utt2spk="):
            utt2spk = table_path(a.split("=", 1)[1])
        elif a.startswith("--norm-vars="):
            norm_vars = a.split("=", 1)[1] == "true"
        else:
            rest.append(a)
    if len(rest) != 3:
        print(
            "usage: cmvn [--utt2spk=ark:f] [--norm-vars=bool] "
            "<stats-rspecifier> <feats-rspecifier> <out-wspecifier>",
            file=sys.stderr,
        )
        return 1
    apply_cmvn(rest[0], rest[1], rest[2], utt2spk=utt2spk,
               norm_vars=norm_vars)
    return 0


if __name__ == "__main__":
    log_startup()
    sys.exit(main())
