"""Transform-matrix generators (role of the vendored utils/nnet helpers:
gen_dct_mat.py, gen_hamm_mat.py, gen_splice.py — the matrices Kaldi nnet
prototypes splice into their input layers)."""

from __future__ import annotations

import math

import numpy as np


def dct_matrix(num_ceps, num_bins, orthonormal=True):
    """DCT-II basis [num_ceps, num_bins] (gen_dct_mat.py role; the same
    basis fbank.py uses for MFCC)."""
    k = np.arange(num_ceps)[:, None]
    n = np.arange(num_bins)[None, :]
    basis = np.cos(math.pi / num_bins * (n + 0.5) * k)
    if orthonormal:
        basis = basis * math.sqrt(2.0 / num_bins)
        basis[0] *= 1.0 / math.sqrt(2.0)
    return basis.astype(np.float32)


def hamming_window(length, periodic=False):
    """Hamming window (gen_hamm_mat.py role)."""
    n = length if periodic else length - 1
    i = np.arange(length)
    return (0.54 - 0.46 * np.cos(2 * math.pi * i / n)).astype(np.float32)


def splice_indices(left, right, step=1):
    """Context offset list [-left..right] (gen_splice.py role); feed to
    models.common.splice_frames / spliced_linear."""
    return list(range(-left, right + 1, step))


def splice_matrix(dim, context):
    """Explicit splice as a sparse selection matrix
    [dim·len(context), dim·len(context)] → identity blocks; provided for
    tools that want the transform as a matrix (Kaldi nnet proto style).
    Note the in-model path uses splice_frames/conv instead."""
    k = len(context)
    return np.eye(dim * k, dtype=np.float32)
