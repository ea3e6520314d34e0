"""LDA(+bias) estimation over spliced features.

The reference consumes a Kaldi-trained ``lda.mat`` affine (last column =
bias; initialize_model.py:69, TDNN.py:51-52) produced by an external
LDA/MLLT pipeline.  This estimator provides that capability in-framework:
classic Fisher LDA on (spliced-feature, frame-label) pairs, emitting the
same ``[out_dim, in_dim+1]`` affine layout, with the bias centering the
projected features (as Kaldi's est-lda does)."""

from __future__ import annotations

import numpy as np

from pytorch_kaldi_asr_tpu_torch.utils.logging import info


def estimate_lda(feature_label_pairs, out_dim=None, *, floor=1e-6):
    """Estimate an LDA affine.

    feature_label_pairs: iterable of (feats [n, d], labels [n] int).
    Returns ``lda_mat [out_dim, d+1]`` (last column = bias)."""
    class_sum = {}
    class_count = {}
    total_sum = None
    total_sq = None
    n_total = 0
    for feats, labels in feature_label_pairs:
        feats = np.asarray(feats, np.float64)
        labels = np.asarray(labels)
        if total_sum is None:
            total_sum = np.zeros(feats.shape[1])
            total_sq = np.zeros((feats.shape[1], feats.shape[1]))
        total_sum += feats.sum(0)
        total_sq += feats.T @ feats
        n_total += feats.shape[0]
        for c in np.unique(labels):
            sel = feats[labels == c]
            class_sum[c] = class_sum.get(c, 0) + sel.sum(0)
            class_count[c] = class_count.get(c, 0) + sel.shape[0]

    d = total_sum.shape[0]
    mean = total_sum / n_total
    total_cov = total_sq / n_total - np.outer(mean, mean)

    between = np.zeros((d, d))
    for c, s in class_sum.items():
        mu_c = s / class_count[c]
        diff = mu_c - mean
        between += class_count[c] * np.outer(diff, diff)
    between /= n_total
    within = total_cov - between
    within += floor * np.trace(within) / d * np.eye(d)

    # generalized symmetric eigenproblem B v = λ W v via Cholesky whitening:
    # W = L Lᵀ; eigh(L⁻¹ B L⁻ᵀ) is symmetric (np.linalg.eigh on the
    # non-symmetric W⁻¹B would silently use one triangle and give wrong
    # directions), then map eigenvectors back through L⁻ᵀ.
    chol = np.linalg.cholesky(within)
    b_sym = (between + between.T) / 2.0
    m = np.linalg.solve(chol, np.linalg.solve(chol, b_sym).T).T
    evals, evecs = np.linalg.eigh((m + m.T) / 2.0)
    order = np.argsort(evals)[::-1]
    out_dim = out_dim or min(len(class_sum) - 1, d)
    u = evecs[:, order[:out_dim]]
    w = np.linalg.solve(chol.T, u).T  # [out_dim, d]

    # normalize rows so projected within-class covariance ≈ I (Kaldi style)
    proj_within = w @ within @ w.T
    scales = 1.0 / np.sqrt(np.maximum(np.diag(proj_within), floor))
    w = w * scales[:, None]

    bias = -(w @ mean)
    lda_mat = np.concatenate([w, bias[:, None]], axis=1).astype(np.float32)
    info("estimated LDA %dx%d from %d frames / %d classes",
         lda_mat.shape[0], lda_mat.shape[1], n_total, len(class_sum))
    return lda_mat
