"""Class-prior estimation from frame alignments (the port's copy of
``pytorch_kaldi_asr_tpu.tools.compute_priors``; the hybrid-AM companion to
dump_posteriors: posteriors divided by priors give the scaled likelihoods a
WFST decoder expects).  Counts over ``ali.txt`` tables with add-one
smoothing."""

import argparse

import numpy as np

from pytorch_kaldi_asr_tpu_torch.io import kaldi_io
from pytorch_kaldi_asr_tpu_torch.utils.logging import info, log_startup


def compute_priors(ali_files, n_targets=None, smoothing=1.0):
    """``n_targets`` should be the MODEL's output dimension (e.g. the
    checkpoint's n_targets); inferring it from the alignments (the default)
    undercounts whenever the top classes never occur."""
    counts = {}
    for path in ali_files:
        table = kaldi_io.read_key_value_text(path)
        for key, value in table.items():
            for tok in value.split():
                tid = int(tok)
                if tid < 0:
                    raise ValueError(
                        f"negative alignment id {tid} for utterance "
                        f"{key!r} in {path}"
                    )
                counts[tid] = counts.get(tid, 0) + 1
    if not counts:
        raise ValueError(
            "no alignment frames found in: " + ", ".join(ali_files)
        )
    if n_targets is None:
        n_targets = max(counts) + 1
    elif max(counts) >= n_targets:
        raise ValueError(
            f"alignment id {max(counts)} out of range for "
            f"n_targets={n_targets}"
        )
    priors = np.full(n_targets, float(smoothing), np.float64)
    for tid, c in counts.items():
        priors[tid] += c
    priors /= priors.sum()
    info("priors over %d classes from %d frames",
         n_targets, int(sum(counts.values())))
    return priors


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-ali", nargs="+", required=True,
                        help="alignment tables (key id id ...)")
    parser.add_argument("-n_targets", type=int, default=None,
                        help="model output dim (recommended; default infers "
                             "max-seen-id+1 from the alignments)")
    parser.add_argument("-smoothing", type=float, default=1.0)
    parser.add_argument("-save_priors_file", required=True)
    opt = parser.parse_args(argv)
    priors = compute_priors(opt.ali, opt.n_targets, smoothing=opt.smoothing)
    np.savetxt(opt.save_priors_file, priors)
    return 0


if __name__ == "__main__":
    log_startup()
    raise SystemExit(main())
