"""Dump per-utterance log-posteriors from a trained hybrid AM to a Kaldi
ark/scp pair (the port's ``pytorch_kaldi_asr_tpu.recipes.dump_posteriors``;
the artifact the WFST decoder, recipes/latgen.py, consumes), on the card.

Same flags as the JAX CLI plus ``-device`` (``cuda`` by default; ``cpu``
on request; without a visible card and without ``-device cpu`` it raises
rather than fall back).  ``-priors_file`` (a text file of class priors, as
tools/compute_priors.py writes) divides the priors out: the log-posteriors
minus the log-priors, the hybrid likelihood scaling."""

import argparse
import os

import numpy as np
import torch

from pytorch_kaldi_asr_tpu_torch.data.loader import BatchLoader
from pytorch_kaldi_asr_tpu_torch.io import kaldi_io
from pytorch_kaldi_asr_tpu_torch.models import am
from pytorch_kaldi_asr_tpu_torch.ops.launches import log_launch_counts
from pytorch_kaldi_asr_tpu_torch.train.checkpoint import load_checkpoint
from pytorch_kaldi_asr_tpu_torch.utils.device import disable_tf32, resolve_device
from pytorch_kaldi_asr_tpu_torch.utils.logging import info, log_startup


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-read_data_dir", required=True)
    parser.add_argument("-load_model_file", required=True)
    parser.add_argument("-wspecifier", required=True,
                        help="e.g. ark,scp:post.ark,post.scp")
    parser.add_argument("-batch_size", type=int, default=16)
    parser.add_argument("-priors_file", default=None,
                        help="optional text file of class priors to divide "
                             "out (hybrid likelihood scaling)")
    parser.add_argument("-device", default="cuda",
                        help="cuda (default), cuda:N or cpu")
    opt = parser.parse_args(argv)

    device = resolve_device(opt.device)
    disable_tf32()
    ckpt = load_checkpoint(opt.load_model_file, device=device)
    params, cfg = ckpt["params"], ckpt["cfg"]
    n_targets = ckpt["meta"].get("n_targets")

    feats = dict(kaldi_io.scp_entries(
        os.path.join(opt.read_data_dir, "feats.scp")))
    triples = [(k, rx, np.zeros(1, np.int32)) for k, rx in feats.items()]
    loader = BatchLoader(triples, opt.batch_size, mode="all", shuffle=False)

    log_priors = None
    if opt.priors_file:
        priors = np.atleast_1d(np.loadtxt(opt.priors_file))
        if priors.shape != (n_targets,):
            raise ValueError(
                f"priors file has {priors.size} entries but the model "
                f"has {n_targets} targets — pass -n_targets to "
                f"compute_priors"
            )
        log_priors = torch.log(torch.tensor(priors / priors.sum(),
                                            dtype=torch.float32)).to(device)

    n = am.write_posteriors(params, cfg, loader, opt.wspecifier, device,
                            log_priors=log_priors)
    info("wrote posteriors for %d utterances", n)
    log_launch_counts(device)
    return 0


if __name__ == "__main__":
    log_startup()
    raise SystemExit(main())
