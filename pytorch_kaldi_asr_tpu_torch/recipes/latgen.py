"""Graph decoding of dumped posteriors: HLG.fst + posterior ark -> text
(the port's copy of ``pytorch_kaldi_asr_tpu.recipes.latgen``, the host
decoder's best paths).

The latgen-faster role over recipes/dump_posteriors.py output, finishing
the hybrid-AM pipeline (posterior dump -> graph decode -> WER).  Reads the
graph dir written by recipes/mkgraph.py; posteriors are LOG posteriors as
dumped by the AM (``-priors_file``, a numpy .npy of log-priors, turns them
into pseudo-likelihoods, as in decode/latgen.py).  The search runs on the
host, token passing in Python (decode/latgen.py).  Not ported yet, and
refused by name: ``-device_search`` (ROADMAP.md, queue 1 item 11) and the
lattice outputs ``-save_lattice_file``, ``-save_lattice_ark`` and
``-save_slf`` (queue 1 item 8, the lattice tools).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from pytorch_kaldi_asr_tpu_torch.decode.latgen import decode_posterior_ark
from pytorch_kaldi_asr_tpu_torch.fst.openfst_io import read_fst
from pytorch_kaldi_asr_tpu_torch.io.kaldi_io import read_mat_ark, read_mat_scp
from pytorch_kaldi_asr_tpu_torch.recipes.mkgraph import read_symbol_table
from pytorch_kaldi_asr_tpu_torch.utils.logging import info, log_startup

NOT_PORTED = {
    "device_search": "queue 1 item 11: device WFST decoding",
    "save_lattice_file": "queue 1 item 8: the lattice tools",
    "save_lattice_ark": "queue 1 item 8: the lattice tools",
    "save_slf": "queue 1 item 8: the lattice tools",
}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-graph_dir", required=True)
    parser.add_argument("-rspecifier", required=True,
                        help="posterior input, ark:file or scp:file")
    parser.add_argument("-save_result_file", required=True)
    parser.add_argument("-acoustic_scale", type=float, default=1.0)
    parser.add_argument("-beam", type=float, default=16.0)
    parser.add_argument("-max_active", type=int, default=2000)
    parser.add_argument("-priors_file", default=None,
                        help="numpy .npy log-priors to subtract")
    parser.add_argument("-save_lattice_file", default=None,
                        help="not ported yet")
    parser.add_argument("-save_lattice_ark", default=None,
                        help="not ported yet")
    parser.add_argument("-save_slf", default=None, help="not ported yet")
    parser.add_argument("-device_search", action="store_true",
                        help="not ported yet")
    opt = parser.parse_args(argv)
    for name, item in NOT_PORTED.items():
        if getattr(opt, name):
            raise NotImplementedError(
                f"latgen -{name} is not ported to pytorch_kaldi_asr_tpu_torch "
                f"yet (ROADMAP.md, {item})")

    # read_fst accepts both VectorFst and ConstFst HLG graphs
    graph = read_fst(os.path.join(opt.graph_dir, "HLG.fst"))
    word_syms = read_symbol_table(os.path.join(opt.graph_dir, "words.txt"))
    log_priors = np.load(opt.priors_file) if opt.priors_file else None

    kind, path = opt.rspecifier.split(":", 1)
    reader = read_mat_scp(path) if kind == "scp" else read_mat_ark(path)
    results = decode_posterior_ark(
        graph, reader, word_syms, acoustic_scale=opt.acoustic_scale,
        beam=opt.beam, max_active=opt.max_active, log_priors=log_priors)
    n = 0
    with open(opt.save_result_file, "w", encoding="utf-8") as f:
        for key, text, _cost in results:
            f.write(f"{key} {text}\n")
            n += 1
    info("decoded %d utterances -> %s", n, opt.save_result_file)
    return 0


if __name__ == "__main__":
    log_startup()
    raise SystemExit(main())
