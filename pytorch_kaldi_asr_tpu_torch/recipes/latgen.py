"""Graph decoding of dumped posteriors: HLG.fst + posterior ark -> text
and word lattices (the port's copy of ``pytorch_kaldi_asr_tpu.recipes.
latgen``, the host decoder).

The latgen-faster role over recipes/dump_posteriors.py output, finishing
the hybrid-AM pipeline (posterior dump -> graph decode -> WER).  Reads the
graph dir written by recipes/mkgraph.py; posteriors are LOG posteriors as
dumped by the AM (``-priors_file``, a numpy .npy of log-priors, turns them
into pseudo-likelihoods, as in decode/latgen.py).  The search runs on the
host, token passing in Python (decode/latgen.py).  With any of
``-save_lattice_file`` (Kaldi text), ``-save_lattice_ark`` (Kaldi binary
CompactLattice, with a ``.scp`` beside it) or ``-save_slf`` (HTK SLF, a
file or a directory) it decodes through ``latgen_lattice`` at
``-lattice_beam`` and writes each lattice's best path as the result.  Not
ported yet, and refused by name: ``-device_search``, ``-device_batch``
and ``-device_mode`` (ROADMAP.md, queue 1 item 11).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from pytorch_kaldi_asr_tpu_torch.decode.latgen import (
    decode_posterior_ark,
    latgen_lattice,
)
from pytorch_kaldi_asr_tpu_torch.decode.lattice_io import write_slf_file
from pytorch_kaldi_asr_tpu_torch.fst.openfst_io import (
    read_fst,
    write_lattice_ark,
)
from pytorch_kaldi_asr_tpu_torch.io.kaldi_io import read_mat_ark, read_mat_scp
from pytorch_kaldi_asr_tpu_torch.recipes.mkgraph import read_symbol_table
from pytorch_kaldi_asr_tpu_torch.utils.logging import info, log_startup

# the device search's flags: refused by name when given
NOT_PORTED = {"device_search": False, "device_batch": None,
              "device_mode": None}


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
    parser.add_argument("-lattice_beam", type=float, default=8.0)
    parser.add_argument("-save_lattice_file", default=None,
                        help="also emit pruned word lattices (kaldi text)")
    parser.add_argument("-save_lattice_ark", default=None,
                        help="also emit Kaldi BINARY CompactLattice ark "
                             "(+ .scp next to it)")
    parser.add_argument("-save_slf", default=None,
                        help="also emit HTK SLF lattices (file or dir)")
    parser.add_argument("-device_search", action="store_true",
                        help="not ported yet")
    parser.add_argument("-device_batch", type=int, default=None,
                        help="not ported yet")
    parser.add_argument("-device_mode", default=None, help="not ported yet")
    opt = parser.parse_args(argv)
    for name, unset in NOT_PORTED.items():
        if getattr(opt, name) != unset:
            raise NotImplementedError(
                f"latgen -{name} is not ported to pytorch_kaldi_asr_tpu_torch "
                "yet (ROADMAP.md, queue 1 item 11: device WFST decoding)")

    # read_fst accepts both VectorFst and ConstFst HLG graphs
    graph = read_fst(os.path.join(opt.graph_dir, "HLG.fst"))
    word_syms = read_symbol_table(os.path.join(opt.graph_dir, "words.txt"))
    log_priors = np.load(opt.priors_file) if opt.priors_file else None

    kind, path = opt.rspecifier.split(":", 1)
    reader = read_mat_scp(path) if kind == "scp" else read_mat_ark(path)

    n = 0
    if opt.save_lattice_file or opt.save_slf or opt.save_lattice_ark:
        id2word = {v: k for k, v in word_syms.items()}
        lats = []
        with open(opt.save_result_file, "w", encoding="utf-8") as f:
            for key, mat in reader:
                lat = latgen_lattice(
                    graph, mat, acoustic_scale=opt.acoustic_scale,
                    beam=opt.beam, lattice_beam=opt.lattice_beam,
                    max_active=opt.max_active, log_priors=log_priors,
                    id2word=id2word, utt=key,
                )
                if lat is None:
                    f.write(f"{key} \n")
                    continue
                words, _ = lat.best_path()
                f.write(f"{key} {' '.join(words)}\n")
                lats.append(lat)
                n += 1
        if opt.save_lattice_file:
            with open(opt.save_lattice_file, "w", encoding="utf-8") as f:
                for lat in lats:
                    f.write(f"{lat.utt}\n")
                    lat.write_kaldi_text(f)
                    f.write("\n")
        if opt.save_lattice_ark:
            write_lattice_ark(lats, opt.save_lattice_ark, word_syms,
                              scp_path=opt.save_lattice_ark + ".scp")
        if opt.save_slf:
            write_slf_file(lats, opt.save_slf)
    else:
        results = decode_posterior_ark(
            graph, reader, word_syms, acoustic_scale=opt.acoustic_scale,
            beam=opt.beam, max_active=opt.max_active, log_priors=log_priors)
        with open(opt.save_result_file, "w", encoding="utf-8") as f:
            for key, text, _cost in results:
                f.write(f"{key} {text}\n")
                n += 1
    info("decoded %d utterances -> %s", n, opt.save_result_file)
    return 0


if __name__ == "__main__":
    log_startup()
    raise SystemExit(main())
