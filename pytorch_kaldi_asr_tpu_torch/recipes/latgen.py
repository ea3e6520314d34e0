"""Graph decoding of dumped posteriors: HLG.fst + posterior ark -> text
and word lattices (the port's copy of ``pytorch_kaldi_asr_tpu.recipes.
latgen``, the host decoder).

The latgen-faster role over recipes/dump_posteriors.py output, finishing
the hybrid-AM pipeline (posterior dump -> graph decode -> WER).  Reads the
graph dir written by recipes/mkgraph.py; posteriors are LOG posteriors as
dumped by the AM (``-priors_file``, a numpy .npy of log-priors, turns them
into pseudo-likelihoods, as in decode/latgen.py).  The search runs on the
host, token passing in the port's native C++ core (decode/latgen.py,
native/src/latgen.cc, built at first use; a failed build is an error),
and it logs the decoder it ran.  With any of
``-save_lattice_file`` (Kaldi text), ``-save_lattice_ark`` (Kaldi binary
CompactLattice, with a ``.scp`` beside it) or ``-save_slf`` (HTK SLF, a
file or a directory) it decodes through ``latgen_lattice`` at
``-lattice_beam`` and writes each lattice's best path as the result.

``-device_search`` runs the best-path search on the card instead
(decode/device_latgen.py): ``-device_batch`` utterances per call, the
dense decoder or the top-K frontier decoder by ``-device_mode`` (``auto``
picks by graph size), on ``-device`` (``cuda`` by default; without a card
it raises unless ``-device cpu`` is given).  It logs the decoder it ran,
the graph's size and the utterances the host decoder took over (an
overflowing traceback falls back to it, as in the JAX package).
"""

from __future__ import annotations

import argparse
import os
import time

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
                        help="run the graph search on the card (batched "
                             "Viterbi, decode/device_latgen) instead of "
                             "the host token-passing decoder; best-path "
                             "output only (no lattice emit)")
    parser.add_argument("-device_batch", type=int, default=8,
                        help="utterances per device call with "
                             "-device_search")
    parser.add_argument("-device_mode", default="auto",
                        choices=["auto", "dense", "frontier"],
                        help="device decoder flavor with -device_search: "
                             "dense full-state-table Viterbi, top-K "
                             "frontier search, or size-based auto pick")
    parser.add_argument("-device", default="cuda",
                        help="the device of -device_search: cuda (the "
                             "default; raises without a card), cuda:N or "
                             "cpu")
    opt = parser.parse_args(argv)

    if opt.device_search and (opt.save_lattice_file or opt.save_slf
                              or opt.save_lattice_ark):
        parser.error("-device_search emits best paths only; drop the "
                     "lattice outputs or use the host decoder")

    # read_fst accepts both VectorFst and ConstFst HLG graphs
    graph = read_fst(os.path.join(opt.graph_dir, "HLG.fst"))
    word_syms = read_symbol_table(os.path.join(opt.graph_dir, "words.txt"))
    log_priors = np.load(opt.priors_file) if opt.priors_file else None

    kind, path = opt.rspecifier.split(":", 1)
    reader = read_mat_scp(path) if kind == "scp" else read_mat_ark(path)

    n = 0
    if not opt.device_search:
        info("host search: native C++ decoder (native/src/latgen.cc), graph "
             "%d states, %d arcs", graph.num_states, graph.num_arcs)
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
        decoder = None
        if opt.device_search:
            from pytorch_kaldi_asr_tpu_torch.decode.device_latgen import (
                decode_posterior_stream,
                make_device_latgen,
                pick_mode,
            )

            mode = pick_mode(graph, opt.device_mode)
            decoder = make_device_latgen(
                graph, mode=mode, acoustic_scale=opt.acoustic_scale,
                beam=opt.beam, max_active=opt.max_active,
                log_priors=log_priors, device=opt.device)
            info("device search: %s decoder (-device_mode %s) on %s, graph "
                 "%d states, %d arcs", mode, opt.device_mode, decoder.device,
                 graph.num_states, graph.num_arcs)
            results = decode_posterior_stream(
                graph, reader, word_syms, batch_size=opt.device_batch,
                decoder=decoder)
        else:
            results = decode_posterior_ark(
                graph, reader, word_syms, acoustic_scale=opt.acoustic_scale,
                beam=opt.beam, max_active=opt.max_active,
                log_priors=log_priors)
        t0 = time.perf_counter()
        with open(opt.save_result_file, "w", encoding="utf-8") as f:
            for key, text, _cost in results:
                f.write(f"{key} {text}\n")
                n += 1
        if decoder is not None:
            info("device search: %d host fallbacks; %.3f s reading and "
                 "decoding", decoder.host_fallbacks, time.perf_counter() - t0)
    info("decoded %d utterances -> %s", n, opt.save_result_file)
    return 0


if __name__ == "__main__":
    log_startup()
    raise SystemExit(main())
