"""Lattice rescoring with a neural (or ARPA) language model — the Kaldi
steps/lmrescore*.sh role for the hybrid path: replace each lattice
hypothesis's graph/LM cost with a new LM's score and re-rank (the port's
copy of ``pytorch_kaldi_asr_tpu.tools.lattice_rescore``).

For every utterance lattice: extract the n lowest-cost DISTINCT word
sequences with their UNSCALED acoustic/graph cost split
(decode/lattice_ops.py nbest with_components), score each sequence with
the new LM, and pick

    argmin  acoustic_scale * am_cost
          + graph_scale    * graph_cost      (0 = replace the old LM)
          + lm_scale       * new_lm_cost     (-ln p from the new LM)

Usage::

    python3 -m pytorch_kaldi_asr_tpu_torch.tools.lattice_rescore \
        -words graph/words.txt -nlm_model_dir lang/nlm \
        -read_vocab_file lang/vocab.txt -acoustic_scale 0.1 -lm_scale 1.0 \
        ark:lat.ark best.txt

    # ARPA instead of neural:
    ... -lm lang/lm.3k.gz ark:lat.ark best.txt

The neural LM runs on ``-device`` (``cuda`` by default; ``cpu`` on
request; without a visible card and without ``-device cpu`` it raises);
torch is imported for it only, so the ARPA path, on the host, starts as
cheaply as the other lattice tools.
"""

from __future__ import annotations

import argparse
import math
import sys

from pytorch_kaldi_asr_tpu_torch.decode.lattice_ops import nbest
from pytorch_kaldi_asr_tpu_torch.tools.lattice_copy import (
    _read_words,
    read_lattices,
)
from pytorch_kaldi_asr_tpu_torch.utils.logging import info, log_startup

LN10 = math.log(10.0)


def rescore_hyps(hyps, lm_costs, *, acoustic_scale, graph_scale, lm_scale):
    """Re-rank [(words, total, am, graph)] with new per-hypothesis LM
    costs (-ln p).  Returns the list re-sorted by the new combined cost,
    as (words, new_cost) pairs."""
    rescored = [
        (words, acoustic_scale * am + graph_scale * gr + lm_scale * lc)
        for (words, _total, am, gr), lc in zip(hyps, lm_costs)
    ]
    rescored.sort(key=lambda e: e[1])
    return rescored


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="rescore lattice n-best with a new LM")
    parser.add_argument("-words", required=True, help="word symbol table")
    parser.add_argument("-nlm_model_dir", default=None)
    parser.add_argument("-read_vocab_file", default=None,
                        help="vocab for -nlm_model_dir")
    parser.add_argument("-lm", default=None, help="ARPA LM (.gz ok)")
    parser.add_argument("-n", type=int, default=20,
                        help="hypotheses considered per lattice")
    parser.add_argument("-acoustic_scale", type=float, default=1.0)
    parser.add_argument("-graph_scale", type=float, default=0.0,
                        help="weight of the OLD graph/LM cost (0 = "
                             "replace it; >0 interpolates)")
    parser.add_argument("-lm_scale", type=float, default=1.0,
                        help="weight of the new LM's -ln p")
    parser.add_argument("-device", default="cuda",
                        help="the neural LM's device: cuda (default), "
                             "cuda:N or cpu")
    parser.add_argument("rspecifier", help="ark:lattices")
    parser.add_argument("out", help="best transcripts: 'utt words'")
    opt = parser.parse_args(argv)
    if bool(opt.lm) == bool(opt.nlm_model_dir):
        parser.error("pass exactly one of -lm / -nlm_model_dir")

    word2id = _read_words(opt.words)

    if opt.nlm_model_dir:
        if not opt.read_vocab_file:
            parser.error("-nlm_model_dir needs -read_vocab_file")
        from pytorch_kaldi_asr_tpu_torch.data.instances import read_vocab
        from pytorch_kaldi_asr_tpu_torch.models.nlm import (
            load_nlm,
            score_sentences,
        )
        from pytorch_kaldi_asr_tpu_torch.utils.device import (
            disable_tf32,
            resolve_device,
        )

        device = resolve_device(opt.device)
        disable_tf32()
        params, cfg, _ = load_nlm(opt.nlm_model_dir, device=device)
        vocab = read_vocab(opt.read_vocab_file)

        def lm_costs(seqs):
            # score_sentences returns log10 p -> cost is -ln p
            return [-s * LN10
                    for s in score_sentences(params, cfg, seqs, vocab)]
    else:
        from pytorch_kaldi_asr_tpu_torch.lm import read_arpa

        arpa = read_arpa(opt.lm)

        def lm_costs(seqs):
            return [-arpa.sentence_logprob(seq)[0] * LN10 for seq in seqs]

    # Pass 1: extract every lattice's n-best.  Extraction ranks at the
    # RESCORING acoustic scale (Kaldi lmrescore semantics) — ranking at
    # unit scales would bias the candidate set and could drop the true
    # argmin of the rescored objective; the returned components stay raw.
    per_utt = []  # (utt, hyps)
    for key, lat in read_lattices(opt.rspecifier, word2id):
        utt = lat.utt or key
        per_utt.append((utt, nbest(lat, opt.n,
                                   acoustic_scale=opt.acoustic_scale,
                                   with_components=True)))

    # Pass 2: ONE LM scoring call over all hypotheses of all utterances
    # (per-utterance calls would batch the neural scorer per lattice)
    all_seqs = [words for _utt, hyps in per_utt
                for words, *_ in hyps]
    all_costs = lm_costs(all_seqs) if all_seqs else []

    n_done = 0
    pos = 0
    with open(opt.out, "w", encoding="utf-8") as f:
        for utt, hyps in per_utt:
            if not hyps:
                f.write(f"{utt}\n")
                continue
            costs = all_costs[pos : pos + len(hyps)]
            pos += len(hyps)
            best_words, _cost = rescore_hyps(
                hyps, costs, acoustic_scale=opt.acoustic_scale,
                graph_scale=opt.graph_scale, lm_scale=opt.lm_scale)[0]
            f.write(f"{utt} {' '.join(best_words)}\n")
            n_done += 1
    info("lattice_rescore: %d utterances -> %s", n_done, opt.out)
    if opt.nlm_model_dir:
        from pytorch_kaldi_asr_tpu_torch.ops.launches import log_launch_counts

        log_launch_counts(device)
    return 0


if __name__ == "__main__":
    log_startup()
    raise SystemExit(main())
