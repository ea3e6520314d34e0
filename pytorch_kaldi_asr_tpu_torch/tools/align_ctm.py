"""Forced-alignment CTM: posterior ark + reference text -> word-time CTM
(the port's copy of ``pytorch_kaldi_asr_tpu.tools.align_ctm``, on the
host).

The ali-to-phones --ctm-output / steps/get_train_ctm.sh role: align each
utterance's AM posteriors against its transcript (decode/align.py) and
emit NIST CTM lines whose times come from the per-frame alignment —
refining the lattice-node-frame times tools/lattice_to_ctm.py produces
(``-refine_ctm``).  Not ported yet, and refused by name: ``-topo`` (HMM
topology files), ROADMAP.md queue 1 item 8b.

Usage::

    python3 -m pytorch_kaldi_asr_tpu_torch.tools.align_ctm \
        -lexicon lang/lexicon.txt -phones graph/phones.txt \
        -sil_phone sil -text data/test/text -acoustic_scale 0.1 \
        ark:post.ark out.ctm

    # patch an existing consensus CTM's times in place of emitting fresh:
    ... -refine_ctm consensus.ctm ark:post.ark refined.ctm
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from pytorch_kaldi_asr_tpu_torch.decode.align import (
    align_graph,
    ctm_from_alignment,
    forced_align,
    refine_ctm_times,
    word_syms_from_lexicon,
)
from pytorch_kaldi_asr_tpu_torch.io.kaldi_io import read_mat_ark, read_mat_scp
from pytorch_kaldi_asr_tpu_torch.recipes.mkgraph import (
    read_lexicon,
    read_symbol_table,
)
from pytorch_kaldi_asr_tpu_torch.utils.logging import info, log_startup, warning


def read_text(path):
    out = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if parts:
                out[parts[0]] = parts[1:]
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="forced-alignment CTM from posteriors + transcripts")
    parser.add_argument("-lexicon", required=True)
    parser.add_argument("-pron_probs", action="store_true")
    parser.add_argument("-phones", required=True, help="phone symbol table")
    parser.add_argument("-text", required=True,
                        help="reference transcripts ('utt w1 w2 ...')")
    parser.add_argument("-sil_phone", default=None)
    parser.add_argument("-sil_prob", type=float, default=0.5)
    parser.add_argument("-self_loop_prob", type=float, default=0.5)
    parser.add_argument("-topo", default=None,
                        help="HMM topology file: not ported yet")
    parser.add_argument("-acoustic_scale", type=float, default=1.0)
    parser.add_argument("-priors_file", default=None,
                        help="numpy .npy log-priors to subtract")
    parser.add_argument("-frame_rate", type=float, default=0.01)
    parser.add_argument("-channel", type=int, default=1)
    parser.add_argument("-refine_ctm", default=None,
                        help="existing CTM whose times to patch (word "
                             "sequences that match the alignment) instead "
                             "of emitting alignment-only lines")
    parser.add_argument("rspecifier", help="ark:file or scp:file posteriors")
    parser.add_argument("ctm_out")
    opt = parser.parse_args(argv)
    if opt.topo:
        raise NotImplementedError(
            "align_ctm -topo is not ported to pytorch_kaldi_asr_tpu_torch "
            "yet (ROADMAP.md, queue 1 item 8b)")

    lexicon = read_lexicon(opt.lexicon, opt.pron_probs)
    phone_syms = read_symbol_table(opt.phones)
    word_syms = word_syms_from_lexicon(lexicon)
    id2word = {v: k for k, v in word_syms.items()}
    text = read_text(opt.text)
    log_priors = np.load(opt.priors_file) if opt.priors_file else None

    if opt.sil_phone is not None and opt.sil_phone not in phone_syms:
        raise SystemExit(
            f"align_ctm: -sil_phone {opt.sil_phone!r} is not in the phone "
            f"table {opt.phones} — silence handling would silently vanish "
            "(check the symbol's exact spelling/case)")
    sil_ids = {phone_syms[opt.sil_phone]} if opt.sil_phone else set()
    kind, path = opt.rspecifier.split(":", 1)
    reader = read_mat_scp(path) if kind == "scp" else read_mat_ark(path)

    # Real corpora have near-unique transcripts, so an unbounded
    # transcript-keyed cache is an OOM, not a cache — bound it FIFO.  The
    # hit case that matters (repeated prompts, CI fixtures) still wins.
    graph_cache = {}
    max_cache = 256
    aligned, failed = 0, 0
    lines = []
    alignments = {}
    for utt, mat in reader:
        words = text.get(utt)
        if words is None:
            warning("align_ctm: no transcript for %s, skipping", utt)
            failed += 1
            continue
        key = tuple(words)
        if key not in graph_cache:
            if len(graph_cache) >= max_cache:
                graph_cache.pop(next(iter(graph_cache)))
            try:
                graph_cache[key] = align_graph(
                    words, lexicon, word_syms, phone_syms,
                    sil_phone=opt.sil_phone, sil_prob=opt.sil_prob,
                    self_loop_prob=opt.self_loop_prob)[0]
            except ValueError as e:
                warning("align_ctm: %s: %s", utt, e)
                graph_cache[key] = None
        graph = graph_cache[key]
        ali = None
        if graph is not None:
            ali = forced_align(
                graph, np.asarray(mat, dtype=np.float64),
                acoustic_scale=opt.acoustic_scale, log_priors=log_priors,
                sil_ids=sil_ids)
        if ali is None:
            warning("align_ctm: alignment failed for %s", utt)
            failed += 1
            continue
        aligned += 1
        if opt.refine_ctm:
            # per-frame alignments are only consumed by the refine pass;
            # in plain mode keeping them would grow O(corpus frames)
            alignments[utt] = (ali, id2word)
        else:
            lines.extend(ctm_from_alignment(
                utt, ali, id2word, frame_rate=opt.frame_rate,
                channel=opt.channel))

    if opt.refine_ctm:
        with open(opt.refine_ctm, encoding="utf-8") as f:
            base = [ln.rstrip("\n") for ln in f if ln.strip()]
        lines, refined = refine_ctm_times(base, alignments,
                                          frame_rate=opt.frame_rate)
        info("align_ctm: refined times for %d utterances in %s",
             refined, opt.refine_ctm)

    with open(opt.ctm_out, "w", encoding="utf-8") as f:
        for line in lines:
            f.write(line + "\n")
    info("align_ctm: %d aligned, %d failed -> %s", aligned, failed,
         opt.ctm_out)
    return 0 if aligned or not failed else 1


if __name__ == "__main__":
    log_startup()
    sys.exit(main())
