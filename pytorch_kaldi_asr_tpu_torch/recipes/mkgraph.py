"""Compile a decoding graph: lexicon + ARPA LM -> HLG.fst (the port's
copy of ``pytorch_kaldi_asr_tpu.recipes.mkgraph``, on the host).

Inputs are a lexicon text file (``word phone phone ...``, optionally
``word prob phone ...`` with -pron_probs), an ARPA LM (.gz ok), and a
phone symbol table; outputs a binary graph plus the word/phone tables the
latgen CLI needs.  For phone-recognition recipes (where targets ARE
phones) use -self_lexicon to generate the identity lexicon from the phone
table.  ``-topo`` (HMM topology files) is not ported yet (ROADMAP.md,
queue 1 item 8b).
"""

from __future__ import annotations

import argparse
import os

from pytorch_kaldi_asr_tpu_torch.fst.graph import mkgraph
from pytorch_kaldi_asr_tpu_torch.fst.openfst_io import write_const_fst
from pytorch_kaldi_asr_tpu_torch.lm.arpa import read_arpa
from pytorch_kaldi_asr_tpu_torch.utils.logging import info, log_startup


def read_symbol_table(path):
    syms = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                syms[parts[0]] = int(parts[1])
    return syms


def write_symbol_table(path, syms):
    with open(path, "w", encoding="utf-8") as f:
        for k, v in sorted(syms.items(), key=lambda kv: kv[1]):
            f.write(f"{k} {v}\n")


def read_lexicon(path, pron_probs=False):
    lex = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            word = parts[0]
            if pron_probs:
                prob, phones = float(parts[1]), parts[2:]
            else:
                prob, phones = 1.0, parts[1:]
            lex.setdefault(word, []).append((prob, phones))
    return lex


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-phones", required=True, help="phone symbol table")
    parser.add_argument("-lexicon", help="lexicon text file")
    parser.add_argument("-self_lexicon", action="store_true",
                        help="identity lexicon: every phone is a word")
    parser.add_argument("-pron_probs", action="store_true")
    parser.add_argument("-lm", required=True, help="ARPA LM (.gz ok)")
    parser.add_argument("-sil_phone", default=None)
    parser.add_argument("-sil_prob", type=float, default=0.5)
    parser.add_argument("-self_loop_prob", type=float, default=0.5)
    parser.add_argument("-no_hmm_loops", action="store_true")
    parser.add_argument("-topo", default=None,
                        help="HMM topology file: not ported yet")
    parser.add_argument("-fst_type", choices=("vector", "const"),
                        default="vector",
                        help="HLG.fst on-disk layout (fstconvert "
                             "--fst_type=const role)")
    parser.add_argument("-graph_dir", required=True)
    opt = parser.parse_args(argv)
    if opt.topo:
        raise NotImplementedError(
            "mkgraph -topo is not ported to pytorch_kaldi_asr_tpu_torch yet "
            "(ROADMAP.md, queue 1 item 8b: tools/lang)")

    phone_syms = read_symbol_table(opt.phones)
    if opt.self_lexicon:
        lexicon = {ph: [(1.0, [ph])] for ph in phone_syms
                   if not ph.startswith("#") and ph != "<eps>"}
    elif opt.lexicon:
        lexicon = read_lexicon(opt.lexicon, opt.pron_probs)
    else:
        parser.error("need -lexicon or -self_lexicon")

    lm = read_arpa(opt.lm)
    word_syms = {w: i + 1 for i, w in enumerate(sorted(lexicon))}

    graph, phone_syms_ext = mkgraph(
        lexicon, lm, word_syms, phone_syms,
        sil_phone=opt.sil_phone, sil_prob=opt.sil_prob,
        hmm_loops=not opt.no_hmm_loops,
        self_loop_prob=opt.self_loop_prob,
    )
    os.makedirs(opt.graph_dir, exist_ok=True)
    if opt.fst_type == "const":
        write_const_fst(graph, os.path.join(opt.graph_dir, "HLG.fst"))
    else:
        graph.write_binary(os.path.join(opt.graph_dir, "HLG.fst"))
    write_symbol_table(os.path.join(opt.graph_dir, "words.txt"), word_syms)
    write_symbol_table(os.path.join(opt.graph_dir, "phones.txt"),
                       phone_syms_ext)
    info("graph: %d states, %d arcs -> %s/HLG.fst", graph.num_states,
         graph.num_arcs, opt.graph_dir)
    return 0


if __name__ == "__main__":
    log_startup()
    raise SystemExit(main())
