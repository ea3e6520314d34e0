"""Minimal lang-dir preparation (the core of utils/prepare_lang.sh +
validate_dict_dir.pl's checks; the port's copy of
``pytorch_kaldi_asr_tpu.tools.prepare_lang``).

From a dict dir (``lexicon.txt`` word → pronunciation, optional
``silence_phones.txt``/``optional_silence.txt``), builds::

    lang/
      words.txt      word symbol table (<eps>=0, #0 disambig last)
      phones.txt     phone symbol table (<eps>=0, disambig symbols last)
      L.fst.txt      lexicon FST (phones in, words out, text form)
      oov.txt        the OOV word (default <unk>)
      topo           HMM topology (gen_topo.pl format; tools/lang.py)

The topology is real and consumed: fst.graph.mkgraph expands per-phone
HMMs from it (tools.lang.expand_hmm), and tools.lang.validate_lang checks
the dir (validate_lang.pl role).  The HCLG graph build itself lives in
recipes/mkgraph.py."""

from __future__ import annotations

import argparse
import os

from pytorch_kaldi_asr_tpu_torch.lm.fst import make_lexicon_fst_text
from pytorch_kaldi_asr_tpu_torch.utils.logging import info, log_startup


def read_lexicon(path):
    """{word: [(prob, [phones]), ...]} — supports lexicon.txt and
    lexiconp.txt (probability column) layouts."""
    lexicon = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if len(parts) < 2:
                continue
            word = parts[0]
            try:
                prob = float(parts[1])
                phones = parts[2:]
                if not phones:  # the "1.0" was actually a phone
                    raise ValueError
            except ValueError:
                prob = 1.0
                phones = parts[1:]
            lexicon.setdefault(word, []).append((prob, phones))
    return lexicon


def validate_dict(lexicon, silence_phones):
    """Basic validate_dict_dir.pl checks; returns problem list."""
    problems = []
    if not lexicon:
        problems.append("empty lexicon")
    for word, prons in lexicon.items():
        for _prob, phones in prons:
            if not phones:
                problems.append(f"word {word!r} has an empty pronunciation")
    return problems


def prepare_lang(dict_dir, lang_dir, *, oov_word="<unk>", sil_prob=0.5,
                 num_nonsil_states=1, num_sil_states=1):
    os.makedirs(lang_dir, exist_ok=True)
    lexicon = read_lexicon(os.path.join(dict_dir, "lexicon.txt"))

    sil_path = os.path.join(dict_dir, "optional_silence.txt")
    sil_phone = None
    if os.path.exists(sil_path):
        sil_phone = open(sil_path).read().split()[0]
    silence_phones = set()
    sp_path = os.path.join(dict_dir, "silence_phones.txt")
    if os.path.exists(sp_path):
        silence_phones = set(open(sp_path).read().split())

    problems = validate_dict(lexicon, silence_phones)
    if problems:
        raise ValueError("dict dir invalid: " + "; ".join(problems))

    phones = sorted(
        {p for prons in lexicon.values() for _w, ph in prons for p in ph}
        | silence_phones | ({sil_phone} if sil_phone else set())
    )
    phone_syms = {"<eps>": 0}
    for p in phones:
        phone_syms[p] = len(phone_syms)
    phone_syms["#0"] = len(phone_syms)  # LM backoff disambig on phone side

    word_syms = {"<eps>": 0}
    for w in sorted(lexicon):
        word_syms[w] = len(word_syms)
    if oov_word not in word_syms:
        word_syms[oov_word] = len(word_syms)
    word_syms["#0"] = len(word_syms)

    def write_syms(table, name):
        with open(os.path.join(lang_dir, name), "w", encoding="utf-8") as f:
            for sym, idx in table.items():
                f.write(f"{sym} {idx}\n")

    write_syms(word_syms, "words.txt")
    write_syms(phone_syms, "phones.txt")
    with open(os.path.join(lang_dir, "oov.txt"), "w") as f:
        f.write(oov_word + "\n")
    # real HMM topology (gen_topo.pl construction), consumed by
    # fst.graph.mkgraph via tools.lang.expand_hmm
    from pytorch_kaldi_asr_tpu_torch.tools.lang import gen_topo

    sil_ids = sorted(phone_syms[p] for p in silence_phones | (
        {sil_phone} if sil_phone else set()) if p in phone_syms)
    nonsil_ids = sorted(
        v for k, v in phone_syms.items()
        if v not in sil_ids and k != "<eps>" and not k.startswith("#"))
    with open(os.path.join(lang_dir, "topo"), "w") as f:
        f.write(gen_topo(nonsil_ids, sil_ids,
                         num_nonsil_states=num_nonsil_states,
                         num_sil_states=num_sil_states))

    make_lexicon_fst_text(
        lexicon, word_syms, phone_syms,
        os.path.join(lang_dir, "L.fst.txt"),
        sil_phone=sil_phone, sil_prob=sil_prob if sil_phone else 0.0,
    )
    info("lang dir prepared at %s (%d words, %d phones)", lang_dir,
         len(word_syms) - 2, len(phone_syms) - 2)
    return lang_dir


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("dict_dir")
    parser.add_argument("lang_dir")
    parser.add_argument("--oov", default="<unk>")
    parser.add_argument("--sil-prob", type=float, default=0.5)
    parser.add_argument("--num-nonsil-states", type=int, default=1)
    parser.add_argument("--num-sil-states", type=int, default=1)
    opt = parser.parse_args(argv)
    prepare_lang(opt.dict_dir, opt.lang_dir, oov_word=opt.oov,
                 sil_prob=opt.sil_prob,
                 num_nonsil_states=opt.num_nonsil_states,
                 num_sil_states=opt.num_sil_states)
    return 0


if __name__ == "__main__":
    log_startup()
    raise SystemExit(main())
