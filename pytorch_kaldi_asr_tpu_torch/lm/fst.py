"""LM/lexicon FST construction in OpenFst text (AT&T) format (the port's
copy of ``pytorch_kaldi_asr_tpu.lm.fst``).

Replaces the graph-prep native tooling the reference shells out to:
``arpa2fst --disambig-symbol=#0`` (run.sh:61 — note SURVEY.md: its output
``lm.3k.fst`` is never consumed downstream) and the ``make_lexicon_fst.pl``
lexicon builder from the vendored Kaldi utils.  Output is the standard text
format (``src dst ilabel olabel [cost]`` lines plus final-state lines),
compilable by OpenFst's fstcompile when a binary graph is needed; costs are
negated natural logs, matching arpa2fst.
"""

from __future__ import annotations

import math

from pytorch_kaldi_asr_tpu_torch.lm.ngram import BOS_WORD, EOS_WORD, NgramLM
from pytorch_kaldi_asr_tpu_torch.utils.logging import info

LN10 = math.log(10.0)


def arpa_to_fst_text(lm: NgramLM, symbols, path, *, disambig_symbol="#0",
                     eps_symbol="<blank>"):
    """Compile a backoff LM to FST text form.

    States are n-gram histories; word arcs carry -log10prob·ln10, backoff
    arcs use the disambig symbol as input and epsilon as output (Kaldi's
    ``arpa2fst --disambig-symbol`` convention; the recipe maps eps to
    ``<blank>``, run.sh:60 comment).  ``symbols``: {word: id} including the
    disambig symbol."""
    states = {(): 1, (BOS_WORD,): 0}  # start state = <s> history

    def state_of(hist):
        hist = tuple(hist)
        if hist not in states:
            states[hist] = len(states)
        return states[hist]

    # every context that has continuations or a backoff weight is a state
    # (contexts with an implicit bow of 1 — legal ARPA — still need states,
    # otherwise their continuations become unreachable)
    for gram in lm.backoff:
        state_of(gram)
    for gram in lm.logprob:
        if len(gram) > 1:
            state_of(gram[:-1])

    arcs = []
    finals = {}  # </s> probabilities become weighted final states

    for gram, lp in sorted(lm.logprob.items()):
        word = gram[-1]
        hist = gram[:-1]
        if word == BOS_WORD:
            continue  # <s> has no incoming arc (it's the start history)
        cost = -lp * LN10
        src = state_of(hist)
        if word == EOS_WORD:
            finals[src] = min(finals.get(src, float("inf")), cost)
            continue
        # destination: longest suffix of (hist + word) that is a state
        dest_hist = hist + (word,)
        while dest_hist not in states and dest_hist:
            dest_hist = dest_hist[1:]
        dst = state_of(dest_hist)
        sym = symbols.get(word)
        if sym is None:
            continue  # OOV wrt the symbol table
        arcs.append((src, dst, sym, sym, cost))

    for hist, bow in lm.backoff.items():
        if len(hist) == 0:
            continue
        src = state_of(hist)
        dst = state_of(hist[1:])
        arcs.append(
            (src, dst, symbols[disambig_symbol], symbols.get(eps_symbol, 0),
             -bow * LN10)
        )

    # OpenFst's text format takes the FIRST line's source as the start
    # state: put state-0 (<s>-history) arcs first; if the LM has no
    # <s>-context n-grams at all (e.g. order 1), anchor the start with an
    # explicit backoff arc 0 → empty-history.
    arcs.sort(key=lambda a: a[0] != 0)
    if not any(a[0] == 0 for a in arcs):
        arcs.insert(
            0,
            (0, states[()], symbols.get(disambig_symbol, 0),
             symbols.get(eps_symbol, 0), 0.0),
        )
    with open(path, "w", encoding="utf-8") as f:
        for src, dst, il, ol, cost in arcs:
            f.write(f"{src}\t{dst}\t{il}\t{ol}\t{cost:.6f}\n")
        for state, cost in finals.items():
            f.write(f"{state}\t{cost:.6f}\n")
    info("LM FST: %d states, %d arcs, %d final states -> %s",
         len(states), len(arcs), len(finals), path)
    return path


def make_lexicon_fst_text(lexicon, symbols_words, symbols_phones, path, *,
                          sil_phone=None, sil_prob=0.5,
                          eps_id=0):
    """L FST: phones in, words out (utils/make_lexicon_fst.pl construction).

    lexicon: {word: [phone, ...]} or {word: [(pron_prob, [phones]), ...]}.
    With silence: Kaldi's three-state scheme — start(0) offers initial
    silence or not; each word's final phone goes to loop(1) with nosil cost
    OR to sil(2) with sil cost; sil(2) emits the silence phone back to loop.
    Exactly ONE of {sil, nosil} is charged per word boundary."""
    lines = []
    if sil_phone is not None:
        start, loop, sil_state = 0, 1, 2
        next_state = 3
        sil_cost = -math.log(max(sil_prob, 1e-10))
        nosil_cost = -math.log(max(1.0 - sil_prob, 1e-10))
        lines.append((start, loop, eps_id, eps_id, nosil_cost))
        lines.append((start, loop, symbols_phones[sil_phone], eps_id,
                      sil_cost))
        lines.append((sil_state, loop, symbols_phones[sil_phone], eps_id,
                      0.0))
    else:
        start = loop = 0
        sil_state = None
        next_state = 1
        sil_cost = nosil_cost = 0.0

    for word, prons in lexicon.items():
        if prons and not isinstance(prons[0], (list, tuple)):
            prons = [(1.0, list(prons))]
        for prob, phones in prons:
            pron_cost = -math.log(max(float(prob), 1e-10))
            cur = loop
            for i, phone in enumerate(phones):
                olabel = symbols_words[word] if i == 0 else eps_id
                arc_cost = pron_cost if i == 0 else 0.0
                last = i == len(phones) - 1
                if last and sil_state is not None:
                    # word end: either straight back to loop (no silence)
                    # or into the silence state
                    lines.append((cur, loop, symbols_phones[phone], olabel,
                                  arc_cost + nosil_cost))
                    lines.append((cur, sil_state, symbols_phones[phone],
                                  olabel, arc_cost + sil_cost))
                else:
                    dst = loop if last else next_state
                    if not last:
                        next_state += 1
                    lines.append((cur, dst, symbols_phones[phone], olabel,
                                  arc_cost))
                    cur = dst

    with open(path, "w", encoding="utf-8") as f:
        for src, dst, il, ol, cost in lines:
            f.write(f"{src}\t{dst}\t{il}\t{ol}\t{cost:.6f}\n")
        f.write(f"{loop}\t0.0\n")
    info("lexicon FST: %d arcs -> %s", len(lines), path)
    return path
