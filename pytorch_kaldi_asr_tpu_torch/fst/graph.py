"""Decoding-graph compilation: L o G -> HLG (the port's copy of
``pytorch_kaldi_asr_tpu.fst.graph``).

Compose the lexicon transducer with the grammar, determinize, minimize,
strip the disambiguation symbols and expand each phone into its HMM (a
1-state model with a self-loop, or the topology file's models through
tools/lang.expand_hmm), producing the graph decode/latgen.py and the
device searches (decode/device_latgen.py, decode/frontier_latgen.py) walk
over the hybrid AM's posteriors (recipes/dump_posteriors.py).

- add_lex_disambig: auxiliary #1..#N phone symbols for homophones and
  prefix pronunciations
- lexicon_fst:      L with optional silence and disambig pass-through
- lexicon_fst_silprob: L with word-dependent silence probabilities
- grammar_fst:      G from an ARPA NgramLM (#0 backoff inputs, the
                    arpa2fst --disambig-symbol convention)
- mkgraph:          min(det(L o G)) with disambig symbols removed and
                    1-state-HMM self-loops expanded (monophone topology,
                    matching the hybrid AM's one-pdf-per-phone outputs), or
                    the per-phone HMMs of a parsed topology (``topo=``)
"""

from __future__ import annotations

import math
from collections import defaultdict

from pytorch_kaldi_asr_tpu_torch.fst import ops
from pytorch_kaldi_asr_tpu_torch.fst.core import EPS, Fst
from pytorch_kaldi_asr_tpu_torch.lm.ngram import BOS_WORD, EOS_WORD, NgramLM

LN10 = math.log(10.0)


def add_lex_disambig(lexicon):
    """Append auxiliary symbols so no pronunciation is a prefix of (or
    identical to) another.  lexicon: {word: [phones]} or
    {word: [(prob, [phones]), ...]}.  Returns ({word: [(prob, phones+aux)]},
    max_disambig) with aux symbols as strings '#1'.. (Kaldi's
    add_lex_disambig.pl semantics: identical prons get distinct #k; a pron
    that is a prefix of another gets #1)."""
    norm = {}
    for word, prons in lexicon.items():
        if prons and not isinstance(prons[0], (list, tuple)):
            prons = [(1.0, list(prons))]
        norm[word] = [(float(p), list(ph)) for p, ph in prons]

    counts = defaultdict(int)
    prefixes = set()
    for prons in norm.values():
        for _, ph in prons:
            counts[tuple(ph)] += 1
            for i in range(1, len(ph)):
                prefixes.add(tuple(ph[:i]))

    max_disambig = 0
    assigned = defaultdict(int)
    out = {}
    for word, prons in norm.items():
        out[word] = []
        for prob, ph in prons:
            key = tuple(ph)
            needs = counts[key] > 1 or key in prefixes
            if needs:
                assigned[key] += 1
                k = assigned[key]
                max_disambig = max(max_disambig, k)
                out[word].append((prob, ph + [f"#{k}"]))
            else:
                out[word].append((prob, list(ph)))
    return out, max_disambig


def lexicon_fst(lexicon, word_syms, phone_syms, *, sil_phone=None,
                sil_prob=0.5, add_disambig=True):
    """Build L directly as an Fst: phones (input) -> words (output).

    Returns (L, phone_syms_ext) where phone_syms_ext extends phone_syms
    with the auxiliary #k symbols and a phone-side '#0' used to pass the
    grammar's backoff disambig through composition (Kaldi's
    make_lexicon_fst.pl and phase 1 of mkgraph.sh)."""
    if add_disambig:
        lexicon, max_k = add_lex_disambig(lexicon)
    else:
        lex2 = {}
        for w, prons in lexicon.items():
            if prons and not isinstance(prons[0], (list, tuple)):
                prons = [(1.0, list(prons))]
            lex2[w] = [(float(p), list(ph)) for p, ph in prons]
        lexicon, max_k = lex2, 0

    phone_syms_ext = dict(phone_syms)
    next_id = max(phone_syms.values()) + 1 if phone_syms else 1
    for k in range(1, max_k + 1):
        if f"#{k}" not in phone_syms_ext:
            phone_syms_ext[f"#{k}"] = next_id
            next_id += 1
    phone_syms_ext.setdefault("#0", next_id)

    f = Fst()
    if sil_phone is not None:
        start = f.add_state()
        loop = f.add_state()
        sil_state = f.add_state()
        f.start = start
        sil_cost = -math.log(max(sil_prob, 1e-10))
        nosil_cost = -math.log(max(1.0 - sil_prob, 1e-10))
        f.add_arc(start, EPS, EPS, nosil_cost, loop)
        f.add_arc(start, phone_syms[sil_phone], EPS, sil_cost, loop)
        f.add_arc(sil_state, phone_syms[sil_phone], EPS, 0.0, loop)
    else:
        start = loop = f.add_state()
        f.start = start
        sil_state = None
        sil_cost = nosil_cost = 0.0

    for word, prons in lexicon.items():
        if word not in word_syms:
            continue
        for prob, phones in prons:
            pron_cost = -math.log(max(prob, 1e-10))
            cur = loop
            for i, ph in enumerate(phones):
                il = phone_syms_ext[ph]
                ol = word_syms[word] if i == 0 else EPS
                cost = pron_cost if i == 0 else 0.0
                last = i == len(phones) - 1
                if last and sil_state is not None:
                    f.add_arc(cur, il, ol, cost + nosil_cost, loop)
                    f.add_arc(cur, il, ol, cost + sil_cost, sil_state)
                elif last:
                    f.add_arc(cur, il, ol, cost, loop)
                else:
                    nxt = f.add_state()
                    f.add_arc(cur, il, ol, cost, nxt)
                    cur = nxt
    # pass the grammar backoff disambig through L (mkgraph.sh phase 1:
    # L_disambig's #0:#0 self-loop at the loop state)
    if "#0" in word_syms:
        f.add_arc(loop, phone_syms_ext["#0"], word_syms["#0"], 0.0, loop)
    f.set_final(loop, 0.0)
    return f, phone_syms_ext


def lexicon_fst_silprob(lexicon, silprobs, word_syms, phone_syms, *,
                        sil_phone="sil", sil_disambig="#s"):
    """Build L with WORD-DEPENDENT silence probabilities (the reference
    kaldi/utils/make_lexicon_fst_silprob.pl:1-146 contract).

    lexicon: {word: [(pron_prob, word_sil_prob, sil_word_correction,
    nonsil_word_correction, [phones]), ...]} — per pronunciation, the
    probability of silence FOLLOWING the word plus the Bayes correction
    factors for silence/non-silence PRECEDING it.
    silprobs: {"<s>": p_sil_after_bos, "</s>_s": end-after-sil correction,
    "</s>_n": end-after-nonsil correction}.

    Returns (L, phone_syms_ext) where phone_syms_ext adds ``sil_disambig``
    (the silence-path disambiguator) and a '#0' passthrough like
    :func:`lexicon_fst`.  Topology: distinct 'after-silence' and
    'after-non-silence' loop states so each word's entry cost conditions
    on whether silence preceded it."""
    def cost(p):
        return -math.log(max(float(p), 1e-10))

    phone_syms_ext = dict(phone_syms)
    next_id = max(phone_syms_ext.values()) + 1 if phone_syms_ext else 1
    for sym in (sil_disambig, "#0"):
        if sym not in phone_syms_ext:
            phone_syms_ext[sym] = next_id
            next_id += 1

    f = Fst()
    start = f.add_state()
    nonsil = f.add_state()  # "a non-silence word just ended"
    sil = f.add_state()     # "silence just ended"
    f.start = start
    sil_id = phone_syms_ext[sil_phone]
    dis_id = phone_syms_ext[sil_disambig]
    f.add_arc(start, sil_id, EPS, cost(silprobs["<s>"]), sil)
    f.add_arc(start, dis_id, EPS, cost(1.0 - float(silprobs["<s>"])), nonsil)

    for word, prons in lexicon.items():
        if word not in word_syms:
            continue
        for pron_prob, wsp, silc, nonsilc, phones in prons:
            if not phones:
                raise ValueError(
                    f"empty pronunciation for word {word!r} (the reference "
                    "make_lexicon_fst_silprob.pl rejects empty prons)")
            pron_cost = cost(pron_prob)
            cur = None
            for i, ph in enumerate(phones):
                il = phone_syms_ext[ph]
                if i == 0:
                    nxt = f.add_state()
                    f.add_arc(nonsil, il, word_syms[word],
                              cost(nonsilc) + pron_cost, nxt)
                    f.add_arc(sil, il, word_syms[word],
                              cost(silc) + pron_cost, nxt)
                else:
                    nxt = f.add_state()
                    f.add_arc(cur, il, EPS, 0.0, nxt)
                cur = nxt
            # word end: silence follows with prob wsp, else the disambig
            f.add_arc(cur, dis_id, EPS, cost(1.0 - float(wsp)), nonsil)
            f.add_arc(cur, sil_id, EPS, cost(wsp), sil)
    if "#0" in word_syms:
        for loop in (nonsil, sil):
            f.add_arc(loop, phone_syms_ext["#0"], word_syms["#0"], 0.0, loop)
    f.set_final(sil, cost(silprobs["</s>_s"]))
    f.set_final(nonsil, cost(silprobs["</s>_n"]))
    return f, phone_syms_ext


def grammar_fst(lm: NgramLM, word_syms, *, disambig_symbol="#0") -> Fst:
    """Build G as an Fst from a backoff NgramLM: states are histories, word
    arcs carry -ln p, backoff arcs are input-#0/output-eps, </s> mass
    becomes final weights (the arpa2fst --disambig-symbol
    construction)."""
    f = Fst()
    states = {}

    def state_of(hist):
        hist = tuple(hist)
        if hist not in states:
            states[hist] = f.add_state()
        return states[hist]

    start = state_of((BOS_WORD,))
    f.start = start
    state_of(())
    for gram in lm.backoff:
        state_of(gram)
    for gram in lm.logprob:
        if len(gram) > 1:
            state_of(gram[:-1])

    disambig_id = word_syms[disambig_symbol]
    for gram, lp in sorted(lm.logprob.items()):
        word, hist = gram[-1], gram[:-1]
        if word == BOS_WORD:
            continue
        cost = -lp * LN10
        src = state_of(hist)
        if word == EOS_WORD:
            f.final[src] = min(f.final.get(src, math.inf), cost)
            continue
        if word not in word_syms:
            continue
        dest_hist = hist + (word,)
        while dest_hist not in states and dest_hist:
            dest_hist = dest_hist[1:]
        f.add_arc(src, word_syms[word], word_syms[word], cost,
                  state_of(dest_hist))
    for hist, bow in lm.backoff.items():
        if not hist:
            continue
        f.add_arc(state_of(hist), disambig_id, EPS, -bow * LN10,
                  state_of(hist[1:]))
    return f.connect()


def add_hmm_loops(g: Fst, n_phones, *, self_loop_prob=0.5,
                  sym_offset=0) -> Fst:
    """Expand each phone arc into a 1-state HMM: enter on the phone label
    (forward cost), self-loop on the same label (loop cost), exit by eps.
    This is the H-level expansion for the monophone topology the hybrid AM
    uses (gen_topo.pl 1-emitting-state case): the decoder then consumes one
    input label per FRAME."""
    loop_cost = -math.log(self_loop_prob)
    fwd_cost = -math.log(1.0 - self_loop_prob)
    out = Fst()
    for _ in range(g.num_states):
        out.add_state()
    out.start = g.start
    out.final = dict(g.final)
    for s in range(g.num_states):
        for a in g.arcs[s]:
            if a.ilabel == EPS or a.ilabel > n_phones + sym_offset:
                out.add_arc(s, a.ilabel, a.olabel, a.weight, a.nextstate)
                continue
            hmm = out.add_state()
            out.add_arc(s, a.ilabel, a.olabel, a.weight + fwd_cost, hmm)
            out.add_arc(hmm, a.ilabel, EPS, loop_cost, hmm)
            out.add_arc(hmm, EPS, EPS, fwd_cost, a.nextstate)
    return out


def mkgraph(lexicon, lm: NgramLM, word_syms, phone_syms, *, sil_phone=None,
            sil_prob=0.5, hmm_loops=True, self_loop_prob=0.5, topo=None):
    """Full graph compilation: returns (graph, phone_syms_ext).

    min(det(L o G)) with disambig symbols mapped back to epsilon (mkgraph.sh
    phases 2-4), then HMM expansion (phase 5's add-self-loops role): either
    the default 1-state self-loop model, or — when ``topo`` (a parsed
    topology from tools.lang.parse_topo) is given — the per-phone HMMs it
    declares.  Graph input labels are phone ids, outputs are word ids."""
    word_syms = dict(word_syms)
    if "#0" not in word_syms:
        word_syms["#0"] = max(word_syms.values()) + 1
    L, phone_syms_ext = lexicon_fst(
        lexicon, word_syms, phone_syms, sil_phone=sil_phone,
        sil_prob=sil_prob)
    G = grammar_fst(lm, word_syms)
    LG = ops.compose(L.arcsort("olabel"), G)
    LG = ops.determinize(ops.rmepsilon(LG))
    LG = ops.minimize(LG)
    # strip auxiliary symbols BY NAME: phone-side #k -> eps, word-side
    # #0 -> eps.  (An id-range test would miss #k symbols a supplied
    # Kaldi-style phones.txt already contains at low ids — they would
    # survive as bogus "phones" and kill every path through homophones.)
    n_real_phones = max(
        (v for k, v in phone_syms.items() if not k.startswith("#")),
        default=0,
    )
    imap = {v: EPS for k, v in phone_syms_ext.items()
            if k.startswith("#")}
    omap = {word_syms["#0"]: EPS}
    LG = ops.relabel(LG, imap=imap, omap=omap).connect()
    if topo is not None:
        from pytorch_kaldi_asr_tpu_torch.tools.lang import expand_hmm

        LG = expand_hmm(LG, topo)
    elif hmm_loops:
        LG = add_hmm_loops(LG, n_real_phones,
                           self_loop_prob=self_loop_prob)
    return LG.arcsort("ilabel"), phone_syms_ext
