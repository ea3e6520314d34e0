"""Backoff n-gram LM training and scoring (the JAX package's
``lm/ngram.py``), in place of SRILM's ``ngram-count -text - -order 3``
(stage 2) and ``ngram -ppl -debug 1`` (the per-sentence log-probabilities
of stage 5's rescoring).

Estimation: Katz backoff with Good-Turing discounting (SRILM's default),
with SRILM-style count-minimum pruning (singleton trigrams dropped by
default); orders whose count-of-count statistics make Good-Turing
ill-defined fall back to Witten-Bell, as tiny corpora demand.

Scoring follows ``ngram -ppl``: transitions for w1..wn and </s> with <s> as
context only; OOV words contribute nothing to the logprob (zeroprob words)
and are counted separately.  Log-probs are base 10, as in ARPA files.
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict

from pytorch_kaldi_asr_tpu_torch.utils.logging import info, warning

BOS_WORD = "<s>"
EOS_WORD = "</s>"
LOG10_MIN = -99.0  # SRILM's stand-in for "no probability" (the <s> unigram)


def count_ngrams(sentences, order):
    """Count 1..order-grams over <s>/</s>-delimited sentences.

    ``sentences``: iterable of word lists (without <s>/</s>).
    Returns list ``counts[n]`` (n=1..order) of Counter{tuple: count}, with
    ngram-count's conventions: <s> appears only as left context (its unigram
    count is tracked but receives no probability); </s> is a real event."""
    counts = [Counter() for _ in range(order + 1)]  # index by n
    for words in sentences:
        padded = [BOS_WORD] + list(words) + [EOS_WORD]
        for n in range(1, order + 1):
            for i in range(len(padded) - n + 1):
                counts[n][tuple(padded[i: i + n])] += 1
    return counts[1:]


class NgramLM:
    """A backoff n-gram LM: ``logprob[ngram] -> log10 p``,
    ``backoff[ngram] -> log10 bow``."""

    def __init__(self, order):
        self.order = order
        self.logprob = {}  # tuple -> log10 prob
        self.backoff = {}  # tuple -> log10 backoff weight

    def word_logprob(self, word, context):
        """log10 P(word | context) via Katz backoff; -inf if the word is
        not in the vocabulary."""
        if (word,) not in self.logprob:
            return float("-inf")  # OOV / zeroprob
        context = tuple(context)[-(self.order - 1):] if self.order > 1 else ()
        bow_sum = 0.0
        while context:
            gram = context + (word,)
            if gram in self.logprob:
                return bow_sum + self.logprob[gram]
            bow_sum += self.backoff.get(context, 0.0)
            context = context[1:]
        return bow_sum + self.logprob[(word,)]

    def sentence_logprob(self, words):
        """(logprob, n_words_scored, n_oov) for one sentence — the numbers
        ``ngram -ppl -debug 1`` reports per sentence."""
        history = [BOS_WORD]
        total = 0.0
        n_oov = 0
        n_scored = 0
        for w in list(words) + [EOS_WORD]:
            lp = self.word_logprob(w, history)
            if lp == float("-inf"):
                n_oov += 1
            else:
                total += lp
                n_scored += 1
            history.append(w)
        return total, n_scored, n_oov


def _good_turing_discounts(count_of_counts, gtmax=7):
    """Katz'd Good-Turing discount ratios d[c] for c in 1..gtmax.

    d_c = (c*/c − A) / (1 − A), c* = (c+1)·N_{c+1}/N_c,
    A = (gtmax+1)·N_{gtmax+1}/N_1.  Returns None when the statistics are
    unusable (any required N_c == 0 or a discount out of (0, 1])."""
    n = count_of_counts
    if n.get(1, 0) == 0:
        return None
    a = (gtmax + 1) * n.get(gtmax + 1, 0) / n[1]
    if a >= 1.0:
        return None
    discounts = {}
    for c in range(1, gtmax + 1):
        if n.get(c, 0) == 0 or n.get(c + 1, 0) == 0:
            return None
        c_star = (c + 1) * n[c + 1] / n[c]
        d = (c_star / c - a) / (1.0 - a)
        if not (0.0 < d <= 1.0 + 1e-9):
            return None
        discounts[c] = min(d, 1.0)
    return discounts


def train_ngram_lm(sentences, order=3, *, gtmin=None, gtmax=7,
                   discounting="gt"):
    """Estimate a Katz/Good-Turing backoff LM (SRILM ngram-count's default
    behavior); per-order fallback to Witten-Bell when GT stats are
    degenerate.

    gtmin: minimum count to keep an n-gram per order (SRILM defaults:
    1 for orders 1-2, 2 for orders ≥3)."""
    sentences = [list(s) for s in sentences]
    if gtmin is None:
        gtmin = [1 if n <= 2 else 2 for n in range(1, order + 1)]
    counts = count_ngrams(sentences, order)

    lm = NgramLM(order)

    for n in range(1, order + 1):
        grams = counts[n - 1]
        kept = {
            g: c
            for g, c in grams.items()
            if c >= gtmin[n - 1] or n == 1
        }

        # choose discounting for this order
        discounts = None
        if discounting == "gt":
            coc = Counter(grams.values())
            discounts = _good_turing_discounts(coc, gtmax)
            if discounts is None and n > 1:
                warning(
                    "order-%d Good-Turing stats degenerate; "
                    "falling back to Witten-Bell", n,
                )

        # group kept grams by context; context totals use RAW counts
        by_context = defaultdict(dict)
        for g, c in kept.items():
            by_context[g[:-1]][g[-1]] = c
        context_totals = defaultdict(int)
        if n == 1:
            # unigram denominator: all tokens except <s> events
            context_totals[()] = sum(
                c for g, c in grams.items() if g != (BOS_WORD,)
            )
        else:
            for g, c in grams.items():
                context_totals[g[:-1]] += c

        for context, words in by_context.items():
            c_h = context_totals[context]
            if c_h == 0:
                continue
            t_h = len(words)  # distinct continuations (Witten-Bell)
            for w, c in words.items():
                if n == 1 and w == BOS_WORD:
                    lm.logprob[(w,)] = LOG10_MIN
                    continue
                if discounts is not None:
                    d = discounts.get(c, 1.0) if c <= gtmax else 1.0
                    p = d * c / c_h
                else:  # Witten-Bell
                    p = c / (c_h + t_h)
                lm.logprob[context + (w,)] = math.log10(max(p, 1e-99))

    # The unigram level has nothing to back off to: redistribute its
    # held-out discount mass by renormalizing (SRILM gives this mass to
    # zeroton/<unk> words; with a closed vocabulary it renormalizes).
    unigrams = [g for g in lm.logprob if len(g) == 1 and g != (BOS_WORD,)]
    mass = sum(10 ** lm.logprob[g] for g in unigrams)
    if mass > 0:
        shift = math.log10(mass)
        for g in unigrams:
            lm.logprob[g] -= shift

    # backoff weights: bow(h) = (1 − Σ kept P(w|h)) / (1 − Σ kept P(w|h⁻))
    for n in range(1, order):
        grams_next = [g for g in lm.logprob if len(g) == n + 1]
        by_context = defaultdict(list)
        for g in grams_next:
            by_context[g[:-1]].append(g[-1])
        for context, ws in by_context.items():
            num = 1.0
            den = 1.0
            for w in ws:
                num -= 10 ** lm.logprob[context + (w,)]
                den -= 10 ** lm.word_logprob(w, context[1:])
            if num <= 0:
                num = 1e-12
            if den <= 1e-9:
                # the lower order keeps (almost) no mass for unseen
                # continuations: backing off is vacuous, bow = 1 (SRILM's
                # fallback), where the floored denominator would give a
                # bow near 1e12
                lm.backoff[context] = 0.0
            else:
                lm.backoff[context] = math.log10(num / den)

    n_by_order = Counter(len(g) for g in lm.logprob)
    info(
        "trained order-%d LM: %s",
        order,
        ", ".join(f"{n_by_order[n]} {n}-grams" for n in range(1, order + 1)),
    )
    return lm
