"""Backoff n-gram LM scoring, the JAX package's ``lm/ngram.py`` trimmed to
its read side (training, ``train_ngram_lm``, waits for the port's
``train_lm``).

Scoring follows SRILM's ``ngram -ppl``: transitions for w1..wn and </s>
with <s> as context only; OOV words contribute nothing to the logprob
(zeroprob words) and are counted separately.  Log-probs are base 10, as in
ARPA files.
"""

from __future__ import annotations

BOS_WORD = "<s>"
EOS_WORD = "</s>"


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
