"""LM-directory tooling: ARPA mapping, reversal, OOV detection, const-ARPA
(the port's copy of ``pytorch_kaldi_asr_tpu.lm.tools``).

Covers the reference's vendored LM-dir script group
(reference kaldi/utils/: map_arpa_lm.pl:1-137, reverse_arpa.py:1-188,
find_arpa_oovs.pl:1-57, build_const_arpa_lm.sh, format_lm.sh:1-84) as
library functions + thin CLIs under tools/.

- map_arpa:        words <-> integer ids in an ARPA stream, dropping
                   n-grams containing out-of-table words and fixing the
                   \\data\\ header counts
- reverse_arpa:    exact ARPA reversal (reversed sentences score as the
                   forward model scores the originals), same construction
                   as the reference script: rev(w1..wn) accumulates
                   p+b plus the telescoping sum of shortened-gram terms
- find_arpa_oovs:  ARPA words absent from a symbol table
- ConstArpaLm:     compact binary LM (int-mapped, sorted arrays with
                   binary-search lookup) standing in for Kaldi's
                   arpa-to-const-arpa memory-mapped format
- format_lm:       lang-dir + ARPA -> lang-dir with compiled binary G.fst
"""

from __future__ import annotations

import math
import os
import pickle
import shutil
from bisect import bisect_left

from pytorch_kaldi_asr_tpu_torch.lm.arpa import _open

INF = float("inf")


# ---------------------------------------------------------------------------
# streaming ARPA parse (header + per-order entries)
# ---------------------------------------------------------------------------


def _parse_arpa(path):
    """Yields (order, logprob, words_tuple, backoff_or_None)."""
    with _open(path, "r") as f:
        lines = iter(f)
        for line in lines:
            if line.strip() == "\\data\\":
                break
        counts = []
        for line in lines:
            line = line.strip()
            if line.startswith("ngram "):
                counts.append(int(line.split("=")[1]))
            elif line:
                break
        order = 0
        while True:
            if line is None:
                break
            s = line.strip() if isinstance(line, str) else ""
            if s.startswith("\\") and s.endswith("-grams:"):
                order = int(s[1:s.index("-")])
            elif s == "\\end\\":
                break
            elif s:
                parts = s.split()
                lp = float(parts[0])
                if len(parts) > order + 1:
                    words = tuple(parts[1:order + 1])
                    back = float(parts[-1])
                else:
                    words = tuple(parts[1:])
                    back = None
                yield order, lp, words, back
            line = next(lines, None)


# ---------------------------------------------------------------------------
# map_arpa_lm
# ---------------------------------------------------------------------------


def map_arpa(arpa_in, arpa_out, symbols, *, sym2int=True):
    """Map ARPA words to integers (or back).  n-grams containing words
    missing from ``symbols`` are dropped and the header counts updated
    (map_arpa_lm.pl semantics)."""
    if sym2int:
        table = {w: str(i) for w, i in symbols.items()}
    else:
        table = {str(i): w for w, i in symbols.items()}
    by_order: dict[int, list] = {}
    max_order = 0
    for order, lp, words, back in _parse_arpa(arpa_in):
        mapped = tuple(table.get(w) for w in words)
        if any(m is None for m in mapped):
            continue
        by_order.setdefault(order, []).append((lp, mapped, back))
        max_order = max(max_order, order)
    with _open(arpa_out, "w") as f:
        f.write("\n\\data\\\n")
        for n in range(1, max_order + 1):
            f.write(f"ngram {n}={len(by_order.get(n, []))}\n")
        for n in range(1, max_order + 1):
            f.write(f"\n\\{n}-grams:\n")
            for lp, words, back in by_order.get(n, []):
                line = f"{lp}\t{' '.join(words)}"
                if back is not None:
                    line += f"\t{back}"
                f.write(line + "\n")
        f.write("\n\\end\\\n")
    return arpa_out


# ---------------------------------------------------------------------------
# find_arpa_oovs
# ---------------------------------------------------------------------------


def find_arpa_oovs(arpa_path, symbols):
    """Words appearing in the ARPA file but not in ``symbols``
    (find_arpa_oovs.pl; <s>/</s> excluded like the reference does)."""
    oovs = set()
    for _, _, words, _ in _parse_arpa(arpa_path):
        for w in words:
            if w not in symbols:
                oovs.add(w)
    return sorted(oovs - {"<s>", "</s>"})


# ---------------------------------------------------------------------------
# reverse_arpa
# ---------------------------------------------------------------------------


def reverse_arpa(arpa_in, arpa_out):
    """Write the exact reversed LM (reference reverse_arpa.py construction:
    reversed n-gram logprob = p + b + sum over shortened grams of
    p(prefix_x) - p(offset-suffix_x); <s>/</s> swapped; newly created
    backoff grams get prob 0 and backoff -100000)."""
    ngrams: list[dict] = []
    sentprob = 0.0
    max_order = 0
    for order, lp, words, back in _parse_arpa(arpa_in):
        while len(ngrams) < order:
            ngrams.append({})
        max_order = max(max_order, order)
        if order == 1 and words[0] == "<s>":
            sentprob, lp = lp, 0.0
        ngrams[order - 1][words] = (lp, back if back is not None else 0.0)
    # create missing shortened grams (prob 0, backoff inf marker)
    created = [set() for _ in ngrams]
    for order in range(1, max_order + 1):
        for words in list(ngrams[order - 1]):
            for x in range(order - 1, 0, -1):
                for sub in (words[:x], words[1:1 + x], words[order - x:]):
                    if sub not in ngrams[x - 1]:
                        ngrams[x - 1][sub] = (0.0, INF)
                        created[x - 1].add(sub)

    def swap(ws):
        out = []
        for w in reversed(ws):
            out.append({"<s>": "</s>", "</s>": "<s>"}.get(w, w))
        return tuple(out)

    offset = 0.0
    with _open(arpa_out, "w") as f:
        f.write("\\data\\\n")
        for n in range(1, max_order + 1):
            f.write(f"ngram {n}={len(ngrams[n - 1])}\n")
        for n in range(1, max_order + 1):
            f.write(f"\\{n}-grams:\n")
            for words in sorted(ngrams[n - 1]):
                prob, back = ngrams[n - 1][words]
                rev = " ".join(swap(words))
                revprob = prob + (back if back != INF else 0.0)
                for x in range(n - 1, 0, -1):
                    revprob += ngrams[x - 1][words[:x]][0]
                    revprob -= ngrams[x - 1][words[1:1 + x]][0]
                if n != max_order:
                    bo = 0.0
                    if rev.startswith("<s>"):
                        if n == 1:
                            offset = revprob
                            revprob = sentprob
                            bo = offset
                        elif n == 2:
                            revprob += offset
                    if back != INF:
                        f.write(f"{revprob} {rev} {bo}\n")
                    else:
                        f.write(f"{revprob} {rev} -100000.0\n")
                else:
                    if n == 2 and rev.startswith("<s>"):
                        revprob += offset
                    f.write(f"{revprob} {rev}\n")
        f.write("\\end\\\n")
    return arpa_out


# ---------------------------------------------------------------------------
# const-ARPA
# ---------------------------------------------------------------------------


class ConstArpaLm:
    """Compact immutable LM with binary-search n-gram lookup — the
    arpa-to-const-arpa/ConstArpaLm role (build_const_arpa_lm.sh).  Words are
    int-mapped; grams per order are sorted tuples queried with bisect."""

    def __init__(self, order, vocab, grams):
        self.order = order
        self.vocab = vocab  # word -> int
        # grams[n]: (sorted list of id-tuples, [logprob], [backoff])
        self.grams = grams

    @classmethod
    def from_arpa(cls, arpa_path):
        vocab: dict[str, int] = {}
        tmp: dict[int, dict] = {}
        max_order = 0
        for order, lp, words, back in _parse_arpa(arpa_path):
            ids = tuple(vocab.setdefault(w, len(vocab)) for w in words)
            tmp.setdefault(order, {})[ids] = (lp, back or 0.0)
            max_order = max(max_order, order)
        grams = {}
        for n, d in tmp.items():
            keys = sorted(d)
            grams[n] = (keys, [d[k][0] for k in keys], [d[k][1] for k in keys])
        return cls(max_order, vocab, grams)

    def _lookup(self, ids):
        n = len(ids)
        if n not in self.grams:
            return None
        keys, lps, bos = self.grams[n]
        i = bisect_left(keys, ids)
        if i < len(keys) and keys[i] == ids:
            return lps[i], bos[i]
        return None

    def logprob(self, word, history=()):
        """log10 p(word | history) with Katz backoff (-inf for OOV words)."""
        if word not in self.vocab:
            return -math.inf
        wid = self.vocab[word]
        hids = tuple(self.vocab[h] for h in history if h in self.vocab)
        hids = hids[-(self.order - 1):] if self.order > 1 else ()
        acc = 0.0
        while True:
            hit = self._lookup(hids + (wid,))
            if hit is not None:
                return acc + hit[0]
            if not hids:
                return -math.inf
            bo = self._lookup(hids)
            acc += bo[1] if bo is not None else 0.0
            hids = hids[1:]

    def sentence_logprob(self, words):
        """Sum of log10 p over the sentence with <s>/</s> wrapping."""
        hist = ["<s>"]
        total = 0.0
        for w in list(words) + ["</s>"]:
            total += self.logprob(w, tuple(hist))
            hist.append(w)
        return total

    def save(self, path):
        with open(path, "wb") as f:
            pickle.dump(
                {"order": self.order, "vocab": self.vocab,
                 "grams": self.grams}, f, protocol=4)
        return path

    @classmethod
    def load(cls, path):
        with open(path, "rb") as f:
            d = pickle.load(f)
        return cls(d["order"], d["vocab"], d["grams"])


# ---------------------------------------------------------------------------
# format_lm
# ---------------------------------------------------------------------------


def format_lm(lang_dir, arpa_path, out_dir):
    """Copy a lang dir and compile the ARPA into a binary G.fst inside it
    (format_lm.sh:1-84 role; checks the LM's words against words.txt like
    the reference does via find_arpa_oovs)."""
    from pytorch_kaldi_asr_tpu_torch.fst.graph import grammar_fst
    from pytorch_kaldi_asr_tpu_torch.lm.arpa import read_arpa

    os.makedirs(out_dir, exist_ok=True)
    for name in os.listdir(lang_dir):
        src = os.path.join(lang_dir, name)
        if os.path.isfile(src):
            shutil.copy(src, os.path.join(out_dir, name))
    words_txt = os.path.join(lang_dir, "words.txt")
    word_syms = {}
    with open(words_txt, encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                word_syms[parts[0]] = int(parts[1])
    oovs = find_arpa_oovs(arpa_path, word_syms)
    if oovs:
        raise ValueError(
            f"LM contains {len(oovs)} words not in words.txt, e.g. "
            f"{oovs[:5]} — filter the ARPA first (map_arpa/find_arpa_oovs)")
    if "#0" not in word_syms:
        word_syms["#0"] = max(word_syms.values()) + 1
        with open(os.path.join(out_dir, "words.txt"), "a",
                  encoding="utf-8") as f:
            f.write(f"#0 {word_syms['#0']}\n")
    lm = read_arpa(arpa_path)
    g = grammar_fst(lm, word_syms)
    g.write_binary(os.path.join(out_dir, "G.fst"))
    return out_dir
