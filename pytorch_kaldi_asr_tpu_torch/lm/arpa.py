"""ARPA files (the JAX package's ``lm/arpa.py``): the recipe's gzipped
``lm.3k.gz`` or a plain file, gzip chosen by the extension."""

from __future__ import annotations

import gzip

from pytorch_kaldi_asr_tpu_torch.lm.ngram import NgramLM


def _open(path, mode="r"):
    if path.endswith(".gz"):
        return gzip.open(path, mode + "t", encoding="utf-8")
    return open(path, mode, encoding="utf-8")


def write_arpa(lm: NgramLM, path):
    """Serialize to ARPA: \\data\\ header, per-order sections, log10
    probs, optional trailing backoff weight per line."""
    by_order = {}
    for gram in lm.logprob:
        by_order.setdefault(len(gram), []).append(gram)
    with _open(path, "w") as f:
        f.write("\n\\data\\\n")
        for n in range(1, lm.order + 1):
            f.write(f"ngram {n}={len(by_order.get(n, []))}\n")
        for n in range(1, lm.order + 1):
            f.write(f"\n\\{n}-grams:\n")
            for gram in sorted(by_order.get(n, [])):
                lp = lm.logprob[gram]
                line = f"{lp:.7f}\t{' '.join(gram)}"
                if n < lm.order and gram in lm.backoff:
                    line += f"\t{lm.backoff[gram]:.7f}"
                f.write(line + "\n")
        f.write("\n\\end\\\n")
    return path


def read_arpa(path):
    """Parse an ARPA file into an NgramLM."""
    order = 0
    with _open(path) as f:
        lines = iter(f)
        for line in lines:
            line = line.strip()
            if line == "\\data\\":
                break
        for line in lines:
            line = line.strip()
            if line.startswith("ngram "):
                n, _count = line[len("ngram "):].split("=")
                order = max(order, int(n))
            elif line:
                break
        lm = NgramLM(order)
        current_n = None
        # `line` currently holds the first section header
        while True:
            line = line.strip()
            if line.endswith("-grams:") and line.startswith("\\"):
                current_n = int(line[1:].split("-")[0])
            elif line == "\\end\\":
                break
            elif line and current_n is not None:
                parts = line.split("\t")
                if len(parts) == 1:
                    parts = line.split()
                    lp, words, bow = (
                        parts[0], parts[1: 1 + current_n],
                        parts[1 + current_n:],
                    )
                    bow = bow[0] if bow else None
                else:
                    lp = parts[0]
                    words = parts[1].split()
                    bow = parts[2] if len(parts) > 2 else None
                gram = tuple(words)
                lm.logprob[gram] = float(lp)
                if bow is not None:
                    lm.backoff[gram] = float(bow)
            try:
                line = next(lines)
            except StopIteration:
                break
    return lm
