"""Per-utterance / per-speaker WER breakdown reports.

Role of the vendored scoring scripts (utils/scoring/wer_per_utt_details.pl,
wer_per_spk_details.pl, wer_ops_details.pl): alignment-level diagnostics on
top of the aggregate compute-wer numbers."""

from __future__ import annotations

import numpy as np


def align(ref, hyp):
    """Full Levenshtein alignment: list of (op, ref_word, hyp_word), op ∈
    {'cor', 'sub', 'ins', 'del'}."""
    r, h = len(ref), len(hyp)
    dp = np.zeros((r + 1, h + 1), np.int32)
    dp[:, 0] = np.arange(r + 1)
    dp[0, :] = np.arange(h + 1)
    for i in range(1, r + 1):
        for j in range(1, h + 1):
            dp[i, j] = min(
                dp[i - 1, j - 1] + (ref[i - 1] != hyp[j - 1]),
                dp[i - 1, j] + 1,
                dp[i, j - 1] + 1,
            )
    ops = []
    i, j = r, h
    while i > 0 or j > 0:
        if i > 0 and j > 0 and dp[i, j] == dp[i - 1, j - 1] + (
            ref[i - 1] != hyp[j - 1]
        ):
            op = "cor" if ref[i - 1] == hyp[j - 1] else "sub"
            ops.append((op, ref[i - 1], hyp[j - 1]))
            i, j = i - 1, j - 1
        elif i > 0 and dp[i, j] == dp[i - 1, j] + 1:
            ops.append(("del", ref[i - 1], "***"))
            i -= 1
        else:
            ops.append(("ins", "***", hyp[j - 1]))
            j -= 1
    return ops[::-1]


def per_utt_details(ref_table, hyp_table, mode="present"):
    """{utt: {'ops': [...], 'cor': n, 'sub': n, 'ins': n, 'del': n}}."""
    out = {}
    for key, ref in ref_table.items():
        if key not in hyp_table:
            if mode == "present":
                continue
            hyp = []
        else:
            hyp = hyp_table[key]
        ref_words = ref.split() if isinstance(ref, str) else list(ref)
        hyp_words = hyp.split() if isinstance(hyp, str) else list(hyp)
        ops = align(ref_words, hyp_words)
        counts = {"cor": 0, "sub": 0, "ins": 0, "del": 0}
        for op, *_ in ops:
            counts[op] += 1
        out[key] = {"ops": ops, **counts}
    return out


def per_spk_details(details, utt2spk):
    """Aggregate per-utterance counts by speaker."""
    out = {}
    for utt, d in details.items():
        spk = utt2spk.get(utt, utt)
        agg = out.setdefault(spk, {"cor": 0, "sub": 0, "ins": 0, "del": 0,
                                   "utts": 0})
        for k in ("cor", "sub", "ins", "del"):
            agg[k] += d[k]
        agg["utts"] += 1
    return out


def ops_details(details):
    """Confusion counts: {(op, ref_word, hyp_word): n} sorted by frequency
    (wer_ops_details.pl role)."""
    counts = {}
    for d in details.values():
        for op_tuple in d["ops"]:
            if op_tuple[0] == "cor":
                continue
            counts[op_tuple] = counts.get(op_tuple, 0) + 1
    return dict(sorted(counts.items(), key=lambda kv: -kv[1]))


def format_per_utt_report(details):
    lines = []
    for utt, d in details.items():
        refs = " ".join(r for _, r, _ in d["ops"])
        hyps = " ".join(h for _, _, h in d["ops"])
        opss = " ".join(op.upper()[0] for op, _, _ in d["ops"])
        lines.append(f"{utt} ref  {refs}")
        lines.append(f"{utt} hyp  {hyps}")
        lines.append(f"{utt} op   {opss}")
        lines.append(
            f"{utt} #csid {d['cor']} {d['sub']} {d['ins']} {d['del']}"
        )
    return "\n".join(lines) + "\n"
