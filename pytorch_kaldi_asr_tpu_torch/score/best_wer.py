"""Best-WER selection across rescoring weights (the role of Kaldi's
best_wer.sh: grep WER over the per-weight ``*_wer`` files and keep the
lowest)."""

from __future__ import annotations

import glob
import re

WER_RE = re.compile(r"%WER\s+([0-9.]+)")


def best_wer(wer_files_or_glob):
    """Return (best_line, best_path, best_wer_value) over WER report files."""
    if isinstance(wer_files_or_glob, str):
        files = sorted(glob.glob(wer_files_or_glob))
    else:
        files = list(wer_files_or_glob)
    best = (None, None, float("inf"))
    for path in files:
        with open(path, encoding="utf-8") as f:
            for line in f:
                m = WER_RE.search(line)
                if m:
                    value = float(m.group(1))
                    if value < best[2]:
                        best = (f"{path}: {line.strip()}", path, value)
    return best
