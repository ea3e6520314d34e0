"""Log triage: count and sample WARNING/ERROR lines across job logs (role of
utils/summarize_warnings.pl and summarize_logs.pl — the reference's log
conventions are preserved by parallel/launch.py, so greps carry over)."""

import argparse
import glob
import re
import sys

_TAG = re.compile(r"\[(WARNING|ERROR)\]|^(WARNING|ERROR)\b")


def summarize(log_globs, max_examples=5):
    """Return {tag: {'count': n, 'examples': [...]}} plus per-file exit
    codes scraped from the launcher book-ends."""
    out = {"WARNING": {"count": 0, "examples": []},
           "ERROR": {"count": 0, "examples": []},
           "failed_jobs": []}
    files = []
    for pattern in log_globs:
        files.extend(sorted(glob.glob(pattern)))
    for path in files:
        try:
            with open(path, encoding="utf-8", errors="replace") as f:
                for line in f:
                    m = _TAG.search(line)
                    if m:
                        tag = m.group(1) or m.group(2)
                        out[tag]["count"] += 1
                        if len(out[tag]["examples"]) < max_examples:
                            out[tag]["examples"].append(
                                f"{path}: {line.strip()}"
                            )
                    if line.startswith("# Ended (code ") and \
                            "(code 0)" not in line:
                        out["failed_jobs"].append(path)
        except OSError:
            continue
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("logs", nargs="+", help="log files or globs")
    parser.add_argument("--max-examples", type=int, default=5)
    opt = parser.parse_args(argv)
    summary = summarize(opt.logs, opt.max_examples)
    for tag in ("ERROR", "WARNING"):
        print(f"{summary[tag]['count']} {tag} lines")
        for ex in summary[tag]["examples"]:
            print(f"  {ex}")
    if summary["failed_jobs"]:
        print(f"{len(summary['failed_jobs'])} failed jobs:")
        for p in summary["failed_jobs"]:
            print(f"  {p}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
