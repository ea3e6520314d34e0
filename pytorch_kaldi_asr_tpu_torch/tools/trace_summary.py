"""Summarize a profiler trace: top ops by total duration (the port's
``pytorch_kaldi_asr_tpu.tools.trace_summary``).

Reads the gzipped Chrome trace that utils/metrics.profile_trace writes
(``torch.profiler``'s ``*.pt.trace.json.gz``) or any other Chrome trace
(plain JSON; the JAX profiler's ``trace.json.gz`` too) and aggregates
complete ('X') events by name per track: ``summarize``/``format_md``.
``summarize_by_source`` is the device view of a torch trace: each kernel,
copy and fill on the card is attributed to the host op that launched it,
through the trace's correlation ids (device event -> the ``cuda_runtime``
or ``cuda_driver`` launch call -> the innermost ``cpu_op`` or
``user_annotation`` around that call on its thread), with the op's FLOPs
where the profile was taken ``with_flops`` and the bytes of copies and
fills; ``format_source_md`` tables it by launching op and by category
(``kernel``, ``gpu_memcpy``, ``gpu_memset``).

Usage: python -m pytorch_kaldi_asr_tpu_torch.tools.trace_summary <logdir>
           [-top N] [-md out.md]
"""

from __future__ import annotations

import argparse
import bisect
import glob
import gzip
import json
import os
from collections import defaultdict


def find_trace_files(logdir):
    pats = [
        os.path.join(logdir, "**", "*.trace.json.gz"),
        os.path.join(logdir, "**", "trace.json.gz"),
        os.path.join(logdir, "**", "*.trace.json"),
    ]
    out = []
    for p in pats:
        out.extend(glob.glob(p, recursive=True))
    return sorted(set(out))


def load_events(path):
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rt", encoding="utf-8", errors="replace") as f:
        data = json.load(f)
    if isinstance(data, list):  # bare Chrome-trace event array
        return data
    return data.get("traceEvents", [])


# the device events of a torch trace, and the host events that launch them
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_OP_CATS = ("cpu_op", "user_annotation")
NO_OP = "<no launching op>"


def _innermost(spans, t):
    """The innermost span of ``spans`` (sorted by start; (start, end, op
    index)) that holds time ``t``: the latest-starting one around it."""
    i = bisect.bisect_right(spans, (t, float("inf"), float("inf")))
    while i > 0:
        i -= 1
        start, end, idx = spans[i]
        if end >= t:
            return idx
    return None


def summarize_by_source(logdir, top=10):
    """Attribute device time to the host op that launched it.

    A device track is named by its process's label (torch.profiler's
    ``process_labels``, "GPU 0"), else its process name.  Each device 'X'
    event (``cat`` in DEVICE_CATS) carries a
    ``correlation`` id shared with its launch call on the host (``cat``
    in LAUNCH_CATS); the innermost ``cpu_op`` or ``user_annotation`` on
    that call's thread around the call is the launching op.  An op's
    ``flops`` (profiles taken ``with_flops``) count once per op instance;
    copies and fills add their ``bytes``.  -> {device track: {"total_us",
    "rows": [(launching op, us, bytes, flops, calls)], "category_rows":
    [(category, us, bytes, flops, calls)]}}"""
    files = find_trace_files(logdir)
    if not files:
        raise FileNotFoundError(f"no trace.json(.gz) under {logdir}")
    names, labels = {}, {}
    per_track = defaultdict(lambda: defaultdict(lambda: [0.0, 0, 0, 0]))
    cats = defaultdict(lambda: defaultdict(lambda: [0.0, 0, 0, 0]))
    for path in files:  # correlation ids and op spans are per trace
        ops, spans, launches, device = [], defaultdict(list), {}, []
        for ev in load_events(path):
            ph, cat = ev.get("ph"), ev.get("cat")
            args = ev.get("args") or {}
            if ph == "M" and ev.get("name") == "process_name":
                names[ev.get("pid")] = args.get("name", "")
            elif ph == "M" and ev.get("name") == "process_labels":
                labels[ev.get("pid")] = args.get("labels", "")
            elif ph != "X":
                continue
            elif cat in HOST_OP_CATS:
                ts, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
                spans[(ev.get("pid"), ev.get("tid"))].append(
                    (ts, ts + dur, len(ops)))
                ops.append((ev.get("name", "?"),
                            int(args.get("flops", 0) or 0)))
            elif cat in LAUNCH_CATS and "correlation" in args:
                launches[args["correlation"]] = (
                    (ev.get("pid"), ev.get("tid")), float(ev.get("ts", 0.0)))
            elif cat in DEVICE_CATS:
                device.append(ev)
        for v in spans.values():
            v.sort()
        counted = set()  # the op instances whose flops are in
        for ev in device:
            args = ev.get("args") or {}
            launch = launches.get(args.get("correlation"))
            idx = (None if launch is None
                   else _innermost(spans.get(launch[0], []), launch[1]))
            key, flops = NO_OP, 0
            if idx is not None:
                key = ops[idx][0]
                if idx not in counted:
                    counted.add(idx)
                    flops = ops[idx][1]
            pid = ev.get("pid")
            track = labels.get(pid) or names.get(pid, f"pid{pid}")
            nbytes = int(args.get("bytes", 0) or 0)
            for table, k in ((per_track, key), (cats, ev.get("cat"))):
                cell = table[track][k]
                cell[0] += float(ev.get("dur", 0.0))
                cell[1] += nbytes
                cell[2] += flops
                cell[3] += 1
    out = {}
    for track, rows in per_track.items():
        out[track] = {
            "total_us": sum(v[0] for v in rows.values()),
            "rows": sorted(((k,) + tuple(v) for k, v in rows.items()),
                           key=lambda r: -r[1])[:top],
            "category_rows": sorted(
                ((k,) + tuple(v) for k, v in cats[track].items()),
                key=lambda r: -r[1])[:top]}
    return out


def format_source_md(summary, title="Device time by launching op"):
    lines = [f"# {title}", ""]
    for track in sorted(summary, key=lambda t: -summary[t]["total_us"]):
        s = summary[track]
        for head, rows in (("by launching op", s["rows"]),
                           ("by category", s["category_rows"])):
            lines += [f"## {track} — {head} "
                      f"(total {s['total_us'] / 1e3:.2f} ms)", "",
                      "| where | total ms | GB moved | GFLOPs | calls "
                      "| % time |",
                      "|---|---|---|---|---|---|"]
            for key, dur, nbytes, flops, cnt in rows:
                pct = 100.0 * dur / s["total_us"] if s["total_us"] else 0.0
                lines.append(
                    f"| `{key[:80]}` | {dur / 1e3:.3f} | "
                    f"{nbytes / 1e9:.3f} | {flops / 1e9:.2f} | {cnt} "
                    f"| {pct:.1f} |")
            lines.append("")
    return "\n".join(lines)


def summarize(logdir, top=10):
    """-> {track_name: [(op_name, total_us, count, pct), ...]} plus the
    per-track total duration."""
    files = find_trace_files(logdir)
    if not files:
        raise FileNotFoundError(f"no trace.json(.gz) under {logdir}")
    # pid/tid -> track name from metadata events
    names = {}
    per_track = defaultdict(lambda: defaultdict(lambda: [0.0, 0]))
    for path in files:
        for ev in load_events(path):
            ph = ev.get("ph")
            if ph == "M" and ev.get("name") == "process_name":
                names[ev.get("pid")] = ev.get("args", {}).get("name", "")
            elif ph == "X":
                track = names.get(ev.get("pid"), f"pid{ev.get('pid')}")
                cell = per_track[track][ev.get("name", "?")]
                cell[0] += float(ev.get("dur", 0.0))
                cell[1] += 1
    out = {}
    for track, ops in per_track.items():
        total = sum(v[0] for v in ops.values())
        rows = sorted(((n, v[0], v[1]) for n, v in ops.items()),
                      key=lambda r: -r[1])[:top]
        out[track] = {
            "total_us": total,
            "rows": [(n, d, c, (100.0 * d / total if total else 0.0))
                     for n, d, c in rows],
        }
    return out


def format_md(summary, title="Profiler trace summary"):
    lines = [f"# {title}", ""]
    for track in sorted(summary,
                        key=lambda t: -summary[t]["total_us"]):
        s = summary[track]
        lines += [f"## {track} (total {s['total_us'] / 1e3:.2f} ms)", "",
                  "| op | total ms | calls | % of track |",
                  "|---|---|---|---|"]
        for name, dur, cnt, pct in s["rows"]:
            lines.append(
                f"| `{name[:90]}` | {dur / 1e3:.3f} | {cnt} | {pct:.1f} |")
        lines.append("")
    return "\n".join(lines)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("logdir")
    parser.add_argument("-top", type=int, default=10)
    parser.add_argument("-md", default=None,
                        help="also write a markdown summary here")
    opt = parser.parse_args(argv)
    summary = summarize(opt.logdir, top=opt.top)
    text = format_md(summary)
    try:
        text += "\n" + format_source_md(
            summarize_by_source(opt.logdir, top=opt.top))
    except FileNotFoundError:
        pass
    print(text)
    if opt.md:
        with open(opt.md, "w", encoding="utf-8") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
