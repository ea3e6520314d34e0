"""CTM post-processing for the scoring chain (the port's copy of
``pytorch_kaldi_asr_tpu.tools.ctm``).

Two roles the reference vendors as Kaldi scoring glue:

- :func:`convert_ctm` — shift utterance-relative CTM word times to
  recording-relative times via a ``segments`` file and map utterance ids
  to (file, channel) via ``reco2file_and_channel``
  (reference kaldi/utils/convert_ctm.pl:1-90).
- :func:`fix_ctm` — pad a CTM so every segment named in the STM appears
  at least once, inserting ``EMPTY_RECOGNIZED_PHRASE`` placeholder words
  so NIST sclite-style scoring doesn't abort on empty recognitions
  (reference kaldi/utils/fix_ctm.sh:1-31).

CTM line format: ``<utt-or-file> <channel> <begin> <duration> <word>
[<confidence>]``; times in seconds.
"""

from __future__ import annotations

import argparse
import sys

from pytorch_kaldi_asr_tpu_torch.utils.logging import (
    info,
    log_startup,
    warning as warn,
)


def read_segments(path):
    """segments file -> {utt: (reco, begin, end)}."""
    out = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if len(parts) != 4:
                raise ValueError(f"bad segments line: {line!r}")
            utt, reco, b, e = parts
            out[utt] = (reco, float(b), float(e))
    return out


def read_reco2file_and_channel(path):
    """reco2file_and_channel -> {reco: (file, channel)}."""
    out = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if len(parts) != 3:
                raise ValueError(f"bad reco2file_and_channel line: {line!r}")
            out[parts[0]] = (parts[1], parts[2])
    return out


def convert_ctm(ctm_lines, segments, reco2file, *, skip_unknown=False):
    """Convert utterance-relative CTM entries to recording-relative ones.

    ctm_lines: iterable of strings or pre-split token lists with 5-6
    fields ``utt chan begin dur word [conf]``.  Yields output lines
    ``file channel begin dur word [conf]`` with begin/dur formatted %.2f
    (the convert_ctm.pl output contract).  Raises KeyError on an
    utterance absent from segments unless skip_unknown."""
    n_done = 0
    for entry in ctm_lines:
        parts = entry.split() if isinstance(entry, str) else list(entry)
        if not parts:
            continue
        if len(parts) not in (5, 6):
            raise ValueError(f"unexpected ctm format: {entry!r}")
        utt, _chan, wbegin, wlen, word = parts[:5]
        conf = parts[5] if len(parts) == 6 else None
        seg = segments.get(utt)
        if seg is None:
            if skip_unknown:
                continue
            raise KeyError(f"utterance {utt} not in segments file")
        reco, begin, end = seg
        if reco not in reco2file:
            raise KeyError(f"recording {reco} not in reco2file_and_channel")
        fname, channel = reco2file[reco]
        b = float(wbegin) + begin
        dur = float(wlen)
        fields = [fname, channel, f"{b:.2f}", f"{dur:.2f}", word]
        if conf is not None:
            fields.append(conf)
        if b + dur > end + 0.01:
            warn("word appears to be past end of recording: %s",
                 " ".join(fields))
        n_done += 1
        yield " ".join(fields)
    if n_done == 0:
        raise ValueError("convert_ctm produced no output lines")


def _first_fields(path):
    with open(path, encoding="utf-8") as f:
        return {line.split()[0] for line in f if line.split()}


def fix_ctm(stm_path, ctm_path):
    """Append ``<seg> 1 0 0 EMPTY_RECOGNIZED_PHRASE`` lines to the CTM for
    every STM segment with no CTM output (empty recognition result).
    Returns True if the CTM is usable afterwards; False when the CTM
    names segments the STM doesn't (the fix_ctm.sh failure case)."""
    stm_segs = _first_fields(stm_path)
    ctm_segs = _first_fields(ctm_path)
    extra = ctm_segs - stm_segs
    if extra:
        warn("fix_ctm: CTM has %d segments absent from the STM (e.g. %s)",
             len(extra), sorted(extra)[0])
        return False
    missing = sorted(stm_segs - ctm_segs)
    if missing:
        with open(ctm_path, "a", encoding="utf-8") as f:
            for seg in missing:
                f.write(f"{seg} 1 0 0 EMPTY_RECOGNIZED_PHRASE\n")
        info("fix_ctm: padded %d empty segments", len(missing))
    return True


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="convert_ctm.pl role: utterance-relative ctm -> "
                    "recording-relative ctm")
    parser.add_argument("segments")
    parser.add_argument("reco2file_and_channel")
    parser.add_argument("ctm", nargs="?", default="-",
                        help="input ctm (default stdin)")
    parser.add_argument("--skip-unknown", action="store_true")
    opt = parser.parse_args(argv)
    segments = read_segments(opt.segments)
    reco2file = read_reco2file_and_channel(opt.reco2file_and_channel)
    src = sys.stdin if opt.ctm == "-" else open(opt.ctm, encoding="utf-8")
    try:
        for line in convert_ctm(src, segments, reco2file,
                                skip_unknown=opt.skip_unknown):
            print(line)
    finally:
        if src is not sys.stdin:
            src.close()
    return 0


if __name__ == "__main__":
    log_startup()
    raise SystemExit(main())
