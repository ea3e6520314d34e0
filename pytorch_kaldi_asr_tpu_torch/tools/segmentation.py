"""Speech/silence segmentation of long recordings into utterance chunks.

The reference kaldi/utils/segmentation.pl:1-402 role, same algorithm:

input lines ``recording-id c c c ...`` with one class per frame
(0 = silence, 1 = noise/other nonspeech, 2 = speech); output a Kaldi
``segments`` file (``utt-id recording-id start-sec end-sec``).

Phases (matching the reference's header comment):
(1) contiguous class-1/2 runs become initial segments;
(2) grow segments into flanking silence until the silence proportion
    reaches ``silence_proportion`` (one frame per side per round, never
    crossing into another segment);
(3) merge touching segments, least-silence boundaries first, while the
    merge stays under ``max_segment_length``;
(4) split segments over ``hard_max_segment_length`` into equal pieces;
(5) drop segments containing no speech frames.

CLI: python -m pytorch_kaldi_asr_tpu_torch.tools.segmentation < classes > segments
"""

from __future__ import annotations

import argparse
import math
import sys


def segment_frames(classes, *, silence_proportion=0.2,
                   max_segment_length=1000, hard_max_segment_length=1500,
                   min_inter_utt_silence_length=1):
    """Segment one recording.  ``classes``: per-frame ints 0/1/2.
    Returns [(start_frame, end_frame_exclusive)]."""
    n = len(classes)
    # (1) initial segments = contiguous runs of class != 0
    segs = []
    i = 0
    while i < n:
        if classes[i] != 0:
            j = i
            while j < n and classes[j] != 0:
                j += 1
            segs.append([i, j])
            i = j
        else:
            i += 1
    if not segs:
        return []

    # (2) pad with silence until the silence proportion is reached
    def stats():
        total = sum(e - s for s, e in segs)
        sil = sum(
            1 for s, e in segs for t in range(s, e) if classes[t] == 0
        )
        return sil, total

    changed = True
    while changed:
        sil, total = stats()
        if total > 0 and sil / total >= silence_proportion:
            break
        changed = False
        for k, seg in enumerate(segs):
            lo_bound = segs[k - 1][1] if k > 0 else 0
            hi_bound = segs[k + 1][0] if k + 1 < len(segs) else n
            if seg[0] > lo_bound:
                seg[0] -= 1
                changed = True
            if seg[1] < hi_bound:
                seg[1] += 1
                changed = True

    # (3) merge touching segments, least-silence boundary first
    def boundary_silence(k):
        """Silence frames around the junction of segs[k] and segs[k+1]."""
        s, e = segs[k][1], segs[k + 1][0]
        cnt = 0
        t = segs[k][1] - 1
        while t >= segs[k][0] and classes[t] == 0:
            cnt += 1
            t -= 1
        t = segs[k + 1][0]
        while t < segs[k + 1][1] and classes[t] == 0:
            cnt += 1
            t += 1
        return cnt + (e - s)

    merged = True
    while merged:
        merged = False
        touching = [k for k in range(len(segs) - 1)
                    if segs[k][1] >= segs[k + 1][0]]
        touching.sort(key=boundary_silence)
        for k in touching:
            if k + 1 >= len(segs) or segs[k][1] < segs[k + 1][0]:
                continue
            if segs[k + 1][1] - segs[k][0] <= max_segment_length:
                segs[k][1] = segs[k + 1][1]
                del segs[k + 1]
                merged = True
                break

    # (4) split over-long segments equally
    out = []
    for s, e in segs:
        length = e - s
        if length > hard_max_segment_length:
            pieces = math.ceil(length / hard_max_segment_length)
            step = length / pieces
            for p in range(pieces):
                out.append([s + round(p * step), s + round((p + 1) * step)])
        else:
            out.append([s, e])

    # (5) drop segments with no speech
    return [(s, e) for s, e in out
            if any(classes[t] == 2 for t in range(s, e))]


def write_segments(lines, f, *, frame_shift=0.01, first_separator="-",
                   second_separator="-", **kw):
    """Process ``recording-id c c c...`` lines, write a segments file."""
    n_out = 0
    for line in lines:
        parts = line.split()
        if not parts:
            continue
        rec = parts[0]
        classes = [int(c) for c in parts[1:]]
        segs = segment_frames(classes, **kw)
        if not segs:
            continue
        digits = max(
            (len(str(e)) for _, e in segs), default=1
        )
        for s, e in segs:
            utt = (f"{rec}{first_separator}{s:0{digits}d}"
                   f"{second_separator}{e:0{digits}d}")
            f.write(f"{utt} {rec} {s * frame_shift:.2f} "
                    f"{e * frame_shift:.2f}\n")
            n_out += 1
    return n_out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--silence-proportion", type=float, default=0.2)
    parser.add_argument("--max-segment-length", type=int, default=1000)
    parser.add_argument("--hard-max-segment-length", type=int, default=1500)
    parser.add_argument("--frame-shift", type=float, default=0.01)
    parser.add_argument("--first-separator", default="-")
    parser.add_argument("--second-separator", default="-")
    parser.add_argument("input", nargs="?", default="-")
    opt = parser.parse_args(argv)
    src = sys.stdin if opt.input == "-" else open(opt.input, encoding="utf-8")
    write_segments(
        src, sys.stdout, frame_shift=opt.frame_shift,
        first_separator=opt.first_separator,
        second_separator=opt.second_separator,
        silence_proportion=opt.silence_proportion,
        max_segment_length=opt.max_segment_length,
        hard_max_segment_length=opt.hard_max_segment_length,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
