"""Keyword search over word lattices + kwslist output/post-processing
(the port's copy of ``pytorch_kaldi_asr_tpu.tools.kws``).

The KWS tool group the reference vendors (reference kaldi/utils/:
write_kwslist.pl:1-334, kwslist_post_process.pl:1-291), natively backed by
this framework's lattices (decode/latgen.py lattice mode):

- search_lattice: find keyword (word-sequence) occurrences with
  forward-backward posterior scores and frame times;
- Hit / write_kwslist: the NIST-style kwslist XML with duplicate-time
  merging, score normalization (none / KST sum-to-one), and YES/NO
  threshold decisions — the write_kwslist.pl surface;
- post_process_kwslist: re-normalize, dedup, and re-threshold an existing
  kwslist XML (kwslist_post_process.pl role).

CLI: python -m pytorch_kaldi_asr_tpu_torch.tools.kws <search|post-process> ...
"""

from __future__ import annotations

import argparse
import sys
import xml.etree.ElementTree as ET
from collections import defaultdict
from dataclasses import dataclass

from pytorch_kaldi_asr_tpu_torch.decode.lattice_io import (
    read_text_lattice_archive,
)
from pytorch_kaldi_asr_tpu_torch.utils.logging import log_startup


@dataclass
class Hit:
    kwid: str
    utt: str
    tbeg: int       # frames
    dur: int        # frames
    score: float
    decision: str = ""


def search_lattice(lat, keywords, *, acoustic_scale=1.0, lm_scale=1.0,
                   min_score=1e-4):
    """Find occurrences of each keyword in one lattice.

    keywords: {kwid: [word, ...]}.  A hit's score is the exact occurrence
    posterior: the sum over all lattice paths that pass through the
    keyword's word sequence starting at a given link, computed with the
    forward/backward node scores (the lattice-index summation
    write_kwslist.pl consumes).  Returns [Hit]."""
    import math

    alpha, beta, total = lat.alpha_beta(acoustic_scale=acoustic_scale,
                                        lm_scale=lm_scale)

    def lw(l):
        return -(acoustic_scale * l.acoustic + lm_scale * l.graph)

    def lse(a, b):
        if a == -math.inf:
            return b
        if b == -math.inf:
            return a
        m = max(a, b)
        return m + math.log(math.exp(a - m) + math.exp(b - m))

    by_start = defaultdict(list)
    for l in lat.links:
        by_start[l.start].append(l)
    order = lat.topo_order()
    pos_in_order = {n: i for i, n in enumerate(order)}

    def eps_sum(scores):
        """Sum-propagate through eps links in topological order; keeps the
        originals too (a next word can start right away)."""
        i = 0
        # process nodes in topo order, extending as we reach new ones
        seen = dict(scores)
        work = sorted(seen, key=pos_in_order.get)
        while i < len(work):
            u = work[i]
            i += 1
            for l in by_start[u]:
                if l.word in ("<eps>", "!NULL", ""):
                    v = seen[u] + lw(l)
                    if l.end in seen:
                        seen[l.end] = lse(seen[l.end], v)
                    else:
                        seen[l.end] = v
                        # insert keeping topo order (append then resort tail)
                        work.append(l.end)
                        work[i:] = sorted(work[i:], key=pos_in_order.get)
        return seen

    hits = []
    for kwid, words in keywords.items():
        if not words:
            continue
        for l0 in lat.links:
            if l0.word != words[0]:
                continue
            state = {l0.end: alpha[l0.start] + lw(l0)}
            ok = True
            for w in words[1:]:
                reach = eps_sum(state)
                nxt: dict[int, float] = {}
                for node, sc in reach.items():
                    for l in by_start[node]:
                        if l.word == w:
                            v = sc + lw(l)
                            nxt[l.end] = lse(nxt.get(l.end, -math.inf), v)
                if not nxt:
                    ok = False
                    break
                state = nxt
            if not ok:
                continue
            # total posterior is the log-sum over end nodes; the reported
            # end time comes from the DOMINANT end node (track the max
            # separately — comparing against the running log-sum would let
            # an earlier pair outvote the true best contributor)
            logpost = -math.inf
            end_node = None
            best_contrib = -math.inf
            for node, sc in state.items():
                contrib = sc + beta[node]
                if contrib > best_contrib:
                    best_contrib = contrib
                    end_node = node
                logpost = lse(logpost, contrib)
            score = math.exp(min(logpost - total, 0.0))
            if score >= min_score and end_node is not None:
                tbeg = lat.node_times[l0.start]
                tend = lat.node_times[end_node]
                hits.append(Hit(kwid, lat.utt, tbeg, max(tend - tbeg, 1),
                                score))
    return _merge_overlapping(hits)


def _merge_overlapping(hits):
    """A word occurrence is spread over many time-parallel lattice paths;
    its detection score is the SUM of path posteriors in the overlapping
    time region (the lattice-index summation), capped at 1."""
    by_kw = defaultdict(list)
    for h in hits:
        by_kw[(h.kwid, h.utt)].append(h)
    merged = []
    for hs in by_kw.values():
        hs.sort(key=lambda h: h.tbeg)
        cur = None
        for h in hs:
            if cur is not None and h.tbeg < cur.tbeg + cur.dur:
                end = max(cur.tbeg + cur.dur, h.tbeg + h.dur)
                cur.dur = end - cur.tbeg
                cur.score = min(cur.score + h.score, 1.0)
            else:
                if cur is not None:
                    merged.append(cur)
                cur = Hit(h.kwid, h.utt, h.tbeg, h.dur, h.score)
        if cur is not None:
            merged.append(cur)
    merged.sort(key=lambda h: (h.kwid, h.utt, h.tbeg))
    return merged


def _dedup(hits, duptime):
    """Keep the best-scoring hit among same-kw/same-utt hits starting
    within ``duptime`` frames of each other (write_kwslist.pl --duptime)."""
    out = []
    by_key = defaultdict(list)
    for h in hits:
        by_key[(h.kwid, h.utt)].append(h)
    for hs in by_key.values():
        hs.sort(key=lambda h: -h.score)
        kept = []
        for h in hs:
            if all(abs(h.tbeg - k.tbeg) > duptime for k in kept):
                kept.append(h)
        out.extend(kept)
    out.sort(key=lambda h: (h.kwid, h.utt, h.tbeg))
    return out


def normalize_scores(hits, method="none"):
    """'kst': per-keyword sum-to-one normalization
    (write_kwslist.pl --normalize); 'none': raw posteriors."""
    if method == "none":
        return hits
    if method != "kst":
        raise ValueError(f"unknown normalization {method!r}")
    total = defaultdict(float)
    for h in hits:
        total[h.kwid] += h.score
    for h in hits:
        if total[h.kwid] > 0:
            h.score = h.score / total[h.kwid]
    return hits


def write_kwslist(hits, f, *, kwlist_id="kwlist", language="",
                  frame_rate=0.01, threshold=0.5, duptime=50,
                  normalize="none", digits=6):
    """Emit the kwslist XML (write_kwslist.pl output format)."""
    hits = _dedup(list(hits), duptime)
    hits = normalize_scores(hits, normalize)
    by_kw = defaultdict(list)
    for h in hits:
        h.decision = "YES" if h.score >= threshold else "NO"
        by_kw[h.kwid].append(h)
    f.write(
        f'<kwslist kwlist_filename="{kwlist_id}" language="{language}" '
        f'system_id="">\n'
    )
    for kwid in sorted(by_kw):
        f.write(f'  <detected_kwlist kwid="{kwid}" search_time="1" '
                f'oov_count="0">\n')
        for h in by_kw[kwid]:
            f.write(
                f'    <kw file="{h.utt}" channel="1" '
                f'tbeg="{h.tbeg * frame_rate:.2f}" '
                f'dur="{h.dur * frame_rate:.2f}" '
                f'score="{h.score:.{digits}f}" decision="{h.decision}"/>\n'
            )
        f.write("  </detected_kwlist>\n")
    f.write("</kwslist>\n")
    return hits


def read_kwslist(path):
    """Parse a kwslist XML back into [Hit] (+ header attrs)."""
    tree = ET.parse(path)
    root = tree.getroot()
    hits = []
    for dk in root.findall("detected_kwlist"):
        kwid = dk.get("kwid")
        for kw in dk.findall("kw"):
            hits.append(Hit(
                kwid=kwid,
                utt=kw.get("file"),
                tbeg=int(round(float(kw.get("tbeg")) / 0.01)),
                dur=int(round(float(kw.get("dur")) / 0.01)),
                score=float(kw.get("score")),
                decision=kw.get("decision") or "",
            ))
    return hits, dict(root.attrib)


def post_process_kwslist(xml_in, xml_out, *, threshold=0.5, duptime=50,
                         normalize="none", remove_no=False, digits=6):
    """kwslist_post_process.pl role: read, dedup, renormalize, re-decide,
    optionally drop NO entries, write."""
    hits, attrs = read_kwslist(xml_in)
    hits = _dedup(hits, duptime)
    hits = normalize_scores(hits, normalize)
    for h in hits:
        h.decision = "YES" if h.score >= threshold else "NO"
    if remove_no:
        hits = [h for h in hits if h.decision == "YES"]
    with open(xml_out, "w", encoding="utf-8") as f:
        write_kwslist(hits, f,
                      kwlist_id=attrs.get("kwlist_filename", "kwlist"),
                      language=attrs.get("language", ""),
                      threshold=threshold, duptime=duptime,
                      normalize="none", digits=digits)
    return xml_out


def main(argv=None):
    parser = argparse.ArgumentParser(prog="kws")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("search", help="search keywords in SLF/kaldi lattices")
    p.add_argument("-keywords", required=True,
                   help="file of lines: kwid word word ...")
    p.add_argument("-lattices", required=True,
                   help="kaldi text lattice archive (key + block format)")
    p.add_argument("-output", required=True)
    p.add_argument("-threshold", type=float, default=0.5)
    p.add_argument("-duptime", type=int, default=50)
    p.add_argument("-normalize", choices=["none", "kst"], default="none")

    p = sub.add_parser("post-process")
    p.add_argument("xml_in")
    p.add_argument("xml_out")
    p.add_argument("-threshold", type=float, default=0.5)
    p.add_argument("-duptime", type=int, default=50)
    p.add_argument("-normalize", choices=["none", "kst"], default="none")
    p.add_argument("-remove_no", action="store_true")

    opt = parser.parse_args(argv)
    if opt.cmd == "search":
        keywords = {}
        with open(opt.keywords, encoding="utf-8") as f:
            for line in f:
                parts = line.split()
                if parts:
                    keywords[parts[0]] = parts[1:]
        hits = []
        for _utt, lat in read_text_lattice_archive(opt.lattices):
            hits.extend(search_lattice(lat, keywords))
        with open(opt.output, "w", encoding="utf-8") as f:
            write_kwslist(hits, f, threshold=opt.threshold,
                          duptime=opt.duptime, normalize=opt.normalize)
    elif opt.cmd == "post-process":
        post_process_kwslist(opt.xml_in, opt.xml_out,
                             threshold=opt.threshold, duptime=opt.duptime,
                             normalize=opt.normalize,
                             remove_no=opt.remove_no)
    return 0


if __name__ == "__main__":
    log_startup()
    sys.exit(main())
