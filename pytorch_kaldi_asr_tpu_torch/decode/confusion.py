"""Confusion networks, consensus (MBR) decoding, CTM, and ROVER fusion
(the port's copy of ``pytorch_kaldi_asr_tpu.decode.confusion``).

The reference's vendored Kaldi layer hands lattices to external binaries
for these roles (lattice-mbr-decode / lattice-to-ctm-conf in
steps/get_ctm.sh-style scoring; SCTK ``rover`` for system combination —
the chain its convert_slf.pl / write_kwslist.pl outputs feed in KWS and
scoring pipelines).  This module implements them natively over
decode/lattice_io.py's WordLattice:

- :func:`confusion_network`  lattice -> sausage of time-ordered bins of
  (word, posterior) alternatives, via pivot alignment against the Viterbi
  path (the practical variant of Mangu-Brill consensus clustering);
- :func:`consensus`          argmax-per-bin decoding over the sausage =
  minimum-Bayes-risk decoding under the word-error loss approximation
  (lattice-mbr-decode role), with per-word confidences and frame spans;
- :func:`ctm_lines`          NIST CTM output with confidences
  (lattice-to-ctm-conf role);
- :func:`read_ctm`           CTM parsing (rover's input side);
- :func:`rover`              ROVER word-transition-network combination of
  N systems with confidence-weighted voting (SCTK rover role).

Everything is plain host-side Python: lattices are tiny (hundreds of
links) next to the search that produced them.
"""

from __future__ import annotations

import math
from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np

_EPS_WORDS = ("<eps>", "!NULL", "")

#: the NULL (word-absent) token inside ROVER word transition networks
NULL = "@"


@dataclass
class ConfusionBin:
    """One sausage slot: competing words with posteriors over [start, end)
    frames.  ``words`` maps word -> posterior; the epsilon/skip mass is
    ``max(0, 1 - sum(words.values()))`` (paths that carry no word here)."""

    start: int
    end: int
    words: dict = field(default_factory=dict)

    @property
    def eps_mass(self):
        return max(0.0, 1.0 - sum(self.words.values()))

    def best(self):
        """(word, posterior) of the winning entry, where the epsilon/skip
        alternative competes as (None, eps_mass)."""
        w, p = None, self.eps_mass
        for word, post in sorted(self.words.items()):
            if post > p:
                w, p = word, post
        return w, p


def _viterbi_links(lat, *, acoustic_scale=1.0, lm_scale=1.0):
    """Links of the best path (lattice_io.best_path keeps only words)."""
    INF = math.inf
    dist = [INF] * lat.num_nodes
    back = [None] * lat.num_nodes
    dist[0] = 0.0
    out = lat.out_links()
    for n in lat.topo_order():
        if dist[n] == INF:
            continue
        for l in out[n]:
            c = dist[n] + acoustic_scale * l.acoustic + lm_scale * l.graph
            if c < dist[l.end]:
                dist[l.end] = c
                back[l.end] = l
    best, bc = None, INF
    for n, fw in lat.finals.items():
        if dist[n] + fw < bc:
            best, bc = n, dist[n] + fw
    if best is None:
        return []
    links = []
    n = best
    while back[n] is not None:
        links.append(back[n])
        n = back[n].start
    return links[::-1]


def _overlap(a0, a1, b0, b1):
    """Length of [a0,a1) ∩ [b0,b1); point intervals count as length-1 at
    their position so zero-duration links can still attach to a bin."""
    if a1 <= a0:
        a1 = a0 + 1
    if b1 <= b0:
        b1 = b0 + 1
    return min(a1, b1) - max(a0, b0)


def _node_reachability(lat):
    """reach[n] = bitset (int) of nodes reachable from n by >=1 link."""
    out = lat.out_links()
    reach = [0] * lat.num_nodes
    for n in reversed(lat.topo_order()):
        r = 0
        for l in out[n]:
            r |= (1 << l.end) | reach[l.end]
        reach[n] = r
    return reach


@dataclass
class _Cluster:
    """Intra-word cluster: same-word links on PARALLEL paths that overlap
    in time — one hypothesised word token, whatever frame the arcs that
    carry it land on."""

    word: str
    start: int
    end: int
    post: float
    nodes_in: int = 0   # bitset of link start nodes
    nodes_out: int = 0  # bitset of link end nodes
    on_pivot: bool = False
    pivot_rank: int = -1


def confusion_network(lat, *, acoustic_scale=1.0, lm_scale=1.0,
                      prune=1e-4):
    """Build the sausage, Mangu-Brill style in two stages.

    Intra-word stage: same-word links merge into one cluster when their
    frame spans overlap or touch AND no lattice path connects them —
    parallel alternatives for one spoken token smear the same word over
    adjacent frames on different paths (HMM-expanded graphs emit word
    labels on instantaneous arcs), while a genuine repeat ("tab tab")
    lies on a single path and must stay two clusters.  Cluster posterior
    is the sum over its links.

    Inter-word stage (pivot alignment): clusters containing a Viterbi
    link seed the bins in path order; every other cluster joins the bin
    it overlaps most in time, or opens a new bin at its midpoint.
    Clusters with posterior below ``prune`` are dropped.

    Returns a time-ordered list of :class:`ConfusionBin`.
    """
    posts = lat.forward_backward(acoustic_scale=acoustic_scale,
                                 lm_scale=lm_scale)
    times = lat.node_times
    reach = _node_reachability(lat)
    pivot_ids = {id(l): rank for rank, l in enumerate(_viterbi_links(
        lat, acoustic_scale=acoustic_scale, lm_scale=lm_scale))
        if l.word not in _EPS_WORDS}

    def ordered(c, link_start, link_end):
        """True if some lattice path connects cluster c and this link
        (sequential occurrences — distinct tokens, must not merge)."""
        for n_out in _bits(c.nodes_out):
            if (reach[n_out] >> link_start) & 1 or n_out == link_start:
                return True
        if (reach[link_end] & c.nodes_in) or ((1 << link_end) & c.nodes_in):
            return True
        return False

    clusters = {}
    for l, p in sorted(posts, key=lambda lp: -lp[1]):
        if l.word in _EPS_WORDS or p <= 0.0:
            continue
        s, e = times[l.start], times[l.end]
        merged = None
        for c in clusters.get(l.word, ()):
            if _overlap(s, e, c.start, c.end) <= 0 and not (
                    c.start <= e and s <= c.end):
                continue
            if ordered(c, l.start, l.end):
                continue  # sequential occurrence: a different token
            merged = c
            break
        if merged is None:
            merged = _Cluster(l.word, s, e, 0.0)
            clusters.setdefault(l.word, []).append(merged)
        merged.start = min(merged.start, s)
        merged.end = max(merged.end, e)
        merged.post += p
        merged.nodes_in |= 1 << l.start
        merged.nodes_out |= 1 << l.end
        if id(l) in pivot_ids:
            merged.on_pivot = True
            merged.pivot_rank = pivot_ids[id(l)]
    allc = [c for cs in clusters.values() for c in cs if c.post >= prune]
    allc.sort(key=lambda c: -c.post)
    bins = [ConfusionBin(c.start, c.end, {c.word: min(c.post, 1.0)})
            for c in sorted((c for c in allc if c.on_pivot),
                            key=lambda c: c.pivot_rank)]
    # each bin's span as _overlap reads it and its midpoint, in bin order:
    # a cluster's overlap with every bin at once, the first largest winning
    # (a scan over the bins with a strict comparison)
    starts = np.array([b.start for b in bins], dtype=np.int64)
    ends = np.array([max(b.end, b.start + 1) for b in bins], dtype=np.int64)
    mids = np.array([(b.start + b.end) / 2.0 for b in bins])
    for c in allc:
        if c.on_pivot:
            continue
        c_end = max(c.end, c.start + 1)
        ov = np.minimum(ends, c_end) - np.maximum(starts, c.start)
        k = int(np.argmax(ov)) if len(bins) else 0
        if len(bins) and ov[k] > 0:
            best_bin = bins[k]
        else:
            best_bin = ConfusionBin(c.start, c.end)
            mid = (c.start + c.end) / 2.0
            later = mids > mid  # before the first bin whose midpoint is later
            at = int(np.argmax(later)) if later.any() else len(bins)
            bins.insert(at, best_bin)
            starts = np.insert(starts, at, c.start)
            ends = np.insert(ends, at, c_end)
            mids = np.insert(mids, at, mid)
        best_bin.words[c.word] = min(
            best_bin.words.get(c.word, 0.0) + c.post, 1.0)
    return bins


def _bits(mask):
    while mask:
        low = mask & -mask
        yield low.bit_length() - 1
        mask ^= low


def consensus(bins):
    """MBR/consensus decoding over the sausage: per bin, keep the argmax
    word unless the epsilon/skip mass wins.  Returns
    [(word, confidence, start_frame, end_frame)] in time order."""
    out = []
    for b in bins:
        w, p = b.best()
        if w is not None:
            out.append((w, p, b.start, b.end))
    return out


def mbr_decode(lat, *, acoustic_scale=1.0, lm_scale=1.0, prune=1e-4):
    """lattice-mbr-decode role: (words, confidences) for one lattice."""
    entries = consensus(confusion_network(
        lat, acoustic_scale=acoustic_scale, lm_scale=lm_scale, prune=prune))
    return [w for w, _, _, _ in entries], [c for _, c, _, _ in entries]


# -- CTM ---------------------------------------------------------------------


def ctm_lines(utt, entries, *, frame_rate=0.01, channel=1):
    """NIST CTM lines ``utt chan start dur word conf`` from consensus
    entries (lattice-to-ctm-conf role).  Zero-duration words get one
    frame of duration so downstream scorers keep them."""
    lines = []
    for word, conf, s, e in entries:
        dur = max(e - s, 1) * frame_rate
        lines.append(f"{utt} {channel} {s * frame_rate:.2f} {dur:.2f} "
                     f"{word} {conf:.3f}")
    return lines


def read_ctm(path):
    """Parse a CTM file -> {utt: [(word, conf, start_s, dur_s)]} in time
    order.  A missing confidence column reads as 1.0."""
    by_utt = defaultdict(list)
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if len(parts) < 5 or parts[0].startswith(";;"):
                continue
            utt, _chan, start, dur, word = parts[:5]
            conf = float(parts[5]) if len(parts) > 5 else 1.0
            by_utt[utt].append((word, conf, float(start), float(dur)))
    for utt in by_utt:
        by_utt[utt].sort(key=lambda e: e[2])
    return dict(by_utt)


# -- ROVER -------------------------------------------------------------------


def _align_to_wtn(wtn, hyp, n_seen):
    """Align one hypothesis [(word, conf)] against the word transition
    network (list of slots, slot = {word: [sum_conf, count]}), minimum
    edit cost: 0 to enter a slot already containing the word, 1 for a
    substitution/insertion/deletion.  Returns the merged WTN."""
    n, m = len(wtn), len(hyp)
    INF = math.inf
    # dp[i][j]: cost aligning wtn[:i] with hyp[:j]
    dp = [[INF] * (m + 1) for _ in range(n + 1)]
    op = [[None] * (m + 1) for _ in range(n + 1)]
    dp[0][0] = 0.0
    for i in range(n + 1):
        for j in range(m + 1):
            d = dp[i][j]
            if d == INF:
                continue
            if i < n:  # hyp skips this slot (NULL into slot)
                # cheaper if the slot already holds NULL votes
                c = d + (0.5 if NULL in wtn[i] else 1.0)
                if c < dp[i + 1][j]:
                    dp[i + 1][j] = c
                    op[i + 1][j] = "del"
            if j < m:  # hyp word opens a new slot
                c = d + 1.0
                if c < dp[i][j + 1]:
                    dp[i][j + 1] = c
                    op[i][j + 1] = "ins"
            if i < n and j < m:
                c = d + (0.0 if hyp[j][0] in wtn[i] else 1.0)
                if c < dp[i + 1][j + 1]:
                    dp[i + 1][j + 1] = c
                    op[i + 1][j + 1] = "match"
    # trace back into a merge script, then replay it forwards
    script = []
    i, j = n, m
    while i or j:
        o = op[i][j]
        script.append(o)
        if o == "del":
            i -= 1
        elif o == "ins":
            j -= 1
        else:
            i -= 1
            j -= 1
    script.reverse()
    merged = []
    i = j = 0
    for o in script:
        if o == "del":
            slot = wtn[i]
            votes = slot.setdefault(NULL, [0.0, 0])
            votes[1] += 1
            merged.append(slot)
            i += 1
        elif o == "ins":
            word, conf = hyp[j]
            slot = {word: [conf, 1], NULL: [0.0, n_seen]}
            merged.append(slot)
            j += 1
        else:
            slot = wtn[i]
            word, conf = hyp[j]
            votes = slot.setdefault(word, [0.0, 0])
            votes[0] += conf
            votes[1] += 1
            merged.append(slot)
            i += 1
            j += 1
    return merged


def rover(hyps, *, alpha=0.5, null_conf=0.7):
    """ROVER: progressive WTN alignment of N hypotheses then
    confidence-weighted voting (Fiscus 1997, the SCTK ``rover`` role the
    reference's multi-system scoring would shell out to).

    ``hyps``: list of systems, each a list of (word, confidence).
    Vote score = ``alpha * freq + (1 - alpha) * mean_conf`` where NULL's
    confidence is the fixed ``null_conf`` prior.  Returns
    [(word, score)] for the winning non-NULL words in order.
    """
    systems = [list(h) for h in hyps if True]
    if not systems:
        return []
    wtn = [{w: [c, 1]} for w, c in systems[0]]
    for k, hyp in enumerate(systems[1:], start=1):
        wtn = _align_to_wtn(wtn, hyp, n_seen=k)
        # systems aligned so far that had no entry in a slot vote NULL
        for slot in wtn:
            have = sum(v[1] for v in slot.values())
            if have < k + 1:
                votes = slot.setdefault(NULL, [0.0, 0])
                votes[1] += (k + 1) - have
    n_sys = len(systems)
    out = []
    for slot in wtn:
        best_w, best_s = NULL, -1.0
        for w in sorted(slot):
            conf_sum, count = slot[w]
            mean_conf = (null_conf if w == NULL
                         else (conf_sum / count if count else 0.0))
            score = alpha * (count / n_sys) + (1 - alpha) * mean_conf
            if score > best_s:
                best_w, best_s = w, score
        if best_w != NULL:
            out.append((best_w, best_s))
    return out


def rover_ctms(ctm_by_system, *, alpha=0.5, null_conf=0.7):
    """Combine per-system CTM dicts (:func:`read_ctm` output) utterance by
    utterance.  Systems missing an utterance simply don't vote on it.
    Returns {utt: [(word, score)]}."""
    utts = sorted({u for ctm in ctm_by_system for u in ctm})
    out = {}
    for utt in utts:
        hyps = [[(w, c) for w, c, _, _ in ctm[utt]]
                for ctm in ctm_by_system if utt in ctm]
        out[utt] = rover(hyps, alpha=alpha, null_conf=null_conf)
    return out
