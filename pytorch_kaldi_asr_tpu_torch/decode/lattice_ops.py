"""Lattice algebra: the Kaldi lattice-tool verbs over decode/lattice_io.py's
WordLattice (the port's ``pytorch_kaldi_asr_tpu.decode.lattice_ops``, on
the host):

- :func:`scale_lattice`     lattice-scale --acoustic-scale --lm-scale
- :func:`prune_lattice`     lattice-prune --beam (cost-from-best pruning)
- :func:`best_path`         lattice-best-path (on WordLattice)
- :func:`nbest`             lattice-nbest --n (distinct word sequences)
- :func:`oracle_wer`        lattice-oracle (the least edit distance over all
                            lattice paths, by dynamic programming over
                            (node, reference position) states)
- :func:`oracle_errors`     its error count alone, the DP a node's row at
                            a time in numpy (tools/lattice_copy.py)

The recognition server's hybrid n-best reads :func:`nbest`.
"""

from __future__ import annotations

import heapq
import math

from pytorch_kaldi_asr_tpu_torch.decode.lattice_io import WordLattice
from pytorch_kaldi_asr_tpu_torch.utils.logging import warning

_EPS_WORDS = ("<eps>", "!NULL", "")


def scale_lattice(lat, *, acoustic_scale=1.0, lm_scale=1.0, inplace=False):
    """Scale the acoustic/graph costs (lattice-scale semantics: the two
    weight components are scaled independently; finals scale with lm)."""
    if inplace:
        for l in lat.links:
            l.acoustic *= acoustic_scale
            l.graph *= lm_scale
        lat.finals = {n: w * lm_scale for n, w in lat.finals.items()}
        return lat
    out = WordLattice(node_times=list(lat.node_times), links=[], finals={},
                      utt=lat.utt)
    for l in lat.links:
        out.add_link(l.start, l.end, l.word, l.acoustic * acoustic_scale,
                     l.graph * lm_scale)
    out.finals = {n: w * lm_scale for n, w in lat.finals.items()}
    return out


def _forward_backward_costs(lat):
    """Tropical (min-cost) forward alpha and backward beta per node."""
    INF = math.inf
    n = lat.num_nodes
    order = lat.topo_order()
    out = lat.out_links()
    alpha = [INF] * n
    alpha[0] = 0.0
    for s in order:
        if alpha[s] == INF:
            continue
        for l in out[s]:
            c = alpha[s] + l.cost
            if c < alpha[l.end]:
                alpha[l.end] = c
    beta = [INF] * n
    for s, fw in lat.finals.items():
        beta[s] = fw
    for s in reversed(order):
        for l in out[s]:
            c = l.cost + beta[l.end]
            if c < beta[s]:
                beta[s] = c
    return alpha, beta


def prune_lattice(lat, beam):
    """lattice-prune: drop links (and unreachable nodes) whose best path
    through them costs more than best + beam.  Node ids are compacted."""
    alpha, beta = _forward_backward_costs(lat)
    best = min((alpha[s] + fw for s, fw in lat.finals.items()),
               default=math.inf)
    keep_links = [
        l for l in lat.links
        if alpha[l.start] + l.cost + beta[l.end] <= best + beam
    ]
    used = {0}
    for l in keep_links:
        used.add(l.start)
        used.add(l.end)
    finals = {s: w for s, w in lat.finals.items()
              if s in used and alpha[s] + w <= best + beam}
    used |= set(finals)
    remap = {}
    out = WordLattice(utt=lat.utt)
    for s in sorted(used):
        remap[s] = out.add_node(lat.node_times[s])
    for l in keep_links:
        out.add_link(remap[l.start], remap[l.end], l.word, l.acoustic,
                     l.graph)
    out.finals = {remap[s]: w for s, w in finals.items()}
    return out


def best_path(lat, **kw):
    """lattice-best-path (delegates to WordLattice.best_path)."""
    return lat.best_path(**kw)


def nbest(lat, n, *, acoustic_scale=1.0, lm_scale=1.0,
          with_components=False):
    """lattice-nbest: the n lowest-cost DISTINCT word sequences, via
    best-first search with the exact backward cost as the A* heuristic.
    Returns [(words, cost)] sorted by cost; with_components=True returns
    [(words, cost, acoustic_cost, graph_cost)] where the components are
    the UNSCALED per-hypothesis sums (final weights count as graph) —
    what an external LM rescorer needs to replace the graph/LM part
    (tools/lattice_rescore.py, the Kaldi lmrescore role)."""
    scaled = scale_lattice(lat, acoustic_scale=acoustic_scale,
                           lm_scale=lm_scale)
    _, beta = _forward_backward_costs(scaled)
    if not scaled.finals or beta[0] == math.inf:
        return []
    out = scaled.out_links()
    raw_out = lat.out_links()  # unscaled components, same link order
    results = []
    seen = set()
    # heap entries: (f = g + beta[node], tiebreak, node, g, words, am, gr)
    # node=None marks a finished hypothesis whose f is its exact cost.
    # Finishing is an explicit transition (not recorded at first visit of
    # a final node) because a final node may still continue to a cheaper
    # final through epsilon links.
    counter = 0
    heap = [(beta[0], counter, 0, 0.0, (), 0.0, 0.0)]
    # bounded expansion: each pop is on an exact heuristic so the first n
    # distinct finished word-sequences popped are optimal
    max_pops = 200 * max(n, 1) * max(scaled.num_nodes, 1)
    pops = 0
    # (node, words) states already expanded: the first pop of a state is
    # its cheapest (its entries share beta[node], so they pop in g order),
    # and any later one only continues to the same word sequences at a
    # higher cost.  Skipping them keeps the results and makes the search
    # polynomial where the JAX package's enumerates every alignment of a
    # word sequence (a deliberate difference: ROADMAP.md)
    expanded = set()
    while heap and len(results) < n and pops < max_pops:
        f, _, node, g, words, am, gr = heapq.heappop(heap)
        pops += 1
        if node is None:  # finished hypothesis, f == exact cost
            if words not in seen:
                seen.add(words)
                if with_components:
                    results.append((list(words), f, am, gr))
                else:
                    results.append((list(words), f))
            continue
        if (node, words) in expanded:
            continue
        expanded.add((node, words))
        fw = scaled.finals.get(node)
        if fw is not None and words not in seen:
            counter += 1
            heapq.heappush(heap, (g + fw, counter, None, g, words, am,
                                  gr + lat.finals.get(node, 0.0)))
        for l, rl in zip(out[node], raw_out[node]):
            w2 = words if l.word in _EPS_WORDS else words + (l.word,)
            g2 = g + l.cost
            counter += 1
            heapq.heappush(heap, (g2 + beta[l.end], counter, l.end, g2,
                                  w2, am + rl.acoustic, gr + rl.graph))
    if heap and len(results) < n and pops >= max_pops:
        # search gave up, not "lattice exhausted" — callers must be able
        # to tell the difference
        warning("nbest(%s): search cap hit after %d pops with %d/%d "
                "hypotheses — lattice has heavy epsilon ambiguity",
                lat.utt or "?", pops, len(results), n)
    return results


def oracle_wer(lat, ref_words):
    """lattice-oracle: minimum (ins+del+sub) edit distance between the
    reference and ANY path through the lattice, by DP over
    (lattice node, reference position) with epsilon-closure handled by
    relaxation.  Returns (errors, best_words)."""
    INF = math.inf
    order = lat.topo_order()
    pos_of = {s: i for i, s in enumerate(order)}
    out = lat.out_links()
    R = len(ref_words)
    # dist[node][j] = min errors consuming ref[:j] reaching node
    dist = {s: [INF] * (R + 1) for s in range(lat.num_nodes)}
    back = {s: [None] * (R + 1) for s in range(lat.num_nodes)}
    dist[0][0] = 0.0
    # process in topo order; within a node, deletions advance j (ref word
    # skipped = deletion from the hypothesis point of view)
    for s in order:
        row = dist[s]
        for j in range(R + 1):
            d = row[j]
            if d == INF:
                continue
            if j < R and d + 1 < row[j + 1]:  # skip ref word: deletion
                row[j + 1] = d + 1
                back[s][j + 1] = (s, j, None, "del")
            for l in out[s]:
                t = l.end
                if l.word in _EPS_WORDS:  # epsilon link: free move
                    if d < dist[t][j]:
                        dist[t][j] = d
                        back[t][j] = (s, j, l, "eps")
                    continue
                # insertion: hyp word with no ref advance
                if d + 1 < dist[t][j]:
                    dist[t][j] = d + 1
                    back[t][j] = (s, j, l, "ins")
                if j < R:
                    cost = 0 if l.word == ref_words[j] else 1
                    if d + cost < dist[t][j + 1]:
                        dist[t][j + 1] = d + cost
                        back[t][j + 1] = (s, j, l,
                                          "cor" if cost == 0 else "sub")
    # NOTE: epsilon links to earlier-in-order nodes would need iteration;
    # lattices from latgen are DAGs in topo order so one pass suffices.
    best_s, best_err = None, INF
    for s in lat.finals:
        if dist[s][R] < best_err:
            best_s, best_err = s, dist[s][R]
    if best_s is None:
        return (R, [])
    words = []
    s, j = best_s, R
    while back[s][j] is not None:
        ps, pj, link, kind = back[s][j]
        if link is not None and link.word not in _EPS_WORDS:
            words.append(link.word)
        s, j = ps, pj
    return (int(best_err), words[::-1])


def oracle_errors(lat, ref_words):
    """The error count of :func:`oracle_wer` alone, without its best path:
    the same DP over (lattice node, reference position), each node's row
    at once in numpy — its deletions as a running minimum, then each
    link's epsilon move, insertion and match or substitution into the
    row of its end node.  The counts are small integers in float64, so
    they are exact; lattice_copy's ``-oracle_ref`` writes only these."""
    import numpy as np

    R = len(ref_words)
    ar = np.arange(R + 1, dtype=np.float64)
    ref = np.array(ref_words, dtype=object)
    dist = np.full((lat.num_nodes, R + 1), math.inf)
    dist[0, 0] = 0.0
    out = lat.out_links()
    mismatch = {}  # word -> [R] 0 where the reference word is it, else 1
    for s in lat.topo_order():
        if dist[s].min() == math.inf:
            continue
        row = np.minimum.accumulate(dist[s] - ar) + ar  # deletions
        dist[s] = row
        for l in out[s]:
            t = dist[l.end]
            if l.word in _EPS_WORDS:  # epsilon link: free move
                np.minimum(t, row, out=t)
                continue
            np.minimum(t, row + 1.0, out=t)  # insertion
            sub = mismatch.get(l.word)
            if sub is None:
                sub = mismatch[l.word] = (ref != l.word).astype(np.float64)
            np.minimum(t[1:], row[:-1] + sub, out=t[1:])
    best = min((dist[s, R] for s in lat.finals), default=math.inf)
    return R if best == math.inf else int(best)
