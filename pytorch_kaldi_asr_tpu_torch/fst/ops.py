"""FST algorithms over the tropical semiring (the port's copy of
``pytorch_kaldi_asr_tpu.fst.ops``, trimmed to what graph compilation and
the decoders run):

- compose:      epsilon-filter composition (correct eps handling)
- determinize:  weighted subset construction with residual weights and
                pending output strings (functional transducers)
- minimize:     weight pushing + partition refinement on deterministic
                machines
- rmepsilon:    epsilon-closure elimination
- shortest_distance / shortest_path, relabel
"""

from __future__ import annotations

import heapq
from collections import defaultdict

from pytorch_kaldi_asr_tpu_torch.fst.core import EPS, INF, Fst


# ---------------------------------------------------------------------------
# composition
# ---------------------------------------------------------------------------


def compose(a: Fst, b: Fst) -> Fst:
    """Compose a o b with the standard epsilon filter (3 filter states),
    so paths with epsilons are matched exactly once.  ``b`` should be
    ilabel-sorted for efficiency (done here defensively)."""
    b = b.copy().arcsort("ilabel")
    out = Fst()
    # composite state: (state_a, state_b, filter)
    index: dict[tuple, int] = {}

    def get(sa, sb, f):
        key = (sa, sb, f)
        if key not in index:
            index[key] = out.add_state()
            queue.append(key)
        return index[key]

    if a.start < 0 or b.start < 0:
        return out
    queue: list[tuple] = []
    out.start = get(a.start, b.start, 0)
    qi = 0
    while qi < len(queue):
        sa, sb, f = queue[qi]
        s = index[(sa, sb, f)]
        qi += 1

        if a.is_final(sa) and b.is_final(sb):
            out.set_final(s, a.final_weight(sa) + b.final_weight(sb))

        b_by_ilabel = defaultdict(list)
        for arc_b in b.arcs[sb]:
            b_by_ilabel[arc_b.ilabel].append(arc_b)

        for arc_a in a.arcs[sa]:
            if arc_a.olabel == EPS:
                # a moves alone: eps-filter state 1 (blocks b's eps move
                # interleaving ambiguity)
                if f != 2:
                    out.add_arc(s, arc_a.ilabel, EPS, arc_a.weight,
                                get(arc_a.nextstate, sb, 1))
                # joint eps-eps move, allowed only from filter state 0:
                # without it, paths needing BOTH an a-side eps-output move
                # and a b-side eps-input move between two matches are lost
                # (a-alone lands in 1 where b-alone is blocked, and vice
                # versa).  Any interleaving of j a-eps + k b-eps moves is
                # realizable as min(j,k) joint moves (0->0) followed by the
                # excess side alone, so this stays duplicate-free.
                if f == 0:
                    for arc_b in b_by_ilabel.get(EPS, ()):
                        out.add_arc(s, arc_a.ilabel, arc_b.olabel,
                                    arc_a.weight + arc_b.weight,
                                    get(arc_a.nextstate, arc_b.nextstate, 0))
            else:
                for arc_b in b_by_ilabel.get(arc_a.olabel, ()):
                    out.add_arc(s, arc_a.ilabel, arc_b.olabel,
                                arc_a.weight + arc_b.weight,
                                get(arc_a.nextstate, arc_b.nextstate, 0))
        # b moves alone on its eps input arcs: filter state 2
        if f != 1:
            for arc_b in b_by_ilabel.get(EPS, ()):
                out.add_arc(s, EPS, arc_b.olabel, arc_b.weight,
                            get(sa, arc_b.nextstate, 2))
    return out.connect()


# ---------------------------------------------------------------------------
# determinization
# ---------------------------------------------------------------------------


def determinize(f: Fst, *, max_states=2_000_000) -> Fst:
    """Weighted determinization for functional transducers: subset states
    are {(state, residual weight, pending output string)}; each input label
    leaving a subset gets the common (min) weight and the longest common
    prefix of outputs, with the remainder carried in the subset."""
    if f.start < 0:
        return Fst()
    out = Fst()
    index: dict[tuple, int] = {}

    def norm(subset):
        """Normalize: subtract min weight, sort; returns (key, shift)."""
        w0 = min(w for _, w, _ in subset)
        key = tuple(sorted((s, w - w0, o) for s, w, o in subset))
        return key, w0

    def get(key):
        if key not in index:
            index[key] = out.add_state()
            queue.append(key)
            if len(index) > max_states:
                raise RuntimeError("determinize: state blowup")
        return index[key]

    start_key, _ = norm([(f.start, 0.0, ())])
    queue: list[tuple] = []
    out.start = get(start_key)
    qi = 0
    while qi < len(queue):
        key = queue[qi]
        s = index[key]
        qi += 1

        # final: all members that are final must agree on pending output
        # (functional input); final weight = min over members
        fin = INF
        fin_out = None
        for st, w, pend in key:
            if f.is_final(st):
                fw = w + f.final_weight(st)
                if fw < fin:
                    fin, fin_out = fw, pend
        if fin < INF:
            if fin_out:
                # flush pending output via epsilon-input arcs to a final sink
                cur = s
                for i, o in enumerate(fin_out):
                    nxt = out.add_state()
                    out.add_arc(cur, EPS, o, fin if i == 0 else 0.0, nxt)
                    cur = nxt
                out.set_final(cur, 0.0)
            else:
                out.set_final(s, fin)

        # group successor (state, weight, output) triples by input label
        by_ilabel: dict[int, list] = defaultdict(list)
        for st, w, pend in key:
            for a in f.arcs[st]:
                o = pend + ((a.olabel,) if a.olabel != EPS else ())
                by_ilabel[a.ilabel].append((a.nextstate, w + a.weight, o))

        for il, items in sorted(by_ilabel.items()):
            # longest common output prefix
            outs = [o for _, _, o in items]
            prefix = outs[0]
            for o in outs[1:]:
                n = 0
                while n < len(prefix) and n < len(o) and prefix[n] == o[n]:
                    n += 1
                prefix = prefix[:n]
            rest = [(st, w, o[len(prefix):]) for st, w, o in items]
            # merge duplicates keeping min weight
            best: dict[tuple, float] = {}
            for st, w, o in rest:
                k2 = (st, o)
                if w < best.get(k2, INF):
                    best[k2] = w
            subset = [(st, w, o) for (st, o), w in best.items()]
            nkey, shift = norm(subset)
            ns = get(nkey)
            # emit arc(s): first output label rides the real arc, extra
            # prefix labels need epsilon-input glue states
            if len(prefix) <= 1:
                ol = prefix[0] if prefix else EPS
                out.add_arc(s, il, ol, shift, ns)
            else:
                cur = out.add_state()
                out.add_arc(s, il, prefix[0], shift, cur)
                for o in prefix[1:-1]:
                    nxt = out.add_state()
                    out.add_arc(cur, EPS, o, 0.0, nxt)
                    cur = nxt
                out.add_arc(cur, EPS, prefix[-1], 0.0, ns)
    return out


# ---------------------------------------------------------------------------
# epsilon removal / shortest distance
# ---------------------------------------------------------------------------


def rmepsilon(f: Fst) -> Fst:
    """Remove arcs where BOTH labels are epsilon, folding their weights into
    successors via per-state epsilon-closure (tropical shortest distance)."""
    out = Fst()
    for _ in range(f.num_states):
        out.add_state()
    out.start = f.start

    for s in range(f.num_states):
        # Dijkstra over eps-arcs from s (tropical weights assumed >= 0-ish;
        # falls back to relaxation if negative weights appear)
        dist = {s: 0.0}
        heap = [(0.0, s)]
        while heap:
            d, u = heapq.heappop(heap)
            if d > dist.get(u, INF):
                continue
            for a in f.arcs[u]:
                if a.ilabel == EPS and a.olabel == EPS:
                    nd = d + a.weight
                    if nd < dist.get(a.nextstate, INF):
                        dist[a.nextstate] = nd
                        heapq.heappush(heap, (nd, a.nextstate))
        fin = INF
        for u, d in dist.items():
            if f.is_final(u):
                fin = min(fin, d + f.final_weight(u))
            for a in f.arcs[u]:
                if a.ilabel != EPS or a.olabel != EPS:
                    out.add_arc(s, a.ilabel, a.olabel, d + a.weight,
                                a.nextstate)
        if fin < INF:
            out.set_final(s, fin)
    return out.connect()


def shortest_distance(f: Fst, reverse=False):
    """Tropical shortest distance from the start (or to the finals when
    ``reverse``).  Returns a list indexed by state (INF = unreachable)."""
    n = f.num_states
    dist = [INF] * n
    if reverse:
        radj = defaultdict(list)
        for s in range(n):
            for a in f.arcs[s]:
                radj[a.nextstate].append((s, a.weight))
        heap = []
        for s, w in f.final.items():
            dist[s] = min(dist[s], w)
        heap = [(w, s) for s, w in f.final.items()]
    else:
        if f.start < 0:
            return dist
        dist[f.start] = 0.0
        heap = [(0.0, f.start)]
    heapq.heapify(heap)
    while heap:
        d, u = heapq.heappop(heap)
        if d > dist[u]:
            continue
        edges = radj[u] if reverse else [(a.nextstate, a.weight)
                                         for a in f.arcs[u]]
        for v, w in edges:
            nd = d + w
            if nd < dist[v]:
                dist[v] = nd
                heapq.heappush(heap, (nd, v))
    return dist


def shortest_path(f: Fst):
    """1-best path: returns (ilabels, olabels, weight) or None."""
    if f.start < 0:
        return None
    n = f.num_states
    dist = [INF] * n
    back: list = [None] * n
    dist[f.start] = 0.0
    heap = [(0.0, f.start)]
    while heap:
        d, u = heapq.heappop(heap)
        if d > dist[u]:
            continue
        for a in f.arcs[u]:
            nd = d + a.weight
            if nd < dist[a.nextstate]:
                dist[a.nextstate] = nd
                back[a.nextstate] = (u, a)
                heapq.heappush(heap, (nd, a.nextstate))
    best, bw = None, INF
    for s, w in f.final.items():
        if dist[s] + w < bw:
            best, bw = s, dist[s] + w
    if best is None:
        return None
    ilabs, olabs = [], []
    s = best
    while back[s] is not None:
        u, a = back[s]
        if a.ilabel != EPS:
            ilabs.append(a.ilabel)
        if a.olabel != EPS:
            olabs.append(a.olabel)
        s = u
    return ilabs[::-1], olabs[::-1], bw


# ---------------------------------------------------------------------------
# minimization
# ---------------------------------------------------------------------------


def push_weights(f: Fst) -> Fst:
    """Push weights toward the start state (reweighting by the reverse
    shortest distance) — the canonical form minimization needs."""
    d = shortest_distance(f, reverse=True)
    out = f.copy()
    for s in range(out.num_states):
        ds = d[s]
        if ds == INF:
            continue
        for a in out.arcs[s]:
            dn = d[a.nextstate]
            if dn != INF:
                a.weight = a.weight + dn - ds
        if s in out.final:
            out.final[s] = out.final[s] - ds
    if out.start >= 0 and d[out.start] != INF:
        # fold the start potential into arcs out of start (keeps weights
        # equivalent without a super-initial weight)
        for a in out.arcs[out.start]:
            a.weight += d[out.start]
        if out.start in out.final:
            out.final[out.start] += d[out.start]
    return out


def minimize(f: Fst) -> Fst:
    """Minimize a deterministic FST: push weights, then merge states by
    partition refinement over (ilabel, olabel, weight, class(next))
    signatures — the fstminimizeencoded role (labels+weights treated as
    part of the arc identity)."""
    f = push_weights(f.copy().connect())
    n = f.num_states
    if n == 0:
        return f
    # initial partition: by final weight
    cls = [0] * n
    finals = {}
    for s in range(n):
        key = round(f.final.get(s, INF), 9)
        finals.setdefault(key, len(finals))
        cls[s] = finals[key]
    changed = True
    while changed:
        changed = False
        sig_index: dict[tuple, int] = {}
        new_cls = [0] * n
        for s in range(n):
            sig = (cls[s], tuple(sorted(
                (a.ilabel, a.olabel, round(a.weight, 9), cls[a.nextstate])
                for a in f.arcs[s]
            )))
            if sig not in sig_index:
                sig_index[sig] = len(sig_index)
            new_cls[s] = sig_index[sig]
        if new_cls != cls:
            cls = new_cls
            changed = True
    out = Fst()
    n_cls = max(cls) + 1
    for _ in range(n_cls):
        out.add_state()
    out.start = cls[f.start]
    done = set()
    for s in range(n):
        c = cls[s]
        if c in done:
            continue
        done.add(c)
        for a in f.arcs[s]:
            out.add_arc(c, a.ilabel, a.olabel, a.weight, cls[a.nextstate])
        if s in f.final:
            out.set_final(c, f.final[s])
    return out


# ---------------------------------------------------------------------------
# small utilities
# ---------------------------------------------------------------------------


def relabel(f: Fst, imap=None, omap=None) -> Fst:
    """Relabel arcs (dict old->new): the disambiguation symbols to
    epsilon."""
    out = f.copy()
    for lst in out.arcs:
        for a in lst:
            if imap is not None:
                a.ilabel = imap.get(a.ilabel, a.ilabel)
            if omap is not None:
                a.olabel = omap.get(a.olabel, a.olabel)
    return out
