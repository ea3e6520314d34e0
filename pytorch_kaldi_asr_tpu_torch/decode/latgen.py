"""Frame-synchronous Viterbi beam decoding over a compiled HLG graph, on
the host (the port's copy of ``pytorch_kaldi_asr_tpu.decode.latgen``: the
Python token-passing decoder and its best-path drivers).

The latgen role of the hybrid-AM path: consumes per-frame phone
log-posteriors (recipes/dump_posteriors.py output), walks the
self-loop-expanded graph of fst/graph.py's mkgraph, and returns the best
word sequence (plus the frame-level phone alignment).  Acoustic costs
follow the hybrid convention: cost(frame, phone) = -acoustic_scale *
(log p(phone|frame) - log prior(phone)).

The JAX package dispatches to a C++ twin of this decoder when its native
library is built, with outputs pinned identical; the port runs the Python
decoder (a native core of its own is on ROADMAP.md's host queue).
``latgen_lattice`` is the lattice-generating decode, the JAX package's
Python path (the hybrid server's n-best).
"""

from __future__ import annotations

import math

import numpy as np

from pytorch_kaldi_asr_tpu_torch.fst.core import EPS, Fst

INF = math.inf
_UNSEEN = (INF,)  # the token of a state not reached yet


class StreamingLatgen:
    """Frame-synchronous Viterbi decoding with CARRIED token state: feed
    posterior chunks as they arrive (``push``), read a partial best
    hypothesis at any point (``partial``), and terminate with final
    weights at end of stream (``finish``).  ``latgen`` is the one-shot
    wrapper; decode/align.py aligns through it."""

    def __init__(self, graph: Fst, *, acoustic_scale=1.0, beam=16.0,
                 max_active=2000, log_priors=None, sym_offset=1,
                 compact_threshold=None):
        if graph.start < 0:
            raise ValueError("decode graph has no start state")
        self.graph = graph
        self.acoustic_scale = acoustic_scale
        self.beam = beam
        self.max_active = max_active
        self.log_priors = (None if log_priors is None
                           else np.asarray(log_priors, dtype=np.float64))
        self.sym_offset = sym_offset
        self.compact_threshold = (compact_threshold
                                  if compact_threshold is not None
                                  else max(65536, 64 * max_active))
        # each state's arcs split by kind, in the graph's order, as tuples:
        # the token loops below read no Arc attribute
        self._eps_arcs = [tuple((a.weight, a.nextstate, a.olabel)
                                for a in arcs if a.ilabel == EPS)
                          for arcs in graph.arcs]
        self._emit_arcs = [tuple((a.ilabel - sym_offset, a.weight,
                                  a.nextstate, a.olabel, a.ilabel)
                                 for a in arcs if a.ilabel != EPS)
                           for arcs in graph.arcs]
        self.reset()

    def reset(self):
        # token: state -> (cost, traceback id); tracebacks: list of
        # (prev_tb, olabel, ilabel) triples
        self.tracebacks = [(-1, EPS, EPS)]
        self.tokens = self._eps_expand({self.graph.start: (0.0, 0)})
        self.dead = False
        self.frames = 0

    def _eps_expand(self, tokens):
        """Relax non-emitting (input-eps) arcs until fixpoint."""
        eps_arcs, tracebacks = self._eps_arcs, self.tracebacks
        stack = [s for s in tokens if eps_arcs[s]]
        while stack:
            s = stack.pop()
            cost, tb = tokens[s]
            for weight, nextstate, olabel in eps_arcs[s]:
                nc = cost + weight
                if nc < tokens.get(nextstate, _UNSEEN)[0]:
                    tracebacks.append((tb, olabel, EPS))
                    tokens[nextstate] = (nc, len(tracebacks) - 1)
                    if eps_arcs[nextstate]:
                        stack.append(nextstate)
        return tokens

    def push(self, log_posts):
        """Advance over [T, n_phones] frames of log p(phone | frame).
        Returns False if the beam died (no surviving token) — the decode
        is then unrecoverable until reset()."""
        if self.dead:
            return False
        emit_arcs, tracebacks = self._emit_arcs, self.tracebacks
        log_posts = np.asarray(log_posts, dtype=np.float64)
        if self.log_priors is not None:
            log_posts = log_posts - self.log_priors
        n_ph = log_posts.shape[1]
        beam = self.beam
        # the acoustic costs -scale * log p, as Python floats (the same
        # float64 products the scalar arithmetic takes)
        costs_ac = (-self.acoustic_scale * log_posts).tolist()
        tokens = self.tokens
        for t in range(log_posts.shape[0]):
            nxt: dict[int, tuple] = {}
            best = INF
            row = costs_ac[t]
            for s, (cost, tb) in tokens.items():
                for col, weight, nextstate, olabel, ilabel in emit_arcs[s]:
                    if col < 0 or col >= n_ph:
                        continue
                    nc = cost + weight + row[col]
                    if nc >= best + beam:
                        continue
                    if nc < nxt.get(nextstate, _UNSEEN)[0]:
                        tracebacks.append((tb, olabel, ilabel))
                        nxt[nextstate] = (nc, len(tracebacks) - 1)
                        if nc < best:
                            best = nc
            if not nxt:
                self.dead = True
                return False
            # beam + histogram pruning
            cut = best + self.beam
            pruned = {s: v for s, v in nxt.items() if v[0] <= cut}
            if len(pruned) > self.max_active:
                costs = sorted(v[0] for v in pruned.values())
                cut = costs[self.max_active - 1]
                pruned = {s: v for s, v in pruned.items() if v[0] <= cut}
            tokens = self._eps_expand(pruned)
            self.frames += 1
        self.tokens = tokens
        # bound the traceback arena for long-running streams: most entries
        # belong to pruned-away hypotheses; keep only those reachable from
        # a live token (shared prefixes keep the live set linear in frames)
        if len(self.tracebacks) > self.compact_threshold:
            self._compact()
        return True

    def _compact(self):
        reachable = set()
        for _cost, tb in self.tokens.values():
            while tb >= 0 and tb not in reachable:
                reachable.add(tb)
                tb = self.tracebacks[tb][0]
        order = sorted(reachable)
        remap = {old: new for new, old in enumerate(order)}
        self.tracebacks = [
            (remap.get(self.tracebacks[old][0], -1),
             self.tracebacks[old][1], self.tracebacks[old][2])
            for old in order
        ]
        self.tokens = {s: (cost, remap[tb])
                       for s, (cost, tb) in self.tokens.items()}

    def _backtrace(self, tb):
        words, phones = [], []
        while tb >= 0:
            prev, ol, il = self.tracebacks[tb]
            if ol != EPS:
                words.append(ol)
            if il != EPS:
                phones.append(il)
            tb = prev
        return words[::-1], phones[::-1]

    def partial(self):
        """(word_ids, cost) of the best ALIVE token so far — final weights
        not applied; the stable prefix of the eventual result in practice.
        None if the beam died."""
        if self.dead or not self.tokens:
            return None
        s, (cost, tb) = min(self.tokens.items(), key=lambda kv: kv[1][0])
        words, _ = self._backtrace(tb)
        return words, cost

    def finish(self):
        """Terminate with final weights.  Returns
        (word_ids, phone_frames, total_cost) or None."""
        res = self.finish_entries()
        if res is None:
            return None
        entries, best_cost = res
        words = [ol for ol, _ in entries if ol != EPS]
        phones = [il for _, il in entries if il != EPS]
        return words, phones, best_cost

    def finish_entries(self):
        """Terminate with final weights, keeping the arc-level structure:
        returns (entries, total_cost) where ``entries`` is the best path's
        [(olabel, ilabel)] in TEMPORAL order — including epsilon entries,
        so frame indices are recoverable by counting emitting (ilabel !=
        eps) entries.  decode/align.py builds word time boundaries from
        this.  None if no final token survived."""
        if self.dead:
            return None
        best_state, best_cost, best_tb = None, INF, -1
        for s, (cost, tb) in self.tokens.items():
            if self.graph.is_final(s):
                total = cost + self.graph.final_weight(s)
                if total < best_cost:
                    best_state, best_cost, best_tb = s, total, tb
        if best_state is None:
            return None
        entries = []
        tb = best_tb
        while tb >= 0:
            prev, ol, il = self.tracebacks[tb]
            entries.append((ol, il))
            tb = prev
        return entries[::-1], best_cost


def make_streaming_latgen(graph: Fst, **kw):
    """The carried-state decoder the streaming server drives: the JAX
    package's constructor of the same name returns its native core when
    built; the port has the Python decoder only (ROADMAP.md, queue 1 item
    8d), which gives the same outputs."""
    return StreamingLatgen(graph, **kw)


def latgen(graph: Fst, log_posts, *, acoustic_scale=1.0, beam=16.0,
           max_active=2000, log_priors=None, sym_offset=1):
    """Decode one utterance.

    log_posts: [T, n_phones] log p(phone | frame).  Graph input label i
    corresponds to posterior column (i - sym_offset) — phone symbol tables
    start at 1 because 0 is epsilon.

    Returns (word_ids, phone_frames, total_cost) or None if no path
    survived."""
    dec = StreamingLatgen(graph, acoustic_scale=acoustic_scale, beam=beam,
                          max_active=max_active, log_priors=log_priors,
                          sym_offset=sym_offset)
    if not dec.push(log_posts):
        return None
    return dec.finish()


def latgen_lattice(graph: Fst, log_posts, *, acoustic_scale=1.0, beam=16.0,
                   lattice_beam=8.0, max_active=2000, log_priors=None,
                   sym_offset=1, id2word=None, utt=""):
    """Lattice-generating decode: like :func:`latgen`, but records every
    transition within ``lattice_beam`` of a surviving token and returns the
    pruned WordLattice (the lattice-faster decode role; the hybrid server's
    n-best reads it through decode/lattice_ops.nbest).  The JAX package's
    Python token loop, in its order with its float64 sums.  Returns None if
    no path survives."""
    from pytorch_kaldi_asr_tpu_torch.decode.lattice_io import WordLattice

    log_posts = np.asarray(log_posts, dtype=np.float64)
    if log_priors is not None:
        log_posts = log_posts - np.asarray(log_priors, dtype=np.float64)
    T, n_ph = log_posts.shape

    lat = WordLattice(utt=utt)
    node_of: dict[tuple, int] = {}

    def node(t, s):
        key = (t, s)
        if key not in node_of:
            node_of[key] = lat.add_node(t)
        return node_of[key]

    def word(ol):
        if ol == EPS:
            return "<eps>"
        return id2word.get(ol, f"#{ol}") if id2word else str(ol)

    def eps_expand(t, tokens):
        stack = list(tokens.keys())
        while stack:
            s = stack.pop()
            cost = tokens[s]
            for a in graph.arcs[s]:
                if a.ilabel != EPS:
                    continue
                nc = cost + a.weight
                cur = tokens.get(a.nextstate, INF)
                if nc < cur + lattice_beam:
                    lat.add_link(node(t, s), node(t, a.nextstate),
                                 word(a.olabel), 0.0, a.weight)
                if nc < cur:
                    tokens[a.nextstate] = nc
                    stack.append(a.nextstate)
        return tokens

    if graph.start < 0:
        raise ValueError("decode graph has no start state")
    node(0, graph.start)
    tokens = eps_expand(0, {graph.start: 0.0})

    for t in range(T):
        nxt: dict[int, float] = {}
        cand = []  # (src_state, arc, new_cost, acoustic)
        best = INF
        for s, cost in tokens.items():
            for a in graph.arcs[s]:
                if a.ilabel == EPS:
                    continue
                col = a.ilabel - sym_offset
                if col < 0 or col >= n_ph:
                    continue
                ac = -acoustic_scale * log_posts[t, col]
                nc = cost + a.weight + ac
                if nc >= best + beam:
                    continue
                cand.append((s, a, nc, ac))
                if nc < nxt.get(a.nextstate, INF):
                    nxt[a.nextstate] = nc
                    best = min(best, nc)
        if not nxt:
            return None
        cut = best + beam
        pruned = {s: c for s, c in nxt.items() if c <= cut}
        if len(pruned) > max_active:
            costs = sorted(pruned.values())
            cut = costs[max_active - 1]
            pruned = {s: c for s, c in pruned.items() if c <= cut}
        for s, a, nc, ac in cand:
            dst_best = pruned.get(a.nextstate)
            if dst_best is not None and nc <= dst_best + lattice_beam:
                lat.add_link(node(t, s), node(t + 1, a.nextstate),
                             word(a.olabel), ac, a.weight)
        tokens = eps_expand(t + 1, pruned)

    ok = False
    for s in tokens:
        if graph.is_final(s):
            lat.finals[node(T, s)] = graph.final_weight(s)
            ok = True
    if not ok:
        return None
    return _prune_lattice(lat, lattice_beam)


def _prune_lattice(lat, lattice_beam):
    """Drop the links on no path within ``lattice_beam`` of the best;
    renumber the nodes densely by (time, id)."""
    from pytorch_kaldi_asr_tpu_torch.decode.lattice_io import WordLattice

    n = lat.num_nodes
    order = lat.topo_order()
    out = lat.out_links()
    fwd = [INF] * n
    fwd[0] = 0.0
    for u in order:
        if fwd[u] == INF:
            continue
        for l in out[u]:
            c = fwd[u] + l.cost
            if c < fwd[l.end]:
                fwd[l.end] = c
    bwd = [INF] * n
    for u, w in lat.finals.items():
        bwd[u] = w
    for u in reversed(order):
        for l in out[u]:
            c = l.cost + bwd[l.end]
            if c < bwd[u]:
                bwd[u] = c
    best = min((fwd[u] + w for u, w in lat.finals.items()), default=INF)
    if best == INF:
        return None
    keep_links = [l for l in lat.links
                  if fwd[l.start] + l.cost + bwd[l.end] <= best + lattice_beam]
    used = {0}
    for l in keep_links:
        used.add(l.start)
        used.add(l.end)
    remap = {}
    out_lat = WordLattice(utt=lat.utt)
    for u in sorted(used, key=lambda u: (lat.node_times[u], u)):
        remap[u] = out_lat.add_node(lat.node_times[u])
    for l in keep_links:
        out_lat.add_link(remap[l.start], remap[l.end], l.word, l.acoustic,
                         l.graph)
    for u, w in lat.finals.items():
        if u in used:
            out_lat.finals[remap[u]] = w
    return out_lat


def decode_posterior_ark(graph, post_iter, word_syms, *, acoustic_scale=1.0,
                         beam=16.0, max_active=2000, log_priors=None):
    """Decode a (key, log_posterior_matrix) stream; yields
    (key, word_string, cost).  word_syms: {word: id}."""
    id2word = {v: k for k, v in word_syms.items()}
    for key, mat in post_iter:
        res = latgen(graph, mat, acoustic_scale=acoustic_scale, beam=beam,
                     max_active=max_active, log_priors=log_priors)
        if res is None:
            yield key, "", INF
            continue
        word_ids, _, cost = res
        yield key, " ".join(id2word.get(w, "<unk>") for w in word_ids), cost
