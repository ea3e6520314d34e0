"""Frame-synchronous Viterbi beam decoding over a compiled HLG graph, on
the host (the port's copy of ``pytorch_kaldi_asr_tpu.decode.latgen``: the
Python token-passing decoder and its best-path drivers).

The latgen role of the hybrid-AM path: consumes per-frame phone
log-posteriors (recipes/dump_posteriors.py output), walks the
self-loop-expanded graph of fst/graph.py's mkgraph, and returns the best
word sequence (plus the frame-level phone alignment).  Acoustic costs
follow the hybrid convention: cost(frame, phone) = -acoustic_scale *
(log p(phone|frame) - log prior(phone)).

The token passing runs in the port's native C++ core by default
(native/src/latgen.cc, built at first use: ``NativeStreamingLatgen`` and
the lattice decode's ``_native_latgen_lattice``), as the JAX package's
dispatch does when its core is built; ``native=False`` takes the Python
token passer (``StreamingLatgen`` and ``latgen_lattice``'s Python loop),
the oracle the core is held against.  The two give the same words,
phones and costs, and their lattices the same n-best; but the core
records links in its hash maps' order, so the link order, the node
numbering and the count of duplicate links differ (and marginal links
may).  There is no silent fallback: a core that does not build raises.
``latgen_lattice`` is the lattice-generating decode (the hybrid server's
n-best).
"""

from __future__ import annotations

import ctypes
import math
import weakref

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


class _NativeGraph:
    """Owns a native (C++) copy of an Fst's arcs; shared read-only by any
    number of decoder instances (one per stream)."""

    def __init__(self, graph: Fst, lib):
        if graph.start < 0:
            raise ValueError("decode graph has no start state")
        self._lib = lib
        n = graph.num_states
        n_arcs = graph.num_arcs
        row = np.zeros(n + 1, np.int64)
        il = np.empty(n_arcs, np.int32)
        ol = np.empty(n_arcs, np.int32)
        w = np.empty(n_arcs, np.float64)
        ns = np.empty(n_arcs, np.int32)
        pos = 0
        for s in range(n):
            for a in graph.arcs[s]:
                il[pos], ol[pos], w[pos], ns[pos] = (a.ilabel, a.olabel,
                                                     a.weight, a.nextstate)
                pos += 1
            row[s + 1] = pos
        finals = np.full(n, np.inf, np.float64)
        for s, fw in graph.final.items():
            finals[s] = fw
        i32p = ctypes.POINTER(ctypes.c_int32)
        self.handle = lib.pka_graph_create(
            n, graph.start,
            row.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            il.ctypes.data_as(i32p), ol.ctypes.data_as(i32p),
            w.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            ns.ctypes.data_as(i32p),
            finals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        )

    def __del__(self):
        if getattr(self, "handle", None):
            self._lib.pka_graph_destroy(self.handle)
            self.handle = None


def _graph_fingerprint(graph: Fst):
    return (graph.start, graph.num_states, graph.num_arcs,
            tuple(sorted(graph.final.items())))


# keyed WEAKLY by the Fst (not stored on it: a ctypes-bearing attribute
# would break deepcopy/pickle of any graph that has been decoded once);
# entries carry a fingerprint so mutating the graph rebuilds the copy
_NATIVE_GRAPHS: "weakref.WeakKeyDictionary[Fst, tuple]" = (
    weakref.WeakKeyDictionary())


def _native_graph(graph: Fst, lib):
    """Native arc-copy cache, invalidated when the Fst is mutated after a
    decode (add_arc/set_final/start change the fingerprint)."""
    fp = _graph_fingerprint(graph)
    ent = _NATIVE_GRAPHS.get(graph)
    if ent is None or ent[0] != fp:
        ent = (fp, _NativeGraph(graph, lib))
        _NATIVE_GRAPHS[graph] = ent
    return ent[1]


def _check_priors(posts, priors):
    if priors is not None and posts.shape[1] != len(priors):
        raise ValueError(
            f"posterior width {posts.shape[1]} != priors length "
            f"{len(priors)} (same check the Python decoder's broadcast "
            "raises)")


class NativeStreamingLatgen:
    """C++ twin of :class:`StreamingLatgen` (native/src/latgen.cc) with
    the identical interface and outputs, and faster token passing (PERF.md
    §6 has its times against the Python decoder's).
    :func:`make_streaming_latgen` returns it unless asked for the Python
    decoder."""

    def __init__(self, graph: Fst, *, acoustic_scale=1.0, beam=16.0,
                 max_active=2000, log_priors=None, sym_offset=1,
                 compact_threshold=None):
        from pytorch_kaldi_asr_tpu_torch import native

        self._lib = native.load()
        self._graph = _native_graph(graph, self._lib)  # keep alive
        self.frames = 0
        if compact_threshold is None:
            compact_threshold = max(65536, 64 * max_active)
        priors_p = None
        n_priors = 0
        self._priors = None
        if log_priors is not None:
            self._priors = np.ascontiguousarray(log_priors, np.float64)
            priors_p = self._priors.ctypes.data_as(
                ctypes.POINTER(ctypes.c_double))
            n_priors = len(self._priors)
        self._h = self._lib.pka_latgen_create(
            self._graph.handle, float(acoustic_scale), float(beam),
            int(max_active), priors_p, n_priors, int(sym_offset),
            int(compact_threshold),
        )

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.pka_latgen_destroy(self._h)
            self._h = None

    @property
    def dead(self):
        return bool(self._lib.pka_latgen_dead(self._h))

    def reset(self):
        self._lib.pka_latgen_reset(self._h)
        self.frames = 0

    def push(self, log_posts):
        posts = np.ascontiguousarray(log_posts, np.float64)
        _check_priors(posts, self._priors)
        ok = self._lib.pka_latgen_push(
            self._h, posts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            posts.shape[0], posts.shape[1],
        )
        self.frames = int(self._lib.pka_latgen_frames(self._h))
        return bool(ok)

    def partial(self):
        cap = 256
        while True:
            words = np.empty(cap, np.int32)
            cost = ctypes.c_double()
            n = self._lib.pka_latgen_partial(
                self._h, words.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                cap, ctypes.byref(cost))
            if n < 0:
                return None
            if n <= cap:
                return [int(x) for x in words[:n]], cost.value
            cap = int(n)

    def finish_entries(self):
        i32p = ctypes.POINTER(ctypes.c_int32)
        cap = 1024
        while True:
            ols = np.empty(cap, np.int32)
            ils = np.empty(cap, np.int32)
            cost = ctypes.c_double()
            n = self._lib.pka_latgen_finish(
                self._h, ols.ctypes.data_as(i32p), ils.ctypes.data_as(i32p),
                cap, ctypes.byref(cost))
            if n < 0:
                return None
            if n <= cap:
                entries = [(int(o), int(i)) for o, i in
                           zip(ols[:n], ils[:n])]
                return entries, cost.value
            cap = int(n)

    def finish(self):
        res = self.finish_entries()
        if res is None:
            return None
        entries, best_cost = res
        words = [ol for ol, _ in entries if ol != EPS]
        phones = [il for _, il in entries if il != EPS]
        return words, phones, best_cost


def make_streaming_latgen(graph: Fst, *, native=True, **kw):
    """The carried-state decoder the streaming server drives: the native
    C++ core (:class:`NativeStreamingLatgen`, built at first use), or with
    ``native=False`` the Python :class:`StreamingLatgen`; the same
    outputs (tests/test_torch_native_latgen.py)."""
    if native:
        return NativeStreamingLatgen(graph, **kw)
    return StreamingLatgen(graph, **kw)


def latgen(graph: Fst, log_posts, *, acoustic_scale=1.0, beam=16.0,
           max_active=2000, log_priors=None, sym_offset=1, native=True):
    """Decode one utterance.

    log_posts: [T, n_phones] log p(phone | frame).  Graph input label i
    corresponds to posterior column (i - sym_offset) — phone symbol tables
    start at 1 because 0 is epsilon.  The native core decodes unless
    ``native=False`` (the Python token passer; the same outputs).

    Returns (word_ids, phone_frames, total_cost) or None if no path
    survived."""
    dec = make_streaming_latgen(graph, native=native,
                                acoustic_scale=acoustic_scale, beam=beam,
                                max_active=max_active, log_priors=log_priors,
                                sym_offset=sym_offset)
    if not dec.push(log_posts):
        return None
    return dec.finish()


def _word_label(id2word):
    def word(ol):
        if ol == EPS:
            return "<eps>"
        return id2word.get(ol, f"#{ol}") if id2word else str(ol)
    return word


def _native_latgen_lattice(graph, log_posts, *, acoustic_scale, beam,
                           lattice_beam, max_active, log_priors,
                           sym_offset, id2word, utt):
    """Native-core lattice decode: the C++ token loop records surviving
    transitions and beam-prunes them (native/src/latgen.cc
    LatticeDecoder); the WordLattice is assembled here.  Link RECORDING
    depends on the relaxation order (a state relaxed again records its
    links again, and the record test ``nc < cur + lattice_beam`` sees a
    looser ``cur`` earlier in the relaxation), so the link order and the
    duplicate links differ from the Python decoder's, and marginal links
    may; the n-best agrees at wide beams and the 1-best always."""
    from pytorch_kaldi_asr_tpu_torch import native
    from pytorch_kaldi_asr_tpu_torch.decode.lattice_io import WordLattice

    lib = native.load()
    ngraph = _native_graph(graph, lib)
    posts = np.ascontiguousarray(log_posts, np.float64)
    priors_p, n_priors = None, 0
    if log_priors is not None:
        priors = np.ascontiguousarray(log_priors, np.float64)
        _check_priors(posts, priors)
        priors_p = priors.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        n_priors = len(priors)
    h = lib.pka_latlat_create(ngraph.handle, float(acoustic_scale),
                              float(beam), float(lattice_beam),
                              int(max_active), priors_p, n_priors,
                              int(sym_offset))
    try:
        rc = lib.pka_latlat_run(
            h, posts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            posts.shape[0], posts.shape[1])
        if rc == -1:
            raise ValueError("lattice has a cycle")  # as topo_order raises
        if rc == 0:
            return None
        i32p = ctypes.POINTER(ctypes.c_int32)
        f64p = ctypes.POINTER(ctypes.c_double)
        nn = int(lib.pka_latlat_n_nodes(h))
        times = np.empty(nn, np.int32)
        lib.pka_latlat_node_times(h, times.ctypes.data_as(i32p))
        n = int(lib.pka_latlat_n_links(h))
        frm = np.empty(n, np.int32)
        to = np.empty(n, np.int32)
        ol = np.empty(n, np.int32)
        ac = np.empty(n, np.float64)
        gw = np.empty(n, np.float64)
        lib.pka_latlat_links(h, frm.ctypes.data_as(i32p),
                             to.ctypes.data_as(i32p),
                             ol.ctypes.data_as(i32p),
                             ac.ctypes.data_as(f64p),
                             gw.ctypes.data_as(f64p))
        nf = int(lib.pka_latlat_n_finals(h))
        fnodes = np.empty(nf, np.int32)
        fweights = np.empty(nf, np.float64)
        lib.pka_latlat_finals(h, fnodes.ctypes.data_as(i32p),
                              fweights.ctypes.data_as(f64p))
    finally:
        lib.pka_latlat_destroy(h)

    # the native core already beam-pruned and renumbered by (time, id):
    # assemble the final WordLattice verbatim
    word = _word_label(id2word)
    lat = WordLattice(utt=utt)
    for t in times:
        lat.add_node(int(t))
    for i in range(n):
        lat.add_link(int(frm[i]), int(to[i]), word(int(ol[i])),
                     float(ac[i]), float(gw[i]))
    for i in range(nf):
        lat.finals[int(fnodes[i])] = float(fweights[i])
    return lat


def latgen_lattice(graph: Fst, log_posts, *, acoustic_scale=1.0, beam=16.0,
                   lattice_beam=8.0, max_active=2000, log_priors=None,
                   sym_offset=1, id2word=None, utt="", native=True):
    """Lattice-generating decode: like :func:`latgen`, but records every
    transition within ``lattice_beam`` of a surviving token and returns the
    pruned WordLattice (the lattice-faster decode role; the hybrid server's
    n-best reads it through decode/lattice_ops.nbest).  The token loop runs
    in the native core; with ``native=False`` it is the JAX package's
    Python loop, in its order with its float64 sums.  Returns None if no
    path survives."""
    if native:
        return _native_latgen_lattice(
            graph, log_posts, acoustic_scale=acoustic_scale, beam=beam,
            lattice_beam=lattice_beam, max_active=max_active,
            log_priors=log_priors, sym_offset=sym_offset, id2word=id2word,
            utt=utt)
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

    word = _word_label(id2word)

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
