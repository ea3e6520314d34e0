"""Top-K active-frontier WFST Viterbi search on the card (the port's copy
of ``pytorch_kaldi_asr_tpu.decode.frontier_latgen``).

The dense device decoder (decode/device_latgen.py) sweeps the FULL arc
table with a segment-min scatter every frame and stores a [T, S, B]
traceback, so both its per-frame work and its memory grow with the graph.
This module keeps only the ACTIVE search frontier on the device — the top
``max_active`` states, the set the host decoder's histogram pruning keeps
(decode/latgen.py) — so the per-frame work is independent of graph size:

- at pack time every state's out-arcs are bounded to ``de`` emitting +
  ``dz`` epsilon arcs by splitting fat states into balanced trees of
  zero-weight-epsilon-linked virtual states, resolved by the normal
  closure loop;
- the per-frame emit step is one GATHER of the live frontier states'
  padded arc rows ([K, de] candidates per utterance at most), not a sweep
  of all arcs;
- candidate dedup + pruning (``_Dedup``) keeps what JAX's four-key
  ``lax.sort`` by (dst, score, age, arc) and ``lax.top_k`` keep: per state
  the lexicographic minimum of (score, age, arc), packed into one int64
  and scattered with ``amin`` into a [B, S + 1] table, then the K best
  per utterance by a stable sort of the scores (ties to the lower state,
  ``lax.top_k``'s lower index).  The frontier is carried as states and
  packed keys;
- epsilon closure is the same expansion + dedup round iterated to
  fixpoint (strict improvement only, old entries win ties), at most
  ``MAX_EPS_ROUNDS`` rounds per utterance and frame, each round expanding
  the previous dedup's survivors; each utterance keeps its own round
  counter and stops on its own, as under JAX's vmap;
- the traceback stores [T, B, K] (state, winning-arc) pairs and is walked
  backwards on the device for the whole batch, finding each state in its
  frame's stored frontier.  Broken walks (top-K boundary ties) raise the
  overflow flag and fall back to the host decoder for that utterance
  (``host_fallbacks`` counts them), never returning a truncated
  hypothesis.

Semantics are pinned to decode/latgen.py StreamingLatgen (emit -> beam
prune -> histogram prune -> epsilon closure per frame), with the JAX
package's one documented difference: the frontier width also caps the
states kept AFTER closure (the host keeps every within-beam state
post-closure), so the frontier decoder searches with an effectively
tighter histogram prune.  With ``max_active`` at least the number of live
states the outputs match the host decoder; when closure fan-out exceeds
the frontier width they diverge — the frontier returns a well-formed but
worse-scoring hypothesis, with no overflow flag
(tests/test_torch_frontier_latgen.py pins a binding case).

Scores are float32, like the dense decoder.
"""

from __future__ import annotations

import weakref

import numpy as np

from pytorch_kaldi_asr_tpu_torch.decode.device_latgen import (
    WALK_ROUNDS,
    DeviceLatgen,
)
from pytorch_kaldi_asr_tpu_torch.fst.core import EPS, Fst

# epsilon-closure safety cap: real HLG epsilon chains are a handful of
# hops (plus log_dz(fan-out) virtual-tree levels); a frame that fails to
# converge within this many rounds sets the overflow flag and falls back
# to the host decoder
MAX_EPS_ROUNDS = 128


class _FrontierGraph:
    """Degree-bounded padded arc-table view of an Fst.

    States keep at most ``de`` emitting and ``dz`` epsilon out-arcs;
    fatter states are split into virtual states joined by zero-weight
    epsilon arcs (a ``dz``-ary tree over chunked leaves).  Tables are
    padded to ``S + 1`` rows so the frontier's invalid-slot sentinel
    (state id S) gathers an all-dead row.

    Global arc-id convention (what the traceback stores): emitting arc
    ``(s, d)`` has id ``s * de + d``; epsilon arc ``(s, d)`` has id
    ``Ae + s * dz + d`` with ``Ae = (S + 1) * de`` — so an arc id alone
    recovers its source state and labels with integer arithmetic, no
    separate src table.
    """

    def __init__(self, graph: Fst, sym_offset: int, de: int = 16,
                 dz: int = 16):
        if graph.start < 0:
            raise ValueError("decode graph has no start state")
        if de < 1 or dz < 2:
            raise ValueError("need de >= 1 and dz >= 2 to split states")
        S0 = graph.num_states
        emit_rows: list[list] = [None] * S0  # type: ignore[list-item]
        eps_rows: list[list] = [None] * S0  # type: ignore[list-item]

        def new_state():
            emit_rows.append([])
            eps_rows.append([])
            return len(emit_rows) - 1

        for s in range(S0):
            emit = [a for a in graph.arcs[s] if a.ilabel != EPS]
            eps = [a for a in graph.arcs[s] if a.ilabel == EPS]
            if len(emit) <= de and len(eps) <= dz:
                emit_rows[s] = [(a.ilabel - sym_offset, a.ilabel, a.olabel,
                                 a.weight, a.nextstate) for a in emit]
                eps_rows[s] = [(a.olabel, a.weight, a.nextstate)
                               for a in eps]
                continue
            # fat state: all real arcs move to virtual leaves; the state
            # keeps only epsilon links to a dz-ary tree over the leaves
            emit_rows[s] = []
            children = []
            for i in range(0, len(emit), de):
                v = new_state()
                emit_rows[v] = [(a.ilabel - sym_offset, a.ilabel, a.olabel,
                                 a.weight, a.nextstate)
                                for a in emit[i:i + de]]
                children.append(v)
            for i in range(0, len(eps), dz):
                v = new_state()
                eps_rows[v] = [(a.olabel, a.weight, a.nextstate)
                               for a in eps[i:i + dz]]
                children.append(v)
            while len(children) > dz:
                nxt = []
                for i in range(0, len(children), dz):
                    v = new_state()
                    eps_rows[v] = [(EPS, 0.0, c)
                                   for c in children[i:i + dz]]
                    nxt.append(v)
                children = nxt
            eps_rows[s] = [(EPS, 0.0, c) for c in children]

        S = len(emit_rows)
        self.num_states = S
        self.n_virtual = S - S0
        self.start = graph.start
        self.sym_offset = sym_offset
        self.de = de
        self.dz = dz
        self.ae = (S + 1) * de  # epsilon arc-id offset

        # padded [S + 1, de/dz] tables; pad row/slots: dst = S (sentinel),
        # weight = +inf, col = -1
        e_col = np.full((S + 1, de), -1, np.int32)
        e_il = np.zeros((S + 1, de), np.int32)
        e_ol = np.zeros((S + 1, de), np.int32)
        e_dst = np.full((S + 1, de), S, np.int32)
        e_w = np.full((S + 1, de), np.inf, np.float32)
        z_ol = np.zeros((S + 1, dz), np.int32)
        z_dst = np.full((S + 1, dz), S, np.int32)
        z_w = np.full((S + 1, dz), np.inf, np.float32)
        n_eps = 0
        for s in range(S):
            for d, (col, il, ol, w, dst) in enumerate(emit_rows[s]):
                e_col[s, d] = col
                e_il[s, d] = il
                e_ol[s, d] = ol
                e_dst[s, d] = dst
                e_w[s, d] = w
            for d, (ol, w, dst) in enumerate(eps_rows[s]):
                z_ol[s, d] = ol
                z_dst[s, d] = dst
                z_w[s, d] = w
                n_eps += 1
        self.has_eps = n_eps > 0
        self.e_col, self.e_il, self.e_ol = e_col, e_il, e_ol
        self.e_dst, self.e_w = e_dst, e_w
        self.z_ol, self.z_dst, self.z_w = z_ol, z_dst, z_w

        finals = np.full(S + 1, np.inf, np.float32)
        for s, fw in graph.final.items():
            finals[s] = fw
        self.finals = finals

        # start-state epsilon closure over the SPLIT graph (so back
        # pointers are valid split-table arc ids), float64 like the host
        scores0 = np.full(S + 1, np.inf)
        back0 = np.full(S + 1, -1, np.int32)
        scores0[graph.start] = 0.0
        stack = [graph.start]
        while stack:
            s = stack.pop()
            base = scores0[s]
            for d in range(dz):
                if not np.isfinite(z_w[s, d]):
                    continue
                nc = base + z_w[s, d]
                dst = int(z_dst[s, d])
                if nc < scores0[dst]:
                    scores0[dst] = nc
                    back0[dst] = self.ae + s * dz + d
                    stack.append(dst)
        self.scores0 = scores0.astype(np.float32)
        self.back_init = back0
        self._tables = {}
        self._init_frontier = {}

    def tables(self, torch, device):
        """The padded tables as tensors on ``device``, sent once per
        device (index tables int64, torch's gather index type)."""
        key = str(device)
        tabs = self._tables.get(key)
        if tabs is None:
            def t(a, dtype=torch.int64):
                return torch.as_tensor(a).to(device=device, dtype=dtype)

            tabs = {name: t(getattr(self, name)) for name in
                    ("e_col", "e_il", "e_ol", "e_dst", "z_ol", "z_dst",
                     "back_init")}
            for name in ("e_w", "z_w", "finals"):
                tabs[name] = t(getattr(self, name), torch.float32)
            self._tables[key] = tabs
        return tabs

    def init_frontier(self, torch, device, K):
        """The K best start-closure states and their scores on ``device``
        (host, once per graph, width and device)."""
        key = (str(device), K)
        init = self._init_frontier.get(key)
        if init is None:
            S = self.num_states
            order = np.argsort(self.scores0[:S], kind="stable")[:K]
            is_ = np.full(K, S, np.int64)
            isc = np.full(K, np.inf, np.float32)
            fin = np.isfinite(self.scores0[order])
            is_[:order.size] = np.where(fin, order, S)
            isc[:order.size] = np.where(fin, self.scores0[order], np.inf)
            init = (torch.from_numpy(is_).to(device),
                    torch.from_numpy(isc).to(device))
            self._init_frontier[key] = init
        return init


def _graph_fingerprint(graph: Fst):
    return (graph.start, graph.num_states, graph.num_arcs,
            tuple(sorted(graph.final.items())))


_PACKED: "weakref.WeakKeyDictionary[Fst, tuple]" = weakref.WeakKeyDictionary()


def _packed(graph: Fst, sym_offset: int, de: int, dz: int):
    key = (_graph_fingerprint(graph), sym_offset, de, dz)
    ent = _PACKED.get(graph)
    if ent is None or ent[0] != key:
        ent = (key, _FrontierGraph(graph, sym_offset, de, dz))
        _PACKED[graph] = ent
    return ent[1]


def _bits_key(x):
    """The order-preserving map between float32 bit patterns (int32) and
    int32 keys, its own inverse: -inf < ... < -0.0 < 0.0 < ... < inf."""
    return x ^ ((x >> 31) & 0x7FFFFFFF)


def _score_key(torch, sc):
    """int64 keys in [-2**31, 2**31) ordered as ``lax.sort`` orders
    float32 (-0.0 made equal to 0.0 first, as ``lax.sort`` does)."""
    return _bits_key((sc + 0.0).view(torch.int32)).to(torch.int64)


def _key_score(torch, key):
    """The float32 scores of packed keys (``_Dedup``'s layout)."""
    return _bits_key((key >> 32).to(torch.int32)).view(torch.float32)


# a packed frontier entry: the score's key in the high 32 bits, then the
# age bit (1 = reached in this closure round) and arc + 1 in the low 31
_AGE = 1 << 31
_ARC = _AGE - 1
_DEAD = 0x7F800000 << 32  # score +inf, age 0, arc -1: a dead slot
_NONE = (1 << 63) - 1  # an empty cell of the dedup table


class _Dedup:
    """JAX's ``dedup_topk`` for a batch: keep the best candidate per
    (utterance, destination state) and each utterance's K best survivors.

    JAX sorts an utterance's candidates, dead slots included, by (dst,
    score, age, arc), keeps each state's first and takes the K lowest
    scores (``lax.top_k``: ties to the lower index, i.e. the lower state).
    The first per state is the lexicographic minimum of (score, age, arc),
    so each candidate's packed key is scattered with an ``amin`` into a
    [B, S + 1] table (a minimum does not depend on the order the scatter
    takes), the states reached are read back in (utterance, state) order
    (one look at the host for their number) and sorted stably by
    (utterance, score).  The table is reset where it was written.  A
    candidate of infinite score never survives in JAX and is not added;
    JAX's drop of the sentinel state S needs no test here, since only
    infinite-weight padding leads there."""

    def __init__(self, torch, B, S, K, device):
        self.torch, self.B, self.S, self.K = torch, B, S, K
        self.table = torch.full((B * (S + 1),), _NONE, dtype=torch.int64,
                                device=device)

    def add(self, rows, dst, key):
        """Scatter the candidates ``key`` (flat, _NONE to skip) of
        utterances ``rows`` to states ``dst``."""
        self.table.scatter_reduce_(0, rows * (self.S + 1) + dst, key, "amin")

    def take(self):
        """[B, K] states and packed keys of the survivors in score order
        (ties by state), dead slots (S, _DEAD) last, and the same as a flat
        list (utterance, state, key, kept: False past the K best); the
        table is left empty."""
        torch, B, S, K = self.torch, self.B, self.S, self.K
        pos = (self.table != _NONE).nonzero()[:, 0]
        key = self.table[pos]
        self.table[pos] = _NONE
        r = pos // (S + 1)
        o = torch.sort((r << 32) + (key >> 32) + (1 << 31),
                       stable=True).indices
        r, key = r[o], key[o]
        dst = pos[o] - r * (S + 1)
        # each survivor's rank in its utterance (r is sorted, so its first
        # index is where r's value starts); the rest to a spare column
        slot = (torch.arange(r.shape[0], device=r.device)
                - torch.searchsorted(r, r)).clamp(max=K)
        n_s = torch.full((B, K + 1), S, dtype=torch.int64, device=r.device)
        n_key = torch.full((B, K + 1), _DEAD, dtype=torch.int64,
                           device=r.device)
        n_s[r, slot] = dst
        n_key[r, slot] = key
        return n_s[:, :K], n_key[:, :K], (r, dst, key, slot < K)


def _candidates(torch, sc, low, ok=None):
    """Packed keys of candidates of score ``sc`` and low word ``low`` (age
    bit and arc + 1), _NONE where the score is infinite or ``ok`` false."""
    keep = sc < float("inf")
    if ok is not None:
        keep = keep & ok
    return torch.where(keep, (_score_key(torch, sc) << 32) + low, _NONE)


def _frontier_search(torch, g, tabs, init, posts, lengths, acoustic_scale,
                     beam, K, ma, n_words_cap):
    """The frontier Viterbi over a [B, T, P] float32 batch on its device:
    returns (best_cost [B], words [B, Lw], n_words [B], phones [B, T],
    overflow [B]) as tensors on that device.  The frontier is carried as
    states and packed keys (score, age, arc); each step expands its live
    entries only (one look at the host for their number), as the dead
    slots' candidates in JAX's fixed-shape step are infinite."""
    dev = posts.device
    B, T, P = posts.shape
    S, de, dz = g.num_states, g.de, g.dz
    Ae = (S + 1) * de
    i64 = torch.int64
    beam = torch.tensor(np.float32(beam), device=dev)
    ac = posts * torch.tensor(-np.float32(acoustic_scale), device=dev)
    # a +inf column for the arcs outside the posterior: [T, B, P + 1]
    ac = torch.cat([ac, torch.full((B, T, 1), float("inf"), device=dev)],
                   2).transpose(0, 1).contiguous()
    col = tabs["e_col"]
    e_colm = torch.where((col >= 0) & (col < P), col, P)
    e_w, e_dst = tabs["e_w"], tabs["e_dst"]
    z_w, z_dst = tabs["z_w"], tabs["z_dst"]
    # the low words: emitting arc s * de + d (age 0), epsilon arc
    # Ae + s * dz + d (age 1), each + 1
    low_e = torch.arange(de, device=dev) + 1
    low_z = torch.arange(dz, device=dev) + (Ae + 1 + _AGE)
    lengths = lengths.to(dev)
    dedup = _Dedup(torch, B, S, K, dev)

    def eps_close(n_s, n_key, flat, live):
        """JAX's closure rounds from the step's survivors ``flat``, for the
        utterances ``live`` (the others' results are discarded, as JAX
        discards them); returns the frontier and the overflow flags."""
        improved = live
        it = torch.zeros(B, dtype=i64, device=dev)
        while g.has_eps:
            run = improved & (it < MAX_EPS_ROUNDS)
            r, s_, key_, ok = flat
            ok = ok & run[r]
            dedup.add(r, s_, torch.where(ok, key_ & ~_AGE, _NONE))
            sc = _key_score(torch, key_)[:, None] + z_w[s_]
            n = r.shape[0]
            dedup.add(r[:, None].expand(n, dz).flatten(),
                      z_dst[s_].flatten(),
                      _candidates(torch, sc, s_[:, None] * dz + low_z,
                                  ok[:, None]).flatten())
            r_s, r_key, flat = dedup.take()
            # an utterance that has stopped keeps its entries
            keep = run[:, None]
            n_s = torch.where(keep, r_s, n_s)
            n_key = torch.where(keep, r_key, n_key)
            improved = torch.where(run, (r_key & _AGE).any(1), improved)
            it = it + run.to(i64)
            if not bool((improved & (it < MAX_EPS_ROUNDS)).any()):
                break
        return n_s, n_key, it >= MAX_EPS_ROUNDS

    init_s, init_sc = init
    fr_s = init_s[None].expand(B, K).contiguous()
    fr_key = _candidates(torch, init_sc, 0)[None].expand(B, K)
    fr_key = torch.where(fr_key == _NONE, _DEAD, fr_key).contiguous()
    ovf = torch.zeros(B, dtype=torch.bool, device=dev)
    tb_s = torch.empty((T, B, K), dtype=torch.int32, device=dev)
    tb_arc = torch.empty((T, B, K), dtype=torch.int32, device=dev)
    for t in range(T):
        live = t < lengths
        # the live utterances' live entries (one look at the host)
        rows, ks = ((fr_key < _DEAD) & live[:, None]).nonzero(as_tuple=True)
        s_ = fr_s[rows, ks]
        n = rows.shape[0]
        rows_e = rows[:, None].expand(n, de)
        cand = (_key_score(torch, fr_key[rows, ks])[:, None] + e_w[s_]
                + ac[t][rows_e, e_colm[s_]])
        best = torch.full((B,), float("inf"), device=dev).scatter_reduce_(
            0, rows_e.flatten(), cand.flatten(), "amin")
        dedup.add(rows_e.flatten(), e_dst[s_].flatten(), _candidates(
            torch, cand, s_[:, None] * de + low_e,
            cand <= (best + beam)[rows_e]).flatten())
        n_s, n_key, flat = dedup.take()
        if ma < K:
            # histogram prune at the kth-best DISTINCT state's score,
            # keeping ties (the keys' high words order the scores)
            cut = n_key[:, ma - 1] >> 32
            dead = (n_key >> 32) > cut[:, None]
            n_key = torch.where(dead, _DEAD, n_key)
            n_s = torch.where(dead, S, n_s)
            r, s2, key2, ok = flat
            flat = (r, s2, key2, ok & ((key2 >> 32) <= cut[r]))
        n_s, n_key, n_ovf = eps_close(n_s, n_key, flat, live)
        keep = live[:, None]
        out_arc = torch.where(keep, (n_key & _ARC) - 1, -1)
        tb_s[t] = torch.where(out_arc >= 0, n_s, -2)
        tb_arc[t] = out_arc
        fr_s = torch.where(keep, n_s, fr_s)
        fr_key = torch.where(keep, n_key, fr_key)
        ovf = torch.where(live, ovf | n_ovf, ovf)

    fr_sc = _key_score(torch, fr_key)
    total = fr_sc + tabs["finals"][fr_s]
    k_best = total.argmin(1, keepdim=True)
    best_cost = total.gather(1, k_best)[:, 0]
    end_state = fr_s.gather(1, k_best)[:, 0]
    words, n_words, phones, bad = _frontier_backtrace(
        torch, g, tabs, tb_s, tb_arc, lengths - 1, end_state, K,
        n_words_cap)
    return best_cost, words, n_words, phones, ovf | bad


def _frontier_backtrace(torch, g, tabs, tb_s, tb_arc, t, s, K, Lw):
    """Walk the stored frontiers back from frame ``t`` [B] and state ``s``
    [B] for every utterance at once; an utterance stops when its walk ends,
    breaks (its state is not in its frame's frontier) or passes its step
    cap, as JAX's vmapped while_loop does.  Returns (words, n_words,
    phones, bad | not done)."""
    dev = t.device
    T, B = tb_s.shape[0], tb_s.shape[1]
    S, de, dz = g.num_states, g.de, g.dz
    Ae = (S + 1) * de
    i64 = torch.int64
    cap = (T + 2) * (MAX_EPS_ROUNDS + de + dz + K)
    b_idx = torch.arange(B, device=dev)
    words = torch.zeros((B, Lw), dtype=i64, device=dev)
    phones = torch.zeros((B, max(T, 1)), dtype=i64, device=dev)
    wi = torch.zeros(B, dtype=i64, device=dev)
    it = torch.zeros(B, dtype=i64, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    bad = torch.zeros(B, dtype=torch.bool, device=dev)
    t, s = t.clone(), s.clone()
    e_il, e_ol, z_ol = tabs["e_il"], tabs["e_ol"], tabs["z_ol"]
    back_init = tabs["back_init"]
    while True:
        for _ in range(WALK_ROUNDS):
            run = ~done & (it < cap) & ~bad
            tc = t.clamp(min=0)
            in_frame = t >= 0
            hit = tb_s[tc, b_idx] == s[:, None]  # [B, K]
            k = hit.to(torch.int32).argmax(1)
            found = hit.any(1)
            a = torch.where(
                in_frame,
                torch.where(found, tb_arc[tc, b_idx, k].to(i64), -1),
                back_init[s])
            bad_now = in_frame & ~found
            done_now = a < 0
            act = ~done_now & ~bad_now
            emit = act & (a < Ae)
            ids = a.clamp(min=0)
            e_s, e_d = (ids // de).clamp(max=S), ids % de
            z_ids = (a - Ae).clamp(min=0)
            z_s, z_d = (z_ids // dz).clamp(max=S), z_ids % dz
            ol = torch.where(emit, e_ol[e_s, e_d], z_ol[z_s, z_d])
            src = torch.where(emit, e_s, z_s)
            rec_w = run & act & (ol != EPS)
            bad_now = bad_now | (rec_w & (wi >= Lw))
            widx = (Lw - 1 - wi).clamp(0, Lw - 1)
            words[b_idx, widx] = torch.where(rec_w, ol, words[b_idx, widx])
            wi = wi + rec_w.to(i64)
            rec_p = run & emit & in_frame
            phones[b_idx, tc] = torch.where(rec_p, e_il[e_s, e_d],
                                            phones[b_idx, tc])
            s = torch.where(run & act, src, s)
            t = torch.where(run & emit, t - 1, t)
            done = done | (run & done_now)
            bad = bad | (run & bad_now)
            it = it + run.to(i64)
        if not bool((~done & (it < cap) & ~bad).any()):
            return words, wi, phones, bad | ~done


class FrontierLatgen(DeviceLatgen):
    """Batched on-device top-K frontier Viterbi decoder.

    Same knobs and output contract as :class:`DeviceLatgen`
    (decode/device_latgen.py): ``decode_batch`` consumes a PADDED
    [B, T, P] log-posterior batch plus per-utterance frame counts and
    returns a list of (word_ids, phone_frames, total_cost) or None per
    utterance.  The frontier width is ``frontier_width`` or
    ``min(S, max(2 * max_active, 64))``; ``max_active`` is the histogram
    prune on the emit candidates.  ``de``/``dz`` bound per-state
    out-degree (fatter states are split; see :class:`_FrontierGraph`).
    """

    def __init__(self, graph: Fst, *, acoustic_scale=1.0, beam=16.0,
                 max_active=2000, log_priors=None, sym_offset=1,
                 words_cap=None, de=16, dz=16, frontier_width=None,
                 device="cuda"):
        self._setup(graph, acoustic_scale, beam, max_active, log_priors,
                    sym_offset, words_cap, device)
        self.packed = _packed(graph, sym_offset, de, dz)
        self.frontier_width = frontier_width

    def widths(self):
        """(K, ma): the frontier width and the emit candidates' cap."""
        S = self.packed.num_states
        ma = self.max_active if 0 < self.max_active < S else S
        # frontier slack past max_active holds histogram-prune score
        # ties and epsilon-closure results (the host keeps both
        # uncapped); 2x matches the host on every pinned fixture
        K = self.frontier_width or min(S, max(2 * ma, 64))
        return K, min(ma, K)

    def decode_batch(self, log_posts, lengths=None):
        import torch

        g = self.packed
        posts, posts_raw, lengths, single = self._prepare(log_posts, lengths)
        T = posts.shape[1]
        K, ma = self.widths()
        Lw = self.words_cap or (2 * T + 16)
        with torch.no_grad():
            out_t = _frontier_search(
                torch, g, g.tables(torch, self.device),
                g.init_frontier(torch, self.device, K),
                torch.from_numpy(posts).to(self.device),
                torch.from_numpy(lengths).to(torch.int64),
                self.acoustic_scale, self.beam, K, ma, Lw)
        cost, words, n_words, phones, overflow = (x.cpu().numpy()
                                                  for x in out_t)
        out = []
        for b in range(posts.shape[0]):
            # overflow first: an overflowed search's dead beam is not
            # trustworthy — the host fallback may still find a path
            if overflow[b]:
                # traceback overflow / broken frontier walk: host
                # fallback for this utterance, never a truncated result
                out.append(self._host_decode(posts_raw[b], lengths[b]))
                continue
            if not np.isfinite(cost[b]):
                out.append(None)
                continue
            n = int(n_words[b])
            w = words[b, len(words[b]) - n:].tolist() if n else []
            ph = phones[b, :lengths[b]].tolist()
            out.append((w, ph, float(cost[b])))
        return out[0] if single else out


def frontier_latgen(graph: Fst, log_posts, lengths=None, **kw):
    """One-shot batched frontier decode; see :class:`FrontierLatgen`."""
    return FrontierLatgen(graph, **kw).decode_batch(log_posts, lengths)
