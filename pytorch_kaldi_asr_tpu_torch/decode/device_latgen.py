"""Batched WFST Viterbi search on the card (the port's copy of
``pytorch_kaldi_asr_tpu.decode.device_latgen``: the dense decoder).

The host decoder (decode/latgen.py) walks the graph one token at a time on
the CPU; this module runs the same frame-synchronous Viterbi recursion as
tensor operations, so a whole BATCH of utterances is decoded on the card
next to the acoustic model that produced the posteriors (the batched GPU
WFST decoders of Chen et al., arXiv:1804.03243, and NVIDIA's batched
Viterbi decoder, arXiv:1910.10032).  The JAX package writes it as XLA code
(``lax.scan``, ``lax.while_loop``, ``segment_min``); here it is PyTorch
tensor code with JAX's semantics, operation for operation:

- the graph's arcs are packed into arrays, split into EMITTING
  (ilabel != eps) and EPSILON arc tables, and sent to the device once per
  graph and device (``_PackedGraph.tables``);
- per frame, the emit step is one gather plus a segment-min over the
  emitting arc table: ``cand[a] = scores[src[a]] + w[a] + acoustic(t,
  il[a])``, summed in that order, reduced to per-state minima with
  ``scatter_reduce_(..., "amin")`` on a +inf-filled [S, B] table; the
  argmin is a second amin over arc ids where the candidate equals its
  state's minimum, so the lowest arc id wins ties (a minimum does not
  depend on the order the card's atomics take);
- beam pruning masks states above ``best + beam`` to +inf; histogram
  (max_active) pruning masks states above the k-th smallest cost;
- epsilon closure is a Bellman-Ford relaxation over the epsilon arc table
  to fixpoint (strict improvement only).  A round past the fixpoint
  changes nothing, so ``EPS_ROUNDS`` rounds run between two looks at the
  host;
- each frame's winning-arc ids are kept in a [T, S, B] int32 traceback,
  walked BACKWARDS on the device for the whole batch at once (each
  utterance masked once its walk ends; ``WALK_ROUNDS`` steps between two
  looks at the host), so only the [B, O(T)] label buffers reach the host.

Scores are float32 (the host decoder sums in float64).  An utterance whose
traceback overflows its word buffer, or whose walk does not end, is decoded
again by the host decoder, as in the JAX package; ``host_fallbacks``
counts these.  Memory: the traceback is T x S x B x 4 bytes.
"""

from __future__ import annotations

import weakref

import numpy as np

from pytorch_kaldi_asr_tpu_torch.fst.core import EPS, Fst

EPS_ROUNDS = 4  # epsilon relaxation rounds between two host checks
WALK_ROUNDS = 64  # backtrace steps between two host checks


class _PackedGraph:
    """Dense arc-table view of an Fst plus the start state's host-side
    epsilon closure (computed once, in float64)."""

    def __init__(self, graph: Fst, sym_offset: int):
        if graph.start < 0:
            raise ValueError("decode graph has no start state")
        S = graph.num_states
        e_src, e_dst, e_col, e_il, e_ol, e_w = [], [], [], [], [], []
        z_src, z_dst, z_ol, z_w = [], [], [], []
        for s in range(S):
            for a in graph.arcs[s]:
                if a.ilabel == EPS:
                    z_src.append(s)
                    z_dst.append(a.nextstate)
                    z_ol.append(a.olabel)
                    z_w.append(a.weight)
                else:
                    e_src.append(s)
                    e_dst.append(a.nextstate)
                    e_col.append(a.ilabel - sym_offset)
                    e_il.append(a.ilabel)
                    e_ol.append(a.olabel)
                    e_w.append(a.weight)
        self.num_states = S
        self.start = graph.start
        self.sym_offset = sym_offset
        self.e_src = np.asarray(e_src, np.int32)
        self.e_dst = np.asarray(e_dst, np.int32)
        self.e_col = np.asarray(e_col, np.int32)
        self.e_il = np.asarray(e_il, np.int32)
        self.e_ol = np.asarray(e_ol, np.int32)
        self.e_w = np.asarray(e_w, np.float32)
        self.z_src = np.asarray(z_src, np.int32)
        self.z_dst = np.asarray(z_dst, np.int32)
        self.z_ol = np.asarray(z_ol, np.int32)
        self.z_w = np.asarray(z_w, np.float32)
        finals = np.full(S, np.inf, np.float32)
        for s, fw in graph.final.items():
            finals[s] = fw
        self.finals = finals
        # start-state epsilon closure with back pointers (global arc ids
        # offset past the emitting table), float64 like the host oracle
        scores0 = np.full(S, np.inf)
        back0 = np.full(S, -1, np.int32)
        scores0[graph.start] = 0.0
        n_e = len(self.e_src)
        stack = [graph.start]
        while stack:
            s = stack.pop()
            base = scores0[s]
            for zi in np.nonzero(self.z_src == s)[0]:
                nc = base + self.z_w[zi]
                d = int(self.z_dst[zi])
                if nc < scores0[d]:
                    scores0[d] = nc
                    back0[d] = n_e + zi
                    stack.append(d)
        self.scores0 = scores0.astype(np.float32)
        self.back_init = back0
        self._tables = {}

    def tables(self, torch, device):
        """The arc tables as tensors on ``device``, sent once per device.
        Index tables are int64 (torch's gather and scatter index type); an
        empty arc table gets one dummy row so the backtrace's gathers stay
        in bounds (its entries are never selected)."""
        key = str(device)
        tabs = self._tables.get(key)
        if tabs is not None:
            return tabs

        def t(a, dtype=torch.int64):
            return torch.as_tensor(a).to(device=device, dtype=dtype)

        def nonempty(a):
            return a if len(a) else np.zeros(1, a.dtype)

        tabs = {
            "e_src": t(self.e_src), "e_dst": t(self.e_dst),
            "e_col": t(self.e_col), "e_w": t(self.e_w, torch.float32),
            "z_src": t(self.z_src), "z_dst": t(self.z_dst),
            "z_w": t(self.z_w, torch.float32),
            "finals": t(self.finals, torch.float32),
            "scores0": t(self.scores0, torch.float32),
            "back_init": t(self.back_init),
            # the backtrace's label lookups
            "bt_e_src": t(nonempty(self.e_src)),
            "bt_e_il": t(nonempty(self.e_il)),
            "bt_e_ol": t(nonempty(self.e_ol)),
            "bt_z_src": t(nonempty(self.z_src)),
            "bt_z_ol": t(nonempty(self.z_ol)),
        }
        self._tables[key] = tabs
        return tabs


def _graph_fingerprint(graph: Fst):
    return (graph.start, graph.num_states, graph.num_arcs,
            tuple(sorted(graph.final.items())))


_PACKED: "weakref.WeakKeyDictionary[Fst, tuple]" = weakref.WeakKeyDictionary()


def _packed(graph: Fst, sym_offset: int):
    key = (_graph_fingerprint(graph), sym_offset)
    ent = _PACKED.get(graph)
    if ent is None or ent[0] != key:
        ent = (key, _PackedGraph(graph, sym_offset))
        _PACKED[graph] = ent
    return ent[1]


def _seg_min_arg(torch, cand, dst, ids, n, big):
    """Per-state minimum of ``cand`` [A, B] over arcs into each of ``n``
    states (``dst`` [A, B] int64), and the lowest arc id reaching it (-1
    where the minimum is +inf): ``jax.ops.segment_min`` twice."""
    B = cand.shape[1]
    m = torch.full((n, B), float("inf"), dtype=cand.dtype,
                   device=cand.device)
    m.scatter_reduce_(0, dst, cand, "amin")
    is_min = cand == m.gather(0, dst)
    arg = torch.full((n, B), big, dtype=torch.int64, device=cand.device)
    arg.scatter_reduce_(0, dst, torch.where(is_min, ids[:, None], big),
                        "amin")
    return m, torch.where(torch.isfinite(m), arg, -1)


def _dense_search(torch, g, tabs, posts, lengths, acoustic_scale, beam,
                  max_active, n_words_cap):
    """The Viterbi search over a [B, T, P] float32 batch on its device:
    returns (best_cost [B], words [B, Lw], n_words [B], phones [B, T],
    overflow [B]) as tensors on that device."""
    dev = posts.device
    B, T, P = posts.shape
    S, Ae, Az = g.num_states, len(g.e_src), len(g.z_src)
    Lw = n_words_cap
    f32 = torch.float32
    inf = float("inf")
    beam = torch.tensor(np.float32(beam), device=dev)
    # -acoustic_scale * post, with a +inf row for the columns outside the
    # posterior (JAX's where(col_ok, ac, INF)): [T, P + 1, B]
    ac = posts * torch.tensor(-np.float32(acoustic_scale), device=dev)
    ac = torch.cat([ac, torch.full((B, T, 1), inf, dtype=f32, device=dev)],
                   2).permute(1, 2, 0).contiguous()
    col = tabs["e_col"]
    e_colm = torch.where((col >= 0) & (col < P), col, P)
    e_src, e_w = tabs["e_src"], tabs["e_w"][:, None]
    e_dst = tabs["e_dst"][:, None].expand(Ae, B).contiguous()
    z_src, z_w = tabs["z_src"], tabs["z_w"][:, None]
    z_dst = tabs["z_dst"][:, None].expand(Az, B).contiguous()
    ids_e = torch.arange(Ae, device=dev)
    ids_z = torch.arange(Az, device=dev)
    big = Ae + Az + 1
    live_all = (torch.arange(T, device=dev)[:, None]
                < lengths[None, :].to(dev))  # [T, B]

    def eps_relax(sc, bk):
        if Az == 0:
            return sc, bk
        while True:
            for _ in range(EPS_ROUNDS):
                cand = sc.index_select(0, z_src) + z_w
                m, arg = _seg_min_arg(torch, cand, z_dst, ids_z, S, big)
                better = m < sc
                sc = torch.where(better, m, sc)
                bk = torch.where(better & (arg >= 0), arg + Ae, bk)
            if not bool(better.any()):
                return sc, bk

    scores = tabs["scores0"][:, None].expand(S, B).contiguous()
    back_arcs = torch.empty((T, S, B), dtype=torch.int32, device=dev)
    for t in range(T):
        cand = (scores.index_select(0, e_src) + e_w
                + ac[t].index_select(0, e_colm))
        new_sc, back = _seg_min_arg(torch, cand, e_dst, ids_e, S, big)
        # beam prune (the host prunes after the emit step, before closure)
        best = new_sc.min(0).values
        new_sc = torch.where(new_sc <= best + beam, new_sc, inf)
        if 0 < max_active < S:
            kth = new_sc.kthvalue(max_active, 0).values
            new_sc = torch.where(new_sc <= kth, new_sc, inf)
        new_sc, back = eps_relax(new_sc, back)
        live = live_all[t]
        scores = torch.where(live, new_sc, scores)
        back_arcs[t] = torch.where(live, back, -1)

    total = scores + tabs["finals"][:, None]
    end_state = total.argmin(0)
    best_cost = total.gather(0, end_state[None])[0]
    words, n_words, phones, overflow = _dense_backtrace(
        torch, tabs, back_arcs.view(-1), lengths.to(dev) - 1, end_state,
        T, S, Ae, Az, Lw)
    return best_cost, words, n_words, phones, overflow


def _dense_backtrace(torch, tabs, ba, t, s, T, S, Ae, Az, Lw):
    """Walk the [T, S, B] traceback (``ba``, flat) back from frame ``t``
    [B] and state ``s`` [B] for every utterance at once; an utterance stops
    when its walk ends (a -1 back pointer) or after (T + 2)(S + 1) steps,
    and takes no further step meanwhile (JAX's vmapped while_loop)."""
    dev = t.device
    B = t.shape[0]
    cap = (T + 2) * (S + 1)
    b_idx = torch.arange(B, device=dev)
    words = torch.zeros((B, Lw), dtype=torch.int64, device=dev)
    phones = torch.zeros((B, max(T, 1)), dtype=torch.int64, device=dev)
    wi = torch.zeros(B, dtype=torch.int64, device=dev)
    it = torch.zeros(B, dtype=torch.int64, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    ovf = torch.zeros(B, dtype=torch.bool, device=dev)
    s = s.clone()
    t = t.clone()
    e_src, e_il, e_ol = tabs["bt_e_src"], tabs["bt_e_il"], tabs["bt_e_ol"]
    z_src, z_ol = tabs["bt_z_src"], tabs["bt_z_ol"]
    back_init = tabs["back_init"]
    while True:
        for _ in range(WALK_ROUNDS):
            run = ~done & (it < cap)
            tc = t.clamp(min=0)
            a_frame = ba[(tc * S + s) * B + b_idx].to(torch.int64)
            a = torch.where(t >= 0, a_frame, back_init[s])
            done_now = a < 0
            act = ~done_now
            emit = act & (a < Ae)
            ae = a.clamp(0, max(Ae - 1, 0))
            az = (a - Ae).clamp(0, max(Az - 1, 0))
            ol = torch.where(emit, e_ol[ae], z_ol[az])
            src = torch.where(emit, e_src[ae], z_src[az])
            rec_w = run & act & (ol != EPS)
            ovf = ovf | (rec_w & (wi >= Lw))
            widx = (Lw - 1 - wi).clamp(0, Lw - 1)
            words[b_idx, widx] = torch.where(rec_w, ol, words[b_idx, widx])
            wi = wi + rec_w.to(torch.int64)
            rec_p = run & emit & (t >= 0)
            phones[b_idx, tc] = torch.where(rec_p, e_il[ae],
                                            phones[b_idx, tc])
            s = torch.where(run & act, src, s)
            t = torch.where(run & emit, t - 1, t)
            done = done | (run & done_now)
            it = it + run.to(torch.int64)
        if not bool((~done & (it < cap)).any()):
            return words, wi, phones, ovf | ~done


class DeviceLatgen:
    """Batched on-device Viterbi decoder over a compiled (H)LG graph.

    Same knobs and conventions as :func:`decode.latgen.latgen`
    (acoustic_scale / beam / max_active / log_priors / sym_offset; input
    label i reads posterior column i - sym_offset).  ``decode_batch``
    consumes a PADDED [B, T, P] posterior batch plus per-utterance frame
    counts and returns a list of (word_ids, phone_frames, total_cost) or
    None per utterance — the host decoders' exact output contract.
    ``device``: ``cuda`` (the default; raises without a card) or ``cpu``.
    ``host_fallbacks`` counts the utterances the host decoder took over.
    """

    def __init__(self, graph: Fst, *, acoustic_scale=1.0, beam=16.0,
                 max_active=2000, log_priors=None, sym_offset=1,
                 words_cap=None, device="cuda"):
        self._setup(graph, acoustic_scale, beam, max_active, log_priors,
                    sym_offset, words_cap, device)
        self.packed = _packed(graph, sym_offset)

    def _setup(self, graph, acoustic_scale, beam, max_active, log_priors,
               sym_offset, words_cap, device):
        from pytorch_kaldi_asr_tpu_torch.utils.device import resolve_device

        self.device = resolve_device(device)
        self.graph = graph
        self.acoustic_scale = float(acoustic_scale)
        self.beam = float(beam)
        self.max_active = int(max_active)
        self.log_priors = (None if log_priors is None
                           else np.asarray(log_priors, np.float32))
        self.sym_offset = sym_offset
        self.words_cap = words_cap
        self.host_fallbacks = 0

    def _prepare(self, log_posts, lengths):
        posts = np.asarray(log_posts, np.float32)
        single = posts.ndim == 2
        if single:
            posts = posts[None]
        B, T, P = posts.shape
        if lengths is None:
            lengths = np.full(B, T, np.int32)
        lengths = np.asarray(lengths, np.int32)
        posts_raw = posts
        if self.log_priors is not None:
            if posts.shape[2] != len(self.log_priors):
                raise ValueError(
                    f"posterior width {posts.shape[2]} != priors length "
                    f"{len(self.log_priors)}")
            posts = posts - self.log_priors[None, None, :]
        return posts, posts_raw, lengths, single

    def _host_decode(self, posts_raw, length):
        """The host decoder on one utterance: the fallback on overflow."""
        from pytorch_kaldi_asr_tpu_torch.decode.latgen import latgen

        self.host_fallbacks += 1
        return latgen(self.graph, posts_raw[:length].astype(np.float64),
                      acoustic_scale=self.acoustic_scale, beam=self.beam,
                      max_active=self.max_active, log_priors=self.log_priors,
                      sym_offset=self.sym_offset)

    def decode_batch(self, log_posts, lengths=None):
        """log_posts: [B, T, P] (or [T, P] for a single utterance) log
        p(phone | frame), zero-padded past each utterance's length."""
        import torch

        g = self.packed
        posts, posts_raw, lengths, single = self._prepare(log_posts, lengths)
        T = posts.shape[1]
        Lw = self.words_cap or (2 * T + 16)
        with torch.no_grad():
            out_t = _dense_search(
                torch, g, g.tables(torch, self.device),
                torch.from_numpy(posts).to(self.device),
                torch.from_numpy(lengths).to(torch.int64), self.acoustic_scale,
                self.beam, self.max_active, Lw)
        cost, words, n_words, phones, overflow = (x.cpu().numpy()
                                                  for x in out_t)
        out = []
        for b in range(posts.shape[0]):
            if not np.isfinite(cost[b]):
                out.append(None)
                continue
            if overflow[b]:
                # traceback buffer overflow (words_cap too small) or a
                # non-converged walk: fall back to the host decoder for
                # this utterance — never return a truncated hypothesis
                out.append(self._host_decode(posts_raw[b], lengths[b]))
                continue
            n = int(n_words[b])
            w = words[b, len(words[b]) - n:].tolist() if n else []
            ph = phones[b, :lengths[b]].tolist()
            out.append((w, ph, float(cost[b])))
        return out[0] if single else out


def device_latgen(graph: Fst, log_posts, lengths=None, **kw):
    """One-shot batched decode; see :class:`DeviceLatgen`."""
    return DeviceLatgen(graph, **kw).decode_batch(log_posts, lengths)


# dense-path comfort zone: past either bound the [T, S, B] traceback and
# the per-frame full-arc-table scatter stop paying for themselves and the
# top-K frontier decoder (decode/frontier_latgen.py) takes over.  These are
# the JAX package's bounds, kept because the choice changes the output (the
# frontier searches with a tighter histogram prune); they were not placed
# on the card
DENSE_MAX_STATES = 8192
DENSE_MAX_ARCS = 65536


def pick_mode(graph: Fst, mode="auto"):
    """``dense`` or ``frontier`` for ``graph``: ``mode`` itself unless it
    is ``auto``, which picks dense inside DENSE_MAX_STATES and
    DENSE_MAX_ARCS and the frontier beyond either."""
    if mode == "auto":
        mode = ("frontier"
                if (graph.num_states > DENSE_MAX_STATES
                    or graph.num_arcs > DENSE_MAX_ARCS)
                else "dense")
    if mode not in ("dense", "frontier"):
        raise ValueError(f"unknown device-search mode {mode!r}")
    return mode


def make_device_latgen(graph: Fst, *, mode="auto", **kw):
    """Build the right on-device decoder for ``graph``.

    ``mode``: ``"dense"`` (this module's full-state-table decoder),
    ``"frontier"`` (decode/frontier_latgen.py top-K decoder), or
    ``"auto"`` (:func:`pick_mode`).  Both classes share the decode_batch
    contract and the ``device`` keyword."""
    if pick_mode(graph, mode) == "frontier":
        from pytorch_kaldi_asr_tpu_torch.decode.frontier_latgen import (
            FrontierLatgen,
        )

        return FrontierLatgen(graph, **kw)
    kw.pop("frontier_width", None)
    return DeviceLatgen(graph, **kw)


def _round_up(n, m):
    return ((n + m - 1) // m) * m


def decode_posterior_stream(graph: Fst, post_iter, word_syms, *,
                            batch_size=8, pad_multiple=64,
                            acoustic_scale=1.0, beam=16.0, max_active=2000,
                            log_priors=None, sym_offset=1, mode="auto",
                            device="cuda", decoder=None):
    """Batched on-device twin of decode.latgen.decode_posterior_ark:
    consume a (key, log_posterior_matrix) stream, decode ``batch_size``
    utterances per device call, and yield (key, word_string, cost) in
    input order.  Frame counts are padded to ``pad_multiple`` (and the
    last ragged batch to the full ``batch_size`` with empty utterances).
    ``mode`` picks the dense or frontier device decoder (see
    :func:`make_device_latgen`); ``decoder``, when given, is used instead
    (the CLI reads its ``host_fallbacks``)."""
    id2word = {v: k for k, v in word_syms.items()}
    dec = decoder or make_device_latgen(
        graph, mode=mode, acoustic_scale=acoustic_scale, beam=beam,
        max_active=max_active, log_priors=log_priors, sym_offset=sym_offset,
        device=device)

    def flush(buf):
        P = buf[0][1].shape[1]
        lens = [m.shape[0] for _, m in buf]
        T = _round_up(max(lens), pad_multiple)
        n_pad = batch_size - len(buf)
        batch = np.zeros((batch_size, T, P), np.float32)
        for b, (_, mat) in enumerate(buf):
            batch[b, :lens[b]] = mat
        res = dec.decode_batch(batch, np.asarray(lens + [0] * n_pad,
                                                 np.int32))
        for (key, _), r in zip(buf, res):
            if r is None:
                yield key, "", float("inf")
            else:
                word_ids, _, cost = r
                yield key, " ".join(id2word.get(w, "<unk>")
                                    for w in word_ids), cost

    buf = []
    for key, mat in post_iter:
        buf.append((key, np.asarray(mat, np.float32)))
        if len(buf) == batch_size:
            yield from flush(buf)
            buf = []
    if buf:
        yield from flush(buf)
