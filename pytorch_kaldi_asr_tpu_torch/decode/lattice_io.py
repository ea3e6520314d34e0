"""The word lattice: a DAG of timed nodes and word links carrying split
acoustic and graph costs (the information of a Kaldi CompactLattice); the
port's ``Link`` and ``WordLattice`` of ``pytorch_kaldi_asr_tpu.decode.
lattice_io``, with its scoring (Viterbi best path, log-semiring
forward/backward and link posteriors).

Produced by decode/latgen.py's ``latgen_lattice``; decode/lattice_ops.py
holds the lattice verbs.  The lattice interchange formats (HTK SLF, Kaldi
text lattices, GraphViz) are not ported yet (ROADMAP.md, queue 1 item 8a).
"""

from __future__ import annotations

import math
from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class Link:
    start: int
    end: int
    word: str
    acoustic: float = 0.0  # -log, Kaldi sign convention
    graph: float = 0.0

    @property
    def cost(self):
        return self.acoustic + self.graph


@dataclass
class WordLattice:
    """node_times[i] = frame index of node i; node 0 is the start.
    ``finals``: {node: final_cost}."""

    node_times: list = field(default_factory=list)
    links: list = field(default_factory=list)
    finals: dict = field(default_factory=dict)
    utt: str = ""

    @property
    def num_nodes(self):
        return len(self.node_times)

    def add_node(self, time):
        self.node_times.append(int(time))
        return len(self.node_times) - 1

    def add_link(self, start, end, word, acoustic=0.0, graph=0.0):
        self.links.append(Link(start, end, word, float(acoustic),
                               float(graph)))

    def out_links(self):
        by_start = defaultdict(list)
        for l in self.links:
            by_start[l.start].append(l)
        return by_start

    def topo_order(self):
        """Topological node order (lattices are DAGs)."""
        indeg = [0] * self.num_nodes
        for l in self.links:
            indeg[l.end] += 1
        order = [n for n in range(self.num_nodes) if indeg[n] == 0]
        out = self.out_links()
        i = 0
        while i < len(order):
            n = order[i]
            i += 1
            for l in out[n]:
                indeg[l.end] -= 1
                if indeg[l.end] == 0:
                    order.append(l.end)
        if len(order) != self.num_nodes:
            raise ValueError("lattice has a cycle")
        return order

    # -- scoring -------------------------------------------------------------

    def best_path(self, *, acoustic_scale=1.0, lm_scale=1.0):
        """(words, total_cost) of the Viterbi path."""
        INF = math.inf
        dist = [INF] * self.num_nodes
        back = [None] * self.num_nodes
        dist[0] = 0.0
        out = self.out_links()
        for n in self.topo_order():
            if dist[n] == INF:
                continue
            for l in out[n]:
                c = dist[n] + acoustic_scale * l.acoustic + lm_scale * l.graph
                if c < dist[l.end]:
                    dist[l.end] = c
                    back[l.end] = l
        best, bc = None, INF
        for n, fw in self.finals.items():
            if dist[n] + fw < bc:
                best, bc = n, dist[n] + fw
        if best is None:
            return None
        words = []
        n = best
        while back[n] is not None:
            l = back[n]
            if l.word not in ("<eps>", "!NULL", ""):
                words.append(l.word)
            n = l.start
        return words[::-1], bc

    def alpha_beta(self, *, acoustic_scale=1.0, lm_scale=1.0):
        """Log-semiring forward/backward node scores.  Returns
        (alpha, beta, total_logprob)."""

        def lse(a, b):
            if a == -math.inf:
                return b
            if b == -math.inf:
                return a
            m = max(a, b)
            return m + math.log(math.exp(a - m) + math.exp(b - m))

        order = self.topo_order()
        out = self.out_links()
        alpha = [-math.inf] * self.num_nodes
        alpha[0] = 0.0
        for n in order:
            for l in out[n]:
                w = -(acoustic_scale * l.acoustic + lm_scale * l.graph)
                alpha[l.end] = lse(alpha[l.end], alpha[n] + w)
        beta = [-math.inf] * self.num_nodes
        for n, fw in self.finals.items():
            beta[n] = -fw
        for n in reversed(order):
            for l in out[n]:
                w = -(acoustic_scale * l.acoustic + lm_scale * l.graph)
                beta[n] = lse(beta[n], w + beta[l.end])
        total = -math.inf
        for n, fw in self.finals.items():
            total = lse(total, alpha[n] - fw)
        return alpha, beta, total

    def forward_backward(self, *, acoustic_scale=1.0, lm_scale=1.0):
        """Log-semiring link posteriors: returns [(link, posterior)] with
        posteriors normalized over the lattice (the lattice-to-kws-index
        scoring role)."""
        alpha, beta, total = self.alpha_beta(
            acoustic_scale=acoustic_scale, lm_scale=lm_scale)
        posts = []
        for l in self.links:
            w = -(acoustic_scale * l.acoustic + lm_scale * l.graph)
            lp = alpha[l.start] + w + beta[l.end] - total
            posts.append((l, math.exp(min(lp, 0.0))))
        return posts
