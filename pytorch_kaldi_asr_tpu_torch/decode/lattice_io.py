"""The word lattice: a DAG of timed nodes and word links carrying split
acoustic and graph costs (the information of a Kaldi CompactLattice); the
port's ``Link`` and ``WordLattice`` of ``pytorch_kaldi_asr_tpu.decode.
lattice_io``, with its scoring (Viterbi best path, log-semiring
forward/backward and link posteriors).

Produced by decode/latgen.py's ``latgen_lattice``; decode/lattice_ops.py
holds the lattice verbs.  The interchange formats:

- write_slf / write_slf_file: HTK SLF v1.1 output, words on links (and the
  --word-to-node variant), matching convert_slf.pl's header fields, to one
  file or to per-utterance .lat.gz files;
- to_dot: GraphViz rendering (show_lattice.sh role);
- Kaldi text lattice read/write (the ``lattice-copy ark,t:`` format that
  convert_slf.pl consumes after word alignment), and
  read_text_lattice_archive over a whole archive.

Kaldi's binary lattice arks are fst/openfst_io.py's.
"""

from __future__ import annotations

import gzip
import math
import os
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

    # -- HTK SLF (convert_slf.pl role) ----------------------------------------

    def write_slf(self, f, *, frame_rate=0.01, word_to_node=False):
        """HTK SLF v1.1.  Default: words on links (node ids match the
        internal lattice); --word-to-node adds a word node per link like
        the reference's option."""
        f.write("VERSION=1.1\n")
        f.write(f"UTTERANCE={self.utt}\n")
        # terminal sink: SLF wants one end node; add if several finals
        finals = sorted(self.finals)
        links = list(self.links)
        times = list(self.node_times)
        if len(finals) != 1 or self.finals.get(finals[0], 0.0) != 0.0:
            sink = len(times)
            times.append(max(times) if times else 0)
            for n in finals:
                links.append(Link(n, sink, "!NULL", 0.0, self.finals[n]))
            finals = [sink]
        if word_to_node:
            nodes = [(t, "!NULL") for t in times]
            out_links = []
            for l in links:
                wn = len(nodes)
                nodes.append((times[l.end], l.word or "!NULL"))
                out_links.append((l.start, wn, l.acoustic, l.graph))
                out_links.append((wn, l.end, 0.0, 0.0))
            f.write(f"N={len(nodes)}\tL={len(out_links)}\n")
            for i, (t, w) in enumerate(nodes):
                f.write(f"I={i}\tt={t * frame_rate:.2f}\tW={w}\n")
            for j, (s, e, a, g) in enumerate(out_links):
                f.write(f"J={j}\tS={s}\tE={e}\ta={-a:.2f}\tl={-g:.3f}\n")
        else:
            f.write(f"N={len(times)}\tL={len(links)}\n")
            for i, t in enumerate(times):
                f.write(f"I={i}\tt={t * frame_rate:.2f}\n")
            for j, l in enumerate(links):
                w = l.word or "!NULL"
                f.write(
                    f"J={j}\tS={l.start}\tE={l.end}\tW={w}\t"
                    f"a={-l.acoustic:.2f}\tl={-l.graph:.3f}\n"
                )

    # -- GraphViz (show_lattice.sh role) --------------------------------------

    def to_dot(self):
        lines = ["digraph lattice {", "  rankdir = LR;",
                 "  node [shape=circle];"]
        for n, fw in self.finals.items():
            lines.append(f"  {n} [shape=doublecircle];")
        for l in self.links:
            label = f"{l.word or '<eps>'}/{l.acoustic:.2f},{l.graph:.2f}"
            lines.append(f'  {l.start} -> {l.end} [label="{label}"];')
        lines.append("}")
        return "\n".join(lines)

    # -- Kaldi text lattice ----------------------------------------------------

    def write_kaldi_text(self, f):
        """``start end word graph,acoustic,`` lines + final lines, the
        lattice-copy ark,t: per-utterance block (without the key line)."""
        for l in self.links:
            f.write(f"{l.start} {l.end} {l.word} {l.graph},{l.acoustic},\n")
        for n, fw in self.finals.items():
            f.write(f"{n} {fw},0,\n" if fw else f"{n}\n")

    @classmethod
    def read_kaldi_text(cls, lines, utt="", frame_times=None):
        """Parse one per-utterance block of word-aligned kaldi text lattice
        lines.  Node times are reconstructed from per-link frame counts when
        the score triple carries a state sequence (word-aligned lattices),
        else left as link-count depth."""
        lat = cls(utt=utt)

        def need(n):
            while lat.num_nodes <= n:
                lat.add_node(0)

        for line in lines:
            parts = line.split()
            if not parts:
                continue
            if len(parts) >= 3:
                s, e, word = int(parts[0]), int(parts[1]), parts[2]
                graph = acoustic = 0.0
                nframes = 0
                if len(parts) > 3:
                    scores = parts[3].split(",")
                    graph = float(scores[0]) if scores[0] else 0.0
                    acoustic = float(scores[1]) if len(scores) > 1 and scores[1] else 0.0
                    if len(scores) > 2 and scores[2]:
                        nframes = len(scores[2].split("_"))
                need(max(s, e))
                lat.add_link(s, e, word, acoustic, graph)
                if nframes:
                    lat.node_times[e] = max(lat.node_times[e],
                                            lat.node_times[s] + nframes)
            else:
                s = int(parts[0])
                need(s)
                w = 0.0
                if len(parts) > 1:
                    w = float(parts[1].split(",")[0])
                lat.finals[s] = w
        if frame_times:
            lat.node_times = list(frame_times)
        return lat


def read_text_lattice_archive(path):
    """Yield (utt, WordLattice) from a kaldi-text lattice archive: key
    line, block of arc/final lines, blank separator (the lattice-copy
    ``ark,t:`` file shape).  THE parser for this format — show_lattice,
    kws, and lattice_copy all route through it."""
    with open(path, encoding="utf-8") as f:
        block, utt = [], None
        for line in list(f) + [""]:
            stripped = line.strip()
            if utt is None:
                if stripped:
                    utt = stripped.split()[0]
                continue
            if stripped:
                block.append(stripped)
            else:
                yield utt, WordLattice.read_kaldi_text(block, utt=utt)
                block, utt = [], None


def write_slf_file(lattices, path, *, frame_rate=0.01, word_to_node=False):
    """Write lattices (iterable of WordLattice) to one SLF file, or to
    per-utterance .lat.gz files when ``path`` is a directory
    (convert_slf.pl's two output modes)."""
    if os.path.isdir(path):
        for lat in lattices:
            p = os.path.join(path, f"{lat.utt}.lat.gz")
            with gzip.open(p, "wt", encoding="utf-8") as f:
                lat.write_slf(f, frame_rate=frame_rate,
                              word_to_node=word_to_node)
    else:
        with open(path, "w", encoding="utf-8") as f:
            for lat in lattices:
                lat.write_slf(f, frame_rate=frame_rate,
                              word_to_node=word_to_node)
                f.write("\n")
    return path
