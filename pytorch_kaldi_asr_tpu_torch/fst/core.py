"""Mutable weighted FST over the tropical semiring (the port's copy of
``pytorch_kaldi_asr_tpu.fst.core``).

Weights are tropical: plus = min, times = +, zero = +inf, one = 0.0; label
0 is epsilon.  ``write_binary`` writes OpenFst's VectorFst<StdArc> stream
(fst/openfst_io.py reads it back, and ConstFst files too).
"""

from __future__ import annotations

import math
import struct
from dataclasses import dataclass

INF = math.inf
EPS = 0


@dataclass
class Arc:
    ilabel: int
    olabel: int
    weight: float
    nextstate: int

    def __iter__(self):  # unpacking convenience
        return iter((self.ilabel, self.olabel, self.weight, self.nextstate))


class Fst:
    """states are dense ints; ``arcs[s]`` is the outgoing arc list;
    ``final[s]`` is the final weight (absent = not final)."""

    def __init__(self):
        self.arcs: list[list[Arc]] = []
        self.final: dict[int, float] = {}
        self.start: int = -1

    # -- construction -----------------------------------------------------

    def add_state(self) -> int:
        self.arcs.append([])
        return len(self.arcs) - 1

    def add_arc(self, state, ilabel, olabel, weight, nextstate):
        self.arcs[state].append(Arc(ilabel, olabel, float(weight), nextstate))

    def set_final(self, state, weight=0.0):
        self.final[state] = float(weight)

    @property
    def num_states(self):
        return len(self.arcs)

    @property
    def num_arcs(self):
        return sum(len(a) for a in self.arcs)

    def is_final(self, s):
        return s in self.final

    def final_weight(self, s):
        return self.final.get(s, INF)

    # -- basic transforms --------------------------------------------------

    def arcsort(self, sort_type="ilabel"):
        key = (lambda a: (a.ilabel, a.olabel)) if sort_type == "ilabel" else (
            lambda a: (a.olabel, a.ilabel))
        for lst in self.arcs:
            lst.sort(key=key)
        return self

    def connect(self):
        """Trim states not on a successful (start -> final) path."""
        if self.start < 0:
            return self
        # forward reachability
        fwd = set()
        stack = [self.start]
        while stack:
            s = stack.pop()
            if s in fwd:
                continue
            fwd.add(s)
            stack.extend(a.nextstate for a in self.arcs[s])
        # backward from finals (over the reversed graph, restricted to fwd)
        rev: dict[int, list[int]] = {}
        for s in fwd:
            for a in self.arcs[s]:
                if a.nextstate in fwd:
                    rev.setdefault(a.nextstate, []).append(s)
        bwd = set()
        stack = [s for s in self.final if s in fwd]
        while stack:
            s = stack.pop()
            if s in bwd:
                continue
            bwd.add(s)
            stack.extend(rev.get(s, []))
        keep = fwd & bwd
        remap = {}
        out = Fst()
        for s in range(self.num_states):
            if s in keep:
                remap[s] = out.add_state()
        for s in keep:
            for a in self.arcs[s]:
                if a.nextstate in keep:
                    out.add_arc(remap[s], a.ilabel, a.olabel, a.weight,
                                remap[a.nextstate])
        for s, w in self.final.items():
            if s in keep:
                out.set_final(remap[s], w)
        out.start = remap.get(self.start, -1)
        self.arcs, self.final, self.start = out.arcs, out.final, out.start
        return self

    def copy(self):
        out = Fst()
        out.start = self.start
        out.final = dict(self.final)
        out.arcs = [[Arc(*a) for a in lst] for lst in self.arcs]
        return out

    # -- binary format -------------------------------------------------------
    # Layout (little endian), OpenFst's VectorFst<StdArc>:
    #   int32 magic (0x7EB2FDD6) | string fsttype | string arctype |
    #   int32 version | int32 flags | uint64 properties |
    #   int64 start | int64 numstates | int64 numarcs
    #   per state: float final (inf if none) | int64 narcs |
    #              narcs * (int32 ilabel, int32 olabel, float weight,
    #                       int32 nextstate)
    # Strings are int32 length + utf-8 bytes.

    _MAGIC = 0x7EB2FDD6

    @staticmethod
    def _wstr(f, s):
        b = s.encode()
        f.write(struct.pack("<i", len(b)))
        f.write(b)

    def write_binary(self, path):
        with open(path, "wb") as f:
            f.write(struct.pack("<i", self._MAGIC))
            self._wstr(f, "vector")
            self._wstr(f, "standard")
            f.write(struct.pack("<iiQ", 2, 0, 0))
            f.write(struct.pack("<qqq", self.start, self.num_states,
                                self.num_arcs))
            for s in range(self.num_states):
                final = self.final.get(s, INF)
                f.write(struct.pack("<f", final))
                f.write(struct.pack("<q", len(self.arcs[s])))
                for a in self.arcs[s]:
                    f.write(struct.pack("<iifi", a.ilabel, a.olabel,
                                        a.weight, a.nextstate))
        return path
