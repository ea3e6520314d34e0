"""OpenFst's binary FST files without OpenFst (the port's copy of
``pytorch_kaldi_asr_tpu.fst.openfst_io``, the StdArc graphs only; the
lattice-ark writers come with the lattice tools).

- ``read_fst`` reads OpenFst's VectorFst<StdArc> stream (what
  ``Fst.write_binary`` writes, fst/core.py): int32 magic 2125659606,
  length-prefixed fsttype/arctype strings, int32 version/flags, uint64
  properties, int64 start/numstates/numarcs, then per state a float final
  weight, an int64 arc count, and (ilabel:int32, olabel:int32,
  weight:float, nextstate:int32) arcs, all little-endian; and
  ConstFst<StdArc> files (version 2 unaligned and the version-1
  16-byte-aligned layout), so graphs that went through ``fstconvert
  --fst_type=const`` load too.
- ``write_const_fst`` writes ConstFst<StdArc>, version 2.
"""

from __future__ import annotations

import struct

from pytorch_kaldi_asr_tpu_torch.fst.core import INF, Fst

MAGIC = 2125659606  # OpenFst kFstMagicNumber
_ALIGN = 16  # ConstFst v1 MappedFile alignment


def _rstr(f):
    (n,) = struct.unpack("<i", f.read(4))
    return f.read(n).decode()


def _wstr(f, s):
    b = s.encode()
    f.write(struct.pack("<i", len(b)))
    f.write(b)


def _read_header(f):
    (magic,) = struct.unpack("<i", f.read(4))
    if magic != MAGIC:
        raise ValueError(f"bad OpenFst magic {magic:#x}")
    fsttype = _rstr(f)
    arctype = _rstr(f)
    version, flags = struct.unpack("<ii", f.read(8))
    (properties,) = struct.unpack("<Q", f.read(8))
    start, numstates, numarcs = struct.unpack("<qqq", f.read(24))
    if flags & 0x3:
        raise ValueError("embedded symbol tables not supported")
    return dict(fsttype=fsttype, arctype=arctype, version=version,
                properties=properties, start=start, numstates=numstates,
                numarcs=numarcs)


# ---------------------------------------------------------------------------
# StdArc graphs: vector + const
# ---------------------------------------------------------------------------


def _read_vector_std(f, hdr):
    fst = Fst()
    for _ in range(hdr["numstates"]):
        fst.add_state()
    fst.start = hdr["start"]
    for s in range(hdr["numstates"]):
        (final,) = struct.unpack("<f", f.read(4))
        if final != INF:
            fst.set_final(s, final)
        (narcs,) = struct.unpack("<q", f.read(8))
        raw = f.read(16 * narcs)
        for i in range(narcs):
            il, ol, w, ns = struct.unpack_from("<iifi", raw, 16 * i)
            fst.add_arc(s, il, ol, w, ns)
    return fst


def _align(f, base):
    """ConstFst v1: pad so the next read starts at a multiple of 16 bytes
    from the start of the file (MappedFile alignment)."""
    pos = f.tell() - base
    pad = (-pos) % _ALIGN
    if pad:
        f.read(pad)


def _read_const_std(f, hdr, base):
    nstates, narcs = hdr["numstates"], hdr["numarcs"]
    if hdr["version"] == 1:
        _align(f, base)
    states = f.read(20 * nstates)  # {float final, u32 pos, u32 narcs, u32, u32}
    if hdr["version"] == 1:
        _align(f, base)
    arcs = f.read(16 * narcs)
    fst = Fst()
    for _ in range(nstates):
        fst.add_state()
    fst.start = hdr["start"]
    for s in range(nstates):
        final, pos, n, _nieps, _noeps = struct.unpack_from("<fIIII",
                                                           states, 20 * s)
        if final != INF:
            fst.set_final(s, final)
        for i in range(n):
            il, ol, w, ns = struct.unpack_from("<iifi", arcs, 16 * (pos + i))
            fst.add_arc(s, il, ol, w, ns)
    return fst


def read_fst(path_or_file):
    """Read an OpenFst StdArc file: VectorFst or ConstFst."""
    close = False
    f = path_or_file
    if isinstance(f, str):
        f = open(f, "rb")
        close = True
    try:
        base = f.tell()
        hdr = _read_header(f)
        if hdr["arctype"] != "standard":
            raise ValueError(f"not a StdArc fst: {hdr['arctype']!r}")
        if hdr["fsttype"] == "vector":
            return _read_vector_std(f, hdr)
        if hdr["fsttype"] == "const":
            return _read_const_std(f, hdr, base)
        raise ValueError(f"unsupported fst type {hdr['fsttype']!r}")
    finally:
        if close:
            f.close()


def write_const_fst(fst, path):
    """Write an OpenFst ConstFst<StdArc> (version 2, unaligned), the
    frozen read-optimized layout."""
    nstates = fst.num_states
    narcs = fst.num_arcs
    with open(path, "wb") as f:
        f.write(struct.pack("<i", MAGIC))
        _wstr(f, "const")
        _wstr(f, "standard")
        f.write(struct.pack("<iiQ", 2, 0, 0x1))  # version 2, kExpanded
        f.write(struct.pack("<qqq", fst.start, nstates, narcs))
        pos = 0
        for s in range(nstates):
            lst = fst.arcs[s]
            nieps = sum(1 for a in lst if a.ilabel == 0)
            noeps = sum(1 for a in lst if a.olabel == 0)
            f.write(struct.pack("<fIIII", fst.final.get(s, INF), pos,
                                len(lst), nieps, noeps))
            pos += len(lst)
        for s in range(nstates):
            for a in fst.arcs[s]:
                f.write(struct.pack("<iifi", a.ilabel, a.olabel, a.weight,
                                    a.nextstate))
    return path
