"""OpenFst's binary FST files and Kaldi's binary lattice tables without
OpenFst (the port's copy of ``pytorch_kaldi_asr_tpu.fst.openfst_io``).

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
- ``write_lattice_ark`` / ``read_lattice_ark`` speak Kaldi's binary
  lattice tables: ``key \\0B`` + a VectorFst stream with arctype
  ``lattice4`` (LatticeWeight: graph cost + acoustic cost floats) or
  ``compactlattice44`` (CompactLatticeWeight: LatticeWeight + an
  int32-counted transition-id string), bridging decode/lattice_io.py's
  WordLattice to the format Kaldi's ``lattice-copy`` reads; the readers
  parse an ark in place from one read of it, and ``read_lattice_scp``
  reads the ``key ark:offset`` script written beside it.
"""

from __future__ import annotations

import os
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
            raise ValueError(f"not a StdArc fst: {hdr['arctype']!r} "
                             "(use read_lattice_ark for lattice arcs)")
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


# ---------------------------------------------------------------------------
# Kaldi binary lattice tables (lattice4 / compactlattice44 arcs)
# ---------------------------------------------------------------------------


def _write_lattice_weight(f, graph, acoustic):
    f.write(struct.pack("<ff", graph, acoustic))


def _write_clat_weight(f, graph, acoustic, string):
    _write_lattice_weight(f, graph, acoustic)
    f.write(struct.pack("<i", len(string)))
    if string:
        f.write(struct.pack(f"<{len(string)}i", *string))


def write_compact_lattice(lat, f, word2id):
    """Serialize a WordLattice as an OpenFst VectorFst<CompactLatticeArc>
    stream ('compactlattice44').  The per-arc transition-id string carries
    the link's frame duration (placeholder id 1 per frame) so node times
    survive the roundtrip; word labels are acceptor-style ilabel=olabel."""
    numarcs = len(lat.links)
    f.write(struct.pack("<i", MAGIC))
    _wstr(f, "vector")
    _wstr(f, "compactlattice44")
    f.write(struct.pack("<iiQ", 2, 0, 0))
    f.write(struct.pack("<qqq", 0 if lat.num_nodes else -1,
                        lat.num_nodes, numarcs))
    out = lat.out_links()
    for s in range(lat.num_nodes):
        if s in lat.finals:
            _write_clat_weight(f, lat.finals[s], 0.0, [])
        else:
            _write_clat_weight(f, INF, INF, [])
        lst = out.get(s, [])
        f.write(struct.pack("<q", len(lst)))
        for l in lst:
            wid = word2id.get(l.word, 0) if l.word not in ("<eps>", "!NULL",
                                                           "") else 0
            dur = max(lat.node_times[l.end] - lat.node_times[l.start], 0)
            f.write(struct.pack("<ii", wid, wid))
            _write_clat_weight(f, l.graph, l.acoustic, [1] * dur)
            f.write(struct.pack("<i", l.end))


def _parse_compact_lattice(buf, pos, id2word):
    """(WordLattice, end offset) of the lattice stream at ``buf[pos:]``
    (what read_compact_lattice reads), parsed in place: one
    ``struct.unpack_from`` per state weight and two per arc, the
    transition-id strings skipped over (only their lengths are kept)."""
    from pytorch_kaldi_asr_tpu_torch.decode.lattice_io import (
        Link,
        WordLattice,
    )

    (magic,) = struct.unpack_from("<i", buf, pos)
    if magic != MAGIC:
        raise ValueError(f"bad OpenFst magic {magic:#x}")
    pos += 4
    types = []
    for _ in range(2):
        (n,) = struct.unpack_from("<i", buf, pos)
        types.append(bytes(buf[pos + 4:pos + 4 + n]).decode())
        pos += 4 + n
    fsttype, arctype = types
    _version, flags, _props, _start, numstates, _numarcs = \
        struct.unpack_from("<iiQqqq", buf, pos)
    pos += 40
    if flags & 0x3:
        raise ValueError("embedded symbol tables not supported")
    compact = arctype == "compactlattice44"
    if not compact and arctype != "lattice4":
        raise ValueError(f"not a lattice fst: {arctype!r}")
    if fsttype != "vector":
        raise ValueError(f"unsupported lattice fst type {fsttype!r}")
    weight = struct.Struct("<ffi" if compact else "<ff").unpack_from
    arc = struct.Struct("<iiffi" if compact else "<iiff").unpack_from
    int32 = struct.Struct("<i").unpack_from
    int64 = struct.Struct("<q").unpack_from
    lat = WordLattice(node_times=[0] * numstates)
    links = []
    for s in range(numstates):
        if compact:
            graph, acoustic, n = weight(buf, pos)
            pos += 12 + 4 * n
        else:
            graph, acoustic = weight(buf, pos)
            pos += 8
        if graph != INF or acoustic != INF:
            lat.finals[s] = graph + (acoustic if acoustic != INF else 0.0)
        (narcs,) = int64(buf, pos)
        pos += 8
        for _ in range(narcs):
            if compact:
                il, _ol, g, a, n = arc(buf, pos)
                pos += 20 + 4 * n
            else:
                il, _ol, g, a = arc(buf, pos)
                pos += 16
                n = 0
            (ns,) = int32(buf, pos)
            pos += 4
            word = id2word.get(il, "<eps>") if il else "<eps>"
            links.append((s, ns, word, a, g, n))
    lat.links = [Link(s, ns, word, a, g) for s, ns, word, a, g, _ in links]
    # propagate node times in topological order — external tools may number
    # states non-topologically, so a single pass in file order is not enough
    dur_out = {}
    for s, ns, _w, _a, _g, dur in links:
        dur_out.setdefault(s, []).append((ns, dur))
    for s in lat.topo_order():
        for ns, dur in dur_out.get(s, ()):
            lat.node_times[ns] = max(lat.node_times[ns],
                                     lat.node_times[s] + dur)
    return lat, pos


def read_compact_lattice(f, id2word):
    """Inverse of write_compact_lattice; also accepts 'lattice4' streams
    (no alignment strings — node times fall back to link depth).  Reads
    the rest of ``f`` and leaves it just past the lattice."""
    start = f.tell()
    lat, end = _parse_compact_lattice(f.read(), 0, id2word)
    f.seek(start + end)
    return lat


def write_lattice_ark(lattices, ark_path, word2id, scp_path=None):
    """Kaldi binary CompactLattice table: ``key \\0B`` + fst stream per
    utterance, with an optional offset scp (the lattice-copy
    ``ark,scp:`` writer contract)."""
    abspath = os.path.abspath(ark_path)
    scp = open(scp_path, "w", encoding="utf-8") if scp_path else None
    try:
        with open(ark_path, "wb") as f:
            for lat in lattices:
                if not lat.utt:
                    raise ValueError("lattice has no utterance key")
                f.write(lat.utt.encode("utf-8") + b" ")
                if scp is not None:
                    scp.write(f"{lat.utt} {abspath}:{f.tell()}\n")
                f.write(b"\x00B")
                write_compact_lattice(lat, f, word2id)
    finally:
        if scp is not None:
            scp.close()
    return ark_path


def _lattice_at(buf, pos, id2word, where):
    """The lattice whose ``\\0B`` marker is at ``buf[pos:]``, and the
    offset past it."""
    if buf[pos:pos + 2] != b"\x00B":
        raise ValueError(f"expected binary marker {where}")
    return _parse_compact_lattice(buf, pos + 2, id2word)


def read_lattice_ark(path, id2word):
    """Iterate (key, WordLattice) from a Kaldi binary lattice ark (read
    whole, then parsed in place)."""
    with open(path, "rb") as f:
        buf = f.read()
    pos = 0
    while True:
        space = buf.find(b" ", pos)
        if space < 0:
            return
        key = buf[pos:space]
        lat, pos = _lattice_at(buf, space + 1, id2word,
                               f"after key {key!r}")
        lat.utt = key.decode("utf-8")
        yield lat.utt, lat


def read_lattice_scp(path, id2word):
    """Iterate (key, WordLattice) from a ``key ark:offset`` script of
    binary lattice arks (what ``write_lattice_ark`` writes beside its
    ark), in the script's order; each ark is read once."""
    arks = {}
    with open(path, encoding="utf-8") as scp:
        for line in scp:
            parts = line.split(None, 1)
            if not parts:
                continue
            key, rx = parts[0], parts[1].strip()
            ark, _, offset = rx.rpartition(":")
            if not ark or not offset.isdigit():
                raise ValueError(f"bad lattice scp entry {line!r}")
            if ark not in arks:
                with open(ark, "rb") as f:
                    arks[ark] = f.read()
            lat, _ = _lattice_at(arks[ark], int(offset), id2word,
                                 f"at {rx!r}")
            lat.utt = key
            yield key, lat
