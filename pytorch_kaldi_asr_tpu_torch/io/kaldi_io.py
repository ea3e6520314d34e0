"""Kaldi binary/text archive (ark) and script (scp) I/O, and the table
specifiers (``scp:``, ``ark:``, ``ark,t:``, ``ark,scp:``) of the Kaldi CLI
contract the recipe's tools take.

The port's own copy of ``pytorch_kaldi_asr_tpu.io.kaldi_io`` without the
vectors.  :func:`read_mat` and :func:`mat_num_rows` read a binary matrix
of a plain file through the port's native core (``native/src/ark_io.cc``),
chosen by peeking at the object's header: the ``\\0B`` marker and one of
``FM``, ``DM``, ``CM``, ``CM2``, ``CM3``.  Text objects, pipes and ``-``
take the Python readers, which stay the plain version the core is held
against (:func:`read_mat_python`): the core gives their values bit for
bit, float64 for a DM.  A binary matrix the core cannot read raises; it is
never read again through Python.

Supported object types
----------------------
- ``FM``/``DM``  uncompressed float/double matrices
- ``CM``/``CM2``/``CM3``  compressed matrices, i.e. Kaldi's
  ``CompressedMatrix`` one-byte-with-column-headers / two-byte / one-byte
  formats
- text-mode matrices (``ark,t:``)

Rxfilename handling follows Kaldi: ``path``, ``path:offset`` (offset points
at the object header inside an ark), ``-`` (stdin), and trailing-``|``
command pipes.  :class:`ArkWriter` writes float matrices, binary (also
compressed: CM, CM2, CM3) or text, with an optional paired scp.
"""

from __future__ import annotations

import io as _io
import os
import struct
import subprocess
import sys

import numpy as np

from pytorch_kaldi_asr_tpu_torch import native

_INT_SIZE = b"\x04"  # Kaldi writes a 1-byte size tag before each basic type


# ---------------------------------------------------------------------------
# rxfilename plumbing
# ---------------------------------------------------------------------------


def _split_offset(rxfilename):
    """Split ``path:offset`` into (path, offset).  Offsets are the byte
    position of the object header (the ``\\0B`` marker), exactly as written in
    scp lines produced by Kaldi's ``ark,scp:`` writers."""
    if ":" in rxfilename:
        path, _, off = rxfilename.rpartition(":")
        if off.isdigit() and path and not path.endswith("|"):
            return path, int(off)
    return rxfilename, None


class _PipeReader:
    """File-like over a shell pipe that enforces Kaldi semantics: a nonzero
    command exit status is a hard error (surfaced at close), and the child
    is always reaped."""

    def __init__(self, command):
        self.command = command
        self._proc = subprocess.Popen(command, shell=True,
                                      stdout=subprocess.PIPE)

    def read(self, n=-1):
        return self._proc.stdout.read(n)

    def close(self):
        self._proc.stdout.close()
        code = self._proc.wait()
        if code != 0:
            raise IOError(
                f"pipe command failed with status {code}: {self.command!r}"
            )

    def __getattr__(self, name):  # readable/seekable probes etc.
        return getattr(self._proc.stdout, name)


def open_rx(rxfilename):
    """Open an extended read-filename and return a binary file object."""
    if rxfilename == "-":
        return _io.BytesIO(sys.stdin.buffer.read())
    if rxfilename.endswith("|"):
        return _PipeReader(rxfilename[:-1])
    path, offset = _split_offset(rxfilename)
    f = open(path, "rb")
    if offset is not None:
        f.seek(offset)
    return f


# ---------------------------------------------------------------------------
# low-level binary readers
# ---------------------------------------------------------------------------


def _read_key(f):
    """Read a whitespace-terminated token (the utterance key) from an ark."""
    chars = []
    while True:
        c = f.read(1)
        if not c:  # EOF
            return None
        if c in (b" ", b"\t", b"\n"):
            if chars:
                return b"".join(chars).decode("utf-8")
            continue  # skip leading whitespace
        chars.append(c)


def _expect_binary(f):
    """Consume the two-byte ``\\0B`` binary-mode marker.  Returns
    (is_binary, bytes read) so the text path can reuse the peeked bytes
    (pushing back is impossible on pipes)."""
    b0 = f.read(2)
    if b0 == b"\x00B":
        return True, b""
    return False, b0


def _read_int32(f):
    size = f.read(1)
    if size != _INT_SIZE:
        raise ValueError(f"expected int32 size byte, got {size!r}")
    return struct.unpack("<i", f.read(4))[0]


def _read_token(f):
    tok = []
    while True:
        c = f.read(1)
        if c in (b" ", b""):
            break
        tok.append(c)
    return b"".join(tok).decode("utf-8")


# ---------------------------------------------------------------------------
# compressed matrix decoding (Kaldi CompressedMatrix)
# ---------------------------------------------------------------------------


def _uint16_to_float(value, min_value, prange):
    return min_value + prange * (value.astype(np.float64) / 65535.0)


def _decode_cm1(f, min_value, prange, num_rows, num_cols):
    """``CM``: per-column 4×uint16 percentile headers + uint8 codes,
    stored column-major."""
    col_headers = np.frombuffer(
        f.read(8 * num_cols), dtype="<u2"
    ).reshape(num_cols, 4)
    codes = np.frombuffer(f.read(num_rows * num_cols), dtype=np.uint8).reshape(
        num_cols, num_rows
    )
    p = _uint16_to_float(col_headers, min_value, prange)  # (cols, 4)
    p0, p25, p75, p100 = p[:, 0:1], p[:, 1:2], p[:, 2:3], p[:, 3:4]
    c = codes.astype(np.float64)
    low = p0 + (p25 - p0) * (c / 64.0)
    mid = p25 + (p75 - p25) * ((c - 64.0) / 128.0)
    high = p75 + (p100 - p75) * ((c - 192.0) / 63.0)
    out = np.where(c <= 64, low, np.where(c <= 192, mid, high))
    return out.T.astype(np.float32)


def _decode_cm2(f, min_value, prange, num_rows, num_cols):
    codes = np.frombuffer(f.read(2 * num_rows * num_cols), dtype="<u2")
    out = min_value + prange * (codes.astype(np.float64) / 65535.0)
    return out.reshape(num_rows, num_cols).astype(np.float32)


def _decode_cm3(f, min_value, prange, num_rows, num_cols):
    codes = np.frombuffer(f.read(num_rows * num_cols), dtype=np.uint8)
    out = min_value + prange * (codes.astype(np.float64) / 255.0)
    return out.reshape(num_rows, num_cols).astype(np.float32)


_CM_DECODERS = {"CM": _decode_cm1, "CM2": _decode_cm2, "CM3": _decode_cm3}


# ---------------------------------------------------------------------------
# matrix object readers
# ---------------------------------------------------------------------------


def _read_matrix_binary(f):
    token = _read_token(f)
    if token in ("FM", "DM"):
        rows = _read_int32(f)
        cols = _read_int32(f)
        dtype = "<f4" if token == "FM" else "<f8"
        itemsize = 4 if token == "FM" else 8
        data = f.read(rows * cols * itemsize)
        mat = np.frombuffer(data, dtype=dtype).reshape(rows, cols)
        return np.asarray(mat, dtype=np.float32 if token == "FM" else np.float64)
    if token in _CM_DECODERS:
        min_value, prange = struct.unpack("<ff", f.read(8))
        num_rows, num_cols = struct.unpack("<ii", f.read(8))
        return _CM_DECODERS[token](f, min_value, prange, num_rows, num_cols)
    raise ValueError(f"unsupported matrix token {token!r}")


def _read_matrix_header_binary(f):
    """Read only (rows, cols) without decoding the data."""
    token = _read_token(f)
    if token in ("FM", "DM"):
        rows = _read_int32(f)
        cols = _read_int32(f)
        return rows, cols
    if token in _CM_DECODERS:
        f.read(8)  # min_value, range
        num_rows, num_cols = struct.unpack("<ii", f.read(8))
        return num_rows, num_cols
    raise ValueError(f"unsupported matrix token {token!r}")


def _read_matrix_text(f, first_chunk=b""):
    """Parse a text-mode matrix ``[\\n r0c0 r0c1 ...\\n ... ]``."""
    buf = first_chunk + f.read()
    try:
        text = buf.decode("utf-8")
        lbr = text.index("[")
        rbr = text.index("]")
    except (UnicodeDecodeError, ValueError) as e:
        raise ValueError(
            "stream is neither a binary (\\0B-marked) nor a text-mode Kaldi "
            "matrix — check the rxfilename/offset"
        ) from e
    rows = []
    for line in text[lbr + 1 : rbr].strip().splitlines():
        vals = line.split()
        if vals:
            rows.append([float(v) for v in vals])
    return np.array(rows, dtype=np.float32)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


_NATIVE_TOKENS = (b"FM", b"DM", b"CM", b"CM2", b"CM3")


def _peek_native(rxfilename):
    """(an open descriptor, the offset) of a plain file (not ``-``, not a
    ``...|`` pipe) whose object at ``rxfilename`` starts with the
    ``\\0B`` marker and one of the native core's matrix tokens; else
    None.  The caller closes the descriptor."""
    if rxfilename == "-" or rxfilename.endswith("|"):
        return None
    path, offset = _split_offset(rxfilename)
    fd, native_reads = os.open(path, os.O_RDONLY), False
    try:
        head = os.pread(fd, 6, offset or 0)  # the marker and "CM2 "
        token, space, _ = head[2:].partition(b" ")
        native_reads = (head[:2] == b"\x00B" and bool(space)
                        and token in _NATIVE_TOKENS)
        return (fd, offset or 0) if native_reads else None
    finally:
        if not native_reads:
            os.close(fd)


def native_object(rxfilename):
    """Whether the object at ``rxfilename`` is one the native core reads:
    a plain file's binary FM, DM, CM, CM2 or CM3 matrix."""
    peeked = _peek_native(rxfilename)
    if peeked is not None:
        os.close(peeked[0])
    return peeked is not None


def read_mat(rxfilename):
    """Read a single matrix from an extended filename: through the native
    core where the object's header says it reads it (the file opened once
    for the peek and the read), else :func:`read_mat_python`; the same
    values either way."""
    peeked = _peek_native(rxfilename)
    if peeked is None:
        return read_mat_python(rxfilename)
    fd, offset = peeked
    try:
        return native.read_mat_fd(fd, offset, rxfilename)
    finally:
        os.close(fd)


def read_mat_python(rxfilename):
    """:func:`read_mat` through the Python readers alone (the plain
    version of the native core's read)."""
    f = open_rx(rxfilename)
    try:
        is_binary, peeked = _expect_binary(f)
        if is_binary:
            return _read_matrix_binary(f)
        return _read_matrix_text(f, peeked)
    finally:
        f.close()


def mat_num_rows(rxfilename):
    """Number of rows (frames) of a matrix, without decoding the data
    (the per-utterance work of Kaldi's ``feat-to-len``): from the native
    core's header read where the object's header says it reads it."""
    peeked = _peek_native(rxfilename)
    if peeked is not None:
        fd, offset = peeked
        try:
            return native.mat_header_fd(fd, offset, rxfilename)[1]
        finally:
            os.close(fd)
    f = open_rx(rxfilename)
    try:
        is_binary, peeked = _expect_binary(f)
        if is_binary:
            return _read_matrix_header_binary(f)[0]
        return _read_matrix_text(f, peeked).shape[0]
    finally:
        f.close()


def scp_entries(scp_rxfilename):
    """Iterate ``(key, rxfilename)`` lines of an scp file."""
    f = open_rx(scp_rxfilename)
    try:
        for line in _io.TextIOWrapper(f, encoding="utf-8"):
            # split once: rxfilenames may contain spaces (command pipes,
            # 'gunzip -c x.gz |')
            parts = line.strip().split(None, 1)
            if len(parts) == 2:
                yield parts[0], parts[1]
    finally:
        f.close()


def read_mat_scp(scp_rxfilename):
    """Iterate ``(key, matrix)`` over an scp."""
    for key, rxfilename in scp_entries(scp_rxfilename):
        yield key, read_mat(rxfilename)


def read_mat_ark(rxfilename):
    """Iterate ``(key, matrix)`` over a (binary or text) archive."""
    f = open_rx(rxfilename)
    try:
        while True:
            key = _read_key(f)
            if key is None:
                return
            is_binary, peeked = _expect_binary(f)
            if is_binary:
                yield key, _read_matrix_binary(f)
            else:
                # text archives interleave "key [ ... ]" records: read up to
                # the closing bracket only, and serve the rest first next
                chunks = [peeked]
                while b"]" not in chunks[-1]:
                    c = f.read(4096)
                    if not c:
                        break
                    chunks.append(c)
                data = b"".join(chunks)
                end = data.index(b"]") + 1
                yield key, _read_matrix_text(_io.BytesIO(data[:end]))
                f = _Concat(data[end:], f)
    finally:
        f.close()


class _Concat:
    """Minimal file-like that serves buffered bytes before the wrapped file."""

    def __init__(self, head, f):
        self._head = head
        self._f = f

    def read(self, n=-1):
        if self._head:
            if n < 0 or n >= len(self._head):
                out, self._head = self._head, b""
                if n < 0:
                    return out + self._f.read()
                return out + self._f.read(n - len(out))
            out, self._head = self._head[:n], self._head[n:]
            return out
        return self._f.read(n)

    def close(self):
        self._f.close()


def read_key_value_text(path, value_type=str):
    """Read a ``key value...`` text table (feats.length, utt2spk, text)."""
    out = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if value_type is str:
                # may be empty (an empty decode hypothesis)
                out[parts[0]] = " ".join(parts[1:])
            elif len(parts) < 2:
                raise ValueError(
                    f"{path}: key {parts[0]!r} has no value (expected "
                    f"{value_type.__name__})"
                )
            else:
                out[parts[0]] = value_type(parts[1])
    return out


def write_key_value_text(path, table):
    """Write a ``key value`` text table in key order of the mapping."""
    with open(path, "w", encoding="utf-8") as f:
        for key, value in table.items():
            f.write(f"{key} {value}\n")


# ---------------------------------------------------------------------------
# rspecifiers / wspecifiers
# ---------------------------------------------------------------------------


def parse_specifier(spec):
    """Split 'ark,t:path' → (kind, {options}, path).  kind ∈ {ark, scp}."""
    head, _, path = spec.partition(":")
    if not path:
        raise ValueError(f"not a table specifier: {spec!r}")
    parts = head.split(",")
    kind = parts[0]
    if kind not in ("ark", "scp"):
        raise ValueError(f"unsupported specifier kind {kind!r} in {spec!r}")
    return kind, set(parts[1:]), path


def read_table(rspecifier):
    """Iterate (key, matrix) from an rspecifier ('scp:f', 'ark:f')."""
    kind, _opts, path = parse_specifier(rspecifier)
    if kind == "scp":
        return read_mat_scp(path)
    return read_mat_ark(path)


def open_writer(wspecifier, compress=False):
    """An :class:`ArkWriter` for a wspecifier: 'ark:f', 'ark,t:f' or
    'ark,scp:f.ark,f.scp'.  ``compress`` is passed through to ArkWriter
    (False | True=CM2 | 'CM' | 'CM2' | 'CM3'); ignored in text mode the
    same way Kaldi's --compress is."""
    head, _, rest = wspecifier.partition(":")
    parts = head.split(",")
    if parts[0] != "ark":
        raise ValueError(f"unsupported wspecifier {wspecifier!r}")
    text = "t" in parts[1:]
    if text:
        compress = False
    if "scp" in parts[1:]:
        ark_path, _, scp_path = rest.partition(",")
        if not scp_path:
            raise ValueError(
                f"ark,scp wspecifier needs two paths: {wspecifier!r}")
        return ArkWriter(ark_path, scp_path, text=text, compress=compress)
    return ArkWriter(rest, text=text, compress=compress)


# ---------------------------------------------------------------------------
# writers
# ---------------------------------------------------------------------------


def _matrix_binary_bytes(mat):
    mat = np.asarray(mat)
    if mat.dtype == np.float64:
        token, data = b"DM ", mat.astype("<f8")
    else:
        token, data = b"FM ", mat.astype("<f4")
    out = [token]
    for dim in mat.shape:
        out.append(_INT_SIZE)
        out.append(struct.pack("<i", dim))
    out.append(data.tobytes())
    return b"".join(out)


def _compressed_matrix_bytes(mat):
    """Kaldi CM2 encoding (two-byte codes with a global min/range): the
    simple compressed format, ~2x smaller feature arks, max quantization
    error range/65535."""
    mat = np.asarray(mat, dtype=np.float32)
    mn = float(mat.min()) if mat.size else 0.0
    mx = float(mat.max()) if mat.size else 0.0
    rg = max(mx - mn, 1e-10)
    codes = np.round((mat - mn) / rg * 65535.0).astype("<u2")
    return (
        b"CM2 "
        + struct.pack("<ff", mn, rg)
        + struct.pack("<ii", mat.shape[0], mat.shape[1])
        + codes.tobytes()
    )


def _compressed_matrix_bytes_cm3(mat):
    """Kaldi CM3 encoding (one-byte codes with a global min/range): 4x
    smaller feature arks, max quantization error range/255."""
    mat = np.asarray(mat, dtype=np.float32)
    mn = float(mat.min()) if mat.size else 0.0
    mx = float(mat.max()) if mat.size else 0.0
    rg = max(mx - mn, 1e-10)
    codes = np.round((mat - mn) / rg * 255.0).astype(np.uint8)
    return (
        b"CM3 "
        + struct.pack("<ff", mn, rg)
        + struct.pack("<ii", mat.shape[0], mat.shape[1])
        + codes.tobytes()
    )


def _compressed_matrix_bytes_cm1(mat):
    """Kaldi CM encoding (the default CompressedMatrix format): per-column
    4x-uint16 percentile headers (p0/p25/p75/p100 quantized against a
    global min/range) + one-byte codes on a piecewise scale, stored
    column-major.  Mirrors CompressedMatrix::ComputeColHeader/FloatToChar
    (percentiles at row indices 0, n/4, 3n/4, n-1 with the forced
    one-step separation in the uint16 domain), so Kaldi tools decode the
    stream exactly as :func:`_decode_cm1` does."""
    mat = np.asarray(mat, dtype=np.float32)
    rows, cols = mat.shape
    mn = float(mat.min()) if mat.size else 0.0
    mx = float(mat.max()) if mat.size else 0.0
    rg = max(mx - mn, 1e-10)
    srt = np.sort(mat, axis=0)  # per-column ascending, (rows, cols)
    if rows >= 5:
        q = rows // 4
        pf = srt[[0, q, 3 * q, rows - 1], :]  # (4, cols) float percentiles
    elif rows > 0:
        # short columns: degenerate percentiles from whatever rows exist
        idx = [0, min(1, rows - 1), min(2, rows - 1), rows - 1]
        pf = srt[idx, :]
    else:  # empty matrix: headers only, no codes
        pf = np.zeros((4, cols), np.float32)
    pq = np.clip(np.round((pf - mn) / rg * 65535.0), 0, 65535).astype(np.int64)
    # force p0 < p25 < p75 < p100 by >=1 uint16 step (Kaldi's clamps)
    p0 = np.minimum(pq[0], 65532)
    p25 = np.minimum(np.maximum(pq[1], p0 + 1), 65533)
    p75 = np.minimum(np.maximum(pq[2], p25 + 1), 65534)
    p100 = np.maximum(pq[3], p75 + 1)
    headers = np.stack([p0, p25, p75, p100], axis=1).astype("<u2")  # (cols,4)
    # dequantized breakpoints actually used by the decoder
    d = mn + rg * (headers.astype(np.float64) / 65535.0)  # (cols, 4)
    b0, b25, b75, b100 = d[:, 0], d[:, 1], d[:, 2], d[:, 3]
    v = mat.astype(np.float64).T  # (cols, rows), column-major like the codes
    low = np.round(64.0 * (v - b0[:, None]) / (b25 - b0)[:, None])
    midv = 64.0 + np.round(128.0 * (v - b25[:, None]) / (b75 - b25)[:, None])
    high = 192.0 + np.round(63.0 * (v - b75[:, None]) / (b100 - b75)[:, None])
    codes = np.where(
        v < b25[:, None],
        np.clip(low, 0, 64),
        np.where(v < b75[:, None], np.clip(midv, 64, 192),
                 np.clip(high, 192, 255)),
    ).astype(np.uint8)
    return (
        b"CM "
        + struct.pack("<ff", mn, rg)
        + struct.pack("<ii", rows, cols)
        + headers.tobytes()
        + codes.tobytes()
    )


_COMPRESSORS = {
    "CM": _compressed_matrix_bytes_cm1,
    "CM2": _compressed_matrix_bytes,
    "CM3": _compressed_matrix_bytes_cm3,
}


class ArkWriter:
    """Write an archive of matrices, binary or text (``text=True``, the
    ``ark,t:`` form), optionally with a paired scp (the
    ``ark,scp:foo.ark,foo.scp`` contract); ``compress`` (False | True=CM2 |
    'CM' | 'CM2' | 'CM3') writes binary matrices in Kaldi's compressed
    formats::

        with ArkWriter("feats.ark", "feats.scp") as w:
            w.write("utt1", mat1)
    """

    def __init__(self, ark_path, scp_path=None, text=False, compress=False):
        if compress is True:
            compress = "CM2"
        if compress and compress not in _COMPRESSORS:
            raise ValueError(f"unknown compression method {compress!r}")
        self.compress = compress
        self.ark_path = os.path.abspath(ark_path)
        self._ark = open(ark_path, "wb")
        self._scp = open(scp_path, "w", encoding="utf-8") if scp_path else None
        self.text = text

    def write(self, key, mat):
        mat = np.asarray(mat)
        if mat.ndim != 2:
            raise ValueError("ArkWriter writes 2-D matrices only")
        self._ark.write(key.encode("utf-8") + b" ")
        offset = self._ark.tell()
        if self.text:
            lines = "\n  ".join(" ".join(f"{v:g}" for v in row)
                                for row in mat)
            self._ark.write(f"[\n  {lines} ]\n".encode("utf-8"))
        else:
            self._ark.write(b"\x00B")
            self._ark.write(_COMPRESSORS[self.compress](mat) if self.compress
                            else _matrix_binary_bytes(mat))
        if self._scp is not None:
            self._scp.write(f"{key} {self.ark_path}:{offset}\n")

    def close(self):
        self._ark.close()
        if self._scp is not None:
            self._scp.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
