"""Kaldi binary/text archive (ark) and script (scp) reading, plus a plain
binary ark writer.

The port's own copy of the read side of ``pytorch_kaldi_asr_tpu.io.kaldi_io``
(pure Python; the JAX package's ctypes parser in ``native/`` stays its own).

Supported object types
----------------------
- ``FM``/``DM``  uncompressed float/double matrices
- ``CM``/``CM2``/``CM3``  compressed matrices, i.e. Kaldi's
  ``CompressedMatrix`` one-byte-with-column-headers / two-byte / one-byte
  formats
- text-mode matrices (``ark,t:``)

Rxfilename handling follows Kaldi: ``path``, ``path:offset`` (offset points
at the object header inside an ark), ``-`` (stdin), and trailing-``|``
command pipes.  :class:`ArkWriter` writes uncompressed binary float
matrices, with an optional paired scp.
"""

from __future__ import annotations

import io as _io
import os
import struct
import subprocess
import sys

import numpy as np

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


def read_mat(rxfilename):
    """Read a single matrix from an extended filename."""
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
    (the per-utterance work of Kaldi's ``feat-to-len``)."""
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


# ---------------------------------------------------------------------------
# writer
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


class ArkWriter:
    """Write a binary archive of uncompressed matrices, optionally with a
    paired scp (the ``ark,scp:foo.ark,foo.scp`` contract)::

        with ArkWriter("feats.ark", "feats.scp") as w:
            w.write("utt1", mat1)
    """

    def __init__(self, ark_path, scp_path=None):
        self.ark_path = os.path.abspath(ark_path)
        self._ark = open(ark_path, "wb")
        self._scp = open(scp_path, "w", encoding="utf-8") if scp_path else None

    def write(self, key, mat):
        mat = np.asarray(mat)
        if mat.ndim != 2:
            raise ValueError("ArkWriter writes 2-D matrices only")
        self._ark.write(key.encode("utf-8") + b" ")
        offset = self._ark.tell()
        self._ark.write(b"\x00B")
        self._ark.write(_matrix_binary_bytes(mat))
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
