"""The port's native C++ core, loaded with ctypes: the port's own copies of
the JAX package's ``native/src`` sources.

- ``src/latgen.cc``: the hybrid decode's host token passing
  (``pka_graph_*``, a shared read-only graph; ``pka_latgen_*``, one
  streaming decoder per handle; ``pka_latlat_*``, the lattice decode).
- ``src/ark_io.cc``: Kaldi matrix headers, matrix reads at scp offsets and
  archive scans (:func:`mat_shape`, :func:`read_mat`, :func:`scan_ark`),
  under ``io/kaldi_io.read_mat`` and ``mat_num_rows`` for binary matrices
  of plain files and under ``tools/feat_to_len``.  Its values are the
  Python readers' bit for bit: CM, CM2 and CM3 decode in double arithmetic
  rounded once to float32, and a DM comes back as float64.
- ``src/edit_distance.cc``: :func:`edit_distance`, under
  ``score/wer.levenshtein_alignment``.
- ``src/cmvn.cc``: :func:`cmvn_accumulate` and :func:`cmvn_apply`, bound
  and called on no path, as in the JAX package.
- ``src/tools_main.cc``: the ``pka-tools`` binary with its links
  ``pka-feat-to-len`` and ``pka-compute-wer`` (:func:`tool_path`).

:func:`load` builds the library at first use with the host's ``g++`` and
the JAX package's Makefile flags plus ``-ffp-contract=off`` (no fused
multiply-add, so the double arithmetic gives numpy's values on every host)
into ``build/torch_native/`` at the root of the checkout;
:func:`tool_path` builds the binary beside it.  Each build's name carries
a hash of its sources and flags, as ``ops/_build.py`` names the CUDA
kernels, so an edited source is rebuilt and never confused with an old
build; each is written under a temporary name and moved into place, so
processes that build at once never load a half-written file.  A failed
build raises with the compiler's output: nothing falls back to Python
behind the caller's back.  ctypes releases the GIL around each call, so
threads decode and read side by side.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "src"
SOURCES = ("latgen.cc", "ark_io.cc", "edit_distance.cc", "cmvn.cc")
TOOL_SOURCES = ("tools_main.cc", "ark_io.cc", "edit_distance.cc")
TOOLS = ("pka-tools", "pka-feat-to-len", "pka-compute-wer")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-ffp-contract=off")
# pka_mat_header_fd's kinds
KINDS = ("FM", "DM", "CM", "CM2", "CM3")

_lib = None
_lock = threading.Lock()


def _hashed(sources, flags):
    digest = hashlib.sha256()
    for name in sources:
        digest.update((SRC / name).read_bytes())
    digest.update(" ".join(flags).encode())
    return digest.hexdigest()[:16]


def _lib_flags():
    return (*CXX_FLAGS, "-shared")


def library_path():
    """Where the library of the current sources and flags lives."""
    return BUILD_DIR / f"libpka_native-{_hashed(SOURCES, _lib_flags())}.so"


def tools_dir():
    """Where ``pka-tools`` and its links of the current sources live."""
    return BUILD_DIR / f"tools-{_hashed(TOOL_SOURCES, CXX_FLAGS)}"


def _compiler():
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("the native core needs a C++ compiler (g++) on "
                           "the host; none was found")
    return cxx


def _tmp_name(path):
    return path.with_name(f"{path.name}.{os.getpid()}."
                          f"{threading.get_ident()}.tmp")


def _compile(flags, sources, out, what):
    cmd = [_compiler(), *flags, "-o", str(out),
           *(str(SRC / name) for name in sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"building {what} failed ({' '.join(cmd)}):\n"
                           f"{log}")
    return log


def build():
    """Compile the library unless it is built already.  Returns its path
    and the compiler's output (None when nothing was compiled); raises
    with that output if the compiler fails."""
    out = library_path()
    if out.exists():
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _tmp_name(out)
    try:
        log = _compile(_lib_flags(), SOURCES, tmp,
                       "the native latgen core and host core")
    except RuntimeError:
        tmp.unlink(missing_ok=True)
        raise
    os.replace(tmp, out)
    return out, log


def build_tools():
    """Compile ``pka-tools`` and make its two links, unless they are built
    already.  Returns their folder and the compiler's output (None when
    nothing was compiled); raises with that output if the compiler
    fails."""
    out = tools_dir()
    if out.exists():
        return out, None
    tmp = _tmp_name(out)
    tmp.mkdir(parents=True)
    try:
        log = _compile(CXX_FLAGS, TOOL_SOURCES, tmp / TOOLS[0], "pka-tools")
    except RuntimeError:
        shutil.rmtree(tmp)
        raise
    for link in TOOLS[1:]:
        os.symlink(TOOLS[0], tmp / link)
    try:
        os.rename(tmp, out)
    except OSError:  # another process moved its build into place first
        shutil.rmtree(tmp)
        if not out.exists():
            raise
    return out, log


def tool_path(name):
    """The path of ``pka-tools``, ``pka-feat-to-len`` or
    ``pka-compute-wer``, built first if needed."""
    if name not in TOOLS:
        raise ValueError(f"no native tool {name!r}; there are {TOOLS}")
    return build_tools()[0] / name


def _bind(lib):
    i32p = ctypes.POINTER(ctypes.c_int32)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.pka_graph_create.argtypes = [
        ctypes.c_int32, ctypes.c_int32, ctypes.POINTER(ctypes.c_int64),
        i32p, i32p, f64p, i32p, f64p,
    ]
    lib.pka_graph_create.restype = ctypes.c_void_p
    lib.pka_graph_destroy.argtypes = [ctypes.c_void_p]
    lib.pka_latgen_create.argtypes = [
        ctypes.c_void_p, ctypes.c_double, ctypes.c_double, ctypes.c_int32,
        f64p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
    ]
    lib.pka_latgen_create.restype = ctypes.c_void_p
    lib.pka_latgen_destroy.argtypes = [ctypes.c_void_p]
    lib.pka_latgen_reset.argtypes = [ctypes.c_void_p]
    lib.pka_latgen_push.argtypes = [ctypes.c_void_p, f64p, ctypes.c_int64,
                                    ctypes.c_int32]
    lib.pka_latgen_dead.argtypes = [ctypes.c_void_p]
    lib.pka_latgen_frames.argtypes = [ctypes.c_void_p]
    lib.pka_latgen_frames.restype = ctypes.c_int64
    lib.pka_latgen_partial.argtypes = [ctypes.c_void_p, i32p,
                                       ctypes.c_int64, f64p]
    lib.pka_latgen_partial.restype = ctypes.c_int64
    lib.pka_latgen_finish.argtypes = [ctypes.c_void_p, i32p, i32p,
                                      ctypes.c_int64, f64p]
    lib.pka_latgen_finish.restype = ctypes.c_int64
    lib.pka_latlat_create.argtypes = [
        ctypes.c_void_p, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_int32, f64p, ctypes.c_int32, ctypes.c_int32,
    ]
    lib.pka_latlat_create.restype = ctypes.c_void_p
    lib.pka_latlat_destroy.argtypes = [ctypes.c_void_p]
    lib.pka_latlat_run.argtypes = [ctypes.c_void_p, f64p, ctypes.c_int64,
                                   ctypes.c_int32]
    lib.pka_latlat_n_nodes.argtypes = [ctypes.c_void_p]
    lib.pka_latlat_n_nodes.restype = ctypes.c_int64
    lib.pka_latlat_node_times.argtypes = [ctypes.c_void_p, i32p]
    lib.pka_latlat_n_links.argtypes = [ctypes.c_void_p]
    lib.pka_latlat_n_links.restype = ctypes.c_int64
    lib.pka_latlat_links.argtypes = [ctypes.c_void_p, i32p, i32p, i32p,
                                     f64p, f64p]
    lib.pka_latlat_n_finals.argtypes = [ctypes.c_void_p]
    lib.pka_latlat_n_finals.restype = ctypes.c_int64
    lib.pka_latlat_finals.argtypes = [ctypes.c_void_p, i32p, f64p]
    # ark_io.cc, edit_distance.cc, cmvn.cc
    lib.pka_mat_header_fd.argtypes = [ctypes.c_int, ctypes.c_long, i32p,
                                      i32p, i32p]
    lib.pka_read_mat_fd.argtypes = [ctypes.c_int, ctypes.c_long,
                                    ctypes.c_void_p, ctypes.c_int32,
                                    ctypes.c_int32, ctypes.c_int]
    lib.pka_scan_ark.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                 ctypes.c_long, i32p, i32p, ctypes.c_int32]
    lib.pka_edit_distance.argtypes = [i32p, ctypes.c_int32, i32p,
                                      ctypes.c_int32, i32p, i32p, i32p, i32p]
    lib.pka_cmvn_accumulate.argtypes = [ctypes.POINTER(ctypes.c_float),
                                        ctypes.c_int32, ctypes.c_int32, f64p]
    lib.pka_cmvn_apply.argtypes = [ctypes.POINTER(ctypes.c_float),
                                   ctypes.c_int32, ctypes.c_int32, f64p,
                                   ctypes.c_int]
    return lib


def load():
    """The native library as a bound ``ctypes.CDLL``, built first if
    needed (raises if the build fails)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            _lib = _bind(ctypes.CDLL(str(path)))
        return _lib


# ---------------------------------------------------------------------------
# ark_io.cc
# ---------------------------------------------------------------------------


def _split_offset(rxfilename):
    """``path:offset`` as (path, offset); a path alone at offset 0.  The
    last colon splits, so a path may hold colons."""
    path, _, off = rxfilename.rpartition(":")
    if off.isdigit() and path:
        return path, int(off)
    return rxfilename, 0


def mat_header_fd(fd, offset, rxfilename=None):
    """(kind, rows, cols) of the binary matrix at ``offset`` of the open
    file ``fd``, from its header alone; kind is one of :data:`KINDS`.
    ``rxfilename`` names it in the error."""
    kind, rows, cols = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
    if load().pka_mat_header_fd(fd, offset, ctypes.byref(kind),
                                ctypes.byref(rows), ctypes.byref(cols)) != 0:
        raise IOError(f"native mat_header: no binary FM, DM, CM, CM2 or CM3 "
                      f"matrix header at {rxfilename or offset}")
    return KINDS[kind.value], rows.value, cols.value


def read_mat_fd(fd, offset, rxfilename=None):
    """The binary matrix at ``offset`` of the open file ``fd``: float32
    for FM, CM, CM2 and CM3, float64 for DM, as ``io/kaldi_io``'s Python
    readers return them and with their values.  The file is read at
    offsets (``pread``), not opened again."""
    kind, rows, cols = mat_header_fd(fd, offset, rxfilename)
    out = np.empty((rows, cols),
                   dtype=np.float64 if kind == "DM" else np.float32)
    if load().pka_read_mat_fd(fd, offset, out.ctypes.data, rows, cols,
                              int(kind == "DM")) != 0:
        raise IOError(f"native read_mat: the {kind} matrix at "
                      f"{rxfilename or offset} is truncated or changed "
                      f"under the read")
    return out


def _opened(rxfilename, fn):
    path, offset = _split_offset(rxfilename)
    fd = os.open(path, os.O_RDONLY)
    try:
        return fn(fd, offset, rxfilename)
    finally:
        os.close(fd)


def mat_header(rxfilename):
    """(kind, rows, cols) of the binary matrix at a plain file's
    rxfilename (``path`` or ``path:offset``), from its header alone."""
    return _opened(rxfilename, mat_header_fd)


def mat_shape(rxfilename):
    """(rows, cols) of the matrix at an rxfilename; header only."""
    return mat_header(rxfilename)[1:]


def read_mat(rxfilename):
    """The binary matrix at a plain file's rxfilename (:func:`read_mat_fd`
    of the file opened once)."""
    return _opened(rxfilename, read_mat_fd)


def scan_ark(path, max_entries=4096):
    """Header-only scan of a whole binary archive: [(key, rows, cols), ...]
    in file order, with one open of the file.  Grows its buffers and scans
    again while the core reports them full; raises on a parse error."""
    lib = load()
    while True:
        keys_buf = ctypes.create_string_buffer(max_entries * 64)
        rows = np.empty(max_entries, np.int32)
        cols = np.empty(max_entries, np.int32)
        count = lib.pka_scan_ark(
            os.fsencode(path), keys_buf, len(keys_buf),
            rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            max_entries)
        if count != -2:
            break
        max_entries *= 4
    if count < 0:
        raise IOError(f"native scan_ark: {path} is not a binary archive of "
                      f"FM, DM, CM, CM2 or CM3 matrices")
    keys = keys_buf.value.decode("utf-8").split("\n")[:count]
    return [(k, int(rows[i]), int(cols[i])) for i, k in enumerate(keys)]


# ---------------------------------------------------------------------------
# edit_distance.cc, cmvn.cc
# ---------------------------------------------------------------------------


def edit_distance(ref_ids, hyp_ids):
    """(errors, ins, dels, subs) over int32 token-id arrays."""
    lib = load()
    i32p = ctypes.POINTER(ctypes.c_int32)
    ref = np.ascontiguousarray(ref_ids, dtype=np.int32)
    hyp = np.ascontiguousarray(hyp_ids, dtype=np.int32)
    counts = [ctypes.c_int32() for _ in range(4)]
    lib.pka_edit_distance(ref.ctypes.data_as(i32p), len(ref),
                          hyp.ctypes.data_as(i32p), len(hyp),
                          *map(ctypes.byref, counts))
    return tuple(c.value for c in counts)


def cmvn_accumulate(mat, stats):
    """Accumulate a float32 [rows, cols] matrix into float64 stats
    [2, cols + 1] (Kaldi's layout), in place; returns ``stats``."""
    lib = load()
    mat = np.ascontiguousarray(mat, dtype=np.float32)
    if stats.shape != (2, mat.shape[1] + 1) or stats.dtype != np.float64 \
            or not stats.flags.c_contiguous:
        raise ValueError(f"cmvn stats must be C-contiguous float64 "
                         f"[2, {mat.shape[1] + 1}], got {stats.dtype} "
                         f"{list(stats.shape)}")
    lib.pka_cmvn_accumulate(
        mat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        mat.shape[0], mat.shape[1],
        stats.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return stats


def cmvn_apply(mat, stats, norm_vars=False):
    """A normalised float32 copy of ``mat``."""
    lib = load()
    out = np.array(mat, dtype=np.float32, order="C")
    stats = np.ascontiguousarray(stats, dtype=np.float64)
    rc = lib.pka_cmvn_apply(
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.shape[0], out.shape[1],
        stats.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        1 if norm_vars else 0)
    if rc != 0:
        raise ValueError("cmvn_apply: the stats count no frame")
    return out
