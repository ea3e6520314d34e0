"""The port's native C++ core: the hybrid decode's host token passing
(``src/latgen.cc``, the port's own copy of the JAX package's
``native/src/latgen.cc``), loaded with ctypes.

:func:`load` builds the library at first use with the host's ``g++`` and
the JAX package's Makefile flags (``-O3 -fPIC -std=c++17 -Wall -shared``)
into ``build/torch_native/`` at the root of the checkout.  The library's
file name carries a hash of the source and the flags, as ``ops/_build.py``
names the CUDA kernels, so an edited source is rebuilt and never confused
with an old build; it is written under a temporary name and moved into
place, so processes that build at once never load a half-written file.
A failed build raises with the compiler's output: nothing falls back to
the Python decoder behind the caller's back (decode/latgen.py takes the
Python token passer only when asked, ``native=False``).

Only the decoder's entry points are bound: ``pka_graph_*`` (a shared,
read-only graph), ``pka_latgen_*`` (one streaming decoder per handle) and
``pka_latlat_*`` (the lattice-generating decode).  ctypes releases the GIL
around each call, so threads decode side by side over one graph.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"
SOURCES = ("latgen.cc",)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")

_lib = None
_lock = threading.Lock()


def library_path():
    """Where the library of the current sources and flags lives."""
    digest = hashlib.sha256()
    for name in SOURCES:
        digest.update((SRC / name).read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libpka_native-{digest.hexdigest()[:16]}.so"


def _compiler():
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("the native latgen core needs a C++ compiler "
                           "(g++) on the host; none was found")
    return cxx


def build():
    """Compile the library unless it is built already.  Returns its path
    and the compiler's output (empty when nothing was compiled); raises
    with that output if the compiler fails."""
    out = library_path()
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}"
                        ".tmp")
    cmd = [_compiler(), *CXX_FLAGS, "-o", str(tmp),
           *(str(SRC / name) for name in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the native latgen core failed "
                           f"({' '.join(cmd)}):\n{log}")
    os.replace(tmp, out)
    return out, log


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
    return lib


def load():
    """The native library as a bound ``ctypes.CDLL``, built first if
    needed (raises if the build fails)."""
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            _lib = _bind(ctypes.CDLL(str(path)))
        return _lib
