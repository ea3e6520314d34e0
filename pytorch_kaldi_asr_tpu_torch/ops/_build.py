"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``ops/csrc/<name>.cu`` exposes a plain C interface and is compiled on
its own by ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/torch_kernels/`` at the root of the checkout.  The library's file
name carries a hash of the source and the flags, so an edited source is
rebuilt and never confused with an old build.  :func:`build` starts one
``nvcc`` per source, all at once, and waits for them together.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def kernel_names():
    """Every kernel source of the port, by name."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def library_path(name):
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names=None):
    """Compile every kernel in ``names`` (default: all) that has no current
    library yet, all ``nvcc`` processes in parallel.  Returns ``{name:
    compiler output}`` for the kernels compiled by this call (``-Xptxas
    -v`` prints registers, shared memory and spills)."""
    names = kernel_names() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


@functools.lru_cache(maxsize=None)
def load(name):
    """The library of kernel ``name`` as a ``ctypes.CDLL``, built if
    needed."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))
