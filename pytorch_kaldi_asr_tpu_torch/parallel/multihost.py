"""Joining a ``torch.distributed`` world: one process per rank (the JAX
package's ``parallel/multihost.py``).

The JAX package's one process spans its host's devices and joins a
multi-host runtime through ``jax.distributed.initialize``.  Here every rank
is a process of its own, the idiom of ``torch.distributed``, and the world
is joined through a ``tcp://`` rendezvous read from the JAX package's
environment: ``PKA_COORDINATOR`` (host:port), ``PKA_NUM_PROCESSES`` and
``PKA_PROCESS_ID`` (e.g. exported by a cluster scheduler), or the explicit
arguments.  One process is a no-op, as in the JAX package.

The backend is the one choice ``torch.distributed`` forces that JAX's
runtime does not: ``nccl`` for a CUDA device, ``gloo`` for the CPU, never
switched silently.  ``gloo`` also takes CUDA tensors for the two
collectives the port issues (``all_reduce`` and ``broadcast``,
parallel/collectives.py), so several ranks can share one card under it.
A rank's device is ``cuda:(local_rank % torch.cuda.device_count())``;
NCCL refuses two ranks on one card, so that layout raises before the
world is joined.

:func:`spawn_local` starts the ranks of a world on this host, one process
each, and fails them together: the first rank to exit non-zero gets the
others terminated (``GANG_KILL_GRACE``), as the launcher's ``--gang``
does, and raises.
"""

from __future__ import annotations

import datetime
import os
import signal
import socket
import subprocess
import time

import torch
import torch.distributed as dist

from pytorch_kaldi_asr_tpu_torch.utils.logging import info

#: seconds a collective may wait for its peers before the rank fails
COLLECTIVE_TIMEOUT_S = 600.0
#: seconds a surviving rank gets between SIGTERM and SIGKILL
GANG_KILL_GRACE = 10.0


def _env_int(name):
    value = os.environ.get(name)
    return int(value) if value else None


def default_backend(device):
    """``nccl`` for a CUDA device, ``gloo`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(device, local_rank):
    """This rank's device: ``cuda:(local_rank % device_count)`` for a CUDA
    ``device``, the CPU for ``cpu``."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass -device cpu to run on the CPU")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def check_backend(backend, device, local_world):
    """Raise where ``backend`` cannot run ``local_world`` ranks of this
    host on ``device``: NCCL with more ranks than cards, or NCCL off the
    card."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: nccl or gloo")
    device = torch.device(device)
    if backend != "nccl":
        return
    if device.type != "cuda":
        raise ValueError("the nccl backend runs on CUDA devices; use gloo "
                         "on the CPU")
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if local_world > cards:
        raise ValueError(
            f"nccl would put {local_world} ranks on {cards} card(s), and "
            "NCCL refuses two ranks on one card: use the gloo backend "
            "(-dist_backend gloo), or as many cards as ranks")


def initialize(coordinator=None, num_processes=None, process_id=None, *,
               backend=None, device=None):
    """Join the world; a no-op for one process.  Returns (rank,
    world_size).  ``device`` (default: the CPU) picks the default
    ``backend`` and, for ``nccl``, the card this rank binds."""
    coordinator = coordinator or os.environ.get("PKA_COORDINATOR")
    num_processes = num_processes or _env_int("PKA_NUM_PROCESSES")
    process_id = process_id if process_id is not None else _env_int(
        "PKA_PROCESS_ID")
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if not (num_processes and num_processes > 1):
        return 0, 1
    if coordinator is None or process_id is None:
        raise ValueError("a world of several processes needs a coordinator "
                         "(PKA_COORDINATOR) and this process's id "
                         "(PKA_PROCESS_ID)")
    device = torch.device(device or "cpu")
    backend = backend or default_backend(device)
    local_world = _env_int("PKA_LOCAL_WORLD_SIZE") or num_processes
    local_rank = _env_int("PKA_LOCAL_RANK")
    local_rank = process_id if local_rank is None else local_rank
    check_backend(backend, device, local_world)
    if backend == "nccl":
        torch.cuda.set_device(rank_device(device, local_rank))
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    info("joined distributed world: rank %d / %d, backend %s, device %s",
         dist.get_rank(), dist.get_world_size(), backend,
         rank_device(device, local_rank))
    return dist.get_rank(), dist.get_world_size()


def shard_for_process(items, process_index=None, process_count=None):
    """Deterministic per-process slice of a work list, truncated to a
    common length: every rank MUST execute the same number of steps (a rank
    with one extra batch would enter a collective the others never reach
    and deadlock the world), so the ragged remainder is dropped."""
    if process_index is None:
        process_index = dist.get_rank() if dist.is_initialized() else 0
    if process_count is None:
        process_count = (dist.get_world_size() if dist.is_initialized()
                         else 1)
    per_host = len(items) // process_count
    dropped = len(items) - per_host * process_count
    if dropped:
        info("shard_for_process: dropping %d ragged items so all %d hosts "
             "run equal step counts", dropped, process_count)
    start = process_index * per_host
    return items[start : start + per_host]


def free_port():
    """A free TCP port on localhost for the rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def world_env(rank, world_size, port, env=None):
    """The environment of ``rank`` in a world of ``world_size`` processes
    on this host, meeting at localhost:``port``; one thread per rank."""
    env = dict(os.environ if env is None else env)
    env.update(PKA_COORDINATOR=f"127.0.0.1:{port}",
               PKA_NUM_PROCESSES=str(world_size), PKA_PROCESS_ID=str(rank),
               PKA_LOCAL_RANK=str(rank),
               PKA_LOCAL_WORLD_SIZE=str(world_size), OMP_NUM_THREADS="1")
    return env


def spawn_local(argv, world_size, *, timeout=None, poll_s=0.1):
    """Run ``argv`` as the ``world_size`` ranks of one world on this host
    (each rank's environment from :func:`world_env`; output inherited) and
    wait for all.  The first rank to exit non-zero, or the ``timeout`` in
    seconds, gets every other rank terminated and raises RuntimeError."""
    port = free_port()
    procs = [subprocess.Popen(argv, env=world_env(r, world_size, port))
             for r in range(world_size)]
    deadline = None if timeout is None else time.time() + timeout
    failed = None
    try:
        while failed is None and any(p.poll() is None for p in procs):
            failed = next((r for r, p in enumerate(procs)
                           if p.poll() not in (None, 0)), None)
            if deadline is not None and time.time() > deadline:
                failed = "timeout"
            if failed is None:
                time.sleep(poll_s)
        if failed is None:
            failed = next((r for r, p in enumerate(procs)
                           if p.returncode != 0), None)
    finally:
        alive = [p for p in procs if p.poll() is None]
        for p in alive:
            p.send_signal(signal.SIGTERM)
        end = time.time() + GANG_KILL_GRACE
        for p in alive:
            try:
                p.wait(timeout=max(0.1, end - time.time()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    if failed == "timeout":
        raise RuntimeError(f"{world_size} ranks did not finish in "
                           f"{timeout} s; all were stopped")
    if failed is not None:
        raise RuntimeError(f"rank {failed} of {world_size} exited with code "
                           f"{procs[failed].returncode}; the other ranks "
                           "were stopped")
