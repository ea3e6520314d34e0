"""Starting a world of the port's parallel tests: gloo ranks of
tests/torch_parallel_worker.py, started through the port's own launcher
(``launch --gang JOB=1:N``), one thread each."""

import os
import signal
import subprocess
import sys
from pathlib import Path

import torch

from pytorch_kaldi_asr_tpu_torch.parallel.multihost import free_port

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "torch_parallel_worker.py"


def run_world(suite, n, work, inputs=None, timeout=300, device="cpu"):
    """Run ``suite`` on ``n`` ranks in ``work`` (the cases ``inputs``; the
    ranks' tensors on ``device``); returns every rank's results, rank
    order."""
    work = Path(work)
    work.mkdir(parents=True, exist_ok=True)
    if inputs is not None:
        torch.save(inputs, work / "inputs.pt")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "pytorch_kaldi_asr_tpu_torch.parallel.launch",
         "--gang", f"JOB=1:{n}", str(work / "log.JOB"), sys.executable,
         str(WORKER), suite, "JOB", str(n), str(free_port()), str(work),
         device],
        env=env, cwd=str(REPO), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        _, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:  # the launcher and every rank
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    logs = "\n".join((work / f"log.{j}").read_text()
                     for j in range(1, n + 1) if (work / f"log.{j}").exists())
    assert proc.returncode == 0, err + logs
    for r in range(n):
        assert f"PARALLEL_WORKER_OK {suite} {r}/{n}" in logs, logs
    return [torch.load(work / f"out.{r}.pt", weights_only=False)
            for r in range(n)]
