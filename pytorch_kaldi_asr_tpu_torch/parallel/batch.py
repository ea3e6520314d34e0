"""Batch-scheduler job submission: the queue.pl / slurm.pl / pbs.pl roles
(the JAX package's ``parallel/batch.py``, whole).

The reference submits every heavy stage to an SGE grid through a locally
modified queue.pl (reference kaldi/queue.pl:366-395): it writes a bash
wrapper that cds to the work dir, sources the project environment, runs
the command with the scheduler's array-task variable bound to ``JOB``,
remaps OOM-kill exit 137 to 100 (the SGE re-runnable marker,
queue.pl:388), and touches an NFS ``sync/done.*`` file the parent polls
for.  slurm.pl/pbs.pl are the same contract over sbatch/qsub.

This module reproduces that design scheduler-agnostically:

- :func:`write_wrapper` emits the wrapper script (cwd + ``./path.sh``
  sourcing + JOB binding + exit-code file + done file — the queue.pl
  wrapper shape);
- :func:`submit` invokes the scheduler's submit binary (``qsub`` /
  ``sbatch``; override with $PKA_QSUB / $PKA_SBATCH / $PKA_PBS_QSUB for
  testing or site wrappers);
- :func:`wait_sync` polls the done files and collects per-task exit codes
  (the NFS-latency-tolerant polling loop).

The local/ssh execution paths live in parallel/launch.py; this is the
path for sites with a real batch system.
"""

from __future__ import annotations

import os
import shlex
import subprocess
import time

# scheduler -> (submit binary env override, default binary, task-id env var)
BACKENDS = {
    "sge": ("PKA_QSUB", "qsub", "SGE_TASK_ID"),
    "slurm": ("PKA_SBATCH", "sbatch", "SLURM_ARRAY_TASK_ID"),
    "pbs": ("PKA_PBS_QSUB", "qsub", "PBS_ARRAYID"),
}


def write_wrapper(qdir, backend, log_file, command, *, cwd=None):
    """Write the array-job wrapper script; returns its path.

    The wrapper binds JOB from the scheduler's task-id variable (or from
    $1 when run outside a scheduler, which is how the tests and the
    fallback local submitter drive it), substitutes JOB into the log path
    and argv, and book-ends the log exactly like parallel/launch.py so
    the log-triage tools work unchanged."""
    env_var = BACKENDS[backend][2]
    cwd = cwd or os.getcwd()
    os.makedirs(qdir, exist_ok=True)
    script = os.path.join(qdir, "job.sh")
    cmd = " ".join(shlex.quote(c) for c in command)
    # JOB substitution happens at runtime via bash ${var//pat/rep}
    with open(script, "w", encoding="utf-8") as f:
        f.write(f"""#!/usr/bin/env bash
# generated by pytorch_kaldi_asr_tpu_torch.parallel.batch ({backend} backend)
JOB="${{{env_var}:-${{1:-1}}}}"
cd {shlex.quote(cwd)} || exit 1
[ -f ./path.sh ] && . ./path.sh
logfile={shlex.quote(log_file)}
logfile="${{logfile//JOB/$JOB}}"
mkdir -p "$(dirname "$logfile")"
cmd={shlex.quote(cmd)}
cmd="${{cmd//JOB/$JOB}}"
{{
  echo "# $cmd"
  echo "# Started at $(date)"
  echo "#"
}} > "$logfile"
start=$(date +%s)
bash -c "$cmd" >> "$logfile" 2>&1
code=$?
# SGE re-runnable marker: remap OOM-kill 137 -> 100 (queue.pl behavior)
if [ $code -eq 137 ]; then code=100; fi
end=$(date +%s)
{{
  echo "# Accounting: time=$((end - start)) threads=1"
  echo "# Ended (code $code) at $(date), elapsed time $((end - start)) seconds"
}} >> "$logfile"
echo $code > {shlex.quote(qdir)}/status.$JOB
touch {shlex.quote(qdir)}/done.$JOB
exit $code
""")
    os.chmod(script, 0o755)
    return script


def submit_argv(backend, script, jobs, *, queue=None, resources=None,
                max_jobs=0):
    """The scheduler submit command line for an array over ``jobs``.
    ``max_jobs`` becomes the scheduler's array-concurrency throttle
    (SGE/PBS ``-tc N``, Slurm ``--array=lo-hi%N``)."""
    env_override, default_bin, _ = BACKENDS[backend]
    binary = os.environ.get(env_override, default_bin)
    argv = shlex.split(binary)
    lo, hi = jobs[0], jobs[-1]
    if backend == "slurm":
        spec = f"--array={lo}-{hi}"
        if max_jobs:
            spec += f"%{max_jobs}"
        argv += [spec, "--output=/dev/null"]
        if queue:
            argv += [f"--partition={queue}"]
        for r in resources or []:
            argv += [r]
    else:  # sge / pbs qsub
        argv += ["-cwd", "-j", "y", "-o", "/dev/null", "-t", f"{lo}:{hi}"]
        if max_jobs:
            argv += ["-tc", str(max_jobs)]
        if queue:
            argv += ["-q", queue]
        for r in resources or []:
            argv += ["-l", r]
    argv.append(script)
    return argv


def wait_sync(qdir, jobs, *, poll=0.5, timeout=None, progress_every=60.0):
    """Poll ``done.N`` files until all jobs finish; return {job: code}.
    Missing status files (a scheduler that lost the job) count as failed
    with code -1 once the done file exists.  ``timeout`` bounds the wait
    (remaining jobs marked failed) — queue.pl detects lost jobs via qstat;
    here the guard is the timeout plus a periodic progress line so a
    scheduler that silently dropped the array never hangs this caller
    invisibly."""
    import sys

    pending = set(jobs)
    deadline = time.time() + timeout if timeout else None
    next_report = time.time() + progress_every
    codes = {}
    while pending:
        for job in sorted(pending):
            if os.path.exists(os.path.join(qdir, f"done.{job}")):
                status = os.path.join(qdir, f"status.{job}")
                try:
                    with open(status, encoding="utf-8") as f:
                        codes[job] = int(f.read().strip() or -1)
                except (OSError, ValueError):
                    codes[job] = -1
                pending.discard(job)
        if not pending:
            break
        now = time.time()
        if deadline and now > deadline:
            print(f"batch: timed out waiting for jobs {sorted(pending)} "
                  f"(no done-files in {qdir})", file=sys.stderr)
            for job in pending:
                codes[job] = -1
            break
        if progress_every and now >= next_report:
            print(f"batch: waiting on {len(pending)} job(s) "
                  f"{sorted(pending)[:8]}... (sync dir {qdir})",
                  file=sys.stderr)
            next_report = now + progress_every
        time.sleep(poll)
    return codes


def submit_and_wait(backend, log_file, command, jobs, *, queue=None,
                    resources=None, qdir=None, poll=0.5, timeout=None,
                    max_jobs=0):
    """queue.pl's full contract: wrapper + submit + sync-file wait.
    Returns the number of failed jobs.  ``timeout`` defaults to
    $PKA_BATCH_TIMEOUT seconds when unset (unbounded without either)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    if timeout is None and os.environ.get("PKA_BATCH_TIMEOUT"):
        timeout = float(os.environ["PKA_BATCH_TIMEOUT"])
    qdir = qdir or os.path.join(
        os.path.dirname(os.path.abspath(log_file.replace("JOB", "1"))), "q")
    os.makedirs(qdir, exist_ok=True)
    # clear stale sync files from a previous run
    for job in jobs:
        for prefix in ("done", "status"):
            try:
                os.remove(os.path.join(qdir, f"{prefix}.{job}"))
            except OSError:
                pass
    script = write_wrapper(qdir, backend, log_file, command)
    argv = submit_argv(backend, script, list(jobs), queue=queue,
                       resources=resources, max_jobs=max_jobs)
    proc = subprocess.run(argv, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"{backend} submit failed ({proc.returncode}): "
            f"{proc.stderr.strip() or proc.stdout.strip()}")
    codes = wait_sync(qdir, list(jobs), poll=poll, timeout=timeout)
    return sum(1 for c in codes.values() if c != 0)
