"""Job launcher: the recipes' ``$cuda_cmd`` and ``$train_cmd`` (the JAX
package's ``parallel/launch.py``, in the role of Kaldi's run.pl, queue.pl,
slurm.pl, pbs.pl and ssh.pl), with their uniform CLI contract::

    launch [--max-jobs N] [--retries N] [--resubmit N] [--hosts FILE]
           [--gang] [--backend sge|slurm|pbs [-q QUEUE] [-l RES]...]
           [JOB=1:N] <log-file> <command...>

- ``JOB=1:N`` expands into N jobs with ``JOB`` substituted in the log path
  and arguments (run.pl's array-job contract), at most ``--max-jobs`` at a
  time;
- stdout/stderr of each job is captured into its log file, book-ended by the
  ``# command / # Started / # Ended (code N) / # Accounting`` lines the Kaldi
  log-triage tooling greps for;
- failure of any array element fails the launcher with a run.pl-style
  message; ``--retries N`` re-runs failed jobs, and ``--resubmit N``
  separately re-runs jobs that exit PREEMPT_EXIT_CODE (the trainer
  checkpointed on SIGTERM and asks to continue; pair with its ``-resume``);
- ``--hosts FILE`` (one hostname per line, the .queue/machines shape)
  round-robins array jobs over machines via ssh with the working directory
  preserved and logs collected locally (ssh.pl's role); the ssh binary is
  overridable via $PKA_SSH;
- ``--gang`` runs the array as one gang (the ranks of one
  ``torch.distributed`` world, parallel/multihost.py): any rank failing
  gets the survivors SIGTERMed (a dead rank wedges their collectives;
  preemption-aware trainers checkpoint on TERM) and the WHOLE array
  relaunched on the --retries/--resubmit budgets;
- ``--backend sge|slurm|pbs`` submits the array to a batch scheduler
  instead (queue.pl/slurm.pl/pbs.pl roles) via parallel/batch.py: wrapper
  script + qsub/sbatch + sync-file polling; ``-q QUEUE`` and ``-l RES``
  are forwarded as scheduler resources.
"""

from __future__ import annotations

import os
import re
import shlex
import subprocess
import sys
import time

from pytorch_kaldi_asr_tpu_torch.utils.constants import PREEMPT_EXIT_CODE
from pytorch_kaldi_asr_tpu_torch.utils.logging import log_startup


def _expand(template, job):
    return template.replace("JOB", str(job))


def remote_command(host, command, cwd=None, ssh=None):
    """Build the ssh argv for running ``command`` on ``host`` from the
    current working directory (ssh.pl behavior: cd to cwd first so relative
    data/log paths resolve on the far side)."""
    ssh = ssh or os.environ.get("PKA_SSH", "ssh")
    cwd = cwd or os.getcwd()
    remote = f"cd {shlex.quote(cwd)} && " + " ".join(
        shlex.quote(c) for c in command)
    return shlex.split(ssh) + ["-o", "BatchMode=yes", host, remote]


class _RunningJob:
    """A started array element: Popen handle + open log (gang mode needs
    to kill survivors, so starting and finishing are split)."""

    def __init__(self, proc, log, start, log_file, job):
        self.proc = proc
        self.log = log
        self.start = start
        self.log_file = log_file
        self.job = job

    def finish(self, note=None):
        """Write the Kaldi book-ends once the process has exited."""
        code = self.proc.returncode
        elapsed = time.time() - self.start
        if note:
            self.log.write(f"# {note}\n")
        self.log.write(f"# Accounting: time={int(elapsed)} threads=1\n")
        self.log.write(f"# Ended (code {code}) at "
                       f"{time.ctime()}, elapsed time {elapsed:.0f} "
                       "seconds\n")
        self.log.close()
        return code


def start_job(log_file, command, job=None, host=None):
    """Start one command (locally, or on ``host`` via ssh) with its output
    captured into log_file; returns a :class:`_RunningJob`."""
    if job is not None:
        log_file = _expand(log_file, job)
        command = [_expand(c, job) for c in command]
    if host:
        command = remote_command(host, command)
    os.makedirs(os.path.dirname(os.path.abspath(log_file)), exist_ok=True)
    start = time.time()
    log = open(log_file, "w", encoding="utf-8")
    log.write("# " + " ".join(command) + "\n")
    if host:
        log.write(f"# Running on {host}\n")
    log.write("# Started at " + time.ctime(start) + "\n#\n")
    log.flush()
    try:
        proc = subprocess.Popen(command, stdout=log,
                                stderr=subprocess.STDOUT)
    except Exception:
        log.close()
        raise
    return _RunningJob(proc, log, start, log_file, job)


def run_job(log_file, command, job=None, host=None):
    """Run one command (locally, or on ``host`` via ssh), capturing output
    into log_file with Kaldi-style book-ends.  Returns the exit code."""
    running = start_job(log_file, command, job, host=host)
    running.proc.wait()
    return running.finish()


def run_job_with_retries(log_file, command, job=None, retries=0, host=None,
                         resubmits=0):
    """run_job plus requeue-on-failure (role of queue.pl's remap of
    OOM-killed jobs into the re-runnable state, reference kaldi/queue.pl
    exit-137 handling).

    ``retries`` re-runs plain failures; ``resubmits`` separately re-runs
    jobs that exit PREEMPT_EXIT_CODE (preemptible-pool support: the job
    checkpointed and asked to be resubmitted — not a failure, so it does
    not consume a retry)."""
    code = run_job(log_file, command, job, host=host)
    attempt = resub = 0
    while code != 0:
        if code == PREEMPT_EXIT_CODE:
            if resub >= resubmits:
                break
            resub += 1
        else:
            if attempt >= retries:
                break
            attempt += 1
        code = run_job(log_file, command, job, host=host)
    return code


#: seconds a killed gang survivor gets between SIGTERM and SIGKILL — the
#: TERM window lets a preemption-aware trainer write its checkpoint
GANG_KILL_GRACE = 10.0


def run_gang(log_file, command, jobs, *, hosts=None, retries=0,
             resubmits=0, poll_s=0.2):
    """Run the array as ONE GANG — the multi-host SPMD failure model.

    The reference's schedulers treat array elements as independent; a
    torch.distributed world is not: one dead rank wedges every surviving
    rank inside its next collective.  Gang semantics: if any element
    exits nonzero while others run, SIGTERM the survivors (a
    preemption-aware trainer checkpoints on TERM — recipes/train.py),
    then relaunch the WHOLE array, which resumes from the newest
    checkpoint via the trainer's own ``-resume``.  ``retries`` budgets
    relaunches after failures, ``resubmits`` after preemptions
    (PREEMPT_EXIT_CODE ranks), mirroring run_job_with_retries.

    Returns 0 on a fully-clean attempt, else the first failing code of
    the last attempt."""
    attempt = resub = 0
    while True:
        running = []
        try:
            for i, j in enumerate(jobs):
                running.append(start_job(
                    log_file, command, j,
                    host=hosts[i % len(hosts)] if hosts else None))
        except Exception:
            # a rank failed to even start: don't leave the earlier ranks
            # running headless
            for r in running:
                r.proc.terminate()
            for r in running:
                r.proc.wait()
                r.finish("Gang: killed, a later rank failed to start")
            raise
        first_bad = None
        alive = list(running)
        while alive and first_bad is None:
            time.sleep(poll_s)
            for r in list(alive):
                if r.proc.poll() is None:
                    continue
                alive.remove(r)
                if r.proc.returncode != 0 and first_bad is None:
                    first_bad = r
        if first_bad is not None and alive:
            for r in alive:
                r.proc.terminate()
            deadline = time.time() + GANG_KILL_GRACE
            for r in alive:
                try:
                    r.proc.wait(timeout=max(0.1, deadline - time.time()))
                except subprocess.TimeoutExpired:
                    r.proc.kill()
                    r.proc.wait()
        note = (f"Gang: killed after job {first_bad.job} exited "
                f"{first_bad.proc.returncode}" if first_bad else None)
        codes = []
        for r in running:
            r.proc.wait()
            codes.append(r.finish(note if r in alive else None))
        if all(c == 0 for c in codes):
            return 0
        # Classify (and report) by the INITIATING failure only: survivors
        # the gang itself SIGTERM/SIGKILLed exit -15/-9, and counting
        # those as plain failures would burn the retry budget on what was
        # really a preemption (and mask the root-cause exit code).
        cause = (first_bad.proc.returncode if first_bad
                 else next(c for c in codes if c != 0))
        if cause == PREEMPT_EXIT_CODE:
            if resub >= resubmits:
                return cause
            resub += 1
        else:
            if attempt >= retries:
                return cause
            attempt += 1


def read_hosts(path):
    """One host per line; '#' comments; a host may repeat to receive more
    slots (the .queue/machines convention ssh.pl reads)."""
    hosts = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if line:
                hosts.append(line)
    if not hosts:
        raise SystemExit(f"hosts file {path} is empty")
    return hosts


def launch(argv):
    argv = list(argv)
    max_jobs = 0
    retries = 0
    resubmits = 0
    hosts = None
    backend = None
    queue_name = None
    resources = []
    gang = False
    while argv and (argv[0].startswith("--") or argv[0] in ("-q", "-l")):
        opt = argv.pop(0)
        if opt == "--gang":
            gang = True
        elif opt.startswith("--max-jobs"):
            max_jobs = int(opt.split("=", 1)[1] if "=" in opt else argv.pop(0))
        elif opt.startswith("--retries"):
            retries = int(opt.split("=", 1)[1] if "=" in opt else argv.pop(0))
        elif opt.startswith("--resubmit"):
            resubmits = int(
                opt.split("=", 1)[1] if "=" in opt else argv.pop(0))
        elif opt.startswith("--hosts"):
            hosts = read_hosts(
                opt.split("=", 1)[1] if "=" in opt else argv.pop(0))
        elif opt.startswith("--backend"):
            backend = opt.split("=", 1)[1] if "=" in opt else argv.pop(0)
        elif opt == "-q":  # queue.pl resource flags, honored by --backend
            queue_name = argv.pop(0)
        elif opt == "-l":
            resources.append(argv.pop(0))
        else:
            raise SystemExit(f"unknown option {opt}")

    job_range = None
    m = re.match(r"^(\w+)=(\d+):(\d+)$", argv[0]) if argv else None
    if m:
        if m.group(1) != "JOB":
            raise SystemExit("array variable must be named JOB")
        job_range = range(int(m.group(2)), int(m.group(3)) + 1)
        argv.pop(0)

    if len(argv) < 2:
        raise SystemExit(
            "usage: launch [--max-jobs N] [--backend sge|slurm|pbs] "
            "[JOB=1:N] <log-file> <command...>"
        )
    log_file, command = argv[0], argv[1:]

    if backend:
        from pytorch_kaldi_asr_tpu_torch.parallel import batch

        if gang:
            raise SystemExit("--gang and --backend are mutually exclusive "
                             "(use the scheduler's gang scheduling)")
        if hosts:
            raise SystemExit("--hosts and --backend are mutually exclusive "
                             "(the scheduler owns machine placement)")
        if retries or resubmits:
            raise SystemExit("--retries/--resubmit are not supported with "
                             "--backend: requeueing is the scheduler's job "
                             "(the wrapper already remaps OOM exit 137 to "
                             "the re-runnable code 100)")
        jobs = list(job_range) if job_range is not None else [1]
        failed = batch.submit_and_wait(
            backend, log_file, command, jobs,
            queue=queue_name, resources=resources, max_jobs=max_jobs,
        )
        if failed:
            print(
                f"launch: {failed} / {len(jobs)} failed, log is in "
                f"{_expand(log_file, '*')}",
                file=sys.stderr,
            )
            return 1
        return 0

    if job_range is None:
        if gang:
            raise SystemExit("--gang needs a JOB=1:N array (the gang is "
                             "the set of SPMD ranks)")
        code = run_job_with_retries(log_file, command, retries=retries,
                                    host=hosts[0] if hosts else None,
                                    resubmits=resubmits)
        if code != 0:
            print(f"launch: job failed (code {code}), log is in {log_file}",
                  file=sys.stderr)
        return code

    if gang:
        code = run_gang(log_file, command, list(job_range), hosts=hosts,
                        retries=retries, resubmits=resubmits)
        if code != 0:
            print(
                f"launch: gang failed (code {code}), log is in "
                f"{_expand(log_file, '*')}",
                file=sys.stderr,
            )
            return 1
        return 0

    failed = 0
    jobs = list(job_range)
    limit = max_jobs or len(jobs)
    import concurrent.futures

    with concurrent.futures.ThreadPoolExecutor(max_workers=limit) as pool:
        futures = {
            pool.submit(run_job_with_retries, log_file, command, job,
                        retries,
                        hosts[i % len(hosts)] if hosts else None,
                        resubmits): job
            for i, job in enumerate(jobs)
        }
        for fut in concurrent.futures.as_completed(futures):
            if fut.result() != 0:
                failed += 1
    if failed:
        print(
            f"launch: {failed} / {len(jobs)} failed, log is in "
            f"{_expand(log_file, '*')}",
            file=sys.stderr,
        )
        return 1
    return 0


def main():
    return launch(sys.argv[1:])


if __name__ == "__main__":
    log_startup()
    sys.exit(main())
