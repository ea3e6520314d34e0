"""Job launcher: the recipes' ``$cuda_cmd`` and ``$train_cmd`` (the JAX
package's ``parallel/launch.py``, in the role of Kaldi's run.pl/queue.pl),
with their uniform CLI contract::

    launch [--max-jobs N] [--retries N] [--resubmit N] [JOB=1:N]
           <log-file> <command...>

- ``JOB=1:N`` expands into N jobs with ``JOB`` substituted in the log path
  and arguments (run.pl's array-job contract), at most ``--max-jobs`` at a
  time;
- stdout/stderr of each job is captured into its log file, book-ended by the
  ``# command / # Started / # Ended (code N) / # Accounting`` lines the Kaldi
  log-triage tooling greps for;
- failure of any array element fails the launcher with a run.pl-style
  message; ``--retries N`` re-runs failed jobs, and ``--resubmit N``
  separately re-runs jobs that exit PREEMPT_EXIT_CODE (the trainer
  checkpointed on SIGTERM and asks to continue; pair with its ``-resume``).

The JAX launcher's ``--gang``, ``--hosts`` and ``--backend`` (multi-host
gangs, ssh placement, batch schedulers) are not ported yet: they raise.
"""

from __future__ import annotations

import concurrent.futures
import os
import re
import subprocess
import sys
import time

from pytorch_kaldi_asr_tpu_torch.utils.constants import PREEMPT_EXIT_CODE
from pytorch_kaldi_asr_tpu_torch.utils.logging import log_startup

NOT_PORTED = ("--gang", "--hosts", "--backend", "-q", "-l")


def _expand(template, job):
    return template.replace("JOB", str(job))


def run_job(log_file, command, job=None):
    """Run one command with its output captured into log_file, book-ended
    in Kaldi's style.  Returns the exit code."""
    if job is not None:
        log_file = _expand(log_file, job)
        command = [_expand(c, job) for c in command]
    os.makedirs(os.path.dirname(os.path.abspath(log_file)), exist_ok=True)
    start = time.time()
    with open(log_file, "w", encoding="utf-8") as log:
        log.write("# " + " ".join(command) + "\n")
        log.write("# Started at " + time.ctime(start) + "\n#\n")
        log.flush()
        code = subprocess.run(command, stdout=log,
                              stderr=subprocess.STDOUT).returncode
        elapsed = time.time() - start
        log.write(f"# Accounting: time={int(elapsed)} threads=1\n")
        log.write(f"# Ended (code {code}) at {time.ctime()}, elapsed time "
                  f"{elapsed:.0f} seconds\n")
    return code


def run_job_with_retries(log_file, command, job=None, retries=0,
                         resubmits=0):
    """run_job plus requeue: ``retries`` re-runs plain failures;
    ``resubmits`` separately re-runs jobs that exit PREEMPT_EXIT_CODE (the
    job checkpointed and asked to be resubmitted: not a failure, so it does
    not consume a retry)."""
    code = run_job(log_file, command, job)
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
        code = run_job(log_file, command, job)
    return code


def launch(argv):
    argv = list(argv)
    max_jobs = retries = resubmits = 0
    while argv and (argv[0].startswith("--") or argv[0] in ("-q", "-l")):
        opt = argv.pop(0)
        name = opt.split("=", 1)[0]
        if name in NOT_PORTED:
            raise SystemExit(
                f"launch: {name} is not ported to pytorch_kaldi_asr_tpu_torch "
                "yet (ROADMAP.md, queue 1 item 12: parallelism on "
                "torch.distributed)")
        value = opt.split("=", 1)[1] if "=" in opt else argv.pop(0)
        if name == "--max-jobs":
            max_jobs = int(value)
        elif name == "--retries":
            retries = int(value)
        elif name == "--resubmit":
            resubmits = int(value)
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
            "usage: launch [--max-jobs N] [--retries N] [--resubmit N] "
            "[JOB=1:N] <log-file> <command...>"
        )
    log_file, command = argv[0], argv[1:]

    if job_range is None:
        code = run_job_with_retries(log_file, command, retries=retries,
                                    resubmits=resubmits)
        if code != 0:
            print(f"launch: job failed (code {code}), log is in {log_file}",
                  file=sys.stderr)
        return code

    jobs = list(job_range)
    with concurrent.futures.ThreadPoolExecutor(
            max_workers=max_jobs or len(jobs)) as pool:
        futures = [pool.submit(run_job_with_retries, log_file, command, job,
                               retries, resubmits) for job in jobs]
        failed = sum(1 for fut in futures if fut.result() != 0)
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
