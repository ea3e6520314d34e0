"""Prefixed logging in the reference's house style.

The reference logs with ``[INFO]/[PROCEDURE]/[WARNING]/[ERROR]`` prefixes on
stdout (e.g. train.py:222-263); recipe logs are greppable by these tags, and
``summarize_warnings.pl``-style triage relies on them.  We keep the format but
route through ``logging`` so structured handlers can be attached.
"""

import logging
import os
import sys
import time
from contextlib import contextmanager

_logger = logging.getLogger("pytorch_kaldi_asr_tpu_torch")
if not _logger.handlers:
    _handler = logging.StreamHandler(sys.stdout)
    _handler.setFormatter(logging.Formatter("%(message)s"))
    _logger.addHandler(_handler)
    _logger.setLevel(logging.INFO)
    # own handler only: with propagate=True a configured root logger would
    # emit every [INFO]/[WARNING] line twice
    _logger.propagate = False


# the line log_startup writes: the CLI's module and its start-up seconds
STARTUP_RE = r"\[INFO\] (\S+) started in ([0-9.]+) s"


def quiet():
    """Log warnings and errors only (the ranks of a world other than 0)."""
    _logger.setLevel(logging.WARNING)


def info(msg, *args):
    _logger.info("[INFO] " + (msg % args if args else msg))


def procedure(msg, *args):
    _logger.info("[PROCEDURE] " + (msg % args if args else msg))


def warning(msg, *args):
    _logger.warning("[WARNING] " + (msg % args if args else msg))


def error(msg, *args):
    _logger.error("[ERROR] " + (msg % args if args else msg))


@contextmanager
def timed(label):
    """Wall-clock timer context; logs ``[INFO] <label>: elapse X.XX min``."""
    start = time.time()
    yield
    info("%s: elapse %3.2f min", label, (time.time() - start) / 60.0)


def process_seconds():
    """Wall seconds since this process started, from Linux's ``/proc``
    (10 ms ticks), or None where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            # field 22, starttime, counted after the parenthesised name
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return None
    return uptime - start / os.sysconf("SC_CLK_TCK")


def log_startup():
    """``[INFO] <module> started in X s`` on stderr (a CLI's stdout is often
    its result file): the wall seconds from the process's start to now, the
    interpreter's start-up and the CLI's imports.  Each CLI calls it in its
    ``__main__`` block, just before ``main()``; STARTUP_RE reads it back."""
    seconds = process_seconds()
    if seconds is None:
        return
    spec = getattr(sys.modules["__main__"], "__spec__", None)
    name = (spec.name.rsplit(".", 1)[-1] if spec
            else os.path.splitext(os.path.basename(sys.argv[0]))[0])
    print(f"[INFO] {name} started in {seconds:.2f} s", file=sys.stderr,
          flush=True)
