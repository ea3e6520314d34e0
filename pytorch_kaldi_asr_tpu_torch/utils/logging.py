"""Prefixed logging in the reference's house style.

The reference logs with ``[INFO]/[PROCEDURE]/[WARNING]/[ERROR]`` prefixes on
stdout (e.g. train.py:222-263); recipe logs are greppable by these tags, and
``summarize_warnings.pl``-style triage relies on them.  We keep the format but
route through ``logging`` so structured handlers can be attached.
"""

import logging
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
