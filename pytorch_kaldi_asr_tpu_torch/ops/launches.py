"""The kernel wrappers' launch counts, by name, read and reset together.

Each wrapper adds one to its count where it launches its kernel (K1, K2a-c
in ``ops/banded_attention.py``, K3 in ``ops/fused_dropout.py``).  The CLIs
that run kernels log the counts of their process at the end
with the device they ran on (:func:`log_launch_counts`), so a recipe's
launches can be read from its logs."""

from __future__ import annotations

import json

from pytorch_kaldi_asr_tpu_torch.utils.logging import info

ATTENTION_WRAPPERS = ("banded_attention", "banded_attention_fwd",
                      "banded_attention_dq", "banded_attention_dkv")
LOG_RE = r"kernel launches on (\S+): (\{.*\})"


def launch_counts():
    """{name: launches} of every kernel wrapper, the bfloat16
    instantiations under ``<name>_bf16``."""
    from pytorch_kaldi_asr_tpu_torch.ops import banded_attention as ba
    from pytorch_kaldi_asr_tpu_torch.ops import fused_dropout as fd

    counts = {}
    for name in ATTENTION_WRAPPERS:
        fn = getattr(ba, name)
        counts.update({name: fn.launches, f"{name}_bf16": fn.launches_bf16})
    counts.update({f"fused_dropout_{k}": v
                   for k, v in fd.fused_dropout.launches.items()})
    return counts


def reset_launch_counts():
    from pytorch_kaldi_asr_tpu_torch.ops import banded_attention as ba
    from pytorch_kaldi_asr_tpu_torch.ops import fused_dropout as fd

    for name in ATTENTION_WRAPPERS:
        getattr(ba, name).launches = getattr(ba, name).launches_bf16 = 0
    for key in fd.fused_dropout.launches:
        fd.fused_dropout.launches[key] = 0


def log_launch_counts(device):
    """One ``[INFO] kernel launches on <device>: {json}`` line of this
    process's counts (``LOG_RE`` reads it back)."""
    info("kernel launches on %s: %s", device, json.dumps(launch_counts()))
