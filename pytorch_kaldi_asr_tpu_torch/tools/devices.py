"""Accelerator inventory (the port's ``pytorch_kaldi_asr_tpu.tools.devices``;
the role of the reference's nvidia-smi scraper, pytorch/utils/get_gpu.py).
Lists the CUDA devices torch sees: id, platform ``gpu``, kind (the card's
name), process (this process's ``torch.distributed`` rank, 0 outside a
group), and the card's memory from ``torch.cuda.mem_get_info``: bytes in
use (by every process on the card) and the card's total.  The CPU is not
listed: where there is no card the list is empty and the CLI says so and
exits 1.

Usage: python -m pytorch_kaldi_asr_tpu_torch.tools.devices
"""

from __future__ import annotations

import sys


def available_devices():
    """List of dicts describing the attached CUDA devices."""
    import torch

    if not torch.cuda.is_available():
        return []
    process = 0
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        process = torch.distributed.get_rank()
    out = []
    for i in range(torch.cuda.device_count()):
        free, total = torch.cuda.mem_get_info(i)
        out.append({"id": i, "platform": "gpu",
                    "kind": torch.cuda.get_device_name(i),
                    "process": process, "bytes_in_use": total - free,
                    "bytes_limit": total})
    return out


def main(argv=None):
    devices = available_devices()
    if not devices:
        print("devices: no CUDA device is visible", file=sys.stderr)
        return 1
    for entry in devices:
        print(entry)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
