"""Device selection for the entry points: CUDA unless the caller asks for
the CPU, and never a silent fall back from one to the other."""

from __future__ import annotations

import torch


def resolve_device(name="cuda"):
    """``torch.device`` for ``name`` ('cuda', 'cuda:N' or 'cpu').  Raises
    when CUDA is asked for and no card is visible."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass -device cpu to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}")
    return device


def disable_tf32():
    """Keep float32 matmuls and convolutions in full float32 on the card
    (cuDNN convolutions default to TF32), and bfloat16 matmuls summing in
    float32: cuBLAS may otherwise reduce a bfloat16 GEMM in reduced
    precision (``allow_bf16_reduced_precision_reduction`` defaults to True),
    where XLA, and so the JAX reference, accumulates in float32.  The port
    is held to the JAX reference at float32 tolerances, and in bfloat16
    compute to the reference's bfloat16 rounding points."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
