"""The fused-dropout kernels as written for the card (K3 in
pytorch_kaldi_asr_tpu_torch/ops/csrc/fused_dropout.cu, float32 and
bfloat16), compiled on the CPU with g++ against tests/cuda_emu.h and held
bit for bit against the port's plain version: the same Philox words at the
same flat index, the float32 product rounded once (to bfloat16 with the
round-to-nearest-even of ``__float2bfloat16_rn``), the 16-byte groups and
the scalar tail.  Skips where there is no g++.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from pytorch_kaldi_asr_tpu_torch.ops import fused_dropout as fd

SOURCE = Path(fd.__file__).resolve().parent / "csrc" / "fused_dropout.cu"


def _emulated_source(src):
    """The .cu with its includes and launches routed to cuda_emu.h."""
    src = src.replace("#include <cuda_bf16.h>\n", "")
    src = src.replace("#include <cuda_runtime.h>", '#include "cuda_emu.h"')
    src, n = re.subn(r"(\w+)<<<(.*?)>>>\((.*?)\);",
                     lambda m: f"emu_launch({m[2]}, [&] {{ {m[1]}({m[3]}); }});",
                     src, flags=re.S)
    assert n == 2, n
    return src


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """{dtype: emulated C entry point}."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++")
    work = tmp_path_factory.mktemp("k3_emulated")
    cpp = work / "fused_dropout_emu.cpp"
    cpp.write_text(_emulated_source(SOURCE.read_text()))
    lib = work / "libk3_emu.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                    f"-I{Path(__file__).resolve().parent}", "-o", str(lib),
                    str(cpp)], check=True, capture_output=True)
    dll = ctypes.CDLL(str(lib))
    return {torch.float32: fd.kernel_entry(dll, "fused_dropout_f32"),
            torch.bfloat16: fd.kernel_entry(dll, "fused_dropout_bf16")}


def _run(fn, x, seed, threshold, scale):
    out = torch.full_like(x, float("nan"))
    assert fn(x.data_ptr(), out.data_ptr(), x.numel(), *fd._key(seed),
              threshold, scale, None) == 0
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("n", [4096, 1003], ids=["groups", "tail"])
@pytest.mark.parametrize("rate", [0.1, 0.35])
def test_emulated_kernel_is_the_plain_version_bit_for_bit(emulated, dtype,
                                                          n, rate):
    """Both thresholds' users: the model's 8-bit draw (on bfloat16 its
    scale is 256/q rounded to bfloat16) and the TPU kernel's exact one."""
    x = torch.from_numpy(np.random.default_rng(n).normal(size=n)
                         .astype(np.float32)).to(dtype)
    q = round((1 - rate) * 256)
    scale8 = 256.0 / q
    if dtype == torch.bfloat16:
        scale8 = float(torch.tensor(scale8, dtype=torch.bfloat16))
    for threshold, scale in (((256 - q) << 24, scale8),
                             (fd.fused_dropout_threshold(rate),
                              float(np.float32(1 / (1 - rate))))):
        got = _run(emulated[dtype], x, 1234, threshold, scale)
        want = fd.fused_dropout_reference(x, 1234, threshold, scale)
        assert got.dtype == dtype
        assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16
                                    else torch.int32),
                           want.view(torch.int16 if dtype == torch.bfloat16
                                     else torch.int32))
        kept = float((got != 0).float().mean())
        assert abs(kept - (1 - threshold / 2**32)) < 0.05


def test_emulated_bf16_rounds_to_nearest_even(emulated):
    """Products that fall halfway between two bfloat16 values go to the
    even one, as ``__float2bfloat16_rn`` and torch's cast do."""
    # 1 + k/128 times 1.5: exact in float32, often halfway in bfloat16
    x = (1 + torch.arange(128) / 128.0).to(torch.bfloat16)
    got = _run(emulated[torch.bfloat16], x, 3, 0, 1.5)
    want = (x.float() * 1.5).to(torch.bfloat16)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    halfway = (x.float() * 1.5) != want.float()
    assert bool(halfway.any())
