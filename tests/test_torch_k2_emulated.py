"""The trainable banded-attention kernels as written for the card (K2a, K2b
and K2c in pytorch_kaldi_asr_tpu_torch/ops/csrc/banded_attention_train.cu),
compiled on the CPU with g++ against tests/cuda_emu.h and held against the
port's plain versions (themselves held against the JAX package in
tests/test_torch_train_kernels.py) at the card tests' tolerances.

What this checks without a card: the kernels' index arithmetic, that is
the mma fragment layouts, the permuted k index of the accumulating
products, the tile and sub-tile skips, the band and validity masks, the
dropout hash and delta.  The emulated mma multiplies the operands' tf32
bits exactly as the tensor core does, so the 3xTF32 split is checked too.
Skips where there is no g++.
"""

import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from pytorch_kaldi_asr_tpu_torch.ops import banded_attention as ba

SOURCE = (Path(ba.__file__).resolve().parent / "csrc"
          / "banded_attention_train.cu")
OUT_ATOL = 2e-5  # out and lse, as tests/test_torch_cuda.py
GRAD_ATOL = 1e-4  # dq, dk, dv and delta


def _emulated_source(src):
    """The .cu with its inline PTX and launches routed to cuda_emu.h."""
    src = src.replace("#include <cuda_runtime.h>", '#include "cuda_emu.h"')
    src = src.replace("extern __shared__ float4 smem[];",
                      "float4* smem = emu_smem();")
    subs = [
        (r'asm\("mma\.sync.*?"r"\(b1\)\);', "emu_mma(c, a, b0, b1);", 1),
        (r'asm volatile\("cp\.async\.cg[^;]*;[^;]*;',
         "std::memcpy(dst, src, 16);", 1),
        (r'asm volatile\("cp\.async\.(commit|wait)[^;]*;[^;]*;', ";", 2),
        (r"(\w+(?:<[^<>]*>)?)<<<([^>]*)>>>\((.*?)\);",
         lambda m: f"emu_launch({m[2]}, [&] {{ {m[1]}({m[3]}); }});", 3),
    ]
    for pattern, repl, count in subs:
        src, n = re.subn(pattern, repl, src, flags=re.S)
        assert n == count, (pattern, n)
    return src


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """{"fwd", "dq", "dkv"}: the C entry points of the emulated build."""
    import ctypes

    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++")
    work = tmp_path_factory.mktemp("k2_emulated")
    cpp = work / "banded_attention_train_emu.cpp"
    cpp.write_text(_emulated_source(SOURCE.read_text()))
    lib = work / "libk2_emu.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                    f"-I{Path(__file__).resolve().parent}", "-o", str(lib),
                    str(cpp)], check=True, capture_output=True)
    dll = ctypes.CDLL(str(lib))
    return {w: ba.train_entry(dll, w) for w in ("fwd", "dq", "dkv")}


def _run(fns, q, k, v, valid, dout, seed, start, end, scale, rate):
    """out, lse, dq, delta, dk, dv of the emulated kernels; the outputs
    start as NaN, so a value never written shows."""
    bh, s, d = q.shape
    dv = v.shape[-1]
    tail = (bh, s, d, dv, start, end, scale, *ba._dropout_args(seed, rate),
            None)
    out = torch.full((bh, s, dv), float("nan"))
    lse = torch.full((bh, s), float("nan"))
    dq, delta = torch.full_like(q, float("nan")), torch.full_like(lse, float("nan"))
    dk, dv_out = torch.full_like(k, float("nan")), torch.full_like(v, float("nan"))
    calls = (("fwd", (q, k, v, valid, out, lse)),
             ("dq", (q, k, v, dout, out, lse, valid, dq, delta)),
             ("dkv", (q, k, v, dout, lse, delta, valid, dk, dv_out)))
    for which, tensors in calls:
        assert fns[which](*(t.data_ptr() for t in tensors), *tail) == 0
    return out, lse, dq, delta, dk, dv_out


def _prefix(s, lengths):
    return torch.arange(s)[None, :] < torch.tensor(lengths)[:, None]


def _holes(s):
    """Random holes, and a whole invalid 64-key tile."""
    g = torch.Generator().manual_seed(1)
    tile = (torch.arange(s) >= 64) & (torch.arange(s) < 128)
    return (torch.rand((2, s), generator=g) > 0.3) & ~tile[None]


# (s, d, dv, key mask, start, end): each reaches a skip or a layout case
CASES = {
    "band (-100,0)": (256, 16, 16, _prefix(256, [256, 150]), -100, 0),
    "band (-64,64) on tile edges": (256, 32, 32, _prefix(256, [256, 200]),
                                    -64, 64),
    "band (-65,0), dv != d": (192, 16, 8, _prefix(192, [192, 70]), -65, 0),
    "invalid key tiles, dead query tiles": (256, 16, 16,
                                            _prefix(256, [256, 60, 0]), -10, 30),
    "d 12": (128, 12, 12, _prefix(128, [128, 100]), -30, 5),
    "d 64, dv 32": (128, 64, 32, _prefix(128, [128]), -20, 20),
    "key mask no prefix": (256, 8, 8, _holes(256), -40, 40),
    "d 128": (128, 128, 128, _prefix(128, [100]), -64, 0),
    "band (-256,256) S 640": (640, 8, 8, _prefix(640, [500]), -256, 256),
}


@pytest.mark.parametrize("rate", [0.0, 0.35])
@pytest.mark.parametrize("case", list(CASES))
def test_emulated_kernels_match_plain_version(emulated, case, rate):
    s, d, dv, valid, start, end = CASES[case]
    bh, scale, seed = valid.shape[0], 0.125, 77
    rng = np.random.default_rng(3)
    q, k = (torch.from_numpy(rng.normal(size=(bh, s, d)).astype(np.float32))
            for _ in range(2))
    v, dout = (torch.from_numpy(rng.normal(size=(bh, s, dv))
                                .astype(np.float32)) for _ in range(2))
    valid = valid.to(torch.int32).contiguous()
    out, lse, dq, delta, dk, dv_out = _run(emulated, q, k, v, valid, dout,
                                           seed, start, end, scale, rate)

    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    out_ref, lse_ref = ba.banded_attention_trainable_reference(
        qg, kg, vg, valid, seed, start, end, scale, rate)
    out_ref.backward(dout)
    live = torch.isfinite(lse_ref)
    assert torch.equal(torch.isfinite(lse), live)
    np.testing.assert_allclose(out.numpy(), out_ref.detach().numpy(),
                               atol=OUT_ATOL)
    np.testing.assert_allclose(lse[live].numpy(), lse_ref[live].numpy(),
                               atol=OUT_ATOL)
    np.testing.assert_allclose(
        delta.numpy(), (dout * out_ref.detach()).sum(-1).numpy(),
        atol=GRAD_ATOL)
    for got, want in ((dq, qg.grad), (dk, kg.grad), (dv_out, vg.grad)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=GRAD_ATOL)
    # exact zeros: rows with no key in band, invalid keys
    assert (dq[~live] == 0).all()
    assert (dk[valid == 0] == 0).all() and (dv_out[valid == 0] == 0).all()
