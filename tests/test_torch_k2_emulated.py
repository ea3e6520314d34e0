"""The banded-attention kernels as written for the card (K1, K2a, K2b and
K2c on float32 in pytorch_kaldi_asr_tpu_torch/ops/csrc/banded_attention_train.cu;
on bfloat16 in ops/csrc/banded_attention_sm90.cu), compiled on the CPU with
g++ against tests/cuda_emu.h and held against the port's plain versions (themselves held against the JAX package in
tests/test_torch_banded_attention.py and tests/test_torch_train_kernels.py)
at the card tests' tolerances.

What this checks without a card: the kernels' index arithmetic, that is
the mma fragment layouts, the permuted k index of the accumulating
products, the tile and sub-tile skips, the band and validity masks, the
forward's online softmax across passes and tiles, the dropout hash and
delta.  The emulated mma multiplies the operands' tf32
bits exactly as the tensor core does, so the 3xTF32 split is checked too.
The bfloat16 kernels (on wgmma fed by TMA through mbarriers, which
cuda_emu.h emulates down to the matrix descriptors and the 128-byte
swizzle) are held against the plain versions on bfloat16 in bfloat16 ulps
(``ba.bf16_ulps``).  Skips where there is no g++.
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
SM90_SOURCE = SOURCE.with_name("banded_attention_sm90.cu")
OUT_ATOL = 2e-5  # out and lse, as tests/test_torch_cuda.py
GRAD_ATOL = 1e-4  # dq, dk, dv and delta


def _emulated_source(src):
    """The .cu with its inline PTX and launches routed to cuda_emu.h."""
    src = src.replace("#include <cuda_bf16.h>\n", "")
    src = src.replace("#include <cuda_runtime.h>", '#include "cuda_emu.h"')
    src = src.replace("extern __shared__ float4 smem[];",
                      "float4* smem = emu_smem();")
    subs = [
        (r'asm\("mma\.sync\.aligned\.m16n8k8\..*?"r"\(b1\)\);',
         "emu_mma(c, a, b0, b1);", 1),
        (r'asm\("mma\.sync\.aligned\.m16n8k16\..*?"r"\(b1\)\);',
         "emu_mma_bf16(c, a, b0, b1);", 1),
        (r'asm volatile\("cp\.async\.cg[^;]*;[^;]*;',
         "std::memcpy(dst, src, 16);", 1),
        (r'asm volatile\("cp\.async\.(commit|wait)[^;]*;[^;]*;', ";", 2),
        (r"(\w+(?:<[^<>]*>)?)<<<([^>]*)>>>\((.*?)\);",
         lambda m: f"emu_launch({m[2]}, [&] {{ {m[1]}({m[3]}); }});", 4),
    ]
    for pattern, repl, count in subs:
        src, n = re.subn(pattern, repl, src, flags=re.S)
        assert n == count, (pattern, n)
    return src


# the bodies of banded_attention_sm90.cu's one-instruction helpers,
# emulated
SM90_HELPERS = {
    "exp2_approx": "return emu_ex2_ftz(x);",
    "mbar_init": "emu_mbar_init(bar, count);",
    "fence_mbar_init": "",
    "mbar_expect_tx": "emu_mbar_expect_tx(bar, bytes);",
    "mbar_arrive": "emu_mbar_arrive(bar);",
    "mbar_try_wait": "return emu_mbar_try_wait(bar, parity);",
    "tma_load_3d": "emu_tma_load_3d(dst, map, bar, c0, c1, c2);",
    "bulk_load": "emu_bulk_load(dst, src, bytes, bar);",
    "wgmma_fence": "",
    "wgmma_commit": "emu_wgmma_commit();",
    "wgmma_wait": "emu_wgmma_wait(N);",
    "pin": "",
    # the shape and the transpose flags are read off the PTX (_wgmma_body)
    "wgmma_ss": "emu_wgmma(d, {n}, da, db, nullptr, scale_d, {trans_a}, {trans_b});",
    "wgmma_rs": ("const uint32_t a[4] = {{a0, a1, a2, a3}}; "
                 "emu_wgmma(d, {n}, 0, db, a, 1, false, {trans_b});"),
}


def _wgmma_body(name, ptx):
    """The emulated body of wgmma helper ``name`` whose asm is ``ptx``: its
    N and transpose flags as the PTX states them (bfloat16 operands,
    float32 sums, unit scales of A and B)."""
    ptx = re.sub(r'"\s*"', "", ptx)  # the asm's string literals joined
    shape = re.search(r"wgmma\.mma_async\.sync\.aligned\.m64n(\d+)k16"
                      r"\.f32\.bf16\.bf16", ptx)
    flags = re.search(r"p, 1, 1, ([01]), ([01]);" if name == "wgmma_ss"
                      else r"p, 1, 1, ([01]);", ptx)
    assert shape and flags, name
    trans = {"0": "false", "1": "true"}
    return SM90_HELPERS[name].format(
        n=shape[1], trans_a=trans[flags[1]] if name == "wgmma_ss" else "",
        trans_b=trans[flags[flags.lastindex]])


def _emulated_sm90_source(src):
    """banded_attention_sm90.cu with its PTX helpers, shared memory and
    launches routed to cuda_emu.h."""
    src = src.replace("#include <cuda.h>\n", "")
    src = src.replace("#include <cuda_bf16.h>\n", "")
    src = src.replace("#include <cuda_runtime.h>", '#include "cuda_emu.h"')
    src, n = re.subn(r"extern __shared__ __align__\(1024\) uint8_t smem_raw\[\];",
                     "uint8_t* smem_raw = reinterpret_cast<uint8_t*>(emu_smem());",
                     src)
    assert n == 3, n  # the forward, K2b and K2c
    for name, body in SM90_HELPERS.items():
        src, n = re.subn(
            rf"(__device__ __forceinline__ [^\n(]*\b{name}\(.*?\)) \{{\n(.*?)\n\}}\n",
            lambda m: "{} {{ {} }}\n".format(
                m[1], _wgmma_body(name, m[2]) if name.startswith("wgmma_")
                and name not in ("wgmma_fence", "wgmma_commit",
                                 "wgmma_wait") else body),
            src, flags=re.S)
        assert n == 1, (name, n)
    src, n = re.subn(r"(\w+)<<<([^>]*)>>>\((.*?)\);",
                     lambda m: f"emu_launch({m[2]}, [&] {{ {m[1]}({m[3]}); }});",
                     src, flags=re.S)
    assert n == 3, n  # launch_fwd, launch_dq and launch_dkv
    return src


def _compile(tmp_path_factory, name, source):
    """``source`` built with g++ against cuda_emu.h as a ``ctypes.CDLL``."""
    import ctypes

    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++")
    work = tmp_path_factory.mktemp(name)
    cpp = work / f"{name}.cpp"
    cpp.write_text(source)
    lib = work / f"lib{name}.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                    f"-I{Path(__file__).resolve().parent}", "-o", str(lib),
                    str(cpp)], check=True, capture_output=True)
    return ctypes.CDLL(str(lib))


@pytest.fixture(scope="module")
def emulated_library(tmp_path_factory):
    """The emulated build of banded_attention_train.cu."""
    return _compile(tmp_path_factory, "k2_emu",
                    _emulated_source(SOURCE.read_text()))


@pytest.fixture(scope="module")
def emulated_sm90_library(tmp_path_factory):
    """The emulated build of banded_attention_sm90.cu."""
    return _compile(tmp_path_factory, "k2_sm90_emu",
                    _emulated_sm90_source(SM90_SOURCE.read_text()))


@pytest.fixture(scope="module")
def emulated(emulated_library):
    """{"k1", "fwd", "dq", "dkv"}: the float32 C entry points of the
    emulated build."""
    return {w: ba.kernel_entry(emulated_library, w)
            for w in ("k1", "fwd", "dq", "dkv")}


@pytest.fixture(scope="module")
def emulated_bf16(emulated_sm90_library):
    """The same on bfloat16: the four kernels of banded_attention_sm90.cu,
    as the wrappers load them."""
    return {w: ba.kernel_entry(emulated_sm90_library, w, torch.bfloat16)
            for w in ("k1", "fwd", "dq", "dkv")}


def _run(fns, q, k, v, valid, dout, seed, start, end, scale, rate,
         backward=True):
    """out, lse, dq, delta, dk, dv of the emulated kernels (K2a only where
    not ``backward``), in q's dtype (lse and delta float32); the outputs
    start as NaN, so a value never written shows."""
    bh, s, d = q.shape
    dv = v.shape[-1]
    tail = (bh, s, d, dv, start, end, scale, *ba._dropout_args(seed, rate),
            None)
    out = torch.full((bh, s, dv), float("nan")).to(q.dtype)
    lse = torch.full((bh, s), float("nan"))
    dq, delta = torch.full_like(q, float("nan")), torch.full_like(lse, float("nan"))
    dk, dv_out = torch.full_like(k, float("nan")), torch.full_like(v, float("nan"))
    calls = (("fwd", (q, k, v, valid, out, lse)),
             ("dq", (q, k, v, dout, out, lse, valid, dq, delta)),
             ("dkv", (q, k, v, dout, lse, delta, valid, dk, dv_out)))
    for which, tensors in calls[:None if backward else 1]:
        assert fns[which](*(t.data_ptr() for t in tensors), *tail) == 0
    return out, lse, dq, delta, dk, dv_out


def _check_k1(fns, q, k, v, valid, start, end, scale):
    """The emulated K1 against the plain version; exact zeros on rows with
    no valid key in band."""
    bh, s, d = q.shape
    dv = v.shape[-1]
    out = torch.full((bh, s, dv), float("nan"))
    assert fns["k1"](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     valid.data_ptr(), out.data_ptr(), bh, s, d, dv, start,
                     end, scale, None) == 0
    want = ba.banded_attention_reference(q, k, v, valid, start, end, scale)
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=OUT_ATOL)
    empty = ~ba._allowed(s, start, end, valid).any(-1)
    assert (out[empty] == 0).all()


def _inputs(case):
    """Seeded q, k, v, dout and the int32 key mask of ``case``."""
    s, d, dv, valid, start, end = case
    bh = valid.shape[0]
    rng = np.random.default_rng(3)
    q, k = (torch.from_numpy(rng.normal(size=(bh, s, d)).astype(np.float32))
            for _ in range(2))
    v, dout = (torch.from_numpy(rng.normal(size=(bh, s, dv))
                                .astype(np.float32)) for _ in range(2))
    return q, k, v, dout, valid.to(torch.int32).contiguous()


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


def _check_forward(out, lse, out_ref, lse_ref):
    """K2a's out and lse against the plain version's; lse -inf on the same
    rows, whose out is exact zeros."""
    live = torch.isfinite(lse_ref)
    assert torch.equal(torch.isfinite(lse), live)
    np.testing.assert_allclose(out.numpy(), out_ref.detach().numpy(),
                               atol=OUT_ATOL)
    np.testing.assert_allclose(lse[live].numpy(), lse_ref[live].numpy(),
                               atol=OUT_ATOL)
    assert (out[~live] == 0).all()


@pytest.mark.parametrize("rate", [0.0, 0.35])
@pytest.mark.parametrize("case", list(CASES))
def test_emulated_kernels_match_plain_version(emulated, case, rate):
    """K2a, K2b and K2c against autograd of the plain trainable version;
    K1 (no dropout) against its plain version in the rate-0 instance."""
    s, d, dv, _, start, end = CASES[case]
    scale, seed = 0.125, 77
    q, k, v, dout, valid = _inputs(CASES[case])
    out, lse, dq, delta, dk, dv_out = _run(emulated, q, k, v, valid, dout,
                                           seed, start, end, scale, rate)

    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    out_ref, lse_ref = ba.banded_attention_trainable_reference(
        qg, kg, vg, valid, seed, start, end, scale, rate)
    out_ref.backward(dout)
    _check_forward(out, lse, out_ref, lse_ref)
    live = torch.isfinite(lse_ref)
    np.testing.assert_allclose(
        delta.numpy(), (dout * out_ref.detach()).sum(-1).numpy(),
        atol=GRAD_ATOL)
    for got, want in ((dq, qg.grad), (dk, kg.grad), (dv_out, vg.grad)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=GRAD_ATOL)
    # exact zeros: rows with no key in band, invalid keys
    assert (dq[~live] == 0).all()
    assert (dk[valid == 0] == 0).all() and (dv_out[valid == 0] == 0).all()
    if rate == 0.0:
        _check_k1(emulated, q, k, v, valid, start, end, scale)


def _tile_out(s, lengths):
    """Prefix lengths with the second 64-key tile wholly invalid."""
    tile = (torch.arange(s) >= 64) & (torch.arange(s) < 128)
    return _prefix(s, lengths) & ~tile[None]


# the forward's own skips: chunks of 8 keys wholly in band beside partial
# ones (the band test skipped), a whole invalid key tile between valid ones,
# d % 8 = 4 with dv one 8-column step, and TIMIT's band at its head dim
FORWARD_CASES = {
    "band (-40,0): whole and partial chunks":
        (128, 16, 16, _prefix(128, [128, 90]), -40, 0),
    "an invalid key tile inside the band":
        (256, 16, 8, _tile_out(256, [256, 200]), -70, 10),
    "d 20, dv 4": (128, 20, 4, _prefix(128, [128, 77]), -20, 20),
    "TIMIT band (-100,0) S 256 d 64":
        (256, 64, 64, _prefix(256, [256, 180]), -100, 0),
}


@pytest.mark.parametrize("rate", [0.0, 0.35])
@pytest.mark.parametrize("case", list(FORWARD_CASES))
def test_emulated_forward_matches_plain_version(emulated, case, rate):
    """K2a (out, lse) and, in the rate-0 instance, K1 against their plain
    versions at the cases that reach the forward's skips."""
    s, d, dv, _, start, end = FORWARD_CASES[case]
    q, k, v, dout, valid = _inputs(FORWARD_CASES[case])
    out, lse, *_ = _run(emulated, q, k, v, valid, dout, 77, start, end,
                        0.125, rate, backward=False)
    out_ref, lse_ref = ba.banded_attention_trainable_reference(
        q, k, v, valid, 77, start, end, 0.125, rate)
    _check_forward(out, lse, out_ref, lse_ref)
    if rate == 0.0:
        _check_k1(emulated, q, k, v, valid, start, end, 0.125)


def test_emulated_forward_does_not_drift(emulated):
    """K2a's out against the plain version in float64, at TIMIT's band and
    head dim: the mean error along each output's sign, over the outputs'
    mean size.  The tensor core rounds each mma's sum toward zero (so does
    cuda_emu.h), so products chained onto one accumulator shrink every
    output by about 1e-6 of its size (-9.2e-7 here), a bias that the
    cancelling gradient sums of a train step amplify; summed from zero and
    added in float32, the forward's products leave -8e-8 (the CPU's float32
    plain version: 6e-9)."""
    bh, s, d, start, end, scale = 4, 256, 64, -100, 0, 0.125
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=(bh, s, d)).astype(np.float32))
               for _ in range(3))
    valid = torch.ones((bh, s), dtype=torch.int32)
    out, *_ = _run(emulated, q, k, v, valid, v, 7, start, end, scale, 0.0,
                   backward=False)
    ref, _ = ba.banded_attention_trainable_reference(
        q.double(), k.double(), v.double(), valid, 7, start, end, scale)
    bias = float(((out.double() - ref) * ref.sign()).mean() / ref.abs().mean())
    assert abs(bias) < 3e-7


def test_emulated_backward_does_not_drift(emulated):
    """The backward twin of test_emulated_forward_does_not_drift: K2b's dq
    and K2c's dk and dv against autograd of the plain version in float64,
    as the mean error along each gradient's sign over its mean size.
    Chained on one accumulator, the backward's products drift toward zero
    by -1.3e-6 to -2.1e-6 here; each product summed from zero and added in
    float32 stays well under 3e-7."""
    bh, s, d, start, end, scale = 4, 256, 64, -100, 0, 0.125
    rng = np.random.default_rng(0)
    q, k, v, dout = (torch.from_numpy(rng.normal(size=(bh, s, d))
                                      .astype(np.float32)) for _ in range(4))
    valid = torch.ones((bh, s), dtype=torch.int32)
    _, _, dq, _, dk, dv = _run(emulated, q, k, v, valid, dout, 7, start, end,
                               scale, 0.0)
    qg, kg, vg = (x.double().requires_grad_() for x in (q, k, v))
    out, _ = ba.banded_attention_trainable_reference(qg, kg, vg, valid, 7,
                                                     start, end, scale)
    out.backward(dout.double())
    for name, got, ref in (("dq", dq, qg.grad), ("dk", dk, kg.grad),
                           ("dv", dv, vg.grad)):
        bias = float(((got.double() - ref) * ref.sign()).mean()
                     / ref.abs().mean())
        assert abs(bias) < 3e-7, (name, bias)


# ---------------------------------------------------------------------------
# the bfloat16 instantiations
# ---------------------------------------------------------------------------

BF16 = torch.bfloat16
# bfloat16 outputs, kernel against plain version, in bf16_ulps.  Measured
# here: at most 1.0 over every case below.  The forward rounds its
# unnormalised probabilities against the running max of each 64-key tile,
# the plain version against the row's max (the Pallas kernel against its
# 128-key block's), so the two round p differently: out differs by one ulp
# in 3-32 % of its entries, the gradients (whose probabilities come from the
# final lse in both) by at most one ulp.
BF16_ULPS = 2.0


# the cases of CASES and FORWARD_CASES whose head dims the bfloat16
# kernels take (multiples of 8), and one whose d ends inside a 16-deep step
BF16_CASES = {
    **{name: c for name, c in {**CASES, **FORWARD_CASES}.items()
       if c[1] % 8 == 0 and c[2] % 8 == 0},
    "d 24, dv 8": (128, 24, 8, _prefix(128, [128, 70]), -20, 20),
}


def _bf16_inputs(case):
    q, k, v, dout, valid = _inputs(case)
    return (*(x.to(BF16) for x in (q, k, v, dout)), valid)


@pytest.mark.parametrize("rate", [0.0, 0.35])
@pytest.mark.parametrize("case", list(BF16_CASES))
def test_emulated_bf16_kernels_match_plain_version(emulated_bf16, case,
                                                   rate):
    """K2a, K2b and K2c on bfloat16 against the plain versions on bfloat16
    (K2b and K2c on the emulated forward's out and lse, K2c on K2b's
    delta); K1 in the rate-0 instance.  Outputs bfloat16, within BF16_ULPS;
    lse and delta float32; exact zeros where the float32 kernels have
    them."""
    s, d, dv, _, start, end = BF16_CASES[case]
    scale, seed = 0.125, 77
    q, k, v, dout, valid = _bf16_inputs(BF16_CASES[case])
    out, lse, dq, delta, dk, dv_out = _run(emulated_bf16, q, k, v, valid,
                                           dout, seed, start, end, scale,
                                           rate)
    assert out.dtype == dq.dtype == dk.dtype == dv_out.dtype == BF16
    out_ref, lse_ref = ba.banded_attention_trainable_reference(
        q, k, v, valid, seed, start, end, scale, rate)
    live = torch.isfinite(lse_ref)
    assert torch.equal(torch.isfinite(lse), live)
    np.testing.assert_allclose(lse[live].numpy(), lse_ref[live].numpy(),
                               atol=OUT_ATOL)
    assert float(ba.bf16_ulps(out, out_ref).max()) <= BF16_ULPS
    dq_ref, delta_ref = ba.banded_attention_dq_reference(
        q, k, v, valid, dout, out, lse, seed, start, end, scale, rate)
    dk_ref, dv_ref = ba.banded_attention_dkv_reference(
        q, k, v, valid, dout, lse, delta, seed, start, end, scale, rate)
    np.testing.assert_allclose(delta.numpy(), delta_ref.numpy(),
                               atol=GRAD_ATOL)
    for name, got, want in (("dq", dq, dq_ref), ("dk", dk, dk_ref),
                            ("dv", dv_out, dv_ref)):
        assert float(ba.bf16_ulps(got, want).max()) <= BF16_ULPS, name
    assert (out[~live] == 0).all() and (dq[~live] == 0).all()
    assert (dk[valid == 0] == 0).all() and (dv_out[valid == 0] == 0).all()
    if rate == 0.0:
        bh = q.shape[0]
        k1 = torch.full((bh, s, dv), float("nan")).to(BF16)
        assert emulated_bf16["k1"](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                   valid.data_ptr(), k1.data_ptr(), bh, s, d,
                                   dv, start, end, scale, None) == 0
        want = ba.banded_attention_reference(q, k, v, valid, start, end,
                                             scale)
        assert float(ba.bf16_ulps(k1, want).max()) <= BF16_ULPS
        empty = ~ba._allowed(s, start, end, valid).any(-1)
        assert (k1[empty] == 0).all()


# cases whose CTAs stream more tiles than the bfloat16 kernels' ring has
# stages (3 at d, dv <= 64; 2 above)
RING_CASES = {
    "band (-256,256) S 640": BF16_CASES["band (-256,256) S 640"],
    "d 128, band (-256,64) S 384": (384, 128, 128, _prefix(384, [384, 200]),
                                    -256, 64),
}


@pytest.mark.parametrize("case", list(RING_CASES))
def test_emulated_bf16_backward_with_copies_landing_at_once(
        emulated_sm90_library, emulated_bf16, case):
    """cuda_emu.h lands a TMA or bulk copy when a thread waits on its
    mbarrier for a phase not yet complete, so a wait on the wrong phase
    reads a stage's old tile; here each copy lands as it is issued, so a
    stage handed back for its next tile before the products reading it
    are complete is overwritten under them.  K2b and K2c on bfloat16 at cases
    that wrap the ring, against the plain versions at rate 0.35."""
    s, d, dv, _, start, end = RING_CASES[case]
    q, k, v, dout, valid = _bf16_inputs(RING_CASES[case])
    emulated_sm90_library.emu_lazy_copies(0)
    try:
        out, lse, dq, delta, dk, dv_out = _run(emulated_bf16, q, k, v, valid,
                                               dout, 77, start, end, 0.125,
                                               0.35)
    finally:
        emulated_sm90_library.emu_lazy_copies(1)
    band = (77, start, end, 0.125, 0.35)
    dq_ref, _ = ba.banded_attention_dq_reference(q, k, v, valid, dout, out,
                                                 lse, *band)
    dk_ref, dv_ref = ba.banded_attention_dkv_reference(
        q, k, v, valid, dout, lse, delta, *band)
    for name, got, want in (("dq", dq, dq_ref), ("dk", dk, dk_ref),
                            ("dv", dv_out, dv_ref)):
        assert float(ba.bf16_ulps(got, want).max()) <= BF16_ULPS, name


@pytest.mark.parametrize("case", list(RING_CASES))
def test_emulated_bf16_forward_with_copies_landing_at_once(
        emulated_sm90_library, emulated_bf16, case):
    """The forward's twin of the test above: K2a on bfloat16 at rate 0.35
    and K1 with each TMA and bulk copy landing as it is issued, at cases
    that wrap the ring, against the plain versions; a stage handed back
    before the products reading it are complete is overwritten under
    them."""
    s, d, dv, _, start, end = RING_CASES[case]
    q, k, v, dout, valid = _bf16_inputs(RING_CASES[case])
    emulated_sm90_library.emu_lazy_copies(0)
    try:
        out, lse, *_ = _run(emulated_bf16, q, k, v, valid, dout, 77, start,
                            end, 0.125, 0.35, backward=False)
        k1 = torch.full((q.shape[0], s, dv), float("nan")).to(BF16)
        assert emulated_bf16["k1"](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                   valid.data_ptr(), k1.data_ptr(),
                                   q.shape[0], s, d, dv, start, end, 0.125,
                                   None) == 0
    finally:
        emulated_sm90_library.emu_lazy_copies(1)
    out_ref, lse_ref = ba.banded_attention_trainable_reference(
        q, k, v, valid, 77, start, end, 0.125, 0.35)
    live = torch.isfinite(lse_ref)
    assert torch.equal(torch.isfinite(lse), live)
    np.testing.assert_allclose(lse[live].numpy(), lse_ref[live].numpy(),
                               atol=OUT_ATOL)
    assert float(ba.bf16_ulps(out, out_ref).max()) <= BF16_ULPS
    want = ba.banded_attention_reference(q, k, v, valid, start, end, 0.125)
    assert float(ba.bf16_ulps(k1, want).max()) <= BF16_ULPS


def test_bf16_kernels_load_from_the_hopper_source(monkeypatch):
    """_kernel_fn takes all four bfloat16 kernels from
    banded_attention_sm90.cu's library and the float32 ones from
    banded_attention_train.cu's (``_build.load`` patched: nothing
    compiles)."""
    import types

    from pytorch_kaldi_asr_tpu_torch.ops import _build

    loaded = []

    def load(name):
        loaded.append(name)
        return types.SimpleNamespace(**{
            f"banded_attention{w}_{sfx}": types.SimpleNamespace()
            for w in ("", "_fwd", "_dq", "_dkv") for sfx in ("f32", "bf16")})

    monkeypatch.setattr(_build, "load", load)
    ba._kernel_fn.cache_clear()
    try:
        for dtype, source in ((torch.bfloat16, "banded_attention_sm90"),
                              (torch.float32, "banded_attention_train")):
            for which in ("k1", "fwd", "dq", "dkv"):
                del loaded[:]
                fn = ba._kernel_fn(which, dtype)
                assert loaded == [source], (dtype, which, loaded)
                assert fn.restype is not None and fn.argtypes
    finally:
        ba._kernel_fn.cache_clear()


def _drift(got, ref):
    """The mean error along ``ref``'s sign over its mean size."""
    got, ref = got.double(), ref.double()
    return float(((got - ref) * ref.sign()).mean() / ref.abs().mean())


def test_emulated_bf16_does_not_drift(emulated_sm90_library, emulated_bf16):
    """The bfloat16 kernels chain their products on one accumulator (one
    wgmma per 16 products).  Under cuda_emu.h's model of the tensor core's
    rounding (its addends cut toward zero at 26 bits below the largest,
    the sum rounded toward zero: what chip_smoke.py's probe reads on the
    H100), at TIMIT's band and head dim, out, dq, dk and dv sit along their
    signs no further from the plain bfloat16 version (float32 sums rounded
    to nearest) than DRIFT_GATE, 1 % of bfloat16's rounding of an input
    (2**-9); and the tensor core's rounding itself, the same kernels
    against a build whose mma rounds its exact sum to nearest, moves them
    by less than 1e-5 of their size.  Measured: against the plain version
    out +6.2e-6 (the forward rounds p at other maxima, see BF16_ULPS; O
    chains over every tile of its band), dq, dk and dv -6e-8 to -4.3e-7;
    the tensor core's rounding against to nearest -3.2e-7 (out), +6.5e-7,
    +8.3e-7 and -1.6e-7 (dq, dk, dv): three orders of magnitude under
    bfloat16's 2**-9, so the products chain (the float32 kernels cannot:
    there the drift was the size of their error budget)."""
    bh, s, d, start, end, scale = 8, 256, 64, -100, 0, 0.125
    rng = np.random.default_rng(0)
    q, k, v, dout = (torch.from_numpy(rng.normal(size=(bh, s, d)).astype(
        np.float32)).to(BF16) for _ in range(4))
    valid = torch.ones((bh, s), dtype=torch.int32)
    runs = {}
    for nearest in (0, 1):
        emulated_sm90_library.emu_round_nearest(nearest)
        try:
            runs[nearest] = _run(emulated_bf16, q, k, v, valid, dout, 7,
                                 start, end, scale, 0.0)
        finally:
            emulated_sm90_library.emu_round_nearest(0)
    out, lse, dq, delta, dk, dv = runs[0]
    out_ref, _ = ba.banded_attention_trainable_reference(q, k, v, valid, 7,
                                                         start, end, scale)
    dq_ref, _ = ba.banded_attention_dq_reference(q, k, v, valid, dout, out,
                                                 lse, 7, start, end, scale)
    dk_ref, dv_ref = ba.banded_attention_dkv_reference(
        q, k, v, valid, dout, lse, delta, 7, start, end, scale)
    got = {"out": out, "dq": dq, "dk": dk, "dv": dv}
    nearest = dict(zip(("out", "dq", "dk", "dv"),
                       (runs[1][i] for i in (0, 2, 4, 5))))
    drift = {n: _drift(got[n], r) for n, r in (
        ("out", out_ref), ("dq", dq_ref), ("dk", dk_ref), ("dv", dv_ref))}
    toward_zero = {n: _drift(got[n], nearest[n]) for n in got}
    print(f"bfloat16 drift against the plain version {drift}; rounding "
          f"toward zero against to nearest {toward_zero}")
    for n in got:
        assert abs(drift[n]) < DRIFT_GATE, (n, drift)
        assert abs(toward_zero[n]) < 1e-5, (n, toward_zero)


DRIFT_GATE = 0.01 * 2.0 ** -9


def _aligned_toward_zero(terms, p=26):
    """cuda_emu.h's tc_sum_bf16 in float64: each addend (last axis) cut
    toward zero to a multiple of 2**(e - p), e the largest addend's leading
    bit, the sum rounded toward zero to float32."""
    largest = np.abs(terms).max(-1, keepdims=True)
    _, e = np.frexp(largest)
    q = np.where(largest > 0, np.ldexp(1.0, e - 1 - p), 1.0)
    total = (np.trunc(terms / q) * q).sum(-1)
    f = total.astype(np.float32)
    return np.where(np.abs(f.astype(np.float64)) > np.abs(total),
                    np.nextafter(f, np.float32(0)), f)


def test_emulated_mma_bf16_probe(emulated_library):
    """The probe entry point (one m16n8k16 bfloat16 mma per problem, as
    chip_smoke.py reads the card's rounding with it) against the emulated
    tensor core's model computed here in float64 (``_aligned_toward_zero``):
    equal, so the probe's fragment loads are right."""
    import ctypes

    n = 4
    rng = np.random.default_rng(5)
    a, b = (torch.from_numpy(rng.normal(size=(n, 16, w)).astype(np.float32))
            .to(BF16) for w in (16, 8))
    c = torch.from_numpy(rng.normal(size=(n, 16, 8)).astype(np.float32))
    d = torch.full_like(c, float("nan"))
    probe = emulated_library.mma_bf16_probe
    probe.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
    assert probe(a.data_ptr(), b.data_ptr(), c.data_ptr(), d.data_ptr(), n,
                 None) == 0
    prods = (a.double().numpy()[:, :, None, :]
             * b.double().numpy().transpose(0, 2, 1)[:, None, :, :])
    terms = np.concatenate([c.double().numpy()[..., None], prods], -1)
    np.testing.assert_array_equal(d.numpy(), _aligned_toward_zero(terms))
