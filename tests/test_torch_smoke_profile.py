"""chip_smoke.py's reading of a torch.profiler profile against the kernel
wrappers' launch counts (``lost_records``): a profile that lost its device
records is told from a sound one, and from one short by the record lost at
its window's edge; every profiled kernel has its wrappers' counts."""

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke as cs  # noqa: E402
from pytorch_kaldi_asr_tpu_torch.ops.launches import launch_counts  # noqa: E402

# kernel names as torch.profiler gives them on the card
FWD_BF16 = ("void (anonymous namespace)::fwd_kernel<__nv_bfloat16, 8>"
            "(__nv_bfloat16 const*, int)")
DQ_BF16 = ("void (anonymous namespace)::dq_sm90_kernel<1>(CUtensorMap_st, "
           "CUtensorMap_st, int)")
DKV_BF16 = ("void (anonymous namespace)::dkv_sm90_kernel<1>(CUtensorMap_st, "
            "CUtensorMap_st, int)")
FWD_F32 = "void (anonymous namespace)::fwd_kernel<float, 8>(float const*)"
K1_F32 = ("void (anonymous namespace)::banded_attention_kernel<float, 8>"
          "(float const*)")
K3_F32 = "void (anonymous namespace)::fused_dropout_kernel(float const*)"
K3_BF16 = "void (anonymous namespace)::fused_dropout_bf16_kernel(int)"
GEMM = "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64"


def _counts(**delta):
    before = dict.fromkeys(launch_counts(), 0)
    return before, {**before, **delta}


# three profiled bfloat16 train steps of the banded TIMIT model: 3 layers,
# 4 float32 and 21 bfloat16 dropout sites each way
STEP = dict(banded_attention_fwd_bf16=9, banded_attention_dq_bf16=9,
            banded_attention_dkv_bf16=9, fused_dropout_forward=12,
            fused_dropout_backward=12, fused_dropout_forward_bf16=63,
            fused_dropout_backward_bf16=63)


@pytest.mark.parametrize("kernels,lost", [
    # sound, one K3 record short at the window's edge (as every profiled
    # train step on the H100 reads)
    ({FWD_BF16: 9, DQ_BF16: 9, DKV_BF16: 9, K3_F32: 23, K3_BF16: 126,
      GEMM: 300}, {}),
    # the device records lost: no attention kernel of either dtype
    ({GEMM: 40, K3_BF16: 3},
     {"K2a_bf16": {"profiled": 0, "counted": 9},
      "K2b_bf16": {"profiled": 0, "counted": 9},
      "K2c_bf16": {"profiled": 0, "counted": 9},
      "K3": {"profiled": 0, "counted": 24},
      "K3_bf16": {"profiled": 3, "counted": 126}}),
    # nothing at all
    ({}, {"K2a_bf16": {"profiled": 0, "counted": 9},
          "K2b_bf16": {"profiled": 0, "counted": 9},
          "K2c_bf16": {"profiled": 0, "counted": 9},
          "K3": {"profiled": 0, "counted": 24},
          "K3_bf16": {"profiled": 0, "counted": 126}}),
    # a float32 K2a the wrappers did not count is no loss: the step's own
    # gate (check_profile_kernels) refuses it
    ({FWD_BF16: 9, DQ_BF16: 9, DKV_BF16: 9, K3_F32: 24, K3_BF16: 126,
      FWD_F32: 9}, {}),
], ids=["sound", "lost", "empty", "uncounted-kernel"])
def test_lost_records_bf16_step(kernels, lost):
    before, after = _counts(**STEP)
    assert cs.lost_records(kernels, before, after) == lost


@pytest.mark.parametrize("kernels,lost", [
    ({K1_F32: 100}, {}),
    ({GEMM: 1}, {"K1": {"profiled": 0, "counted": 0}}),
], ids=["seen", "missing"])
def test_lost_records_expected_kernel(kernels, lost):
    """A kernel launched past its wrapper (a timing loop) is expected by
    name: a profile without it lost its records."""
    before, after = _counts()
    assert cs.lost_records(kernels, before, after, expect=("K1",)) == lost


def test_profile_names_have_their_counts():
    """Every kernel chip_smoke.py looks for in a profile has the wrapper
    counts that launch it, and every wrapper count belongs to one kernel."""
    assert set(cs.PROFILE_COUNTS) == set(cs.PROFILE_NAMES)
    counted = [c for cs_ in cs.PROFILE_COUNTS.values() for c in cs_]
    assert sorted(counted) == sorted(launch_counts())


def test_profile_check_refuses_a_step_without_its_kernels():
    """The gate after the retries is unchanged: a bfloat16 step's profile
    without its bfloat16 K2a fails it."""
    cfg = type("Cfg", (), {"compute_dtype": "bfloat16",
                           "encoder_type": "banded"})
    ours = {k: [0.0, 0.0] for k in cs.PROFILE_NAMES}
    with pytest.raises(AssertionError, match="K2a_bf16 0.0"):
        cs.check_profile_kernels(
            {"port_kernels_ms_and_launches_per_step": ours}, cfg)
    for k in ("K2a_bf16", "K2b_bf16", "K2c_bf16"):
        ours[k] = [1.0, 3.0]
    cs.check_profile_kernels(
        {"port_kernels_ms_and_launches_per_step": ours}, cfg)
