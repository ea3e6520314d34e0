"""chip_smoke.py's CPU cross-checks deferred to a side thread (``run_slice``
with the corpus's ``cpu_side``; ``start_side_checks``,
``join_side_checks``), rehearsed on the CPU at a narrow width: the sound
run passes, its check recorded with its span (the fixed-buffer search's
decode, and the bfloat16-compute conformer's CPU part); a planted mismatch
(the CPU's first score moved by 1e-3, ten times the gate) still fails the
run, where the check is joined."""

import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke as cs  # noqa: E402

torch.set_num_threads(1)

NARROW = ["-encoder_max_len", "64", "-decoder_max_len", "12",
          "-encoder_sub_sequence", "(-8,0)", "-decoder_sub_sequence",
          "(-3,1)", "-en_layers", "1", "-de_layers", "1", "-n_head", "2",
          "-en_d_model", "16", "-de_d_model", "16", "-d_k", "8", "-d_v", "8",
          "-encoder_type", "banded"]


# the conformer as bfloat16 compute runs it, narrow: its CPU part (the
# CPU's encoders, the search from the card's encoder output) deferred
CONFORMER = ["-encoder_max_len", "200", "-decoder_max_len", "12",
             "-encoder_sub_sequence", "(-16,16)", "-decoder_sub_sequence",
             "(-4,0)", "-en_layers", "1", "-de_layers", "1", "-n_head", "2",
             "-en_d_model", "32", "-de_d_model", "32", "-d_k", "8", "-d_v",
             "8", "-en_dropout", "0.1", "-de_dropout", "0.1",
             "-encoder_type", "conformer", "-conformer_stream_dtype",
             "bfloat16"]


def _corpus(name="timit_noncausal"):
    if name == "timit_noncausal":
        base, frames = cs.TIMIT_NONCAUSAL, dict(frames=(20, 48))
    else:
        base, frames = cs.LIBRISPEECH_BF16_COMPUTE, dict(
            frames=(40, 120), lognormal=(4.0, 0.3))
    return dict(base, **frames,
                decode=dict(base["decode"], utts=4, batch=2, beam=2,
                            nbest=2, max_tokens=6, buckets=1))


@pytest.fixture
def smoke(tmp_path, monkeypatch):
    monkeypatch.setattr(cs, "WORK", tmp_path)
    monkeypatch.setattr(cs, "SIDE_CHECKS", [])
    monkeypatch.setattr(cs, "SIDE_PENDING", [])
    monkeypatch.setattr(cs, "SIDE_CHECK_THREADS", 1)
    assert cs.TIMIT_NONCAUSAL["decode"]["cpu_side"]
    yield
    cs.join_side_checks(torch)  # nothing left running


@pytest.mark.parametrize("name", ["timit_noncausal",
                                  "librispeech_bf16_compute"])
def test_side_check_passes_on_a_sound_run(smoke, name):
    summary = cs.run_slice(torch, _corpus(name), device="cpu",
                           model_args=NARROW if name == "timit_noncausal"
                           else CONFORMER)
    assert summary["cpu_side_check"] == f"{name} decode, first batch"
    assert [label for label, _ in cs.SIDE_PENDING] == [
        summary["cpu_side_check"]]  # deferred, not started
    cs.start_side_checks(torch)
    joined = cs.join_side_checks(torch)
    row = joined[summary["cpu_side_check"]]
    assert row["result"][0] <= cs.CPU_SCORE_ATOL
    assert 0.0 <= row["start_s"] <= row["end_s"]


def test_side_check_fails_on_a_planted_mismatch(smoke, monkeypatch):
    from pytorch_kaldi_asr_tpu_torch.recipes import decode

    real = decode.main

    def planted(argv, **kw):
        rc = real(argv, **kw)
        out = Path(argv[argv.index("-save_result_file") + 1])
        if out.name == "decode_cpu.txt":
            lines = out.read_text().splitlines()
            key, score, words = lines[0].split("\t")
            lines[0] = "\t".join([key, f"{float(score) + 1e-3:.6f}", words])
            out.write_text("\n".join(lines) + "\n")
        return rc

    monkeypatch.setattr(decode, "main", planted)
    cs.run_slice(torch, _corpus(), device="cpu", model_args=NARROW)
    with pytest.raises(AssertionError, match=r"rank 0: score .* \(cpu\)"):
        cs.join_side_checks(torch)
