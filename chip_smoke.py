#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pytorch_kaldi_asr_tpu_torch) on one
CUDA card: ``python3 chip_smoke.py`` from the root of a checkout.

1. Requires a CUDA card; prints its name and power limit (nvidia-smi) and
   turns TF32 off for matmuls and cuDNN (the port is float32).
2. Builds every CUDA kernel of the port from ``ops/csrc`` (one nvcc per
   source, all started together) and prints what ptxas reports.
3. Kernel phase: holds each kernel against its plain PyTorch version on the
   card at the slice's shapes and at edge cases (band shapes, padded tails,
   fully masked rows exactly 0, dv != d, S not a multiple of the tile), then
   times the kernel, the plain version and the PyTorch library call that
   computes the same function, with CUDA events after warm-up.
4. Slice phase: writes a seeded TIMIT-shaped data dir (16 utterances of 40-dim
   features, 150-500 frames, a 52-entry phone vocabulary), runs the port's
   ``initialize_model`` at the recipe's widths with ``-encoder_type banded``
   and its ``decode`` on the card with the recipe's stage-5 flags, checks the
   16 x 10 n-best lines and that each kernel was launched by the decode,
   decodes the first batch again on the CPU and compares, and prints the
   decode wall time and real-time factor.
5. Prints the ``kernels`` JSON line, the card line, and as the last line
   ``{"ok": true, "device": {...}}``.  Any failure raises: the script then
   exits non-zero without the last line.

Everything it writes goes under ``build/chip_smoke/`` in the checkout.
"""

import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
WORK = REPO / "build" / "chip_smoke"

# H100 SXM published peaks (NVIDIA data sheet), the denominators of bound_ms
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12  # float32 outside the tensor cores

# the recipe's model (recipes/attention-transformer-timit/run.sh) with the
# banded encoder, and its stage-5 decode flags
RECIPE_MODEL = [
    "-encoder_max_len", "500", "-decoder_max_len", "100", "-src_fold", "1",
    "-encoder_sub_sequence", "(-100,0)", "-decoder_sub_sequence", "(-10,0)",
    "-en_layers", "3", "-de_layers", "3", "-n_head", "2",
    "-en_d_model", "256", "-de_d_model", "128", "-d_k", "64", "-d_v", "64",
    "-en_dropout", "0.35", "-de_dropout", "0.35", "-encoder_type", "banded",
]
BATCH, BEAM, NBEST, MAX_TOKENS = 8, 25, 10, 100
N_UTTS, FEAT_DIM, MIN_FRAMES, MAX_FRAMES = 16, 40, 150, 500
N_PHONES = 48  # + 4 control words = 52 vocabulary entries
SEED = 0

KERNEL_ATOL = 2e-5  # float32, summation order differs from the plain version
CPU_SCORE_ATOL = 1e-4  # card vs CPU n-best scores
WORD_GAP = 1e-3  # words must agree where scores are this far apart


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------


def _attention_inputs(torch, bh, s, d, dv, lengths, seed):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((bh, s, d), generator=g)
    k = torch.randn((bh, s, d), generator=g)
    v = torch.randn((bh, s, dv), generator=g)
    valid = (torch.arange(s)[None, :] < torch.as_tensor(lengths)[:, None])
    return q.cuda(), k.cuda(), v.cuda(), valid.to(torch.int32).cuda()


def _slice_lengths(torch, n_utts, heads, s, seed):
    """Key-valid lengths of a decode batch: utterances of 150..s frames,
    each repeated per head (b-major, as the encoder folds heads)."""
    g = torch.Generator().manual_seed(seed)
    lens = torch.randint(MIN_FRAMES, s + 1, (n_utts,), generator=g)
    return lens.repeat_interleave(heads)


def check_banded_attention(torch, ba):
    """Kernel vs plain version on the card; returns the max abs error."""
    scale = 1.0 / math.sqrt(256.0)
    # (bh, s, d, dv, lengths, start, end, scale, name)
    cases = [
        (16, 504, 64, 64, _slice_lengths(torch, 8, 2, 504, 1), -100, 0,
         scale, "slice shape"),
    ]
    for start, end in [(-100, 0), (-10, 0), (-64, 32), (-300, 0)]:
        cases.append((4, 256, 32, 32, [256] * 4, start, end, scale,
                      f"band ({start},{end})"))
    cases += [
        (2, 256, 16, 16, [128, 128], -10, 0, 0.1, "padded tail"),
        (2, 256, 16, 8, [216, 216], -100, 0, 0.125, "dv != d"),
        (3, 200, 64, 64, [200, 120, 0], -100, 0, scale, "S=200, empty row"),
        (4, 504, 64, 64, [504, 300, 150, 33], -100, 0, scale, "S=504"),
    ]
    worst = 0.0
    for bh, s, d, dv, lengths, start, end, sc, name in cases:
        q, k, v, valid = _attention_inputs(torch, bh, s, d, dv, lengths,
                                           seed=bh * s + d)
        got = ba.banded_attention(q, k, v, valid, start=start, end=end,
                                  scale=sc)
        want = ba.banded_attention_reference(q, k, v, valid, start, end, sc)
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.isfinite(got).all():
            raise AssertionError(f"banded_attention {name}: bad output")
        err = float((got - want).abs().max())
        # rows with no valid key in band must be exact zeros
        lens = torch.as_tensor(lengths, device=q.device)
        empty = torch.arange(s, device=q.device)[None, :] + start >= lens[:, None]
        if bool((got[empty] != 0).any()):
            raise AssertionError(f"banded_attention {name}: masked rows not 0")
        print(f"banded_attention {name}: bh={bh} S={s} d={d} dv={dv} "
              f"max_abs_err={err:.3e}")
        if not err <= KERNEL_ATOL:
            raise AssertionError(f"banded_attention {name}: error {err} > "
                                 f"{KERNEL_ATOL}")
        worst = max(worst, err)
    return worst


def time_ms(torch, fn, iters=100, warmup=10):
    """Mean time of ``fn`` on the card, by CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_banded_attention(torch, ba):
    """Kernel, plain and library times at the slice's shape: one decode
    batch of 8 utterances x 2 heads, S = 504 frames padded by the wrapper to
    the 64-frame tile, d = dv = 64, band (-100, 0)."""
    import torch.nn.functional as F

    bh, s, d = 16, 504, 64
    start, end, scale = -100, 0, 1.0 / math.sqrt(256.0)
    s_pad = -(-s // ba.BLOCK) * ba.BLOCK
    q, k, v, valid = _attention_inputs(
        torch, bh, s_pad, d, d, _slice_lengths(torch, 8, 2, s, 1), seed=7)

    pos = torch.arange(s_pad, device="cuda")
    rel = pos[None, :] - pos[:, None]
    allowed = ((rel >= start) & (rel <= end))[None] & (valid[:, None, :] > 0)
    pairs = int(allowed.sum())
    n_bytes = 4 * (q.numel() + k.numel() + v.numel() + v.numel()
                   + valid.numel())
    flops = pairs * (2 * d + 2 * d)
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS_PER_S * 1e3

    kernel_ms = time_ms(torch, lambda: ba._launch(q, k, v, valid, start, end,
                                                  scale))
    plain_ms = time_ms(torch, lambda: ba.banded_attention_reference(
        q, k, v, valid, start, end, scale))
    library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=allowed, scale=scale))
    wrapper_ms = time_ms(torch, lambda: ba.banded_attention(
        q[:, :s], k[:, :s], v[:, :s], valid[:, :s], start=start, end=end,
        scale=scale))
    print(f"banded_attention timing: BH={bh} S={s} (kernel S={s_pad}) d={d} "
          f"in-band pairs={pairs} bytes={n_bytes} flops={flops} "
          f"kernel_ms={kernel_ms:.6f} wrapper_ms={wrapper_ms:.6f} "
          f"plain_ms={plain_ms:.6f} sdpa_ms={library_ms:.6f} "
          f"bytes_bound_ms={bytes_ms:.6f} ops_bound_ms={ops_ms:.6f}")
    return {
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
    }


# ---------------------------------------------------------------------------
# slice phase
# ---------------------------------------------------------------------------


def write_data_dir(data_dir, kaldi_io, torch):
    """Seeded TIMIT-shaped data: feats.ark/scp, text, vocab.txt."""
    data_dir.mkdir(parents=True)
    g = torch.Generator().manual_seed(SEED)
    phones = [f"ph{i:02d}" for i in range(N_PHONES)]
    vocab = ["<blank>", "<unk>", "<s>", "</s>"] + phones
    with open(data_dir / "vocab.txt", "w") as f:
        for i, word in enumerate(vocab):
            f.write(f"{word} {i}\n")
    frames = 0
    with kaldi_io.ArkWriter(str(data_dir / "feats.ark"),
                            str(data_dir / "feats.scp")) as ark, \
            open(data_dir / "text", "w") as text:
        for u in range(N_UTTS):
            n = int(torch.randint(MIN_FRAMES, MAX_FRAMES + 1, (1,),
                                  generator=g))
            frames += n
            feats = torch.randn((n, FEAT_DIM), generator=g)
            key = f"utt{u:03d}"
            ark.write(key, feats.numpy())
            n_phones = max(1, n // 10)
            ids = torch.randint(0, N_PHONES, (n_phones,), generator=g)
            text.write(key + " " + " ".join(phones[i] for i in ids) + "\n")
    return frames


def read_nbest(path):
    """{key: [(score, words), ...]} of a decode.txt, checking each line."""
    out = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            key, score, words = line.rstrip("\n").split("\t")
            score = float(score)
            if not math.isfinite(score):
                raise AssertionError(f"non-finite score in {line!r}")
            out.setdefault(key, []).append((score, words))
    return out


def compare_nbest(gpu, cpu):
    """Scores within CPU_SCORE_ATOL lane by lane; words identical wherever
    a hypothesis's score is more than WORD_GAP from its neighbours'."""
    worst = 0.0
    for key, hyps in cpu.items():
        ref = gpu[key]
        if len(ref) != len(hyps):
            raise AssertionError(f"{key}: {len(ref)} vs {len(hyps)} lines")
        scores = [s for s, _ in ref]
        for i, ((s_g, w_g), (s_c, w_c)) in enumerate(zip(ref, hyps)):
            worst = max(worst, abs(s_g - s_c))
            if abs(s_g - s_c) > CPU_SCORE_ATOL:
                raise AssertionError(f"{key} rank {i}: score {s_g} (card) "
                                     f"vs {s_c} (cpu)")
            gaps = [abs(scores[i] - scores[j]) for j in (i - 1, i + 1)
                    if 0 <= j < len(scores)]
            if min(gaps, default=math.inf) > WORD_GAP and w_g != w_c:
                raise AssertionError(f"{key} rank {i}: words differ: "
                                     f"{w_g!r} vs {w_c!r}")
    return worst


def run_slice(torch, ba, device="cuda", model_args=RECIPE_MODEL):
    """The port's stage-3 and stage-5 entry points on ``device``, then the
    first decode batch again on the CPU.  Returns the run's numbers."""
    from pytorch_kaldi_asr_tpu_torch.data import read_vocab
    from pytorch_kaldi_asr_tpu_torch.data.loader import make_batch_loader
    from pytorch_kaldi_asr_tpu_torch.io import kaldi_io
    from pytorch_kaldi_asr_tpu_torch.recipes import decode, initialize_model

    if WORK.exists():
        shutil.rmtree(WORK)
    data = WORK / "data"
    frames = write_data_dir(data, kaldi_io, torch)
    model = WORK / "model"
    initialize_model.main([
        "-read_feats_scp_file", str(data / "feats.scp"),
        "-lda_mat_file", "identity", "-read_vocab_file",
        str(data / "vocab.txt"), "-seed", str(SEED),
        "-save_model_file", str(model), *model_args])

    def decode_args(data_dir, out, device):
        return ["-read_data_dir", str(data_dir), "-read_vocab_file",
                str(data / "vocab.txt"), "-load_model_file", str(model),
                "-save_result_file", str(out), "-device", device,
                "-batch_size", str(BATCH), "-beam_size", str(BEAM),
                "-nbest", str(NBEST), "-max_token_seq_len", str(MAX_TOKENS)]

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)

    # the main path: every launch count at 0 just before, read just after
    ba.banded_attention.launches = 0
    sync()
    t0 = time.perf_counter()
    decode.main(decode_args(data, WORK / "decode.txt", device))
    sync()
    decode_s = time.perf_counter() - t0
    launches = ba.banded_attention.launches

    t0 = time.perf_counter()
    decode.main(decode_args(data, WORK / "decode_again.txt", device))
    sync()
    decode_again_s = time.perf_counter() - t0

    loader = make_batch_loader(str(data), read_vocab(str(data / "vocab.txt")),
                               BATCH, mode="all", shuffle=False,
                               num_buckets=4)
    gpu = read_nbest(WORK / "decode.txt")
    if len(gpu) != N_UTTS or any(len(h) != NBEST for h in gpu.values()):
        raise AssertionError(f"expected {N_UTTS} utterances x {NBEST} "
                             f"n-best lines")
    compare_nbest(gpu, read_nbest(WORK / "decode_again.txt"))

    # the first decode batch again, on the CPU
    first = next(iter(loader))
    keys = [key for key, ok in zip(first.keys, first.valid) if ok]
    sub = WORK / "data_first_batch"
    sub.mkdir()
    scp = dict(kaldi_io.scp_entries(str(data / "feats.scp")))
    with open(sub / "feats.scp", "w") as f:
        f.writelines(f"{key} {scp[key]}\n" for key in keys)
    with open(data / "text") as src, open(sub / "text", "w") as dst:
        dst.writelines(line for line in src if line.split()[0] in keys)
    t0 = time.perf_counter()
    decode.main(decode_args(sub, WORK / "decode_cpu.txt", "cpu"))
    cpu_s = time.perf_counter() - t0
    cpu = read_nbest(WORK / "decode_cpu.txt")
    if sorted(cpu) != sorted(keys):
        raise AssertionError("the CPU decode covered other utterances")
    score_err = compare_nbest(gpu, cpu)

    audio_s = frames * 0.010
    return {
        "utterances": N_UTTS, "frames": frames, "batches": len(loader),
        "banded_attention_launches": launches,
        "decode_s": decode_s, "rtf": decode_s / audio_s,
        "decode_again_s": decode_again_s,
        "rtf_again": decode_again_s / audio_s,
        "cpu_first_batch_s": cpu_s, "cpu_vs_card_max_score_err": score_err,
    }


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a card",
              file=sys.stderr)
        return 2
    if not (REPO / "pytorch_kaldi_asr_tpu_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from pytorch_kaldi_asr_tpu_torch.ops import _build
    from pytorch_kaldi_asr_tpu_torch.ops import banded_attention as ba
    from pytorch_kaldi_asr_tpu_torch.utils.device import disable_tf32

    card = card_line()
    print(f"card: {card}")
    disable_tf32()

    t0 = time.perf_counter()
    logs = _build.build()
    print(f"built {sorted(logs) or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "ptxas" in line:
                print(f"  {name}: {line.strip()}")

    err = check_banded_attention(torch, ba)
    timing = time_banded_attention(torch, ba)
    summary = run_slice(torch, ba)
    expected = 3 * summary["batches"]  # en_layers x decode batches
    if summary["banded_attention_launches"] != expected:
        raise AssertionError(
            f"banded_attention launched {summary['banded_attention_launches']}"
            f" times in the decode, expected {expected}")
    summary["card"] = card
    print("slice: " + json.dumps(summary))

    kernels = [dict(
        name="banded_attention", route="cuda",
        source="pytorch_kaldi_asr_tpu_torch/ops/csrc/banded_attention.cu",
        replaces="pytorch_kaldi_asr_tpu/ops/banded_attention.py:112",
        launches=summary["banded_attention_launches"], max_abs_err=err,
        **timing)]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
