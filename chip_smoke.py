#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pytorch_kaldi_asr_tpu_torch) on one
CUDA card: ``python3 chip_smoke.py`` from the root of a checkout.

1. Requires a CUDA card; prints its name and power limit (nvidia-smi) and
   turns TF32 off for matmuls and cuDNN (the port is float32).
2. Builds every CUDA kernel of the port from ``ops/csrc`` (one nvcc per
   source, all started together) and prints what ptxas reports.
3. Kernel phase: holds each kernel against its plain PyTorch version on the
   card at the paths' shapes and at edge cases, then times the kernel, the
   plain version and the PyTorch library call that computes the same
   function, with CUDA events after warm-up.  K1 is the inference kernel;
   K2a/K2b/K2c (forward with lse, dq with delta, dk/dv) are held against
   autograd of the plain trainable version at dropout 0 and 0.35, at the
   TIMIT shape, at the conformer's (S 1600, band (-256, 256)) and at cases
   that reach each tile skip of the backward; one backward must be exactly
   one K2b and one K2c launch and no other device work; the backward pair
   is timed against SDPA's backward at dropout 0 and at the path's rate.
   Bounds take the faster float32 route: the CUDA cores, or for the
   attention products the TF32 tensor cores at three passes; K3 (fused dropout)
   forward and backward must match its plain version bit for bit (0 mask
   mismatches) at the conformer's [51200, 1024] and [51200, 256] for both
   thresholds at rates 0.1 and 0.35, and at edge cases.
4. TIMIT decode (stage 5): a seeded TIMIT-shaped data dir (16 utterances of
   40-dim features, 150-500 frames, a 52-entry phone vocabulary), the
   port's ``initialize_model`` at the recipe's widths with ``-encoder_type
   banded`` and its ``decode`` on the card with the recipe's stage-5 flags;
   checks the n-best lines and the K1 launches, decodes the first batch
   again on the CPU and compares, and prints the wall time and RTF.
5. TIMIT training (stages 3-4): train/dev/test dirs of 300/40/40
   utterances, the ``train`` CLI with the recipe's stage-4 flags for 2
   epochs, then the ``combine`` CLI.  Checks finite losses, the
   ``metrics.jsonl`` records, the checkpoint names, K2a/K2b/K2c at exactly
   en_layers x steps and K3 at exactly (dropout sites) x steps each way.
   Then one train step from model.init at the recipe's dropout, on the card
   and on the CPU (the masks are the same on both): loss and every
   gradient leaf must agree (``card_vs_cpu_step``; an ill-conditioned leaf
   is judged against a float64 CPU step).  Prints the step time and a
   profile.
6. and 7. The same for the conformer-librispeech recipe's model (8 + 4
   layers, d_model 256, 4 heads, band (-256, 256), 5000 words, dropout
   0.1) on LibriSpeech-shaped data (lognormal(7.0, 0.55) frames clipped to
   [150, 1600]): the decode of 16 utterances with the recipe's stage-5
   flags; then ``generate_archive`` (512 per archive) and ``train
   -train_archive_dir`` on 128/16/16 utterances at batch 32 for 2 epochs,
   ``combine``, the exact launch counts, and card against CPU on a batch of
   4 utterances with dropout on.
8. Prints the ``kernels`` JSON line, the card line, and as the last line
   ``{"ok": true, "device": {...}}``.  Any failure raises: the script then
   exits non-zero without the last line.

``python3 chip_smoke.py --train-step TREE [timit|librispeech]`` runs only
the train step of that recipe's model (default TIMIT; LibriSpeech is the
conformer at batch 32 x S 1600) with the port in the checkout ``TREE`` (for
instance a parent commit unpacked with ``git archive`` under ``build/``)
and prints one ``TRAIN_STEP`` JSON line: five timings of 20 steps and a
profile with every kernel's launches and the host's busiest operations per
step; for TIMIT, where the port has K3, also the same step with the
model's dropout drawn by the port's former draw (``former_draw``),
alternated with K3 in one process.  Run parent, change, change, parent
one after another on one card to compare two commits.

``python3 chip_smoke.py --k2-sources A.cu [B.cu ...]`` compares versions
of ``ops/csrc/banded_attention_train.cu`` (a parent's, or a copy with
``#define`` lines on top) in one process: each is built with the port's
nvcc flags (ptxas's registers and spills for ``dq_kernel`` and
``dkv_kernel`` printed), and at both train timing shapes their K2b and K2c
are timed in turns, three rounds, and held against the first source's
outputs; one ``K2_SOURCES`` JSON line per shape.

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
TF32_FLOPS_PER_S = 495e12  # TF32 tensor cores, dense
# float32 products on the TF32 tensor cores at float32 accuracy take three
# passes (3xTF32: big.big + big.small + small.big)
TF32_PASSES = 3

# the TIMIT recipe's model (recipes/attention-transformer-timit/run.sh)
# with the banded encoder
RECIPE_MODEL = [
    "-encoder_max_len", "500", "-decoder_max_len", "100", "-src_fold", "1",
    "-encoder_sub_sequence", "(-100,0)", "-decoder_sub_sequence", "(-10,0)",
    "-en_layers", "3", "-de_layers", "3", "-n_head", "2",
    "-en_d_model", "256", "-de_d_model", "128", "-d_k", "64", "-d_v", "64",
    "-en_dropout", "0.35", "-de_dropout", "0.35", "-encoder_type", "banded",
]
# the conformer-librispeech recipe's model (recipes/conformer-librispeech/
# run.sh:26-48, 88-110) with a float32 residual stream
CONFORMER_MODEL = [
    "-encoder_max_len", "1600", "-decoder_max_len", "100", "-src_fold", "1",
    "-encoder_sub_sequence", "(-256,256)", "-decoder_sub_sequence",
    "(-20,0)", "-en_layers", "8", "-de_layers", "4", "-n_head", "4",
    "-en_d_model", "256", "-de_d_model", "256", "-d_k", "64", "-d_v", "64",
    "-en_dropout", "0.1", "-de_dropout", "0.1", "-encoder_type", "conformer",
    "-conformer_stream_dtype", "float32",
]
FEAT_DIM, SEED = 40, 0
TIMIT = {
    "name": "timit", "model": RECIPE_MODEL, "frames": (150, 500),
    "words": [f"ph{i:02d}" for i in range(48)],  # + 4 control words = 52
    "decode": {"utts": 16, "batch": 8, "beam": 25, "nbest": 10,
               "buckets": 4, "max_tokens": 100},
    # stage-4 flags of run.sh:153-175; 3 steps per epoch
    "train": {"utts": {"train": 300, "dev": 40, "test": 40}, "batch": 100,
              "epochs": 2, "size_archive": None, "cpu_rows": None},
}
LIBRISPEECH = {
    "name": "librispeech", "model": CONFORMER_MODEL, "frames": (150, 1600),
    "lognormal": (7.0, 0.55),  # tools/make_librispeech_shaped.py:179-180
    "words": [f"w{i:04d}" for i in range(5000)],
    "decode": {"utts": 16, "batch": 8, "beam": 8, "nbest": 8, "buckets": 4,
               "max_tokens": 100},
    # run.sh:113-139 at batch 32; 4 steps per epoch.  The CPU side of the
    # card-vs-CPU step takes 4 utterances: the plain attention at 32 x 1600
    # would need about 40 GB
    "train": {"utts": {"train": 128, "dev": 16, "test": 16}, "batch": 32,
              "epochs": 2, "size_archive": 512, "cpu_rows": 4},
}
DROPOUT = 0.35  # the K2 checks' attention dropout (the TIMIT recipe's)

KERNEL_ATOL = 2e-5  # float32, summation order differs from the plain version
GRAD_ATOL = 1e-4  # float32 gradients, summed over the band in another order
STEP_LOSS_RTOL = 1e-5  # one train step, card vs CPU
STEP_GRAD_RTOL = 1e-4  # of the largest |gradient| of each leaf
# a leaf over STEP_GRAD_RTOL passes if the card is no further from a float64
# CPU step than this many times the CPU's own float32 result; the sound runs
# on the H100 read at most 1.00004 (TIMIT ffn.w1 of layer 2; src_proj.w 0.70)
FLOAT64_RATIO = 1.25
CPU_SCORE_ATOL = 1e-4  # card vs CPU n-best scores
WORD_GAP = 1e-3  # words must agree where scores are this far apart

# kernel names in a torch.profiler trace (all in anonymous namespaces)
PROFILE_NAMES = {
    "K1": "::banded_attention_kernel<", "K2a": "::fwd_kernel<",
    "K2b": "::dq_kernel<", "K2c": "::dkv_kernel<",
    "K3": "::fused_dropout_kernel",
}


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]


def launch_counts():
    """Every kernel wrapper's launch count, by name."""
    from pytorch_kaldi_asr_tpu_torch.ops import banded_attention as ba
    from pytorch_kaldi_asr_tpu_torch.ops import fused_dropout as fd

    counts = {fn.__name__: fn.launches for fn in (
        ba.banded_attention, ba.banded_attention_fwd, ba.banded_attention_dq,
        ba.banded_attention_dkv)}
    counts.update({f"fused_dropout_{k}": v
                   for k, v in fd.fused_dropout.launches.items()})
    return counts


def reset_launch_counts():
    from pytorch_kaldi_asr_tpu_torch.ops import banded_attention as ba
    from pytorch_kaldi_asr_tpu_torch.ops import fused_dropout as fd

    for fn in (ba.banded_attention, ba.banded_attention_fwd,
               ba.banded_attention_dq, ba.banded_attention_dkv):
        fn.launches = 0
    fd.fused_dropout.launches.update(forward=0, backward=0)


def dropout_sites(cfg):
    """K3 launches of one train step, each way, counted from the model code
    (models/transformer.py, models/encoders.py): the encoder's input
    dropout; per banded layer the attention block's output and the FFN's
    (and one after the final positions), per conformer layer two in each
    half-step FFN, one after the MHSA and one after the conv module; the
    decoder's embedding and output dropouts, and per layer the self- and
    cross-attention probabilities and outputs and the FFN's output."""
    if cfg.encoder_type == "banded":
        encoder = 1 + 2 * cfg.en_layers + 1
    elif cfg.encoder_type == "conformer":
        encoder = 1 + 6 * cfg.en_layers
    else:
        raise ValueError(f"no site count for {cfg.encoder_type}")
    return encoder + 2 + 5 * cfg.de_layers


# ---------------------------------------------------------------------------
# kernel phase: K1, K2a-c
# ---------------------------------------------------------------------------


def _attention_inputs(torch, bh, s, d, dv, lengths, seed):
    """Seeded q, k, v and key_valid on the card; ``lengths`` are per-row
    valid prefixes, or a [bh, s] mask of valid keys."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((bh, s, d), generator=g)
    k = torch.randn((bh, s, d), generator=g)
    v = torch.randn((bh, s, dv), generator=g)
    lengths = torch.as_tensor(lengths)
    valid = lengths if lengths.dim() == 2 else (
        torch.arange(s)[None, :] < lengths[:, None])
    return q.cuda(), k.cuda(), v.cuda(), valid.to(torch.int32).cuda()


def _holes(torch, bh, s, seed):
    """A key mask that is no prefix: 30 % of the keys invalid at random,
    and the whole second 64-key tile invalid."""
    g = torch.Generator().manual_seed(seed)
    valid = torch.rand((bh, s), generator=g) > 0.3
    valid[:, 64:128] = False
    return valid


def _lengths(torch, corpus, n_utts, heads, s, seed):
    """Key-valid lengths of ``n_utts`` utterances of ``corpus``'s length
    distribution cut at ``s``, each repeated per head (b-major, as the
    encoder folds heads)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lens = [min(_utterance_frames(rng, corpus), s) for _ in range(n_utts)]
    return torch.as_tensor(lens).repeat_interleave(heads)


# (bh, s, d, band, corpus, utterances, heads) of K1 and K2 at each path
ATTN_SHAPES = {
    "timit_decode": (16, 504, 64, (-100, 0), TIMIT, 8, 2),
    "conformer_decode": (32, 1600, 64, (-256, 256), LIBRISPEECH, 8, 4),
    "conformer_train": (128, 1600, 64, (-256, 256), LIBRISPEECH, 32, 4),
}


def check_banded_attention(torch, ba):
    """Kernel vs plain version on the card; returns the max abs error."""
    scale = 1.0 / math.sqrt(256.0)
    # (bh, s, d, dv, lengths, start, end, scale, name)
    cases = []
    for name in ("timit_decode", "conformer_decode"):
        bh, s, d, (start, end), corpus, n, heads = ATTN_SHAPES[name]
        cases.append((bh, s, d, d, _lengths(torch, corpus, n, heads, s, 1),
                      start, end, scale, f"{name} shape"))
    for start, end in [(-100, 0), (-10, 0), (-64, 32), (-300, 0),
                       (-256, 256)]:
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
              f"band=({start},{end}) max_abs_err={err:.3e}")
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


def _bound(n_bytes, flops, tensor_cores=False):
    """(bound_ms, bound_by) on the H100's published peaks: the bytes over
    the memory rate or the operations over the faster float32 route,
    whichever takes longer.  The attention products (``tensor_cores``) take
    the TF32 tensor cores at TF32_PASSES passes (3 / 495 TFLOP/s, faster
    than the CUDA cores' 1 / 67); other float32 work the CUDA cores."""
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    rate = TF32_FLOPS_PER_S / TF32_PASSES if tensor_cores else F32_FLOPS_PER_S
    ops_ms = flops / rate * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def _allowed(torch, s, start, end, valid):
    pos = torch.arange(s, device="cuda")
    rel = pos[None, :] - pos[:, None]
    return ((rel >= start) & (rel <= end))[None] & (valid[:, None, :] > 0)


def time_banded_attention(torch, ba, shape):
    """K1, its plain version and the library call at one decode batch of
    ``shape`` (ATTN_SHAPES), S padded by the wrapper to the 64-frame tile."""
    import torch.nn.functional as F

    bh, s, d, (start, end), corpus, n, heads = ATTN_SHAPES[shape]
    scale = 1.0 / math.sqrt(256.0)
    s_pad = -(-s // ba.BLOCK) * ba.BLOCK
    q, k, v, valid = _attention_inputs(
        torch, bh, s_pad, d, d, _lengths(torch, corpus, n, heads, s, 1),
        seed=7)
    allowed = _allowed(torch, s_pad, start, end, valid)
    pairs = int(allowed.sum())
    n_bytes = 4 * (q.numel() + k.numel() + v.numel() + v.numel()
                   + valid.numel())
    bound_ms, bound_by = _bound(n_bytes, pairs * (2 * d + 2 * d),
                                tensor_cores=True)
    plain_iters = 100 if s_pad <= 512 else 10
    kernel_ms = time_ms(torch, lambda: ba._launch(q, k, v, valid, start, end,
                                                  scale))
    plain_ms = time_ms(torch, lambda: ba.banded_attention_reference(
        q, k, v, valid, start, end, scale), iters=plain_iters, warmup=2)
    library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=allowed, scale=scale))
    print(f"banded_attention timing ({shape}): BH={bh} S={s} (kernel "
          f"S={s_pad}) d={d} band=({start},{end}) in-band pairs={pairs} "
          f"bytes={n_bytes} kernel_ms={kernel_ms:.6f} plain_ms={plain_ms:.6f} "
          f"sdpa_ms={library_ms:.6f} bound_ms={bound_ms:.6f} ({bound_by})")
    return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def _grads(fn, q, k, v, dout):
    """(out, dq, dk, dv) of ``fn`` by autograd."""
    q, k, v = (x.detach().clone().requires_grad_() for x in (q, k, v))
    out = fn(q, k, v)
    out.backward(dout)
    return out.detach(), q.grad, k.grad, v.grad


def check_trainable_attention(torch, ba):
    """K2a/K2b/K2c through the autograd function vs autograd of the plain
    trainable version on the card, at dropout 0 and 0.35, at the paths'
    shapes and at the cases that reach each skip of the backward's tiling:
    band edges on a tile boundary, whole invalid key tiles and dead query
    tiles, a key mask that is no prefix, dv != d, d a multiple of 4 but not
    of 8, and the largest head dims.  Returns the max abs error per kernel:
    K2a out and lse, K2b dq, K2c dk and dv."""
    scale = 1.0 / math.sqrt(256.0)
    bh, s, d, (start, end), corpus, n, heads = ATTN_SHAPES["conformer_train"]
    cases = [
        (200, 504, 64, 64, _lengths(torch, TIMIT, 100, 2, 504, 2), -100, 0,
         scale, "timit_train shape"),
        # the conformer's band at S 1600, 8 of its 32 utterances
        (bh // 4, s, d, d, _lengths(torch, corpus, n // 4, heads, s, 2),
         start, end, scale, "conformer_train shape (8 utterances)"),
        (4, 256, 32, 32, [256] * 4, -10, 0, scale, "band (-10,0)"),
        (4, 256, 32, 32, [256] * 4, -64, 32, scale, "band (-64,32)"),
        (2, 256, 16, 16, [128, 128], -10, 0, 0.1, "padded tail"),
        (2, 256, 16, 8, [216, 216], -100, 0, 0.125, "dv != d"),
        (3, 200, 64, 64, [200, 120, 0], -100, 0, scale, "S=200, empty row"),
        (4, 256, 32, 32, [256, 200, 100, 30], -64, 64, scale,
         "band (-64,64) on tile edges"),
        (4, 256, 32, 32, [256, 200, 100, 30], -65, 0, scale, "band (-65,0)"),
        (2, 640, 64, 64, [640, 500], -256, 256, scale,
         "band (-256,256) S 640"),
        (4, 512, 64, 64, [512, 200, 64, 0], -100, 0, scale,
         "invalid key tiles, dead query tiles"),
        (4, 512, 32, 32, [512, 130, 64, 0], -30, 30, scale,
         "invalid key tiles, band (-30,30)"),
        (2, 256, 16, 16, _holes(torch, 2, 256, 3), -40, 40, 0.25,
         "key mask no prefix"),
        (4, 256, 64, 32, [256, 180, 90, 0], -64, 32, scale, "d 64, dv 32"),
        (4, 256, 12, 12, [256, 180, 90, 0], -40, 8, 0.3, "d 12"),
        (2, 256, 128, 128, [256, 100], -100, 20, scale, "d 128"),
    ]
    worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    for rate in (0.0, DROPOUT):
        for bh, s, d, dv, lengths, start, end, sc, name in cases:
            q, k, v, valid = _attention_inputs(torch, bh, s, d, dv, lengths,
                                               seed=bh * s + d + 1)
            dout = torch.randn(v.shape, generator=torch.Generator()
                               .manual_seed(s)).cuda()
            kw = dict(start=start, end=end, scale=sc, dropout_rate=rate)
            got = _grads(lambda q, k, v: ba.banded_attention_trainable(
                q, k, v, valid, 4321, **kw), q, k, v, dout)
            want = _grads(lambda q, k, v: ba.banded_attention_trainable_reference(
                q, k, v, valid, 4321, start, end, sc, rate)[0], q, k, v, dout)
            padded = ba._check_and_pad(q, k, v, valid, start, end)
            _, lse = ba.banded_attention_fwd(*padded, 4321, **kw)
            _, lse_want = ba.banded_attention_trainable_reference(
                *padded, 4321, start, end, sc, rate)
            torch.cuda.synchronize()
            if any(not torch.isfinite(x).all() for x in got):
                raise AssertionError(f"trainable {name}: non-finite output")
            if not torch.equal(torch.isfinite(lse), torch.isfinite(lse_want)):
                raise AssertionError(f"trainable {name}: lse -inf rows differ")
            live = torch.isfinite(lse_want)
            errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
            errs.append(float((lse[live] - lse_want[live]).abs().max()))
            # rows with no valid key in band and invalid keys: exact zeros,
            # gradients too
            empty = ~_allowed(torch, s, start, end, valid).any(-1)
            invalid = valid == 0
            if bool((got[0][empty] != 0).any() or (got[1][empty] != 0).any()
                    or (got[2][invalid] != 0).any()
                    or (got[3][invalid] != 0).any()):
                raise AssertionError(f"trainable {name}: masked rows not 0")
            print(f"trainable attention {name} rate={rate}: bh={bh} S={s} "
                  f"d={d} dv={dv} err out={errs[0]:.2e} lse={errs[4]:.2e} "
                  f"dq={errs[1]:.2e} dk={errs[2]:.2e} dv={errs[3]:.2e}")
            if max(errs[0], errs[4]) > KERNEL_ATOL or max(errs[1:4]) > GRAD_ATOL:
                raise AssertionError(f"trainable {name} rate={rate}: errors "
                                     f"{errs} over {KERNEL_ATOL}/{GRAD_ATOL}")
            worst["fwd"] = max(worst["fwd"], errs[0], errs[4])
            worst["dq"] = max(worst["dq"], errs[1])
            worst["dkv"] = max(worst["dkv"], errs[2], errs[3])
            del got, want
    return worst


def device_kernels(torch, fn):
    """{kernel name: launches} on the card while ``fn`` runs (its work
    synchronised), from torch.profiler: every kernel, copy and fill."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in _kernel_rows(prof.key_averages())[1]}


def _kernel_rows(events):
    """(device rows, those of them that are kernels, copies and fills) of
    torch.profiler's ``key_averages()``: not the GPU ranges of user
    annotations such as "Optimizer.step#Adam.step", which span the kernels
    inside them and carry the name of a host row.  (A kernel's name may
    hold "#" too: "{lambda()#1}" in every TensorIterator kernel built from
    a lambda, such as where, compare and the random draws.)"""
    from torch.autograd import DeviceType

    host_names = {e.key for e in events if e.device_type == DeviceType.CPU}
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    return device, [e for e in device
                    if not getattr(e, "is_user_annotation", False)
                    and e.key not in host_names]


def check_backward_launches(torch, ba):
    """One backward of the trainable attention on the card is exactly two
    kernels, K2b (with delta) then K2c, and no other device work; counted
    by the wrappers and by torch.profiler at the conformer's band."""
    q, k, v, valid = _attention_inputs(torch, 8, 1600, 64, 64,
                                       [1600, 1200] * 4, seed=12)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    dout = torch.randn(v.shape, device="cuda")
    out = ba.banded_attention_trainable(q, k, v, valid, 7, start=-256,
                                        end=256, scale=0.0625,
                                        dropout_rate=0.1)
    wrappers = (ba.banded_attention_dq, ba.banded_attention_dkv)
    before = [fn.launches for fn in wrappers]
    kernels = device_kernels(torch, lambda: torch.autograd.grad(
        out, (q, k, v), dout))
    launched = tuple(fn.launches - n for fn, n in zip(wrappers, before))
    ours = [any(PROFILE_NAMES[kn] in name for name in kernels)
            for kn in ("K2b", "K2c")]
    print(f"one backward of the trainable attention: wrapper launches "
          f"(K2b, K2c) = {launched}; device kernels {kernels}")
    if launched != (1, 1) or sum(kernels.values()) != 2 or not all(ours):
        raise AssertionError(f"backward launched {kernels}, expected one "
                             f"dq_kernel and one dkv_kernel")
    return kernels


# (bh, s, d, band, lengths, rate) of the K2 timings
TRAIN_TIMING_SHAPES = {
    # the TIMIT training slice: batch 100 x 2 heads, utterances of 412-504
    # frames (no empty query row, so SDPA's softmax is defined everywhere)
    "timit_train": (200, 512, 64, (-100, 0), "timit", DROPOUT),
    # the conformer's train batch: 32 x 4 heads, archives padded to 1600
    "conformer_train": (128, 1600, 64, (-256, 256), "librispeech", 0.1),
}


def train_timing_inputs(torch, ba, shape):
    """(q, k, v, valid, dout, out, lse, seed, kw) at ``shape``
    (TRAIN_TIMING_SHAPES): seeded inputs on the card, the forward's out and
    lse, and the kernels' keyword arguments at the path's rate."""
    bh, s, d, (start, end), lengths, rate = TRAIN_TIMING_SHAPES[shape]
    scale, seed = 1.0 / math.sqrt(256.0), 99
    g = torch.Generator().manual_seed(5)
    if lengths == "timit":
        lengths = torch.randint(412, 505, (bh // 2,),
                                generator=g).repeat_interleave(2)
    else:
        lengths = _lengths(torch, LIBRISPEECH, bh // 4, 4, s, 5)
    q, k, v, valid = _attention_inputs(torch, bh, s, d, d, lengths, seed=8)
    dout = torch.randn((bh, s, d), generator=g).cuda()
    kw = dict(start=start, end=end, scale=scale, dropout_rate=rate)
    out, lse = ba.banded_attention_fwd(q, k, v, valid, seed, **kw)
    return q, k, v, valid, dout, out, lse, seed, kw


def time_trainable_attention(torch, ba, shape):
    """K2a, K2b and K2c, their plain versions and the library call at
    ``shape`` (TRAIN_TIMING_SHAPES); and the backward as the model runs it,
    K2b (with delta) then K2c, at dropout 0 (like for like with SDPA's
    backward, which computes the same dq, dk and dv) and at the path's
    rate.  SDPA (forward; backward for dq and dk/dv together) runs at
    dropout 0 with the same boolean band mask."""
    import torch.nn.functional as F

    bh, s, d, (start, end), _, rate = TRAIN_TIMING_SHAPES[shape]
    q, k, v, valid, dout, out, lse, seed, kw = train_timing_inputs(
        torch, ba, shape)
    scale = kw["scale"]
    dq_args = (q, k, v, valid, dout, out, lse, seed)
    _, delta = ba.banded_attention_dq(*dq_args, **kw)
    dkv_args = (q, k, v, valid, dout, lse, delta, seed)

    allowed = _allowed(torch, s, start, end, valid)
    pairs = int(allowed.sum())
    vec = 4 * bh * s * d  # bytes of one [BH, S, 64] float32 tensor
    row = 4 * bh * s  # bytes of one [BH, S] int32/float32 tensor
    bounds = {  # (bytes: inputs once, outputs once; flops per in-band pair)
        "fwd": _bound(4 * vec + 2 * row, pairs * 4 * d, tensor_cores=True),
        "dq": _bound(6 * vec + 3 * row, pairs * 6 * d + 2 * bh * s * d,
                     tensor_cores=True),
        "dkv": _bound(6 * vec + 3 * row, pairs * 8 * d, tensor_cores=True),
        # the pair's function: q, k, v, dout, out, lse, key_valid in; dq,
        # dk, dv out; five products per pair (S, dP, dV, dK, dQ) and delta.
        # K2b's recomputation of S and dP is a cost of the two-kernel design
        "backward": _bound(8 * vec + 2 * row, pairs * 10 * d + 2 * bh * s * d,
                           tensor_cores=True),
    }
    timed = dict(iters=20, warmup=3)
    kernel_ms = {
        "fwd": time_ms(torch, lambda: ba.banded_attention_fwd(
            q, k, v, valid, seed, **kw), **timed),
        "dq": time_ms(torch, lambda: ba.banded_attention_dq(*dq_args, **kw),
                      **timed),
        "dkv": time_ms(torch, lambda: ba.banded_attention_dkv(*dkv_args,
                                                              **kw),
                       **timed),
    }

    def backward_pair(rate):
        band = dict(kw, dropout_rate=rate)
        _, dl = ba.banded_attention_dq(*dq_args, **band)
        ba.banded_attention_dkv(q, k, v, valid, dout, lse, dl, seed, **band)

    # the forward's lse at rate 0 is the same: the normaliser is undropped
    pair_ms = {r: time_ms(torch, lambda: backward_pair(r), **timed)
               for r in (0.0, rate)}
    band = (start, end, scale, rate)
    plain = dict(iters=3, warmup=1)
    with torch.no_grad():
        plain_ms = {
            "fwd": time_ms(torch, lambda: ba.banded_attention_trainable_reference(
                q, k, v, valid, seed, *band), **plain),
            "dq": time_ms(torch, lambda: ba.banded_attention_dq_reference(
                *dq_args, *band), **plain),
            "dkv": time_ms(torch, lambda: ba.banded_attention_dkv_reference(
                *dkv_args, *band), **plain),
        }
    sdpa_fwd_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=allowed, scale=scale), **timed)
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=allowed,
                                              scale=scale)
    sdpa_bwd_ms = time_ms(torch, lambda: torch.autograd.grad(
        sdpa_out, (qg, kg, vg), dout, retain_graph=True), **timed)
    del sdpa_out, qg, kg, vg
    library_ms = {"fwd": sdpa_fwd_ms, "dq": sdpa_bwd_ms, "dkv": sdpa_bwd_ms}

    # forward + backward as the model runs it: the autograd function (K2a,
    # K2b with delta, K2c)
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    path_ms = time_ms(torch, lambda: torch.autograd.grad(
        ba.banded_attention_trainable(qg, kg, vg, valid, seed, **kw),
        (qg, kg, vg), dout), **timed)
    print(f"trainable attention timing ({shape}): BH={bh} S={s} d={d} "
          f"band=({start},{end}) rate={rate} in-band pairs={pairs} "
          f"kernel_ms={kernel_ms} plain_ms={plain_ms} "
          f"sdpa_fwd_ms={sdpa_fwd_ms:.6f} sdpa_bwd_ms={sdpa_bwd_ms:.6f} "
          f"backward K2b+K2c: rate 0 {pair_ms[0.0]:.6f} ms, rate {rate} "
          f"{pair_ms[rate]:.6f} ms (bound {bounds['backward'][0]:.6f}) "
          f"against sdpa_bwd {sdpa_bwd_ms:.6f} ms; "
          f"fwd+bwd: kernels_ms={path_ms:.6f} "
          f"sdpa_ms={sdpa_fwd_ms + sdpa_bwd_ms:.6f} bounds={bounds}")
    rows = {name: {"ms": kernel_ms[name], "plain_ms": plain_ms[name],
                   "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
                   "library_ms": library_ms[name]}
            for name in kernel_ms}
    for name in ("dq", "dkv"):  # the pair against the one library call
        rows[name].update(backward_pair_ms=pair_ms[0.0],
                          backward_pair_ms_at_rate=pair_ms[rate],
                          backward_pair_bound_ms=bounds["backward"][0])
    return rows


def start_k2_builds(sources):
    """Start one nvcc per version of banded_attention_train.cu in
    ``sources``, with the port's flags, into build/chip_smoke/k2_sources/;
    returns {source: (process, library path)}."""
    from pytorch_kaldi_asr_tpu_torch.ops import _build

    out_dir = WORK / "k2_sources"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, src in enumerate(sources):
        lib = out_dir / f"{i}-{src.stem}.so"
        procs[src] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    return procs


def finish_k2_builds(procs):
    """{source: ctypes library} of start_k2_builds' processes; prints
    ptxas's registers and spills for each dq_kernel and dkv_kernel."""
    import ctypes
    import re

    libs = {}
    for src, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{log}")
        entry = None
        for line in log.splitlines():
            found = re.search(r"(dq_kernel|dkv_kernel)ILi(\d+)E", line)
            if "Compiling entry function" in line:
                entry = f"{found[1]}<{found[2]}>" if found else None
            elif entry and ("Used" in line or "spill" in line):
                print(f"  {src.name} {entry}: "
                      f"{line.split('ptxas info', 1)[-1].strip(' :')}")
        libs[src] = ctypes.CDLL(str(lib))
    return libs


def compare_k2_sources(torch, ba, libs, rounds=3):
    """K2b (dq with delta) and K2c (dk/dv) of each build in ``libs``
    ({source: ctypes library}) at each TRAIN_TIMING_SHAPES shape, on the
    same inputs at the path's rate: CUDA-event times in ``rounds`` rounds
    that take the builds in turns, and each build's largest difference from
    the first build's dq, delta, dk and dv."""
    fns = {src: {w: ba.train_entry(lib, w) for w in ("dq", "dkv")}
           for src, lib in libs.items()}
    results = {}
    for shape in TRAIN_TIMING_SHAPES:
        q, k, v, valid, dout, out, lse, seed, kw = train_timing_inputs(
            torch, ba, shape)
        bh, s, d = q.shape
        scalars = (bh, s, d, v.shape[-1], kw["start"], kw["end"], kw["scale"],
                   *ba._dropout_args(seed, kw["dropout_rate"]))
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
        delta = torch.empty_like(lse)
        tensors = {"dq": (q, k, v, dout, out, lse, valid, dq, delta),
                   "dkv": (q, k, v, dout, lse, delta, valid, dk, dv)}

        def launch(src, which):
            ptrs = [t.data_ptr() for t in tensors[which]]
            return lambda: ba._run(f"{src.name} {which}", fns[src][which],
                                   q.device, *ptrs, *scalars)

        first, diff = None, {}
        for src in libs:
            launch(src, "dq")()
            launch(src, "dkv")()
            got = [x.clone() for x in (dq, delta, dk, dv)]
            first = got if first is None else first
            diff[src] = max(float((a - b).abs().max())
                            for a, b in zip(got, first))
        times = {src: {"dq": [], "dkv": []} for src in libs}
        for _ in range(rounds):
            for src in libs:
                for which in ("dq", "dkv"):
                    times[src][which].append(time_ms(
                        torch, launch(src, which), iters=20, warmup=3))
        results[shape] = {str(src): {"dq_ms": times[src]["dq"],
                                     "dkv_ms": times[src]["dkv"],
                                     "max_diff_from_first": diff[src]}
                          for src in libs}
    return results


# ---------------------------------------------------------------------------
# kernel phase: K3
# ---------------------------------------------------------------------------

K3_SHAPES = ((51200, 1024), (51200, 256))  # the conformer's sites at 32 x 1600


def _k3_thresholds(fd, rate):
    """{name: (threshold, scale)} of the kernel's two users at ``rate``."""
    q = round((1.0 - rate) * 256)
    return {"8-bit": ((256 - q) << 24, 256.0 / q),
            "exact": (fd.fused_dropout_threshold(rate), 1.0 / (1.0 - rate))}


def check_fused_dropout(torch, fd):
    """K3 forward and backward against its plain version on the card: the
    same mask (0 mismatches), outputs and gradients bit-equal, at the
    conformer's shapes for both thresholds at rates 0.1 and 0.35, and at
    edge cases.  Returns the max abs error (0 when all is bit-equal)."""
    import numpy as np

    g = torch.Generator(device="cuda").manual_seed(3)
    cases = [(shape, rate, which, "contiguous")
             for shape in K3_SHAPES for rate in (0.1, 0.35)
             for which in ("8-bit", "exact")]
    cases += [((4097, 3), 0.35, "exact", "size % 4 != 0"),
              ((1024, 256), 0.1, "8-bit", "non-contiguous"),
              ((1, 1024), 0.35, "exact", "one row"),
              ((51200, 256), 0.0, "exact", "rate 0")]
    for shape, rate, which, name in cases:
        threshold, scale = _k3_thresholds(fd, rate)[which]
        scale32 = float(np.float32(scale))
        x = torch.randn(shape, generator=g, device="cuda")
        if name == "non-contiguous":
            x = x.t()
        x.requires_grad_()
        dout = torch.randn(x.shape, generator=g, device="cuda")
        seed = 20240 + int(rate * 100)
        y = fd.masked_dropout(x, seed, threshold, scale)
        y.backward(dout)
        want = fd.fused_dropout_reference(x.detach(), seed, threshold,
                                          scale32)
        want_grad = fd.fused_dropout_reference(dout, seed, threshold,
                                               scale32)
        torch.cuda.synchronize()
        mismatches = int(((y != 0) != (want != 0)).sum())
        kept = float((y != 0).float().mean())
        print(f"fused_dropout {name} {list(shape)} rate={rate} {which}: "
              f"mask mismatches={mismatches} keep={kept:.6f} "
              f"out bit-equal={torch.equal(y, want)} "
              f"grad bit-equal={torch.equal(x.grad, want_grad)}")
        if mismatches or not torch.equal(y, want) \
                or not torch.equal(x.grad, want_grad):
            raise AssertionError(f"fused_dropout {name} {shape} {rate} "
                                 f"{which}: kernel and plain version differ")
    if fd.fused_dropout(x, 0.0, 1, True) is not x:
        raise AssertionError("fused_dropout at rate 0 is not the identity")
    return 0.0


def former_draw(torch, x, q, generator):
    """The port's dropout before K3: a uint8 draw per element from a
    generator on the card, kept below ``q``, scaled by 256/q.  Five
    launches forward (draw, compare, multiply, a fill for the scalar 0,
    where) and three backward (fill, where, multiply)."""
    bits = torch.randint(0, 256, x.shape, generator=generator,
                         device=x.device, dtype=torch.uint8)
    return torch.where(bits < q, x * (256.0 / q), 0.0)


def k3_host_us(torch, fd, rate=0.1, shape=(64, 256), n=2000):
    """Host microseconds per call at a shape small enough that the card
    keeps up (wall time of ``n`` calls, one synchronize at the end): K3
    through ``masked_dropout`` forward and forward + backward, its parts
    (``dropout_mask_pass``; a device guard with a Stream object, which the
    wrapper takes only off the current device; the bare ctypes launch), and
    the former 8-bit draw forward and forward + backward."""
    x = torch.randn(shape, device="cuda", requires_grad=True)
    dout = torch.ones(shape, device="cuda")
    xd, out = x.detach(), torch.empty(shape, device="cuda")
    threshold, scale = _k3_thresholds(fd, rate)["8-bit"]
    q = round((1.0 - rate) * 256)
    gen = torch.Generator(device="cuda").manual_seed(2)
    launch = fd._kernel_fn()
    k0, k1 = fd._key(7)
    stream = torch.cuda.current_stream().cuda_stream

    def guard_and_stream():
        with torch.cuda.device(xd.device):
            return torch.cuda.current_stream().cuda_stream

    cases = {
        "k3_forward": lambda: fd.masked_dropout(x, 7, threshold, scale),
        "k3_forward_backward": lambda: torch.autograd.grad(
            fd.masked_dropout(x, 7, threshold, scale), x, dout),
        "dropout_mask_pass": lambda: fd.dropout_mask_pass(
            xd, 7, threshold, scale),
        "device_guard_and_stream": guard_and_stream,
        "bare_launch": lambda: launch(xd.data_ptr(), out.data_ptr(),
                                      xd.numel(), k0, k1, threshold, scale,
                                      stream),
        "former_draw_forward": lambda: former_draw(torch, x, q, gen),
        "former_draw_forward_backward": lambda: torch.autograd.grad(
            former_draw(torch, x, q, gen), x, dout),
    }
    us = {}
    for name, fn in cases.items():
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        us[name] = (time.perf_counter() - t0) / n * 1e6
    print(f"fused_dropout host cost per call, {list(shape)}: "
          + json.dumps(us))
    return us


def time_fused_dropout(torch, fd, shape=K3_SHAPES[0], rate=0.1):
    """K3 (the model's 8-bit threshold), its plain version, ``F.dropout``
    (the same bytes, another generator) and the port's former 8-bit draw
    (``former_draw``, five launches) at ``shape``."""
    import torch.nn.functional as F

    x = torch.randn(shape, generator=torch.Generator(device="cuda")
                    .manual_seed(1), device="cuda")
    threshold, scale = _k3_thresholds(fd, rate)["8-bit"]
    q = round((1.0 - rate) * 256)
    gen = torch.Generator(device="cuda").manual_seed(2)

    kernel_ms = time_ms(torch, lambda: fd.dropout_mask_pass(
        x, 7, threshold, scale))
    plain_ms = time_ms(torch, lambda: fd.fused_dropout_reference(
        x, 7, threshold, scale), iters=10, warmup=2)
    library_ms = time_ms(torch, lambda: F.dropout(x, rate, training=True))
    former_ms = time_ms(torch, lambda: former_draw(torch, x, q, gen))
    bound_ms, bound_by = _bound(8 * x.numel(), x.numel())
    print(f"fused_dropout timing: {list(shape)} rate={rate} (8-bit) "
          f"kernel_ms={kernel_ms:.6f} plain_ms={plain_ms:.6f} "
          f"F.dropout_ms={library_ms:.6f} former_draw_ms={former_ms:.6f} "
          f"bound_ms={bound_ms:.6f} ({bound_by}) "
          f"achieved_GB/s={8 * x.numel() / kernel_ms / 1e6:.1f}")
    return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "former_draw_ms": former_ms,
            "host_us": k3_host_us(torch, fd, rate)}


# ---------------------------------------------------------------------------
# the paths: decode and training of each recipe's model
# ---------------------------------------------------------------------------


def _utterance_frames(rng, corpus):
    lo, hi = corpus["frames"]
    if "lognormal" in corpus:
        mean, sigma = corpus["lognormal"]
        return int(min(max(math.exp(rng.normal(mean, sigma)), lo), hi))
    return int(rng.integers(lo, hi + 1))


def write_data_dir(data_dir, kaldi_io, torch, corpus, n_utts, seed=SEED):
    """A seeded data dir of ``corpus``'s shape: feats.ark/scp, text and
    vocab.txt (4 control words + the corpus's words).  TIMIT keeps the
    generator of earlier runs (torch), so its data stay the same.  Returns
    the number of frames."""
    import numpy as np

    data_dir.mkdir(parents=True)
    words = corpus["words"]
    with open(data_dir / "vocab.txt", "w") as f:
        for i, word in enumerate(["<blank>", "<unk>", "<s>", "</s>"] + words):
            f.write(f"{word} {i}\n")
    if corpus is TIMIT:
        g = torch.Generator().manual_seed(seed)
        lo, hi = corpus["frames"]

        def draw():
            n = int(torch.randint(lo, hi + 1, (1,), generator=g))
            feats = torch.randn((n, FEAT_DIM), generator=g).numpy()
            ids = torch.randint(0, len(words), (max(1, n // 10),),
                                generator=g)
            return feats, ids.tolist()
    else:
        rng = np.random.default_rng(seed)

        def draw():  # about LibriSpeech's 2.9 words per second
            n = _utterance_frames(rng, corpus)
            feats = rng.normal(size=(n, FEAT_DIM)).astype(np.float32)
            return feats, rng.integers(0, len(words), max(1, n // 35)).tolist()
    frames = 0
    with kaldi_io.ArkWriter(str(data_dir / "feats.ark"),
                            str(data_dir / "feats.scp")) as ark, \
            open(data_dir / "text", "w") as text:
        for u in range(n_utts):
            feats, ids = draw()
            frames += feats.shape[0]
            key = f"utt{u:03d}"
            ark.write(key, feats)
            text.write(key + " " + " ".join(words[i] for i in ids) + "\n")
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


def _sync(torch, device):
    return torch.cuda.synchronize if device == "cuda" else (lambda: None)


def run_slice(torch, corpus=TIMIT, device="cuda", model_args=None):
    """Stage 3 and stage 5 of ``corpus``'s recipe with the port on
    ``device``, then the first decode batch again on the CPU.  Returns the
    run's numbers; ``launches`` are the decode's."""
    from pytorch_kaldi_asr_tpu_torch.data import read_vocab
    from pytorch_kaldi_asr_tpu_torch.data.loader import make_batch_loader
    from pytorch_kaldi_asr_tpu_torch.io import kaldi_io
    from pytorch_kaldi_asr_tpu_torch.recipes import decode, initialize_model

    spec = corpus["decode"]
    work = WORK / corpus["name"] / "decode"
    if work.exists():
        shutil.rmtree(work)
    data = work / "data"
    frames = write_data_dir(data, kaldi_io, torch, corpus, spec["utts"])
    model = work / "model"
    initialize_model.main([
        "-read_feats_scp_file", str(data / "feats.scp"),
        "-lda_mat_file", "identity", "-read_vocab_file",
        str(data / "vocab.txt"), "-seed", str(SEED),
        "-save_model_file", str(model), *(model_args or corpus["model"])])

    def decode_args(data_dir, out, device):
        return ["-read_data_dir", str(data_dir), "-read_vocab_file",
                str(data / "vocab.txt"), "-load_model_file", str(model),
                "-save_result_file", str(out), "-device", device,
                "-batch_size", str(spec["batch"]), "-num_buckets",
                str(spec["buckets"]), "-beam_size", str(spec["beam"]),
                "-nbest", str(spec["nbest"]), "-max_token_seq_len",
                str(spec["max_tokens"])]

    sync = _sync(torch, device)
    # the main path: every launch count at 0 just before, read just after
    reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    decode.main(decode_args(data, work / "decode.txt", device))
    sync()
    decode_s = time.perf_counter() - t0
    launches = launch_counts()

    t0 = time.perf_counter()
    decode.main(decode_args(data, work / "decode_again.txt", device))
    sync()
    decode_again_s = time.perf_counter() - t0

    loader = make_batch_loader(str(data), read_vocab(str(data / "vocab.txt")),
                               spec["batch"], mode="all", shuffle=False,
                               num_buckets=spec["buckets"])
    gpu = read_nbest(work / "decode.txt")
    if len(gpu) != spec["utts"] or any(len(h) != spec["nbest"]
                                       for h in gpu.values()):
        raise AssertionError(f"expected {spec['utts']} utterances x "
                             f"{spec['nbest']} n-best lines")
    compare_nbest(gpu, read_nbest(work / "decode_again.txt"))

    # the first decode batch again, on the CPU
    first = next(iter(loader))
    keys = [key for key, ok in zip(first.keys, first.valid) if ok]
    sub = work / "data_first_batch"
    sub.mkdir()
    scp = dict(kaldi_io.scp_entries(str(data / "feats.scp")))
    with open(sub / "feats.scp", "w") as f:
        f.writelines(f"{key} {scp[key]}\n" for key in keys)
    with open(data / "text") as src, open(sub / "text", "w") as dst:
        dst.writelines(line for line in src if line.split()[0] in keys)
    t0 = time.perf_counter()
    decode.main(decode_args(sub, work / "decode_cpu.txt", "cpu"))
    cpu_s = time.perf_counter() - t0
    cpu = read_nbest(work / "decode_cpu.txt")
    if sorted(cpu) != sorted(keys):
        raise AssertionError("the CPU decode covered other utterances")
    score_err = compare_nbest(gpu, cpu)

    audio_s = frames * 0.010
    return {
        "corpus": corpus["name"], "utterances": spec["utts"],
        "frames": frames, "batches": len(loader), "launches": launches,
        "decode_s": decode_s, "rtf": decode_s / audio_s,
        "decode_again_s": decode_again_s,
        "rtf_again": decode_again_s / audio_s,
        "cpu_first_batch_s": cpu_s, "cpu_vs_card_max_score_err": score_err,
    }


def _step_on(torch, device, params, cfg, batch, dtype=None):
    """One train step from ``params`` on ``device`` (in ``dtype``, default
    float32); returns (loss, {leaf path: gradient on the CPU in float64})."""
    from pytorch_kaldi_asr_tpu_torch.data.loader import to_device
    from pytorch_kaldi_asr_tpu_torch.models.transformer import tree_map
    from pytorch_kaldi_asr_tpu_torch.train import create_train_state, train_step
    from pytorch_kaldi_asr_tpu_torch.train.optim import named_leaves

    dtype = dtype or torch.float32
    state = create_train_state(
        tree_map(lambda t: t.detach().to(device, dtype, copy=True), params))
    b = to_device(batch, device)
    metrics = train_step(state, cfg, b.src.to(dtype), b.src_mask, b.tgt,
                         b.tgt_mask)
    return (float(metrics["loss"]),
            {path: p.grad.cpu().double()
             for path, p in named_leaves(state.params)})


def _rel_err(a, b):
    """max |a - b| over the largest |b|."""
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def card_vs_cpu_step(torch, device, params, cfg, batch):
    """One train step on ``device`` and on the CPU from the same parameters
    and batch (the dropout masks are the same on both).  The loss must
    agree within STEP_LOSS_RTOL and every gradient leaf within
    STEP_GRAD_RTOL of its largest entry.  A leaf whose float32 gradient is
    ill-conditioned (a sum over tens of thousands of frames that cancels)
    differs by more between any two float32 summation orders; for such a
    leaf the CPU step is run again in float64, and the card must be no
    further from the float64 gradient than FLOAT64_RATIO times the CPU's
    float32 result is.  Returns the numbers."""
    loss_dev, grads_dev = _step_on(torch, device, params, cfg, batch)
    t0 = time.perf_counter()
    loss_cpu, grads_cpu = _step_on(torch, "cpu", params, cfg, batch)
    cpu_s = time.perf_counter() - t0
    loss_err = abs(loss_dev - loss_cpu) / abs(loss_cpu)
    errs = {k: _rel_err(grads_dev[k], grads_cpu[k]) for k in grads_cpu}
    worst = max(errs, key=errs.get)
    out = {"loss": loss_dev, "loss_cpu": loss_cpu, "loss_rel_err": loss_err,
           "grad_rel_err": errs[worst], "worst_leaf": str(worst),
           "cpu_step_s": cpu_s, "float64_checks": {}}
    if loss_err > STEP_LOSS_RTOL:
        raise AssertionError(f"train step {device} vs cpu: loss {loss_err}")
    over = [k for k, e in errs.items() if e > STEP_GRAD_RTOL]
    if over:
        _, grads64 = _step_on(torch, "cpu", params, cfg, batch,
                              torch.float64)
        for k in over:
            card, cpu = (_rel_err(g[k], grads64[k])
                         for g in (grads_dev, grads_cpu))
            out["float64_checks"][str(k)] = {
                "card_vs_cpu": errs[k], "card_vs_float64": card,
                "cpu_vs_float64": cpu}
            if card > max(STEP_GRAD_RTOL, FLOAT64_RATIO * cpu):
                raise AssertionError(
                    f"train step {device} vs cpu: gradient {k} differs by "
                    f"{errs[k]:.2e} of its max; against float64 the card is "
                    f"off by {card:.2e}, the CPU by {cpu:.2e}")
    return out


def run_train(torch, corpus=TIMIT, device="cuda", model_args=None, utts=None,
              batch=None):
    """Stages 3-4 of ``corpus``'s recipe with the port on ``device``:
    initialize, pack archives where the recipe streams them, train (ending
    in combine), the standalone combine; then one train step at the
    recipe's dropout on the card and on the CPU, and the step's time and
    profile.  Returns the run's numbers; ``launches`` are those of the train
    and combine CLIs."""
    from pytorch_kaldi_asr_tpu_torch.data import read_vocab
    from pytorch_kaldi_asr_tpu_torch.data.archive import ArchiveBatchLoader
    from pytorch_kaldi_asr_tpu_torch.data.loader import make_batch_loader, to_device
    from pytorch_kaldi_asr_tpu_torch.io import kaldi_io
    from pytorch_kaldi_asr_tpu_torch.models.transformer import tree_map
    from pytorch_kaldi_asr_tpu_torch.recipes import (
        combine,
        generate_archive,
        initialize_model,
        train,
    )
    from pytorch_kaldi_asr_tpu_torch.train import (
        create_train_state,
        load_checkpoint,
        train_step,
    )

    spec = corpus["train"]
    utts, batch = utts or spec["utts"], batch or spec["batch"]
    epochs = spec["epochs"]
    work = WORK / corpus["name"] / "train"
    if work.exists():
        shutil.rmtree(work)
    dirs = {name: work / name for name in utts}
    frames = {name: write_data_dir(dirs[name], kaldi_io, torch, corpus, n,
                                   seed=i + 1)
              for i, (name, n) in enumerate(utts.items())}
    vocab = dirs["train"] / "vocab.txt"
    model = work / "model.init"
    initialize_model.main([
        "-read_feats_scp_file", str(dirs["train"] / "feats.scp"),
        "-lda_mat_file", "identity", "-read_vocab_file", str(vocab),
        "-seed", str(SEED), "-save_model_file", str(model),
        *(model_args or corpus["model"])])
    archive_args = []
    if spec["size_archive"]:
        archives = work / "archives"
        t0 = time.perf_counter()
        generate_archive.main([
            "-read_data_dir", str(dirs["train"]), "-read_vocab_file",
            str(vocab), "-save_archive_dir", str(archives), "-size_archive",
            str(spec["size_archive"])])
        print(f"{corpus['name']}: generate_archive took "
              f"{time.perf_counter() - t0:.2f} s")
        archive_args = ["-train_archive_dir", str(archives)]
    exp = work / "exp"
    sync = _sync(torch, device)

    # the main path: every launch count at 0 just before, read just after
    reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    rc = train.main([
        "-read_train_dir", str(dirs["train"]), *archive_args,
        "-read_dev_dir", str(dirs["dev"]), "-read_test_dir",
        str(dirs["test"]), "-read_vocab_file", str(vocab),
        "-load_model_file", str(model), "-save_model_dir", str(exp),
        "-batch_size", str(batch), "-epoch", str(epochs),
        "-save_interval", "1", "-optim_start_lr", "0.001",
        "-optim_soft_coefficient", "25000", "-device", device])
    sync()
    train_s = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"train CLI returned {rc}")
    models = ",".join(str(exp / f"epoch.{e}") for e in range(epochs, 0, -1))
    combine.main(["-model_list", models, "-read_data_dir", str(dirs["test"]),
                  "-read_vocab_file", str(vocab), "-save_model_dir",
                  str(work / "combined"), "-batch_size", str(batch),
                  "-device", device])
    sync()
    launches = launch_counts()

    records = [json.loads(x) for x in open(exp / "metrics.jsonl")]
    if len(records) != epochs:
        raise AssertionError(f"metrics.jsonl has {len(records)} records")
    for r in records:
        if not all(math.isfinite(r[k]) for k in
                   ("train_loss", "train_accu", "dev_accu", "test_accu")):
            raise AssertionError(f"non-finite metrics {r}")
    names = sorted(p.name for p in exp.iterdir() if p.is_dir())
    want = {f"epoch.{e}" for e in range(1, epochs + 1)}
    if not want <= set(names) or not any(
            n.startswith("best.epoch") for n in names) or not any(
            n.startswith("combined.accu") for n in names):
        raise AssertionError(f"checkpoint names {names}")
    if len(list((work / "combined").glob("combined.accu*"))) != 1:
        raise AssertionError("the combine CLI wrote no combined.accu*")

    # one train step from model.init at the recipe's dropout, on the card
    # and on the CPU: the masks are the same on both devices
    ckpt = load_checkpoint(str(model))
    if archive_args:
        loader = ArchiveBatchLoader(archive_args[1], batch, mode="drop")
    else:
        loader = make_batch_loader(str(dirs["train"]), read_vocab(str(vocab)),
                                   batch, mode="drop")
    first = next(iter(loader))
    rows = spec["cpu_rows"] or batch
    check = card_vs_cpu_step(torch, device, ckpt["params"], ckpt["cfg"],
                             type(first)(*(x[:rows] for x in first)))
    print(f"{corpus['name']}: one train step of {rows} utterances at dropout "
          f"{ckpt['cfg'].en_dropout}/{ckpt['cfg'].de_dropout}, {device} vs "
          f"cpu: " + json.dumps(check))

    # the train step's time at the recipe's dropout, on one full batch
    state = create_train_state(tree_map(
        lambda t: t.detach().to(device, copy=True), ckpt["params"]))
    b = to_device(first, device)

    def step():
        train_step(state, ckpt["cfg"], b.src, b.src_mask, b.tgt, b.tgt_mask)

    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    [step_ms] = time_steps(step, sync)
    peak_gb = (torch.cuda.max_memory_allocated() / 1e9 if device == "cuda"
               else None)
    profile = profile_steps(torch, step) if device == "cuda" else None
    batch_frames = int(first.src_mask.sum())
    return {
        "corpus": corpus["name"], "utterances": utts, "frames": frames,
        "train_steps": records[-1]["step"], "train_cli_s": train_s,
        "metrics": records, "checkpoints": names, "launches": launches,
        "dropout_sites": dropout_sites(ckpt["cfg"]),
        "en_layers": ckpt["cfg"].en_layers, "step_ms": step_ms,
        "step_frames": batch_frames,
        "step_padded_frames": int(first.src_mask.size),
        "frames_per_s": batch_frames / step_ms * 1e3,
        "peak_memory_gb": peak_gb, "card_vs_cpu_rows": rows,
        "card_vs_cpu_step": check, "step_profile": profile,
    }


def time_steps(step, sync, n_steps=10, repeats=1):
    """Wall ms per call of ``step``, ``repeats`` times over ``n_steps``
    calls each, after 3 warm-up calls."""
    for _ in range(3):
        step()
    sync()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step()
        sync()
        times.append((time.perf_counter() - t0) / n_steps * 1e3)
    return times


def profile_steps(torch, step, n=3, by_name=False):
    """torch.profiler over ``n`` train steps: device time per step, the
    device's idle share of the (profiled, so slower) wall time, kernels per
    step, the time of the port's kernels, and the kernels that take the
    most device time; with ``by_name``, every kernel's launches per step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    device, kernels = _kernel_rows(events)
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.device_time_total)[:12]
    ours = {k: [sum(e.device_time_total for e in kernels if pat in e.key)
                / 1e3 / n,
                sum(e.count for e in kernels if pat in e.key) / n]
            for k, pat in PROFILE_NAMES.items()}
    out = {
        "profiled_wall_ms_per_step": wall_ms / n,
        "device_ms_per_step": busy_ms / n,
        "idle_share": 1.0 - busy_ms / wall_ms,
        "kernels_per_step": sum(e.count for e in kernels) / n,
        "port_kernels_ms_and_launches_per_step": ours,
        "top_kernels_ms_per_step": [
            [e.key[:80], e.device_time_total / 1e3 / n, e.count / n]
            for e in top],
    }
    if by_name:
        out["launches_per_step_by_kernel"] = {
            e.key: e.count / n
            for e in sorted(kernels, key=lambda e: -e.count)}
        out["annotation_rows"] = sorted(
            e.key for e in device if e not in kernels)
        host = [e for e in events if e.device_type == DeviceType.CPU]
        out["host_ops_self_ms_total_ms_calls_per_step"] = [
            [e.key, e.self_cpu_time_total / 1e3 / n,
             e.cpu_time_total / 1e3 / n, e.count / n]
            for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:30]]
    return out


def train_step_only(torch, corpus=TIMIT):
    """The train step of ``corpus``'s recipe alone, for ``--train-step``:
    its model at the recipe's widths from seed 0, the first batch of
    run_train's train set (TIMIT: 300 utterances at batch 100; LibriSpeech:
    128 utterances packed by ``generate_archive`` and read back as
    ``train -train_archive_dir`` reads them, batch 32 at S 1600), five
    timings of 20 steps and a profile.  Uses only entry points that every
    slice of the port with that recipe has, so it times the port of
    whichever checkout is first on ``sys.path``.  For TIMIT, where the
    model's dropout runs K3, also three rounds of three timings each of the
    step with the dropout drawn by ``former_draw`` and by K3, alternated in
    this process, and a profile of the former."""
    from pytorch_kaldi_asr_tpu_torch.data import read_vocab
    from pytorch_kaldi_asr_tpu_torch.data.loader import make_batch_loader, to_device
    from pytorch_kaldi_asr_tpu_torch.io import kaldi_io
    from pytorch_kaldi_asr_tpu_torch.models.transformer import tree_map
    from pytorch_kaldi_asr_tpu_torch.recipes import initialize_model
    from pytorch_kaldi_asr_tpu_torch.train import (
        create_train_state,
        load_checkpoint,
        train_step,
    )

    spec = corpus["train"]
    work = WORK / "train_step" / corpus["name"]
    if work.exists():
        shutil.rmtree(work)
    data = work / "train"
    write_data_dir(data, kaldi_io, torch, corpus, spec["utts"]["train"],
                   seed=1)
    initialize_model.main([
        "-read_feats_scp_file", str(data / "feats.scp"),
        "-lda_mat_file", "identity", "-read_vocab_file",
        str(data / "vocab.txt"), "-seed", str(SEED), "-save_model_file",
        str(work / "model.init"), *corpus["model"]])
    ckpt = load_checkpoint(str(work / "model.init"))
    if spec["size_archive"]:
        from pytorch_kaldi_asr_tpu_torch.data.archive import ArchiveBatchLoader
        from pytorch_kaldi_asr_tpu_torch.recipes import generate_archive

        generate_archive.main([
            "-read_data_dir", str(data), "-read_vocab_file",
            str(data / "vocab.txt"), "-save_archive_dir",
            str(work / "archives"), "-size_archive",
            str(spec["size_archive"])])
        loader = ArchiveBatchLoader(str(work / "archives"), spec["batch"],
                                    mode="drop")
    else:
        loader = make_batch_loader(str(data),
                                   read_vocab(str(data / "vocab.txt")),
                                   spec["batch"], mode="drop")
    first = next(iter(loader))
    state = create_train_state(tree_map(
        lambda t: t.detach().to("cuda", copy=True), ckpt["params"]))
    b = to_device(first, "cuda")

    def step():
        train_step(state, ckpt["cfg"], b.src, b.src_mask, b.tgt, b.tgt_mask)

    sync = torch.cuda.synchronize
    times = time_steps(step, sync, n_steps=20, repeats=5)
    out = {"step_ms": times, "median_ms": sorted(times)[2],
           "real_frames": int(first.src_mask.sum())}
    from pytorch_kaldi_asr_tpu_torch.models import common

    if corpus is not TIMIT or not hasattr(common, "masked_dropout"):
        # the conformer, or a checkout before K3
        out["profile"] = profile_steps(torch, step, by_name=True)
        return out
    # every timing before the first profile: a profiled process launches
    # more slowly afterwards
    gen = torch.Generator(device="cuda").manual_seed(2)
    variants = {"k3": common.masked_dropout,
                "former_draw": lambda x, seed, threshold, scale: former_draw(
                    torch, x, 256 - (threshold >> 24), gen)}
    rounds = {name: [] for name in variants}
    try:
        for _ in range(3):
            for name in ("former_draw", "k3"):
                common.masked_dropout = variants[name]
                rounds[name] += time_steps(step, sync, n_steps=20, repeats=3)
        for key, name in (("profile", "k3"),
                          ("former_draw_profile", "former_draw")):
            common.masked_dropout = variants[name]
            out[key] = profile_steps(torch, step, by_name=True)
    finally:
        common.masked_dropout = variants["k3"]
    out["alternated_step_ms"] = rounds
    out["alternated_median_ms"] = {
        name: sorted(t)[len(t) // 2] for name, t in rounds.items()}
    return out


def check_train_launches(training):
    """K2a-c at exactly en_layers x steps, K3 at exactly (dropout sites) x
    steps each way, and K1 in the evaluations."""
    launches, steps = training["launches"], training["train_steps"]
    want = {f"banded_attention_{k}": training["en_layers"] * steps
            for k in ("fwd", "dq", "dkv")}
    want.update({f"fused_dropout_{k}": training["dropout_sites"] * steps
                 for k in ("forward", "backward")})
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"{training['corpus']}: {name} launched "
                                 f"{launches[name]} times in training, "
                                 f"expected {n}")
    if launches["banded_attention"] == 0:
        raise AssertionError("banded_attention (K1) not launched by the "
                             "training path's evaluations")
    print(f"{training['corpus']}: {training['dropout_sites']} dropout sites "
          f"per train step; launches over {steps} steps: {launches}")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a card",
              file=sys.stderr)
        return 2
    step_only = sys.argv[1:2] == ["--train-step"]
    sources = ([Path(p).resolve() for p in sys.argv[2:]]
               if sys.argv[1:2] == ["--k2-sources"] else None)
    if sources == []:
        print("chip_smoke: --k2-sources takes one or more .cu files",
              file=sys.stderr)
        return 2
    tree = Path(sys.argv[2]).resolve() if step_only else REPO
    corpus = {"timit": TIMIT, "librispeech": LIBRISPEECH}.get(
        sys.argv[3] if step_only and len(sys.argv) > 3 else "timit")
    if corpus is None:
        print(f"chip_smoke: --train-step takes timit or librispeech, got "
              f"{sys.argv[3]}", file=sys.stderr)
        return 2
    if not (tree / "pytorch_kaldi_asr_tpu_torch").is_dir():
        print(f"chip_smoke: {tree} is not a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(tree))
    from pytorch_kaldi_asr_tpu_torch.ops import _build
    from pytorch_kaldi_asr_tpu_torch.utils.device import disable_tf32

    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}")
    disable_tf32()

    t0 = time.perf_counter()
    procs = start_k2_builds(sources) if sources else None
    logs = _build.build(["banded_attention_train"] if sources else None)
    print(f"built {sorted(logs) or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "ptxas" in line:
                print(f"  {name}: {line.strip()}")
    if sources:
        from pytorch_kaldi_asr_tpu_torch.ops import banded_attention as ba

        compared = compare_k2_sources(torch, ba, finish_k2_builds(procs))
        for shape, row in compared.items():
            print("K2_SOURCES " + json.dumps(
                {"card": card, "shape": shape, "builds": row}))
        return 0
    if step_only:
        print("TRAIN_STEP " + json.dumps(
            {"tree": str(tree), "card": card, "corpus": corpus["name"],
             **train_step_only(torch, corpus)}))
        return 0

    from pytorch_kaldi_asr_tpu_torch.ops import banded_attention as ba
    from pytorch_kaldi_asr_tpu_torch.ops import fused_dropout as fd

    err = check_banded_attention(torch, ba)
    train_errs = check_trainable_attention(torch, ba)
    check_backward_launches(torch, ba)
    k3_err = check_fused_dropout(torch, fd)
    timing = {shape: time_banded_attention(torch, ba, shape)
              for shape in ("timit_decode", "conformer_decode")}
    train_timing = {shape: time_trainable_attention(torch, ba, shape)
                    for shape in TRAIN_TIMING_SHAPES}
    k3_timing = time_fused_dropout(torch, fd)
    torch.cuda.empty_cache()
    print(f"kernel phase done at {time.perf_counter() - t_start:.1f} s")

    decodes, trainings = {}, {}
    for corpus in (TIMIT, LIBRISPEECH):
        name = corpus["name"]
        summary = run_slice(torch, corpus)
        en_layers = int(corpus["model"][corpus["model"].index("-en_layers")
                                        + 1])
        expected = en_layers * summary["batches"]
        if summary["launches"]["banded_attention"] != expected:
            raise AssertionError(
                f"{name}: banded_attention launched "
                f"{summary['launches']['banded_attention']} times in the "
                f"decode, expected {expected}")
        summary["card"] = card
        print(f"{name} decode: " + json.dumps(summary))
        decodes[name] = summary

        training = run_train(torch, corpus)
        check_train_launches(training)
        training["card"] = card
        profile = training["step_profile"]
        print(f"{name} train step (batch {corpus['train']['batch']}): "
              f"{training['step_ms']:.3f} ms, "
              f"{training['frames_per_s']:.0f} real frames/s, "
              f"{profile['kernels_per_step']:.0f} kernels and "
              f"{profile['device_ms_per_step']:.2f} ms of device time per "
              f"profiled step, idle share {profile['idle_share']:.3f}")
        print(f"{name} training: " + json.dumps(training))
        trainings[name] = training
        torch.cuda.empty_cache()
        print(f"{name} done at {time.perf_counter() - t_start:.1f} s")

    def total(name, paths):
        return sum(p["launches"][name] for p in paths)

    paths = [*decodes.values(), *trainings.values()]
    jax_file = "pytorch_kaldi_asr_tpu/ops/banded_attention.py"
    kernels = [dict(
        name="banded_attention", route="cuda",
        source="pytorch_kaldi_asr_tpu_torch/ops/csrc/banded_attention.cu",
        replaces=f"{jax_file}:112", launches=total("banded_attention", paths),
        max_abs_err=err, **timing["conformer_decode"])]
    for name, line in (("fwd", 415), ("dq", 477), ("dkv", 505)):
        kernels.append(dict(
            name=f"banded_attention_{name}", route="cuda",
            source="pytorch_kaldi_asr_tpu_torch/ops/csrc/"
                   "banded_attention_train.cu",
            replaces=f"{jax_file}:{line}",
            launches=total(f"banded_attention_{name}", paths),
            max_abs_err=train_errs[name],
            **train_timing["conformer_train"][name]))
    kernels.append(dict(
        name="fused_dropout", route="cuda",
        source="pytorch_kaldi_asr_tpu_torch/ops/csrc/fused_dropout.cu",
        replaces="pytorch_kaldi_asr_tpu/ops/fused_dropout.py:34",
        launches=total("fused_dropout_forward", paths)
        + total("fused_dropout_backward", paths),
        max_abs_err=k3_err,
        **{k: k3_timing[k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")}))
    print(f"whole run {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
