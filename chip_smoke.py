#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pytorch_kaldi_asr_tpu_torch) on one
CUDA card: ``python3 chip_smoke.py`` from the root of a checkout.

1. Requires a CUDA card; prints its name and power limit (nvidia-smi) and
   turns TF32 off for matmuls and cuDNN, and cuBLAS's reduced-precision
   sums in bfloat16 GEMMs.
2. Builds every CUDA kernel of the port from ``ops/csrc`` (one nvcc per
   source, all started together) and prints what ptxas reports.
3. Kernel phase: holds each kernel against its plain PyTorch version on the
   card at the paths' shapes and at edge cases, then times the kernel, the
   plain version and the PyTorch library call that computes the same
   function, with CUDA events after warm-up.  K1 is the inference kernel,
   held against its plain version at the paths' shapes and at cases that
   reach each tile skip; K2a/K2b/K2c (forward with lse, dq with delta,
   dk/dv) are held against autograd of the plain trainable version at
   dropout 0 and 0.35, at the TIMIT shape, at the conformer's (S 1600, band
   (-256, 256)) and at the same tile-skip cases; one trainable forward must
   be exactly one K2a launch, one inference call one K1 launch, and one
   backward exactly one K2b and one K2c launch, with no other device work;
   the backward pair is timed against SDPA's backward at dropout 0 and at
   the path's rate.
   Bounds take the faster float32 route: the CUDA cores, or for the
   attention products the TF32 tensor cores at three passes; K3 (fused
   dropout) forward and backward, on float32 and on bfloat16, must match its
   plain version bit for bit (0 mask mismatches) at the conformer's [51200,
   1024] and [51200, 256] for both thresholds at rates 0.1 and 0.35, and at
   edge cases (a tail, a non-contiguous and a misaligned input).  The
   bfloat16 instantiations of K1 and K2a-c are held against their plain
   versions on bfloat16 in bfloat16 ulps (``bf16_ulps``, BF16_KERNEL_ULPS)
   at the same shapes (d 24 for d 12), with the same one-launch checks, and
   timed beside SDPA on bfloat16 (bounds at 989 TFLOP/s); the bfloat16 mma
   probe reads the tensor core's rounding (``mma_bf16_probe``).
4. TIMIT decode (stage 5): a seeded TIMIT-shaped data dir (16 utterances of
   40-dim features, 150-500 frames, a 52-entry phone vocabulary), the
   port's ``initialize_model`` at the recipe's widths with ``-encoder_type
   banded`` and its ``decode`` on the card with the recipe's stage-5 flags;
   checks the n-best lines and the K1 launches, decodes the first batch
   again on the CPU and compares, and prints the wall time, the RTF and
   the wall time's split (checkpoint and vocabulary loading, data, encoder,
   search steps, writing).  Then, on the first batch, the fixed-buffer
   ``beam_search`` against the KV-cached ``fast_beam_search`` (same n-best),
   and the same decode on a model whose decoder band reaches one token
   ahead, (-10, 1), which the CLI decodes with the fixed-buffer search
   (its CPU cross-check on 2 utterances of the first batch).
5. TIMIT training (stages 3-4): train/dev/test dirs of 300/40/40
   utterances, the ``train`` CLI with the recipe's stage-4 flags for 2
   epochs, then the ``combine`` CLI.  Checks finite losses, the
   ``metrics.jsonl`` records, the checkpoint names, K2a/K2b/K2c at exactly
   en_layers x steps and K3 at exactly (dropout sites) x steps each way.
   Then one train step from model.init at the recipe's dropout, on the card
   and on the CPU (the masks are the same on both): loss and every
   gradient leaf must agree (``card_vs_cpu_step``; an ill-conditioned leaf
   is judged against the CPU's own float32 noise, its step with the
   weights one ulp off).  Prints the step time and a profile.
6. and 7. The same for the conformer-librispeech recipe's model (8 + 4
   layers, d_model 256, 4 heads, band (-256, 256), 5000 words, dropout
   0.1) on LibriSpeech-shaped data (lognormal(7.0, 0.55) frames clipped to
   [150, 1600]): the decode of 16 utterances with the recipe's stage-5
   flags; then ``generate_archive`` (512 per archive) and ``train
   -train_archive_dir`` on 128/16/16 utterances at batch 32 for 2 epochs,
   ``combine``, the exact launch counts, and card against CPU on a batch of
   4 utterances with dropout on.  Then the same for the recipe as it
   ships, with its bfloat16 residual stream (K3 on bfloat16 at 25 sites per
   step, on float32 at 46): the card-vs-CPU step and n-best are held
   against limits set from the stream's own error and from planted faults
   (``bf16_card_vs_cpu_step``, ``compare_nbest_bf16``).
8. bfloat16 compute (``compute_dtype`` set in config.json): bench.py's
   headline train step (``BENCH``: the TIMIT-width tdnn, batch 100 x 500
   frames; frames/s, device time, idle share, K3 launches, card vs CPU on 10
   utterances), then the banded TIMIT model (decode, 2 epochs x 3 steps of
   training) and the conformer as shipped (decode, 1 epoch of training from
   archives), each held against the CPU (``bf16_card_vs_cpu_step`` over
   bfloat16 compute's own error, the CPU's distance from its float32-compute
   model; ``bf16_compute_decode_check``), their profiles
   showing the bfloat16 attention kernels and no float32 one.
9. Prints the ``kernels`` JSON line (K1, K2a-c on both dtypes, K3 on both),
   the card line, and as the last line ``{"ok": true, "device": {...}}``.
   Any failure raises: the script then exits non-zero without the last
   line.

``python3 chip_smoke.py --train-step TREE [CORPUS]`` runs only the train
step of CORPUS's model (timit, the default; librispeech, the conformer at
batch 32 x S 1600 with a float32 stream; librispeech_bf16, the same as the
recipe ships it, with a bfloat16 stream) with the port in the checkout
``TREE`` (for instance a parent commit unpacked with ``git archive`` under
``build/``) and prints one ``TRAIN_STEP`` JSON line: five timings of 20 steps and a
profile with every kernel's launches and the host's busiest operations per
step; for TIMIT, where the port has K3, also the same step with the
model's dropout drawn by the port's former draw (``former_draw``),
alternated with K3 in one process.  Run parent, change, change, parent
one after another on one card to compare two commits.

``python3 chip_smoke.py --noisy-leaf`` prints one ``NOISY_LEAF`` JSON line:
what the float32 step gate reads on the TIMIT model (``f32_gate_readings``)
at 3 seeds x 2 batches of the TIMIT training slice, and with K2b's dq scaled
by 1 + 1e-5 on the card.

``python3 chip_smoke.py --bf16-compute-gates`` prints one
``BF16_COMPUTE_GATES`` JSON line: what bfloat16 compute's card-vs-CPU gates
read, sound and with each fault of BF16_COMPUTE_FAULTS planted
(``bf16_compute_gate_readings``).

``python3 chip_smoke.py --bf16-gates`` prints one ``BF16_GATES`` JSON line:
what the bfloat16 stream's card-vs-CPU gates (the decode's n-best and the
train step's ratios) read on the conformer recipe's model as it ships,
sound and with each fault of BF16_FAULTS planted on the card
(``bf16_gate_readings``); the limits are set between the two.

``python3 chip_smoke.py --k2-sources A.cu [B.cu ...]`` compares versions
of ``ops/csrc/banded_attention_train.cu`` (a parent's, or an edited copy;
a parent's ``banded_attention.cu`` for its K1) in
one process: each is built with the port's nvcc flags (ptxas's registers
and spills for each kernel printed), and each kernel a build has is timed
in turns with the other builds', three rounds, and held against the first
build's outputs: K2a, K2b and K2c at both train timing shapes, K1 at both
decode shapes; one ``K2_SOURCES`` JSON line per shape.

Everything it writes goes under ``build/chip_smoke/`` in the checkout.
"""

import contextlib
import hashlib
import json
import math
import shutil
import statistics
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
BF16_FLOPS_PER_S = 989e12  # bfloat16 tensor cores, dense

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
# the conformer-librispeech recipe as it ships: its residual stream in
# bfloat16 (run.sh:110, -conformer_stream_dtype ${stream_dtype:-bfloat16})
CONFORMER_BF16_MODEL = [x if x != "float32" else "bfloat16"
                        for x in CONFORMER_MODEL]
# the TIMIT model with a decoder band one token ahead, which takes the
# fixed-buffer search
NONCAUSAL_MODEL = [x if x != "(-10,0)" else "(-10,1)" for x in RECIPE_MODEL]
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
LIBRISPEECH_BF16 = dict(LIBRISPEECH, name="librispeech_bf16",
                        model=CONFORMER_BF16_MODEL)
# the CPU cross-check takes 2 utterances of the first batch: the
# fixed-buffer search decodes the whole buffer at every step, and the CPU
# took about 87 s for all 8 on the chip machine
TIMIT_NONCAUSAL = dict(TIMIT, name="timit_noncausal", model=NONCAUSAL_MODEL,
                       decode=dict(TIMIT["decode"], cpu_utts=2))
DROPOUT = 0.35  # the K2 checks' attention dropout (the TIMIT recipe's)

KERNEL_ATOL = 2e-5  # float32, summation order differs from the plain version
GRAD_ATOL = 1e-4  # float32 gradients, summed over the band in another order
STEP_LOSS_RTOL = 1e-5  # one train step, card vs CPU
STEP_GRAD_RTOL = 1e-4  # of the largest |gradient| of each leaf
# a leaf over STEP_GRAD_RTOL is judged against the CPU's own float32 noise
# on it: the CPU step with every weight one float32 ulp off (random signs,
# ``one_ulp_off``), its distance from the CPU step over the leaf's largest
# entry (at least NOISE_FLOOR).  The card may be at most F32_NOISE_RATIO
# times that noise from the CPU (readings: ``--noisy-leaf``, PERF.md, PR 7).
F32_NOISE_RATIO = 8.0
NOISE_FLOOR = 2.0 ** -23
# the bfloat16 stream's step, card vs CPU: per leaf (and the loss), the
# card's distance from the CPU's bfloat16 step over the CPU's bfloat16
# step's distance from its float32 step (the stream's own error), both over
# the leaf's largest entry.  A bfloat16 step is chaotic at float32's last
# bit, so one leaf says little; the median leaf separates: sound card runs
# read 0.23-0.46 (4 batch/seed draws), the card with a float32 stream
# 1.000 and with the bfloat16 dropout's scale left unrounded 1.11 (``--bf16-
# gates``, PERF.md).  Single leaves read up to 1.45 when sound, so the leaf
# limit only bounds a fault confined to a few leaves.
BF16_MEDIAN_RATIO = 0.75
BF16_LEAF_RATIO = 3.0
# the bfloat16 stream's n-best, card vs CPU, scores within BF16_SCORE_ATOL
# and words at the float32 gate's WORD_GAP: sound runs read 3.5e-3 and
# 7.6e-3 (two model seeds), words differing at gaps up to 4.3e-4; the card
# with a float32 stream 0.63, with the swish rounded once 1.15, and with
# two-pass layer-norm moments 3.8e-3 but words differing at a gap of 0.013
# (``--bf16-gates``)
BF16_SCORE_ATOL = 0.05
# bfloat16 compute's step, card vs CPU: the yardstick is the CPU's
# distance from its float32-compute step (the stream as it is), each leaf
# by its mean entries (``bf16_step_ratios``; readings: ``--bf16-compute-
# gates``, PERF.md, PR 7).  Two bfloat16 steps of these models decorrelate:
# sound medians read 0.58-0.91, and of the planted faults only the
# attention 6 % too large reads over them (1.06-1.22), so the median is
# printed, not gated.  Every leaf at most BF16_COMPUTE_LEAF_RATIO: sound
# up to 1.24 (the main paths' steps up to 1.25 by the former yardstick),
# the attention 6 % too large 1.81-2.27, the decoder's FFN 1.6 % too large
# 5.27-8.42.  The median leaf's distance from the
# float32-compute step (by the largest entries) at least
# BF16_COMPUTE_FLOAT32_FLOOR: sound 0.87-1.11, a card in float32 compute
# 0.00-0.12.  The loss is not gated.
BF16_COMPUTE_LEAF_RATIO = 1.6
BF16_COMPUTE_FLOAT32_FLOOR = 0.5
# and its decode (``bf16_compute_decode_check``): the encoder output's mean
# distance over bfloat16 compute's own, per recipe: TIMIT sound 0.59-0.60,
# its attention with p kept in float32 0.72, 6 % too large 2.63; the
# conformer sound 0.91, 6 % too large 1.54 (p in float32 reads 0.91, with
# sound); and at least BF16_DECODE_FLOAT32_FLOOR of it from the
# float32-compute encoder: sound 1.00, float32 compute 0.00-0.70.  The
# search from one encoder output at the float32 gate
BF16_COMPUTE_ENCODER_RATIO = 0.65
BF16_CONFORMER_ENCODER_RATIO = 1.2
BF16_DECODE_FLOAT32_FLOOR = 0.85

# the same recipes with compute_dtype=bfloat16, set as users set it: in
# the checkpoint's config.json (the initialize_model CLI has no flag for it,
# as the JAX package's has none)
# (the card-vs-CPU step on 20 TIMIT utterances, as the gate's readings
# take it on 10: the CPU's steps at batch 100 took 54 s); the decode's
# encoder-output limit (``bf16_compute_decode_check``) per recipe
TIMIT_BF16 = dict(TIMIT, name="timit_bf16", compute_dtype="bfloat16",
                  train=dict(TIMIT["train"], cpu_rows=20),
                  decode_encoder_ratio=BF16_COMPUTE_ENCODER_RATIO)
# (the conformer for 1 epoch: 4 steps, which the launch checks count; the
# earlier paths' 2 epochs run combine over two checkpoints)
LIBRISPEECH_BF16_COMPUTE = dict(
    LIBRISPEECH_BF16, name="librispeech_bf16_compute",
    compute_dtype="bfloat16",
    train=dict(LIBRISPEECH_BF16["train"], epochs=1),
    decode_encoder_ratio=BF16_CONFORMER_ENCODER_RATIO)
# the TIMIT leaf whose float32 gate sat at its noise under PR 6's float64
# yardstick (ROADMAP.md queue 3)
NOISY_LEAF = ("encoder", "layers", 1, "ffn", "w1", "w")
CPU_SCORE_ATOL = 1e-4  # card vs CPU n-best scores
WORD_GAP = 1e-3  # words must agree where scores are this far apart

# bfloat16 kernel outputs against their plain versions, in bfloat16 ulps of
# each entry's scale (``bf16_ulps``): the forward rounds its probabilities
# against another max than the plain version, so out differs by one ulp in
# 7-36 % of its entries.  The card read up to 2.0 (K1 at the conformer
# decode shape), the gradients up to 1.0 (PERF.md, PR 7); cuda_emu.h up to
# 1.0 (tests/test_torch_k2_emulated.py)
BF16_KERNEL_ULPS = 3.0

# kernel names in a torch.profiler trace (all in anonymous namespaces; the
# attention kernels are templates over the element type)
PROFILE_NAMES = {
    "K1": "::banded_attention_kernel<float", "K2a": "::fwd_kernel<float",
    "K2b": "::dq_kernel<float", "K2c": "::dkv_kernel<float",
    "K1_bf16": "::banded_attention_kernel<__nv_bfloat16",
    "K2a_bf16": "::fwd_kernel<__nv_bfloat16",
    "K2b_bf16": "::dq_kernel<__nv_bfloat16",
    "K2c_bf16": "::dkv_kernel<__nv_bfloat16",
    "K3": "::fused_dropout_kernel", "K3_bf16": "::fused_dropout_bf16_kernel",
}
ATTENTION_WRAPPERS = ("banded_attention", "banded_attention_fwd",
                      "banded_attention_dq", "banded_attention_dkv")


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


def dropout_sites(cfg):
    """K3 launches of one train step, each way, by dtype ({"float32": n,
    "bfloat16": m}), counted from the model code (models/transformer.py,
    models/encoders.py).  The tdnn encoder: after the projection and each
    TDNN layer (in the compute dtype), after the positions (float32).  The
    banded encoder: the input dropout and one after the final positions
    (float32), per layer the attention block's output and the FFN's (the
    compute dtype).  The conformer: per layer one in each half-step FFN
    after its swish and one after the MHSA (the compute dtype); the input
    dropout, each half-step FFN's second and the conv module's (the
    stream's dtype).  The decoder: its embedding and output dropouts
    (float32), per layer the self- and cross-attention probabilities and
    outputs and the FFN's output (the compute dtype)."""
    counts = {"float32": 0, "bfloat16": 0}
    compute = cfg.compute_dtype

    def add(n, dtype):
        counts[dtype] += n

    if cfg.encoder_type == "tdnn":
        add(1 + len(cfg.tdnn_contexts), compute)
        add(1, "float32")
    elif cfg.encoder_type == "banded":
        add(2, "float32")
        add(2 * cfg.en_layers, compute)
    elif cfg.encoder_type == "conformer":
        add(1 + 3 * cfg.en_layers, cfg.conformer_stream_dtype)
        add(3 * cfg.en_layers, compute)
    else:
        raise ValueError(f"no site count for {cfg.encoder_type}")
    add(2, "float32")
    add(5 * cfg.de_layers, compute)
    return counts


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


def _tile_cases(torch, scale, bf16=False):
    """(bh, s, d, dv, lengths, start, end, scale, name) of the cases that
    reach each skip of the kernels' tiling: band edges on a tile boundary,
    whole invalid key tiles and dead query tiles, 8-key chunks wholly in
    band beside partial ones, a key mask that is no prefix, dv != d, d a
    multiple of 4 but not of 8 (``bf16``: d 24, which ends inside a 16-deep
    mma step), and the largest head dims."""
    odd = ((4, 256, 24, 24, [256, 180, 90, 0], -40, 8, 0.3, "d 24") if bf16
           else (4, 256, 12, 12, [256, 180, 90, 0], -40, 8, 0.3, "d 12"))
    return [
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
        odd,
        (2, 256, 128, 128, [256, 100], -100, 20, scale, "d 128"),
    ]


def check_banded_attention(torch, ba):
    """Kernel vs plain version on the card, at the paths' shapes and at
    the tile-skip cases; returns the max abs error."""
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
        *_tile_cases(torch, scale),
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
        empty = ~_allowed(torch, s, start, end, valid).any(-1)
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


def kernel_device_ms(torch, fn, kernel, n=100):
    """Mean device time of the kernel ``kernel`` (a PROFILE_NAMES key) over
    ``n`` calls of ``fn``, from torch.profiler: its own duration, without
    the gaps that the host's launch cost leaves between short kernels."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in _kernel_rows(prof.key_averages())[1]
            if PROFILE_NAMES[kernel] in e.key]
    return (sum(e.device_time_total for e in rows)
            / sum(e.count for e in rows) / 1e3)


def _bound(n_bytes, flops, tensor_cores=False, bf16=False):
    """(bound_ms, bound_by) on the H100's published peaks: the bytes over
    the memory rate or the operations over the faster float32 route,
    whichever takes longer.  The attention products (``tensor_cores``) take
    the TF32 tensor cores at TF32_PASSES passes (3 / 495 TFLOP/s, faster
    than the CUDA cores' 1 / 67), or on bfloat16 (``bf16``) the bfloat16
    tensor cores (989 TFLOP/s); other float32 work the CUDA cores."""
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    rate = (BF16_FLOPS_PER_S if bf16 else TF32_FLOPS_PER_S / TF32_PASSES) \
        if tensor_cores else F32_FLOPS_PER_S
    ops_ms = flops / rate * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def _allowed(torch, s, start, end, valid):
    pos = torch.arange(s, device="cuda")
    rel = pos[None, :] - pos[:, None]
    return ((rel >= start) & (rel <= end))[None] & (valid[:, None, :] > 0)


def decode_timing_inputs(torch, ba, shape, dtype=None):
    """(q, k, v, valid, start, end, scale) of one decode batch of ``shape``
    (ATTN_SHAPES), S padded to the 64-frame tile as the wrapper pads it;
    q, k, v in ``dtype`` (float32 by default)."""
    bh, s, d, (start, end), corpus, n, heads = ATTN_SHAPES[shape]
    s_pad = -(-s // ba.BLOCK) * ba.BLOCK
    q, k, v, valid = _attention_inputs(
        torch, bh, s_pad, d, d, _lengths(torch, corpus, n, heads, s, 1),
        seed=7)
    q, k, v = (x.to(dtype or torch.float32) for x in (q, k, v))
    return q, k, v, valid, start, end, 1.0 / math.sqrt(256.0)


def time_banded_attention(torch, ba, shape, dtype=None):
    """K1, its plain version and the library call at one decode batch of
    ``shape`` (ATTN_SHAPES), S padded by the wrapper to the 64-frame tile,
    on ``dtype`` (float32 by default; the library call on the same)."""
    import torch.nn.functional as F

    q, k, v, valid, start, end, scale = decode_timing_inputs(torch, ba, shape,
                                                             dtype)
    (bh, s_pad, d), s = q.shape, ATTN_SHAPES[shape][1]
    allowed = _allowed(torch, s_pad, start, end, valid)
    pairs = int(allowed.sum())
    n_bytes = (q.element_size() * (q.numel() + k.numel() + v.numel()
                                   + v.numel()) + 4 * valid.numel())
    bound_ms, bound_by = _bound(n_bytes, pairs * (2 * d + 2 * d),
                                tensor_cores=True,
                                bf16=q.dtype == torch.bfloat16)
    plain_iters = 100 if s_pad <= 512 else 10
    def launch():
        return ba._launch(q, k, v, valid, start, end, scale)

    kernel_ms = time_ms(torch, launch)
    device_ms = kernel_device_ms(
        torch, launch, "K1_bf16" if q.dtype == torch.bfloat16 else "K1")
    plain_ms = time_ms(torch, lambda: ba.banded_attention_reference(
        q, k, v, valid, start, end, scale), iters=plain_iters, warmup=2)
    library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=allowed, scale=scale))
    print(f"banded_attention timing ({shape}, {str(q.dtype)[6:]}): "
          f"BH={bh} S={s} (kernel "
          f"S={s_pad}) d={d} band=({start},{end}) in-band pairs={pairs} "
          f"bytes={n_bytes} kernel_ms={kernel_ms:.6f} "
          f"kernel_device_ms={device_ms:.6f} plain_ms={plain_ms:.6f} "
          f"sdpa_ms={library_ms:.6f} bound_ms={bound_ms:.6f} ({bound_by})")
    return {"ms": kernel_ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def _grads(fn, q, k, v, dout):
    """(out, dq, dk, dv) of ``fn`` by autograd."""
    q, k, v = (x.detach().clone().requires_grad_() for x in (q, k, v))
    out = fn(q, k, v)
    out.backward(dout)
    return out.detach(), q.grad, k.grad, v.grad


def check_trainable_attention(torch, ba):
    """K2a/K2b/K2c through the autograd function vs autograd of the plain
    trainable version on the card, at dropout 0 and 0.35, at the paths'
    shapes and at the cases that reach each skip of the kernels' tiling
    (``_tile_cases``).  Returns the max abs error per kernel: K2a out and
    lse, K2b dq, K2c dk and dv."""
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
        *_tile_cases(torch, scale),
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


def _bf16_errors(torch, got, want):
    """(largest ``bf16_ulps``, share of entries whose bfloat16 values
    differ, that is off by one ulp of the entry or more, max abs error)."""
    from pytorch_kaldi_asr_tpu_torch.ops.banded_attention import bf16_ulps

    return (float(bf16_ulps(got, want).max()),
            float((got != want).float().mean()),
            float((got.float() - want.float()).abs().max()))


def check_banded_attention_bf16(torch, ba):
    """K1 on bfloat16 against its plain version on bfloat16 on the card, at
    the decode paths' shapes and the tile-skip cases (``_tile_cases`` with
    d 24 for d 12): within BF16_KERNEL_ULPS, rows with no valid key exact
    zeros.  Returns (max abs error, largest ulps)."""
    scale = 1.0 / math.sqrt(256.0)
    cases = []
    for name in ("timit_decode", "conformer_decode"):
        bh, s, d, (start, end), corpus, n, heads = ATTN_SHAPES[name]
        cases.append((bh, s, d, d, _lengths(torch, corpus, n, heads, s, 1),
                      start, end, scale, f"{name} shape"))
    cases += [(3, 200, 64, 64, [200, 120, 0], -100, 0, scale,
               "S=200, empty row"), *_tile_cases(torch, scale, bf16=True)]
    worst = [0.0, 0.0]
    for bh, s, d, dv, lengths, start, end, sc, name in cases:
        q, k, v, valid = _attention_inputs(torch, bh, s, d, dv, lengths,
                                           seed=bh * s + d)
        q, k, v = (x.bfloat16() for x in (q, k, v))
        got = ba.banded_attention(q, k, v, valid, start=start, end=end,
                                  scale=sc)
        want = ba.banded_attention_reference(q, k, v, valid, start, end, sc)
        torch.cuda.synchronize()
        if got.dtype != torch.bfloat16 or not torch.isfinite(got).all():
            raise AssertionError(f"banded_attention bf16 {name}: bad output")
        ulps, share, err = _bf16_errors(torch, got, want)
        empty = ~_allowed(torch, s, start, end, valid).any(-1)
        if bool((got[empty] != 0).any()):
            raise AssertionError(f"banded_attention bf16 {name}: masked rows "
                                 f"not 0")
        print(f"banded_attention bf16 {name}: bh={bh} S={s} d={d} dv={dv} "
              f"band=({start},{end}) max_ulps={ulps:.2f} "
              f"share_off_by_an_ulp={share:.4f} max_abs_err={err:.3e}")
        if not ulps <= BF16_KERNEL_ULPS:
            raise AssertionError(f"banded_attention bf16 {name}: {ulps} ulps "
                                 f"> {BF16_KERNEL_ULPS}")
        worst = [max(worst[0], err), max(worst[1], ulps)]
    return worst


def check_trainable_attention_bf16(torch, ba):
    """K2a, K2b and K2c on bfloat16 against their plain versions on
    bfloat16 on the card, each on the same inputs (K2b and K2c on the
    kernel's out and lse, K2c on K2b's delta), at dropout 0 and 0.35, at
    the TIMIT train shape, the conformer's (8 utterances) and the tile-skip
    cases: out, dq, dk, dv within BF16_KERNEL_ULPS, lse within KERNEL_ATOL
    and delta within GRAD_ATOL (float32), the same exact zeros as on
    float32.  Returns {kernel: (max abs error, largest ulps)}."""
    scale = 1.0 / math.sqrt(256.0)
    bh, s, d, (start, end), corpus, n, heads = ATTN_SHAPES["conformer_train"]
    cases = [
        (200, 504, 64, 64, _lengths(torch, TIMIT, 100, 2, 504, 2), -100, 0,
         scale, "timit_train shape"),
        (bh // 4, s, d, d, _lengths(torch, corpus, n // 4, heads, s, 2),
         start, end, scale, "conformer_train shape (8 utterances)"),
        (3, 200, 64, 64, [200, 120, 0], -100, 0, scale, "S=200, empty row"),
        *_tile_cases(torch, scale, bf16=True),
    ]
    worst = {"fwd": [0.0, 0.0], "dq": [0.0, 0.0], "dkv": [0.0, 0.0]}
    for rate in (0.0, DROPOUT):
        for bh, s, d, dv, lengths, start, end, sc, name in cases:
            q, k, v, valid = _attention_inputs(torch, bh, s, d, dv, lengths,
                                               seed=bh * s + d + 1)
            dout = torch.randn(v.shape, generator=torch.Generator()
                               .manual_seed(s)).cuda()
            q, k, v, dout = (x.bfloat16() for x in (q, k, v, dout))
            q, k, v, valid = ba._check_and_pad(q, k, v, valid, start, end)
            dout = ba._pad_seq(dout, q.shape[1])
            kw = dict(start=start, end=end, scale=sc, dropout_rate=rate)
            band = (4321, start, end, sc, rate)
            out, lse = ba.banded_attention_fwd(q, k, v, valid, 4321, **kw)
            dq, delta = ba.banded_attention_dq(q, k, v, valid, dout, out,
                                               lse, 4321, **kw)
            dk, dv_ = ba.banded_attention_dkv(q, k, v, valid, dout, lse,
                                              delta, 4321, **kw)
            out_w, lse_w = ba.banded_attention_trainable_reference(
                q, k, v, valid, *band)
            dq_w, delta_w = ba.banded_attention_dq_reference(
                q, k, v, valid, dout, out, lse, *band)
            dk_w, dv_w = ba.banded_attention_dkv_reference(
                q, k, v, valid, dout, lse, delta, *band)
            torch.cuda.synchronize()
            if not torch.equal(torch.isfinite(lse), torch.isfinite(lse_w)):
                raise AssertionError(f"trainable bf16 {name}: lse -inf rows "
                                     f"differ")
            live = torch.isfinite(lse_w)
            errs = {n_: _bf16_errors(torch, g, w) for n_, g, w in (
                ("out", out, out_w), ("dq", dq, dq_w), ("dk", dk, dk_w),
                ("dv", dv_, dv_w))}
            lse_err = float((lse[live] - lse_w[live]).abs().max())
            delta_err = float((delta - delta_w).abs().max())
            invalid = valid == 0
            if bool((out[~live] != 0).any() or (dq[~live] != 0).any()
                    or (dk[invalid] != 0).any() or (dv_[invalid] != 0).any()):
                raise AssertionError(f"trainable bf16 {name}: masked rows "
                                     f"not 0")
            print(f"trainable attention bf16 {name} rate={rate}: bh={bh} "
                  f"S={s} d={d} dv={dv} lse_err={lse_err:.2e} "
                  f"delta_err={delta_err:.2e} (max_ulps, share_off_by_an_ulp"
                  f", max_abs_err) " + json.dumps(errs))
            if max(e[0] for e in errs.values()) > BF16_KERNEL_ULPS \
                    or lse_err > KERNEL_ATOL or delta_err > GRAD_ATOL:
                raise AssertionError(f"trainable bf16 {name} rate={rate}: "
                                     f"{errs} lse {lse_err} delta "
                                     f"{delta_err}")
            for key, names in (("fwd", ("out",)), ("dq", ("dq",)),
                               ("dkv", ("dk", "dv"))):
                for n_ in names:
                    worst[key] = [max(worst[key][0], errs[n_][2]),
                                  max(worst[key][1], errs[n_][0])]
            worst["fwd"][0] = max(worst["fwd"][0], lse_err)
    return worst


def mma_bf16_probe(torch, n=4096):
    """The tensor core's rounding of one m16n8k16 bfloat16 mma (the
    kernels' ``mma_bf16``, through the ``mma_bf16_probe`` entry point) on
    ``n`` random problems, against its float64 sum: the share of outputs
    equal to the sum rounded to nearest, equal to it rounded toward zero,
    below and above the sum in size, and the mean and largest error in
    float32 ulps of the sum, signed along the sum's sign; and the share
    equal to tests/cuda_emu.h's model of it (``tc_sum_bf16``: each addend
    cut toward zero 26 bits below the largest one's leading bit, the sum
    rounded toward zero)."""
    import ctypes

    from pytorch_kaldi_asr_tpu_torch.ops import _build
    from pytorch_kaldi_asr_tpu_torch.ops import banded_attention as ba

    fn = _build.load("banded_attention_train").mma_bf16_probe
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    g = torch.Generator(device="cuda").manual_seed(11)
    a = torch.randn((n, 16, 16), generator=g, device="cuda").bfloat16()
    b = torch.randn((n, 16, 8), generator=g, device="cuda").bfloat16()
    c = torch.randn((n, 16, 8), generator=g, device="cuda")
    d = torch.full_like(c, float("nan"))
    ba._run("mma_bf16_probe", fn, a.device, a.data_ptr(), b.data_ptr(),
            c.data_ptr(), d.data_ptr(), n)
    torch.cuda.synchronize()
    def toward_zero(x):
        f = x.float()
        return torch.where(f.double().abs() > x.abs(),
                           torch.nextafter(f, torch.zeros_like(f)), f)

    exact = a.double() @ b.double() + c.double()
    nearest = exact.float()
    terms = torch.cat([c.double()[..., None], a.double()[:, :, None, :]
                       * b.double().transpose(1, 2)[:, None, :, :]], -1)
    largest = terms.abs().amax(-1, keepdim=True)
    _, e = torch.frexp(largest)  # largest = f 2**e, f in [0.5, 1)
    q = torch.where(largest > 0, torch.ldexp(torch.ones_like(largest), e - 27),
                    torch.ones_like(largest))
    emulated = toward_zero((torch.trunc(terms / q) * q).sum(-1))
    ulp = (torch.nextafter(nearest.abs(), torch.full_like(nearest, math.inf))
           - nearest.abs()).double()
    signed = (d.double() - exact) * exact.sign() / ulp
    out = {"problems": n, "share_equal_nearest": float((d == nearest)
                                                       .float().mean()),
           "share_equal_toward_zero": float((d == toward_zero(exact))
                                            .float().mean()),
           "share_equal_emulator": float((d == emulated).float().mean()),
           "share_smaller_than_exact": float((d.double().abs() < exact.abs())
                                             .float().mean()),
           "share_larger_than_exact": float((d.double().abs() > exact.abs())
                                            .float().mean()),
           "mean_signed_err_ulps": float(signed.mean()),
           "max_abs_err_ulps": float(signed.abs().max())}
    print("MMA_BF16_PROBE " + json.dumps(out))
    return out


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


def _one_launch_each(torch, what, fn, wrappers, names, attr="launches"):
    """Runs ``fn`` under torch.profiler: each of ``wrappers`` must count one
    launch in its count ``attr``, and the card must run exactly the kernels
    ``names`` (PROFILE_NAMES keys), once each, and no other device work."""
    before = [getattr(w, attr) for w in wrappers]
    kernels = device_kernels(torch, fn)
    launched = tuple(getattr(w, attr) - n for w, n in zip(wrappers, before))
    ours = [sum(n for name, n in kernels.items() if PROFILE_NAMES[k] in name)
            for k in names]
    print(f"{what}: wrapper launches {launched}; device kernels {kernels}")
    if launched != (1,) * len(wrappers) or ours != [1] * len(names) \
            or sum(kernels.values()) != len(names):
        raise AssertionError(f"{what} launched {kernels}, expected one "
                             f"each of {names}")
    return kernels


def _launch_check_inputs(torch, dtype=None):
    """q, k, v, key_valid at the conformer's S 1600 for the launch checks,
    q, k, v in ``dtype`` (float32 by default)."""
    q, k, v, valid = _attention_inputs(torch, 8, 1600, 64, 64,
                                       [1600, 1200] * 4, seed=12)
    return (*(x.to(dtype or torch.float32) for x in (q, k, v)), valid)


BAND = dict(start=-256, end=256, scale=0.0625)  # the launch checks' band


def check_forward_launches(torch, ba, dtype=None):
    """One trainable forward on the card is exactly one K2a launch and one
    inference call exactly one K1 launch, with no other device work;
    counted by the wrappers and by torch.profiler at the conformer's band.
    On bfloat16 (``dtype``) the bfloat16 instantiations, counted apart."""
    bf16 = dtype == torch.bfloat16
    sfx, attr = ("_bf16", "launches_bf16") if bf16 else ("", "launches")
    q, k, v, valid = _launch_check_inputs(torch, dtype)
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    _one_launch_each(
        torch, f"one trainable forward{sfx}",
        lambda: ba.banded_attention_trainable(qg, kg, vg, valid, 7,
                                              dropout_rate=0.1, **BAND),
        (ba.banded_attention_fwd,), (f"K2a{sfx}",), attr)
    _one_launch_each(
        torch, f"one banded_attention call{sfx}",
        lambda: ba.banded_attention(q, k, v, valid, **BAND),
        (ba.banded_attention,), (f"K1{sfx}",), attr)


def check_backward_launches(torch, ba, dtype=None):
    """One backward of the trainable attention on the card is exactly two
    kernels, K2b (with delta) then K2c, and no other device work; counted
    by the wrappers and by torch.profiler at the conformer's band.  On
    bfloat16 (``dtype``) the bfloat16 instantiations."""
    bf16 = dtype == torch.bfloat16
    sfx, attr = ("_bf16", "launches_bf16") if bf16 else ("", "launches")
    q, k, v, valid = _launch_check_inputs(torch, dtype)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    dout = torch.randn(v.shape, device="cuda").to(q.dtype)
    out = ba.banded_attention_trainable(q, k, v, valid, 7, dropout_rate=0.1,
                                        **BAND)
    _one_launch_each(
        torch, f"one backward of the trainable attention{sfx}",
        lambda: torch.autograd.grad(out, (q, k, v), dout),
        (ba.banded_attention_dq, ba.banded_attention_dkv),
        (f"K2b{sfx}", f"K2c{sfx}"), attr)


# (bh, s, d, band, lengths, rate) of the K2 timings
TRAIN_TIMING_SHAPES = {
    # the TIMIT training slice: batch 100 x 2 heads, utterances of 412-504
    # frames (no empty query row, so SDPA's softmax is defined everywhere)
    "timit_train": (200, 512, 64, (-100, 0), "timit", DROPOUT),
    # the conformer's train batch: 32 x 4 heads, archives padded to 1600
    "conformer_train": (128, 1600, 64, (-256, 256), "librispeech", 0.1),
}


def train_timing_inputs(torch, ba, shape, dtype=None):
    """(q, k, v, valid, dout, out, lse, seed, kw) at ``shape``
    (TRAIN_TIMING_SHAPES): seeded inputs on the card in ``dtype`` (float32
    by default), the forward's out and lse, and the kernels' keyword
    arguments at the path's rate."""
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
    q, k, v, dout = (x.to(dtype or torch.float32) for x in (q, k, v, dout))
    kw = dict(start=start, end=end, scale=scale, dropout_rate=rate)
    out, lse = ba.banded_attention_fwd(q, k, v, valid, seed, **kw)
    return q, k, v, valid, dout, out, lse, seed, kw


def time_trainable_attention(torch, ba, shape, dtype=None):
    """K2a, K2b and K2c, their plain versions and the library call at
    ``shape`` (TRAIN_TIMING_SHAPES) on ``dtype`` (float32 by default); and
    the backward as the model runs it, K2b (with delta) then K2c, at
    dropout 0 (like for like with SDPA's backward, which computes the same
    dq, dk and dv) and at the path's rate.  SDPA (forward; backward for dq
    and dk/dv together) runs at dropout 0 with the same boolean band mask,
    on the same dtype."""
    import torch.nn.functional as F

    bh, s, d, (start, end), _, rate = TRAIN_TIMING_SHAPES[shape]
    q, k, v, valid, dout, out, lse, seed, kw = train_timing_inputs(
        torch, ba, shape, dtype)
    bf16 = q.dtype == torch.bfloat16
    scale = kw["scale"]
    dq_args = (q, k, v, valid, dout, out, lse, seed)
    _, delta = ba.banded_attention_dq(*dq_args, **kw)
    dkv_args = (q, k, v, valid, dout, lse, delta, seed)

    allowed = _allowed(torch, s, start, end, valid)
    pairs = int(allowed.sum())
    vec = q.element_size() * bh * s * d  # bytes of one [BH, S, 64] tensor
    row = 4 * bh * s  # bytes of one [BH, S] int32/float32 tensor
    tc = dict(tensor_cores=True, bf16=bf16)
    bounds = {  # (bytes: inputs once, outputs once; flops per in-band pair)
        "fwd": _bound(4 * vec + 2 * row, pairs * 4 * d, **tc),
        "dq": _bound(6 * vec + 3 * row, pairs * 6 * d + 2 * bh * s * d, **tc),
        "dkv": _bound(6 * vec + 3 * row, pairs * 8 * d, **tc),
        # the pair's function: q, k, v, dout, out, lse, key_valid in; dq,
        # dk, dv out; five products per pair (S, dP, dV, dK, dQ) and delta.
        # K2b's recomputation of S and dP is a cost of the two-kernel design
        "backward": _bound(8 * vec + 2 * row, pairs * 10 * d + 2 * bh * s * d,
                           **tc),
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
    print(f"trainable attention timing ({shape}, {str(q.dtype)[6:]}): "
          f"BH={bh} S={s} d={d} "
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


def ptxas_summary(log):
    """ptxas's registers and spills for each attention kernel in an nvcc
    log, as "kernel<type, MAXD8>: ..." lines (a source from before the
    kernels took an element type: "kernel<MAXD8>")."""
    import re

    out, entry = [], None
    for line in log.splitlines():
        found = re.search(r"(banded_attention_kernel|fwd_kernel|dq_kernel"
                          r"|dkv_kernel)I(f|13__nv_bfloat16)?Li(\d+)E", line)
        if "Compiling entry function" in line:
            entry = None
            if found:
                dtype = {"f": "float, ", "13__nv_bfloat16": "bf16, "}.get(
                    found[2], "")
                entry = f"{found[1]}<{dtype}{found[3]}>"
        elif entry and ("Used" in line or "spill" in line):
            out.append(f"{entry}: "
                       f"{line.split('ptxas info', 1)[-1].strip(' :')}")
    return out


def finish_k2_builds(procs):
    """{source: ctypes library} of start_k2_builds' processes; prints
    ptxas's registers and spills for each attention kernel."""
    import ctypes

    libs = {}
    for src, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{log}")
        for line in ptxas_summary(log):
            print(f"  {src.name} {line}")
        libs[src] = ctypes.CDLL(str(lib))
    return libs


def _source_calls(torch, ba, shape):
    """{kernel: (pointer arguments, scalar arguments, outputs)} of the
    kernels --k2-sources times at ``shape``: K2a, K2b and K2c at a
    TRAIN_TIMING_SHAPES shape (K2a into outputs of its own, so that K2b and
    K2c read the same out and lse in every build), K1 at a decode shape."""
    if shape not in TRAIN_TIMING_SHAPES:
        q, k, v, valid, start, end, scale = decode_timing_inputs(torch, ba,
                                                                 shape)
        out = torch.empty_like(v)
        return {"k1": ((q, k, v, valid, out),
                       (*q.shape, v.shape[-1], start, end, scale), (out,))}
    q, k, v, valid, dout, out, lse, seed, kw = train_timing_inputs(
        torch, ba, shape)
    scalars = (*q.shape, v.shape[-1], kw["start"], kw["end"], kw["scale"],
               *ba._dropout_args(seed, kw["dropout_rate"]))
    out_f, lse_f, dq, dk, dv = (torch.empty_like(x)
                                for x in (out, lse, q, k, v))
    delta = torch.empty_like(lse)
    return {"fwd": ((q, k, v, valid, out_f, lse_f), scalars, (out_f, lse_f)),
            "dq": ((q, k, v, dout, out, lse, valid, dq, delta), scalars,
                   (dq, delta)),
            "dkv": ((q, k, v, dout, lse, delta, valid, dk, dv), scalars,
                    (dk, dv))}


def compare_k2_sources(torch, ba, libs, rounds=3):
    """Each attention kernel of each build in ``libs`` ({source: ctypes
    library}) that has its entry point, on the same inputs: K2a, K2b (dq
    with delta) and K2c at each TRAIN_TIMING_SHAPES shape at the path's
    rate, K1 at both decode shapes.  CUDA-event times in ``rounds`` rounds
    that take the builds in turns, and each build's largest difference from
    the first build's outputs (0 where both are -inf)."""
    fns = {src: {} for src in libs}
    for src, lib in libs.items():
        for which in ("k1", "fwd", "dq", "dkv"):
            try:
                fns[src][which] = ba.kernel_entry(lib, which)
            except AttributeError:  # a source without this kernel
                pass
    results = {}
    for shape in (*TRAIN_TIMING_SHAPES, "timit_decode", "conformer_decode"):
        calls = _source_calls(torch, ba, shape)

        def launch(src, which):
            tensors, scalars, _ = calls[which]
            ptrs = [t.data_ptr() for t in tensors]
            return lambda: ba._run(f"{src.name} {which}", fns[src][which],
                                   tensors[0].device, *ptrs, *scalars)

        first, diff = {}, {src: {} for src in libs}
        for src in libs:
            for which in calls:  # in order: K2c reads K2b's delta
                if which not in fns[src]:
                    continue
                launch(src, which)()
                got = [x.clone() for x in calls[which][2]]
                first.setdefault(which, got)
                diff[src][which] = max(
                    float(torch.nan_to_num((a - b).abs(), nan=0.0).max())
                    for a, b in zip(got, first[which]))
        times = {src: {w: [] for w in calls if w in fns[src]} for src in libs}
        for _ in range(rounds):
            for src in libs:
                for which in times[src]:
                    times[src][which].append(time_ms(
                        torch, launch(src, which), iters=20, warmup=3))
        results[shape] = {
            str(src): {**{f"{w}_ms": t for w, t in times[src].items()},
                       "max_diff_from_first": diff[src]}
            for src in libs}
    return results


# ---------------------------------------------------------------------------
# kernel phase: K3
# ---------------------------------------------------------------------------

K3_SHAPES = ((51200, 1024), (51200, 256))  # the conformer's sites at 32 x 1600


def _k3_thresholds(torch, fd, rate, dtype):
    """{name: (threshold, scale)} of the kernel's two users at ``rate`` on
    ``dtype``: the model's 8-bit draw (on bfloat16 its scale 256/q is
    rounded to bfloat16, as models/common.py rounds it) and the TPU
    kernel's exact threshold."""
    q = round((1.0 - rate) * 256)
    scale8 = 256.0 / q
    if dtype == torch.bfloat16:
        scale8 = float(torch.tensor(scale8, dtype=dtype))
    return {"8-bit": ((256 - q) << 24, scale8),
            "exact": (fd.fused_dropout_threshold(rate), 1.0 / (1.0 - rate))}


def _bits(torch, x):
    """x's bit patterns, so that equal means bit for bit (+0 vs -0 too)."""
    return x.view(torch.int16 if x.element_size() == 2 else torch.int32)


def check_fused_dropout(torch, fd, dtype=None):
    """K3 forward and backward against its plain version on the card, on
    ``dtype`` (float32 by default, or bfloat16): the same mask (0
    mismatches), outputs and gradients bit-equal, at the conformer's shapes
    for both thresholds at rates 0.1 and 0.35, and at edge cases (a size
    that leaves a tail of the kernel's 16-byte groups, a non-contiguous
    input, a misaligned view, one row, rate 0).  Returns the max abs error
    (0 when all is bit-equal)."""
    import numpy as np

    dtype = dtype or torch.float32
    g = torch.Generator(device="cuda").manual_seed(3)
    cases = [(shape, rate, which, "contiguous")
             for shape in K3_SHAPES for rate in (0.1, 0.35)
             for which in ("8-bit", "exact")]
    cases += [((4097, 3), 0.35, "exact", "size % 8 != 0"),
              ((1024, 256), 0.1, "8-bit", "non-contiguous"),
              ((1023, 5), 0.1, "8-bit", "misaligned"),
              ((1, 1024), 0.35, "exact", "one row"),
              ((51200, 256), 0.0, "exact", "rate 0")]
    for shape, rate, which, name in cases:
        threshold, scale = _k3_thresholds(torch, fd, rate, dtype)[which]
        scale32 = float(np.float32(scale))
        x = torch.randn(shape, generator=g, device="cuda").to(dtype)
        if name == "non-contiguous":
            x = x.t()
        if name == "misaligned":  # 2 or 4 bytes past a 16-byte boundary
            x = torch.randn(x.numel() + 1, generator=g, device="cuda").to(
                dtype)[1:].view(shape)
            assert x.data_ptr() % 16
        x.requires_grad_()
        dout = torch.randn(x.shape, generator=g, device="cuda").to(dtype)
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
        out_equal = torch.equal(_bits(torch, y.contiguous()),
                                _bits(torch, want.contiguous()))
        grad_equal = torch.equal(_bits(torch, x.grad.contiguous()),
                                 _bits(torch, want_grad.contiguous()))
        print(f"fused_dropout {str(dtype)[6:]} {name} {list(shape)} "
              f"rate={rate} {which}: mask mismatches={mismatches} "
              f"keep={kept:.6f} out bit-equal={out_equal} "
              f"grad bit-equal={grad_equal}")
        if mismatches or not out_equal or not grad_equal \
                or y.dtype != dtype or x.grad.dtype != dtype:
            raise AssertionError(f"fused_dropout {dtype} {name} {shape} "
                                 f"{rate} {which}: kernel and plain version "
                                 f"differ")
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
    threshold, scale = _k3_thresholds(torch, fd, rate, torch.float32)["8-bit"]
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


def time_fused_dropout(torch, fd, shape=K3_SHAPES[0], rate=0.1, dtype=None):
    """K3 (the model's 8-bit threshold) on ``dtype`` (float32 by default),
    its plain version and ``F.dropout`` on the same tensor (the same bytes,
    another generator) at ``shape``; on float32 also the port's former
    8-bit draw (``former_draw``, five launches) and K3's host cost."""
    import torch.nn.functional as F

    dtype = dtype or torch.float32
    x = torch.randn(shape, generator=torch.Generator(device="cuda")
                    .manual_seed(1), device="cuda").to(dtype)
    threshold, scale = _k3_thresholds(torch, fd, rate, dtype)["8-bit"]
    q = round((1.0 - rate) * 256)
    gen = torch.Generator(device="cuda").manual_seed(2)

    kernel_ms = time_ms(torch, lambda: fd.dropout_mask_pass(
        x, 7, threshold, scale))
    plain_ms = time_ms(torch, lambda: fd.fused_dropout_reference(
        x, 7, threshold, scale), iters=10, warmup=2)
    library_ms = time_ms(torch, lambda: F.dropout(x, rate, training=True))
    n_bytes = 2 * x.element_size() * x.numel()
    bound_ms, bound_by = _bound(n_bytes, x.numel())
    out = {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": library_ms}
    if dtype == torch.float32:
        out["former_draw_ms"] = time_ms(torch, lambda: former_draw(
            torch, x, q, gen))
        out["host_us"] = k3_host_us(torch, fd, rate)
    print(f"fused_dropout timing: {str(dtype)[6:]} {list(shape)} rate={rate} "
          f"(8-bit) kernel_ms={kernel_ms:.6f} plain_ms={plain_ms:.6f} "
          f"F.dropout_ms={library_ms:.6f} "
          f"former_draw_ms={out.get('former_draw_ms')} "
          f"bound_ms={bound_ms:.6f} ({bound_by}) "
          f"achieved_GB/s={n_bytes / kernel_ms / 1e6:.1f}")
    return out


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
    vocab.txt (4 control words + the corpus's words).  TIMIT's shape (no
    lognormal lengths) keeps the generator of earlier runs (torch), so its
    data stay the same.  Returns the number of frames."""
    import numpy as np

    data_dir.mkdir(parents=True)
    words = corpus["words"]
    with open(data_dir / "vocab.txt", "w") as f:
        for i, word in enumerate(["<blank>", "<unk>", "<s>", "</s>"] + words):
            f.write(f"{word} {i}\n")
    if "lognormal" not in corpus:
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


def compare_nbest(gpu, cpu, atol=CPU_SCORE_ATOL, word_gap=WORD_GAP):
    """Scores within ``atol`` lane by lane; words identical wherever a
    hypothesis's score is more than ``word_gap`` from its neighbours'."""
    worst = 0.0
    for key, hyps in cpu.items():
        ref = gpu[key]
        if len(ref) != len(hyps):
            raise AssertionError(f"{key}: {len(ref)} vs {len(hyps)} lines")
        scores = [s for s, _ in ref]
        for i, ((s_g, w_g), (s_c, w_c)) in enumerate(zip(ref, hyps)):
            worst = max(worst, abs(s_g - s_c))
            if abs(s_g - s_c) > atol:
                raise AssertionError(f"{key} rank {i}: score {s_g} (card) "
                                     f"vs {s_c} (cpu)")
            gaps = [abs(scores[i] - scores[j]) for j in (i - 1, i + 1)
                    if 0 <= j < len(scores)]
            if min(gaps, default=math.inf) > word_gap and w_g != w_c:
                raise AssertionError(f"{key} rank {i}: words differ: "
                                     f"{w_g!r} vs {w_c!r}")
    return worst


def nbest_distance(gpu, cpu):
    """Two n-best files' largest score difference, rank by rank, and the
    largest gap between a hypothesis's score and its neighbours' at which
    their words differ (0.0 where the words agree throughout)."""
    worst = word_gap = 0.0
    for key, hyps in cpu.items():
        scores = [s for s, _ in gpu[key]]
        for i, ((s_g, w_g), (s_c, w_c)) in enumerate(zip(gpu[key], hyps)):
            worst = max(worst, abs(s_g - s_c))
            if w_g != w_c:
                word_gap = max(word_gap, min(
                    (abs(scores[i] - scores[j]) for j in (i - 1, i + 1)
                     if 0 <= j < len(scores)), default=math.inf))
    return worst, word_gap


def compare_nbest_bf16(gpu, cpu, cpu32):
    """The bfloat16 stream's n-best, card vs CPU: scores within
    BF16_SCORE_ATOL, words identical wherever a score is more than
    WORD_GAP from its neighbours'.  Returns (largest card-vs-CPU score
    difference, the stream's own: the CPU's bfloat16 scores against its
    float32 ones, rank by rank)."""
    own, _ = nbest_distance(cpu32, cpu)
    worst = compare_nbest(gpu, cpu, atol=BF16_SCORE_ATOL)
    return worst, own


def initialize(corpus, feats_scp, vocab, model, model_args=None, seed=SEED):
    """The port's initialize_model CLI at ``corpus``'s flags (or
    ``model_args``), then the corpus's ``compute_dtype`` written into the
    checkpoint's config.json."""
    from pytorch_kaldi_asr_tpu_torch.recipes import initialize_model

    initialize_model.main([
        "-read_feats_scp_file", str(feats_scp), "-lda_mat_file", "identity",
        "-read_vocab_file", str(vocab), "-seed", str(seed),
        "-save_model_file", str(model), *(model_args or corpus["model"])])
    if "compute_dtype" in corpus:
        path = Path(model) / "config.json"
        config = json.loads(path.read_text())
        config["compute_dtype"] = corpus["compute_dtype"]
        path.write_text(json.dumps(config))


def _sync(torch, device):
    return torch.cuda.synchronize if device == "cuda" else (lambda: None)


def run_slice(torch, corpus=TIMIT, device="cuda", model_args=None):
    """Stage 3 and stage 5 of ``corpus``'s recipe with the port on
    ``device``, then the first decode batch again on the CPU (its first
    ``cpu_utts`` utterances where the corpus's decode sets it).  Returns
    the run's numbers; ``launches`` are the decode's."""
    from pytorch_kaldi_asr_tpu_torch.data import read_vocab
    from pytorch_kaldi_asr_tpu_torch.data.loader import make_batch_loader
    from pytorch_kaldi_asr_tpu_torch.io import kaldi_io
    from pytorch_kaldi_asr_tpu_torch.recipes import decode

    spec = corpus["decode"]
    work = WORK / corpus["name"] / "decode"
    if work.exists():
        shutil.rmtree(work)
    data = work / "data"
    frames = write_data_dir(data, kaldi_io, torch, corpus, spec["utts"])
    model = work / "model"
    initialize(corpus, data / "feats.scp", data / "vocab.txt", model,
               model_args)

    def decode_args(data_dir, out, device, model=model):
        return ["-read_data_dir", str(data_dir), "-read_vocab_file",
                str(data / "vocab.txt"), "-load_model_file", str(model),
                "-save_result_file", str(out), "-device", device,
                "-batch_size", str(spec["batch"]), "-num_buckets",
                str(spec["buckets"]), "-beam_size", str(spec["beam"]),
                "-nbest", str(spec["nbest"]), "-max_token_seq_len",
                str(spec["max_tokens"])]

    sync = _sync(torch, device)
    # the main path: every launch count at 0 just before, read just after;
    # the wall time split by the CLI (load, data, encoder, search, write)
    reset_launch_counts()
    split = {}
    sync()
    t0 = time.perf_counter()
    decode.main(decode_args(data, work / "decode.txt", device),
                timings=split)
    sync()
    decode_s = time.perf_counter() - t0
    launches = launch_counts()
    split["other_s"] = decode_s - sum(split.values())

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

    first = next(iter(loader))
    keys = [key for key, ok in zip(first.keys, first.valid) if ok]
    keys = keys[:spec.get("cpu_utts", len(keys))]
    bf16_error = check = None
    t0 = time.perf_counter()
    if corpus.get("compute_dtype") == "bfloat16":
        check = bf16_compute_decode_check(torch, model, data, spec, device)
        print(f"{corpus['name']}: first decode batch, card vs cpu: "
              + json.dumps(check))
        if check["encoder_ratio"] > corpus["decode_encoder_ratio"] \
                or check["encoder_from_float32"] < BF16_DECODE_FLOAT32_FLOOR \
                or not check["search_same_tokens"] \
                or check["search_max_score_diff"] > CPU_SCORE_ATOL:
            raise AssertionError(f"{corpus['name']}: the card's decode "
                                 f"against the CPU's: {check}")
        score_err = check["search_max_score_diff"]
    else:  # the first decode batch again, on the CPU
        sub = work / "data_first_batch"
        sub.mkdir()
        scp = dict(kaldi_io.scp_entries(str(data / "feats.scp")))
        with open(sub / "feats.scp", "w") as f:
            f.writelines(f"{key} {scp[key]}\n" for key in keys)
        with open(data / "text") as src, open(sub / "text", "w") as dst:
            dst.writelines(line for line in src if line.split()[0] in keys)
        decode.main(decode_args(sub, work / "decode_cpu.txt", "cpu"))
        cpu = read_nbest(work / "decode_cpu.txt")
        if sorted(cpu) != sorted(keys):
            raise AssertionError("the CPU decode covered other utterances")
        config = json.loads((model / "config.json").read_text())
        if config["conformer_stream_dtype"] == "bfloat16":
            # the same weights with a float32 stream: the bfloat16
            # stream's own error is the card's yardstick
            model32 = work / "model_f32"
            shutil.copytree(model, model32)
            config["conformer_stream_dtype"] = "float32"
            (model32 / "config.json").write_text(json.dumps(config))
            decode.main(decode_args(sub, work / "decode_cpu_f32.txt", "cpu",
                                    model32))
            score_err, bf16_error = compare_nbest_bf16(
                gpu, cpu, read_nbest(work / "decode_cpu_f32.txt"))
        else:
            score_err = compare_nbest(gpu, cpu)
    cpu_s = time.perf_counter() - t0

    audio_s = frames * 0.010
    return {
        "corpus": corpus["name"], "utterances": spec["utts"],
        "frames": frames, "batches": len(loader), "launches": launches,
        "decode_s": decode_s, "rtf": decode_s / audio_s,
        "time_split_s": split, "model": str(model),
        "first_batch_keys": keys,
        "decode_again_s": decode_again_s,
        "rtf_again": decode_again_s / audio_s,
        "cpu_first_batch_s": cpu_s, "cpu_vs_card_max_score_err": score_err,
        "cpu_bf16_vs_f32_max_score_diff": bf16_error,
        "bf16_compute_decode_check": check,
    }


def bf16_compute_decode_check(torch, model, data, spec, device="cuda",
                              fault=None):
    """The first decode batch of a bfloat16-compute ``model``, card
    against CPU, in two parts that the search's near-ties cannot confuse
    (a bfloat16 encoder moves the card's scores enough to reorder a beam,
    where the float32 model's do not).  The encoder output: mean |card -
    CPU| over the valid frames, over bfloat16's own error (the CPU's
    float32-compute encoder), at most the corpus's
    ``decode_encoder_ratio``, and its distance from the float32 encoder
    over the same, at least BF16_DECODE_FLOAT32_FLOOR.  The search
    (float32 decoder steps, as in the JAX package): the KV-cached
    search on the CPU from the card's encoder output finds the card's
    n-best tokens, scores within CPU_SCORE_ATOL.  ``fault`` is planted on
    the card (``planted_fault``; ``float32_compute`` runs it so).  Returns
    the numbers."""
    from pytorch_kaldi_asr_tpu_torch.data import read_vocab
    from pytorch_kaldi_asr_tpu_torch.data.loader import make_batch_loader, to_device
    from pytorch_kaldi_asr_tpu_torch.decode.fast_beam import (
        fast_beam_search_memory,
    )
    from pytorch_kaldi_asr_tpu_torch.models.transformer import encode, tree_map
    from pytorch_kaldi_asr_tpu_torch.train import load_checkpoint

    ckpt = load_checkpoint(str(model))
    params, cfg = ckpt["params"], ckpt["cfg"]
    loader = make_batch_loader(str(data), read_vocab(str(data / "vocab.txt")),
                               spec["batch"], mode="all", shuffle=False,
                               num_buckets=spec["buckets"])
    first = next(iter(loader))
    b_dev, b_cpu = to_device(first, device), to_device(first, "cpu")
    params_dev = tree_map(lambda t: t.to(device), params)
    dev_cfg = (cfg.replace(compute_dtype="float32")
               if fault == "float32_compute" else cfg)
    with torch.no_grad(), planted_fault(torch, fault):
        enc_dev, mask_f = encode(params_dev, dev_cfg, b_dev.src,
                                 b_dev.src_mask)
    with torch.no_grad():
        enc_cpu, mask_cpu = encode(params, cfg, b_cpu.src, b_cpu.src_mask)
        enc32, _ = encode(params, own_error_config(cfg), b_cpu.src,
                          b_cpu.src_mask)
    keep = (mask_cpu > 0) & (b_cpu.valid[:, None] > 0)
    card, cpu, cpu32 = (x.cpu().double()[keep] for x in (enc_dev, enc_cpu,
                                                         enc32))
    own = (cpu - cpu32).abs().mean()
    ratio = float((card - cpu).abs().mean() / own)
    from_float32 = float((card - cpu32).abs().mean() / own)
    kw = dict(beam_size=spec["beam"], max_len=spec["max_tokens"])
    res_dev = fast_beam_search_memory(params_dev, cfg, enc_dev, mask_f, **kw)
    res_cpu = fast_beam_search_memory(params, cfg, enc_dev.cpu(),
                                      mask_f.cpu(), **kw)
    same_tokens = torch.equal(res_dev.tokens.cpu(), res_cpu.tokens)
    score_err = float((res_dev.scores.cpu() - res_cpu.scores).abs().max())
    return {"encoder_ratio": ratio, "encoder_from_float32": from_float32,
            "search_same_tokens": same_tokens,
            "search_max_score_diff": score_err}


def check_fixed_buffer_search(torch, corpus, summary, device="cuda"):
    """On the first decode batch of ``corpus`` (run_slice's ``summary``:
    its checkpoint, data and first batch), the fixed-buffer ``beam_search``
    against the KV-cached ``fast_beam_search`` on the card: the same
    n-best tokens, scores within CPU_SCORE_ATOL.  Returns both searches'
    times (the card synchronised) and the largest score difference."""
    from pytorch_kaldi_asr_tpu_torch.data import read_vocab
    from pytorch_kaldi_asr_tpu_torch.data.loader import make_batch_loader, to_device
    from pytorch_kaldi_asr_tpu_torch.decode.beam import beam_search
    from pytorch_kaldi_asr_tpu_torch.decode.fast_beam import fast_beam_search
    from pytorch_kaldi_asr_tpu_torch.decode.runner import nbest_from_result
    from pytorch_kaldi_asr_tpu_torch.train import load_checkpoint

    spec = corpus["decode"]
    data = Path(summary["model"]).parent / "data"
    ckpt = load_checkpoint(summary["model"], device=device)
    loader = make_batch_loader(str(data), read_vocab(str(data / "vocab.txt")),
                               spec["batch"], mode="all", shuffle=False,
                               num_buckets=spec["buckets"])
    b = to_device(next(iter(loader)), device)
    kw = dict(beam_size=spec["beam"], max_len=spec["max_tokens"])
    sync = _sync(torch, device)
    results, times = {}, {}
    for search in (fast_beam_search, beam_search, fast_beam_search,
                   beam_search):
        sync()
        t0 = time.perf_counter()
        results[search.__name__] = search(ckpt["params"], ckpt["cfg"], b.src,
                                          b.src_mask, **kw)
        sync()
        times[search.__name__] = time.perf_counter() - t0  # the second run
    fast, fixed = (nbest_from_result(results[n], spec["nbest"])
                   for n in ("fast_beam_search", "beam_search"))
    worst = 0.0
    for utt, (hyps_f, hyps_b) in enumerate(zip(fast, fixed)):
        for rank, ((seq_f, s_f), (seq_b, s_b)) in enumerate(zip(hyps_f,
                                                                hyps_b)):
            worst = max(worst, abs(s_f - s_b))
            if seq_f != seq_b or abs(s_f - s_b) > CPU_SCORE_ATOL:
                raise AssertionError(
                    f"{corpus['name']} utterance {utt} rank {rank}: "
                    f"beam_search {seq_b} {s_b} vs fast_beam_search "
                    f"{seq_f} {s_f}")
    out = {"fast_beam_search_s": times["fast_beam_search"],
           "beam_search_s": times["beam_search"],
           "max_score_diff": worst, "utterances": len(fast)}
    print(f"{corpus['name']}: beam_search = fast_beam_search on the first "
          f"decode batch: " + json.dumps(out))
    return out


# the CPU's train steps by their inputs: the conformer paths share their
# references (the float32 model's step is the bfloat16 stream's yardstick,
# the bfloat16 stream's step bfloat16 compute's)
CPU_STEPS = {}


def _digest(torch, params, batch):
    """A hash of every array in the parameter tree and the batch."""
    import numpy as np

    from pytorch_kaldi_asr_tpu_torch.models.transformer import tree_map

    h = hashlib.sha1()

    def add(t):
        if isinstance(t, torch.Tensor):
            t = t.detach().cpu().contiguous().reshape(-1)
            h.update(f"{t.dtype}{tuple(t.shape)}".encode())
            h.update(t.view(torch.uint8).numpy())
        elif isinstance(t, np.ndarray):
            h.update(f"{t.dtype}{t.shape}".encode())
            h.update(np.ascontiguousarray(t).tobytes())
        else:
            h.update(repr(t).encode())
        return t

    tree_map(add, params)
    tree_map(add, list(batch))
    return h.hexdigest()


def cpu_step(torch, params, cfg, batch):
    """``_step_on`` the CPU at dropout seed 0, taken once for the same
    inputs (CPU_STEPS).  Only the main paths' references come from here:
    a fault planted in memory is not among the inputs."""
    key = (repr(cfg), _digest(torch, params, batch))
    if key not in CPU_STEPS:
        CPU_STEPS[key] = _step_on(torch, "cpu", params, cfg, batch)
    return CPU_STEPS[key]


def _step_on(torch, device, params, cfg, batch, dtype=None, seed=0):
    """One train step from ``params`` on ``device`` (in ``dtype``, default
    float32; dropout masks from ``seed``); returns (loss, {leaf path:
    gradient on the CPU in float64})."""
    from pytorch_kaldi_asr_tpu_torch.data.loader import to_device
    from pytorch_kaldi_asr_tpu_torch.models.transformer import tree_map
    from pytorch_kaldi_asr_tpu_torch.train import create_train_state, train_step
    from pytorch_kaldi_asr_tpu_torch.train.optim import named_leaves

    dtype = dtype or torch.float32
    state = create_train_state(
        tree_map(lambda t: t.detach().to(device, dtype, copy=True), params),
        seed=seed)
    b = to_device(batch, device)
    metrics = train_step(state, cfg, b.src.to(dtype), b.src_mask, b.tgt,
                         b.tgt_mask)
    return (float(metrics["loss"]),
            {path: p.grad.cpu().double()
             for path, p in named_leaves(state.params)
             if p.grad is not None})  # the tdnn's LDA is frozen


def _rel_err(a, b):
    """max |a - b| over the largest |b|."""
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def one_ulp_off(torch, params, seed=9):
    """``params`` with every weight moved one float32 ulp (random signs):
    the CPU's own float32 noise, as a yardstick."""
    from pytorch_kaldi_asr_tpu_torch.models.transformer import tree_map

    signs = torch.Generator().manual_seed(seed)
    return tree_map(lambda t: t * (1 + (torch.randint(
        0, 2, t.shape, generator=signs) * 2 - 1) * 2.0 ** -23), params)


def f32_noise_ratios(torch, grads_dev, grads_cpu, grads_ulp):
    """Per leaf: the card's distance from the CPU step, the CPU's own noise
    (its step with the weights one ulp off, at least NOISE_FLOOR), both over
    the leaf's largest entry, and their ratio."""
    out = {}
    for k in grads_cpu:
        err = _rel_err(grads_dev[k], grads_cpu[k])
        noise = max(_rel_err(grads_ulp[k], grads_cpu[k]), NOISE_FLOOR)
        out[k] = (err, noise, err / noise)
    return out


def card_vs_cpu_step(torch, device, params, cfg, batch, seed=0):
    """One train step on ``device`` and on the CPU from the same parameters
    and batch (the dropout masks are the same on both).  The loss must
    agree within STEP_LOSS_RTOL and every gradient leaf within
    STEP_GRAD_RTOL of its largest entry.  A leaf whose float32 gradient is
    ill-conditioned (a sum over tens of thousands of frames that cancels)
    differs by more between any two float32 summation orders; where a leaf
    is over, the CPU step runs again with every weight one float32 ulp off
    (``one_ulp_off``), and the card may be at most F32_NOISE_RATIO times
    that step's distance from the CPU's (``f32_noise_ratios``).  Returns
    the numbers."""
    loss_dev, grads_dev = _step_on(torch, device, params, cfg, batch,
                                   seed=seed)
    t0 = time.perf_counter()
    loss_cpu, grads_cpu = (cpu_step(torch, params, cfg, batch) if seed == 0
                           else _step_on(torch, "cpu", params, cfg, batch,
                                         seed=seed))
    cpu_s = time.perf_counter() - t0
    loss_err = abs(loss_dev - loss_cpu) / abs(loss_cpu)
    errs = {k: _rel_err(grads_dev[k], grads_cpu[k]) for k in grads_cpu}
    worst = max(errs, key=errs.get)
    out = {"loss": loss_dev, "loss_cpu": loss_cpu, "loss_rel_err": loss_err,
           "grad_rel_err": errs[worst], "worst_leaf": str(worst),
           "cpu_step_s": cpu_s, "noise_checks": {}}
    if loss_err > STEP_LOSS_RTOL:
        raise AssertionError(f"train step {device} vs cpu: loss {loss_err}")
    over = [k for k, e in errs.items() if e > STEP_GRAD_RTOL]
    if over:
        _, grads_ulp = _step_on(torch, "cpu", one_ulp_off(torch, params),
                                cfg, batch, seed=seed)
        ratios = f32_noise_ratios(torch, grads_dev, grads_cpu, grads_ulp)
        for k in over:
            err, noise, ratio = ratios[k]
            out["noise_checks"][str(k)] = {"card_vs_cpu": err,
                                           "cpu_noise": noise,
                                           "ratio": ratio}
            if ratio > F32_NOISE_RATIO:
                raise AssertionError(
                    f"train step {device} vs cpu: gradient {k} differs by "
                    f"{err:.2e} of its max, {ratio:.2f} times the CPU's own "
                    f"float32 noise {noise:.2e} (gate {F32_NOISE_RATIO})")
    return out


def bf16_step_ratios(torch, dev, cpu16, cpu32):
    """For the loss and each gradient leaf, the distance of the step
    ``dev`` from the CPU's bfloat16 step ``cpu16`` over bfloat16's own
    error, ``cpu16``'s distance from the step ``cpu32`` without the
    bfloat16 under test (``own_error_config``; each a ``_step_on``
    result): per leaf over its largest entry (``largest``) and over its
    mean (``mean``), the loss at least to the float32 gate's
    STEP_LOSS_RTOL.  Adds the median leaf and the largest of each; and
    ``from_float32_median_leaf``, the median over the leaves of ``dev``'s
    distance from ``cpu32`` over ``cpu16``'s (by the largest entries):
    about 1 for a bfloat16 computation, about 0 for one without it."""
    (loss_dev, g_dev), (loss16, g16), (loss32, g32) = dev, cpu16, cpu32

    def ratio(k, stat, ref=g16):
        num, den = (float(stat((a[k] - b[k]).abs()))
                    for a, b in ((g_dev, ref), (g16, g32)))
        return num / den if den > 0 else (0.0 if num == 0 else math.inf)

    # the loss's bfloat16 error is a few float32 ulps (its rounding errors
    # cancel over the tokens): it is held to the float32 gate's tolerance
    # where that is the larger
    out = {"loss_ratio": abs(loss_dev - loss16) / max(
        abs(loss16 - loss32), STEP_LOSS_RTOL * abs(loss16) / BF16_LEAF_RATIO)}
    for name, stat in (("largest", torch.max), ("mean", torch.mean)):
        leaves = {str(k): ratio(k, stat) for k in g16}
        worst = max(leaves, key=leaves.get)
        out.update({name: leaves, f"{name}_median_leaf":
                    statistics.median(leaves.values()),
                    f"{name}_worst_leaf": worst,
                    f"{name}_worst": leaves[worst]})
    out["from_float32_median_leaf"] = statistics.median(
        ratio(k, torch.max, g32) for k in g16)
    return out


def own_error_config(cfg):
    """``cfg`` without the bfloat16 under test: float32 compute where its
    compute is bfloat16 (its stream as it is), else a float32 stream.  The
    CPU's distance from this model is bfloat16's own error, the bfloat16
    gates' yardstick."""
    if cfg.compute_dtype == "bfloat16":
        return cfg.replace(compute_dtype="float32")
    return cfg.replace(conformer_stream_dtype="float32")


def bf16_limits(cfg):
    """(statistic, median limit, leaf limit) of the bfloat16 step gate for
    ``cfg``: bfloat16 compute's over the leaves' mean entries (no median
    limit), or the bfloat16 stream's over their largest
    (``bf16_step_ratios``)."""
    if cfg.compute_dtype == "bfloat16":
        return "mean", math.inf, BF16_COMPUTE_LEAF_RATIO
    return "largest", BF16_MEDIAN_RATIO, BF16_LEAF_RATIO


def bf16_card_vs_cpu_step(torch, device, params, cfg, batch):
    """One train step of a bfloat16 model (its stream or its compute
    bfloat16) with dropout on, three times with the same masks: on
    ``device``, on the CPU, and on the CPU without the bfloat16 under test
    (``own_error_config``).  By ``bf16_step_ratios`` over the statistic of
    ``bf16_limits``, the median leaf must be at most its median limit (the
    stream's) and every leaf (and the stream's loss) at most its leaf
    limit; in
    bfloat16 compute the median leaf's distance from the float32-compute
    step at least BF16_COMPUTE_FLOAT32_FLOOR.  Asserts that a bfloat16
    stream's encoder output on the card is bfloat16.  Returns every
    ratio."""
    from pytorch_kaldi_asr_tpu_torch.data.loader import to_device
    from pytorch_kaldi_asr_tpu_torch.models.transformer import encode, tree_map

    if cfg.encoder_type == "conformer" and \
            cfg.conformer_stream_dtype == "bfloat16":
        b = to_device(batch, device)
        with torch.no_grad():
            enc, _ = encode(tree_map(lambda t: t.to(device), params), cfg,
                            b.src, b.src_mask)
        if enc.dtype != torch.bfloat16:
            raise AssertionError(f"the bfloat16 stream encoded to "
                                 f"{enc.dtype}")
    stat, median_limit, leaf_limit = bf16_limits(cfg)
    dev = _step_on(torch, device, params, cfg, batch)
    t0 = time.perf_counter()
    cpu16 = cpu_step(torch, params, cfg, batch)
    cpu32 = cpu_step(torch, params, own_error_config(cfg), batch)
    r = bf16_step_ratios(torch, dev, cpu16, cpu32)
    out = {"loss": dev[0], "loss_cpu_bf16": cpu16[0], "loss_cpu_f32": cpu32[0],
           "cpu_steps_s": time.perf_counter() - t0, **r}
    print("bfloat16 train step ratios: median leaf "
          f"{r['largest_median_leaf']:.3f} (means {r['mean_median_leaf']:.3f}"
          f"; from float32 {r['from_float32_median_leaf']:.3f}), worst leaf "
          f"{r['largest_worst']:.3f} (means {r['mean_worst']:.3f}), loss "
          f"{r['loss_ratio']:.3f}; by {stat}: " + json.dumps(
              sorted(r[stat].items(), key=lambda kv: -kv[1])[:12]))
    if not all(math.isfinite(v)
               for v in (r["loss_ratio"], *r["largest"].values())):
        raise AssertionError(f"bfloat16 train step {device} vs cpu: a "
                             f"ratio is not finite")
    if r[f"{stat}_median_leaf"] > median_limit:
        raise AssertionError(
            f"bfloat16 train step {device} vs cpu: the median leaf at "
            f"{r[f'{stat}_median_leaf']:.3f} of bfloat16's own error by "
            f"{stat} (gate {median_limit})")
    if cfg.compute_dtype == "bfloat16" and \
            r["from_float32_median_leaf"] < BF16_COMPUTE_FLOAT32_FLOOR:
        raise AssertionError(
            f"bfloat16 train step {device}: the median leaf only "
            f"{r['from_float32_median_leaf']:.3f} of bfloat16's own error "
            f"from the float32-compute step: not a bfloat16 computation "
            f"(floor {BF16_COMPUTE_FLOAT32_FLOOR})")
    # bfloat16 compute's loss is printed, not gated: its bfloat16 error
    # cancels over the tokens (to 0.2-8.7 of the leaves' scale when sound,
    # PERF.md, PR 7), so its yardstick is noise
    candidates = [(r[f"{stat}_worst_leaf"], r[f"{stat}_worst"])]
    if cfg.compute_dtype != "bfloat16":
        candidates.append(("loss", r["loss_ratio"]))
    worst, value = max(candidates, key=lambda kv: kv[1])
    if value > leaf_limit:
        raise AssertionError(f"bfloat16 train step {device} vs cpu: {worst} "
                             f"at {value:.3f} of bfloat16's own error by "
                             f"{stat} (gate {leaf_limit})")
    return out


@contextlib.contextmanager
def dq_scaled(factor):
    """K2b's dq multiplied by ``factor`` on the card (a planted fault of the
    float32 gate's readings), restored on exit."""
    from pytorch_kaldi_asr_tpu_torch.ops import banded_attention as ba

    sound = ba.banded_attention_dq

    def scaled(*args, **kw):
        dq, delta = sound(*args, **kw)
        return (dq * factor if dq.is_cuda else dq), delta

    # the wrapper counts its launches on the module's name, now this one
    scaled.launches, scaled.launches_bf16 = sound.launches, sound.launches_bf16
    ba.banded_attention_dq = scaled
    try:
        yield
    finally:
        ba.banded_attention_dq = sound
        sound.launches, sound.launches_bf16 = (scaled.launches,
                                               scaled.launches_bf16)


def f32_gate_readings(torch, device, params, cfg, batches, seeds=(0, 1, 2)):
    """What the float32 step gate reads on the TIMIT model: at each of
    ``seeds`` (the dropout masks) and ``batches``, per leaf the card's
    distance from the CPU step and the CPU's own noise (``f32_noise_ratios``):
    the largest ratio over the leaves over STEP_GRAD_RTOL (what the gate
    holds), NOISY_LEAF's, the median and largest over all leaves; and the
    same with a fault planted on the card at the first seed and batch, K2b's
    dq scaled by 1 + 1e-5 and by 1 + 1e-3."""
    def reading(ratios):
        over = [r for e, _, r in ratios.values() if e > STEP_GRAD_RTOL]
        err, noise, ratio = ratios[NOISY_LEAF]
        values = sorted(r for _, _, r in ratios.values())
        return {"gated_largest_ratio": max(over, default=0.0),
                "leaves_over_rtol": len(over),
                "noisy_leaf": {"card_vs_cpu": err, "cpu_noise": noise,
                               "ratio": ratio},
                "median_ratio": statistics.median(values),
                "largest_ratio": values[-1],
                "largest_card_vs_cpu": max(e for e, _, _ in ratios.values())}

    rows = []
    moved = one_ulp_off(torch, params)
    for seed in seeds:
        for i, batch in enumerate(batches):
            _, cpu = _step_on(torch, "cpu", params, cfg, batch, seed=seed)
            _, ulp = _step_on(torch, "cpu", moved, cfg, batch, seed=seed)
            _, card = _step_on(torch, device, params, cfg, batch, seed=seed)
            rows.append({"seed": seed, "batch": i, **reading(
                f32_noise_ratios(torch, card, cpu, ulp))})
            print(f"NOISY_LEAF row {json.dumps(rows[-1])}")
            for factor in ((1e-5, 1e-3) if (seed, i) == (seeds[0], 0)
                           else ()):
                with dq_scaled(1 + factor):
                    _, card = _step_on(torch, device, params, cfg, batch,
                                       seed=seed)
                rows.append({"seed": seed, "batch": i,
                             "fault": f"dq scaled by 1 + {factor}", **reading(
                                 f32_noise_ratios(torch, card, cpu, ulp))})
                print(f"NOISY_LEAF row {json.dumps(rows[-1])}")
    return rows


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
    initialize(corpus, dirs["train"] / "feats.scp", vocab, model, model_args)
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
    rows_of_first = type(first)(*(x[:rows] for x in first))
    cfg = ckpt["cfg"]
    if "bfloat16" in (cfg.conformer_stream_dtype, cfg.compute_dtype):
        check = bf16_card_vs_cpu_step(torch, device, ckpt["params"],
                                      ckpt["cfg"], rows_of_first)
    else:
        check = card_vs_cpu_step(torch, device, ckpt["params"], ckpt["cfg"],
                                 rows_of_first)
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
    if profile is not None:
        check_profile_kernels(profile, cfg)
    batch_frames = int(first.src_mask.sum())
    return {
        "corpus": corpus["name"], "utterances": utts, "frames": frames,
        "train_steps": records[-1]["step"], "train_cli_s": train_s,
        "metrics": records, "checkpoints": names, "launches": launches,
        "dropout_sites": dropout_sites(ckpt["cfg"]),
        "compute_dtype": ckpt["cfg"].compute_dtype,
        "en_layers": ckpt["cfg"].en_layers, "step_ms": step_ms,
        "step_frames": batch_frames,
        "step_padded_frames": int(first.src_mask.size),
        "frames_per_s": batch_frames / step_ms * 1e3,
        "peak_memory_gb": peak_gb, "card_vs_cpu_rows": rows,
        "card_vs_cpu_step": check, "step_profile": profile,
    }


# bench.py's headline configuration (_flagship_setup, BATCH, SRC_LEN,
# TGT_LEN, SRC_DIM, VOCAB): the TIMIT-width tdnn model (TransformerConfig's
# defaults) with compute_dtype=bfloat16, batch 100 x 500 frames, 48 tokens,
# 40-dim features, 52 words; the card-vs-CPU check on ``cpu_rows`` of them
BENCH = {"name": "bench_tdnn_bf16", "batch": 100, "frames": 500,
         "tokens": 48, "feat_dim": 40, "vocab": 52, "cpu_rows": 10}


def bench_setup(torch, seed=0, n_utts=None, n_frames=None, **model):
    """(cfg, params, batch) of bench.py's headline train step, drawn as
    bench.py draws them (numpy's generator from ``seed``: a random LDA
    matrix, features, tokens); the weights from the port's init (another
    generator than JAX's, the same distributions).  ``n_utts``,
    ``n_frames`` and ``model`` (config fields) rehearse it off the card at
    a small size."""
    import numpy as np

    from pytorch_kaldi_asr_tpu_torch.data.loader import Batch
    from pytorch_kaldi_asr_tpu_torch.models.transformer import (
        TransformerConfig,
        init_transformer,
    )

    cfg = TransformerConfig(src_dim=BENCH["feat_dim"],
                            vocab_size=BENCH["vocab"],
                            compute_dtype="bfloat16", **model)
    rng = np.random.default_rng(seed)
    lda_in = BENCH["feat_dim"] * len(cfg.lda_context)
    lda_mat = (rng.normal(size=(lda_in, lda_in + 1)) * 0.05).astype(
        np.float32)
    params = init_transformer(torch.Generator().manual_seed(seed), cfg,
                              lda_mat)
    b = n_utts or BENCH["batch"]
    s, n = n_frames or BENCH["frames"], BENCH["tokens"]
    src = rng.normal(size=(b, s, BENCH["feat_dim"])).astype(np.float32)
    tgt = rng.integers(4, BENCH["vocab"], size=(b, n)).astype(np.int32)
    tgt[:, 0], tgt[:, -1] = 2, 3
    batch = Batch(keys=tuple(f"utt{i:03d}" for i in range(b)), src=src,
                  src_mask=np.ones((b, s), np.uint8), tgt=tgt,
                  tgt_mask=np.ones((b, n), np.uint8),
                  valid=np.ones(b, np.uint8))
    return cfg, params, batch


def run_bench_step(torch, device="cuda", **size):
    """bench.py's headline train step on the card: the features sent as
    bfloat16 (as the train loop sends them in bfloat16 compute), every
    launch count at 0 just before 10 timed steps (after 3 warm-up) and
    read just after; the step's profile; then card against CPU on
    ``cpu_rows`` utterances (``bf16_card_vs_cpu_step``).  Returns the
    numbers."""
    from pytorch_kaldi_asr_tpu_torch.data.loader import to_device
    from pytorch_kaldi_asr_tpu_torch.models.transformer import tree_map
    from pytorch_kaldi_asr_tpu_torch.train import create_train_state, train_step

    cfg, params, batch = bench_setup(torch, **size)
    state = create_train_state(tree_map(
        lambda t: t.detach().to(device, copy=True), params))
    b = to_device(batch, device, torch.bfloat16)

    def step():
        train_step(state, cfg, b.src, b.src_mask, b.tgt, b.tgt_mask)

    sync = _sync(torch, device)
    for _ in range(3):
        step()
    reset_launch_counts()
    [step_ms] = time_steps(step, sync, n_steps=10, repeats=1)
    launches = launch_counts()
    steps = 13  # time_steps' own 3 warm-up calls and its 10
    sites = dropout_sites(cfg)
    for dtype, sfx in (("float32", ""), ("bfloat16", "_bf16")):
        for way in ("forward", "backward"):
            n = launches[f"fused_dropout_{way}{sfx}"]
            if device == "cuda" and n != sites[dtype] * steps:
                raise AssertionError(f"bench step: K3 {way} {dtype} launched "
                                     f"{n} times, expected {sites[dtype]} x "
                                     f"{steps}")
    profile = profile_steps(torch, step) if device == "cuda" else None
    if profile is not None:
        check_profile_kernels(profile, cfg)
    rows = BENCH["cpu_rows"]
    check = bf16_card_vs_cpu_step(torch, device, params, cfg,
                                  type(batch)(*(x[:rows] for x in batch)))
    frames = int(batch.src_mask.sum())
    out = {"corpus": BENCH["name"], "launches": launches,
           "dropout_sites": sites, "step_ms": step_ms,
           "frames_per_s": frames / step_ms * 1e3, "card_vs_cpu_rows": rows,
           "card_vs_cpu_step": check, "step_profile": profile}
    print(f"{BENCH['name']} train step ({frames} frames): {step_ms:.3f} ms, "
          f"{out['frames_per_s']:.0f} frames/s" + (
              f", {profile['device_ms_per_step']:.2f} ms of device time, "
              f"idle share {profile['idle_share']:.3f}, "
              f"{profile['kernels_per_step']:.0f} kernels per step"
              if profile else ""))
    return out


def check_profile_kernels(profile, cfg):
    """A profiled train step of ``cfg`` ran the attention kernels of its
    compute dtype, and none of the other: on bfloat16 compute the bfloat16
    K2a-c and no float32 fwd_kernel, dq_kernel or dkv_kernel (the tdnn
    encoder has no attention kernel)."""
    ours = profile["port_kernels_ms_and_launches_per_step"]
    bf16 = cfg.compute_dtype == "bfloat16"
    want = ("_bf16", "") if bf16 else ("", "_bf16")
    for kernel in ("K2a", "K2b", "K2c"):
        ran, other = (ours[kernel + sfx][1] for sfx in want)
        if other or (cfg.encoder_type != "tdnn" and not ran):
            raise AssertionError(f"the {cfg.compute_dtype} step launched "
                                 f"{kernel}{want[0]} {ran} and "
                                 f"{kernel}{want[1]} {other} times a step")


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


def noisy_leaf_only(torch):
    """``--noisy-leaf``: the TIMIT model from seed 0 at the recipe's widths
    and the first two batches of run_train's train set (batch 100), and
    what the float32 step gate reads at 3 seeds x 2 batches and with a
    fault planted (``f32_gate_readings``; about 5 minutes on the chip
    machine's CPU)."""
    from pytorch_kaldi_asr_tpu_torch.data import read_vocab
    from pytorch_kaldi_asr_tpu_torch.data.loader import make_batch_loader
    from pytorch_kaldi_asr_tpu_torch.io import kaldi_io
    from pytorch_kaldi_asr_tpu_torch.recipes import initialize_model
    from pytorch_kaldi_asr_tpu_torch.train import load_checkpoint

    spec = TIMIT["train"]
    work = WORK / "noisy_leaf"
    if work.exists():
        shutil.rmtree(work)
    data = work / "train"
    write_data_dir(data, kaldi_io, torch, TIMIT, spec["utts"]["train"],
                   seed=1)
    initialize_model.main([
        "-read_feats_scp_file", str(data / "feats.scp"),
        "-lda_mat_file", "identity", "-read_vocab_file",
        str(data / "vocab.txt"), "-seed", str(SEED), "-save_model_file",
        str(work / "model.init"), *TIMIT["model"]])
    ckpt = load_checkpoint(str(work / "model.init"))
    batches = iter(make_batch_loader(str(data),
                                     read_vocab(str(data / "vocab.txt")),
                                     spec["batch"], mode="drop"))
    return f32_gate_readings(torch, "cuda", ckpt["params"], ckpt["cfg"],
                             [next(batches), next(batches)])


BF16_FAULTS = ("dropout_scale_unrounded", "swish_rounded_once",
               "layer_norm_two_pass", "float32_stream")
# bfloat16 compute's: the attention kernels fed float32 (their
# probabilities and dS kept in float32 through the second products), the
# logit divisor unrounded (sqrt(128) = 11.3137 for 11.3125), the decoder's
# feed-forward layers left in float32, the whole model in float32 compute
# (the caller runs it so), and two gross ones: the encoder attention's
# output (K1, K2a) scaled by 1 + 2**-4, the decoder's feed-forward output
# by 1 + 2**-6
BF16_COMPUTE_FAULTS = ("attention_float32", "divisor_unrounded",
                       "decoder_ffn_float32", "float32_compute",
                       "attention_scaled", "decoder_ffn_scaled")


@contextlib.contextmanager
def planted_fault(torch, name):
    """One fault of bfloat16 planted in the port's modules in memory, for
    ``--bf16-gates`` and ``--bf16-compute-gates``, and taken out again on
    exit.  The stream's (BF16_FAULTS): dropout on bfloat16 scaled by the
    exact 256/q instead of the reference's bfloat16 rounding of it; the
    conv module's swish as ``F.silu`` on bfloat16 (one rounding, not the
    reference's three); layer norm on bfloat16 with the float32 path's
    two-pass moments instead of the reference's one-pass ones.  bfloat16
    compute's (BF16_COMPUTE_FAULTS): the encoder's attention on float32
    q, k, v (the float32 kernels: no rounding of p, dS or the dropped p);
    the logit divisor sqrt(d_model) unrounded; the decoder's feed-forward
    layers in float32; the encoder attention's output 6 % too large; the
    decoder's feed-forward output 1.6 % too large.
    ``None``, ``float32_stream`` and ``float32_compute`` plant nothing here
    (for the latter two the caller runs the model in float32)."""
    import numpy as np
    import torch.nn.functional as F

    from pytorch_kaldi_asr_tpu_torch.models import common, encoders, transformer
    from pytorch_kaldi_asr_tpu_torch.ops.fused_dropout import masked_dropout

    def dropout_scale_unrounded(x, rate, seed, train):
        if x.dtype != torch.bfloat16:
            return common.dropout(x, rate, seed, train)
        q = round((1.0 - rate) * 256)
        return masked_dropout(x, seed, (256 - q) << 24, 256.0 / q)

    def layer_norm_two_pass(z, gamma, beta, **kw):
        return common.layer_norm(z.float(), gamma, beta, **kw).to(z.dtype)

    def in_float32(fn):
        def run(q, k, v, *args, **kw):
            return fn(q.float(), k.float(), v.float(), *args, **kw).to(q.dtype)
        return run

    sound_ffn = transformer.feed_forward

    def ffn_float32(p, x, cfg, *args, **kw):
        return sound_ffn(p, x, cfg.replace(compute_dtype="float32"), *args,
                         **kw)

    patches = {
        "dropout_scale_unrounded": [(transformer, "dropout",
                                     dropout_scale_unrounded)],
        "swish_rounded_once": [(encoders, "_swish",
                                lambda h: F.silu(h).float())],
        "layer_norm_two_pass": [(encoders, "layer_norm",
                                 layer_norm_two_pass)],
        "attention_float32": [
            (encoders, "banded_attention_trainable",
             in_float32(encoders.banded_attention_trainable)),
            (encoders, "banded_attention",
             in_float32(encoders.banded_attention))],
        "divisor_unrounded": [(transformer, "logit_divisor",
                               lambda d, dtype: float(np.sqrt(d)))],
        "decoder_ffn_float32": [(transformer, "feed_forward", ffn_float32)],
        "attention_scaled": [
            (encoders, name, lambda *a, _fn=getattr(encoders, name), **kw:
             _fn(*a, **kw) * (1 + 2.0 ** -4))
            for name in ("banded_attention", "banded_attention_trainable")],
        "decoder_ffn_scaled": [(transformer, "feed_forward",
                                lambda *a, **kw: sound_ffn(*a, **kw)
                                * (1 + 2.0 ** -6))],
    }.get(name, [])
    sound = [getattr(module, attr) for module, attr, _ in patches]
    for module, attr, fault in patches:
        setattr(module, attr, fault)
    try:
        yield
    finally:
        for (module, attr, _), fn in zip(patches, sound):
            setattr(module, attr, fn)


def bf16_gate_readings(torch, device="cuda", model_args=None):
    """``--bf16-gates``: what the bfloat16 stream's card-vs-CPU gates read
    on the conformer recipe's model as it ships, sound and with each of
    BF16_FAULTS planted on the card.  Decode: 16 LibriSpeech-shaped
    utterances with the recipe's stage-5 flags, the card's n-best against
    the CPU's bfloat16 one (``nbest_distance``), for the models of seeds 0
    and 1 (sound) and seed 0 (each fault).  Train step: 4 utterances at the
    recipe's dropout from model.init (``bf16_step_ratios``), sound at two
    batches and two dropout seeds, each fault at the first, and there the
    CPU's own step with every weight one float32 ulp off.  About 10
    minutes on the chip machine, most of it the CPU's steps.  ``device``
    and ``model_args`` (the corpus's flags by default) rehearse it off the
    card at a small width."""
    from pytorch_kaldi_asr_tpu_torch.data import read_vocab
    from pytorch_kaldi_asr_tpu_torch.data.loader import make_batch_loader
    from pytorch_kaldi_asr_tpu_torch.io import kaldi_io
    from pytorch_kaldi_asr_tpu_torch.recipes import decode, initialize_model
    from pytorch_kaldi_asr_tpu_torch.train import load_checkpoint

    corpus, spec = LIBRISPEECH_BF16, LIBRISPEECH_BF16["decode"]
    work = WORK / "bf16_gates"
    if work.exists():
        shutil.rmtree(work)
    data = work / "data"
    write_data_dir(data, kaldi_io, torch, corpus, spec["utts"])

    def init(seed, stream="bfloat16"):
        model = work / f"model_{seed}_{stream}"
        initialize_model.main([
            "-read_feats_scp_file", str(data / "feats.scp"), "-lda_mat_file",
            "identity", "-read_vocab_file", str(data / "vocab.txt"), "-seed",
            str(seed), "-save_model_file", str(model),
            *[x if x != "bfloat16" else stream
              for x in model_args or corpus["model"]]])
        return model

    def nbest(model, device, fault=None):
        out = work / f"decode_{model.name}_{device}_{fault}.txt"
        with planted_fault(torch, fault):
            decode.main([
                "-read_data_dir", str(data), "-read_vocab_file",
                str(data / "vocab.txt"), "-load_model_file", str(model),
                "-save_result_file", str(out), "-device", device,
                "-batch_size", str(spec["batch"]), "-num_buckets",
                str(spec["buckets"]), "-beam_size", str(spec["beam"]),
                "-nbest", str(spec["nbest"]), "-max_token_seq_len",
                str(spec["max_tokens"])])
        return read_nbest(out)

    def distance(gpu, cpu):
        score, gap = nbest_distance(gpu, cpu)
        return {"max_score_diff": score, "largest_gap_words_differ": gap}

    readings = {"decode": {}, "step": {}}
    for seed in (0, 1):
        model, model32 = init(seed), init(seed, "float32")
        cpu = nbest(model, "cpu")
        readings["decode"][f"own_seed{seed}"] = distance(
            nbest(model32, "cpu"), cpu)
        readings["decode"][f"sound_seed{seed}"] = distance(
            nbest(model, device), cpu)
        if seed == 0:
            for fault in BF16_FAULTS:
                readings["decode"][fault] = distance(
                    nbest(model32 if fault == "float32_stream" else model,
                          device, fault), cpu)
    print("BF16_GATES decode " + json.dumps(readings["decode"]))

    ckpt = load_checkpoint(str(work / "model_0_bfloat16"))
    params, cfg = ckpt["params"], ckpt["cfg"]
    cfg32 = cfg.replace(conformer_stream_dtype="float32")
    loader = iter(make_batch_loader(str(data),
                                    read_vocab(str(data / "vocab.txt")),
                                    corpus["train"]["cpu_rows"], mode="drop"))
    batches = [next(loader), next(loader)]

    def summary(r, dev, cpu16, cpu32):
        return {"losses": [dev[0], cpu16[0], cpu32[0]],
                **{k: v for k, v in r.items() if k not in ("largest", "mean")}}

    for i, seed in ((0, 0), (0, 1), (1, 0)):
        batch = batches[i]
        cpu16 = _step_on(torch, "cpu", params, cfg, batch, seed=seed)
        cpu32 = _step_on(torch, "cpu", params, cfg32, batch, seed=seed)
        dev = _step_on(torch, device, params, cfg, batch, seed=seed)
        readings["step"][f"sound_batch{i}_seed{seed}"] = summary(
            bf16_step_ratios(torch, dev, cpu16, cpu32), dev, cpu16, cpu32)
        if (i, seed) == (0, 0):
            for fault in BF16_FAULTS:
                with planted_fault(torch, fault):
                    dev = _step_on(torch, device, params,
                                   cfg32 if fault == "float32_stream" else cfg,
                                   batch, seed=seed)
                readings["step"][fault] = summary(
                    bf16_step_ratios(torch, dev, cpu16, cpu32), dev, cpu16,
                    cpu32)
            # the noise: the CPU's own step, every weight one float32 ulp
            # off (random signs)
            dev = _step_on(torch, "cpu", one_ulp_off(torch, params), cfg,
                           batch, seed=seed)
            readings["step"]["cpu_one_ulp"] = summary(
                bf16_step_ratios(torch, dev, cpu16, cpu32), dev, cpu16,
                cpu32)
        print(f"BF16_GATES step batch {i} seed {seed} done")
    return readings


def bf16_compute_gate_readings(torch, device="cuda"):
    """``--bf16-compute-gates``: what bfloat16 compute's card-vs-CPU gates
    read, sound and with each of BF16_COMPUTE_FAULTS planted on the card.
    Train step (``bf16_step_ratios`` against the CPU's bfloat16-compute and
    float32-compute steps, dropout on), each model at two batches x two
    dropout seeds: bench.py's headline tdnn (batches of BENCH["cpu_rows"]
    utterances), the banded TIMIT model (TIMIT_BF16, seed 0; batches of
    10) and the conformer as shipped (LIBRISPEECH_BF16_COMPUTE, seed 0;
    batches of 4); each fault that reaches the model at the first draw,
    and there the CPU's own step with every weight one float32 ulp off.
    Decode: the first decode batch (``bf16_compute_decode_check``) of the
    banded TIMIT model and of the conformer, for the models of seeds 0 and
    1, and at seed 0 the faults.  About 10 minutes on the chip machine,
    most of it the CPU's steps."""
    from pytorch_kaldi_asr_tpu_torch.data import read_vocab
    from pytorch_kaldi_asr_tpu_torch.data.loader import make_batch_loader
    from pytorch_kaldi_asr_tpu_torch.io import kaldi_io
    from pytorch_kaldi_asr_tpu_torch.train import load_checkpoint

    work = WORK / "bf16_compute_gates"
    if work.exists():
        shutil.rmtree(work)
    readings = {"step": {}, "decode": {}}

    def steps(name, params, cfg, draws, faults):
        for i, (batch, seed) in enumerate(draws):
            cpu16 = _step_on(torch, "cpu", params, cfg, batch, seed=seed)
            cpu32 = _step_on(torch, "cpu", params, own_error_config(cfg),
                             batch, seed=seed)
            runs = {f"sound_draw{i}": (None, params)}
            if i == 0:
                runs.update({f: (f, params) for f in faults})
                runs["cpu_one_ulp"] = ("cpu", one_ulp_off(torch, params))
            for key, (fault, p) in runs.items():
                run_cfg = (cfg.replace(compute_dtype="float32")
                           if fault == "float32_compute" else cfg)
                with planted_fault(torch, None if fault == "cpu" else fault):
                    dev = _step_on(torch, "cpu" if fault == "cpu" else device,
                                   p, run_cfg, batch, seed=seed)
                r = bf16_step_ratios(torch, dev, cpu16, cpu32)
                readings["step"][f"{name}_{key}"] = {
                    "losses": [dev[0], cpu16[0], cpu32[0]],
                    **{k: v for k, v in r.items()
                       if k not in ("largest", "mean")}}
            print(f"BF16_COMPUTE_GATES step {name} draw {i} done")

    cfg, params, batch = bench_setup(torch)
    rows = BENCH["cpu_rows"]
    subsets = [type(batch)(*(x[i * rows:(i + 1) * rows] for x in batch))
               for i in (0, 1)]
    steps("bench", params, cfg, [(subsets[0], 0), (subsets[0], 1),
                                 (subsets[1], 0), (subsets[1], 1)],
          ("divisor_unrounded", "decoder_ffn_float32", "float32_compute",
           "decoder_ffn_scaled"))

    def corpus_model(corpus, n_utts, seed=0):
        data = work / corpus["name"] / "data"
        if not data.exists():
            write_data_dir(data, kaldi_io, torch, corpus, n_utts)
        model = work / corpus["name"] / f"model_{seed}"
        initialize(corpus, data / "feats.scp", data / "vocab.txt", model,
                   seed=seed)
        return data, model

    faults = ("attention_float32", "float32_compute", "attention_scaled",
              "decoder_ffn_scaled")
    for corpus, n_utts in ((TIMIT_BF16, 20), (LIBRISPEECH_BF16_COMPUTE, 8)):
        data, model = corpus_model(corpus, n_utts)
        ckpt = load_checkpoint(str(model))
        loader = iter(make_batch_loader(
            str(data), read_vocab(str(data / "vocab.txt")), n_utts // 2,
            mode="drop"))
        batches = [next(loader), next(loader)]
        steps(corpus["name"], ckpt["params"], ckpt["cfg"],
              [(batches[0], 0), (batches[0], 1), (batches[1], 0),
               (batches[1], 1)],
              faults + (("divisor_unrounded",) if corpus is TIMIT_BF16
                        else ()))

    for corpus in (TIMIT_BF16, LIBRISPEECH_BF16_COMPUTE):
        spec = corpus["decode"]
        data = work / "decode" / corpus["name"] / "data"
        write_data_dir(data, kaldi_io, torch, corpus, spec["utts"])
        for seed in (0, 1):
            model = work / "decode" / corpus["name"] / f"model_{seed}"
            initialize(corpus, data / "feats.scp", data / "vocab.txt", model,
                       seed=seed)
            for fault in (None, *(faults[:3] if seed == 0 else ())):
                readings["decode"][
                    f"{corpus['name']}_{fault or 'sound'}_seed{seed}"] = \
                    bf16_compute_decode_check(torch, model, data, spec,
                                              device, fault)
    print("BF16_COMPUTE_GATES decode " + json.dumps(readings["decode"]))
    return readings


def check_train_launches(training):
    """K2a-c at exactly en_layers x steps on the compute dtype (none on the
    other), K3 at exactly (dropout sites) x steps each way for each dtype,
    and K1 on the compute dtype in the evaluations."""
    launches, steps = training["launches"], training["train_steps"]
    sites = training["dropout_sites"]
    ours, other = (("_bf16", "") if training["compute_dtype"] == "bfloat16"
                   else ("", "_bf16"))
    want = {}
    for k in ("fwd", "dq", "dkv"):
        want[f"banded_attention_{k}{ours}"] = training["en_layers"] * steps
        want[f"banded_attention_{k}{other}"] = 0
    for way in ("forward", "backward"):
        want[f"fused_dropout_{way}"] = sites["float32"] * steps
        want[f"fused_dropout_{way}_bf16"] = sites["bfloat16"] * steps
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"{training['corpus']}: {name} launched "
                                 f"{launches[name]} times in training, "
                                 f"expected {n}")
    if launches[f"banded_attention{ours}"] == 0 \
            or launches[f"banded_attention{other}"]:
        raise AssertionError(f"banded_attention{ours} (K1) not launched by "
                             f"the training path's evaluations, or K1 on the "
                             f"other dtype: {launches}")
    print(f"{training['corpus']}: {training['dropout_sites']} dropout sites "
          f"per train step; launches over {steps} steps: {launches}")


def kernel_phase(torch):
    """Every kernel against its plain version on the card (K1, K2a-c on
    float32 and bfloat16, K3 on both), the launch checks, the bfloat16 mma
    probe, and the timings.  Returns the errors and timings by name."""
    from pytorch_kaldi_asr_tpu_torch.ops import banded_attention as ba
    from pytorch_kaldi_asr_tpu_torch.ops import fused_dropout as fd

    bf16 = torch.bfloat16
    kp = {"probe": mma_bf16_probe(torch)}
    kp["err"] = check_banded_attention(torch, ba)
    kp["train_errs"] = check_trainable_attention(torch, ba)
    kp["err_bf16"] = check_banded_attention_bf16(torch, ba)
    kp["train_errs_bf16"] = check_trainable_attention_bf16(torch, ba)
    for dtype in (None, bf16):
        check_forward_launches(torch, ba, dtype)
        check_backward_launches(torch, ba, dtype)
    kp["k3_err"] = check_fused_dropout(torch, fd)
    kp["k3_bf16_err"] = check_fused_dropout(torch, fd, bf16)
    for key, dtype in (("", None), ("_bf16", bf16)):
        kp[f"timing{key}"] = {
            shape: time_banded_attention(torch, ba, shape, dtype)
            for shape in ("timit_decode", "conformer_decode")}
        kp[f"train_timing{key}"] = {
            shape: time_trainable_attention(torch, ba, shape, dtype)
            for shape in TRAIN_TIMING_SHAPES}
    kp["k3_timing"] = time_fused_dropout(torch, fd)
    kp["k3_bf16_timing"] = {
        str(list(shape)): time_fused_dropout(torch, fd, shape, dtype=bf16)
        for shape in reversed(K3_SHAPES)}
    torch.cuda.empty_cache()
    return kp


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a card",
              file=sys.stderr)
        return 2
    step_only = sys.argv[1:2] == ["--train-step"]
    noisy_leaf = sys.argv[1:2] == ["--noisy-leaf"]
    bf16_gates = sys.argv[1:2] == ["--bf16-gates"]
    bf16_compute_gates = sys.argv[1:2] == ["--bf16-compute-gates"]
    sources = ([Path(p).resolve() for p in sys.argv[2:]]
               if sys.argv[1:2] == ["--k2-sources"] else None)
    if sources == []:
        print("chip_smoke: --k2-sources takes one or more .cu files",
              file=sys.stderr)
        return 2
    tree = Path(sys.argv[2]).resolve() if step_only else REPO
    name = sys.argv[3] if step_only and len(sys.argv) > 3 else "timit"
    corpus = next((c for c in (TIMIT, LIBRISPEECH, LIBRISPEECH_BF16)
                   if c["name"] == name), None)
    if corpus is None:
        print(f"chip_smoke: --train-step takes timit, librispeech or "
              f"librispeech_bf16, got {name}", file=sys.stderr)
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
        summary = ptxas_summary(log)
        for line in summary or [x.strip() for x in log.splitlines()
                                if "ptxas" in x or "spill" in x]:
            print(f"  {name}: {line}")
    if sources:
        from pytorch_kaldi_asr_tpu_torch.ops import banded_attention as ba

        compared = compare_k2_sources(torch, ba, finish_k2_builds(procs))
        for shape, row in compared.items():
            print("K2_SOURCES " + json.dumps(
                {"card": card, "shape": shape, "builds": row}))
        return 0
    if noisy_leaf:
        print("NOISY_LEAF " + json.dumps(
            {"card": card, "leaf": ".".join(map(str, NOISY_LEAF)),
             "readings": noisy_leaf_only(torch)}))
        return 0
    if bf16_gates:
        print("BF16_GATES " + json.dumps({"card": card,
                                          **bf16_gate_readings(torch)}))
        return 0
    if bf16_compute_gates:
        print("BF16_COMPUTE_GATES " + json.dumps(
            {"card": card, **bf16_compute_gate_readings(torch)}))
        return 0
    if step_only:
        print("TRAIN_STEP " + json.dumps(
            {"tree": str(tree), "card": card, "corpus": corpus["name"],
             **train_step_only(torch, corpus)}))
        return 0

    kp = kernel_phase(torch)
    print(f"kernel phase done at {time.perf_counter() - t_start:.1f} s")

    decodes, trainings = {}, {}

    def decode_path(corpus):
        name = corpus["name"]
        summary = run_slice(torch, corpus)
        en_layers = int(corpus["model"][corpus["model"].index("-en_layers")
                                        + 1])
        expected = en_layers * summary["batches"]
        ours, other = (("_bf16", "") if corpus.get("compute_dtype")
                       == "bfloat16" else ("", "_bf16"))
        launched = summary["launches"]
        if launched[f"banded_attention{ours}"] != expected \
                or launched[f"banded_attention{other}"]:
            raise AssertionError(
                f"{name}: banded_attention{ours} launched "
                f"{launched[f'banded_attention{ours}']} times in the decode, "
                f"expected {expected}; banded_attention{other} "
                f"{launched[f'banded_attention{other}']}")
        summary["card"] = card
        print(f"{name} decode: " + json.dumps(summary))
        print(f"{name} decode time split (s): "
              + json.dumps(summary["time_split_s"]))
        decodes[name] = summary
        return summary

    def train_path(corpus):
        name = corpus["name"]
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

    timit = decode_path(TIMIT)
    searches = check_fixed_buffer_search(torch, TIMIT, timit)
    decode_path(TIMIT_NONCAUSAL)  # the fixed-buffer search through the CLI
    train_path(TIMIT)
    for corpus in (LIBRISPEECH, LIBRISPEECH_BF16):
        decode_path(corpus)
        train_path(corpus)
    # bfloat16 compute: bench.py's headline step, then the two recipes
    bench = run_bench_step(torch)
    bench["card"] = card
    print(f"{BENCH['name']}: " + json.dumps(bench))
    trainings[BENCH["name"]] = bench
    print(f"{BENCH['name']} done at {time.perf_counter() - t_start:.1f} s")
    for corpus in (TIMIT_BF16, LIBRISPEECH_BF16_COMPUTE):
        decode_path(corpus)
        train_path(corpus)
    for name in ("librispeech", "librispeech_bf16",
                 "librispeech_bf16_compute"):
        profile = trainings[name]["step_profile"]
        print(f"conformer train step, {name}: "
              f"{trainings[name]['step_ms']:.3f} ms, "
              f"{trainings[name]['frames_per_s']:.0f} real frames/s, "
              f"{profile['device_ms_per_step']:.2f} ms of device time, idle "
              f"share {profile['idle_share']:.3f}; top kernels "
              + json.dumps(profile["top_kernels_ms_per_step"][:5]))

    def total(name, paths):
        return sum(p["launches"][name] for p in paths)

    paths = [*decodes.values(), *trainings.values()]
    jax_file = "pytorch_kaldi_asr_tpu/ops/banded_attention.py"
    source = "pytorch_kaldi_asr_tpu_torch/ops/csrc/banded_attention_train.cu"
    kernels = []
    for sfx in ("", "_bf16"):
        err = kp[f"err{sfx}"]
        kernels.append(dict(
            name=f"banded_attention{sfx}", route="cuda", source=source,
            replaces=f"{jax_file}:140",
            launches=total(f"banded_attention{sfx}", paths),
            max_abs_err=err[0] if sfx else err,
            **kp[f"timing{sfx}"]["conformer_decode"]))
        for name, line in (("fwd", 431), ("dq", 477), ("dkv", 505)):
            err = kp[f"train_errs{sfx}"][name]
            kernels.append(dict(
                name=f"banded_attention_{name}{sfx}", route="cuda",
                source=source, replaces=f"{jax_file}:{line}",
                launches=total(f"banded_attention_{name}{sfx}", paths),
                max_abs_err=err[0] if sfx else err,
                **kp[f"train_timing{sfx}"]["conformer_train"][name]))
    row_keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for name, suffix, err_k3, timed in (
            ("fused_dropout", "", kp["k3_err"], kp["k3_timing"]),
            ("fused_dropout_bf16", "_bf16", kp["k3_bf16_err"],
             kp["k3_bf16_timing"][str(list(K3_SHAPES[1]))])):
        kernels.append(dict(
            name=name, route="cuda",
            source="pytorch_kaldi_asr_tpu_torch/ops/csrc/fused_dropout.cu",
            replaces="pytorch_kaldi_asr_tpu/ops/fused_dropout.py:34",
            launches=total(f"fused_dropout_forward{suffix}", paths)
            + total(f"fused_dropout_backward{suffix}", paths),
            max_abs_err=err_k3, **{k: timed[k] for k in row_keys}))
    print("fixed-buffer search on the card: " + json.dumps(searches))
    print(f"whole run {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
