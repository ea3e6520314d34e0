#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pytorch_kaldi_asr_tpu_torch) on one
CUDA card: ``python3 chip_smoke.py`` from the root of a checkout.

1. Requires a CUDA card; prints its name and power limit (nvidia-smi) and
   turns TF32 off for matmuls and cuDNN (the port is float32).
2. Builds every CUDA kernel of the port from ``ops/csrc`` (one nvcc per
   source, all started together) and prints what ptxas reports.
3. Kernel phase: holds each kernel against its plain PyTorch version on the
   card at the slices' shapes and at edge cases (band shapes, padded tails,
   fully masked rows exactly 0, dv != d, S not a multiple of the tile), then
   times the kernel, the plain version and the PyTorch library call that
   computes the same function, with CUDA events after warm-up.  K1 is the
   inference kernel; K2a/K2b/K2c (forward with lse, dq, dk/dv) are held
   against autograd of the plain trainable version at dropout 0 and 0.35.
4. Decode slice (stage 5): writes a seeded TIMIT-shaped data dir (16
   utterances of 40-dim features, 150-500 frames, a 52-entry phone
   vocabulary), runs the port's ``initialize_model`` at the recipe's widths
   with ``-encoder_type banded`` and its ``decode`` on the card with the
   recipe's stage-5 flags, checks the 16 x 10 n-best lines and that K1 was
   launched by the decode, decodes the first batch again on the CPU and
   compares, and prints the decode wall time and real-time factor.
5. Training slice (stages 3-4): seeded train/dev/test dirs of 300/40/40
   utterances, ``initialize_model`` at the recipe's widths (dropout 0.35),
   the port's ``train`` CLI with the recipe's stage-4 flags for 2 epochs
   and then its ``combine`` CLI, on the card.  Checks finite losses, the
   two ``metrics.jsonl`` records, the checkpoint names, and that K2a, K2b
   and K2c each ran exactly en_layers x train steps times.  Then one train
   step from model.init with dropout off, on the card and on the CPU: the
   loss and every gradient leaf must agree.  Prints the train step's time,
   frames per second and the K2 kernels' share of it.
6. Prints the ``kernels`` JSON line, the card line, and as the last line
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

# the training slice: stage-4 flags of the recipe, 2 epochs
TRAIN_UTTS = {"train": 300, "dev": 40, "test": 40}
TRAIN_BATCH, TRAIN_EPOCHS, DROPOUT = 100, 2, 0.35

KERNEL_ATOL = 2e-5  # float32, summation order differs from the plain version
GRAD_ATOL = 1e-4  # float32 gradients, summed over the band in another order
STEP_LOSS_RTOL = 1e-5  # one train step, card vs CPU
STEP_GRAD_RTOL = 1e-4  # of the largest |gradient| of each leaf
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


def _grads(fn, q, k, v, dout):
    """(out, dq, dk, dv) of ``fn`` by autograd."""
    q, k, v = (x.detach().clone().requires_grad_() for x in (q, k, v))
    out = fn(q, k, v)
    out.backward(dout)
    return out.detach(), q.grad, k.grad, v.grad


def check_trainable_attention(torch, ba):
    """K2a/K2b/K2c through the autograd function vs autograd of the plain
    trainable version on the card, at dropout 0 and 0.35.  Returns the max
    abs error per kernel: K2a out and lse, K2b dq, K2c dk and dv."""
    scale = 1.0 / math.sqrt(256.0)
    cases = [
        (200, 504, 64, 64, _slice_lengths(torch, 100, 2, 504, 2), -100, 0,
         scale, "slice shape"),
        (4, 256, 32, 32, [256] * 4, -10, 0, scale, "band (-10,0)"),
        (4, 256, 32, 32, [256] * 4, -64, 32, scale, "band (-64,32)"),
        (2, 256, 16, 16, [128, 128], -10, 0, 0.1, "padded tail"),
        (2, 256, 16, 8, [216, 216], -100, 0, 0.125, "dv != d"),
        (3, 200, 64, 64, [200, 120, 0], -100, 0, scale, "S=200, empty row"),
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
            # empty rows and invalid keys: exact zeros, gradients too
            lens = torch.as_tensor(lengths, device=q.device)
            pos = torch.arange(s, device=q.device)[None, :]
            empty = pos + start >= lens[:, None]
            invalid = pos >= lens[:, None]
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
    return worst


def _bound(n_bytes, flops):
    """(bound_ms, bound_by) on the H100's published peaks."""
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def time_trainable_attention(torch, ba):
    """K2a, K2b and K2c, their plain versions and the library call at the
    training slice's shape: batch 100 x 2 heads, S 504 padded to 512, d =
    dv = 64, band (-100, 0), the recipe's dropout 0.35.  Utterances of
    412-504 frames, so no query row is empty and SDPA's softmax is defined;
    SDPA (forward; backward for dq and dk/dv together) runs at dropout 0."""
    import torch.nn.functional as F

    bh, s, d = 200, 512, 64
    start, end, scale, seed = -100, 0, 1.0 / math.sqrt(256.0), 99
    g = torch.Generator().manual_seed(5)
    lengths = torch.randint(412, 505, (100,), generator=g).repeat_interleave(2)
    q, k, v, valid = _attention_inputs(torch, bh, s, d, d, lengths, seed=8)
    dout = torch.randn((bh, s, d), generator=g).cuda()
    kw = dict(start=start, end=end, scale=scale, dropout_rate=DROPOUT)
    out, lse = ba.banded_attention_fwd(q, k, v, valid, seed, **kw)
    delta = (dout * out).sum(-1)
    bwd_args = (q, k, v, valid, dout, lse, delta, seed)

    pos = torch.arange(s, device="cuda")
    rel = pos[None, :] - pos[:, None]
    allowed = ((rel >= start) & (rel <= end))[None] & (valid[:, None, :] > 0)
    pairs = int(allowed.sum())
    vec = 4 * bh * s * d  # bytes of one [BH, S, 64] float32 tensor
    row = 4 * bh * s  # bytes of one [BH, S] int32/float32 tensor
    bounds = {  # (bytes: inputs once, outputs once; flops per in-band pair)
        "fwd": _bound(4 * vec + 2 * row, pairs * 4 * d),
        "dq": _bound(5 * vec + 3 * row, pairs * 6 * d),
        "dkv": _bound(6 * vec + 3 * row, pairs * 8 * d),
    }
    kernel_ms = {
        "fwd": time_ms(torch, lambda: ba.banded_attention_fwd(
            q, k, v, valid, seed, **kw)),
        "dq": time_ms(torch, lambda: ba.banded_attention_dq(*bwd_args, **kw)),
        "dkv": time_ms(torch, lambda: ba.banded_attention_dkv(*bwd_args,
                                                              **kw)),
    }
    band = (start, end, scale, DROPOUT)
    with torch.no_grad():
        plain_ms = {
            "fwd": time_ms(torch, lambda: ba.banded_attention_trainable_reference(
                q, k, v, valid, seed, *band), iters=10, warmup=2),
            "dq": time_ms(torch, lambda: ba.banded_attention_dq_reference(
                *bwd_args, *band), iters=10, warmup=2),
            "dkv": time_ms(torch, lambda: ba.banded_attention_dkv_reference(
                *bwd_args, *band), iters=10, warmup=2),
        }
    sdpa_fwd_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=allowed, scale=scale))
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=allowed,
                                              scale=scale)
    sdpa_bwd_ms = time_ms(torch, lambda: torch.autograd.grad(
        sdpa_out, (qg, kg, vg), dout, retain_graph=True))
    library_ms = {"fwd": sdpa_fwd_ms, "dq": sdpa_bwd_ms, "dkv": sdpa_bwd_ms}

    # forward + backward as the model runs it: the autograd function (K2a,
    # delta, K2b, K2c) against autograd of the plain version
    def fwd_bwd(fn):
        qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
        return lambda: torch.autograd.grad(fn(qg, kg, vg), (qg, kg, vg), dout)

    path_ms = time_ms(torch, fwd_bwd(lambda q, k, v: ba.banded_attention_trainable(
        q, k, v, valid, seed, **kw)))
    plain_path_ms = time_ms(torch, fwd_bwd(
        lambda q, k, v: ba.banded_attention_trainable_reference(
            q, k, v, valid, seed, *band)[0]), iters=10, warmup=2)
    print(f"trainable attention timing: BH={bh} S={s} d={d} rate={DROPOUT} "
          f"in-band pairs={pairs} kernel_ms={kernel_ms} plain_ms={plain_ms} "
          f"sdpa_fwd_ms={sdpa_fwd_ms:.6f} sdpa_bwd_ms={sdpa_bwd_ms:.6f} "
          f"fwd+bwd: kernels_ms={path_ms:.6f} plain_ms={plain_path_ms:.6f} "
          f"sdpa_ms={sdpa_fwd_ms + sdpa_bwd_ms:.6f} bounds={bounds}")
    return {name: {"ms": kernel_ms[name], "plain_ms": plain_ms[name],
                   "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
                   "library_ms": library_ms[name]}
            for name in kernel_ms}


# ---------------------------------------------------------------------------
# slice phase
# ---------------------------------------------------------------------------


def write_data_dir(data_dir, kaldi_io, torch, n_utts=N_UTTS, seed=SEED):
    """Seeded TIMIT-shaped data: feats.ark/scp, text, vocab.txt.  Returns
    the number of frames."""
    data_dir.mkdir(parents=True)
    g = torch.Generator().manual_seed(seed)
    phones = [f"ph{i:02d}" for i in range(N_PHONES)]
    vocab = ["<blank>", "<unk>", "<s>", "</s>"] + phones
    with open(data_dir / "vocab.txt", "w") as f:
        for i, word in enumerate(vocab):
            f.write(f"{word} {i}\n")
    frames = 0
    with kaldi_io.ArkWriter(str(data_dir / "feats.ark"),
                            str(data_dir / "feats.scp")) as ark, \
            open(data_dir / "text", "w") as text:
        for u in range(n_utts):
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


def _step_on(torch, device, params, cfg, batch):
    """One train step from ``params`` on ``device``; returns (loss, grads in
    flattening order, on the CPU)."""
    from pytorch_kaldi_asr_tpu_torch.data.loader import to_device
    from pytorch_kaldi_asr_tpu_torch.models.transformer import tree_map
    from pytorch_kaldi_asr_tpu_torch.train import create_train_state, train_step
    from pytorch_kaldi_asr_tpu_torch.train.optim import trainable_leaves

    state = create_train_state(
        tree_map(lambda t: t.detach().to(device, copy=True), params))
    b = to_device(batch, device)
    metrics = train_step(state, cfg, b.src, b.src_mask, b.tgt, b.tgt_mask)
    return (float(metrics["loss"]),
            [p.grad.cpu() for p in trainable_leaves(state.params)])


def run_train(torch, ba, device="cuda", model_args=RECIPE_MODEL,
              utts=TRAIN_UTTS, batch=TRAIN_BATCH):
    """Stages 3-4 of the recipe with the port on ``device``: initialize,
    train (ending in combine), the standalone combine; then one train step
    with dropout off on the card and on the CPU.  Returns the run's numbers;
    the kernel launch counts are those of the train + combine CLIs."""
    from pytorch_kaldi_asr_tpu_torch.data import read_vocab
    from pytorch_kaldi_asr_tpu_torch.data.loader import make_batch_loader, to_device
    from pytorch_kaldi_asr_tpu_torch.io import kaldi_io
    from pytorch_kaldi_asr_tpu_torch.models.transformer import tree_map
    from pytorch_kaldi_asr_tpu_torch.recipes import (
        combine,
        initialize_model,
        train,
    )
    from pytorch_kaldi_asr_tpu_torch.train import (
        create_train_state,
        load_checkpoint,
        train_step,
    )

    work = WORK / "train"
    if work.exists():
        shutil.rmtree(work)
    dirs = {name: work / name for name in utts}
    frames = {name: write_data_dir(dirs[name], kaldi_io, torch, n, seed=i + 1)
              for i, (name, n) in enumerate(utts.items())}
    vocab = dirs["train"] / "vocab.txt"
    model = work / "model.init"
    initialize_model.main([
        "-read_feats_scp_file", str(dirs["train"] / "feats.scp"),
        "-lda_mat_file", "identity", "-read_vocab_file", str(vocab),
        "-seed", str(SEED), "-save_model_file", str(model), *model_args])
    exp = work / "exp"
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)

    # the main path: every launch count at 0 just before, read just after
    kernels = (ba.banded_attention, ba.banded_attention_fwd,
               ba.banded_attention_dq, ba.banded_attention_dkv)
    for fn in kernels:
        fn.launches = 0
    sync()
    t0 = time.perf_counter()
    rc = train.main([
        "-read_train_dir", str(dirs["train"]), "-read_dev_dir",
        str(dirs["dev"]), "-read_test_dir", str(dirs["test"]),
        "-read_vocab_file", str(vocab), "-load_model_file", str(model),
        "-save_model_dir", str(exp), "-batch_size", str(batch),
        "-epoch", str(TRAIN_EPOCHS), "-save_interval", "1",
        "-optim_start_lr", "0.001", "-optim_soft_coefficient", "25000",
        "-device", device])
    sync()
    train_s = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"train CLI returned {rc}")
    models = ",".join(str(exp / f"epoch.{e}")
                      for e in range(TRAIN_EPOCHS, 0, -1))
    combine.main(["-model_list", models, "-read_data_dir", str(dirs["test"]),
                  "-read_vocab_file", str(vocab), "-save_model_dir",
                  str(work / "combined"), "-batch_size", str(batch),
                  "-device", device])
    sync()
    launches = {fn.__name__: fn.launches for fn in kernels}

    records = [json.loads(x) for x in open(exp / "metrics.jsonl")]
    if len(records) != TRAIN_EPOCHS:
        raise AssertionError(f"metrics.jsonl has {len(records)} records")
    for r in records:
        if not all(math.isfinite(r[k]) for k in
                   ("train_loss", "train_accu", "dev_accu", "test_accu")):
            raise AssertionError(f"non-finite metrics {r}")
    names = sorted(p.name for p in exp.iterdir() if p.is_dir())
    want = {f"epoch.{e}" for e in range(1, TRAIN_EPOCHS + 1)}
    if not want <= set(names) or not any(
            n.startswith("best.epoch") for n in names) or not any(
            n.startswith("combined.accu") for n in names):
        raise AssertionError(f"checkpoint names {names}")
    if len(list((work / "combined").glob("combined.accu*"))) != 1:
        raise AssertionError("the combine CLI wrote no combined.accu*")
    steps = records[-1]["step"]

    # one train step from model.init, dropout off, on the card and the CPU
    ckpt = load_checkpoint(str(model))
    cfg = ckpt["cfg"].replace(en_dropout=0.0, de_dropout=0.0)
    loader = make_batch_loader(str(dirs["train"]), read_vocab(str(vocab)),
                               batch, mode="drop")
    first = next(iter(loader))
    loss_dev, grads_dev = _step_on(torch, device, ckpt["params"], cfg, first)
    loss_cpu, grads_cpu = _step_on(torch, "cpu", ckpt["params"], cfg, first)
    loss_err = abs(loss_dev - loss_cpu) / abs(loss_cpu)
    grad_err = max(float((a - b).abs().max()) / max(float(b.abs().max()),
                                                      1e-30)
                   for a, b in zip(grads_dev, grads_cpu))
    print(f"one train step, dropout off: loss {loss_dev!r} ({device}) vs "
          f"{loss_cpu!r} (cpu), rel err {loss_err:.2e}; worst gradient leaf "
          f"max abs err / max |g| = {grad_err:.2e}")
    if loss_err > STEP_LOSS_RTOL or grad_err > STEP_GRAD_RTOL:
        raise AssertionError(f"train step {device} vs cpu: loss {loss_err}, "
                             f"gradients {grad_err}")

    # the train step's time at the recipe's dropout, on one batch
    state = create_train_state(tree_map(
        lambda t: t.detach().to(device, copy=True), ckpt["params"]))
    b = to_device(first, device)

    def step():
        train_step(state, ckpt["cfg"], b.src, b.src_mask, b.tgt, b.tgt_mask)

    for _ in range(3):
        step()
    sync()
    t0 = time.perf_counter()
    n_steps = 10
    for _ in range(n_steps):
        step()
    sync()
    step_ms = (time.perf_counter() - t0) / n_steps * 1e3
    profile = profile_steps(torch, step) if device == "cuda" else None
    batch_frames = int(first.src_mask.sum())
    return {
        "utterances": utts, "frames": frames, "train_steps": steps,
        "train_cli_s": train_s, "metrics": records, "checkpoints": names,
        "launches": launches, "step_ms": step_ms,
        "step_frames": batch_frames, "step_padded_frames":
            int(first.src_mask.size), "frames_per_s": batch_frames / step_ms * 1e3,
        "step_loss_rel_err": loss_err, "step_grad_rel_err": grad_err,
        "step_profile": profile,
    }


def profile_steps(torch, step, n=5):
    """torch.profiler over ``n`` train steps: device time per step, the
    device's idle share of the (profiled, so slower) wall time, and the
    kernels that take the most device time."""
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
    # device rows that are kernels, not the GPU ranges of user annotations
    # such as "Optimizer.step#Adam.step", which span the kernels inside them
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and "#" not in e.key]
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.device_time_total)[:12]
    return {
        "profiled_wall_ms_per_step": wall_ms / n,
        "device_ms_per_step": busy_ms / n,
        "idle_share": 1.0 - busy_ms / wall_ms,
        "kernels_per_step": sum(e.count for e in kernels) / n,
        "top_kernels_ms_per_step": [
            [e.key[:80], e.device_time_total / 1e3 / n, e.count / n]
            for e in top],
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
    train_errs = check_trainable_attention(torch, ba)
    timing = time_banded_attention(torch, ba)
    train_timing = time_trainable_attention(torch, ba)
    summary = run_slice(torch, ba)
    expected = 3 * summary["batches"]  # en_layers x decode batches
    if summary["banded_attention_launches"] != expected:
        raise AssertionError(
            f"banded_attention launched {summary['banded_attention_launches']}"
            f" times in the decode, expected {expected}")
    summary["card"] = card
    print("slice: " + json.dumps(summary))

    training = run_train(torch, ba)
    launches = training["launches"]
    expected = 3 * training["train_steps"]  # en_layers x train steps
    for name in ("banded_attention_fwd", "banded_attention_dq",
                 "banded_attention_dkv"):
        if launches[name] != expected:
            raise AssertionError(f"{name} launched {launches[name]} times in "
                                 f"training, expected {expected}")
    if launches["banded_attention"] == 0:
        raise AssertionError("banded_attention (K1) not launched by the "
                             "training path's evaluations")
    k2_ms = sum(train_timing[n]["ms"] for n in ("fwd", "dq", "dkv"))
    training["k2_share_of_step"] = 3 * k2_ms / training["step_ms"]
    training["card"] = card
    print(f"train step (batch {TRAIN_BATCH}, dropout {DROPOUT}): "
          f"{training['step_ms']:.3f} ms, {training['frames_per_s']:.0f} "
          f"real frames/s, K2a+K2b+K2c share {training['k2_share_of_step']:.3f}")
    print("training: " + json.dumps(training))

    src = "pytorch_kaldi_asr_tpu_torch/ops/csrc/banded_attention_train.cu"
    jax_file = "pytorch_kaldi_asr_tpu/ops/banded_attention.py"
    kernels = [dict(
        name="banded_attention", route="cuda",
        source="pytorch_kaldi_asr_tpu_torch/ops/csrc/banded_attention.cu",
        replaces=f"{jax_file}:112",
        launches=summary["banded_attention_launches"], max_abs_err=err,
        **timing)]
    for name, line in (("fwd", 415), ("dq", 477), ("dkv", 505)):
        kernels.append(dict(
            name=f"banded_attention_{name}", route="cuda", source=src,
            replaces=f"{jax_file}:{line}",
            launches=launches[f"banded_attention_{name}"],
            max_abs_err=train_errs[name], **train_timing[name]))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
