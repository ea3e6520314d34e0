#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pytorch_kaldi_asr_tpu_torch) on one
CUDA card: ``python3 chip_smoke.py`` from the root of a checkout.

1. Requires a CUDA card; prints its name and power limit (nvidia-smi) and
   turns TF32 off for matmuls and cuDNN, and cuBLAS's reduced-precision
   sums in bfloat16 GEMMs.
2. Builds every CUDA kernel of the port from ``ops/csrc`` (one nvcc per
   translation unit, all started together: the attention source as one
   unit per element type, the bfloat16 backward's source as one) and
   prints what ptxas reports; the bfloat16 backward's kernels must not
   spill and must run wgmma (HGMMA in their SASS, ``check_sm90_build``).  Meanwhile a
   thread takes the CPU reference steps of the TIMIT and conformer
   training paths (``prefetch_cpu_steps``), which those paths then find in
   ``cpu_step``'s cache (keyed by a hash of the weights and the batch).
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
   bfloat16 kernels (K1 and K2a as instantiations of the same templates,
   K2b and K2c from ``banded_attention_bwd_sm90.cu``) are held against
   their plain versions on bfloat16 in bfloat16 ulps (``bf16_ulps``,
   BF16_KERNEL_ULPS) at the same shapes (d 24 for d 12), a second backward
   bit-equal to the first, with the same one-launch checks, and timed
   beside SDPA on bfloat16 (bounds at 989 TFLOP/s); the bfloat16 mma probe
   reads the tensor core's rounding (``mma_bf16_probe``).
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
   (its CPU cross-check on 2 utterances of the first batch, deferred to a
   side thread that runs it beside the recipe phase's run.sh:
   ``defer_side_check``, ``start_side_checks``; joined, and any failure
   raised, before the lattice phase by ``join_side_checks``).
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
   flags (its CPU cross-check deferred to the side thread, as in 4);
   then ``generate_archive`` (512 per archive) and ``train
   -train_archive_dir`` on 128/16/16 utterances at batch 32 for 1 epoch,
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
9. The TIMIT recipe's other switches (run.sh:27-61, 112-120, 198-236),
   at its widths: the ``tdnnf`` (its six contexts, bottleneck 64) trained
   with ``-specaugment`` and the ``blstm`` (cut to one encoder layer of
   three), each decoded (16 utterances,
   CPU cross-check on the first batch) and trained as in 5 (K3 exactly at
   their dropout sites, no K1 or K2; the step card vs CPU, SpecAugment's
   masks the same on both; the step's time and profile, the blstm's
   launches per step); the banded TIMIT step with SpecAugment, card vs CPU
   (``run_specaugment_step``: K2a-c and K3 under augmentation); the neural
   LM (``run_nlm``: ``train_nlm`` at its defaults with ``-max_len 102`` on
   the 300 training transcripts for 2 epochs, K3 exact, one step card vs
   CPU, its time and profile, ``score_lm -nlm_model_dir`` on the banded
   decode.txt, card vs CPU within NLM_SCORE_ATOL); and the banded decode
   again, unfused, with ``-lm_weight 0`` (bit-equal to unfused), fused at
   0.5, with ``-quantize_weights`` and with both (``run_lm_decodes``: each's
   CPU cross-check, RTF, split, K1 launches, peak memory; the float32 and
   int8 trees' parameter bytes).
10. The recipe phase (``recipe_phase``): the port's fbank CLI on 16 seeded
   WAVs of 1.5-5 s, log-mel and MFCC, on the card (twice) and on the CPU,
   card within FBANK_ATOL of the CPU, with each run's seconds of audio per
   second (``run_fbank``); run.sh's default encoder, the float32 ``tdnn``,
   decoded as in 4 with its encoder output held against the CPU's
   (``TIMIT_TDNN``, ENCODER_RTOL); then the TIMIT port recipe,
   ``recipes/attention-transformer-timit-cuda/run.sh``, stages 0-5 on the
   card with the banded encoder, ``cmvn=true``, ``nlm_rescore=true`` and 2
   epochs at the recipe's widths on the port's TIMIT-shaped corpus
   (``run_recipe``): it must exit 0 with ``%WER`` reports in both scoring
   dirs of dev and test, its CLIs logging ``cuda`` and their launches
   (K2a-c exactly en_layers x steps), and its first dev decode batch
   decoded again on the CPU from its combined checkpoint must agree
   (compare_nbest).  Prints each stage's wall seconds, the processes and
   the share of the wall time their start-ups take, the decode's RTF and
   the epochs' wall time.  The recipe's launches, read from its logs, join
   the kernels line's counts.
11. The hybrid phase (``hybrid_phase``): the long-form recipe,
   ``recipes/longform-conformer-cuda/run.sh``, stages 0-4 on the card at
   its defaults (``run_hybrid``: 64/8/8 synthetic utterances of about
   2,000-3,500 frames, the conformer AM trained by ``train_am``, its
   posteriors dumped by ``dump_posteriors``, the HLG of ``mkgraph``, the
   host search of ``latgen``, WER, and ``align_ctm``'s CTM): it must exit
   0 with a %WER and CTM lines of positive duration for every test
   utterance, train_am and dump_posteriors logging ``cuda``, K2a-c at
   exactly en_layers x steps, K3 at exactly the AM's dropout sites x steps
   each way, K1 launched.  Then card against CPU: one AM train step from
   the recipe's initial weights on 4 of its utterances
   (``card_vs_cpu_step``), and from its checkpoint the posteriors (every
   frame's best class the same, each utterance's best-path cost within
   HYBRID_COST_ATOL), latgen over both (the same words, costs within
   HYBRID_COST_ATOL) and the encoder output (ENCODER_RTOL); the CPU's
   references run beside the recipe.  Prints the stage walls, processes,
   start-up share, WER, train_am's seconds per step, dump_posteriors',
   latgen's and align_ctm's seconds per second of audio, and the AM step's
   time and profile.  K1 and K2a-c at the long-form shape (BH 8, S 3504,
   band (-100, 50), ragged) are checked among the tile cases and timed in
   the kernel phase.
12. The lattice phase (``lattice_phase``, ``run_lattice``): the hybrid
   phase's posteriors, graph and CTM through the lattice tools, each CLI
   a process: ``train_nlm`` on the card over the long-form training
   transcripts (K3 exactly at its dropout sites x steps each way),
   ``latgen -lattice_beam`` with its Kaldi-text, binary-ark and SLF
   lattices (its result run.sh's decode.txt; ``latgen_lattice`` over the
   card's and the CPU's posteriors: the same best words, costs within
   HYBRID_COST_ATOL), ``lattice_copy`` (prune, n-best, the oracle no
   worse than the 1-best), ``lattice_rescore`` with the 3-gram and with
   the NLM on the card and on the CPU (the same transcripts; the
   hypotheses' NLM scores within NLM_SCORE_ATOL), ``lattice_to_ctm``,
   ``align_ctm -refine_ctm``, ``rover``, ``kws`` (each keyword found)
   and ``show_lattice``.  Prints each CLI's wall and start-up seconds,
   the lattice sizes, the oracle, 1-best and rescored WERs and the
   phase's seconds, and the run's seconds before it and before the serve
   phase.  Its launches, read from the CLIs' logs, join the kernels
   line's counts.
13. The device-search phase (``search_phase``, ``queue_device_search``,
   ``run_device_search``): graph B is built right after the hybrid phase
   (``build_graph_b``: ``prepare_lang --num-nonsil-states 3``,
   ``lm_tools format-lm``, ``mkgraph -topo`` on run.sh's identity
   lexicon, widened by 100 seeded multi-phone words and 200 sentences of
   LM text until ``auto`` picks the frontier decoder; at most 30 s), and
   the CPU references start on the side thread beside the lattice phase
   (the dense search on graph A over the 8 test utterances, the frontier
   on both graphs over 2 utterances cut to 600 frames).  After the
   lattice phase, over the hybrid phase's card posteriors at beam 14,
   max_active 2000: in this process the host ``latgen`` and both device
   decoders on both graphs (the host's words, costs within 2e-4 relative
   of its float64 sums), the frontier on the cut utterances; then
   ``latgen -device_search -device_batch 8`` as processes side by side
   (graph A: ``auto`` picks dense, and ``-device_mode frontier``, each
   run.sh's decode.txt; graph B: ``auto`` picks the frontier, the host
   ``latgen``'s words), and ``align_ctm -topo`` (CTM lines of positive
   duration, exp/test.ctm's words); the card's dense and cut frontier
   decodes against the CPU's (the same words and phones, costs within
   HYBRID_COST_ATOL); no host fallback anywhere.  Prints each graph's
   size and build seconds, each decoder's and the host's seconds per
   second of audio, the peak device memory, each CPU reference's seconds,
   the phase's seconds and the run's before and after it.
14. The tools phase (``tools_phase``, ``run_tools``) over the hybrid
   phase's posteriors and graphs A and B: the native latgen core
   (native/src/latgen.cc) against the Python token passer on the test set,
   on the trained AM's posteriors and on noisy ones (the same words and
   phones, costs within 1e-9, each decoder's seconds), and
   ``latgen_lattice`` both ways on 2 utterances (the same lattice up to
   node numbering and duplicate links, the same 10-best); bench_rtf in
   this process at its defaults (posterior, decode, streaming, hybrid,
   hybrid_device, partials at 6 s) and as a CLI process (``--which
   posterior``); the nnet1 proto DNN (make_nnet_proto's ``dnn 440 2500 4
   1024 --with-dropout 0.1`` behind an 11-frame splice, 8 x 800 frames)
   card against CPU, forward within 1e-5 and one frame-CE step with K3 at
   each dropout site (masks bit-equal, ``card_vs_cpu_step``'s gates); a
   torch.profiler trace (``profile_trace``) of a streaming session and an
   offline forward of the same conformer AM, summarised by
   ``trace_summary`` (K1's kernel row attributed to its wrapper's range);
   then the native host core under the recipe phase's data
   (``run_native_host``): the library and ``pka-tools`` built from the
   checkout's sources; the recipe's test set written as FM, DM, CM, CM2 and
   CM3 arks, the core's ``read_mat`` 0 words apart from the Python readers'
   on every matrix (a DM as float64), each reader's seconds per 1,000
   matrices; on the side thread, ``pka-feat-to-len`` against
   ``tools.feat_to_len`` (``scp:`` and ``ark:``, every kind) and
   ``pka-compute-wer`` against ``tools.compute_wer`` (``present`` and
   ``all``) on the recipe's test decode, byte for byte; on the card, fed by
   the core alone (the Python readers' binary decoding made to raise,
   ``one_reader``), the CM2 test set decoded with the recipe's checkpoint
   (K1; the n-best byte for byte that of the same decode fed by the Python
   readers) and 2 train steps from a CM feats.scp of its training set
   (K2a-c and K3 exactly as the recipe's steps; losses and parameters bit
   for bit the Python readers' run's); the device list.  Its K1, K2a-c
   and K3 launches join the kernels line.
15. The serve phase (``serve_phase``, ``run_serve``): the recognition
   server, ``python3 -m pytorch_kaldi_asr_tpu_torch.recipes.serve``, as two
   processes on free ports.  First a causal copy of the long-form AM (band
   (-100, 0), ``conformer_causal_conv``; the recipe's band reads ahead and
   cannot stream) is trained in this process for 2 epochs over the
   long-form train set (``train_serve_am``).  The attention server on the
   TIMIT decode path's banded checkpoint (``-beam_size 8 -max_batch 8``):
   /healthz; the 16 utterances through /recognize, each top hypothesis
   against the decode CLI's at the same beam; 8 of them at once, coalesced
   by the micro-batcher, equal to the solo results; 2 of the fbank phase's
   WAVs; 2 streaming sessions past encoder_max_len in 40-frame partial
   pushes (the partials say "truncated" past the memory cap, the finish
   equals /recognize of the same audio); a /reload to the TIMIT training
   path's combined checkpoint and a refused one to another configuration.
   The streaming banded encoder on the card against the offline one.  The
   hybrid server on the causal AM and the hybrid phase's HLG: /recognize at
   n-best 1 and 4 on the 8 test utterances against decode.latgen.latgen
   over the same AM's posteriors, and 2 streaming sessions in 40-frame
   pushes.  Both must exit 0 on SIGTERM, their K1 launches (and no other
   kernel's) read from their exit logs into the kernels line.  Prints each
   server's start-up and warm-up seconds, /recognize p50/p95 and RTF, the
   partial and push p50s, the streaming RTF and the phase's seconds.
16. Prints the ``kernels`` JSON line (K1, K2a-c on both dtypes, K3 on both),
   the seconds of every CPU reference the run took (each also on its own
   ``cpu reference`` line as it ends), the card line, and as the last line
   ``{"ok": true, "device": {...}}``.  Any failure raises: the script then
   exits non-zero without the last line.

``python3 chip_smoke.py --recipe`` runs the kernel builds and the recipe
phase (10) alone.

``python3 chip_smoke.py --hybrid`` runs the kernel builds, the long-form
kernel case (K1 and K2a-c against their plain versions and timed at the
long-form shapes, ``longform_kernels``) and the hybrid phase (11) alone.

``python3 chip_smoke.py --lattice`` runs the kernel builds, the long-form
kernel case and the hybrid phase (its inputs), then the lattice phase (12).

``python3 chip_smoke.py --serve`` runs the kernel builds, the TIMIT decode
and training paths, the fbank phase and the hybrid phase (the serve phase's
inputs), then the serve phase (15).

``python3 chip_smoke.py --tools`` runs the kernel builds, the TIMIT
recipe's run.sh (``run_recipe``), the long-form kernel case and the hybrid
phase (its inputs), builds graph B, then the tools phase (14).

``python3 chip_smoke.py --native-host`` runs the kernel builds, the TIMIT
recipe's run.sh (``run_recipe``) and the native host core's part of the
tools phase alone (``run_native_host``).

``python3 chip_smoke.py --device-search`` runs the kernel builds, the
long-form kernel case and the hybrid phase (its inputs), then the
device-search phase (13) with a torch.profiler breakdown of each search
(``search_profile``).

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

``python3 chip_smoke.py --k3-plain`` prints one ``K3_PLAIN`` JSON line from
the host's CPU alone (no kernel built): the plain K3's forward and backward
at the TIMIT encoder's site shape and the TIMIT train step's CPU reference,
each with the current plain K3 and with its first version
(``first_plain_k3``), alternated, and the step's busiest operations
(``k3_plain_readings``).

``python3 chip_smoke.py --noisy-leaf`` prints one ``NOISY_LEAF`` JSON line:
what the float32 step gate reads on the TIMIT model (``f32_gate_readings``)
at 3 seeds x 2 batches of the TIMIT training slice, and with K2b's dq scaled
by 1 + 1e-5 on the card.

``python3 chip_smoke.py --spliced-precision`` prints one
``SPLICED_PRECISION`` JSON line for each of the tdnn and the tdnnf: how far
one float32 train step's loss and gradients sit from the CPU's float64 step
with the spliced products through cuDNN's convolution
(``common.spliced_linear``) and through splice then matmul, on the card
and on the CPU (``spliced_precision``).

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
of the attention sources, ``ops/csrc/banded_attention_train.cu`` and
``ops/csrc/banded_attention_bwd_sm90.cu`` (a parent's, or an edited copy;
a parent's ``banded_attention.cu`` for its K1) in one process: each is
built with the port's nvcc flags (ptxas's registers and spills for each
kernel printed; for a ``banded_attention_bwd_sm90`` source its kernels'
wgmma counts, ``check_sm90_build``), and each kernel a build has, on
float32 and on bfloat16, is timed in turns with the other builds', three
rounds, and held against the outputs of the first build that has it: K2a,
K2b and K2c at the three train timing shapes, K1 at both decode shapes;
one ``K2_SOURCES`` JSON line per shape and dtype, with the train shapes'
bounds and SDPA's backward.

Everything it writes goes under ``build/chip_smoke/`` in the checkout.
"""

import concurrent.futures
import contextlib
import hashlib
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import threading
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
    # its CPU cross-check deferred to the side thread (``cpu_side``)
    "decode": {"utts": 16, "batch": 8, "beam": 25, "nbest": 10,
               "buckets": 4, "max_tokens": 100, "cpu_side": True},
    # stage-4 flags of run.sh:153-175; 3 steps per epoch; the step profiled
    # over one step (three took the whole run past 1,100 s)
    "train": {"utts": {"train": 300, "dev": 40, "test": 40}, "batch": 100,
              "epochs": 2, "size_archive": None, "cpu_rows": None,
              "profiled_steps": 1},
}
LIBRISPEECH = {
    "name": "librispeech", "model": CONFORMER_MODEL, "frames": (150, 1600),
    "lognormal": (7.0, 0.55),  # tools/make_librispeech_shaped.py:179-180
    "words": [f"w{i:04d}" for i in range(5000)],
    # its CPU cross-check (12.9-27.2 s, the bfloat16 stream's with its
    # float32 decode, bfloat16 compute's CPU encoders and search from the
    # card's encoder output) deferred to the side thread
    "decode": {"utts": 16, "batch": 8, "beam": 8, "nbest": 8, "buckets": 4,
               "max_tokens": 100, "cpu_side": True},
    # run.sh:113-139 at batch 32; 4 steps per epoch.  The CPU side of the
    # card-vs-CPU step takes 4 utterances: the plain attention at 32 x 1600
    # would need about 40 GB
    "train": {"utts": {"train": 128, "dev": 16, "test": 16}, "batch": 32,
              "epochs": 1, "size_archive": 512, "cpu_rows": 4,
              "profiled_steps": 1},
}
LIBRISPEECH_BF16 = dict(LIBRISPEECH, name="librispeech_bf16",
                        model=CONFORMER_BF16_MODEL)
# the CPU cross-check takes 2 utterances of the first batch: the
# fixed-buffer search decodes the whole buffer at every step, and the CPU
# took about 87 s for all 8 on the chip machine (40.9-61.3 s for the 2), so
# it runs later on the side thread (``cpu_side``), beside the recipe phase's
# run.sh
TIMIT_NONCAUSAL = dict(TIMIT, name="timit_noncausal", model=NONCAUSAL_MODEL,
                       decode=dict(TIMIT["decode"], cpu_utts=2,
                                   cpu_side=True))
# the TIMIT recipe's other encoders (run.sh:52) at its widths: the tdnnf
# (TransformerConfig's six tdnn_contexts, bottleneck 64) trained with
# SpecAugment (train -specaugment), the blstm (128 units each way) without;
# the blstm's step is timed over 3 steps and profiled over 1 (about 50,000
# launches a step).  Their card-vs-CPU steps take 20 utterances (the CPU's
# blstm step in float64 at batch 100 took 182 s on the H100 host), the
# tdnnf's against the CPU in float64: at batch 100 its float32 gradients sat
# up to 4.4e-4 (CPU) and 7.5e-4 (card) of their size from float64, and the
# one-ulp yardstick, which keeps the CPU's summation order, read 5.5e-6
# (``card_vs_cpu_step``; PERF.md §6)
TIMIT_TDNNF = dict(TIMIT, name="timit_tdnnf",
                   model=[x if x != "banded" else "tdnnf"
                          for x in RECIPE_MODEL],
                   train=dict(TIMIT["train"], specaugment=True,
                              cpu_dtype="float64", cpu_rows=20))
# The blstm is cut to one encoder layer of the recipe's three: at three its
# step took 1.9 s and 66,131 launches, and its profile of one step 40.8 s,
# which took the whole run past 1,100 s (PERF.md §4)
BLSTM_MODEL = [x if x != "banded" else "blstm" for x in RECIPE_MODEL]
BLSTM_MODEL[BLSTM_MODEL.index("-en_layers") + 1] = "1"
TIMIT_BLSTM = dict(TIMIT, name="timit_blstm", model=BLSTM_MODEL,
                   train=dict(TIMIT["train"], timed_steps=3, epochs=1,
                              profiled_steps=1, cpu_rows=20))
# stage 2's neural LM (run.sh:27-37, 112-120): train_nlm at its defaults
# with the recipe's nlm_max_len (max_token_seq_len + 2), 2 epochs over the
# 300 TIMIT training transcripts (9 steps each at batch 32), then fused
# into the banded TIMIT decode at fusion_lm_weight
NLM = {"max_len": 102, "epochs": 2, "batch": 32, "lm_weight": 0.5}
NLM_SCORE_ATOL = 2e-4  # score_lm -nlm_model_dir, card vs CPU, log10
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
# (the conformer paths train 1 epoch: 4 steps, which the launch checks
# count; TIMIT's paths' 2 epochs run combine over two checkpoints)
LIBRISPEECH_BF16_COMPUTE = dict(
    LIBRISPEECH_BF16, name="librispeech_bf16_compute",
    compute_dtype="bfloat16",
    train=LIBRISPEECH_BF16["train"],
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
# attention kernels of banded_attention_train.cu are templates over the
# element type, the bfloat16 backward's over its 64-column blocks)
PROFILE_NAMES = {
    "K1": "::banded_attention_kernel<float", "K2a": "::fwd_kernel<float",
    "K2b": "::dq_kernel<float", "K2c": "::dkv_kernel<float",
    "K1_bf16": "::banded_attention_kernel<__nv_bfloat16",
    "K2a_bf16": "::fwd_kernel<__nv_bfloat16",
    "K2b_bf16": "::dq_sm90_kernel<",
    "K2c_bf16": "::dkv_sm90_kernel<",
    "K3": "::fused_dropout_kernel", "K3_bf16": "::fused_dropout_bf16_kernel",
}
# the launch_counts() entries that count each PROFILE_NAMES kernel
PROFILE_COUNTS = {
    "K1": ("banded_attention",), "K2a": ("banded_attention_fwd",),
    "K2b": ("banded_attention_dq",), "K2c": ("banded_attention_dkv",),
    "K1_bf16": ("banded_attention_bf16",),
    "K2a_bf16": ("banded_attention_fwd_bf16",),
    "K2b_bf16": ("banded_attention_dq_bf16",),
    "K2c_bf16": ("banded_attention_dkv_bf16",),
    "K3": ("fused_dropout_forward", "fused_dropout_backward"),
    "K3_bf16": ("fused_dropout_forward_bf16", "fused_dropout_backward_bf16"),
}
# torch.profiler has returned a bfloat16 train step's profile that held no
# attention kernel of either dtype on the H100 (PERF.md §6): a profile
# holding under half the launches that a kernel's wrapper counted while it
# ran lost its device records, and is taken again, up to PROFILE_ATTEMPTS
# in all.  (Every profiled train step's K3 reads one launch under its
# wrappers' count, a record lost at the window's edge; half is far from it.)
PROFILE_ATTEMPTS = 3
# the encoder families whose self-attention runs K1 and K2
ATTENDING = ("banded", "conformer")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]


def launch_counts():
    """Every kernel wrapper's launch count, by name (ops/launches.py)."""
    from pytorch_kaldi_asr_tpu_torch.ops.launches import launch_counts

    return launch_counts()


def reset_launch_counts():
    from pytorch_kaldi_asr_tpu_torch.ops.launches import reset_launch_counts

    reset_launch_counts()


def dropout_sites(cfg, decoder=True):
    """K3 launches of one train step, each way, by dtype ({"float32": n,
    "bfloat16": m}), counted from the model code (models/transformer.py,
    models/encoders.py).  The tdnn encoder: after the projection and each
    TDNN layer (in the compute dtype), after the positions (float32).  The
    banded encoder: the input dropout and one after the final positions
    (float32), per layer the attention block's output and the FFN's (the
    compute dtype).  The conformer: per layer one in each half-step FFN
    after its swish and one after the MHSA (the compute dtype); the input
    dropout, each half-step FFN's second and the conv module's (the
    stream's dtype).  The tdnnf: after each layer's ReLU (float32).  The
    blstm: after each layer (float32).  The decoder: its embedding and
    output dropouts (float32), per layer the self- and cross-attention
    probabilities and outputs and the FFN's output (the compute dtype);
    the hybrid AM (``decoder=False``) has none of the decoder's."""
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
    elif cfg.encoder_type == "tdnnf":
        add(len(cfg.tdnn_contexts), "float32")
    elif cfg.encoder_type == "blstm":
        add(cfg.en_layers, "float32")
    else:
        raise ValueError(f"no site count for {cfg.encoder_type}")
    if decoder:
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


# the long-form recipe's utterances (recipes/longform-conformer-cuda/run.sh:
# 80-140 words of 23-27 frames), cut at 3,504 frames, about the longest its
# corpus draws (its train set pads to 3,528, the kernels' tile to 3,584)
LONGFORM = {"name": "longform", "frames": (1840, 3504)}
# its train batch's attention at the kernels: 4 utterances x 2 heads, ragged
# (lengths that end inside a tile, a short one) under band (-100, 50)
LONGFORM_LENGTHS = [3504, 3504, 3100, 3100, 2411, 2411, 1990, 1990]

# (bh, s, d, band, corpus, utterances, heads) of K1 and K2 at each path
ATTN_SHAPES = {
    "timit_decode": (16, 504, 64, (-100, 0), TIMIT, 8, 2),
    "conformer_decode": (32, 1600, 64, (-256, 256), LIBRISPEECH, 8, 4),
    "conformer_train": (128, 1600, 64, (-256, 256), LIBRISPEECH, 32, 4),
    # dump_posteriors' batch: the 8 test utterances x 2 heads
    "longform_decode": (16, 3504, 64, (-100, 50), LONGFORM, 8, 2),
}


def _tile_cases(torch, scale, bf16=False):
    """(bh, s, d, dv, lengths, start, end, scale, name) of the cases that
    reach each skip of the kernels' tiling: band edges on a tile boundary,
    whole invalid key tiles and dead query tiles, 8-key chunks wholly in
    band beside partial ones, a key mask that is no prefix, dv != d, d a
    multiple of 4 but not of 8 (``bf16``: d 24, which ends inside a 16-deep
    mma step), the largest head dims, and the long-form recipe's train
    batch (S 3504, band (-100, 50), ragged: many dead query tiles and
    invalid key tiles beside live ones)."""
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
        (8, 3504, 64, 64, LONGFORM_LENGTHS, -100, 50, scale,
         "long-form S 3504 band (-100,50)"),
    ]


def check_banded_attention(torch, ba, cases=None):
    """Kernel vs plain version on the card, at the paths' shapes and at
    the tile-skip cases (or at ``cases``); returns the max abs error."""
    if cases is not None:
        return _check_k1(torch, ba, cases)
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
    return _check_k1(torch, ba, cases)


def _check_k1(torch, ba, cases):
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
    fn()

    def calls():
        for _ in range(n):
            fn()

    events, _, _ = _profile(torch, calls, expect=(kernel,))
    rows = [e for e in _kernel_rows(events)[1]
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


def check_trainable_attention(torch, ba, cases=None):
    """K2a/K2b/K2c through the autograd function vs autograd of the plain
    trainable version on the card, at dropout 0 and 0.35, at the paths'
    shapes and at the cases that reach each skip of the kernels' tiling
    (``_tile_cases``), or at ``cases``.  Returns the max abs error per
    kernel: K2a out and lse, K2b dq, K2c dk and dv."""
    scale = 1.0 / math.sqrt(256.0)
    bh, s, d, (start, end), corpus, n, heads = ATTN_SHAPES["conformer_train"]
    cases = cases or [
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
    float32, and a second backward (K2b, then K2c on its delta) bit-equal to
    the first.  Returns {kernel: (max abs error, largest ulps)}."""
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
            again = ba.banded_attention_dq(q, k, v, valid, dout, out, lse,
                                           4321, **kw)
            again += ba.banded_attention_dkv(q, k, v, valid, dout, lse,
                                             again[1], 4321, **kw)
            if not all(torch.equal(a, b) for a, b in zip(
                    again, (dq, delta, dk, dv_))):
                raise AssertionError(f"trainable bf16 {name} rate={rate}: a "
                                     f"second backward differs from the "
                                     f"first")
            del again
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

    fn = _build.load("banded_attention_train", "bf16").mma_bf16_probe
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


def lost_records(kernels, before, after, expect=()):
    """{PROFILE_NAMES key: {"profiled", "counted"}} of the kernels whose
    device records a profile lost: ``kernels`` ({kernel name: launches})
    holds under half the launches that the wrappers counted from
    ``before`` to ``after`` (launch_counts()), or none of a kernel in
    ``expect``."""
    lost = {}
    for k, pat in PROFILE_NAMES.items():
        seen = sum(n for name, n in kernels.items() if pat in name)
        counted = sum(after[c] - before[c] for c in PROFILE_COUNTS[k])
        if seen < counted / 2 or (k in expect and not seen):
            lost[k] = {"profiled": seen, "counted": counted}
    return lost


def _profile(torch, fn, expect=()):
    """torch.profiler over ``fn()``, its work synchronised: (key_averages(),
    the wall ms of ``fn``, attempts).  A profile that lost its device
    records (PROFILE_ATTEMPTS: under half the launches of a kernel that
    its wrappers counted meanwhile, or none of a kernel in ``expect``,
    PROFILE_NAMES keys of kernels ``fn`` launches past the wrappers) is
    printed and taken again; the last attempt is returned as it is, for
    the caller's gates."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        before = launch_counts()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        after = launch_counts()
        events = prof.key_averages()
        kernels = _kernel_rows(events)[1]
        lost = lost_records({e.key: e.count for e in kernels}, before, after,
                            expect)
        if not lost:
            break
        print(f"torch.profiler lost device records (attempt {attempt} of "
              f"{PROFILE_ATTEMPTS}, {len(kernels)} kernel rows, "
              f"{sum(e.count for e in kernels)} launches): "
              + json.dumps(lost), flush=True)
    return events, wall_ms, attempt


def device_kernels(torch, fn):
    """({kernel name: launches} on the card while ``fn`` runs (its work
    synchronised), from torch.profiler: every kernel, copy and fill; the
    times ``fn`` ran, ``_profile``'s attempts)."""
    events, _, attempts = _profile(torch, fn)
    return ({e.key: e.count for e in _kernel_rows(events)[1]}, attempts)


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
    kernels, runs = device_kernels(torch, fn)
    launched = tuple(getattr(w, attr) - n for w, n in zip(wrappers, before))
    ours = [sum(n for name, n in kernels.items() if PROFILE_NAMES[k] in name)
            for k in names]
    print(f"{what}: wrapper launches {launched} over {runs} run(s); device "
          f"kernels {kernels}")
    if launched != (runs,) * len(wrappers) or ours != [1] * len(names) \
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
        lambda: torch.autograd.grad(out, (q, k, v), dout,
                                    retain_graph=True),
        (ba.banded_attention_dq, ba.banded_attention_dkv),
        (f"K2b{sfx}", f"K2c{sfx}"), attr)


# (bh, s, d, band, lengths, rate) of the K2 timings
TRAIN_TIMING_SHAPES = {
    # the TIMIT training slice: batch 100 x 2 heads, utterances of 412-504
    # frames (no empty query row, so SDPA's softmax is defined everywhere)
    "timit_train": (200, 512, 64, (-100, 0), "timit", DROPOUT),
    # the conformer's train batch: 32 x 4 heads, archives padded to 1600
    "conformer_train": (128, 1600, 64, (-256, 256), "librispeech", 0.1),
    # the long-form recipe's AM train batch: 4 x 2 heads, S 3504
    "longform_train": (8, 3504, 64, (-100, 50), "longform", 0.1),
}


def train_timing_inputs(torch, ba, shape, dtype=None):
    """(q, k, v, valid, dout, out, lse, seed, kw) at ``shape``
    (TRAIN_TIMING_SHAPES): seeded inputs on the card in ``dtype`` (float32
    by default), the forward's out and lse, and the kernels' keyword
    arguments at the path's rate.  S is padded to the 64-frame tile as the
    trainable wrapper pads it, the padded keys invalid."""
    bh, s, d, (start, end), lengths, rate = TRAIN_TIMING_SHAPES[shape]
    scale, seed = 1.0 / math.sqrt(256.0), 99
    g = torch.Generator().manual_seed(5)
    if lengths == "timit":
        lengths = torch.randint(412, 505, (bh // 2,),
                                generator=g).repeat_interleave(2)
    elif lengths == "longform":
        lengths = LONGFORM_LENGTHS
    else:
        lengths = _lengths(torch, LIBRISPEECH, bh // 4, 4, s, 5)
    s = -(-s // ba.BLOCK) * ba.BLOCK
    q, k, v, valid = _attention_inputs(torch, bh, s, d, d, lengths, seed=8)
    dout = torch.randn((bh, s, d), generator=g).cuda()
    q, k, v, dout = (x.to(dtype or torch.float32) for x in (q, k, v, dout))
    kw = dict(start=start, end=end, scale=scale, dropout_rate=rate)
    out, lse = ba.banded_attention_fwd(q, k, v, valid, seed, **kw)
    return q, k, v, valid, dout, out, lse, seed, kw


def train_bounds(torch, q, valid, start, end):
    """{K2a "fwd", K2b "dq", K2c "dkv", the pair "backward": (bound_ms,
    bound_by)} at q's shape [BH, S, d] (d = dv) and dtype, its in-band
    pairs counted from ``valid``; and the pairs."""
    bh, s, d = q.shape
    pairs = int(_allowed(torch, s, start, end, valid).sum())
    vec = q.element_size() * bh * s * d  # bytes of one [BH, S, d] tensor
    row = 4 * bh * s  # bytes of one [BH, S] int32/float32 tensor
    tc = dict(tensor_cores=True, bf16=q.dtype == torch.bfloat16)
    return {  # (bytes: inputs once, outputs once; flops per in-band pair)
        "fwd": _bound(4 * vec + 2 * row, pairs * 4 * d, **tc),
        "dq": _bound(6 * vec + 3 * row, pairs * 6 * d + 2 * bh * s * d, **tc),
        "dkv": _bound(6 * vec + 3 * row, pairs * 8 * d, **tc),
        # the pair's function: q, k, v, dout, out, lse, key_valid in; dq,
        # dk, dv out; five products per pair (S, dP, dV, dK, dQ) and delta.
        # K2b's recomputation of S and dP is a cost of the two-kernel design
        "backward": _bound(8 * vec + 2 * row, pairs * 10 * d + 2 * bh * s * d,
                           **tc),
    }, pairs


def sdpa_backward_ms(torch, q, k, v, valid, dout, start, end, scale,
                     **timed):
    """SDPA's backward (dq, dk and dv together) at dropout 0 with the boolean
    band mask, on q's dtype: the library call the backward pair is held
    against."""
    import torch.nn.functional as F

    allowed = _allowed(torch, q.shape[1], start, end, valid)
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=allowed,
                                         scale=scale)
    return time_ms(torch, lambda: torch.autograd.grad(
        out, (qg, kg, vg), dout, retain_graph=True), **timed)


def time_trainable_attention(torch, ba, shape, dtype=None):
    """K2a, K2b and K2c, their plain versions and the library call at
    ``shape`` (TRAIN_TIMING_SHAPES) on ``dtype`` (float32 by default); and
    the backward as the model runs it, K2b (with delta) then K2c, at
    dropout 0 (like for like with SDPA's backward, which computes the same
    dq, dk and dv) and at the path's rate.  SDPA (forward; backward for dq
    and dk/dv together) runs at dropout 0 with the same boolean band mask,
    on the same dtype."""
    import torch.nn.functional as F

    bh, _, d, (start, end), _, rate = TRAIN_TIMING_SHAPES[shape]
    q, k, v, valid, dout, out, lse, seed, kw = train_timing_inputs(
        torch, ba, shape, dtype)
    s = q.shape[1]  # padded to the tile
    scale = kw["scale"]
    dq_args = (q, k, v, valid, dout, out, lse, seed)
    _, delta = ba.banded_attention_dq(*dq_args, **kw)
    dkv_args = (q, k, v, valid, dout, lse, delta, seed)

    allowed = _allowed(torch, s, start, end, valid)
    bounds, pairs = train_bounds(torch, q, valid, start, end)
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
    sdpa_bwd_ms = sdpa_backward_ms(torch, q, k, v, valid, dout, start, end,
                                   scale, **timed)
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
    """Start one nvcc per version of an attention source in ``sources``
    (banded_attention_train.cu, banded_attention_bwd_sm90.cu), with the
    port's flags, into build/chip_smoke/k2_sources/; returns {source:
    (process, library path)}."""
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
    kernels took an element type: "kernel<MAXD8>"; the bfloat16 backward:
    "kernel<bf16, CB>", CB its 64-column blocks), and ptxas's warnings
    (a wgmma it serialized, for one)."""
    out, entry = [], None
    for line in log.splitlines():
        found = re.search(r"(banded_attention_kernel|fwd_kernel|dq_kernel"
                          r"|dkv_kernel)I(f|13__nv_bfloat16)?Li(\d+)E", line)
        sm90 = re.search(r"(dq_sm90_kernel|dkv_sm90_kernel)ILi(\d+)E", line)
        if "Compiling entry function" in line:
            entry = None
            if found:
                dtype = {"f": "float, ", "13__nv_bfloat16": "bf16, "}.get(
                    found[2], "")
                entry = f"{found[1]}<{dtype}{found[3]}>"
            elif sm90:
                entry = f"{sm90[1]}<bf16, {sm90[2]}>"
        elif entry and ("Used" in line or "spill" in line):
            out.append(f"{entry}: "
                       f"{line.split('ptxas info', 1)[-1].strip(' :')}")
        if "Performance Loss" in line or "ptxas warning" in line:
            out.append(f"{entry or 'ptxas'}: {line.strip()}")
    return out


def wgmma_counts(lib, src):
    """{kernel: wgmma instructions} of library ``lib`` built from ``src``:
    HGMMA in its SASS (cuobjdump -sass), or where the toolkit has no
    cuobjdump, wgmma.mma_async in the PTX of ``src`` (nvcc -ptx)."""
    from pytorch_kaldi_asr_tpu_torch.ops import _build

    nvcc = Path(_build._nvcc())
    cuobjdump = nvcc.with_name("cuobjdump")
    if cuobjdump.exists():
        text = subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True,
                              capture_output=True, text=True).stdout
        head, count = r"Function : (\S+)", "HGMMA"
    else:
        ptx = WORK / f"{Path(lib).stem}.ptx"
        subprocess.run([str(nvcc), "-arch=sm_90a", "-std=c++17", "-O3", "-ptx",
                        "-o", str(ptx), str(src)], check=True,
                       capture_output=True)
        text, head, count = ptx.read_text(), r"\.entry (\w+)", "wgmma.mma_async"
    counts, fn = {}, None
    for line in text.splitlines():
        found = re.search(head, line)
        if found:
            fn = found[1]
            counts[fn] = 0
        elif fn and count in line:
            counts[fn] += 1
    return counts


SM90_SOURCE = "banded_attention_bwd_sm90"


def check_sm90_build(log, lib, src):
    """The bfloat16 backward's kernels as built: ptxas reports no spill
    bytes (where ``log`` holds its compile) and each runs wgmma
    (``wgmma_counts``).  Prints both; raises if a kernel spills or has no
    wgmma."""
    for line in ptxas_summary(log or ""):
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                           r"loads", line)
        if "_sm90_kernel" in line and spills and spills.group(1, 2) != (
                "0", "0"):
            raise AssertionError(f"{src.name}: {line}")
    counts = wgmma_counts(lib, src)
    print(f"  {src.name} wgmma per kernel: " + json.dumps(counts))
    kernels = [n for k, n in counts.items() if "_sm90_kernel" in k]
    if len(kernels) != 4 or not all(kernels):
        raise AssertionError(f"{src.name}: kernels without wgmma: {counts}")


def finish_k2_builds(procs):
    """{source: ctypes library} of start_k2_builds' processes; prints
    ptxas's registers and spills for each attention kernel, and for a
    version of the bfloat16 backward its kernels' wgmma counts
    (``check_sm90_build``)."""
    import ctypes

    libs = {}
    for src, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{log}")
        for line in ptxas_summary(log):
            print(f"  {src.name} {line}")
        if SM90_SOURCE in src.name:
            check_sm90_build(log, lib, src)
        libs[src] = ctypes.CDLL(str(lib))
    return libs


def _source_calls(torch, ba, shape, dtype):
    """{kernel: (pointer arguments, scalar arguments, outputs)} of the
    kernels --k2-sources times at ``shape`` on ``dtype``: K2a, K2b and K2c
    at a TRAIN_TIMING_SHAPES shape (K2a into outputs of its own, so that K2b
    and K2c read the same out and lse in every build), K1 at a decode
    shape; and the train shape's bounds and SDPA's backward there."""
    if shape not in TRAIN_TIMING_SHAPES:
        q, k, v, valid, start, end, scale = decode_timing_inputs(
            torch, ba, shape, dtype)
        out = torch.empty_like(v)
        return {"k1": ((q, k, v, valid, out),
                       (*q.shape, v.shape[-1], start, end, scale), (out,))}, {}
    q, k, v, valid, dout, out, lse, seed, kw = train_timing_inputs(
        torch, ba, shape, dtype)
    scalars = (*q.shape, v.shape[-1], kw["start"], kw["end"], kw["scale"],
               *ba._dropout_args(seed, kw["dropout_rate"]))
    out_f, lse_f, dq, dk, dv = (torch.empty_like(x)
                                for x in (out, lse, q, k, v))
    delta = torch.empty_like(lse)
    bounds, _ = train_bounds(torch, q, valid, kw["start"], kw["end"])
    library = {"bounds_ms": {n: b[0] for n, b in bounds.items()},
               "sdpa_bwd_ms": sdpa_backward_ms(
                   torch, q, k, v, valid, dout, kw["start"], kw["end"],
                   kw["scale"], iters=20, warmup=3)}
    return {"fwd": ((q, k, v, valid, out_f, lse_f), scalars, (out_f, lse_f)),
            "dq": ((q, k, v, dout, out, lse, valid, dq, delta), scalars,
                   (dq, delta)),
            "dkv": ((q, k, v, dout, lse, delta, valid, dk, dv), scalars,
                    (dk, dv))}, library


def compare_k2_sources(torch, ba, libs, rounds=3):
    """Each attention kernel of each build in ``libs`` ({source: ctypes
    library}) that has its entry point, on float32 and on bfloat16, on the
    same inputs: K2a, K2b (dq with delta) and K2c at each
    TRAIN_TIMING_SHAPES shape at the path's rate, K1 at both decode shapes.
    CUDA-event times in ``rounds`` rounds that take the builds in turns, and
    each build's largest difference from the outputs of the first build
    that has the kernel (0 where both are -inf); at the train shapes the
    bounds and SDPA's backward.  Returns {"shape dtype": row}."""
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    fns = {src: {} for src in libs}
    for src, lib in libs.items():
        for dname, dtype in dtypes.items():
            for which in ("k1", "fwd", "dq", "dkv"):
                try:
                    fns[src][dname, which] = ba.kernel_entry(lib, which,
                                                             dtype)
                except AttributeError:  # a source without this kernel
                    pass
    results = {}
    for dname, dtype in dtypes.items():
        for shape in (*TRAIN_TIMING_SHAPES, "timit_decode",
                      "conformer_decode"):
            calls, library = _source_calls(torch, ba, shape, dtype)
            has = {src: [w for w in calls if (dname, w) in fns[src]]
                   for src in libs}
            if not any(has.values()):
                continue

            def launch(src, which):
                tensors, scalars, _ = calls[which]
                ptrs = [t.data_ptr() for t in tensors]
                return lambda: ba._run(f"{src.name} {which}",
                                       fns[src][dname, which],
                                       tensors[0].device, *ptrs, *scalars)

            first, diff = {}, {src: {} for src in libs}
            for src in libs:
                for which in has[src]:  # in order: K2c reads K2b's delta
                    launch(src, which)()
                    got = [x.clone() for x in calls[which][2]]
                    first.setdefault(which, got)
                    diff[src][which] = max(
                        float(torch.nan_to_num((a.float() - b.float()).abs(),
                                               nan=0.0).max())
                        for a, b in zip(got, first[which]))
            times = {src: {w: [] for w in has[src]} for src in libs}
            for _ in range(rounds):
                for src in libs:
                    for which in times[src]:
                        times[src][which].append(time_ms(
                            torch, launch(src, which), iters=20, warmup=3))
            results[f"{shape} {dname}"] = {
                **library,
                "builds": {str(src): {
                    **{f"{w}_ms": t for w, t in times[src].items()},
                    "max_diff_from_first": diff[src]}
                    for src in libs if has[src]}}
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


def stage5_args(spec, data_dir, vocab, model, out, device):
    """The decode CLI's flags for ``spec`` (a corpus's ``decode``)."""
    return ["-read_data_dir", str(data_dir), "-read_vocab_file", str(vocab),
            "-load_model_file", str(model), "-save_result_file", str(out),
            "-device", device, "-batch_size", str(spec["batch"]),
            "-num_buckets", str(spec["buckets"]), "-beam_size",
            str(spec["beam"]), "-nbest", str(spec["nbest"]),
            "-max_token_seq_len", str(spec["max_tokens"])]


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
        return stage5_args(spec, data_dir, data / "vocab.txt", model, out,
                           device)

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

    def cpu_cross_check():
        """The first decode batch again, on the CPU: its largest score
        difference from the card's (and the bfloat16 stream's distance
        from float32), or AssertionError."""
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
            return compare_nbest_bf16(
                gpu, cpu, read_nbest(work / "decode_cpu_f32.txt"))
        return compare_nbest(gpu, cpu), None

    t0 = time.perf_counter()
    side = None
    if corpus.get("compute_dtype") == "bfloat16":  # the card's part now
        cpu_part = bf16_compute_decode_check(torch, model, data, spec,
                                             device, defer=True)

        def cpu_cross_check():
            check = cpu_part()
            print(f"{corpus['name']}: first decode batch, card vs cpu: "
                  + json.dumps(check))
            if check["encoder_ratio"] > corpus["decode_encoder_ratio"] \
                    or check["encoder_from_float32"] \
                    < BF16_DECODE_FLOAT32_FLOOR \
                    or not check["search_same_tokens"] \
                    or check["search_max_score_diff"] > CPU_SCORE_ATOL:
                raise AssertionError(f"{corpus['name']}: the card's decode "
                                     f"against the CPU's: {check}")
            return check["search_max_score_diff"], check
    if spec.get("cpu_side"):  # later, on the side thread
        side = f"{corpus['name']} decode, first batch"
        defer_side_check(side, cpu_cross_check)
        score_err = "on the side thread"
    elif corpus.get("compute_dtype") == "bfloat16":
        score_err, check = cpu_cross_check()
    else:
        score_err, bf16_error = cpu_cross_check()
    encoder = None
    if corpus.get("check_encoder"):
        err, largest = encoder_card_vs_cpu(torch, model, data, spec, device)
        encoder = {"max_abs_err": err, "max_abs": largest}
        if err > ENCODER_RTOL * largest:
            raise AssertionError(f"{corpus['name']}: encoder output, card "
                                 f"vs CPU: {encoder}")
    cpu_s = time.perf_counter() - t0
    if side is None:
        cpu_reference_done(f"{corpus['name']} decode, first batch", cpu_s)

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
        "encoder_card_vs_cpu": encoder, "cpu_side_check": side,
    }


def bf16_compute_decode_check(torch, model, data, spec, device="cuda",
                              fault=None, defer=False):
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
    the numbers; with ``defer``, the card's part done, a function that
    does the CPU's part and returns them."""
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
    kw = dict(beam_size=spec["beam"], max_len=spec["max_tokens"])
    res_dev = fast_beam_search_memory(params_dev, cfg, enc_dev, mask_f, **kw)
    enc_dev, mask_f = enc_dev.cpu(), mask_f.cpu()
    tokens_dev, scores_dev = res_dev.tokens.cpu(), res_dev.scores.cpu()

    def cpu_part():
        with torch.no_grad():
            enc_cpu, mask_cpu = encode(params, cfg, b_cpu.src,
                                       b_cpu.src_mask)
            enc32, _ = encode(params, own_error_config(cfg), b_cpu.src,
                              b_cpu.src_mask)
        keep = (mask_cpu > 0) & (b_cpu.valid[:, None] > 0)
        card, cpu, cpu32 = (x.double()[keep] for x in (enc_dev, enc_cpu,
                                                       enc32))
        own = (cpu - cpu32).abs().mean()
        ratio = float((card - cpu).abs().mean() / own)
        from_float32 = float((card - cpu32).abs().mean() / own)
        res_cpu = fast_beam_search_memory(params, cfg, enc_dev, mask_f, **kw)
        return {"encoder_ratio": ratio, "encoder_from_float32": from_float32,
                "search_same_tokens": torch.equal(tokens_dev, res_cpu.tokens),
                "search_max_score_diff": float(
                    (scores_dev - res_cpu.scores).abs().max())}

    return cpu_part if defer else cpu_part()


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
CPU_STEPS = {}  # key -> Future of a CPU reference step (cpu_step)
CPU_STEPS_LOCK = threading.Lock()
CPU_REFERENCES = []  # (label, wall seconds) of each CPU reference of the run


def cpu_reference_done(label, seconds):
    """Record one CPU reference's wall seconds and print them on a line of
    their own."""
    CPU_REFERENCES.append((label, seconds))
    print(f"cpu reference {label}: {seconds:.1f} s", flush=True)


# CPU cross-checks deferred to a side thread (run_slice's, where the
# corpus's decode sets ``cpu_side``): queued by defer_side_check, started by
# start_side_checks where the main thread mostly waits on processes (the
# full run: as the recipe phase's run.sh starts), one at a time, each on
# SIDE_CHECK_THREADS threads; joined by join_side_checks, which raises what
# a check raised
SIDE_CHECK_THREADS = 4
SIDE_PENDING = []  # (label, fn) not started yet
SIDE_CHECKS = []  # (label, Future, {"start_s", "end_s"} on the run's clock)
_SIDE_POOL = []
RUN_START = time.perf_counter()


def defer_side_check(label, fn):
    """Queue ``fn()``, a CPU cross-check, for the side thread."""
    SIDE_PENDING.append((label, fn))


def start_side_checks(torch):
    """Start the queued checks on the side thread; each one's wall seconds
    are recorded as a CPU reference, and its start and end on the run's
    clock, so the card timings taken meanwhile can be named."""
    if SIDE_PENDING and not _SIDE_POOL:
        _SIDE_POOL.append(concurrent.futures.ThreadPoolExecutor(1))
    threads = torch.get_num_threads()
    while SIDE_PENDING:
        label, fn = SIDE_PENDING.pop(0)
        span = {}

        def job(label=label, fn=fn, span=span):
            # this thread's team; the BLAS threads the setting shares with
            # the main thread are given back when the check ends
            torch.set_num_threads(SIDE_CHECK_THREADS)
            t0 = time.perf_counter()
            span["start_s"] = t0 - RUN_START
            try:
                return fn()
            finally:
                t1 = time.perf_counter()
                torch.set_num_threads(threads)
                span["end_s"] = t1 - RUN_START
                cpu_reference_done(f"{label} (side thread)", t1 - t0)

        SIDE_CHECKS.append((label, _SIDE_POOL[0].submit(job), span))


def join_side_checks(torch):
    """Start what is still queued, wait for every side check; raises the
    first failure.  Returns {label: {"result", "start_s", "end_s",
    "waited_s"}}."""
    start_side_checks(torch)
    out = {}
    while SIDE_CHECKS:
        label, future, span = SIDE_CHECKS.pop(0)
        t0 = time.perf_counter()
        result = future.result()
        out[label] = {"result": result, **span,
                      "waited_s": time.perf_counter() - t0}
        print(f"side check {label}: " + json.dumps(out[label]), flush=True)
    return out


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


def cpu_step(torch, params, cfg, batch, specaugment=False, dtype=None):
    """``_step_on`` the CPU at dropout seed 0, taken once for the same
    inputs (CPU_STEPS).  Only the main paths' references come from here:
    a fault planted in memory is not among the inputs."""
    dtype = dtype or torch.float32  # None and float32 are one step
    key = (repr(cfg), _digest(torch, params, batch), specaugment, dtype)
    with CPU_STEPS_LOCK:  # a step another thread takes is waited for
        mine = key not in CPU_STEPS
        if mine:
            CPU_STEPS[key] = concurrent.futures.Future()
        step = CPU_STEPS[key]
    if mine:
        t0 = time.perf_counter()
        try:
            step.set_result(_step_on(torch, "cpu", params, cfg, batch,
                                     dtype=dtype, specaugment=specaugment))
        except BaseException as e:
            step.set_exception(e)
            raise
        cpu_reference_done(
            f"cpu_step {cfg.encoder_type} compute {cfg.compute_dtype} "
            f"stream {cfg.conformer_stream_dtype} in {dtype} "
            f"batch {list(batch.src.shape)}", time.perf_counter() - t0)
    return step.result()


def _step_on(torch, device, params, cfg, batch, dtype=None, seed=0,
             specaugment=False):
    """One train step from ``params`` on ``device`` (in ``dtype``, default
    float32; dropout masks, and SpecAugment's with ``specaugment``, from
    ``seed``); returns (loss, {leaf path: gradient on the CPU in
    float64})."""
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
                         b.tgt_mask, specaugment=specaugment)
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


def f32_noise_ratios(torch, grads_dev, grads_cpu, grads_ulp, grads_f32=None):
    """Per leaf: the card's distance from the CPU step, the CPU's own noise
    (its step with the weights one ulp off, at least NOISE_FLOOR; with
    ``grads_f32``, the CPU's float32 step where ``grads_cpu`` is its
    float64 one, at least that step's distance from it), both over the
    leaf's largest entry, and their ratio."""
    out = {}
    for k in grads_cpu:
        err = _rel_err(grads_dev[k], grads_cpu[k])
        noise = max(_rel_err(grads_ulp[k], grads_cpu[k]), NOISE_FLOOR)
        if grads_f32 is not None:
            noise = max(noise, _rel_err(grads_f32[k], grads_cpu[k]))
        out[k] = (err, noise, err / noise)
    return out


def card_vs_cpu_step(torch, device, params, cfg, batch, seed=0,
                     specaugment=False, step_on=_step_on, cpu_dtype=None):
    """One train step (``step_on``, by default the acoustic model's, with
    SpecAugment where ``specaugment``) on ``device`` and on the CPU from
    the same parameters and batch (the dropout and SpecAugment masks are
    the same on both).  ``cpu_dtype`` float64 takes the CPU's steps in
    float64, for models whose float32 gradients are long sums that cancel
    (the tdnnf's, PERF.md §6): the card is held to the
    exact step, and an ill-conditioned leaf's noise is also the CPU's own
    float32 step's distance from it (float32's summation error, which the
    one-ulp step, summing in the same order, does not show).  The loss must
    agree within STEP_LOSS_RTOL and every gradient leaf within
    STEP_GRAD_RTOL of its largest entry.  A leaf whose float32 gradient is
    ill-conditioned (a sum over tens of thousands of frames that cancels)
    differs by more between any two float32 summation orders; where a leaf
    is over, the CPU step runs again with every weight one float32 ulp off
    (``one_ulp_off``), and the card may be at most F32_NOISE_RATIO times
    that step's distance from the CPU's (``f32_noise_ratios``).  Returns
    the numbers."""
    kw = dict(specaugment=specaugment) if specaugment else {}
    ref = dict(kw, dtype=cpu_dtype) if cpu_dtype else kw
    loss_dev, grads_dev = step_on(torch, device, params, cfg, batch,
                                  seed=seed, **kw)
    t0 = time.perf_counter()
    cached = seed == 0 and step_on is _step_on
    loss_cpu, grads_cpu = (
        cpu_step(torch, params, cfg, batch, **ref) if cached
        else step_on(torch, "cpu", params, cfg, batch, seed=seed, **ref))
    cpu_s = time.perf_counter() - t0
    if not cached:
        cpu_reference_done(f"card_vs_cpu_step {step_on.__name__} seed "
                           f"{seed}", cpu_s)
    loss_err = abs(loss_dev - loss_cpu) / abs(loss_cpu)
    errs = {k: _rel_err(grads_dev[k], grads_cpu[k]) for k in grads_cpu}
    worst = max(errs, key=errs.get)
    out = {"cpu_dtype": str(cpu_dtype or torch.float32),
           "loss": loss_dev, "loss_cpu": loss_cpu, "loss_rel_err": loss_err,
           "grad_rel_err": errs[worst], "worst_leaf": str(worst),
           "cpu_step_s": cpu_s, "noise_checks": {}}
    if loss_err > STEP_LOSS_RTOL:
        raise AssertionError(f"train step {device} vs cpu: loss {loss_err}")
    over = [k for k, e in errs.items() if e > STEP_GRAD_RTOL]
    if over:
        t0 = time.perf_counter()
        _, grads_ulp = (
            cpu_step(torch, one_ulp_off(torch, params), cfg, batch, **ref)
            if cached else step_on(torch, "cpu", one_ulp_off(torch, params),
                                   cfg, batch, seed=seed, **ref))
        if not cached:
            cpu_reference_done(f"card_vs_cpu_step {step_on.__name__} one "
                               f"ulp off", time.perf_counter() - t0)
        grads_f32 = (cpu_step(torch, params, cfg, batch, **kw)[1]
                     if cpu_dtype and step_on is _step_on else None)
        ratios = f32_noise_ratios(torch, grads_dev, grads_cpu, grads_ulp,
                                  grads_f32)
        for k in over:
            err, noise, ratio = ratios[k]
            out["noise_checks"][str(k)] = {"card_vs_cpu": err,
                                           "cpu_noise": noise,
                                           "ratio": ratio}
            if grads_f32 is not None:
                out["noise_checks"][str(k)]["cpu_float32_vs_cpu"] = \
                    _rel_err(grads_f32[k], grads_cpu[k])
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


def train_setup(torch, corpus, work, model_args=None, utts=None):
    """run_train's inputs, made anew in ``work``: the train/dev/test data
    dirs, the vocabulary, model.init and, where the recipe streams them,
    the archives.  Returns (dirs, vocab, model, frames, the train CLI's
    archive flags)."""
    from pytorch_kaldi_asr_tpu_torch.io import kaldi_io
    from pytorch_kaldi_asr_tpu_torch.recipes import generate_archive

    spec = corpus["train"]
    if work.exists():
        shutil.rmtree(work)
    dirs = {name: work / name for name in utts or spec["utts"]}
    frames = {name: write_data_dir(dirs[name], kaldi_io, torch, corpus, n,
                                   seed=i + 1)
              for i, (name, n) in enumerate((utts or spec["utts"]).items())}
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
    return dirs, vocab, model, frames, archive_args


def step_batches(dirs, vocab, archive_args, batch, cpu_rows):
    """The first training batch and its first ``cpu_rows`` rows (all with
    None): the batch the train step is timed on, and the card-vs-CPU
    step's."""
    from pytorch_kaldi_asr_tpu_torch.data import read_vocab
    from pytorch_kaldi_asr_tpu_torch.data.archive import ArchiveBatchLoader
    from pytorch_kaldi_asr_tpu_torch.data.loader import make_batch_loader

    if archive_args:
        loader = ArchiveBatchLoader(archive_args[1], batch, mode="drop")
    else:
        loader = make_batch_loader(str(dirs["train"]), read_vocab(str(vocab)),
                                   batch, mode="drop")
    first = next(iter(loader))
    rows = cpu_rows or batch
    return first, type(first)(*(x[:rows] for x in first))


# the training paths whose CPU reference steps are taken while the kernels
# build: TIMIT's (its step and, for its leaf at its noise, NOISY_LEAF, its
# one-ulp step) and the conformer's three, about 95 s of the build's
# 120-126 s on the H100 host (PERF.md §4)
PREFETCHED = (TIMIT, LIBRISPEECH, LIBRISPEECH_BF16, LIBRISPEECH_BF16_COMPUTE)


def prefetch_cpu_steps(torch):
    """The CPU reference steps of the PREFETCHED training paths, taken
    while the kernels build (``cpu_step`` keeps them by a hash of the
    weights and the batch, so a path finds its step taken; inputs that
    came out otherwise would only be taken again).  Each path's inputs are
    made as run_train makes them, under ``WORK/prefetch``.  A failure here
    is printed and left to the path itself."""
    from pytorch_kaldi_asr_tpu_torch.train import load_checkpoint

    for corpus in PREFETCHED:
        try:
            spec = corpus["train"]
            dirs, vocab, model, _, archive_args = train_setup(
                torch, corpus, WORK / "prefetch" / corpus["name"])
            ckpt = load_checkpoint(str(model))
            params, cfg = ckpt["params"], ckpt["cfg"]
            _, rows = step_batches(dirs, vocab, archive_args, spec["batch"],
                                   spec["cpu_rows"])
            cpu_step(torch, params, cfg, rows)
            if "bfloat16" in (cfg.conformer_stream_dtype, cfg.compute_dtype):
                cpu_step(torch, params, own_error_config(cfg), rows)
            if corpus is TIMIT:
                cpu_step(torch, one_ulp_off(torch, params), cfg, rows)
        except Exception as e:  # noqa: BLE001 — the path takes it again
            print(f"prefetch of {corpus['name']}'s CPU steps failed: "
                  f"{e!r}")


@contextlib.contextmanager
def first_plain_k3(torch, fd):
    """The plain K3 as it was first written (tests/torch_k3_reference.py:
    Philox products from 16-bit halves, no pass of the CPU's counters, the
    mask drawn again backward) in place of the current one, for a timing
    beside it."""
    import importlib.util

    path = REPO / "tests" / "torch_k3_reference.py"
    spec = importlib.util.spec_from_file_location("torch_k3_reference", path)
    first = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(first)
    saved = fd.dropout_bits, fd.fused_dropout_reference, fd._MaskedDropout

    class Redraw(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, seed, threshold, scale):
            ctx.args = (seed, threshold, scale)
            return first.fused_dropout_reference(x, seed, threshold, scale)

        @staticmethod
        def backward(ctx, g):
            return (first.fused_dropout_reference(g, *ctx.args), None, None,
                    None)

    fd.dropout_bits = first.dropout_bits
    fd.fused_dropout_reference = first.fused_dropout_reference
    fd._MaskedDropout = Redraw
    try:
        yield
    finally:
        fd.dropout_bits, fd.fused_dropout_reference, fd._MaskedDropout = saved


def time_plain_k3_cpu(torch, fd, shape=(50400, 256), rounds=3):
    """The plain K3's forward and backward on a CPU tensor of ``shape``
    (the TIMIT encoder's dropout sites at batch 100), the current version
    and the first (``first_plain_k3``) alternated: the median ms of each."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(shape, generator=g).requires_grad_()
    dout = torch.randn(shape, generator=g)
    threshold = fd.fused_dropout_threshold(0.35)

    def once():
        t0 = time.perf_counter()
        fd.masked_dropout(x, 11, threshold, 1 / 0.65).backward(dout)
        x.grad = None
        return 1000 * (time.perf_counter() - t0)

    times = {"ms": [], "first_ms": []}
    once()
    for _ in range(rounds):
        times["ms"].append(once())
        with first_plain_k3(torch, fd):
            times["first_ms"].append(once())
    return {"shape": list(shape), "threads": torch.get_num_threads(),
            **{k: statistics.median(v) for k, v in times.items()}}


def k3_plain_readings(torch, rounds=2):
    """On this host's CPU: the plain K3 alone (``time_plain_k3_cpu``), and
    the TIMIT train step's CPU reference (``_step_on`` at batch 100, the
    recipe's dropout) with the current plain K3 and with the first,
    alternated after one step of each to warm up, and a torch.profiler
    table of its busiest operations with the current one."""
    from pytorch_kaldi_asr_tpu_torch.ops import fused_dropout as fd
    from pytorch_kaldi_asr_tpu_torch.train import load_checkpoint

    out = {"k3": time_plain_k3_cpu(torch, fd)}
    dirs, vocab, model, _, archive_args = train_setup(
        torch, TIMIT, WORK / "k3_plain")
    ckpt = load_checkpoint(str(model))
    _, rows = step_batches(dirs, vocab, archive_args, TIMIT["train"]["batch"],
                           None)

    def step():
        t0 = time.perf_counter()
        _step_on(torch, "cpu", ckpt["params"], ckpt["cfg"], rows)
        return time.perf_counter() - t0

    steps = {"s": [], "first_s": []}
    out["warm_up_s"] = step()
    with first_plain_k3(torch, fd):
        out["first_warm_up_s"] = step()
    for _ in range(rounds):
        steps["s"].append(step())
        with first_plain_k3(torch, fd):
            steps["first_s"].append(step())
    out["timit_step"] = steps
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step()
    out["profile_top"] = [
        [e.key, e.count, e.self_cpu_time_total / 1000.0]
        for e in sorted(prof.key_averages(),
                        key=lambda e: -e.self_cpu_time_total)[:12]]
    return out


def run_train(torch, corpus=TIMIT, device="cuda", model_args=None, utts=None,
              batch=None):
    """Stages 3-4 of ``corpus``'s recipe with the port on ``device``:
    initialize, pack archives where the recipe streams them, train (ending
    in combine), the standalone combine; then one train step at the
    recipe's dropout on the card and on the CPU, and the step's time and
    profile.  Returns the run's numbers; ``launches`` are those of the train
    and combine CLIs."""
    from pytorch_kaldi_asr_tpu_torch.data.loader import to_device
    from pytorch_kaldi_asr_tpu_torch.models.transformer import tree_map
    from pytorch_kaldi_asr_tpu_torch.recipes import combine, train
    from pytorch_kaldi_asr_tpu_torch.train import (
        create_train_state,
        load_checkpoint,
        train_step,
    )

    spec = corpus["train"]
    utts, batch = utts or spec["utts"], batch or spec["batch"]
    epochs = spec["epochs"]
    specaugment = spec.get("specaugment", False)
    work = WORK / corpus["name"] / "train"
    dirs, vocab, model, frames, archive_args = train_setup(
        torch, corpus, work, model_args, utts)
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
        "-optim_soft_coefficient", "25000", "-device", device,
        *(["-specaugment"] if specaugment else [])])
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
    phase_s = {"train_cli": train_s,
               "combine_cli": time.perf_counter() - t0 - train_s}

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
    first, rows_of_first = step_batches(dirs, vocab, archive_args, batch,
                                        spec["cpu_rows"])
    t0 = time.perf_counter()
    rows = spec["cpu_rows"] or batch
    cfg = ckpt["cfg"]
    if "bfloat16" in (cfg.conformer_stream_dtype, cfg.compute_dtype):
        check = bf16_card_vs_cpu_step(torch, device, ckpt["params"],
                                      ckpt["cfg"], rows_of_first)
    else:
        check = card_vs_cpu_step(
            torch, device, ckpt["params"], ckpt["cfg"], rows_of_first,
            specaugment=specaugment,
            cpu_dtype=getattr(torch, spec.get("cpu_dtype", "float32")))
    print(f"{corpus['name']}: one train step of {rows} utterances at dropout "
          f"{ckpt['cfg'].en_dropout}/{ckpt['cfg'].de_dropout}"
          f"{', SpecAugment on' if specaugment else ''}, {device} vs "
          f"cpu: " + json.dumps(check))

    phase_s["card_vs_cpu_step"] = time.perf_counter() - t0

    # the train step's time at the recipe's dropout, on one full batch
    t0 = time.perf_counter()
    state = create_train_state(tree_map(
        lambda t: t.detach().to(device, copy=True), ckpt["params"]))
    b = to_device(first, device)

    def step():
        train_step(state, ckpt["cfg"], b.src, b.src_mask, b.tgt, b.tgt_mask,
                   specaugment=specaugment)

    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    [step_ms] = time_steps(step, sync, n_steps=spec.get("timed_steps", 10))
    peak_gb = (torch.cuda.max_memory_allocated() / 1e9 if device == "cuda"
               else None)
    phase_s["timed_steps"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    profile = (profile_steps(torch, step, n=spec.get("profiled_steps", 3))
               if device == "cuda" else None)
    if profile is not None:
        check_profile_kernels(profile, cfg)
    phase_s["profile"] = time.perf_counter() - t0
    batch_frames = int(first.src_mask.sum())
    return {
        "corpus": corpus["name"], "utterances": utts, "frames": frames,
        "train_steps": records[-1]["step"], "train_cli_s": train_s,
        "metrics": records, "checkpoints": names, "launches": launches,
        "dropout_sites": dropout_sites(ckpt["cfg"]),
        "compute_dtype": ckpt["cfg"].compute_dtype,
        "specaugment": specaugment,
        "en_layers": ckpt["cfg"].en_layers,
        "encoder_type": ckpt["cfg"].encoder_type, "step_ms": step_ms,
        "step_frames": batch_frames,
        "step_padded_frames": int(first.src_mask.size),
        "frames_per_s": batch_frames / step_ms * 1e3,
        "peak_memory_gb": peak_gb, "card_vs_cpu_rows": rows,
        "card_vs_cpu_step": check, "step_profile": profile,
        "phase_s": phase_s,
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


# ---------------------------------------------------------------------------
# the TIMIT recipe's other switches: SpecAugment, the neural LM, fusion, int8
# ---------------------------------------------------------------------------


def check_step_launches(what, launches, want):
    """Every wrapper's count in ``launches`` equals ``want``'s (absent:
    0)."""
    for name, n in launches.items():
        if n != want.get(name, 0):
            raise AssertionError(f"{what}: {name} launched {n} times, "
                                 f"expected {want.get(name, 0)}")


def run_specaugment_step(torch, corpus=TIMIT, device="cuda", rows=20):
    """One banded TIMIT train step with SpecAugment on, card against CPU
    (``card_vs_cpu_step``: the masks are the same on both), from run_train's
    model.init and the first ``rows`` utterances of its first batch (the
    CPU's step at batch 100 and its one-ulp twin took 46 s); the card's
    step alone launches K2a, K2b and K2c once per encoder layer and K3 once
    per dropout site each way."""
    from pytorch_kaldi_asr_tpu_torch.data import read_vocab
    from pytorch_kaldi_asr_tpu_torch.data.loader import make_batch_loader
    from pytorch_kaldi_asr_tpu_torch.train import load_checkpoint

    work = WORK / corpus["name"] / "train"
    ckpt = load_checkpoint(str(work / "model.init"))
    cfg = ckpt["cfg"]
    loader = make_batch_loader(str(work / "train"),
                               read_vocab(str(work / "train" / "vocab.txt")),
                               corpus["train"]["batch"], mode="drop")
    first = next(iter(loader))
    first = type(first)(*(x[:rows] for x in first))
    reset_launch_counts()
    check = card_vs_cpu_step(torch, device, ckpt["params"], cfg, first,
                             specaugment=True)
    launches = launch_counts()
    sites = dropout_sites(cfg)["float32"]
    if device == "cuda":
        check_step_launches(f"{corpus['name']} step with SpecAugment",
                            launches, {
                                "banded_attention_fwd": cfg.en_layers,
                                "banded_attention_dq": cfg.en_layers,
                                "banded_attention_dkv": cfg.en_layers,
                                "fused_dropout_forward": sites,
                                "fused_dropout_backward": sites})
    print(f"{corpus['name']}: one train step with SpecAugment, {device} vs "
          f"cpu: " + json.dumps(check))
    return {"corpus": corpus["name"], "launches": launches,
            "card_vs_cpu_step": check}


def _nlm_step_on(torch, device, params, cfg, batch, seed=0):
    """One ``train_nlm`` step of the LM from ``params`` on ``device`` over
    ``batch`` = (tokens, mask) numpy rows; returns (mean per-token loss,
    {leaf path: gradient on the CPU in float64})."""
    from pytorch_kaldi_asr_tpu_torch.models.transformer import tree_map
    from pytorch_kaldi_asr_tpu_torch.recipes.train_nlm import nlm_train_step
    from pytorch_kaldi_asr_tpu_torch.train import create_train_state
    from pytorch_kaldi_asr_tpu_torch.train.optim import named_leaves

    state = create_train_state(
        tree_map(lambda t: t.detach().to(device, copy=True), params),
        seed=seed)
    toks, mask = (torch.from_numpy(x).to(device) for x in batch)
    loss, _, n = nlm_train_step(state, cfg, toks.long(), mask)
    return (float(loss / n),
            {path: p.grad.cpu().double()
             for path, p in named_leaves(state.params)})


def run_nlm(torch, decoded, device="cuda"):
    """Stage 2's ``train_nlm`` (NLM's flags) on the TIMIT training
    transcripts with K3's launches exact, one LM step card against CPU, the
    step's time and profile, and ``score_lm -nlm_model_dir`` on the n-best
    file ``decoded``, card against CPU within NLM_SCORE_ATOL."""
    import numpy as np

    from pytorch_kaldi_asr_tpu_torch.data import read_vocab
    from pytorch_kaldi_asr_tpu_torch.models.nlm import (
        encode_sentences,
        load_nlm,
    )
    from pytorch_kaldi_asr_tpu_torch.models.transformer import tree_map
    from pytorch_kaldi_asr_tpu_torch.recipes import score_lm, train_nlm
    from pytorch_kaldi_asr_tpu_torch.train import create_train_state

    work = WORK / "nlm"
    if work.exists():
        shutil.rmtree(work)
    data = WORK / TIMIT["name"] / "train" / "train"
    text, vocab = data / "text", data / "vocab.txt"
    sync = _sync(torch, device)
    reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    train_nlm.main(["-text", str(text), "-read_vocab_file", str(vocab),
                    "-save_model_dir", str(work / "nlm"), "-max_len",
                    str(NLM["max_len"]), "-epoch", str(NLM["epochs"]),
                    "-batch_size", str(NLM["batch"]), "-device", device])
    sync()
    train_s = time.perf_counter() - t0
    launches = launch_counts()
    params, cfg, meta = load_nlm(str(work / "nlm"))
    sentences = train_nlm.read_sentences(str(text))
    steps = NLM["epochs"] * max(1, len(sentences) // NLM["batch"])
    sites = 2 + 3 * cfg.de_layers  # embeddings, per layer 3, the output
    if meta["step"] != steps:
        raise AssertionError(f"train_nlm took {meta['step']} steps, "
                             f"expected {steps}")
    if device == "cuda":
        check_step_launches("train_nlm", launches, {
            "fused_dropout_forward": sites * steps,
            "fused_dropout_backward": sites * steps})

    batch = encode_sentences(sentences[:NLM["batch"]], read_vocab(str(vocab)),
                             NLM["max_len"])
    check = card_vs_cpu_step(torch, device, params, cfg, batch,
                             step_on=_nlm_step_on)
    print(f"nlm: one train_nlm step of {NLM['batch']} sentences at dropout "
          f"{cfg.de_dropout}, {device} vs cpu: " + json.dumps(check))

    state = create_train_state(tree_map(
        lambda t: t.detach().to(device, copy=True), params))
    toks, mask = (torch.from_numpy(x).to(device) for x in batch)

    def step():
        train_nlm.nlm_train_step(state, cfg, toks.long(), mask)

    [step_ms] = time_steps(step, sync)
    profile = profile_steps(torch, step) if device == "cuda" else None

    scores = {}
    for where in (device, "cpu"):
        out = work / f"nlm_score_{where}.txt"
        t0 = time.perf_counter()
        score_lm.main(["-decode_file", str(decoded), "-nlm_model_dir",
                       str(work / "nlm"), "-read_vocab_file", str(vocab),
                       "-save_score_file", str(out), "-device", where])
        if where == "cpu":
            cpu_reference_done("nlm score_lm", time.perf_counter() - t0)
        scores[where] = np.loadtxt(out)
    score_err = float(np.abs(scores[device] - scores["cpu"]).max())
    if not np.isfinite(scores[device]).all() or score_err > NLM_SCORE_ATOL:
        raise AssertionError(f"score_lm -nlm_model_dir: card vs cpu "
                             f"{score_err} (limit {NLM_SCORE_ATOL})")
    out = {"corpus": "nlm", "model": str(work / "nlm"), "train_cli_s": train_s,
           "train_steps": steps, "dropout_sites": sites, "launches": launches,
           "card_vs_cpu_step": check, "step_ms": step_ms,
           "step_tokens": int(batch[1].sum()), "step_profile": profile,
           "score_lm_lines": int(scores[device].size),
           "score_lm_card_vs_cpu": score_err}
    print(f"nlm: train_nlm {steps} steps in {train_s:.2f} s; step {step_ms:.3f}"
          " ms" + (f", {profile['device_ms_per_step']:.2f} ms of device time, "
                   f"idle share {profile['idle_share']:.3f}, "
                   f"{profile['kernels_per_step']:.0f} kernels; top kernels "
                   + json.dumps(profile["top_kernels_ms_per_step"][:5])
                   if profile else ""))
    return out


def run_lm_decodes(torch, decoded, nlm_dir, device="cuda"):
    """The banded TIMIT decode of run_slice (``decoded``, its summary) with
    the neural LM fused at NLM's weight, with int8 weights, and with both;
    each's first batch again on the CPU (``compare_nbest``, deferred to the
    side thread: ``defer_side_check``).  On the card,
    ``-lm_weight 0`` writes the unfused decode's lines exactly (tokens and
    scores bit-equal).  Records each decode's RTF, its time split, its K1
    launches, its peak device memory and the parameter bytes of the float32
    and int8 trees."""
    from pytorch_kaldi_asr_tpu_torch.models.nlm import load_nlm
    from pytorch_kaldi_asr_tpu_torch.ops.quant import quantize_tree, tree_bytes
    from pytorch_kaldi_asr_tpu_torch.recipes import decode
    from pytorch_kaldi_asr_tpu_torch.train import load_checkpoint

    spec = TIMIT["decode"]
    work = WORK / TIMIT["name"] / "decode"
    data, model = work / "data", Path(decoded["model"])
    vocab = data / "vocab.txt"
    en_layers = load_checkpoint(str(model))["cfg"].en_layers
    fused = ["-nlm_model_dir", str(nlm_dir), "-lm_weight"]
    variants = {"unfused": [], "lm_weight_0": fused + ["0"],
                "fused": fused + [str(NLM["lm_weight"])],
                "int8": ["-quantize_weights"],
                "fused_int8": fused + [str(NLM["lm_weight"]),
                                       "-quantize_weights"]}
    sync = _sync(torch, device)
    audio_s = decoded["frames"] * 0.010
    out = {}
    for name, extra in variants.items():
        path = work / f"decode_{name}.txt"
        reset_launch_counts()
        if device == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        split = {}
        sync()
        t0 = time.perf_counter()
        decode.main(stage5_args(spec, data, vocab, model, path, device)
                    + extra, timings=split)
        sync()
        decode_s = time.perf_counter() - t0
        split["other_s"] = decode_s - sum(split.values())
        launches = launch_counts()
        if device == "cuda":
            check_step_launches(f"{name} decode", launches, {
                "banded_attention": en_layers * decoded["batches"]})
        row = {"decode_s": decode_s, "rtf": decode_s / audio_s,
               "time_split_s": split, "launches": launches,
               "peak_memory_gb": (torch.cuda.max_memory_allocated() / 1e9
                                  if device == "cuda" else None)}
        gpu = read_nbest(path)
        if len(gpu) != spec["utts"]:
            raise AssertionError(f"{name} decode: {len(gpu)} utterances")
        if name in ("fused", "int8", "fused_int8"):
            def cpu_cross_check(name=name, extra=extra, gpu=gpu):
                cpu_path = work / f"decode_{name}_cpu.txt"
                decode.main(stage5_args(spec, work / "data_first_batch",
                                        vocab, model, cpu_path, "cpu")
                            + extra)
                cpu = read_nbest(cpu_path)
                if sorted(cpu) != sorted(decoded["first_batch_keys"]):
                    raise AssertionError("the CPU decode covered other "
                                         "utterances")
                return compare_nbest(gpu, cpu)

            defer_side_check(f"timit {name} decode, first batch",
                             cpu_cross_check)
            row["cpu_vs_card_max_score_err"] = "on the side thread"
        out[name] = row
        print(f"timit {name} decode: RTF {row['rtf']:.4f}, "
              + json.dumps(row))
    same = (work / "decode_lm_weight_0.txt").read_text() == \
        (work / "decode_unfused.txt").read_text()
    if device == "cuda" and not same:
        raise AssertionError("-lm_weight 0 did not write the unfused "
                             "decode's lines exactly")
    if (work / "decode_fused.txt").read_text() == \
            (work / "decode_unfused.txt").read_text():
        raise AssertionError("the fused decode wrote the unfused lines")
    params = load_checkpoint(str(model))["params"]
    lm, _, _ = load_nlm(str(nlm_dir))
    out["param_bytes"] = {
        "am_float32": tree_bytes(params),
        "am_int8": tree_bytes(quantize_tree(params)[0]),
        "lm_float32": tree_bytes(lm), "lm_int8": tree_bytes(
            quantize_tree(lm)[0])}
    out["lm_weight_0_equals_unfused"] = same
    print("timit decodes with the LM and int8: parameter bytes "
          + json.dumps(out["param_bytes"]) + "; peak memory (GB) "
          + json.dumps({k: v["peak_memory_gb"] for k, v in out.items()
                        if isinstance(v, dict) and "peak_memory_gb" in v}))
    return out


def check_profile_kernels(profile, cfg):
    """A profiled train step of ``cfg`` ran the attention kernels of its
    compute dtype, and none of the other: on bfloat16 compute the bfloat16
    K2a-c and no float32 fwd_kernel, dq_kernel or dkv_kernel (the tdnn,
    tdnnf and blstm encoders have no attention kernel)."""
    ours = profile["port_kernels_ms_and_launches_per_step"]
    bf16 = cfg.compute_dtype == "bfloat16"
    want = ("_bf16", "") if bf16 else ("", "_bf16")
    for kernel in ("K2a", "K2b", "K2c"):
        ran, other = (ours[kernel + sfx][1] for sfx in want)
        if other or (cfg.encoder_type in ATTENDING and not ran):
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

    def steps():
        for _ in range(n):
            step()

    events, wall_ms, attempts = _profile(torch, steps)
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
        "profile_attempts": attempts,
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


def spliced_precision(torch, encoder):
    """``--spliced-precision``: one train step (dropout 0, SpecAugment on)
    of the TIMIT-width ``encoder`` (tdnn or tdnnf) on run_train's first
    batch (100 utterances), its spliced products through cuDNN's
    convolution (``common.spliced_linear``, the tdnn's route) and through
    splice then matmul (the tdnnf's), each on the card, again (the card's
    reductions are not all deterministic), with cuDNN's deterministic
    algorithms, and on the CPU in float32, against the CPU's float64 step:
    per route the loss's and the largest leaf's distance (``_rel_err``)
    from it, over the encoder's leaves and the decoder's.  About a minute,
    most of it the CPU's."""
    from pytorch_kaldi_asr_tpu_torch.data import read_vocab
    from pytorch_kaldi_asr_tpu_torch.data.loader import make_batch_loader
    from pytorch_kaldi_asr_tpu_torch.io import kaldi_io
    from pytorch_kaldi_asr_tpu_torch.models import common, encoders
    from pytorch_kaldi_asr_tpu_torch.train import load_checkpoint

    work = WORK / f"spliced_precision_{encoder}"
    if work.exists():
        shutil.rmtree(work)
    data = work / "train"
    write_data_dir(data, kaldi_io, torch, TIMIT, TIMIT["train"]["utts"]
                   ["train"], seed=1)
    model = [{"0.35": "0.0", "banded": encoder}.get(x, x)
             for x in RECIPE_MODEL]
    initialize(TIMIT, data / "feats.scp", data / "vocab.txt",
               work / "model.init", model)
    ckpt = load_checkpoint(str(work / "model.init"))
    batch = next(iter(make_batch_loader(
        str(data), read_vocab(str(data / "vocab.txt")),
        TIMIT["train"]["batch"], mode="drop")))

    def step(device, dtype=None):
        return _step_on(torch, device, ckpt["params"], ckpt["cfg"], batch,
                        dtype=dtype, specaugment=True)

    def conv_product(h, w, b, dtype=None):  # the tdnnf's through the conv
        if isinstance(h, tuple):
            return common.spliced_linear(h[0], w, b, h[1], dtype)
        return common.linear(h, w, b, dtype)

    def matmul_product(x, w, b, context, dtype=None):  # the tdnn's
        return common.linear(common.splice_frames(x, context), w, b, dtype)

    other = ({"splice_frames": lambda x, context: (x, context),
              "linear": conv_product} if encoder == "tdnnf"
             else {"spliced_linear": matmul_product})
    module = encoders if encoder == "tdnnf" else common

    @contextlib.contextmanager
    def route(name):
        """The model's own route, or the other one patched in."""
        if name == ("matmul" if encoder == "tdnnf" else "conv"):
            yield
            return
        kept = {k: getattr(module, k) for k in other}
        for k, fn in other.items():
            setattr(module, k, fn)
        try:
            yield
        finally:
            for k, fn in kept.items():
                setattr(module, k, fn)

    ref_loss, ref = step("cpu", torch.float64)
    runs = {}
    for name in ("conv", "matmul"):
        with route(name):
            runs[f"{name}_card"] = step("cuda")
            runs[f"{name}_card_again"] = step("cuda")
            torch.backends.cudnn.deterministic = True
            try:
                runs[f"{name}_card_deterministic"] = step("cuda")
            finally:
                torch.backends.cudnn.deterministic = False
            runs[f"{name}_cpu"] = step("cpu")
    out = {}
    for name, (loss, grads) in runs.items():
        errs = {k: _rel_err(grads[k], ref[k]) for k in ref}
        enc = {k: v for k, v in errs.items() if k[0] == "encoder"}
        dec = {k: v for k, v in errs.items() if k[0] == "decoder"}
        out[name] = {
            "loss": abs(loss - ref_loss) / abs(ref_loss),
            "encoder_max": max(enc.values()),
            "encoder_worst": str(max(enc, key=enc.get)),
            "decoder_max": max(dec.values()),
            "decoder_worst": str(max(dec, key=dec.get))}
    return out


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


# ---------------------------------------------------------------------------
# the recipe phase: fbank on the card, the float32 tdnn decode, and the
# TIMIT port recipe's run.sh end to end
# ---------------------------------------------------------------------------

# 16 seeded WAVs of 1.5-5 s at 16 kHz through the fbank CLI
FBANK = {"utts": 16, "seconds": (1.5, 5.0), "rate": 16000}
# card vs CPU: the CPU-vs-JAX limits of tests/test_torch_fbank.py
FBANK_ATOL = {"fbank": 1e-4, "mfcc": 5e-4}
# the float32 tdnn decode's encoder output, card vs CPU, over its largest
# entry (the decode's n-best at CPU_SCORE_ATOL, as every float32 decode)
ENCODER_RTOL = 1e-4
# run.sh's default encoder (the tdnn), float32, at the TIMIT widths
TIMIT_TDNN = dict(TIMIT, name="timit_tdnn",
                  model=[x if x != "banded" else "tdnn"
                         for x in RECIPE_MODEL], check_encoder=True)
RECIPE_SH = "recipes/attention-transformer-timit-cuda/run.sh"
# its knobs, the rest at run.sh's defaults (3 + 3 layers, 2 heads, d_model
# 256/128, d_k = d_v = 64, dropout 0.35, band (-100, 0), batch_size 100,
# beam_size 25, nbest 10, decode_batch 8, max_token_seq_len 100)
RECIPE_KNOBS = {"device": "cuda", "encoder_type": "banded", "cmvn": "true",
                "nlm_rescore": "true", "nlm_epochs": "1", "epochs": "2",
                "model_dir": "exp/model"}
# run.sh's decode knobs at their defaults, for the CPU cross-check
RECIPE_DECODE = {"decode_batch": "8", "beam_size": "25", "nbest": "10",
                 "max_token_seq_len": "100"}
# make_timit_shaped's -scale: 369/38/19 utterances (TIMIT's 3696/384/192)
RECIPE_SCALE = "0.1"
# the lines run.sh echoes as each stage starts
STAGE_LINES = {"0": "[PROCEDURE] preparing instances.",
               "1": "[PROCEDURE] preparing vocabulary for output label",
               "2": "[PROCEDURE] preparing language model (arpa).",
               "3": "[PROCEDURE] reading dimension from data file and "
                    "initialize the model",
               "4": "[PROCEDURE] trainning start... log is in train.log",
               "5": "[PROCEDURE] decoding dev set..."}
def run_fbank(torch, device="cuda"):
    """The port's fbank CLI (``tools.fbank``) on FBANK's seeded WAVs, log-mel
    and MFCC, on ``device`` twice (the first call sets up cuFFT) and on the
    CPU: the device within FBANK_ATOL of the CPU, and the seconds of audio
    per wall second of each run."""
    import numpy as np

    from pytorch_kaldi_asr_tpu_torch.io import kaldi_io
    from pytorch_kaldi_asr_tpu_torch.tools import fbank, wav

    work = WORK / "fbank"
    if work.exists():
        shutil.rmtree(work)
    work.mkdir(parents=True)
    rng = np.random.default_rng(SEED)
    audio_s, lines = 0.0, []
    for u in range(FBANK["utts"]):
        n = int(FBANK["rate"] * rng.uniform(*FBANK["seconds"]))
        x = rng.normal(scale=rng.uniform(100, 3000), size=n)
        if u == 0:
            x[: n // 3] = 0.0  # digital silence: the log's floor
        wav.write_wav(str(work / f"u{u:02d}.wav"), x, FBANK["rate"])
        lines.append(f"u{u:02d} {work / f'u{u:02d}.wav'}\n")
        audio_s += n / FBANK["rate"]
    (work / "wav.scp").write_text("".join(lines))
    out = {"utterances": FBANK["utts"], "audio_s": audio_s}
    for kind in ("fbank", "mfcc"):
        feats, rates = {}, {}
        for run in (f"{device}_1", f"{device}_2", "cpu"):
            target = work / f"{kind}_{run}"
            t0 = time.perf_counter()
            fbank.main([*(["--mfcc"] if kind == "mfcc" else []),
                        f"--device={run.split('_')[0]}",
                        f"scp:{work / 'wav.scp'}",
                        f"ark,scp:{target}.ark,{target}.scp"])
            rates[run] = audio_s / (time.perf_counter() - t0)
            if run == "cpu":
                cpu_reference_done(f"fbank {kind}",
                                   time.perf_counter() - t0)
            feats[run] = dict(kaldi_io.read_mat_scp(f"{target}.scp"))
        err = max(float(np.abs(feats[f"{device}_2"][k] - feats["cpu"][k])
                        .max()) for k in feats["cpu"])
        again = max(float(np.abs(feats[f"{device}_2"][k]
                                 - feats[f"{device}_1"][k]).max())
                    for k in feats["cpu"])
        if err > FBANK_ATOL[kind] or again:
            raise AssertionError(f"fbank --{kind}: card vs CPU {err} "
                                 f"(limit {FBANK_ATOL[kind]}), card vs card "
                                 f"{again}")
        out[kind] = {"max_abs_err": err, "audio_s_per_s": rates,
                     "frames": sum(m.shape[0] for m in feats["cpu"].values())}
    return out


def encoder_card_vs_cpu(torch, model, data, spec, device="cuda"):
    """The first decode batch's float32 encoder output on ``device`` and on
    the CPU, over the valid frames: (largest |card - CPU|, largest
    |CPU|)."""
    from pytorch_kaldi_asr_tpu_torch.data import read_vocab
    from pytorch_kaldi_asr_tpu_torch.data.loader import make_batch_loader, to_device
    from pytorch_kaldi_asr_tpu_torch.models.transformer import encode, tree_map
    from pytorch_kaldi_asr_tpu_torch.train import load_checkpoint

    ckpt = load_checkpoint(str(model))
    params, cfg = ckpt["params"], ckpt["cfg"]
    loader = make_batch_loader(str(data), read_vocab(str(data / "vocab.txt")),
                               spec["batch"], mode="all", shuffle=False,
                               num_buckets=spec["buckets"])
    first = next(iter(loader))
    b_dev, b_cpu = to_device(first, device), to_device(first, "cpu")
    with torch.no_grad():
        enc_dev, _ = encode(tree_map(lambda t: t.to(device), params), cfg,
                            b_dev.src, b_dev.src_mask)
        enc_cpu, mask = encode(params, cfg, b_cpu.src, b_cpu.src_mask)
    keep = (mask > 0) & (b_cpu.valid[:, None] > 0)
    card, cpu = enc_dev.cpu()[keep], enc_cpu[keep]
    return float((card - cpu).abs().max()), float(cpu.abs().max())


def _trace_commands(trace):
    """(start time, command) of each command in a ``bash -x`` trace whose
    PS4 prints the time (``run_recipe``'s ``ps4.sh``)."""
    out = []
    for line in trace.splitlines():
        m = re.match(r"\++ ([0-9]+\.[0-9]+) (.*)", line)
        if m:
            out.append((float(m.group(1)), m.group(2)))
    return out


def recipe_processes(trace, end):
    """The Python processes of a traced run.sh: for each CLI module (the
    last ``-m`` of a command: a launcher's command names its job), the
    number of processes and their wall seconds (each command's start to
    the next command's)."""
    commands = _trace_commands(trace)
    procs = {}
    for i, (t, cmd) in enumerate(commands):
        if not cmd.startswith("python3 "):
            continue
        modules = re.findall(r"-m (\S+)", cmd)
        t_next = commands[i + 1][0] if i + 1 < len(commands) else end
        for n, module in enumerate(modules):
            row = procs.setdefault(module.rsplit(".", 1)[-1],
                                   {"processes": 0, "wall_s": 0.0})
            row["processes"] += 1
            if n == len(modules) - 1:  # the job's wall, not its launcher's
                row["wall_s"] += t_next - t
    return procs


def recipe_startups(texts):
    """The start-up seconds the recipe's CLIs logged (``log_startup``:
    interpreter start to ``main()``), by CLI: processes and seconds."""
    from pytorch_kaldi_asr_tpu_torch.utils.logging import STARTUP_RE

    out = {}
    for text in texts:
        for name, seconds in re.findall(STARTUP_RE, text):
            row = out.setdefault(name, {"processes": 0, "seconds": 0.0})
            row["processes"] += 1
            row["seconds"] += float(seconds)
    return out


def recipe_launches(texts):
    """The kernel launches the recipe's CLIs logged (ops/launches.py), by
    kernel, and the devices they ran on."""
    from pytorch_kaldi_asr_tpu_torch.ops.launches import LOG_RE

    total, devices = {}, set()
    for text in texts:
        for device, counts in re.findall(LOG_RE, text):
            devices.add(device)
            for name, n in json.loads(counts).items():
                total[name] = total.get(name, 0) + n
    return total, devices


def _fresh(work):
    """``work``, emptied."""
    if work.exists():
        shutil.rmtree(work)
    work.mkdir(parents=True)
    return work


def run_traced(script, work, knobs, stage_lines, on_stage=None):
    """``bash -x script`` in ``work`` with ``knobs`` in its environment, its
    trace (each command stamped with its start time by PS4) in
    ``work/trace.log`` and its output in ``work/run.log``.  Fails unless it
    exits 0 and prints each of ``stage_lines`` ({stage: the line it echoes
    as the stage starts}); ``on_stage(stage)`` is called as each starts.
    Returns (its output, the wall seconds of each stage, its start and end
    times)."""
    (work / "ps4.sh").write_text("PS4='+ $(date +%s.%N) '\n")
    env = dict(os.environ, PYTHONPATH=str(REPO), PYTHONUNBUFFERED="1",
               BASH_ENV=str(work / "ps4.sh"), **knobs)
    stage_t, lines = {}, []
    t_start = time.time()
    with open(work / "trace.log", "w") as trace:
        proc = subprocess.Popen(["bash", "-x", str(REPO / script)],
                                cwd=str(work), env=env, text=True,
                                stdout=subprocess.PIPE, stderr=trace)
        for line in proc.stdout:
            lines.append(line)
            for stage, opening in stage_lines.items():
                if line.startswith(opening) and stage not in stage_t:
                    stage_t[stage] = time.time()
                    if on_stage is not None:
                        on_stage(stage)
        code = proc.wait()
    t_end = time.time()
    stdout = "".join(lines)
    (work / "run.log").write_text(stdout)
    if code != 0:
        raise AssertionError(f"{script} exited {code}: " + stdout[-2000:]
                             + (work / "trace.log").read_text()[-2000:])
    marks = [stage_t[s] for s in sorted(stage_t)] + [t_end]
    stages_s = {s: b - a for s, a, b in zip(sorted(stage_t), marks,
                                            marks[1:])}
    if sorted(stages_s) != list(stage_lines):
        raise AssertionError(f"{script}: stages seen {sorted(stages_s)}")
    return stdout, stages_s, t_start, t_end


def run_recipe(torch, device="cuda", knobs=None, scale=RECIPE_SCALE):
    """The TIMIT port recipe's run.sh, stages 0-5, on a TIMIT-shaped corpus
    (the port's make_timit_shaped at ``scale``), with RECIPE_KNOBS (or
    ``knobs``) on ``device``; then the first decode batch of the dev set
    again on the CPU from the recipe's combined checkpoint, held against
    the recipe's decode.txt (compare_nbest).  Fails unless run.sh exits 0,
    the dev and test scoring/ and scoring_nlm/ hold %WER reports and
    result.txt a %WER line, and the train and decode logs show ``device``.
    Returns the wall seconds of each stage, the processes, the start-up
    share, the decode's RTF, the launches and the checks."""
    from pytorch_kaldi_asr_tpu_torch.data import read_vocab
    from pytorch_kaldi_asr_tpu_torch.data.loader import make_batch_loader
    from pytorch_kaldi_asr_tpu_torch.io import kaldi_io
    from pytorch_kaldi_asr_tpu_torch.recipes import decode
    from pytorch_kaldi_asr_tpu_torch.tools import make_timit_shaped

    knobs = dict(RECIPE_KNOBS, device=device, **(knobs or {}))
    work = _fresh(WORK / "recipe")
    t0 = time.perf_counter()
    make_timit_shaped.main(["-out_dir", str(work), "-scale", scale])
    corpus_s = time.perf_counter() - t0
    stdout, stages_s, t_start, t_end = run_traced(RECIPE_SH, work, knobs,
                                                  STAGE_LINES)

    model_dir = work / knobs["model_dir"]
    results = {}
    for split in ("dev", "test"):
        decode_dir = model_dir / f"decode_{split}"
        for scoring in ("scoring", "scoring_nlm"):
            reports = list((decode_dir / scoring).glob("*_wer"))
            if not reports or not all("%WER" in r.read_text()
                                      for r in reports):
                raise AssertionError(f"{decode_dir / scoring}: no %WER")
        result = (decode_dir / "result.txt").read_text()
        if "%WER" not in result:
            raise AssertionError(f"{decode_dir}/result.txt: {result!r}")
        results[split] = result.strip().splitlines()[-1]
    logs = {"train": (model_dir / "train.log").read_text(),
            **{f"decode_{s}": (model_dir / f"decode_{s}" / "decode.log")
               .read_text() for s in ("dev", "test")}}
    for name, log in logs.items():
        if f"kernel launches on {device}" not in log:
            raise AssertionError(f"the {name} log shows no {device} run")
    launches, devices = recipe_launches([stdout, *logs.values()])
    if devices != {device}:
        raise AssertionError(f"the recipe's CLIs ran on {devices}")
    metrics = [json.loads(line) for line in
               open(model_dir / "metrics.jsonl")]
    en_layers = int(knobs.get("en_layers", 3))
    if device.startswith("cuda") and not (
            all(launches[f"banded_attention_{k}"]
                == en_layers * metrics[-1]["step"]
                for k in ("fwd", "dq", "dkv"))
            and launches["banded_attention"] > 0
            and launches["fused_dropout_forward"] > 0
            and launches["fused_dropout_backward"] > 0):
        raise AssertionError(f"the recipe's kernel launches: {launches}; "
                             f"K2a-c expected {en_layers} x "
                             f"{metrics[-1]['step']} steps")

    # the first decode batch of dev again, on the CPU
    data = work / "data" / "dev_filtered"
    vocab = work / "data" / "language" / "vocab.txt"
    model = sorted(model_dir.glob("combined*"))[-1]
    flags = {k: knobs.get(k, v) for k, v in RECIPE_DECODE.items()}
    loader = make_batch_loader(str(data), read_vocab(str(vocab)),
                               int(flags["decode_batch"]), mode="all",
                               shuffle=False, num_buckets=4)
    first = next(iter(loader))
    keys = [key for key, ok in zip(first.keys, first.valid) if ok]
    sub = work / "dev_first_batch"
    sub.mkdir()
    scp = dict(kaldi_io.scp_entries(str(data / "feats.scp")))
    (sub / "feats.scp").write_text("".join(f"{k} {scp[k]}\n" for k in keys))
    (sub / "text").write_text("".join(
        line for line in open(data / "text") if line.split()[0] in keys))
    t0 = time.perf_counter()
    decode.main(["-read_data_dir", str(sub), "-read_vocab_file", str(vocab),
                 "-load_model_file", str(model), "-save_result_file",
                 str(work / "decode_cpu.txt"), "-device", "cpu",
                 "-max_token_seq_len", flags["max_token_seq_len"],
                 "-batch_size", flags["decode_batch"],
                 "-beam_size", flags["beam_size"], "-nbest", flags["nbest"]])
    cpu_s = time.perf_counter() - t0
    cpu_reference_done("recipe dev decode, first batch", cpu_s)
    score_err = compare_nbest(read_nbest(model_dir / "decode_dev"
                                         / "decode.txt"),
                              read_nbest(work / "decode_cpu.txt"))

    end = t_end - t_start
    trace = (work / "trace.log").read_text()
    procs = recipe_processes(trace, t_end)
    startup = recipe_startups([trace, *logs.values()])
    startup_total = sum(row["seconds"] for row in startup.values())
    frames = {split: sum(kaldi_io.read_key_value_text(
        str(work / "data" / f"{split}_filtered" / "feats.length"),
        int).get(k, 0) for k in kaldi_io.read_key_value_text(
            str(work / "data" / f"{split}_filtered" / "text")))
        for split in ("dev", "test")}
    decode_s = procs["decode"]["wall_s"]
    epoch_s = ([b["ts"] - a["ts"] for a, b in zip(metrics, metrics[1:])]
               if len(metrics) > 1 else [])
    return {
        "knobs": knobs, "scale": scale, "corpus_s": corpus_s,
        "utterances": {split: len((work / "data" / split / "text")
                                  .read_text().splitlines())
                       for split in ("train", "dev", "test")},
        "wall_s": end, "stages_s": stages_s, "processes": procs,
        "n_processes": sum(r["processes"] for r in procs.values()),
        "startup_s": startup, "startup_total_s": startup_total,
        "startup_processes": sum(r["processes"] for r in startup.values()),
        "startup_share": startup_total / end,
        "decode_s": decode_s,
        "decode_rtf": decode_s / (0.010 * sum(frames.values())),
        "epoch_wall_s": epoch_s, "train_steps": metrics[-1]["step"],
        "results": results, "launches": launches,
        "cpu_first_batch_s": cpu_s, "cpu_vs_card_max_score_err": score_err,
    }


# ---------------------------------------------------------------------------
# the hybrid phase: the long-form recipe (train_am, dump_posteriors,
# mkgraph, latgen, align_ctm)
# ---------------------------------------------------------------------------

HYBRID_SH = "recipes/longform-conformer-cuda/run.sh"
# its knobs: run.sh's defaults (recipes/longform-conformer/run.sh:30-49),
# 64/8/8 utterances of 80-140 words x 25 frames of 40-dim features, the
# conformer AM at 3 layers, d_model 144, 2 heads of d_k = d_v = 64, conv
# kernel 15, dropout 0.1, band (-100, 50), float32, batch 4, 10 epochs, lr
# 0.003; a 3-gram LM, latgen at beam 14 and max_active 2000
HYBRID_KNOBS = {"device": "cuda"}
# the AM run.sh trains at those defaults (train_am's flags), for the CPU
# references that start while it trains
HYBRID_MODEL = dict(encoder_type="conformer", en_d_model=144,
                    encoder_sub_sequence=(-100, 50), en_dropout=0.1)
HYBRID_BATCH = 4
# torch threads of the CPU references beside the recipe (of the host's 8
# cores: the recipe's host work keeps the others)
CPU_SIDE_THREADS = 6
HYBRID_STAGE_LINES = {
    "0": "[PROCEDURE] preparing the long-form corpus.",
    "1": "[PROCEDURE] training language model.",
    "2": "[PROCEDURE] AM training.",
    "3": "[PROCEDURE] posterior dump + graph decode.",
    "4": "[PROCEDURE] forced-alignment CTM (word time boundaries).",
}
# card vs CPU: each utterance's best-path cost (the posteriors' and
# latgen's), and the encoder output over its largest entry (ENCODER_RTOL)
HYBRID_COST_ATOL = 1e-3


def _am_step_on(torch, device, params, cfg, batch, seed=0, dtype=None):
    """One hybrid-AM train step (recipes/train_am.py's) from ``params`` on
    ``device``, the dropout masks from ``seed``; returns (loss, {leaf path:
    gradient on the CPU in float64})."""
    from pytorch_kaldi_asr_tpu_torch.data.loader import to_device
    from pytorch_kaldi_asr_tpu_torch.models.transformer import tree_map
    from pytorch_kaldi_asr_tpu_torch.recipes.train_am import (
        am_train_step,
        create_am_state,
    )
    from pytorch_kaldi_asr_tpu_torch.train.optim import named_leaves

    dtype = dtype or torch.float32
    state = create_am_state(tree_map(
        lambda t: t.detach().to(device, dtype, copy=True), params),
        seed=seed)
    b = to_device(batch, device)
    loss, _ = am_train_step(state, cfg, b.src.to(dtype), b.src_mask, b.tgt)
    return (float(loss), {path: p.grad.cpu().double()
                          for path, p in named_leaves(state.params)})


def check_hybrid_launches(launches, steps, cfg):
    """K2a-c at exactly en_layers x train steps, K3 at exactly the AM's
    dropout sites x steps each way (float32), K1 in the evaluations and the
    dump, no bfloat16 instantiation."""
    sites = dropout_sites(cfg, decoder=False)
    want = {f"banded_attention_{k}": cfg.en_layers * steps
            for k in ("fwd", "dq", "dkv")}
    want.update({f"fused_dropout_{way}": sites["float32"] * steps
                 for way in ("forward", "backward")})
    want.update({name: 0 for name in launches if name.endswith("_bf16")})
    wrong = {k: (launches.get(k), n) for k, n in want.items()
             if launches.get(k) != n}
    if wrong or not launches.get("banded_attention"):
        raise AssertionError(f"the hybrid recipe's launches {launches}: "
                             f"(launched, expected) {wrong}; K1 "
                             f"{launches.get('banded_attention')}")


def run_hybrid(torch, device="cuda", knobs=None):
    """The long-form recipe's run.sh (HYBRID_SH), stages 0-4, with
    HYBRID_KNOBS (or ``knobs``) on ``device``.  Fails unless it exits 0
    with a %WER in exp/wer and CTM lines with positive durations for every
    test utterance, the device-running CLIs logging ``device``, and K2a-c,
    K3 and K1 launched as ``check_hybrid_launches`` says.  Then card
    against CPU: one AM train step from the recipe's initial weights (as
    every path's step starts from model.init: the trained AM's frames are
    near certain, its mean NLL near 0, where float32 resolves a log-softmax
    coarsely; PERF.md §6) on its first batch of 4 training utterances
    (``card_vs_cpu_step``); from the recipe's checkpoint, dump_posteriors on
    the CPU against the card's posteriors (every frame's best class the
    same, each utterance's best-path cost within HYBRID_COST_ATOL), latgen
    over both (the same words, costs within HYBRID_COST_ATOL; the card's as
    run.sh wrote them) and the encoder output on the test batch (within
    ENCODER_RTOL of its largest entry); on the card, the AM step's time
    (3 x 10 steps) and profile (3 steps).  The CPU's references start as the
    stages that give them their inputs start (the step's when stage 2 does,
    the dump's and the encoder's when stage 3 does) and run beside the
    recipe on CPU_SIDE_THREADS threads.  Returns the stage walls,
    processes, start-up share, WER, rates and checks."""
    import concurrent.futures

    from pytorch_kaldi_asr_tpu_torch.data.loader import BatchLoader, to_device
    from pytorch_kaldi_asr_tpu_torch.decode.latgen import latgen
    from pytorch_kaldi_asr_tpu_torch.fst.openfst_io import read_fst
    from pytorch_kaldi_asr_tpu_torch.io import kaldi_io
    from pytorch_kaldi_asr_tpu_torch.models.transformer import encode, tree_map
    from pytorch_kaldi_asr_tpu_torch.recipes import dump_posteriors
    from pytorch_kaldi_asr_tpu_torch.recipes.train_am import (
        am_setup,
        am_train_step,
        create_am_state,
    )
    from pytorch_kaldi_asr_tpu_torch.train import load_checkpoint

    import numpy as np

    knobs = dict(HYBRID_KNOBS, device=device, **(knobs or {}))
    work = _fresh(WORK / "hybrid")
    exp, data = work / "exp", work / "data"

    def test_batch():
        loader = BatchLoader([(k, rx, np.zeros(1, np.int32)) for k, rx in
                              kaldi_io.scp_entries(str(data / "test"
                                                       / "feats.scp"))],
                             16, mode="all", shuffle=False)
        return next(iter(loader))

    ref, side_s = {}, {}

    def timed(name, fn):
        def job():
            t0 = time.perf_counter()
            out = fn()
            side_s[name] = time.perf_counter() - t0
            return out
        return job

    def cpu_step_job():
        loader, _, cfg, init = am_setup(str(data / "train"),
                                        str(data / "dev"), HYBRID_BATCH,
                                        **HYBRID_MODEL)
        batch = next(iter(loader))  # train_am's first batch
        return cfg, init, batch, _am_step_on(torch, "cpu", init, cfg, batch)

    def cpu_dump_job():
        assert dump_posteriors.main([
            "-read_data_dir", str(data / "test"), "-load_model_file",
            str(exp / "am"), "-wspecifier",
            f"ark,scp:{work}/post_cpu.ark,{work}/post_cpu.scp",
            "-device", "cpu"]) == 0
        ckpt = load_checkpoint(str(exp / "am"))
        b = to_device(test_batch(), "cpu")
        with torch.no_grad():
            enc, mask = encode(ckpt["params"], ckpt["cfg"], b.src,
                               b.src_mask)
        return enc, (mask > 0) & (b.valid[:, None] > 0)

    threads = torch.get_num_threads()
    torch.set_num_threads(CPU_SIDE_THREADS)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        def on_stage(stage):
            if stage == "2":
                ref["step"] = pool.submit(timed("step", cpu_step_job))
            elif stage == "3":
                ref["dump"] = pool.submit(timed("dump", cpu_dump_job))

        stdout, stages_s, t_start, t_end = run_traced(
            HYBRID_SH, work, knobs, HYBRID_STAGE_LINES, on_stage)
        t0 = time.perf_counter()
        cfg0, init, batch, step_cpu = ref["step"].result()
        enc_cpu, keep = ref["dump"].result()
        waited_s = time.perf_counter() - t0
    torch.set_num_threads(threads)
    cpu_reference_done("hybrid AM step (beside run.sh)", side_s["step"])
    cpu_reference_done("hybrid dump_posteriors and encoder (beside run.sh)",
                       side_s["dump"])
    print(f"hybrid: the CPU references kept the run {waited_s:.1f} s after "
          f"run.sh")

    wer_text = (exp / "wer").read_text()
    if "%WER" not in wer_text:
        raise AssertionError(f"exp/wer: {wer_text!r}")
    texts = kaldi_io.read_key_value_text(str(data / "test" / "text"))
    ctm = [line.split() for line in (exp / "test.ctm").read_text()
           .splitlines()]
    if {row[0] for row in ctm} != set(texts) or not all(
            len(row) == 6 and float(row[3]) > 0 for row in ctm):
        raise AssertionError(f"exp/test.ctm: {len(ctm)} lines over "
                             f"{len({row[0] for row in ctm})} of "
                             f"{len(texts)} utterances, or a duration <= 0")
    launches, devices = recipe_launches([stdout])
    if devices != {device} or stdout.count(f"kernel launches on {device}") \
            != 2:
        raise AssertionError(f"train_am and dump_posteriors ran on "
                             f"{devices}")
    ckpt = load_checkpoint(str(exp / "am"))
    params, cfg, steps = ckpt["params"], ckpt["cfg"], ckpt["step"]
    if cfg != cfg0:
        raise AssertionError(f"run.sh trained {cfg}, the CPU references "
                             f"took {cfg0}")
    if device.startswith("cuda"):
        check_hybrid_launches(launches, steps, cfg)
    trace = (work / "trace.log").read_text()
    procs = recipe_processes(trace, t_end)
    startup = recipe_startups([trace])
    startup_total = sum(row["seconds"] for row in startup.values())
    frames = kaldi_io.read_key_value_text(
        str(data / "test" / "feats.length"), int)
    audio_s = 0.010 * sum(frames.values())

    def per_audio_s(cli):
        wall = procs[cli]["wall_s"]
        start = startup.get(cli, {}).get("seconds", 0.0)
        return {"wall_s": wall, "startup_s": start,
                "wall_per_audio_s": wall / audio_s,
                "after_startup_per_audio_s": (wall - start) / audio_s}

    out = {
        "knobs": knobs, "wall_s": t_end - t_start, "stages_s": stages_s,
        "processes": procs,
        "n_processes": sum(r["processes"] for r in procs.values()),
        "startup_s": startup, "startup_total_s": startup_total,
        "startup_share": startup_total / (t_end - t_start),
        "wer": wer_text.strip().splitlines()[0], "ctm_lines": len(ctm),
        "test_audio_s": audio_s, "train_steps": steps,
        "launches": launches, "dropout_sites": dropout_sites(cfg, False),
        "train_am_s_per_step": procs["train_am"]["wall_s"] / steps,
        **{cli: per_audio_s(cli) for cli in ("dump_posteriors", "latgen",
                                             "align_ctm")},
        "cpu_side_s": side_s, "cpu_side_waited_s": waited_s,
    }
    print("hybrid recipe: " + json.dumps(out))

    def step_on(torch, device, params, cfg, batch, seed=0):
        if device == "cpu" and params is init and seed == 0:
            return step_cpu  # taken beside the recipe
        return _am_step_on(torch, device, params, cfg, batch, seed=seed)

    t0 = time.perf_counter()
    out["step"] = card_vs_cpu_step(torch, device, init, cfg, batch,
                                   step_on=step_on)
    out["step"]["s"] = time.perf_counter() - t0
    print("hybrid train step card vs CPU: " + json.dumps(out["step"]))
    if device.startswith("cuda"):  # the AM step's time and profile
        state = create_am_state(tree_map(
            lambda t: t.detach().to(device, copy=True), init), lr=0.003)
        b = to_device(batch, device)

        def step():
            am_train_step(state, cfg, b.src, b.src_mask, b.tgt)

        out["step_ms"] = time_steps(step, torch.cuda.synchronize,
                                    repeats=3)
        out["real_frames"] = int(batch.src_mask.sum())
        out["step_profile"] = profile_steps(torch, step)
        print(f"hybrid AM step (batch {HYBRID_BATCH}, "
              f"{out['real_frames']} real frames of S {batch.src.shape[1]}):"
              f" {out['step_ms']} ms; profile "
              + json.dumps(out["step_profile"]))

    card = dict(kaldi_io.read_mat_scp(str(exp / "post.scp")))
    cpu = dict(kaldi_io.read_mat_scp(str(work / "post_cpu.scp")))
    if list(card) != list(cpu) or any(card[k].shape != cpu[k].shape
                                      for k in cpu):
        raise AssertionError("posteriors: card and CPU differ in keys or "
                             "shapes")
    post_err = max(float(np.abs(card[k] - cpu[k]).max()) for k in cpu)
    flips = sum(int((card[k].argmax(1) != cpu[k].argmax(1)).sum())
                for k in cpu)
    post_cost = max(abs(float(card[k].max(1).astype(np.float64).sum()
                              - cpu[k].max(1).astype(np.float64).sum()))
                    for k in cpu)
    out["posteriors"] = {"max_abs_err": post_err, "best_class_flips": flips,
                         "max_cost_err": post_cost}
    if flips or post_cost > HYBRID_COST_ATOL:
        raise AssertionError(f"posteriors card vs CPU: {out['posteriors']}")

    t0 = time.perf_counter()
    graph = read_fst(str(exp / "graph" / "HLG.fst"))
    kw = dict(beam=float(knobs.get("beam", 14)),
              max_active=int(knobs.get("max_active", 2000)),
              acoustic_scale=float(knobs.get("acoustic_scale", 1.0)))
    words = {int(v): w for w, v in (line.split() for line in
                                    open(exp / "graph" / "words.txt"))}
    written = kaldi_io.read_key_value_text(str(exp / "decode.txt"))
    lat_err = 0.0
    for key in cpu:
        (ids, _, cost), (cpu_ids, _, cpu_cost) = (
            latgen(graph, post[key], **kw) for post in (card, cpu))
        lat_err = max(lat_err, abs(cost - cpu_cost))
        if ids != cpu_ids or not abs(cost - cpu_cost) <= HYBRID_COST_ATOL \
                or " ".join(words[i] for i in ids) != written.get(key, ""):
            raise AssertionError(f"latgen {key}: card {cost} vs CPU "
                                 f"{cpu_cost}, words differ: {ids != cpu_ids}")
    out["latgen"] = {"max_cost_err": lat_err,
                     "decodes_s": time.perf_counter() - t0}

    with torch.no_grad():
        b = to_device(test_batch(), device)
        enc_dev, _ = encode(tree_map(lambda t: t.to(device), params), cfg,
                            b.src, b.src_mask)
    enc_err = float((enc_dev.cpu()[keep] - enc_cpu[keep]).abs().max())
    enc_max = float(enc_cpu[keep].abs().max())
    out["encoder"] = {"max_abs_err": enc_err, "max_abs": enc_max}
    if not enc_err <= ENCODER_RTOL * enc_max:
        raise AssertionError(f"encoder output card vs CPU: {enc_err} over "
                             f"{enc_max}")
    print("hybrid card vs CPU: " + json.dumps(
        {k: out[k] for k in ("posteriors", "latgen", "encoder")}))
    return out


# the lattice phase: the hybrid phase's posteriors and graph through the
# lattice tools, each CLI as its own process, as a user runs them
LATTICE = {"lattice_beam": 8.0, "prune_beam": 6.0, "nbest": 10,
           "rescore_n": 20, "nlm_epochs": 1, "keywords": 4, "jobs": 8}


def run_lattice(torch, hybrid_work, device="cuda", knobs=None):
    """The lattice tools over the hybrid phase's ``hybrid_work`` (its
    ``exp/post.scp``, the card's posteriors, and ``post_cpu.scp``, the
    CPU's; its graph, LM, test text and CTM), each CLI a process in that
    directory, writing under ``WORK/lattice``; each CLI starts as soon as
    the CLIs whose output it reads are done, beside the others
    (LATTICE["jobs"] chains at once):

    1. ``prepare_vocab`` and ``train_nlm`` at its defaults for
       LATTICE["nlm_epochs"] epochs over the training transcripts on
       ``device``: K3 exactly (dropout sites) x steps each way, from its
       exit log;
    2. ``latgen -lattice_beam`` with the three lattice outputs over the
       card's posteriors at the hybrid knobs: its result equal to run.sh's
       ``exp/decode.txt``; meanwhile, in this process, ``latgen_lattice``
       over the card's and the CPU's posteriors: each utterance's best-path
       words the same and its cost within HYBRID_COST_ATOL (the lattices'
       node and link counts printed, not gated: they may differ at the
       beam's edge);
    3. ``lattice_copy`` from the ``.scp`` with ``-prune_beam``, ``-nbest``
       and ``-oracle_ref``: the oracle's errors no more than the 1-best's;
    4. ``lattice_rescore`` with ``-lm`` (the recipe's 3-gram) and with
       ``-nlm_model_dir`` on ``device`` and on the CPU: a line for every
       test utterance, the two NLM runs the same transcripts; in this
       process the hypotheses' NLM scores on ``device`` and on the CPU
       within NLM_SCORE_ATOL;
    5. ``lattice_to_ctm`` (consensus CTM), ``align_ctm -refine_ctm`` on
       it: CTM lines of positive duration for every test utterance;
    6. ``rover`` over the refined CTM and run.sh's ``exp/test.ctm``;
    7. ``kws search`` for LATTICE["keywords"] keywords from the test text
       (its most frequent words and a word pair of the 1-best), each found
       at least once, then ``kws post-process``;
    8. ``show_lattice`` on the first utterance.

    Returns each CLI's wall and start-up seconds (with its neighbours
    running), the lattice sizes, the WERs, the checks and the launches
    read from the CLIs' logs."""
    import xml.etree.ElementTree as ET

    import numpy as np

    from pytorch_kaldi_asr_tpu_torch.data import read_vocab
    from pytorch_kaldi_asr_tpu_torch.decode.latgen import latgen_lattice
    from pytorch_kaldi_asr_tpu_torch.decode.lattice_ops import nbest
    from pytorch_kaldi_asr_tpu_torch.fst.openfst_io import (
        read_fst,
        read_lattice_ark,
    )
    from pytorch_kaldi_asr_tpu_torch.io import kaldi_io
    from pytorch_kaldi_asr_tpu_torch.models.nlm import (
        load_nlm,
        score_sentences,
    )
    from pytorch_kaldi_asr_tpu_torch.score.wer import compute_wer

    knobs = dict(HYBRID_KNOBS, device=device, **(knobs or {}))
    t_phase = time.perf_counter()
    hw = Path(hybrid_work).resolve()
    exp, data = hw / "exp", hw / "data"
    work = _fresh(WORK / "lattice")
    words_txt = exp / "graph" / "words.txt"
    clis, logs = {}, {}

    def cli(name, module, *args):
        t0 = time.perf_counter()
        wall, start, logs[name] = _run_cli(hw, work / f"{name}.log", module,
                                           *args)
        clis[name] = {"wall_s": wall, "startup_s": start,
                      "started_s": t0 - t_phase}

    refs = kaldi_io.read_key_value_text(str(data / "test" / "text"))
    out = {"knobs": knobs, "lattice": dict(LATTICE)}

    def wer(path):
        hyps = kaldi_io.read_key_value_text(str(path))
        if sorted(hyps) != sorted(refs):
            raise AssertionError(f"{path.name}: {len(hyps)} lines for "
                                 f"{len(refs)} test utterances")
        return compute_wer(refs, hyps)

    beam = float(knobs.get("beam", 14))
    max_active = int(knobs.get("max_active", 2000))
    scale = float(knobs.get("acoustic_scale", 1.0))
    vocab, ark = work / "nlm_vocab.txt", f"ark:{work / 'lat.ark'}"
    nlm_args = ["-words", words_txt, "-nlm_model_dir", work / "nlm",
                "-read_vocab_file", vocab, "-n", LATTICE["rescore_n"], ark]
    picked = {}  # 7.'s keywords and 8.'s utterance, from latgen's result

    def pick_keywords():
        """The test text's most frequent words and a word pair that the
        first utterance's reference and 1-best share."""
        counts = {}
        for words in refs.values():
            for w in words.split():
                counts[w] = counts.get(w, 0) + 1
        frequent = sorted(counts, key=lambda w: (-counts[w], w))
        first = (work / "decode.txt").read_text().splitlines()[0].split()
        ref_first = refs[first[0]].split()
        pairs = set(zip(ref_first, ref_first[1:]))
        pair = next((f"{a} {b}" for a, b in zip(first[1:], first[2:])
                     if (a, b) in pairs), None)
        picked["keywords"] = (frequent[:LATTICE["keywords"] - 1] + [pair]
                              if pair else frequent[:LATTICE["keywords"]])
        picked["utt"] = first[0]
        (work / "keywords.txt").write_text("".join(
            f"KW{i} {k}\n" for i, k in enumerate(picked["keywords"])))

    with concurrent.futures.ThreadPoolExecutor(LATTICE["jobs"]) as pool:
        def start(*steps, after=()):
            """A chain of CLIs (or callables), one after another, once the
            jobs ``after`` are done."""
            def chain():
                for job in after:
                    job.result()
                for step in steps:
                    step() if callable(step) else cli(*step)
            return pool.submit(chain)

        # 1. the neural LM on the card; 2. latgen's lattices
        nlm_job = start(
            ("prepare_vocab", "recipes.prepare_vocab", "-read_instances_file",
             data / "train" / "text", "-save_vocab_file", vocab),
            ("train_nlm", "recipes.train_nlm", "-text",
             data / "train" / "text", "-read_vocab_file", vocab,
             "-save_model_dir", work / "nlm", "-epoch",
             LATTICE["nlm_epochs"], "-device", device))
        (work / "slf").mkdir()
        latgen_job = start((
            "latgen", "recipes.latgen", "-graph_dir", exp / "graph",
            "-rspecifier", "scp:exp/post.scp", "-acoustic_scale", scale,
            "-beam", beam, "-max_active", max_active, "-lattice_beam",
            LATTICE["lattice_beam"], "-save_result_file",
            work / "decode.txt", "-save_lattice_file", work / "lat.txt",
            "-save_lattice_ark", work / "lat.ark", "-save_slf",
            work / "slf"))
        # 3.-8.: the tools over latgen's lattices, as each one's inputs are
        # written
        jobs = [
            start(("lattice_copy", "tools.lattice_copy", "-words", words_txt,
                   "-prune_beam", LATTICE["prune_beam"], "-nbest",
                   LATTICE["nbest"], "-nbest_file", work / "nbest.txt",
                   "-oracle_ref", data / "test" / "text", "-oracle_file",
                   work / "oracle.txt", f"scp:{work / 'lat.ark.scp'}",
                   f"ark,t:{work / 'lat_pruned.txt'}"), after=[latgen_job]),
            start(("lattice_to_ctm", "tools.lattice_to_ctm", "-words",
                   words_txt, ark, work / "consensus.ctm", "-text",
                   work / "consensus.tra"),
                  ("align_ctm_refine", "tools.align_ctm", "-lexicon",
                   exp / "lexicon.txt", "-phones", data / "phones.txt",
                   "-text", data / "test" / "text", "-acoustic_scale", scale,
                   "-refine_ctm", work / "consensus.ctm", "scp:exp/post.scp",
                   work / "refined.ctm"),
                  ("rover", "tools.rover", "-o", work / "rover.tra",
                   "-conf_output", work / "rover.conf", work / "refined.ctm",
                   exp / "test.ctm"), after=[latgen_job]),
            start(("lattice_rescore_lm", "tools.lattice_rescore", "-words",
                   words_txt, "-lm", data / "lm.gz", "-n",
                   LATTICE["rescore_n"], ark, work / "rescore_lm.txt"),
                  after=[latgen_job]),
            start(pick_keywords,
                  ("kws_search", "tools.kws", "search", "-keywords",
                   work / "keywords.txt", "-lattices", work / "lat.txt",
                   "-output", work / "kws.xml"),
                  ("kws_post_process", "tools.kws", "post-process",
                   work / "kws.xml", work / "kws_post.xml", "-normalize",
                   "kst"),
                  lambda: cli("show_lattice", "tools.show_lattice",
                              "-lattices", work / "lat.txt", "-utt",
                              picked["utt"], "-output",
                              work / f"{picked['utt']}.dot"),
                  after=[latgen_job]),
            start(("lattice_rescore_nlm", "tools.lattice_rescore", *nlm_args,
                   work / "rescore_nlm.txt", "-device", device),
                  after=[nlm_job, latgen_job]),
            start(("lattice_rescore_nlm_cpu", "tools.lattice_rescore",
                   *nlm_args, work / "rescore_nlm_cpu.txt", "-device",
                   "cpu"), after=[nlm_job, latgen_job])]

        # in process meanwhile: latgen_lattice over both posteriors
        graph = read_fst(str(exp / "graph" / "HLG.fst"))
        id2word = {int(v): w for w, v in (line.split() for line in
                                          open(words_txt))}
        kw = dict(acoustic_scale=scale, beam=beam, max_active=max_active,
                  lattice_beam=LATTICE["lattice_beam"], id2word=id2word)
        t0 = time.perf_counter()
        card = list(kaldi_io.read_mat_scp(str(exp / "post.scp")))
        cpu = dict(kaldi_io.read_mat_scp(str(hw / "post_cpu.scp")))
        sizes, cost_err = {}, 0.0
        for key, post in card:
            lats = [latgen_lattice(graph, p, utt=key, **kw)
                    for p in (post, cpu[key])]
            if None in lats:
                raise AssertionError(f"latgen_lattice {key}: no path "
                                     "survived")
            (w_card, c_card), (w_cpu, c_cpu) = (lat.best_path()
                                                for lat in lats)
            cost_err = max(cost_err, abs(c_card - c_cpu))
            if w_card != w_cpu or not abs(c_card - c_cpu) <= \
                    HYBRID_COST_ATOL:
                raise AssertionError(f"latgen_lattice {key}: card {c_card} "
                                     f"vs CPU {c_cpu}, words differ: "
                                     f"{w_card != w_cpu}")
            sizes[key] = {where: [lat.num_nodes, len(lat.links)]
                          for where, lat in zip(("card", "cpu"), lats)}
        out["latgen_lattice"] = {"max_cost_err": cost_err, "sizes": sizes,
                                 "s": time.perf_counter() - t0}
        print("lattice phase: latgen_lattice card vs CPU (nodes, links): "
              + json.dumps(out["latgen_lattice"]), flush=True)
        latgen_job.result()
        if (work / "decode.txt").read_bytes() != (exp / "decode.txt") \
                .read_bytes():
            raise AssertionError("latgen -save_lattice_*: its result "
                                 "differs from run.sh's exp/decode.txt")
        written = dict(read_lattice_ark(str(work / "lat.ark"), id2word))
        seqs = [words for lat in written.values() for words, *_ in
                nbest(lat, LATTICE["rescore_n"], with_components=True)]
        nlm_job.result()
        # in process: the hypotheses' NLM scores, card against CPU
        word2idx = read_vocab(str(vocab))
        scores = {}
        for where in (device, "cpu"):
            p, c, _ = load_nlm(str(work / "nlm"), device=where)
            scores[where] = np.array(score_sentences(p, c, seqs, word2idx))
        for job in jobs:
            job.result()
    keywords, utt = picked["keywords"], picked["utt"]

    # 1.: K3 in train_nlm
    params, cfg, meta = load_nlm(str(work / "nlm"))
    n_sents = len((data / "train" / "text").read_text().splitlines())
    steps = LATTICE["nlm_epochs"] * max(1, n_sents // 32)
    sites = 2 + 3 * cfg.de_layers  # embeddings, per layer 3, the output
    nlm_launches, nlm_devices = recipe_launches([logs["train_nlm"]])
    if meta["step"] != steps or nlm_devices != {device}:
        raise AssertionError(f"train_nlm took {meta['step']} steps on "
                             f"{nlm_devices}, expected {steps} on {device}")
    if device.startswith("cuda"):
        check_step_launches("lattice phase train_nlm", nlm_launches, {
            "fused_dropout_forward": sites * steps,
            "fused_dropout_backward": sites * steps,
            "fused_dropout_forward_bf16": 0,
            "fused_dropout_backward_bf16": 0})
    out["nlm"] = {"steps": steps, "dropout_sites": sites,
                  "launches": nlm_launches}

    # 2.: latgen's three outputs cover the test set
    if sorted(written) != sorted(refs) or not (work / "lat.ark.scp") \
            .exists() or len(list((work / "slf").glob("*.lat.gz"))) \
            != len(refs):
        raise AssertionError("latgen's lattice outputs do not cover the "
                             "test set")

    # 3.: the oracle no worse than the 1-best
    overall = (work / "oracle.txt").read_text().splitlines()[-1].split()
    onebest = wer(work / "decode.txt")
    out["oracle"] = {"errors": int(overall[1]), "words": int(overall[2]),
                     "wer": 100.0 * int(overall[1]) / max(int(overall[2]),
                                                          1)}
    out["onebest_wer"] = onebest
    if int(overall[1]) > onebest["errors"]:
        raise AssertionError(f"oracle {out['oracle']} worse than the "
                             f"1-best {onebest}")

    # 4.: rescoring
    out["rescored_wer"] = {name: wer(work / f"rescore_{name}.txt")
                           for name in ("lm", "nlm")}
    if (work / "rescore_nlm.txt").read_bytes() != \
            (work / "rescore_nlm_cpu.txt").read_bytes():
        raise AssertionError("lattice_rescore -nlm_model_dir: the card's "
                             "transcripts differ from the CPU's")
    nlm_err = float(np.abs(scores[device] - scores["cpu"]).max())
    out["nlm_scores"] = {"hypotheses": len(seqs), "max_abs_err": nlm_err}
    if not np.isfinite(scores[device]).all() or nlm_err > NLM_SCORE_ATOL:
        raise AssertionError(f"lattice hypotheses' NLM scores, {device} vs "
                             f"cpu: {nlm_err} (limit {NLM_SCORE_ATOL})")

    # 5. and 6.: the CTMs and ROVER
    for name in ("consensus.ctm", "refined.ctm"):
        rows = [line.split() for line in (work / name).read_text()
                .splitlines()]
        if {r[0] for r in rows} != set(refs) or not all(
                len(r) == 6 and float(r[3]) > 0 for r in rows):
            raise AssertionError(f"{name}: {len(rows)} lines over "
                                 f"{len({r[0] for r in rows})} of "
                                 f"{len(refs)} utterances, or a duration "
                                 "<= 0")
        out[name.replace(".", "_") + "_lines"] = len(rows)
    out["consensus_wer"] = wer(work / "consensus.tra")
    out["rover_wer"] = wer(work / "rover.tra")

    # 7. and 8.: every keyword found; a dot graph
    found = dict.fromkeys((f"KW{i}" for i in range(len(keywords))), 0)
    for dk in ET.parse(work / "kws.xml").getroot().findall(
            "detected_kwlist"):
        found[dk.get("kwid")] = len(dk.findall("kw"))
    out["kws"] = {"keywords": keywords, "hits": found}
    if not all(found.values()):
        raise AssertionError(f"kws: a keyword was not found: {out['kws']}")
    if not (work / f"{utt}.dot").read_text().startswith("digraph lattice"):
        raise AssertionError("show_lattice wrote no dot graph")

    launches, devices = recipe_launches(logs.values())
    out.update({"clis": clis,
                "launches": {**dict.fromkeys(launch_counts(), 0),
                             **launches},
                "devices": sorted(devices),
                "seconds": time.perf_counter() - t_phase})
    print("lattice phase: " + json.dumps(out))
    for name, row in sorted(clis.items(), key=lambda kv: kv[1]["started_s"]):
        print(f"lattice phase CLI {name}: started at {row['started_s']:.2f} "
              f"s, {row['wall_s']:.2f} s, start-up {row['startup_s']} s")
    return out


# the device-search phase: latgen -device_search (decode/device_latgen.py,
# decode/frontier_latgen.py) over the hybrid phase's card posteriors, on its
# HLG (graph A: 1-state HMMs, inside the dense decoder's bounds) and on a
# lang dir's HLG with 3-state HMMs (graph B: prepare_lang, format_lm,
# mkgraph -topo) widened by seeded multi-phone words until ``auto`` picks
# the frontier decoder; at the hybrid recipe's beam 14, max_active 2000
DEVICE_SEARCH = {"batch": 8, "nonsil_states": 3, "words": 100,
                 "sentences": 200, "cpu_utts": 2, "cpu_frames": 600,
                 "profile_frames": 200, "build_s": 30.0}
# card vs the host's float64 latgen: a float32 sum of 3,584 terms may round
# 3,584 x 2**-24 = 2.1e-4 of its size
DEVICE_SEARCH_COST_RTOL = 2e-4
# latgen's knobs in the hybrid recipe (recipes/longform-conformer/run.sh)
HYBRID_SEARCH = {"beam": 14.0, "max_active": 2000, "acoustic_scale": 1.0}
SEARCH_LOG_RE = r"device search: (\w+) decoder \(-device_mode (\w+)\)"
FALLBACK_RE = (r"device search: (\d+) host fallbacks; ([0-9.]+) s reading "
               r"and decoding")


def _run_cli(cwd, log, module, *args):
    """One CLI of the port as a process in ``cwd``; its output to ``log``.
    Returns (wall seconds, start-up seconds, log text); raises unless it
    exits 0."""
    from pytorch_kaldi_asr_tpu_torch.utils.logging import STARTUP_RE

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", f"pytorch_kaldi_asr_tpu_torch.{module}",
         *map(str, args)], cwd=str(cwd), capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=str(REPO), PYTHONUNBUFFERED="1"),
        timeout=900)
    wall = time.perf_counter() - t0
    text = proc.stdout + proc.stderr
    log.write_text(text)
    if proc.returncode != 0:
        raise AssertionError(f"{module} exited {proc.returncode}: "
                             f"{text[-3000:]}")
    start = [float(s) for _, s in re.findall(STARTUP_RE, proc.stderr)]
    return wall, (start[0] if start else None), text


def build_graph_b(hybrid_work, work):
    """Graph B in ``work``: a dict dir of the recipe's identity lexicon
    (run.sh's exp/lexicon.txt), ``prepare_lang --num-nonsil-states 3``
    (every phone a 3-state Bakis HMM), ``lm_tools format-lm`` with the LM
    and ``mkgraph -topo`` with the lang dir's topology, each a process.  While
    the HLG stays inside the dense decoder's bounds it is built again with
    DEVICE_SEARCH["words"] (then twice as many) seeded words of 2-4 of the
    recipe's phones added to the lexicon, and an LM trained by ``train_lm``
    on the training text plus DEVICE_SEARCH["sentences"] seeded sentences
    that use them.  Fails unless validate_lang finds nothing and the
    build takes at most DEVICE_SEARCH["build_s"] seconds.  Returns the
    graph's size, the words added, and the seconds."""
    import numpy as np

    from pytorch_kaldi_asr_tpu_torch.decode.device_latgen import pick_mode
    from pytorch_kaldi_asr_tpu_torch.fst.openfst_io import read_fst
    from pytorch_kaldi_asr_tpu_torch.tools.lang import validate_lang

    hw = Path(hybrid_work).resolve()
    exp, data = hw / "exp", hw / "data"
    phones = [line.split()[0] for line in open(data / "phones.txt")
              if not line.startswith(("#", "<eps>"))]
    t0 = time.perf_counter()
    tries = []
    n_words = 0
    while True:
        work = _fresh(Path(work))
        rng = np.random.default_rng(SEED)
        added = [f"w{i:04d}" for i in range(n_words)]
        lexicon = (exp / "lexicon.txt").read_text() + "".join(
            f"{w} {' '.join(rng.choice(phones, int(rng.integers(2, 5))))}\n"
            for w in added)
        (work / "dict").mkdir()
        (work / "dict" / "lexicon.txt").write_text(lexicon)
        logs = work / "logs"
        logs.mkdir()
        lm = data / "lm.gz"
        if added:
            text = (data / "train" / "text").read_text() + "".join(
                f"extra{i} " + " ".join(
                    str(rng.choice(added)) if rng.random() < 0.5
                    else str(rng.choice(phones))
                    for _ in range(int(rng.integers(6, 13)))) + "\n"
                for i in range(DEVICE_SEARCH["sentences"]))
            (work / "text").write_text(text)
            lm = work / "lm.gz"
            _run_cli(work, logs / "train_lm.log", "recipes.train_lm",
                     "-text", work / "text", "-order", 3, "-lm", lm)
        _run_cli(work, logs / "prepare_lang.log", "tools.prepare_lang",
                 work / "dict", work / "lang", "--num-nonsil-states",
                 DEVICE_SEARCH["nonsil_states"])
        _run_cli(work, logs / "format_lm.log", "tools.lm_tools", "format-lm",
                 work / "lang", lm, work / "lang_test")
        problems = validate_lang(str(work / "lang_test"))
        if problems:
            raise AssertionError(f"graph B's lang dir: {problems}")
        _run_cli(work, logs / "mkgraph.log", "recipes.mkgraph", "-phones",
                 data / "phones.txt", "-lexicon", work / "dict" /
                 "lexicon.txt", "-lm", lm, "-topo", work / "lang" / "topo",
                 "-graph_dir", work / "graph")
        g = read_fst(str(work / "graph" / "HLG.fst"))
        tries.append({"words": n_words, "states": g.num_states,
                      "arcs": g.num_arcs})
        if pick_mode(g) == "frontier":
            break
        n_words = max(DEVICE_SEARCH["words"], 2 * n_words)
    out = {"tries": tries, **tries[-1], "lm": str(lm),
           "build_s": time.perf_counter() - t0}
    print(f"device search graph B: {out['states']} states, {out['arcs']} arcs,"
          f" {n_words} words added, built in {out['build_s']:.1f} s "
          f"(tries {tries})", flush=True)
    if out["build_s"] > DEVICE_SEARCH["build_s"]:
        raise AssertionError(f"graph B took {out['build_s']:.1f} s to build")
    return out


def _search_posts(hybrid_work, name="post.scp"):
    from pytorch_kaldi_asr_tpu_torch.io import kaldi_io

    return dict(kaldi_io.read_mat_scp(str(Path(hybrid_work) / "exp" / name)))


def _search_batch(posts, keys, frames=None):
    """[B, T, P] float32 of ``keys``' posteriors (each cut to ``frames``),
    T rounded up to 64 as decode_posterior_stream pads it, and lengths."""
    import numpy as np

    mats = [posts[k][:frames] for k in keys]
    lens = np.array([m.shape[0] for m in mats], np.int32)
    T = -(-int(lens.max()) // 64) * 64
    batch = np.zeros((len(mats), T, mats[0].shape[1]), np.float32)
    for b, m in enumerate(mats):
        batch[b, :lens[b]] = m
    return batch, lens


def _search_decode(torch, graph, cls, device, batch, lens, max_active):
    """One decode_batch of ``cls`` on ``device``: (results, seconds, host
    fallbacks, peak device bytes or None)."""
    dec = cls(graph, beam=HYBRID_SEARCH["beam"], max_active=max_active,
              acoustic_scale=HYBRID_SEARCH["acoustic_scale"], device=device)
    cuda = str(device).startswith("cuda")
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = dec.decode_batch(batch, lens)
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if cuda else None
    return res, seconds, dec.host_fallbacks, peak


# the host ops that wait for the card: the syncs and the device-to-host
# copies behind each nonzero and each value read back
SYNC_OPS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
            "cudaMemcpyAsync")


def search_profile(torch, graph, cls, batch, lens, max_active):
    """torch.profiler over one decode_batch of ``cls`` on the card: per
    frame of the batch its wall ms, device kernels, their device ms and the
    host's waits for the card (SYNC_OPS calls); the busy share; the host
    ops with the most self CPU time and the kernels with the most device
    time, each per frame."""
    events, wall_ms, attempts = _profile(torch, lambda: _search_decode(
        torch, graph, cls, "cuda", batch, lens, max_active))
    kernels = _kernel_rows(events)[1]
    n = int(batch.shape[1])
    host = [e for e in events if e.key not in {k.key for k in kernels}]
    device_ms = sum(e.device_time_total for e in kernels) / 1e3
    return {
        "frames": n, "utterances": int(batch.shape[0]),
        "wall_ms_per_frame": wall_ms / n,
        "kernels_per_frame": sum(e.count for e in kernels) / n,
        "device_ms_per_frame": device_ms / n,
        "busy_share": device_ms / wall_ms,
        "syncs_per_frame": {k: e.count / n for e in host for k in SYNC_OPS
                            if e.key == k},
        "top_host_ms_per_frame": [
            [e.key, e.self_cpu_time_total / 1e3 / n, e.count / n]
            for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:8]],
        "top_kernels_ms_per_frame": [
            [e.key[:60], e.device_time_total / 1e3 / n, e.count / n]
            for e in sorted(kernels, key=lambda e: -e.device_time_total)[:6]],
        "profile_attempts": attempts}


SEARCH_REFS = {}  # label -> the CPU reference's keys, results, seconds


def queue_device_search(torch, hybrid_work):
    """Build graph B (``build_graph_b``) and queue the device search's CPU
    references on the side thread (``defer_side_check``), started at once:
    the dense decoder on graph A over every test utterance, and the
    frontier decoder on graphs A and B over DEVICE_SEARCH["cpu_utts"]
    utterances cut to DEVICE_SEARCH["cpu_frames"] frames (the CPU's sorts
    are slow), each on the card's posteriors.  Returns graph B's build."""
    from pytorch_kaldi_asr_tpu_torch.decode.device_latgen import DeviceLatgen
    from pytorch_kaldi_asr_tpu_torch.decode.frontier_latgen import (
        FrontierLatgen,
    )
    from pytorch_kaldi_asr_tpu_torch.fst.openfst_io import read_fst

    hw = Path(hybrid_work).resolve()
    graph_b = build_graph_b(hw, WORK / "device_search" / "graph_b")
    posts = _search_posts(hw)
    keys = sorted(posts)
    cut = keys[:DEVICE_SEARCH["cpu_utts"]]
    graphs = {"A": hw / "exp" / "graph" / "HLG.fst",
              "B": WORK / "device_search" / "graph_b" / "graph" / "HLG.fst"}

    def job(label, name, cls, utts, frames):
        def run():
            batch, lens = _search_batch(posts, utts, frames)
            res, seconds, fallbacks, _ = _search_decode(
                torch, read_fst(str(graphs[name])), cls, "cpu", batch, lens,
                HYBRID_SEARCH["max_active"])
            SEARCH_REFS[label] = {"keys": utts, "results": res,
                                  "seconds": seconds,
                                  "host_fallbacks": fallbacks}
            return {"utterances": len(utts), "frames": int(lens.sum())}
        defer_side_check(label, run)

    job("device search dense on graph A", "A", DeviceLatgen, keys, None)
    for name in ("A", "B"):
        job(f"device search frontier on graph {name}", name, FrontierLatgen,
            cut, DEVICE_SEARCH["cpu_frames"])
    start_side_checks(torch)
    return graph_b


def _same_search(what, pairs, cost_atol=None, cost_rtol=None, phones=True):
    """Two decodes of the same utterances, ``pairs`` of (key, result,
    reference result): the same words (and phones), costs within
    ``cost_atol`` or ``cost_rtol`` of the reference's.  Returns the largest
    cost gap, absolute and relative."""
    gap = rel = 0.0
    for key, g, w in pairs:
        if g is None or w is None:
            raise AssertionError(f"{what} {key}: no path ({g is None}, "
                                 f"{w is None})")
        if g[0] != w[0] or (phones and g[1] != w[1]):
            raise AssertionError(f"{what} {key}: words or phones differ")
        gap = max(gap, abs(g[2] - w[2]))
        rel = max(rel, abs(g[2] - w[2]) / abs(w[2]))
    if (cost_atol is not None and gap > cost_atol) or \
            (cost_rtol is not None and rel > cost_rtol):
        raise AssertionError(f"{what}: costs {gap} apart ({rel} relative)")
    return {"max_cost_gap": gap, "max_cost_rel": rel}


def run_device_search(torch, hybrid_work, graph_b, device="cuda",
                      profile=False):
    """The device search over the hybrid phase's card posteriors
    (``hybrid_work``'s exp/post.scp) at HYBRID_SEARCH's knobs, on graph A
    (run.sh's exp/graph) and graph B (``build_graph_b``).  Side by side:

    1. the CLIs as processes: ``latgen -device_search -device_batch 8`` on
       graph A, ``auto`` (it must pick dense) and ``-device_mode frontier``,
       each decode.txt run.sh's exp/decode.txt line for line; on graph B
       the host ``latgen``, ``latgen -device_search`` (``auto``: it must
       pick the frontier) and ``-device_mode dense``, the same words for
       every utterance; ``align_ctm
       -topo`` with graph B's topology: CTM lines of positive duration for
       every test utterance, the words of run.sh's exp/test.ctm.  Where the
       frontier's post-closure cap makes graph B's words differ from the
       host's, both run again at twice the max_active (to at most 8 times
       the recipe's), the value printed;
    2. in this process: the host ``latgen`` (float64) on each graph, then
       DeviceLatgen and FrontierLatgen on ``device`` on graph A over the 8
       utterances in one batch: the host's words, each
       cost within DEVICE_SEARCH_COST_RTOL of the host's; the frontier on
       both graphs over the DEVICE_SEARCH["cpu_utts"] utterances cut to
       DEVICE_SEARCH["cpu_frames"] frames, against the host the same way.
       With ``profile`` (and a card), ``search_profile`` of both decoders
       on both graphs over the cut utterances' first DEVICE_SEARCH
       ["profile_frames"] frames.

    Then 3., the CPU references queued by ``queue_device_search``: the
    dense search on graph A and the frontier's cut decodes on the device
    against them, the same words and phones, costs within HYBRID_COST_ATOL.
    No decode may fall back to the host.  The in-process searches are
    timed with the CLIs running beside them (graph B's searches over the
    whole set from their CLIs' logs).  Returns each graph's size, each
    decoder's seconds per second of audio, the peak device memory, the
    checks and the CLIs' seconds."""
    from pytorch_kaldi_asr_tpu_torch.decode.device_latgen import DeviceLatgen
    from pytorch_kaldi_asr_tpu_torch.decode.frontier_latgen import (
        FrontierLatgen,
    )
    from pytorch_kaldi_asr_tpu_torch.decode.latgen import latgen
    from pytorch_kaldi_asr_tpu_torch.fst.openfst_io import read_fst
    from pytorch_kaldi_asr_tpu_torch.io import kaldi_io

    t_phase = time.perf_counter()
    hw = Path(hybrid_work).resolve()
    exp, data = hw / "exp", hw / "data"
    gb_dir = WORK / "device_search" / "graph_b"
    work = _fresh(WORK / "device_search" / "run")
    posts = _search_posts(hw)
    keys = sorted(posts)
    frames = kaldi_io.read_key_value_text(str(data / "test" /
                                              "feats.length"), int)
    audio_s = 0.010 * sum(frames[k] for k in keys)
    cut = keys[:DEVICE_SEARCH["cpu_utts"]]
    graphs = {"A": read_fst(str(exp / "graph" / "HLG.fst")),
              "B": read_fst(str(gb_dir / "graph" / "HLG.fst"))}
    out = {"knobs": dict(HYBRID_SEARCH, device=device, **DEVICE_SEARCH),
           "audio_s": audio_s, "graph_b": graph_b,
           "graphs": {k: {"states": g.num_states, "arcs": g.num_arcs}
                      for k, g in graphs.items()}, "clis": {}}
    fallbacks, timings, peaks, checks, host, dev = {}, {}, {}, {}, {}, {}
    recipe_ma = HYBRID_SEARCH["max_active"]

    # 1. the CLIs, side by side, beside this process's searches
    def latgen_args(graph_dir, result, max_active, *extra):
        return ("-graph_dir", graph_dir, "-rspecifier",
                f"scp:{exp / 'post.scp'}", "-acoustic_scale",
                HYBRID_SEARCH["acoustic_scale"], "-beam",
                HYBRID_SEARCH["beam"], "-max_active", max_active,
                "-save_result_file", result, *extra)

    search = ("-device_search", "-device_batch", DEVICE_SEARCH["batch"],
              "-device", device)

    def graph_b_clis(max_active):
        return {
            "latgen_b_host": ("recipes.latgen", latgen_args(
                gb_dir / "graph", work / "b_host.txt", max_active)),
            "latgen_b_auto": ("recipes.latgen", latgen_args(
                gb_dir / "graph", work / "b_auto.txt", max_active,
                *search)),
            "latgen_b_dense": ("recipes.latgen", latgen_args(
                gb_dir / "graph", work / "b_dense.txt", max_active,
                *search, "-device_mode", "dense"))}

    clis = {
        "latgen_a_auto": ("recipes.latgen", latgen_args(
            exp / "graph", work / "a_auto.txt", recipe_ma, *search)),
        "latgen_a_frontier": ("recipes.latgen", latgen_args(
            exp / "graph", work / "a_frontier.txt", recipe_ma, *search,
            "-device_mode", "frontier")),
        **graph_b_clis(recipe_ma),
        "align_ctm_topo": ("tools.align_ctm", (
            "-lexicon", exp / "lexicon.txt", "-phones", data / "phones.txt",
            "-text", data / "test" / "text", "-acoustic_scale",
            HYBRID_SEARCH["acoustic_scale"], "-topo",
            gb_dir / "lang" / "topo", f"scp:{exp / 'post.scp'}",
            work / "topo.ctm"))}

    def cli(item):
        name, (module, args) = item
        t0 = time.perf_counter() - t_phase
        wall, start, text = _run_cli(hw, work / f"{name}.log", module,
                                     *args)
        row = {"wall_s": wall, "startup_s": start, "started_s": t0}
        if "-device_search" in args:
            found = re.findall(FALLBACK_RE, text)
            fallbacks[f"cli {name}"] = int(found[0][0]) if found else None
            row["decoding_s"] = float(found[0][1]) if found else None
            picked = re.findall(SEARCH_LOG_RE, text)
            row["picked"] = picked[0][0] if picked else None
        out["clis"][name] = row

    pool = concurrent.futures.ThreadPoolExecutor(len(clis))
    running = [pool.submit(cli, item) for item in clis.items()]

    # 2. in this process
    def host_decode(name, utts, frames_cut=None):
        t0 = time.perf_counter()
        res = [latgen(graphs[name], posts[k][:frames_cut], **HYBRID_SEARCH)
               for k in utts]
        return res, time.perf_counter() - t0

    def device_decode(label, cls, gname, batch, lens, want):
        res, seconds, fb, peak = _search_decode(
            torch, graphs[gname], cls, device, batch, lens, recipe_ma)
        fallbacks[label] = fb
        timings[label] = seconds
        peaks[label] = peak
        checks[f"{label}_vs_host"] = _same_search(
            f"{label} on {device} against the host",
            list(zip(keys if len(res) == len(keys) else cut, res, want)),
            cost_rtol=DEVICE_SEARCH_COST_RTOL, phones=False)
        return res

    batch, lens = _search_batch(posts, keys)
    cut_batch, cut_lens = _search_batch(posts, cut,
                                        DEVICE_SEARCH["cpu_frames"])
    for name in ("A", "B"):
        host[name], timings[f"host_{name}"] = host_decode(name, keys)
        host[f"{name}_cut"], _ = host_decode(name, cut,
                                             DEVICE_SEARCH["cpu_frames"])
    dev["dense_A"] = device_decode("dense_A", DeviceLatgen, "A", batch, lens,
                                   host["A"])
    dev["frontier_A"] = device_decode("frontier_A", FrontierLatgen, "A",
                                      batch, lens, host["A"])
    for name in ("A", "B"):
        dev[f"frontier_{name}_cut"] = device_decode(
            f"frontier_{name}_cut", FrontierLatgen, name, cut_batch,
            cut_lens, host[f"{name}_cut"])
    if profile and str(device).startswith("cuda"):  # where the time goes
        prof_batch, prof_lens = _search_batch(posts, cut,
                                              DEVICE_SEARCH["profile_frames"])
        out["profile"] = {
            f"{name}_{gname}": search_profile(
                torch, graphs[gname], cls, prof_batch, prof_lens, recipe_ma)
            for name, cls in (("dense", DeviceLatgen),
                              ("frontier", FrontierLatgen))
            for gname in ("A", "B")}
        for name, row in out["profile"].items():
            print(f"device search profile {name}: " + json.dumps(row),
                  flush=True)
    out["in_process_s"] = time.perf_counter() - t_phase
    for future in running:
        future.result()
    pool.shutdown()

    # graph B's words against the host's, max_active doubled while the
    # frontier's post-closure cap binds
    max_active_b = recipe_ma
    if (work / "b_dense.txt").read_text() != (work / "b_host.txt").read_text():
        raise AssertionError("latgen -device_search -device_mode dense on "
                             "graph B: not the host decoder's words")
    while (work / "b_auto.txt").read_text() != \
            (work / "b_host.txt").read_text():
        if max_active_b >= 8 * recipe_ma:
            raise AssertionError("latgen -device_search on graph B: not the "
                                 "host decoder's words")
        max_active_b *= 2
        print(f"device search: the frontier's post-closure cap binds on "
              f"graph B; max_active {max_active_b}", flush=True)
        for item in graph_b_clis(max_active_b).items():
            cli(item)
    out["max_active_b"] = max_active_b
    out["clis_s"] = max(r["started_s"] + r["wall_s"]
                        for r in out["clis"].values())
    written = (exp / "decode.txt").read_text().splitlines()
    for mode in ("auto", "frontier"):
        if (work / f"a_{mode}.txt").read_text().splitlines() != written:
            raise AssertionError(f"latgen -device_search -device_mode {mode}"
                                 f" on graph A: not run.sh's decode.txt")
    picked = {g: out["clis"][f"latgen_{g}_auto"]["picked"] for g in "ab"}
    if picked != {"a": "dense", "b": "frontier"}:
        raise AssertionError(f"auto picked {picked} on graphs A and B")
    for name in ("dense", "auto"):
        timings[f"{'frontier' if name == 'auto' else name}_B"] = \
            out["clis"][f"latgen_b_{name}"]["decoding_s"]
    ctm = [line.split() for line in (work / "topo.ctm").read_text()
           .splitlines()]
    plain = [line.split() for line in (exp / "test.ctm").read_text()
             .splitlines()]
    if {r[0] for r in ctm} != set(keys) or not all(
            len(r) == 6 and float(r[3]) > 0 for r in ctm) \
            or [r[4] for r in ctm] != [r[4] for r in plain]:
        raise AssertionError("align_ctm -topo: not a line of positive "
                             "duration for every word of every test "
                             "utterance, or not exp/test.ctm's words")
    out["ctm_lines"] = len(ctm)

    # 3. against the CPU references (taken at the recipe's max_active;
    # graph B's cut again on both devices if the cap bound)
    join_side_checks(torch)
    if max_active_b != recipe_ma:
        ref = SEARCH_REFS["device search frontier on graph B"]
        t0 = time.perf_counter()
        ref["results"], ref["seconds"], ref["host_fallbacks"], _ = \
            _search_decode(torch, graphs["B"], FrontierLatgen, "cpu",
                           cut_batch, cut_lens, max_active_b)
        cpu_reference_done(f"device search frontier on graph B at "
                           f"max_active {max_active_b}",
                           time.perf_counter() - t0)
        dev["frontier_B_cut"], _, fallbacks["frontier_B_cut"], _ = \
            _search_decode(torch, graphs["B"], FrontierLatgen, device,
                           cut_batch, cut_lens, max_active_b)
    for name, label in (("dense_A", "device search dense on graph A"),
                        ("frontier_A_cut",
                         "device search frontier on graph A"),
                        ("frontier_B_cut",
                         "device search frontier on graph B")):
        ref = SEARCH_REFS[label]
        fallbacks[f"cpu {name}"] = ref["host_fallbacks"]
        checks[f"{name}_vs_cpu"] = _same_search(
            f"{name} on {device} against the CPU",
            list(zip(ref["keys"], dev[name], ref["results"])),
            cost_atol=HYBRID_COST_ATOL)
        checks[f"{name}_vs_cpu"]["cpu_s"] = ref["seconds"]
    if any(v != 0 for v in fallbacks.values()):
        raise AssertionError(f"device search: host fallbacks {fallbacks}")
    out.update({
        "checks": checks, "host_fallbacks": fallbacks,
        "seconds": timings, "peak_bytes": peaks,
        "s_per_audio_s": {k: v / audio_s for k, v in timings.items()
                          if not k.endswith("_cut")},
        "phase_s": time.perf_counter() - t_phase})
    print("device search: " + json.dumps(out))
    return out


# the tools phase: the native latgen core against the Python token passer
# on the hybrid phase's posteriors over graphs A and B, the port's RTF
# bench (tools/bench_rtf.py) in this process and as a CLI, an nnet1 proto
# DNN (tools/make_nnet_proto.py, models/proto.py) card against CPU, a
# profile (utils/metrics.profile_trace) and its summary
# (tools/trace_summary.py), and the device list (tools/devices.py)
TOOLS = {"noise": 0.1, "lattice_utts": 2, "nbest": 10, "session_sec": 6,
         "chunk": 40,
         # Kaldi nnet1's steps/nnet/train.sh DNN: 4 hidden layers of 1,024
         # sigmoids over 11 spliced 40-dim frames, TIMIT's 2,500 leaves
         "proto": ("dnn", "440", "2500", "4", "1024", "--with-dropout",
                   "0.1"),
         "proto_feat_dim": 40, "proto_splice": 5, "proto_utts": 8,
         "proto_frames": 800}
# native core against the Python token passer: the same float64 sums
NATIVE_COST_ATOL = 1e-9
# the proto DNN's forward, card against CPU, of the output's largest entry
PROTO_FWD_RTOL = 1e-5


def noisy_posteriors(posts, keys, scale=TOOLS["noise"]):
    """Each utterance's posteriors with bench_rtf's noise: normal of
    ``scale`` added, renormalised (``bench_rtf._batched_posts``, seeded 1
    + the utterance's index)."""
    from pytorch_kaldi_asr_tpu_torch.tools.bench_rtf import _batched_posts

    return {k: _batched_posts(posts[k].astype("float64"), 1, seed=1 + i)[0][0]
            for i, k in enumerate(keys)}


def lattice_form(lat):
    """What a lattice says, without its node numbering: the node times,
    the distinct links (their times, word and costs) and the finals
    (their time and weight).  The native core records links in its hash
    maps' order, so its node ids and its count of duplicate links differ
    from the Python token passer's."""
    times = lat.node_times
    return (sorted(times),
            sorted({(times[l.start], times[l.end], l.word, l.acoustic,
                     l.graph) for l in lat.links}),
            sorted((times[n], w) for n, w in lat.finals.items()))


def _proto_step_on(torch, device, params, comps, batch, seed=0):
    """One frame cross-entropy step of the proto model ``comps`` from
    ``params`` on ``device`` with dropout on (its seeds from ``seed``):
    (loss, {(component, name): gradient on the CPU in float64})."""
    from pytorch_kaldi_asr_tpu_torch.models.common import DropoutRngs
    from pytorch_kaldi_asr_tpu_torch.models.proto import apply_proto

    feats, labels = batch
    ps = [{k: v.detach().to(device, copy=True).requires_grad_()
           for k, v in p.items()} for p in params]
    out = apply_proto(ps, comps, torch.as_tensor(feats, device=device),
                      train=True,
                      rngs=DropoutRngs(torch.Generator().manual_seed(seed)))
    lab = torch.as_tensor(labels, device=device)
    loss = -torch.log(torch.take_along_dim(out, lab[..., None], -1)
                      + 1e-8).mean()
    loss.backward()
    return float(loss.detach()), {(i, k): p[k].grad.cpu().double()
                         for i, p in enumerate(ps) for k in p}


def proto_setup(torch):
    """The TOOLS["proto"] DNN, ``make_nnet_proto``'s text behind a
    <Splice> of +-TOOLS["proto_splice"] frames: (proto text, parsed
    components, parameters on the CPU, (features, frame labels))."""
    import io

    import numpy as np

    from pytorch_kaldi_asr_tpu_torch.models.proto import (
        init_proto,
        parse_proto,
        proto_output_dim,
    )
    from pytorch_kaldi_asr_tpu_torch.tools import make_nnet_proto

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        make_nnet_proto.main(list(TOOLS["proto"]))
    d, c = TOOLS["proto_feat_dim"], TOOLS["proto_splice"]
    text = (f"<Splice> <InputDim> {d} <OutputDim> {d * (2 * c + 1)} "
            f"<Context> {':'.join(str(i) for i in range(-c, c + 1))}\n"
            + buf.getvalue())
    comps = parse_proto(text)
    params = init_proto(torch.Generator().manual_seed(SEED), comps)
    rng = np.random.default_rng(SEED)
    shape = (TOOLS["proto_utts"], TOOLS["proto_frames"])
    feats = rng.normal(size=(*shape, d)).astype(np.float32)
    labels = rng.integers(0, proto_output_dim(comps), size=shape)
    return text, comps, params, (feats, labels)


def proto_masks_equal(torch, comps, batch, device, seed=0):
    """Each <Dropout> site's mask of ``_proto_step_on``'s step with seed
    ``seed``, on ``device`` and on the CPU (the K3 check's way: the
    kernel's pass against its plain version on the same seed and shape):
    the mismatched elements per site."""
    from pytorch_kaldi_asr_tpu_torch.models.common import DropoutRngs, dropout

    rngs = DropoutRngs(torch.Generator().manual_seed(seed))
    out = []
    for comp in comps:
        if comp["type"] != "<Dropout>":
            continue
        rate = 1.0 - float(comp["DropoutRetention"])
        s = rngs.seed()
        shape = (*batch[0].shape[:2], int(comp["OutputDim"]))
        card = dropout(torch.ones(shape, device=device), rate, s, True)
        cpu = dropout(torch.ones(shape), rate, s, True)
        out.append(int((card.cpu() != cpu).sum()))
    return out


def _run_bench_cli(work, *args):
    """``python -m pytorch_kaldi_asr_tpu_torch.tools.bench_rtf`` as a
    process, started at once; ``_finish_bench_cli`` waits for it."""
    log = open(work / "bench_rtf_cli.log", "w")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "pytorch_kaldi_asr_tpu_torch.tools.bench_rtf",
         *map(str, args)], cwd=str(REPO), stdout=subprocess.PIPE,
        stderr=log, text=True,
        env=dict(os.environ, PYTHONPATH=str(REPO), PYTHONUNBUFFERED="1"))
    return proc, log, t0


def _finish_bench_cli(run):
    proc, log, t0 = run
    stdout, _ = proc.communicate(timeout=300)
    log.close()
    if proc.returncode != 0:
        raise AssertionError(f"bench_rtf CLI exited {proc.returncode}: "
                             f"{Path(log.name).read_text()[-3000:]}")
    rows = [json.loads(line) for line in stdout.splitlines()
            if line.startswith("{")]
    return rows, time.perf_counter() - t0


def profile_attention(torch, work, device="cuda", attempts=PROFILE_ATTEMPTS):
    """``profile_trace`` around one session of bench_streaming_conformer's
    push loop and one offline forward of the same conformer AM over the
    session's audio (the streaming chunks attend through an einsum over
    [cache | chunk], as JAX's do: the inference kernel K1 runs in the
    offline forward), then ``trace_summary``: the device track's rows must
    name ``banded_attention_kernel``, and the by-launching-op view must
    attribute all of its time to the attention call (the wrapper's
    ``banded_attention`` range).  A trace that lost the kernel's records
    is taken again (``attempts`` in all).  Returns the tables and
    readings."""
    from pytorch_kaldi_asr_tpu_torch.models.am import am_log_posteriors
    from pytorch_kaldi_asr_tpu_torch.tools import bench_rtf, trace_summary
    from pytorch_kaldi_asr_tpu_torch.utils.metrics import profile_trace

    stream, feats = bench_rtf.streaming_conformer_setup(device=device)
    src = torch.as_tensor(feats, device=device)
    mask = torch.ones(src.shape[:2], dtype=torch.uint8, device=device)

    def run():
        bench_rtf.stream_session(stream, feats, TOOLS["chunk"])
        with torch.no_grad():
            am_log_posteriors(stream.params, stream.cfg, src, mask)[0].cpu()

    run()  # warm
    for attempt in range(1, attempts + 1):
        log_dir = _fresh(work / "trace")
        before = launch_counts()["banded_attention"]
        with profile_trace(str(log_dir)):
            run()
        launched = launch_counts()["banded_attention"] - before
        # every row (K1's may rank low on the device track); 12 printed
        summary = trace_summary.summarize(str(log_dir), top=10 ** 9)
        by_op = trace_summary.summarize_by_source(str(log_dir), top=10 ** 9)
        k1 = {track: [r for r in s["rows"]
                      if "banded_attention_kernel" in r[0]]
              for track, s in summary.items()}
        k1 = {t: rows for t, rows in k1.items() if rows}
        if k1:
            break
        print(f"torch.profiler lost the K1 records (attempt {attempt} of "
              f"{attempts})", flush=True)
    if not k1:
        raise AssertionError("trace_summary: no banded_attention_kernel row "
                             "on any track")
    (track, rows), = k1.items()
    k1_us, k1_calls = sum(r[1] for r in rows), sum(r[2] for r in rows)
    # the by-launching-op view names its device track by the process's
    # label ("GPU 0"); JAX's per-track view by the name it has seen
    attributed = {t: {r[0]: (r[1], r[4]) for r in v["rows"]}
                  for t, v in by_op.items()}
    ours = [(t, row["banded_attention"]) for t, row in attributed.items()
            if "banded_attention" in row]
    if len(ours) != 1 or abs(ours[0][1][0] - k1_us) > 1e-6 * k1_us \
            or ours[0][1][1] != k1_calls or k1_calls != launched:
        raise AssertionError(
            f"trace_summary by launching op: {ours}, K1 {k1_us} us over "
            f"{k1_calls} calls on {track}, {launched} launches counted")

    def top(tables, *keys):
        return {t: dict(v, **{k: v[k][:12] for k in keys})
                for t, v in tables.items()}

    return {"track": track, "by_op_track": ours[0][0], "k1_rows": rows,
            "k1_us": k1_us, "k1_calls": k1_calls,
            "k1_launches_counted": launched, "attempts": attempt,
            "md": trace_summary.format_md(top(summary, "rows")),
            "source_md": trace_summary.format_source_md(
                top(by_op, "rows", "category_rows"))}


# the native host core under the recipe's data (run_native_host): the
# matrix kinds the core reads, and how many reads each reader is timed on
NATIVE_KINDS = ("FM", "DM", "CM", "CM2", "CM3")
NATIVE_TIMED_READS = 1000
# the train steps fed from a CM feats.scp (the recipe's train set)
NATIVE_STEPS = 2
# the kinds tools.feat_to_len runs on as a process (each about 1 s)
NATIVE_CLI_KINDS = ("FM", "CM2")


def _write_kind(kaldi_io, mats, folder, kind, text):
    """``mats`` as a ``kind`` ark (a DM from the features in float64) with
    its feats.scp, and ``text``, in ``folder``: a data dir."""
    folder.mkdir(parents=True)
    compress = kind if kind.startswith("CM") else False
    with kaldi_io.ArkWriter(str(folder / "feats.ark"),
                            str(folder / "feats.scp"),
                            compress=compress) as w:
        for key, mat in mats.items():
            w.write(key, mat.astype("float64") if kind == "DM" else mat)
    shutil.copy(text, folder / "text")
    return folder


@contextlib.contextmanager
def one_reader(which):
    """Within: every matrix ``io/kaldi_io`` reads goes through one reader.
    ``"native"``: the Python readers' binary decoding and header reads
    raise, so only the native core can feed a caller; ``"python"``: the
    header peek says no and the core's entry points raise, so only the
    Python readers can.  Yields a list that counts the chosen reader's matrix
    reads."""
    from pytorch_kaldi_asr_tpu_torch import native
    from pytorch_kaldi_asr_tpu_torch.io import kaldi_io

    reads = []

    def blocked(*args):
        raise AssertionError(f"the {'Python' if which == 'native' else 'native'}"
                             f" reader was called under one_reader({which!r})")

    def counted(fn):
        def read(*args):
            reads.append(args[-1])
            return fn(*args)
        return read

    saved = [(kaldi_io, n, getattr(kaldi_io, n)) for n in
             ("_read_matrix_binary", "_read_matrix_header_binary",
              "_peek_native", "read_mat_python")]
    saved += [(native, n, getattr(native, n)) for n in
              ("read_mat_fd", "mat_header_fd", "scan_ark")]
    try:
        if which == "native":
            kaldi_io._read_matrix_binary = blocked
            kaldi_io._read_matrix_header_binary = blocked
            native.read_mat_fd = counted(native.read_mat_fd)
        else:
            kaldi_io._peek_native = lambda rx: None
            kaldi_io.read_mat_python = counted(kaldi_io.read_mat_python)
            native.read_mat_fd = native.mat_header_fd = blocked
            native.scan_ark = blocked
        yield reads
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


def _words(torch, t):
    """``t``'s bits as integers of its width."""
    return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[
        t.element_size()])


def _cli_bytes(cmd, out=None):
    """Run ``cmd``; its stdout (or the file ``out``) and its wall
    seconds.  Fails unless it exits 0."""
    t0 = time.perf_counter()
    proc = subprocess.run([str(c) for c in cmd], capture_output=True,
                          env=dict(os.environ, PYTHONPATH=str(REPO)))
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{cmd} exited {proc.returncode}: "
                             f"{proc.stderr.decode()[-2000:]}")
    return (Path(out).read_bytes() if out else proc.stdout), wall


def native_host_clis(dirs, decode_dir, ref):
    """The CPU-only checks of run_native_host, for the side thread: (a)
    ``pka-tools`` built from the checkout's sources; (c) ``pka-feat-to-len``
    (scp input) against ``tools.feat_to_len`` as processes over ``scp:``
    and ``ark:`` of the NATIVE_CLI_KINDS in ``dirs``: the same ``.length``
    bytes; (d)
    ``pka-compute-wer`` against ``tools.compute_wer`` as processes on the
    recipe's test decode (``decode_dir``/scoring/rescore_10.0 against the
    reference ``ref``), in ``present`` and ``all`` modes, and
    ``score.wer`` in this process on every rescore file of both scoring
    dirs: the same three lines byte for byte.  Every process
    is its own, so the main thread's ``one_reader`` does not reach them.
    Returns the readings and walls."""
    from pytorch_kaldi_asr_tpu_torch import native
    from pytorch_kaldi_asr_tpu_torch.io import kaldi_io
    from pytorch_kaldi_asr_tpu_torch.score.wer import (
        compute_wer,
        format_wer_report,
    )

    t0 = time.perf_counter()
    tools, log = native.build_tools()
    out = {"tools": {"dir": tools.name, "files": sorted(
        p.name for p in tools.iterdir()), "built_here": log is not None,
        "build_s": time.perf_counter() - t0}}
    py = [sys.executable, "-m"]
    lengths = {}
    for kind, d in ((k, dirs[k]) for k in NATIVE_CLI_KINDS):
        want, _ = _cli_bytes([tools / "pka-feat-to-len", f"scp:{d}/feats.scp",
                              f"ark,t:{d}/pka.length"], d / "pka.length")
        for spec in ("scp", "ark"):
            src = d / f"feats.{spec}"
            got, wall = _cli_bytes(
                [*py, "pytorch_kaldi_asr_tpu_torch.tools.feat_to_len",
                 f"{spec}:{src}", f"ark,t:{d}/{spec}.length"],
                d / f"{spec}.length")
            if got != want or not want:
                raise AssertionError(f"feat_to_len {spec}:{src}: not "
                                     f"pka-feat-to-len's bytes")
            lengths[f"{kind}_{spec}"] = wall
    out["feat_to_len_s"] = lengths
    hyps = sorted(p for p in decode_dir.glob("scoring*/rescore_*")
                  if not p.name.endswith("_wer"))
    one = decode_dir / "scoring" / "rescore_10.0"
    walls = {}
    for mode in ("present", "all"):
        args = [f"--mode={mode}", f"ark:{ref}", f"ark:{one}"]
        want, walls[f"pka_{mode}"] = _cli_bytes(
            [tools / "pka-compute-wer", *args])
        got, walls[f"python_{mode}"] = _cli_bytes(
            [*py, "pytorch_kaldi_asr_tpu_torch.tools.compute_wer", *args])
        if got != want or len(want.splitlines()) != 3:
            raise AssertionError(f"compute_wer --mode={mode} {one}: "
                                 f"{got!r} against pka-compute-wer's "
                                 f"{want!r}")
        refs = kaldi_io.read_key_value_text(str(ref))
        for hyp in hyps:
            report = format_wer_report(compute_wer(
                refs, kaldi_io.read_key_value_text(str(hyp)), mode=mode))
            pka, _ = _cli_bytes([tools / "pka-compute-wer", f"--mode={mode}",
                                 f"ark:{ref}", f"ark:{hyp}"])
            if report.encode() != pka:
                raise AssertionError(f"score.wer on {hyp} ({mode}): "
                                     f"{report!r} against {pka!r}")
    out["compute_wer_s"] = walls
    out["compute_wer_files"] = len(hyps)
    out["report"] = want.decode()
    return out


def run_native_host(torch, recipe_work, device="cuda", knobs=None):
    """The native host core (native/src/ark_io.cc, edit_distance.cc,
    tools_main.cc) under the recipe phase's data (``recipe_work``: run.sh's
    corpus, checkpoints and decode output), in order:

    a. the library built from the checkout's sources (by the first CLI of
       run.sh that read a matrix; its file name, and whether this call
       built it), ``pka-tools`` and its links on the side thread;
    b. the test set's features (data/test_filtered, after CMVN) written as
       FM, DM, CM, CM2 and CM3 arks with their feats.scp: the core's
       ``read_mat`` against the Python readers' on every matrix, 0 words
       apart, a DM as float64; each reader's seconds per 1,000 matrices
       over NATIVE_TIMED_READS reads, beside an open and close of the
       file;
    c. and d. on the side thread (``native_host_clis``), beside e and f;
    e. the CM2 test set decoded on ``device`` with run.sh's combined
       checkpoint and stage-5 flags, fed by the core alone
       (``one_reader("native")``): K1 launched, and the n-best file
       byte for byte that of the same decode fed by the Python readers
       alone (its launches not counted);
    f. NATIVE_STEPS train steps from run.sh's model.init on its training
       set written as CM at its batch size, fed by the core alone: K2a-c at
       en_layers and K3 at the dropout sites each way per step, exactly;
       every step's loss and the updated parameters bit for bit those of
       the same steps fed by the Python readers alone.

    ``knobs``: those run.sh ran with, over RECIPE_KNOBS (its model dir,
    batch size and stage-5 flags).  Returns the readings, seconds and the
    launches of e and f."""
    import numpy as np

    from pytorch_kaldi_asr_tpu_torch import native
    from pytorch_kaldi_asr_tpu_torch.data import read_vocab
    from pytorch_kaldi_asr_tpu_torch.data.loader import (
        make_batch_loader,
        to_device,
    )
    from pytorch_kaldi_asr_tpu_torch.io import kaldi_io
    from pytorch_kaldi_asr_tpu_torch.models.transformer import tree_map
    from pytorch_kaldi_asr_tpu_torch.recipes import decode
    from pytorch_kaldi_asr_tpu_torch.train import (
        create_train_state,
        load_checkpoint,
        train_step,
    )
    from pytorch_kaldi_asr_tpu_torch.train.optim import named_leaves

    t_phase = time.perf_counter()
    knobs = dict(RECIPE_KNOBS, **(knobs or {}))
    rw = Path(recipe_work).resolve()
    model_dir = rw / knobs["model_dir"]
    work = _fresh(WORK / "native_host")
    sync = _sync(torch, device)
    out = {}

    # a. the library
    t0 = time.perf_counter()
    lib, log = native.build()
    out["library"] = {"file": lib.name, "built_here": log is not None,
                      "build_s": time.perf_counter() - t0}

    # b. the test set in every kind; the core against the Python readers
    test = rw / "data" / "test_filtered"
    feats = dict(kaldi_io.read_mat_scp(str(test / "feats.scp")))
    dirs = {kind: _write_kind(kaldi_io, feats, work / f"test_{kind}", kind,
                              test / "text") for kind in NATIVE_KINDS}
    apart, rxs = {}, []
    for kind, d in dirs.items():
        n = 0
        for key, rx in kaldi_io.scp_entries(str(d / "feats.scp")):
            got, want = native.read_mat(rx), kaldi_io.read_mat_python(rx)
            dtype = np.float64 if kind == "DM" else np.float32
            if got.dtype != dtype or want.dtype != dtype \
                    or got.shape != want.shape:
                raise AssertionError(f"{kind} {key}: {got.dtype} "
                                     f"{got.shape} against {want.dtype} "
                                     f"{want.shape}")
            view = np.uint64 if kind == "DM" else np.uint32
            n += int((got.view(view) != want.view(view)).sum())
            rxs.append(rx)
        apart[kind] = n
    if any(apart.values()):
        raise AssertionError(f"the native read_mat against the Python "
                             f"readers: {apart} words apart")
    reads = (rxs * (-(-NATIVE_TIMED_READS // len(rxs))))[:NATIVE_TIMED_READS]
    per_1000 = {}

    def open_close(rx):  # what one read costs the host before any byte
        os.close(os.open(kaldi_io._split_offset(rx)[0], os.O_RDONLY))

    for name, fn in (("native", kaldi_io.read_mat),
                     ("python", kaldi_io.read_mat_python),
                     ("open_close", open_close)):
        t0 = time.perf_counter()
        for rx in reads:
            fn(rx)
        per_1000[name] = (time.perf_counter() - t0) * 1000 / len(reads)
    out["read_mat"] = {"matrices": len(feats), "words_apart": apart,
                       "frames": int(sum(m.shape[0] for m in feats.values())),
                       "dim": int(next(iter(feats.values())).shape[1]),
                       "s_per_1000": per_1000}
    print(f"native read_mat against the Python readers on the recipe's test "
          f"set ({len(feats)} matrices in each of {', '.join(dirs)}): 0 "
          f"words apart, DM float64", flush=True)
    # the training set as CM, for f
    train_dir = rw / "data" / "train_filtered"
    train_cm = _write_kind(
        kaldi_io, dict(kaldi_io.read_mat_scp(str(train_dir / "feats.scp"))),
        work / "train_CM", "CM", train_dir / "text")

    # c. and d. on the side thread, beside the card's work
    defer_side_check("native host CLIs", lambda: native_host_clis(
        dirs, model_dir / "decode_test", test / "text"))
    start_side_checks(torch)

    # e. the CM2 test set decoded, fed by the core alone
    vocab = rw / "data" / "language" / "vocab.txt"
    combined = sorted(model_dir.glob("combined*"))[-1]
    dec = {k: knobs.get(k, v) for k, v in RECIPE_DECODE.items()}
    flags = ["-max_token_seq_len", dec["max_token_seq_len"], "-batch_size",
             dec["decode_batch"], "-beam_size", dec["beam_size"], "-nbest",
             dec["nbest"], "-device", device]
    decodes = {}
    for which in ("native", "python"):
        result = work / f"decode_{which}.txt"
        with one_reader(which) as n_reads:
            reset_launch_counts()
            t0 = time.perf_counter()
            decode.main(["-read_data_dir", str(dirs["CM2"]),
                         "-read_vocab_file", str(vocab), "-load_model_file",
                         str(combined), "-save_result_file", str(result),
                         *flags])
            sync()
            decodes[which] = {"s": time.perf_counter() - t0,
                              "reads": len(n_reads),
                              "launches": launch_counts()}
    launches = decodes["native"]["launches"]
    cuda = device.startswith("cuda")
    if decodes["native"]["reads"] < len(feats) \
            or bool(launches["banded_attention"]) != cuda \
            or any(n for k, n in launches.items()
                   if k != "banded_attention"):
        raise AssertionError(f"the CM2 decode fed by the native core: "
                             f"{decodes['native']}")
    if (work / "decode_native.txt").read_bytes() != \
            (work / "decode_python.txt").read_bytes():
        raise AssertionError("the CM2 decode fed by the native core is not "
                             "the Python readers' n-best")
    out["decode"] = {k: {"s": v["s"], "reads": v["reads"]}
                     for k, v in decodes.items()}
    print(f"the CM2 test set decoded on {device}, fed by the native core "
          f"alone: K1 {launches['banded_attention']} launches, the n-best "
          f"of the Python readers' decode byte for byte; "
          + json.dumps(out["decode"]), flush=True)

    # f. train steps from a CM feats.scp, fed by the core alone
    ckpt = load_checkpoint(str(model_dir / "model.init"))
    cfg = ckpt["cfg"]
    batch = int(knobs.get("batch_size", 100))  # run.sh's default
    steps = {}
    for which in ("native", "python"):
        with one_reader(which) as n_reads:
            loader = make_batch_loader(str(train_cm), read_vocab(str(vocab)),
                                       batch, mode="drop", shuffle=False)
            state = create_train_state(tree_map(
                lambda t: t.detach().to(device, copy=True), ckpt["params"]))
            reset_launch_counts()
            losses = []
            t0 = time.perf_counter()
            for _, b in zip(range(NATIVE_STEPS), loader):
                b = to_device(b, device)
                m = train_step(state, cfg, b.src, b.src_mask, b.tgt,
                               b.tgt_mask)
                losses.append(float(m["loss"]))
            sync()
            steps[which] = {
                "s": time.perf_counter() - t0, "losses": losses,
                "reads": len(n_reads), "launches": launch_counts(),
                "params": {p: t.detach().cpu() for p, t in
                           named_leaves(state.params)}}
    sites = dropout_sites(cfg)
    want = {f"banded_attention_{k}": NATIVE_STEPS * cfg.en_layers
            for k in ("fwd", "dq", "dkv")}
    for way in ("forward", "backward"):
        for dtype, sfx in (("float32", ""), ("bfloat16", "_bf16")):
            want[f"fused_dropout_{way}{sfx}"] = NATIVE_STEPS * sites[dtype]
    if cuda:
        check_step_launches("the train steps fed by the native core",
                            steps["native"]["launches"], want)
    nat, pyt = steps["native"], steps["python"]
    words = sum(int((_words(torch, nat["params"][p])
                     != _words(torch, pyt["params"][p])).sum())
                for p in nat["params"])
    if len(nat["losses"]) != NATIVE_STEPS or nat["reads"] < NATIVE_STEPS \
            or nat["losses"] != pyt["losses"] or words:
        raise AssertionError(
            f"the train steps fed by the native core: losses "
            f"{nat['losses']} against the Python readers' {pyt['losses']}, "
            f"{words} parameter words apart, {nat['reads']} reads")
    out["steps"] = {k: {"s": v["s"], "losses": v["losses"],
                        "reads": v["reads"]} for k, v in steps.items()}
    out["steps"]["parameter_words_apart"] = words
    print(f"{NATIVE_STEPS} train steps on {device} from a CM feats.scp fed "
          f"by the native core alone: losses {nat['losses']}, the Python "
          f"readers' bit for bit, 0 parameter words apart; launches "
          + json.dumps({k: v for k, v in nat["launches"].items() if v}),
          flush=True)
    out["launches"] = {k: decodes["native"]["launches"][k]
                       + nat["launches"][k] for k in launches}

    # c. and d.: joined
    t0 = time.perf_counter()
    out["clis"] = join_side_checks(torch)["native host CLIs"]["result"]
    out["side_wait_s"] = time.perf_counter() - t0
    walls = out["clis"]["compute_wer_s"]
    print(f"native host core: read_mat "
          f"{per_1000['native']:.4f} s per 1,000 matrices, the Python readers "
          f"{per_1000['python']:.4f}, an open and close "
          f"{per_1000['open_close']:.4f} ({out['read_mat']['frames']} frames of "
          f"{out['read_mat']['dim']} in {len(feats)} matrices, each kind); "
          f"pka-compute-wer {walls['pka_present']:.3f} s, python -m "
          f"tools.compute_wer {walls['python_present']:.3f} s (--mode="
          f"present); {card_line() if cuda else 'cpu'}",
          flush=True)
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def run_tools(torch, hybrid_work, recipe_work, device="cuda"):
    """The tools phase over the hybrid phase's ``hybrid_work`` (its card
    posteriors, exp/post.scp, and HLG, graph A) and graph B (built by
    ``build_graph_b`` under WORK/device_search/graph_b), in order:

    1. the native latgen core (``native.build``; run.sh's latgen built it
       already) against the Python token passer (``native=False``) over
       the test set on graphs A and B at the recipe's knobs, on the
       trained AM's posteriors and on noisy ones (``noisy_posteriors``):
       the same words and phones, costs within NATIVE_COST_ATOL, each
       decoder's seconds; ``latgen_lattice`` both ways on graph A over
       TOOLS["lattice_utts"] utterances at the lattice phase's beam: the
       same lattice up to node numbering and duplicate links
       (``lattice_form``) and the same TOOLS["nbest"]-best, costs within
       NATIVE_COST_ATOL;
    2. bench_rtf in this process at its defaults (posterior, decode,
       streaming, hybrid, hybrid_device; partials at TOOLS["session_sec"]
       s), and its CLI as a process with ``--which posterior``, started
       with step 1;
    3. the proto DNN (``proto_setup``): its forward at ``train=False``,
       card against CPU within PROTO_FWD_RTOL of the output's largest
       entry, and one frame-CE step with dropout on (``card_vs_cpu_step``
       with ``_proto_step_on``: loss, and each leaf within STEP_GRAD_RTOL
       or F32_NOISE_RATIO times the CPU's one-ulp noise);
    4. ``profile_attention``;
    5. K3 launched once a dropout site each way in the step, K1 in the
       profile; the step's masks card against CPU (``proto_masks_equal``,
       after the counts are read: comparison launches do not count) all
       equal;
    6. the native host core under the recipe phase's data
       (``run_native_host`` over ``recipe_work``: its reads, CLIs, a
       decode and train steps fed by the core alone, its K1, K2a-c and K3
       launches counted apart from 2-5's and added to them); the device
       list (``tools.devices``).

    Returns the readings, the launches and the seconds."""
    import numpy as np

    from pytorch_kaldi_asr_tpu_torch import native
    from pytorch_kaldi_asr_tpu_torch.decode.latgen import (
        latgen,
        latgen_lattice,
    )
    from pytorch_kaldi_asr_tpu_torch.decode.lattice_ops import nbest
    from pytorch_kaldi_asr_tpu_torch.fst.openfst_io import read_fst
    from pytorch_kaldi_asr_tpu_torch.io import kaldi_io
    from pytorch_kaldi_asr_tpu_torch.models.proto import apply_proto
    from pytorch_kaldi_asr_tpu_torch.recipes.mkgraph import read_symbol_table
    from pytorch_kaldi_asr_tpu_torch.tools import bench_rtf, devices

    t_phase = time.perf_counter()
    hw = Path(hybrid_work).resolve()
    exp, data = hw / "exp", hw / "data"
    work = _fresh(WORK / "tools")
    cli = _run_bench_cli(work, "--which", "posterior", "--device", device)
    out = {"knobs": dict(HYBRID_SEARCH, **TOOLS), "seconds": {}}

    # 1. the native core against the Python token passer
    t0 = time.perf_counter()
    lib, log = native.build()
    out["native"] = {"library": lib.name, "built_here": log is not None,
                     "build_s": time.perf_counter() - t0}
    posts = _search_posts(hw)
    keys = sorted(posts)
    frames = kaldi_io.read_key_value_text(str(data / "test" /
                                              "feats.length"), int)
    audio_s = 0.010 * sum(frames[k] for k in keys)
    noisy = noisy_posteriors(posts, keys)
    graphs = {"A": read_fst(str(exp / "graph" / "HLG.fst")),
              "B": read_fst(str(WORK / "device_search" / "graph_b" / "graph"
                                / "HLG.fst"))}
    decodes = {}
    for gname, graph in graphs.items():
        for pname, pp in (("trained", posts), ("noisy", noisy)):
            res = {}
            for name, flag in (("native", True), ("python", False)):
                t0 = time.perf_counter()
                res[name] = [latgen(graph, pp[k], native=flag,
                                    **HYBRID_SEARCH) for k in keys]
                seconds = time.perf_counter() - t0
                decodes[f"{name}_{gname}_{pname}"] = {
                    "s": seconds, "s_per_audio_s": seconds / audio_s}
            check = _same_search(
                f"native latgen against the Python token passer on graph "
                f"{gname}, {pname} posteriors",
                list(zip(keys, res["native"], res["python"])),
                cost_atol=NATIVE_COST_ATOL)
            n, p = (decodes[f"{x}_{gname}_{pname}"]["s"]
                    for x in ("native", "python"))
            decodes[f"check_{gname}_{pname}"] = dict(check, speedup=p / n)
            print(f"native latgen on graph {gname}, {pname} posteriors: "
                  f"{n:.4f} s ({n / audio_s:.6f} s per s of audio), the "
                  f"Python token passer {p:.3f} s ({p / audio_s:.6f}); "
                  f"{p / n:.1f} x; the same words and phones, costs "
                  f"{check['max_cost_gap']:.3g} apart", flush=True)
    out["decodes"] = decodes
    out["audio_s"] = audio_s
    words = read_symbol_table(str(exp / "graph" / "words.txt"))
    id2word = {i: w for w, i in words.items()}
    lats = {}
    for name, flag in (("native", True), ("python", False)):
        t0 = time.perf_counter()
        lats[name] = [latgen_lattice(
            graphs["A"], posts[k], lattice_beam=LATTICE["lattice_beam"],
            id2word=id2word, utt=k, native=flag, **HYBRID_SEARCH)
            for k in keys[:TOOLS["lattice_utts"]]]
        out["seconds"][f"lattice_{name}"] = time.perf_counter() - t0
        with open(work / f"lat_{name}.txt", "w", encoding="utf-8") as f:
            for lat in lats[name]:
                f.write(f"{lat.utt}\n")
                lat.write_kaldi_text(f)
                f.write("\n")
    sizes = []
    for a, b in zip(lats["native"], lats["python"]):
        if lattice_form(a) != lattice_form(b):
            raise AssertionError(f"latgen_lattice {a.utt}: the native "
                                 f"core's lattice is not the Python's")
        na, nb = nbest(a, TOOLS["nbest"]), nbest(b, TOOLS["nbest"])
        if [w for w, _ in na] != [w for w, _ in nb] or any(
                abs(x - y) > NATIVE_COST_ATOL
                for (_, x), (_, y) in zip(na, nb)):
            raise AssertionError(f"latgen_lattice {a.utt}: n-best differs")
        sizes.append({"utt": a.utt, "nodes": a.num_nodes,
                      "links_native": len(a.links),
                      "links_python": len(b.links),
                      "distinct_links": len(lattice_form(a)[1])})
    out["lattices"] = sizes
    print(f"latgen_lattice native against Python on graph A: the same "
          f"lattices up to node numbering and duplicate links, the same "
          f"{TOOLS['nbest']}-best: {sizes}; native "
          f"{out['seconds']['lattice_native']:.3f} s, Python "
          f"{out['seconds']['lattice_python']:.3f} s", flush=True)
    out["seconds"]["native_vs_python"] = time.perf_counter() - t_phase

    # 2. bench_rtf in this process (the phase's main path from here on)
    reset_launch_counts()
    benches = {}
    for name, fn in (("posterior", bench_rtf.bench_offline_posteriors),
                     ("decode", bench_rtf.bench_decode),
                     ("streaming", bench_rtf.bench_streaming_conformer),
                     ("hybrid", bench_rtf.bench_hybrid),
                     ("hybrid_device", bench_rtf.bench_hybrid_device)):
        t0 = time.perf_counter()
        benches[name] = fn(device=device)
        out["seconds"][f"bench_{name}"] = time.perf_counter() - t0
        print("bench_rtf " + json.dumps(benches[name]), flush=True)
    t0 = time.perf_counter()
    benches["partials"] = bench_rtf.bench_partials(
        total_frames=int(TOOLS["session_sec"] * 100), device=device)
    out["seconds"]["bench_partials"] = time.perf_counter() - t0
    print("bench_rtf " + json.dumps(benches["partials"]), flush=True)
    out["bench_rtf"] = benches

    # 3. the proto DNN, card against CPU
    t0 = time.perf_counter()
    text, comps, params, batch = proto_setup(torch)
    on_card = [{k: v.to(device) for k, v in p.items()} for p in params]
    with torch.no_grad():
        got = apply_proto(on_card, comps, torch.as_tensor(batch[0],
                                                          device=device))
        want = apply_proto(params, comps, torch.as_tensor(batch[0]))
    fwd_err = _rel_err(got.cpu(), want)
    if fwd_err > PROTO_FWD_RTOL:
        raise AssertionError(f"proto DNN forward, card against CPU: "
                             f"{fwd_err:.3g} of its largest entry")
    step = card_vs_cpu_step(torch, device, params, comps, batch,
                            step_on=_proto_step_on)
    out["proto"] = {"components": [c["type"] for c in comps],
                    "parameters": sum(v.numel() for p in params
                                      for v in p.values()),
                    "forward_rel_err": fwd_err, "step": step,
                    "s": time.perf_counter() - t0}
    print(f"proto DNN ({len(comps)} components, "
          f"{out['proto']['parameters']} parameters) forward card against "
          f"CPU {fwd_err:.3g} of its largest entry; step: "
          + json.dumps(step), flush=True)

    # 4. a profile and its summary (on a card: the CPU runs no kernel)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        t0 = time.perf_counter()
        prof = profile_attention(torch, work, device)
        out["profile"] = {k: v for k, v in prof.items()
                          if not k.endswith("md")}
        out["seconds"]["profile"] = time.perf_counter() - t0
        print(prof["md"] + "\n" + prof["source_md"], flush=True)
        print(f"trace_summary: banded_attention_kernel "
              f"{prof['k1_us']:.3f} us over {prof['k1_calls']} calls on "
              f"{prof['track']}, all of it launched by banded_attention on "
              f"{prof['by_op_track']} ({prof['k1_launches_counted']} "
              f"launches counted)", flush=True)

    # 5. the counts, then the comparison launches; the device list
    launches = launch_counts()
    sites = sum(c["type"] == "<Dropout>" for c in comps) if cuda else 0
    want_k3 = {"fused_dropout_forward": sites,
               "fused_dropout_backward": sites}
    if any(launches[k] != n for k, n in want_k3.items()) \
            or bool(launches["banded_attention"]) != cuda:
        raise AssertionError(f"tools phase launches {launches}: expected K3 "
                             f"{want_k3} (the proto step) and K1 (the "
                             f"profiled forward)")
    out["launches"] = launches
    masks = proto_masks_equal(torch, comps, batch, device)
    if any(masks):
        raise AssertionError(f"proto step's dropout masks, card against "
                             f"CPU: {masks} elements differ")
    out["proto"]["mask_mismatches"] = masks

    # 6. the native host core, its launches counted on their own
    t0 = time.perf_counter()
    host = run_native_host(torch, recipe_work, device)
    out["native_host"] = host
    out["seconds"]["native_host"] = time.perf_counter() - t0
    out["launches"] = {k: n + host["launches"][k]
                       for k, n in launches.items()}
    out["devices"] = devices.available_devices()
    print("tools.devices: " + json.dumps(out["devices"]), flush=True)
    cli_rows, cli_s = _finish_bench_cli(cli)
    if [r.get("metric") for r in cli_rows] != ["posterior_rtf_offline"]:
        raise AssertionError(f"bench_rtf CLI printed {cli_rows}")
    out["bench_rtf_cli"] = {"rows": cli_rows, "wall_s": cli_s}
    print("bench_rtf CLI (--which posterior): " + json.dumps(cli_rows[0])
          + f" in {cli_s:.1f} s", flush=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print("tools: " + json.dumps(out, default=str))
    return out


# the serve phase: the recognition server (recipes/serve.py) as a process,
# in attention mode on the TIMIT banded checkpoint of the decode path, in
# hybrid mode on a causal copy of the long-form AM and the hybrid phase's
# HLG
# a session's audio: utterances concatenated until they pass encoder_max_len
# (500), so its partials cross into the stream and reach the memory cap
SERVE = {"beam_size": 8, "max_batch": 8, "concurrent": 8, "wavs": 2,
         "sessions": 2, "chunk": 40, "stream_frames": 500}
# the long-form AM at its widths with a causal band: its band (-100, 50)
# reads ahead and cannot stream (models/streaming.py)
SERVE_AM = dict(HYBRID_MODEL, encoder_sub_sequence=(-100, 0))
SERVE_AM_EPOCHS = 2
COALESCED_SCORE_ATOL = 1e-4  # a coalesced request against the same alone
STREAM_ENCODER_RTOL = 1e-5  # chunked encoder against offline, of the max
SERVING_RE = r"serving on 127\.0\.0\.1:(\d+)"
WARMED_RE = r"warmed (?:batched |AM )?bucket \d+.* in ([0-9.]+)s"


class ServerProcess:
    """``python3 -m pytorch_kaldi_asr_tpu_torch.recipes.serve ARGS -port 0``
    with its output in ``work/<name>.log``: started, waited for until its
    ``serving on`` line names its port, sent JSON requests, stopped by
    SIGTERM (its exit code and the launches it logs)."""

    def __init__(self, name, args, work, timeout=600.0):
        import threading

        self.name, self.log = name, work / f"{name}.log"
        env = dict(os.environ, PYTHONPATH=str(REPO), PYTHONUNBUFFERED="1")
        self.t0 = time.perf_counter()
        with open(self.log, "w") as out:
            self.proc = subprocess.Popen(
                [sys.executable, "-m",
                 "pytorch_kaldi_asr_tpu_torch.recipes.serve", *args,
                 "-port", "0"], cwd=str(REPO), env=env, stdout=out,
                stderr=subprocess.STDOUT)
        self.base = self.ready_s = None
        # the port opens while this process does other work: a thread
        # notes when
        self._watch = threading.Thread(target=self._watch_log,
                                       args=(timeout,), daemon=True)
        self._watch.start()

    def _watch_log(self, timeout):
        while self.proc.poll() is None \
                and time.perf_counter() - self.t0 < timeout:
            found = re.search(SERVING_RE, self.text())
            if found:
                self.ready_s = time.perf_counter() - self.t0
                self.base = f"http://127.0.0.1:{found.group(1)}"
                return
            time.sleep(0.05)

    def text(self):
        return self.log.read_text()

    def wait_ready(self):
        """Seconds from the start to the open port; the start-up (the
        interpreter and the imports, as the CLI logs it) and the warm-up
        seconds it logged."""
        self._watch.join()
        if self.base is None:
            raise AssertionError(f"{self.name} server not serving (exit "
                                 f"{self.proc.poll()}): "
                                 + self.text()[-3000:])
        from pytorch_kaldi_asr_tpu_torch.utils.logging import STARTUP_RE

        text = self.text()
        return {"ready_s": self.ready_s,
                "startup_s": sum(float(s) for _, s in
                                 re.findall(STARTUP_RE, text)),
                "warmup_s": sum(float(s) for s in re.findall(WARMED_RE,
                                                               text))}

    def request(self, path, obj=None, data=None, ctype="application/json"):
        """(reply as JSON, HTTP status, client-side seconds) of a GET, or
        of a POST of ``obj`` as JSON or of ``data``."""
        import urllib.error
        import urllib.request

        if data is None and obj is not None:
            data = json.dumps(obj).encode()
        req = urllib.request.Request(self.base + path, data=data,
                                     headers={"Content-Type": ctype})
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=300) as r:
                return json.loads(r.read()), r.status, \
                    time.perf_counter() - t0
        except urllib.error.HTTPError as e:
            return json.loads(e.read()), e.code, time.perf_counter() - t0

    def post(self, path, obj=None, data=None, ctype="application/json"):
        """(reply, client-side seconds) of a POST that must answer 200."""
        if data is None and obj is None:
            data = b""
        reply, status, seconds = self.request(path, obj, data, ctype)
        if status != 200:
            raise AssertionError(f"{self.name} {path}: {status} {reply}")
        return reply, seconds

    def stop(self, timeout=120.0):
        """SIGTERM, then the exit code must be 0; returns the kernel
        launches the server logged at its exit."""
        self.proc.send_signal(signal.SIGTERM)
        try:
            code = self.proc.wait(timeout=timeout)
        finally:
            self.kill()
        if code != 0:
            raise AssertionError(f"{self.name} server exited {code} on "
                                 f"SIGTERM: " + self.text()[-3000:])
        launches, devices = recipe_launches([self.text()])
        if len(devices) != 1:
            raise AssertionError(f"{self.name} server logged launches on "
                                 f"{devices}")
        return launches

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=60)


def _percentile(values, q):
    return float(statistics.quantiles(values, n=100, method="inclusive")[
        q - 1]) if len(values) > 1 else float(values[0])


def train_serve_am(torch, data, out, device="cuda"):
    """The causal long-form AM (SERVE_AM) trained in this process as
    train_am trains, with recipes.train_am.am_train_step, for
    SERVE_AM_EPOCHS over the long-form train set (batch HYBRID_BATCH, lr
    0.003, seed 0), saved to ``out`` as train_am saves.  Returns (its
    config, its steps, the kernel launches of the training)."""
    from pytorch_kaldi_asr_tpu_torch.data.loader import to_device
    from pytorch_kaldi_asr_tpu_torch.models.transformer import tree_map
    from pytorch_kaldi_asr_tpu_torch.recipes.train_am import (
        am_setup,
        am_train_step,
        create_am_state,
    )
    from pytorch_kaldi_asr_tpu_torch.train.checkpoint import save_checkpoint

    loader, _, cfg, params = am_setup(str(data / "train"), str(data / "dev"),
                                      HYBRID_BATCH, **SERVE_AM)
    cfg = cfg.replace(conformer_causal_conv=True)
    state = create_am_state(tree_map(lambda t: t.to(device), params),
                            lr=0.003, seed=1)
    reset_launch_counts()
    for _ in range(SERVE_AM_EPOCHS):
        for batch in loader:
            b = to_device(batch, device)
            loss, _ = am_train_step(state, cfg, b.src, b.src_mask, b.tgt)
    loss = float(loss)
    launches = launch_counts()
    if not math.isfinite(loss):
        raise AssertionError(f"the causal AM's loss {loss}")
    save_checkpoint(str(out), state.params, cfg, epoch=SERVE_AM_EPOCHS,
                    step=state.step, extra={"n_targets": cfg.vocab_size,
                                            "model_kind": "am"})
    return cfg, state.step, launches, loss


def run_serve(torch, timit, hybrid_work, fbank_work, device="cuda"):
    """The serve phase.  ``timit``: the TIMIT decode path's summary (its
    banded checkpoint and data); ``hybrid_work``: the hybrid phase's
    directory (its corpus and HLG); ``fbank_work``: the fbank phase's WAVs.

    First the causal long-form AM is trained in this process
    (``train_serve_am``); then both servers start at once.  The attention
    server (``-beam_size 8 -max_batch 8``, the default buckets): /healthz;
    the 16 TIMIT utterances through /recognize one by one, each top
    hypothesis held against the decode CLI's at the same beam (the same
    words where the score is more than WORD_GAP from its neighbours',
    scores within CPU_SCORE_ATOL); 8 of them again at once from threads,
    coalesced by the micro-batcher, equal to the solo results (words, scores
    within COALESCED_SCORE_ATOL); 2 WAVs of the fbank phase; 2 streaming
    sessions of concatenated utterances past encoder_max_len in 40-frame
    partial pushes, whose partials carry "truncated" past the memory cap and
    whose finish equals /recognize of the same audio; a /reload to the
    TIMIT training path's combined checkpoint and one to a checkpoint of
    another configuration, which must fail.  In this process, the streaming
    banded encoder fed 40-frame chunks against the offline encoder on 2
    utterances (STREAM_ENCODER_RTOL).  The hybrid server (buckets up to the
    AM's encoder_max_len): /recognize at n-best 1 and 4 on the 8 test
    utterances, the 1-best words and cost (HYBRID_COST_ATOL) those of
    decode.latgen.latgen over the same AM's posteriors computed here, the
    4-best's first the 1-best; 2 streaming sessions in 40-frame pushes, a
    partial in every reply, the finish the offline 1-best.  Both servers
    exit 0 on SIGTERM with their launches logged (K1, no other kernel).
    Returns the numbers, with ``launches`` summed over the servers and the
    AM's training."""
    import threading

    import numpy as np

    from pytorch_kaldi_asr_tpu_torch.data.loader import BatchLoader, to_device
    from pytorch_kaldi_asr_tpu_torch.decode.latgen import latgen
    from pytorch_kaldi_asr_tpu_torch.fst.openfst_io import read_fst
    from pytorch_kaldi_asr_tpu_torch.io import kaldi_io
    from pytorch_kaldi_asr_tpu_torch.models.am import am_log_posteriors
    from pytorch_kaldi_asr_tpu_torch.models.streaming import (
        StreamingBandedEncoder,
    )
    from pytorch_kaldi_asr_tpu_torch.models.transformer import encode
    from pytorch_kaldi_asr_tpu_torch.recipes import decode
    from pytorch_kaldi_asr_tpu_torch.train import load_checkpoint

    t_phase = time.perf_counter()
    work = _fresh(WORK / "serve")
    data = Path(timit["model"]).parent / "data"
    vocab = data / "vocab.txt"
    hdata, hexp = hybrid_work / "data", hybrid_work / "exp"
    out = {"device": device}

    t0 = time.perf_counter()
    am_cfg, am_steps, am_launches, am_loss = train_serve_am(
        torch, hdata, work / "am_causal", device)
    out["am"] = {"steps": am_steps, "final_loss": am_loss,
                 "train_s": time.perf_counter() - t0,
                 "encoder_max_len": am_cfg.encoder_max_len}
    buckets = [b for b in (1000, 2000) if b < am_cfg.encoder_max_len] + [
        am_cfg.encoder_max_len]
    servers = {}
    try:
        servers["attention"] = ServerProcess("attention", [
            "-read_model_file", timit["model"], "-read_vocab_file",
            str(vocab), "-beam_size", str(SERVE["beam_size"]),
            "-max_token_seq_len", str(TIMIT["decode"]["max_tokens"]),
            "-max_batch", str(SERVE["max_batch"]), "-device", device], work)
        servers["hybrid"] = ServerProcess("hybrid", [
            "-read_model_file", str(work / "am_causal"), "-graph_dir",
            str(hexp / "graph"), "-beam", "14", "-buckets",
            ",".join(map(str, buckets)), "-device", device], work)

        # the decode CLI at the server's beam: the reference of /recognize
        spec = dict(TIMIT["decode"], beam=SERVE["beam_size"],
                    nbest=SERVE["beam_size"])
        decode.main(stage5_args(spec, data, vocab, timit["model"],
                                work / "decode_beam8.txt", device))
        reference = read_nbest(work / "decode_beam8.txt")
        feats = dict(kaldi_io.read_mat_scp(str(data / "feats.scp")))

        att = servers["attention"]
        out["attention"] = att.wait_ready()
        health = att.request("/healthz")[0]
        if health["status"] != "ok" or health["mode"] != "attention":
            raise AssertionError(f"attention /healthz: {health}")
        solo, lat = {}, []
        for key, mat in feats.items():
            reply, s = att.post("/recognize", {"features": mat.tolist()})
            solo[key] = reply
            lat.append(s)
            if reply["frames"] != mat.shape[0] or "truncated" in reply:
                raise AssertionError(f"/recognize {key}: {reply}")
        worst = 0.0
        for key, reply in solo.items():
            top, ref = reply["nbest"][0], reference[key]
            err = abs(top["score"] - ref[0][0])
            worst = max(worst, err)
            gap = abs(ref[0][0] - ref[1][0]) if len(ref) > 1 else math.inf
            if err > CPU_SCORE_ATOL or (gap > WORD_GAP
                                        and top["text"] != ref[0][1]):
                raise AssertionError(f"/recognize {key}: {top} against the "
                                     f"decode CLI's {ref[0]}")
        keys = list(feats)[:SERVE["concurrent"]]
        coalesced = {}

        def ask(key):
            coalesced[key] = att.post("/recognize",
                                      {"features": feats[key].tolist()})

        threads = [threading.Thread(target=ask, args=(k,)) for k in keys]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        concurrent_s = time.perf_counter() - t0
        coalesced_err = 0.0
        for key in keys:
            got, want = coalesced[key][0]["nbest"][0], solo[key]["nbest"][0]
            coalesced_err = max(coalesced_err,
                                abs(got["score"] - want["score"]))
            if got["text"] != want["text"] \
                    or abs(got["score"] - want["score"]) \
                    > COALESCED_SCORE_ATOL:
                raise AssertionError(f"coalesced {key}: {got} vs {want}")
        wavs = sorted(fbank_work.glob("u*.wav"))[:SERVE["wavs"]]
        wav_frames = []
        for wav in wavs:
            reply, _ = att.post("/recognize", data=wav.read_bytes(),
                                ctype="audio/wav")
            if not reply["nbest"] or reply["frames"] <= 0:
                raise AssertionError(f"/recognize {wav.name}: {reply}")
            wav_frames.append(reply["frames"])
        sessions, partial_s = [], []
        order = list(feats)
        for n in range(SERVE["sessions"]):
            parts, total = [], 0
            for key in order[n::2]:
                parts.append(feats[key])
                total += feats[key].shape[0]
                if total > SERVE["stream_frames"]:
                    break
            audio = np.concatenate(parts)
            sid = att.post("/stream/start")[0]["id"]
            replies = []
            for lo in range(0, audio.shape[0], SERVE["chunk"]):
                reply, s = att.post(f"/stream/{sid}/push", {
                    "features": audio[lo:lo + SERVE["chunk"]].tolist(),
                    "partial": True})
                replies.append(reply)
                partial_s.append(s)
                past = reply["frames"] > health["buckets"][-1]
                if not isinstance(reply.get("partial"), str) \
                        or bool(reply.get("truncated")) != past:
                    raise AssertionError(f"session {n} push at "
                                         f"{reply['frames']}: {reply}")
            final, _ = att.post(f"/stream/{sid}/finish")
            whole, _ = att.post("/recognize", {"features": audio.tolist()})
            if final["nbest"][0]["text"] != whole["nbest"][0]["text"] \
                    or abs(final["nbest"][0]["score"]
                           - whole["nbest"][0]["score"]) \
                    > COALESCED_SCORE_ATOL or not final.get("truncated"):
                raise AssertionError(f"session {n} finish {final} vs "
                                     f"/recognize {whole}")
            sessions.append({"frames": int(audio.shape[0]),
                             "pushes": len(replies),
                             "truncated_from": min(
                                 r["frames"] for r in replies
                                 if r.get("truncated"))})
        stats = att.request("/healthz")[0]["stats"]
        combined = sorted((WORK / "timit" / "train" / "combined").glob(
            "combined.accu*"))[-1]
        reloaded, _ = att.post("/reload", {"model_file": str(combined)})
        after, _ = att.post("/recognize",
                            {"features": feats[order[0]].tolist()})
        other = work / "model_noncausal"  # its decoder band reads ahead
        initialize(TIMIT_NONCAUSAL, data / "feats.scp", vocab, other)
        refused, status, _ = att.request("/reload",
                                         {"model_file": str(other)})
        if status != 400 or "differs" not in refused.get("error", ""):
            raise AssertionError(f"/reload of another configuration: "
                                 f"{status} {refused}")
        audio_s = sum(m.shape[0] for m in feats.values()) * 0.010
        out["attention"].update({
            "recognize_p50_ms": stats.get("p50_ms"),
            "recognize_p95_ms": stats.get("p95_ms"),
            "requests": stats["requests"],
            "solo_rtf": sum(lat) / audio_s,
            "solo_vs_decode_cli_max_score_err": worst,
            "concurrent_s": concurrent_s,
            "concurrent_rtf": concurrent_s / sum(
                feats[k].shape[0] * 0.010 for k in keys),
            "coalesced_vs_solo_max_score_err": coalesced_err,
            "wav_frames": wav_frames, "sessions": sessions,
            "partial_p50_ms": _percentile(partial_s, 50) * 1e3,
            "reloaded": reloaded["model_file"],
            "after_reload_frames": after["frames"]})
        launches_att = att.stop()
        out["attention"]["launches"] = launches_att

        # the streaming encoder on the card against the offline one
        ckpt = load_checkpoint(timit["model"], device=device)
        stream_err = []
        for key in order[:2]:
            x = torch.from_numpy(feats[key][None]).to(device)
            with torch.no_grad():
                offline, _ = encode(ckpt["params"], ckpt["cfg"], x,
                                    torch.ones(x.shape[:2], dtype=torch.uint8,
                                               device=device))
            enc = StreamingBandedEncoder(ckpt["params"]["encoder"],
                                         ckpt["cfg"])
            chunked = torch.cat([enc.push(x[:, lo:lo + SERVE["chunk"]])
                                 for lo in range(0, x.shape[1],
                                                 SERVE["chunk"])], dim=1)
            err = float((chunked - offline).abs().max())
            stream_err.append(err / float(offline.abs().max()))
        out["attention"]["stream_encoder_rel_err"] = max(stream_err)
        if max(stream_err) > STREAM_ENCODER_RTOL:
            raise AssertionError(f"streaming encoder vs offline: "
                                 f"{stream_err}")

        hyb = servers["hybrid"]
        out["hybrid"] = hyb.wait_ready()
        if hyb.request("/healthz")[0]["mode"] != "hybrid":
            raise AssertionError("hybrid /healthz")
        graph = read_fst(str(hexp / "graph" / "HLG.fst"))
        words = {int(v): w for w, v in (line.split() for line in
                                        open(hexp / "graph" / "words.txt"))}
        ckpt = load_checkpoint(str(work / "am_causal"), device=device)
        test = dict(kaldi_io.read_mat_scp(str(hdata / "test" / "feats.scp")))
        one_ms, four_ms, cost_err = [], [], 0.0
        for key, mat in test.items():
            one, s1 = hyb.post("/recognize", {"features": mat.tolist()})
            four, s4 = hyb.post("/recognize", {"features": mat.tolist(),
                                               "nbest": 4})
            one_ms.append(s1 * 1e3)
            four_ms.append(s4 * 1e3)
            t = one["frames"]
            x = torch.from_numpy(mat[None, :t]).to(device)
            with torch.no_grad():
                logp, _ = am_log_posteriors(
                    ckpt["params"], ckpt["cfg"], x,
                    torch.ones(x.shape[:2], dtype=torch.uint8,
                               device=device))
            ids, _, cost = latgen(graph, logp[0].cpu().numpy(), beam=14.0,
                                  max_active=2000)
            text = " ".join(words[i] for i in ids)
            top = one["nbest"][0]
            cost_err = max(cost_err, abs(-top["score"] - cost))
            if top["text"] != text or abs(-top["score"] - cost) \
                    > HYBRID_COST_ATOL or not four["nbest"] \
                    or four["nbest"][0]["text"] != text \
                    or abs(four["nbest"][0]["score"] - top["score"]) \
                    > HYBRID_COST_ATOL:
                raise AssertionError(f"hybrid /recognize {key}: {one} / "
                                     f"{four} against latgen {text} {cost}")
            test[key] = (mat, top)
        push_s, stream_audio_s = [], 0.0
        for key in list(test)[:SERVE["sessions"]]:
            mat, top = test[key]
            sid = hyb.post("/stream/start")[0]["id"]
            for lo in range(0, mat.shape[0], SERVE["chunk"]):
                reply, s = hyb.post(f"/stream/{sid}/push", {
                    "features": mat[lo:lo + SERVE["chunk"]].tolist()})
                push_s.append(s)
                if not isinstance(reply.get("partial"), str):
                    raise AssertionError(f"hybrid push: {reply}")
            final, _ = hyb.post(f"/stream/{sid}/finish")
            stream_audio_s += mat.shape[0] * 0.010
            if final["nbest"][0]["text"] != top["text"] or abs(
                    final["nbest"][0]["score"] - top["score"]) \
                    > HYBRID_COST_ATOL:
                raise AssertionError(f"hybrid session {key}: {final} "
                                     f"against /recognize {top}")
        stats = hyb.request("/healthz")[0]
        audio_s = sum(m.shape[0] for m, _ in test.values()) * 0.010
        out["hybrid"].update({
            "recognize_p50_ms": stats["stats"].get("p50_ms"),
            "recognize_p95_ms": stats["stats"].get("p95_ms"),
            "nbest1_rtf": sum(one_ms) / 1e3 / audio_s,
            "nbest4_rtf": sum(four_ms) / 1e3 / audio_s,
            "graph_search_mean_ms": stats["graph_search"]["mean_ms"],
            "max_cost_err": cost_err,
            "push_p50_ms": _percentile(push_s, 50) * 1e3,
            "streaming_rtf": sum(push_s) / stream_audio_s,
            "test_audio_s": audio_s})
        out["hybrid"]["launches"] = hyb.stop()
    finally:
        for server in servers.values():
            server.kill()
    for name in ("attention", "hybrid"):
        launched = out[name]["launches"]
        if not device.startswith("cuda"):
            continue  # the CPU runs the plain versions
        if not launched.get("banded_attention") or any(
                n for k, n in launched.items() if k != "banded_attention"):
            raise AssertionError(f"the {name} server's launches: {launched}")
    out["launches"] = {
        k: am_launches[k] + out["attention"]["launches"].get(k, 0)
        + out["hybrid"]["launches"].get(k, 0) for k in am_launches}
    out["am"]["launches"] = am_launches
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def longform_kernels(torch, ba):
    """K1 and K2a-c at the long-form tile case against their plain
    versions (the same checks as the kernel phase's), and their times at
    the long-form shapes beside their bounds."""
    scale = 1.0 / math.sqrt(256.0)
    case = [c for c in _tile_cases(torch, scale) if c[1] == 3504]
    out = {"k1_err": check_banded_attention(torch, ba, case),
           "k2_errs": check_trainable_attention(torch, ba, case),
           "k1": time_banded_attention(torch, ba, "longform_decode"),
           "k2": time_trainable_attention(torch, ba, "longform_train")}
    torch.cuda.empty_cache()
    return out


def check_train_launches(training):
    """K2a-c at exactly en_layers x steps on the compute dtype (none on the
    other), K3 at exactly (dropout sites) x steps each way for each dtype,
    and K1 on the compute dtype in the evaluations; encoders that do not
    attend (tdnn, tdnnf, blstm) launch no K1 and no K2."""
    launches, steps = training["launches"], training["train_steps"]
    sites = training["dropout_sites"]
    ours, other = (("_bf16", "") if training["compute_dtype"] == "bfloat16"
                   else ("", "_bf16"))
    want = {}
    attention_layers = training["en_layers"] if training["encoder_type"] \
        in ATTENDING else 0
    for k in ("fwd", "dq", "dkv"):
        want[f"banded_attention_{k}{ours}"] = attention_layers * steps
        want[f"banded_attention_{k}{other}"] = 0
    for way in ("forward", "backward"):
        want[f"fused_dropout_{way}"] = sites["float32"] * steps
        want[f"fused_dropout_{way}_bf16"] = sites["bfloat16"] * steps
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"{training['corpus']}: {name} launched "
                                 f"{launches[name]} times in training, "
                                 f"expected {n}")
    if bool(launches[f"banded_attention{ours}"]) != bool(attention_layers) \
            or launches[f"banded_attention{other}"]:
        raise AssertionError(f"banded_attention{ours} (K1) not launched by "
                             f"the training path's evaluations, or K1 on the "
                             f"other dtype: {launches}")
    print(f"{training['corpus']}: {training['dropout_sites']} dropout sites "
          f"per train step; launches over {steps} steps: {launches}")


# ---------------------------------------------------------------------------
# the parallel phase: ranks of one torch.distributed world sharing the card
# ---------------------------------------------------------------------------

PARALLEL_RANKS = 8  # the long-form recipe's seq_shards
PARALLEL_TIMEOUT_S = 300  # the main world, and train_am's
PROBE_TIMEOUT_S = 120
PROBE_OPS = ("all_reduce", "broadcast", "broadcast_pair_group",
             "all_gather", "send_recv")
SP_FWD_RTOL = 2e-5  # of the largest entry: 8 ranks against one
PP_FWD_RTOL = 2e-5
PARAM_RTOL = 1e-5  # dp x tp: the updated parameters, of each leaf's largest
SP_STEP_REPEATS = 3
# the TIMIT recipe's banded model (RECIPE_MODEL) at dropout 0, on a 2 x 2
# ("data", "model") mesh, one step at batch 100
TP_MESH = (2, 2)
TP_BATCH = 100
# a banded AM at TIMIT's encoder widths over 3 stages, 6 microbatches
PP_MODEL = dict(encoder_type="banded", en_layers=3, en_d_model=256,
                n_head=2, d_k=64, d_v=64, encoder_sub_sequence=(-100, 0),
                en_dropout=0.0)
PP_STAGES, PP_MICRO = 3, 6


def _tp_config(torch, **narrow):
    """The TIMIT recipe's banded model at dropout 0 (``narrow``: fields
    replaced, for a rehearsal on the CPU)."""
    from pytorch_kaldi_asr_tpu_torch.models.transformer import (
        TransformerConfig,
    )

    flags = dict(zip(RECIPE_MODEL[::2], RECIPE_MODEL[1::2]))
    band = tuple(int(x) for x in flags["-encoder_sub_sequence"].strip(
        "()").split(","))
    dband = tuple(int(x) for x in flags["-decoder_sub_sequence"].strip(
        "()").split(","))
    return TransformerConfig(
        src_dim=FEAT_DIM, vocab_size=4 + len(TIMIT["words"]),
        encoder_max_len=int(flags["-encoder_max_len"]),
        decoder_max_len=int(flags["-decoder_max_len"]),
        encoder_sub_sequence=band, decoder_sub_sequence=dband,
        en_layers=int(flags["-en_layers"]), de_layers=int(flags["-de_layers"]),
        n_head=int(flags["-n_head"]), en_d_model=int(flags["-en_d_model"]),
        de_d_model=int(flags["-de_d_model"]), d_k=int(flags["-d_k"]),
        d_v=int(flags["-d_v"]), en_dropout=0.0, de_dropout=0.0,
        encoder_type=flags["-encoder_type"]).replace(**narrow)


def _tp_batch(torch, cfg, rows=TP_BATCH, seed=SEED):
    """A TIMIT-shaped batch of ``rows``: 150-500 frames, 20-75 phones
    between <s> and </s>, from a numpy seed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    s = cfg.encoder_max_len
    lens = rng.integers(min(TIMIT["frames"][0], s - 1), s + 1, rows)
    src = rng.normal(size=(rows, s, cfg.src_dim)).astype(np.float32)
    mask = (np.arange(s)[None, :] < lens[:, None]).astype(np.uint8)
    src *= mask[..., None]
    t = 78
    n_tok = rng.integers(20, 76, rows)
    tgt = np.zeros((rows, t), np.int64)
    for i, n in enumerate(n_tok):
        tgt[i, 0], tgt[i, n + 1] = 2, 3
        tgt[i, 1:n + 1] = rng.integers(4, cfg.vocab_size, n)
    return tuple(torch.from_numpy(a) for a in
                 (src, mask, tgt, (tgt != 0).astype(np.uint8)))


def _max_rel(got, want):
    """max |got - want| over the largest |want|."""
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max().clamp_min(1e-30))


def _leaf_errs(got, want):
    """{leaf: max |got - want| over that leaf's largest |want|}."""
    return {k: _max_rel(got[k], want[k]) for k in want}


def _grads_of(torch, params):
    from pytorch_kaldi_asr_tpu_torch.train.optim import named_leaves

    return {"/".join(map(str, p)): (l.grad.detach().clone() if l.grad is not
                                     None else torch.zeros_like(l))
            for p, l in named_leaves(params)}


def _leaf_dict(params):
    from pytorch_kaldi_asr_tpu_torch.train.optim import named_leaves

    return {"/".join(map(str, p)): l.detach() for p, l in named_leaves(params)}


def _card_sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _timed_ms(torch, fn, device, barrier=None, repeats=SP_STEP_REPEATS):
    """Median milliseconds of ``fn`` (the card synchronised, and the world
    at a barrier before each, when ``barrier`` is given)."""
    times = []
    for _ in range(repeats):
        if barrier is not None:
            barrier()
        _card_sync(torch, device)
        t0 = time.perf_counter()
        fn()
        _card_sync(torch, device)
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def parallel_rank(torch, spec_path):
    """One rank of the parallel phase's world (``--parallel-rank``): every
    rank on cuda:0 under gloo with CUDA tensors.  Rank 0 writes the
    gates' readings to ``spec["result"]``."""
    from pytorch_kaldi_asr_tpu_torch.data.loader import to_device
    from pytorch_kaldi_asr_tpu_torch.models import am
    from pytorch_kaldi_asr_tpu_torch.models.encoders import banded_encode
    from pytorch_kaldi_asr_tpu_torch.models.transformer import (
        TransformerConfig,
        encode,
        init_transformer,
        tree_map,
    )
    from pytorch_kaldi_asr_tpu_torch.ops.launches import (
        launch_counts as counts_now,
    )
    from pytorch_kaldi_asr_tpu_torch.parallel import multihost
    from pytorch_kaldi_asr_tpu_torch.parallel.collectives import (
        all_reduce_,
        broadcast_,
        gather_rows,
    )
    from pytorch_kaldi_asr_tpu_torch.parallel.mesh import (
        gather_params,
        make_mesh,
        param_shardings,
        shard_batch_arrays,
        shard_params,
    )
    from pytorch_kaldi_asr_tpu_torch.parallel.pipeline import (
        make_pipe_mesh,
        pp_banded_encode,
        pp_frame_ce_loss,
        stage_params,
    )
    from pytorch_kaldi_asr_tpu_torch.parallel.sequence import (
        make_seq_mesh,
        sp_encode,
        sp_frame_ce_loss,
    )
    from pytorch_kaldi_asr_tpu_torch.recipes.train_am import (
        am_batch_loader,
        am_setup,
        am_sp_train_step,
        am_train_step,
        create_am_state,
    )
    from pytorch_kaldi_asr_tpu_torch.train.optim import named_leaves
    from pytorch_kaldi_asr_tpu_torch.train.state import (
        create_train_state,
        sum_grads,
        train_step,
    )
    from pytorch_kaldi_asr_tpu_torch.utils.device import disable_tf32

    spec = json.loads(Path(spec_path).read_text())
    entered_s = time.time() - spec["t0"]
    narrow = spec["narrow"]
    torch.set_num_threads(1)
    rank, n = multihost.initialize(backend="gloo", device=spec["device"])
    device = multihost.rank_device(spec["device"], 0)  # all on one card
    if device.type == "cuda":
        torch.cuda.set_device(device)
        disable_tf32()
    seq = make_seq_mesh(n)
    world = seq.axis("seq")
    tp = make_mesh(*TP_MESH, ranks=list(range(TP_MESH[0] * TP_MESH[1])))
    pipe = make_pipe_mesh(pipe=PP_STAGES, data=1,
                          ranks=list(range(PP_STAGES)))

    def barrier():
        all_reduce_(torch.zeros(1, device=device), world)

    def dev(tree):
        return tree_map(lambda t: t.detach().to(device, copy=True), tree)

    out = {"section_s": {"entered": entered_s}}
    t_rank = time.perf_counter() - (time.time() - spec["t0"])

    def section(name):
        barrier()
        out["section_s"][name] = time.perf_counter() - t_rank

    section("joined")
    data = Path(spec["corpus"])
    # sequence parallelism: train_am's long-form AM at the recipe's widths
    _, _, cfg, init = am_setup(str(data / "train"), str(data / "dev"),
                               HYBRID_BATCH, **narrow["hybrid_model"])
    cfg0 = cfg.replace(en_dropout=0.0)
    test = next(iter(am_batch_loader(str(data / "test"), HYBRID_BATCH,
                                     mode="all")))
    b = to_device(test, device)
    s = b.src.shape[1]
    out["sp_shape"] = list(b.src.shape)
    # the step times, first (train_am starts beside the rest of the world
    # once they are taken: ``spec["timed"]``), and after the updates the
    # parameters bit-equal across the ranks
    state = create_am_state(dev(init), lr=0.003, seed=1)
    sp_ms = _timed_ms(torch, lambda: am_sp_train_step(
        state, cfg0, b.src, b.src_mask, b.tgt, seq), device, barrier)
    if rank == 0:
        one = create_am_state(dev(init), lr=0.003, seed=1)
        out["sp_step_ms_1_rank"] = _timed_ms(torch, lambda: am_train_step(
            one, cfg0, b.src, b.src_mask, b.tgt), device)
        Path(spec["timed"]).write_text("")
    flat = torch.cat([l.detach().reshape(-1) for _, l in
                      named_leaves(state.params)])
    mine = flat.clone()
    broadcast_(flat, world, 0)
    mismatches = torch.tensor([float((flat.view(torch.int32)
                                      != mine.view(torch.int32)).sum())],
                              device=device)
    out["sp_param_mismatches"] = float(all_reduce_(mismatches, world))
    out["sp_step_ms_8_ranks"] = sp_ms
    section("timed")
    with torch.no_grad():
        local = sp_encode(dev(init)["encoder"], cfg0, b.src, b.src_mask, seq)
        whole = torch.cat(list(gather_rows(local, world)), dim=1)
        if rank == 0:
            ref, _ = encode(dev(init), cfg0, b.src, b.src_mask)
            out["sp_fwd_rel"] = _max_rel(whole, ref)
    # the step: the batch, and the batch padded so its last shard holds no
    # valid frame
    s_pad = -(-(8 * s) // (7 * 64)) * 64
    padded = tuple(torch.nn.functional.pad(x, (0, 0, 0, s_pad - s)) if
                   x.dim() == 3 else torch.nn.functional.pad(x, (0, s_pad - s))
                   for x in (b.src, b.src_mask, b.tgt))
    out["sp_step"] = {}
    for name, (src, mask, tgt) in (("batch", (b.src, b.src_mask, b.tgt)),
                                   ("last_shard_padding", padded)):
        params = dev(init)
        for _, leaf in named_leaves(params):
            leaf.requires_grad_(True)
        loss, _, nf = sp_frame_ce_loss(params, cfg0, src, mask, tgt, seq,
                                       train=True)
        (loss / nf).backward()
        sum_grads(params, world)
        row = {"loss": float((loss / nf).detach()),
               "finite": bool(all(torch.isfinite(g).all() for g in
                                  _grads_of(torch, params).values()))}
        if rank == 0:
            one = dev(init)
            for _, leaf in named_leaves(one):
                leaf.requires_grad_(True)
            l1, _, n1 = am.frame_ce_loss(one, cfg0, src, mask, tgt,
                                         train=True)
            (l1 / n1).backward()
            errs = _leaf_errs(_grads_of(torch, params), _grads_of(torch, one))
            lv, l1v = float((loss / nf).detach()), float((l1 / n1).detach())
            row.update(one_loss=l1v, loss_rel=abs(lv - l1v) / abs(l1v),
                       grad_rel_max=max(errs.values()),
                       grad_rel_leaf=max(errs, key=errs.get))
        out["sp_step"][name] = row
    section("sp")

    # dp x tp: the TIMIT banded model on a 2 x 2 mesh, one step at batch 100
    cfg_t = _tp_config(torch, **narrow["tp_cfg"])
    init_t = init_transformer(torch.Generator().manual_seed(SEED), cfg_t)
    batch_t = tuple(x.to(device) for x in _tp_batch(torch, cfg_t,
                                                     narrow["tp_batch"]))
    if tp.member:
        specs = param_shardings(init_t, tp)
        st = create_train_state(shard_params(dev(init_t), tp))
        m = train_step(st, cfg_t, *shard_batch_arrays(tp, *batch_t), mesh=tp)
        full = gather_params(st.params, specs, tp)
        grads = gather_params(tree_map(lambda t: t.grad, st.params), specs,
                              tp)
        if rank == 0:
            one = create_train_state(dev(init_t))
            m1 = train_step(one, cfg_t, *batch_t)
            # the one-rank step's own noise: from every weight one ulp off
            ulp = create_train_state(dev(one_ulp_off(torch, init_t)))
            train_step(ulp, cfg_t, *batch_t)
            want = _leaf_dict(one.params)
            errs = _leaf_errs(_leaf_dict(full), want)
            noise = {k: max(v, NOISE_FLOOR) for k, v in
                     _leaf_errs(_leaf_dict(ulp.params), want).items()}
            ratios = {k: errs[k] / noise[k] for k in errs
                      if errs[k] > PARAM_RTOL}
            gerrs = _leaf_errs(_leaf_dict(grads), _grads_of(torch,
                                                            one.params))
            out["tp"] = {"loss": float(m["loss"]), "one_loss": float(m1["loss"]),
                         "loss_rel": abs(float(m["loss"]) - float(m1["loss"]))
                         / abs(float(m1["loss"])),
                         "param_rel_max": max(errs.values()),
                         "param_rel_leaf": max(errs, key=errs.get),
                         "param_noise": noise[max(errs, key=errs.get)],
                         "over_limit_noise_ratios": ratios,
                         "grad_rel_max": max(gerrs.values()),
                         "grad_rel_leaf": max(gerrs, key=gerrs.get)}
    section("tp")

    # pipeline: a banded AM at TIMIT's encoder widths, 3 stages, 6
    # microbatches of a hybrid-corpus batch
    loader6 = am_batch_loader(str(data / "train"), PP_MICRO)
    batch6 = to_device(next(iter(loader6)), device)
    n_targets = 1 + max(int(l.max()) for l in loader6.labels)
    cfg_p = TransformerConfig(src_dim=loader6.feat_dim, vocab_size=n_targets,
                              encoder_max_len=loader6.src_pad,
                              **narrow["pp_model"])
    init_p = am.init_am(torch.Generator().manual_seed(SEED + 1), cfg_p,
                        n_targets)
    row = {}
    if pipe.member:
        own = dev(stage_params(init_p, cfg_p, pipe))
        with torch.no_grad():
            enc_pp = pp_banded_encode(own["encoder"], cfg_p, batch6.src,
                                      batch6.src_mask, pipe,
                                      n_microbatches=PP_MICRO)
        for _, leaf in named_leaves(own):
            leaf.requires_grad_(True)
        loss, _, nf = pp_frame_ce_loss(own, cfg_p, batch6.src,
                                       batch6.src_mask, batch6.tgt, pipe,
                                       n_microbatches=PP_MICRO, train=True)
        (loss / nf).backward()
        one = dev(init_p)
        for _, leaf in named_leaves(one):
            leaf.requires_grad_(True)
        with torch.no_grad():
            enc1, _ = banded_encode(one["encoder"], cfg_p, batch6.src,
                                    batch6.src_mask)
        l1, _, n1 = am.frame_ce_loss(one, cfg_p, batch6.src, batch6.src_mask,
                                     batch6.tgt, train=True)
        (l1 / n1).backward()
        want = _grads_of(torch, one)
        lps = cfg_p.en_layers // PP_STAGES
        got = {}
        for key, g in _grads_of(torch, own).items():
            parts = key.split("/")
            if parts[:2] == ["encoder", "layers"]:
                parts[2] = str(pipe.index("pipe") * lps + int(parts[2]))
            got["/".join(parts)] = g
        errs = {k: _max_rel(g, want[k]) for k, g in got.items()}
        lv, l1v = float((loss / nf).detach()), float((l1 / n1).detach())
        row = [_max_rel(enc_pp, enc1), abs(lv - l1v) / abs(l1v),
               max(errs.values())]
    rows = gather_rows(torch.tensor(row or [0.0, 0.0, 0.0], device=device,
                                    dtype=torch.float64), world)
    if rank == 0:
        out["pp"] = {"shape": list(batch6.src.shape), "stages": [
            dict(zip(("fwd_rel", "loss_rel", "grad_rel_max"), r))
            for r in rows[:PP_STAGES].tolist()]}

    section("pp")
    counts = counts_now()
    every = gather_rows(torch.tensor([float(counts[k]) for k in counts],
                                     device=device), world)
    if rank == 0:
        out["launches_by_rank"] = [dict(zip(counts, map(int, r)))
                                   for r in every.tolist()]
        Path(spec["result"]).write_text(json.dumps(out))
    torch.distributed.destroy_process_group()
    return 0


def probe_rank(torch, spec_path):
    """One of the 2 ranks of the collectives probe (``--probe-rank``): each
    op of PROBE_OPS on CUDA tensors under gloo, both ranks on cuda:0, its
    outcome appended to ``spec["result"]``.<rank> as it completes (an op
    that kills the process leaves the earlier ones written)."""
    import torch.distributed as dist

    from pytorch_kaldi_asr_tpu_torch.parallel import multihost

    spec = json.loads(Path(spec_path).read_text())
    rank, _ = multihost.initialize(backend="gloo", device=spec["device"])
    device = multihost.rank_device(spec["device"], 0)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    pair = dist.new_group([0, 1])
    path = Path(f"{spec['result']}.{rank}")

    def record(op, outcome):
        with open(path, "a") as f:
            f.write(json.dumps({"op": op, "outcome": outcome}) + "\n")

    for op in PROBE_OPS:
        x = torch.full((4,), float(rank + 1), device=device)
        record(op, "started")
        try:
            if op == "all_reduce":
                dist.all_reduce(x)
                ok = x.tolist() == [3.0] * 4
            elif op == "broadcast":
                dist.broadcast(x, src=1)
                ok = x.tolist() == [2.0] * 4
            elif op == "broadcast_pair_group":
                dist.broadcast(x, src=1, group=pair)
                ok = x.tolist() == [2.0] * 4
            elif op == "all_gather":
                parts = [torch.zeros_like(x) for _ in range(2)]
                dist.all_gather(parts, x)
                ok = [p[0].item() for p in parts] == [1.0, 2.0]
            else:
                if rank == 0:
                    dist.send(x, dst=1)
                    ok = True
                else:
                    dist.recv(x, src=0)
                    ok = x.tolist() == [1.0] * 4
            _card_sync(torch, device)
            record(op, "ok" if ok else "wrong result")
        except Exception as e:  # the probe's reading, not a failure
            record(op, f"raised {type(e).__name__}: {str(e)[:200]}")
    dist.destroy_process_group()
    return 0


def start_probe(work, device):
    """The probe's 2 ranks as processes (their output to work/probe.log)."""
    from pytorch_kaldi_asr_tpu_torch.parallel import multihost

    spec = work / "probe.json"
    spec.write_text(json.dumps({"result": str(work / "probe"),
                                "device": device}))
    port = multihost.free_port()
    log = open(work / "probe.log", "w")
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "chip_smoke.py"), "--probe-rank",
         str(spec)], stdout=log, stderr=subprocess.STDOUT,
        env=multihost.world_env(r, 2, port,
                                dict(os.environ, PYTHONPATH=str(REPO))))
        for r in range(2)]
    return procs, log, time.perf_counter()


def finish_probe(work, probe):
    """Wait for the probe (killing a rank that hangs) and read each op's
    outcome on each rank: ok, wrong result, raised ..., or, for the op a
    rank was in when it died or was stopped, that."""
    procs, log, t0 = probe
    for p in procs:
        try:
            p.wait(timeout=max(1.0, PROBE_TIMEOUT_S - (time.perf_counter()
                                                        - t0)))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
    log.close()
    result = {}
    for r, p in enumerate(procs):
        path = work / f"probe.{r}"
        rows = [json.loads(x) for x in path.read_text().splitlines()] \
            if path.exists() else []
        ops = {}
        for row in rows:
            ops[row["op"]] = row["outcome"]
        for op, outcome in ops.items():
            if outcome == "started":
                ops[op] = (f"the rank ended in it (exit {p.returncode})"
                           if p.returncode != -9 else "hung: stopped")
        result[f"rank{r}"] = {op: ops.get(op, "not reached")
                              for op in PROBE_OPS}
    return result


def _run_cli_timed(cwd, log, module, *args):
    """``_run_cli`` with each output line's arrival second (written to
    ``log`` as ``[+S] line``).  Returns (wall seconds, text, the second of
    each line)."""
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", f"pytorch_kaldi_asr_tpu_torch.{module}",
         *map(str, args)], cwd=str(cwd), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, PYTHONPATH=str(REPO), PYTHONUNBUFFERED="1"))
    lines = [(time.perf_counter() - t0, line) for line in proc.stdout]
    code = proc.wait()
    wall = time.perf_counter() - t0
    log.write_text("".join(f"[+{t:.1f}] {line}" for t, line in lines))
    text = "".join(line for _, line in lines)
    if code != 0:
        raise AssertionError(f"{module} exited {code}: {text[-3000:]}")
    return wall, text, lines


def _first_at(lines, needle):
    """The second the first line holding ``needle`` arrived, or None."""
    return next((round(t, 1) for t, line in lines if needle in line), None)


def parallel_corpus(work):
    """The hybrid phase's corpus, or (the phase alone) a fresh one at
    run.sh's defaults (tools.make_synthetic_data)."""
    data = WORK / "hybrid" / "data"
    if (data / "test" / "ali.txt").exists():
        return data
    _run_cli(work, work / "corpus.log", "tools.make_synthetic_data",
             "-out_dir", work / "corpus", "-n_train", 64, "-n_dev", 8,
             "-n_test", 8, "-feat_dim", FEAT_DIM, "-min_words", 80,
             "-max_words", 140, "-frames_per_word", 25)
    return work / "corpus" / "data"


PARALLEL_FULL = {"hybrid_model": HYBRID_MODEL, "tp_cfg": {},
                 "tp_batch": TP_BATCH, "pp_model": PP_MODEL}


def run_parallel(torch, device="cuda", narrow=None):
    """The parallel phase: ranks sharing the card under gloo with CUDA
    tensors, every gate float32 at dropout 0.

    1. The probe: which collectives gloo carries on CUDA tensors, 2 ranks
       on cuda:0 (beside the main world).
    2.-3. Sequence parallelism (``parallel_rank``): train_am's long-form AM
       (conformer, d_model 144, band (-100, 50)) on the hybrid corpus's
       test batch, 8 ranks against one: the forward within SP_FWD_RTOL of
       its largest entry; the step's loss within STEP_LOSS_RTOL and every
       gradient leaf within GRAD_ATOL of its largest entry, on the batch
       and on it padded so its last shard holds no valid frame; after an
       Adam update the parameters bit-equal across the ranks; the step's
       time on 8 ranks and on 1.
    4. ``train_am -seq_shards 8 -dist_backend gloo -epoch 1`` on the hybrid
       corpus at the recipe's defaults: exit 0, finite losses, on every
       rank K2a-c exactly en_layers x steps, K3 exactly dropout sites x
       steps each way and K1 en_layers x dev batches; ``dump_posteriors``
       on one card reads its checkpoint.
    5. dp x tp: the TIMIT banded model on a 2 x 2 mesh, one step at batch
       100 against one rank: loss within STEP_LOSS_RTOL, every gradient
       within GRAD_ATOL of its leaf's largest entry, the updated parameters
       within PARAM_RTOL of each leaf's largest entry or at most
       F32_NOISE_RATIO times the one-rank step's one-ulp noise.
    6. The pipeline: a banded AM at TIMIT's encoder widths over 3 stages
       and 6 microbatches of a hybrid-corpus batch: the forward within
       PP_FWD_RTOL, the loss within STEP_LOSS_RTOL, every gradient within
       GRAD_ATOL of its leaf's largest entry.
    A failed rank fails the run.  Returns the readings, the launches (every
    rank's, summed: they join the kernels line), the processes and the
    seconds.  ``narrow`` replaces PARALLEL_FULL's models and batch (a
    rehearsal on the CPU)."""
    import numpy as np

    from pytorch_kaldi_asr_tpu_torch.parallel import multihost
    from pytorch_kaldi_asr_tpu_torch.train import load_checkpoint

    narrow = dict(PARALLEL_FULL, **(narrow or {}))
    model = narrow["hybrid_model"]
    t_phase = time.perf_counter()
    work = _fresh(WORK / "parallel")
    data = parallel_corpus(work)
    probe = start_probe(work, device)
    spec = work / "world.json"
    spec.write_text(json.dumps({"corpus": str(data), "device": device,
                                "narrow": narrow, "t0": time.time(),
                                "timed": str(work / "timed"),
                                "result": str(work / "world_result.json")}))
    # train_am -seq_shards starts beside the world once the world's step
    # times are taken (its marker file), so its start-up overlaps the
    # world's gates
    world_done = threading.Event()
    side = {}

    def train_am_beside():
        while not (work / "timed").exists():
            if world_done.wait(0.2):
                return
        try:
            side["at"] = time.perf_counter() - t_phase
            side["run"] = _run_cli_timed(work, work / "train_am.log",
                                         "recipes.train_am", *train_am_args)
        except Exception as e:  # raised in the caller's thread below
            side["error"] = e

    train_am_args = (
        "-read_train_dir", data / "train", "-read_dev_dir", data / "dev",
        "-save_model_dir", work / "am", "-encoder_type",
        model["encoder_type"], "-epoch", 1, "-batch_size", HYBRID_BATCH,
        "-en_d_model", model["en_d_model"], "-optim_start_lr", 0.003,
        "-en_dropout", model["en_dropout"], "-encoder_sub_sequence",
        "({},{})".format(*model["encoder_sub_sequence"]), "-seq_shards",
        PARALLEL_RANKS, "-dist_backend", "gloo", "-device", device)
    beside = threading.Thread(target=train_am_beside, daemon=True)
    beside.start()
    t0 = time.perf_counter()
    env_path = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = str(REPO)
    try:
        multihost.spawn_local([sys.executable, str(REPO / "chip_smoke.py"),
                               "--parallel-rank", str(spec)],
                              PARALLEL_RANKS, timeout=PARALLEL_TIMEOUT_S)
    finally:
        world_done.set()
        if env_path is None:
            os.environ.pop("PYTHONPATH")
        else:
            os.environ["PYTHONPATH"] = env_path
    world_s = time.perf_counter() - t0
    beside.join(PARALLEL_TIMEOUT_S)
    if "error" in side or "run" not in side:
        raise AssertionError(f"train_am -seq_shards: {side.get('error')}")
    res = json.loads((work / "world_result.json").read_text())
    res["probe"] = finish_probe(work, probe)
    print("parallel probe (gloo, CUDA tensors, 2 ranks on cuda:0): "
          + json.dumps(res["probe"]))
    fails = []
    if res["sp_fwd_rel"] > SP_FWD_RTOL:
        fails.append(f"SP forward {res['sp_fwd_rel']:.3g}")
    for name, row in res["sp_step"].items():
        if not row["finite"] or row["loss_rel"] > STEP_LOSS_RTOL \
                or row["grad_rel_max"] > GRAD_ATOL:
            fails.append(f"SP step ({name}) {row}")
    if res["sp_param_mismatches"]:
        fails.append(f"{res['sp_param_mismatches']} parameter words differ "
                     "across the ranks after the update")
    tp_row = res["tp"]
    if tp_row["loss_rel"] > STEP_LOSS_RTOL \
            or tp_row["grad_rel_max"] > GRAD_ATOL or any(
                r > F32_NOISE_RATIO for r in
                tp_row["over_limit_noise_ratios"].values()):
        fails.append(f"dp x tp {tp_row}")
    for s, row in enumerate(res["pp"]["stages"]):
        if row["fwd_rel"] > PP_FWD_RTOL or row["loss_rel"] > STEP_LOSS_RTOL \
                or row["grad_rel_max"] > GRAD_ATOL:
            fails.append(f"pipeline stage {s} {row}")
    for r, counts in enumerate(res["launches_by_rank"]):
        # every rank ran the SP forward (K1) and steps (K2a-c)
        if device.startswith("cuda") and not (
                counts["banded_attention"] and counts["banded_attention_fwd"]
                and counts["banded_attention_dq"]
                and counts["banded_attention_dkv"]):
            fails.append(f"rank {r} launched {counts}")

    # train_am -seq_shards 8 through its CLI (beside the world), then
    # dump_posteriors on one card, in this process
    wall, text, lines = side["run"]
    ckpt = load_checkpoint(str(work / "am"))
    cfg, steps = ckpt["cfg"], ckpt["step"]
    losses = re.findall(r"mean train loss (\S+) over (\d+) steps", text)
    if not losses or not all(math.isfinite(float(l)) for l, _ in losses):
        fails.append(f"train_am -seq_shards losses {losses}")
    sites = dropout_sites(cfg, decoder=False)["float32"]
    from pytorch_kaldi_asr_tpu_torch.ops.launches import LOG_RE

    ranks = {d: json.loads(c) for d, c in re.findall(LOG_RE, text)}
    dev_batches = -(-len((data / "dev" / "ali.txt").read_text()
                         .splitlines()) // HYBRID_BATCH)
    want = {"banded_attention_fwd": cfg.en_layers * steps,
            "banded_attention_dq": cfg.en_layers * steps,
            "banded_attention_dkv": cfg.en_layers * steps,
            "fused_dropout_forward": sites * steps,
            "fused_dropout_backward": sites * steps,
            "banded_attention": cfg.en_layers * dev_batches}
    if sorted(int(name.split("#rank")[1]) for name in ranks) != list(
            range(PARALLEL_RANKS)):
        fails.append(f"train_am -seq_shards logged ranks {sorted(ranks)}")
    for name, counts in ranks.items():
        wrong = {k: (counts.get(k), v) for k, v in want.items()
                 if counts.get(k) != v}
        if wrong and device.startswith("cuda"):
            fails.append(f"train_am {name}: (launched, expected) {wrong}")
    t0 = time.perf_counter()
    before = launch_counts()
    from pytorch_kaldi_asr_tpu_torch.recipes import dump_posteriors

    if dump_posteriors.main([
            "-read_data_dir", str(data / "test"), "-load_model_file",
            str(work / "am"), "-wspecifier",
            f"ark,scp:{work}/post.ark,{work}/post.scp", "-device",
            device]) != 0:
        fails.append("dump_posteriors failed")
    dump_launches = {k: v - before[k] for k, v in launch_counts().items()}
    from pytorch_kaldi_asr_tpu_torch.io import kaldi_io

    posts = list(kaldi_io.read_mat_scp(str(work / "post.scp")))
    n_test = len((data / "test" / "ali.txt").read_text().splitlines())
    if len(posts) != n_test or not all(np.isfinite(m).all()
                                       for _, m in posts):
        fails.append(f"dump_posteriors wrote {len(posts)} of {n_test}")
    dump_s = time.perf_counter() - t0
    launches = {}
    for counts in [*res["launches_by_rank"], *ranks.values(),
                   dump_launches]:
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    marks = {name: _first_at(lines, needle) for name, needle in (
        ("started", "train_am started in"),
        ("first_rank_joined", "joined distributed world"),
        ("loaders_ready", "sequence-parallel training:"),
        ("epoch_done", "dev frame-acc"),
        ("saved", "AM saved to"), ("launches", "kernel launches on"))}
    out = dict(res, launches=launches, train_am={
        "wall_s": wall, "steps": steps, "losses": losses, "at_s": marks,
        "launches_by_rank": ranks, "expected": want},
        processes=2 + PARALLEL_RANKS + (1 + PARALLEL_RANKS),
        seconds={"world": world_s, "train_am": wall,
                 "train_am_started_at": side["at"], "dump": dump_s,
                 "phase": time.perf_counter() - t_phase})
    print("parallel: " + json.dumps(out))
    if fails:
        raise AssertionError("parallel phase: " + "; ".join(fails))
    return out


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
            for shape in ("timit_decode", "conformer_decode",
                          "longform_decode")}
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

    for flag, rank_main in (("--parallel-rank", parallel_rank),
                            ("--probe-rank", probe_rank)):
        if sys.argv[1:2] == [flag]:  # a rank of the parallel phase: its
            sys.path.insert(0, str(REPO))  # device is in its spec
            return rank_main(torch, sys.argv[2])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a card",
              file=sys.stderr)
        return 2
    step_only = sys.argv[1:2] == ["--train-step"]
    noisy_leaf = sys.argv[1:2] == ["--noisy-leaf"]
    spliced = sys.argv[1:2] == ["--spliced-precision"]
    bf16_gates = sys.argv[1:2] == ["--bf16-gates"]
    bf16_compute_gates = sys.argv[1:2] == ["--bf16-compute-gates"]
    recipe_only = sys.argv[1:2] == ["--recipe"]
    hybrid_only = sys.argv[1:2] == ["--hybrid"]
    serve_only = sys.argv[1:2] == ["--serve"]
    lattice_only = sys.argv[1:2] == ["--lattice"]
    search_only = sys.argv[1:2] == ["--device-search"]
    tools_only = sys.argv[1:2] == ["--tools"]
    parallel_only = sys.argv[1:2] == ["--parallel"]
    native_host_only = sys.argv[1:2] == ["--native-host"]
    if sys.argv[1:2] == ["--k3-plain"]:  # the CPU alone: nothing to build
        sys.path.insert(0, str(REPO))
        print(f"card: {card_line()}")
        print("K3_PLAIN " + json.dumps(k3_plain_readings(torch)))
        return 0
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

    global RUN_START
    t_start = RUN_START = time.perf_counter()
    card = card_line()
    print(f"card: {card}")
    disable_tf32()
    if spliced:  # launches no kernel of the port: nothing to build
        for encoder in ("tdnn", "tdnnf"):
            print("SPLICED_PRECISION " + json.dumps(
                {"card": card, "encoder": encoder,
                 "routes": spliced_precision(torch, encoder)}))
        return 0

    full_run = not (sources or noisy_leaf or bf16_gates or bf16_compute_gates
                    or step_only or recipe_only or hybrid_only or serve_only
                    or lattice_only or search_only or tools_only
                    or parallel_only or native_host_only)
    # the training paths' CPU reference steps use the CPU while nvcc builds
    prefetch = (threading.Thread(target=prefetch_cpu_steps, args=(torch,),
                                 daemon=True) if full_run else None)
    if prefetch is not None:
        prefetch.start()
    t0 = time.perf_counter()
    procs = start_k2_builds(sources) if sources else None
    logs = _build.build(["banded_attention_train"] if sources else None)
    print(f"built {sorted(logs) or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.1f} s")
    if prefetch is not None:
        t1 = time.perf_counter()
        prefetch.join()
        print(f"the prefetched CPU steps took {time.perf_counter() - t1:.1f} s "
              f"more after the build")
    for name, log in logs.items():
        summary = ptxas_summary(log)
        for line in summary or [x.strip() for x in log.splitlines()
                                if "ptxas" in x or "spill" in x]:
            print(f"  {name}: {line}")
    if not sources:
        check_sm90_build(logs.get(SM90_SOURCE),
                         _build.library_path(SM90_SOURCE),
                         _build.CSRC / f"{SM90_SOURCE}.cu")
    if sources:
        from pytorch_kaldi_asr_tpu_torch.ops import banded_attention as ba

        compared = compare_k2_sources(torch, ba, finish_k2_builds(procs))
        for shape, row in compared.items():
            print("K2_SOURCES " + json.dumps(
                {"card": card, "shape": shape, **row}))
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

    if not (recipe_only or hybrid_only or serve_only or lattice_only
            or search_only or tools_only or parallel_only
            or native_host_only):
        kp = kernel_phase(torch)
        print(f"kernel phase done at {time.perf_counter() - t_start:.1f} s")

    decodes, trainings = {}, {}

    def decode_path(corpus):
        name = corpus["name"]
        summary = run_slice(torch, corpus)
        model = corpus["model"]
        en_layers = int(model[model.index("-en_layers") + 1])
        attends = model[model.index("-encoder_type") + 1] in ATTENDING
        expected = en_layers * summary["batches"] if attends else 0
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
        print(f"{name} decode done at {time.perf_counter() - t_start:.1f} s")
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

    def recipe_phase():
        """fbank on the card, the float32 tdnn decode, and the TIMIT port
        recipe's run.sh, stages 0-5."""
        phase = {"fbank": run_fbank(torch)}
        print("fbank: " + json.dumps(phase["fbank"]))
        decode_path(TIMIT_TDNN)
        t0 = time.perf_counter()
        # the deferred CPU cross-checks beside run.sh, whose processes
        # leave most of the host's cores idle
        start_side_checks(torch)
        phase["recipe"] = run_recipe(torch)
        phase["recipe"]["card"] = card
        print("recipe: " + json.dumps(phase["recipe"]))
        print(f"recipe phase: {time.perf_counter() - t0:.1f} s, done at "
              f"{time.perf_counter() - t_start:.1f} s")
        return phase

    def hybrid_phase(kernels):
        """The long-form kernel case (``kernels``: checked and timed here,
        else by the kernel phase), then the long-form recipe."""
        t0 = time.perf_counter()
        phase = {}
        if kernels:
            from pytorch_kaldi_asr_tpu_torch.ops import banded_attention as ba

            phase["kernels"] = longform_kernels(torch, ba)
        phase["recipe"] = run_hybrid(torch)
        phase["recipe"]["card"] = card
        print(f"hybrid phase: {time.perf_counter() - t0:.1f} s, done at "
              f"{time.perf_counter() - t_start:.1f} s")
        return phase

    def lattice_phase():
        """The lattice tools over the hybrid phase's posteriors, graph and
        CTM (``run_lattice``)."""
        phase = run_lattice(torch, WORK / "hybrid")
        phase["card"] = card
        print(f"lattice phase: {phase['seconds']:.1f} s, oracle WER "
              f"{phase['oracle']['wer']:.2f} %, 1-best "
              f"{phase['onebest_wer']['wer']:.2f} %, rescored 3-gram "
              f"{phase['rescored_wer']['lm']['wer']:.2f} %, NLM "
              f"{phase['rescored_wer']['nlm']['wer']:.2f} %, consensus "
              f"{phase['consensus_wer']['wer']:.2f} %, rover "
              f"{phase['rover_wer']['wer']:.2f} %; done at "
              f"{time.perf_counter() - t_start:.1f} s; {card}")
        return phase

    def search_phase(graph_b, profile=False):
        """The device search over the hybrid phase's posteriors and graph
        and graph B (``run_device_search``), its CPU references joined."""
        before = time.perf_counter() - t_start
        phase = run_device_search(torch, WORK / "hybrid", graph_b,
                                  profile=profile)
        phase["card"] = card
        rate, peak = phase["s_per_audio_s"], phase["peak_bytes"]
        for g in ("A", "B"):
            size = phase["graphs"][g]
            print(f"device search graph {g}: {size['states']} states, "
                  f"{size['arcs']} arcs; seconds per second of audio: dense "
                  f"{rate[f'dense_{g}']:.5f}, frontier "
                  f"{rate[f'frontier_{g}']:.5f}"
                  f"{' (their CLIs)' if g == 'B' else ''}, host latgen "
                  f"{rate[f'host_{g}']:.5f}; peak device memory"
                  + (f" dense {peak['dense_A']}, frontier "
                     f"{peak['frontier_A']}" if g == "A" else
                     f" frontier {peak['frontier_B_cut']} (2 utterances)")
                  + f" bytes; {card}")
        after = time.perf_counter() - t_start
        print(f"device search phase: {phase['phase_s']:.1f} s (graph B built "
              f"in {graph_b['build_s']:.1f} s before the lattice phase); the "
              f"run {before:.1f} s before it, {after:.1f} s after; {card}")
        return phase

    def tools_phase():
        """The native core, bench_rtf, the proto DNN, a profile's summary
        and the device list over the hybrid phase's posteriors and graphs
        A and B (``run_tools``)."""
        before = time.perf_counter() - t_start
        phase = run_tools(torch, WORK / "hybrid", WORK / "recipe")
        phase["card"] = card
        d = phase["decodes"]
        for g in ("A", "B"):
            for p in ("trained", "noisy"):
                print(f"tools phase, graph {g}, {p} posteriors: native "
                      f"latgen {d[f'native_{g}_{p}']['s_per_audio_s']:.6f} s "
                      f"per s of audio, Python "
                      f"{d[f'python_{g}_{p}']['s_per_audio_s']:.6f} "
                      f"({d[f'check_{g}_{p}']['speedup']:.1f} x); {card}")
        host = phase["native_host"]
        print(f"native host core: {host['library']['file']} (built by this "
              f"run: {host['library']['built_here']}), "
              f"{host['clis']['tools']['dir']}/"
              f"{{{','.join(host['clis']['tools']['files'])}}} (built by "
              f"this run: {host['clis']['tools']['built_here']}); "
              f"{host['phase_s']:.1f} s of the phase, the side thread's "
              f"CLIs waited on {host['side_wait_s']:.1f} s; {card}")
        n = phase["launches"]
        print(f"tools phase: {phase['phase_s']:.1f} s (K1 "
              f"{n['banded_attention']}, K2a-c {n['banded_attention_fwd']}, "
              f"{n['banded_attention_dq']}, {n['banded_attention_dkv']}, K3 "
              f"{n['fused_dropout_forward']} + "
              f"{n['fused_dropout_backward']} launches); the run "
              f"{before:.1f} s before it, "
              f"{time.perf_counter() - t_start:.1f} s after; {card}")
        return phase

    def serve_phase():
        """Both servers on the TIMIT decode path's checkpoint and the
        hybrid phase's corpus and graph (``run_serve``)."""
        t0 = time.perf_counter()
        phase = run_serve(torch, decodes["timit"], WORK / "hybrid",
                          WORK / "fbank")
        phase["card"] = card
        for name in ("attention", "hybrid"):
            row = phase[name]
            print(f"{name} server: ready in {row['ready_s']:.1f} s (start-up "
                  f"{row['startup_s']:.1f} s, warm-up {row['warmup_s']:.1f} "
                  f"s), /recognize p50 {row['recognize_p50_ms']} ms, p95 "
                  f"{row['recognize_p95_ms']} ms; {card}")
        print("serve: " + json.dumps(phase))
        print(f"serve phase: {time.perf_counter() - t0:.1f} s, done at "
              f"{time.perf_counter() - t_start:.1f} s")
        return phase

    def parallel_phase():
        """Ranks of one world sharing the card (``run_parallel``)."""
        before = time.perf_counter() - t_start
        phase = run_parallel(torch)
        phase["card"] = card
        sp = phase["sp_step"]["batch"]
        print(f"parallel phase: {phase['seconds']['phase']:.1f} s over "
              f"{phase['processes']} processes (the world "
              f"{phase['seconds']['world']:.1f} s; train_am -seq_shards "
              f"{PARALLEL_RANKS} {phase['seconds']['train_am']:.1f} s from "
              f"{phase['seconds']['train_am_started_at']:.1f} s, beside it; "
              f"dump_posteriors {phase['seconds']['dump']:.1f} s); SP "
              f"forward {phase['sp_fwd_rel']:.3g}, step loss "
              f"{sp['loss_rel']:.3g}, gradients {sp['grad_rel_max']:.3g}; "
              f"dp x tp loss {phase['tp']['loss_rel']:.3g}, gradients "
              f"{phase['tp']['grad_rel_max']:.3g}, parameters "
              f"{phase['tp']['param_rel_max']:.3g}; the SP step "
              f"{phase['sp_step_ms_8_ranks']:.1f} ms on {PARALLEL_RANKS} "
              f"ranks sharing the card, {phase['sp_step_ms_1_rank']:.1f} ms "
              f"on one; the run {before:.1f} s before it, "
              f"{time.perf_counter() - t_start:.1f} s after; {card}")
        return phase

    if parallel_only:
        parallel_phase()
        print(f"whole run {time.perf_counter() - t_start:.1f} s")
        return 0
    if recipe_only:
        recipe_phase()
        join_side_checks(torch)
        return 0
    if hybrid_only:
        hybrid_phase(kernels=True)
        return 0
    if lattice_only:
        hybrid_phase(kernels=True)
        lattice_phase()
        print(f"whole run {time.perf_counter() - t_start:.1f} s")
        return 0
    if tools_only:
        run_recipe(torch)
        hybrid_phase(kernels=True)
        build_graph_b(WORK / "hybrid", WORK / "device_search" / "graph_b")
        tools_phase()
        print(f"whole run {time.perf_counter() - t_start:.1f} s")
        return 0
    if native_host_only:
        run_recipe(torch)
        print(f"recipe done at {time.perf_counter() - t_start:.1f} s")
        host = run_native_host(torch, WORK / "recipe")
        print("native host: " + json.dumps(host, default=str))
        print(f"whole run {time.perf_counter() - t_start:.1f} s")
        return 0
    if search_only:
        hybrid_phase(kernels=True)
        search_phase(queue_device_search(torch, WORK / "hybrid"),
                     profile=True)
        print(f"whole run {time.perf_counter() - t_start:.1f} s")
        return 0
    if serve_only:  # the serve phase and the paths that make its inputs
        decode_path(TIMIT)
        train_path(TIMIT)
        print("fbank: " + json.dumps(run_fbank(torch)))
        hybrid_phase(kernels=False)
        join_side_checks(torch)
        print(f"before the serve phase: {time.perf_counter() - t_start:.1f}"
              f" s")
        serve_phase()
        print(f"whole run {time.perf_counter() - t_start:.1f} s")
        return 0

    timit = decode_path(TIMIT)
    searches = check_fixed_buffer_search(torch, TIMIT, timit)
    print(f"fixed-buffer search done at {time.perf_counter() - t_start:.1f} s")
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
    # the TIMIT recipe's other switches: the tdnnf with SpecAugment and the
    # blstm, the banded step with SpecAugment, the neural LM, fusion, int8
    for corpus in (TIMIT_TDNNF, TIMIT_BLSTM):
        decode_path(corpus)
        train_path(corpus)
    extra = {"specaugment_step": run_specaugment_step(torch)}
    extra["nlm"] = run_nlm(torch, WORK / TIMIT["name"] / "decode"
                           / "decode.txt")
    print("nlm: " + json.dumps(extra["nlm"]))
    lm_decodes = run_lm_decodes(torch, timit, extra["nlm"]["model"])
    extra.update({f"decode_{k}": v for k, v in lm_decodes.items()
                  if isinstance(v, dict) and "launches" in v})
    for name, row in extra.items():
        row["card"] = card
    print("lm and int8 decodes: " + json.dumps(lm_decodes))
    print(f"lm paths done at {time.perf_counter() - t_start:.1f} s")
    for name in ("librispeech", "librispeech_bf16",
                 "librispeech_bf16_compute"):
        profile = trainings[name]["step_profile"]
        print(f"conformer train step, {name}: "
              f"{trainings[name]['step_ms']:.3f} ms, "
              f"{trainings[name]['frames_per_s']:.0f} real frames/s, "
              f"{profile['device_ms_per_step']:.2f} ms of device time, idle "
              f"share {profile['idle_share']:.3f}; top kernels "
              + json.dumps(profile["top_kernels_ms_per_step"][:5]))

    recipe = recipe_phase()
    hybrid = hybrid_phase(kernels=False)
    join_side_checks(torch)
    # the device search's CPU references run beside the lattice phase
    graph_b = queue_device_search(torch, WORK / "hybrid")
    before_lattice = time.perf_counter() - t_start
    print(f"before the lattice phase: {before_lattice:.1f} s")
    lattice = lattice_phase()
    search_phase(graph_b)
    tools = tools_phase()
    before_serve = time.perf_counter() - t_start
    print(f"before the serve phase: {before_serve:.1f} s (without the "
          f"lattice phase: {before_serve - lattice['seconds']:.1f} s)")
    serve = serve_phase()
    parallel = parallel_phase()

    def total(name, paths):
        return sum(p["launches"][name] for p in paths)

    paths = [*decodes.values(), *trainings.values(), *extra.values(),
             recipe["recipe"], hybrid["recipe"], lattice, tools, serve,
             parallel]
    jax_file = "pytorch_kaldi_asr_tpu/ops/banded_attention.py"
    source = "pytorch_kaldi_asr_tpu_torch/ops/csrc/banded_attention_train.cu"
    sm90 = f"pytorch_kaldi_asr_tpu_torch/ops/csrc/{SM90_SOURCE}.cu"
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
                source=sm90 if sfx and name != "fwd" else source,
                replaces=f"{jax_file}:{line}",
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
    print("cpu references: " + json.dumps(
        {"total_s": sum(s for _, s in CPU_REFERENCES),
         "each_s": CPU_REFERENCES}))
    print(f"whole run {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
