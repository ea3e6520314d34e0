"""Shallow-fusion weight sweep: decode a dataset at several LM weights
and report the WER of each (the fusion analogue of the recipe's
inverse-weight rescoring sweep).  Every decode runs the fused search on the
device (decode/fusion.py), the banded encoder's attention through K1.

Usage::

    python3 -m pytorch_kaldi_asr_tpu_torch.tools.sweep_fusion \
        -read_data_dir data/dev_filtered -read_vocab_file lang/vocab.txt \
        -load_model_file exp/model/combined.accuXX \
        -nlm_model_dir lang/nlm -weights 0,0.3,0.5,1.0 \
        -save_dir exp/fusion_sweep

Same flags as ``pytorch_kaldi_asr_tpu.tools.sweep_fusion`` plus
``-device`` (``cuda`` by default; ``cpu`` on request; without a visible
card and without ``-device cpu`` it raises).
"""

from __future__ import annotations

import argparse
import os

from pytorch_kaldi_asr_tpu_torch.data import read_vocab
from pytorch_kaldi_asr_tpu_torch.data.loader import make_batch_loader
from pytorch_kaldi_asr_tpu_torch.decode.runner import decode_dataset
from pytorch_kaldi_asr_tpu_torch.io import kaldi_io
from pytorch_kaldi_asr_tpu_torch.models.nlm import load_nlm
from pytorch_kaldi_asr_tpu_torch.ops.launches import log_launch_counts
from pytorch_kaldi_asr_tpu_torch.score.rescore import read_nbest
from pytorch_kaldi_asr_tpu_torch.score.wer import compute_wer
from pytorch_kaldi_asr_tpu_torch.train import load_checkpoint
from pytorch_kaldi_asr_tpu_torch.utils.device import disable_tf32, resolve_device
from pytorch_kaldi_asr_tpu_torch.utils.logging import info, log_startup


def one_best_table(nbest_path):
    """First hypothesis per key from a ``key\\tscore\\ttext`` n-best file."""
    table = read_nbest(nbest_path)
    return {key: texts[0].split() for key, (_am, _lm, texts)
            in table.items()}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-read_data_dir", required=True)
    parser.add_argument("-read_vocab_file", required=True)
    parser.add_argument("-load_model_file", required=True)
    parser.add_argument("-nlm_model_dir", required=True)
    parser.add_argument("-weights", default="0,0.2,0.4,0.6,0.8,1.0",
                        help="comma-separated fusion weights to sweep")
    parser.add_argument("-ref_text", default=None,
                        help="reference transcripts (default: "
                             "<data_dir>/text)")
    parser.add_argument("-max_token_seq_len", type=int, default=100)
    parser.add_argument("-batch_size", type=int, default=8)
    parser.add_argument("-beam_size", type=int, default=8)
    parser.add_argument("-num_buckets", type=int, default=1)
    parser.add_argument("-save_dir", required=True)
    parser.add_argument("-device", default="cuda",
                        help="cuda (default), cuda:N or cpu")
    opt = parser.parse_args(argv)

    device = resolve_device(opt.device)
    disable_tf32()
    weights = [float(w) for w in opt.weights.split(",") if w.strip()]
    vocab = read_vocab(opt.read_vocab_file)
    ckpt = load_checkpoint(opt.load_model_file, device=device)
    lm_params, lm_cfg, _ = load_nlm(opt.nlm_model_dir, device=device)
    ref_path = opt.ref_text or os.path.join(opt.read_data_dir, "text")
    ref = kaldi_io.read_key_value_text(ref_path)
    ref = {k: v.split() for k, v in ref.items()}
    os.makedirs(opt.save_dir, exist_ok=True)

    results = []
    for w in weights:
        out = os.path.join(opt.save_dir, f"decode_w{w:g}.txt")
        loader = make_batch_loader(opt.read_data_dir, vocab,
                                   opt.batch_size, mode="all",
                                   shuffle=False,
                                   num_buckets=opt.num_buckets)
        decode_dataset(
            ckpt["params"], ckpt["cfg"], loader, vocab,
            beam_size=opt.beam_size, nbest=1,
            max_token_seq_len=opt.max_token_seq_len,
            save_result_file=out, device=device,
            fusion=(lm_params, lm_cfg, w),
        )
        stats = compute_wer(ref, one_best_table(out), mode="present")
        wer = stats["wer"]
        results.append((w, wer, stats))
        info("fusion weight %g: %%WER %.2f [ %d / %d ]", w, wer,
             stats["errors"], stats["words"])

    best_w, best_wer, _ = min(results, key=lambda r: r[1])
    summary = os.path.join(opt.save_dir, "sweep.txt")
    with open(summary, "w", encoding="utf-8") as f:
        for w, wer, stats in results:
            f.write(f"weight {w:g}\t%WER {wer:.2f} "
                    f"[ {stats['errors']} / {stats['words']} ]\n")
        f.write(f"best\tweight {best_w:g}\t%WER {best_wer:.2f}\n")
    info("sweep summary -> %s (best: weight %g at %%WER %.2f)", summary,
         best_w, best_wer)
    log_launch_counts(device)
    return 0


if __name__ == "__main__":
    log_startup()
    raise SystemExit(main())
