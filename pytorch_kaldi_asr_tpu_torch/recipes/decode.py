"""Stage-5 decode entry point: load the combined checkpoint, beam-search the
dataset on the card, write the n-best ``decode.txt``.

Same flags as ``pytorch_kaldi_asr_tpu.recipes.decode`` plus ``-device``
(``cuda`` by default; ``cpu`` on request).  Without a visible card and
without ``-device cpu`` it raises rather than fall back.  ``-use_gpu`` is
accepted for recipe compatibility.  The search is the KV-cached one where
the model's decoder band is causal, else the fixed-buffer one;
``-nlm_model_dir`` (a checkpoint of recipes.train_nlm) fuses a neural LM
into the KV-cached search at ``-lm_weight`` (decode/fusion.py), and
``-quantize_weights`` decodes from int8 weights (ops/quant.py), the LM's
too.  A caller in Python may pass ``timings={}`` to :func:`main` to get
the wall seconds of the checkpoint, vocabulary and LM loading (``load_s``)
and of each part of the decode (``runner.decode_dataset``)."""

import argparse
import time

import torch

from pytorch_kaldi_asr_tpu_torch.data import read_vocab
from pytorch_kaldi_asr_tpu_torch.data.loader import make_batch_loader
from pytorch_kaldi_asr_tpu_torch.decode.runner import decode_dataset
from pytorch_kaldi_asr_tpu_torch.models.nlm import load_nlm
from pytorch_kaldi_asr_tpu_torch.ops.launches import log_launch_counts
from pytorch_kaldi_asr_tpu_torch.train import load_checkpoint
from pytorch_kaldi_asr_tpu_torch.utils.device import disable_tf32, resolve_device
from pytorch_kaldi_asr_tpu_torch.utils.logging import info, log_startup


def main(argv=None, *, timings=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-read_data_dir", required=True)
    parser.add_argument("-read_vocab_file", required=True)
    parser.add_argument("-load_model_file", required=True)
    parser.add_argument("-save_result_file", required=True)
    parser.add_argument("-max_token_seq_len", type=int, required=True)
    parser.add_argument("-batch_size", type=int, default=64)
    parser.add_argument("-beam_size", type=int, default=20)
    parser.add_argument("-nbest", type=int, default=10)
    parser.add_argument("-num_buckets", type=int, default=4,
                        help="length buckets: short utterances decode in "
                             "short shapes instead of padding everything "
                             "to the longest")
    parser.add_argument("-device", default="cuda",
                        help="cuda (default), cuda:N or cpu")
    parser.add_argument("-use_gpu", action="store_true",
                        help="accepted for recipe compatibility")
    parser.add_argument("-quantize_weights", action="store_true",
                        help="weight-only int8 decoding (ops/quant.py)")
    parser.add_argument("-nlm_model_dir", default=None,
                        help="neural LM checkpoint for per-step shallow "
                             "fusion (decode/fusion.py); must share the "
                             "recipe vocabulary")
    parser.add_argument("-lm_weight", type=float, default=0.3,
                        help="shallow-fusion LM weight")
    opt = parser.parse_args(argv)

    if opt.nbest > opt.beam_size:
        parser.error("nbest should not be larger than beam_size")
    device = resolve_device(opt.device)
    disable_tf32()
    t0 = time.perf_counter()
    ckpt = load_checkpoint(opt.load_model_file, device=device)
    info("loading model with parameter: %s", ckpt["cfg"])
    vocab = read_vocab(opt.read_vocab_file)
    loader = make_batch_loader(opt.read_data_dir, vocab, opt.batch_size,
                               mode="all", shuffle=False,
                               num_buckets=opt.num_buckets)
    fusion = None
    if opt.nlm_model_dir:
        lm_params, lm_cfg, _ = load_nlm(opt.nlm_model_dir, device=device)
        fusion = (lm_params, lm_cfg, opt.lm_weight)
        info("shallow fusion: %s at weight %.2f", opt.nlm_model_dir,
             opt.lm_weight)
    if timings is not None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        timings["load_s"] = time.perf_counter() - t0
    decode_dataset(
        ckpt["params"], ckpt["cfg"], loader, vocab,
        beam_size=opt.beam_size, nbest=opt.nbest,
        max_token_seq_len=opt.max_token_seq_len,
        save_result_file=opt.save_result_file, device=device,
        quantize_weights=opt.quantize_weights, fusion=fusion,
        timings=timings,
    )
    log_launch_counts(device)
    return 0


if __name__ == "__main__":
    log_startup()
    raise SystemExit(main())
