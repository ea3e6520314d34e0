"""Recognition server: load a trained checkpoint once and serve n-best
hypotheses over HTTP, on the card (the port's
``pytorch_kaldi_asr_tpu.recipes.serve``; serve/ holds its parts).

Same flags as the JAX CLI plus ``-device`` (``cuda`` by default; ``cpu`` on
request; without a visible card and without ``-device cpu`` it raises
rather than fall back).  Attention mode (default): an encoder-decoder
checkpoint and its vocabulary, the KV-cached beam search per length bucket,
streaming partials.  Hybrid mode (``-graph_dir``): an AM checkpoint of
recipes/train_am.py and a graph dir of recipes/mkgraph.py, the AM on the
card and the graph search on the host, true streaming.  ``-port 0`` binds a
free port, named by the ``serving on HOST:PORT`` line.  On SIGTERM the
server drains its requests and the process logs its kernel launches
(``ops/launches.py``) before it exits 0.

Usage::

    python3 -m pytorch_kaldi_asr_tpu_torch.recipes.serve \\
        -read_model_file exp/model/combined -read_vocab_file lang/vocab.txt \\
        -port 8600 -beam_size 8
    python3 -m pytorch_kaldi_asr_tpu_torch.recipes.serve \\
        -read_model_file exp/am -graph_dir exp/graph -beam 16 -port 8600
"""

import argparse

from pytorch_kaldi_asr_tpu_torch.ops.launches import log_launch_counts
from pytorch_kaldi_asr_tpu_torch.serve.batcher import MicroBatcher
from pytorch_kaldi_asr_tpu_torch.serve.http import serve
from pytorch_kaldi_asr_tpu_torch.serve.hybrid import HybridRecognizer
from pytorch_kaldi_asr_tpu_torch.serve.recognizer import (
    DEFAULT_BUCKETS,
    Recognizer,
)
from pytorch_kaldi_asr_tpu_torch.utils.device import disable_tf32, resolve_device
from pytorch_kaldi_asr_tpu_torch.utils.logging import log_startup


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-read_model_file", required=True)
    parser.add_argument("-read_vocab_file", default=None,
                        help="vocab (attention mode)")
    parser.add_argument("-graph_dir", default=None,
                        help="HCLG graph dir -> hybrid AM mode with true "
                             "streaming (the model file must be an AM "
                             "checkpoint from recipes/train_am.py)")
    parser.add_argument("-priors_file", default=None,
                        help="hybrid mode: .npy log-priors to divide out")
    parser.add_argument("-acoustic_scale", type=float, default=1.0)
    parser.add_argument("-port", type=int, default=8600)
    parser.add_argument("-host", default="127.0.0.1")
    parser.add_argument("-beam_size", type=int, default=8)
    parser.add_argument("-partial_beam", type=int, default=0,
                        help="narrower beam for streaming PARTIAL decodes "
                             "only (0 = use -beam_size); finals are "
                             "unaffected")
    parser.add_argument("-beam", type=float, default=16.0,
                        help="hybrid graph beam")
    parser.add_argument("-max_token_seq_len", type=int, default=None)
    parser.add_argument("-buckets", default=None,
                        help="comma-separated frame-length buckets "
                             "(default 100,200,300,500 clipped to the "
                             "encoder max length)")
    parser.add_argument("-max_batch", type=int, default=1,
                        help=">1 coalesces concurrent requests into one "
                             "batched search of this static size (both "
                             "modes; in hybrid mode the AM forward batches, "
                             "the graph searches stay per utterance)")
    parser.add_argument("-batch_window_ms", type=float, default=5.0)
    parser.add_argument("-quantize_weights", action="store_true",
                        help="serve int8 matmul weights (ops/quant.py), "
                             "dequantized once per search call")
    parser.add_argument("-nlm_model_dir", default=None,
                        help="neural LM for per-step shallow fusion "
                             "(attention mode only)")
    parser.add_argument("-lm_weight", type=float, default=0.3)
    parser.add_argument("-no_warmup", action="store_true")
    parser.add_argument("-stream_chunk", type=int, default=40,
                        help="internal streaming push size in frames "
                             "(hybrid mode): client chunks are re-chunked "
                             "to this fixed size")
    parser.add_argument("-device", default="cuda",
                        help="cuda (default), cuda:N or cpu")
    opt = parser.parse_args(argv)

    device = resolve_device(opt.device)
    disable_tf32()
    buckets = (tuple(int(b) for b in opt.buckets.split(","))
               if opt.buckets else DEFAULT_BUCKETS)
    if opt.graph_dir:
        if opt.nlm_model_dir:
            parser.error("-nlm_model_dir applies to the attention search; "
                         "hybrid mode rescores via lattice tools instead")
        rec = HybridRecognizer(opt.read_model_file, opt.graph_dir,
                               beam=opt.beam, priors_file=opt.priors_file,
                               acoustic_scale=opt.acoustic_scale,
                               buckets=buckets,
                               quantize_weights=opt.quantize_weights,
                               stream_chunk=opt.stream_chunk, device=device)
    else:
        if not opt.read_vocab_file:
            parser.error("-read_vocab_file is required without -graph_dir")
        rec = Recognizer(opt.read_model_file, opt.read_vocab_file,
                         beam_size=opt.beam_size,
                         max_token_seq_len=opt.max_token_seq_len,
                         buckets=buckets,
                         quantize_weights=opt.quantize_weights,
                         nlm_model_dir=opt.nlm_model_dir,
                         lm_weight=opt.lm_weight,
                         partial_beam=opt.partial_beam or None, device=device)
    if opt.max_batch > 1:
        rec = MicroBatcher(rec, max_batch=opt.max_batch,
                           window_ms=opt.batch_window_ms)
    if not opt.no_warmup:
        rec.warmup()
    serve(rec, opt.port, host=opt.host)
    log_launch_counts(device)
    return 0


if __name__ == "__main__":
    log_startup()
    raise SystemExit(main())
