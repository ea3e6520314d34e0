"""The attention-mode recognizer: a trained encoder-decoder checkpoint and
its vocabulary loaded once, and the KV-cached beam search over requests
padded to a few length buckets (the port's ``Recognizer`` of
``pytorch_kaldi_asr_tpu.recipes.serve``).

The buckets keep the shapes a server sees few: every request pads to the
smallest bucket that holds it (longer ones are cut to the largest), and
each bucket is warmed before the port opens.  The encoder runs K1 on the
card for the ``banded`` and ``conformer`` encoders.  ``-quantize_weights``
keeps int8 weights on the device and dequantizes them once per search call
(as the decode CLI does); ``nlm_model_dir`` fuses a neural LM into each
search step (decode/fusion.py).  ``reload`` swaps weights of the same
configuration between searches; ``new_attention_stream`` opens the
incremental partials of a streaming session (serve/attention_stream.py).
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from pytorch_kaldi_asr_tpu_torch.data import read_vocab
from pytorch_kaldi_asr_tpu_torch.decode.fusion import make_fused_search
from pytorch_kaldi_asr_tpu_torch.decode.runner import (
    _pick_search,
    ids_to_words,
    nbest_from_result,
)
from pytorch_kaldi_asr_tpu_torch.models.nlm import load_nlm
from pytorch_kaldi_asr_tpu_torch.models.streaming import (
    FixedChunkStream,
    StreamingBandedEncoder,
    StreamingConformer,
    StreamingTDNN,
)
from pytorch_kaldi_asr_tpu_torch.models.transformer import encode
from pytorch_kaldi_asr_tpu_torch.ops.quant import (
    dequantize_tree,
    quantize_tree,
    tree_bytes,
)
from pytorch_kaldi_asr_tpu_torch.serve.attention_stream import _AttentionStream
from pytorch_kaldi_asr_tpu_torch.train.checkpoint import load_checkpoint
from pytorch_kaldi_asr_tpu_torch.utils.device import resolve_device
from pytorch_kaldi_asr_tpu_torch.utils.logging import info

DEFAULT_BUCKETS = (100, 200, 300, 500)


def _clip_buckets(buckets, max_len):
    return tuple(b for b in sorted(buckets) if b <= max_len) or (max_len,)


def _pick_bucket(buckets, t):
    for b in buckets:
        if t <= b:
            return b
    return buckets[-1]


def _check_features(feats, src_dim):
    feats = np.asarray(feats, np.float32)
    if feats.ndim != 2 or feats.shape[1] != src_dim:
        raise ValueError(
            f"expected [T, {src_dim}] features, got {feats.shape}")
    return feats


def _padded_batch(feats_list, buckets, encoder_max_len, src_dim, batch_pad,
                  device):
    """Features [bp, bucket, D] and mask [bp, bucket] on ``device`` for
    ``feats_list`` (rows past it masked out), with the frames each
    utterance keeps."""
    bp = batch_pad or len(feats_list)
    b = max(_pick_bucket(buckets, min(f.shape[0], encoder_max_len))
            for f in feats_list)
    src = np.zeros((bp, b, src_dim), np.float32)
    mask = np.zeros((bp, b), np.uint8)
    kept = []
    for i, f in enumerate(feats_list):
        t = min(f.shape[0], b)
        src[i, :t] = f[:t]
        mask[i, :t] = 1
        kept.append(t)
    return (torch.from_numpy(src).to(device), torch.from_numpy(mask).to(device),
            kept)


class Recognizer:
    """Model + vocabulary + bucketed beam search on ``device`` (``cuda``
    unless the caller asks for ``cpu``); thread-safe through one lock
    around the device work."""

    def __init__(self, model_file, vocab_file, *, beam_size=8,
                 max_token_seq_len=None, buckets=DEFAULT_BUCKETS,
                 use_cache=True, quantize_weights=False, nlm_model_dir=None,
                 lm_weight=0.3, partial_beam=None, device="cuda"):
        self.device = resolve_device(str(device))
        ck = load_checkpoint(model_file, device=self.device)
        self.params, self.cfg = ck["params"], ck["cfg"]
        self.model_file = model_file
        self.model_meta = ck.get("meta", {})
        self.word2idx = read_vocab(vocab_file)
        self.idx2word = {i: w for w, i in self.word2idx.items()}
        self.beam_size = beam_size
        # partials need stability, not n-best quality: a narrower beam for
        # the partial-only decodes; finals keep beam_size
        self.partial_beam = partial_beam or beam_size
        self.max_len = max_token_seq_len or self.cfg.decoder_max_len
        self.buckets = _clip_buckets(buckets, self.cfg.encoder_max_len)
        self.search = _pick_search(self.cfg, use_cache)
        if nlm_model_dir:
            lm_params, lm_cfg, _ = load_nlm(nlm_model_dir, device=self.device)
            self.search = make_fused_search(lm_params, lm_cfg, lm_weight,
                                            quantize=quantize_weights)
            info("serving with shallow fusion: %s at weight %.2f",
                 nlm_model_dir, lm_weight)
        self.quantize_weights = quantize_weights
        if quantize_weights:
            before = tree_bytes(self.params)
            self.params, nq = quantize_tree(self.params)
            info("int8 weights: %d matmul tensors quantized, params "
                 "%.1f -> %.1f MB", nq, before / 1e6,
                 tree_bytes(self.params) / 1e6)
        self._stream_params = None
        self.lock = threading.Lock()

    def reload(self, model_file=None):
        """Hot checkpoint reload: new weights of the serving configuration,
        swapped between searches (never mid-search).  A checkpoint of
        another configuration raises ValueError and the old weights keep
        serving.  Returns the new checkpoint's meta."""
        path = model_file or self.model_file
        ck = load_checkpoint(path, device=self.device)
        if ck["cfg"] != self.cfg:
            raise ValueError(
                f"checkpoint config at {path!r} differs from the serving "
                f"config; restart the server for architecture changes")
        new_params = ck["params"]
        if self.quantize_weights:
            new_params, _ = quantize_tree(new_params)
        with self.lock:
            self.params = new_params
            self._stream_params = None  # re-derived for new sessions
            self.model_file = path
            self.model_meta = ck.get("meta", {})
        info("reloaded checkpoint %s (epoch %s, step %s)", path,
             self.model_meta.get("epoch"), self.model_meta.get("step"))
        return dict(self.model_meta)

    def warmup(self):
        """One search per bucket before serving (the kernels' first calls
        and the allocator's growth must not land on a request)."""
        for b in self.buckets:
            t0 = time.time()
            src = torch.zeros((1, b, self.cfg.src_dim), device=self.device)
            mask = torch.zeros((1, b), dtype=torch.uint8, device=self.device)
            mask[:, :2] = 1
            with self.lock:
                self._hyps(self._search(self.params, src, mask,
                                        self.beam_size), 1)
            info("warmed bucket %d in %.1fs", b, time.time() - t0)

    def warmup_batched(self, max_batch):
        """The (max_batch, bucket) shapes the MicroBatcher's searches take."""
        for b in self.buckets:
            t0 = time.time()
            self.recognize_many(
                [np.zeros((b, self.cfg.src_dim), np.float32)],
                batch_pad=max_batch)
            info("warmed batched bucket %d (batch %d) in %.1fs", b,
                 max_batch, time.time() - t0)

    def check_features(self, feats):
        return _check_features(feats, self.cfg.src_dim)

    @property
    def stream_params(self):
        """The float parameter tree of the streaming paths (dequantized once
        and cached when serving int8), read under the lock so a concurrent
        reload cannot leave a stale tree in the cache."""
        with self.lock:
            p = self._stream_params
            if p is None:
                p = (dequantize_tree(self.params) if self.quantize_weights
                     else self.params)
                self._stream_params = p
            return p

    def new_attention_stream(self, stream_chunk=40):
        """An :class:`~.attention_stream._AttentionStream` for incremental
        partials, or None when this model cannot stream exactly (a
        non-causal band or conv, a folded front end, the blstm)."""
        cfg = self.cfg
        if cfg.src_fold != 1:
            return None
        params = self.stream_params  # one generation for the whole session
        try:
            if cfg.encoder_type == "conformer":
                frontend = FixedChunkStream(
                    StreamingConformer(params["encoder"], cfg),
                    chunk=stream_chunk)
            elif cfg.encoder_type == "banded":
                frontend = FixedChunkStream(
                    StreamingBandedEncoder(params["encoder"], cfg),
                    chunk=stream_chunk)
            elif cfg.encoder_type in ("tdnn", "tdnnf"):
                frontend = StreamingTDNN(params, cfg, encode)
            else:
                return None
        except ValueError:
            return None  # non-causal band or conv
        return _AttentionStream(self, frontend, params)

    @torch.no_grad()
    def _search(self, params, src, mask, beam_size):
        """Encode a padded batch and beam-search it (the caller holds the
        lock)."""
        weights = dequantize_tree(params) if self.quantize_weights else params
        enc, mask_f = encode(weights, self.cfg, src, mask)
        return self.search(weights, self.cfg, enc, mask_f,
                           beam_size=beam_size, max_len=self.max_len)

    def _hyps(self, result, nbest):
        """[(text, score)] per utterance of a search result, best first."""
        outs = []
        for hyps in nbest_from_result(result, min(nbest, self.beam_size)):
            outs.append([(" ".join(ids_to_words(seq[1:-1], self.idx2word)),
                          float(score)) for seq, score in hyps])
        return outs

    def recognize_many(self, feats_list, nbest=1, batch_pad=None):
        """Decode several utterances in one batched search (the
        request-coalescing path); ``batch_pad`` fixes the batch dimension
        (default len(feats_list)), extra rows masked out.  Returns
        ([hyps per utterance], [frames decoded])."""
        feats_list = [self.check_features(f) for f in feats_list]
        src, mask, decoded = _padded_batch(
            feats_list, self.buckets, self.cfg.encoder_max_len,
            self.cfg.src_dim, batch_pad, self.device)
        with self.lock:
            result = self._search(self.params, src, mask, self.beam_size)
        return self._hyps(result, nbest)[:len(feats_list)], decoded

    def recognize(self, feats, nbest=1):
        """feats [T, D] → ([(text, score)] best first, frames decoded).
        Inputs longer than the largest bucket are cut to it (frames decoded
        < T tells the caller)."""
        outs, decoded = self.recognize_many([feats], nbest=nbest)
        return outs[0], decoded[0]
