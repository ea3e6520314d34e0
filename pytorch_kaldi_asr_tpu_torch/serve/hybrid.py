"""The hybrid-mode recognizer (the port's ``HybridRecognizer`` and
``_HybridStream`` of ``pytorch_kaldi_asr_tpu.recipes.serve``): a trained
acoustic model (recipes/train_am.py) and a decode graph (recipes/mkgraph.py).

``/recognize`` runs the AM forward per length bucket on the device (K1 in
every attention layer of a ``banded`` or ``conformer`` AM on the card),
then the graph searches on the host, in the native C++ core: ``latgen``
for the 1-best, ``latgen_lattice`` and ``lattice_ops.nbest`` for an n-best,
over a thread pool (ctypes releases the GIL) and outside the device lock.
Streaming sessions are true streaming: chunked AM posteriors
(models/streaming.py) feed the carried-token graph decoder
(decode/latgen.make_streaming_latgen), so every push returns a partial.
Clients may push any chunk sizes: the conformer and banded frontends
re-chunk to ``stream_chunk`` frames (FixedChunkStream) and pad the ragged
tail at the end, exact since band and conv are causal.  Scores are the
negated graph costs, higher is better, as in the attention mode.
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from pytorch_kaldi_asr_tpu_torch.decode.latgen import (
    latgen,
    latgen_lattice,
    make_streaming_latgen,
)
from pytorch_kaldi_asr_tpu_torch.decode.lattice_ops import nbest as nbest_op
from pytorch_kaldi_asr_tpu_torch.fst.openfst_io import read_fst
from pytorch_kaldi_asr_tpu_torch.models.am import am_log_posteriors
from pytorch_kaldi_asr_tpu_torch.models.streaming import (
    FixedChunkStream,
    StreamingAM,
    StreamingTDNN,
)
from pytorch_kaldi_asr_tpu_torch.ops.quant import (
    dequantize_tree,
    quantize_tree,
    tree_bytes,
)
from pytorch_kaldi_asr_tpu_torch.recipes.mkgraph import read_symbol_table
from pytorch_kaldi_asr_tpu_torch.serve.recognizer import (
    DEFAULT_BUCKETS,
    _check_features,
    _clip_buckets,
    _padded_batch,
)
from pytorch_kaldi_asr_tpu_torch.train.checkpoint import (
    load_checkpoint,
    read_checkpoint_config,
)
from pytorch_kaldi_asr_tpu_torch.utils.device import resolve_device
from pytorch_kaldi_asr_tpu_torch.utils.logging import info


class HybridRecognizer:
    def __init__(self, model_file, graph_dir, *, beam=16.0, max_active=2000,
                 priors_file=None, acoustic_scale=1.0,
                 buckets=DEFAULT_BUCKETS, quantize_weights=False,
                 decode_workers=None, stream_chunk=40, device="cuda"):
        self.device = resolve_device(str(device))
        ck = load_checkpoint(model_file, device=self.device)
        self.params, self.cfg = ck["params"], ck["cfg"]
        self.model_file = model_file
        self.model_meta = dict(ck["meta"])
        self.graph = read_fst(os.path.join(graph_dir, "HLG.fst"))
        word_syms = read_symbol_table(os.path.join(graph_dir, "words.txt"))
        self.id2word = {v: k for k, v in word_syms.items()}
        self.beam = beam
        self.max_active = max_active
        self.acoustic_scale = acoustic_scale
        # .npy log-priors, subtracted from the log-posteriors
        self.log_priors = np.load(priors_file) if priors_file else None
        self.buckets = _clip_buckets(buckets, self.cfg.encoder_max_len)
        self.lock = threading.Lock()  # the device's work, one at a time
        self.decode_workers = decode_workers or min(8, os.cpu_count() or 1)
        self.stream_chunk = int(stream_chunk)
        # made here: made lazily by concurrent batches, two pools could race
        self._decode_pool = (
            ThreadPoolExecutor(max_workers=self.decode_workers,
                               thread_name_prefix="graph-decode")
            if self.decode_workers > 1 else None)
        self._search_lock = threading.Lock()
        self.graph_searches = 0
        self.graph_search_ms_total = 0.0
        self.quantize_weights = quantize_weights
        if quantize_weights:
            before = tree_bytes(self.params)
            self.params, nq = quantize_tree(self.params)
            info("hybrid: int8 weights, %d tensors quantized, params "
                 "%.1f -> %.1f MB", nq, before / 1e6,
                 tree_bytes(self.params) / 1e6)

    @torch.no_grad()
    def _fwd(self, params, src, mask):
        weights = dequantize_tree(params) if self.quantize_weights else params
        logp, _ = am_log_posteriors(weights, self.cfg, src, mask)
        return logp

    def warmup(self):
        """One AM forward per bucket.  The graph search is host Python with
        nothing to warm: decoding zeros at full length would cost minutes
        of CPU for nothing."""
        for b in self.buckets:
            t0 = time.time()
            src = torch.zeros((1, b, self.cfg.src_dim), device=self.device)
            mask = torch.zeros((1, b), dtype=torch.uint8, device=self.device)
            mask[0, :2] = 1
            with self.lock:
                self._fwd(self.params, src, mask).cpu()
            info("hybrid: warmed AM bucket %d in %.1fs", b, time.time() - t0)

    def warmup_batched(self, max_batch):
        """The (max_batch, bucket) AM forwards only (see :meth:`warmup`)."""
        for b in self.buckets:
            t0 = time.time()
            self._posteriors_many(
                [np.zeros((b, self.cfg.src_dim), np.float32)],
                batch_pad=max_batch)
            info("hybrid: warmed AM bucket %d (batch %d) in %.1fs", b,
                 max_batch, time.time() - t0)

    def reload(self, model_file=None):
        """Hot AM reload (Recognizer.reload's contract: the configuration
        and the target count must be the serving ones)."""
        path = model_file or self.model_file
        cfg, meta = read_checkpoint_config(path)
        if cfg != self.cfg or (meta.get("n_targets")
                               != self.model_meta.get("n_targets")):
            raise ValueError(
                f"checkpoint config at {path!r} differs from the serving "
                f"config; restart the server for architecture changes")
        new_params = load_checkpoint(path, device=self.device)["params"]
        if self.quantize_weights:
            new_params, _ = quantize_tree(new_params)
        with self.lock:
            self.params = new_params
            self.model_file = path
            self.model_meta = dict(meta)
        info("hybrid: reloaded checkpoint %s (epoch %s, step %s)", path,
             meta.get("epoch"), meta.get("step"))
        return dict(meta)

    def check_features(self, feats):
        return _check_features(feats, self.cfg.src_dim)

    def _posteriors_many(self, feats_list, batch_pad=None):
        """One bucketed AM forward over several utterances (padded rows
        masked out).  Returns ([float64 log-posteriors per utterance, minus
        the log-priors], [frames])."""
        src, mask, lens = _padded_batch(
            feats_list, self.buckets, self.cfg.encoder_max_len,
            self.cfg.src_dim, batch_pad, self.device)
        with self.lock:
            logp = self._fwd(self.params, src, mask).cpu().numpy()
        outs = []
        for i, t in enumerate(lens):
            out = logp[i, :t].astype(np.float64)
            if self.log_priors is not None:
                out = out - self.log_priors
            outs.append(out)
        return outs, lens

    def _graph_decode(self, posts, nbest):
        """The host graph search of one utterance's posteriors."""
        if nbest > 1:
            lat = latgen_lattice(self.graph, posts, beam=self.beam,
                                 acoustic_scale=self.acoustic_scale,
                                 max_active=self.max_active,
                                 id2word=self.id2word)
            if lat is None:
                return []
            return [(" ".join(w), -c) for w, c in nbest_op(lat, nbest)]
        res = latgen(self.graph, posts, beam=self.beam,
                     acoustic_scale=self.acoustic_scale,
                     max_active=self.max_active)
        if res is None:
            return []
        words, _phones, cost = res
        text = " ".join(self.id2word.get(w, "<unk>") for w in words)
        return [(text, -float(cost))]

    def _timed_decode(self, posts, nbest):
        t0 = time.time()
        out = self._graph_decode(posts, nbest)
        ms = (time.time() - t0) * 1e3
        with self._search_lock:
            self.graph_searches += 1
            self.graph_search_ms_total += ms
        return out

    def recognize_many(self, feats_list, nbest=1, batch_pad=None):
        """Batched recognition (the MicroBatcher's contract): one AM
        forward for the group, then the graph searches over the host pool,
        outside the device lock."""
        feats_list = [self.check_features(f) for f in feats_list]
        posts_list, lens = self._posteriors_many(feats_list,
                                                 batch_pad=batch_pad)
        if self._decode_pool is not None and len(posts_list) > 1:
            outs = list(self._decode_pool.map(
                lambda p: self._timed_decode(p, nbest), posts_list))
        else:
            outs = [self._timed_decode(p, nbest) for p in posts_list]
        return outs, lens

    def recognize(self, feats, nbest=1):
        """([(text, score)], frames decoded); score = the negated graph
        cost, so higher is better on every endpoint."""
        outs, lens = self.recognize_many([feats], nbest=nbest)
        return outs[0], lens[0]

    def new_stream(self):
        # dequantized once per stream, not per chunk
        params = (dequantize_tree(self.params) if self.quantize_weights
                  else self.params)
        if self.cfg.encoder_type in ("conformer", "banded"):
            frontend = FixedChunkStream(StreamingAM(params, self.cfg),
                                        chunk=self.stream_chunk)
        else:
            frontend = StreamingTDNN(params, self.cfg, am_log_posteriors)
        decoder = make_streaming_latgen(
            self.graph, beam=self.beam, acoustic_scale=self.acoustic_scale,
            max_active=self.max_active, log_priors=self.log_priors)
        return _HybridStream(frontend, decoder, self.id2word, self.lock)


class _HybridStream:
    """A session's state: the chunked AM frontend and the carried-token
    decoder.  Its own lock orders pipelined pushes of one session; the
    recognizer's device lock is held only around the AM push."""

    def __init__(self, frontend, decoder, id2word, device_lock):
        self.frontend = frontend
        self.decoder = decoder
        self.id2word = id2word
        self.device_lock = device_lock
        self.lock = threading.Lock()
        self.frames = 0

    def _words(self, ids):
        return " ".join(self.id2word.get(w, "<unk>") for w in ids)

    def push(self, feats):
        """Feed [T, D] frames; returns (total frames, partial text)."""
        with self.lock:
            self.frames += feats.shape[0]
            with self.device_lock:
                emit = self.frontend.push(feats[None])
                emit = None if emit is None else emit[0].cpu().numpy()
            if emit is not None:
                self.decoder.push(emit)
            p = self.decoder.partial()
            return self.frames, (self._words(p[0]) if p else "")

    def finish(self):
        """(text, score = -cost) of the final hypothesis, or None if the
        beam died."""
        with self.lock:
            with self.device_lock:
                tail = self.frontend.flush()
                tail = None if tail is None else tail[0].cpu().numpy()
            if tail is not None:
                self.decoder.push(tail)
            res = self.decoder.finish()
        if res is None:
            return None
        words, _phones, cost = res
        return self._words(words), -float(cost)
