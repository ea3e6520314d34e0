"""Streaming chunked inference with carried state (the port's
``pytorch_kaldi_asr_tpu.models.streaming``): encoder outputs chunk by
chunk, with bounded latency, equal to the offline encoder's.

- ``banded`` and ``conformer`` encoders with a causal band (end == 0; the
  conformer also with ``conformer_causal_conv``): each layer carries the
  last ``-start`` frames of its attention input (keys and values are
  recomputed from them) and, in the conformer, the last ``kernel - 1``
  post-GLU frames of its depthwise conv, so chunked outputs equal the
  offline encoder's with no algorithmic latency.  Position rows are the
  closed-form sinusoids at the global frame index.
- ``tdnn``/``tdnnf`` encoders: a finite FIR stack, so re-running the last
  ``left_rf`` frames with ``right_rf`` frames of lookahead reproduces the
  offline outputs, with a latency of ``right_rf`` frames.

The chunk attention is a product over [cache | chunk] keys with a band
mask, as the JAX package computes it (outside any Pallas kernel): the
offline encoder's K1 is not on this path.  The caches and the outputs are
tensors on the parameters' device; ``push`` takes a numpy array or a
tensor [B, T, D] and returns a tensor on that device, or None.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from pytorch_kaldi_asr_tpu_torch.models.common import (
    cast,
    layer_norm,
    linear,
    masked_softmax,
    position_encoding_rows,
)
from pytorch_kaldi_asr_tpu_torch.models.encoders import (
    _half_ffn,
    _sigmoid,
    _swish,
)
from pytorch_kaldi_asr_tpu_torch.models.transformer import (
    compute_dtype,
    feed_forward,
    logit_divisor,
    multi_head_attention,
)


def receptive_field(cfg):
    """(left, right) context frames the tdnn/tdnnf encoders need per output
    frame (every tdnn context, plus the lda splice for the flagship tdnn
    encoder only — the tdnnf encoder has no lda splice)."""
    if cfg.encoder_type == "tdnn":
        left = -min(min(cfg.lda_context), 0)
        right = max(max(cfg.lda_context), 0)
    else:
        left = right = 0
    for ctx in cfg.tdnn_contexts:
        left += -min(min(ctx), 0)
        right += max(max(ctx), 0)
    return left, right


def _device_of(tree):
    """The device of the first tensor leaf of a parameter tree."""
    while isinstance(tree, (dict, list, tuple)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return tree.device


def _as_frames(chunk, device):
    """A [B, T, D] numpy array or tensor as float32 on ``device``."""
    return torch.as_tensor(chunk, dtype=torch.float32, device=device)


def _chunk_blocked(t, n_cache, window, device):
    """[T, n_cache + T] True where query i (global n_cache + i) may not
    attend key j: outside ``0 <= (i + n_cache) - j <= window``."""
    rel = (torch.arange(n_cache + t, device=device)[None, :]
           - (torch.arange(t, device=device)[:, None] + n_cache))
    return ~((rel >= -window) & (rel <= 0))


class StreamingTDNN:
    """Chunked driver for the tdnn/tdnnf encoders by overlap recompute.

    Each push runs at most one forward over the carried buffer, never
    padded (the TDNN's symmetric context would leak pad frames into the
    last real frames); the emission is quantized instead: a forward runs
    when at least :data:`QUANT` frames are ready, over ``hist + k*QUANT +
    right_rf`` real frames.  ``apply_fn(params, cfg, buf, mask,
    pos_offset=...)`` returns (outputs, mask): ``transformer.encode`` or
    ``am.am_log_posteriors``."""

    QUANT = 32  # emit granularity

    def __init__(self, params, cfg, apply_fn):
        if cfg.encoder_type not in ("tdnn", "tdnnf"):
            raise ValueError("StreamingTDNN serves tdnn/tdnnf encoders")
        self.params = params
        self.cfg = cfg
        self.apply = apply_fn
        self.device = _device_of(params)
        self.left_rf, self.right_rf = receptive_field(cfg)
        # buffer = [hist (<= left_rf frames already emitted) | pending]
        self.reset()

    def reset(self):
        self._buf = None
        self._hist_len = 0
        self._global0 = 0  # global frame index of buf[:, 0]

    @torch.no_grad()
    def _emit(self, n_emit, win_len):
        """Forward over the first ``win_len`` buffer frames, emit
        ``n_emit`` frames from the first un-emitted one, advance the
        buffer."""
        p0 = self._hist_len
        buf = self._buf[:, :win_len]
        mask = torch.ones(buf.shape[:2], dtype=torch.uint8,
                          device=self.device)
        out, _ = self.apply(self.params, self.cfg, buf, mask,
                            pos_offset=self._global0)
        emit = out[:, p0:p0 + n_emit]
        new_first_pending = p0 + n_emit
        drop = max(0, new_first_pending - self.left_rf)
        self._buf = self._buf[:, drop:]
        self._hist_len = new_first_pending - drop
        self._global0 += drop
        return emit

    def push(self, chunk):
        """Feed [B, T, D] frames; returns the outputs of the ready frames in
        QUANT multiples (a frame is ready when its whole receptive field is
        there), or None."""
        chunk = _as_frames(chunk, self.device)
        self._buf = (chunk if self._buf is None
                     else torch.cat([self._buf, chunk], dim=1))
        n_ready = self._buf.shape[1] - self._hist_len - self.right_rf
        k = n_ready // self.QUANT
        if k <= 0:
            return None
        n_emit = k * self.QUANT
        return self._emit(n_emit, self._hist_len + n_emit + self.right_rf)

    def flush(self):
        """End of stream: every remaining frame (the last right_rf frames
        see zero right context, as the offline encoder sees past the
        utterance's end)."""
        if self._buf is None or self._buf.shape[1] <= self._hist_len:
            return None
        emit = self._emit(self._buf.shape[1] - self._hist_len,
                          self._buf.shape[1])
        self.reset()
        return emit


def _conformer_mhsa_chunk(p, x, keys, n_cache, cfg, window):
    """The chunk's MHSA against cached + current keys: post-LN, logits
    divided by sqrt(d_model), the residual sum rounded once to the
    stream's dtype (JAX's ``_conformer_mhsa_chunk``)."""
    dtype = compute_dtype(cfg)
    dt = dtype or p["w_qs"].dtype
    b, t, d_model = x.shape
    qs = torch.einsum("bld,hdk->bhlk", x.to(dt), cast(p["w_qs"], dtype))
    ks = torch.einsum("bld,hdk->bhlk", keys.to(dt), cast(p["w_ks"], dtype))
    vs = torch.einsum("bld,hdv->bhlv", keys.to(dt), cast(p["w_vs"], dtype))
    logits = torch.einsum("bhqk,bhlk->bhql", qs, ks) / logit_divisor(
        d_model, dtype)
    blocked = _chunk_blocked(t, n_cache, window, x.device)
    attn = masked_softmax(logits.float(), blocked[None, None]).to(dt)
    out = torch.einsum("bhql,bhlv->bhqv", attn, vs)
    out = out.transpose(1, 2).reshape(b, t, -1)
    out = linear(out, p["proj"]["w"], p["proj"]["b"], dtype)
    return layer_norm((out + x).to(x.dtype), p["ln"]["gamma"],
                      p["ln"]["beta"], skip_len1=False)


def _conformer_conv_chunk(p, x, conv_cache, cfg):
    """The causal conv module over [cached post-GLU frames | chunk] (the
    cache is the causal conv's left padding).  Returns (outputs, new
    cache)."""
    dtype = compute_dtype(cfg)
    h = layer_norm(x, p["ln"]["gamma"], p["ln"]["beta"], skip_len1=False)
    h = linear(h, p["pw1"]["w"], p["pw1"]["b"], dtype)
    a, g = h.chunk(2, dim=-1)
    h = a * _sigmoid(g)  # GLU
    kernel = cast(p["dw"]["w"], dtype)  # [K, D]
    k, d = kernel.shape
    conv_in = torch.cat([conv_cache.to(h.dtype), h], dim=1)
    new_cache = conv_in[:, conv_in.shape[1] - (k - 1):]
    y = F.conv1d(conv_in.transpose(1, 2), kernel.t()[:, None, :],
                 groups=d).transpose(1, 2)
    y = layer_norm((y + cast(p["dw"]["b"], dtype)).to(x.dtype),
                   p["norm"]["gamma"], p["norm"]["beta"], skip_len1=False)
    y = linear(_swish(y), p["pw2"]["w"], p["pw2"]["b"], dtype)
    return x + y.to(x.dtype), new_cache


def _conformer_push(params, cfg, window, chunk, pos, attn_caches,
                    conv_caches):
    """One push through src_proj, positions and every layer (half-FFN,
    cached MHSA, cached causal conv, half-FFN).  Returns (outputs, new
    attention caches, new conv caches)."""
    stream = getattr(torch, cfg.conformer_stream_dtype)
    x = linear(chunk, params["src_proj"]["w"], None, compute_dtype(cfg))
    x = x.to(stream) + pos[None].to(stream)
    new_attn, new_conv = [], []
    for li, layer in enumerate(params["layers"]):
        x = _half_ffn(layer["ffn1"], x, cfg, 0.0, None, False)
        cache = attn_caches[li]
        keys = torch.cat([cache.to(x.dtype), x], dim=1)
        new_attn.append(keys[:, -window:] if window else keys[:, :0])
        x = _conformer_mhsa_chunk(layer["mhsa"], x, keys, cache.shape[1],
                                  cfg, window)
        x, nc = _conformer_conv_chunk(layer["conv"], x, conv_caches[li], cfg)
        new_conv.append(nc)
        x = _half_ffn(layer["ffn2"], x, cfg, 0.0, None, False)
    return x, new_attn, new_conv


def _causal_window(cfg):
    start, end = cfg.encoder_sub_sequence
    if end != 0:
        raise ValueError("streaming needs a causal band (end == 0)")
    return -start


class StreamingConformer:
    """Exact chunked inference for the conformer encoder.  Needs a causal
    band (``encoder_sub_sequence`` end == 0) and a causal depthwise conv
    (``conformer_causal_conv``); both are checked.  Carries per layer the
    last ``-start`` MHSA inputs and the last ``kernel - 1`` post-GLU frames
    (zeros at first: the causal conv's left padding)."""

    def __init__(self, params, cfg):
        if cfg.encoder_type != "conformer":
            raise ValueError("StreamingConformer serves the conformer "
                             "encoder")
        window = _causal_window(cfg)
        if not cfg.conformer_causal_conv:
            raise ValueError(
                "streaming needs conformer_causal_conv=True (a centered "
                "depthwise conv reads future frames)")
        self.params = params
        # layer norm applies even to one-frame chunks, as offline it does
        # at every position of the utterance
        self.cfg = cfg.replace(ln_skip_len1=False)
        self.window = window
        self.device = _device_of(params)
        self.reset()

    def reset(self):
        self._attn_caches = None  # per layer [B, <=window, D] MHSA inputs
        self._conv_caches = None  # per layer [B, k-1, D] post-GLU frames
        self._offset = 0

    @torch.no_grad()
    def push(self, chunk):
        """Feed [B, T, D] frames; returns [B, T, en_d_model] outputs (no
        latency: band and conv are causal)."""
        cfg = self.cfg
        chunk = _as_frames(chunk, self.device)
        b, t, _ = chunk.shape
        if self._attn_caches is None:
            stream = getattr(torch, cfg.conformer_stream_dtype)
            dt = compute_dtype(cfg) or torch.float32
            layers = self.params["layers"]
            self._attn_caches = [
                torch.zeros((b, 0, cfg.en_d_model), dtype=stream,
                            device=self.device) for _ in layers]
            self._conv_caches = [
                torch.zeros((b, lay["conv"]["dw"]["w"].shape[0] - 1,
                             lay["conv"]["pw1"]["w"].shape[1] // 2),
                            dtype=dt, device=self.device)
                for lay in layers]
        pos = position_encoding_rows(self._offset + np.arange(t),
                                     cfg.en_d_model, self.device)
        out, self._attn_caches, self._conv_caches = _conformer_push(
            self.params, cfg, self.window, chunk, pos, self._attn_caches,
            self._conv_caches)
        self._offset += t
        return out

    def flush(self):
        """Causal model: nothing is pending at the end of the stream."""
        return None


class StreamingBandedEncoder:
    """Exact chunked inference for the banded self-attention encoder, with
    per-layer caches of the last ``-start`` layer inputs (the band must be
    causal: end == 0)."""

    def __init__(self, params, cfg):
        if cfg.encoder_type != "banded":
            raise ValueError("serves the 'banded' encoder")
        self.window = _causal_window(cfg)
        self.params = params
        # layer norm applies even to one-frame chunks (see
        # StreamingConformer)
        self.cfg = cfg.replace(ln_skip_len1=False)
        self.device = _device_of(params)
        self.reset()

    def reset(self):
        self._caches = None  # per layer: [B, <=window, D] of layer INPUT
        self._offset = 0

    @torch.no_grad()
    def push(self, chunk):
        """Feed [B, T, D] frames; returns [B, T, en_d_model] outputs (no
        latency: the band is causal)."""
        cfg, window = self.cfg, self.window
        chunk = _as_frames(chunk, self.device)
        b, t, _ = chunk.shape
        if self._caches is None:
            self._caches = [torch.zeros((b, 0, cfg.en_d_model),
                                        device=self.device)
                            for _ in self.params["layers"]]
        pos = position_encoding_rows(self._offset + np.arange(t),
                                     cfg.en_d_model, self.device)
        x = linear(chunk, self.params["src_proj"]["w"], None,
                   compute_dtype(cfg))
        x = x.float() + pos[None]
        new_caches = []
        for cache, layer in zip(self._caches, self.params["layers"]):
            keys = torch.cat([cache, x], dim=1)
            blocked = _chunk_blocked(t, cache.shape[1], window, self.device)
            new_caches.append(keys[:, -window:] if window else keys[:, :0])
            x = multi_head_attention(layer["slf"], x, keys, keys,
                                     blocked[None].expand(b, -1, -1), cfg)
            x = feed_forward(layer["ffn"], x, cfg)
        self._caches = new_caches
        self._offset += t
        return x + pos[None]

    def flush(self):
        """Causal band: nothing is pending at the end of the stream."""
        return None


class StreamingAM:
    """Chunked AM log-posteriors from a streaming encoder (conformer or
    banded): the AM's output head on each emitted encoder chunk, minus the
    log-priors when given.  The push/flush contract of StreamingTDNN with
    ``am_log_posteriors``."""

    def __init__(self, params, cfg, *, log_priors=None):
        if cfg.encoder_type == "conformer":
            self.encoder = StreamingConformer(params["encoder"], cfg)
        elif cfg.encoder_type == "banded":
            self.encoder = StreamingBandedEncoder(params["encoder"], cfg)
        else:
            raise ValueError(
                f"StreamingAM serves conformer/banded encoders, not "
                f"{cfg.encoder_type!r} (use StreamingTDNN)")
        self.params = params
        self.cfg = cfg
        self.log_priors = (None if log_priors is None else torch.as_tensor(
            np.asarray(log_priors), dtype=torch.float32).to(
                self.encoder.device))

    def reset(self):
        self.encoder.reset()

    @torch.no_grad()
    def _head(self, enc):
        from pytorch_kaldi_asr_tpu_torch.models.am import head_log_posteriors

        return head_log_posteriors(self.params, self.cfg, enc,
                                   log_priors=self.log_priors)

    def push(self, chunk):
        enc = self.encoder.push(chunk)
        return None if enc is None else self._head(enc)

    def flush(self):
        enc = self.encoder.flush()
        out = None if enc is None else self._head(enc)
        self.encoder.reset()
        return out


class FixedChunkStream:
    """Fixed-size pushes whatever the client sends: incoming frames are
    buffered and forwarded ``chunk`` frames at a time, so a server's
    streaming frontends see one push shape.  The ragged tail goes out at
    :meth:`flush`, padded to ``chunk`` frames with the padded outputs
    sliced off: exact for the causal frontends (:class:`StreamingAM`,
    :class:`StreamingConformer`, :class:`StreamingBandedEncoder`), whose
    padding lies in every valid frame's future; the stream then resets."""

    def __init__(self, inner, chunk=40):
        if int(chunk) <= 0:
            raise ValueError(f"chunk must be positive, got {chunk}")
        self.inner = inner
        self.chunk = int(chunk)
        self._buf = None  # [B, < chunk, D] carried remainder

    @property
    def device(self):
        inner = getattr(self.inner, "encoder", self.inner)
        return inner.device

    def reset(self):
        self._buf = None
        self.inner.reset()

    def push(self, feats):
        feats = _as_frames(feats, self.device)
        buf = feats if self._buf is None else torch.cat([self._buf, feats],
                                                        dim=1)
        outs, lo, t = [], 0, buf.shape[1]
        while t - lo >= self.chunk:
            out = self.inner.push(buf[:, lo:lo + self.chunk])
            lo += self.chunk
            if out is not None:
                outs.append(out)
        self._buf = buf[:, lo:] if lo < t else None
        return torch.cat(outs, dim=1) if outs else None

    def flush(self):
        outs = []
        if self._buf is not None and self._buf.shape[1]:
            t_valid = self._buf.shape[1]
            padded = F.pad(self._buf, (0, 0, 0, self.chunk - t_valid))
            out = self.inner.push(padded)
            if out is not None:
                outs.append(out[:, :t_valid])
            self._buf = None
        tail = self.inner.flush()
        if tail is not None:
            outs.append(tail)
        return torch.cat(outs, dim=1) if outs else None
