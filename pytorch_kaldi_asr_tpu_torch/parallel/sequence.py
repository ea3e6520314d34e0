"""Sequence (context) parallelism for long-form audio (the JAX package's
``parallel/sequence.py``): the TIME axis split over the ranks of a
``("seq",)`` mesh.

Every op of the banded encoders is position-local except the attention
window, whose reach is bounded by the band (and the conformer's depthwise
conv, whose reach is ``(kernel-1)//2``), so each rank needs only a HALO of
its neighbours' frames: ``-start`` frames from the left shard and ``end``
from the right, moved with one ``ppermute`` per direction per layer
(parallel/collectives.py: broadcasts inside the two-rank groups), zeros at
the mesh's ends, as the single-device mask pads past the sequence edge.

- :func:`halo_exchange` pulls the halo frames of the neighbour shards;
- :func:`sp_banded_attention` is the banded self-attention block on a
  shard with halos: the queries left-padded by ``halo_l`` so the band
  indices line up over ``[halo_l | local | halo_r]`` keys, through the
  port's K1 (inference) or K2a-c (training) on the padded q, k, v, where
  the JAX package runs its blocked XLA op (the port's Deliberate
  difference 2, carried over);
- :func:`sp_banded_encode` / :func:`sp_conformer_encode` are the
  encoders' forwards on a shard (models/encoders.py semantics), with the
  sinusoids indexed by the GLOBAL frame and the dropout sites of the
  single-device encoders, each dropout through K3 on the card;
- :func:`sp_encode` dispatches by ``cfg.encoder_type``;
- :func:`sp_frame_ce_loss` is the hybrid AM's frame CE on a shard, its sums
  ``psum``'d over the mesh.

The functions take the GLOBAL ``[B, S, ...]`` arrays, which every rank
holds (the loader's batch), and return this rank's shard of the output
(``[B, S/n, ...]``, rank r holding frames ``[r S/n, (r+1) S/n)``).  The
whole construction is differentiable (``ppermute``'s backward is the
reverse shift): each rank's gradients are its share, and the step sums
them over the mesh.

Dropout: ``rngs`` is the step's ``DropoutRngs``; each shard draws an
independent stream from a generator seeded by (one draw of the step's
generator, the shard) (:func:`per_shard_rng`), as the JAX package folds
the shard into the key; masks apply to a shard's own frames before the
halos move, so neighbours read post-dropout activations as one device
would.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from pytorch_kaldi_asr_tpu_torch.models.common import (
    DropoutRngs,
    cast,
    layer_norm,
    linear,
    position_encoding_rows,
)
from pytorch_kaldi_asr_tpu_torch.models.encoders import _sigmoid, _swish
from pytorch_kaldi_asr_tpu_torch.models.transformer import (
    _drop,
    compute_dtype,
    feed_forward,
)
from pytorch_kaldi_asr_tpu_torch.ops.banded_attention import (
    banded_attention,
    banded_attention_trainable,
)
from pytorch_kaldi_asr_tpu_torch.parallel.collectives import ppermute, psum
from pytorch_kaldi_asr_tpu_torch.parallel.mesh import Mesh, _world_ranks


def fold_rng(base, *keys):
    """A dropout stream seeded from (``base``, ``keys``...), the port's
    ``jax.random.fold_in``."""
    mixed = int(np.random.SeedSequence([int(base), *map(int, keys)])
                .generate_state(1, np.uint64)[0] >> 1)
    return DropoutRngs(torch.Generator().manual_seed(mixed))


def draw_base(rngs):
    """One draw of the step's generator: the base of the streams folded
    from it (every rank draws the same)."""
    return int(torch.randint(0, 2**62, (), generator=rngs.seeds))


def per_shard_rng(rngs, shard):
    """An independent dropout stream for time shard ``shard``: a generator
    seeded from (one draw of the step's generator, the shard).  Every rank
    draws the same base, so the streams differ by shard only.  None passes
    through (no dropout)."""
    if rngs is None:
        return None
    return fold_rng(draw_base(rngs), shard)


def make_seq_mesh(seq=None, ranks=None):
    """A 1-axis ``("seq",)`` mesh over the first ``seq`` of ``ranks``
    (default: the world)."""
    ranks = _world_ranks(ranks)
    seq = seq or len(ranks)
    return Mesh(("seq",), (seq,), ranks[:seq], shifted=("seq",))


def halo_exchange(x, halo_l, halo_r, axis):
    """(left_halo, right_halo) of a [B, S_local, ...] shard: the last
    ``halo_l`` frames of the LEFT neighbour and the first ``halo_r`` frames
    of the RIGHT one (zeros at the mesh's ends).  None for a zero reach."""
    left = right = None
    if halo_l:
        left = ppermute(x[:, x.shape[1] - halo_l:], axis, 1)
    if halo_r:
        right = ppermute(x[:, :halo_r], axis, -1)
    return left, right


def _cat_with_halos(x, left, right):
    parts = [p for p in (left, x, right) if p is not None]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def _halo_mask(valid, halo_l, halo_r, axis):
    """The key validity over ``[halo_l | local | halo_r]`` (exchanged as
    float32: the mask carries no gradient)."""
    lv, rv = halo_exchange(valid.float(), halo_l, halo_r, axis)
    return _cat_with_halos(valid.float(), lv, rv).to(torch.int32)


def sp_banded_attention(p, x, valid, cfg, axis, *, rate=0.0, rngs=None,
                        train=False):
    """One banded self-attention block on a time shard (post-LN residual),
    the single-device ``_banded_self_attention``'s dtype contract (the
    conformer's MHSA too).  ``valid`` is the local [B, S_local] frame
    mask.  Training runs K2a-c with the attention dropout seeded from
    ``rngs``; inference runs K1."""
    start, end = cfg.encoder_sub_sequence
    halo_l, halo_r = max(0, -start), max(0, end)
    b, sl, d_model = x.shape
    h = p["w_qs"].shape[0]
    if halo_l > sl or halo_r > sl:
        raise ValueError(
            f"band reach ({halo_l}/{halo_r}) exceeds the local shard "
            f"length {sl}: the halo pulls only the immediate neighbor — "
            "use fewer sequence shards (or a narrower band)")

    lx, rx = halo_exchange(x, halo_l, halo_r, axis)
    xk = _cat_with_halos(x, lx, rx)  # [B, hl+Sl+hr, D]
    vk = _halo_mask(valid, halo_l, halo_r, axis)
    total = halo_l + sl + halo_r
    # left-pad the queries by halo_l: query row i of the padded sequence
    # then has key row i's global offset, and the aligned band is the
    # global band
    xq = F.pad(x, (0, 0, halo_l, halo_r))
    dtype = compute_dtype(cfg)
    wdt = dtype or p["w_qs"].dtype
    qs = torch.einsum("bld,hdk->bhlk", xq.to(wdt), cast(p["w_qs"], dtype))
    ks = torch.einsum("bld,hdk->bhlk", xk.to(wdt), cast(p["w_ks"], dtype))
    vs = torch.einsum("bld,hdv->bhlv", xk.to(wdt), cast(p["w_vs"], dtype))
    qs, ks, vs = (t.reshape(b * h, total, -1) for t in (qs, ks, vs))
    key_valid = torch.repeat_interleave(vk, h, dim=0)
    scale = 1.0 / float(d_model) ** 0.5
    if train:
        out = banded_attention_trainable(
            qs, ks, vs, key_valid, 0 if rngs is None else rngs.seed(),
            start=start, end=end, scale=scale,
            dropout_rate=0.0 if rngs is None else float(rate))
    else:
        out = banded_attention(qs, ks, vs, key_valid, start=start, end=end,
                               scale=scale)
    out = out.reshape(b, h, total, -1)[:, :, halo_l:halo_l + sl]
    out = out.transpose(1, 2).reshape(b, sl, -1)
    out = linear(out, p["proj"]["w"], p["proj"]["b"], dtype)
    out = _drop(out, rate, rngs, train)
    return layer_norm((out + x).to(x.dtype), p["ln"]["gamma"],
                      p["ln"]["beta"], skip_len1=cfg.ln_skip_len1)


def _positions(cfg, axis, sl, device):
    """The sinusoid rows of this shard's GLOBAL frames."""
    first = axis.index * sl if axis is not None else 0
    return position_encoding_rows(np.arange(first, first + sl),
                                  cfg.en_d_model, device=device)


def _sp_encode_local(params, cfg, src, mask, *, axis, train=False,
                     rngs=None):
    """Banded encoder forward on a shard (banded_encode semantics: src
    projection -> +positions (global index) -> [attention, FFN] stack ->
    +positions, with the same dropout sites when training)."""
    rate = cfg.en_dropout
    pos = _positions(cfg, axis, src.shape[1], src.device)
    dtype = compute_dtype(cfg)
    x = linear(src, params["src_proj"]["w"], None, dtype)
    x = (x if dtype is None else x.float()) + pos[None]
    x = _drop(x, rate, rngs, train)
    for layer in params["layers"]:
        x = sp_banded_attention(layer["slf"], x, mask, cfg, axis, rate=rate,
                                rngs=rngs, train=train)
        x = feed_forward(layer["ffn"], x, cfg, rate, rngs, train)
    x = x + pos[None]  # positions again after the stack
    return _drop(x, rate, rngs, train)


def _sp_conv_module(p, x, valid, cfg, axis, rate=0.0, rngs=None,
                    train=False):
    """The conformer's conv module on a time shard (models/encoders.py
    ``_conv_module``): everything is position-local but the depthwise
    conv, whose reach is exchanged as halos of the masked GLU output; a
    VALID conv over ``[pad_l | local | pad_r]`` gives the local frames
    (the boundary shards' zero halos are the single device's zero
    padding)."""
    dtype = compute_dtype(cfg)
    h = layer_norm(x, p["ln"]["gamma"], p["ln"]["beta"], skip_len1=False)
    h = linear(h, p["pw1"]["w"], p["pw1"]["b"], dtype)
    a, bgate = h.chunk(2, dim=-1)
    h = (a * _sigmoid(bgate)) * valid[..., None].to(h.dtype)  # GLU, mask
    kernel = cast(p["dw"]["w"], dtype)  # [K, D]
    k, d = kernel.shape
    pad_l = k - 1 if cfg.conformer_causal_conv else (k - 1) // 2
    pad_r = k - 1 - pad_l
    if pad_l > h.shape[1] or pad_r > h.shape[1]:
        raise ValueError(
            f"conv kernel reach ({pad_l}/{pad_r}) exceeds the local shard "
            f"length {h.shape[1]}: the halo pulls only the immediate "
            "neighbor — use fewer sequence shards (or a smaller kernel)")
    lh, rh = halo_exchange(h, pad_l, pad_r, axis)
    hk = _cat_with_halos(h, lh, rh)
    h = F.conv1d(hk.transpose(1, 2), kernel.t()[:, None, :],
                 groups=d).transpose(1, 2)
    h = layer_norm((h + cast(p["dw"]["b"], dtype)).to(x.dtype),
                   p["norm"]["gamma"], p["norm"]["beta"], skip_len1=False)
    h = linear(_swish(h), p["pw2"]["w"], p["pw2"]["b"], dtype)
    return x + _drop(h.to(x.dtype), rate, rngs, train)


def _sp_conformer_local(params, cfg, src, mask, *, axis, train=False,
                        rngs=None):
    """Conformer forward on a shard (conformer_encode semantics)."""
    from pytorch_kaldi_asr_tpu_torch.models.encoders import _half_ffn

    rate = cfg.en_dropout
    pos = _positions(cfg, axis, src.shape[1], src.device)
    stream = getattr(torch, cfg.conformer_stream_dtype)
    x = linear(src, params["src_proj"]["w"], None, compute_dtype(cfg))
    x = x.to(stream) + pos[None].to(stream)
    x = _drop(x, rate, rngs, train)
    for layer in params["layers"]:
        x = _half_ffn(layer["ffn1"], x, cfg, rate, rngs, train)
        x = sp_banded_attention(layer["mhsa"], x, mask, cfg, axis,
                                rate=rate, rngs=rngs, train=train)
        x = _sp_conv_module(layer["conv"], x, mask, cfg, axis, rate, rngs,
                            train)
        x = _half_ffn(layer["ffn2"], x, cfg, rate, rngs, train)
    return x


def seq_shard(mesh, *arrays, seq_axis="seq"):
    """This rank's time shard of each [B, S, ...] array (S divisible by
    the axis size, else the JAX package's error)."""
    n = mesh.size(seq_axis)
    i = mesh.index(seq_axis)
    out = []
    for a in arrays:
        if a.shape[1] % n != 0:
            raise ValueError(
                f"sequence length {a.shape[1]} not divisible by the "
                f"'{seq_axis}' mesh axis ({n}); pad with mask=0 frames")
        sl = a.shape[1] // n
        out.append(a[:, i * sl:(i + 1) * sl])
    return tuple(out)


def _sp_shard(local, params, cfg, mesh, seq_axis, src, mask, train, rngs):
    src_l, mask_l = seq_shard(mesh, src, mask, seq_axis=seq_axis)
    axis = mesh.axis(seq_axis)
    return local(params, cfg, src_l, mask_l, axis=axis, train=train,
                 rngs=per_shard_rng(rngs if train else None, axis.index))


def sp_banded_encode(params, cfg, src, mask, mesh, *, seq_axis="seq",
                     train=False, rngs=None):
    """Banded encoder forward with the TIME axis split over ``mesh``:
    ``src`` [B, S, D] and ``mask`` [B, S] global (S divisible by the
    ``seq_axis`` size); returns this rank's [B, S/n, d_model] shard of the
    output.  ``train=True`` runs K2a-c (differentiable), with dropout from
    a per-shard stream of ``rngs``."""
    return _sp_shard(_sp_encode_local, params, cfg, mesh, seq_axis, src,
                     mask, train, rngs)


def sp_conformer_encode(params, cfg, src, mask, mesh, *, seq_axis="seq",
                        train=False, rngs=None):
    """Conformer encoder forward with the TIME axis split: the attention
    band's halo and the depthwise conv's per layer, both bounded, so the
    collectives stay neighbour-only."""
    return _sp_shard(_sp_conformer_local, params, cfg, mesh, seq_axis, src,
                     mask, train, rngs)


SP_ENCODERS = {
    "banded": sp_banded_encode,
    "conformer": sp_conformer_encode,
}


def sp_encode(params, cfg, src, mask, mesh, *, seq_axis="seq", train=False,
              rngs=None):
    """Sequence-parallel encoder forward dispatched by cfg.encoder_type
    (banded and conformer; the FIR-style tdnn/tdnnf encoders stream
    instead, models/streaming.py)."""
    try:
        fn = SP_ENCODERS[cfg.encoder_type]
    except KeyError:
        raise ValueError(
            f"encoder_type {cfg.encoder_type!r} has no sequence-parallel "
            f"forward (available: {sorted(SP_ENCODERS)})") from None
    return fn(params, cfg, src, mask, mesh, seq_axis=seq_axis, train=train,
              rngs=rngs)


def sp_frame_ce_loss(params, cfg, src, src_mask, targets, mesh, *,
                     seq_axis="seq", train=False, rngs=None, utt_valid=None):
    """Sequence-parallel frame CE (models/am.py ``frame_ce_loss``
    semantics) for long-form hybrid AM training: the encoder on the
    time shards (:func:`sp_encode`), the posterior head, log-softmax and
    per-frame CE on each shard, and the three sums ``psum``'d over the
    mesh, so every rank returns the GLOBAL (loss_sum, n_correct, n_frames)
    and the caller divides by the global frame count.  Requires
    cfg.src_fold == 1 (time-split targets must stay frame-aligned)."""
    if cfg.src_fold != 1:
        raise ValueError(
            "sp_frame_ce_loss requires src_fold == 1: folding re-times the "
            "encoder output, so per-frame targets would no longer align "
            "with the time shards")
    from pytorch_kaldi_asr_tpu_torch.models import am

    enc = sp_encode(params["encoder"], cfg, src, src_mask, mesh,
                    seq_axis=seq_axis, train=train, rngs=rngs)
    mask_l, tgt_l = seq_shard(mesh, src_mask, targets, seq_axis=seq_axis)
    logp = am.head_log_posteriors(params, cfg, enc)
    valid = mask_l.float()
    if utt_valid is not None:
        valid = valid * utt_valid.float()[:, None]
    tgt_l = tgt_l.long()
    nll = -torch.take_along_dim(logp, tgt_l[..., None], dim=-1)[..., 0]
    axis = mesh.axis(seq_axis)
    loss = psum((nll * valid).sum(), axis)
    n_correct = psum(((logp.argmax(dim=-1) == tgt_l).float() * valid).sum(),
                     axis)
    return loss, n_correct.detach(), psum(valid.sum(), axis).detach()
