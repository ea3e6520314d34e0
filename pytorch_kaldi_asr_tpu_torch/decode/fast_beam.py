"""KV-cached incremental beam search.

Each step computes exactly one new position for every lane:

- cross-attention K/V are projected once per utterance from the encoder
  output;
- the banded decoder self-attention window ``[t+start, t]`` is a rolling
  per-layer cache of the last ``-start`` positions' K/V, reordered by beam
  parent at every step;
- the reference's layer-norm length-1 quirk is honored at step 0 only, and
  only for that step's logits: the cached K/V come from a pass with layer
  norm, as later full-prefix recomputation in the reference would derive
  them.

The JAX package's ``jax.lax.scan`` over steps is a Python loop here, which
stops once every lane has finished (the remaining steps are exact no-ops).
Pinned against the JAX ``fast_beam_search`` by tests/test_torch_beam.py.
"""

from __future__ import annotations

import math

import torch

from pytorch_kaldi_asr_tpu_torch.decode.beam import BeamResult, _advance
from pytorch_kaldi_asr_tpu_torch.models.common import (
    layer_norm,
    masked_softmax,
    position_encoding_table,
)
from pytorch_kaldi_asr_tpu_torch.models.transformer import encode, tree_map
from pytorch_kaldi_asr_tpu_torch.utils import constants


def _project_heads(x, w):
    """[N, D] × [H, D, K] → [N, H, K]."""
    return torch.einsum("nd,hdk->nhk", x, w)


def _layer_norm_rows(x, ln):
    return layer_norm(x[:, None, :], ln["gamma"], ln["beta"],
                      skip_len1=False)[:, 0]


def _mha_step(p, x_t, k_ctx, v_ctx, ctx_valid, scale, ln_skip):
    """One-query multi-head attention: x_t [N, D], context K/V
    [N, H, C, dk/dv], ctx_valid [N, C] bool → [N, D]."""
    q = _project_heads(x_t, p["w_qs"])  # [N, H, K]
    logits = torch.einsum("nhk,nhck->nhc", q, k_ctx) / math.sqrt(scale)
    attn = masked_softmax(logits, ~ctx_valid[:, None, :])
    out = torch.einsum("nhc,nhcv->nhv", attn, v_ctx)
    out = out.reshape(out.shape[0], -1) @ p["proj"]["w"] + p["proj"]["b"]
    out = out + x_t  # residual
    return out if ln_skip else _layer_norm_rows(out, p["ln"])


def _ffn_step(p, x_t, ln_skip):
    h = torch.relu(x_t @ p["w1"]["w"] + p["w1"]["b"])
    out = h @ p["w2"]["w"] + p["w2"]["b"] + x_t
    return out if ln_skip else _layer_norm_rows(out, p["ln"])


def _decode_one(dec, tokens_t, t, self_caches, cross_k, cross_v, src_valid,
                pos_table, ln_skip):
    """One decoder step for all lanes.  tokens_t [N] current input token;
    self_caches: per layer dict(k,v [N,H,W,dk], valid [N,W]).
    Returns (word_logits [N, V], new per-layer (k_t, v_t))."""
    n = tokens_t.shape[0]
    x = dec["embed"][tokens_t] + pos_table[t][None, :]
    d_model = x.shape[-1]

    new_kv = []
    for li, layer in enumerate(dec["layers"]):
        cache = self_caches[li]
        k_t = _project_heads(x, layer["slf"]["w_ks"])  # [N, H, K]
        v_t = _project_heads(x, layer["slf"]["w_vs"])
        new_kv.append((k_t, v_t))
        k_ctx = torch.cat([cache["k"], k_t[:, :, None, :]], dim=2)
        v_ctx = torch.cat([cache["v"], v_t[:, :, None, :]], dim=2)
        ctx_valid = torch.cat(
            [cache["valid"], torch.ones((n, 1), dtype=torch.bool,
                                        device=x.device)], dim=1)
        x = _mha_step(layer["slf"], x, k_ctx, v_ctx, ctx_valid, d_model,
                      ln_skip)
        x = _mha_step(layer["enc"], x, cross_k[li], cross_v[li], src_valid,
                      d_model, ln_skip)
        x = _ffn_step(layer["ffn"], x, ln_skip)
    return x @ dec["word_proj"]["w"], new_kv


def empty_caches(n_layers, n, heads, window, d_k, d_v, device=None):
    """Per-layer rolling K/V caches for ``n`` lanes with a ``window``-wide
    band."""
    return [{
        "k": torch.zeros((n, heads, window, d_k), device=device),
        "v": torch.zeros((n, heads, window, d_v), device=device),
        "valid": torch.zeros((n, window), dtype=torch.bool, device=device),
    } for _ in range(n_layers)]


def roll_caches(caches, new_kv, window):
    """Shift each rolling cache left one slot and append this step's K/V.
    window == 0 (band (0,0)) keeps the caches empty."""
    if window == 0:
        return caches
    out = []
    for cache, (k_t, v_t) in zip(caches, new_kv):
        n = k_t.shape[0]
        out.append({
            "k": torch.cat([cache["k"][:, :, 1:], k_t[:, :, None, :]], dim=2),
            "v": torch.cat([cache["v"][:, :, 1:], v_t[:, :, None, :]], dim=2),
            "valid": torch.cat(
                [cache["valid"][:, 1:],
                 torch.ones((n, 1), dtype=torch.bool, device=k_t.device)],
                dim=1),
        })
    return out


def gather_beam_lanes(caches, parent, b, beam_size):
    """Reorder lane-major trees by each batch row's parent lane."""
    flat = (torch.arange(b, device=parent.device)[:, None] * beam_size
            + parent).reshape(-1)
    return tree_map(lambda a: a[flat], caches)


def project_cross_kv(dec, enc_proj, beam_size):
    """Per-layer cross-attention K/V, projected once per utterance and
    expanded across beam lanes ([N, H, S, dk/dv])."""
    cross_k, cross_v = [], []
    for layer in dec["layers"]:
        ck = torch.einsum("bsd,hdk->bhsk", enc_proj, layer["enc"]["w_ks"])
        cv = torch.einsum("bsd,hdv->bhsv", enc_proj, layer["enc"]["w_vs"])
        cross_k.append(torch.repeat_interleave(ck, beam_size, dim=0))
        cross_v.append(torch.repeat_interleave(cv, beam_size, dim=0))
    return cross_k, cross_v


def _check_search_cfg(cfg, max_len):
    if max_len > cfg.decoder_max_len:
        raise ValueError("max_len exceeds the decoder position table")
    if cfg.decoder_sub_sequence[1] != 0:
        raise ValueError("incremental decoding needs a causal band (end=0)")


@torch.no_grad()
def fast_beam_search(params, cfg, src, src_mask, *, beam_size, max_len):
    """Encode a batch and beam-search it with the KV caches.  ``src``
    [B, S, D] float32 and ``src_mask`` [B, S] on the params' device."""
    _check_search_cfg(cfg, max_len)
    enc_output, src_mask_f = encode(params, cfg, src, src_mask)
    return fast_beam_search_memory(params, cfg, enc_output, src_mask_f,
                                   beam_size=beam_size, max_len=max_len)


@torch.no_grad()
def fast_beam_search_memory(params, cfg, enc_output, src_mask_f, prefix=None,
                            *, beam_size, max_len):
    """:func:`fast_beam_search` over encoder memory (``encode``'s output
    and folded mask), optionally continuing from a forced token prefix.

    ``prefix`` [B, P] holds token ids without BOS/EOS (a tensor, or
    anything ``torch.as_tensor`` takes); None or P == 0 is the plain search
    over that memory.  The streaming server's incremental partials force
    the previous partial's stable prefix through the KV caches, then
    beam-continue: the returned scores accumulate over the continuation
    only (the forced prefix contributes 0), so they rank hypotheses within
    one call but are not comparable to full-search scores."""
    _check_search_cfg(cfg, max_len)
    if prefix is None:
        prefix = torch.zeros((enc_output.shape[0], 0), dtype=torch.int64)
    prefix = torch.as_tensor(prefix, dtype=torch.int64).to(enc_output.device)
    return _search_from_memory(params, cfg, enc_output, src_mask_f, prefix,
                               beam_size=beam_size, max_len=max_len)


def _search_from_memory(params, cfg, enc_output, src_mask_f, prefix, *,
                        beam_size, max_len):
    """Beam search over encoder memory, first forcing ``prefix`` [B, P]
    (token ids without BOS/EOS) through the caches when P > 0."""
    window = -cfg.decoder_sub_sequence[0]
    b = enc_output.shape[0]
    vocab = cfg.vocab_size
    dec = params["decoder"]
    device = enc_output.device
    n = b * beam_size
    P = prefix.shape[1]
    if P >= max_len:
        raise ValueError(f"prefix length {P} leaves no room under "
                         f"max_len {max_len}")

    # [B, S, de_d] in the weights' dtype, whatever the encoder stream's
    w = dec["enc_dec_proj"]["w"]
    enc_proj = enc_output.to(w.dtype) @ w
    cross_k, cross_v = project_cross_kv(dec, enc_proj, beam_size)
    src_valid = torch.repeat_interleave(src_mask_f > 0, beam_size, dim=0)
    pos_table = position_encoding_table(cfg.decoder_max_len, cfg.de_d_model,
                                        device=device)
    caches = empty_caches(len(dec["layers"]), n, cfg.n_head, window,
                          cfg.d_k, cfg.d_v, device=device)

    tokens = torch.zeros((n, max_len + 1), dtype=torch.int64, device=device)
    tokens[:, 0] = constants.BOS
    scores = torch.full((b, beam_size), float("-inf"), device=device)
    scores[:, 0] = 0.0
    finished = torch.zeros((b, beam_size), dtype=torch.bool, device=device)
    lengths = torch.full((b, beam_size), max_len + 1, dtype=torch.int64,
                         device=device)

    def step_logits(tokens, t, caches, ln_skip=False):
        return _decode_one(dec, tokens[:, t], t, caches, cross_k, cross_v,
                           src_valid, pos_table, ln_skip)

    state = (tokens, scores, finished, lengths)
    if P > 0:
        # forced prefix: every lane carries the same tokens, so the beam
        # state is untouched; the steps only fill the caches (with LN)
        tokens[:, 1:P + 1] = torch.repeat_interleave(prefix, beam_size, dim=0)
        for t in range(P):
            _, new_kv = step_logits(tokens, t, caches)
            caches = roll_caches(caches, new_kv, window)
        first_t = P
    else:
        # step 0: the reference decodes a length-1 sequence here, where layer
        # norm is skipped, but only for this step's logits; the cached K/V
        # come from the pass with layer norm
        logits0, new_kv = step_logits(tokens, 0, caches)
        if cfg.ln_skip_len1:
            logits0, _ = step_logits(tokens, 0, caches, ln_skip=True)
        state, parent = _advance(state, torch.log_softmax(logits0, dim=-1), 0,
                                 beam_size, vocab)
        caches = gather_beam_lanes(roll_caches(caches, new_kv, window),
                                   parent, b, beam_size)
        first_t = 1

    for t in range(first_t, max_len):
        if bool(state[2].all()):
            break  # every lane finished: the remaining steps are no-ops
        logits, new_kv = step_logits(state[0], t, caches)
        state, parent = _advance(state, torch.log_softmax(logits, dim=-1), t,
                                 beam_size, vocab)
        caches = gather_beam_lanes(roll_caches(caches, new_kv, window),
                                   parent, b, beam_size)

    tokens, scores, finished, lengths = state
    return BeamResult(
        tokens=tokens.reshape(b, beam_size, max_len + 1),
        scores=scores,
        lengths=lengths,
        finished=finished,
    )
