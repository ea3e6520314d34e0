"""Shallow fusion: the neural LM inside the KV-cached beam search (the JAX
package's ``decode/fusion.py``).  Every candidate is scored during the
search as

    score(w | prefix) = log p_AM(w | prefix, x)
                        + lm_weight · log p_LM(w | prefix)

It is decode/fast_beam.py's search with a second set of rolling caches for
the causal-transformer LM (models/nlm.py), whose layers are the decoder's
self-attention and FFN steps without cross-attention, so the per-step
pieces (``_mha_step``, ``_ffn_step``) serve both.  The LM must be trained
with ``ln_skip_len1=False`` (recipes/train_nlm.py's default): the length-1
layer-norm skip would make one-token-at-a-time scoring differ from batch
scoring.  With ``lm_weight == 0`` the result equals ``fast_beam_search``
exactly.  As that search, the loop stops once every lane has finished.
Pinned against the JAX ``fused_beam_search`` by
tests/test_torch_fusion.py.
"""

from __future__ import annotations

import torch

from pytorch_kaldi_asr_tpu_torch.decode.beam import BeamResult, _advance
from pytorch_kaldi_asr_tpu_torch.decode.fast_beam import (
    _check_search_cfg,
    _decode_one,
    _ffn_step,
    _mha_step,
    _project_heads,
    empty_caches,
    gather_beam_lanes,
    project_cross_kv,
    roll_caches,
)
from pytorch_kaldi_asr_tpu_torch.models.common import position_encoding_table
from pytorch_kaldi_asr_tpu_torch.models.transformer import encode
from pytorch_kaldi_asr_tpu_torch.ops.quant import (
    dequantize_tree,
    quantize_tree,
)
from pytorch_kaldi_asr_tpu_torch.utils import constants


def make_fused_search(lm_params, lm_cfg, lm_weight, *, quantize=False):
    """A search ``(params, cfg, enc_output, src_mask_f, *, beam_size,
    max_len)`` over encoder memory running :func:`fused_beam_search_memory`
    with this LM: decode/runner.py's wiring point.  ``quantize=True`` keeps
    the LM as int8 on its device and dequantizes it once per search call,
    as the runner does the acoustic model's tree."""
    lm_tree = quantize_tree(lm_params)[0] if quantize else lm_params

    def fused_search(params, cfg, enc_output, src_mask_f, *, beam_size,
                     max_len):
        lm = dequantize_tree(lm_tree) if quantize else lm_tree
        return fused_beam_search_memory(params, cfg, lm, lm_cfg, lm_weight,
                                        enc_output, src_mask_f,
                                        beam_size=beam_size, max_len=max_len)

    return fused_search


def nlm_step(lm_params, tokens_t, t, caches, pos_table):
    """One causal-LM step for all lanes: tokens_t [N] → (log-probs [N, V],
    new per-layer (k_t, v_t)).  ``caches``: per layer dict(k, v [N, H, W,
    d], valid [N, W]).  Equals models/nlm.py ``nlm_logits`` position for
    position when the caches hold the true history (``ln_skip_len1=False``
    models only)."""
    x = lm_params["embed"][tokens_t] + pos_table[t][None, :]
    d_model = x.shape[-1]
    n = tokens_t.shape[0]
    new_kv = []
    for cache, layer in zip(caches, lm_params["layers"]):
        k_t = _project_heads(x, layer["slf"]["w_ks"])
        v_t = _project_heads(x, layer["slf"]["w_vs"])
        new_kv.append((k_t, v_t))
        k_ctx = torch.cat([cache["k"], k_t[:, :, None, :]], dim=2)
        v_ctx = torch.cat([cache["v"], v_t[:, :, None, :]], dim=2)
        ctx_valid = torch.cat(
            [cache["valid"], torch.ones((n, 1), dtype=torch.bool,
                                        device=x.device)], dim=1)
        x = _mha_step(layer["slf"], x, k_ctx, v_ctx, ctx_valid, d_model,
                      ln_skip=False)
        x = _ffn_step(layer["ffn"], x, ln_skip=False)
    logits = x @ lm_params["word_proj"]["w"]
    return torch.log_softmax(logits, dim=-1), new_kv


def _check_fusion_cfg(cfg, lm_cfg, max_len):
    _check_search_cfg(cfg, max_len)
    if lm_cfg.ln_skip_len1:
        raise ValueError(
            "shallow fusion needs an NLM trained with ln_skip_len1=False "
            "(recipes/train_nlm.py default)")
    if lm_cfg.decoder_sub_sequence[1] != 0:
        raise ValueError(
            "shallow fusion needs a CAUSAL LM band (decoder_sub_sequence "
            "end=0): incremental scoring cannot see future tokens, so a "
            "lookahead LM would silently diverge from its batch scores")
    if lm_cfg.vocab_size < cfg.vocab_size:
        raise ValueError("the LM vocabulary is smaller than the AM's")


@torch.no_grad()
def fused_beam_search(params, cfg, lm_params, lm_cfg, lm_weight, src,
                      src_mask, *, beam_size, max_len):
    """Encode a batch and beam-search it with per-step shallow fusion.  The
    LM shares the recipe vocabulary (ids identical; a larger LM vocabulary's
    extra entries are ignored)."""
    _check_fusion_cfg(cfg, lm_cfg, max_len)
    enc_output, src_mask_f = encode(params, cfg, src, src_mask)
    return fused_beam_search_memory(params, cfg, lm_params, lm_cfg,
                                    lm_weight, enc_output, src_mask_f,
                                    beam_size=beam_size, max_len=max_len)


@torch.no_grad()
def fused_beam_search_memory(params, cfg, lm_params, lm_cfg, lm_weight,
                             enc_output, src_mask_f, *, beam_size, max_len):
    """:func:`fused_beam_search` over encoder memory (``encode``'s output
    and folded mask)."""
    _check_fusion_cfg(cfg, lm_cfg, max_len)
    window = -cfg.decoder_sub_sequence[0]
    lm_window = min(-lm_cfg.decoder_sub_sequence[0], max_len)
    b = enc_output.shape[0]
    vocab = cfg.vocab_size
    dec = params["decoder"]
    device = enc_output.device
    n = b * beam_size

    w = dec["enc_dec_proj"]["w"]
    enc_proj = enc_output.to(w.dtype) @ w
    cross_k, cross_v = project_cross_kv(dec, enc_proj, beam_size)
    src_valid = torch.repeat_interleave(src_mask_f > 0, beam_size, dim=0)
    pos_table = position_encoding_table(cfg.decoder_max_len, cfg.de_d_model,
                                        device=device)
    lm_pos = position_encoding_table(max(lm_cfg.decoder_max_len, max_len),
                                     lm_cfg.de_d_model, device=device)
    caches = empty_caches(len(dec["layers"]), n, cfg.n_head, window,
                          cfg.d_k, cfg.d_v, device=device)
    lm_caches = empty_caches(len(lm_params["layers"]), n, lm_cfg.n_head,
                             lm_window, lm_cfg.d_k, lm_cfg.d_v, device=device)

    tokens = torch.zeros((n, max_len + 1), dtype=torch.int64, device=device)
    tokens[:, 0] = constants.BOS
    scores = torch.full((b, beam_size), float("-inf"), device=device)
    scores[:, 0] = 0.0
    finished = torch.zeros((b, beam_size), dtype=torch.bool, device=device)
    lengths = torch.full((b, beam_size), max_len + 1, dtype=torch.int64,
                         device=device)
    state = (tokens, scores, finished, lengths)

    def step(state, t, caches, lm_caches, first=False):
        tok_t = state[0][:, t]
        logits, new_kv = _decode_one(dec, tok_t, t, caches, cross_k, cross_v,
                                     src_valid, pos_table, ln_skip=False)
        if first and cfg.ln_skip_len1:
            # the reference's length-1 layer-norm skip, for step 0's logits
            # only (decode/fast_beam.py)
            logits, _ = _decode_one(dec, tok_t, t, caches, cross_k, cross_v,
                                    src_valid, pos_table, ln_skip=True)
        lm_lp, lm_new_kv = nlm_step(lm_params, tok_t, t, lm_caches, lm_pos)
        word_lk = (torch.log_softmax(logits, dim=-1)
                   + lm_weight * lm_lp[:, :vocab])
        state, parent = _advance(state, word_lk, t, beam_size, vocab)
        caches = gather_beam_lanes(roll_caches(caches, new_kv, window),
                                   parent, b, beam_size)
        lm_caches = gather_beam_lanes(
            roll_caches(lm_caches, lm_new_kv, lm_window), parent, b,
            beam_size)
        return state, caches, lm_caches

    state, caches, lm_caches = step(state, 0, caches, lm_caches, first=True)
    for t in range(1, max_len):
        if bool(state[2].all()):
            break  # every lane finished: the remaining steps are no-ops
        state, caches, lm_caches = step(state, t, caches, lm_caches)

    tokens, scores, finished, lengths = state
    return BeamResult(
        tokens=tokens.reshape(b, beam_size, max_len + 1),
        scores=scores,
        lengths=lengths,
        finished=finished,
    )
