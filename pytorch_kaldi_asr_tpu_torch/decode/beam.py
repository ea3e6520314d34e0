"""Beam-search state, the beam step shared by the searches, and the
fixed-buffer search.

Hypotheses live in ``[B·beam, T+1]`` lanes; the reference's competition rule
(finished hypotheses stay in the pool and compete with every extension of
the active ones) is a global top-k over ``beam·V`` extension candidates
concatenated with ``beam`` keep-finished candidates.  Lanes stay sorted by
score, so the n-best are the first rows.

Ties: ``jax.lax.top_k`` returns the lowest index among equal scores, and
``torch.topk`` does not promise any order.  Candidates at ``-inf`` tie at
every step, so the port takes a stable descending sort and keeps the first
``beam`` entries, which reproduces the JAX order.

``beam_search`` is the JAX package's fixed-buffer search, the one that
serves any decoder band (decode/fast_beam.py's KV-cached search needs a
causal one): hypotheses live in a ``[B·beam, max_len + 1]`` token buffer,
and every step decodes the whole buffer and reads the logits at the step's
position.  Positions after t hold PAD; with a causal band they cannot reach
position t, with a non-causal one they do, exactly as in the JAX package.
Pinned against the JAX ``beam_search``, ``fast_beam_search`` and the
``Lattice`` oracle by tests/test_torch_beam_search.py.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pytorch_kaldi_asr_tpu_torch.models.transformer import decode_logits, encode
from pytorch_kaldi_asr_tpu_torch.utils import constants


class BeamResult(NamedTuple):
    tokens: torch.Tensor  # [B, beam, T+1] int64 (BOS at column 0)
    scores: torch.Tensor  # [B, beam] float32, sorted descending
    lengths: torch.Tensor  # [B, beam] int64 tokens incl BOS+EOS (T+1 if unfinished)
    finished: torch.Tensor  # [B, beam] bool


def top_k_lowest_index(x, k):
    """Top ``k`` along the last axis, equal values in increasing index order
    (``jax.lax.top_k``'s order)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _advance(state, word_lk, t, beam_size, vocab):
    """One beam step: pool = extensions ∪ kept-finished, global top-k.

    ``state`` = (tokens [N, T+1], scores [B, beam], finished, lengths);
    ``word_lk`` [N, V] log-probs at step ``t``.  Returns (new state, parent
    lane of each new lane [B, beam]).  When every lane is finished this is an
    exact no-op."""
    tokens, scores, finished, lengths = state
    b = scores.shape[0]
    word_lk = word_lk.reshape(b, beam_size, vocab)

    neg_inf = torch.tensor(float("-inf"), dtype=scores.dtype,
                           device=scores.device)
    ext = torch.where(finished[..., None], neg_inf, scores[..., None] + word_lk)
    keep = torch.where(finished, scores, neg_inf)
    pool = torch.cat([ext.reshape(b, beam_size * vocab), keep], dim=1)

    top_scores, top_idx = top_k_lowest_index(pool, beam_size)
    is_ext = top_idx < beam_size * vocab
    parent = torch.where(is_ext, top_idx // vocab, top_idx - beam_size * vocab)
    word = torch.where(is_ext, top_idx % vocab,
                       torch.full_like(top_idx, constants.PAD))

    lane0 = torch.arange(b, device=scores.device)[:, None] * beam_size
    tokens = tokens[(lane0 + parent).reshape(-1)]
    tokens[:, t + 1] = torch.where(is_ext.reshape(-1), word.reshape(-1),
                                   tokens[:, t + 1])

    now_eos = is_ext & (word == constants.EOS)
    parent_finished = finished.gather(1, parent)
    parent_lengths = lengths.gather(1, parent)
    new_finished = torch.where(is_ext, now_eos, parent_finished)
    new_lengths = torch.where(now_eos, torch.full_like(parent_lengths, t + 2),
                              parent_lengths)
    return (tokens, top_scores, new_finished, new_lengths), parent


@torch.no_grad()
def beam_search(params, cfg, src, src_mask, *, beam_size, max_len):
    """Encode a batch and beam-search it over the fixed token buffer.
    ``max_len`` is the reference's ``max_token_seq_len``: at most that many
    steps, and the decoder never sees more than ``max_len`` positions.
    Every step runs (a finished beam's steps are exact no-ops), so the loop
    counter is the only host-side state: no step waits on the card."""
    enc_output, src_mask_f = encode(params, cfg, src, src_mask)
    return beam_search_memory(params, cfg, enc_output, src_mask_f,
                              beam_size=beam_size, max_len=max_len)


@torch.no_grad()
def beam_search_memory(params, cfg, enc_output, src_mask_f, *, beam_size,
                       max_len):
    """:func:`beam_search` over encoder memory (``encode``'s output and
    folded mask)."""
    if max_len > cfg.decoder_max_len:
        raise ValueError("max_len exceeds the decoder position table")
    b = enc_output.shape[0]
    vocab = cfg.vocab_size
    device = enc_output.device
    enc_rep = torch.repeat_interleave(enc_output, beam_size, dim=0)
    srcm_rep = torch.repeat_interleave(src_mask_f, beam_size, dim=0)

    n = b * beam_size
    tokens = torch.zeros((n, max_len + 1), dtype=torch.int64, device=device)
    tokens[:, 0] = constants.BOS
    scores = torch.full((b, beam_size), float("-inf"), device=device)
    scores[:, 0] = 0.0
    finished = torch.zeros((b, beam_size), dtype=torch.bool, device=device)
    lengths = torch.full((b, beam_size), max_len + 1, dtype=torch.int64,
                         device=device)
    ones_mask = torch.ones((n, max_len), dtype=torch.uint8, device=device)

    # step 0 decodes the length-1 buffer [BOS]: the reference runs the
    # decoder on a sequence of length 1 here, where layer norm is skipped
    logits = decode_logits(params, cfg, tokens[:, :1], ones_mask[:, :1],
                           srcm_rep, enc_rep)
    state, _ = _advance((tokens, scores, finished, lengths),
                        torch.log_softmax(logits[:, 0], dim=-1), 0,
                        beam_size, vocab)
    for t in range(1, max_len):
        logits = decode_logits(params, cfg, state[0][:, :max_len], ones_mask,
                               srcm_rep, enc_rep)
        state, _ = _advance(state, torch.log_softmax(logits[:, t], dim=-1),
                            t, beam_size, vocab)

    tokens, scores, finished, lengths = state
    return BeamResult(tokens=tokens.reshape(b, beam_size, max_len + 1),
                      scores=scores, lengths=lengths, finished=finished)
