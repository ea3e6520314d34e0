"""Beam-search state and the beam step shared by the searches.

Hypotheses live in ``[B·beam, T+1]`` lanes; the reference's competition rule
(finished hypotheses stay in the pool and compete with every extension of
the active ones) is a global top-k over ``beam·V`` extension candidates
concatenated with ``beam`` keep-finished candidates.  Lanes stay sorted by
score, so the n-best are the first rows.

Ties: ``jax.lax.top_k`` returns the lowest index among equal scores, and
``torch.topk`` does not promise any order.  Candidates at ``-inf`` tie at
every step, so the port takes a stable descending sort and keeps the first
``beam`` entries, which reproduces the JAX order.

The JAX package's fixed-buffer ``beam_search`` (the search for a non-causal
decoder band) is not ported yet; see ROADMAP.md.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

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
