"""Training objective: cross entropy summed over the non-PAD goal positions,
with the reference's optional label smoothing (eps 0.1), as the JAX
package's ``train/loss.py`` computes it."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pytorch_kaldi_asr_tpu_torch.utils import constants

SMOOTHING_EPS = 0.1  # the reference's label-smoothing mass


def cross_entropy_loss(logits, goal, *, smoothing=False, extra_mask=None):
    """Sum CE over non-PAD positions; ``smoothing`` spreads SMOOTHING_EPS
    of each target over the other classes.

    logits: [B, T, V]; goal: [B, T] int ids.  ``extra_mask``: optional [B]
    or [B, T] multiplier (the loader's per-row ``valid`` flag for padded
    tail batches).  Returns (loss_sum, n_correct, n_words) as 0-d tensors
    on the logits' device."""
    v = logits.shape[-1]
    logp = F.log_softmax(logits, dim=-1)
    goal = goal.long()
    non_pad = (goal != constants.PAD).to(logp.dtype)
    if extra_mask is not None:
        extra = torch.as_tensor(extra_mask, device=logp.device).to(logp.dtype)
        if extra.dim() == 1:
            extra = extra[:, None]
        non_pad = non_pad * extra

    if smoothing:
        one_hot = F.one_hot(goal, v).to(logp.dtype)
        eps = SMOOTHING_EPS
        smooth = one_hot * (1.0 - eps) + (1.0 - one_hot) * eps / (v - 1)
        nll = -(smooth * logp).sum(dim=-1)
    else:
        nll = -logp.gather(-1, goal[..., None])[..., 0]

    loss = (nll * non_pad).sum()
    pred = logits.argmax(dim=-1)
    n_correct = ((pred == goal).to(logp.dtype) * non_pad).sum()
    return loss, n_correct, non_pad.sum()
