"""SpecAugment: time and frequency masking of the features inside the train
step, with the JAX package's policy and defaults (``ops/specaugment.py``):
``n_freq_masks`` bands of width at most ``freq_width`` on the feature axis
and ``n_time_masks`` spans of width at most ``min(time_width,
⌊max_time_frac·length⌋)`` on each utterance's frames, filled with zeros.

The draws keep the JAX package's quirks: a frequency start in ``[0, max(D
- w, 1))``; a time width of ``r % (max_w + 1)`` and a time start of ``r %
max(length - w + 1, 1)`` with ``r`` uniform in ``[0, 10⁶)``.

Split in two:

- :func:`draw` takes a fixed number of integers (two per mask per
  utterance) from a CPU ``torch.Generator``, the one that then draws the
  step's dropout seeds (``models/common.DropoutRngs``), so the masks and
  the seeds after them are the same on every device;
- :func:`apply` turns them into widths and starts with the utterances'
  lengths and zeroes the masked entries, on the features' device, in
  integer arithmetic: no value goes back to the host.

The masks cannot equal ``jax.random``'s (ROADMAP.md queue 3, deliberate
difference 1); tests/test_torch_specaugment.py holds their distributions
against the JAX package's.
"""

from __future__ import annotations

import torch

_RANGE = 2**31 - 1  # the raw draws lie in [0, _RANGE)
_TIME_DRAW = 10**6  # the JAX package's randint(0, 10**6) for time masks


def draw(generator, batch, n_freq_masks=2, n_time_masks=2):
    """Raw integers for one step's masks: [n_freq_masks + n_time_masks, 2,
    batch] int64 on the CPU (per mask a width and a start draw per
    utterance)."""
    return torch.randint(0, _RANGE, (n_freq_masks + n_time_masks, 2, batch),
                         generator=generator)


def apply(raw, feats, feat_mask, *, n_freq_masks=2, freq_width=15,
          time_width=50, max_time_frac=0.2):
    """``feats`` [B, T, D] with the masks of ``raw`` (from :func:`draw`)
    zeroed; ``feat_mask`` [B, T] gives each utterance's length."""
    b, t, d = feats.shape
    device = feats.device
    raw = raw.to(device)
    lengths = feat_mask.sum(dim=1).to(torch.int64)  # [B]
    keep_f = torch.ones((b, d), dtype=torch.bool, device=device)
    keep_t = torch.ones((b, t), dtype=torch.bool, device=device)
    cols = torch.arange(d, device=device)[None, :]
    rows = torch.arange(t, device=device)[None, :]
    for i, (rw, rs) in enumerate(raw):
        if i < n_freq_masks:
            width = rw % (freq_width + 1)
            start = rs % torch.clamp(d - width, min=1)
            keep_f &= ~((cols >= start[:, None])
                        & (cols < (start + width)[:, None]))
        else:
            max_w = torch.clamp(
                (lengths.to(torch.float32) * max_time_frac).to(torch.int64),
                max=time_width)
            width = rw % _TIME_DRAW % torch.clamp(max_w + 1, min=1)
            start = rs % _TIME_DRAW % torch.clamp(lengths - width + 1, min=1)
            keep_t &= ~((rows >= start[:, None])
                        & (rows < (start + width)[:, None]))
    keep = keep_t[:, :, None] & keep_f[:, None, :]
    return torch.where(keep, feats, torch.zeros((), dtype=feats.dtype,
                                                device=device))


def spec_augment(generator, feats, feat_mask, *, n_freq_masks=2,
                 freq_width=15, n_time_masks=2, time_width=50,
                 max_time_frac=0.2):
    """:func:`draw` from ``generator``, then :func:`apply` to ``feats``."""
    raw = draw(generator, feats.shape[0], n_freq_masks, n_time_masks)
    return apply(raw, feats, feat_mask, n_freq_masks=n_freq_masks,
                 freq_width=freq_width, time_width=time_width,
                 max_time_frac=max_time_frac)
