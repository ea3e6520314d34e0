"""Frame-level acoustic model: encoder → per-frame log-posteriors (the
port's ``pytorch_kaldi_asr_tpu.models.am``).

The hybrid-AM contract: the model emits per-utterance log-posterior
matrices that a host WFST decoder (decode/latgen.py) consumes.  Any
encoder family plugs in (tdnn, banded, blstm, conformer, tdnnf); the
output head is a linear projection to the target inventory, then a
log-softmax in float32, minus the log-priors when given (the hybrid
"likelihood" scaling).  The parameter tree is ``{"encoder": ..., "head":
{"w", "b"}}``, the JAX package's, so its AM checkpoints load here.
"""

from __future__ import annotations

import numpy as np
import torch

from pytorch_kaldi_asr_tpu_torch.io import kaldi_io
from pytorch_kaldi_asr_tpu_torch.data.loader import to_device
from pytorch_kaldi_asr_tpu_torch.models.common import linear, xavier_normal
from pytorch_kaldi_asr_tpu_torch.models.transformer import (
    TransformerConfig,
    compute_dtype,
    encode,
    init_transformer,
)


def init_am(generator, cfg: TransformerConfig, n_targets, lda_mat=None):
    """Encoder parameters and the posterior head (float32, on the CPU).
    ``cfg.vocab_size`` is unused by the AM but kept so one config type
    serves both model kinds."""
    base = init_transformer(generator, cfg, lda_mat)
    return {
        "encoder": base["encoder"],
        "head": {
            "w": xavier_normal(generator, (cfg.en_d_model, n_targets),
                               cfg.en_d_model, n_targets),
            "b": torch.zeros(n_targets),
        },
    }


def head_log_posteriors(params, cfg, enc, *, log_priors=None):
    """Posterior head on encoder output ``enc`` [..., d_model]: ``enc @ w +
    b`` in the compute dtype, then log-softmax in float32 (minus
    ``log_priors`` [n_targets] if given)."""
    logits = linear(enc, params["head"]["w"], params["head"]["b"],
                    compute_dtype(cfg))
    logp = torch.log_softmax(logits.float(), dim=-1)
    if log_priors is not None:
        logp = logp - log_priors
    return logp


def am_log_posteriors(params, cfg, src, src_mask, *, train=False, rngs=None,
                      log_priors=None, pos_offset=0):
    """([B, S', n_targets] log-posteriors, the folded [B, S'] mask).
    ``pos_offset`` shifts the tdnn's position rows (the streaming
    frontend passes its buffer's global frame index)."""
    enc, mask = encode(params, cfg, src, src_mask, train=train, rngs=rngs,
                       pos_offset=pos_offset)
    return head_log_posteriors(params, cfg, enc, log_priors=log_priors), mask


def frame_ce_loss(params, cfg, src, src_mask, targets, *, train=False,
                  rngs=None, utt_valid=None):
    """Frame-level cross entropy: ``targets`` [B, S'] int ids aligned with
    the (folded) encoder output; padded frames (mask 0) are excluded, and
    ``utt_valid`` [B] also excludes the loader's repeated tail rows ('all'
    mode).  Returns (loss_sum, n_correct, n_frames) as 0-d float32
    tensors."""
    logp, mask = am_log_posteriors(params, cfg, src, src_mask, train=train,
                                   rngs=rngs)
    valid = mask.float()
    if utt_valid is not None:
        valid = valid * utt_valid.float()[:, None]
    targets = targets.long()
    nll = -torch.take_along_dim(logp, targets[..., None], dim=-1)[..., 0]
    loss = (nll * valid).sum()
    n_correct = ((logp.argmax(dim=-1) == targets).float() * valid).sum()
    return loss, n_correct, valid.sum()


@torch.no_grad()
def write_posteriors(params, cfg, loader, wspecifier, device, *,
                     log_priors=None):
    """Each utterance of ``loader`` to its [frames, n_targets]
    log-posterior matrix on ``device``, written to a Kaldi table
    (``wspecifier``, e.g. ``ark,scp:post.ark,post.scp``).  Returns the
    number of utterances."""
    n = 0
    with kaldi_io.open_writer(wspecifier) as w:
        for batch in loader:
            b = to_device(batch, device)
            logp, mask = am_log_posteriors(params, cfg, b.src, b.src_mask,
                                           log_priors=log_priors)
            logp = logp.cpu().numpy()
            lengths = mask.sum(dim=1).cpu().numpy()
            for i, key in enumerate(batch.keys):
                if not batch.valid[i]:
                    continue
                w.write(key, np.ascontiguousarray(logp[i, :int(lengths[i])]))
                n += 1
    return n
