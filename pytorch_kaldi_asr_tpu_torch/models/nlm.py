"""Neural language model: a causal transformer LM over the recipe's
vocabulary (the JAX package's ``models/nlm.py``), for n-best rescoring
(recipes/score_lm.py) and per-step shallow fusion (decode/fusion.py).

It is the decoder without cross-attention: word + position embeddings,
``de_layers`` × [self-attention, FFN] with the port's post-LN
``multi_head_attention``/``feed_forward`` under the band
``decoder_sub_sequence`` (causal; ``(-max_len, 0)`` from
recipes/train_nlm.py), and a vocabulary projection without bias.  The
configuration rides ``TransformerConfig``'s decoder fields, and a
checkpoint is the JAX package's layout with ``model_kind: "nlm"`` in its
meta, so one written by either package loads in the other.  Training drops
at the JAX package's sites (after the embeddings, each attention's
probabilities and output, each FFN's output, before the projection), each
through K3 with its own seed from ``rngs``.

Scoring contract: log10 p(sentence) including the EOS event, as ``ngram
-ppl`` reports it (lm/ngram.py ``sentence_logprob``).
"""

from __future__ import annotations

import numpy as np
import torch

from pytorch_kaldi_asr_tpu_torch.models.common import (
    banded_attn_mask,
    linear,
    padding_attn_mask,
    position_encoding_table,
    xavier_normal,
)
from pytorch_kaldi_asr_tpu_torch.models.transformer import (
    _drop,
    _init_ffn,
    _init_mha,
    compute_dtype,
    feed_forward,
    multi_head_attention,
)
from pytorch_kaldi_asr_tpu_torch.utils import constants
from pytorch_kaldi_asr_tpu_torch.utils.logging import warning

LOG10_E = float(np.log10(np.e))


def init_nlm(generator, cfg):
    """The LM's parameter tree (float32, on the CPU): ``embed`` (N(0, 1),
    row 0 zero), ``layers`` of {slf, ffn} and ``word_proj`` {w}.  Draws
    differ from the JAX package's (another generator); the distributions
    match."""
    embed = torch.randn((cfg.vocab_size, cfg.de_d_model), generator=generator)
    embed[0] = 0.0  # padding_idx
    layers = [{"slf": _init_mha(generator, cfg.de_d_model, cfg.n_head,
                                cfg.d_k, cfg.d_v),
               "ffn": _init_ffn(generator, cfg.de_d_model, cfg.de_d_model)}
              for _ in range(cfg.de_layers)]
    word_proj = xavier_normal(generator, (cfg.de_d_model, cfg.vocab_size),
                              cfg.de_d_model, cfg.vocab_size)
    return {"embed": embed, "layers": layers, "word_proj": {"w": word_proj}}


def nlm_logits(params, cfg, tokens, mask, *, train=False, rngs=None):
    """[B, T, vocab] next-token logits (float32) of ``tokens``/``mask``
    [B, T]; positions past ``decoder_max_len`` extrapolate (closed-form
    sinusoids)."""
    t = tokens.shape[1]
    device = tokens.device
    pos = position_encoding_table(max(cfg.decoder_max_len, t), cfg.de_d_model,
                                  device=device)[:t]
    x = params["embed"][tokens] + pos[None]
    blocked = padding_attn_mask(mask, mask) | banded_attn_mask(
        t, *cfg.decoder_sub_sequence, device=device)[None]
    rate = cfg.de_dropout
    x = _drop(x, rate, rngs, train)
    for layer in params["layers"]:
        x = multi_head_attention(layer["slf"], x, x, x, blocked, cfg, rate,
                                 rngs, train)
        x = feed_forward(layer["ffn"], x, cfg, rate, rngs, train)
    x = _drop(x, rate, rngs, train)
    return linear(x, params["word_proj"]["w"], None,
                  compute_dtype(cfg)).float()


def _goal_logprobs(params, cfg, tokens, mask, *, train=False, rngs=None):
    """(log-softmax [B, T-1, V], goal [B, T-1], valid [B, T-1]) of the
    teacher-forced shift: inputs tokens[:, :-1], goals tokens[:, 1:], PAD
    goals invalid."""
    inp, goal = tokens[:, :-1], tokens[:, 1:]
    logits = nlm_logits(params, cfg, inp, mask[:, :-1], train=train,
                        rngs=rngs)
    valid = (goal != constants.PAD).float()
    return torch.log_softmax(logits, dim=-1), goal, valid


def nlm_loss(params, cfg, tokens, mask, *, train=False, rngs=None):
    """Teacher-forced cross entropy over [BOS w1 ... wn EOS] rows: returns
    (loss_sum, n_correct, n_tokens)."""
    logp, goal, valid = _goal_logprobs(params, cfg, tokens, mask, train=train,
                                       rngs=rngs)
    nll = -logp.gather(-1, goal[..., None]).squeeze(-1)
    n_correct = ((logp.argmax(-1) == goal).float() * valid).sum()
    return (nll * valid).sum(), n_correct, valid.sum()


def sentence_logprobs(params, cfg, tokens, mask):
    """[B] log10 p(sentence) of [BOS ... EOS PAD*] rows: every non-PAD
    transition scored, the EOS event included."""
    logp, goal, valid = _goal_logprobs(params, cfg, tokens, mask)
    ll = logp.gather(-1, goal[..., None]).squeeze(-1)
    return (ll * valid).sum(dim=1) * LOG10_E


def load_nlm(model_dir, device=None):
    """(params on ``device``, cfg, meta) of a neural-LM checkpoint
    (recipes/train_nlm.py, in either package); raises for any other
    checkpoint."""
    from pytorch_kaldi_asr_tpu_torch.train.checkpoint import (
        load_checkpoint,
        read_checkpoint_config,
    )

    cfg, meta = read_checkpoint_config(model_dir)
    if meta.get("model_kind") != "nlm":
        raise ValueError(
            f"{model_dir} is not a neural-LM checkpoint "
            f"(model_kind={meta.get('model_kind')!r}); train one with "
            "recipes/train_nlm.py")
    return load_checkpoint(model_dir, device=device)["params"], cfg, meta


def encode_sentences(sentences, word2idx, max_len):
    """[N, max_len] int32 [BOS ids EOS PAD*] and the uint8 mask; sentences
    longer than max_len - 2 words are cut (OOVs become UNK)."""
    toks = np.full((len(sentences), max_len), constants.PAD, np.int32)
    mask = np.zeros((len(sentences), max_len), np.uint8)
    for i, words in enumerate(sentences):
        ids = [constants.BOS] + [
            word2idx.get(w, constants.UNK) for w in words
        ][: max_len - 2] + [constants.EOS]
        toks[i, : len(ids)] = ids
        mask[i, : len(ids)] = 1
    return toks, mask


@torch.no_grad()
def score_sentences(params, cfg, sentences, word2idx, *, batch_size=64):
    """log10 scores of a list of word lists, in order, on the params'
    device, ``batch_size`` sentences at a time.

    The width covers the longest sentence and never cuts one (a prefix
    scored as p(sentence) would make long hypotheses cheap next to
    full-text n-gram scores); past ``decoder_max_len`` the positions
    extrapolate, with one warning."""
    if not sentences:
        return []
    width = max(cfg.decoder_max_len, max(len(s) for s in sentences) + 2)
    if width > cfg.decoder_max_len:
        warning(
            "score_sentences: longest hypothesis (%d words) exceeds the "
            "LM's trained length %d; positions extrapolate — consider "
            "train_nlm -max_len >= decode max_token_seq_len",
            width - 2, cfg.decoder_max_len)
    device = params["embed"].device
    out = []
    for i in range(0, len(sentences), batch_size):
        toks, mask = encode_sentences(sentences[i: i + batch_size], word2idx,
                                      width)
        scores = sentence_logprobs(
            params, cfg, torch.from_numpy(toks).long().to(device),
            torch.from_numpy(mask).to(device))
        out.extend(float(s) for s in scores.cpu())
    return out
