"""Stage-2 neural-LM training: a causal transformer LM (models/nlm.py) on
transcript text with the recipe's vocabulary, for ``score_lm
-nlm_model_dir`` rescoring and ``decode -nlm_model_dir`` shallow fusion.

Same flags and defaults as ``pytorch_kaldi_asr_tpu.recipes.train_nlm``
(d_model 128, 2 layers, 2 heads, ``-max_len`` 64, dropout 0.1, Adam under
the hyperbolic schedule at soft 2000) plus ``-device`` (``cuda`` by
default; ``cpu`` on request; without a visible card and without ``-device
cpu`` it raises).  Each epoch visits the sentences in a numpy permutation
from ``seed``, in full batches (a corpus smaller than a batch makes one
ragged batch, its rows repeated), as the JAX package does; the loss is
the mean per token.  The dropout masks come from the port's per-site seeds
(``train/state.step_rngs``), not ``jax.random``.

Usage::

    python3 -m pytorch_kaldi_asr_tpu_torch.recipes.train_nlm \\
        -text data/train/text -read_vocab_file data/language/vocab.txt \\
        -save_model_dir exp/nlm -epoch 20
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from pytorch_kaldi_asr_tpu_torch.data import read_vocab
from pytorch_kaldi_asr_tpu_torch.models.nlm import (
    encode_sentences,
    init_nlm,
    nlm_loss,
)
from pytorch_kaldi_asr_tpu_torch.models.transformer import (
    TransformerConfig,
    tree_map,
)
from pytorch_kaldi_asr_tpu_torch.ops.launches import log_launch_counts
from pytorch_kaldi_asr_tpu_torch.train.checkpoint import save_checkpoint
from pytorch_kaldi_asr_tpu_torch.train.optim import set_learning_rate
from pytorch_kaldi_asr_tpu_torch.train.state import (
    create_train_state,
    step_rngs,
)
from pytorch_kaldi_asr_tpu_torch.utils.device import disable_tf32, resolve_device
from pytorch_kaldi_asr_tpu_torch.utils.logging import info, log_startup, procedure


def read_sentences(path):
    """``utt w1 w2 ...`` lines → word lists (key dropped)."""
    out = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if len(parts) > 1:
                out.append(parts[1:])
    return out


def nlm_config(vocab_size, *, d_model=128, layers=2, n_head=2, max_len=64,
               dropout=0.1):
    """The LM's configuration, as the JAX package builds it: the decoder
    fields, a full causal band ``(-max_len, 0)`` and no length-1 layer-norm
    skip (shallow fusion evaluates the LM one token at a time, where the
    skip would make it differ from batch scoring)."""
    return TransformerConfig(
        src_dim=1,  # unused by the LM; kept for checkpoint compatibility
        vocab_size=vocab_size,
        de_d_model=d_model,
        de_layers=layers,
        n_head=n_head,
        d_k=d_model // n_head,
        d_v=d_model // n_head,
        decoder_max_len=max_len,
        de_dropout=dropout,
        decoder_sub_sequence=(-max_len, 0),
        encoder_max_len=8,
        ln_skip_len1=False,
    )


def nlm_train_step(state, cfg, toks, mask):
    """One Adam update of ``state`` in place on the mean per-token loss of
    ``toks``/``mask`` [B, T]; returns (loss_sum, n_correct, n_tokens) as
    0-d tensors on the device."""
    rngs = step_rngs(state.seed, state.step)
    loss, n_correct, n = nlm_loss(state.params, cfg, toks, mask, train=True,
                                  rngs=rngs)
    state.optimizer.zero_grad(set_to_none=True)
    (loss / n).backward()
    set_learning_rate(state.optimizer, state.schedule(state.step))
    state.optimizer.step()
    state.step += 1
    return loss.detach(), n_correct, n


def train_nlm(text_path, vocab_file, save_dir, *, epochs=20, batch_size=32,
              d_model=128, layers=2, n_head=2, max_len=64, dropout=0.1,
              lr=0.001, soft_coefficient=2000.0, seed=0, device="cuda"):
    """Train the LM on ``device`` and save it to ``save_dir``; returns
    (params, cfg, the last epoch's training perplexity)."""
    word2idx = read_vocab(vocab_file)
    sentences = read_sentences(text_path)
    if not sentences:
        raise SystemExit(f"no sentences in {text_path}")
    cfg = nlm_config(max(word2idx.values()) + 1, d_model=d_model,
                     layers=layers, n_head=n_head, max_len=max_len,
                     dropout=dropout)
    params = init_nlm(torch.Generator().manual_seed(seed), cfg)
    state = create_train_state(tree_map(lambda x: x.to(device), params),
                               start_lr=lr, soft_coefficient=soft_coefficient,
                               seed=seed + 1)
    toks, mask = encode_sentences(sentences, word2idx, max_len)
    toks = torch.from_numpy(toks).long().to(device)
    mask = torch.from_numpy(mask).to(device)

    rng = np.random.default_rng(seed)
    n_full = len(sentences) // batch_size
    ppl = float("nan")
    for epoch in range(1, epochs + 1):
        order = rng.permutation(len(sentences))
        totals = None
        for i in range(max(1, n_full)):
            idx = order[i * batch_size: (i + 1) * batch_size]
            if len(idx) < batch_size:  # tiny corpus: one ragged batch
                idx = np.resize(idx, batch_size)
            idx = torch.from_numpy(idx).to(device)
            loss, n_correct, n = nlm_train_step(state, cfg, toks[idx],
                                                mask[idx])
            # summed on the device, read once per epoch
            sums = torch.stack([loss, n, n_correct / n])
            totals = sums if totals is None else totals + sums
        nll, n_tok, acc_sum = totals.tolist()
        ppl = float(np.exp(nll / max(n_tok, 1.0)))
        info("nlm epoch %d: token-acc %.3f, train ppl %.2f", epoch,
             acc_sum / max(1, n_full), ppl)

    save_checkpoint(save_dir, state.params, cfg, epoch=epochs,
                    step=state.step, extra={"model_kind": "nlm"})
    info("neural LM saved to %s", save_dir)
    return state.params, cfg, ppl


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-text", required=True)
    parser.add_argument("-read_vocab_file", required=True)
    parser.add_argument("-save_model_dir", required=True)
    parser.add_argument("-epoch", type=int, default=20)
    parser.add_argument("-batch_size", type=int, default=32)
    parser.add_argument("-d_model", type=int, default=128)
    parser.add_argument("-layers", type=int, default=2)
    parser.add_argument("-n_head", type=int, default=2)
    parser.add_argument("-max_len", type=int, default=64)
    parser.add_argument("-dropout", type=float, default=0.1)
    parser.add_argument("-optim_start_lr", type=float, default=0.001)
    parser.add_argument("-device", default="cuda",
                        help="cuda (default), cuda:N or cpu")
    opt = parser.parse_args(argv)

    device = resolve_device(opt.device)
    disable_tf32()
    procedure("neural LM training")
    train_nlm(
        opt.text, opt.read_vocab_file, opt.save_model_dir,
        epochs=opt.epoch, batch_size=opt.batch_size, d_model=opt.d_model,
        layers=opt.layers, n_head=opt.n_head, max_len=opt.max_len,
        dropout=opt.dropout, lr=opt.optim_start_lr, device=device,
    )
    log_launch_counts(device)
    return 0


if __name__ == "__main__":
    log_startup()
    raise SystemExit(main())
