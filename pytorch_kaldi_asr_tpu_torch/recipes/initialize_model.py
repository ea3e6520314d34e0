"""Stage-3 entry point: build and save the initial model checkpoint.

Same flags as ``pytorch_kaldi_asr_tpu.recipes.initialize_model``: input and
output dims come from the data (``src_dim`` from the first scp matrix, the
vocabulary size from the vocab file), the frozen LDA affine from
``lda.mat`` (or identity), hyperparameters from the flags with the TIMIT
defaults.  Weights are drawn on the CPU from ``torch.Generator`` seeded by
``-seed`` and saved in the JAX package's checkpoint layout.  Every encoder
family of the JAX package is offered (``tdnn``, ``banded``, ``blstm``,
``conformer``, ``tdnnf``); the conformer's residual stream is float32 or
bfloat16 (``-conformer_stream_dtype``).
"""

import argparse

import torch

from pytorch_kaldi_asr_tpu_torch.data import instances as instances_handler
from pytorch_kaldi_asr_tpu_torch.io import kaldi_io
from pytorch_kaldi_asr_tpu_torch.models.transformer import (
    TransformerConfig,
    init_transformer,
)
from pytorch_kaldi_asr_tpu_torch.train import save_checkpoint
from pytorch_kaldi_asr_tpu_torch.utils.logging import info, log_startup


def str2tuple(s):
    if not (s.startswith("(") and s.endswith(")")):
        raise ValueError(f"invalid sub-sequence string {s!r}")
    arr = tuple(int(i) for i in s[1:-1].split(","))
    if len(arr) != 2:
        raise ValueError(f"invalid sub-sequence length in {s!r}")
    return arr


def build_config(opt):
    for _key, matrix in kaldi_io.read_mat_scp(opt.read_feats_scp_file):
        src_dim = matrix.shape[1]
        break
    info("get feature of dimension %d from %s.", src_dim,
         opt.read_feats_scp_file)
    word2idx = instances_handler.read_vocab(opt.read_vocab_file)
    vocab_dim = len(word2idx)
    info("get label of dimension %d from %s.", vocab_dim, opt.read_vocab_file)
    return TransformerConfig(
        src_dim=src_dim,
        vocab_size=vocab_dim,
        encoder_max_len=opt.encoder_max_len,
        decoder_max_len=opt.decoder_max_len,
        src_fold=opt.src_fold,
        encoder_sub_sequence=str2tuple(opt.encoder_sub_sequence),
        decoder_sub_sequence=str2tuple(opt.decoder_sub_sequence),
        en_layers=opt.en_layers,
        de_layers=opt.de_layers,
        n_head=opt.n_head,
        en_d_model=opt.en_d_model,
        de_d_model=opt.de_d_model,
        d_k=opt.d_k,
        d_v=opt.d_v,
        en_dropout=opt.en_dropout,
        de_dropout=opt.de_dropout,
        encoder_type=opt.encoder_type,
        conformer_stream_dtype=opt.conformer_stream_dtype,
        tdnn_contexts=((-1, 0, 1), (-1, 0, 1), (-3, 0, 3), (-3, 0, 3),
                       (-3, 0, 3), (-3, 0, 3)),
    )


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-read_feats_scp_file", required=True)
    parser.add_argument("-lda_mat_file", required=True)
    parser.add_argument("-read_vocab_file", required=True)
    parser.add_argument("-encoder_max_len", type=int, required=True)
    parser.add_argument("-decoder_max_len", type=int, required=True)
    parser.add_argument("-src_fold", type=int, default=1)
    parser.add_argument("-encoder_sub_sequence", default="(-100,0)")
    parser.add_argument("-decoder_sub_sequence", default="(-20,0)")
    parser.add_argument("-en_layers", type=int, default=2)
    parser.add_argument("-de_layers", type=int, default=2)
    parser.add_argument("-n_head", type=int, default=3)
    parser.add_argument("-en_d_model", type=int, default=256)
    parser.add_argument("-de_d_model", type=int, default=128)
    parser.add_argument("-d_k", type=int, default=64)
    parser.add_argument("-d_v", type=int, default=64)
    parser.add_argument("-en_dropout", type=float, default=0.2)
    parser.add_argument("-de_dropout", type=float, default=0.2)
    parser.add_argument("-encoder_type", default="tdnn",
                        choices=["tdnn", "banded", "blstm", "conformer",
                                 "tdnnf"],
                        help="encoder family (models/transformer.py, "
                             "models/encoders.py)")
    parser.add_argument("-conformer_stream_dtype", default="float32",
                        choices=["float32", "bfloat16"],
                        help="Conformer residual-stream dtype (the "
                             "conformer recipe's default is bfloat16); "
                             "compute stays float32")
    parser.add_argument("-seed", type=int, default=0)
    parser.add_argument("-init_compat", default="native",
                        choices=["native", "torch"],
                        help="'torch' reproduces the reference's init "
                             "distributions (torch-default FFN convs + "
                             "uniform biases)")
    parser.add_argument("-save_model_file", required=True)
    opt = parser.parse_args(argv)

    cfg = build_config(opt)
    info("model will initialized with arguments:\n\t%s.", cfg)

    if opt.lda_mat_file in ("", "none", "identity"):
        lda_mat = None
    else:
        lda_mat = kaldi_io.read_mat(opt.lda_mat_file)
    generator = torch.Generator().manual_seed(opt.seed)
    params = init_transformer(generator, cfg, lda_mat,
                              init_compat=opt.init_compat)
    save_checkpoint(opt.save_model_file, params, cfg, epoch=0)
    info("initialized model is saved to %s.", opt.save_model_file)
    return 0


if __name__ == "__main__":
    log_startup()
    raise SystemExit(main())
