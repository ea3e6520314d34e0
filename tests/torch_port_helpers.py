"""Shared setup of the tests that hold the PyTorch port
(pytorch_kaldi_asr_tpu_torch) against the JAX package: one set of small
hyperparameters built into both packages' configs, the JAX parameter tree
carried over to the port, and a tiny Kaldi data dir for the CLIs."""

import numpy as np
import torch

from pytorch_kaldi_asr_tpu.io.kaldi_io import ArkWriter
from pytorch_kaldi_asr_tpu.models.transformer import (
    TransformerConfig as JaxConfig,
)
from pytorch_kaldi_asr_tpu_torch.models.transformer import (
    TransformerConfig as PortConfig,
)


def small_kwargs(**kw):
    """tests/test_models.py::small_cfg's sizes; banded encoder by default."""
    base = dict(
        src_dim=13,
        vocab_size=11,
        encoder_max_len=32,
        decoder_max_len=16,
        encoder_sub_sequence=(-8, 0),
        decoder_sub_sequence=(-3, 0),
        en_layers=2,
        de_layers=2,
        n_head=2,
        en_d_model=32,
        de_d_model=16,
        d_k=8,
        d_v=8,
        en_dropout=0.0,
        de_dropout=0.0,
        tdnn_contexts=((-1, 0, 1), (-3, 0, 3)),
        encoder_type="banded",
    )
    base.update(kw)
    return base


def configs(**kw):
    """(JAX config, port config) with the same fields."""
    kwargs = small_kwargs(**kw)
    return JaxConfig(**kwargs), PortConfig(**kwargs)


def jax_params(cfg, seed=0):
    """JAX-initialized parameters as (JAX tree, port tree).  The JAX init
    runs under ``jax.jit`` (one compile instead of one per op; same draws)."""
    import jax

    from pytorch_kaldi_asr_tpu.models.transformer import init_transformer
    from pytorch_kaldi_asr_tpu_torch.train.checkpoint import params_from_jax

    init = jax.jit(init_transformer, static_argnums=1)
    params = init(jax.random.PRNGKey(seed), cfg)
    return params, params_from_jax(jax.device_get(params))


def source_batch(cfg, b=3, s=20, seed=0, short_row=12):
    """Features [B, S, src_dim] and a mask whose last row is padded after
    ``short_row`` frames, as numpy."""
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(b, s, cfg.src_dim)).astype(np.float32)
    mask = np.ones((b, s), np.uint8)
    mask[b - 1, short_row:] = 0
    return src, mask


def leaves(tree):
    """Tensor leaves of a port tree in JAX's flattening order (dict keys
    sorted, lists in order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def t(a):
    """numpy → CPU tensor (int arrays become int64 for indexing)."""
    a = np.asarray(a)
    if a.dtype.kind in "iu" and a.dtype != np.uint8:
        a = a.astype(np.int64)
    return torch.from_numpy(np.array(a))  # a writable copy


def write_data_dir(path, *, n_utts=6, feat_dim=13, n_words=7, seed=0,
                   lengths=(9, 24)):
    """A tiny Kaldi data dir: feats.ark/scp, text and vocab.txt (4 control
    words + ``n_words``), written with the JAX package's ArkWriter."""
    rng = np.random.default_rng(seed)
    path.mkdir(parents=True, exist_ok=True)
    words = [f"w{i}" for i in range(n_words)]
    with open(path / "vocab.txt", "w") as f:
        for i, w in enumerate(["<blank>", "<unk>", "<s>", "</s>"] + words):
            f.write(f"{w} {i}\n")
    with ArkWriter(str(path / "feats.ark"), str(path / "feats.scp")) as ark, \
            open(path / "text", "w") as text:
        for u in range(n_utts):
            n = int(rng.integers(lengths[0], lengths[1] + 1))
            ark.write(f"utt{u}", rng.normal(size=(n, feat_dim))
                      .astype(np.float32))
            label = rng.choice(words, size=int(rng.integers(1, 5)))
            text.write(f"utt{u} " + " ".join(label) + "\n")
    return path

