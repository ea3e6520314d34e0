"""The port's model code (models/common.py, transformer.py, encoders.py)
against the JAX package's on the same numpy inputs and the same JAX-made
parameters, float32, dropout off.  Tolerance: atol 1e-5 (float32 sums in
another order), exact where the function has no arithmetic."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from pytorch_kaldi_asr_tpu.models import common as jc
from pytorch_kaldi_asr_tpu.models.transformer import (
    encode,
    transformer_forward,
)
from pytorch_kaldi_asr_tpu_torch.models import common as pc
from pytorch_kaldi_asr_tpu_torch.models import transformer as pt
from tests.torch_port_helpers import (
    configs,
    jax_params,
    leaves,
    source_batch,
    t,
)

torch.set_num_threads(1)

ATOL = 1e-5

# the JAX side under jit: one compile per config instead of one per op
jax_encode = jax.jit(encode, static_argnums=1)
jax_forward = jax.jit(transformer_forward, static_argnums=1)


def test_position_table_is_bit_identical():
    for n, d in [(500, 256), (100, 128), (7, 6)]:
        ours = pc.position_encoding_table(n, d).numpy()
        np.testing.assert_array_equal(ours,
                                      np.asarray(jc.position_encoding_table(n, d)))
        assert (ours[0] == 0).all()


@pytest.mark.parametrize("start,end", [(-2, 0), (-3, 2), (0, 0)])
def test_masks_are_identical(start, end):
    np.testing.assert_array_equal(pc.banded_attn_mask(9, start, end).numpy(),
                                  np.asarray(jc.banded_attn_mask(9, start, end)))
    mq = np.array([[1, 1, 1, 0], [1, 0, 0, 0]], np.uint8)
    mk = np.array([[1, 1, 0], [1, 0, 0]], np.uint8)
    np.testing.assert_array_equal(pc.padding_attn_mask(t(mq), t(mk)).numpy(),
                                  np.asarray(jc.padding_attn_mask(mq, mk)))


@pytest.mark.parametrize("fold", [1, 2, 3])
def test_fold_seq_and_mask(fold):
    rng = np.random.default_rng(fold)
    seq = rng.normal(size=(2, 11, 5)).astype(np.float32)
    mask = (rng.random((2, 11)) > 0.3).astype(np.uint8)
    ps, pm = pc.fold_seq_and_mask(t(seq), t(mask), fold)
    js, jm = jc.fold_seq_and_mask(seq, mask, fold)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))


def test_masked_softmax_zero_rows():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 4, 6)).astype(np.float32) * 4
    blocked = rng.random((3, 4, 6)) > 0.5
    blocked[1, 2, :] = True  # fully masked row
    ours = pc.masked_softmax(t(logits), t(blocked)).numpy()
    np.testing.assert_allclose(ours, np.asarray(jc.masked_softmax(logits, blocked)),
                               atol=1e-6)
    assert (ours[1, 2] == 0).all() and np.isfinite(ours).all()


@pytest.mark.parametrize("length", [1, 5])
def test_layer_norm_unbiased_std_and_len1_skip(length):
    rng = np.random.default_rng(length)
    z = rng.normal(size=(2, length, 8)).astype(np.float32) * 3
    z[0, 0] = 1.25  # a constant row: zero variance
    gamma = rng.normal(size=8).astype(np.float32)
    beta = rng.normal(size=8).astype(np.float32)
    for skip in (True, False):
        ours = pc.layer_norm(t(z), t(gamma), t(beta), skip_len1=skip).numpy()
        np.testing.assert_allclose(
            ours, np.asarray(jc.layer_norm(z, gamma, beta, skip_len1=skip)),
            atol=ATOL)


@pytest.mark.parametrize("context", [(-2, -1, 0, 1, 2), (-3, 0, 3), (0,),
                                     (-1, 0, 2)])
def test_spliced_linear(context):
    rng = np.random.default_rng(len(context))
    x = rng.normal(size=(2, 9, 4)).astype(np.float32)
    w = rng.normal(size=(4 * len(context), 6)).astype(np.float32)
    b = rng.normal(size=6).astype(np.float32)
    np.testing.assert_allclose(
        pc.spliced_linear(t(x), t(w), t(b), context).numpy(),
        np.asarray(jc.spliced_linear(x, w, b, context)), atol=ATOL)


@pytest.mark.parametrize("encoder_type", ["banded", "tdnn"])
def test_encode_matches_jax(encoder_type):
    jcfg, pcfg = configs(encoder_type=encoder_type)
    jparams, params = jax_params(jcfg, seed=1)
    src, mask = source_batch(jcfg, s=20)
    j_out, j_mask = jax_encode(jparams, jcfg, src, mask)
    p_out, p_mask = pt.encode(params, pcfg, t(src), t(mask))
    np.testing.assert_allclose(p_out.numpy(), np.asarray(j_out), atol=ATOL)
    np.testing.assert_array_equal(p_mask.numpy(), np.asarray(j_mask))


@pytest.mark.parametrize("encoder_type", ["banded", "tdnn"])
def test_transformer_forward_logits_match_jax(encoder_type):
    jcfg, pcfg = configs(encoder_type=encoder_type)
    jparams, params = jax_params(jcfg, seed=2)
    src, mask = source_batch(jcfg, s=20, seed=2)
    rng = np.random.default_rng(2)
    tgt = rng.integers(1, jcfg.vocab_size, size=(3, 7)).astype(np.int32)
    tgt_mask = np.ones((3, 7), np.uint8)
    tgt_mask[1, 4:] = 0
    want = np.asarray(jax_forward(jparams, jcfg, src, mask, tgt, tgt_mask))
    got = pt.transformer_forward(params, pcfg, t(src), t(mask), t(tgt),
                              t(tgt_mask)).numpy()
    assert got.shape == want.shape == (3, 7, jcfg.vocab_size)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_port_init_matches_jax_tree_and_distributions():
    """Same tree shapes as the JAX init; xavier stds, zero embedding row 0,
    no word_proj bias (draws differ: another generator)."""
    from pytorch_kaldi_asr_tpu.models.transformer import (
        init_transformer as jax_init,
    )

    jcfg, pcfg = configs(en_d_model=64, de_d_model=32)
    params = pt.init_transformer(torch.Generator().manual_seed(0), pcfg)
    jparams = jax.eval_shape(lambda key: jax_init(key, jcfg),
                             jax.random.PRNGKey(0))
    assert [tuple(x.shape) for x in leaves(params)] == \
        [tuple(x.shape) for x in jax.tree_util.tree_leaves(jparams)]
    dec = params["decoder"]
    assert (dec["embed"][0] == 0).all()
    assert set(dec["word_proj"]) == {"w"}
    w = params["encoder"]["layers"][0]["ffn"]["w1"]["w"]
    assert abs(float(w.std()) - np.sqrt(2.0 / (64 + 64))) < 0.02


def test_unported_encoder_raises_with_roadmap_item():
    cfg = pt.TransformerConfig(**dataclasses.asdict(configs()[1]) | {
        "encoder_type": "conformer"})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pt.init_transformer(torch.Generator().manual_seed(0), cfg)
