"""The ``blstm`` and ``tdnnf`` encoders and ``semi_orthogonal_step`` of the
port against the JAX package's, on the CPU, with the JAX parameters carried
over by ``params_from_jax``.

Size: 2 layers, d_model 32 (the BLSTM 16 units each way), a batch of 3
whose last row is padded.  Tolerances (float32; the packages sum in other
orders): encoder outputs within ENC_ATOL, padded frames included (the
BLSTM's there are the state JAX's carry freezes); one train step's loss
within LOSS_RTOL relative and every gradient within GRAD_RTOL of its leaf's
largest entry; ``semi_orthogonal_step`` within SEMI_ORTH_ATOL.  The
``tdnnf`` in bfloat16 compute is held to JAX compiled with
``xla_allow_excess_precision`` off by the rule
tests/test_torch_bf16_compute.py holds the ``tdnn`` to (GATE).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_kaldi_asr_tpu.models.encoders import (
    semi_orthogonal_step as jax_semi_orthogonal_step,
)
from pytorch_kaldi_asr_tpu.models.transformer import (
    encode as jax_encode,
    transformer_forward as jax_forward,
)
from pytorch_kaldi_asr_tpu.train import (
    create_train_state as jax_state,
    cross_entropy_loss as jax_ce,
    make_train_step,
)
from pytorch_kaldi_asr_tpu_torch.models import transformer as pt
from pytorch_kaldi_asr_tpu_torch.models.encoders import semi_orthogonal_step
from pytorch_kaldi_asr_tpu_torch.train import create_train_state, train_step
from pytorch_kaldi_asr_tpu_torch.train.optim import named_leaves
from tests.test_torch_bf16_stream import GATE, _exact, _ratio
from tests.torch_port_helpers import configs, jax_params, leaves, t

torch.set_num_threads(1)

ENC_ATOL = 1e-5
LOSS_RTOL = 1e-6
GRAD_RTOL = 1e-5  # of the largest |gradient| of the leaf
SEMI_ORTH_ATOL = 1e-6

ZOO = {"blstm": dict(encoder_type="blstm"),
       "tdnnf": dict(encoder_type="tdnnf", tdnnf_bottleneck=8)}


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(3, 14, cfg.src_dim)).astype(np.float32)
    src_mask = np.ones((3, 14), np.uint8)
    src_mask[2, 9:] = 0
    tgt = np.array([[2, 4, 5, 6, 3, 0], [2, 6, 7, 8, 3, 0],
                    [2, 5, 4, 3, 0, 0]], np.int32)
    return src, src_mask, tgt, (tgt != 0).astype(np.uint8)


@pytest.mark.parametrize("model", list(ZOO))
def test_encoder_matches_jax_and_tree_carries(model):
    """The JAX tree carried over leaf for leaf (the port's own init draws
    the same shapes), and the encoder output, padded frames included."""
    jcfg, pcfg = configs(**ZOO[model])
    jparams, params = jax_params(jcfg, seed=1)
    own = pt.init_transformer(torch.Generator().manual_seed(0), pcfg)
    assert [tuple(x.shape) for x in leaves(own)] == \
        [tuple(x.shape) for x in leaves(params)] == \
        [tuple(np.shape(x)) for x in jax.tree_util.tree_leaves(jparams)]
    if model == "blstm":
        assert set(params["encoder"]["layers"][1]) == {"fwd", "bwd"}
        assert set(params["encoder"]["layers"][1]["bwd"]) == {"wx", "wh", "b"}
    else:
        assert set(params["encoder"]["layers"][0]) == {"factor", "up"}
    src, src_mask, _, _ = _batch(jcfg)
    want, _ = jax.jit(lambda p, x, m: jax_encode(p, jcfg, x, m))(
        jparams, src, src_mask)
    got, _ = pt.encode(params, pcfg, t(src), t(src_mask))
    assert got.shape == (3, 14, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ENC_ATOL)


def test_blstm_valid_frames_are_pad_invariant():
    """The padded row's valid frames equal the same utterance encoded
    alone, unpadded: the state freezes on the pads, and the backward
    direction starts from zeros through them.  (The TDNN-F, like the TDNN,
    reads past the end through its splices, as in the JAX package.)"""
    jcfg, pcfg = configs(**ZOO["blstm"])
    _, params = jax_params(jcfg, seed=2)
    src, src_mask, _, _ = _batch(pcfg, seed=3)
    src[2, 9:] = 100.0  # whatever the pads hold
    padded, _ = pt.encode(params, pcfg, t(src), t(src_mask))
    alone, _ = pt.encode(params, pcfg, t(src[2:, :9]), t(src_mask[2:, :9]))
    np.testing.assert_allclose(padded[2, :9].numpy(), alone[0].numpy(),
                               atol=1e-6)


@pytest.mark.parametrize("model", list(ZOO))
def test_one_train_step_matches_jax(model):
    """One step at dropout 0 against JAX's ``make_train_step``: the loss,
    the token counts and every gradient leaf."""
    jcfg, pcfg = configs(**ZOO[model])
    jparams, params = jax_params(jcfg, seed=3)
    batch = _batch(jcfg, seed=4)
    src, src_mask, tgt, tgt_mask = (jnp.asarray(x) for x in batch)

    def jax_loss(p):
        logits = jax_forward(p, jcfg, src, src_mask, tgt[:, :-1],
                             tgt_mask[:, :-1], train=True, rng=None)
        return jax_ce(logits, tgt[:, 1:])[0]

    jgrads = jax.tree_util.tree_leaves(jax.jit(jax.grad(jax_loss))(jparams))
    jstate, tx = jax_state(jparams, start_lr=0.01, soft_coefficient=2.0)
    _, jm = make_train_step(jcfg, tx, donate=False)(jstate, *batch)
    state = create_train_state(params, start_lr=0.01, soft_coefficient=2.0)
    m = train_step(state, pcfg, *(t(x) for x in batch))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    assert float(m["n_correct"]) == float(jm["n_correct"])
    assert float(m["n_words"]) == float(jm["n_words"])
    for (path, leaf), g in zip(named_leaves(state.params), jgrads):
        g = np.asarray(g)
        np.testing.assert_allclose(leaf.grad.numpy(), g,
                                   atol=GRAD_RTOL * max(np.abs(g).max(),
                                                        1e-30),
                                   err_msg=str(path))


def test_tdnnf_bf16_compute_matches_jax():
    """``compute_dtype=bfloat16``: the encoder output within GATE of
    bfloat16 compute's own error (JAX bfloat16 against JAX float32)."""
    j32, p32 = configs(**ZOO["tdnnf"])
    j16 = j32.replace(compute_dtype=jnp.bfloat16)
    p16 = p32.replace(compute_dtype="bfloat16")
    jparams, params = jax_params(j32, seed=5)
    src, src_mask, _, _ = _batch(j32, seed=6)

    def enc(cfg):
        return lambda p, x, m: jax_encode(p, cfg, x, m, train=True)[0]

    want16 = _exact(enc(j16), jparams, src, src_mask)
    want32 = jax.jit(enc(j32))(jparams, src, src_mask)
    got, _ = pt.encode(params, p16, t(src), t(src_mask), train=True)
    assert got.dtype == torch.float32
    ratio = _ratio(got, want16, want32)
    assert ratio < GATE, ratio


def test_semi_orthogonal_step_matches_jax():
    """Every ``factor`` (tall, and a wide one) moved as JAX moves it; the
    other leaves untouched."""
    jcfg, _ = configs(**ZOO["tdnnf"])
    jparams, params = jax_params(jcfg, seed=7)
    rng = np.random.default_rng(8)
    wide = rng.normal(size=(4, 9)).astype(np.float32)
    jparams = dict(jparams, extra={"factor": jnp.asarray(wide)})
    params = dict(params, extra={"factor": t(wide)})
    want = jax.jit(jax_semi_orthogonal_step)(jparams)
    got = semi_orthogonal_step(params)
    for (path, a), b in zip(named_leaves(got),
                            jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   atol=SEMI_ORTH_ATOL, err_msg=str(path))
    moved = {path for (path, a), (_, b) in zip(named_leaves(got),
                                               named_leaves(params))
             if not torch.equal(a, b)}
    assert moved == {("encoder", "layers", 0, "factor"),
                     ("encoder", "layers", 1, "factor"), ("extra", "factor")}
