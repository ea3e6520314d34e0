"""The port's conformer (models/encoders.py) against the JAX package's, on
the CPU, with the JAX parameters carried over by ``params_from_jax``.

Size: 2 layers, d_model 32, 2 heads, d_k = d_v = 16, conv kernel 5, encoder
band (-8, 8), a padded row, centered and causal conv.  Tolerances (float32;
the packages sum in other orders): encoder output and logits 1e-5
absolute; three train steps at dropout 0 as slice 2's (loss 1e-6
relative, gradients 1e-5 of the leaf's largest entry, parameters 1e-5);
n-best scores 1e-4.  The JAX conformer attends through its blocked XLA
banded op, the port through the banded-attention kernels' plain versions:
the same function at dropout 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_kaldi_asr_tpu.models.encoders import (
    conformer_encode as jax_conformer_encode,
)
from pytorch_kaldi_asr_tpu.models.transformer import (
    transformer_forward as jax_forward,
)
from pytorch_kaldi_asr_tpu.recipes import decode as jax_decode
from pytorch_kaldi_asr_tpu.recipes import initialize_model as jax_init_cli
from pytorch_kaldi_asr_tpu.train import (
    create_train_state as jax_state,
    cross_entropy_loss as jax_ce,
    make_train_step,
)
from pytorch_kaldi_asr_tpu_torch.models import transformer as pt
from pytorch_kaldi_asr_tpu_torch.models.encoders import conformer_encode
from pytorch_kaldi_asr_tpu_torch.ops import fused_dropout as fd
from pytorch_kaldi_asr_tpu_torch.recipes import decode
from pytorch_kaldi_asr_tpu_torch.train import create_train_state, train_step
from pytorch_kaldi_asr_tpu_torch.train.optim import named_leaves
from tests.torch_port_helpers import (
    configs,
    jax_params,
    leaves,
    source_batch,
    t,
    write_data_dir,
)

torch.set_num_threads(1)

ATOL = 1e-5
LOSS_RTOL = 1e-6
GRAD_RTOL = 1e-5  # of the largest |gradient| of the leaf
PARAM_ATOL = 1e-5
SCORE_ATOL = 1e-4


def conformer_configs(**kw):
    base = dict(encoder_type="conformer", en_d_model=32, de_d_model=16,
                n_head=2, d_k=16, d_v=16, conformer_kernel=5,
                encoder_sub_sequence=(-8, 8))
    base.update(kw)
    return configs(**base)


CAUSAL = pytest.mark.parametrize("causal", [False, True],
                                 ids=["centered", "causal"])


@CAUSAL
def test_conformer_encode_matches_jax(causal):
    jcfg, pcfg = conformer_configs(conformer_causal_conv=causal)
    jparams, params = jax_params(jcfg, seed=1)
    src, mask = source_batch(jcfg, s=20, short_row=13)
    fn = jax.jit(lambda p, x, m: jax_conformer_encode(p, jcfg, x, m))
    want, want_mask = fn(jparams["encoder"], src, mask)
    got, got_mask = conformer_encode(params["encoder"], pcfg, t(src), t(mask))
    assert got.shape == (3, 20, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))


@CAUSAL
def test_conformer_logits_match_jax(causal):
    jcfg, pcfg = conformer_configs(conformer_causal_conv=causal)
    jparams, params = jax_params(jcfg, seed=2)
    src, mask = source_batch(jcfg, s=20, seed=2)
    rng = np.random.default_rng(2)
    tgt = rng.integers(1, jcfg.vocab_size, size=(3, 7)).astype(np.int32)
    tgt_mask = np.ones((3, 7), np.uint8)
    tgt_mask[1, 4:] = 0
    want = np.asarray(jax.jit(jax_forward, static_argnums=1)(
        jparams, jcfg, src, mask, tgt, tgt_mask))
    got = pt.transformer_forward(params, pcfg, t(src), t(mask), t(tgt),
                                 t(tgt_mask)).numpy()
    assert got.shape == want.shape == (3, 7, jcfg.vocab_size)
    np.testing.assert_allclose(got, want, atol=ATOL)


def _batch(cfg, b=4, s=18, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(b, s, cfg.src_dim)).astype(np.float32)
    src_mask = np.ones((b, s), np.uint8)
    src_mask[3, 11:] = 0
    tgt = np.array([[2, 4, 5, 6, 3, 0], [2, 6, 7, 8, 3, 0],
                    [2, 5, 4, 3, 0, 0], [2, 7, 3, 0, 0, 0]], np.int32)[:b]
    return src, src_mask, tgt, (tgt != 0).astype(np.uint8)


@CAUSAL
def test_three_conformer_train_steps_match_jax(causal):
    jcfg, pcfg = conformer_configs(conformer_causal_conv=causal)
    jparams, params = jax_params(jcfg, seed=3)
    batch = _batch(jcfg)
    src, src_mask, tgt, tgt_mask = (jnp.asarray(x) for x in batch)

    def jax_loss(p):
        logits = jax_forward(p, jcfg, src, src_mask, tgt[:, :-1],
                             tgt_mask[:, :-1], train=True,
                             rng=jax.random.PRNGKey(1))
        return jax_ce(logits, tgt[:, 1:])[0]

    jgrads = jax.jit(jax.grad(jax_loss))(jparams)
    jstate, tx = jax_state(jparams, start_lr=0.01, soft_coefficient=2.0)
    jstep = make_train_step(jcfg, tx, donate=False)
    state = create_train_state(params, start_lr=0.01, soft_coefficient=2.0)
    for i in range(3):
        jstate, jm = jstep(jstate, *batch)
        m = train_step(state, pcfg, *(t(x) for x in batch))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
        assert float(m["n_correct"]) == float(jm["n_correct"])
        if i == 0:
            for (path, leaf), g in zip(named_leaves(state.params),
                                       jax.tree_util.tree_leaves(jgrads)):
                g = np.asarray(g)
                np.testing.assert_allclose(
                    leaf.grad.numpy(), g,
                    atol=GRAD_RTOL * max(np.abs(g).max(), 1e-30),
                    err_msg=str(path))
    for a, b in zip(leaves(state.params),
                    jax.tree_util.tree_leaves(jstate.params)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=PARAM_ATOL)


def test_conformer_trains_with_dropout_through_the_fused_dropout_path():
    """Dropout on: each train step draws its masks from the step's seeds,
    so two runs from the same state agree exactly, the loss differs from
    the dropout-off loss, and no kernel launches on the CPU."""
    _, pcfg = conformer_configs(en_dropout=0.1, de_dropout=0.1)
    _, params = jax_params(conformer_configs()[0], seed=4)
    batch = [t(x) for x in _batch(pcfg)]
    launches = dict(fd.fused_dropout.launches)
    losses = []
    for cfg in (pcfg, pcfg, pcfg.replace(en_dropout=0.0, de_dropout=0.0)):
        state = create_train_state(pt.tree_map(torch.clone, params), seed=9)
        losses.append(float(train_step(state, cfg, *batch)["loss"]))
    assert np.isfinite(losses).all()
    assert losses[0] == losses[1] != losses[2]
    assert fd.fused_dropout.launches == launches


MODEL_FLAGS = [
    "-encoder_max_len", "48", "-decoder_max_len", "12",
    "-encoder_sub_sequence", "(-8,8)", "-decoder_sub_sequence", "(-3,0)",
    "-en_layers", "2", "-de_layers", "2", "-n_head", "2",
    "-en_d_model", "32", "-de_d_model", "16", "-d_k", "16", "-d_v", "16",
    "-en_dropout", "0.1", "-de_dropout", "0.1", "-encoder_type", "conformer",
    "-lda_mat_file", "none",
]
DECODE_FLAGS = ["-batch_size", "4", "-num_buckets", "2", "-beam_size", "4",
                "-nbest", "3", "-max_token_seq_len", "10"]


def test_port_decode_of_a_conformer_matches_jax_decode(tmp_path):
    data = write_data_dir(tmp_path / "data", n_utts=7, seed=5,
                          lengths=(10, 30))
    model = tmp_path / "model"
    assert jax_init_cli.main([
        "-read_feats_scp_file", str(data / "feats.scp"), "-read_vocab_file",
        str(data / "vocab.txt"), "-seed", "2", "-save_model_file",
        str(model), *MODEL_FLAGS]) == 0
    args = ["-read_data_dir", str(data), "-read_vocab_file",
            str(data / "vocab.txt"), "-load_model_file", str(model),
            *DECODE_FLAGS]
    assert jax_decode.main(args + ["-save_result_file",
                                   str(tmp_path / "jax.txt")]) == 0
    assert decode.main(args + ["-save_result_file", str(tmp_path / "port.txt"),
                               "-device", "cpu"]) == 0
    want = [line.split("\t") for line in open(tmp_path / "jax.txt")]
    got = [line.split("\t") for line in open(tmp_path / "port.txt")]
    assert len(got) == len(want) == 7 * 3
    for (gk, gs, gw), (wk, ws, ww) in zip(got, want):
        assert (gk, gw) == (wk, ww)
        assert abs(float(gs) - float(ws)) <= SCORE_ATOL


def test_bfloat16_conformer_stream_is_refused():
    """Nothing bfloat16 is refused now: the bfloat16 residual stream runs
    (tests/test_torch_bf16_stream.py), and so does bfloat16 compute
    (tests/test_torch_bf16_compute.py); other dtypes are refused."""
    assert conformer_configs(compute_dtype="bfloat16")[1].compute_dtype == \
        "bfloat16"
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        conformer_configs(compute_dtype="float16")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        conformer_configs(conformer_stream_dtype="float16")
    # the stream dtype is the conformer's alone: other encoders ignore it
    assert configs(conformer_stream_dtype="bfloat16")[1].encoder_type == \
        "banded"
