"""The conformer's bfloat16 residual stream (the conformer-librispeech
recipe's default) in the port against the JAX package on the CPU, with the
JAX parameters carried over by ``params_from_jax``.

Size: 2 layers, d_model 32, 2 heads, d_k = d_v = 16, conv kernel 5, band
(-8, 8), a padded row.

The reference is the JAX package's code compiled by XLA with
``xla_allow_excess_precision`` off, so that every bfloat16 rounding its
code writes happens.  With the option on (XLA's default) the CPU compile
keeps some sums of the stream in float32 inside its fusions, and moves its
own result by 0.76-1.26 times the stream's whole bfloat16 error (mean
absolute difference over that of bfloat16 from float32, 5 seeds,
tests/bf16_stream_ratios.py).  No port can be gated against that.

The gate: the mean absolute difference between the port and JAX in
bfloat16 must be under half the mean absolute difference between JAX in
bfloat16 and JAX in float32, the error the bfloat16 stream itself makes.
The mean and not the largest entry: one bfloat16 rounding that goes the
other way on a float32 summation order (one ulp of bfloat16 at the output's
largest entry is already that whole difference) would decide a
largest-entry gate.  Measured over 5 seeds: encoder output 0 to 0.12,
logits 1.3e-4 to 0.20 (largest-entry ratios 0 to 0.80 and 0.39; PERF.md).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_kaldi_asr_tpu.decode.fast_beam import (
    fast_beam_search as jax_search,
)
from pytorch_kaldi_asr_tpu.models.common import (
    dropout as jax_dropout,
    layer_norm as jax_layer_norm,
)
from pytorch_kaldi_asr_tpu.models.encoders import (
    conformer_encode as jax_conformer_encode,
)
from pytorch_kaldi_asr_tpu.models.transformer import (
    transformer_forward as jax_forward,
)
from pytorch_kaldi_asr_tpu.recipes import initialize_model as jax_init_cli
from pytorch_kaldi_asr_tpu.train import (
    create_train_state as jax_state,
    cross_entropy_loss as jax_ce,
    load_checkpoint as jax_load_checkpoint,
    make_train_step,
)
from pytorch_kaldi_asr_tpu_torch.data import read_vocab
from pytorch_kaldi_asr_tpu_torch.data.loader import make_batch_loader
from pytorch_kaldi_asr_tpu_torch.decode.fast_beam import fast_beam_search
from pytorch_kaldi_asr_tpu_torch.models import transformer as pt
from pytorch_kaldi_asr_tpu_torch.models.common import dropout, layer_norm
from pytorch_kaldi_asr_tpu_torch.models.encoders import conformer_encode
from pytorch_kaldi_asr_tpu_torch.ops import fused_dropout as fd
from pytorch_kaldi_asr_tpu_torch.recipes import initialize_model
from pytorch_kaldi_asr_tpu_torch.train import (
    create_train_state,
    load_checkpoint,
    train_step,
)
from tests.torch_port_helpers import (
    configs,
    jax_params,
    leaves,
    source_batch,
    t,
    write_data_dir,
)

torch.set_num_threads(1)

GATE = 0.5  # of the bfloat16 stream's own mean error
EXACT = {"xla_allow_excess_precision": False}
BF16 = torch.bfloat16


def _configs(**kw):
    """(JAX float32, JAX bfloat16, port float32, port bfloat16) configs."""
    base = dict(encoder_type="conformer", en_d_model=32, de_d_model=16,
                n_head=2, d_k=16, d_v=16, conformer_kernel=5,
                encoder_sub_sequence=(-8, 8))
    base.update(kw)
    jcfg, pcfg = configs(**base)
    return (jcfg, jcfg.replace(conformer_stream_dtype=jnp.bfloat16), pcfg,
            pcfg.replace(conformer_stream_dtype="bfloat16"))


def _exact(fn, *args):
    """``jax.jit(fn)`` on ``args``, compiled with every bfloat16 rounding
    kept, and run."""
    return jax.jit(fn).lower(*args).compile(compiler_options=EXACT)(*args)


def _f32(x):
    x = x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.astype(np.float64)


def _ratio(port, jax_bf16, jax_f32):
    """mean |port - JAX bfloat16| over mean |JAX bfloat16 - JAX float32|."""
    port, j16, j32 = _f32(port), _f32(jax_bf16), _f32(jax_f32)
    return np.abs(port - j16).mean() / np.abs(j16 - j32).mean()


# ---------------------------------------------------------------------------
# layer norm and dropout on bfloat16
# ---------------------------------------------------------------------------


def _ulps(a, b):
    """bfloat16 ulps between two bfloat16 tensors of the same sign."""
    return (a.view(torch.int16).int() - b.view(torch.int16).int()).abs()


@pytest.mark.parametrize("shape", [(3, 20, 48), (2, 7, 256)])
def test_layer_norm_on_bf16_matches_jax_one_pass(shape):
    """Equal to JAX's one-pass form in bfloat16, but where the two float32
    statistics round differently, and there by one ulp at most."""
    rng = np.random.default_rng(shape[-1])
    z32 = (rng.normal(size=shape) * 3 + 1).astype(np.float32)
    gamma = rng.normal(size=shape[-1]).astype(np.float32)
    beta = rng.normal(size=shape[-1]).astype(np.float32)
    z = torch.from_numpy(z32).to(BF16)
    want = jax.jit(lambda z: jax_layer_norm(z, gamma, beta, skip_len1=False))(
        jnp.asarray(z32).astype(jnp.bfloat16))
    got = layer_norm(z, t(gamma), t(beta), skip_len1=False)
    assert got.dtype == BF16
    want = torch.from_numpy(np.asarray(want).astype(np.float32)).to(BF16)
    same_sign = (got.float() * want.float()) > 0
    assert bool(((got == want) | same_sign).all())
    assert int(_ulps(got, want)[same_sign].max()) <= 1
    assert float((got != want).float().mean()) < 0.02
    # the length-1 skip
    one = z[:, :1]
    assert layer_norm(one, t(gamma), t(beta)) is one


def test_layer_norm_on_float32_keeps_the_two_pass_form():
    rng = np.random.default_rng(1)
    z = t(rng.normal(size=(2, 9, 32)).astype(np.float32))
    gamma, beta = t(rng.normal(size=32)), t(rng.normal(size=32))
    gamma, beta = gamma.float(), beta.float()
    mu = z.mean(dim=-1, keepdim=True)
    var = ((z - mu) ** 2).sum(dim=-1, keepdim=True) / 31
    want = (z - mu) / (torch.sqrt(var) + 1e-3) * gamma + beta
    assert torch.equal(layer_norm(z, gamma, beta), want)


@pytest.mark.parametrize("rate,scale", [(0.1, 1.109375), (0.35, 1.5390625)])
def test_bf16_dropout_matches_jax_keep_rate_and_rounded_scale(rate, scale):
    """On bfloat16 the JAX package scales by 256/q as a weak-typed Python
    float, which bfloat16 arithmetic rounds to bfloat16 (1.109375, not
    1.1130, at rate 0.1): kept values are bf16(x * bf16(256/q)) in both
    packages, and both keep q/256 of the elements."""
    q = round((1 - rate) * 256)
    assert float(torch.tensor(256 / q, dtype=BF16)) == scale
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(300, 256))
                         .astype(np.float32)).to(BF16)
    want_kept = (x.float() * scale).to(BF16)
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    jout = jax.jit(lambda x, k: jax_dropout(x, rate, k, True))(
        jx, jax.random.PRNGKey(0))
    assert jout.dtype == jnp.bfloat16
    jout = torch.from_numpy(np.asarray(jout).astype(np.float32)).to(BF16)
    out = dropout(x, rate, 77, True)
    assert out.dtype == BF16
    sigma = 3 * np.sqrt(q / 256 * (1 - q / 256) / x.numel())
    for got in (out, jout):
        kept = got != 0
        assert abs(float(kept.float().mean()) - q / 256) < sigma
        assert torch.equal(got[kept], want_kept[kept])


def test_bf16_mask_is_the_float32_mask_and_backward_reuses_it():
    """The mask is a function of the seed and the flat index alone: the
    bfloat16 pass drops exactly the float32 pass's elements, and its
    gradient is the same pass on the cotangent."""
    x32 = torch.from_numpy(np.random.default_rng(4).normal(size=(64, 40))
                           .astype(np.float32))
    x = x32.to(BF16).requires_grad_()
    threshold, scale = (256 - 230) << 24, 1.109375
    out = fd.masked_dropout(x, 9, threshold, scale)
    ref32 = fd.fused_dropout_reference(x32, 9, threshold, scale)
    assert torch.equal(out != 0, ref32 != 0)
    g = torch.from_numpy(np.random.default_rng(5).normal(size=(64, 40))
                         .astype(np.float32)).to(BF16)
    out.backward(g)
    assert x.grad.dtype == BF16
    assert torch.equal(x.grad, fd.fused_dropout_reference(g, 9, threshold,
                                                          scale))
    assert torch.equal(x.grad != 0, out != 0)


# ---------------------------------------------------------------------------
# the conformer with a bfloat16 stream
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(5))
def test_bf16_encoder_and_logits_match_jax(seed):
    j32, j16, p32, p16 = _configs()
    jparams, params = jax_params(j32, seed=seed)
    src, mask = source_batch(j32, s=20, seed=seed, short_row=13)
    enc16 = _exact(lambda p, x, m: jax_conformer_encode(p, j16, x, m)[0],
                   jparams["encoder"], src, mask)
    enc32 = jax.jit(lambda p, x, m: jax_conformer_encode(p, j32, x, m)[0])(
        jparams["encoder"], src, mask)
    got, _ = conformer_encode(params["encoder"], p16, t(src), t(mask))
    assert got.dtype == BF16 and enc16.dtype == jnp.bfloat16
    assert _ratio(got, enc16, enc32) < GATE

    rng = np.random.default_rng(seed)
    tgt = rng.integers(1, j32.vocab_size, size=(3, 7)).astype(np.int32)
    tgt_mask = np.ones((3, 7), np.uint8)
    tgt_mask[1, 4:] = 0
    want16 = _exact(lambda p, *a: jax_forward(p, j16, *a), jparams, src,
                    mask, tgt, tgt_mask)
    want32 = jax.jit(lambda p, *a: jax_forward(p, j32, *a))(
        jparams, src, mask, tgt, tgt_mask)
    logits = pt.transformer_forward(params, p16, t(src), t(mask), t(tgt),
                                    t(tgt_mask))
    assert logits.dtype == torch.float32
    assert _ratio(logits, want16, want32) < GATE


def _batch(cfg, b=4, s=18, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(b, s, cfg.src_dim)).astype(np.float32)
    src_mask = np.ones((b, s), np.uint8)
    src_mask[3, 11:] = 0
    tgt = np.array([[2, 4, 5, 6, 3, 0], [2, 6, 7, 8, 3, 0],
                    [2, 5, 4, 3, 0, 0], [2, 7, 3, 0, 0, 0]], np.int32)[:b]
    return src, src_mask, tgt, (tgt != 0).astype(np.uint8)


def _jax_grads(jparams, cfg, batch, exact):
    src, src_mask, tgt, tgt_mask = (jnp.asarray(x) for x in batch)

    def loss(p):
        logits = jax_forward(p, cfg, src, src_mask, tgt[:, :-1],
                             tgt_mask[:, :-1], train=True,
                             rng=jax.random.PRNGKey(1))
        return jax_ce(logits, tgt[:, 1:])[0]

    grad = jax.grad(loss)
    return _exact(grad, jparams) if exact else jax.jit(grad)(jparams)


def _leaf_ratios(port_leaves, jax16, jax32):
    """The relative rule on each leaf; a leaf that bfloat16 leaves exactly
    as in float32 must stay within 1e-6 of it.  Returns the ratios."""
    ratios = []
    for a, b16, b32 in zip(port_leaves, jax.tree_util.tree_leaves(jax16),
                           jax.tree_util.tree_leaves(jax32)):
        a, b16, b32 = _f32(a.detach()), _f32(b16), _f32(b32)
        if np.array_equal(b16, b32):
            np.testing.assert_allclose(a, b16, atol=1e-6)
        else:
            ratios.append(_ratio(a, b16, b32))
    return ratios


def test_three_bf16_train_steps_match_jax():
    """The loss of each of three steps (Adam, dropout 0), every gradient of
    the first and every parameter after the third, each by the relative
    rule against the same steps in float32.  Measured: gradients 1e-4
    (median) to 0.018, parameters 0.043 to 0.25, losses 6e-4 to 0.022."""
    j32, j16, _, p16 = _configs()
    jparams, params = jax_params(j32, seed=3)
    batch = _batch(j32)
    jbatch = tuple(jnp.asarray(x) for x in batch)
    runs = {}
    for name, cfg in (("bf16", j16), ("f32", j32)):
        jstate, tx = jax_state(jparams, start_lr=0.01, soft_coefficient=2.0)
        step = make_train_step(cfg, tx, donate=False)
        if name == "bf16":
            step = step.lower(jstate, *jbatch).compile(compiler_options=EXACT)
        losses = []
        for _ in range(3):
            jstate, m = step(jstate, *jbatch)
            losses.append(float(m["loss"]))
        runs[name] = (jstate.params, losses,
                      _jax_grads(jparams, cfg, batch, name == "bf16"))
    state = create_train_state(params, start_lr=0.01, soft_coefficient=2.0)
    losses, grads = [], None
    for _ in range(3):
        losses.append(float(train_step(state, p16,
                                       *(t(x) for x in batch))["loss"]))
        grads = grads or [leaf.grad.clone() for leaf in leaves(state.params)]
    (params16, l16, g16), (params32, l32, g32) = runs["bf16"], runs["f32"]
    for got, w16, w32 in zip(losses, l16, l32):
        assert abs(got - w16) < GATE * abs(w16 - w32)
    for ratios in (_leaf_ratios(grads, g16, g32),
                   _leaf_ratios(leaves(state.params), params16, params32)):
        assert len(ratios) > 50 and max(ratios) < GATE


MODEL_FLAGS = [
    "-encoder_max_len", "48", "-decoder_max_len", "12",
    "-encoder_sub_sequence", "(-8,8)", "-decoder_sub_sequence", "(-3,0)",
    "-en_layers", "2", "-de_layers", "2", "-n_head", "2",
    "-en_d_model", "32", "-de_d_model", "16", "-d_k", "16", "-d_v", "16",
    "-en_dropout", "0.1", "-de_dropout", "0.1", "-encoder_type", "conformer",
    "-lda_mat_file", "none", "-conformer_stream_dtype", "bfloat16",
]


def test_jax_bf16_checkpoint_encodes_and_decodes_as_in_jax(tmp_path):
    """A checkpoint that the JAX package's initialize_model writes with the
    bfloat16 stream loads in the port with that stream, encodes within the
    gate, and the port's search finds JAX's 1-best on every utterance,
    scores within the gate of their bfloat16-to-float32 difference."""
    data = write_data_dir(tmp_path / "data", n_utts=6, seed=8,
                          lengths=(10, 30))
    model = tmp_path / "model"
    assert jax_init_cli.main([
        "-read_feats_scp_file", str(data / "feats.scp"), "-read_vocab_file",
        str(data / "vocab.txt"), "-seed", "3", "-save_model_file",
        str(model), *MODEL_FLAGS]) == 0
    assert json.loads((model / "config.json").read_text())[
        "conformer_stream_dtype"] == "bfloat16"
    ckpt = load_checkpoint(str(model))
    cfg = ckpt["cfg"]
    assert cfg.conformer_stream_dtype == "bfloat16"
    jck = jax_load_checkpoint(str(model))
    j16 = jck["cfg"]
    j32 = j16.replace(conformer_stream_dtype=jnp.float32)
    loader = make_batch_loader(str(data), read_vocab(str(data / "vocab.txt")),
                               3, mode="all", shuffle=False)
    for batch in loader:
        src, mask = batch.src, batch.src_mask
        enc16 = _exact(lambda p, x, m: jax_conformer_encode(p, j16, x, m)[0],
                       jck["params"]["encoder"], src, mask)
        enc32 = jax.jit(lambda p, x, m: jax_conformer_encode(p, j32, x, m)[0])(
            jck["params"]["encoder"], src, mask)
        enc, _ = conformer_encode(ckpt["params"]["encoder"], cfg, t(src),
                                  t(mask))
        assert enc.dtype == BF16
        assert _ratio(enc, enc16, enc32) < GATE

        def search(cfg):
            return lambda p, x, m: jax_search(p, cfg, x, m, beam_size=4,
                                              max_len=10)

        want16 = _exact(search(j16), jck["params"], src, mask)
        want32 = jax.jit(search(j32))(jck["params"], src, mask)
        got = fast_beam_search(ckpt["params"], cfg, t(src), t(mask),
                               beam_size=4, max_len=10)
        np.testing.assert_array_equal(got.tokens[:, 0].numpy(),
                                      np.asarray(want16.tokens)[:, 0])
        s16, s32 = (np.asarray(w.scores)[:, 0] for w in (want16, want32))
        assert np.all(np.abs(got.scores[:, 0].numpy() - s16)
                      <= GATE * np.maximum(np.abs(s16 - s32), 1e-6))


def test_port_initialize_model_writes_a_bf16_conformer_jax_loads(tmp_path):
    data = write_data_dir(tmp_path / "data", n_utts=2)
    model = tmp_path / "m"
    assert initialize_model.main([
        "-read_feats_scp_file", str(data / "feats.scp"),
        "-read_vocab_file", str(data / "vocab.txt"), "-save_model_file",
        str(model), *MODEL_FLAGS]) == 0
    assert load_checkpoint(str(model))["cfg"].conformer_stream_dtype == \
        "bfloat16"
    assert jax_load_checkpoint(str(model))["cfg"].conformer_stream_dtype == \
        jnp.bfloat16
