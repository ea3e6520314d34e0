"""``compute_dtype=bfloat16`` (the configuration the JAX package's bench.py
trains) in the port against the JAX package on the CPU, with the JAX
parameters carried over by ``params_from_jax``.

Size: 2 layers, d_model 32, 2 heads, d_k 16, band (-8, 8), a padded row.

- The plain versions of K1, K2a, K2b and K2c on bfloat16 against the JAX
  package's Pallas kernels in interpret mode on bfloat16 inputs (64-row
  blocks): out, lse, dq, dk and dv, and the dropout masks.  bfloat16 outputs
  are held in bfloat16 ulps of each entry's scale (``ba.bf16_ulps``,
  BF16_ULPS).  Measured: the gradients at most 0.25 ulp; out at most 1.12,
  one ulp off in 0.4 % of its entries at band (-8, 8) and 14-15 % at (-64,
  32): the Pallas kernel rounds its unnormalised probabilities against the
  running max of its 64-key block, the plain version against the row's.
- The ``tdnn``, ``banded`` and ``conformer`` (float32 and bfloat16 stream)
  models: the encoder output and the logits, and one train step's loss and
  gradients, against the JAX package compiled with
  ``xla_allow_excess_precision`` off (tests/test_torch_bf16_stream.py says
  why).  The gate: mean |port - JAX bfloat16| under GATE (half) of mean
  |JAX bfloat16 - JAX float32|, the error bfloat16 compute itself makes.
  The forward and the step run with training on and no randomness (dropout
  rates set, no rng): JAX then trains the banded encoder off the TPU
  through its masked XLA attention (``multi_head_attention``), where the
  port runs the kernels' function; with ``PKA_CONF_ATTN=pallas`` JAX's
  conformer attends through the same kernel function as the port.  The
  ratios measured are in RATIOS_MEASURED.
- The two traps of bfloat16 compute: the logit divisor sqrt(d_model)
  computed in bfloat16 (11.3125 for 128), and ``x @ w + b`` rounded twice.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_kaldi_asr_tpu.decode.fast_beam import (
    fast_beam_search as jax_search,
)
from pytorch_kaldi_asr_tpu.models.transformer import (
    _Rngs,
    encode as jax_encode,
    multi_head_attention as jax_mha,
    transformer_forward as jax_forward,
)
from pytorch_kaldi_asr_tpu.ops.banded_attention import (
    _dropout_keep,
    _trainable_bwd,
    _trainable_fwd,
    banded_attention_pallas,
)
from pytorch_kaldi_asr_tpu.train import cross_entropy_loss as jax_ce
from pytorch_kaldi_asr_tpu_torch.decode.fast_beam import fast_beam_search
from pytorch_kaldi_asr_tpu_torch.models import encoders
from pytorch_kaldi_asr_tpu_torch.models import transformer as pt
from pytorch_kaldi_asr_tpu_torch.models.common import (
    banded_attn_mask,
    linear,
    padding_attn_mask,
)
from pytorch_kaldi_asr_tpu_torch.ops import banded_attention as ba
from pytorch_kaldi_asr_tpu_torch.train.state import loss_and_metrics
from tests.test_torch_bf16_stream import GATE, _exact, _f32, _ratio
from tests.torch_port_helpers import configs, jax_params, leaves, t

torch.set_num_threads(1)

BF16 = torch.bfloat16
BF16_ULPS = 2.0


def _bf16(x):
    """A JAX array as a bfloat16 tensor (exact)."""
    return torch.from_numpy(np.asarray(x, dtype=np.float32)).to(BF16)


# ---------------------------------------------------------------------------
# the kernels' plain versions on bfloat16 against the Pallas kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rate", [0.0, 0.35])
@pytest.mark.parametrize("bh,s,d,dv,lengths,start,end", [
    (4, 128, 16, 16, [128, 100, 60, 0], -8, 8),
    (2, 256, 16, 8, [256, 150], -64, 32),
])
def test_plain_bf16_versions_match_pallas_kernels(bh, s, d, dv, lengths,
                                                  start, end, rate):
    """K2a's out and lse, K2b's dq, K2c's dk and dv (each on the Pallas
    forward's out and lse, and delta as the JAX package computes it) and
    K1's out, plain versions on bfloat16 against the Pallas kernels in
    interpret mode on bfloat16; the dropout mask bit for bit."""
    scale, seed, block = 0.25, 77, 64
    rng = np.random.default_rng(s + d)
    q, k = (rng.normal(size=(bh, s, d)).astype(np.float32) for _ in range(2))
    v, dout = (rng.normal(size=(bh, s, dv)).astype(np.float32)
               for _ in range(2))
    valid = (np.arange(s)[None] < np.asarray(lengths)[:, None]).astype(
        np.int32)
    jq, jk, jv, jd = (jnp.asarray(x).astype(jnp.bfloat16)
                      for x in (q, k, v, dout))
    out, res = _trainable_fwd(jq, jk, jv, jnp.asarray(valid), jnp.int32(seed),
                              start, end, scale, rate, block, True)
    lse = np.asarray(res[-1])[..., 0]
    dq, dk, dv_, _, _ = _trainable_bwd(start, end, scale, rate, block, True,
                                       res, jd)
    k1 = banded_attention_pallas(jq, jk, jv, jnp.asarray(valid), start=start,
                                 end=end, scale=scale, block_q=block,
                                 interpret=True)
    assert out.dtype == dq.dtype == dk.dtype == jnp.bfloat16
    tq, tk, tv, td, tout = (_bf16(x) for x in (jq, jk, jv, jd, out))
    tvalid, tlse = torch.from_numpy(valid), torch.from_numpy(lse)
    band = (seed, start, end, scale, rate)
    p_out, p_lse = ba.banded_attention_trainable_reference(tq, tk, tv, tvalid,
                                                           *band)
    p_dq, delta = ba.banded_attention_dq_reference(tq, tk, tv, tvalid, td,
                                                   tout, tlse, *band)
    p_dk, p_dv = ba.banded_attention_dkv_reference(tq, tk, tv, tvalid, td,
                                                   tlse, delta, *band)
    p_k1 = ba.banded_attention_reference(tq, tk, tv, tvalid, start, end,
                                         scale)
    live = np.isfinite(lse)
    np.testing.assert_array_equal(np.isfinite(p_lse.numpy()), live)
    np.testing.assert_allclose(p_lse.numpy()[live], lse[live], atol=2e-5)
    for name, got, want in (("out", p_out, out), ("dq", p_dq, dq),
                            ("dk", p_dk, dk), ("dv", p_dv, dv_),
                            ("k1", p_k1, k1)):
        assert got.dtype == BF16, name
        assert float(ba.bf16_ulps(got, _bf16(want)).max()) <= BF16_ULPS, name
    if rate:
        pos = np.arange(s, dtype=np.int32)
        for b in range(bh):
            want = np.asarray(_dropout_keep(jnp.int32(seed), b,
                                            jnp.asarray(pos[:, None]),
                                            jnp.asarray(pos[None]), rate))
            np.testing.assert_array_equal(
                ba._keep_mask(seed, bh, s, rate, "cpu")[b].numpy(), want)


# ---------------------------------------------------------------------------
# the models: forward and one train step
# ---------------------------------------------------------------------------

BANDED = dict(encoder_type="banded", encoder_sub_sequence=(-8, 8), d_k=16,
              d_v=16)
MODELS = {
    "tdnn": dict(encoder_type="tdnn"),
    "banded": BANDED,
    "banded_masked_attention": BANDED,
    "conformer": dict(encoder_type="conformer", d_k=16, d_v=16,
                      conformer_kernel=5, encoder_sub_sequence=(-8, 8)),
    "conformer_bf16_stream": dict(
        encoder_type="conformer", d_k=16, d_v=16, conformer_kernel=5,
        encoder_sub_sequence=(-8, 8), conformer_stream_dtype="bfloat16"),
}


def _configs(model):
    """(JAX float32, JAX bfloat16, port float32, port bfloat16) configs,
    dropout rates set (the step runs without randomness)."""
    kw = dict(MODELS[model], en_dropout=0.1, de_dropout=0.1)
    stream = kw.pop("conformer_stream_dtype", "float32")
    jcfg, pcfg = configs(**kw)
    return (jcfg, jcfg.replace(compute_dtype=jnp.bfloat16,
                               conformer_stream_dtype=getattr(jnp, stream)),
            pcfg, pcfg.replace(compute_dtype="bfloat16",
                               conformer_stream_dtype=stream))


@pytest.fixture
def pallas_conformer(monkeypatch):
    """JAX's conformer attends through the Pallas kernel's function (in
    interpret mode off the TPU), as the port's does."""
    monkeypatch.setenv("PKA_CONF_ATTN", "pallas")


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(3, 20, cfg.src_dim)).astype(np.float32)
    src_mask = np.ones((3, 20), np.uint8)
    src_mask[2, 13:] = 0
    tgt = np.array([[2, 4, 5, 6, 3, 0], [2, 6, 7, 8, 3, 0],
                    [2, 5, 4, 3, 0, 0]], np.int32)
    return src, src_mask, tgt, (tgt != 0).astype(np.uint8)


def _jax_encode(params, cfg, src, mask):
    return jax_encode(params, cfg, src, mask, train=True)[0]


def _jax_loss(cfg):
    def loss(p, src, src_mask, tgt, tgt_mask):
        logits = jax_forward(p, cfg, src, src_mask, tgt[:, :-1],
                             tgt_mask[:, :-1], train=True, rng=None)
        return jax_ce(logits, tgt[:, 1:])[0]
    return loss


def _masked_attention(p, x, src_mask, cfg, rate, rngs, train):
    """The banded encoder's attention block as JAX trains it off the TPU:
    the port's ``multi_head_attention`` (masked, its logits bfloat16)."""
    s = x.shape[1]
    blocked = padding_attn_mask(src_mask, src_mask) | banded_attn_mask(
        s, *cfg.encoder_sub_sequence)[None]
    return pt.multi_head_attention(p, x, x, x, blocked, cfg, rate, rngs,
                                   train)


@pytest.mark.parametrize("model", list(MODELS))
def test_bf16_compute_forward_and_step_match_jax(model, pallas_conformer,
                                                 monkeypatch):
    """Encoder output, logits and one step's gradients (over all leaves,
    and the median leaf) of bfloat16 compute against JAX's, by the
    relative rule (GATE); the encoder's output in the stream's dtype, the
    logits float32.  ``banded`` runs the port as it is, its attention the
    kernels' function, against JAX's masked XLA attention: the deliberate
    difference, held to BANDED_LIMIT; ``banded_masked_attention`` swaps the
    port's attention block for the masked one (``_masked_attention``), so
    everything else in the banded model is held to GATE."""
    if model == "banded_masked_attention":
        monkeypatch.setattr(encoders, "_banded_self_attention",
                            _masked_attention)
    j32, j16, _, p16 = _configs(model)
    jparams, params = jax_params(j32, seed=2)
    src, src_mask, tgt, tgt_mask = batch = _batch(j32)

    enc16 = _exact(lambda p, x, m: _jax_encode(p, j16, x, m), jparams, src,
                   src_mask)
    enc32 = jax.jit(lambda p, x, m: _jax_encode(p, j32, x, m))(
        jparams, src, src_mask)
    enc, _ = pt.encode(params, p16, t(src), t(src_mask), train=True)
    want_dtype = BF16 if p16.conformer_stream_dtype == "bfloat16" and \
        model.startswith("conformer") else torch.float32
    assert enc.dtype == want_dtype
    ratios = {"encoder": _ratio(enc, enc16, enc32)}

    def forward(cfg):
        return lambda p, *a: jax_forward(p, cfg, *a, train=True, rng=None)

    args = (src, src_mask, tgt[:, :-1], tgt_mask[:, :-1])
    logits16 = _exact(forward(j16), jparams, *args)
    logits32 = jax.jit(forward(j32))(jparams, *args)
    logits = pt.transformer_forward(params, p16, *(t(x) for x in args),
                                    train=True)
    assert logits.dtype == torch.float32
    ratios["logits"] = _ratio(logits, logits16, logits32)

    loss16, g16 = _exact(jax.value_and_grad(_jax_loss(j16)), jparams, *batch)
    loss32, g32 = jax.jit(jax.value_and_grad(_jax_loss(j32)))(jparams, *batch)
    tree = pt.tree_map(lambda x: x.clone().requires_grad_(), params)
    loss, _, _ = loss_and_metrics(tree, p16, *(t(x) for x in batch),
                                  train=True)
    loss.backward()
    grads = [a.grad.detach() for a in leaves(tree)]
    g16, g32 = (jax.tree_util.tree_leaves(g) for g in (g16, g32))
    flat = (np.concatenate([_f32(x).ravel() for x in g])
            for g in (grads, g16, g32))
    ratios["gradients"] = _ratio(*flat)
    leaf = [_ratio(a, b16, b32) for a, b16, b32 in zip(grads, g16, g32)
            if not np.array_equal(b16, b32)]
    assert len(leaf) > 10
    ratios["median_leaf"] = float(np.median(leaf))
    gated = dict(ratios)
    # not gated: the largest leaf and the loss, sums over every position
    # whose bfloat16 errors cancel against float32 and leave chaos at
    # float32's last bit as the yardstick (PERF.md, PR 7)
    ratios["largest_leaf"] = max(leaf)
    ratios["loss"] = abs(float(loss) - float(loss16)) / abs(
        float(loss16) - float(loss32))
    print(f"{model}: {ratios}")
    limit = BANDED_LIMIT if model == "banded" else GATE
    for name, value in gated.items():
        assert value < limit, (name, ratios)


# The deliberate difference: JAX trains the banded encoder off the TPU
# through masked XLA attention, its logits rounded to bfloat16 and divided
# by bf16(sqrt(d_model)), where the port runs the kernels' function
# (float32 scores, the unnormalised probabilities rounded).  Measured:
# encoder 0.752, logits 1.138, gradients 0.724, median leaf 0.707 (largest
# leaf 1.404); with the masked attention swapped in, 2.0e-5, 0, 0.018 and
# 6.8e-4 (the other models: tdnn 0, 0.193, 0.187, 0.412; conformer 7e-6,
# 0, 0.221, 0.282; with its bfloat16 stream 0, 0, 0.147, 3e-5).
BANDED_LIMIT = 1.5


@pytest.mark.parametrize("model", ["tdnn", "conformer"])
def test_bf16_compute_decode_matches_jax(model, pallas_conformer):
    """The KV-cached search on a bfloat16-compute model (its encoder in
    bfloat16, the conformer's through K1's plain version; the search's
    steps float32 as in JAX): JAX's 1-best on every utterance, scores
    within GATE of their bfloat16-to-float32 difference."""
    j32, j16, _, p16 = _configs(model)
    jparams, params = jax_params(j32, seed=4)
    src, src_mask, _, _ = _batch(j32, seed=4)

    def search(cfg):
        return lambda p, x, m: jax_search(p, cfg, x, m, beam_size=3,
                                          max_len=8)

    want16 = _exact(search(j16), jparams, src, src_mask)
    want32 = jax.jit(search(j32))(jparams, src, src_mask)
    got = fast_beam_search(params, p16, t(src), t(src_mask), beam_size=3,
                           max_len=8)
    np.testing.assert_array_equal(got.tokens[:, 0].numpy(),
                                  np.asarray(want16.tokens)[:, 0])
    s16, s32 = (np.asarray(w.scores)[:, 0] for w in (want16, want32))
    assert np.all(np.abs(got.scores[:, 0].numpy() - s16)
                  <= GATE * np.maximum(np.abs(s16 - s32), 1e-6))


# ---------------------------------------------------------------------------
# the traps
# ---------------------------------------------------------------------------


def test_logit_divisor_is_sqrt_d_model_in_bf16():
    """JAX divides the attention logits by ``jnp.sqrt(jnp.array(d_model,
    bf16))``: 11.3125 for the decoder's 128, not sqrt(128) = 11.3137; for
    256 both are 16.  The port's multi-head attention at d_model 128 (its
    q/k/v, logits and probabilities bfloat16) stays within DIVISOR_GATE of
    JAX's bfloat16 error from float32: measured 9.8e-5; divided by the
    unrounded 11.3137 it reads 0.041 and fails."""
    assert pt.logit_divisor(128, BF16) == 11.3125
    assert pt.logit_divisor(256, BF16) == 16.0
    assert pt.logit_divisor(128, None) == np.sqrt(np.float32(128))
    ratio = _mha_ratio()
    print(f"multi-head attention at d_model 128: {ratio}")
    assert ratio < DIVISOR_GATE


def _mha_ratio():
    j32, j16, _, p16 = _configs("tdnn")
    j32, j16 = (c.replace(de_d_model=128, d_k=16, d_v=16) for c in (j32, j16))
    p16 = p16.replace(de_d_model=128, d_k=16, d_v=16)
    jparams, params = jax_params(j32, seed=6)
    jp = jparams["decoder"]["layers"][0]["slf"]
    pp = params["decoder"]["layers"][0]["slf"]
    rng = np.random.default_rng(6)
    x = rng.normal(size=(3, 7, 128)).astype(np.float32)
    blocked = np.zeros((3, 7, 7), bool)
    blocked[2, :, 5:] = True

    def mha(cfg):
        return lambda p, x, b: jax_mha(p, x, x, x, b, cfg, 0.0, _Rngs(None),
                                       False)

    want16 = _exact(mha(j16), jp, x, blocked)
    want32 = jax.jit(mha(j32))(jp, x, blocked)
    got = pt.multi_head_attention(pp, t(x), t(x), t(x), t(blocked), p16)
    return _ratio(got, want16, want32)


DIVISOR_GATE = 0.01


def test_bias_add_rounds_twice_in_bf16():
    """JAX's ``x @ w + b`` on bfloat16 is the product rounded to bfloat16,
    then the sum rounded again.  ``linear`` equals it but where the
    float32 sums' order flips a rounding (under 1 % of the entries; measured
    0); one rounding of the float32 product plus bias (``F.linear``,
    ``addmm``) differs in TWO_ROUNDINGS_SHARE or more of them (measured
    30 %)."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(64, 96)).astype(np.float32)
    w = rng.normal(size=(96, 80)).astype(np.float32) * 0.1
    b = rng.normal(size=(80,)).astype(np.float32)
    want = _bf16(_exact(lambda x, w, b: x.astype(jnp.bfloat16)
                        @ w.astype(jnp.bfloat16) + b.astype(jnp.bfloat16),
                        x, w, b))
    got = linear(t(x), t(w), t(b), BF16)
    once = torch.nn.functional.linear(t(x).to(BF16), t(w).t().to(BF16),
                                      t(b).to(BF16))
    fused = (t(x).to(BF16).float() @ t(w).to(BF16).float()
             + t(b).to(BF16).float()).to(BF16)
    assert got.dtype == BF16
    share = {name: float((y != want).float().mean())
             for name, y in (("linear", got), ("F.linear", once),
                             ("one rounding", fused))}
    print(f"shares of entries unlike JAX's: {share}")
    assert share["linear"] < 0.01
    assert share["one rounding"] >= TWO_ROUNDINGS_SHARE


TWO_ROUNDINGS_SHARE = 0.05
