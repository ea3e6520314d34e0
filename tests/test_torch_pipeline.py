"""The port's pipeline parallelism (parallel/pipeline.py) against the JAX
package's on its 8-device CPU mesh (tests/test_pipeline.py, its
tolerances): 8 gloo ranks of tests/torch_parallel_worker.py, one world
for the module (meshes of 4 and 2 stages, 4 stages x 2 data ranks, and 3
stages for the refusal), started by the port's ``launch --gang``.  Each
rank holds its own stage's layers only (``stage_params``).

- ``stack_stage_params``'s layout;
- the forward against the single-device ``banded_encode`` and JAX's
  ``pp_banded_encode`` within 1e-5: M = S, M > S, with a data axis;
- the loss over the global frames within 1e-6 and every gradient (each
  stage's layers from their rank, the shared leaves equal on every rank)
  within JAX's 2e-5 + 2e-4 relative of JAX's;
- ``utt_valid`` drops the rows ``frame_ce_loss`` drops;
- dropout: finite, non-zero gradients, another step seed another loss;
- JAX's refusals, with its messages.
"""

import jax
import numpy as np
import pytest
import torch

from pytorch_kaldi_asr_tpu.models.am import frame_ce_loss, init_am
from pytorch_kaldi_asr_tpu.models.encoders import banded_encode
from pytorch_kaldi_asr_tpu.models.transformer import (
    TransformerConfig,
    init_transformer,
)
from pytorch_kaldi_asr_tpu.parallel import pipeline as jax_pp
from pytorch_kaldi_asr_tpu_torch.parallel import pipeline as pp
from pytorch_kaldi_asr_tpu_torch.train.checkpoint import params_from_jax
from tests.torch_parallel_helpers import run_world

torch.set_num_threads(1)

KW = dict(src_dim=8, vocab_size=16, encoder_type="banded",
          encoder_sub_sequence=(-4, 0), encoder_max_len=32, en_layers=4,
          n_head=2, en_d_model=16, d_k=8, d_v=8, en_dropout=0.3, src_fold=1)
CFG = TransformerConfig(**KW)
FWD = {"pipe4": dict(pipe=4, seed=0), "pipe2_m8": dict(pipe=2, micro=8,
                                                         seed=1),
       "pipe4_data2": dict(pipe=4, data=2, micro=4, seed=2)}


def _data(batch=8, s=16, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(batch, s, CFG.src_dim)).astype(np.float32)
    mask = np.ones((batch, s), np.uint8)
    mask[-1, s // 2:] = 0  # one padded utterance
    return src, mask


def _enc(seed):
    params = jax.jit(init_transformer, static_argnums=1)(
        jax.random.PRNGKey(seed), CFG)["encoder"]
    return params, params_from_jax(jax.device_get(params))


def _am(seed):
    params = jax.jit(init_am, static_argnums=(1, 2))(jax.random.PRNGKey(seed),
                                                     CFG, 10)
    return params, params_from_jax(jax.device_get(params))


@pytest.fixture(scope="module")
def cases():
    jx, inputs = {}, {}
    for name, c in FWD.items():
        jparams, params = _enc(c["seed"])
        src, mask = _data(seed=c["seed"])
        jx[name] = (jparams, src, mask)
        inputs[name] = dict(kind="fwd", cfg=KW, params=params, src=src,
                            mask=mask, pipe=c["pipe"], data=c.get("data", 1),
                            micro=c.get("micro"))
    for name, seed, kind in (("grad", 3, "grad"), ("utt", 5, "utt_valid"),
                             ("dropout", 4, "dropout")):
        jparams, params = _am(seed)
        src, mask = _data(seed=seed)
        tgt = np.random.default_rng(seed).integers(0, 10, size=mask.shape)
        if kind == "dropout":
            tgt = np.zeros(mask.shape, np.int64)
        utt = np.ones(8, np.uint8)
        utt[-2:] = 0  # the loader's duplicated tail rows
        jx[name] = (jparams, src, mask, tgt.astype(np.int32), utt)
        inputs[name] = dict(kind=kind, cfg=KW, params=params, src=src,
                            mask=mask, tgt=tgt, utt=utt, pipe=4)
    jparams, params = _enc(0)
    src, mask = _data()
    inputs["errors"] = dict(kind="errors", cfg=KW, params=params, src=src,
                            mask=mask, pipe=4, bad_mesh=(3, 1))
    inputs["bad"] = dict(kind="none", cfg=KW, src=src, mask=mask, pipe=3)
    return jx, inputs


@pytest.fixture(scope="module")
def world(cases, tmp_path_factory):
    return run_world("pp", 8, tmp_path_factory.mktemp("pp_world"), cases[1])


def test_stack_stage_params_layout():
    _, params = _enc(0)
    stacked = pp.stack_stage_params(params["layers"], 2)
    w = stacked["slf"]["w_qs"]
    assert tuple(w.shape[:2]) == (2, 2)
    # stage 1's first resident layer is global layer 2, in order
    assert torch.equal(w[1, 0], params["layers"][2]["slf"]["w_qs"])
    with pytest.raises(ValueError, match="do not divide"):
        pp.stack_stage_params(params["layers"], 3)


@pytest.mark.parametrize("name", list(FWD))
def test_pp_forward_matches_single_device_and_jax(cases, world, name):
    jparams, src, mask = cases[0][name]
    c = FWD[name]
    ref, _ = banded_encode(jparams, CFG, src, mask)
    want = jax_pp.pp_banded_encode(
        jparams, CFG, src, mask,
        jax_pp.make_pipe_mesh(pipe=c["pipe"], data=c.get("data", 1)),
        n_microbatches=c.get("micro"))
    got = np.zeros_like(np.asarray(ref))
    ranks = c["pipe"] * c.get("data", 1)
    for out in world[:ranks]:
        enc = out[name]["enc"].numpy()
        got[out[name]["rows"]] = enc
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)


def test_pp_grads_match_jax(cases, world):
    jparams, src, mask, tgt, _ = cases[0]["grad"]
    mesh = jax_pp.make_pipe_mesh(pipe=4)

    def pp_loss(p):
        loss, _, n = jax_pp.pp_frame_ce_loss(p, CFG, src, mask, tgt, mesh)
        return loss / n

    def ref_loss(p):
        loss, _, n = frame_ce_loss(p, CFG, src, mask, tgt)
        return loss / n

    lp, gp = jax.value_and_grad(pp_loss)(jparams)
    lr = ref_loss(jparams)
    want = params_from_jax(jax.device_get(gp))
    lps = CFG.en_layers // 4
    for out in world[:4]:
        got = out["grad"]
        assert abs(got["loss"] - float(lp)) < 1e-6 * max(1.0, abs(float(lp)))
        assert abs(got["loss"] - float(lr)) < 1e-6 * max(1.0, abs(float(lr)))
        stage = got["stage"]
        for key, g in got["grads"].items():
            parts = key.split("/")
            if parts[:2] == ["encoder", "layers"]:  # this stage's layer j
                parts[2] = str(stage * lps + int(parts[2]))
            w = want
            for p in parts:
                w = w[int(p)] if isinstance(w, list) else w[p]
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-5,
                                       rtol=2e-4, err_msg=key)


def test_pp_utt_valid_matches_single_device(cases, world):
    jparams, src, mask, tgt, utt = cases[0]["utt"]
    ref = frame_ce_loss(jparams, CFG, src, mask, tgt, utt_valid=utt)
    for out in world[:4]:
        got = out["utt"]
        np.testing.assert_allclose(got["got"], [float(v) for v in ref],
                                   atol=1e-5, rtol=1e-5)
        assert got["full"][2] > got["got"][2]


def test_pp_train_dropout_finite_and_seeded(world):
    for out in world[:4]:
        got = out["dropout"]
        assert np.isfinite(got["l1"]) and np.isfinite(got["gn"])
        assert got["gn"] > 0.0
        assert got["l1"] != got["l2"]  # another step seed, other masks


def test_pp_shape_validation_matches_jax(cases, world):
    jparams, src, mask = cases[0]["pipe4"]
    calls = {"stages": dict(mesh=jax_pp.make_pipe_mesh(pipe=3)),
             "micro": dict(mesh=jax_pp.make_pipe_mesh(pipe=4),
                           n_microbatches=3)}
    for name, kw in calls.items():
        with pytest.raises(ValueError) as err:
            jax_pp.pp_banded_encode(jparams, CFG, src, mask, **kw)
        for out in world[:3]:
            assert out["errors"][name] == str(err.value)
