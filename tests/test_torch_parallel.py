"""The port's dp x tp train step (parallel/mesh.py, train/state.py
``train_step(mesh=)``) against the JAX package's on its 8-device CPU mesh
(tests/test_parallel.py): 8 gloo ranks of tests/torch_parallel_worker.py
in a 4 x 2 ("data", "model") mesh, one world for the module, started by the
port's ``launch --gang``.

- The mesh's shape and its error; the sharding rules equal JAX's
  PartitionSpecs leaf by leaf (``"model"``'s dimension or None).
- Three steps of the small transformer (the tdnn encoder, as JAX's test,
  and the banded encoder, whose attention runs K2a-c on each rank's local
  head) from one JAX-initialised checkpoint: the losses within 2e-4
  relative and the parameters (gathered from the ranks' slices) within
  2e-5 of JAX's 4 x 2 step and of the port on one rank; the heads, FFN
  columns, embedding and vocabulary really split; the eval step's global
  metrics.
- The batch's rows split over ``data`` in rank order.
"""

import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from pytorch_kaldi_asr_tpu.models.transformer import (
    init_transformer as jax_init,
)
from pytorch_kaldi_asr_tpu.parallel import mesh as jax_mesh
from pytorch_kaldi_asr_tpu.train import create_train_state as jax_state
from pytorch_kaldi_asr_tpu.train import make_train_step
from pytorch_kaldi_asr_tpu_torch.models.transformer import tree_map
from pytorch_kaldi_asr_tpu_torch.parallel import mesh
from pytorch_kaldi_asr_tpu_torch.train.checkpoint import params_from_jax
from pytorch_kaldi_asr_tpu_torch.train.optim import named_leaves
from pytorch_kaldi_asr_tpu_torch.train.state import (
    create_train_state,
    train_step,
)
from tests.torch_parallel_helpers import run_world
from tests.torch_port_helpers import configs

torch.set_num_threads(1)

MESH = (4, 2)
STEPS = 3
ENCODERS = {"tdnn": dict(encoder_type="tdnn"),
            "banded": dict(encoder_type="banded")}


def _data(cfg, batch=8, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(batch, 10, cfg.src_dim)).astype(np.float32)
    src_mask = np.ones((batch, 10), np.uint8)
    tgt = np.tile(np.array([2, 4, 5, 6, 3, 0], np.int32), (batch, 1))
    return src, src_mask, tgt.astype(np.int64), (tgt != 0).astype(np.uint8)


@pytest.fixture(scope="module")
def cases():
    jx, inputs = {}, {}
    for name, kw in ENCODERS.items():
        jcfg, pcfg = configs(**kw)
        params = jax.jit(jax_init, static_argnums=1)(jax.random.PRNGKey(0),
                                                     jcfg)
        data = _data(jcfg)
        jx[name] = (jcfg, pcfg, params, data)
        inputs[name] = dict(cfg=dict(pcfg.__dict__), mesh=MESH,
                            params=params_from_jax(jax.device_get(params)),
                            data=data, steps=STEPS)
    return jx, inputs


LOOP = dict(batch=4, epochs=2)


def _triples(cfg, n=12, seed=3):
    rng = np.random.default_rng(seed)
    return [(f"u{i:02d}", rng.normal(size=(int(rng.integers(5, 10)),
                                            cfg.src_dim)).astype(np.float32),
             np.array([2] + list(rng.integers(4, cfg.vocab_size,
                                              int(rng.integers(1, 4))))
                      + [3])) for i in range(n)]


@pytest.fixture(scope="module")
def world(cases, tmp_path_factory):
    inputs = dict(cases[1])
    _, pcfg, _, _ = cases[0]["banded"]
    inputs["loop"] = dict(
        cases[1]["banded"], mesh=(2, 2),
        loop=dict(LOOP, triples=_triples(pcfg),
                  dir=str(tmp_path_factory.mktemp("dptp_loop"))))
    return run_world("dptp", 8, tmp_path_factory.mktemp("dptp_world"),
                     inputs)


def test_mesh_construction():
    with pytest.raises(ValueError) as err:
        mesh.make_mesh(data=3, model=2, ranks=range(8))
    with pytest.raises(ValueError) as want:
        jax_mesh.make_mesh(data=3, model=2)
    assert str(err.value) == str(want.value)
    m = mesh.make_mesh(model=1)  # one process: a 1 x 1 mesh
    assert m.axis_names == ("data", "model")
    assert m.shape == {"data": 1, "model": 1} and m.member


@pytest.mark.parametrize("name", ["tdnn", "banded", "conformer"])
def test_sharding_rules_match_jax(name):
    kw = ENCODERS.get(name, dict(encoder_type="conformer",
                                 conformer_kernel=5))
    jcfg, _ = configs(**kw)
    params = jax.jit(jax_init, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    specs = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map_with_path(jax_mesh.param_sharding_rules,
                                         params),
        is_leaf=lambda x: isinstance(x, P))
    port = params_from_jax(jax.device_get(params))
    got = [mesh.param_sharding_rules(path, leaf)
           for path, leaf in named_leaves(port)]
    want = [spec.index("model") if "model" in spec else None
            for spec in specs]
    assert got == want
    assert any(d is not None for d in got)


def test_shard_params_copies():
    """Each slice is a tensor of its own: the optimizer's in-place update
    of a slice leaves the full tree as it was (a chunk along dim 0 would
    otherwise be a view of it)."""
    _, pcfg = configs(encoder_type="banded")
    from pytorch_kaldi_asr_tpu_torch.models.transformer import (
        init_transformer,
    )

    full = init_transformer(torch.Generator().manual_seed(0), pcfg)
    before = tree_map(torch.clone, full)
    # one process: this rank is index 0 of a 2-way model axis, no groups
    sliced = mesh.shard_params(full, mesh.Mesh(("data", "model"), (1, 2),
                                               [0, 1]))
    for _, leaf in named_leaves(sliced):
        leaf.add_(1.0)
    for (_, a), (_, b) in zip(named_leaves(full), named_leaves(before)):
        assert torch.equal(a, b)


def test_batch_rows_split_over_data(world):
    rows = [o[f"rows{MESH}"] for o in world]
    for r, got in enumerate(rows):
        d = r // MESH[1]
        np.testing.assert_array_equal(
            got.numpy(), np.arange(32).reshape(8, 4)[2 * d:2 * d + 2])


@pytest.mark.parametrize("name", list(ENCODERS))
def test_dptp_step_matches_jax_and_one_rank(cases, world, name):
    jcfg, pcfg, params, data = cases[0][name]
    jmesh = jax_mesh.make_mesh(model=2)
    state, tx = jax_state(jax_mesh.shard_params(params, jmesh))
    step = make_train_step(jcfg, tx, donate=False, mesh=jmesh)
    arrays = jax_mesh.shard_batch_arrays(jmesh, *data)
    jax_losses = []
    with jmesh:
        for _ in range(STEPS):
            state, m = step(state, *arrays)
            jax_losses.append(float(m["loss"]))
    jax_params = [np.asarray(x) for x in
                  jax.tree_util.tree_leaves(jax.device_get(state.params))]

    one = create_train_state(tree_map(torch.clone, cases[1][name]["params"]))
    one_losses = [float(train_step(one, pcfg, *map(torch.as_tensor, data))
                        ["loss"]) for _ in range(STEPS)]

    for r, out in enumerate(world):
        got = out[name]
        np.testing.assert_allclose(got["losses"], jax_losses, rtol=2e-4)
        np.testing.assert_allclose(got["losses"], one_losses, rtol=2e-4)
        got_params = [p for _, p in named_leaves(got["params"])]
        one_params = [p.detach() for _, p in named_leaves(one.params)]
        for g, w, o in zip(got_params, jax_params, one_params):
            np.testing.assert_allclose(g.numpy(), w, atol=2e-5)
            np.testing.assert_allclose(g.numpy(), o.numpy(), atol=2e-5)
        words = (data[2][:, 1:] != 0).sum()
        assert got["eval"]["n_words"] == words
    shapes = world[0][name]["local_shapes"]
    layer = "decoder/layers/0"
    assert shapes[f"{layer}/slf/w_qs"][0] == jcfg.n_head // 2  # heads
    assert shapes[f"{layer}/ffn/w1/w"][1] == jcfg.de_d_model // 2
    assert shapes["decoder/embed"][1] == jcfg.de_d_model // 2
    assert shapes[f"{layer}/slf/proj/w"][0] == jcfg.n_head * jcfg.d_v // 2
    # an odd vocabulary (11) does not divide over 2: replicated
    assert shapes["decoder/word_proj/w"][1] == jcfg.vocab_size


def test_train_model_on_a_mesh_matches_one_device(cases, world, tmp_path):
    """``train_model(mesh=)`` (train/loop.py) on a 2 x 2 mesh: two epochs
    over in-memory batches, every rank's best epoch, accuracy and (whole)
    best parameters those of the single-device run within 2e-5; rank 0
    alone writes the checkpoints."""
    from pytorch_kaldi_asr_tpu_torch.data.loader import BatchLoader
    from pytorch_kaldi_asr_tpu_torch.train.loop import train_model

    _, pcfg, _, _ = cases[0]["banded"]
    triples = _triples(pcfg)
    one = train_model(tree_map(torch.clone, cases[1]["banded"]["params"]),
                      pcfg, BatchLoader(triples, LOOP["batch"], mode="drop"),
                      BatchLoader(triples, LOOP["batch"], mode="all"),
                      BatchLoader(triples, LOOP["batch"], mode="all"),
                      str(tmp_path / "one"), epochs=LOOP["epochs"],
                      device="cpu")
    want = [p for _, p in named_leaves(one.best_params)]
    for out in world[:4]:
        got = out["loop"]
        assert got["best_epoch"] == one.best_epoch
        assert abs(got["best_accu"] - one.best_accu) < 1e-6
        for g, w in zip([p for _, p in named_leaves(got["params"])], want):
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-5)
    assert world[0]["loop"]["written"] == sorted(os.listdir(
        tmp_path / "one"))
    assert all(out["loop"]["written"] == [] for out in world[1:4])
