"""Port checkpoints against the JAX package's: a checkpoint saved by the JAX
``save_checkpoint`` loads into the port bit for bit, one saved by the port
loads through the JAX ``load_checkpoint`` bit for bit, and the files the port
writes back are byte-identical (config.json, meta.json, params.msgpack)."""

import filecmp

import jax
import msgpack
import numpy as np
import pytest
import torch

from pytorch_kaldi_asr_tpu.models.transformer import init_transformer
from pytorch_kaldi_asr_tpu.train.checkpoint import (
    load_checkpoint as jax_load,
    save_checkpoint as jax_save,
)
from pytorch_kaldi_asr_tpu_torch.train.checkpoint import (
    load_checkpoint,
    params_from_jax,
    save_checkpoint,
)
from pytorch_kaldi_asr_tpu_torch.utils import msgpack as port_msgpack
from tests.torch_port_helpers import configs, leaves

torch.set_num_threads(1)


# en_layers=11 puts list indices "10" after "9" (flax keeps list order)
@pytest.mark.parametrize("encoder_type,en_layers", [("banded", 11),
                                                    ("tdnn", 2),
                                                    ("conformer", 2)])
def test_jax_checkpoint_round_trips_through_port(tmp_path, encoder_type,
                                                 en_layers):
    jcfg, pcfg = configs(encoder_type=encoder_type, en_layers=en_layers)
    # op by op: jit would compile the whole 11-layer init for one call
    jparams = init_transformer(jax.random.PRNGKey(3), jcfg)
    jax_save(str(tmp_path / "jax"), jparams, jcfg, epoch=2, step=40,
             extra={"note": "x"})

    ck = load_checkpoint(str(tmp_path / "jax"))
    assert ck["cfg"] == pcfg
    assert (ck["epoch"], ck["step"], ck["meta"]["note"]) == (2, 40, "x")
    ours, theirs = leaves(ck["params"]), jax.tree_util.tree_leaves(jparams)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))  # bit-identical

    save_checkpoint(str(tmp_path / "port"), ck["params"], ck["cfg"],
                    epoch=2, step=40, extra={"note": "x"})
    for name in ("config.json", "meta.json", "params.msgpack"):
        assert filecmp.cmp(tmp_path / "jax" / name, tmp_path / "port" / name,
                           shallow=False), name

    back = jax_load(str(tmp_path / "port"))
    assert back["cfg"] == jcfg
    for a, b in zip(jax.tree_util.tree_leaves(back["params"]), theirs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_port_initialized_checkpoint_loads_in_jax(tmp_path):
    from pytorch_kaldi_asr_tpu_torch.models import transformer

    jcfg, pcfg = configs()
    params = transformer.init_transformer(torch.Generator().manual_seed(0),
                                          pcfg)
    save_checkpoint(str(tmp_path), params, pcfg)
    back = jax_load(str(tmp_path))
    assert back["cfg"] == jcfg
    jleaves = jax.tree_util.tree_leaves(back["params"])
    pleaves = leaves(params)
    assert [tuple(x.shape) for x in jleaves] == [tuple(x.shape) for x in pleaves]
    for a, b in zip(jleaves, pleaves):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_params_from_jax_keeps_the_tree():
    jcfg, _ = configs()
    jparams = init_transformer(jax.random.PRNGKey(0), jcfg)
    ported = params_from_jax(jax.device_get(jparams))
    assert isinstance(ported["encoder"]["layers"], list)
    assert len(ported["encoder"]["layers"]) == 2
    np.testing.assert_array_equal(
        ported["decoder"]["layers"][1]["enc"]["w_qs"].numpy(),
        np.asarray(jparams["decoder"]["layers"][1]["enc"]["w_qs"]))


@pytest.mark.parametrize("value", [
    0, 1, 127, 128, 255, 256, 65535, 65536, 2**32, -1, -32, -33, -128, -129,
    -2**15 - 1, -2**31 - 1, 1.5, -0.0, None, True, False, "", "a" * 31,
    "b" * 32, "c" * 300, "d" * 70000, b"", b"\x00" * 300,
    list(range(15)), list(range(16)), {str(i): i for i in range(15)},
    {str(i): i for i in range(16)},
])
def test_msgpack_codec_matches_the_msgpack_package(value):
    packed = port_msgpack.packb(value)
    assert packed == msgpack.packb(value, use_bin_type=True)
    assert port_msgpack.unpackb(packed) == value


def test_msgpack_arrays_match_flax_including_bfloat16():
    from flax import serialization

    tree = {
        "f32": np.arange(6, dtype=np.float32).reshape(2, 3),
        "i32": np.array([-1, 7], np.int32),
        "bf16": np.asarray(jax.numpy.asarray([1.5, -2.25, 3.0],
                                             jax.numpy.bfloat16)),
        "scalar": np.float32(0.5),
        "empty": np.zeros((0, 4), np.float32),
    }
    flax_bytes = serialization.msgpack_serialize(dict(tree))
    restored = port_msgpack.unpackb(flax_bytes)
    assert restored["bf16"].dtype == torch.bfloat16
    np.testing.assert_array_equal(restored["bf16"].float().numpy(),
                                  [1.5, -2.25, 3.0])
    np.testing.assert_array_equal(restored["f32"].numpy(), tree["f32"])
    assert restored["scalar"] == 0.5
    assert tuple(restored["empty"].shape) == (0, 4)

    # flax writes the keys sorted, as a JAX pytree flattens a dict
    ours = {k: (tree[k] if k == "scalar" else restored[k])
            for k in sorted(tree)}
    assert port_msgpack.packb(ours) == flax_bytes
    back = serialization.msgpack_restore(port_msgpack.packb(ours))
    np.testing.assert_array_equal(np.asarray(back["bf16"], np.float32),
                                  [1.5, -2.25, 3.0])
    assert np.asarray(back["bf16"]).dtype == jax.numpy.bfloat16


def test_non_float32_compute_dtype_is_refused():
    from pytorch_kaldi_asr_tpu_torch.models.transformer import TransformerConfig

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TransformerConfig(src_dim=4, vocab_size=5, compute_dtype="bfloat16")
