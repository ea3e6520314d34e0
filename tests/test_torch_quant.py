"""Weight-only int8 (ops/quant.py) of the port against the JAX package's,
on the CPU.

- ``quantize_array`` and ``quantize_tree`` give the JAX package's int8
  values and scales bit for bit, on the same leaves (a JAX-initialized
  model's tree and edge cases: a zero channel, a tie at .5), and
  ``tree_bytes`` counts the same bytes;
- ``dequantize_tree`` is ``q8 * scale`` exactly;
- ``decode -quantize_weights -device cpu`` against the JAX decode CLI with
  ``-quantize_weights``: the same n-best text line for line, scores within
  SCORE_ATOL (float32 in another summation order); and its scores differ
  from the float32 decode's, so the int8 weights were used.
"""

import jax
import numpy as np
import pytest
import torch

from pytorch_kaldi_asr_tpu.ops.quant import (
    dequantize_tree as jax_dequantize_tree,
    quantize_array as jax_quantize_array,
    quantize_tree as jax_quantize_tree,
    tree_bytes as jax_tree_bytes,
)
from pytorch_kaldi_asr_tpu.recipes import decode as jax_decode
from pytorch_kaldi_asr_tpu.recipes import initialize_model as jax_init
from pytorch_kaldi_asr_tpu_torch.ops.quant import (
    dequantize_tree,
    quantize_array,
    quantize_tree,
    tree_bytes,
)
from pytorch_kaldi_asr_tpu_torch.recipes import decode
from pytorch_kaldi_asr_tpu_torch.train.optim import named_leaves
from tests.torch_port_helpers import configs, jax_params, t, write_data_dir

torch.set_num_threads(1)

SCORE_ATOL = 1e-5


@pytest.mark.parametrize("encoder_type", ["banded", "tdnn"])
def test_quantized_tree_is_bit_equal_to_jax(encoder_type):
    jcfg, _ = configs(encoder_type=encoder_type, en_d_model=64,
                      de_d_model=32, d_k=16, d_v=16)
    jparams, params = jax_params(jcfg, seed=3)
    for min_size in (1024, 256):
        jq, jn = jax_quantize_tree(jax.device_get(jparams), min_size=min_size)
        q, n = quantize_tree(params, min_size=min_size)
        assert n == jn > 0
        flat = jax.tree_util.tree_leaves(jq)
        got = list(named_leaves(q))
        assert len(got) == len(flat)
        for (path, a), b in zip(got, flat):
            b = np.asarray(b)
            assert a.numpy().dtype == b.dtype, path
            np.testing.assert_array_equal(a.numpy(), b, err_msg=str(path))
        assert tree_bytes(q) == jax_tree_bytes(jq)
        assert tree_bytes(params) == jax_tree_bytes(jparams)
        for (path, a), b in zip(named_leaves(dequantize_tree(q)),
                                jax.tree_util.tree_leaves(
                                    jax_dequantize_tree(jq))):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=str(path))


def test_quantize_array_edge_cases_match_jax():
    rng = np.random.default_rng(1)
    w = rng.normal(size=(40, 6)).astype(np.float32)
    w[:, 2] = 0.0  # a zero channel: scale 1, all zeros
    w[0, 3], w[1, 3] = 127.0, 0.5  # q exactly at .5: round half to even
    w[2:, 3] = 0.0
    got, want = quantize_array(w), jax_quantize_array(w)
    for key in ("q8", "scale"):
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])
    assert got["scale"][2] == 1.0 and got["q8"][1, 3] == 0


MODEL_FLAGS = [
    "-encoder_max_len", "48", "-decoder_max_len", "12",
    "-encoder_sub_sequence", "(-8,0)", "-decoder_sub_sequence", "(-3,0)",
    "-en_layers", "2", "-de_layers", "2", "-n_head", "2",
    "-en_d_model", "64", "-de_d_model", "32", "-d_k", "16", "-d_v", "16",
    "-encoder_type", "banded",
]


def _decode_args(data, model, out):
    return ["-read_data_dir", str(data), "-read_vocab_file",
            str(data / "vocab.txt"), "-load_model_file", str(model),
            "-save_result_file", str(out), "-batch_size", "4",
            "-beam_size", "4", "-nbest", "3", "-max_token_seq_len", "10"]


def _lines(path):
    return [line.rstrip("\n").split("\t") for line in open(path)]


def test_int8_decode_matches_jax_int8_decode(tmp_path):
    data = write_data_dir(tmp_path / "data", n_utts=6, seed=7)
    model = tmp_path / "model"
    assert jax_init.main([
        "-read_feats_scp_file", str(data / "feats.scp"), "-lda_mat_file",
        "identity", "-read_vocab_file", str(data / "vocab.txt"), "-seed", "8",
        "-save_model_file", str(model), *MODEL_FLAGS]) == 0
    assert jax_decode.main(_decode_args(data, model, tmp_path / "jax.txt")
                           + ["-quantize_weights"]) == 0
    timings = {}
    assert decode.main(_decode_args(data, model, tmp_path / "port.txt")
                       + ["-quantize_weights", "-device", "cpu"],
                       timings=timings) == 0
    assert timings["dequantize_s"] > 0
    assert decode.main(_decode_args(data, model, tmp_path / "f32.txt")
                       + ["-device", "cpu"]) == 0
    want, got = _lines(tmp_path / "jax.txt"), _lines(tmp_path / "port.txt")
    assert len(got) == len(want) == 6 * 3
    for (gk, gs, gw), (wk, ws, ww) in zip(got, want):
        assert (gk, gw) == (wk, ww)
        assert abs(float(gs) - float(ws)) <= SCORE_ATOL
    f32 = _lines(tmp_path / "f32.txt")
    assert max(abs(float(a[1]) - float(b[1])) for a, b in zip(got, f32)) \
        > 10 * SCORE_ATOL


def test_int8_leaves_stay_on_their_device():
    tree = {"w": t(np.ones((32, 32), np.float32)), "b": t(np.ones(32))}
    q, n = quantize_tree(tree)
    assert n == 1 and q["w"]["q8"].dtype == torch.int8
    assert q["b"] is tree["b"]
    assert q["w"]["q8"].device == q["w"]["scale"].device == tree["w"].device
