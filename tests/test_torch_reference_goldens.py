"""The port against activations, gradients and beam traces recorded from
the reference code itself (tests/goldens/, written by
tests/record_reference_goldens.py), as tests/test_parity_reference.py pins
the JAX package: the reference state dict goes through the port's
``models.torch_import``, and the forward logits on a padded batch, the
encoder output, the length-1 layer-norm quirk, ``src_fold=2`` and every
parameter gradient match at that file's tolerances (2e-4 on activations,
5e-4 on gradients, loss 1e-4 relative).  The import gives the same arrays
as the JAX package's, and the port's ``Lattice`` replays the reference's
recorded trace.
"""

import json
import os

import numpy as np
import pytest
import torch

from pytorch_kaldi_asr_tpu.models.torch_import import (
    config_from_model_options as jax_config_from_options,
    state_dict_to_params as jax_state_dict_to_params,
)
from pytorch_kaldi_asr_tpu_torch.decode.lattice import Lattice
from pytorch_kaldi_asr_tpu_torch.models.torch_import import (
    config_from_model_options,
    state_dict_to_params,
)
from pytorch_kaldi_asr_tpu_torch.models.transformer import (
    TransformerConfig,
    encode,
    transformer_forward,
)
from tests.torch_port_helpers import leaves, t

torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
ACT_TOL = 2e-4
GRAD_TOL = 5e-4


@pytest.fixture(scope="module")
def golden():
    return np.load(os.path.join(GOLDEN_DIR, "reference_transformer.npz"))


def _cfg(src_fold=1):
    return TransformerConfig(
        src_dim=20, vocab_size=37, encoder_max_len=96, decoder_max_len=24,
        src_fold=src_fold, encoder_sub_sequence=(-100, 0),
        decoder_sub_sequence=(-10, 0), en_layers=2, de_layers=2, n_head=2,
        en_d_model=48, de_d_model=32, d_k=16, d_v=16, en_dropout=0.0,
        de_dropout=0.0, tdnn_contexts=((-1, 0, 1), (-1, 0, 1), (-3, 0, 3)))


def _state_dict(golden, prefix):
    return {k[len(prefix):]: golden[k] for k in golden.files
            if k.startswith(prefix)}


def _params(golden, prefix="sd/"):
    return state_dict_to_params(_state_dict(golden, prefix),
                                _cfg(src_fold=2 if prefix == "sd2/" else 1))


def _inputs(golden, prefix="in/"):
    return tuple(t(golden[prefix + k]) for k in ("src", "src_mask", "tgt",
                                                 "tgt_mask"))


def _close(got, want, tol=ACT_TOL):
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=tol, atol=tol)


def test_import_gives_the_jax_packages_arrays(golden):
    """The same state dict through both packages' imports: identical
    arrays, leaf for leaf, in JAX's flattening order."""
    import jax

    for prefix, fold in (("sd/", 1), ("sd2/", 2)):
        sd = _state_dict(golden, prefix)
        cfg = _cfg(src_fold=fold)
        want = jax.tree_util.tree_leaves(jax_state_dict_to_params(sd, cfg))
        got = leaves(state_dict_to_params(sd, cfg))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == torch.float32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        # torch tensors in the state dict import the same
        got_t = leaves(state_dict_to_params(
            {k: torch.from_numpy(v) for k, v in sd.items()}, cfg))
        assert all(torch.equal(a, b) for a, b in zip(got, got_t))


def test_config_from_model_options_matches_jax():
    opts = {"n_src_dim": 40, "n_tgt_vocab": 52, "encoder_max_len": 500,
            "decoder_max_len": 100, "encoder_sub_sequence": "(-100, 0)",
            "decoder_sub_sequence": [-10, 1], "en_layers": 3, "n_head": 2,
            "tdnn_contexts": [[-1, 0, 1], [-3, 0, 3]]}
    got, want = config_from_model_options(opts), jax_config_from_options(opts)
    for field in ("src_dim", "vocab_size", "encoder_sub_sequence",
                  "decoder_sub_sequence", "en_layers", "de_layers",
                  "tdnn_contexts", "en_dropout"):
        assert getattr(got, field) == getattr(want, field), field


def test_wrong_layer_counts_are_refused(golden):
    sd = _state_dict(golden, "sd/")
    with pytest.raises(ValueError, match="TDNN layers"):
        state_dict_to_params(sd, _cfg().replace(tdnn_contexts=((0,),)))
    with pytest.raises(ValueError, match="decoder layers"):
        state_dict_to_params(sd, _cfg().replace(de_layers=3))


def test_forward_matches_reference_code(golden):
    logits = transformer_forward(_params(golden), _cfg(), *_inputs(golden))
    _close(logits, golden["out/logits"])


def test_encoder_matches_reference_code(golden):
    src, src_mask, _, _ = _inputs(golden)
    enc, _ = encode(_params(golden), _cfg(), src, src_mask)
    _close(enc, golden["out/enc_output"])


def test_len1_decode_matches_reference_code(golden):
    """First autoregressive step: the reference's layer norm is the
    identity when the target axis has length 1."""
    src, src_mask, tgt, tgt_mask = _inputs(golden)
    logits = transformer_forward(_params(golden), _cfg(), src, src_mask,
                                 tgt[:, :1], tgt_mask[:, :1])
    _close(logits, golden["out/logits_len1"])


def test_fold2_matches_reference_code(golden):
    logits = transformer_forward(_params(golden, "sd2/"), _cfg(src_fold=2),
                                 *_inputs(golden, "in2/"))
    _close(logits, golden["out2/logits"])


def _grad_pairs(grads):
    """reference parameter name → (the port's gradient, layout)."""
    dec, enc = grads["decoder"], grads["encoder"]
    pairs = {
        "encoder_test.src_projection.linear.weight": (enc["src_proj"]["w"],
                                                      True),
        "decoder.tgt_word_emb.weight": (dec["embed"], False),
        "decoder.tgt_word_proj.linear.weight": (dec["word_proj"]["w"], True),
        "decoder.enc_dec_projection.linear.weight": (
            dec["enc_dec_proj"]["w"], True),
    }
    for i in range(3):
        layer = enc["tdnn"][i]
        pairs[f"encoder_test.tdnn_stack.{i}.proj.weight"] = (layer["w"], True)
        pairs[f"encoder_test.tdnn_stack.{i}.proj.bias"] = (layer["b"], False)
    for i in range(2):
        for ref_block, ours in (("slf_attn", "slf"), ("enc_attn", "enc")):
            blk = dec["layers"][i][ours]
            p = f"decoder.layer_stack.{i}.{ref_block}"
            for name in ("w_qs", "w_ks", "w_vs"):
                pairs[f"{p}.{name}"] = (blk[name], False)
            pairs[p + ".proj.linear.weight"] = (blk["proj"]["w"], True)
            pairs[p + ".proj.linear.bias"] = (blk["proj"]["b"], False)
            pairs[p + ".layer_norm.a_2"] = (blk["ln"]["gamma"], False)
            pairs[p + ".layer_norm.b_2"] = (blk["ln"]["beta"], False)
        ffn = dec["layers"][i]["ffn"]
        p = f"decoder.layer_stack.{i}.pos_ffn"
        for wname, ours in (("w_1", "w1"), ("w_2", "w2")):
            pairs[f"{p}.{wname}.weight"] = (ffn[ours]["w"], "conv")
            pairs[f"{p}.{wname}.bias"] = (ffn[ours]["b"], False)
        pairs[p + ".layer_norm.a_2"] = (ffn["ln"]["gamma"], False)
        pairs[p + ".layer_norm.b_2"] = (ffn["ln"]["beta"], False)
    return pairs


def _grad_tree(tree):
    if isinstance(tree, dict):
        return {k: _grad_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_grad_tree(v) for v in tree]
    return tree.grad


def test_grads_match_reference_code(golden):
    """d(loss)/d(params) of a fixed linear functional of the logits against
    the reference code's autograd, for every trainable parameter."""
    params = _params(golden)
    for leaf in leaves(params):
        leaf.requires_grad_()
    logits = transformer_forward(params, _cfg(), *_inputs(golden))
    loss = (logits * t(golden["in/loss_w"])).sum()
    loss.backward()
    np.testing.assert_allclose(float(loss), float(golden["out/loss"]),
                               rtol=1e-4)
    checked = 0
    for ref_name, (ours, layout) in _grad_pairs(_grad_tree(params)).items():
        ref = golden["grad/" + ref_name]
        ours = ours.numpy()
        if layout == "conv":
            ref = ref[:, :, 0].T
        elif layout:
            ref = ref.T
        if ref_name == "decoder.tgt_word_emb.weight":
            # torch zeroes the padding row's gradient (padding_idx=0); the
            # port masks PAD out of the loss instead: row 0 is not compared
            ref, ours = ref[1:], ours[1:]
        np.testing.assert_allclose(ours, ref, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=ref_name)
        checked += 1
    assert checked >= 40


def test_lattice_matches_reference_trace():
    with open(os.path.join(GOLDEN_DIR, "reference_lattice.json")) as f:
        trace = json.load(f)
    lat = Lattice(max_length=trace["max_length"], beam_size=trace["beam"])
    for step in trace["steps"]:
        assert lat.advance(np.array(step["weights"])) == step["done"]
        res_all, w_all = lat.get_results("all")
        assert res_all == step["results_all"]
        np.testing.assert_allclose(w_all, step["weights_all"], rtol=1e-9,
                                   atol=1e-9)
        res_end, w_end = lat.get_results("end")
        assert res_end == step["results_end"]
        np.testing.assert_allclose(w_end, step["weights_end"], rtol=1e-9,
                                   atol=1e-9)
    active, _ = lat.get_results("active")
    assert active == lat.active_sequences()
    with pytest.raises(ValueError, match="invalid mode"):
        lat.get_results("best")
