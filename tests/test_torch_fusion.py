"""Shallow fusion (decode/fusion.py) of the port against the JAX package's
``fused_beam_search``, on the CPU, with the JAX parameters carried over by
``params_from_jax``.

- The port's ``nlm_step`` driven over a token sequence gives the batch
  forward's log-probs (the incremental LM is the batch LM);
- the fused search on float32 trees, and with both trees int8 (the JAX
  package's ``make_fused_search(quantize=True)`` on its quantized AM tree):
  tokens and lengths identical, scores within SCORE_ATOL;
- ``lm_weight == 0`` equals the port's ``fast_beam_search`` exactly;
- the refusals raise with the JAX package's messages;
- ``decode -nlm_model_dir -lm_weight 0`` on the CPU writes the unfused
  decode's lines exactly; at 0.5, and with ``-quantize_weights``, others.
"""

import jax
import numpy as np
import pytest
import torch

from pytorch_kaldi_asr_tpu.decode.fusion import (
    fused_beam_search as jax_fused_beam_search,
    make_fused_search as jax_make_fused_search,
)
from pytorch_kaldi_asr_tpu.models.nlm import init_nlm as jax_init_nlm
from pytorch_kaldi_asr_tpu.models.transformer import (
    TransformerConfig as JaxConfig,
)
from pytorch_kaldi_asr_tpu.ops.quant import quantize_tree as jax_quantize_tree
from pytorch_kaldi_asr_tpu_torch.decode.fast_beam import (
    empty_caches,
    fast_beam_search,
    roll_caches,
)
from pytorch_kaldi_asr_tpu_torch.decode.fusion import (
    fused_beam_search,
    make_fused_search,
    nlm_step,
)
from pytorch_kaldi_asr_tpu_torch.models.common import position_encoding_table
from pytorch_kaldi_asr_tpu_torch.models.nlm import nlm_logits
from pytorch_kaldi_asr_tpu_torch.models.transformer import (
    TransformerConfig as PortConfig,
    encode,
)
from pytorch_kaldi_asr_tpu_torch.ops.quant import dequantize_tree, quantize_tree
from pytorch_kaldi_asr_tpu_torch.recipes import decode
from pytorch_kaldi_asr_tpu_torch.train import params_from_jax, save_checkpoint
from tests.torch_port_helpers import (
    configs,
    jax_params,
    source_batch,
    t,
    write_data_dir,
)

torch.set_num_threads(1)

SCORE_ATOL = 1e-5
BEAM, MAX_LEN = 3, 8


def _lm_configs(vocab, max_len=16, **kw):
    base = dict(src_dim=1, vocab_size=vocab, de_d_model=16, de_layers=2,
                n_head=2, d_k=8, d_v=8, decoder_max_len=max_len,
                decoder_sub_sequence=(-max_len, 0), de_dropout=0.0,
                encoder_max_len=8, ln_skip_len1=False)
    base.update(kw)
    return JaxConfig(**base), PortConfig(**base)


def _lm(jcfg, seed=1):
    params = jax.jit(jax_init_nlm, static_argnums=1)(
        jax.random.PRNGKey(seed), jcfg)
    return params, params_from_jax(jax.device_get(params))


@pytest.fixture(scope="module")
def models():
    """A banded AM (vocab 11) and an LM with a larger vocabulary (13)."""
    jcfg, pcfg = configs(en_d_model=64, de_d_model=32, d_k=16, d_v=16,
                         decoder_max_len=MAX_LEN)
    jparams, params = jax_params(jcfg, seed=5)
    jlm_cfg, lm_cfg = _lm_configs(13)
    jlm, lm = _lm(jlm_cfg)
    src, mask = source_batch(jcfg, b=3, s=20, seed=6)
    return dict(jcfg=jcfg, pcfg=pcfg, jparams=jparams, params=params,
                jlm_cfg=jlm_cfg, lm_cfg=lm_cfg, jlm=jlm, lm=lm, src=src,
                mask=mask)


def test_nlm_step_matches_batch_logits(models):
    lm, cfg = models["lm"], models["lm_cfg"]
    toks = torch.tensor([[2, 4, 5, 6, 12, 3], [2, 7, 3, 0, 0, 0]])
    batch = torch.log_softmax(nlm_logits(lm, cfg, toks, toks != 0), -1)
    window = -cfg.decoder_sub_sequence[0]
    caches = empty_caches(2, 2, cfg.n_head, window, cfg.d_k, cfg.d_v)
    pos = position_encoding_table(cfg.decoder_max_len, cfg.de_d_model)
    for step in range(3):  # the second row is valid for 3 positions
        lp, new_kv = nlm_step(lm, toks[:, step], step, caches, pos)
        np.testing.assert_allclose(lp.numpy(), batch[:, step].numpy(),
                                   atol=2e-5)
        caches = roll_caches(caches, new_kv, window)


def _compare(got, want):
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  np.asarray(want.lengths))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               atol=SCORE_ATOL)


@pytest.mark.parametrize("quantize", [False, True])
def test_fused_search_matches_jax(models, quantize):
    m = models
    weight = 0.7
    kw = dict(beam_size=BEAM, max_len=MAX_LEN)
    if quantize:
        jq, _ = jax_quantize_tree(jax.device_get(m["jparams"]), min_size=256)
        want = jax_make_fused_search(m["jlm"], m["jlm_cfg"], weight,
                                     quantize=True)(
            jq, m["jcfg"], m["src"], m["mask"], **kw)
        weights = dequantize_tree(quantize_tree(m["params"],
                                                min_size=256)[0])
    else:
        want = jax_fused_beam_search(m["jparams"], m["jcfg"], m["jlm"],
                                     m["jlm_cfg"], weight, m["src"],
                                     m["mask"], **kw)
        weights = m["params"]
    enc, mask_f = encode(weights, m["pcfg"], t(m["src"]), t(m["mask"]))
    got = make_fused_search(m["lm"], m["lm_cfg"], weight,
                            quantize=quantize)(weights, m["pcfg"], enc,
                                               mask_f, **kw)
    _compare(got, want)
    unfused = fast_beam_search(weights, m["pcfg"], t(m["src"]),
                               t(m["mask"]), **kw)
    assert not torch.equal(got.scores, unfused.scores)


def test_weight_zero_equals_unfused_search_exactly(models):
    m = models
    args = (t(m["src"]), t(m["mask"]))
    kw = dict(beam_size=BEAM, max_len=MAX_LEN)
    base = fast_beam_search(m["params"], m["pcfg"], *args, **kw)
    fused = fused_beam_search(m["params"], m["pcfg"], m["lm"], m["lm_cfg"],
                              0.0, *args, **kw)
    for a, b in zip(base, fused):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bad,match", [
    ("lm_ln_skip", "ln_skip_len1"),
    ("lm_lookahead", "CAUSAL LM band"),
    ("lm_vocab", "vocabulary"),
    ("am_lookahead", "causal band"),
    ("max_len", "position table"),
])
def test_refusals_raise_as_in_jax(models, bad, match):
    m = models
    jcfg, pcfg = m["jcfg"], m["pcfg"]
    lm_kw, max_len = {}, MAX_LEN
    if bad == "lm_ln_skip":
        lm_kw = dict(ln_skip_len1=True)
    elif bad == "lm_lookahead":
        lm_kw = dict(decoder_sub_sequence=(-16, 1))
    elif bad == "am_lookahead":
        jcfg = jcfg.replace(decoder_sub_sequence=(-3, 1))
        pcfg = pcfg.replace(decoder_sub_sequence=(-3, 1))
    elif bad == "max_len":
        max_len = MAX_LEN + 1
    # the module's LM weights: every refusal comes before they are read
    jlm_cfg, lm_cfg = _lm_configs(9 if bad == "lm_vocab" else 13, **lm_kw)
    jlm, lm = m["jlm"], m["lm"]
    src, mask = m["src"][:1], m["mask"][:1]
    with pytest.raises(ValueError, match=match):
        jax_fused_beam_search(m["jparams"], jcfg, jlm, jlm_cfg, 0.5, src,
                              mask, beam_size=2, max_len=max_len)
    with pytest.raises(ValueError, match=match):
        fused_beam_search(m["params"], pcfg, lm, lm_cfg, 0.5, t(src),
                          t(mask), beam_size=2, max_len=max_len)


def test_decode_cli_fuses_the_lm(models, tmp_path):
    """``decode -nlm_model_dir -lm_weight`` on the CPU, with and without
    ``-quantize_weights``: ``-lm_weight 0`` writes the unfused decode's
    lines exactly, 0.5 others, and int8 others again."""
    m = models
    cfg = m["pcfg"].replace(src_dim=13, vocab_size=11)
    data = write_data_dir(tmp_path / "data", n_utts=4, seed=2,
                          lengths=(12, 20))
    save_checkpoint(tmp_path / "am", m["params"], cfg)
    save_checkpoint(tmp_path / "lm", m["lm"], m["lm_cfg"],
                    extra={"model_kind": "nlm"})
    args = ["-read_data_dir", str(data), "-read_vocab_file",
            str(data / "vocab.txt"), "-load_model_file", str(tmp_path / "am"),
            "-batch_size", "4", "-beam_size", "3", "-nbest", "2",
            "-max_token_seq_len", str(MAX_LEN), "-device", "cpu"]
    fused = ["-nlm_model_dir", str(tmp_path / "lm"), "-lm_weight"]
    outs = {}
    for name, extra in (("unfused", []), ("weight0", fused + ["0"]),
                        ("fused", fused + ["0.5"]),
                        ("fused_int8", fused + ["0.5", "-quantize_weights"])):
        timings = {}
        assert decode.main(args + extra + ["-save_result_file",
                                           str(tmp_path / name)],
                           timings=timings) == 0
        outs[name] = open(tmp_path / name).read()
        assert len(outs[name].splitlines()) == 4 * 2
        assert ("dequantize_s" in timings) == (name == "fused_int8")
    assert outs["weight0"] == outs["unfused"]
    assert len({outs["unfused"], outs["fused"], outs["fused_int8"]}) == 3
