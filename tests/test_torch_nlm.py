"""The neural LM (models/nlm.py, recipes/train_nlm.py) and the LM scoring
CLI (recipes/score_lm.py) of the port against the JAX package's, on the
CPU.

- ``nlm_logits``, ``nlm_loss`` and ``sentence_logprobs`` within ATOL of
  JAX's (float32, the JAX parameters carried over by ``params_from_jax``),
  on rows padded to different lengths;
- one training step of the port's ``train_nlm`` at dropout 0 against
  JAX's loss and gradients (loss 1e-6 relative, gradients 1e-5 of each
  leaf's largest entry);
- checkpoints load both ways: the port reads an LM checkpoint as JAX's
  ``train_nlm`` writes it (its config, ``model_kind: "nlm"``) and scores
  as JAX does, and JAX's ``load_nlm`` reads one the port's ``train_nlm
  -device cpu`` wrote;
- ``score_lm`` against the JAX CLI's output files: with ``-lm`` (an ARPA
  file written by JAX's ``train_lm``) line for line equal, with
  ``-nlm_model_dir`` each line within NLM_SCORE_ATOL (printed to 4
  decimals; the scores agree to 1e-5).
"""

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_kaldi_asr_tpu.models.nlm import (
    init_nlm as jax_init_nlm,
    load_nlm as jax_load_nlm,
    nlm_logits as jax_nlm_logits,
    nlm_loss as jax_nlm_loss,
    sentence_logprobs as jax_sentence_logprobs,
)
from pytorch_kaldi_asr_tpu.models.transformer import (
    TransformerConfig as JaxConfig,
)
from pytorch_kaldi_asr_tpu.recipes import score_lm as jax_score_lm
from pytorch_kaldi_asr_tpu.recipes import train_lm as jax_train_lm
from pytorch_kaldi_asr_tpu.train.checkpoint import (
    save_checkpoint as jax_save_checkpoint,
)
from pytorch_kaldi_asr_tpu_torch.models.nlm import (
    load_nlm,
    nlm_logits,
    nlm_loss,
    sentence_logprobs,
)
from pytorch_kaldi_asr_tpu_torch.recipes import score_lm, train_nlm
from pytorch_kaldi_asr_tpu_torch.train import (
    create_train_state,
    params_from_jax,
)
from pytorch_kaldi_asr_tpu_torch.train.optim import named_leaves
from tests.torch_port_helpers import t

torch.set_num_threads(1)

ATOL = 1e-5
LOSS_RTOL = 1e-6
GRAD_RTOL = 1e-5
NLM_SCORE_ATOL = 1e-4

WORDS = ["the", "cat", "sat", "dog", "ran", "on", "mat"]
VOCAB = {w: i for i, w in enumerate(["<blank>", "<unk>", "<s>", "</s>"]
                                    + WORDS)}


def _configs(**kw):
    """(JAX config, port config) of train_nlm's LM at a small size."""
    base = dict(src_dim=1, vocab_size=len(VOCAB), de_d_model=16, de_layers=2,
                n_head=2, d_k=8, d_v=8, decoder_max_len=12, de_dropout=0.0,
                decoder_sub_sequence=(-12, 0), encoder_max_len=8,
                ln_skip_len1=False)
    base.update(kw)
    port = train_nlm.nlm_config(base["vocab_size"], d_model=16, layers=2,
                                n_head=2, max_len=12, dropout=0.0)
    assert port.replace(**base) == port  # train_nlm's config, field for field
    return JaxConfig(**base), port


def _tokens(seed=0):
    rng = np.random.default_rng(seed)
    toks = np.zeros((4, 10), np.int32)
    for i, n in enumerate((8, 5, 3, 1)):
        toks[i, 0] = 2
        toks[i, 1:n + 1] = rng.integers(4, len(VOCAB), n)
        toks[i, n + 1] = 3
    return toks, (toks != 0).astype(np.uint8)


def _jax_lm(jcfg, seed):
    jparams = jax.jit(jax_init_nlm, static_argnums=1)(
        jax.random.PRNGKey(seed), jcfg)
    return jparams, params_from_jax(jax.device_get(jparams))


def test_logits_loss_and_sentence_scores_match_jax():
    jcfg, pcfg = _configs()
    jparams, params = _jax_lm(jcfg, 1)
    toks, mask = _tokens()
    want = jax.jit(lambda p, x, m: jax_nlm_logits(p, jcfg, x, m))(
        jparams, toks, mask)
    got = nlm_logits(params, pcfg, t(toks), t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    for got, want in zip(
            nlm_loss(params, pcfg, t(toks), t(mask)),
            jax.jit(lambda p, x, m: jax_nlm_loss(p, jcfg, x, m))(
                jparams, toks, mask)):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    want = jax.jit(lambda p, x, m: jax_sentence_logprobs(p, jcfg, x, m))(
        jparams, toks, mask)
    got = sentence_logprobs(params, pcfg, t(toks), t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_one_training_step_matches_jax_gradients():
    """The port's ``nlm_train_step`` on its mean per-token loss: the loss
    and every gradient leaf of JAX's ``value_and_grad`` of the same
    objective (train_nlm's), at dropout 0."""
    jcfg, pcfg = _configs()
    jparams, params = _jax_lm(jcfg, 2)
    toks, mask = _tokens(seed=3)

    def objective(p):
        loss, _, n = jax_nlm_loss(p, jcfg, jnp.asarray(toks),
                                  jnp.asarray(mask), train=True, rng=None)
        return loss / n

    jloss, jgrads = jax.jit(jax.value_and_grad(objective))(jparams)
    state = create_train_state(params, start_lr=0.01, soft_coefficient=2.0)
    loss, _, n = train_nlm.nlm_train_step(state, pcfg, t(toks), t(mask))
    np.testing.assert_allclose(float(loss / n), float(jloss), rtol=LOSS_RTOL)
    for (path, leaf), g in zip(named_leaves(state.params),
                               jax.tree_util.tree_leaves(jgrads)):
        g = np.asarray(g)
        np.testing.assert_allclose(
            leaf.grad.numpy(), g, atol=GRAD_RTOL * max(np.abs(g).max(), 1e-30),
            err_msg=str(path))
    assert state.step == 1


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """vocab.txt, a training text and an n-best file (decode.txt) of words
    the LM knows and one it does not."""
    tmp = tmp_path_factory.mktemp("nlm")
    (tmp / "vocab.txt").write_text(
        "".join(f"{w} {i}\n" for w, i in VOCAB.items()))
    rng = np.random.default_rng(0)
    lines = [f"u{i:03d} " + " ".join(rng.choice(WORDS, rng.integers(2, 7)))
             for i in range(40)]
    (tmp / "text").write_text("\n".join(lines) + "\n")
    hyps = [" ".join(rng.choice(WORDS + ["zebra"], rng.integers(0, 9)))
            for _ in range(12)]
    (tmp / "decode.txt").write_text("".join(
        f"u{i // 3}\t{-1.5 * i}\t{h}\n" for i, h in enumerate(hyps)))
    return tmp


def _floats(path):
    return [float(x) for x in open(path).read().split()]


@pytest.fixture(scope="module")
def port_nlm(corpus):
    """An LM trained by the port's CLI on the CPU (dropout on)."""
    path = corpus / "port_nlm"
    assert train_nlm.main([
        "-text", str(corpus / "text"), "-read_vocab_file",
        str(corpus / "vocab.txt"), "-save_model_dir", str(path), "-epoch",
        "2", "-batch_size", "16", "-d_model", "16", "-layers", "1",
        "-max_len", "12", "-device", "cpu"]) == 0
    return path


def test_checkpoints_load_both_ways(corpus, port_nlm):
    # what JAX's train_nlm writes at its end, for its config (_configs)
    jcfg, _ = _configs()
    jparams, _ = _jax_lm(jcfg, 5)
    jax_save_checkpoint(str(corpus / "jax_nlm"), jparams, jcfg, epoch=1,
                        extra={"model_kind": "nlm"})
    params, cfg, meta = load_nlm(str(corpus / "jax_nlm"))
    assert meta["model_kind"] == "nlm" and not cfg.ln_skip_len1
    toks, mask = _tokens(seed=4)
    np.testing.assert_allclose(
        nlm_logits(params, cfg, t(toks), t(mask)).numpy(),
        np.asarray(jax_nlm_logits(jparams, jcfg, toks, mask)), atol=ATOL)

    params, cfg, _ = load_nlm(str(port_nlm))
    jparams, jcfg, jmeta = jax_load_nlm(str(port_nlm))
    assert jmeta["model_kind"] == "nlm" and jcfg.decoder_sub_sequence == \
        cfg.decoder_sub_sequence == (-12, 0)
    np.testing.assert_allclose(
        nlm_logits(params, cfg, t(toks), t(mask)).numpy(),
        np.asarray(jax_nlm_logits(jparams, jcfg, toks, mask)), atol=ATOL)

    not_lm = corpus / "not_nlm"  # the LM with its meta's kind gone
    shutil.copytree(port_nlm, not_lm)
    (not_lm / "meta.json").write_text(json.dumps({"epoch": 0}))
    with pytest.raises(ValueError, match="not a neural-LM checkpoint"):
        load_nlm(str(not_lm))


def test_score_lm_matches_jax_files(corpus, port_nlm):
    """Both LMs, the port's CLI against the JAX CLI on the same inputs."""
    jax_train_lm.main(["-text", str(corpus / "text"), "-order", "3",
                       "-lm", str(corpus / "lm.3.gz")])
    out = {}
    for name, lm in (("arpa", ["-lm", str(corpus / "lm.3.gz")]),
                     ("nlm", ["-nlm_model_dir", str(port_nlm),
                              "-read_vocab_file", str(corpus / "vocab.txt"),
                              "-batch_size", "5"])):
        for pkg, main, extra in (("jax", jax_score_lm.main, []),
                                 ("port", score_lm.main,
                                  ["-device", "cpu"])):
            path = corpus / f"{pkg}_{name}.txt"
            assert main(["-decode_file", str(corpus / "decode.txt"), *lm,
                         "-save_score_file", str(path), *extra]) == 0
            out[pkg, name] = path
    assert open(out["port", "arpa"]).read() == open(out["jax", "arpa"]).read()
    got, want = _floats(out["port", "nlm"]), _floats(out["jax", "nlm"])
    assert len(got) == len(want) == 12
    np.testing.assert_allclose(got, want, atol=NLM_SCORE_ATOL)
    assert len(set(got)) > 6  # the scores tell the hypotheses apart
