"""The port's hybrid acoustic model (models/am.py, recipes/train_am.py)
against the JAX package's, on the CPU, with the JAX parameters carried
over by ``params_from_jax``.

- ``am_log_posteriors`` within 1e-5 of JAX's for the tdnnf, banded and
  conformer (band (-16, 8)) encoders, with and without log-priors; the
  conformer attends through the banded kernels' plain versions, JAX's
  through its blocked XLA op (the same function).
- ``frame_ce_loss``'s (loss, n_correct, n_frames) and its gradients
  against ``jax.grad`` at dropout 0, on a batch whose last row repeats the
  first and is marked invalid (the loader's 'all' tail): loss within 1e-6
  relative, gradients within 1e-5 of each leaf's largest entry.
- The frame-target loader's batches equal JAX's (src, tgt, masks, valid)
  in 'drop' and 'all' mode, over two epochs; its errors are JAX's.
- ``train_am`` with the tdnnf takes its ``semi_orthogonal_step`` on the
  same updates as JAX's (every 4, counted across epochs); its step draws
  SpecAugment's masks before the dropout seeds; it refuses ``seq_shards``
  > 1, ids past the head, and (with dump_posteriors) no card without
  ``-device cpu``.
- The long-form attention case: the plain K1 and K2 (forward, dq, dk, dv)
  at S 1000 (no multiple of the 64-frame tile), band (-100, 50) and
  ragged lengths against the JAX Pallas kernels in interpret mode (S
  padded to their 128-row block), at dropout 0 and 0.1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_kaldi_asr_tpu.models import am as jax_am
from pytorch_kaldi_asr_tpu.ops.banded_attention import (
    banded_attention_pallas,
    banded_attention_trainable as jax_trainable,
)
from pytorch_kaldi_asr_tpu.recipes import train_am as jax_train_am
from pytorch_kaldi_asr_tpu.tools.make_synthetic_data import make_dataset
from pytorch_kaldi_asr_tpu_torch.models import am
from pytorch_kaldi_asr_tpu_torch.ops import banded_attention as ba
from pytorch_kaldi_asr_tpu_torch.recipes import train_am
from pytorch_kaldi_asr_tpu_torch.train.checkpoint import params_from_jax
from tests.torch_port_helpers import configs, leaves, source_batch, t

torch.set_num_threads(1)

ATOL = 1e-5
LOSS_RTOL = 1e-6
GRAD_RTOL = 1e-5  # of the largest |gradient| of the leaf
N_TARGETS = 7

ENCODERS = {
    "tdnnf": dict(encoder_type="tdnnf", tdnnf_bottleneck=8),
    "banded": dict(encoder_type="banded"),
    "conformer": dict(encoder_type="conformer", n_head=2, d_k=16, d_v=16,
                      conformer_kernel=5, encoder_sub_sequence=(-16, 8)),
}


def _am(name, seed=0):
    jcfg, pcfg = configs(**ENCODERS[name])
    init = jax.jit(jax_am.init_am, static_argnums=(1, 2))
    jparams = init(jax.random.PRNGKey(seed), jcfg, N_TARGETS)
    return jcfg, pcfg, jparams, params_from_jax(jax.device_get(jparams))


@pytest.mark.parametrize("priors", [False, True], ids=["posteriors",
                                                       "minus_priors"])
@pytest.mark.parametrize("name", list(ENCODERS))
def test_am_log_posteriors_match_jax(name, priors):
    jcfg, pcfg, jparams, params = _am(name, seed=1)
    src, mask = source_batch(jcfg, s=24, short_row=15)
    log_priors = (np.log(np.random.default_rng(2).dirichlet(
        np.ones(N_TARGETS))).astype(np.float32) if priors else None)
    fn = jax.jit(lambda p, x, m, lp: jax_am.am_log_posteriors(
        p, jcfg, x, m, log_priors=lp))
    want, want_mask = fn(jparams, src, mask, log_priors)
    got, got_mask = am.am_log_posteriors(
        params, pcfg, t(src), t(mask),
        log_priors=None if log_priors is None else t(log_priors))
    assert got.shape == (3, 24, N_TARGETS) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))


@pytest.mark.parametrize("name", ["conformer", "tdnnf"])
def test_frame_ce_loss_and_grads_match_jax(name):
    jcfg, pcfg, jparams, params = _am(name, seed=3)
    src, mask = source_batch(jcfg, b=4, s=24, short_row=15)
    src[3], mask[3] = src[0], mask[0]  # the 'all' tail repeats a row
    valid = np.array([1, 1, 1, 0], np.uint8)
    tgt = np.random.default_rng(4).integers(0, N_TARGETS, (4, 24)).astype(
        np.int32)

    def jax_loss(p):
        loss, n_correct, n = jax_am.frame_ce_loss(
            p, jcfg, src, mask, jnp.asarray(tgt), utt_valid=valid)
        return loss, (n_correct, n)

    (want_loss, (want_c, want_n)), want_grads = jax.jit(
        jax.value_and_grad(jax_loss, has_aux=True))(jparams)
    for leaf in leaves(params):
        leaf.requires_grad_(True)
    loss, n_correct, n = am.frame_ce_loss(params, pcfg, t(src), t(mask),
                                          t(tgt), utt_valid=t(valid))
    loss.backward()
    assert abs(float(loss.detach()) - float(want_loss)) <= LOSS_RTOL * abs(
        float(want_loss))
    assert float(n_correct) == float(want_c)
    assert float(n) == float(want_n) == mask[:3].sum()
    got = leaves(params)
    want = jax.tree_util.tree_leaves(want_grads)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.grad.numpy(), w,
                                   atol=GRAD_RTOL * max(np.abs(w).max(),
                                                        1e-30))


def _corpus(tmp_path, n_train=10, n_dev=5):
    """A tiny corpus with frame alignments, written by the JAX package's
    make_synthetic_data."""
    means = make_dataset(str(tmp_path / "train"), n_train, feat_dim=6,
                         seed=0, frames_per_word=4)
    make_dataset(str(tmp_path / "dev"), n_dev, feat_dim=6, seed=1,
                 frames_per_word=4, word_means=means)
    return tmp_path / "train", tmp_path / "dev"


@pytest.mark.parametrize("mode", ["drop", "all"])
def test_frame_target_loader_matches_jax(tmp_path, mode):
    train, _ = _corpus(tmp_path)
    kw = dict(mode=mode, num_buckets=2) if mode == "drop" else dict(
        mode=mode, shuffle=False)
    ours = train_am.am_batch_loader(str(train), 3, **kw)
    theirs = jax_train_am.am_batch_loader(str(train), 3, **kw)
    for _ in range(2):
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g.keys == w.keys
            for field in ("src", "src_mask", "tgt", "tgt_mask", "valid"):
                np.testing.assert_array_equal(getattr(g, field),
                                              getattr(w, field))
            assert g.tgt.shape == g.src.shape[:2]
    if mode == "all":
        assert not got[-1].valid.all()  # 10 utterances in batches of 3


def test_am_batch_loader_errors_match_jax(tmp_path):
    train, _ = _corpus(tmp_path)
    ali = (train / "ali.txt").read_text().splitlines()
    ali[0] = ali[0] + " 1"
    (train / "ali.txt").write_text("\n".join(ali) + "\n")
    for loader in (train_am.am_batch_loader, jax_train_am.am_batch_loader):
        with pytest.raises(ValueError, match="alignment ids vs"):
            loader(str(train), 3)


def test_train_am_refusals(tmp_path, monkeypatch):
    """Alignment ids past the head, sequence parallelism of an encoder that
    has none and NCCL with more ranks than cards, and (for train_am and
    dump_posteriors) no card without ``-device cpu``."""
    from pytorch_kaldi_asr_tpu_torch.recipes import dump_posteriors

    train, dev = _corpus(tmp_path)
    with pytest.raises(ValueError, match="n_targets"):
        train_am.train_am(str(train), str(dev), str(tmp_path / "am"),
                          n_targets=3, device="cpu")
    with pytest.raises(ValueError, match="no sequence-parallel forward"):
        train_am.train_am(str(train), str(dev), str(tmp_path / "am"),
                          seq_shards=2, device="cpu")  # the tdnnf default
    with pytest.raises(ValueError, match="NCCL refuses two ranks"):
        train_am.train_am(str(train), str(dev), str(tmp_path / "am"),
                          encoder_type="banded", seq_shards=2,
                          device="cuda", dist_backend="nccl")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="-device cpu"):
        train_am.main(["-read_train_dir", str(train), "-read_dev_dir",
                       str(dev), "-save_model_dir", str(tmp_path / "m")])
    with pytest.raises(RuntimeError, match="-device cpu"):
        dump_posteriors.main(["-read_data_dir", str(dev), "-load_model_file",
                              str(tmp_path / "m"), "-wspecifier",
                              f"ark:{tmp_path / 'p.ark'}"])


def test_am_train_step_draws_specaugment_then_dropout():
    """``-specaugment``: the step masks the features from its generator
    first, then draws the dropout seeds from the same generator."""
    from pytorch_kaldi_asr_tpu_torch.models.transformer import tree_map
    from pytorch_kaldi_asr_tpu_torch.ops.specaugment import spec_augment
    from pytorch_kaldi_asr_tpu_torch.train.state import step_rngs

    _, pcfg = configs(**ENCODERS["conformer"], en_dropout=0.1)
    params = am.init_am(torch.Generator().manual_seed(5), pcfg, N_TARGETS)
    src, mask = source_batch(pcfg, s=24, short_row=15)
    tgt = t(np.random.default_rng(6).integers(0, N_TARGETS, (3, 24)))
    kw = dict(freq_width=3, time_width=5)
    state = train_am.create_am_state(tree_map(torch.clone, params), seed=7)
    loss, _ = train_am.am_train_step(state, pcfg, t(src), t(mask), tgt,
                                     specaugment=kw)
    rngs = step_rngs(7, 0)
    masked = spec_augment(rngs.seeds, t(src), t(mask), **kw)
    assert not torch.equal(masked, t(src))
    want, _, n = am.frame_ce_loss(params, pcfg, masked, t(mask), tgt,
                                  train=True, rngs=rngs)
    assert float(loss) == float(want / n)
    assert state.step == 1


def test_train_am_semi_orthogonal_steps_match_jax(tmp_path, monkeypatch):
    """3 batches an epoch over 3 epochs: updates 4 and 8 take the step in
    both packages (a count per epoch would take none)."""
    train, dev = _corpus(tmp_path, n_train=9, n_dev=3)
    calls = {"jax": 0, "port": []}
    jax_step = jax_train_am.semi_orthogonal_step
    port_step = train_am.semi_orthogonal_step
    updates = []
    port_train_step = train_am.am_train_step

    def count_jax(params):
        calls["jax"] += 1
        return jax_step(params)

    def count_port(params):
        calls["port"].append(len(updates))
        return port_step(params)

    def step(*a, **kw):
        updates.append(1)
        return port_train_step(*a, **kw)

    monkeypatch.setattr(jax_train_am, "semi_orthogonal_step", count_jax)
    monkeypatch.setattr(train_am, "semi_orthogonal_step", count_port)
    monkeypatch.setattr(train_am, "am_train_step", step)
    kw = dict(encoder_type="tdnnf", epochs=3, batch_size=3, en_d_model=16,
              en_dropout=0.0)
    jax_train_am.train_am(str(train), str(dev), str(tmp_path / "jax"), **kw)
    params, cfg, acc, steps = train_am.train_am(
        str(train), str(dev), str(tmp_path / "port"), device="cpu", **kw)
    assert steps == len(updates) == 9
    assert calls["port"] == [4, 8]
    assert calls["jax"] == len(calls["port"])
    assert 0.0 <= acc <= 1.0
    # the factor matrices stay the optimizer's leaves (updated in place)
    assert all(p.requires_grad for p in leaves(params))


# the long-form case: S 1000 (not a multiple of the 64-frame tile), the
# longform recipe's band (-100, 50), ragged lengths with a short row
LONG = dict(bh=3, s=1000, d=16, lengths=[1000, 613, 77], start=-100, end=50)


def _long_inputs(seed):
    rng = np.random.default_rng(seed)
    bh, s, d = LONG["bh"], LONG["s"], LONG["d"]
    q, k, v, dout = (rng.normal(size=(bh, s, d)).astype(np.float32)
                     for _ in range(4))
    valid = (np.arange(s)[None, :] < np.asarray(LONG["lengths"])[:, None]
             ).astype(np.int32)
    return q, k, v, valid, dout


def _pad_rows(x, s_pad):
    return np.pad(x, [(0, 0), (0, s_pad - x.shape[1])] + [(0, 0)] * (x.ndim
                                                                  - 2))


def test_longform_plain_k1_matches_jax_kernel():
    q, k, v, valid, _ = _long_inputs(5)
    scale = 1.0 / np.sqrt(144.0)
    want = np.asarray(banded_attention_pallas(
        *(jnp.asarray(_pad_rows(x, 1024)) for x in (q, k, v, valid)),
        start=LONG["start"], end=LONG["end"], scale=scale, block_q=128,
        interpret=True))[:, :LONG["s"]]
    got = ba.banded_attention(*(torch.from_numpy(x) for x in (q, k, v, valid)),
                              start=LONG["start"], end=LONG["end"],
                              scale=scale)
    assert got.shape == (3, 1000, 16)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_longform_plain_k2_matches_jax_kernels(rate):
    q, k, v, valid, dout = _long_inputs(6)
    seed, scale, s = 11, 1.0 / np.sqrt(144.0), LONG["s"]
    band = (LONG["start"], LONG["end"])
    padded = [jnp.asarray(_pad_rows(x, 1024)) for x in (q, k, v, dout)]
    out, vjp = jax.vjp(
        lambda q, k, v: jax_trainable(
            q, k, v, jnp.asarray(_pad_rows(valid, 1024)), jnp.int32(seed),
            *band, scale, rate, 128, True), *padded[:3])
    want = [np.asarray(x)[:, :s] for x in (out, *vjp(padded[3]))]
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got = ba.banded_attention_trainable(
        tq, tk, tv, torch.from_numpy(valid), seed, start=band[0],
        end=band[1], scale=scale, dropout_rate=rate)
    got.backward(torch.from_numpy(dout))
    for g, w, tol in zip((got, tq.grad, tk.grad, tv.grad), want,
                         (2e-5, 1e-4, 1e-4, 1e-4)):
        np.testing.assert_allclose(g.detach().numpy(), w, atol=tol)
    # invalid keys get no gradient; rows past a short row's band are zeros
    assert not tk.grad.numpy()[valid == 0].any()
    empty = np.arange(s)[None, :] + band[0] >= np.asarray(
        LONG["lengths"])[:, None]
    assert empty.any() and not got.detach().numpy()[empty].any()
