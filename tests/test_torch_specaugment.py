"""SpecAugment (ops/specaugment.py) of the port, on the CPU.

The masks come from a torch generator, not ``jax.random``, so they cannot
equal the JAX package's (ROADMAP.md queue 3, deliberate difference 1).
What is held:

- exactly, the invariants: a masked entry is exactly 0 and every other
  entry bit-equal to its input; the masked set is whole frequency bands and
  whole time spans, each span inside its utterance's length, no band wider
  than ``freq_width`` and no span wider than ``min(time_width,
  ⌊max_time_frac·length⌋)``; the same (seed, step) gives the same masks,
  whatever the features' dtype (the device only holds the features);
- statistically, against the JAX package's ``spec_augment`` on all-ones
  features, N_DRAWS utterances each: the distributions of the frequency
  band's width and start and the time span's width and start, by a
  two-sample χ² test at P_MIN (fixed seeds, so the test is deterministic);
- in the train step: the masks are drawn from the step's generator before
  its dropout seeds; and ``train -specaugment -device cpu`` end to end.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import chi2_contingency

from pytorch_kaldi_asr_tpu.ops.specaugment import (
    spec_augment as jax_spec_augment,
)
from pytorch_kaldi_asr_tpu_torch.ops.specaugment import (
    apply,
    draw,
    spec_augment,
)
from pytorch_kaldi_asr_tpu_torch.recipes import initialize_model, train
from pytorch_kaldi_asr_tpu_torch.train import create_train_state, train_step
from pytorch_kaldi_asr_tpu_torch.train.state import (
    loss_and_metrics,
    step_rngs,
)
from tests.torch_port_helpers import configs, jax_params, t, write_data_dir

torch.set_num_threads(1)

N_DRAWS = 3000
P_MIN = 1e-3


def _feats(b=6, s=90, d=40, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(b, s, d)).astype(np.float32) + 3.0  # no zeros
    lengths = np.array([90, 80, 61, 40, 9, 1][:b])
    mask = (np.arange(s)[None] < lengths[:, None]).astype(np.uint8)
    return t(feats), t(mask), lengths


def test_masks_are_whole_bands_and_spans_within_bounds():
    feats, mask, lengths = _feats()
    for seed in range(20):
        out = spec_augment(torch.Generator().manual_seed(seed), feats, mask)
        zero = out == 0
        assert torch.equal(out[~zero], feats[~zero])  # bit-equal elsewhere
        for row, n in enumerate(lengths):
            z = zero[row].numpy()
            bands = z.all(axis=0)  # whole frequency bands
            spans = z[:, ~bands].any(axis=1) if (~bands).any() else \
                np.zeros(z.shape[0], bool)
            # what is zero is a band or a span, nothing else
            np.testing.assert_array_equal(z, bands[None] | spans[:, None])
            assert not spans[n:].any()  # spans lie inside the utterance
            # at most 2 bands of width <= 15 and 2 spans of width <= max_w
            assert bands.sum() <= 2 * 15
            assert spans.sum() <= 2 * min(50, int(n * 0.2))


def test_same_seed_and_step_give_the_same_masks_in_any_dtype():
    feats, mask, _ = _feats()
    keep = [apply(draw(step_rngs(5, 3).seeds, 6), feats.to(dtype), mask) != 0
            for dtype in (torch.float32, torch.float64, torch.bfloat16)]
    assert torch.equal(keep[0], keep[1]) and torch.equal(keep[0], keep[2])
    other = apply(draw(step_rngs(5, 4).seeds, 6), feats, mask) != 0
    assert not torch.equal(keep[0], other)
    assert draw(torch.Generator().manual_seed(1), 6).shape == (4, 2, 6)


def _widths_and_starts(zero):
    """Per row of a [N, L] mask of one zeroed band: (width, start) with
    start -1 where the width is 0."""
    width = zero.sum(axis=1)
    start = np.where(width > 0, zero.argmax(axis=1), -1)
    return width, start


def _chi2_p(a, b, bins):
    counts = np.stack([np.histogram(a, bins)[0], np.histogram(b, bins)[0]])
    counts = counts[:, counts.sum(axis=0) > 0]
    return chi2_contingency(counts)[1]


@pytest.mark.parametrize("axis", ["frequency", "time"])
def test_widths_and_starts_match_jax_distributions(axis):
    """One mask on N_DRAWS all-ones utterances (D 40 features; for time,
    80 valid frames of 90: widths up to 16): widths in one bin each,
    starts in 8 bins, JAX against the port."""
    n, s, d = N_DRAWS, (4, 90)[axis == "time"], (40, 2)[axis == "time"]
    ones = np.ones((n, s, d), np.float32)
    mask = np.zeros((n, s), np.uint8)
    mask[:, :80 if axis == "time" else s] = 1
    masks = dict(n_freq_masks=1, n_time_masks=0) if axis == "frequency" \
        else dict(n_freq_masks=0, n_time_masks=1)
    want = np.asarray(jax_spec_augment(jax.random.key(11), jnp.asarray(ones),
                                       jnp.asarray(mask), **masks)) == 0
    got = spec_augment(torch.Generator().manual_seed(11), t(ones), t(mask),
                       **masks).numpy() == 0
    zero = (lambda z: z[:, 0, :]) if axis == "frequency" else \
        (lambda z: z[:, :, 0])
    (jw, js), (pw, ps) = (_widths_and_starts(zero(z)) for z in (want, got))
    top = 15 if axis == "frequency" else 16
    assert jw.max() <= top and pw.max() <= top
    assert _chi2_p(jw, pw, np.arange(top + 2)) >= P_MIN
    span = d if axis == "frequency" else 80
    starts = np.linspace(0, span, 9)
    assert _chi2_p(js[jw > 0], ps[pw > 0], starts) >= P_MIN
    # every draw's span fits: the start quirk [0, max(D - w, 1)) for
    # frequency, [0, length - w] for time
    end = ps + pw
    assert (end[pw > 0] <= span).all()


def test_train_step_draws_masks_before_dropout_seeds():
    """``train_step(specaugment=True)`` is the step on features masked from
    the step's generator, whose next draws are the dropout seeds."""
    _, pcfg = configs(encoder_type="tdnnf", tdnnf_bottleneck=8,
                      en_dropout=0.2, de_dropout=0.2)
    _, params = jax_params(configs(encoder_type="tdnnf",
                                   tdnnf_bottleneck=8)[0], seed=1)
    rng = np.random.default_rng(2)
    src = t(rng.normal(size=(2, 30, pcfg.src_dim)).astype(np.float32))
    src_mask = t(np.ones((2, 30), np.uint8))
    tgt = t(np.array([[2, 4, 5, 3], [2, 6, 3, 0]], np.int32))
    tgt_mask = (tgt != 0).to(torch.uint8)
    rngs = step_rngs(7, 0)
    masked = spec_augment(rngs.seeds, src, src_mask)
    assert (masked == 0).any()
    want, _, _ = loss_and_metrics(params, pcfg, masked, src_mask, tgt,
                                  tgt_mask, train=True, rngs=rngs)
    state = create_train_state(params, seed=7)
    got = train_step(state, pcfg, src, src_mask, tgt, tgt_mask,
                     specaugment=True)
    assert float(got["loss"]) == float(want)


def test_train_cli_runs_with_specaugment(tmp_path):
    data = write_data_dir(tmp_path / "data", n_utts=6, seed=4,
                          lengths=(20, 40))
    flags = ["-read_vocab_file", str(data / "vocab.txt")]
    initialize_model.main([
        "-read_feats_scp_file", str(data / "feats.scp"), "-lda_mat_file",
        "identity", *flags, "-encoder_max_len", "48", "-decoder_max_len",
        "8", "-en_layers", "1", "-de_layers", "1", "-n_head", "2",
        "-en_d_model", "16", "-de_d_model", "8", "-d_k", "4", "-d_v", "4",
        "-encoder_type", "banded", "-save_model_file", str(tmp_path / "m")])
    losses = {}
    for name, extra in (("on", ["-specaugment"]), ("off", [])):
        exp = tmp_path / name
        assert train.main([
            "-read_train_dir", str(data), "-read_dev_dir", str(data),
            "-read_test_dir", str(data), *flags, "-load_model_file",
            str(tmp_path / "m"), "-save_model_dir", str(exp), "-epoch", "1",
            "-batch_size", "3", "-save_interval", "1", "-device", "cpu",
            *extra]) == 0
        [record] = [json.loads(x) for x in open(exp / "metrics.jsonl")]
        losses[name] = record["train_loss"]
        assert np.isfinite(record["train_loss"])
        assert len(list(exp.glob("combined.accu*"))) == 1
    assert losses["on"] != losses["off"]
