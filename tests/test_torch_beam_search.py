"""The port's fixed-buffer ``beam_search`` (decode/beam.py), the search for
any decoder band:

- against the JAX package's ``beam_search`` on causal and non-causal bands
  at beams 1-5: identical tokens, lengths and finished flags, scores to
  atol 1e-5 (float32 sums in another order); the cases need their
  top-``beam`` scores more than 1e-4 apart unless they are exact ties;
- with exact ties (two words with the same output column) and lanes that
  finish early (a boosted EOS column), where the lowest index wins in both;
- equal to the KV-cached ``fast_beam_search`` on a causal band, where the
  positions after t cannot reach position t;
- against the port's host ``Lattice`` oracle, which decodes the active
  hypotheses step by step, as tests/test_decode.py holds the JAX search.
"""

import jax
import numpy as np
import pytest
import torch

from pytorch_kaldi_asr_tpu.decode.beam import beam_search as jax_beam_search
from pytorch_kaldi_asr_tpu_torch.decode.beam import beam_search
from pytorch_kaldi_asr_tpu_torch.decode.fast_beam import fast_beam_search
from pytorch_kaldi_asr_tpu_torch.decode.lattice import Lattice
from pytorch_kaldi_asr_tpu_torch.decode.runner import nbest_from_result
from pytorch_kaldi_asr_tpu_torch.models.transformer import decode_logits, encode
from pytorch_kaldi_asr_tpu_torch.utils import constants
from tests.torch_port_helpers import configs, jax_params, source_batch, t

torch.set_num_threads(1)

ATOL = 1e-5
MIN_GAP = 1e-4


def _gaps_ok(scores):
    """Neighbouring finite scores of each row are exactly tied or more
    than MIN_GAP apart."""
    s = np.sort(np.asarray(scores), axis=1)[:, ::-1]
    finite = np.isfinite(s[:, :-1]) & np.isfinite(s[:, 1:])
    gaps = np.abs(np.diff(s, axis=1))[finite]
    return np.all((gaps == 0) | (gaps > MIN_GAP))


def _assert_same(got, want, atol=ATOL):
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  np.asarray(want.lengths))
    np.testing.assert_array_equal(got.finished.numpy(),
                                  np.asarray(want.finished))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               atol=atol)


@pytest.mark.parametrize("band,seed,beam", [
    ((-3, 0), 0, 1),
    ((-3, 0), 1, 3),
    ((-3, 1), 2, 2),
    ((-3, 2), 3, 4),
    ((-2, 3), 4, 5),
], ids=["causal-beam1", "causal-beam3", "ahead1-beam2", "ahead2-beam4",
        "ahead3-beam5"])
def test_beam_search_matches_jax(band, seed, beam):
    jcfg, pcfg = configs(decoder_sub_sequence=band)
    jparams, params = jax_params(jcfg, seed=seed)
    src, mask = source_batch(jcfg, s=20, seed=seed)
    want = jax_beam_search(jparams, jcfg, src, mask, beam_size=beam,
                           max_len=9)
    assert _gaps_ok(want.scores), "near-tied scores: choose another seed"
    got = beam_search(params, pcfg, t(src), t(mask), beam_size=beam,
                      max_len=9)
    assert got.tokens.shape == (3, beam, 10)
    _assert_same(got, want)


def _tied_params(cfg, seed):
    """Parameters whose output columns 5 and 6 are equal (every step ties
    those two words exactly) and whose EOS column is boosted, so lanes
    finish early and then compete with the extensions."""
    jparams, params = jax_params(cfg, seed=seed)
    w = np.array(jparams["decoder"]["word_proj"]["w"])
    w[:, 6] = w[:, 5]
    w[:, constants.EOS] *= 3.0
    jparams = jax.tree_util.tree_map(lambda x: x, jparams)
    jparams["decoder"]["word_proj"]["w"] = w
    params["decoder"]["word_proj"]["w"] = torch.from_numpy(w.copy())
    return jparams, params


@pytest.mark.parametrize("band", [(-3, 0), (-3, 1)],
                         ids=["causal", "non-causal"])
def test_ties_and_finished_lanes_match_jax(band):
    jcfg, pcfg = configs(decoder_sub_sequence=band)
    jparams, params = _tied_params(jcfg, seed=7)
    src, mask = source_batch(jcfg, s=16, seed=7)
    want = jax_beam_search(jparams, jcfg, src, mask, beam_size=4, max_len=8)
    got = beam_search(params, pcfg, t(src), t(mask), beam_size=4, max_len=8)
    finished = np.asarray(want.finished)
    assert finished.any() and not finished.all()
    tokens = np.asarray(want.tokens)
    assert ((tokens == 5) | (tokens == 6)).any()
    assert _gaps_ok(want.scores)
    _assert_same(got, want)


@pytest.mark.parametrize("encoder_type,seed", [("banded", 5), ("tdnn", 6)])
def test_beam_search_equals_fast_beam_search_on_a_causal_band(encoder_type,
                                                              seed):
    _, pcfg = configs(encoder_type=encoder_type)
    _, params = jax_params(configs(encoder_type=encoder_type)[0], seed=seed)
    src, mask = source_batch(pcfg, s=18, seed=seed)
    fast = fast_beam_search(params, pcfg, t(src), t(mask), beam_size=4,
                            max_len=10)
    assert _gaps_ok(fast.scores.numpy())
    _assert_same(beam_search(params, pcfg, t(src), t(mask), beam_size=4,
                             max_len=10), fast)


def _lattice_decode(params, cfg, src, mask, beam, max_len):
    """The reference's host loop: grow the active hypotheses of every
    utterance's Lattice and decode them together each step."""
    with torch.no_grad():
        enc, enc_mask = encode(params, cfg, src, mask)
        lattices = [Lattice(max_len, beam) for _ in range(src.shape[0])]
        for _ in range(max_len):
            seqs, owners = [], []
            for i, lat in enumerate(lattices):
                if not lat.done:
                    active = lat.active_sequences()
                    seqs += active
                    owners += [i] * len(active)
            if not seqs:
                break
            arr = torch.tensor(seqs)
            logits = decode_logits(params, cfg, arr, torch.ones_like(arr),
                                   enc_mask[owners], enc[owners])
            word_lk = torch.log_softmax(logits[:, -1], dim=-1).numpy()
            end = 0
            for lat in lattices:
                if not lat.done:
                    start, end = end, end + lat.num_curr_active
                    lat.advance(word_lk[start:end])
    return lattices


@pytest.mark.parametrize("encoder_type", ["banded", "tdnn"])
def test_beam_search_matches_the_lattice_oracle(encoder_type):
    """On a causal band the oracle's growing sequences see what the buffer
    shows.  (On a non-causal band they differ by design: the buffer's PAD
    tokens ahead of t reach position t, in the JAX package too.)"""
    jcfg, cfg = configs(encoder_type=encoder_type)
    _, params = jax_params(jcfg, seed=11)
    src, mask = source_batch(cfg, b=2, s=10, seed=0, short_row=6)
    beam, max_len = 3, 8
    ours = nbest_from_result(beam_search(params, cfg, t(src), t(mask),
                                         beam_size=beam, max_len=max_len),
                             beam)
    for b, lat in enumerate(_lattice_decode(params, cfg, t(src), t(mask),
                                            beam, max_len)):
        seqs, scores = lat.get_results("all")
        for lane, (seq, score) in enumerate(zip(seqs, scores)):
            our_seq, our_score = ours[b][lane]
            # an unfinished oracle hypothesis has no EOS: compare its prefix
            assert our_seq[:len(seq)] == seq, (b, lane, our_seq, seq)
            np.testing.assert_allclose(our_score, score, atol=1e-4)


def test_the_runner_picks_the_search_by_band_and_use_cache():
    from pytorch_kaldi_asr_tpu_torch.decode.beam import beam_search_memory
    from pytorch_kaldi_asr_tpu_torch.decode.fast_beam import (
        fast_beam_search_memory,
    )
    from pytorch_kaldi_asr_tpu_torch.decode.runner import _pick_search

    _, causal = configs()
    _, ahead = configs(decoder_sub_sequence=(-3, 1))
    assert _pick_search(causal, True) is fast_beam_search_memory
    assert _pick_search(causal, False) is beam_search_memory
    assert _pick_search(ahead, True) is beam_search_memory
