"""The port's beam search (decode/beam.py, fast_beam.py) against the JAX
package's ``fast_beam_search``: identical tokens, lengths and finished
flags, scores to atol 1e-5 (float32 sums in another order).  Each case
asserts that its top-``beam`` scores are more than 1e-4 apart, so that a
float-level difference cannot legitimately reorder the beam."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_kaldi_asr_tpu.decode.beam import _advance as jax_advance
from pytorch_kaldi_asr_tpu.decode.fast_beam import (
    fast_beam_search as jax_search,
    fast_beam_search_memory as jax_search_memory,
)
from pytorch_kaldi_asr_tpu.models.transformer import encode as jax_encode
from pytorch_kaldi_asr_tpu_torch.decode.beam import _advance, top_k_lowest_index
from pytorch_kaldi_asr_tpu_torch.decode.fast_beam import (
    _search_from_memory,
    fast_beam_search,
)
from tests.torch_port_helpers import configs, jax_params, source_batch, t

torch.set_num_threads(1)

ATOL = 1e-5
MIN_GAP = 1e-4


def test_top_k_tie_order_is_lowest_index_first():
    x = torch.tensor([[0.5, 1, 1, 0.2, 1, -np.inf, -np.inf, 1]])
    _, idx = top_k_lowest_index(x, 4)
    assert idx.tolist() == [[1, 2, 4, 7]]
    _, jidx = jax.lax.top_k(jnp.asarray(x.numpy()), 4)
    assert np.asarray(jidx).tolist() == [[1, 2, 4, 7]]


def test_advance_matches_jax_with_ties_and_finished_lanes():
    b, beam, vocab = 2, 3, 5
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, vocab, size=(b * beam, 6)).astype(np.int32)
    scores = np.array([[0.0, -1.0, -np.inf], [-0.5, -0.5, -2.0]], np.float32)
    finished = np.array([[False, True, False], [True, False, False]])
    lengths = np.array([[7, 3, 7], [2, 7, 7]], np.int32)
    word_lk = np.log(rng.dirichlet(np.ones(vocab), size=b * beam)).astype(
        np.float32)
    word_lk[3:, 1] = word_lk[3:, 2]  # ties inside a lane
    want, want_parent = jax_advance(
        tuple(jnp.asarray(x) for x in (tokens, scores, finished, lengths)),
        jnp.asarray(word_lk), 2, beam, vocab)
    got, parent = _advance((t(tokens), t(scores), t(finished), t(lengths)),
                           t(word_lk), 2, beam, vocab)
    np.testing.assert_array_equal(parent.numpy(), np.asarray(want_parent))
    for a, w in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(w))


def _gaps_ok(scores):
    s = np.sort(np.asarray(scores), axis=1)[:, ::-1]
    finite = np.isfinite(s[:, :-1]) & np.isfinite(s[:, 1:])
    return np.all(np.abs(np.diff(s, axis=1))[finite] > MIN_GAP)


def _assert_same(got, want):
    assert _gaps_ok(want.scores), "choose another seed: near-tied scores"
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  np.asarray(want.lengths))
    np.testing.assert_array_equal(got.finished.numpy(),
                                  np.asarray(want.finished))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               atol=ATOL)


@pytest.mark.parametrize("encoder_type,seed,beam,max_len", [
    ("banded", 0, 4, 10),
    ("banded", 1, 4, 10),
    ("tdnn", 2, 4, 10),
])
def test_fast_beam_search_matches_jax(encoder_type, seed, beam, max_len):
    jcfg, pcfg = configs(encoder_type=encoder_type)
    jparams, params = jax_params(jcfg, seed=seed)
    src, mask = source_batch(jcfg, s=20, seed=seed)
    want = jax_search(jparams, jcfg, src, mask, beam_size=beam,
                      max_len=max_len)
    got = fast_beam_search(params, pcfg, t(src), t(mask), beam_size=beam,
                           max_len=max_len)
    _assert_same(got, want)


def test_window_wider_than_the_search():
    jcfg, pcfg = configs(decoder_sub_sequence=(-20, 0))
    jparams, params = jax_params(jcfg, seed=9)
    src, mask = source_batch(jcfg, seed=9)
    want = jax_search(jparams, jcfg, src, mask, beam_size=3, max_len=8)
    got = fast_beam_search(params, pcfg, t(src), t(mask), beam_size=3,
                           max_len=8)
    _assert_same(got, want)


def test_forced_prefix_search_matches_jax():
    jcfg, pcfg = configs()
    jparams, params = jax_params(jcfg, seed=3)
    src, mask = source_batch(jcfg, b=2, seed=3)
    enc, enc_mask = jax_encode(jparams, jcfg, src, mask)
    prefix = np.array([[5, 6], [7, 4]], np.int32)
    want = jax_search_memory(jparams, jcfg, enc, enc_mask, prefix,
                             beam_size=3, max_len=9)
    with torch.no_grad():
        got = _search_from_memory(params, pcfg, t(np.asarray(enc)),
                                  t(np.asarray(enc_mask)), t(prefix),
                                  beam_size=3, max_len=9)
    _assert_same(got, want)
