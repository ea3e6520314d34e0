"""The port's streaming encoders (pytorch_kaldi_asr_tpu_torch/models/
streaming.py) against the JAX package's, on the same weights and the same
chunks, and against the port's own offline encoders, on the CPU.

Chunk sizes 1, 7 and 40 and a ragged sequence; every output within 1e-5
of the largest entry of JAX's streamed output, and of the port's offline
encoder output.  ``StreamingBandedEncoder``, the causal
``StreamingConformer``, ``StreamingTDNN`` (tdnn and tdnnf),
``StreamingAM`` with log-priors and ``FixedChunkStream``; the non-causal
configurations raise, as in JAX.
"""

import jax
import numpy as np
import pytest
import torch

from pytorch_kaldi_asr_tpu.models import am as jax_am
from pytorch_kaldi_asr_tpu.models import streaming as jax_streaming
from pytorch_kaldi_asr_tpu.models.transformer import encode as jax_encode
from pytorch_kaldi_asr_tpu_torch.models import am, streaming
from pytorch_kaldi_asr_tpu_torch.models.transformer import encode
from pytorch_kaldi_asr_tpu_torch.train.checkpoint import params_from_jax
from tests.torch_port_helpers import configs, jax_params

torch.set_num_threads(1)

RTOL = 1e-5  # of the largest entry
T = 47  # frames streamed
CHUNKINGS = {"1": [1] * T, "7": [7] * 7, "40": [40, 40],
             "ragged": [5, 1, 13, 2, 40]}


def _cfgs(encoder_type, **kw):
    return configs(encoder_type=encoder_type, encoder_sub_sequence=(-8, 0),
                   encoder_max_len=64, conformer_kernel=5,
                   tdnnf_bottleneck=8, **kw)


def _src(cfg, seed=3, b=2):
    return np.random.default_rng(seed).normal(
        size=(b, T, cfg.src_dim)).astype(np.float32)


def _stream(frontend, src, sizes, flush=True):
    outs, lo = [], 0
    for n in sizes:
        out = frontend.push(src[:, lo:lo + n])
        lo += n
        if out is not None:
            outs.append(np.asarray(out.cpu() if isinstance(out, torch.Tensor)
                                   else out))
    if flush:
        tail = frontend.flush()
        if tail is not None:
            outs.append(np.asarray(tail.cpu() if isinstance(
                tail, torch.Tensor) else tail))
    return np.concatenate(outs, axis=1)


def _assert_close(got, want):
    assert got.shape == want.shape
    tol = RTOL * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _offline(params, cfg, src):
    out, _ = encode(params, cfg, torch.from_numpy(src),
                    torch.ones(src.shape[:2], dtype=torch.uint8))
    return out.numpy()


@pytest.mark.parametrize("chunks", list(CHUNKINGS))
@pytest.mark.parametrize("kind", ["banded", "conformer"])
def test_streaming_attention_encoders_match_jax_and_offline(kind, chunks):
    extra = {"conformer_causal_conv": True} if kind == "conformer" else {}
    jcfg, cfg = _cfgs(kind, **extra)
    jparams, params = jax_params(jcfg, seed=4)
    src = _src(cfg)
    jcls, cls = {"banded": (jax_streaming.StreamingBandedEncoder,
                            streaming.StreamingBandedEncoder),
                 "conformer": (jax_streaming.StreamingConformer,
                               streaming.StreamingConformer)}[kind]
    sizes = CHUNKINGS[chunks]
    got = _stream(cls(params["encoder"], cfg), src, sizes)
    _assert_close(got, _stream(jcls(jparams["encoder"], jcfg), src, sizes))
    _assert_close(got, _offline(params, cfg, src))


@pytest.mark.parametrize("chunks", ["7", "ragged"])
@pytest.mark.parametrize("kind", ["tdnn", "tdnnf"])
def test_streaming_tdnn_matches_jax_and_offline(kind, chunks):
    jcfg, cfg = _cfgs(kind)
    jparams, params = jax_params(jcfg, seed=5)
    src = _src(cfg, seed=6)
    sizes = CHUNKINGS[chunks]
    got = _stream(streaming.StreamingTDNN(params, cfg, encode), src, sizes)
    want = _stream(jax_streaming.StreamingTDNN(jparams, jcfg, jax_encode),
                   src, sizes)
    _assert_close(got, want)
    _assert_close(got, _offline(params, cfg, src))
    assert streaming.receptive_field(cfg) == \
        jax_streaming.receptive_field(jcfg)


def _am_params(jcfg, n_targets, seed):
    jparams = jax_am.init_am(jax.random.PRNGKey(seed), jcfg, n_targets)
    return jparams, params_from_jax(jax.device_get(jparams))


@pytest.mark.parametrize("kind", ["banded", "conformer"])
def test_streaming_am_with_priors_matches_jax_and_offline(kind):
    extra = {"conformer_causal_conv": True} if kind == "conformer" else {}
    jcfg, cfg = _cfgs(kind, **extra)
    n_targets = 6
    jparams, params = _am_params(jcfg, n_targets, seed=7)
    log_priors = np.log(np.random.default_rng(8).dirichlet(
        np.ones(n_targets))).astype(np.float32)
    src = _src(cfg, seed=9)
    sizes = CHUNKINGS["ragged"]
    got = _stream(streaming.StreamingAM(params, cfg, log_priors=log_priors),
                  src, sizes)
    want = _stream(jax_streaming.StreamingAM(jparams, jcfg,
                                             log_priors=log_priors),
                   src, sizes)
    _assert_close(got, want)
    offline, _ = am.am_log_posteriors(
        params, cfg, torch.from_numpy(src),
        torch.ones(src.shape[:2], dtype=torch.uint8),
        log_priors=torch.from_numpy(log_priors))
    _assert_close(got, offline.numpy())


@pytest.mark.parametrize("chunk", [1, 7, 40])
def test_fixed_chunk_stream_matches_jax_and_offline(chunk):
    """Client pushes of any size re-chunked to ``chunk`` frames, the ragged
    tail padded at flush and sliced off; AM log-posteriors and the tdnn
    AM through StreamingTDNN."""
    jcfg, cfg = _cfgs("conformer", conformer_causal_conv=True)
    jparams, params = _am_params(jcfg, 5, seed=11)
    src = _src(cfg, seed=12)
    sizes = CHUNKINGS["ragged"]
    got = _stream(streaming.FixedChunkStream(
        streaming.StreamingAM(params, cfg), chunk=chunk), src, sizes)
    want = _stream(jax_streaming.FixedChunkStream(
        jax_streaming.StreamingAM(jparams, jcfg), chunk=chunk), src, sizes)
    _assert_close(got, want)
    offline, _ = am.am_log_posteriors(
        params, cfg, torch.from_numpy(src),
        torch.ones(src.shape[:2], dtype=torch.uint8))
    _assert_close(got, offline.numpy())
    # the tdnn AM streams by overlap recompute (the hybrid server's tdnn
    # frontend): am_log_posteriors with the global position offset
    jcfg, cfg = _cfgs("tdnn")
    jparams, params = _am_params(jcfg, 5, seed=13)
    got = _stream(streaming.StreamingTDNN(params, cfg, am.am_log_posteriors),
                  src, sizes)
    want = _stream(jax_streaming.StreamingTDNN(jparams, jcfg,
                                               jax_am.am_log_posteriors),
                   src, sizes)
    _assert_close(got, want)


def test_noncausal_configurations_raise():
    _, banded = _cfgs("banded")
    _, params = jax_params(_cfgs("banded")[0])
    with pytest.raises(ValueError, match="causal band"):
        streaming.StreamingBandedEncoder(
            params["encoder"], banded.replace(encoder_sub_sequence=(-8, 2)))
    jconf, conf = _cfgs("conformer", conformer_causal_conv=True)
    _, cparams = jax_params(jconf)
    with pytest.raises(ValueError, match="conformer_causal_conv"):
        streaming.StreamingConformer(
            cparams["encoder"], conf.replace(conformer_causal_conv=False))
    with pytest.raises(ValueError, match="causal band"):
        streaming.StreamingConformer(
            cparams["encoder"], conf.replace(encoder_sub_sequence=(-8, 2)))
    with pytest.raises(ValueError, match="StreamingTDNN"):
        streaming.StreamingAM({"encoder": params["encoder"]},
                              banded.replace(encoder_type="tdnn"))
    with pytest.raises(ValueError, match="tdnn/tdnnf"):
        streaming.StreamingTDNN(params, banded, encode)
    with pytest.raises(ValueError, match="positive"):
        streaming.FixedChunkStream(None, chunk=0)
