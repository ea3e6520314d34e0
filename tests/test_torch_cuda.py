"""Tests of the port that need a CUDA card (marker ``cuda``); without one
they skip.  This file imports neither JAX nor the JAX package, so it runs on
a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py sets up JAX for the rest of the suite.)
"""

import numpy as np
import pytest
import torch

from pytorch_kaldi_asr_tpu_torch.decode.fast_beam import fast_beam_search
from pytorch_kaldi_asr_tpu_torch.models.transformer import (
    TransformerConfig,
    init_transformer,
    tree_map,
)
from pytorch_kaldi_asr_tpu_torch.ops import banded_attention as ba

pytestmark = pytest.mark.cuda

ATOL = 2e-5  # float32; the kernel sums in another order than the plain version


@pytest.fixture
def cuda_device():
    """The first CUDA card, float32 matmuls in full float32; skips the test
    where there is no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from pytorch_kaldi_asr_tpu_torch.utils.device import disable_tf32

    disable_tf32()
    return torch.device("cuda", 0)


def _inputs(device, bh, s, d, dv, valid_len, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k = (torch.randn((bh, s, d), generator=g) for _ in range(2))
    v = torch.randn((bh, s, dv), generator=g)
    valid = (torch.arange(s)[None, :] < torch.as_tensor(valid_len)[:, None])
    return [x.to(device) for x in (q, k, v, valid.to(torch.int32))]


@pytest.mark.parametrize("s,d,dv,start,end", [
    (504, 64, 64, -100, 0),   # the slice's shape
    (256, 32, 32, -64, 32),
    (200, 16, 8, -10, 0),
    (64, 128, 128, -300, 0),  # the largest head dims (dynamic shared memory)
])
def test_kernel_matches_plain_version(cuda_device, s, d, dv, start, end):
    lengths = [s, s // 2, 1, 0]
    q, k, v, valid = _inputs(cuda_device, 4, s, d, dv, lengths, seed=s)
    before = ba.banded_attention.launches
    got = ba.banded_attention(q, k, v, valid, start=start, end=end,
                              scale=0.125)
    want = ba.banded_attention_reference(q, k, v, valid, start, end, 0.125)
    torch.cuda.synchronize()
    assert ba.banded_attention.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=ATOL)
    # rows with no valid key in their band are exact zeros
    empty = torch.arange(s, device=cuda_device)[None, :] + start >= \
        torch.as_tensor(lengths, device=cuda_device)[:, None]
    assert (got[empty] == 0).all()


def test_kernel_refuses_what_it_cannot_take(cuda_device):
    q, k, v, valid = _inputs(cuda_device, 2, 64, 6, 6, [64, 64])
    with pytest.raises(ValueError, match="multiples of 4"):
        ba.banded_attention(q, k, v, valid, start=-4, end=0, scale=1.0)
    q, k, v, valid = _inputs(cuda_device, 2, 64, 8, 8, [64, 64])
    with pytest.raises(TypeError):
        ba.banded_attention(q.double(), k.double(), v.double(), valid,
                            start=-4, end=0, scale=1.0)


def test_beam_search_on_the_card_matches_the_cpu(cuda_device):
    cfg = TransformerConfig(
        src_dim=40, vocab_size=52, encoder_max_len=128, decoder_max_len=20,
        encoder_sub_sequence=(-100, 0), decoder_sub_sequence=(-10, 0),
        en_layers=2, de_layers=2, n_head=2, en_d_model=64, de_d_model=32,
        d_k=16, d_v=16, encoder_type="banded")
    params = init_transformer(torch.Generator().manual_seed(0), cfg)
    g = torch.Generator().manual_seed(1)
    src = torch.randn((3, 120, 40), generator=g)
    mask = torch.ones((3, 120), dtype=torch.uint8)
    mask[2, 70:] = 0
    kw = dict(beam_size=5, max_len=20)
    cpu = fast_beam_search(params, cfg, src, mask, **kw)
    before = ba.banded_attention.launches
    gpu = fast_beam_search(tree_map(lambda x: x.to(cuda_device), params), cfg,
                           src.to(cuda_device), mask.to(cuda_device), **kw)
    assert ba.banded_attention.launches == before + cfg.en_layers
    np.testing.assert_allclose(gpu.scores.cpu().numpy(), cpu.scores.numpy(),
                               atol=1e-4)
    # tokens agree wherever the beam's scores are not near-tied
    s = cpu.scores.numpy()
    for b in range(s.shape[0]):
        if np.all(np.abs(np.diff(s[b])) > 1e-3):
            assert torch.equal(gpu.tokens[b].cpu(), cpu.tokens[b])
