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
from pytorch_kaldi_asr_tpu_torch.ops import fused_dropout as fd

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


def _inputs(device, bh, s, d, dv, valid, seed=0):
    """q, k, v from ``seed`` and the int32 key mask: ``valid`` is a [bh, s]
    mask or the bh valid lengths."""
    g = torch.Generator().manual_seed(seed)
    q, k = (torch.randn((bh, s, d), generator=g) for _ in range(2))
    v = torch.randn((bh, s, dv), generator=g)
    valid = torch.as_tensor(valid)
    if valid.dim() == 1:
        valid = torch.arange(s)[None, :] < valid[:, None]
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


GRAD_ATOL = 1e-4  # float32 gradients summed over the band in another order


def _grads_of(fn, q, k, v, dout):
    q, k, v = (x.detach().clone().requires_grad_() for x in (q, k, v))
    out = fn(q, k, v)
    out.backward(dout)
    return out.detach(), q.grad, k.grad, v.grad


TRAINABLE_SHAPES = [
    (512, 64, 64, -100, 0, "lengths"),   # the training slice's kernel shape
    (256, 32, 32, -64, 32, "lengths"),
    (200, 16, 8, -10, 0, "lengths"),     # S not a multiple of the tile, dv != d
    # the largest head dims (dynamic shared memory)
    (64, 128, 128, -300, 0, "lengths"),
    # the backward's tile skips: band edges on a tile boundary, the
    # conformer's band over several tiles, whole invalid key tiles and dead
    # query tiles (lengths s/2, 1 and 0), dv != d, d % 8 != 0
    (256, 32, 32, -64, 64, "lengths"),
    (256, 32, 32, -65, 0, "lengths"),
    (640, 64, 64, -256, 256, "lengths"),
    (512, 64, 64, -30, 30, "lengths"),
    (256, 64, 32, -64, 32, "lengths"),
    (256, 12, 12, -40, 8, "lengths"),
    # a key mask that is no prefix: random holes, a whole invalid 64-key
    # tile, a cut tail
    (256, 16, 16, -40, 40, "holes"),
]


def _key_mask(s, keys):
    """[4, s] key mask: lengths s, s/2, 1 and 0, or ``holes``."""
    if keys == "lengths":
        return torch.arange(s)[None, :] < torch.tensor([s, s // 2, 1, 0])[:, None]
    valid = torch.rand((4, s), generator=torch.Generator().manual_seed(3)) > 0.3
    valid[:, 64:128] = False
    valid[1, 150:] = False
    return valid


@pytest.mark.parametrize("rate", [0.0, 0.35])
@pytest.mark.parametrize("s,d,dv,start,end,keys", TRAINABLE_SHAPES)
def test_trainable_kernels_match_plain_version(cuda_device, rate, s, d, dv,
                                               start, end, keys):
    """K2a (out, lse), K2b (dq, with delta) and K2c (dk, dv) against
    autograd of the plain version, each launched exactly once per forward +
    backward; rows with no valid key in band get exact-zero outputs and
    gradients, invalid keys exact-zero gradients."""
    q, k, v, valid = _inputs(cuda_device, 4, s, d, dv, _key_mask(s, keys),
                             seed=s + d)
    dout = torch.randn(v.shape, generator=torch.Generator().manual_seed(1)
                       ).to(cuda_device)
    kw = dict(start=start, end=end, scale=0.125, dropout_rate=rate)
    counts = [f.launches for f in (ba.banded_attention_fwd,
                                   ba.banded_attention_dq,
                                   ba.banded_attention_dkv)]
    got = _grads_of(lambda q, k, v: ba.banded_attention_trainable(
        q, k, v, valid, 1234, **kw), q, k, v, dout)
    torch.cuda.synchronize()
    assert [f.launches for f in (ba.banded_attention_fwd,
                                 ba.banded_attention_dq,
                                 ba.banded_attention_dkv)] == \
        [c + 1 for c in counts]
    want = _grads_of(lambda q, k, v: ba.banded_attention_trainable_reference(
        q, k, v, valid, 1234, start, end, 0.125, rate)[0], q, k, v, dout)
    for g, w, tol in zip(got, want, (ATOL, GRAD_ATOL, GRAD_ATOL, GRAD_ATOL)):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), atol=tol)
    pos = torch.arange(s, device=cuda_device)
    rel = pos[None, :] - pos[:, None]
    allowed = ((rel >= start) & (rel <= end))[None] & (valid[:, None, :] > 0)
    empty = ~allowed.any(-1)
    assert empty.any()
    assert (got[0][empty] == 0).all() and (got[1][empty] == 0).all()
    assert (got[2][valid == 0] == 0).all() and (got[3][valid == 0] == 0).all()
    # lse straight from K2a, padded to the tile as the wrapper does
    s_pad = -(-s // ba.BLOCK) * ba.BLOCK
    padded = ba._check_and_pad(q, k, v, valid, start, end)
    _, lse = ba.banded_attention_fwd(*padded, 1234, **kw)
    _, lse_ref = ba.banded_attention_trainable_reference(
        *padded, 1234, start, end, 0.125, rate)
    assert lse.shape == (4, s_pad)
    finite = torch.isfinite(lse_ref)
    assert torch.equal(torch.isfinite(lse), finite)
    np.testing.assert_allclose(lse[finite].cpu().numpy(),
                               lse_ref[finite].cpu().numpy(), atol=ATOL)


def test_train_step_on_the_card_matches_the_cpu(cuda_device):
    """One train step of the banded-encoder model, dropout off: the card
    (K2a/K2b/K2c, each launched once per encoder layer) against the CPU
    (their plain versions)."""
    from pytorch_kaldi_asr_tpu_torch.train import create_train_state, train_step
    from pytorch_kaldi_asr_tpu_torch.train.optim import trainable_leaves

    cfg = TransformerConfig(
        src_dim=40, vocab_size=52, encoder_max_len=128, decoder_max_len=20,
        encoder_sub_sequence=(-100, 0), decoder_sub_sequence=(-10, 0),
        en_layers=2, de_layers=2, n_head=2, en_d_model=64, de_d_model=32,
        d_k=16, d_v=16, en_dropout=0.0, de_dropout=0.0, encoder_type="banded")
    params = init_transformer(torch.Generator().manual_seed(0), cfg)
    g = torch.Generator().manual_seed(2)
    src = torch.randn((3, 120, 40), generator=g)
    mask = torch.ones((3, 120), dtype=torch.uint8)
    mask[2, 70:] = 0
    tgt = torch.tensor([[2, 5, 9, 3, 0], [2, 7, 3, 0, 0], [2, 4, 4, 6, 3]])
    batch = (src, mask, tgt, (tgt != 0).to(torch.uint8))
    kernels = (ba.banded_attention_fwd, ba.banded_attention_dq,
               ba.banded_attention_dkv)
    results = {}
    for device in ("cpu", cuda_device):
        before = [f.launches for f in kernels]
        # a copy per device: the step updates its parameters in place
        state = create_train_state(tree_map(
            lambda x: x.detach().to(device, copy=True), params))
        m = train_step(state, cfg, *(x.to(device) for x in batch))
        launched = [f.launches - b for f, b in zip(kernels, before)]
        results[str(device)] = (float(m["loss"]), [
            p.grad.cpu() for p in trainable_leaves(state.params)], launched)
    (loss_c, grads_c, n_c), (loss_g, grads_g, n_g) = results.values()
    assert n_c == [0, 0, 0] and n_g == [cfg.en_layers] * 3
    assert abs(loss_g - loss_c) <= 1e-5 * abs(loss_c)
    for a, b in zip(grads_g, grads_c):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


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


def _thresholds(rate):
    """(threshold, scale) of the 8-bit model dropout and of fused_dropout."""
    q = round((1 - rate) * 256)
    return [((256 - q) << 24, 256.0 / q),
            (fd.fused_dropout_threshold(rate), 1.0 / (1.0 - rate))]


@pytest.mark.parametrize("which", [0, 1], ids=["8-bit", "exact"])
@pytest.mark.parametrize("shape", [(512, 1024), (33, 7), (1, 256),
                                   (3, 5, 11), (0, 4)])
def test_fused_dropout_kernel_matches_plain_version(cuda_device, shape,
                                                    which):
    """K3 forward and backward against the plain version on the card: the
    same mask bit for bit, outputs and gradients bit-equal, one launch each
    way; a non-contiguous input is masked in its logical order."""
    threshold, scale = _thresholds(0.35)[which]
    g = torch.Generator().manual_seed(len(shape))
    x = torch.randn(shape, generator=g).to(cuda_device).requires_grad_()
    dout = torch.randn(shape, generator=g).to(cuda_device)
    before = dict(fd.fused_dropout.launches)
    y = fd.masked_dropout(x, 77, threshold, scale)
    y.backward(dout)
    torch.cuda.synchronize()
    launched = 0 if x.numel() == 0 else 1
    assert fd.fused_dropout.launches == {
        k: v + launched for k, v in before.items()}
    scale32 = float(np.float32(scale))
    want = fd.fused_dropout_reference(x.detach(), 77, threshold, scale32)
    assert torch.equal(y.detach(), want)
    assert torch.equal(x.grad, fd.fused_dropout_reference(dout, 77, threshold,
                                                          scale32))
    if x.dim() == 2 and x.numel():
        xt = x.detach().t()
        assert torch.equal(fd.dropout_mask_pass(xt, 5, threshold, scale32),
                           fd.fused_dropout_reference(xt, 5, threshold,
                                                      scale32))


def test_fused_dropout_kernel_refuses_what_it_cannot_take(cuda_device):
    x = torch.ones(8, device=cuda_device)
    with pytest.raises(TypeError):
        fd.dropout_mask_pass(x.double(), 1, 2**31, 2.0)
    with pytest.raises(ValueError, match="32-bit"):
        fd.dropout_mask_pass(x, 1, 2**32, 2.0)


def test_conformer_train_step_with_dropout_matches_the_cpu(cuda_device):
    """One train step of a conformer with dropout on: the masks are the
    same on both devices (K3's Philox, K2's hash), so the card (K2a-c once
    per encoder layer, K3 once per dropout site each way) matches the CPU
    (their plain versions)."""
    from pytorch_kaldi_asr_tpu_torch.train import create_train_state, train_step
    from pytorch_kaldi_asr_tpu_torch.train.optim import trainable_leaves

    cfg = TransformerConfig(
        src_dim=40, vocab_size=52, encoder_max_len=128, decoder_max_len=20,
        encoder_sub_sequence=(-32, 32), decoder_sub_sequence=(-10, 0),
        en_layers=2, de_layers=2, n_head=2, en_d_model=64, de_d_model=32,
        d_k=16, d_v=16, en_dropout=0.1, de_dropout=0.1,
        encoder_type="conformer")
    params = init_transformer(torch.Generator().manual_seed(0), cfg)
    g = torch.Generator().manual_seed(3)
    src = torch.randn((3, 120, 40), generator=g)
    mask = torch.ones((3, 120), dtype=torch.uint8)
    mask[2, 70:] = 0
    tgt = torch.tensor([[2, 5, 9, 3, 0], [2, 7, 3, 0, 0], [2, 4, 4, 6, 3]])
    batch = (src, mask, tgt, (tgt != 0).to(torch.uint8))
    # input + 6 per conformer layer; embedding + 5 per decoder layer + output
    sites = 1 + 6 * cfg.en_layers + 2 + 5 * cfg.de_layers
    results = {}
    for device in ("cpu", cuda_device):
        k2 = ba.banded_attention_fwd.launches
        k3 = dict(fd.fused_dropout.launches)
        state = create_train_state(tree_map(
            lambda x: x.detach().to(device, copy=True), params))
        m = train_step(state, cfg, *(x.to(device) for x in batch))
        launched = [ba.banded_attention_fwd.launches - k2] + [
            fd.fused_dropout.launches[k] - k3[k] for k in k3]
        results[str(device)] = (float(m["loss"]), [
            p.grad.cpu() for p in trainable_leaves(state.params)], launched)
    (loss_c, grads_c, n_c), (loss_g, grads_g, n_g) = results.values()
    assert n_c == [0, 0, 0] and n_g == [cfg.en_layers, sites, sites]
    assert abs(loss_g - loss_c) <= 1e-5 * abs(loss_c)
    for a, b in zip(grads_g, grads_c):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
