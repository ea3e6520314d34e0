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


# (s, d, dv, start, end, keys) of K1 and K2 beyond each path's own shape
SHAPES = [
    (256, 32, 32, -64, 32, "lengths"),
    (200, 16, 8, -10, 0, "lengths"),     # S not a multiple of the tile, dv != d
    # the largest head dims (dynamic shared memory)
    (64, 128, 128, -300, 0, "lengths"),
    # the tile skips: band edges on a tile boundary, the conformer's band
    # over several tiles, whole invalid key tiles and dead query tiles
    # (lengths s/2, 1 and 0), dv != d, d % 8 != 0
    (256, 32, 32, -64, 64, "lengths"),
    (256, 32, 32, -65, 0, "lengths"),
    (640, 64, 64, -256, 256, "lengths"),
    (512, 64, 64, -30, 30, "lengths"),
    (256, 64, 32, -64, 32, "lengths"),
    (256, 12, 12, -40, 8, "lengths"),
    # the forward's: 8-key chunks wholly in band beside partial ones at
    # TIMIT's band and head dim, d % 8 = 4 with dv one 8-column step
    (256, 64, 64, -100, 0, "lengths"),
    (128, 20, 4, -20, 20, "lengths"),
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


def _empty_rows(s, start, end, valid):
    """[4, s]: query rows with no valid key in their band."""
    pos = torch.arange(s, device=valid.device)
    rel = pos[None, :] - pos[:, None]
    allowed = ((rel >= start) & (rel <= end))[None] & (valid[:, None, :] > 0)
    return ~allowed.any(-1)


@pytest.mark.parametrize("s,d,dv,start,end,keys", [
    (504, 64, 64, -100, 0, "lengths"),   # the slice's shape
    *SHAPES,
])
def test_kernel_matches_plain_version(cuda_device, s, d, dv, start, end,
                                      keys):
    q, k, v, valid = _inputs(cuda_device, 4, s, d, dv, _key_mask(s, keys),
                             seed=s)
    before = ba.banded_attention.launches
    got = ba.banded_attention(q, k, v, valid, start=start, end=end,
                              scale=0.125)
    want = ba.banded_attention_reference(q, k, v, valid, start, end, 0.125)
    torch.cuda.synchronize()
    assert ba.banded_attention.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=ATOL)
    # rows with no valid key in their band are exact zeros
    empty = _empty_rows(s, start, end, valid)
    assert empty.any() and (got[empty] == 0).all()


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


@pytest.mark.parametrize("rate", [0.0, 0.35])
@pytest.mark.parametrize("s,d,dv,start,end,keys", [
    (512, 64, 64, -100, 0, "lengths"),   # the training slice's kernel shape
    *SHAPES,
])
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
    empty = _empty_rows(s, start, end, valid)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("which", [0, 1], ids=["8-bit", "exact"])
@pytest.mark.parametrize("shape", [(512, 1024), (33, 7), (1, 256),
                                   (3, 5, 11), (0, 4)])
def test_fused_dropout_kernel_matches_plain_version(cuda_device, shape,
                                                    which, dtype):
    """K3 forward and backward against the plain version on the card, on
    float32 and on bfloat16: the same mask bit for bit, outputs and
    gradients bit-equal, one launch each way counted under the dtype's
    keys; a non-contiguous input is masked in its logical order."""
    threshold, scale = _thresholds(0.35)[which]
    g = torch.Generator().manual_seed(len(shape))
    x = torch.randn(shape, generator=g).to(cuda_device, dtype)
    x.requires_grad_()
    dout = torch.randn(shape, generator=g).to(cuda_device, dtype)
    before = dict(fd.fused_dropout.launches)
    y = fd.masked_dropout(x, 77, threshold, scale)
    y.backward(dout)
    torch.cuda.synchronize()
    launched = 0 if x.numel() == 0 else 1
    suffix = "_bf16" if dtype == torch.bfloat16 else ""
    assert fd.fused_dropout.launches == {
        k: v + (launched if k in ("forward" + suffix, "backward" + suffix)
                else 0)
        for k, v in before.items()}
    assert y.dtype == x.grad.dtype == dtype
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
    with pytest.raises(TypeError):
        fd.dropout_mask_pass(x.half(), 1, 2**31, 2.0)
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
    assert n_c == [0] * 5 and n_g == [cfg.en_layers, sites, sites, 0, 0]
    assert abs(loss_g - loss_c) <= 1e-5 * abs(loss_c)
    for a, b in zip(grads_g, grads_c):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


def test_bf16_conformer_train_step_matches_the_cpu(cuda_device):
    """The conformer with the recipe's bfloat16 residual stream, one train
    step with dropout on, on the card and on the CPU (same masks), and on
    the CPU with the float32 stream.  Per gradient leaf, the card's
    distance from the CPU's bfloat16 step over the bfloat16 step's distance
    from the float32 one (each over its largest entry): at most 0.75 at
    the median leaf and 3 at every leaf and the loss, chip_smoke.py's
    BF16_MEDIAN_RATIO and BF16_LEAF_RATIO (on the H100 this test read a
    median of 0.057 and a largest leaf of 0.569).  K3 launches on bfloat16 at the
    stream's sites (input, and three per layer)."""
    from pytorch_kaldi_asr_tpu_torch.train import create_train_state, train_step
    from pytorch_kaldi_asr_tpu_torch.train.optim import trainable_leaves

    cfg = TransformerConfig(
        src_dim=40, vocab_size=52, encoder_max_len=128, decoder_max_len=20,
        encoder_sub_sequence=(-32, 32), decoder_sub_sequence=(-10, 0),
        en_layers=2, de_layers=2, n_head=2, en_d_model=64, de_d_model=32,
        d_k=16, d_v=16, en_dropout=0.1, de_dropout=0.1,
        encoder_type="conformer", conformer_stream_dtype="bfloat16")
    params = init_transformer(torch.Generator().manual_seed(0), cfg)
    g = torch.Generator().manual_seed(3)
    src = torch.randn((3, 120, 40), generator=g)
    mask = torch.ones((3, 120), dtype=torch.uint8)
    mask[2, 70:] = 0
    tgt = torch.tensor([[2, 5, 9, 3, 0], [2, 7, 3, 0, 0], [2, 4, 4, 6, 3]])
    batch = (src, mask, tgt, (tgt != 0).to(torch.uint8))
    stream_sites = 1 + 3 * cfg.en_layers
    results = {}
    for name, device, c in (
            ("card", cuda_device, cfg), ("cpu", "cpu", cfg),
            ("cpu32", "cpu", cfg.replace(conformer_stream_dtype="float32"))):
        k3 = dict(fd.fused_dropout.launches)
        state = create_train_state(tree_map(
            lambda x: x.detach().to(device, copy=True), params))
        m = train_step(state, c, *(x.to(device) for x in batch))
        launched = {k: fd.fused_dropout.launches[k] - k3[k] for k in k3}
        results[name] = (float(m["loss"]), [
            p.grad.cpu() for p in trainable_leaves(state.params)], launched)
    (loss_g, grads_g, n_g), (loss_c, grads_c, _), (loss_32, grads_32, _) = (
        results["card"], results["cpu"], results["cpu32"])
    assert n_g["forward_bf16"] == n_g["backward_bf16"] == stream_sites
    # a single leaf is chaotic at float32's last bit (the CPU's own step
    # with the weights one ulp off lands up to 0.76 of the stream's error
    # away); the loss at least to 1e-5 relative
    assert abs(loss_g - loss_c) <= max(3.0 * abs(loss_c - loss_32),
                                       1e-5 * abs(loss_c))
    ratios = [float((a - b).abs().max()) / float((b - c).abs().max())
              if (b - c).abs().max() > 0 else float((a - b).abs().max()) * 1e30
              for a, b, c in zip(grads_g, grads_c, grads_32)]
    print(f"bfloat16 step, card vs cpu over the stream's own error: median "
          f"leaf {np.median(ratios):.3f}, largest {max(ratios):.3f}")
    assert np.median(ratios) <= 0.75
    assert max(ratios) <= 3.0


# ---------------------------------------------------------------------------
# bfloat16: the bfloat16 kernels and bfloat16 compute
# ---------------------------------------------------------------------------

BF16 = torch.bfloat16
# bfloat16 outputs against the plain versions on bfloat16, in bfloat16 ulps
# of each entry's scale (``ba.bf16_ulps``); as chip_smoke.py's
# BF16_KERNEL_ULPS: the forward rounds its probabilities against another
# max than the plain version (PERF.md, PR 7)
BF16_ULPS = 3.0
# the kernel shapes whose head dims the bfloat16 kernels take (multiples
# of 8), and d 24, which ends inside a 16-deep mma step
BF16_SHAPES = [(512, 64, 64, -100, 0, "lengths"),
               *(x for x in SHAPES if x[1] % 8 == 0 and x[2] % 8 == 0),
               (256, 24, 24, -40, 8, "lengths")]


@pytest.mark.parametrize("s,d,dv,start,end,keys", BF16_SHAPES)
def test_bf16_kernel_matches_plain_version(cuda_device, s, d, dv, start, end,
                                           keys):
    """K1 on bfloat16 (one launch of its bfloat16 kernel, counted apart
    from the float32 one) against its plain version on bfloat16."""
    q, k, v, valid = _inputs(cuda_device, 4, s, d, dv, _key_mask(s, keys),
                             seed=s)
    q, k, v = (x.to(BF16) for x in (q, k, v))
    before = (ba.banded_attention.launches, ba.banded_attention.launches_bf16)
    got = ba.banded_attention(q, k, v, valid, start=start, end=end,
                              scale=0.125)
    want = ba.banded_attention_reference(q, k, v, valid, start, end, 0.125)
    torch.cuda.synchronize()
    assert (ba.banded_attention.launches,
            ba.banded_attention.launches_bf16) == (before[0], before[1] + 1)
    assert got.dtype == BF16
    assert float(ba.bf16_ulps(got, want).max()) <= BF16_ULPS
    empty = _empty_rows(s, start, end, valid)
    assert (got[empty] == 0).all()


@pytest.mark.parametrize("rate", [0.0, 0.35])
@pytest.mark.parametrize("s,d,dv,start,end,keys", BF16_SHAPES)
def test_bf16_trainable_kernels_match_plain_versions(cuda_device, rate, s, d,
                                                     dv, start, end, keys):
    """K2a, K2b and K2c on bfloat16, each against its plain version on the
    same inputs (K2b and K2c on the kernel's out and lse, K2c on K2b's
    delta); through the autograd function one bfloat16 launch of each per
    forward + backward, and bfloat16 gradients."""
    q, k, v, valid = _inputs(cuda_device, 4, s, d, dv, _key_mask(s, keys),
                             seed=s + d)
    dout = torch.randn(v.shape, generator=torch.Generator().manual_seed(1))
    q, k, v, dout = (x.to(cuda_device, BF16) for x in (q, k, v, dout))
    kernels = (ba.banded_attention_fwd, ba.banded_attention_dq,
               ba.banded_attention_dkv)
    counts = [(f.launches, f.launches_bf16) for f in kernels]
    kw = dict(start=start, end=end, scale=0.125, dropout_rate=rate)
    grads = _grads_of(lambda q, k, v: ba.banded_attention_trainable(
        q, k, v, valid, 1234, **kw), q, k, v, dout)
    torch.cuda.synchronize()
    assert [(f.launches, f.launches_bf16) for f in kernels] == \
        [(a, b + 1) for a, b in counts]
    assert all(g.dtype == BF16 for g in grads)
    q, k, v, valid = ba._check_and_pad(q, k, v, valid, start, end)
    dout = ba._pad_seq(dout, q.shape[1])
    band = (1234, start, end, 0.125, rate)
    out, lse = ba.banded_attention_fwd(q, k, v, valid, 1234, **kw)
    dq, delta = ba.banded_attention_dq(q, k, v, valid, dout, out, lse, 1234,
                                       **kw)
    dk, dv_ = ba.banded_attention_dkv(q, k, v, valid, dout, lse, delta, 1234,
                                      **kw)
    out_w, lse_w = ba.banded_attention_trainable_reference(q, k, v, valid,
                                                           *band)
    dq_w, delta_w = ba.banded_attention_dq_reference(q, k, v, valid, dout,
                                                     out, lse, *band)
    dk_w, dv_w = ba.banded_attention_dkv_reference(q, k, v, valid, dout, lse,
                                                   delta, *band)
    finite = torch.isfinite(lse_w)
    assert torch.equal(torch.isfinite(lse), finite)
    np.testing.assert_allclose(lse[finite].cpu().numpy(),
                               lse_w[finite].cpu().numpy(), atol=ATOL)
    np.testing.assert_allclose(delta.cpu().numpy(), delta_w.cpu().numpy(),
                               atol=GRAD_ATOL)
    for name, got, want in (("out", out, out_w), ("dq", dq, dq_w),
                            ("dk", dk, dk_w), ("dv", dv_, dv_w)):
        assert float(ba.bf16_ulps(got, want).max()) <= BF16_ULPS, name
    assert (out[~finite] == 0).all() and (dq[~finite] == 0).all()
    assert (dk[valid == 0] == 0).all() and (dv_[valid == 0] == 0).all()


# (bh, s, d, dv, start, end) of the bfloat16 backward pair
# (csrc/banded_attention_sm90.cu) at the shapes its design meets: the
# conformer's train shape, d and dv ending inside a 16-deep step, two
# 64-column blocks, the long-form recipe's S (3,504, padded to 3,520)
BWD_PAIR_SHAPES = {
    "conformer train": (128, 1600, 64, 64, -256, 256),
    "d 24, dv 8": (4, 256, 24, 8, -40, 8),
    "d 128": (4, 256, 128, 128, -100, 20),
    "S 3504": (8, 3504, 64, 64, -100, 50),
}


@pytest.mark.parametrize("rate", [0.0, 0.35])
@pytest.mark.parametrize("case", list(BWD_PAIR_SHAPES))
def test_bf16_backward_pair_matches_plain_versions(cuda_device, rate, case):
    """K2b and K2c on bfloat16 against their plain versions on the same
    inputs (the kernel forward's out and lse, K2c on K2b's delta), rows of
    random lengths, one of them empty: within BF16_ULPS, delta within
    GRAD_ATOL, exact zeros for dead rows and invalid keys, and a second run
    bit-equal to the first."""
    bh, s, d, dv, start, end = BWD_PAIR_SHAPES[case]
    lengths = torch.randint(s // 4, s + 1, (bh,),
                            generator=torch.Generator().manual_seed(bh))
    lengths[-1] = 0
    q, k, v, valid = _inputs(cuda_device, bh, s, d, dv, lengths, seed=s + d)
    dout = torch.randn(v.shape, generator=torch.Generator().manual_seed(2))
    q, k, v, dout = (x.to(cuda_device, BF16) for x in (q, k, v, dout))
    q, k, v, valid = ba._check_and_pad(q, k, v, valid, start, end)
    dout = ba._pad_seq(dout, q.shape[1])
    kw = dict(start=start, end=end, scale=0.125, dropout_rate=rate)
    out, lse = ba.banded_attention_fwd(q, k, v, valid, 99, **kw)
    runs = []
    for _ in range(2):
        dq, delta = ba.banded_attention_dq(q, k, v, valid, dout, out, lse, 99,
                                           **kw)
        runs.append((dq, delta, *ba.banded_attention_dkv(
            q, k, v, valid, dout, lse, delta, 99, **kw)))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    dq, delta, dk, dv_ = runs[0]
    band = (99, start, end, 0.125, rate)
    dq_w, delta_w = ba.banded_attention_dq_reference(q, k, v, valid, dout,
                                                     out, lse, *band)
    dk_w, dv_w = ba.banded_attention_dkv_reference(q, k, v, valid, dout, lse,
                                                   delta, *band)
    np.testing.assert_allclose(delta.cpu().numpy(), delta_w.cpu().numpy(),
                               atol=GRAD_ATOL)
    for name, got, want in (("dq", dq, dq_w), ("dk", dk, dk_w),
                            ("dv", dv_, dv_w)):
        assert got.dtype == BF16, name
        assert float(ba.bf16_ulps(got, want).max()) <= BF16_ULPS, name
    dead = ~torch.isfinite(lse)
    assert dead.any() and (dq[dead] == 0).all()
    assert (dk[valid == 0] == 0).all() and (dv_[valid == 0] == 0).all()


# (bh, s, d, dv, start, end) of the bfloat16 forward (K2a and K1 of
# csrc/banded_attention_sm90.cu) at the shapes its design meets: the
# conformer's train and decode shapes (its ring wraps), TIMIT's decode
# shape (S 504, one wave of CTAs), d and dv ending inside a 16-deep step,
# two 64-column blocks, the long-form recipe's S (3,504, padded to 3,520)
FWD_SHAPES = {
    "conformer train": (128, 1600, 64, 64, -256, 256),
    "conformer decode": (32, 1600, 64, 64, -256, 256),
    "timit decode": (16, 504, 64, 64, -100, 0),
    "d 24, dv 8": (4, 256, 24, 8, -40, 8),
    "d 128": (4, 256, 128, 128, -100, 20),
    "S 3504": (8, 3504, 64, 64, -100, 50),
}


@pytest.mark.parametrize("rate", [0.0, 0.35])
@pytest.mark.parametrize("case", list(FWD_SHAPES))
def test_bf16_forward_matches_plain_versions(cuda_device, rate, case):
    """K2a on bfloat16 against its plain version on the same inputs, rows
    of random lengths, one of them empty: out within BF16_ULPS, lse within
    ATOL and -inf on the same rows, exact zeros on rows with no key, a
    second run bit-equal to the first; K1 within BF16_ULPS of its plain
    version and, at rate 0, bit-equal to K2a's out (one routine)."""
    bh, s, d, dv, start, end = FWD_SHAPES[case]
    lengths = torch.randint(s // 4, s + 1, (bh,),
                            generator=torch.Generator().manual_seed(bh))
    lengths[-1] = 0
    q, k, v, valid = _inputs(cuda_device, bh, s, d, dv, lengths, seed=s + d)
    q, k, v = (x.to(BF16) for x in (q, k, v))
    q, k, v, valid = ba._check_and_pad(q, k, v, valid, start, end)
    kw = dict(start=start, end=end, scale=0.125, dropout_rate=rate)
    runs = [ba.banded_attention_fwd(q, k, v, valid, 99, **kw)
            for _ in range(2)]
    k1 = ba.banded_attention(q, k, v, valid, start=start, end=end,
                             scale=0.125)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    out, lse = runs[0]
    out_w, lse_w = ba.banded_attention_trainable_reference(
        q, k, v, valid, 99, start, end, 0.125, rate)
    finite = torch.isfinite(lse_w)
    assert torch.equal(torch.isfinite(lse), finite) and (~finite).any()
    np.testing.assert_allclose(lse[finite].cpu().numpy(),
                               lse_w[finite].cpu().numpy(), atol=ATOL)
    assert out.dtype == k1.dtype == BF16
    assert float(ba.bf16_ulps(out, out_w).max()) <= BF16_ULPS
    assert (out[~finite] == 0).all() and (k1[~finite] == 0).all()
    want = ba.banded_attention_reference(q, k, v, valid, start, end, 0.125)
    assert float(ba.bf16_ulps(k1, want).max()) <= BF16_ULPS
    if rate == 0.0:
        assert torch.equal(k1, out)


def test_bf16_forward_refuses_a_scale_it_cannot_take(cuda_device):
    """The bfloat16 forward folds the scale into its running max, which
    needs scale > 0: K1 and K2a refuse 0 and a negative scale."""
    q, k, v, valid = _inputs(cuda_device, 2, 64, 8, 8, [64, 64])
    q, k, v = (x.to(BF16) for x in (q, k, v))
    for scale in (0.0, -0.125):
        with pytest.raises(RuntimeError, match="launch failed"):
            ba.banded_attention(q, k, v, valid, start=-4, end=0, scale=scale)
        with pytest.raises(RuntimeError, match="launch failed"):
            ba.banded_attention_fwd(q, k, v, valid, 1, start=-4, end=0,
                                    scale=scale)


def test_bf16_compute_train_step_on_the_card_matches_the_cpu(cuda_device):
    """One train step of a banded model in bfloat16 compute, dropout on:
    the card (the bfloat16 K2a/K2b/K2c, once per encoder layer, and no
    float32 one) against the CPU (their plain versions), over bfloat16
    compute's own error (the CPU's bfloat16 step against its float32 one),
    each leaf by its largest entry: the median leaf at most 0.75, every
    leaf at most 3 (a two-layer model decorrelates less than chip_smoke.py's
    full-width ones)."""
    from pytorch_kaldi_asr_tpu_torch.train import create_train_state, train_step
    from pytorch_kaldi_asr_tpu_torch.train.optim import trainable_leaves

    cfg = TransformerConfig(
        src_dim=40, vocab_size=52, encoder_max_len=128, decoder_max_len=20,
        encoder_sub_sequence=(-100, 0), decoder_sub_sequence=(-10, 0),
        en_layers=2, de_layers=2, n_head=2, en_d_model=64, de_d_model=32,
        d_k=16, d_v=16, en_dropout=0.1, de_dropout=0.1,
        encoder_type="banded", compute_dtype="bfloat16")
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
    for name, device, c in (("card", cuda_device, cfg), ("cpu", "cpu", cfg),
                            ("cpu32", "cpu",
                             cfg.replace(compute_dtype="float32"))):
        before = [(f.launches, f.launches_bf16) for f in kernels]
        state = create_train_state(tree_map(
            lambda x: x.detach().to(device, copy=True), params))
        m = train_step(state, c, *(x.to(device) for x in batch))
        launched = [(f.launches - a, f.launches_bf16 - b)
                    for f, (a, b) in zip(kernels, before)]
        results[name] = (float(m["loss"]), [
            p.grad.cpu() for p in trainable_leaves(state.params)], launched)
    (loss_g, grads_g, n_g), (loss_c, grads_c, _), (loss_32, grads_32, _) = (
        results["card"], results["cpu"], results["cpu32"])
    assert n_g == [(0, cfg.en_layers)] * 3
    assert abs(loss_g - loss_c) <= max(3.0 * abs(loss_c - loss_32),
                                       1e-5 * abs(loss_c))
    ratios = [float((a - b).abs().max()) / float((b - c).abs().max())
              if (b - c).abs().max() > 0 else float((a - b).abs().max()) * 1e30
              for a, b, c in zip(grads_g, grads_c, grads_32)]
    print(f"bfloat16-compute step, card vs cpu over its own error: median "
          f"leaf {np.median(ratios):.3f}, largest {max(ratios):.3f}")
    assert np.median(ratios) <= 0.75
    assert max(ratios) <= 3.0


@pytest.mark.parametrize("mode", ["dense", "frontier"])
def test_device_search_on_the_card_matches_the_cpu(cuda_device, mode):
    """latgen's device search (decode/device_latgen.py, dense, and
    decode/frontier_latgen.py) on the card over a batch of padded
    utterances on a phone-loop graph with an epsilon backoff: the CPU's
    words and phones, costs within 1e-5 relative, no host fallback."""
    from pytorch_kaldi_asr_tpu_torch.decode.device_latgen import (
        make_device_latgen,
    )
    from pytorch_kaldi_asr_tpu_torch.fst.core import Fst

    rng = np.random.default_rng(0)
    P = 6
    g = Fst()
    loop, back = g.add_state(), g.add_state()
    g.start = loop
    g.set_final(loop, 0.5)
    for p in range(1, P + 1):
        hmm = g.add_state()
        g.add_arc(loop, p, p, float(rng.uniform(0, 2)), hmm)
        g.add_arc(hmm, p, 0, 0.7, hmm)
        g.add_arc(hmm, 0, 0, 0.7, back)
    g.add_arc(back, 0, 0, 0.1, loop)
    lens = [40, 33, 17]
    x = rng.normal(size=(len(lens), 64, P))
    x = (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)
    kw = dict(mode=mode, beam=12.0, max_active=8)
    card = make_device_latgen(g, device=cuda_device, **kw)
    cpu = make_device_latgen(g, device="cpu", **kw)
    got = card.decode_batch(x, np.array(lens))
    want = cpu.decode_batch(x, np.array(lens))
    for r, w in zip(got, want):
        assert r[0] == w[0] and r[1] == w[1]
        assert abs(r[2] - w[2]) <= 1e-5 * abs(w[2])
    assert card.host_fallbacks == cpu.host_fallbacks == 0


def test_sp_step_on_ranks_sharing_the_card(cuda_device, tmp_path):
    """The sequence-parallel step (parallel/sequence.py) of a small
    conformer AM on 2 ranks sharing the card under gloo with CUDA tensors
    (tests/torch_parallel_worker.py, started by the port's launcher),
    against one rank's step on the card: the loss within 1e-5, every
    gradient within 1e-4 of its leaf's largest, K2a-c launched on each
    rank."""
    # tests/ is on the path as pytest imports this file (no package): a
    # machine with only PyTorch may hold another top-level ``tests``
    from torch_parallel_helpers import run_world

    out = run_world("sp_cuda", 2, tmp_path, device="cuda")
    assert abs(out[0]["loss"] - out[0]["one_loss"]) <= 1e-5 * abs(
        out[0]["one_loss"])
    assert out[1]["loss"] == out[0]["loss"]
    assert out[0]["grad_rel"] <= 1e-4
    for rank in out:
        for k in ("fwd", "dq", "dkv"):
            assert rank["launches"][f"banded_attention_{k}"] > 0
