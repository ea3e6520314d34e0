"""The port's nnet1 proto frontend (models/proto.py, tools/make_nnet_proto.py,
tools/transforms.py, tools/lda.py) against the JAX package's, on the CPU.

- Every case of tests/test_nnet_proto.py on the port.
- ``make_nnet_proto``'s four protos (dnn with each option, lstm, blstm,
  cnn) and its CLI: byte for byte JAX's.
- ``apply_proto`` on JAX's parameters (``proto_params_from_jax``): within
  1e-6 of the output's largest entry at ``train=False``; a frame CE's
  gradients within 1e-5 of each leaf's largest entry, for sigmoid, tanh
  and relu stacks with a bottleneck, a splice and dropout sites; the
  splice clamps as JAX's does.
- With dropout on, the masks come from ``DropoutRngs`` through
  ``models.common.dropout`` (K3's plain version here): one seed a site.
- The transforms: ``np.array_equal`` with JAX's; ``estimate_lda`` within
  1e-6 on tests/test_features.py's case and on a seeded 440-dimensional
  one (11 spliced frames of 40).
"""

import io
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_kaldi_asr_tpu.models import proto as jax_proto
from pytorch_kaldi_asr_tpu.tools import lda as jax_lda
from pytorch_kaldi_asr_tpu.tools import make_nnet_proto as jax_mnp
from pytorch_kaldi_asr_tpu.tools import transforms as jax_transforms
from pytorch_kaldi_asr_tpu_torch.models.common import DropoutRngs
from pytorch_kaldi_asr_tpu_torch.models.proto import (
    apply_proto,
    init_proto,
    parse_proto,
    proto_output_dim,
    proto_params_from_jax,
)
from pytorch_kaldi_asr_tpu_torch.tools import lda, transforms
from pytorch_kaldi_asr_tpu_torch.tools.make_nnet_proto import (
    cnn_proto,
    dnn_proto,
    lstm_proto,
    main,
)

torch.set_num_threads(1)
FWD_RTOL = 1e-6  # of the output's largest entry
GRAD_RTOL = 1e-5  # of each leaf's largest entry
LDA_ATOL = 1e-6


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


# --- every case of tests/test_nnet_proto.py, on the port ---

def test_dnn_proto_structure():
    text = dnn_proto(440, 1500, 3, 1024)
    lines = text.strip().splitlines()
    assert lines[0] == "<NnetProto>" and lines[-1] == "</NnetProto>"
    affines = [l for l in lines if l.startswith("<AffineTransform>")]
    assert len(affines) == 4  # 3 hidden + output
    sigmoids = [l for l in lines if l.startswith("<Sigmoid>")]
    assert len(sigmoids) == 3
    assert any(l.startswith("<Softmax>") for l in lines)
    assert "<InputDim> 440" in affines[0]
    assert "<OutputDim> 1500" in affines[-1]


def test_dnn_proto_bottleneck():
    text = dnn_proto(440, 1500, 2, 1024, bottleneck_dim=40)
    assert "<LinearTransform> <InputDim> 1024 <OutputDim> 40" in text
    assert "<LearnRateCoef> 0.1" in text


def test_lstm_blstm_protos():
    t = lstm_proto(43, 2000, num_layers=2)
    assert t.count("<LstmProjectedStreams>") == 2
    assert "<CellDim> 800" in t
    b = lstm_proto(43, 2000, bidirectional=True)
    assert "<BLstmProjectedStreams>" in b
    assert "<OutputDim> 1024" in b  # 2 * proj_dim


def test_cnn_proto():
    t = cnn_proto(40, 1500)
    assert "<ConvolutionalComponent>" in t
    assert "<MaxPoolingComponent>" in t
    assert "<Softmax>" in t


def test_cli(capsys):
    assert main(["dnn", "120", "300", "2", "256"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("<NnetProto>")
    assert main(["blstm", "40", "300"]) == 0
    assert main(["cnn", "40", "300"]) == 0


def test_proto_realizes_as_torch_model():
    comps = parse_proto(dnn_proto(20, 30, 2, 64, with_dropout=0.2))
    params = init_proto(_gen(0), comps)
    x = torch.as_tensor(np.random.RandomState(0).randn(3, 7, 20),
                        dtype=torch.float32)
    y = apply_proto(params, comps, x)
    assert y.shape == (3, 7, 30)
    np.testing.assert_allclose(y.sum(-1).numpy(), 1.0, rtol=1e-5)
    assert proto_output_dim(comps) == 30
    # train mode with dropout seeds runs and differs from eval
    y2 = apply_proto(params, comps, x, train=True,
                     rngs=DropoutRngs(_gen(1)))
    assert not np.allclose(y.numpy(), y2.numpy())


def test_proto_model_is_trainable():
    comps = parse_proto(dnn_proto(10, 5, 1, 32))
    params = init_proto(_gen(0), comps)
    rs = np.random.RandomState(1)
    x = torch.as_tensor(rs.randn(50, 10), dtype=torch.float32)
    labels = torch.as_tensor(rs.randint(0, 5, 50))

    def loss_fn(p):
        probs = apply_proto(p, comps, x)
        return -torch.log(probs[torch.arange(50), labels] + 1e-8).mean()

    with torch.no_grad():
        l0 = float(loss_fn(params))
    for _ in range(20):
        leaves = [v.requires_grad_() for p in params for v in p.values()]
        grads = torch.autograd.grad(loss_fn(params), leaves)
        with torch.no_grad():
            it = iter(grads)
            params = [{k: v - 0.5 * next(it) for k, v in p.items()}
                      for p in params]
    with torch.no_grad():
        assert float(loss_fn(params)) < l0


def test_unsupported_component_raises():
    comps = parse_proto(lstm_proto(40, 100))
    with pytest.raises(ValueError, match="encoder zoo"):
        init_proto(_gen(0), comps)
    with pytest.raises(ValueError, match="encoder zoo"):
        jax_proto.init_proto(jax.random.PRNGKey(0), comps)


def test_splice_component():
    comps = parse_proto(
        "<NnetProto>\n<Splice> <InputDim> 4 <OutputDim> 12 "
        "<Context> -1:0:1\n</NnetProto>\n")
    params = init_proto(_gen(0), comps)
    x = torch.arange(2 * 5 * 4, dtype=torch.float32).reshape(2, 5, 4)
    assert apply_proto(params, comps, x).shape == (2, 5, 12)


def test_splice_clamps_at_edges():
    """nnet1 splice repeats edge frames, as JAX's does: no wrap."""
    comps = parse_proto(
        "<NnetProto>\n<Splice> <InputDim> 2 <OutputDim> 6 "
        "<Context> -1:0:1\n</NnetProto>\n")
    x = np.arange(1 * 4 * 2, dtype=np.float32).reshape(1, 4, 2)
    y = apply_proto(init_proto(_gen(0), comps), comps,
                    torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(y[0, 0, 0:2], x[0, 0])
    np.testing.assert_array_equal(y[0, 0, 2:4], x[0, 0])
    np.testing.assert_array_equal(y[0, 0, 4:6], x[0, 1])
    np.testing.assert_array_equal(y[0, -1, 0:2], x[0, -2])
    np.testing.assert_array_equal(y[0, -1, 2:4], x[0, -1])
    np.testing.assert_array_equal(y[0, -1, 4:6], x[0, -1])
    want = jax_proto.apply_proto(
        jax_proto.init_proto(jax.random.PRNGKey(0), comps), comps,
        jnp.asarray(x))
    np.testing.assert_array_equal(y, np.asarray(want))


# --- make_nnet_proto byte for byte ---

PROTOS = {
    "dnn": (lambda m: m.dnn_proto(440, 2500, 4, 1024)),
    "dnn_options": (lambda m: m.dnn_proto(
        440, 1500, 3, 512, activation="<ReLU>", bottleneck_dim=40,
        with_softmax=False, with_dropout=0.1, hid_bias_mean=-1.0,
        hid_bias_range=2.0, param_stddev_factor=0.2, with_glorot=False)),
    "lstm": (lambda m: m.lstm_proto(43, 2000, num_layers=2, cell_dim=320,
                                    proj_dim=128, param_scale=0.01,
                                    clip_gradient=2.5)),
    "blstm": (lambda m: m.lstm_proto(40, 300, bidirectional=True)),
    "cnn": (lambda m: m.cnn_proto(40, 1500, num_filters=64, patch_dim=6,
                                  patch_step=2, pool_size=2,
                                  num_hid_layers=3, num_hid_neurons=256,
                                  splice=4)),
}


@pytest.mark.parametrize("name", sorted(PROTOS))
def test_protos_equal_jax(name):
    from pytorch_kaldi_asr_tpu_torch.tools import make_nnet_proto

    assert PROTOS[name](make_nnet_proto) == PROTOS[name](jax_mnp)


CLI_ARGS = [
    ["dnn", "440", "2500", "4", "1024", "--with-dropout", "0.1"],
    ["dnn", "120", "300", "2", "256", "--activation-type", "<Tanh>",
     "--bottleneck-dim", "32", "--no-softmax", "--hid-bias-mean", "-1.5",
     "--hid-bias-range", "3.0", "--param-stddev-factor", "0.05"],
    ["lstm", "40", "300", "--num-layers", "2", "--cell-dim", "256",
     "--proj-dim", "64", "--param-scale", "0.03", "--clip-gradient", "1.0"],
    ["blstm", "40", "300"],
    ["cnn", "40", "300", "--num-filters", "32", "--patch-dim", "5",
     "--pool-size", "2", "--num-hid-layers", "1", "--num-hid-neurons",
     "128"],
]


@pytest.mark.parametrize("args", CLI_ARGS, ids=lambda a: a[0])
def test_cli_equals_jax(args):
    outs = []
    for fn in (main, jax_mnp.main):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert fn(list(args)) == 0
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and outs[0].startswith("<NnetProto>")


# --- apply_proto against JAX's ---

SPLICE = "<Splice> <InputDim> 6 <OutputDim> 30 <Context> -2:-1:0:1:2\n"
MODELS = {
    "sigmoid": "<NnetProto>\n" + SPLICE + dnn_proto(
        30, 17, 2, 24, with_dropout=0.2).split("\n", 1)[1],
    "tanh_bottleneck": dnn_proto(6, 11, 3, 20, activation="<Tanh>",
                                 bottleneck_dim=5),
    "relu_no_softmax": dnn_proto(6, 9, 2, 16, activation="<ReLU>",
                                 with_softmax=False, with_dropout=0.1),
}


def _jax_setup(name, seed=0):
    comps = parse_proto(MODELS[name])
    jparams = jax_proto.init_proto(jax.random.PRNGKey(seed), comps)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(3, 13, int(comps[0]["InputDim"]))).astype(
        np.float32)
    labels = rng.integers(0, proto_output_dim(comps), size=(3, 13))
    return comps, jparams, x, labels


@pytest.mark.parametrize("name", sorted(MODELS))
def test_apply_proto_matches_jax(name):
    comps, jparams, x, _ = _jax_setup(name)
    assert comps == jax_proto.parse_proto(MODELS[name])
    want = np.asarray(jax_proto.apply_proto(jparams, comps, jnp.asarray(x)))
    got = apply_proto(proto_params_from_jax(jparams), comps,
                      torch.as_tensor(x)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= FWD_RTOL * np.abs(want).max()


@pytest.mark.parametrize("name", sorted(MODELS))
def test_frame_ce_grads_match_jax(name):
    comps, jparams, x, labels = _jax_setup(name, seed=1)
    softmax = comps[-1]["type"] == "<Softmax>"

    def jax_loss(p):
        out = jax_proto.apply_proto(p, comps, jnp.asarray(x))
        logp = (jnp.log(out + 1e-8) if softmax
                else jax.nn.log_softmax(out, axis=-1))
        return -jnp.take_along_axis(logp, jnp.asarray(labels)[..., None],
                                    axis=-1).mean()

    want_loss, want = jax.value_and_grad(jax_loss)(jparams)
    params = proto_params_from_jax(jparams)
    leaves = [p[k].requires_grad_() for p in params for k in sorted(p)]
    out = apply_proto(params, comps, torch.as_tensor(x))
    logp = (torch.log(out + 1e-8) if softmax
            else torch.log_softmax(out, dim=-1))
    loss = -torch.take_along_dim(
        logp, torch.as_tensor(labels)[..., None], dim=-1).mean()
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - float(want_loss)) <= 1e-6 * abs(
        float(want_loss))
    want_leaves = [np.asarray(p[k]) for p in want for k in sorted(p)]
    assert len(grads) == len(want_leaves) > 0
    for g, w in zip(grads, want_leaves):
        assert np.abs(g.numpy() - w).max() <= GRAD_RTOL * np.abs(w).max()


def test_dropout_sites_draw_one_seed_each():
    """Each <Dropout> takes the next seed of ``rngs`` and drops through
    ``models.common.dropout``: the same generator state, the same masks;
    at train=False or without rngs, the identity."""
    from pytorch_kaldi_asr_tpu_torch.models.common import dropout

    comps = parse_proto(dnn_proto(8, 6, 2, 12, with_dropout=0.25,
                                  with_softmax=False))
    params = init_proto(_gen(3), comps)
    x = torch.as_tensor(np.random.default_rng(2).normal(size=(2, 9, 8)),
                        dtype=torch.float32)
    a = apply_proto(params, comps, x, train=True, rngs=DropoutRngs(_gen(5)))
    b = apply_proto(params, comps, x, train=True, rngs=DropoutRngs(_gen(5)))
    assert torch.equal(a, b)
    seeds = DropoutRngs(_gen(5))
    h = x
    for p, comp in zip(params, comps):
        if comp["type"] == "<AffineTransform>":
            h = h @ p["w"] + p["b"]
        elif comp["type"] == "<Sigmoid>":
            h = torch.sigmoid(h)
        elif comp["type"] == "<Dropout>":
            h = dropout(h, 0.25, seeds.seed(), True)
    assert torch.equal(a, h)
    plain = apply_proto(params, comps, x)
    assert torch.equal(apply_proto(params, comps, x, train=True), plain)
    assert torch.equal(apply_proto(params, comps, x,
                                   rngs=DropoutRngs(_gen(5))), plain)


def test_init_proto_draws_from_the_generator():
    comps = parse_proto(dnn_proto(6, 5, 1, 8, bottleneck_dim=0))
    a, b = init_proto(_gen(7), comps), init_proto(_gen(7), comps)
    assert all(torch.equal(p[k], q[k]) for p, q in zip(a, b) for k in p)
    w = a[0]["w"]
    assert w.shape == (6, 8) and w.dtype == torch.float32
    b0 = a[0]["b"]
    # hidden bias: BiasMean -2 ± BiasRange 4 / 2
    assert float(b0.min()) >= -4.0 and float(b0.max()) <= 0.0
    assert [set(p) for p in a] == [set(p) for p in jax_proto.init_proto(
        jax.random.PRNGKey(0), comps)]


# --- transforms and LDA ---

@pytest.mark.parametrize("fn,args", [
    ("dct_matrix", (13, 23)), ("dct_matrix", (23, 40, False)),
    ("hamming_window", (400,)), ("hamming_window", (256, True)),
    ("splice_indices", (5, 5)), ("splice_indices", (3, 6, 3)),
    ("splice_matrix", (40, [-2, -1, 0, 1, 2])),
])
def test_transforms_equal_jax(fn, args):
    got = getattr(transforms, fn)(*args)
    want = getattr(jax_transforms, fn)(*args)
    assert np.array_equal(np.asarray(got), np.asarray(want))
    assert np.asarray(got).dtype == np.asarray(want).dtype


def _lda_features_case():
    """tests/test_features.py's case: 3 classes in 10-d."""
    rng = np.random.default_rng(3)
    means = rng.normal(scale=4.0, size=(3, 10))
    feats, labels = [], []
    for c in range(3):
        feats.append(means[c] + rng.normal(scale=0.5, size=(200, 10)))
        labels.append(np.full(200, c))
    return ([(np.concatenate(feats).astype(np.float32),
              np.concatenate(labels))], 2)


def _lda_spliced_case():
    """11 spliced frames of 40 (440-d), 48 classes, in 3 chunks."""
    rng = np.random.default_rng(11)
    means = rng.normal(scale=2.0, size=(48, 440))
    pairs = []
    for _ in range(3):
        labels = rng.integers(0, 48, size=1500)
        feats = means[labels] + rng.normal(size=(1500, 440))
        pairs.append((feats.astype(np.float32), labels))
    return pairs, 40


@pytest.mark.parametrize("case", [_lda_features_case, _lda_spliced_case],
                         ids=["test_features", "spliced_440"])
def test_estimate_lda_matches_jax(case):
    pairs, out_dim = case()
    got = lda.estimate_lda(pairs, out_dim=out_dim)
    want = jax_lda.estimate_lda(pairs, out_dim=out_dim)
    assert got.shape == want.shape == (out_dim, pairs[0][0].shape[1] + 1)
    assert got.dtype == want.dtype == np.float32
    assert np.abs(got - want).max() <= LDA_ATOL
