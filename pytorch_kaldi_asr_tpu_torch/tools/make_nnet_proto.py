"""Network prototype generators (Kaldi nnet1 proto format).

The reference vendors generators that emit network-definition artifacts
(reference kaldi/utils/nnet/: make_nnet_proto.py:1-215,
make_lstm_proto.py, make_blstm_proto.py, make_cnn_proto.py) which Kaldi's
nnet1 trainer materializes.  This module generates the same artifact
class — component-per-line <NnetProto> text with Glorot-scaled init
hyperparameters — and, unlike the reference, the DNN protos are also
CONSUMABLE in-framework: models/proto.py builds a PyTorch model from them.

Subcommands mirror the reference scripts:
  dnn   <feat-dim> <num-leaves> <num-hid-layers> <num-hid-neurons>
  lstm  <feat-dim> <num-leaves>   [--num-layers N --cell-dim D --proj-dim P]
  blstm <feat-dim> <num-leaves>   [--num-layers N --cell-dim D --proj-dim P]
  cnn   <feat-dim> <num-leaves>   [--num-filters ... --patch-dim ...]
"""

from __future__ import annotations

import argparse
import math
import sys


def _glorot(dim1, dim2, with_glorot=True):
    # the nnet1 generators' scaling: ~1.0 in inner layers at hid-dim 1024
    if with_glorot:
        return 35.0 * math.sqrt(2.0 / (dim1 + dim2))
    return 1.0


def dnn_proto(feat_dim, num_leaves, num_hid_layers, num_hid_neurons, *,
              activation="<Sigmoid>", hid_bias_mean=-2.0,
              hid_bias_range=4.0, param_stddev_factor=0.1,
              bottleneck_dim=0, with_softmax=True, with_glorot=True,
              with_dropout=0.0):
    """DNN prototype (make_nnet_proto.py role): hidden AffineTransform +
    activation stack, optional linear bottleneck before the last hidden
    layer, final AffineTransform (+ Softmax)."""
    L = ["<NnetProto>"]

    def affine(din, dout, stddev_scale=1.0, lr=None, bias_mean=None,
               bias_range=None):
        bias_mean = hid_bias_mean if bias_mean is None else bias_mean
        bias_range = hid_bias_range if bias_range is None else bias_range
        std = param_stddev_factor * _glorot(din, dout, with_glorot) * \
            stddev_scale
        line = (f"<AffineTransform> <InputDim> {din} <OutputDim> {dout} "
                f"<BiasMean> {bias_mean:f} <BiasRange> {bias_range:f} "
                f"<ParamStddev> {std:f}")
        if lr is not None:
            line += f" <LearnRateCoef> {lr:f} <BiasLearnRateCoef> {lr:f}"
        L.append(line)

    def act(dim):
        L.append(f"{activation} <InputDim> {dim} <OutputDim> {dim}")
        if with_dropout > 0:
            L.append(f"<Dropout> <InputDim> {dim} <OutputDim> {dim} "
                     f"<DropoutRetention> {1.0 - with_dropout:f}")

    cur = feat_dim
    for i in range(num_hid_layers):
        last_hidden = i == num_hid_layers - 1
        if last_hidden and bottleneck_dim > 0:
            std = param_stddev_factor * _glorot(cur, bottleneck_dim,
                                                with_glorot) * 0.75
            L.append(f"<LinearTransform> <InputDim> {cur} <OutputDim> "
                     f"{bottleneck_dim} <ParamStddev> {std:f} "
                     f"<LearnRateCoef> 0.1")
            cur = bottleneck_dim
            affine(cur, num_hid_neurons, stddev_scale=0.75, lr=0.1)
        else:
            affine(cur, num_hid_neurons)
        act(num_hid_neurons)
        cur = num_hid_neurons
    # output layer: zero bias, 10x smaller bias learn rate like nnet1
    std = param_stddev_factor * _glorot(cur, num_leaves, with_glorot)
    L.append(f"<AffineTransform> <InputDim> {cur} <OutputDim> {num_leaves} "
             f"<BiasMean> 0.000000 <BiasRange> 0.000000 "
             f"<ParamStddev> {std:f} <LearnRateCoef> 1.000000 "
             f"<BiasLearnRateCoef> 0.100000")
    if with_softmax:
        L.append(f"<Softmax> <InputDim> {num_leaves} <OutputDim> "
                 f"{num_leaves}")
    L.append("</NnetProto>")
    return "\n".join(L) + "\n"


def lstm_proto(feat_dim, num_leaves, *, num_layers=1, cell_dim=800,
               proj_dim=512, param_scale=0.02, clip_gradient=5.0,
               bidirectional=False):
    """LSTM/BLSTM prototype (make_lstm_proto.py / make_blstm_proto.py
    role)."""
    comp = ("<BLstmProjectedStreams>" if bidirectional
            else "<LstmProjectedStreams>")
    out_dim = proj_dim * (2 if bidirectional else 1)
    L = ["<NnetProto>"]
    cur = feat_dim
    for _ in range(num_layers):
        L.append(f"{comp} <InputDim> {cur} <OutputDim> {out_dim} "
                 f"<CellDim> {cell_dim} <ParamScale> {param_scale:f} "
                 f"<ClipGradient> {clip_gradient:f}")
        cur = out_dim
    std = _glorot(cur, num_leaves) * 0.1
    L.append(f"<AffineTransform> <InputDim> {cur} <OutputDim> {num_leaves} "
             f"<BiasMean> 0.0 <BiasRange> 0.0 <ParamStddev> {std:f}")
    L.append(f"<Softmax> <InputDim> {num_leaves} <OutputDim> {num_leaves}")
    L.append("</NnetProto>")
    return "\n".join(L) + "\n"


def cnn_proto(feat_dim, num_leaves, *, num_filters=128, patch_dim=8,
              patch_step=1, pool_size=3, num_hid_layers=2,
              num_hid_neurons=1024, splice=5, delta_order=0):
    """1-D convolutional front-end prototype (make_cnn_proto.py role):
    ConvolutionalComponent + MaxPooling, then a DNN tail."""
    num_splice = 2 * splice + 1
    patch_stride = feat_dim  # filters slide over the frequency axis
    L = ["<NnetProto>"]
    conv_out = num_filters * ((feat_dim - patch_dim) // patch_step + 1)
    L.append(
        f"<ConvolutionalComponent> <InputDim> {feat_dim * num_splice} "
        f"<OutputDim> {conv_out} <PatchDim> {patch_dim} "
        f"<PatchStep> {patch_step} <PatchStride> {patch_stride} "
        f"<ParamStddev> 0.01"
    )
    pool_out = num_filters * (
        ((feat_dim - patch_dim) // patch_step + 1) // pool_size)
    L.append(f"<MaxPoolingComponent> <InputDim> {conv_out} <OutputDim> "
             f"{pool_out} <PoolSize> {pool_size}")
    body = dnn_proto(pool_out, num_leaves, num_hid_layers,
                     num_hid_neurons).splitlines()[1:-1]
    L.extend(body)
    L.append("</NnetProto>")
    return "\n".join(L) + "\n"


def main(argv=None):
    parser = argparse.ArgumentParser(prog="make_nnet_proto")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("dnn")
    p.add_argument("feat_dim", type=int)
    p.add_argument("num_leaves", type=int)
    p.add_argument("num_hid_layers", type=int)
    p.add_argument("num_hid_neurons", type=int)
    p.add_argument("--activation-type", default="<Sigmoid>")
    p.add_argument("--bottleneck-dim", type=int, default=0)
    p.add_argument("--no-softmax", action="store_true")
    p.add_argument("--with-dropout", type=float, default=0.0)
    p.add_argument("--hid-bias-mean", type=float, default=-2.0)
    p.add_argument("--hid-bias-range", type=float, default=4.0)
    p.add_argument("--param-stddev-factor", type=float, default=0.1)

    for name in ("lstm", "blstm"):
        p = sub.add_parser(name)
        p.add_argument("feat_dim", type=int)
        p.add_argument("num_leaves", type=int)
        p.add_argument("--num-layers", type=int, default=1)
        p.add_argument("--cell-dim", type=int, default=800)
        p.add_argument("--proj-dim", type=int, default=512)
        p.add_argument("--param-scale", type=float, default=0.02)
        p.add_argument("--clip-gradient", type=float, default=5.0)

    p = sub.add_parser("cnn")
    p.add_argument("feat_dim", type=int)
    p.add_argument("num_leaves", type=int)
    p.add_argument("--num-filters", type=int, default=128)
    p.add_argument("--patch-dim", type=int, default=8)
    p.add_argument("--pool-size", type=int, default=3)
    p.add_argument("--num-hid-layers", type=int, default=2)
    p.add_argument("--num-hid-neurons", type=int, default=1024)

    opt = parser.parse_args(argv)
    if opt.cmd == "dnn":
        sys.stdout.write(dnn_proto(
            opt.feat_dim, opt.num_leaves, opt.num_hid_layers,
            opt.num_hid_neurons, activation=opt.activation_type,
            bottleneck_dim=opt.bottleneck_dim,
            with_softmax=not opt.no_softmax,
            with_dropout=opt.with_dropout,
            hid_bias_mean=opt.hid_bias_mean,
            hid_bias_range=opt.hid_bias_range,
            param_stddev_factor=opt.param_stddev_factor))
    elif opt.cmd in ("lstm", "blstm"):
        sys.stdout.write(lstm_proto(
            opt.feat_dim, opt.num_leaves, num_layers=opt.num_layers,
            cell_dim=opt.cell_dim, proj_dim=opt.proj_dim,
            param_scale=opt.param_scale, clip_gradient=opt.clip_gradient,
            bidirectional=opt.cmd == "blstm"))
    elif opt.cmd == "cnn":
        sys.stdout.write(cnn_proto(
            opt.feat_dim, opt.num_leaves, num_filters=opt.num_filters,
            patch_dim=opt.patch_dim, pool_size=opt.pool_size,
            num_hid_layers=opt.num_hid_layers,
            num_hid_neurons=opt.num_hid_neurons))
    return 0


if __name__ == "__main__":
    sys.exit(main())
