"""A frame-level model from an nnet1-style network prototype (the port's
``pytorch_kaldi_asr_tpu.models.proto``).

``parse_proto`` reads the <NnetProto> text that tools/make_nnet_proto.py
writes; ``init_proto`` draws its parameters (a list aligned with the
components, ``{"w": [in, out], "b": [out]}`` for an affine, ``{"w"}`` for
a linear transform, ``{}`` otherwise) and ``apply_proto`` is its forward,
plain functions on that list as in models/am.py, so a declarative
frame-level AM sits beside the encoder zoo.

Supported components: <AffineTransform>, <LinearTransform>, <Sigmoid>,
<Tanh>, <ReLU>, <Softmax> (over the last axis), <Dropout> and <Splice>
(context frames clamp at the utterance's edges).  Recurrent and
convolutional protos (LSTM, CNN) are generated for artifact parity only:
``init_proto`` raises for them, as the JAX package does.  Each <Dropout>
is ``models.common.dropout`` with the next seed of ``rngs``
(``DropoutRngs``), so on the card it launches the fused-dropout kernel
(K3) and the masks are the ones the CPU draws.
"""

from __future__ import annotations

import numpy as np
import torch

from pytorch_kaldi_asr_tpu_torch.models.common import dropout as _dropout

SUPPORTED = {"<AffineTransform>", "<LinearTransform>", "<Sigmoid>",
             "<Tanh>", "<ReLU>", "<Softmax>", "<Dropout>", "<Splice>"}


def parse_proto(text):
    """<NnetProto> text -> [ {type, attrs...} ] component dicts."""
    comps = []
    for line in text.splitlines():
        toks = line.split()
        if not toks or toks[0] in ("<NnetProto>", "</NnetProto>"):
            continue
        comp = {"type": toks[0]}
        i = 1
        while i + 1 < len(toks) + 1 and i < len(toks):
            key = toks[i]
            if key.startswith("<") and i + 1 < len(toks):
                comp[key[1:-1]] = toks[i + 1]
                i += 2
            else:
                i += 1
        comps.append(comp)
    return comps


def init_proto(generator, comps, device=None):
    """Parameters of a parsed proto, drawn from the ``torch.Generator``
    (float32, on the CPU, then moved to ``device``): an affine's weight
    normal with the proto's ParamStddev, its bias uniform in BiasMean ±
    BiasRange / 2."""
    params = []
    for comp in comps:
        t = comp["type"]
        if t not in SUPPORTED:
            raise ValueError(
                f"component {t} is generated for artifact parity but must "
                f"be realized via the encoder zoo (models/encoders.py)")
        if t in ("<AffineTransform>", "<LinearTransform>"):
            din = int(comp["InputDim"])
            dout = int(comp["OutputDim"])
            std = float(comp.get("ParamStddev", 0.1))
            p = {"w": std * torch.randn((din, dout), generator=generator)}
            if t == "<AffineTransform>":
                bias_mean = float(comp.get("BiasMean", 0.0))
                bias_range = float(comp.get("BiasRange", 0.0))
                p["b"] = bias_mean + bias_range * (
                    torch.rand((dout,), generator=generator) - 0.5)
            params.append({k: v.to(device) for k, v in p.items()})
        else:
            params.append({})
    return params


def proto_params_from_jax(params, device=None):
    """The JAX package's parameter list (``{"w", "b"}`` arrays) as the
    port's: float32 tensors on ``device``."""
    return [{k: torch.tensor(np.asarray(v), dtype=torch.float32,
                             device=device) for k, v in p.items()}
            for p in params]


def _splice(x, ctx):
    """nnet1 splice: the frames at each offset of ``ctx``, clamped (edge
    frames repeat) at the utterance's ends, concatenated in context
    order."""
    n = x.shape[-2]
    idx = torch.arange(n, device=x.device)
    return torch.cat([x.index_select(-2, (idx + off).clamp(0, n - 1))
                      for off in ctx], dim=-1)


def apply_proto(params, comps, x, *, train=False, rngs=None):
    """Forward over [B, T, D] (or [N, D]) inputs.  With ``train`` and
    ``rngs`` every <Dropout> drops (one seed of ``rngs`` each); otherwise
    it is the identity."""
    for p, comp in zip(params, comps):
        t = comp["type"]
        if t in ("<AffineTransform>", "<LinearTransform>"):
            x = x @ p["w"]
            if "b" in p:
                x = x + p["b"]
        elif t == "<Sigmoid>":
            x = torch.sigmoid(x)
        elif t == "<Tanh>":
            x = torch.tanh(x)
        elif t == "<ReLU>":
            x = torch.relu(x)
        elif t == "<Softmax>":
            x = torch.softmax(x, dim=-1)
        elif t == "<Dropout>":
            keep = float(comp.get("DropoutRetention", 0.5))
            if train and rngs is not None and keep < 1.0:
                x = _dropout(x, 1.0 - keep, rngs.seed(), train)
        elif t == "<Splice>":
            ctx = [int(c) for c in comp.get("Context", "0").split(":")]
            x = _splice(x, ctx)
    return x


def proto_output_dim(comps):
    for comp in reversed(comps):
        if "OutputDim" in comp:
            return int(comp["OutputDim"])
    raise ValueError("proto has no OutputDim")
