"""The flagship acoustic model: encoder + windowed-attention transformer
decoder, as plain functions over a parameter tree of tensors.

The tree has the same nesting and names as the JAX package's
(``pytorch_kaldi_asr_tpu.models.transformer``), so a flax checkpoint maps
onto it leaf for leaf.  Heads are an einsum axis of per-head projection
tensors ``[H, D, K]``.

Numerical contract kept from the reference (and pinned against the JAX
package by tests/test_torch_models.py):

- attention scale is 1/sqrt(d_model), NOT 1/sqrt(d_k);
- post-LN residuals with the eps=1e-3 unbiased-std layer norm;
- banded decoder self-attention window ``decoder_sub_sequence``;
- the ``tdnn`` encoder is splice → frozen LDA affine → src_projection →
  TDNN stack → +sinusoid positions; ``banded``, ``blstm``, ``conformer``
  and ``tdnnf`` live in models/encoders.py;
- decoder: word+position embeddings → [self-attn, cross-attn, FFN]×N →
  vocab projection (no bias), with enc_dec_projection en_d_model→de_d_model.

Training (``train=True``) adds dropout at the JAX package's sites, in its
order, each site with its own seed from the ``DropoutRngs`` of
models/common.py passed as ``rngs``; with ``rngs=None`` every dropout is the
identity.  The masks come from the fused-dropout kernel's Philox, not from
``jax.random``, so the packages are compared with dropout off.

``compute_dtype="bfloat16"`` (the configuration the JAX package's bench
trains) runs every product in bfloat16 with the JAX package's casts, cast
for cast (``common.linear``: the product rounded, then the bias add rounded
again); the softmax, layer norm, residual sums and logits stay float32, and
so do the parameters, their gradients and Adam's state.  The attention
logits divide by ``sqrt(d_model)`` computed in bfloat16 (11.3125 for 128).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pytorch_kaldi_asr_tpu_torch.models import common
from pytorch_kaldi_asr_tpu_torch.models.common import (
    banded_attn_mask,
    cast,
    dropout,
    fold_seq_and_mask,
    layer_norm,
    linear,
    masked_softmax,
    padding_attn_mask,
    position_encoding_table,
    torch_default_uniform,
    xavier_normal,
)
from pytorch_kaldi_asr_tpu_torch.parallel.collectives import (
    copy_to,
    gather_from,
    model_axis,
    reduce_from,
)

@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Model hyperparameters; field for field the JAX package's
    ``TransformerConfig`` (same order, same defaults), so ``config.json``
    round-trips.  Dtypes are stored by name: ``compute_dtype`` float32 or
    bfloat16 (the dtype of the products), ``conformer_stream_dtype`` float32
    or bfloat16 (the conformer recipe's default).  ``use_banded_kernel`` is
    kept only for that round trip: the port routes nothing by it (a CUDA
    tensor always takes the banded kernel, a CPU tensor its plain
    version)."""

    src_dim: int
    vocab_size: int
    encoder_max_len: int = 500
    decoder_max_len: int = 100
    src_fold: int = 1
    encoder_sub_sequence: tuple = (-100, 0)
    decoder_sub_sequence: tuple = (-10, 0)
    en_layers: int = 3
    de_layers: int = 3
    n_head: int = 2
    en_d_model: int = 256
    de_d_model: int = 128
    d_k: int = 64
    d_v: int = 64
    en_dropout: float = 0.35
    de_dropout: float = 0.35
    lda_context: tuple = (-2, -1, 0, 1, 2)
    tdnn_contexts: tuple = (
        (-1, 0, 1),
        (-1, 0, 1),
        (-3, 0, 3),
        (-3, 0, 3),
        (-3, 0, 3),
        (-3, 0, 3),
    )
    ln_skip_len1: bool = True
    compute_dtype: str = "float32"
    encoder_type: str = "tdnn"
    conformer_kernel: int = 15
    conformer_stream_dtype: str = "float32"
    conformer_causal_conv: bool = False
    tdnnf_bottleneck: int = 64
    use_banded_kernel: object = None

    def __post_init__(self):
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype={self.compute_dtype!r}: float32 "
                             f"or bfloat16")
        if self.conformer_stream_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"conformer_stream_dtype="
                             f"{self.conformer_stream_dtype!r}: float32 or "
                             f"bfloat16")

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_mha(gen, d_model, n_head, d_k, d_v, init_compat="native"):
    if init_compat == "torch":
        proj_b = torch_default_uniform(gen, (d_model,), n_head * d_v)
    else:
        proj_b = torch.zeros(d_model)
    return {
        "w_qs": xavier_normal(gen, (n_head, d_model, d_k), d_model * d_k, n_head * d_k),
        "w_ks": xavier_normal(gen, (n_head, d_model, d_k), d_model * d_k, n_head * d_k),
        "w_vs": xavier_normal(gen, (n_head, d_model, d_v), d_model * d_v, n_head * d_v),
        "proj": {
            "w": xavier_normal(gen, (n_head * d_v, d_model), n_head * d_v, d_model),
            "b": proj_b,
        },
        "ln": {"gamma": torch.ones(d_model), "beta": torch.zeros(d_model)},
    }


def _init_ffn(gen, d_model, d_inner, init_compat="native"):
    if init_compat == "torch":
        w1 = torch_default_uniform(gen, (d_model, d_inner), d_model)
        b1 = torch_default_uniform(gen, (d_inner,), d_model)
        w2 = torch_default_uniform(gen, (d_inner, d_model), d_inner)
        b2 = torch_default_uniform(gen, (d_model,), d_inner)
    else:
        w1 = xavier_normal(gen, (d_model, d_inner), d_model, d_inner)
        b1 = torch.zeros(d_inner)
        w2 = xavier_normal(gen, (d_inner, d_model), d_inner, d_model)
        b2 = torch.zeros(d_model)
    return {
        "w1": {"w": w1, "b": b1},
        "w2": {"w": w2, "b": b2},
        "ln": {"gamma": torch.ones(d_model), "beta": torch.zeros(d_model)},
    }


def init_transformer(generator, cfg: TransformerConfig, lda_mat=None,
                     init_compat="native"):
    """Build the parameter tree (float32, on the CPU) from ``generator``.

    ``lda_mat`` is the Kaldi LDA/MLLT affine as stored in ``lda.mat`` (last
    column = bias); None gives an identity frontend.  ``init_compat='torch'``
    gives the reference's torch-default FFN and bias inits.  Draws differ
    from the JAX package's (another generator); the distributions match."""
    if cfg.encoder_type != "tdnn":
        from pytorch_kaldi_asr_tpu_torch.models.encoders import encoder_init

        return {
            "encoder": encoder_init(cfg.encoder_type)(generator, cfg),
            "decoder": _init_decoder(generator, cfg, init_compat),
        }

    spliced_dim = cfg.src_dim * cfg.src_fold * len(cfg.lda_context)
    if lda_mat is None:
        lda_w = torch.eye(spliced_dim)
        lda_b = torch.zeros(spliced_dim)
    else:
        lda_mat = np.asarray(lda_mat, dtype=np.float32)
        lda_w = torch.from_numpy(np.ascontiguousarray(lda_mat[:, :-1].T))
        lda_b = torch.from_numpy(np.ascontiguousarray(lda_mat[:, -1]))
    lda_out_dim = lda_w.shape[1]

    d = cfg.en_d_model
    encoder = {
        "lda": {"w": lda_w, "b": lda_b},
        "src_proj": {
            "w": xavier_normal(generator, (lda_out_dim, d), lda_out_dim, d)
        },
        "tdnn": [],
    }
    for ctx in cfg.tdnn_contexts:
        if init_compat == "torch":
            b = torch_default_uniform(generator, (d,), d * len(ctx))
        else:
            b = torch.zeros(d)
        encoder["tdnn"].append({
            "w": xavier_normal(generator, (d * len(ctx), d), d * len(ctx), d),
            "b": b,
        })
    return {"encoder": encoder,
            "decoder": _init_decoder(generator, cfg, init_compat)}


def _init_decoder(gen, cfg: TransformerConfig, init_compat="native"):
    """Decoder subtree (shared by every encoder family)."""
    # nn.Embedding's default N(0, 1); row 0 (padding_idx) is zero
    embed = torch.randn((cfg.vocab_size, cfg.de_d_model), generator=gen)
    embed[0] = 0.0
    decoder = {
        "embed": embed,
        "enc_dec_proj": {
            "w": xavier_normal(gen, (cfg.en_d_model, cfg.de_d_model),
                               cfg.en_d_model, cfg.de_d_model)
        },
        "layers": [],
        "word_proj": {
            "w": xavier_normal(gen, (cfg.de_d_model, cfg.vocab_size),
                               cfg.de_d_model, cfg.vocab_size)
        },
    }
    for _ in range(cfg.de_layers):
        decoder["layers"].append({
            "slf": _init_mha(gen, cfg.de_d_model, cfg.n_head, cfg.d_k,
                             cfg.d_v, init_compat),
            "enc": _init_mha(gen, cfg.de_d_model, cfg.n_head, cfg.d_k,
                             cfg.d_v, init_compat),
            "ffn": _init_ffn(gen, cfg.de_d_model, cfg.de_d_model, init_compat),
        })
    return decoder


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor leaf of a dict/list parameter tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)



# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------


def _drop(x, rate, rngs, train):
    """Dropout at one site, with the next seed of ``rngs``."""
    if not train or rate == 0.0 or rngs is None:
        return x
    return dropout(x, rate, rngs.seed(), train)


# ---------------------------------------------------------------------------
# tensor parallelism: the collectives GSPMD inserts in the JAX package's
# sharded step (parallel/mesh.py has the layout).  With no ``model`` axis
# active (parallel/collectives.tensor_parallel) every hook is the identity.
# A region starts where a replicated tensor meets split weights (copy_to:
# its gradient summed over ``model``) and ends where the partial products
# are summed (reduce_from), the bias added after the sum.
# ---------------------------------------------------------------------------


def _enter_region(tensors, axis):
    """Each distinct tensor of ``tensors`` through ``copy_to`` once."""
    seen = {}
    return tuple(seen.setdefault(id(t), copy_to(t, axis)) for t in tensors)


def _tp_attention(p, cfg):
    """The ``model`` axis when this attention block's output projection
    is split over it, else None."""
    axis = model_axis()
    if axis is None or p["proj"]["w"].shape[0] == cfg.n_head * cfg.d_v:
        return None
    return axis


def _tp_weight(p, name, cfg, axis):
    """A head projection inside a region: as held when its heads are split;
    when they are replicated (the axis does not divide them) its gradient
    is a partial sum, so it enters through ``copy_to``."""
    w = p[name]
    if axis is None or w.shape[0] != cfg.n_head:
        return w
    return copy_to(w, axis)


def _region_rngs(rngs, axis):
    """Inside a region each rank of ``model`` holds other heads (or FFN
    columns): their dropout seeds differ by rank, one seed drawn from the
    shared stream per site so the ranks' streams stay in step."""
    if axis is None or rngs is None:
        return rngs
    return _MixedRngs(rngs, axis.index)


class _MixedRngs:
    def __init__(self, rngs, index):
        self.rngs, self.index = rngs, index

    def seed(self):
        return (self.rngs.seed() + self.index * 0x9E3779B1) % (2**31 - 1)


def _tp_proj(out, proj, dtype, axis):
    """``out @ proj.w + proj.b``; in a region the rows of ``proj.w`` held
    here (``out``'s matching columns) and the partial sums summed."""
    if axis is None:
        return linear(out, proj["w"], proj["b"], dtype)
    rows = proj["w"].shape[0]
    if out.shape[-1] != rows:  # replicated heads, split projection
        out = out[..., axis.index * rows:(axis.index + 1) * rows]
    return _tp_out(out, proj, dtype, axis)


def _tp_out(h, layer, dtype, axis):
    """``h @ layer.w + layer.b`` leaving a region (or plain)."""
    if axis is None:
        return linear(h, layer["w"], layer["b"], dtype)
    out = reduce_from(linear(h, layer["w"], None, dtype), axis)
    return out + cast(layer["b"], dtype)


def _tp_ffn(p):
    """The ``model`` axis when this FFN's inner dimension is split."""
    axis = model_axis()
    if axis is None or p["w1"]["w"].shape[1] == p["w1"]["b"].shape[0]:
        return None
    return axis


def _local_bias(b, n, axis):
    """The slice of a replicated bias that matches this rank's ``n``
    columns (its gradient summed over ``model``)."""
    return copy_to(b, axis)[axis.index * n:(axis.index + 1) * n]


def compute_dtype(cfg):
    """The dtype the products run in: None for float32 (the weights'
    dtype), or torch.bfloat16."""
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None


def logit_divisor(d_model, dtype):
    """sqrt(d_model) as the JAX package divides the attention logits by it:
    in float32, or on bfloat16 ``sqrt(bf16(d_model))`` rounded to bfloat16
    (11.3125 for 128, not 11.3137)."""
    if dtype is None:
        return np.sqrt(np.float32(d_model))
    return float(torch.sqrt(torch.tensor(float(d_model), dtype=dtype)))


def multi_head_attention(p, q, k, v, blocked, cfg, rate=0.0, rngs=None,
                         train=False):
    """Post-LN multi-head attention.  ``blocked`` is [B, Lq, Lk] bool.
    Scale divisor is sqrt(d_model), not sqrt(d_k).  Training drops the
    attention probabilities and the projected output.  In bfloat16 compute
    the projections, logits and probabilities are bfloat16 (the softmax
    float32, the probabilities dropped after the cast) and the residual sum
    float32."""
    dtype = compute_dtype(cfg)
    residual = q
    scale = q.shape[-1]
    tp = _tp_attention(p, cfg)
    if tp is not None:
        q, k, v = _enter_region((q, k, v), tp)
    w = {n: _tp_weight(p, n, cfg, tp) for n in ("w_qs", "w_ks", "w_vs")}
    qs = torch.einsum("bld,hdk->bhlk", cast(q, dtype), cast(w["w_qs"], dtype))
    ks = torch.einsum("bld,hdk->bhlk", cast(k, dtype), cast(w["w_ks"], dtype))
    vs = torch.einsum("bld,hdv->bhlv", cast(v, dtype), cast(w["w_vs"], dtype))
    logits = torch.einsum("bhqk,bhlk->bhql", qs, ks) / logit_divisor(scale,
                                                                      dtype)
    if dtype is None:
        attn = masked_softmax(logits, blocked[:, None, :, :])
    else:
        attn = masked_softmax(logits.float(), blocked[:, None, :, :]).to(dtype)
    attn = _drop(attn, rate, _region_rngs(rngs, tp), train)
    out = torch.einsum("bhql,bhlv->bhqv", attn, vs)
    b, h, lq, dv = out.shape
    out = out.transpose(1, 2).reshape(b, lq, h * dv)
    out = _tp_proj(out, p["proj"], dtype, tp)
    out = _drop(out, rate, rngs, train)
    return layer_norm(out + residual, p["ln"]["gamma"], p["ln"]["beta"],
                      skip_len1=cfg.ln_skip_len1)


def feed_forward(p, x, cfg, rate=0.0, rngs=None, train=False):
    """Position-wise FFN with ReLU and post-LN residual; training drops the
    FFN's output.  In bfloat16 compute both products are bfloat16 and the
    residual sum float32."""
    dtype = compute_dtype(cfg)
    tp = _tp_ffn(p)
    xin, b1 = x, p["w1"]["b"]
    if tp is not None:
        (xin,) = _enter_region((x,), tp)
        b1 = _local_bias(b1, p["w1"]["w"].shape[1], tp)
    h = torch.relu(linear(xin, p["w1"]["w"], b1, dtype))
    out = _tp_out(h, p["w2"], dtype, tp)
    out = _drop(out, rate, rngs, train)
    return layer_norm(out + x, p["ln"]["gamma"], p["ln"]["beta"],
                      skip_len1=cfg.ln_skip_len1)


def encode(params, cfg: TransformerConfig, src_seq, src_mask, *,
           pos_offset=0, train=False, rngs=None):
    """Fold the input, then run the configured encoder family.  Expects
    UNfolded input [B, S, D]; returns (enc_output, folded src_mask).

    ``tdnn``: splice → frozen LDA → projection → TDNN stack → +positions
    (position indices shifted by ``pos_offset``, saturating at the table
    end), with dropout after the projection, each TDNN layer and the
    positions when training.  In bfloat16 compute the LDA, the projection
    and the TDNN stack are bfloat16, the positions added in float32."""
    src_seq, src_mask = fold_seq_and_mask(src_seq, src_mask, cfg.src_fold)
    if cfg.encoder_type != "tdnn":
        from pytorch_kaldi_asr_tpu_torch.models.encoders import encoder_apply

        return encoder_apply(cfg.encoder_type)(
            params["encoder"], cfg, src_seq, src_mask, train=train,
            rngs=rngs)

    p = params["encoder"]
    rate = cfg.en_dropout
    dtype = compute_dtype(cfg)
    x = common.spliced_linear(src_seq, p["lda"]["w"], p["lda"]["b"],
                              cfg.lda_context, dtype)
    x = linear(x, p["src_proj"]["w"], None, dtype)
    x = _drop(x, rate, rngs, train)
    for ctx, layer in zip(cfg.tdnn_contexts, p["tdnn"]):
        x = torch.relu(common.spliced_linear(x, layer["w"], layer["b"], ctx,
                                             dtype))
        x = _drop(x, rate, rngs, train)
    if dtype is not None:
        x = x.float()

    pos_table = position_encoding_table(cfg.encoder_max_len, cfg.en_d_model,
                                        device=x.device)
    pos_idx = torch.clamp(
        pos_offset + torch.arange(x.shape[1], device=x.device), 0,
        cfg.encoder_max_len - 1)
    x = x + pos_table[pos_idx][None, :, :]
    return _drop(x, rate, rngs, train), src_mask


def decode_logits(params, cfg: TransformerConfig, tgt_seq, tgt_mask,
                  src_mask, enc_output, *, train=False, rngs=None):
    """Teacher-forced decoder: returns [B, T, vocab] logits (in the
    weights' dtype, float32; in bfloat16 compute the encoder projection and
    the vocabulary projection are bfloat16 products, their results
    float32)."""
    p = params["decoder"]
    t = tgt_seq.shape[1]
    device = enc_output.device
    rate = cfg.de_dropout
    dtype = compute_dtype(cfg)

    pos_table = position_encoding_table(cfg.decoder_max_len, cfg.de_d_model,
                                        device=device)
    # a bfloat16 encoder stream enters the decoder in the weights' dtype
    # here (``linear``'s cast); a bfloat16 product comes back to float32
    enc = linear(enc_output, p["enc_dec_proj"]["w"], None, dtype)
    enc = enc if dtype is None else enc.float()
    x = p["embed"][tgt_seq]
    if model_axis() is not None and x.shape[-1] != cfg.de_d_model:
        x = gather_from(x, model_axis())  # d_model split over ``model``
    x = x + pos_table[:t][None, :, :]

    slf_blocked = padding_attn_mask(tgt_mask, tgt_mask) | banded_attn_mask(
        t, cfg.decoder_sub_sequence[0], cfg.decoder_sub_sequence[1],
        device=device)[None, :, :]
    cross_blocked = padding_attn_mask(tgt_mask, src_mask)

    x = _drop(x, rate, rngs, train)
    for layer in p["layers"]:
        x = multi_head_attention(layer["slf"], x, x, x, slf_blocked, cfg,
                                 rate, rngs, train)
        x = multi_head_attention(layer["enc"], x, enc, enc, cross_blocked,
                                 cfg, rate, rngs, train)
        x = feed_forward(layer["ffn"], x, cfg, rate, rngs, train)
    x = _drop(x, rate, rngs, train)
    w = p["word_proj"]["w"]
    tp = model_axis()
    if tp is not None and w.shape[1] != cfg.vocab_size:  # vocab split
        (x,) = _enter_region((x,), tp)
        logits = gather_from(linear(x, w, None, dtype), tp)
    else:
        logits = linear(x, w, None, dtype)
    return logits if dtype is None else logits.float()


def transformer_forward(params, cfg: TransformerConfig, src_seq, src_mask,
                        tgt_seq, tgt_mask, *, train=False, rngs=None):
    """Full teacher-forced forward: fold → encode → decode; returns
    [B, T, vocab] logits.  ``train=True`` runs the training branch (the
    banded encoder's differentiable attention, and dropout when ``rngs`` is
    given)."""
    enc_output, folded_src_mask = encode(params, cfg, src_seq, src_mask,
                                         train=train, rngs=rngs)
    return decode_logits(params, cfg, tgt_seq, tgt_mask, folded_src_mask,
                         enc_output, train=train, rngs=rngs)
