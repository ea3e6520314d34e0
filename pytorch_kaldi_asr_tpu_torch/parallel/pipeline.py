"""Pipeline parallelism (GPipe schedule) over a ``pipe`` mesh axis (the
JAX package's ``parallel/pipeline.py``).

Stage ``i`` of a ``("data", "pipe")`` mesh holds ``en_layers / n_stages``
encoder layers (its own only: :func:`stage_params`); microbatches flow
through the stages in the GPipe relay, and the hop between stages is one
``ppermute`` per tick (parallel/collectives.py).

- The schedule is ``M + S - 1`` ticks (M microbatches, S stages).  Stage s
  works on microbatch ``t - s`` at tick t and skips the bubble ticks (its
  output there is zeros), so each stage runs its layers exactly M times
  per forward; utilisation is GPipe's ``M / (M + S - 1)``.
- Activations travel with their frame mask: ``(x, mask)`` pairs ride the
  same ``ppermute``, so later stages see the right padding.
- Differentiable end to end: ``ppermute``'s backward is the reverse shift;
  the stage inputs enter through ``copy_to`` on every stage (a zero
  weight off stage 0, as the JAX package's ``where``), so every rank runs
  the same collectives backward.
- Dropout (``train=True, rngs=...``) draws each layer application's seeds
  from a generator seeded by (the step's draw, ``stage * lps + j``,
  microbatch), and the stack's input and output dropout from (the step's
  draw, n_layers): independent streams at the single-device encoder's
  sites (models/encoders.py ``banded_encode``).
- The last stage's outputs are replicated with one ``psum``; the loss head
  then runs on every rank, so its gradients are the same everywhere.
With a ``data`` axis of more than 1, each data rank relays its share of
every microbatch, and :func:`pp_frame_ce_loss`'s sums are the global
batch's; the caller sums the gradients over ``data``.
"""

from __future__ import annotations

import torch

from pytorch_kaldi_asr_tpu_torch.models.common import (
    fold_seq_and_mask,
    linear,
    position_encoding_table,
)
from pytorch_kaldi_asr_tpu_torch.models.transformer import (
    _drop,
    compute_dtype,
    feed_forward,
)
from pytorch_kaldi_asr_tpu_torch.parallel.collectives import (
    copy_to,
    ppermute,
    psum,
)
from pytorch_kaldi_asr_tpu_torch.parallel.mesh import Mesh, _world_ranks
from pytorch_kaldi_asr_tpu_torch.parallel.sequence import draw_base, fold_rng


def make_pipe_mesh(pipe=None, data=1, ranks=None):
    """A ``("data", "pipe")`` mesh over ``ranks`` (default: the world):
    batch over ``data``, layer stages over ``pipe``; ``pipe`` defaults to
    n_ranks / data."""
    ranks = _world_ranks(ranks)
    pipe = pipe or (len(ranks) // data)
    if data * pipe > len(ranks):
        raise ValueError(
            f"mesh {data}x{pipe} needs {data * pipe} devices, "
            f"have {len(ranks)}")
    return Mesh(("data", "pipe"), (data, pipe), ranks[:data * pipe],
                shifted=("pipe",))


def stack_stage_params(layers, n_stages):
    """Stack L identically-structured layer trees into one tree with
    leading axes ``[n_stages, L // n_stages, ...]`` (stage i's slab is its
    resident layers, in order)."""
    n_layers = len(layers)
    if n_layers % n_stages != 0:
        raise ValueError(
            f"{n_layers} layers do not divide into {n_stages} stages")
    lps = n_layers // n_stages

    def stack(*leaves):
        if isinstance(leaves[0], dict):
            return {k: stack(*(l[k] for l in leaves)) for k in leaves[0]}
        return torch.stack(leaves).reshape(n_stages, lps,
                                           *leaves[0].shape)

    return stack(*layers)


def _check(cfg, mesh, b, n_micro):
    n_stages = mesh.size("pipe")
    if cfg.en_layers % n_stages != 0:
        raise ValueError(
            f"{cfg.en_layers} layers do not divide into "
            f"{n_stages} pipeline stages")
    m = n_micro or n_stages
    if b % m != 0:
        raise ValueError(f"batch {b} not divisible by {m} microbatches")
    data = mesh.size("data")
    if (b // m) % data != 0:
        raise ValueError(
            f"microbatch size {b // m} not divisible by the 'data' "
            f"axis ({data})")
    return m


def stage_params(params, cfg, mesh):
    """``params`` (an encoder or AM tree) with this stage's layers only,
    in order (the other leaves shared)."""
    enc = params.get("encoder", params)
    lps = cfg.en_layers // mesh.size("pipe")
    first = mesh.index("pipe") * lps
    own = dict(enc, layers=list(enc["layers"][first:first + lps]))
    return dict(params, encoder=own) if "encoder" in params else own


def _own_layers(enc, cfg, mesh):
    layers = enc["layers"]
    if len(layers) == cfg.en_layers and mesh.size("pipe") > 1:
        lps = cfg.en_layers // mesh.size("pipe")
        first = mesh.index("pipe") * lps
        layers = layers[first:first + lps]
    return layers


def _banded_stage(layers, x, mask, base, stage, mb_idx, *, cfg, train):
    """This stage's resident banded layers (attention + FFN each) on one
    microbatch; each application's dropout from (base, stage * lps + j,
    microbatch)."""
    from pytorch_kaldi_asr_tpu_torch.models.encoders import (
        _banded_self_attention,
    )

    rate = cfg.en_dropout
    lps = len(layers)
    for j, layer in enumerate(layers):
        rngs = None
        if base is not None and train:
            rngs = fold_rng(base, stage * lps + j, mb_idx)
        x = _banded_self_attention(layer["slf"], x, mask, cfg, rate, rngs,
                                   train)
        x = feed_forward(layer["ffn"], x, cfg, rate, rngs, train)
    return x


def _relay(stage_fn, xs, masks, axis):
    """The GPipe relay: microbatch m enters stage 0 at tick m, reaches
    stage s at tick m + s and leaves the last stage at tick m + S - 1;
    ``(x, mask)`` move one stage right per tick.  Returns [M, ...] outputs,
    replicated over the axis."""
    n_stages = axis.size if axis is not None else 1
    stage = axis.index if axis is not None else 0
    n_micro = xs.shape[0]
    xs = copy_to(xs, axis)
    first = float(stage == 0)
    # every tick's output hangs off the previous tick's hop on every rank,
    # bubbles included, so each rank runs every hop's backward, in order
    state = xs[0] * 0.0
    state_m = torch.zeros_like(masks[0])
    outs = []
    for t in range(n_micro + n_stages - 1):
        mb = t - stage
        if 0 <= mb < n_micro:
            i_in = min(t, n_micro - 1)
            x0 = xs[i_in] * first + state * (1.0 - first)
            m0 = masks[i_in] if stage == 0 else state_m
            y = stage_fn(x0, m0, stage, mb)
        else:  # a bubble: nothing to compute, zeros move on
            m0 = torch.zeros_like(state_m)
            y = state * 0.0
        if t >= n_stages - 1:  # zeros off the last stage, still a node
            outs.append(y if stage == n_stages - 1 else y * 0.0)
        if n_stages > 1 and t < n_micro + n_stages - 2:
            state = ppermute(y, axis, 1)
            state_m = ppermute(m0, axis, 1)
    return psum(torch.stack(outs), axis)


def pp_banded_encode(params, cfg, src, mask, mesh, *, n_microbatches=None,
                     train=False, rngs=None):
    """Banded encoder forward with the LAYER stack pipelined over the
    mesh's ``pipe`` axis (GPipe; see the module docstring).

    ``params`` is the banded encoder's tree with all layers or this
    stage's (:func:`stage_params`); ``src`` [B, S, D_folded] and ``mask``
    [B, S] the global batch after folding.  ``n_microbatches`` (default:
    the stage count) must divide B, and with a ``data`` axis of d > 1 each
    microbatch's rows must divide over it.  Returns [B, S, d_model]
    (numerically the single-device ``banded_encode`` on the dropout-free
    path), or with d > 1 this data rank's rows of it: of each microbatch,
    its d-th share (:func:`pp_rows`)."""
    m = _check(cfg, mesh, src.shape[0], n_microbatches)
    axis = mesh.axis("pipe")
    b, s = src.shape[0], src.shape[1]
    rows = pp_rows(b, m, mesh)
    src, mask = src[rows], mask[rows]
    pos = position_encoding_table(max(cfg.encoder_max_len, s),
                                  cfg.en_d_model, device=src.device)[:s]
    dtype = compute_dtype(cfg)
    x = linear(src, params["src_proj"]["w"], None, dtype)
    x = (x if dtype is None else x.float()) + pos[None]
    rate = cfg.en_dropout if train else 0.0
    base = None
    if rngs is not None and train:
        base = draw_base(rngs)
    # the stack's input and output dropout: a stream disjoint from the
    # layers' (stage * lps + j < n_layers)
    outer = None if base is None else fold_rng(base, cfg.en_layers)
    x = _drop(x, rate, outer, train)
    mb = len(rows) // m
    xs = x.reshape(m, mb, s, x.shape[-1])
    ms = mask.reshape(m, mb, s).float()
    layers = _own_layers(params, cfg, mesh)

    def stage_fn(x0, m0, stage, mb_idx):
        return _banded_stage(layers, x0, m0, base, stage, mb_idx, cfg=cfg,
                             train=train)

    x = _relay(stage_fn, xs, ms, axis).reshape(len(rows), s, -1)
    x = x + pos[None]  # positions again after the stack
    return _drop(x, rate, outer, train)


def pp_rows(b, n_micro, mesh):
    """The global batch rows this data rank relays, in order: of each of
    the ``n_micro`` microbatches, its share."""
    data = mesh.size("data")
    d = mesh.index("data") if data > 1 else 0
    mb = b // n_micro
    per = mb // data
    return [m * mb + d * per + j for m in range(n_micro) for j in range(per)]


def pp_frame_ce_loss(params, cfg, src, src_mask, targets, mesh, *,
                     n_microbatches=None, train=False, rngs=None,
                     utt_valid=None):
    """Frame-level CE with the encoder stack pipelined (models/am.py
    ``frame_ce_loss`` semantics: fold -> encoder -> head -> masked CE);
    ``params`` an AM tree with a banded encoder (all layers or this
    stage's).  Returns the global batch's (loss_sum, n_correct, n_frames):
    with a ``data`` axis the sums are ``psum``'d over it.  ``utt_valid``
    [B] excludes the loader's duplicated tail rows, as ``frame_ce_loss``
    does."""
    from pytorch_kaldi_asr_tpu_torch.models.am import head_log_posteriors

    src, mask = fold_seq_and_mask(src, src_mask, cfg.src_fold)
    m = _check(cfg, mesh, src.shape[0], n_microbatches)
    enc = pp_banded_encode(params["encoder"], cfg, src, mask, mesh,
                           n_microbatches=m, train=train, rngs=rngs)
    rows = pp_rows(src.shape[0], m, mesh)
    logp = head_log_posteriors(params, cfg, enc)
    valid = mask[rows].float()
    if utt_valid is not None:
        valid = valid * utt_valid[rows].float()[:, None]
    tgt = targets[rows].long()
    nll = -torch.take_along_dim(logp, tgt[..., None], dim=-1)[..., 0]
    data = mesh.axis("data")
    loss = psum((nll * valid).sum(), data)
    n_correct = psum(((logp.argmax(dim=-1) == tgt).float() * valid).sum(),
                     data)
    return loss, n_correct.detach(), psum(valid.sum(), data).detach()
