"""The collectives of the port's parallel paths: what the JAX package gets
from ``jax.lax`` (``psum``, ``ppermute``) and what GSPMD inserts for its
sharded train step, as ``torch.autograd.Function``s over process groups.

Every collective here is an ``all_reduce`` or a ``broadcast``: the two that
NCCL and gloo both carry on CUDA tensors, so one code path runs under NCCL
across cards and under gloo with several ranks sharing one card (or on the
CPU).  A point-to-point hop (``ppermute``) is a broadcast inside the
two-rank group ``{i, i+1}`` of a mesh axis; the pair groups are made once
per mesh (parallel/mesh.py).  No other module of the port calls
``torch.distributed``'s collectives.

An :class:`Axis` is one axis of a mesh as this rank sees it: the global
ranks along it, this rank's index, the group (None for an axis of size
1, where every collective is the identity) and the pair groups.

- :func:`psum`: all_reduce forward; identity backward, where the summed
  value is used replicated by every rank of the axis (the caller then
  holds each rank's share of the gradient; the step sums them).
- :func:`copy_to` / :func:`reduce_from`: the Megatron pair of a
  tensor-parallel region: identity forward with an all_reduce backward
  where a replicated tensor enters the region, all_reduce forward with an
  identity backward where its partial sums leave it.
- :func:`gather_from`: a sharded last dimension made whole (an all_reduce
  of a zero-filled full tensor, as gloo has no all_gather on CUDA); its
  backward keeps this rank's slice.
- :func:`ppermute`: the shift ``i -> i+1`` (``shift=1``) or ``i+1 -> i``
  (``shift=-1``), zeros where nothing arrives; its backward is the
  reverse shift.
- :func:`all_reduce_`, :func:`broadcast_`: in place, outside autograd
  (gradients, metrics, parameters).

The model's tensor-parallel hooks read the active ``model`` axis from
:func:`tensor_parallel` (a context manager the dp x tp step enters); with
none active they are the identity.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.distributed as dist


@dataclasses.dataclass
class Axis:
    """One mesh axis as this rank sees it."""

    name: str
    ranks: list       # global ranks along the axis, in axis order
    index: int        # this rank's position on the axis
    group: object     # its process group; None when the axis has size 1
    pairs: list = None  # pair groups {i, i+1}, i = 0 .. size-2

    @property
    def size(self):
        return len(self.ranks)


def all_reduce_(t, axis):
    """Sum ``t`` over ``axis`` in place (no autograd)."""
    if axis is not None and axis.size > 1:
        dist.all_reduce(t, group=axis.group)
    return t


def broadcast_(t, axis, src_index=0):
    """``t`` of the rank at ``src_index`` of ``axis``, in place."""
    if axis is not None and axis.size > 1:
        dist.broadcast(t, src=axis.ranks[src_index], group=axis.group)
    return t


def all_reduce_tensors_(tensors, axis):
    """Sum every tensor of ``tensors`` over ``axis`` in place with one
    all_reduce per dtype (flattened into one buffer)."""
    if axis is None or axis.size == 1:
        return tensors
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat, group=axis.group)
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
    return tensors


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce_(x.clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.axis), None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        n = x.shape[-1]
        ctx.lo, ctx.n = axis.index * n, n
        full = x.new_zeros((*x.shape[:-1], n * axis.size))
        full[..., ctx.lo:ctx.lo + n] = x
        return all_reduce_(full, axis)

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.lo:ctx.lo + ctx.n], None


def _shift(x, axis, shift):
    """The hop behind :func:`ppermute`: the pairs walked in one order on
    every rank, even pairs then odd (each rank is in at most one pair per
    phase, so the walk cannot deadlock and takes two rounds)."""
    out = torch.zeros_like(x)
    n = axis.size
    for i in sorted(range(n - 1), key=lambda j: (j % 2, j)):
        if axis.index not in (i, i + 1):
            continue
        src = i if shift == 1 else i + 1
        if axis.index == src:
            dist.broadcast(x.contiguous(), src=axis.ranks[src],
                           group=axis.pairs[i])
        else:
            buf = torch.empty_like(x).contiguous()
            dist.broadcast(buf, src=axis.ranks[src], group=axis.pairs[i])
            out = buf
    return out


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, shift):
        ctx.axis, ctx.shift = axis, shift
        return _shift(x, axis, shift)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.axis, -ctx.shift), None, None


def psum(x, axis):
    """Sum over ``axis`` (all_reduce); identity backward."""
    if axis is None or axis.size == 1:
        return x
    return _Psum.apply(x, axis)


def copy_to(x, axis):
    """Identity forward, gradients summed over ``axis`` backward."""
    if axis is None or axis.size == 1:
        return x
    return _CopyTo.apply(x, axis)


def reduce_from(x, axis):
    """The partial sums of ``axis``'s ranks summed; identity backward."""
    return psum(x, axis)


def gather_from(x, axis):
    """``x``'s last dimension, split over ``axis`` in rank order, whole on
    every rank; the backward keeps this rank's slice."""
    if axis is None or axis.size == 1:
        return x
    return _GatherFrom.apply(x, axis)


def ppermute(x, axis, shift):
    """``shift=1``: rank i gets rank i-1's ``x`` (zeros at index 0);
    ``shift=-1``: rank i gets rank i+1's (zeros at the last index).  The
    JAX package's ``ppermute`` with ``[(i, i+1)]`` or ``[(i+1, i)]``."""
    if shift not in (1, -1):
        raise ValueError(f"ppermute shifts by 1 or -1, got {shift}")
    if axis is None or axis.size == 1:
        return torch.zeros_like(x)
    return _Ppermute.apply(x, axis, shift)


def gather_rows(row, axis):
    """[axis.size, *row.shape]: every rank's ``row`` (an all_reduce of a
    zero-filled stack)."""
    n = 1 if axis is None else axis.size
    index = 0 if axis is None else axis.index
    rows = row.new_zeros((n, *row.shape))
    rows[index] = row
    return all_reduce_(rows, axis)


_MODEL_AXIS = None


@contextlib.contextmanager
def tensor_parallel(axis):
    """Run the model's forward with its heads, FFN columns, embedding and
    vocabulary split over ``axis`` (the mesh's ``model`` axis)."""
    global _MODEL_AXIS
    previous, _MODEL_AXIS = _MODEL_AXIS, axis
    try:
        yield axis
    finally:
        _MODEL_AXIS = previous


def model_axis():
    """The active ``model`` axis of :func:`tensor_parallel`, or None."""
    if _MODEL_AXIS is None or _MODEL_AXIS.size == 1:
        return None
    return _MODEL_AXIS
