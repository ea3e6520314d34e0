"""Meshes of ranks and the dp x tp sharding rules (the JAX package's
``parallel/mesh.py``).

A mesh lays the world's ranks (one process each, parallel/multihost.py)
out on named axes, as ``jax.sharding.Mesh`` lays out devices, with JAX's
axis names: ``("data", "model")`` here, ``("seq",)`` in
parallel/sequence.py and ``("data", "pipe")`` in parallel/pipeline.py.
Each axis is an :class:`~parallel.collectives.Axis` with its process group
(``mesh.get_group(name)``) and, for the axes that shift activations
(``seq``, ``pipe``), the two-rank pair groups of ``ppermute``.  The groups
are plain ``torch.distributed.new_group``s: every rank of the world makes
every group, in one order, so a mesh may also span a subset of the world
(``ranks=``); a rank outside it has ``mesh.member`` False.

The dp x tp layout of the flagship transformer is the JAX package's:
- batch rows split over ``data``;
- per-head attention projections ``w_qs/w_ks/w_vs [H, D, K]``: heads over
  ``model`` (each rank computes its local heads; the output projection's
  partial sums are summed over ``model``);
- attention output projection ``[H*dv, D]``: its input rows over
  ``model``;
- FFN ``w1 [D, inner]`` columns and ``w2 [inner, D]`` rows over ``model``;
- the embedding's ``d_model`` and the vocabulary projection's columns
  over ``model``;
- everything else (layer norms, biases, LDA, TDNN) replicated.
A dimension the axis does not divide stays replicated
(``_effective_spec``).  The forward on the local slices is the model's own,
with the collectives GSPMD inserts in JAX (models/transformer.py,
``tensor_parallel``); ``train/state.train_step(mesh=)`` sums the gradients
over ``data``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from pytorch_kaldi_asr_tpu_torch.parallel.collectives import Axis


class Mesh:
    """Ranks on named axes.  ``ranks`` (row-major over ``shape``) are
    global ranks of the world; ``shifted`` names the axes that get pair
    groups."""

    def __init__(self, axis_names, shape, ranks, shifted=()):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(n) for n in shape)))
        self.ranks = [int(r) for r in ranks]
        live = dist.is_initialized()
        me = dist.get_rank() if live else 0
        self.member = me in self.ranks
        self.axes = {}
        grid = np.asarray(self.ranks).reshape(tuple(shape))
        for a, name in enumerate(self.axis_names):
            for line in np.moveaxis(grid, a, -1).reshape(-1, grid.shape[a]):
                line = [int(r) for r in line]
                group = pairs = None
                if live and len(line) > 1:
                    group = dist.new_group(line)
                    if name in shifted:
                        pairs = [dist.new_group(line[i:i + 2])
                                 for i in range(len(line) - 1)]
                if me in line:
                    self.axes[name] = Axis(name, line, line.index(me), group,
                                           pairs)

    def axis(self, name):
        """This rank's :class:`Axis` called ``name`` (None off the mesh)."""
        return self.axes.get(name)

    def get_group(self, name):
        return self.axes[name].group

    def size(self, name):
        return self.shape.get(name, 1)

    def index(self, name):
        """This rank's position on axis ``name``."""
        return self.axes[name].index


def _world_ranks(ranks):
    if ranks is not None:
        return list(ranks)
    return list(range(dist.get_world_size() if dist.is_initialized() else 1))


def make_mesh(data=None, model=1, ranks=None):
    """A ('data', 'model') mesh over ``ranks`` (default: the world).
    ``data`` defaults to n_ranks / model."""
    ranks = _world_ranks(ranks)
    n = len(ranks)
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    return Mesh(("data", "model"), (data, model), ranks)


def batch_sharding(mesh):
    """The axis batch rows are split over: ``data``."""
    return mesh.axis("data")


def _keys(path):
    return [str(p) for p in path]


def param_sharding_rules(path, leaf):
    """The dimension of one parameter leaf split over ``model``, or None
    (replicated), keyed on its tree path (a tuple of dict keys and list
    indices): the JAX package's PartitionSpecs on the port's tree."""
    keys = _keys(path)
    name = "/".join(keys)
    ndim = getattr(leaf, "ndim", 0)
    if "w_qs" in keys or "w_ks" in keys or "w_vs" in keys:
        return 0  # heads
    if "proj" in keys and keys[-1] == "w":
        return 0  # contract the head-major input dim
    if "ffn" in name or "w1" in keys or "w2" in keys:
        if keys[-1] == "w" and ndim == 2:
            if "w1" in keys:
                return 1
            if "w2" in keys:
                return 0
    if "embed" in keys and ndim == 2:
        return 1  # shard d_model of the embedding
    if "word_proj" in keys and keys[-1] == "w":
        return 1  # vocab dim
    return None  # replicated


def _effective_spec(mesh, dim, leaf):
    """Replicate instead of sharding a dimension the ``model`` axis does
    not divide (e.g. an odd vocab size over a 2-way model axis)."""
    shape = tuple(getattr(leaf, "shape", ()))
    if dim is None:
        return None
    if dim >= len(shape) or shape[dim] % mesh.size("model") != 0:
        return None
    return dim


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def param_shardings(params, mesh):
    """The tree of split dimensions (or None) that :func:`shard_params`
    applies to the full ``params``."""
    return _map_with_path(
        lambda path, leaf: _effective_spec(
            mesh, param_sharding_rules(path, leaf), leaf), params)


def shard_params(params, mesh):
    """This rank's slice of every leaf of the full ``params`` (new
    tensors; replicated leaves copied whole)."""
    n, i = mesh.size("model"), (mesh.index("model") if mesh.size("model") > 1
                                else 0)

    def place(path, leaf):
        dim = _effective_spec(mesh, param_sharding_rules(path, leaf), leaf)
        if dim is None:
            return leaf.detach().clone()
        # a copy: a chunk along dim 0 is a view of ``leaf``'s storage, which
        # the optimizer would update in place
        return leaf.detach().chunk(n, dim=dim)[i].clone(
            memory_format=torch.contiguous_format)

    return _map_with_path(place, params)


def gather_params(params, specs, mesh):
    """The full parameters from every rank's slices (``specs`` from
    :func:`param_shardings`); detached, on every rank of the ``model``
    axis."""
    from pytorch_kaldi_asr_tpu_torch.parallel.collectives import gather_rows

    axis = mesh.axis("model")

    def gather(leaf, dim):
        leaf = leaf.detach()
        if dim is None:
            return leaf.clone()
        parts = gather_rows(leaf, axis)
        return torch.cat(list(parts), dim=dim)

    def walk(tree, spec):
        if isinstance(tree, dict):
            return {k: walk(v, spec[k]) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [walk(v, s) for v, s in zip(tree, spec)]
        return gather(tree, spec)

    return walk(params, specs)


def shard_batch_arrays(mesh, *arrays):
    """This rank's rows of each batch-major array: the batch split over
    ``data`` in rank order."""
    n = mesh.size("data")
    i = mesh.index("data") if n > 1 else 0
    out = []
    for a in arrays:
        if a.shape[0] % n != 0:
            raise ValueError(f"batch {a.shape[0]} not divisible by the "
                             f"'data' axis ({n})")
        rows = a.shape[0] // n
        out.append(a[i * rows:(i + 1) * rows])
    return tuple(out)
