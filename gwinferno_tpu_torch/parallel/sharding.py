"""Sharding on a :class:`~gwinferno_tpu_torch.parallel.mesh.Mesh`: this
rank's block of chain states and data banks, and the collectives that join
the blocks.

Counterpart of ``gwinferno_tpu/parallel/sharding.py``.  Where the JAX
package places global arrays with a ``NamedSharding`` and lets XLA insert
the collectives, each rank here holds its own block and the collectives are
explicit.

Every collective that feeds a value the ranks must agree on is an all-gather
followed by a reduction in rank order (:func:`sum_over`, :func:`max_over`,
:func:`merge_over`), so every rank of a group computes the same bits: the
ranks of a data group step the same chains and must take the same NUTS
decisions.  The gathers are differentiable by the data-parallel rule: the
backward of :func:`all_gather` hands each rank the sum of every rank's
cotangent for its own block.  A potential computed the same way on every
rank of a data group is therefore differentiated with its backward seeded
by ``1 / W`` and the gradient summed over the group
(``ModelPotential.value_and_grad``): each rank's shard contributes its own
part once, and the replicated terms (priors, the likelihood's tail) once in
all.
"""

from __future__ import annotations

import copy

import torch
import torch.distributed as dist

from ..ops.fused import merge_pairs
from .mesh import active_mesh

__all__ = [
    "shard_chain_state",
    "shard_data_dict",
    "shard_catalog",
    "sharded_logsumexp",
    "gather_chains",
    "all_gather",
    "sum_over",
    "max_over",
    "min_over",
    "merge_over",
    "data_group",
    "group_size",
]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def shard_chain_state(mesh, state, chain_axis="chain"):
    """This rank's block of the leading (chain) axis of every array in
    ``state`` (a dict, tuple or NamedTuple of arrays, nested)."""
    return _map(lambda x: x[mesh.rows(chain_axis, x.shape[0])], state)


def shard_data_dict(mesh, data, data_axis="data", axis=0):
    """This rank's slice of dimension ``axis`` of each array of ``data``.

    The JAX function leaves an array whose length the data axis does not
    divide whole (replicated); there the array is global and XLA reduces it
    once.  Here each rank reduces what it holds and the likelihood merges
    the ranks' reductions (``pipeline/analysis.py``), so an array left whole
    on every rank would be counted once a rank.  Under a data axis of more
    than one rank, an array (of rank 1 or more) whose dimension ``axis``
    does not divide over the axis, or that has no such dimension, raises;
    scalars stay whole.  PE banks ``(events, samples)`` split along their
    samples with ``axis=1``, or along their events with ``axis=0`` when the
    events divide."""
    size = mesh.shape[data_axis]

    def place(name, x):
        if size == 1 or x.ndim == 0:
            return x
        if x.ndim <= axis or x.shape[axis] % size:
            raise ValueError(
                f"shard_data_dict: {name!r} of shape {tuple(x.shape)} does not split along axis {axis} over the "
                f"{size} ranks of the {data_axis!r} axis; each rank would reduce the whole array and the "
                "likelihood would count it once a rank (PE banks (events, samples): axis=1 splits the samples)"
            )
        index = (slice(None),) * axis + (mesh.rows(data_axis, x.shape[axis]),)
        return x[index]

    return {k: place(k, v) for k, v in data.items()}


def shard_catalog(mesh, pedict, injdict, z_model, data_axis="data"):
    """This rank's shard of a catalog over the mesh's data axis, for the
    bench model (``pipeline/bench_model.py``): the PE banks along their
    sample axis, the injections along theirs (both must divide), and a copy
    of the redshift model ``z_model`` (a ``PowerlawRedshiftModel`` of the
    whole catalog: its grid, bounds and normalization) whose dVc/dz columns
    ``dVdzs`` hold this rank's samples.  Returns ``(pedict, injdict,
    z_model)``."""
    pe = shard_data_dict(mesh, dict(pedict, dVdz=z_model.dVdzs[1]), data_axis, axis=1)
    inj = shard_data_dict(mesh, dict(injdict, dVdz=z_model.dVdzs[0]), data_axis)
    zm = copy.copy(z_model)
    zm.dVdzs = [inj.pop("dVdz"), pe.pop("dVdz")]
    return pe, inj, zm


def group_size(group):
    return 1 if group is None else dist.get_world_size(group)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(out, x, group=group)
        return torch.stack(out)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g[dist.get_rank(ctx.group)], None


def all_gather(x, group):
    """Every rank's ``x`` stacked in rank order, ``(W, *x.shape)``;
    differentiable (each rank's block gets the sum of all ranks'
    cotangents).  ``group`` None: no process group, ``x[None]``."""
    if group is None:
        return x.unsqueeze(0)
    return _AllGather.apply(x, group)


def sum_over(x, group):
    """The all-reduce SUM of ``x``, summed in rank order on every rank."""
    return x if group is None else all_gather(x, group).sum(0)


def max_over(x, group):
    """The all-reduce MAX of ``x`` (no gradient)."""
    return x if group is None else all_gather(x.detach(), group).amax(0)


def min_over(x, group):
    """The all-reduce MIN of ``x`` (no gradient)."""
    return x if group is None else all_gather(x.detach(), group).amin(0)


def merge_over(l1, l2, group):
    """Each rank's ``(logsumexp(x), logsumexp(2x))`` pair of its shard of a
    row merged into the row's pair, in rank order, as chunks are merged
    (``ops/fused.py::merge_pairs``)."""
    if group is None:
        return l1, l2
    g = all_gather(torch.stack([l1, l2]), group)
    return merge_pairs([(p[0], p[1]) for p in g.unbind(0)])


def data_group():
    """The active mesh's ``data`` subgroup (``parallel.mesh.use_mesh``), or
    None outside a mesh or without a process group."""
    mesh = active_mesh()
    return None if mesh is None else mesh.group("data")


def sharded_logsumexp(x, axis_name_or_group, axis=-1):
    """logsumexp over an axis sharded over a group (an axis name of the
    active mesh, or a process group): a local max, an all-reduce MAX, a
    local sum of exponentials, an all-reduce SUM.  Differentiable."""
    group = axis_name_or_group
    if isinstance(group, str):
        mesh = active_mesh()
        if mesh is None:
            raise ValueError(f"sharded_logsumexp over axis {group!r} needs an active mesh (parallel.use_mesh)")
        group = mesh.group(group)
    m = max_over(x.detach().amax(dim=axis), group)
    m = torch.where(torch.isfinite(m), m, 0.0)
    s = sum_over(torch.exp(x - m.unsqueeze(axis)).sum(dim=axis), group)
    return m + torch.log(s)


def gather_chains(mesh, x, chain_axis="chain", dim=0):
    """Every rank's block of the chain axis ``dim`` of ``x`` (an array or a
    dict, tuple or NamedTuple of arrays), concatenated in rank order: all
    chains, on every rank."""
    group = mesh.group(chain_axis)
    if group is None:
        return x

    def gather(t):
        with torch.no_grad():
            return torch.cat(all_gather(t, group).unbind(0), dim=dim)

    return _map(gather, x)
