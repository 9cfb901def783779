"""Process meshes on ``torch.distributed``: one process per card.

Counterpart of ``gwinferno_tpu/parallel/mesh.py``.  The JAX mesh is
single-controller: one process sees every device and XLA inserts the
collectives.  The port takes PyTorch's idiom instead: one process per card
(``torchrun --nproc-per-node=N``), each holding its own shard, with the
collectives written out (``parallel/sharding.py``).  A :class:`Mesh` lays the
ranks of the default process group out on the axes ``("chain", "data")``:
chains (or SMC particles) shard over ``chain``, the PE and injection banks
over ``data``.  Each rank knows its coordinates and holds one process
subgroup per axis, the ranks that differ from it along that axis only.

``MCMC`` and ``SMC`` enter their mesh with :func:`use_mesh` for a run; the
likelihood reads :func:`active_mesh` to combine its reductions over the data
group, so model code stays the same with and without a mesh.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Mesh", "create_mesh", "distributed_initialize", "mesh_layout", "use_mesh", "active_mesh"]


def distributed_initialize(coordinator_address=None, num_processes=None, process_id=None):
    """Join the default process group: NCCL when CUDA is available, gloo
    otherwise.

    ``coordinator_address`` is an init method (``tcp://host:port``,
    ``file:///path``) or ``host:port``; without it the group is read from the
    environment that ``torchrun`` sets (``env://``).  A no-op when a group is
    already up, or when there is nothing to join (no arguments and no
    ``WORLD_SIZE``).  Unlike the JAX function, a failed join raises.  With
    NCCL the process takes the card ``LOCAL_RANK`` (else its rank modulo the
    cards it sees)."""
    if dist.is_initialized():
        return
    if coordinator_address is None and num_processes is None and "WORLD_SIZE" not in os.environ:
        return
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = int(num_processes)
    if process_id is not None:
        kwargs["rank"] = int(process_id)
    if backend == "nccl":
        rank = int(process_id) if process_id is not None else int(os.environ.get("RANK", 0))
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count())))
    dist.init_process_group(backend, init_method=init_method, **kwargs)


def mesh_layout(n, chain_axis_size=None):
    """``(chain, data)`` sizes of a mesh of ``n`` ranks: ``chain_axis_size``,
    else the JAX package's default, the largest power of two that divides
    ``n`` and keeps both axes nontrivial (1 when ``n`` is 1)."""
    if chain_axis_size is None:
        chain_axis_size = 1
        while chain_axis_size * 2 <= n and n % (chain_axis_size * 2) == 0 and chain_axis_size * chain_axis_size < n:
            chain_axis_size *= 2
    if chain_axis_size < 1 or n % chain_axis_size:
        raise ValueError(f"chain_axis_size={chain_axis_size} does not divide {n} ranks")
    return chain_axis_size, n // chain_axis_size


class Mesh:
    """Ranks laid out ``(chain, data)``.

    ``devices``: the ``(chain, data)`` array of ranks; ``shape``: ``{axis:
    size}``; ``axis_names``; ``rank``: this process's rank; ``coords``:
    ``{axis: this rank's index}``.  :meth:`group` is this rank's subgroup
    along an axis (None without a process group: a one-rank mesh).
    """

    def __init__(self, devices, axis_names, rank, groups):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))
        self.rank = rank
        where = np.argwhere(devices == rank)
        if len(where) != 1:
            raise ValueError(f"rank {rank} is not in the mesh {devices.tolist()}")
        self.coords = dict(zip(self.axis_names, (int(i) for i in where[0])))
        self._groups = groups

    def group(self, axis):
        return self._groups.get(axis)

    def rows(self, axis, n):
        """This rank's block of ``n`` rows sharded over ``axis``."""
        size = self.shape[axis]
        if n % size:
            raise ValueError(f"{n} rows do not shard over the {size} ranks of axis {axis!r}")
        b = n // size
        i = self.coords[axis]
        return slice(i * b, (i + 1) * b)

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank}, coords={self.coords})"


def create_mesh(n_devices=None, chain_axis_size=None, axis_names=("chain", "data"), devices=None):
    """A 2-D ``(chain, data)`` mesh over ``devices`` (ranks; default all
    ranks of the default process group), or the first ``n_devices`` of them.

    Without a process group the mesh is this one process (``n_devices`` 1).
    Every rank of the default group must call this, in the same order as any
    other ``create_mesh``: it creates one subgroup per axis line
    (``dist.new_group``), which is collective."""
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
    else:
        world, rank = 1, 0
    ranks = list(range(world)) if devices is None else [int(d) for d in devices]
    if n_devices is not None:
        if n_devices > len(ranks):
            raise ValueError(f"create_mesh({n_devices}) with {len(ranks)} ranks; run one process per card "
                             "(torchrun --nproc-per-node=N) and call distributed_initialize() first")
        ranks = ranks[:n_devices]
    c, d = mesh_layout(len(ranks), chain_axis_size)
    arr = np.asarray(ranks).reshape(c, d)
    groups = {}
    if dist.is_initialized():
        lines = {axis_names[0]: [arr[:, j] for j in range(d)], axis_names[1]: [arr[i, :] for i in range(c)]}
        for axis, members in lines.items():
            for m in members:
                g = dist.new_group([int(r) for r in m])
                if rank in m:
                    groups[axis] = g
    return Mesh(arr, axis_names, rank, groups)


_ACTIVE = []  # the mesh of the run in progress (a stack: runs nest)


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the active mesh for the block (None: no mesh)."""
    _ACTIVE.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.pop()


def active_mesh():
    """The innermost mesh entered with :func:`use_mesh`, or None."""
    return _ACTIVE[-1] if _ACTIVE else None
