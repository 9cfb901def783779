"""The parallel layer on ``torch.distributed``: process meshes (one process
per card) and the sharding of chains, particles and data banks over them."""

from .mesh import Mesh
from .mesh import active_mesh
from .mesh import create_mesh
from .mesh import distributed_initialize
from .mesh import mesh_layout
from .mesh import use_mesh
from .sharding import gather_chains
from .sharding import shard_catalog
from .sharding import shard_chain_state
from .sharding import shard_data_dict
from .sharding import sharded_logsumexp

__all__ = [
    "Mesh",
    "active_mesh",
    "create_mesh",
    "distributed_initialize",
    "gather_chains",
    "mesh_layout",
    "shard_catalog",
    "shard_chain_state",
    "shard_data_dict",
    "sharded_logsumexp",
    "use_mesh",
]
