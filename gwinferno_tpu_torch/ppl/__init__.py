"""The probabilistic-programming layer, chain-batched.

Counterpart of ``gwinferno_tpu/ppl``: the ``sample``, ``deterministic``,
``factor`` and ``plate`` primitives, the effect handlers that interpret
them, the constraints and bijectors, and the potential energy the samplers
differentiate.  Where the JAX package gets a chain axis from ``vmap``, here
every substituted site value carries an explicit leading chain axis
``(C, *site_shape)`` and every density term reduces to ``(C,)``.
"""

from . import distributions
from .handlers import block
from .handlers import collect_deterministic
from .handlers import condition
from .handlers import deterministic_requested
from .handlers import seed
from .handlers import substitute
from .handlers import trace
from .infer_util import ModelPotential
from .infer_util import constrain_fn
from .infer_util import init_to_uniform
from .infer_util import log_density
from .infer_util import potential_energy
from .infer_util import transform_fn
from .infer_util import unconstrain_fn
from .primitives import deterministic
from .primitives import factor
from .primitives import plate
from .primitives import sample

__all__ = [
    "distributions",
    "sample",
    "deterministic",
    "factor",
    "plate",
    "trace",
    "seed",
    "substitute",
    "condition",
    "block",
    "collect_deterministic",
    "deterministic_requested",
    "ModelPotential",
    "log_density",
    "potential_energy",
    "unconstrain_fn",
    "constrain_fn",
    "transform_fn",
    "init_to_uniform",
]
