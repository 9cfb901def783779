"""Inference engine: chain-batched NUTS with warmup adaptation."""

from .mcmc import MCMC
from .nuts import NUTS

__all__ = ["MCMC", "NUTS"]
