"""Inference engines over a batched chain axis: NUTS and HMC under the MCMC
engine, SVI (AutoDelta, AutoNormal, ``find_map``) and SMC."""

from .hmc import HMC
from .mcmc import MCMC
from .nuts import NUTS
from .smc import SMC
from .svi import SVI
from .svi import Adam
from .svi import AutoDelta
from .svi import AutoNormal
from .svi import Trace_ELBO
from .svi import find_map

__all__ = ["NUTS", "HMC", "MCMC", "SVI", "Adam", "AutoDelta", "AutoNormal", "Trace_ELBO", "find_map", "SMC"]
