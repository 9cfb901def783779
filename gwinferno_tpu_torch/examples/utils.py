"""The examples' harness: the result directory and the analysis runners.

Counterpart of ``examples/utils.py``.  The JAX key ``PRNGKey(args.rngkey)``
becomes the seed that the port's ``MCMC.run`` takes; the runners put the
catalog on ``device`` (CUDA unless asked otherwise) in ``dtype`` once.  The
B-spline runner is :func:`~gwinferno_tpu_torch.pipeline.bspline_model.
run_bspline_analysis`, named here as the JAX examples name theirs; both
runners show a progress bar, print the run's summary and return the run
third.
"""

from __future__ import annotations

import os

import torch

from ..device import resolve_device
from ..infer import MCMC
from ..infer import NUTS
from ..models.parametric.parametric import PowerlawRedshiftModel
from ..pipeline.bspline_model import run_bspline_analysis
from ..pipeline.utils import to_tensors

__all__ = ["setup_result_dir", "run_powerlawpeak_analysis", "run_bspline_analysis", "add_device_arguments"]


def add_device_arguments(parser):
    """The port's two options beside the JAX package's parser: ``--device``
    (CUDA unless ``cpu`` is named) and ``--dtype``."""
    parser.add_argument("--device", type=str, default="cuda", help="cuda (the default) or cpu")
    parser.add_argument("--dtype", choices=("float32", "float64"), default="float32")
    return parser


def setup_result_dir(args, default_label="run"):
    """``(label, result_dir)`` from ``--run-label`` and ``--result-dir``
    (``results/<label>`` by default); the directory is made."""
    label = args.run_label or default_label
    result_dir = args.result_dir or f"results/{label}"
    os.makedirs(result_dir, exist_ok=True)
    return label, result_dir


def run_powerlawpeak_analysis(model, pedict, injdict, constants, param_names, args, skip_inference=False,
                              device=None, dtype=torch.float32, init_params=None):
    """Build the redshift model, run NUTS on the powerlaw+peak ``model`` and
    return ``(posterior, z_model, mcmc)``, as :func:`run_bspline_analysis`
    returns ``(posterior, models, mcmc)``.

    ``model(pedict, injdict, Nobs, Tobs, Ninj, z_model, mmin, mmax,
    param_names)`` takes the banks as tensors; ``pedict`` ``{param: (E,
    S)}`` and ``injdict`` ``{param: (N,)}`` (host numpy) are put on
    ``device`` in ``dtype`` once.  ``args`` carries ``mmin``, ``mmax``,
    ``warmup``, ``samples``, ``chains``, ``thinning``, ``rngkey`` and, with
    the JAX example's defaults, ``target_accept`` (0.8), ``max_tree_depth``
    (10), ``max_steps_per_call`` and ``chain_scheduler`` ("auto").  The
    posterior holds every sample site and the deterministic rate, surveyed
    hypervolume and detection efficiency.  ``init_params`` (``{site: (C,)}``)
    starts the chains there (``MCMC.run``'s own argument); with
    ``skip_inference`` only the redshift model is built and returned."""
    dev = resolve_device(device)
    z_model = PowerlawRedshiftModel(z_pe=pedict["redshift"], z_inj=injdict["redshift"], device=dev, dtype=dtype)
    if skip_inference:
        return z_model
    pe, inj = to_tensors(pedict, dev, dtype), to_tensors(injdict, dev, dtype)

    def bound_model():
        model(pe, inj, constants["nObs"], constants["obs_time"], constants["total_inj"], z_model, args.mmin,
              args.mmax, param_names)

    mcmc = MCMC(
        NUTS(
            bound_model,
            target_accept_prob=getattr(args, "target_accept", 0.8),
            max_tree_depth=getattr(args, "max_tree_depth", 10),
        ),
        num_warmup=args.warmup,
        num_samples=args.samples,
        num_chains=args.chains,
        thinning=args.thinning,
        progress_bar=True,
        max_steps_per_call=getattr(args, "max_steps_per_call", None),
        chain_scheduler=getattr(args, "chain_scheduler", "auto"),
        device=dev,
        dtype=dtype,
    )
    mcmc.run(args.rngkey, init_params=init_params)
    mcmc.print_summary()
    posterior = dict(mcmc.get_samples())
    posterior.update(mcmc.get_deterministic(site_names={"rate", "surveyed_hypervolume", "detection_efficiency"}))
    return posterior, z_model, mcmc

