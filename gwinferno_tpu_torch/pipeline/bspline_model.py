"""The B-spline production model and its analysis runner.

Counterpart of ``examples/simple_bspline_example.py::model`` and
``examples/utils.py::run_bspline_analysis``: B-spline primary mass (log-log)
and mass ratio, IID B-spline spin magnitudes and tilts, a powerlaw times
exp(B-spline) redshift model, smoothing priors on every coefficient block
(centered or whitened), and the hierarchical likelihood with the ``min_neff``
cut.

Two routes, one model:
- unfused (``fused=False``, the default): each factor's pdf is projected from
  its cached design matrix, the log-weights ``(C, E, S)`` and ``(C, N)`` are
  summed per factor in log space, and the likelihood reduces them with K1;
- fused (``fused=True``): the log-weights are affine in the stacked
  coefficients, so :class:`FusedBSplineLikelihood` reduces both banks with K3
  and hands the summaries to the likelihood's seam.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import ppl
from ..distributions import safe_log
from ..infer import MCMC
from ..infer import NUTS
from ..models.bsplines.fused_path import FusedBSplineLikelihood
from ..ppl import distributions as dist
from .analysis import hierarchical_likelihood
from .utils import bspline_mass_prior
from .utils import bspline_redshift_prior
from .utils import bspline_spin_prior
from .utils import setup_bspline_mass_models
from .utils import setup_bspline_spin_models
from .utils import setup_powerlaw_spline_redshift_model

__all__ = ["BSplineModel", "run_bspline_analysis", "build_bspline_models", "model_from_args", "bank_log_weights",
           "COEF_SITES"]

# the coefficient blocks, which are deterministic sites under reparam="whitened"
COEF_SITES = ("mass_cs", "q_cs", "a_cs", "tilt_cs", "z_cs", "a1_cs", "a2_cs", "tilt1_cs", "tilt2_cs")


def bank_log_weights(factors, log_prior):
    """Per-sample log-weights of one bank: the factors' pdfs summed in log
    space over the bank's sampling prior, NaN (an empty support) to -inf."""
    logw = sum(safe_log(f) for f in factors) - log_prior
    return torch.where(torch.isnan(logw), -torch.inf, logw)


class BSplineModel(torch.nn.Module):
    """The B-spline example model as a PPL model: calling it declares the
    coefficient sites, ``lamb``, the rate and the likelihood factor, every
    site with a leading chain axis.

    ``mass_models``, ``mag_model``, ``tilt_model`` and ``z_model`` come from
    the ``setup_*`` helpers of :mod:`gwinferno_tpu_torch.pipeline.utils`; the
    model runs on their device in their dtype.  ``fused=True`` builds a
    :class:`FusedBSplineLikelihood` (the K3 route).
    """

    def __init__(self, pedict, injdict, constants, mass_models, mag_model, tilt_model, z_model, mmin, mmax,
                 param_names=None, fused=False, reparam="centered", m_tau=1, q_tau=1, a_tau=25, ct_tau=25, z_tau=1):
        super().__init__()
        self.mass_models, self.mag_model, self.tilt_model, self.z_model = mass_models, mag_model, tilt_model, z_model
        self.Nobs, self.Tobs = constants["nObs"], constants["obs_time"]
        self.Ninj = float(constants["total_inj"])
        self.mmin, self.mmax, self.param_names = mmin, mmax, param_names
        self.reparam = reparam
        self.taus = dict(m_tau=m_tau, q_tau=q_tau, a_tau=a_tau, ct_tau=ct_tau, z_tau=z_tau)
        ref = mass_models.primary_model.pe_design_matrix
        dev, dtype = ref.device, ref.dtype
        for prefix, d in (("pe", pedict), ("inj", injdict)):
            self.register_buffer(f"{prefix}_redshift", torch.as_tensor(np.asarray(d["redshift"]), dtype=dtype, device=dev))
            self.register_buffer(
                f"{prefix}_log_prior", torch.as_tensor(np.log(np.asarray(d["prior"], dtype=np.float64)), dtype=dtype, device=dev)
            )
        self.fused_lik = (
            FusedBSplineLikelihood(mass_models, mag_model, tilt_model, z_model, pedict, injdict, self.Ninj)
            if fused else None
        )

    def log_weights(self, mass_cs, q_cs, a_cs, tilt_cs, z_cs, lamb, pe_samples=True):
        """The unfused route's per-sample log-weights, summed per factor in
        log space: ``(C, E, S)`` for the PE bank, ``(C, N)`` for the
        injections."""
        z = self.pe_redshift if pe_samples else self.inj_redshift
        log_prior = self.pe_log_prior if pe_samples else self.inj_log_prior
        factors = (self.mass_models(mass_cs, q_cs, pe_samples=pe_samples), self.mag_model(a_cs, pe_samples=pe_samples),
                   self.tilt_model(tilt_cs, pe_samples=pe_samples), self.z_model(z, lamb, z_cs))
        return bank_log_weights(factors, log_prior)

    def forward(self):
        t = self.taus
        n_m = self.mass_models.primary_model.n_splines
        n_q = self.mass_models.ratio_model.n_splines
        n_a = self.mag_model.primary_model.n_splines
        n_ct = self.tilt_model.primary_model.n_splines
        n_z = self.z_model.n_splines

        mass_cs, q_cs = bspline_mass_prior(m_nsplines=n_m, q_nsplines=n_q, m_tau=t["m_tau"], q_tau=t["q_tau"],
                                           reparam=self.reparam)
        a_cs, tilt_cs = bspline_spin_prior(a_nsplines=n_a, ct_nsplines=n_ct, a_tau=t["a_tau"], ct_tau=t["ct_tau"],
                                           IID=True, reparam=self.reparam)
        z_cs = bspline_redshift_prior(z_nsplines=n_z, z_tau=t["z_tau"], reparam=self.reparam)
        lamb = ppl.sample("lamb", dist.Normal(0, 3))

        if self.fused_lik is not None:
            logBFs, log_n_effs, log_mu, log_n_eff_inj = self.fused_lik(mass_cs, q_cs, a_cs, tilt_cs, z_cs, lamb)
            hierarchical_likelihood(
                None,
                None,
                self.Ninj,
                self.Nobs,
                self.Tobs,
                surveyed_hypervolume=self.z_model.normalization(lamb, z_cs),
                log=True,
                pe_summaries=(logBFs, log_n_effs, self.fused_lik.n_samples),
                inj_summaries=(log_mu, log_n_eff_inj),
            )
            return

        hierarchical_likelihood(
            self.log_weights(mass_cs, q_cs, a_cs, tilt_cs, z_cs, lamb, pe_samples=True),
            self.log_weights(mass_cs, q_cs, a_cs, tilt_cs, z_cs, lamb, pe_samples=False),
            self.Ninj,
            self.Nobs,
            self.Tobs,
            surveyed_hypervolume=self.z_model.normalization(lamb, z_cs),
            param_names=self.param_names,
            m2min=self.mmin,
            m1min=self.mmin,
            mmax=self.mmax,
            log=True,
        )


def build_bspline_models(pedict, injdict, args, device=None, dtype=torch.float32):
    """The mass, spin and redshift B-spline models at ``args``' knot counts
    and mass range: ``{"mass", "mag", "tilt", "z"}``."""
    mass_model = setup_bspline_mass_models(
        pedict, injdict, args.m_nsplines, args.q_nsplines, args.mmin, args.mmax, device=device, dtype=dtype
    )
    mag_model, tilt_model = setup_bspline_spin_models(
        pedict, injdict, args.a_nsplines, args.tilt_nsplines, iid=True, device=device, dtype=dtype
    )
    z_model = setup_powerlaw_spline_redshift_model(pedict, injdict, args.z_nsplines, device=device, dtype=dtype)
    return {"mass": mass_model, "mag": mag_model, "tilt": tilt_model, "z": z_model}


def model_from_args(pedict, injdict, constants, param_names, models, args):
    """A :class:`BSplineModel` on ``models`` with ``args``' route, prior
    parameterization and smoothing scales (the defaults of the example)."""
    return BSplineModel(
        pedict, injdict, constants, models["mass"], models["mag"], models["tilt"], models["z"], args.mmin, args.mmax,
        param_names=param_names,
        fused=getattr(args, "fused", False),
        reparam=getattr(args, "reparam", "centered"),
        m_tau=getattr(args, "m_tau", 1), q_tau=getattr(args, "q_tau", 1),
        a_tau=getattr(args, "a_tau", 25), ct_tau=getattr(args, "ct_tau", 25),
        z_tau=getattr(args, "z_tau", 1),
    )


def run_bspline_analysis(pedict, injdict, constants, param_names, args, skip_inference=False, device=None,
                         dtype=torch.float32):
    """Build the B-spline models, run NUTS on :class:`BSplineModel` with a
    progress bar on stderr, print the run's summary and return
    ``(posterior, models, mcmc)``.

    ``args`` carries the example's settings: ``m_nsplines``, ``q_nsplines``,
    ``a_nsplines``, ``tilt_nsplines``, ``z_nsplines``, ``mmin``, ``mmax``,
    ``warmup``, ``samples``, ``chains``, ``thinning``, ``rngkey`` and, with
    the example's defaults, ``fused``, ``reparam``, the ``*_tau`` scales,
    ``target_accept`` (0.8), ``max_tree_depth`` (10), ``max_steps_per_call``
    (None) and ``chain_scheduler`` ("auto").  The posterior holds
    every sample site and the deterministic rate, surveyed hypervolume,
    detection efficiency and coefficient blocks.  With ``skip_inference``
    only the models are built and returned.
    """
    models = build_bspline_models(pedict, injdict, args, device=device, dtype=dtype)
    if skip_inference:
        return models
    model = model_from_args(pedict, injdict, constants, param_names, models, args)
    mcmc = MCMC(
        NUTS(
            model,
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
        device=device,
        dtype=dtype,
    )
    mcmc.run(args.rngkey)
    mcmc.print_summary()
    posterior = dict(mcmc.get_samples())
    posterior.update(mcmc.get_deterministic(site_names={"rate", "surveyed_hypervolume", "detection_efficiency", *COEF_SITES}))
    return posterior, models, mcmc
