"""Hierarchical population likelihood with selection-effect correction.

Counterpart of ``gwinferno_tpu/pipeline/analysis.py`` on the log path (the
weights are log-weights throughout, so float32 never squares a linear
weight).  Every function takes a leading batch (chain) axis: PE log-weights
``(..., N_events, N_samples)``, injection log-weights ``(..., N_found)``.
Both reductions go through K1 (:func:`gwinferno_tpu_torch.ops.fused.double_logsumexp`).
"""

from __future__ import annotations

import math

import torch

from .. import ppl
from ..ops.fused import double_logsumexp
from ..ppl import distributions as dist

__all__ = ["per_event_log_bayes_factors", "detection_efficiency", "hierarchical_likelihood"]


def per_event_log_bayes_factors(log_weights):
    """Per-event log Bayes factors by importance sampling over the PE banks.

    Returns ``(logBFs, log_n_effs, variances)``, each ``(..., N_events)``.
    """
    n_samples = log_weights.shape[-1]
    lse1, lse2 = double_logsumexp(log_weights)
    logn_effs = 2.0 * lse1 - lse2
    logBFs = lse1 - math.log(n_samples)
    variances = torch.exp(-logn_effs) - 1.0 / n_samples
    return logBFs, logn_effs, variances


def detection_efficiency(log_weights, Ninj):
    """Detection efficiency mu by importance sampling over the found
    injections (``Ninj`` generated), with its MC effective sample size.

    The estimator's variance ``sum(w^2)/Ninj^2 - mu^2/Ninj`` is evaluated in
    shifted log space.  Returns ``(log_mu, log_n_eff, variance)``, each of the
    batch shape.
    """
    log_ninj = math.log(Ninj)
    lse1, lse2 = double_logsumexp(log_weights)
    logmu = lse1 - log_ninj
    # var = e^A - e^B with A = log(sum w^2 / Ninj^2), B = log(mu^2 / Ninj);
    # B - A = log(n_eff_raw / Ninj) < 0 since n_eff_raw <= N_found < Ninj
    A = lse2 - 2.0 * log_ninj
    B = 2.0 * logmu - log_ninj
    logvar = A + torch.log1p(-torch.exp(torch.clamp_max(B - A, -1e-6)))
    logn_eff = 2.0 * logmu - logvar
    variance = torch.exp(-logn_eff) - 1.0 / Ninj
    return logmu, logn_eff, variance


def hierarchical_likelihood(
    pe_weights,
    inj_weights,
    total_inj,
    Nobs,
    Tobs,
    surveyed_hypervolume=None,
    reconstruct_rate=True,
    marginalize_selection=False,
    min_neff_cut=True,
    max_variance_cut=False,
    categorical=False,
    posterior_predictive_check=False,
    param_names=None,
    pedata=None,
    injdata=None,
    m2min=3.0,
    m1min=5.0,
    mmax=100.0,
    log=True,
    pe_summaries=None,
    inj_summaries=None,
):
    """Importance-sampled hierarchical likelihood with rate reconstruction,
    the ``min_neff`` / ``max_variance`` walls and the deterministic
    diagnostic sites, added to the model as the ``log_likelihood`` factor.

    ``pe_weights`` ``(C, N_events, N_samples)`` and ``inj_weights``
    ``(C, N_found)`` are log-weights.  Returns the reconstructed ``rate``
    ``(C,)`` or None.

    Summaries seam: ``pe_summaries=(logBFs, log_n_effs, n_samples)`` and
    ``inj_summaries=(log_mu, log_n_eff_inj)`` take reductions computed
    upstream (the streamed op, ``ops/streamed.py``, or K3 through
    ``FusedBSplineLikelihood``) in place of the weight banks, which may then
    be None.  Categorical subpopulations and the posterior-predictive draws
    are not ported; they raise.  ``param_names``, ``pedata``, ``injdata``,
    ``m1min``, ``m2min`` and ``mmax`` feed only the posterior-predictive
    draws and are unused.  The port has the log path only, so ``log``
    defaults to True; ``log=False`` (linear weight banks, the JAX package's
    default) raises.
    """
    if max_variance_cut and (marginalize_selection or min_neff_cut):
        raise ValueError(
            "max_variance_cut is True which requires marginalize_selection and "
            "min_neff_cut to be False but got "
            f"marginalize_selection = {marginalize_selection} "
            f"and min_neff_cut = {min_neff_cut}",
        )
    if pe_summaries is not None and categorical:
        raise ValueError("pe_summaries (the fused seam) cannot be combined with categorical subpopulations")
    if (pe_summaries is not None or inj_summaries is not None) and posterior_predictive_check:
        raise ValueError("posterior_predictive_check needs the raw weight banks; disable it on the fused path")
    if categorical or posterior_predictive_check:
        raise NotImplementedError("categorical subpopulations and posterior-predictive draws are not ported")
    if not log and (pe_summaries is None or inj_summaries is None):
        raise NotImplementedError("the linear-weight path (log=False) is not ported; pass log-weights with log=True")

    if pe_summaries is not None:
        logBFs, logn_effs, n_samples = pe_summaries
        variances = torch.exp(-logn_effs) - 1.0 / n_samples
    else:
        logBFs, logn_effs, variances = per_event_log_bayes_factors(pe_weights)
    if inj_summaries is not None:
        log_det_eff, logn_eff_inj = inj_summaries
        variance = torch.exp(-logn_eff_inj) - 1.0 / total_inj
    else:
        log_det_eff, logn_eff_inj, variance = detection_efficiency(inj_weights, total_inj)
    floor = torch.finfo(logBFs.dtype).min  # jnp.nan_to_num(-inf)
    ppl.deterministic("log_nEff_inj", logn_eff_inj)
    ppl.deterministic("log_nEffs", logn_effs)
    ppl.deterministic("logBFs", logBFs)
    ppl.deterministic("detection_efficiency", torch.exp(log_det_eff))
    ppl.deterministic("variance_log_BFs", variances)
    ppl.deterministic("variance_log_detection_efficiency", variance)

    rate = None
    if reconstruct_rate:
        total_vt = ppl.deterministic("surveyed_hypervolume", surveyed_hypervolume / 1.0e9 * Tobs)
        unscaled_rate = ppl.sample("unscaled_rate", dist.Gamma(Nobs * 1.0))
        rate = ppl.deterministic("rate", unscaled_rate / torch.exp(log_det_eff) / total_vt)
    if marginalize_selection:
        log_det_eff = log_det_eff - (3.0 + Nobs) / (2.0 * torch.exp(logn_eff_inj))
    if min_neff_cut:
        log_det_eff = torch.where(logn_eff_inj >= math.log(4.0 * Nobs), log_det_eff, torch.inf)
    sel = ppl.deterministic(
        "selection_factor", torch.where(torch.isinf(log_det_eff), floor, -Nobs * log_det_eff)
    )
    sumlogBFs = ppl.deterministic("sum_logBFs", logBFs.sum(-1))
    log_l = sel + sumlogBFs
    log_l = ppl.deterministic("log_l", torch.where(torch.isnan(log_l), floor, torch.nan_to_num(log_l)))

    if min_neff_cut:
        min_n_effs = torch.exp(torch.nan_to_num(logn_effs).amin(-1))
        log_l = ppl.deterministic("neff_less_Nobs", torch.where(min_n_effs <= Nobs, floor, log_l))

    variance = ppl.deterministic("variance_log_likelihood", Nobs**2 * variance + variances.sum(-1))
    if max_variance_cut:
        log_l = ppl.deterministic("variance_less_1", torch.where(variance <= 1.0, log_l, floor))

    ppl.factor("log_likelihood", log_l)
    return rate
