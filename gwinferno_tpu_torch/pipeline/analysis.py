"""Hierarchical population likelihood with selection-effect correction, and
the config-driven hierarchical model.

Counterpart of ``gwinferno_tpu/pipeline/analysis.py``.  The functions keep
the JAX package's signatures and defaults: ``log=False`` takes linear
weights and reduces them with plain sums, as the JAX package does;
``log=True`` takes log-weights and reduces both banks with K1
(:func:`gwinferno_tpu_torch.ops.fused.double_logsumexp`), so float32 never
squares a linear weight.  Every function takes a leading batch (chain)
axis: PE weights ``(..., N_events, N_samples)``, injection weights ``(...,
N_found)``.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .. import ppl
from ..cosmology import PLANCK_2015_LVK_Cosmology
from ..infer import HMC
from ..infer import NUTS
from ..infer import find_map  # re-exported, as the JAX package's analysis module does
from ..ops.fused import double_logsumexp
from ..population_distributions import PowerlawRedshift
from ..population_distributions import interp
from ..ppl import distributions as dist
from .parser import PopMixtureModel
from .parser import PopModel
from .parser import PopPrior

__all__ = [
    "NP_KERNEL_MAP",
    "find_map",
    "per_event_log_bayes_factors",
    "detection_efficiency",
    "hierarchical_likelihood",
    "construct_hierarchical_model",
]


NP_KERNEL_MAP = {"NUTS": NUTS, "HMC": HMC}


def per_event_log_bayes_factors(weights, log=False):
    """Per-event log Bayes factors by importance sampling over the PE banks
    ``weights`` (log-weights with ``log=True``, reduced by K1; linear
    weights otherwise, reduced by plain sums).

    Returns ``(logBFs, log_n_effs, variances)``, each ``(..., N_events)``.
    """
    n_samples = weights.shape[-1]
    if log:
        lse1, lse2 = double_logsumexp(weights)
        logn_effs = 2.0 * lse1 - lse2
        logBFs = lse1 - math.log(n_samples)
    else:
        BFs = weights.sum(-1)
        n_effs = BFs**2 / (weights**2).sum(-1)
        logBFs = torch.log(BFs / n_samples)
        logn_effs = torch.log(n_effs)
    variances = torch.exp(-logn_effs) - 1.0 / n_samples
    return logBFs, logn_effs, variances


def detection_efficiency(weights, Ninj, log=False):
    """Detection efficiency mu by importance sampling over the found
    injections (``Ninj`` generated) with weights ``weights`` (log-weights
    with ``log=True``), with its MC effective sample size.

    The estimator's variance is ``sum(w^2)/Ninj^2 - mu^2/Ninj``; on the log
    path it is evaluated in shifted log space.  Returns ``(log_mu,
    log_n_eff, variance)``, each of the batch shape.
    """
    if log:
        log_ninj = math.log(Ninj)
        lse1, lse2 = double_logsumexp(weights)
        logmu = lse1 - log_ninj
        # var = e^A - e^B with A = log(sum w^2 / Ninj^2), B = log(mu^2 / Ninj);
        # B - A = log(n_eff_raw / Ninj) < 0 since n_eff_raw <= N_found < Ninj
        A = lse2 - 2.0 * log_ninj
        B = 2.0 * logmu - log_ninj
        logvar = A + torch.log1p(-torch.exp(torch.clamp_max(B - A, -1e-6)))
        logn_eff = 2.0 * logmu - logvar
    else:
        mu = weights.sum(-1) / Ninj
        var = (weights**2).sum(-1) / Ninj**2 - mu**2 / Ninj
        logmu = torch.log(mu)
        logn_eff = 2.0 * logmu - torch.log(var)
    variance = torch.exp(-logn_eff) - 1.0 / Ninj
    return logmu, logn_eff, variance


def _subpopulation_draws(Nobs, pop_frac, rngkey):
    """The categorical subpopulation of each event, ``Qs`` ``(Nobs,)``,
    drawn under ``plate("nObs")`` from ``rngkey`` (the same draws in every
    run of the model); ``pop_frac`` is put on the key's device."""
    device = rngkey.device if isinstance(rngkey, torch.Generator) else "cpu"
    probs = torch.as_tensor(pop_frac, dtype=torch.float64, device=device)
    with ppl.plate("nObs", Nobs):
        return ppl.sample("Qs", dist.Categorical(probs=probs), rng_key=rngkey)


def hierarchical_likelihood(
    pe_weights,
    inj_weights,
    total_inj,
    Nobs,
    Tobs,
    surveyed_hypervolume=None,
    categorical=False,
    marginal_qs=False,
    indv_weights=None,
    rngkey=None,
    pop_frac=None,
    reconstruct_rate=True,
    marginalize_selection=False,
    min_neff_cut=True,
    max_variance_cut=False,
    posterior_predictive_check=False,
    param_names=None,
    pedata=None,
    injdata=None,
    m2min=3.0,
    m1min=5.0,
    mmax=100.0,
    log=False,
    pe_summaries=None,
    inj_summaries=None,
):
    """Importance-sampled hierarchical likelihood with rate reconstruction,
    the ``min_neff`` / ``max_variance`` walls and the deterministic
    diagnostic sites, added to the model as the ``log_likelihood`` factor.

    ``pe_weights`` ``(C, N_events, N_samples)`` and ``inj_weights``
    ``(C, N_found)`` are linear weights (the default) or log-weights with
    ``log=True``.  Returns the reconstructed ``rate`` ``(C,)`` or None.

    Categorical subpopulations (``categorical``): ``pe_weights`` is a pair
    of banks, one per subpopulation; each event's subpopulation ``Qs`` is
    drawn once per call, under ``plate("nObs")``, from ``Categorical(
    pop_frac)`` with the key ``rngkey`` (an int or a ``torch.Generator``),
    so every run of the model draws the same ``Qs``; a substituted ``Qs``
    may carry a chain axis, ``(C, Nobs)``.

    Summaries seam: ``pe_summaries=(logBFs, log_n_effs, n_samples)`` and
    ``inj_summaries=(log_mu, log_n_eff_inj)`` take reductions computed
    upstream (the streamed op, ``ops/streamed.py``, or K3 through
    ``FusedBSplineLikelihood``) in place of the weight banks, which may then
    be None.

    ``posterior_predictive_check`` with ``param_names``, ``pedata`` and
    ``injdata`` adds the sites ``{p}_obs_event_{i}`` and
    ``{p}_pred_event_{i}`` (see :func:`_posterior_predictive_sites`), but
    only in a run whose deterministic sites are read
    (:class:`~gwinferno_tpu_torch.ppl.handlers.collect_deterministic`, as
    ``MCMC.get_deterministic`` runs the model): the density does not depend
    on them, so a potential's gradient never draws them, as the JAX
    package's compiled gradient drops them.  ``marginal_qs`` adds, for
    each subpopulation ``i`` of ``indv_weights`` (linear weights ``(...,
    N_events, N_samples)``), ``cat_frac_subpop_{i+1}_event_{ev}``: its
    weight over the bank's at the observed draw (with ``log=True`` the bank's
    weights there are ``exp(logw - max)`` per event, as in the JAX package).
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

    if categorical:
        Qs = _subpopulation_draws(Nobs, pop_frac, rngkey)[..., None].to(pe_weights[0].device)
        mix_pe_weights = torch.where(Qs == 0, pe_weights[0], pe_weights[1])
        logBFs, logn_effs, variances = per_event_log_bayes_factors(mix_pe_weights, log=log)
    elif pe_summaries is not None:
        logBFs, logn_effs, n_samples = pe_summaries
        variances = torch.exp(-logn_effs) - 1.0 / n_samples
    else:
        logBFs, logn_effs, variances = per_event_log_bayes_factors(pe_weights, log=log)
    if inj_summaries is not None:
        log_det_eff, logn_eff_inj = inj_summaries
        variance = torch.exp(-logn_eff_inj) - 1.0 / total_inj
    else:
        log_det_eff, logn_eff_inj, variance = detection_efficiency(inj_weights, total_inj, log=log)
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

    if posterior_predictive_check and param_names is not None and injdata is not None and pedata is not None:
        n_events = pe_weights.shape[-2]
        names = [f"{p}_{kind}_event_{ev}" for ev in range(n_events) for p in param_names for kind in ("obs", "pred")]
        if marginal_qs:
            names += [f"cat_frac_subpop_{i + 1}_event_{ev}" for ev in range(n_events) for i in range(len(indv_weights))]
        if ppl.deterministic_requested(names):
            _posterior_predictive_sites(pe_weights, inj_weights, pedata, injdata, param_names,
                                        m1min=m1min, m2min=m2min, mmax=mmax, marginal_qs=marginal_qs,
                                        indv_weights=indv_weights, log=log)
    return rate


@functools.lru_cache(maxsize=8)
def _event_uniforms(n_events):
    """``(n_events, 2)`` float64 uniforms on the host: row ``ev`` from a
    generator seeded with ``ev`` (the JAX package's ``PRNGKey(ev)``), for
    the observed and the predicted draw of event ``ev``."""
    return torch.stack([torch.rand(2, generator=torch.Generator().manual_seed(ev), dtype=torch.float64)
                        for ev in range(n_events)])


def _choice(w, mask, u):
    """Inverse-cdf draws from the rows of the weights ``w`` ``(..., N)``
    (zero weight where ``mask``): for each uniform of ``u`` (broadcast
    against the rows' batch shape on a new last axis), the first index whose
    cumulative weight reaches ``total * (1 - u)``, as ``jax.random.choice``
    with ``p`` does.  Returns ``(..., M)`` indices."""
    cum = torch.cumsum(torch.where(mask, 0.0, w), dim=-1)
    r = cum[..., -1:] * (1.0 - u)
    return torch.searchsorted(cum, r.contiguous()).clamp_max(cum.shape[-1] - 1)


def _posterior_predictive_sites(pe_weights, inj_weights, pedata, injdata, param_names, m1min=5.0, m2min=3.0,
                                mmax=100.0, marginal_qs=False, indv_weights=None, log=True):
    """Reweighted observed and predicted draws per event, as deterministic
    sites ``{p}_obs_event_{i}`` and ``{p}_pred_event_{i}`` (each ``(C,)``),
    from log-weights (``log=True``, shifted by each bank's maximum before the
    ``exp``) or linear weights.

    For event ``i`` the observed draw picks one of its PE samples with
    probability proportional to its weight, the predicted draw one found
    injection with probability proportional to the injection weights; samples
    with ``mass_1`` outside ``[m1min, mmax]`` or ``mass_1 * mass_ratio <
    m2min`` weigh 0.  Event ``i``'s two uniforms are fixed
    (:func:`_event_uniforms`), so the draws are deterministic given the
    weights, as the JAX package's fixed ``PRNGKey(i)`` makes them.  With
    ``marginal_qs``, ``cat_frac_subpop_{j+1}_event_{i}`` is
    ``indv_weights[j]`` over the bank's weight at event ``i``'s observed
    draw.
    """

    def masked(d):
        m1 = d["mass_1"]
        return (m1 < m1min) | (m1 > mmax) | (m1 * d["mass_ratio"] < m2min)

    if log:
        pe_weights = torch.exp(pe_weights - pe_weights.amax(-1, keepdim=True))
        inj_weights = torch.exp(inj_weights - inj_weights.amax(-1, keepdim=True))
    n_events = pe_weights.shape[-2]
    u = _event_uniforms(n_events).to(pe_weights.device, pe_weights.dtype)
    obs_idx = _choice(pe_weights, masked(pedata), u[:, :1])[..., 0]  # (C, E)
    pred_idx = _choice(inj_weights, masked(injdata), u[:, 1])  # (C, E)
    events = torch.arange(n_events, device=obs_idx.device)
    if marginal_qs:
        at_obs = torch.gather(pe_weights, -1, obs_idx[..., None])[..., 0]
        for i, w in enumerate(indv_weights):
            w = torch.as_tensor(w, dtype=pe_weights.dtype, device=pe_weights.device).expand(pe_weights.shape)
            frac = torch.gather(w, -1, obs_idx[..., None])[..., 0] / at_obs
            for ev in range(n_events):
                ppl.deterministic(f"cat_frac_subpop_{i + 1}_event_{ev}", frac[..., ev])
    for p in param_names:
        obs, pred = pedata[p][events, obs_idx], injdata[p][pred_idx]
        for ev in range(n_events):
            ppl.deterministic(f"{p}_obs_event_{ev}", obs[..., ev])
            ppl.deterministic(f"{p}_pred_event_{ev}", pred[..., ev])


def _plan_hyperpriors(prior_dict):
    """Split the flat hyperprior dict into sample-site specs ``(name, class,
    kwargs)`` and pinned constants.  Any object with ``.dist`` and
    ``.params`` is a prior spec, as in the JAX package."""
    sites, pinned = [], {}
    for name, spec in prior_dict.items():
        if isinstance(spec, PopPrior) or (hasattr(spec, "dist") and hasattr(spec, "params")):
            sites.append((name, spec.dist, spec.params))
        else:
            pinned[name] = spec
    return sites, pinned


def _plan_population_builders(model_dict):
    """Each config block as a builder ``(hypers, redshift_kwargs) ->
    distribution``, the site names resolved here; iid aliases as
    ``(alias, source)`` pairs (the alias reuses the source's distribution).
    The redshift block's class gets ``redshift_kwargs`` (the z grid, and its
    dVc/dz for :class:`PowerlawRedshift`), as the JAX package passes it the
    grid."""
    builders, aliases = [], []
    for param, spec in model_dict.items():
        if isinstance(spec, PopMixtureModel):
            comp_keys = [
                (cls, [(f"{param}_component_{i + 1}_{hp}", hp) for hp in hps])
                for i, (cls, hps) in enumerate(zip(spec.components, spec.component_params))
            ]
            mix_keys = [(f"{param}_mixture_dist_{hp}", hp) for hp in spec.mixing_params]

            def build_mixture(hypers, redshift_kwargs, spec=spec, comp_keys=comp_keys, mix_keys=mix_keys):
                comps = [cls(**{hp: hypers[key] for key, hp in keys}) for cls, keys in comp_keys]
                mixing = spec.mixing_dist(**{hp: hypers[key] for key, hp in mix_keys})
                return spec.model(mixing, comps)

            builders.append((param, build_mixture))
        elif isinstance(spec, PopModel):
            keys = [(f"{param}_{hp}", hp) for hp in spec.params]
            is_z = param == "redshift"

            def build_single(hypers, redshift_kwargs, spec=spec, keys=keys, is_z=is_z):
                extra = {}
                if is_z:
                    extra["grid"] = redshift_kwargs["grid"]
                    if isinstance(spec.model, type) and issubclass(spec.model, PowerlawRedshift):
                        extra["dVcdz"] = redshift_kwargs["dVcdz"]
                return spec.model(**{hp: hypers[key] for key, hp in keys}, **extra)

            builders.append((param, build_single))
        elif isinstance(spec, str):
            aliases.append((param, spec))
        else:
            raise ValueError(f"Unknown model type: {type(spec)}:{spec}")
    return builders, aliases


def _on(v, device, dtype):
    """A constant on the model's device and dtype: tensors are moved, numbers
    stay numbers."""
    return v.to(device=device, dtype=dtype) if isinstance(v, torch.Tensor) else v


class HierarchicalModel:
    """The model :func:`construct_hierarchical_model` returns: call it as
    ``model(samps, injs, Ninj, Nobs, Tobs)`` with the PE banks ``{param:
    (E, S)}`` and the found injections ``{param: (N,)}`` as tensors on one
    device in one dtype (``prior`` among the keys).

    Its constants (pinned values, hyperprior distributions, the redshift
    grid and its dVc/dz) are made on the banks' device and dtype at the
    first call on them; the data-only terms of a bank (``-log prior`` and,
    for :class:`PowerlawRedshift`, dVc/dz at its redshifts) are made once per
    bank.  Per call it samples the hyperpriors (``(C,)`` per site), builds
    the population distributions and sums their :func:`population_log_prob`
    into log-weights ``(C, E, S)`` and ``(C, N)`` for
    :func:`hierarchical_likelihood`.
    """

    def __init__(self, model_dict, prior_dict, likelihood_kwargs):
        self.source_params = tuple(model_dict)
        self.z_max = float(prior_dict["redshift_maximum"]) if "redshift" in model_dict else None
        self.sites, self.pinned = _plan_hyperpriors(prior_dict)
        for _, cls, kwargs in self.sites:
            cls(**kwargs)  # malformed prior parameters raise here, on the host
        self.builders, self.aliases = _plan_population_builders(model_dict)
        self.likelihood_kwargs = likelihood_kwargs
        self._consts = {}
        self._banks = {}

    def _constants(self, device, dtype):
        key = (device, dtype)
        if key not in self._consts:
            consts = {
                "pinned": {k: _on(v, device, dtype) for k, v in self.pinned.items()},
                "priors": [(name, cls(**{k: _on(v, device, dtype) for k, v in kw.items()}))
                           for name, cls, kw in self.sites],
                "redshift": None,
            }
            if self.z_max is not None:
                z = np.linspace(1e-9, self.z_max, 1000)
                consts["redshift"] = {
                    "grid": torch.linspace(1e-9, self.z_max, 1000, dtype=dtype, device=device),
                    "dVcdz": torch.as_tensor(PLANCK_2015_LVK_Cosmology.dVcdz(z), dtype=dtype, device=device),
                }
            self._consts[key] = consts
        return self._consts[key]

    def _bank_terms(self, data, redshift):
        """``(-log prior, dVc/dz at the bank's redshifts or None)``, made once
        per bank (the bank's ``prior`` tensor is the key)."""
        prior = data["prior"]
        hit = self._banks.get(id(prior))
        if hit is None or hit[0] is not prior:
            dvdz = None
            if redshift is not None and "redshift" in data:
                dvdz = interp(data["redshift"], redshift["grid"], redshift["dVcdz"])
            hit = (prior, -torch.log(prior), dvdz)
            self._banks[id(prior)] = hit
        return hit[1], hit[2]

    def __call__(self, samps, injs, Ninj, Nobs, Tobs):
        ref = samps["prior"]
        consts = self._constants(ref.device, ref.dtype)
        hypers = dict(consts["pinned"])
        for name, d in consts["priors"]:
            hypers[name] = ppl.sample(name, d)
        dists = {param: build(hypers, consts["redshift"]) for param, build in self.builders}
        for alias, source in self.aliases:
            dists[alias] = dists[source]

        def bank_log_weights(data):
            lw, dvdz = self._bank_terms(data, consts["redshift"])
            for p in self.source_params:
                d = dists[p]
                if p == "redshift" and isinstance(d, PowerlawRedshift) and d.zs is consts["redshift"]["grid"]:
                    lw = lw + d.log_prob(data[p], dVdc=dvdz)
                else:
                    lw = lw + dist.population_log_prob(d, data[p])
            return lw

        hierarchical_likelihood(
            bank_log_weights(samps),
            bank_log_weights(injs),
            total_inj=Ninj,
            Nobs=Nobs,
            Tobs=Tobs,
            surveyed_hypervolume=dists["redshift"].norm,
            pedata=samps,
            injdata=injs,
            param_names=self.source_params,
            m1min=2.0,
            m2min=2.0,
            mmax=100.0,
            log=True,
            **self.likelihood_kwargs,
        )


def construct_hierarchical_model(
    model_dict,
    prior_dict,
    marginalize_selection=False,
    min_neff_cut=True,
    max_variance_cut=False,
    posterior_predictive_check=True,
):
    """The PPL model of a parsed config (``ConfigReader.models`` and
    ``.priors``): hyperprior sites, population distributions (mixtures and
    iid aliases included), the redshift model's z grid up to the pinned
    ``redshift_maximum`` and its ``norm`` as the surveyed hypervolume, and
    the hierarchical likelihood with these settings.  Returns a
    :class:`HierarchicalModel`; its sites carry the chain axis."""
    return HierarchicalModel(model_dict, prior_dict, dict(
        marginalize_selection=marginalize_selection,
        min_neff_cut=min_neff_cut,
        max_variance_cut=max_variance_cut,
        posterior_predictive_check=posterior_predictive_check,
    ))
