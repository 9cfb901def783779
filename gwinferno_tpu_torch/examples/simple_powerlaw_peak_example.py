"""Powerlaw+peak population analysis: the quick-start example of the README.

Counterpart of ``examples/simple_powerlaw_peak_example.py``: the
14-hyperparameter powerlaw+peak model with independent spins, run by NUTS,
then the posterior file, the mass, spin and rate(z) PPDs, their plots and
the PPD file.  The model takes the JAX example's sites, priors and order;
every sample site carries a leading chain axis ``(C,)``, so the log weights
are ``(C, E, S)`` for the PE bank and ``(C, N)`` for the injections, and
the likelihood reduces each bank with K1 (``ops/csrc/dlse.cu``): two
launches a model run.  The posterior-predictive sites are drawn only when
``MCMC.get_deterministic`` asks for them by name, never in a gradient.

Run:  python -m gwinferno_tpu_torch.examples.simple_powerlaw_peak_example --pe-inj-file CATALOG.h5 \\
          --warmup 500 --samples 1500 [--device cpu --dtype float64]
"""

from __future__ import annotations

import math

import torch

from .. import ppl
from ..device import host_array
from ..device import resolve_device
from ..distributions import per_chain
from ..models.parametric.parametric import log_independent_spin_magnitude_beta_dist
from ..models.parametric.parametric import log_independent_spin_tilt
from ..models.parametric.parametric import log_plpeak_primary_ratio_pdf
from ..pipeline.analysis import hierarchical_likelihood
from ..pipeline.utils import load_base_parser
from ..pipeline.utils import load_pe_and_injections_as_dict
from ..pipeline.utils import pdf_dict_to_xarray
from ..pipeline.utils import posterior_dict_to_xarray
from ..postprocess.calculations import calculate_beta_spin_mag
from ..postprocess.calculations import calculate_mixture_iso_aligned_spin_tilt
from ..postprocess.calculations import calculate_powerlaw_peak_mass_ppds
from ..postprocess.calculations import calculate_powerlaw_rate_of_z_ppds
from ..postprocess.plot import plot_mass_pdfs
from ..postprocess.plot import plot_rate_of_z_pdfs
from ..postprocess.plot import plot_spin_pdfs
from ..ppl import distributions as dist
from ..preprocess.conversions import alpha_beta_from_mu_var
from .utils import add_device_arguments
from .utils import run_powerlawpeak_analysis
from .utils import setup_result_dir

__all__ = ["model", "powerlawpeak_ppds", "main"]


def model(pedict, injdict, Nobs, Tobs, Ninj, z_model, mmin, mmax, param_names):
    """The 14-hyperparameter powerlaw+peak + independent-spins model on the
    banks ``pedict`` ``{param: (E, S)}`` and ``injdict`` ``{param: (N,)}``
    (tensors on the model's device)."""
    # Mass
    beta = ppl.sample("beta", dist.Normal(0, 5))
    alpha = ppl.sample("alpha", dist.Normal(0, 5))
    mu_peak = ppl.sample("mu_peak", dist.Uniform(mmin, mmax))
    sig_peak = ppl.sample("sig_peak", dist.HalfNormal(10))
    lambda_m = ppl.sample("lambda_m", dist.Uniform(0, 1))

    # Spin magnitude (independent; the Beta moment map of (mu, var))
    mu_a1 = ppl.sample("mu_a1", dist.Uniform(0, 1))
    var_a1 = ppl.sample("var_a1", dist.Uniform(0.005, 0.25))
    mu_a2 = ppl.sample("mu_a2", dist.Uniform(0, 1))
    var_a2 = ppl.sample("var_a2", dist.Uniform(0.005, 0.25))
    a1_shapes = alpha_beta_from_mu_var(mu_a1, var_a1)
    a2_shapes = alpha_beta_from_mu_var(mu_a2, var_a2)
    alpha_a1 = ppl.deterministic("alpha_a1", a1_shapes[0])
    alpha_a2 = ppl.deterministic("alpha_a2", a2_shapes[0])
    beta_a1 = ppl.deterministic("beta_a1", a1_shapes[1])
    beta_a2 = ppl.deterministic("beta_a2", a2_shapes[1])

    # Spin tilt (independent)
    lambda_ct1 = ppl.sample("lambda_ct1", dist.Uniform(0, 1))
    lambda_ct2 = ppl.sample("lambda_ct2", dist.Uniform(0, 1))
    sig_ct1 = ppl.sample("sig_ct1", dist.Uniform(0.1, 4))
    sig_ct2 = ppl.sample("sig_ct2", dist.Uniform(0.1, 4))

    # Redshift
    lamb = ppl.sample("lamb", dist.Normal(0, 5))

    def get_log_weights(datadict):
        nd = datadict["mass_1"].ndim
        a, b, mp, sp, lm, aa1, ba1, aa2, ba2, lc1, lc2, sc1, sc2, la = (
            per_chain(v, nd) for v in (alpha, beta, mu_peak, sig_peak, lambda_m, alpha_a1, beta_a1, alpha_a2,
                                       beta_a2, lambda_ct1, lambda_ct2, sig_ct1, sig_ct2, lamb)
        )
        logw = (
            log_plpeak_primary_ratio_pdf(datadict["mass_1"], datadict["mass_ratio"], a, b, mmin, mmax, mp, sp, lm)
            + log_independent_spin_magnitude_beta_dist(datadict["a_1"], datadict["a_2"], aa1, ba1, aa2, ba2)
            + log_independent_spin_tilt(datadict["cos_tilt_1"], datadict["cos_tilt_2"], lc1, lc2, sc1, sc2)
            + z_model.log_prob(datadict["redshift"], la)
            - torch.log(datadict["prior"])
        )
        return torch.where(torch.isnan(logw), -math.inf, logw)

    hierarchical_likelihood(
        get_log_weights(pedict),
        get_log_weights(injdict),
        float(Ninj),
        Nobs,
        Tobs,
        surveyed_hypervolume=z_model.normalization(lamb),
        param_names=param_names,
        posterior_predictive_check=True,
        pedata=pedict,
        injdata=injdict,
        m2min=mmin,
        m1min=mmin,
        mmax=mmax,
        log=True,
    )


def powerlawpeak_ppds(posterior, z_model, args):
    """The example's mass, spin and rate(z) PPDs from the ``posterior``
    draws, on the redshift model's device in its dtype: ``(pdf_dict,
    param_dict)``, each pdf ``(n_draws, grid)`` (numpy) under the name
    ``pdf_dict_to_xarray`` files it by, its grid under the same name."""
    post = {k: host_array(v) for k, v in posterior.items()}
    on = dict(device=z_model.zs.device, dtype=z_model.zs.dtype)
    print("calculating mass ppds:")
    mass, m1s, mass_ratio, qs = calculate_powerlaw_peak_mass_ppds(
        post["alpha"], post["beta"], post["mu_peak"], post["sig_peak"], post["lambda_m"], args.mmin, args.mmax, **on
    )
    print("calculating spin ppds:")
    alpha_a1, beta_a1 = alpha_beta_from_mu_var(post["mu_a1"], post["var_a1"])
    alpha_a2, beta_a2 = alpha_beta_from_mu_var(post["mu_a2"], post["var_a2"])
    mag1, _ = calculate_beta_spin_mag(alpha_a1, beta_a1, **on)
    mag2, mags = calculate_beta_spin_mag(alpha_a2, beta_a2, **on)
    tilt1, _ = calculate_mixture_iso_aligned_spin_tilt(post["sig_ct1"], post["lambda_ct1"], **on)
    tilt2, tilts = calculate_mixture_iso_aligned_spin_tilt(post["sig_ct2"], post["lambda_ct2"], **on)
    print("calculating rate(z) ppds:")
    r_of_z, zs = calculate_powerlaw_rate_of_z_ppds(post["lamb"], post["rate"], z_model)
    pdf_dict = {
        "a1": mag1, "cos_tilt1": tilt1, "a2": mag2, "cos_tilt2": tilt2,
        "mass_1": mass, "mass_ratio": mass_ratio, "redshift": r_of_z,
    }
    param_dict = {"a1": mags, "a2": mags, "cos_tilt1": tilts, "cos_tilt2": tilts, "mass_1": m1s, "redshift": zs,
                  "mass_ratio": qs}
    return pdf_dict, param_dict


def main(argv=None):
    parser = load_base_parser()
    parser.add_argument("--example", type=str, default=None)
    add_device_arguments(parser)
    args = parser.parse_args(argv)
    device, dtype = resolve_device(args.device), getattr(torch, args.dtype)

    pedict, injdict, constants, param_names = load_pe_and_injections_as_dict(args.pe_inj_file)
    label, result_dir = setup_result_dir(args, default_label="powerlaw_peak")

    posterior, z_model, _ = run_powerlawpeak_analysis(model, pedict, injdict, constants, param_names, args,
                                                   device=device, dtype=dtype)
    posterior_dict_to_xarray(posterior).to_hdf5(result_dir + f"/{label}_posterior_samples.h5")
    print(f"posteriors file saved: {result_dir}/{label}_posterior_samples.h5")

    pdf_dict, param_dict = powerlawpeak_ppds(posterior, z_model, args)
    names, colors = ["PowerlawPeak"], ["tab:blue"]
    print("plotting:")
    plot_mass_pdfs([pdf_dict["mass_1"]], [pdf_dict["mass_ratio"]], param_dict["mass_1"], param_dict["mass_ratio"],
                   names, label, result_dir, save=args.save_plots, colors=colors)
    plot_spin_pdfs([pdf_dict["a1"]], [pdf_dict["cos_tilt1"]], param_dict["a1"], param_dict["cos_tilt1"], names, label,
                   result_dir, save=args.save_plots, colors=colors)
    plot_spin_pdfs([pdf_dict["a2"]], [pdf_dict["cos_tilt2"]], param_dict["a2"], param_dict["cos_tilt2"], names, label,
                   result_dir, save=args.save_plots, colors=colors, secondary=True)
    plot_rate_of_z_pdfs(pdf_dict["redshift"], param_dict["redshift"], label, result_dir, save=args.save_plots)

    pdf_dict_to_xarray(pdf_dict, param_dict, args.samples).to_hdf5(result_dir + f"/{label}_pdfs.h5")
    print(f"pdfs saved: {result_dir}/{label}_pdfs.h5")


if __name__ == "__main__":
    main()
