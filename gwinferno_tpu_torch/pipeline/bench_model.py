"""The bench problem: the 14-hyperparameter powerlaw+peak model with spins.

Counterpart of ``bench.py::make_model`` (its flat and streamed routes): powerlaw+peak
``(m1, q)``, independent beta spin magnitudes parameterized by ``(mu, var)``,
independent isotropic+aligned tilt mixtures and a powerlaw-in-``(1+z)``
redshift evolution, fed to :func:`hierarchical_likelihood` with
``min_neff_cut=True``.

The PE and injection banks are concatenated once into one vector per
parameter and held on the device, so each gradient evaluates the log-weight
chain once over ``N_events * N_samples + N_found`` samples for all chains
``(C, N)``.  The data-only terms (``log prior``, ``log dVc/dz``,
``log(1+z)`` and the ``z <= zmax`` mask) are computed once at construction.
The streamed route (``streamed=True``) keeps the two banks apart and hands
them to K2 instead; the chunked route (``sample_chunks=n``) keeps them apart
too and evaluates the chain in ``n`` chunks of the PE sample axis
(``ops/chunked.py``).

Under a mesh with a data axis, each rank builds the model from its shard of
the catalog (``parallel.shard_catalog``: the PE banks along their sample
axis, the injections along theirs, dVc/dz with them), and every route's
likelihood merges the ranks' reductions (``analysis.summaries_over_data``
for the chunked and streamed routes).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..models.parametric.parametric import log_independent_spin_magnitude_beta_dist
from ..models.parametric.parametric import log_independent_spin_tilt
from ..models.parametric.parametric import log_plpeak_primary_ratio_pdf
from .. import ppl
from ..ops.chunked import chunked_pairs
from ..ops.streamed import BANK_KEYS
from ..ops.streamed import StreamedBank
from ..ops.streamed import reshape_bank_rows
from ..ops.streamed import streamed_pairs
from ..ppl import distributions as dist
from .analysis import hierarchical_likelihood
from .analysis import summaries_over_data

__all__ = ["BenchModel", "FIDUCIAL_INIT", "TRUTH", "INIT_JITTER", "jittered_init", "MMIN", "MMAX", "bench_log_weight",
           "bench_banks"]

MMIN, MMAX = 5.0, 100.0
PARAMS7 = ("mass_1", "mass_ratio", "redshift", "a_1", "a_2", "cos_tilt_1", "cos_tilt_2")
INJ_ROW_COLS = 8192  # the streamed route's injection rows (bench.py's reshape_bank_rows)

FIDUCIAL_INIT = {
    "alpha": -2.35, "beta": 1.0, "mu_peak": 35.0, "sig_peak": 5.0, "lambda_m": 0.25,
    "mu_a1": 0.35, "var_a1": 0.03, "mu_a2": 0.35, "var_a2": 0.03,
    "lambda_ct1": 0.7, "lambda_ct2": 0.7, "sig_ct1": 0.5, "sig_ct2": 0.5,
    "lamb": 1.7, "unscaled_rate": 69.0,
}

# the synthetic catalog's population truth, keyed by model site name
TRUTH = {
    "alpha": -2.35, "beta": 1.0, "mu_peak": 35.0, "sig_peak": 5.0, "lambda_m": 0.25,
    "mu_a1": 0.35, "var_a1": 0.03, "mu_a2": 0.35, "var_a2": 0.03,
    "lambda_ct1": 0.7, "lambda_ct2": 0.7, "sig_ct1": 0.5, "sig_ct2": 0.5,
    "lamb": 1.7,
}

# half-widths of the per-chain uniform jitter around FIDUCIAL_INIT
INIT_JITTER = {
    "alpha": 0.3, "beta": 0.3, "mu_peak": 2.0, "sig_peak": 1.0, "lambda_m": 0.05,
    "mu_a1": 0.05, "var_a1": 0.01, "mu_a2": 0.05, "var_a2": 0.01,
    "lambda_ct1": 0.1, "lambda_ct2": 0.1, "sig_ct1": 0.15, "sig_ct2": 0.15,
    "lamb": 0.5, "unscaled_rate": 10.0,
}


def beta_ab(mu, var):
    """The (mu, var) -> (alpha, beta) moment map of the Beta distribution."""
    nu = mu * (1.0 - mu) / var - 1.0
    return mu * nu, (1.0 - mu) * nu


def jittered_init(num_chains, generator, dtype=torch.float32):
    """Overdispersed per-chain starts: ``FIDUCIAL_INIT`` plus a uniform
    jitter of ``INIT_JITTER`` half-width, ``{site: (num_chains,)}`` on the
    generator's device."""
    out = {}
    for k, v in FIDUCIAL_INIT.items():
        u = torch.rand(num_chains, generator=generator, device=generator.device, dtype=dtype)
        out[k] = v + INIT_JITTER[k] * (2.0 * u - 1.0)
    return out


def bench_banks(d, dvdz, zmax):
    """The bench chain's bank from the sample dict ``d`` (numpy, any shape)
    and ``dVc/dz`` at its redshifts: the seven parameters, ``log_prior``,
    ``log_dvdz``, ``log1pz`` (float64) and ``z_ok`` (``redshift <= zmax``)."""
    out = {k: np.asarray(d[k], np.float64) for k in PARAMS7}
    out["log_prior"] = np.log(np.asarray(d["prior"], np.float64))
    out["log_dvdz"] = np.log(np.asarray(dvdz, np.float64))
    out["log1pz"] = np.log1p(out["redshift"])
    out["z_ok"] = out["redshift"] <= zmax
    return out


def bench_log_weight(d, th):
    """Per-sample log-weights of the population ``th`` over the bank ``d``
    (:func:`bench_banks`' keys, as tensors), broadcast against the shapes of
    ``th``'s values: ``bench.py``'s ``log_weight`` and ``streamed_logw``.
    NaN and ``+inf`` become ``-inf``."""
    logw = (
        log_plpeak_primary_ratio_pdf(
            d["mass_1"], d["mass_ratio"], th["alpha"], th["beta"], MMIN, MMAX,
            th["mu_peak"], th["sig_peak"], th["lambda_m"],
        )
        + log_independent_spin_magnitude_beta_dist(
            d["a_1"], d["a_2"], th["alpha_a1"], th["beta_a1"], th["alpha_a2"], th["beta_a2"]
        )
        + log_independent_spin_tilt(
            d["cos_tilt_1"], d["cos_tilt_2"], th["lambda_ct1"], th["lambda_ct2"], th["sig_ct1"], th["sig_ct2"]
        )
        + torch.where(
            d["z_ok"],
            d["log_dvdz"] + (th["lamb"] - 1.0) * d["log1pz"] - th["z_lognorm"],
            torch.finfo(d["log_dvdz"].dtype).min,
        )
        - d["log_prior"]
    )
    return torch.where(torch.isnan(logw) | (logw == torch.inf), -torch.inf, logw)


class BenchModel(torch.nn.Module):
    """The bench model as a PPL model: calling it declares the 15 sample
    sites and the likelihood factor.  Sites carry a leading chain axis.

    ``streamed=True`` takes the streamed route of ``bench.py``
    (``BENCH_STREAMED=1``): the whole log-weight chain and its paired
    reduction run in K2 (``ops/streamed.py``) over the PE bank ``(E, S)``
    and the injection bank reshaped to rows of 8192, and the reductions feed
    the likelihood's summaries seam.  ``sample_chunks=n > 1`` takes the
    chunked route of ``bench.py`` (``BENCH_SAMPLE_CHUNKS=n``): the PE bank in
    ``n`` chunks of its sample axis and the injections in one, each under a
    checkpoint and reduced by K1 (``ops/chunked.py``), into the same seam.
    The default is the flat route.  The JAX bench takes the streamed route
    when both are set; here the pair raises.
    """

    def __init__(self, pedict, injdict, constants, z_model, device=None, dtype=torch.float32, streamed=False,
                 sample_chunks=1):
        super().__init__()
        dev = resolve_device(device)
        E, S = np.shape(pedict["mass_1"])
        self.n_events, self.n_samples = int(E), int(S)
        self.constants = dict(constants)
        self.z_model = z_model
        self.streamed = bool(streamed)
        self.sample_chunks = int(sample_chunks)
        if self.sample_chunks < 1 or self.n_samples % self.sample_chunks:
            raise ValueError(f"sample_chunks={sample_chunks} must divide the {self.n_samples} PE samples")
        if self.streamed and self.sample_chunks > 1:
            raise ValueError("streamed=True and sample_chunks > 1 are two routes; pick one")
        if self.streamed:
            self._build_streamed(pedict, injdict, z_model, dev, dtype)
            return
        pe = bench_banks(pedict, z_model.dVdzs[1], z_model.zmax)
        inj = bench_banks(injdict, z_model.dVdzs[0], z_model.zmax)

        def put(bank):
            return {k: torch.as_tensor(v, dtype=None if v.dtype == bool else dtype, device=dev) for k, v in bank.items()}

        if self.sample_chunks > 1:
            self.pe_bank, self.inj_bank = put(pe), put(inj)
            return
        for k, v in put({k: np.concatenate([pe[k].reshape(-1), inj[k]]) for k in pe}).items():
            self.register_buffer(k, v)

    def _build_streamed(self, pedict, injdict, z_model, dev, dtype):
        """The two banks of the streamed route, their data-only columns made
        once on ``dev`` in ``dtype``."""
        pe2d = bench_banks(pedict, z_model.dVdzs[1], z_model.zmax)
        inj = bench_banks(injdict, z_model.dVdzs[0], z_model.zmax)
        inj_rows, inj_valid = reshape_bank_rows({k: inj[k] for k in BANK_KEYS}, cols=INJ_ROW_COLS)
        self.pe_op = StreamedBank(pe2d, MMIN, MMAX, z_model.zmax)
        self.inj_op = StreamedBank(inj_rows, MMIN, MMAX, z_model.zmax, valid=inj_valid)
        for op in (self.pe_op, self.inj_op):
            op.columns(dtype, dev)

    def log_weight(self, th):
        """Per-sample log-weights ``(C, N)`` of the population ``th`` (each
        hyperparameter ``(C, 1)``) over the concatenated bank."""
        bank = {k: getattr(self, k) for k in PARAMS7 + ("log_prior", "log_dvdz", "log1pz", "z_ok")}
        return bench_log_weight(bank, th)

    def forward(self):
        th = {
            "beta": ppl.sample("beta", dist.Normal(0, 5)),
            "alpha": ppl.sample("alpha", dist.Normal(0, 5)),
            "mu_peak": ppl.sample("mu_peak", dist.Uniform(MMIN, MMAX)),
            "sig_peak": ppl.sample("sig_peak", dist.HalfNormal(10)),
            "lambda_m": ppl.sample("lambda_m", dist.Uniform(0, 1)),
            "mu_a1": ppl.sample("mu_a1", dist.Uniform(0, 1)),
            "var_a1": ppl.sample("var_a1", dist.Uniform(0.005, 0.25)),
            "mu_a2": ppl.sample("mu_a2", dist.Uniform(0, 1)),
            "var_a2": ppl.sample("var_a2", dist.Uniform(0.005, 0.25)),
            "lambda_ct1": ppl.sample("lambda_ct1", dist.Uniform(0, 1)),
            "lambda_ct2": ppl.sample("lambda_ct2", dist.Uniform(0, 1)),
            "sig_ct1": ppl.sample("sig_ct1", dist.Uniform(0.1, 4)),
            "sig_ct2": ppl.sample("sig_ct2", dist.Uniform(0.1, 4)),
            "lamb": ppl.sample("lamb", dist.Normal(0, 5)),
        }
        th["alpha_a1"], th["beta_a1"] = beta_ab(th["mu_a1"], th["var_a1"])
        th["alpha_a2"], th["beta_a2"] = beta_ab(th["mu_a2"], th["var_a2"])
        z_lognorm = torch.log(self.z_model.normalization(th["lamb"]))
        th["z_lognorm"] = z_lognorm
        c = self.constants
        if self.streamed:
            pe_w = inj_w = None
            pe_sum, inj_sum = summaries_over_data(
                *streamed_pairs(self.pe_op, self.inj_op, th), self.n_samples, c["total_inj"], c["nObs"]
            )
        elif self.sample_chunks > 1:
            pe_w = inj_w = None
            th_pe = {k: v[:, None, None] for k, v in th.items()}
            th_inj = {k: v[:, None] for k, v in th.items()}
            pairs = chunked_pairs(
                lambda part: bench_log_weight(part, th_pe), self.pe_bank,
                lambda part: bench_log_weight(part, th_inj), self.inj_bank,
                self.sample_chunks, inj_chunks=1,
            )
            pe_sum, inj_sum = summaries_over_data(*pairs, self.n_samples, c["total_inj"], c["nObs"])
        else:
            C = th["lamb"].shape[0]
            logw = self.log_weight({k: v[:, None] for k, v in th.items()})
            n_pe = self.n_events * self.n_samples
            pe_w, inj_w = logw[:, :n_pe].reshape(C, self.n_events, self.n_samples), logw[:, n_pe:]
            pe_sum = inj_sum = None
        hierarchical_likelihood(
            pe_w,
            inj_w,
            total_inj=c["total_inj"],
            Nobs=c["nObs"],
            Tobs=c["obs_time"],
            surveyed_hypervolume=torch.exp(z_lognorm),
            marginalize_selection=False,
            min_neff_cut=True,
            log=True,
            pe_summaries=pe_sum,
            inj_summaries=inj_sum,
        )
