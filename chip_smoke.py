#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``gwinferno_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--seed N --warmup W --samples S]

It needs no data file, no JAX and no h5py.  Phases, each printed as it starts
and with its wall time as it ends:

1. environment: torch / CUDA versions, the card's name and power limit;
2. build: every CUDA kernel of the port, compiled with ``nvcc`` for
   ``sm_90a`` from the sources in the checkout;
3. K1 (``ops/csrc/dlse.cu``, the double logsumexp) held against its plain
   torch version in float32 and float64, gradient included, at the flat
   route's and the unfused B-spline route's shapes plus all--inf and
   partly--inf rows, two launches bit for bit; kernel, plain, library and
   bound times beside the earlier design's, the geometry from the card's SM
   count and the kernel's occupancy, its registers; also at SMC's shapes
   (1024 particles: ``(70656, 8000)`` and ``(1024, 46770)``);
4. the flat route (the default) at full catalog width: a synthetic catalog
   made from ``--seed`` with numpy (69 events x 8000 PE samples, 46,770
   found injections), the bench model's potential and gradient for 16
   chains (checked against a float64 CPU evaluation on a slice of the
   catalog), then a 16-chain dense-mass NUTS run (depth 6) with warmup,
   saved with ``save_checkpoint``, loaded and resumed for 10 samples through
   ``post_warmup_state`` (no warmup, step size and mass matrix bit for bit);
   then the schedulers: the same run at 5 + 5 transitions under the sync
   scheduler and the async one at L = 1 and L = 4, equal bit for bit, each
   run's model runs and host reads by its scheduler's formula
   (:func:`loop_model_runs`);
5. K2 (``ops/csrc/streamed.cu``, the streamed whole-chain likelihood,
   forward and backward) held against its plain torch version on the
   streamed route's two banks (PE ``(69, 8000)``, injections ``(6, 8192)``)
   for 1, 16 and 17 chains, float64 and float32, and on a small bank that
   drives every branch (4 and 17 chains); per bank and direction at 16
   chains: kernel, plain and bound times, the geometry from the card's SM
   count and the kernel's registers;
6. the streamed route: its potential and gradient against the flat
   route's at the same point, both timed, then the same NUTS run on it, then
   a ``torch.profiler`` trace of both routes' potential + gradient (device
   time, device operations, busy share);
7. the B-spline production model (knots m1 50, q 30, a 16, tilt 16, z 20;
   mmin 3, mmax 100; whitened coefficient priors) on the same catalog: both
   routes built (build seconds, design bytes on the card), the fused route
   (K3) against the unfused one (K1) at the same 8 starts and both timed,
   a profile of both (device time per gradient, the port's kernels' share),
   K3 (``ops/csrc/flw.cu``, the coefficient product with the double
   logsumexp) against its plain version on the route's two banks for 1, 8
   and 16 chains in float64 and float32, on the injection design stored
   with unaligned rows and on an edge bank, two launches bit for bit, with
   kernel, plain, library and bound times beside the earlier design's, the
   geometry and registers; the fused route against a float64 CPU
   evaluation on a slice of the catalog, then
   an 8-chain NUTS run on the fused route through ``run_bspline_analysis``
   (target 0.9, diagonal mass, depth 6);
8. the config route: the model of ``examples/config_files/config_validation.yml``
   (its parsed form, ``CONFIG_VALIDATION``: smoothed-break powerlaw m1,
   powerlaw q, powerlaw redshift, the ``min_neff`` cut and the
   posterior-predictive sites) built by ``ConfigReader.parse_dict`` and
   ``construct_hierarchical_model`` on the same catalog, its potential and
   gradient for 4 and 16 chains against a float64 CPU evaluation on a slice
   of the catalog, both timed and profiled, then the config's sampler block
   (NUTS, dense mass, 4 chains, depth 6) through the CLI's in-memory
   ``run_config``: summary, the CLI's four deterministic sites and one
   posterior-predictive site, all finite;
9. the rest of the model library on the same catalog (mass_2, chi_eff and
   chi_p derived from its columns): the reference-style B-spline model of
   the JAX package's tests with independent spins (:class:`LibraryModel`;
   knots m1 50, q 30, a 16 + 16, tilt 16 + 16, z 20; whitened priors), its
   linear route (``log=False``, plain sums, no kernel) against its log route
   (K1) in float64 at 8 starts (``log_l`` to rtol 1e-9), the log route's
   float32 gradient timed, profiled and held against a float64 CPU
   evaluation on a slice, an 8-chain NUTS run on it (depth 6; K1 exactly twice a model run
   by the async formula), the run's mass, spin and rate PPDs
   (``postprocess/calculations.py``: finite, the pdfs normalized), two
   subpopulation banks under ``categorical`` with a fixed key (two calls
   equal bit for bit), then every other new model class and the linear
   parametric models at full width (float32 against float64 on the card,
   float64 on the card against the CPU on a slice); its wall time and peak
   memory;
10. the config route's sampler block with ``kernel: HMC`` through
   ``run_config`` (dense mass, 4 chains, the trajectory length 64 times the
   smallest step size of the run's own search): every site finite,
   divergences at most 10%;
11. SVI on the bench flat route at one chain: ``find_map`` and ``SVI``
    (AutoDelta from ``FIDUCIAL_INIT``, ``Adam(0.02)``, 300 steps; losses
    finite and falling, ``|MAP - TRUTH|`` per site, ms a step), then
    AutoNormal (4 particles, 50 steps);
12. SMC on the bench flat route, 1024 particles and 5 mutation steps from a
    N(0, 0.2) base: beta = 1 reached within ``max_stages``, the log
    evidence and the particles finite and inside their supports, the peak
    memory;
13. the kernels line (one JSON object), then the contract line
    ``{"ok": true, "device": {...}}``, last on stdout.

K1 is also held against its plain version at the config route's shapes
``(276, 8000)`` and ``(4, 46770)`` in phase 3.  Launch counts are set to 0
just before each route is driven (the flat route's gradients and NUTS run;
the streamed route's NUTS run; the B-spline route's
``run_bspline_analysis``; the config route's ``run_config`` and its
posterior-predictive site) and read just after: K1's from the flat route,
K2's from the streamed route (where K1 must not run), K3's from the B-spline
route (where K1 must not run either), K1's again from the config route,
where it must launch exactly twice per model evaluation and K2 and K3 not
at all, and so under HMC, SVI and SMC and on the library model's log route,
each counted on its own (a model evaluation: one run of the model, counted
by its ``log_likelihood`` site).

Every NUTS run goes through the default scheduler, the async one (16 chains
on the flat and streamed routes, 8 on the B-spline route, 4 on the config
route); each checks that its model runs are those outside the transition
loop (a run with no transitions from the same seed and starts) plus the
async formula for its ``num_steps``, one host read a round, and prints the
sync formula's count beside it.

Any failure raises, with a traceback and a non-zero exit code; no phase
catches its own failure.  Without CUDA the script exits non-zero before
printing any result.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager
from types import SimpleNamespace

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import torch  # noqa: E402

from gwinferno_tpu_torch.cosmology import PLANCK_2015_LVK_Cosmology as COSMO  # noqa: E402
from gwinferno_tpu_torch.infer import MCMC  # noqa: E402
from gwinferno_tpu_torch.infer import NUTS  # noqa: E402
from gwinferno_tpu_torch.infer import SMC  # noqa: E402
from gwinferno_tpu_torch.infer import SVI  # noqa: E402
from gwinferno_tpu_torch.infer import Adam  # noqa: E402
from gwinferno_tpu_torch.infer import AutoDelta  # noqa: E402
from gwinferno_tpu_torch.infer import AutoNormal  # noqa: E402
from gwinferno_tpu_torch.infer import Trace_ELBO  # noqa: E402
from gwinferno_tpu_torch.infer import find_map  # noqa: E402
from gwinferno_tpu_torch.infer.hmc_util import find_reasonable_step_size  # noqa: E402
from gwinferno_tpu_torch.infer.hmc_util import identity_mass_matrix  # noqa: E402
from gwinferno_tpu_torch.infer.nuts import nuts_init  # noqa: E402
from gwinferno_tpu_torch.infer.smc import _ess as smc_ess  # noqa: E402
from gwinferno_tpu_torch.infer.smc import _incremental_logw as smc_incremental_logw  # noqa: E402
from gwinferno_tpu_torch.infer.diagnostics import effective_sample_size  # noqa: E402
from gwinferno_tpu_torch.infer.diagnostics import split_rhat  # noqa: E402
from gwinferno_tpu_torch.models.parametric.parametric import PowerlawRedshiftModel  # noqa: E402
from gwinferno_tpu_torch.ops._build import build_all  # noqa: E402
from gwinferno_tpu_torch.ops import fused  # noqa: E402
from gwinferno_tpu_torch.ops.fused import DLSE_KERNEL  # noqa: E402
from gwinferno_tpu_torch.ops.fused import FLW_KERNEL  # noqa: E402
from gwinferno_tpu_torch.ops.fused import _dlse_torch  # noqa: E402
from gwinferno_tpu_torch.ops.fused import double_logsumexp  # noqa: E402
from gwinferno_tpu_torch.ops import streamed  # noqa: E402
from gwinferno_tpu_torch.ops.streamed import STREAMED_BWD_KERNEL  # noqa: E402
from gwinferno_tpu_torch.ops.streamed import STREAMED_FWD_KERNEL  # noqa: E402
from gwinferno_tpu_torch.pipeline.bench_model import FIDUCIAL_INIT  # noqa: E402
from gwinferno_tpu_torch.pipeline.bench_model import MMAX  # noqa: E402
from gwinferno_tpu_torch.pipeline.bench_model import MMIN  # noqa: E402
from gwinferno_tpu_torch.pipeline.bench_model import TRUTH  # noqa: E402
from gwinferno_tpu_torch.pipeline.bench_model import BenchModel  # noqa: E402
from gwinferno_tpu_torch.pipeline.bench_model import jittered_init  # noqa: E402
from gwinferno_tpu_torch.pipeline.bench_model import beta_ab  # noqa: E402
from gwinferno_tpu_torch.pipeline.bspline_model import COEF_SITES  # noqa: E402
from gwinferno_tpu_torch.pipeline.bspline_model import bank_log_weights  # noqa: E402
from gwinferno_tpu_torch.pipeline.bspline_model import build_bspline_models  # noqa: E402
from gwinferno_tpu_torch.pipeline.bspline_model import model_from_args  # noqa: E402
from gwinferno_tpu_torch.pipeline.bspline_model import run_bspline_analysis  # noqa: E402
from gwinferno_tpu_torch import ppl  # noqa: E402
from gwinferno_tpu_torch.distributions import per_chain  # noqa: E402
from gwinferno_tpu_torch.pipeline.analysis import hierarchical_likelihood  # noqa: E402
from gwinferno_tpu_torch.pipeline.cli import DETERMINISTIC_SITES  # noqa: E402
from gwinferno_tpu_torch.pipeline.cli import model_from_reader  # noqa: E402
from gwinferno_tpu_torch.pipeline.cli import run_config  # noqa: E402
from gwinferno_tpu_torch.pipeline.parser import ConfigReader  # noqa: E402
from gwinferno_tpu_torch.models.bsplines import separable  # noqa: E402
from gwinferno_tpu_torch.models.bsplines import single  # noqa: E402
from gwinferno_tpu_torch.models.parametric.parametric import default_spin_tilt  # noqa: E402
from gwinferno_tpu_torch.models.parametric.parametric import independent_spin_magnitude_beta_dist  # noqa: E402
from gwinferno_tpu_torch.models.parametric.parametric import independent_spin_tilt  # noqa: E402
from gwinferno_tpu_torch.models.parametric.parametric import plpeak_primary_ratio_pdf  # noqa: E402
from gwinferno_tpu_torch.models.parametric.parametric import powerlaw_primary_ratio_falloff_pdf  # noqa: E402
from gwinferno_tpu_torch.models.spline_perturbation import PowerlawBasisSplinePrimaryPowerlawRatio  # noqa: E402
from gwinferno_tpu_torch.models.spline_perturbation import PowerlawBasisSplinePrimaryRatio  # noqa: E402
from gwinferno_tpu_torch.postprocess import calculations  # noqa: E402
from gwinferno_tpu_torch.pipeline.utils import bspline_mass_prior  # noqa: E402
from gwinferno_tpu_torch.pipeline.utils import bspline_redshift_prior  # noqa: E402
from gwinferno_tpu_torch.pipeline.utils import bspline_spin_prior  # noqa: E402
from gwinferno_tpu_torch.pipeline.utils import setup_bspline_mass_models  # noqa: E402
from gwinferno_tpu_torch.pipeline.utils import setup_bspline_spin_models  # noqa: E402
from gwinferno_tpu_torch.pipeline.utils import setup_powerlaw_spline_redshift_model  # noqa: E402
from gwinferno_tpu_torch.pipeline.utils import to_tensors  # noqa: E402
from gwinferno_tpu_torch.ppl import ModelPotential  # noqa: E402
from gwinferno_tpu_torch.ppl.handlers import Messenger  # noqa: E402
from gwinferno_tpu_torch.ppl.infer_util import find_valid_initial_params  # noqa: E402
from gwinferno_tpu_torch.ppl.transforms import ExpTransform  # noqa: E402
from gwinferno_tpu_torch.ppl.transforms import IntervalTransform  # noqa: E402
from gwinferno_tpu_torch.utils.checkpoint import load_checkpoint  # noqa: E402
from gwinferno_tpu_torch.utils.checkpoint import save_checkpoint  # noqa: E402

# the committed catalog's size and attributes (tests/data/pe_inj_synthetic.h5)
N_EVENTS, N_SAMPLES, N_FOUND = 69, 8000, 46770
TOTAL_GENERATED, ANALYSIS_TIME = 9.6e7, 1.0
N_CHAINS, MAX_TREE_DEPTH = 16, 6

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 non-tensor FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# K1's arithmetic per element: compare, subtract, exp, two adds, a multiply
# and the rare rescale -- counted as 8 operations
K1_OPS_PER_ELEMENT = 8
# the earlier designs' times (ms, float32) of K1 (one block a row) and K3
# (one sample a thread, a separate merge kernel), measured by this script's
# K1 and K3 phases on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md section
# 6), printed beside each launch's time now; the unfused B-spline route's K1
# calls were not timed then
EARLIER_MS = {
    "K1 flat_pe": 0.0395, "K1 flat_inj": 0.0869,
    "K3 PE C=8": 0.2317, "K3 injections C=8": 0.1039, "K3 PE C=16": 0.3399, "K3 injections C=16": 0.1181,
}
# special-function unit results/s: 16 per clock per SM for compute
# capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
# throughput: exp2, log2, reciprocal), x 132 SMs x 1.98 GHz, the boost clock
# behind the 67 TFLOP/s above (132 SMs x 128 lanes x 2 flops x 1.98 GHz)
SFU_PER_S = 16 * 132 * 1.98e9
# K2's work per sample in support, per chain, counted from csrc/streamed.cu:
# transcendental calls (exp, log, log1p, expm1; each needs at least one
# special-function result) and the other float operations.  Forward: q norm
# 2, three logaddexps 2 each, the online lse 1.  Backward: q norm 2 and its
# derivative 1, three logaddexps 4 each (with both responsibilities), the
# weight 2.
K2_FWD_SFU, K2_BWD_SFU = 9, 17
K2_FWD_OPS, K2_BWD_OPS = 60, 140

# the B-spline production model (tools/run_bspline_production.py): knots per
# block, mass range (pipeline/utils.py defaults), 8 chains, whitened
# coefficient priors, target acceptance 0.9, diagonal mass
BSPLINE_KNOTS = dict(m_nsplines=50, q_nsplines=30, a_nsplines=16, tilt_nsplines=16, z_nsplines=20)
BSPLINE_MMIN, BSPLINE_MMAX = 3.0, 100.0
BSPLINE_CHAINS = 8

# the parsed form of examples/config_files/config_validation.yml (the
# card's machine has no PyYAML; tests/test_torch_config.py holds this dict
# to the file)
CONFIG_VALIDATION = {
    "label": "config_cli_validation",
    "outdir": "docs/config_cli_r5/run",
    "models": {
        "mass_1": {
            "model": "gwinferno.numpyro_distributions.PowerlawSmoothedPowerlaw",
            "hyper_params": {
                "alpha": {"prior": "numpyro.distributions.Normal", "prior_params": {"loc": 0.0, "scale": 3.0}},
                "minimum": {"prior": "numpyro.distributions.Uniform", "prior_params": {"low": 3.0, "high": 20.0}},
                "maximum": {"prior": "numpyro.distributions.Uniform", "prior_params": {"low": 40.0, "high": 95.0}},
                "alpha_min": {"prior": "numpyro.distributions.Uniform", "prior_params": {"low": 0.0, "high": 6.0}},
                "alpha_max": {"prior": "numpyro.distributions.Uniform", "prior_params": {"low": 3.0, "high": 25.0}},
                "low": {"value": 2.0},
                "high": {"value": 100.0},
            },
        },
        "mass_ratio": {
            "model": "gwinferno.numpyro_distributions.Powerlaw",
            "hyper_params": {
                "alpha": {"prior": "numpyro.distributions.Normal", "prior_params": {"loc": 0.0, "scale": 3.0}},
                "minimum": {"value": 0.02},
                "maximum": {"value": 1.0},
            },
        },
        "redshift": {
            "model": "gwinferno.numpyro_distributions.PowerlawRedshift",
            "hyper_params": {
                "lamb": {"prior": "numpyro.distributions.Normal", "prior_params": {"loc": 0.0, "scale": 3.0}},
                "maximum": {"value": 2.3},
            },
        },
    },
    "sampler": {
        "kernel": "NUTS",
        "kernel_kwargs": {"dense_mass": True},
        "mcmc_kwargs": {"num_warmup": 500, "num_samples": 500, "num_chains": 4, "max_steps_per_call": 25},
    },
    "likelihood": {
        "marginalize_selection": False, "min_neff_cut": True, "max_variance_cut": False,
        "posterior_predictive_check": True,
    },
    "data": {"pe_inj_file": "tests/data/pe_inj_config_val.h5"},
}
# the config route's starts: the catalog's population in the config model's
# terms (TRUTH's powerlaw slope, breaks bracketing its peak, its q slope and
# redshift evolution), jittered per chain by the half-widths beside them
CONFIG_INIT = {
    "mass_1_alpha": (-2.35, 0.3), "mass_1_minimum": (8.0, 1.0), "mass_1_maximum": (70.0, 5.0),
    "mass_1_alpha_min": (2.0, 0.5), "mass_1_alpha_max": (10.0, 2.0), "mass_ratio_alpha": (1.0, 0.3),
    "redshift_lamb": (1.7, 0.5), "unscaled_rate": (69.0, 10.0),
}
CONFIG_CHAINS = (4, 16)

# the other engines: HMC's trajectory length is set so that a transition
# costs at most this many leapfrogs at the step size its search finds (NUTS
# at depth 6 costs up to 63); SVI's steps and rate (AutoDelta from
# FIDUCIAL_INIT, then AutoNormal); SMC at the JAX package's defaults
HMC_LEAPFROGS = 64
# HMC's transitions (30 + 20 until the library phase came; its warmup is the
# smoke's costliest phase); the earlier routes' are --warmup and --samples
HMC_WARMUP, HMC_SAMPLES = 20, 10
SVI_STEPS, SVI_LR, SVI_NORMAL_STEPS, SVI_PARTICLES = 300, 0.02, 50, 4
SMC_PARTICLES, SMC_MUTATIONS = 1024, 5
# SMC's base is N(0, SMC_BASE_SCALE) in unconstrained space.  At the JAX
# package's default scale of 2 nearly all of the base's particles sit on the
# bench model's n_eff walls (potential 3.4e38), and the bisection cannot try
# a beta below 1e-5, where every wall particle already weighs 0: the ESS is
# the off-wall count, under the 50% target, and the run never leaves
# beta = 0.  smc_base_walls measures both at each scale (PERF.md).
SMC_BASE_SCALE = 0.2
RESUME_SAMPLES = 10
# the scheduler phase's transitions on the flat route
SCHED_WARMUP, SCHED_SAMPLES = 5, 5

# synthetic search: proxy SNR ~ Mc_det^(5/6) / DL with a random projection
D0_MPC = 1600.0
ZMAX_DRAW = 1.5


def log(msg):
    print(msg, flush=True)


@contextmanager
def phase(name):
    log(f"[phase] {name}: start")
    t0 = time.perf_counter()
    yield
    log(f"[phase] {name}: done in {time.perf_counter() - t0:.2f} s")


# ----------------------------------------------------------------- catalog


def _powerlaw_icdf(u, alpha, lo, hi):
    ap1 = alpha + 1.0
    return (lo**ap1 + u * (hi**ap1 - lo**ap1)) ** (1.0 / ap1)


def _powerlaw_pdf(x, alpha, lo, hi):
    ap1 = alpha + 1.0
    return ap1 * x**alpha / (hi**ap1 - lo**ap1)


def _truncnorm(rng, loc, sig, lo, hi, shape):
    """N(loc, sig) truncated to [lo, hi] by rejection (loc broadcastable)."""
    loc = np.broadcast_to(loc, shape)
    x = loc + sig * rng.standard_normal(shape)
    bad = (x < lo) | (x > hi)
    while bad.any():
        x[bad] = loc[bad] + sig * rng.standard_normal(int(bad.sum()))
        bad = (x < lo) | (x > hi)
    return x


def _detected(rng, m1, q, z):
    m2 = q * m1
    mc = (m1 * m2) ** 0.6 / (m1 + m2) ** 0.2
    snr = 8.0 * (mc * (1 + z) / 25.0) ** (5.0 / 6.0) * (D0_MPC / COSMO.z2DL(z))
    return snr * rng.uniform(size=m1.shape) ** (1.0 / 3.0) > 8.0


def make_catalog(seed, n_events=N_EVENTS, n_samples=N_SAMPLES, n_found=N_FOUND):
    """A synthetic catalog in the committed catalog's layout.

    Events: drawn from the bench's ``TRUTH`` population and kept if the
    proxy search detects them; each gets a PE cloud (lognormal in m1 and z,
    Gaussian in q and the spins truncated to their supports) whose sampling
    prior is flat in q and the spins and flat in log m1 and log z, so the
    prior row is ``1/(m1 z)``.  Injections: drawn from a broad known pdf
    (powerlaw m1 and q, z proportional to dVc/dz (1+z)^0.7, uniform spins)
    and kept if detected; the prior row is that pdf.
    """
    rng = np.random.default_rng(seed)
    t = TRUTH
    zgrid = np.linspace(1e-4, ZMAX_DRAW, 4000)
    dvdz = COSMO.dVcdz(zgrid)

    def z_sampler(lamb):
        pz = dvdz * (1 + zgrid) ** (lamb - 1.0)
        cdf = np.concatenate([[0.0], np.cumsum(0.5 * (pz[1:] + pz[:-1]) * np.diff(zgrid))])
        return cdf / cdf[-1], pz / cdf[-1]

    # --- events from the truth population, through the search
    cdf_pop, _ = z_sampler(t["lamb"])
    aa, bb = beta_ab(t["mu_a1"], t["var_a1"])
    keep = []
    while sum(len(k[0]) for k in keep) < n_events:
        n = 100_000
        peak = rng.uniform(size=n) < t["lambda_m"]
        m1 = np.where(
            peak,
            _truncnorm(rng, t["mu_peak"], t["sig_peak"], 5.0, 100.0, (n,)),
            _powerlaw_icdf(rng.uniform(size=n), t["alpha"], 5.0, 100.0),
        )
        q = _powerlaw_icdf(rng.uniform(size=n), t["beta"], 5.0 / m1, 1.0)
        z = np.interp(rng.uniform(size=n), cdf_pop, zgrid)
        a1, a2 = rng.beta(aa, bb, n), rng.beta(aa, bb, n)
        ct = [
            np.where(rng.uniform(size=n) < t["lambda_ct1"], _truncnorm(rng, 1.0, t["sig_ct1"], -1, 1, (n,)), rng.uniform(-1, 1, n))
            for _ in range(2)
        ]
        det = _detected(rng, m1, q, z)
        keep.append([x[det] for x in (m1, q, z, a1, a2, ct[0], ct[1])])
    m1, q, z, a1, a2, ct1, ct2 = (np.concatenate([k[i] for k in keep])[:n_events] for i in range(7))

    E, S = n_events, n_samples

    def cloud(x, sig, lo, hi):
        x_obs = x + sig * rng.standard_normal(E)
        return _truncnorm(rng, x_obs[:, None], sig, lo, hi, (E, S))

    m1_s = np.exp(np.log(m1)[:, None] + 0.08 * (rng.standard_normal(E)[:, None] + rng.standard_normal((E, S))))
    z_s = np.exp(np.log(z)[:, None] + 0.08 * (rng.standard_normal(E)[:, None] + rng.standard_normal((E, S))))
    pedict = {
        "mass_1": m1_s,
        "mass_ratio": cloud(q, 0.08, 0.02, 1.0),
        "redshift": z_s,
        "a_1": cloud(a1, 0.14, 0.0, 1.0),
        "a_2": cloud(a2, 0.14, 0.0, 1.0),
        "cos_tilt_1": cloud(ct1, 0.2, -1.0, 1.0),
        "cos_tilt_2": cloud(ct2, 0.2, -1.0, 1.0),
        "prior": 1.0 / (m1_s * z_s),
    }

    # --- injections from a broad known pdf, through the same search
    cdf_inj, pz_inj = z_sampler(1.7)
    found = []
    while sum(len(f["mass_1"]) for f in found) < n_found:
        n = 1_000_000
        m1 = _powerlaw_icdf(rng.uniform(size=n), t["alpha"], 5.0, 100.0)
        q = _powerlaw_icdf(rng.uniform(size=n), t["beta"], 5.0 / m1, 1.0)
        z = np.interp(rng.uniform(size=n), cdf_inj, zgrid)
        det = _detected(rng, m1, q, z)
        pdf = _powerlaw_pdf(m1, t["alpha"], 5.0, 100.0) * _powerlaw_pdf(q, t["beta"], 5.0 / m1, 1.0)
        pdf = pdf * np.interp(z, zgrid, pz_inj) * 0.25  # uniform a in [0,1], ct in [-1,1]
        found.append({
            "mass_1": m1[det], "mass_ratio": q[det], "redshift": z[det],
            "a_1": rng.uniform(size=n)[det], "a_2": rng.uniform(size=n)[det],
            "cos_tilt_1": rng.uniform(-1, 1, n)[det], "cos_tilt_2": rng.uniform(-1, 1, n)[det],
            "prior": pdf[det],
        })
    injdict = {k: np.concatenate([f[k] for f in found])[:n_found] for k in found[0]}
    constants = {"total_inj": TOTAL_GENERATED, "obs_time": ANALYSIS_TIME, "nObs": n_events}
    return pedict, injdict, constants


def k2_edge_case(seed, rows=6, n_samples=700, zmax=1.2):
    """A small bank that drives every branch of K2's chain, made from
    ``seed`` with numpy: ``(banks, valid, zmax)``.

    Samples fall below ``mmin / m1`` in q, outside ``[MMIN, MMAX]`` in m1
    (``mmin / m1 > 1``), outside ``[-1, 1]`` in the tilts and above
    ``zmax``; row 0 has spin magnitudes exactly 0 and 1 and a padded tail
    (edge-replicated, marked invalid); the second last row has every m1
    below ``MMIN`` (all ``-inf``); the last row is in support everywhere but
    has every sample above ``zmax`` (the redshift floor on every sample).
    """
    rng = np.random.default_rng(seed)
    shape = (rows, n_samples)
    m1 = rng.uniform(3.0, 110.0, shape)
    q = rng.uniform(0.01, 1.05, shape)
    a1, a2 = rng.uniform(-0.05, 1.05, shape), rng.uniform(-0.05, 1.05, shape)
    a1[0, :4], a1[0, 4:8], a2[0, 8:12], a2[0, 12:16] = 0.0, 1.0, 0.0, 1.0
    ct1, ct2 = rng.uniform(-1.1, 1.1, shape), rng.uniform(-1.1, 1.1, shape)
    z = rng.uniform(0.01, 1.5, shape)
    m1[-2] = rng.uniform(1.0, 4.9, n_samples)
    m1[-1] = rng.uniform(6.0, 90.0, n_samples)
    q[-1] = rng.uniform(0.0, 1.0, n_samples) * (1.0 - 5.0 / m1[-1]) + 5.0 / m1[-1]
    a1[-1], a2[-1] = rng.uniform(0.01, 0.99, (2, n_samples))
    ct1[-1], ct2[-1] = rng.uniform(-0.99, 0.99, (2, n_samples))
    z[-1] = rng.uniform(zmax + 0.01, 1.5, n_samples)
    banks = {
        "mass_1": m1, "mass_ratio": q, "redshift": z, "a_1": a1, "a_2": a2, "cos_tilt_1": ct1, "cos_tilt_2": ct2,
        "log_prior": rng.normal(-3.0, 1.0, shape), "log_dvdz": rng.normal(22.0, 0.5, shape), "log1pz": np.log1p(z),
    }
    valid = np.ones(shape)
    pad = n_samples - 50
    valid[0, pad:] = 0.0
    for v in banks.values():
        v[0, pad:] = v[0, pad - 1]
    return banks, valid, zmax


def k2_edge_theta(num_chains, dtype=torch.float64, device="cpu"):
    """Hyperparameters ``{name: (num_chains,)}`` for :func:`k2_edge_case`:
    beta cycles through -1.5, -1 (the logarithmic q norm), -0.5 and 1.2, and
    one chain in four has a spin-magnitude alpha below 1 (``+inf`` at a = 0)."""
    c = np.arange(num_chains)
    th = {
        "alpha": -2.3 + 0.1 * c, "beta": np.array([-1.5, -1.0, -0.5, 1.2])[c % 4], "mu_peak": 35.0 - c,
        "sig_peak": 5.0 + 0.2 * c, "lambda_m": 0.25 + 0.01 * c,
        "alpha_a1": np.where(c % 4 == 3, 0.8, 1.6 + 0.05 * c), "beta_a1": 2.4 + 0.05 * c,
        "alpha_a2": 1.7 + 0.05 * c, "beta_a2": 2.2 + 0.05 * c,
        "lambda_ct1": 0.7 - 0.02 * c, "lambda_ct2": 0.6 + 0.02 * c, "sig_ct1": 0.5 + 0.05 * c, "sig_ct2": 0.6 + 0.05 * c,
        "lamb": 1.7 - 0.1 * c, "z_lognorm": 3.0 + 0.1 * c,
    }
    return {k: torch.as_tensor(np.array(np.broadcast_to(v, (num_chains,))), dtype=dtype, device=device) for k, v in th.items()}


def k3_edge_case(seed, num_chains=4, n_events=4, n_samples=2300, n_rows=6):
    """A small bank for K3, made from ``seed`` with numpy: ``(coefs (C, K),
    design (K, E*S), nlp (E*S,), E, S)``, float64.

    Design entries lie in [0, 1) as B-spline bases do; about one sample in
    ten is masked (``nlp = -inf``); event 0's first 600 samples are masked,
    so its leading tiles are empty (ROADMAP F3); event 2 is masked
    entirely; ``S`` is a multiple of no tile size.
    """
    rng = np.random.default_rng(seed)
    E, S = n_events, n_samples
    coefs = rng.normal(0.0, 1.0, (num_chains, n_rows))
    design = rng.uniform(0.0, 1.0, (n_rows, E * S))
    nlp = rng.normal(-3.0, 1.0, E * S)
    nlp[rng.uniform(size=E * S) < 0.1] = -np.inf
    nlp2 = nlp.reshape(E, S)
    nlp2[0, :600] = -np.inf
    nlp2[2 % E] = -np.inf
    return coefs, design, nlp, E, S


# ----------------------------------------------------------------- card


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps=30):
    """Median device time of ``fn`` in ms (CUDA events).  Before each launch
    a 64 MB buffer is read, which leaves the 50 MB L2 cache holding clean
    lines of something else: the input comes from device memory.  Then the
    card sleeps ~1 ms while the host enqueues the events and ``fn``'s
    launches, so the events bracket device work, not the host's enqueueing
    (a plain version that enqueues for longer than that is timed with its
    host time included)."""
    flush = torch.ones(16 * 2**20, dtype=torch.float32, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.sum()
        torch.cuda._sleep(2_000_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _max_err(got, want):
    """max |got - want| over entries, with equal infinities counting 0."""
    same_inf = torch.isinf(want) & (got == want)
    if not bool((torch.isinf(got) == torch.isinf(want)).all()):
        raise AssertionError("a kernel's infinities differ from its plain version's")
    return float(torch.where(same_inf, 0.0, (got - want).abs()).max())


def _earlier(key, ms):
    was = EARLIER_MS.get(key)
    return f"earlier design {was:.4f} ms ({was / ms:.2f}x)" if was else "earlier design not measured"


def check_k1(gen):
    """K1 against its plain version on the flat route's shapes (C = 16), the
    unfused B-spline route's (C = 8), the config route's (C = 4), SMC's
    (1024 particles: the PE call's last row starts 5.65e8 elements in) and
    two edge shapes, float32 and
    float64, gradient included; two launches on the same input must give
    identical bits.  At the main path's shapes, float32: kernel, plain,
    library and bound times beside the earlier design's, the geometry and
    the kernel's registers.  Returns the per-shape f32 results."""
    main_shapes = [
        ("flat_pe", (N_CHAINS * N_EVENTS, N_SAMPLES)), ("flat_inj", (N_CHAINS, N_FOUND)),
        ("bspline_pe", (BSPLINE_CHAINS * N_EVENTS, N_SAMPLES)), ("bspline_inj", (BSPLINE_CHAINS, N_FOUND)),
        ("config_pe", (CONFIG_CHAINS[0] * N_EVENTS, N_SAMPLES)), ("config_inj", (CONFIG_CHAINS[0], N_FOUND)),
        ("smc_pe", (SMC_PARTICLES * N_EVENTS, N_SAMPLES)), ("smc_inj", (SMC_PARTICLES, N_FOUND)),
    ]
    extra_shapes = [("all_-inf_rows", (8, 1000)), ("part_-inf_rows", (64, 3000))]
    tol = {torch.float32: dict(atol=1e-4, rtol=0.0), torch.float64: dict(atol=0.0, rtol=1e-12)}
    gtol = {torch.float32: dict(atol=1e-7, rtol=1e-4), torch.float64: dict(atol=1e-16, rtol=1e-10)}
    results = {}
    for dtype in (torch.float32, torch.float64):
        info = fused.dlse_kernel_info(dtype)
        log(f"  K1 {str(dtype)[6:]}: {info['registers']} registers a thread, {info['local_bytes']} spill bytes, "
            f"{info['blocks_per_sm']} blocks resident per SM")
        for name, shape in main_shapes + extra_shapes:
            x = 10.0 + 3.0 * torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
            if name == "all_-inf_rows":
                x[0] = -math.inf
                x[3] = -math.inf
            elif name == "part_-inf_rows":
                x[torch.rand(shape, generator=gen, device="cuda") < 0.3] = -math.inf
                x[5] = -math.inf
            got = double_logsumexp(x)
            want = _dlse_torch(x)
            again = double_logsumexp(x)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"K1 {name} {dtype}: two launches on the same input differ")
            err = max(_max_err(got[0], want[0]), _max_err(got[1], want[1]))
            t = tol[dtype]
            for g, w in zip(got, want):
                finite = torch.isfinite(w)
                torch.testing.assert_close(g[finite], w[finite], **t)

            # gradient of a weighted sum over the rows that are not all -inf
            w1 = torch.rand(shape[0], generator=gen, device="cuda", dtype=dtype)
            w2 = torch.rand(shape[0], generator=gen, device="cuda", dtype=dtype)
            live = torch.isfinite(want[0])
            grads = []
            for fn in (double_logsumexp, _dlse_torch):
                xg = x.clone().requires_grad_(True)
                l1, l2 = fn(xg)
                grads.append(torch.autograd.grad((w1 * l1)[live].sum() + (w2 * l2)[live].sum(), xg)[0])
            g_kernel, g_plain = grads
            g_plain = torch.nan_to_num(g_plain, nan=0.0)  # torch's own backward is NaN on all--inf rows
            if not bool(torch.isfinite(g_kernel).all()):
                raise AssertionError(f"K1 gradient not finite ({name}, {dtype})")
            torch.testing.assert_close(g_kernel, g_plain, **gtol[dtype])
            log(f"  K1 {name} {tuple(shape)} {str(dtype)[6:]}: max_abs_err={err:.3e}, repeatable, ok")
            if dtype == torch.float32 and name in dict(main_shapes):
                R, N = shape
                k_ms = time_ms(lambda: double_logsumexp(x))
                p_ms = time_ms(lambda: _dlse_torch(x))
                lib_ms = time_ms(lambda: (torch.logsumexp(x, -1), torch.logsumexp(2.0 * x, -1)))
                bytes_ms = (4 * R * N + 2 * 4 * R) / HBM_BYTES_PER_S * 1e3
                ops_ms = K1_OPS_PER_ELEMENT * R * N / F32_FLOP_PER_S * 1e3
                results[name] = {
                    "shape": shape, "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                    "library_ms": lib_ms, "bound_ms": max(bytes_ms, ops_ms),
                    "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                }
                g = fused.dlse_device_geometry(x)
                log(
                    f"  K1 {name} {tuple(shape)} f32: kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
                    f"library_ms={lib_ms:.4f} bound_ms={max(bytes_ms, ops_ms):.4f} "
                    f"({results[name]['bound_by']}; {bytes_ms / k_ms:.1%} of the bound); {_earlier('K1 ' + name, k_ms)}"
                )
                log(f"    geometry: tile {g.tile}, {g.n_tiles} tiles a row, {g.blocks} blocks ({g.resident} resident "
                    f"per SM, {g.waves:.2f} waves), {g.per_thread} vectors a thread")
    return results


# ----------------------------------------------------------------- main path


def check_against_cpu(pedict, injdict, constants, params, n_events=10, n_found=10000):
    """The card's float32 potential and gradient against a float64 CPU
    evaluation (K1's plain version) of the same model on a slice of the
    catalog: the first ``n_events`` events with all their samples (fewer
    samples would put every event's n_eff under the Nobs wall) and the first
    ``n_found`` injections."""
    pe = {k: v[:n_events] for k, v in pedict.items()}
    inj = {k: v[:n_found] for k, v in injdict.items()}
    const = dict(constants, nObs=n_events)
    out = []
    for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        zm = PowerlawRedshiftModel(pe["redshift"], inj["redshift"], device=dev, dtype=dtype)
        pot = ModelPotential(BenchModel(pe, inj, const, zm, device=dev, dtype=dtype), device=dev, dtype=dtype)
        z = pot.unconstrain({k: v.to(dev, dtype) for k, v in params.items()}, N_CHAINS)
        out.append([t.double().cpu() for t in pot.value_and_grad(z)])
    (u32, g32), (u64, g64) = out
    if not (torch.isfinite(u64).all() and (u64.abs() < 1e30).all()):
        raise AssertionError(f"reference potential off the likelihood walls expected, got {u64}")
    torch.testing.assert_close(u32, u64, rtol=1e-4, atol=1e-3)
    rel = float((g32 - g64).norm() / g64.norm())
    if not rel < 1e-3:
        raise AssertionError(f"float32 card gradient differs from the float64 CPU one: relative error {rel:.3e}")
    log(f"  card f32 vs CPU f64 on {n_events} events x {N_SAMPLES} + {n_found} injections: "
        f"max|dU|={float((u32 - u64).abs().max()):.3e}, grad rel err={rel:.3e}")


def run_nuts(model, args, init, label):
    """A 16-chain dense-mass NUTS run (depth 6) of ``model`` from ``init``
    (the default scheduler: async); checks that every site's samples are
    finite and prints the run's summary.  Returns the MCMC object and its
    model runs."""
    dev, dtype = torch.device("cuda"), torch.float32
    with phase(f"NUTS on the {label} route: {args.warmup} warmup + {args.samples} samples, {N_CHAINS} chains, "
               f"dense mass, depth {MAX_TREE_DEPTH}"), ModelRuns() as runs:
        mcmc = MCMC(
            NUTS(model, dense_mass=True, max_tree_depth=MAX_TREE_DEPTH),
            num_warmup=args.warmup, num_samples=args.samples, num_chains=N_CHAINS, device=dev, dtype=dtype,
        )
        mcmc.run(args.seed, init_params=flat_starts(init))
        torch.cuda.synchronize()
    samples = mcmc.get_samples(group_by_chain=True)
    extra = mcmc.get_extra_fields()
    if len(samples) != 15:
        raise AssertionError(f"{label} route: {len(samples)} sample sites, want 15")
    for k, v in samples.items():
        if tuple(v.shape) != (N_CHAINS, args.samples) or not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{label} route, site {k}: samples of shape {tuple(v.shape)} not finite")
    ess = {k: effective_sample_size(v) for k, v in samples.items()}
    rhat = {k: split_rhat(v) for k, v in samples.items()}
    log(
        f"  timings: init {mcmc.timings['init']:.2f} s, warmup {mcmc.timings.get('warmup', 0.0):.2f} s, "
        f"sampling {mcmc.timings['sample']:.2f} s"
    )
    log(
        f"  mean tree depth {float(extra['tree_depth'].double().mean()):.2f}, "
        f"divergences {int(extra['diverging'].sum())}, mean accept {float(extra['accept_prob'].mean()):.3f}, "
        f"min ESS {min(ess.values()):.1f}, max split-Rhat {max(rhat.values()):.3f}, "
        f"leapfrogs in sampling {int(extra['num_steps'].sum())}"
    )
    log("  posterior means: " + ", ".join(f"{k}={float(v.double().mean()):.3f}" for k, v in sorted(samples.items())))
    return mcmc, runs.runs


def flat_starts(init):
    return {k: v.to("cuda", torch.float32) for k, v in init.items()}


def flat_route(args, gen):
    """The flat route (the default): catalog, reference check, potential and
    gradient, NUTS.  Returns ``(K1 launches, catalog, init, potential, z0)``."""
    dev, dtype = torch.device("cuda"), torch.float32
    with phase("catalog"):
        pedict, injdict, constants = make_catalog(args.seed)
        log(f"  {N_EVENTS} events x {N_SAMPLES} PE samples, {len(injdict['mass_1'])} found injections")
    init = jittered_init(N_CHAINS, gen, dtype=torch.float64)
    with phase("reference check"):
        check_against_cpu(pedict, injdict, constants, init)
    with phase("model build"):
        z_model = PowerlawRedshiftModel(pedict["redshift"], injdict["redshift"], device=dev, dtype=dtype)
        model = BenchModel(pedict, injdict, constants, z_model, device=dev, dtype=dtype)
        potential = ModelPotential(model, device=dev, dtype=dtype)
        z0 = potential.unconstrain({k: v.to(dev, dtype) for k, v in init.items()}, N_CHAINS)
        torch.cuda.synchronize()

    DLSE_KERNEL.launches = 0
    with phase(f"potential + gradient, {N_CHAINS} chains"):
        pe, grad = potential.value_and_grad(z0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            potential.value_and_grad(z0)
        torch.cuda.synchronize()
        log(f"  one batched potential + gradient: {(time.perf_counter() - t0) / 5 * 1e3:.2f} ms (host clock, mean of 5)")
        if not (torch.isfinite(pe).all() and torch.isfinite(grad).all()):
            raise AssertionError("potential or gradient not finite at the jittered fiducial starts")
        if not bool((pe.abs() < 1e30).all()):
            raise AssertionError("fiducial starts sit on a likelihood wall")
        log(f"  potential range [{float(pe.min()):.3f}, {float(pe.max()):.3f}], |grad| max {float(grad.abs().max()):.3e}")
    mcmc, runs = run_nuts(model, args, init, "flat")
    launches = DLSE_KERNEL.launches
    if launches == 0:
        raise AssertionError("K1 was not launched on the flat route")
    log(f"  K1 launches on the flat route: {launches}")
    check_async_runs("flat", mcmc, runs, outside_loop_runs(mcmc, args.seed, init_params=flat_starts(init)))
    resume_flat(mcmc, model, args)
    scheduler_phase(model, args, init)
    return launches, (pedict, injdict, constants, z_model), init, potential, z0


def resume_flat(mcmc, model, args):
    """The flat route's NUTS run saved with ``save_checkpoint`` to a
    temporary file, loaded with ``load_checkpoint`` and resumed for
    ``RESUME_SAMPLES`` samples through ``post_warmup_state``: no warmup and
    no step-size search run (the model runs once for the starts' gradient,
    then ``max_c sum_t num_steps`` times, the async formula), the step size
    and inverse mass matrix carry over bit for bit, and the samples are
    finite."""
    with phase(f"resume the flat route's NUTS run from a checkpoint: {RESUME_SAMPLES} samples, {N_CHAINS} chains"):
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "flat_route.npz")
            save_checkpoint(path, mcmc)
            saved = load_checkpoint(path)
            size = os.path.getsize(path)
        resumed = MCMC(NUTS(model, dense_mass=True, max_tree_depth=MAX_TREE_DEPTH), num_warmup=args.warmup,
                       num_samples=RESUME_SAMPLES, num_chains=N_CHAINS, device="cuda", dtype=torch.float32)
        with ModelRuns() as runs:
            resumed.run(args.seed + 1, post_warmup_state=saved)
            torch.cuda.synchronize()
        steps = resumed.transition_steps
        rounds = 2 + loop_model_runs(steps, "async")
        log(f"  checkpoint {size} bytes; {runs.runs} model runs ({rounds} expected: the site probe, the starts' "
            f"gradient and the async loop's max over chains of its leapfrogs in {RESUME_SAMPLES} transitions; "
            f"the sync formula gives {2 + loop_model_runs(steps, 'sync')}); {resumed.host_reads} host reads; "
            f"timings {sorted(resumed.timings)}")
        if runs.runs != rounds or "warmup" in resumed.timings or resumed.host_reads != rounds - 2:
            raise AssertionError(f"the resumed run did more than sample: {runs.runs} model runs, {rounds} expected")
        for key in ("step_size", "inverse_mass_matrix"):
            if not torch.equal(resumed._adapt_info[key], mcmc._adapt_info[key]):
                raise AssertionError(f"the resumed run's {key} differs from the saved run's")
        samples = resumed.get_samples(group_by_chain=True)
        if not all(tuple(v.shape) == (N_CHAINS, RESUME_SAMPLES) and bool(torch.isfinite(v).all())
                   for v in samples.values()):
            raise AssertionError("the resumed run's samples are not finite")
        log(f"  step size and inverse mass matrix carried over bit for bit; {len(samples)} sites finite; "
            f"mean accept {float(resumed.get_extra_fields()['accept_prob'].mean()):.3f}")


# ----------------------------------------------------------------- K2


def k2_theta(init, z_model):
    """The bench chain's hyperparameters (``streamed.THETA``) at the
    constrained starts ``init``, float64 on the card."""
    th = {k: init[k].to("cuda", torch.float64) for k in ("alpha", "beta", "mu_peak", "sig_peak", "lambda_m",
                                                      "lambda_ct1", "lambda_ct2", "sig_ct1", "sig_ct2", "lamb")}
    th["alpha_a1"], th["beta_a1"] = beta_ab(init["mu_a1"].cuda(), init["var_a1"].cuda())
    th["alpha_a2"], th["beta_a2"] = beta_ab(init["mu_a2"].cuda(), init["var_a2"].cuda())
    th["z_lognorm"] = torch.log(z_model.normalization(th["lamb"].float())).double()
    return th


def _rel_err(got, want):
    """Per-chain relative error by norm of ``(C, n)`` gradients."""
    return (got.double() - want).norm(dim=1) / want.norm(dim=1)


def _k2_pair(bank, P64, P32, gen, label):
    """K2's forward and backward kernels (float64 and float32) against the
    float64 plain version on one bank, each held to its limit: float64
    1e-10 absolute on lse and 1e-10 relative (norm, per chain) on dP,
    float32 1e-4 on both.  Returns the float32 errors."""
    c64, flags = bank.columns(torch.float64, "cuda")
    c32, _ = bank.columns(torch.float32, "cuda")
    plain = streamed._streamed_fwd_torch(c64, flags, P64)
    k64 = streamed.streamed_fwd_cuda(c64, flags, P64)
    k32 = streamed.streamed_fwd_cuda(c32, flags, P32)
    l1, l2 = (torch.where(torch.isfinite(v), v, 0.0) for v in plain)
    C, rows = l1.shape
    g1 = torch.where(torch.isfinite(plain[0]), torch.rand(C, rows, generator=gen, device="cuda", dtype=torch.float64), 0.0)
    g2 = torch.where(torch.isfinite(plain[1]), torch.rand(C, rows, generator=gen, device="cuda", dtype=torch.float64) - 0.5, 0.0)
    d_plain = streamed._streamed_bwd_torch(c64, flags, P64, g1, g2, l1, l2)
    d64 = streamed.streamed_bwd_cuda(c64, flags, P64, g1, g2, l1, l2)
    lo = [v.float() for v in (g1, g2, l1, l2)]
    d32 = streamed.streamed_bwd_cuda(c32, flags, P32, *lo)
    torch.cuda.synchronize()
    e64 = max(_max_err(a, b) for a, b in zip(k64, plain))
    e32 = max(_max_err(a.double(), b) for a, b in zip(k32, plain))
    r64, r32 = float(_rel_err(d64, d_plain).max()), float(_rel_err(d32, d_plain).max())
    d32_abs = float((d32.double() - d_plain).abs().max())
    if not (bool(torch.isfinite(d64).all()) and bool(torch.isfinite(d32).all())):
        raise AssertionError(f"K2 {label}: gradient not finite")
    log(f"  K2 {label}: f64 lse max_abs_err={e64:.3e} dP rel_err={r64:.3e}; "
        f"f32 vs f64 plain lse max_abs_err={e32:.3e} dP rel_err={r32:.3e} (max abs {d32_abs:.3e})")
    if not (e64 <= 1e-10 and r64 <= 1e-10 and e32 <= 1e-4 and r32 <= 1e-4):
        raise AssertionError(f"K2 {label}: error above its limit")
    return e32, d32_abs, r32


def _k2_bound_ms(flags, C, direction):
    """The least time of one K2 launch on this bank: the larger of the
    bank bytes over the memory rate, the transcendental calls over the
    special-function rate and the other operations over the float32 rate,
    counting the samples in support (the kernels skip the rest)."""
    n_all = flags.numel()
    n_live = int(((flags & streamed.F_SUPPORT) == streamed.F_SUPPORT).sum())
    bytes_ms = n_all * (streamed.N_COL * 4 + 4) / HBM_BYTES_PER_S * 1e3
    sfu, ops = (K2_FWD_SFU, K2_FWD_OPS) if direction == "fwd" else (K2_BWD_SFU, K2_BWD_OPS)
    ops_ms = max(C * n_live * sfu / SFU_PER_S, C * n_live * ops / F32_FLOP_PER_S) * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


# chain counts held against the plain version: one, the main path's, and
# one more, which no template size fits (17 chains: five forward chain
# groups of at most 4, the last of one chain)
K2_CHAINS = (1, N_CHAINS, N_CHAINS + 1)


def _geo_text(g):
    unit = "a thread" if g.direction == "fwd" else "a lane"
    carry = f"{g.group} chains a block" if g.direction == "fwd" else f"one chain a warp, {g.slices} slices"
    return (f"tile {g.tile}, {g.blocks} blocks ({g.resident} resident per SM, {g.waves:.2f} waves), "
            f"{g.per_thread} samples {unit} per chain, {carry}")


def check_k2(model_s, th, gen):
    """K2 against its plain version at full width (both banks, ``K2_CHAINS``
    chains, float64 and float32) and on the edge bank; at C = 16, float32,
    per bank and direction: kernel, plain and bound times, the geometry, the
    kernel's registers.  ``th`` holds at
    least ``max(K2_CHAINS)`` chains.  Returns the kernels-line numbers."""
    P64 = streamed.chain_params(th, MMIN, MMAX).contiguous()
    P32 = P64.float()
    out = {"fwd": {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0},
           "bwd": {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "max_rel_err": 0.0}}
    for name, bank in (("PE", model_s.pe_op), ("injections", model_s.inj_op)):
        for C in K2_CHAINS:
            e32, d_abs, r32 = _k2_pair(bank, P64[:C].contiguous(), P32[:C].contiguous(), gen,
                                       f"{name} {bank.shape} C={C}")
            out["fwd"]["max_abs_err"] = max(out["fwd"]["max_abs_err"], e32)
            out["bwd"]["max_abs_err"] = max(out["bwd"]["max_abs_err"], d_abs)
            out["bwd"]["max_rel_err"] = max(out["bwd"]["max_rel_err"], r32)
        # float32 times at the main path's C
        P = P32[:N_CHAINS].contiguous()
        cols, flags = bank.columns(torch.float32, "cuda")
        l1, l2 = streamed.streamed_fwd_cuda(cols, flags, P)
        g1, g2 = torch.ones_like(l1), torch.full_like(l2, -0.5)
        runs = {
            "fwd": (lambda: streamed.streamed_fwd_cuda(cols, flags, P),
                    lambda: streamed._streamed_fwd_torch(cols, flags, P)),
            "bwd": (lambda: streamed.streamed_bwd_cuda(cols, flags, P, g1, g2, l1, l2),
                    lambda: streamed._streamed_bwd_torch(cols, flags, P, g1, g2, l1, l2)),
        }
        for d, (kern, plain) in runs.items():
            geo = streamed.device_geometry(cols, P, d)
            info = streamed.k2_kernel_info(torch.float32, d, geo.group, geo.smem)
            k_ms, p_ms = time_ms(kern), time_ms(plain)
            b_ms, b_by = _k2_bound_ms(flags, N_CHAINS, d)
            out[d]["ms"] += k_ms
            out[d]["plain_ms"] += p_ms
            out[d]["bound_ms"] += b_ms
            out[d]["bound_by"] = b_by
            log(f"  K2 {d} {name} {bank.shape} C={N_CHAINS} f32: kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
                f"bound_ms={b_ms:.4f} ({b_by}; {b_ms / k_ms:.1%} of the bound)")
            log(f"    geometry: {_geo_text(geo)}; {info['registers']} registers a thread, "
                f"{info['local_bytes']} spill bytes, {info['blocks_per_sm']} blocks resident per SM")

    # every branch: beta on both sides of -1 and at -1, out-of-support
    # samples, a = 0 and 1, an all--inf row, a row on the redshift floor,
    # padded lanes; each dtype against its own plain version (the floor is
    # the dtype's own)
    banks, valid, zmax = k2_edge_case(seed=7)
    edge = streamed.StreamedBank(banks, MMIN, MMAX, zmax, valid=valid)
    for C in (4, N_CHAINS + 1):
        P = streamed.chain_params(k2_edge_theta(C, torch.float64, "cuda"), MMIN, MMAX).contiguous()
        for dtype, tol in ((torch.float64, 1e-10), (torch.float32, 1e-4)):
            cols, flags = edge.columns(dtype, "cuda")
            Pd = P.to(dtype)
            k = streamed.streamed_fwd_cuda(cols, flags, Pd)
            p = streamed._streamed_fwd_torch(cols, flags, Pd)
            err = max(_max_err(a, b) for a, b in zip(k, p))
            l1, l2 = (torch.where(torch.isfinite(v), v, 0.0) for v in p)
            g1, g2 = torch.isfinite(p[0]).to(dtype), -0.5 * torch.isfinite(p[1]).to(dtype)
            d_k = streamed.streamed_bwd_cuda(cols, flags, Pd, g1, g2, l1, l2)
            d_p = streamed._streamed_bwd_torch(cols, flags, Pd, g1, g2, l1, l2)
            rel = float(_rel_err(d_k, d_p.double()).max())
            log(f"  K2 edge bank {edge.shape} C={C} {str(dtype)[6:]} vs its plain version: lse max_abs_err={err:.3e} "
                f"dP rel_err={rel:.3e}")
            if not (err <= tol and rel <= tol and bool(torch.isfinite(d_k).all())):
                raise AssertionError(f"K2 edge bank, C={C}, {dtype}: error above {tol}")
    return out


def streamed_route(args, model_s, init, flat_potential, z0):
    """The streamed route: potential and gradient against the flat route at
    the same z, both timed, then NUTS with the launch counts zeroed just
    before and read just after.  Returns ``(K2 forward launches, K2
    backward launches, flat ms, streamed ms)``."""
    dev, dtype = torch.device("cuda"), torch.float32
    potential = ModelPotential(model_s, device=dev, dtype=dtype)
    with phase(f"streamed route: potential + gradient against the flat route, {N_CHAINS} chains"):
        u_s, g_s = potential.value_and_grad(z0)
        u_f, g_f = flat_potential.value_and_grad(z0)
        torch.cuda.synchronize()
        du = float(((u_s - u_f).abs() / u_f.abs()).max())
        dg = float(_rel_err(g_s, g_f.double()).max())
        log(f"  streamed vs flat: potential max rel diff {du:.3e}, gradient max rel err (norm, per chain) {dg:.3e}")
        if not (bool(torch.isfinite(u_s).all()) and bool(torch.isfinite(g_s).all()) and du <= 1e-5 and dg <= 1e-3):
            raise AssertionError("the streamed route disagrees with the flat route")
        times = {"flat": [], "streamed": []}
        for _ in range(10):  # in turns, so that both routes see the same card state
            for name, pot in (("flat", flat_potential), ("streamed", potential)):
                times[name].append(call_ms(lambda: pot.value_and_grad(z0)))
        ms = {k: float(np.median(v)) for k, v in times.items()}
        log(f"  one batched potential + gradient: flat {ms['flat']:.3f} ms, streamed {ms['streamed']:.3f} ms "
            "(CUDA events around each call, median of 10 calls each, in turns)")

    DLSE_KERNEL.launches = 0
    STREAMED_FWD_KERNEL.launches = 0
    STREAMED_BWD_KERNEL.launches = 0
    mcmc, runs = run_nuts(model_s, args, init, "streamed")
    n_fwd, n_bwd, n_k1 = STREAMED_FWD_KERNEL.launches, STREAMED_BWD_KERNEL.launches, DLSE_KERNEL.launches
    log(f"  launches on the streamed route: K2 forward {n_fwd}, K2 backward {n_bwd}, K1 {n_k1}")
    if n_fwd == 0 or n_bwd == 0:
        raise AssertionError("K2 was not launched on the streamed route")
    if n_k1 != 0:
        raise AssertionError("K1 ran on the streamed route, whose tail is plain torch")
    check_async_runs("streamed", mcmc, runs, outside_loop_runs(mcmc, args.seed, init_params=flat_starts(init)))
    with phase("profile of one potential + gradient per route"):
        profile_routes({"flat": flat_potential, "streamed": potential}, z0)
    return n_fwd, n_bwd, ms["flat"], ms["streamed"]


# the port's kernels by a part of their device names (csrc/*.cu)
PORT_KERNELS = {"K1": "dlse_kernel", "K2": "k2_", "K3": "flw_kernel"}


def profile_routes(potentials, z0, calls=5):
    """``torch.profiler`` over ``calls`` potential + gradient evaluations of
    each route; prints per call the host wall time, the device time, the
    number of device operations, the device's busy share and the device
    time of each of the port's kernels, and the five device operations that
    take the most time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile

    for name, pot in potentials.items():
        pot.value_and_grad(z0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                pot.value_and_grad(z0)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / calls
        ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        dev_ms = sum(e.device_time_total for e in ops) / 1e3 / calls
        by_name = {}
        for e in ops:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3 / calls
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        mine = {k: sum(ms for op, ms in by_name.items() if tag in op) for k, tag in PORT_KERNELS.items()}
        log(f"  profile, {name} route, per potential + gradient: wall {wall_ms:.3f} ms (host clock, profiler on), "
            f"device {dev_ms:.3f} ms in {len(ops) / calls:.0f} device operations, busy share {dev_ms / wall_ms:.1%}; "
            "the port's kernels: " + ", ".join(f"{k} {ms:.4f} ms" for k, ms in mine.items()))
        for op, ms in top:
            log(f"    {ms:.4f} ms  {op[:100]}")


def call_ms(fn):
    """Time of one call of ``fn`` in ms, CUDA events around it (host work
    between the launches included: the routes are eager)."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


# ----------------------------------------------------------------- B-spline route (K3)


def bspline_args(args):
    """The production B-spline settings, as ``run_bspline_analysis`` reads
    them, with the smoke's depth."""
    return SimpleNamespace(
        **BSPLINE_KNOTS, mmin=BSPLINE_MMIN, mmax=BSPLINE_MMAX, fused=True, reparam="whitened", a_tau=25, ct_tau=25,
        target_accept=0.9, max_tree_depth=MAX_TREE_DEPTH, warmup=args.warmup, samples=args.samples,
        chains=BSPLINE_CHAINS, thinning=1, rngkey=args.seed,
    )


def _design_bytes(models, fused_lik):
    """Bytes of every design matrix on the card: each model's two banks and
    normalization grid, the redshift grid, and the fused stack."""
    tensors = [fused_lik.pe_design, fused_lik.inj_design, models["z"].pe_design_matrix,
               models["z"].inj_design_matrix, models["z"].norm_design_matrix]
    singles = [models["mass"].primary_model, models["mass"].ratio_model, models["mag"].primary_model,
               models["mag"].secondary_model, models["tilt"].primary_model, models["tilt"].secondary_model]
    for m in singles:
        tensors += [m.pe_design_matrix, m.inj_design_matrix]
        if m.interpolator.normalize:
            tensors.append(m.interpolator._grid_bases_t)
    return sum(t.numel() * t.element_size() for t in tensors)


def bspline_build(pedict, injdict, constants, bargs):
    """Both routes' models at production knots on the card, float32; prints
    the build seconds and the design bytes resident on the card."""
    with phase(f"B-spline model build ({', '.join(f'{k[:-9]} {v}' for k, v in BSPLINE_KNOTS.items())} knots, "
               "whitened), both routes"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        models = build_bspline_models(pedict, injdict, bargs, device="cuda", dtype=torch.float32)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        routes = {}
        for fused_route in (True, False):
            routes["fused" if fused_route else "unfused"] = model_from_args(
                pedict, injdict, constants, list(pedict), models, SimpleNamespace(**{**vars(bargs), "fused": fused_route})
            )
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        fl = routes["fused"].fused_lik
        log(f"  models {t1 - t0:.2f} s, fused stack {t2 - t1:.2f} s; design matrices on the card: "
            f"{_design_bytes(models, fl) / 1e6:.1f} MB (fused stack PE {tuple(fl.pe_design.shape)} + injections "
            f"{tuple(fl.inj_design.shape)}: {(fl.pe_design.numel() + fl.inj_design.numel()) * 4 / 1e6:.1f} MB; "
            f"memory allocated {torch.cuda.memory_allocated() / 1e9:.2f} GB)")
    return models, routes


def _coef_values(model, potential, z):
    """The stacked K3 coefficients ``(C, 165)`` of ``model`` at ``z``."""
    with torch.no_grad(), ppl.trace() as tr, ppl.substitute(data=potential.constrain(z)):
        model()
    v = {k: tr.trace[k]["value"] for k in ("mass_cs", "q_cs", "a_cs", "tilt_cs", "z_cs", "lamb")}
    z_cs = torch.cat([torch.zeros_like(v["z_cs"][:, :1]), v["z_cs"]], dim=1)
    return model.fused_lik._coefs(v["mass_cs"], v["q_cs"], v["a_cs"], v["tilt_cs"], z_cs, v["lamb"])


def bspline_routes(routes, gen):
    """The fused and unfused routes' potential and gradient at the same 8
    off-wall starts, held to each other, and each route's potential +
    gradient time.  Returns ``(fused potential, starts, {route: ms})``."""
    dev, dtype = torch.device("cuda"), torch.float32
    pots = {k: ModelPotential(m, device=dev, dtype=dtype) for k, m in routes.items()}
    with phase(f"B-spline routes: fused against unfused, {BSPLINE_CHAINS} chains"):
        z0 = find_valid_initial_params(pots["fused"], BSPLINE_CHAINS, gen)
        (u_f, g_f), (u_u, g_u) = (pots[k].value_and_grad(z0) for k in ("fused", "unfused"))
        torch.cuda.synchronize()
        if not all(bool(torch.isfinite(t).all()) for t in (u_f, g_f, u_u, g_u)):
            raise AssertionError("B-spline potential or gradient not finite at the starts")
        if not bool((u_f.abs() < 1e30).all()):
            raise AssertionError(f"B-spline starts sit on a likelihood wall: {u_f}")
        du = float(((u_f.double() - u_u.double()).abs() / u_u.double().abs()).max())
        dg = float(_rel_err(g_f, g_u.double()).max())
        log(f"  fused vs unfused: potential max rel diff {du:.3e}, gradient max rel err (norm, per chain) {dg:.3e}; "
            f"potential range [{float(u_f.min()):.3f}, {float(u_f.max()):.3f}]")
        if not (du <= 1e-5 and dg <= 1e-3):
            raise AssertionError("the fused and unfused B-spline routes disagree")
        times = {k: [] for k in pots}
        for _ in range(10):
            for k, pot in pots.items():
                times[k].append(call_ms(lambda: pot.value_and_grad(z0)))
        ms = {k: float(np.median(v)) for k, v in times.items()}
        log(f"  one batched potential + gradient: fused {ms['fused']:.3f} ms, unfused {ms['unfused']:.3f} ms "
            "(CUDA events around each call, median of 10 calls each, in turns)")
    with phase("profile of one B-spline potential + gradient per route"):
        profile_routes({f"B-spline {k}": p for k, p in pots.items()}, z0)
    return pots["fused"], z0, ms


def check_bspline_against_cpu(pedict, injdict, constants, params, bargs, n_events=10, n_found=10000):
    """The fused route's float32 potential and gradient on the card against
    a float64 CPU evaluation (K3's plain version) on a slice of the catalog:
    the first ``n_events`` events with all their samples and the first
    ``n_found`` injections."""
    pe = {k: v[:n_events] for k, v in pedict.items()}
    inj = {k: v[:n_found] for k, v in injdict.items()}
    const = dict(constants, nObs=n_events)
    out = []
    for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        models = build_bspline_models(pe, inj, bargs, device=dev, dtype=dtype)
        model = model_from_args(pe, inj, const, list(pe), models, bargs)
        pot = ModelPotential(model, device=dev, dtype=dtype)
        z = pot.unconstrain({k: v.to(dev, dtype) for k, v in params.items()}, BSPLINE_CHAINS)
        out.append([t.double().cpu() for t in pot.value_and_grad(z)])
    (u32, g32), (u64, g64) = out
    # the starts were found off the walls of the whole catalog; on the slice
    # a chain may sit on one (too few effective injections), and is left out
    ok = (u64.abs() < 1e30) & (u32.abs() < 1e30)
    if not (bool(torch.isfinite(u64).all()) and int(ok.sum()) >= BSPLINE_CHAINS // 2):
        raise AssertionError(f"reference potential off the likelihood walls expected, got {u64}")
    torch.testing.assert_close(u32[ok], u64[ok], rtol=1e-4, atol=1e-3)
    rel = float((g32[ok] - g64[ok]).norm() / g64[ok].norm())
    if not rel < 1e-3:
        raise AssertionError(f"float32 card gradient differs from the float64 CPU one: relative error {rel:.3e}")
    log(f"  card f32 (fused route) vs CPU f64 on {n_events} events x {N_SAMPLES} + {n_found} injections, "
        f"{int(ok.sum())} of {BSPLINE_CHAINS} chains off the walls: max|dU|={float((u32 - u64)[ok].abs().max()):.3e}, "
        f"grad rel err={rel:.3e}")


def _k3_bound_ms(design, nlp, C, E):
    """The least time of one K3 launch: the larger of the bytes it must
    move (every nlp entry, the design columns of the samples in support, the
    coefficients and both outputs) over the memory rate, and its operations
    (2 C K per sample in support over the float32 rate, or C exponentials
    per sample over the special-function rate)."""
    K, N = design.shape
    n_live = int((nlp != -math.inf).sum())
    bytes_ms = (N + K * n_live + C * K + 2 * C * E) * design.element_size() / HBM_BYTES_PER_S * 1e3
    ops_ms = max(2 * C * K * n_live / F32_FLOP_PER_S, C * n_live / SFU_PER_S) * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations", n_live / N


def _k3_library(coefs, design, nlp, n_events, n_samples):
    """The library composite: ``torch.logsumexp`` of ``coefs @ design +
    nlp`` and of twice it."""
    logw = (coefs @ design + nlp).reshape(coefs.shape[0], n_events, n_samples)
    return torch.logsumexp(logw, -1), torch.logsumexp(2.0 * logw, -1)


def _k3_case(c, d, n, E, S, gen, tol, label):
    """K3's forward (raw ``lse1, lse2``) and its autograd gradient to the
    coefficients against the plain version on one bank; two launches must
    give identical bits.  Returns the forward error."""
    got = fused.flw_cuda(c, d, n, E, S)
    want = fused._flw_torch(c, d, n, E, S)
    again = fused.flw_cuda(c, d, n, E, S)
    torch.cuda.synchronize()
    if any(bool(torch.isnan(g).any()) for g in got):
        raise AssertionError(f"K3 {label}: NaN in the kernel's output")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"K3 {label}: two launches on the same input differ")
    err = max(_max_err(a, b) for a, b in zip(got, want))
    w1 = torch.rand(want[0].shape, generator=gen, device="cuda", dtype=c.dtype)
    w2 = torch.rand(want[0].shape, generator=gen, device="cuda", dtype=c.dtype) - 0.5
    # the kernel's Function over the whole bank (a masked event gets a zero
    # weight from its guard); the plain version's autograd over the live
    # events only (its backward is NaN on an all--inf event)
    ev = torch.nonzero(torch.isfinite(want[0]).all(0)).flatten()
    K = d.shape[0]
    d_live = d if len(ev) == E else d.reshape(K, E, S)[:, ev].reshape(K, -1)
    n_live = n if len(ev) == E else n.reshape(E, S)[ev].reshape(-1)
    grads = []
    for fn, dd, nn, w1e, w2e in ((fused.fused_logweight_logsumexp, d, n, w1, w2),
                                 (fused.fused_logweight_logsumexp_torch, d_live, n_live, w1[:, ev], w2[:, ev])):
        cg = c.clone().requires_grad_(True)
        lbf, lne = fn(cg, dd, nn, dd.shape[1] // S, S)
        live = torch.isfinite(lbf) & torch.isfinite(lne)
        loss = (w1e * lbf)[live].sum() + (w2e * lne)[live].sum()
        grads.append(torch.autograd.grad(loss, cg)[0])
    rel = float(_rel_err(grads[0], grads[1].double()).max())
    log(f"  K3 {label}: lse max_abs_err={err:.3e}, d coefs rel_err={rel:.3e}, repeatable")
    if not (err <= tol and rel <= tol and bool(torch.isfinite(grads[0]).all())):
        raise AssertionError(f"K3 {label}: error above {tol}")
    return err


def _k3_geo_text(c, d, E, S):
    g = fused.flw_device_geometry(c, d, E, S)
    info = fused.k3_kernel_info(c.dtype, g.width, g.smem)
    return (f"tile {g.tile}, rows split {g.ksplit} ways, {g.steps} runs a lane, {g.blocks} blocks ({g.resident} "
            f"resident per SM, {g.waves:.2f} waves) x {g.groups} launch(es) of the {g.width}-chain kernel; "
            f"{info['registers']} registers a thread, {info['local_bytes']} spill bytes, {g.smem} B shared memory")


def check_k3(fl, coefs, gen):
    """K3 against its plain version on the fused route's two banks (PE
    ``(165, 69 * 8000)``, the injections as one row of 46,770; both designs
    padded-stride views) for C = 1, 8 and 16 in float64 (limit 1e-10) and
    float32 (1e-4), on the injection design stored contiguously (rows of an
    odd 4-byte alignment), and on the edge bank; float32 kernel, plain,
    library and bound times at the main path's C = 8 (and the kernel at
    C = 16) beside the earlier design's, with the geometry and registers.
    Returns the kernels-line numbers."""
    C16 = torch.cat([coefs, coefs + 0.05 * torch.randn(coefs.shape, generator=gen, device="cuda", dtype=coefs.dtype)])
    banks = {
        "PE": (fl.pe_design, fl.pe_nlp, fl.n_events, fl.n_samples),
        "injections": (fl.inj_design, fl.inj_nlp, 1, fl.n_found),
    }
    out = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    for name, (d32, n32, E, S) in banks.items():
        d64, n64 = d32.double(), n32.double()
        for C in (1, BSPLINE_CHAINS, 16):
            for dtype, d, n, tol in ((torch.float64, d64, n64, 1e-10), (torch.float32, d32, n32, 1e-4)):
                c = C16[:C].to(dtype).contiguous()
                err = _k3_case(c, d, n, E, S, gen, tol, f"{name} {tuple(d.shape)} stride {d.stride(0)} E={E} C={C} "
                               f"{str(dtype)[6:]}")
                if dtype == torch.float32:
                    out["max_abs_err"] = max(out["max_abs_err"], err)
        del d64, n64
        if d32.stride(0) % 4:
            raise AssertionError(f"K3 {name}: the design's rows are not padded to whole 16-byte vectors")
        c8 = C16[:BSPLINE_CHAINS].float().contiguous()
        dc = d32.contiguous()  # rows E * S values apart: every other row unaligned when E * S is odd
        _k3_case(c8, dc, n32, E, S, gen, 1e-4, f"{name} contiguous {tuple(dc.shape)} stride {dc.stride(0)} E={E} "
                 f"C={BSPLINE_CHAINS} float32")
        del dc
        k_ms = time_ms(lambda: fused.flw_cuda(c8, d32, n32, E, S))
        p_ms = time_ms(lambda: fused.fused_logweight_logsumexp_torch(c8, d32, n32, E, S))
        lib_ms = time_ms(lambda: _k3_library(c8, d32, n32, E, S))
        b_ms, b_by, live = _k3_bound_ms(d32, n32, BSPLINE_CHAINS, E)
        c16 = C16.float().contiguous()
        k16_ms = time_ms(lambda: fused.flw_cuda(c16, d32, n32, E, S))
        b16_ms = _k3_bound_ms(d32, n32, 16, E)[0]
        for key, v in (("ms", k_ms), ("plain_ms", p_ms), ("library_ms", lib_ms), ("bound_ms", b_ms)):
            out[key] += v
        out["bound_by"] = b_by
        log(f"  K3 {name} {tuple(d32.shape)} C={BSPLINE_CHAINS} f32: kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
            f"library_ms={lib_ms:.4f} bound_ms={b_ms:.4f} ({b_by}; {b_ms / k_ms:.1%} of the bound; "
            f"{live:.1%} of the samples in support); {_earlier(f'K3 {name} C=8', k_ms)}")
        log(f"    geometry: {_k3_geo_text(c8, d32, E, S)}")
        sum_ms = time_ms(lambda: d32.sum())
        log(f"    for scale: torch.sum reads this design ({d32.numel() * 4 / 2**20:.0f} MiB) in {sum_ms:.4f} ms, "
            f"{d32.numel() * 4 / sum_ms / 1e9:.3f} TB/s")
        log(f"  K3 {name} C=16 f32: kernel_ms={k16_ms:.4f} bound_ms={b16_ms:.4f} ({b16_ms / k16_ms:.1%}); "
            f"{_earlier(f'K3 {name} C=16', k16_ms)}")
        log(f"    geometry: {_k3_geo_text(c16, d32, E, S)}")

    # an empty leading tile, a fully masked event, S a multiple of no tile,
    # events of an odd length, and the same bank as one long row; each dtype
    # against its own plain version
    coefs_e, design_e, nlp_e, E, S = k3_edge_case(seed=7, num_chains=16, n_rows=165)
    for dtype, tol in ((torch.float64, 1e-10), (torch.float32, 1e-4)):
        c, d, n = (torch.as_tensor(a, dtype=dtype, device="cuda") for a in (coefs_e, design_e, nlp_e))
        for e, s in ((E, S), (1, E * S), (E * 20, S // 20)):
            for C in (1, 16):
                _k3_case(c[:C].contiguous(), d, n, e, s, gen, tol, f"edge bank E={e} S={s} C={C} {str(dtype)[6:]}")
    return out


def bspline_nuts(pedict, injdict, constants, bargs):
    """NUTS on the fused route through ``run_bspline_analysis``, with the
    K3 and K1 launch counts zeroed just before and read just after.
    Returns the K3 launches."""
    FLW_KERNEL.launches = 0
    DLSE_KERNEL.launches = 0
    with phase(f"NUTS on the B-spline fused route: {bargs.warmup} warmup + {bargs.samples} samples, "
               f"{bargs.chains} chains, whitened, target {bargs.target_accept}, diagonal mass, depth {bargs.max_tree_depth}"), \
            ModelRuns() as runs:
        posterior, models = run_bspline_analysis(pedict, injdict, constants, list(pedict), bargs, device="cuda",
                                                 dtype=torch.float32)
        torch.cuda.synchronize()
    n_k3, n_k1 = FLW_KERNEL.launches, DLSE_KERNEL.launches
    log(f"  launches on the B-spline fused route: K3 {n_k3}, K1 {n_k1}")
    if n_k3 == 0:
        raise AssertionError("K3 was not launched on the B-spline fused route")
    if n_k1 != 0:
        raise AssertionError("K1 ran on the B-spline fused route, which reduces both banks with K3")
    mcmc = models["_mcmc"]
    extra = mcmc.get_extra_fields()
    n_draws = bargs.samples * bargs.chains
    # get_deterministic runs the model once a batch of 64 draws
    check_async_runs("B-spline fused", mcmc, runs.runs - math.ceil(n_draws / 64), outside_loop_runs(mcmc, bargs.rngkey))
    for k, v in posterior.items():
        if v.shape[0] != n_draws or not bool(torch.isfinite(v).all()):
            raise AssertionError(f"B-spline route, site {k}: values of shape {tuple(v.shape)} not finite")
    missing = {"mass_cs", "q_cs", "a_cs", "tilt_cs", "z_cs", "rate"} - set(posterior)
    if missing:
        raise AssertionError(f"B-spline posterior misses {sorted(missing)}")
    log(f"  timings: init {mcmc.timings['init']:.2f} s, warmup {mcmc.timings.get('warmup', 0.0):.2f} s, "
        f"sampling {mcmc.timings['sample']:.2f} s")
    log(f"  mean tree depth {float(extra['tree_depth'].double().mean()):.2f}, "
        f"divergences {int(extra['diverging'].sum())}, mean accept {float(extra['accept_prob'].mean()):.3f}, "
        f"leapfrogs in sampling {int(extra['num_steps'].sum())}; {len(posterior)} sites finite "
        f"({', '.join(f'{k} {tuple(v.shape[1:])}' for k, v in sorted(posterior.items()) if k in COEF_SITES)} "
        "from get_deterministic)")
    samples = mcmc.get_samples(group_by_chain=True)
    log(f"  ESS lamb {effective_sample_size(samples['lamb']):.1f}, unscaled_rate "
        f"{effective_sample_size(samples['unscaled_rate']):.1f}; posterior means lamb "
        f"{float(posterior['lamb'].double().mean()):.3f}, rate {float(posterior['rate'].double().mean()):.3f}")
    return n_k3


def bspline_route(args, catalog, gen):
    """The B-spline production model: build, the two routes against each
    other and timed, K3 against its plain version, the card against a
    float64 CPU evaluation, then NUTS on the fused route.  Returns ``(K3
    numbers, K3 launches, {route: ms})``."""
    pedict, injdict, constants = catalog
    bargs = bspline_args(args)
    models, routes = bspline_build(pedict, injdict, constants, bargs)
    pot_f, z0, ms = bspline_routes(routes, gen)
    with phase("K3 against its plain version"):
        k3 = check_k3(routes["fused"].fused_lik, _coef_values(routes["fused"], pot_f, z0), gen)
    with phase("B-spline reference check"):
        params = {k: v.detach() for k, v in pot_f.constrain(z0).items()}
        check_bspline_against_cpu(pedict, injdict, constants, params, bargs)
    del models, routes, pot_f
    torch.cuda.empty_cache()
    return k3, bspline_nuts(pedict, injdict, constants, bargs), ms


# ----------------------------------------------------------------- library models (K1)


def derived_columns(bank):
    """``mass_2``, ``chi_eff`` and ``chi_p`` of a bank (host float64), from
    its primary mass, mass ratio, spin magnitudes and tilt cosines."""
    m1, q = (np.asarray(bank[k], dtype=np.float64) for k in ("mass_1", "mass_ratio"))
    a1, a2, c1, c2 = (np.asarray(bank[k], dtype=np.float64) for k in ("a_1", "a_2", "cos_tilt_1", "cos_tilt_2"))
    s1, s2 = np.sqrt(np.clip(1.0 - c1**2, 0.0, None)), np.sqrt(np.clip(1.0 - c2**2, 0.0, None))
    return {
        "mass_2": m1 * q,
        "chi_eff": (a1 * c1 + q * a2 * c2) / (1.0 + q),
        "chi_p": np.maximum(a1 * s1, (4.0 * q + 3.0) / (4.0 + 3.0 * q) * q * a2 * s2),
    }


class LibraryModel:
    """The reference-style B-spline model (``tests/models/test_bspline_models.py``
    of the JAX package) with independent spins, on the library's models:
    ``models`` holds ``mass`` (:class:`BSplinePrimaryBSplineRatio`), ``mag``
    and ``tilt`` (the independent pairs) and ``z``
    (:class:`PowerlawSplineRedshiftModel`); the coefficient priors are the
    pipeline's (``bspline_mass_prior``, ``bspline_spin_prior(IID=False)``,
    ``bspline_redshift_prior``).

    ``log=False`` is the reference's linear route: the product of the
    factors over the prior, non-finite weights set to 0, and the likelihood
    at its default ``log=False`` (plain sums, no kernel).  ``log=True`` sums
    the factors' logs per sample and reduces both banks with K1.
    """

    def __init__(self, pedict, injdict, constants, models, log=True, reparam="whitened", min_neff_cut=True):
        self.mass, self.mag, self.tilt, self.z = models["mass"], models["mag"], models["tilt"], models["z"]
        ref = self.mass.primary_model.pe_design_matrix
        self.banks = {}
        for pe_samples, d in ((True, pedict), (False, injdict)):
            z, prior = (np.asarray(d[k], dtype=np.float64) for k in ("redshift", "prior"))
            self.banks[pe_samples] = tuple(torch.as_tensor(v, dtype=ref.dtype, device=ref.device)
                                           for v in (z, prior, np.log(prior)))
        self.Nobs, self.Tobs, self.Ninj = constants["nObs"], constants["obs_time"], float(constants["total_inj"])
        self.log, self.reparam, self.min_neff_cut = log, reparam, min_neff_cut

    def coefficients(self):
        """The coefficient and ``lamb`` sites: ``(mass, q, a1, tilt1, a2,
        tilt2, z (with the pinned zero), lamb)``, at the reference's
        smoothing scales."""
        mass_cs, q_cs = bspline_mass_prior(m_nsplines=self.mass.primary_model.n_splines,
                                           q_nsplines=self.mass.ratio_model.n_splines, m_tau=1, q_tau=1,
                                           reparam=self.reparam)
        spins = bspline_spin_prior(a_nsplines=self.mag.primary_model.n_splines,
                                   ct_nsplines=self.tilt.primary_model.n_splines, a_tau=25, ct_tau=25,
                                   IID=False, reparam=self.reparam)
        z_cs = bspline_redshift_prior(z_nsplines=self.z.n_splines, z_tau=1, reparam=self.reparam)
        return (mass_cs, q_cs, *spins, z_cs, ppl.sample("lamb", ppl.distributions.Normal(0.0, 3.0)))

    def weights(self, cs, pe_samples):
        """Per-sample weights (log-weights when ``log``) of one bank:
        ``(C, E, S)`` or ``(C, N)``."""
        mass_cs, q_cs, a1, ct1, a2, ct2, z_cs, lamb = cs
        z, prior, log_prior = self.banks[pe_samples]
        factors = (self.mass(mass_cs, q_cs, pe_samples=pe_samples), self.mag(a1, a2, pe_samples=pe_samples),
                   self.tilt(ct1, ct2, pe_samples=pe_samples), self.z(z, lamb, z_cs))
        if self.log:
            return bank_log_weights(factors, log_prior)
        w = factors[0] * factors[1] * factors[2] * factors[3] / prior
        return torch.where(torch.isnan(w) | torch.isinf(w), 0.0, w)

    def __call__(self):
        cs = self.coefficients()
        hierarchical_likelihood(self.weights(cs, True), self.weights(cs, False), total_inj=self.Ninj, Nobs=self.Nobs,
                                Tobs=self.Tobs, surveyed_hypervolume=self.z.normalization(cs[-1], cs[-2]),
                                min_neff_cut=self.min_neff_cut, log=self.log)


def library_models(pedict, injdict, device, dtype):
    """The library model's pieces at production knots (``BSPLINE_KNOTS``)
    with the independent spin pairs, on ``device`` in ``dtype``."""
    k = BSPLINE_KNOTS
    mag, tilt = setup_bspline_spin_models(pedict, injdict, k["a_nsplines"], k["tilt_nsplines"], iid=False, device=device,
                                          dtype=dtype)
    return {
        "mass": setup_bspline_mass_models(pedict, injdict, k["m_nsplines"], k["q_nsplines"], BSPLINE_MMIN, BSPLINE_MMAX,
                                          device=device, dtype=dtype),
        "mag": mag,
        "tilt": tilt,
        "z": setup_powerlaw_spline_redshift_model(pedict, injdict, k["z_nsplines"], device=device, dtype=dtype),
    }


def _slice(pedict, injdict, constants, n_events=10, n_found=10000):
    """The first ``n_events`` events with all their samples and the first
    ``n_found`` injections (the CPU reference checks' slice)."""
    return ({k: v[:n_events] for k, v in pedict.items()}, {k: v[:n_found] for k, v in injdict.items()},
            dict(constants, nObs=n_events))


def library_routes(catalog, gen):
    """The library model's two routes in float64 on the card at the same 8
    off-wall starts: every diagnostic site of the linear route (no kernel)
    against the log route's (K1, two launches), ``log_l`` to rtol 1e-9.
    Returns the starts' constrained values."""
    pedict, injdict, constants = catalog
    dev = torch.device("cuda")
    with phase(f"library model build, float64 ({BSPLINE_CHAINS} chains' reference)"):
        models = library_models(pedict, injdict, dev, torch.float64)
        torch.cuda.synchronize()
    with phase("library routes: linear (log=False) against log (K1), float64, "
               f"{BSPLINE_CHAINS} chains"):
        log_model = LibraryModel(pedict, injdict, constants, models, log=True)
        pot = ModelPotential(log_model, device=dev, dtype=torch.float64)
        z0 = find_valid_initial_params(pot, BSPLINE_CHAINS, gen)
        params = {k: v.detach() for k, v in pot.constrain(z0).items()}
        traces = {}
        for route, log_route in (("linear", False), ("log", True)):
            _zero_counts()
            with torch.no_grad(), ppl.trace() as tr, ppl.substitute(data=params):
                LibraryModel(pedict, injdict, constants, models, log=log_route)()
            torch.cuda.synchronize()
            traces[route] = (tr.trace, DLSE_KERNEL.launches)
        (lin, n_lin), (lg, n_log) = traces["linear"], traces["log"]
        if (n_lin, n_log) != (0, 2):
            raise AssertionError(f"K1 launches per run: linear route {n_lin}, log route {n_log}; want 0 and 2")
        worst = {}
        for name in ("log_l", "logBFs", "log_nEffs", "log_nEff_inj", "detection_efficiency", "rate"):
            a, b = lin[name]["value"], lg[name]["value"]
            worst[name] = float(((a - b).abs() / b.abs()).max())
            torch.testing.assert_close(a, b, rtol=1e-9, atol=0.0, msg=lambda m, n=name: f"{n}: {m}")
        log(f"  linear vs log route, float64: max rel diff " + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
            + f"; log_l in [{float(lg['log_l']['value'].min()):.3f}, {float(lg['log_l']['value'].max()):.3f}]; "
            f"K1 launches a run: linear {n_lin}, log {n_log}")
    del models
    return params


def check_library_against_cpu(catalog, params):
    """The log route's float32 potential and gradient on the card against a
    float64 CPU evaluation on a slice of the catalog, as
    :func:`check_bspline_against_cpu` does for the production model."""
    pe, inj, const = _slice(*catalog)
    out = []
    for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        model = LibraryModel(pe, inj, const, library_models(pe, inj, dev, dtype), log=True)
        pot = ModelPotential(model, device=dev, dtype=dtype)
        z = pot.unconstrain({k: v.to(dev, dtype) for k, v in params.items()}, BSPLINE_CHAINS)
        out.append([t.double().cpu() for t in pot.value_and_grad(z)])
    (u32, g32), (u64, g64) = out
    ok = (u64.abs() < 1e30) & (u32.abs() < 1e30)
    if not (bool(torch.isfinite(u64).all()) and int(ok.sum()) >= BSPLINE_CHAINS // 2):
        raise AssertionError(f"reference potential off the likelihood walls expected, got {u64}")
    torch.testing.assert_close(u32[ok], u64[ok], rtol=1e-4, atol=1e-3)
    rel = float((g32[ok] - g64[ok]).norm() / g64[ok].norm())
    if not rel < 1e-3:
        raise AssertionError(f"float32 card gradient differs from the float64 CPU one: relative error {rel:.3e}")
    log(f"  card f32 (log route) vs CPU f64 on {pe['mass_1'].shape[0]} events x {N_SAMPLES} + "
        f"{inj['mass_1'].shape[0]} injections, {int(ok.sum())} of {BSPLINE_CHAINS} chains off the walls: "
        f"max|dU|={float((u32 - u64)[ok].abs().max()):.3e}, grad rel err={rel:.3e}")


LIBRARY_COEF_SITES = ("mass_cs", "q_cs", "a1_cs", "a2_cs", "tilt1_cs", "tilt2_cs", "z_cs")


def library_nuts(catalog, models, args):
    """NUTS on the library model's log route (float32, 8 chains, target 0.9,
    diagonal mass, depth 6, the default scheduler): K1 exactly twice a model
    run by the async formula, K2 and K3 never.  Returns ``(K1 launches,
    posterior with the coefficient blocks and the rate)``."""
    pedict, injdict, constants = catalog
    model = LibraryModel(pedict, injdict, constants, models, log=True)
    mcmc = MCMC(NUTS(model, target_accept_prob=0.9, max_tree_depth=MAX_TREE_DEPTH), num_warmup=args.warmup,
                num_samples=args.samples, num_chains=BSPLINE_CHAINS, device="cuda", dtype=torch.float32)
    _zero_counts()
    with phase(f"NUTS on the library log route: {args.warmup} warmup + {args.samples} samples, {BSPLINE_CHAINS} "
               f"chains, whitened, target 0.9, diagonal mass, depth {MAX_TREE_DEPTH}"), ModelRuns() as runs:
        mcmc.run(args.seed)
        torch.cuda.synchronize()
    n_k1 = _check_k1_only("the library log route", runs.runs)
    check_async_runs("library log", mcmc, runs.runs, outside_loop_runs(mcmc, args.seed))
    extra = mcmc.get_extra_fields()
    posterior = dict(mcmc.get_samples())
    posterior.update(mcmc.get_deterministic(site_names={"rate", *LIBRARY_COEF_SITES}))
    n_draws = args.samples * BSPLINE_CHAINS
    for k, v in posterior.items():
        if v.shape[0] != n_draws or not bool(torch.isfinite(v).all()):
            raise AssertionError(f"library route, site {k}: values of shape {tuple(v.shape)} not finite")
    log(f"  timings: init {mcmc.timings['init']:.2f} s, warmup {mcmc.timings.get('warmup', 0.0):.2f} s, "
        f"sampling {mcmc.timings['sample']:.2f} s; mean tree depth {float(extra['tree_depth'].double().mean()):.2f}, "
        f"divergences {int(extra['diverging'].sum())}, mean accept {float(extra['accept_prob'].mean()):.3f}; "
        f"{len(posterior)} sites finite; posterior means lamb {float(posterior['lamb'].double().mean()):.3f}, "
        f"rate {float(posterior['rate'].double().mean()):.3f}")
    return n_k1, posterior


def library_ppds(posterior, z_model):
    """The posterior-predictive distributions of the library run's draws
    (mass, independent spins, rate of z), float32 on the card: finite, and
    the mass and spin PPDs (``rate=None``) integrate to 1 within 1e-3."""
    k = BSPLINE_KNOTS
    cpu = {key: v.double().cpu().numpy() for key, v in posterior.items()}
    with phase(f"library PPDs of the run's {cpu['lamb'].shape[0]} draws (grids of {calculations.GRID_N})"):
        mp, ms, qp, qs = calculations.calculate_bspline_mass_ppds(
            cpu["mass_cs"], cpu["q_cs"], {"m1": k["m_nsplines"], "q": k["q_nsplines"]}, BSPLINE_MMIN, BSPLINE_MMAX,
            device="cuda")
        a1p, a2p, aa, ct1p, ct2p, cc = calculations.calculate_bspline_spin_ppds(
            cpu["a1_cs"], cpu["tilt1_cs"], {"a1": k["a_nsplines"], "a2": k["a_nsplines"], "tilt1": k["tilt_nsplines"],
                                           "tilt2": k["tilt_nsplines"]},
            a2_cs=cpu["a2_cs"], tilt2_cs=cpu["tilt2_cs"], device="cuda")
        rz, zs = calculations.calculate_powerlaw_spline_rate_of_z_ppds(cpu["lamb"], cpu["z_cs"], cpu["rate"], z_model)
        worst = 0.0
        for name, pdfs, grid in (("m1", mp, ms), ("q", qp, qs), ("a1", a1p, aa), ("a2", a2p, aa), ("tilt1", ct1p, cc),
                                 ("tilt2", ct2p, cc), ("R(z)", rz, zs)):
            if not np.isfinite(pdfs).all() or pdfs.shape != (cpu["lamb"].shape[0], grid.shape[0]):
                raise AssertionError(f"PPD {name}: shape {pdfs.shape} or values not finite")
            if name != "R(z)":
                err = float(np.abs(np.trapezoid(pdfs, grid, axis=-1) - 1.0).max())
                worst = max(worst, err)
                if not err < 1e-3:
                    raise AssertionError(f"PPD {name} integrates to 1 +- {err:.2e}")
        log(f"  m1, q, a1, a2, tilt1, tilt2 and R(z) PPDs finite; the six pdfs integrate to 1 within {worst:.2e}; "
            f"median R(z) at z = {zs[0]:.3f}, {zs[-1]:.3f}: {np.median(rz[:, 0]):.3f}, {np.median(rz[:, -1]):.3f}")


def _library_cases(seed):
    """Every other new model class, and the linear parametric models, as
    ``name -> case``: ``case["build"](pe, inj, kw)`` makes the model (``kw``
    the device and dtype; None for a plain function), ``case["call"](model,
    bank, params, pe_samples)`` evaluates it on a bank's columns, and
    ``case["params"]`` holds ``(C, ...)`` numpy coefficients and
    hyperparameters, one set per chain.  ``q_mmin`` (a number, or a key of
    ``params``) marks a powerlaw mass ratio on ``[q_mmin / m1, 1]``;
    ``not_held`` says why float32 is not held to float64 (see
    :func:`library_model_classes`)."""
    rng = np.random.default_rng(seed)
    C, K = BSPLINE_CHAINS, BSPLINE_KNOTS
    m_k, q_k, s_k, z_k = K["m_nsplines"], K["q_nsplines"], K["a_nsplines"], K["z_nsplines"]

    def co(n, scale=0.3):
        return scale * rng.standard_normal((C, n))

    def u(lo, hi):
        return rng.uniform(lo, hi, C)

    def hp(b, v):
        return per_chain(v, b["mass_1"].ndim)

    def case(build, call, params, q_mmin=None, not_held=None):
        return dict(build=build, call=call, params=params, q_mmin=q_mmin, not_held=not_held)

    def coefs_only(m, b, p, pe):
        return m(p["c"], pe_samples=pe)

    def pair(m, b, p, pe):
        return m(p["c1"], p["c2"], pe_samples=pe)

    def no_model(pe, inj, kw):
        return None

    mm = dict(mmin=BSPLINE_MMIN, mmax=BSPLINE_MMAX)
    ratio = lambda pe, inj, kw: PowerlawBasisSplinePrimaryRatio(  # noqa: E731
        m_k, q_k, pe["mass_1"], pe["mass_ratio"], inj["mass_1"], inj["mass_ratio"], **mm, **kw)
    return {
        # its basis (LogXBSpline, normalized) divides the curve by its
        # integral, so the coefficients of a density keep it positive
        "BSplineRedshift": case(
            lambda pe, inj, kw: single.BSplineRedshift(z_k, pe["redshift"], inj["redshift"], COSMO.dVcdz(pe["redshift"]),
                                                       COSMO.dVcdz(inj["redshift"]), **kw),
            coefs_only, {"c": 1.0 + co(z_k)}),
        "BSplineChiEffective": case(
            lambda pe, inj, kw: single.BSplineChiEffective(s_k, pe["chi_eff"], inj["chi_eff"], **kw), coefs_only,
            {"c": co(s_k)}),
        "BSplineSymmetricChiEffective": case(
            lambda pe, inj, kw: single.BSplineSymmetricChiEffective(s_k, pe["chi_eff"], inj["chi_eff"], **kw),
            coefs_only, {"c": co(s_k)}),
        "BSplineChiPrecess": case(
            lambda pe, inj, kw: single.BSplineChiPrecess(s_k, pe["chi_p"], inj["chi_p"], **kw), coefs_only,
            {"c": co(s_k)}),
        "BSplineEffectiveSpinDims": case(
            lambda pe, inj, kw: separable.BSplineEffectiveSpinDims(s_k, s_k, pe["chi_eff"], pe["chi_p"], inj["chi_eff"],
                                                                   inj["chi_p"], **kw),
            pair, {"c1": co(s_k), "c2": co(s_k)}),
        "BSplinePrimaryPowerlawRatio": case(
            lambda pe, inj, kw: separable.BSplinePrimaryPowerlawRatio(m_k, pe["mass_1"], inj["mass_1"], **mm, **kw),
            lambda m, b, p, pe: m(b["mass_1"], b["mass_ratio"], p["beta"], p["mmin"], p["c"], pe_samples=pe),
            {"c": co(m_k), "beta": u(-1.0, 2.0), "mmin": u(3.0, 6.0)}, q_mmin="mmin"),
        "PLPeakPrimaryBSplineRatio": case(
            lambda pe, inj, kw: separable.PLPeakPrimaryBSplineRatio(q_k, pe["mass_ratio"], inj["mass_ratio"], **kw),
            lambda m, b, p, pe: m(b["mass_1"], p["alpha"], p["mmin"], p["mmax"], p["mu"], p["sig"], p["lam"], p["c"],
                                  pe_samples=pe),
            {"c": co(q_k), "alpha": u(-3.0, -1.5), "mmin": u(3.0, 6.0), "mmax": u(80.0, 100.0), "mu": u(25.0, 40.0),
             "sig": u(2.0, 8.0), "lam": u(0.05, 0.5)}),
        "BSplineIIDComponentMasses": case(
            lambda pe, inj, kw: separable.BSplineIIDComponentMasses(m_k, pe["mass_1"], pe["mass_2"], inj["mass_1"],
                                                                    inj["mass_2"], **mm, **kw),
            lambda m, b, p, pe: m(p["c"], beta=p["beta"], pe_samples=pe), {"c": co(m_k), "beta": u(-1.0, 2.0)}),
        "BSplineIndependentComponentMasses": case(
            lambda pe, inj, kw: separable.BSplineIndependentComponentMasses(
                m_k, m_k, pe["mass_1"], pe["mass_2"], inj["mass_1"], inj["mass_2"], mmin1=BSPLINE_MMIN,
                mmax1=BSPLINE_MMAX, mmin2=BSPLINE_MMIN, mmax2=BSPLINE_MMAX, **kw),
            lambda m, b, p, pe: m(p["c1"], p["c2"], beta=p["beta"], pe_samples=pe),
            {"c1": co(m_k), "c2": co(m_k), "beta": u(-1.0, 2.0)}),
        "PowerlawBasisSplinePrimaryPowerlawRatio": case(
            lambda pe, inj, kw: PowerlawBasisSplinePrimaryPowerlawRatio(m_k, pe["mass_1"], inj["mass_1"], mmin=BSPLINE_MMIN,
                                                                        m2min=BSPLINE_MMIN, mmax=BSPLINE_MMAX, **kw),
            lambda m, b, p, pe: m(b["mass_1"], b["mass_ratio"], alpha=p["alpha"], mmin=BSPLINE_MMIN, mmax=p["mmax"],
                                  cs=p["c"], beta=p["beta"]),
            {"c": co(m_k), "alpha": u(1.5, 3.0), "mmax": u(80.0, 100.0), "beta": u(-1.0, 2.0)}, q_mmin=BSPLINE_MMIN),
        # at its default mmin (the grid's first mass) the joint grid's first
        # column has the q support [mmin/m, 1] = [1, 1]: the powerlaw norm's
        # eps clamp puts 1/eps of the dtype there, and the normalization
        # follows the dtype (ROADMAP F8, the JAX package's semantics); with
        # a per-chain mmin above the grid's start no column is degenerate
        "PowerlawBasisSplinePrimaryRatio": case(
            ratio,
            lambda m, b, p, pe: m(b["mass_1"], b["mass_ratio"], alpha=p["alpha"], mmax=p["mmax"], cs=p["c1"],
                                  beta=p["beta"], vs=p["c2"]),
            {"c1": co(m_k), "c2": co(q_k), "alpha": u(1.5, 3.0), "mmax": u(80.0, 100.0), "beta": u(-1.0, 2.0)},
            q_mmin=BSPLINE_MMIN,
            not_held="the default mmin's normalization is 1/eps of the dtype (F8): float32 and float64 differ by design"),
        "PowerlawBasisSplinePrimaryRatio (per-chain mmin)": case(
            ratio,
            lambda m, b, p, pe: m(b["mass_1"], b["mass_ratio"], alpha=p["alpha"], mmin=p["mmin"], mmax=p["mmax"],
                                  cs=p["c1"], beta=p["beta"], vs=p["c2"]),
            {"c1": co(m_k), "c2": co(q_k), "alpha": u(1.5, 3.0), "mmin": u(3.5, 6.0), "mmax": u(80.0, 100.0),
             "beta": u(-1.0, 2.0)}, q_mmin="mmin"),
        "plpeak_primary_ratio_pdf (delta)": case(
            no_model,
            lambda m, b, p, pe: plpeak_primary_ratio_pdf(b["mass_1"], b["mass_ratio"], hp(b, p["alpha"]), hp(b, p["beta"]),
                                                         MMIN, MMAX, hp(b, p["mu"]), hp(b, p["sig"]), hp(b, p["lam"]),
                                                         delta=hp(b, p["delta"])),
            {"alpha": u(-3.0, -1.5), "beta": u(-1.0, 2.0), "mu": u(25.0, 40.0), "sig": u(2.0, 8.0),
             "lam": u(0.05, 0.5), "delta": u(1.0, 6.0)}, q_mmin=MMIN),
        "powerlaw_primary_ratio_falloff_pdf": case(
            no_model,
            lambda m, b, p, pe: powerlaw_primary_ratio_falloff_pdf(b["mass_1"], b["mass_ratio"], hp(b, p["alpha"]),
                                                                   hp(b, p["beta"]), MMIN, MMAX, 2.0),
            {"alpha": u(-3.0, -1.5), "beta": u(-1.0, 2.0)}, q_mmin=MMIN),
        "independent_spin_magnitude_beta_dist x independent_spin_tilt": case(
            no_model,
            lambda m, b, p, pe: independent_spin_magnitude_beta_dist(
                b["a_1"], b["a_2"], hp(b, p["a1"]), hp(b, p["b1"]), hp(b, p["a2"]), hp(b, p["b2"]))
            * independent_spin_tilt(b["cos_tilt_1"], b["cos_tilt_2"], hp(b, p["x1"]), hp(b, p["x2"]), hp(b, p["s1"]),
                                    hp(b, p["s2"])),
            {"a1": u(1.5, 4.0), "b1": u(1.5, 6.0), "a2": u(1.5, 4.0), "b2": u(1.5, 6.0), "x1": u(0.1, 0.9),
             "x2": u(0.1, 0.9), "s1": u(0.2, 2.0), "s2": u(0.2, 2.0)}),
        "default_spin_tilt": case(
            no_model,
            lambda m, b, p, pe: default_spin_tilt(b["cos_tilt_1"], b["cos_tilt_2"], hp(b, p["x"]), hp(b, p["s"])),
            {"x": u(0.1, 0.9), "s": u(0.2, 2.0)}),
        "PowerlawRedshiftModel": case(
            lambda pe, inj, kw: PowerlawRedshiftModel(pe["redshift"], inj["redshift"], **kw),
            lambda m, b, p, pe: m(b["redshift"], hp(b, p["lamb"])), {"lamb": u(-1.0, 4.0)}),
    }


LIBRARY_COLUMNS = ("mass_1", "mass_ratio", "mass_2", "redshift", "a_1", "a_2", "cos_tilt_1", "cos_tilt_2", "chi_eff",
                   "chi_p")


def _evaluate_case(case, pe, inj, device, dtype, built):
    """A case's values on both banks: ``(PE (C, E, S), injections (C, N))``;
    ``built`` keeps the models of the last builder (the two cases of one
    class share them)."""
    key = (case["build"], device, dtype, id(pe))
    if key not in built:
        built[key] = case["build"](pe, inj, dict(device=device, dtype=dtype))
    model = built[key]
    p = {k: torch.as_tensor(v, dtype=dtype, device=device) for k, v in case["params"].items()}
    with torch.no_grad():
        return tuple(case["call"](model, to_tensors({k: d[k] for k in LIBRARY_COLUMNS}, device, dtype), p, pe_samples)
                     for pe_samples, d in ((True, pe), (False, inj)))


F32_EPS = float(torch.finfo(torch.float32).eps)


def _q_condition(case, m1):
    """How far float32's rounding is amplified in a powerlaw mass ratio on
    ``[mmin / m1, 1]``: its norm divides by the support's log-width, so one
    rounding of ``mmin / m1`` moves the pdf by about ``eps / |log(mmin /
    m1)|`` relative.  Returns ``max(1, 1 / |log(mmin / m1)|)`` (1 for a case
    without such a ratio)."""
    mmin = case["q_mmin"]
    if mmin is None:
        return 1.0
    if isinstance(mmin, str):
        mmin = per_chain(torch.as_tensor(case["params"][mmin], dtype=m1.dtype, device=m1.device), m1.ndim)
    return (1.0 / torch.log(mmin / m1).abs()).clamp_min(1.0)


def library_model_classes(catalog, seed):
    """Every other new model class and the linear parametric models at full
    width, 8 chains: finite on both banks; float32 on the card against
    float64 on the card to rtol 1e-4 and atol 1e-6 of the bank's largest
    value, plus ``8 eps32`` times the ratio's condition number where a
    powerlaw mass ratio's support is nearly empty (:func:`_q_condition`;
    the elements that need it are counted), except where a case says why
    not; and float64 on the card against float64 on the CPU on a slice
    (rtol 1e-9)."""
    pe, inj, const = catalog
    pe_s, inj_s, _ = _slice(pe, inj, const)
    cases = _library_cases(seed)
    with phase(f"library model classes: {len(cases)} cases at full width, {BSPLINE_CHAINS} chains, float32 and "
               "float64 on the card, float64 on the CPU on a slice"):
        built = {}
        for name, case in cases.items():
            t0 = time.perf_counter()
            if not any(k[0] is case["build"] for k in built):
                built.clear()
                torch.cuda.empty_cache()
            f32, f64, s64, c64 = (_evaluate_case(case, *banks, dev, dtype, built) for banks, dev, dtype in (
                ((pe, inj), "cuda", torch.float32), ((pe, inj), "cuda", torch.float64),
                ((pe_s, inj_s), "cuda", torch.float64), ((pe_s, inj_s), "cpu", torch.float64)))
            errs, n_cond = [], 0
            for a, b, sa, sb, d in zip(f32, f64, s64, c64, (pe, inj)):
                if not (bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all())):
                    raise AssertionError(f"{name}: values not finite")
                scale = float(b.abs().max())
                diff = (a.double() - b).abs()
                plain = 1e-6 * scale + 1e-4 * b.abs()
                kappa = _q_condition(case, torch.as_tensor(d["mass_1"], dtype=torch.float64, device="cuda"))
                bad = diff > plain + 8.0 * F32_EPS * kappa * b.abs()
                if case["not_held"] is None and bool(bad.any()):
                    i = int(torch.argmax((diff - plain).flatten()))
                    raise AssertionError(f"{name}: float32 differs from float64 at {int(bad.sum())} of {b.numel()} "
                                         f"values; worst {float(a.flatten()[i])} against {float(b.flatten()[i])}")
                n_cond += int(((diff > plain) & ~bad).sum())
                torch.testing.assert_close(sa.cpu(), sb, rtol=1e-9, atol=1e-12 * float(sb.abs().max()),
                                           msg=lambda m: f"{name} (slice, card vs CPU): {m}")
                errs.append(float((diff / b.abs().clamp_min(1e-6 * scale)).max()))
            held = (f"not held: {case['not_held']}" if case["not_held"] else
                    f"held ({n_cond} values within the ratio's conditioning allowance)")
            log(f"  {name}: PE {tuple(f64[0].shape)}, injections {tuple(f64[1].shape)}; f32 vs f64 max rel err "
                f"{max(errs):.2e}, {held}; card vs CPU on the slice held; {time.perf_counter() - t0:.2f} s")


def library_categorical(catalog, models, params, seed):
    """Categorical subpopulations on the card: two banks of the library
    model's log-weights (at the run's starts and at half their
    coefficients), ``pop_frac = [0.3, 0.7]``, a fixed ``rngkey`` (an int,
    and a generator on the card, which is not advanced): two calls give
    identical ``Qs`` and ``log_l`` bit for bit, K1 twice a call."""
    pedict, injdict, constants = catalog
    model = LibraryModel(pedict, injdict, constants, models, log=True)
    with phase("library categorical subpopulations: two banks, pop_frac [0.3, 0.7], a fixed key"), torch.no_grad():
        banks = []
        for scale in (1.0, 0.5):
            p = {k: (v * scale if k.endswith("_white") else v).to("cuda", torch.float32) for k, v in params.items()}
            with ppl.trace() as tr, ppl.substitute(data=p):
                cs = model.coefficients()
            banks.append((model.weights(cs, True), model.weights(cs, False)))
        gen = torch.Generator(device="cuda").manual_seed(seed)
        state = gen.get_state()
        for key in (seed, gen):
            runs = []
            for _ in range(2):
                _zero_counts()
                with ppl.trace() as tr:
                    hierarchical_likelihood((banks[0][0], banks[1][0]), banks[0][1], total_inj=float(constants["total_inj"]),
                                            Nobs=constants["nObs"], Tobs=constants["obs_time"], reconstruct_rate=False,
                                            categorical=True, rngkey=key, pop_frac=[0.3, 0.7], log=True)
                torch.cuda.synchronize()
                runs.append((tr.trace["Qs"]["value"], tr.trace["log_l"]["value"], DLSE_KERNEL.launches))
            (q0, l0, n0), (q1, l1, n1) = runs
            if not (torch.equal(q0, q1) and torch.equal(l0, l1)):
                raise AssertionError(f"rngkey {key}: two calls differ")
            if (n0, n1) != (2, 2) or not bool(torch.isfinite(l0).all()) or q0.shape != (constants["nObs"],):
                raise AssertionError(f"rngkey {key}: K1 launches {n0}, {n1}; Qs {tuple(q0.shape)}; log_l {l0}")
            log(f"  rngkey {'int' if isinstance(key, int) else 'cuda generator'}: Qs ({q0.device.type}) "
                f"{int(q0.sum())} of {q0.numel()} events in the second subpopulation, log_l "
                f"[{float(l0.min()):.3f}, {float(l0.max()):.3f}], two calls equal bit for bit, K1 2 a call")
        if not torch.equal(gen.get_state(), state):
            raise AssertionError("the caller's generator was advanced")


def library_route(args, catalog, gen):
    """The rest of the model library on the card: the reference-style
    B-spline model with independent spins on both routes, its NUTS run and
    PPDs, every other new model class, and categorical subpopulations.
    Returns ``(K1 launches of the NUTS run, log route gradient ms)``."""
    pedict, injdict, constants = catalog
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    pe = dict(pedict, **derived_columns(pedict))
    inj = dict(injdict, **derived_columns(injdict))
    params = library_routes((pe, inj, constants), gen)
    with phase("library model build, float32"):
        models = library_models(pe, inj, "cuda", torch.float32)
        torch.cuda.synchronize()
    with phase(f"library log route: gradient, {BSPLINE_CHAINS} chains, float32; CPU float64 reference check"):
        pot = ModelPotential(LibraryModel(pe, inj, constants, models, log=True), device="cuda", dtype=torch.float32)
        z = pot.unconstrain({k: v.to("cuda", torch.float32) for k, v in params.items()}, BSPLINE_CHAINS)
        u, g = pot.value_and_grad(z)
        if not (bool(torch.isfinite(u).all()) and bool(torch.isfinite(g).all())):
            raise AssertionError("library log route: potential or gradient not finite")
        times = [call_ms(lambda: pot.value_and_grad(z)) for _ in range(10)]
        grad_ms = float(np.median(times))
        log(f"  one batched potential + gradient: {grad_ms:.3f} ms (CUDA events, median of 10)")
        check_library_against_cpu((pedict, injdict, constants), params)
    with phase("profile of one library log-route potential + gradient"):
        profile_routes({"library log": pot}, z)
    n_k1, posterior = library_nuts((pe, inj, constants), models, args)
    library_ppds(posterior, models["z"])
    library_categorical((pe, inj, constants), models, params, args.seed)
    del models, pot
    torch.cuda.empty_cache()
    library_model_classes((pe, inj, constants), args.seed)
    log(f"  library phase: {time.perf_counter() - t0:.2f} s, peak memory allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return n_k1, grad_ms


# ----------------------------------------------------------------- scheduler


def loop_model_runs(steps, scheduler, leapfrogs=1, segment=None):
    """Model runs of ``MCMC``'s transition loop, from the leapfrogs
    ``steps`` ``(T, C)`` of every transition (``MCMC.transition_steps``):
    sync, one a leapfrog round, ``sum_t max_c steps``; async, ``leapfrogs``
    a round, where chain ``c`` needs ``sum_t ceil(steps / leapfrogs)``
    rounds and the chains wait for each other at the end of each
    ``segment`` transitions: ``sum_seg max_c sum_t L * ceil(steps / L)``.
    Not for collective adaptation under async, whose window barrier parks
    chains."""
    steps = torch.as_tensor(steps, dtype=torch.int64)
    if scheduler == "sync":
        return int(steps.max(1).values.sum())
    seg = segment or max(steps.shape[0], 1)
    rounds = (steps + leapfrogs - 1) // leapfrogs
    return leapfrogs * sum(int(rounds[s : s + seg].sum(0).max()) for s in range(0, steps.shape[0], seg))


def outside_loop_runs(mcmc, seed, *model_args, init_params=None):
    """Model runs of ``mcmc``'s run outside its transition loop (the site
    probe, the starts' search or gradient, the step-size search): those of
    a run of the same kernel, chains, device and dtype with no transitions,
    from the same seed and starts."""
    again = MCMC(mcmc.kernel, num_warmup=0, num_samples=0, num_chains=mcmc.num_chains, device=mcmc.device,
                 dtype=mcmc.dtype)
    with ModelRuns() as runs:
        again.run(seed, *model_args, init_params=init_params)
    return runs.runs


def check_async_runs(label, mcmc, runs, outside):
    """A NUTS route's run went through the async scheduler: its ``runs``
    model runs are ``outside`` the loop plus the async formula for its
    ``num_steps``, one host read a round; prints the sync formula's count
    for the same ``num_steps`` beside them."""
    steps = mcmc.transition_steps
    loop = loop_model_runs(steps, "async", 1, mcmc.max_steps_per_call)
    sync = loop_model_runs(steps, "sync")
    log(f"  model runs {runs} = {outside} outside the loop + {loop} in it (async: per segment, the max over chains "
        f"of the sum of its leapfrogs); the sync formula gives {sync} for the same num_steps "
        f"({sync / max(loop, 1):.3f}x); {mcmc.host_reads} host reads")
    if runs != outside + loop or mcmc.host_reads != loop:
        raise AssertionError(f"{label} route: {runs} model runs and {mcmc.host_reads} host reads; the async "
                             f"scheduler gives {outside} + {loop} and {loop}")


def _same_run(a, b):
    """The fields of two runs that differ, of the samples, the six extra
    fields, the step size, the inverse mass matrix and the final generator
    state."""
    diff = [k for k, v in a.get_samples().items() if not torch.equal(v, b.get_samples()[k])]
    diff += [k for k, v in a.get_extra_fields().items() if not torch.equal(v, b.get_extra_fields()[k])]
    return diff + [k for k in ("step_size", "inverse_mass_matrix", "rng_key")
                   if not torch.equal(a.post_warmup_state[k], b.post_warmup_state[k])]


def scheduler_phase(model, args, init):
    """The flat route's NUTS run (16 chains, dense mass, depth 6, the same
    seed and starts) at ``SCHED_WARMUP`` + ``SCHED_SAMPLES`` transitions
    under the sync scheduler, the async one at L = 1 and at L = 4: the three
    are equal bit for bit, each run's model runs and host reads follow its
    scheduler's formula, and K1 launches twice a model run."""
    kernel = NUTS(model, dense_mass=True, max_tree_depth=MAX_TREE_DEPTH)
    runs_of = {}
    with phase(f"schedulers on the flat route: sync, async L=1, async L=4; {SCHED_WARMUP} warmup + "
               f"{SCHED_SAMPLES} samples, {N_CHAINS} chains, dense mass, depth {MAX_TREE_DEPTH}"):
        for label, scheduler, L in (("sync", "sync", 1), ("async L=1", "async", 1), ("async L=4", "async", 4)):
            mcmc = MCMC(kernel, num_warmup=SCHED_WARMUP, num_samples=SCHED_SAMPLES, num_chains=N_CHAINS,
                        chain_scheduler=scheduler, leapfrogs_per_round=L if scheduler == "async" else None,
                        device="cuda", dtype=torch.float32)
            _zero_counts()
            t0 = time.perf_counter()
            with ModelRuns() as runs:
                mcmc.run(args.seed, init_params=flat_starts(init))
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n_k1 = _check_k1_only(label, runs.runs)
            runs_of[label] = (mcmc, runs.runs, n_k1, wall)
        outside = outside_loop_runs(mcmc, args.seed, init_params=flat_starts(init))
        base = runs_of["sync"][0]
        for label, (mcmc, runs, n_k1, wall) in runs_of.items():
            scheduler, L = ("sync", 1) if label == "sync" else ("async", mcmc.leapfrogs_per_round)
            loop = loop_model_runs(mcmc.transition_steps, scheduler, L)
            log(f"  {label}: {runs} model runs ({outside} outside the loop + {loop}), {mcmc.host_reads} host reads, "
                f"K1 {n_k1} launches, wall {wall:.2f} s (init {mcmc.timings['init']:.2f}, warmup "
                f"{mcmc.timings['warmup']:.2f}, sampling {mcmc.timings['sample']:.2f})")
            if runs != outside + loop or mcmc.host_reads != loop // L:
                raise AssertionError(f"{label}: {runs} model runs and {mcmc.host_reads} host reads, want "
                                     f"{outside} + {loop} and {loop // L}")
            diff = _same_run(mcmc, base)
            if diff:
                raise AssertionError(f"{label} differs from the sync scheduler's run in {diff}")
        log("  samples, the six extra fields, step size, inverse mass matrix and generator state equal bit for bit "
            "across the three runs")


# ----------------------------------------------------------------- config route (K1)


class ModelRuns(Messenger):
    """Counts the model's runs: each run adds the ``log_likelihood`` factor
    once (a gradient, a probe, a batch of deterministic sites)."""

    def __init__(self):
        super().__init__()
        self.runs = 0

    def process_message(self, msg):
        if msg["type"] == "sample" and msg["name"] == "log_likelihood":
            self.runs += 1


def config_reader(num_warmup=None, num_samples=None, trajectory_length=None):
    """A :class:`ConfigReader` of ``CONFIG_VALIDATION``, its sampler block
    cut to the smoke's transitions and depth; with ``trajectory_length`` its
    kernel is HMC (dense mass) with that trajectory length."""
    conf = json.loads(json.dumps(CONFIG_VALIDATION))
    if num_warmup is not None:
        conf["sampler"]["mcmc_kwargs"].update(num_warmup=num_warmup, num_samples=num_samples)
        conf["sampler"]["kernel_kwargs"]["max_tree_depth"] = MAX_TREE_DEPTH
    if trajectory_length is not None:
        conf["sampler"]["kernel"] = "HMC"
        conf["sampler"]["kernel_kwargs"] = {"dense_mass": True, "trajectory_length": trajectory_length}
    reader = ConfigReader()
    reader.parse_dict(conf)
    return reader


def config_init(num_chains, gen):
    """``CONFIG_INIT`` jittered per chain, float64 on the generator's device."""
    u = torch.rand(len(CONFIG_INIT), num_chains, generator=gen, device=gen.device, dtype=torch.float64)
    return {k: c + w * (2.0 * u[i] - 1.0) for i, (k, (c, w)) in enumerate(CONFIG_INIT.items())}


def config_potential(pedict, injdict, constants, device, dtype):
    """The config model's potential on the catalog, on ``device`` in ``dtype``."""
    args = (to_tensors(pedict, device, dtype), to_tensors(injdict, device, dtype), constants["total_inj"],
            constants["nObs"], constants["obs_time"])
    return ModelPotential(model_from_reader(config_reader()), args, device=device, dtype=dtype)


def check_config_against_cpu(pedict, injdict, constants, params, n_events=10, n_found=10000):
    """The config route's float32 potential and gradient on the card against
    a float64 CPU evaluation (K1's plain version) on a slice of the catalog,
    as :func:`check_against_cpu` does for the flat route."""
    pe = {k: v[:n_events] for k, v in pedict.items()}
    inj = {k: v[:n_found] for k, v in injdict.items()}
    const = dict(constants, nObs=n_events)
    C = next(iter(params.values())).shape[0]
    out = []
    for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        pot = config_potential(pe, inj, const, dev, dtype)
        z = pot.unconstrain({k: v.to(dev, dtype) for k, v in params.items()}, C)
        out.append([t.double().cpu() for t in pot.value_and_grad(z)])
    (u32, g32), (u64, g64) = out
    if not (torch.isfinite(u64).all() and (u64.abs() < 1e30).all()):
        raise AssertionError(f"reference potential off the likelihood walls expected, got {u64}")
    torch.testing.assert_close(u32, u64, rtol=1e-4, atol=1e-3)
    rel = float((g32 - g64).norm() / g64.norm())
    if not rel < 1e-3:
        raise AssertionError(f"float32 card gradient differs from the float64 CPU one: relative error {rel:.3e}")
    log(f"  C={C}: card f32 vs CPU f64 on {n_events} events x {N_SAMPLES} + {n_found} injections: "
        f"max|dU|={float((u32 - u64).abs().max()):.3e}, grad rel err={rel:.3e}")


def config_gradients(pedict, injdict, constants, gen):
    """The config route's potential and gradient for each of
    ``CONFIG_CHAINS``: against the CPU, timed (CUDA events, median of 10)
    and profiled.  Returns ``{C: ms}``."""
    ms = {}
    with phase("config route: model build"):
        pot = config_potential(pedict, injdict, constants, "cuda", torch.float32)
        torch.cuda.synchronize()
        log(f"  sites {pot.names} ({pot.dim} unconstrained coordinates)")
    for C in CONFIG_CHAINS:
        params = config_init(C, gen)
        with phase(f"config route: reference check, C={C}"):
            check_config_against_cpu(pedict, injdict, constants, params)
        with phase(f"config route: potential + gradient, C={C}"):
            z = pot.unconstrain({k: v.float() for k, v in params.items()}, C)
            u, g = pot.value_and_grad(z)
            if not (bool(torch.isfinite(u).all()) and bool(torch.isfinite(g).all()) and bool((u.abs() < 1e30).all())):
                raise AssertionError(f"config route: potential or gradient not finite or on a wall at C={C}: {u}")
            ms[C] = float(np.median([call_ms(lambda: pot.value_and_grad(z)) for _ in range(10)]))
            log(f"  one batched potential + gradient at C={C}: {ms[C]:.3f} ms (CUDA events around each call, "
                "median of 10)")
        with phase(f"config route: profile, C={C}"):
            profile_routes({f"config C={C}": pot}, z)
    return ms


def config_nuts(pedict, injdict, constants, args):
    """The config's sampler block through the CLI's ``run_config`` (NUTS,
    dense mass, 4 chains, ``--warmup`` + ``--samples`` transitions, depth
    6), then one posterior-predictive site, with the K1, K2 and K3 launch
    counts zeroed just before and read just after; K1 must launch twice per
    model run and K2 and K3 never.  Returns the K1 launches."""
    reader = config_reader(args.warmup, args.samples)
    n_chains = reader.sampler_conf["mcmc_kwargs"]["num_chains"]
    ppc_site = "mass_1_obs_event_0"
    _zero_counts()
    with phase(f"config route: NUTS through run_config, {args.warmup} warmup + {args.samples} samples, "
               f"{n_chains} chains, dense mass, depth {MAX_TREE_DEPTH}"), ModelRuns() as runs:
        t0 = time.perf_counter()
        mcmc, posterior = run_config(reader, pedict, injdict, constants, rng_seed=args.seed, device="cuda",
                                     dtype=torch.float32)
        wall = time.perf_counter() - t0
        runs_run = runs.runs
        ppc = mcmc.get_deterministic(site_names={ppc_site})
        torch.cuda.synchronize()
    n_k1 = DLSE_KERNEL.launches
    others = (STREAMED_FWD_KERNEL.launches, STREAMED_BWD_KERNEL.launches, FLW_KERNEL.launches)
    n_draws = args.samples * n_chains
    check_async_runs("config", mcmc, runs_run - math.ceil(n_draws / 64),
                     outside_loop_runs(mcmc, args.seed, *mcmc._potential.model_args))
    log(f"  launches on the config route: K1 {n_k1} over {runs.runs} model runs ({runs_run} in run_config, "
        f"{runs.runs - runs_run} for the posterior-predictive site); K2 forward, K2 backward, K3: {others}")
    if n_k1 != 2 * runs.runs or n_k1 == 0:
        raise AssertionError(f"K1 launched {n_k1} times over {runs.runs} model runs; two a run expected")
    if any(others):
        raise AssertionError(f"K2 or K3 ran on the config route: {others}")
    want = set(mcmc.get_samples()) | set(DETERMINISTIC_SITES)
    if set(posterior) != want:
        raise AssertionError(f"config posterior has {sorted(posterior)}, want {sorted(want)}")
    for k, v in {**posterior, **ppc}.items():
        if tuple(v.shape) != (n_draws,) or not bool(torch.isfinite(v).all()):
            raise AssertionError(f"config route, site {k}: values of shape {tuple(v.shape)} not finite")
    extra = mcmc.get_extra_fields()
    log(f"  wall {wall:.2f} s for run_config (init {mcmc.timings['init']:.2f} s, warmup "
        f"{mcmc.timings.get('warmup', 0.0):.2f} s, sampling {mcmc.timings['sample']:.2f} s); mean tree depth "
        f"{float(extra['tree_depth'].double().mean()):.2f}, divergences {int(extra['diverging'].sum())}, "
        f"mean accept {float(extra['accept_prob'].mean()):.3f}, leapfrogs in sampling {int(extra['num_steps'].sum())}")
    log(f"  {len(posterior)} posterior sites and {ppc_site} finite; posterior means "
        + ", ".join(f"{k}={float(v.double().mean()):.3f}" for k, v in sorted(posterior.items())))
    return n_k1


def _zero_counts():
    DLSE_KERNEL.launches = STREAMED_FWD_KERNEL.launches = STREAMED_BWD_KERNEL.launches = FLW_KERNEL.launches = 0


def _check_k1_only(label, runs):
    """K1 launched exactly twice per model run over ``runs`` runs, K2 and K3
    never; returns the K1 launches."""
    n_k1 = DLSE_KERNEL.launches
    others = (STREAMED_FWD_KERNEL.launches, STREAMED_BWD_KERNEL.launches, FLW_KERNEL.launches)
    log(f"  launches under {label}: K1 {n_k1} over {runs} model runs; K2 forward, K2 backward, K3: {others}")
    if n_k1 != 2 * runs or n_k1 == 0:
        raise AssertionError(f"{label}: K1 launched {n_k1} times over {runs} model runs; two a run expected")
    if any(others):
        raise AssertionError(f"{label}: K2 or K3 ran: {others}")
    return n_k1


def hmc_trajectory_length(pedict, injdict, constants, seed, num_chains):
    """``HMC_LEAPFROGS`` times the smallest step size the HMC run's own
    search will find: the same seed, the same starts (the config route's
    init search) and the same doubling search on the unit mass matrix that
    ``MCMC.run`` does before warmup."""
    pot = config_potential(pedict, injdict, constants, "cuda", torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    z0 = find_valid_initial_params(pot, num_chains, gen)
    state = nuts_init(pot, z0)
    mm = identity_mass_matrix(num_chains, pot.dim, True, torch.float32, "cuda")
    eps = find_reasonable_step_size(pot, mm, state.z, gen, 1.0, pe_grad=(state.pe, state.grad))
    log(f"  the search's step sizes at the run's starts: {[round(float(e), 5) for e in eps]}")
    return HMC_LEAPFROGS * float(eps.min())


def config_hmc(pedict, injdict, constants, args):
    """The config route's sampler block with ``kernel: HMC`` (dense mass,
    the trajectory length of :func:`hmc_trajectory_length`, 4 chains,
    ``HMC_WARMUP`` + ``HMC_SAMPLES``) through ``run_config``, with the launch
    counts zeroed just before and read just after: every site finite,
    divergences at most 10% of the sampling transitions, K1 twice per model
    run, K2 and K3 never.  Returns the K1 launches."""
    n_chains = CONFIG_VALIDATION["sampler"]["mcmc_kwargs"]["num_chains"]
    with phase("config route, HMC: trajectory length"):
        length = hmc_trajectory_length(pedict, injdict, constants, args.seed, n_chains)
        log(f"  trajectory_length L = {length:.5f} ({HMC_LEAPFROGS} leapfrogs at the smallest step size)")
    reader = config_reader(HMC_WARMUP, HMC_SAMPLES, trajectory_length=length)
    _zero_counts()
    with phase(f"config route: HMC through run_config, {HMC_WARMUP} warmup + {HMC_SAMPLES} samples, "
               f"{n_chains} chains, dense mass, L = {length:.5f}"), ModelRuns() as runs:
        t0 = time.perf_counter()
        mcmc, posterior = run_config(reader, pedict, injdict, constants, rng_seed=args.seed, device="cuda",
                                     dtype=torch.float32)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n_k1 = _check_k1_only("HMC on the config route", runs.runs)
    if type(mcmc.kernel).__name__ != "HMC":
        raise AssertionError(f"run_config ran {type(mcmc.kernel).__name__}, not HMC")
    n_draws = HMC_SAMPLES * n_chains
    for k, v in posterior.items():
        if tuple(v.shape) != (n_draws,) or not bool(torch.isfinite(v).all()):
            raise AssertionError(f"HMC config route, site {k}: values of shape {tuple(v.shape)} not finite")
    extra = mcmc.get_extra_fields()
    steps, n_div = extra["num_steps"], int(extra["diverging"].sum())
    rounds = int(mcmc.get_extra_fields(group_by_chain=True)["num_steps"].max(0).values.sum())
    log(f"  wall {wall:.2f} s (init {mcmc.timings['init']:.2f} s, warmup {mcmc.timings.get('warmup', 0.0):.2f} s, "
        f"sampling {mcmc.timings['sample']:.2f} s); {runs.runs} model runs ({rounds} leapfrog rounds in sampling, "
        f"{runs.runs - rounds} before it: the probe, the searches, warmup); leapfrogs per transition in sampling "
        f"(num_steps): mean {float(steps.double().mean()):.1f}, min {int(steps.min())}, max {int(steps.max())}; "
        f"final step sizes {[round(float(e), 5) for e in mcmc._adapt_info['step_size']]}")
    log(f"  divergences {n_div} of {steps.numel()} transitions, mean accept {float(extra['accept_prob'].mean()):.3f}; "
        f"{len(posterior)} sites finite; posterior means "
        + ", ".join(f"{k}={float(v.double().mean()):.3f}" for k, v in sorted(posterior.items())))
    if n_div > 0.1 * steps.numel():
        raise AssertionError(f"HMC on the config route: {n_div} divergences in {steps.numel()} transitions")
    return n_k1


def bench_flat_model(catalog, z_model):
    pedict, injdict, constants = catalog
    return BenchModel(pedict, injdict, constants, z_model, device="cuda", dtype=torch.float32)


def svi_route(catalog, z_model, args):
    """SVI on the bench flat route at C = 1: AutoDelta from ``FIDUCIAL_INIT``
    with ``Adam(SVI_LR)`` for ``SVI_STEPS`` steps through ``find_map`` and
    through ``SVI``, then AutoNormal (centred on ``FIDUCIAL_INIT``: from
    random starts a particle may land on an n_eff wall, whose potential of
    3.4e38 overflows the float32 mean of two) with ``SVI_PARTICLES``
    particles for ``SVI_NORMAL_STEPS`` steps, the launch counts zeroed just before and read
    just after; K1 twice per model run (each run builds its guide's
    potential with one model run, then one a step).  Returns ``(K1
    launches, ms per AutoDelta step)``."""
    model = bench_flat_model(catalog, z_model)
    _zero_counts()
    with phase(f"SVI on the bench flat route: find_map and SVI (AutoDelta, Adam({SVI_LR}), {SVI_STEPS} steps), "
               f"AutoNormal ({SVI_PARTICLES} particles, {SVI_NORMAL_STEPS} steps)"), ModelRuns() as runs:
        est = find_map(args.seed, model, Niter=SVI_STEPS, lr=SVI_LR, init_values=FIDUCIAL_INIT, device="cuda")
        guide = AutoDelta(model, init_values=FIDUCIAL_INIT)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = SVI(model, guide, Adam(SVI_LR), Trace_ELBO(), device="cuda").run(args.seed, SVI_STEPS)
        torch.cuda.synchronize()
        ms_step = (time.perf_counter() - t0) / SVI_STEPS * 1e3
        normal = AutoNormal(model, init_values=FIDUCIAL_INIT)
        res_n = SVI(model, normal, Adam(SVI_LR), Trace_ELBO(num_particles=SVI_PARTICLES), device="cuda").run(
            args.seed, SVI_NORMAL_STEPS)
        draws = normal.sample_posterior(args.seed, res_n.params, sample_shape=(100,))
        torch.cuda.synchronize()
    n_k1 = _check_k1_only("SVI on the bench flat route", runs.runs)
    want_runs = 3 + 2 * SVI_STEPS + SVI_NORMAL_STEPS
    if runs.runs != want_runs:
        raise AssertionError(f"SVI ran the model {runs.runs} times, {want_runs} expected (one a step and one a run)")
    losses, losses_n = res.losses, res_n.losses
    if not (bool(torch.isfinite(losses).all()) and float(losses[-1]) < float(losses[0])):
        raise AssertionError(f"AutoDelta losses not finite or not falling: {float(losses[0])} -> {float(losses[-1])}")
    if not (bool(torch.isfinite(losses_n).all()) and all(bool(torch.isfinite(v).all()) for v in draws.values())):
        raise AssertionError("AutoNormal losses or draws not finite")
    map_svi = guide.median(res.params)
    if not all(bool(torch.isfinite(v).all()) for v in est.values()):
        raise AssertionError("find_map's estimate not finite")
    gap = max(float((est[k] - map_svi[k]).abs()) for k in est)
    log(f"  AutoDelta loss {float(losses[0]):.3f} -> {float(losses[-1]):.3f} in {SVI_STEPS} steps, {ms_step:.3f} ms a "
        f"step (host clock, synchronized); find_map against SVI's AutoDelta: max |difference| {gap:.3e}")
    log("  |MAP - TRUTH|: " + ", ".join(f"{k} {abs(float(est[k]) - v):.4f}" for k, v in TRUTH.items())
        + f"; unscaled_rate {float(est['unscaled_rate']):.3f}")
    log(f"  AutoNormal loss {float(losses_n[0]):.3f} -> {float(losses_n[-1]):.3f} in {SVI_NORMAL_STEPS} steps; "
        f"100 guide draws finite")
    return n_k1, ms_step


def _inside_supports(potential, particles):
    """Every particle inside its site's support (open intervals, positive
    reals, finite reals)."""
    for k, v in particles.items():
        t = potential.transforms[k]
        ok = torch.isfinite(v)
        if isinstance(t, IntervalTransform):
            ok &= (v > t.low) & (v < t.high)
        elif isinstance(t, ExpTransform):
            ok &= v > 0
        if not bool(ok.all()):
            raise AssertionError(f"SMC site {k}: {int((~ok).sum())} particles outside the support")


def smc_base_walls(model, seed, scales=(2.0, 1.0, 0.5, SMC_BASE_SCALE)):
    """For bases N(0, scale) in unconstrained space: the share of
    ``SMC_PARTICLES`` draws on the n_eff walls (potential >= 1e30) and the
    ESS at the smallest beta SMC's bisection can try first (2^-17, within
    its 1e-5 tolerance of 0), against the target of half the particles."""
    pot = ModelPotential(model, device="cuda", dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for scale in scales:
        z = scale * torch.randn(SMC_PARTICLES, pot.dim, generator=gen, device="cuda")
        with torch.no_grad():
            pe_post = pot(z)
        pe_base = 0.5 * ((z / scale) ** 2).sum(-1) + pot.dim * math.log(scale)
        ess = float(smc_ess(smc_incremental_logw(2.0**-17, 0.0, pe_post, pe_base)))
        log(f"  base N(0, {scale}): {float((pe_post.abs() >= 1e30).double().mean()):.1%} of {SMC_PARTICLES} draws on "
            f"the walls; ESS at beta = 2^-17: {ess:.1f} (target {SMC_PARTICLES // 2})")


def smc_route(catalog, z_model, args):
    """SMC on the bench flat route, ``SMC_PARTICLES`` particles and
    ``SMC_MUTATIONS`` mutation steps (the JAX package's defaults) from a
    base of scale ``SMC_BASE_SCALE``, the
    launch counts zeroed just before and read just after: at least one
    stage, the last at beta = 1 within ``max_stages``, a finite log
    evidence, particles finite and inside their supports, K1 twice per model
    run over ``2 + stages * mutation steps`` runs (the potential's site
    probe, the first particles, each mutation step).  Returns ``(K1
    launches, stages, peak GB)``."""
    model = bench_flat_model(catalog, z_model)
    with phase("SMC's base against the likelihood walls"):
        smc_base_walls(model, args.seed)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    smc = SMC(model, num_particles=SMC_PARTICLES, num_mutation_steps=SMC_MUTATIONS, base_scale=SMC_BASE_SCALE,
              device="cuda")
    _zero_counts()
    with phase(f"SMC on the bench flat route: {SMC_PARTICLES} particles, {SMC_MUTATIONS} mutation steps, "
               f"base N(0, {SMC_BASE_SCALE})"), ModelRuns() as runs:
        t0 = time.perf_counter()
        res = smc.run(args.seed)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    n_k1 = _check_k1_only("SMC on the bench flat route", runs.runs)
    stages = int(res.num_stages)
    if runs.runs != 2 + stages * SMC_MUTATIONS:
        raise AssertionError(f"SMC ran the model {runs.runs} times over {stages} stages")
    betas = smc.betas
    log(f"  {stages} stages in {wall:.2f} s ({runs.runs} model runs), final acceptance "
        f"{float(res.final_acceptance):.3f}, log evidence {float(res.log_evidence):.4f}, peak memory {peak:.2f} GB; "
        f"betas {[float(f'{b:.3g}') for b in betas[:4]]} ... {[float(f'{b:.3g}') for b in betas[-3:]]}")
    if not (stages >= 1 and betas and betas[-1] == 1.0 and stages <= smc.max_stages):
        raise AssertionError(f"SMC did not reach beta = 1 within {smc.max_stages} stages (last {betas[-1:]})")
    if not math.isfinite(float(res.log_evidence)):
        raise AssertionError("SMC log evidence not finite")
    _inside_supports(ModelPotential(model, device="cuda", dtype=torch.float32), res.particles)
    log("  particles finite and inside their supports; means "
        + ", ".join(f"{k}={float(v.double().mean()):.3f}" for k, v in sorted(res.particles.items())))
    return n_k1, stages, peak


def config_route(args, catalog, gen):
    """The config-driven route: ``CONFIG_VALIDATION``'s model on the catalog,
    its gradient checked, timed and profiled, then its sampler block.
    Returns ``(K1 launches, {C: gradient ms})``."""
    pedict, injdict, constants = catalog
    ms = config_gradients(pedict, injdict, constants, gen)
    torch.cuda.empty_cache()
    return config_nuts(pedict, injdict, constants, args), ms


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    # the routes of earlier slices; HMC runs HMC_WARMUP + HMC_SAMPLES
    parser.add_argument("--warmup", type=int, default=10)
    parser.add_argument("--samples", type=int, default=5)
    args = parser.parse_args(argv)

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script runs only on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(args.seed)

    with phase("environment"):
        log(f"  python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
        card = card_line()
        log(f"  card: {card}")
    with phase("build"):
        secs = build_all([DLSE_KERNEL, STREAMED_FWD_KERNEL, STREAMED_BWD_KERNEL, FLW_KERNEL])
        log(f"  K1 (dlse.cu), K2 (streamed.cu) and K3 (flw.cu) built with nvcc for sm_90a, in parallel, in {secs:.2f} s")
    with phase("K1 against its plain version"):
        k1 = check_k1(gen)
    k1_launches, (pedict, injdict, constants, z_model), init, flat_potential, z0 = flat_route(args, gen)

    with phase("streamed model build"):
        model_s = BenchModel(pedict, injdict, constants, z_model, device="cuda", dtype=torch.float32, streamed=True)
        torch.cuda.synchronize()
    with phase("K2 against its plain version"):
        # the main path's 16 starts and one more, for the odd chain count
        extra = jittered_init(1, gen, dtype=torch.float64)
        init_k2 = {k: torch.cat([v.to("cuda"), extra[k]]) for k, v in init.items()}
        k2 = check_k2(model_s, k2_theta(init_k2, z_model), gen)
    n_fwd, n_bwd, flat_ms, streamed_ms = streamed_route(args, model_s, init, flat_potential, z0)
    del model_s, flat_potential
    torch.cuda.empty_cache()
    k3, k3_launches, bspline_ms = bspline_route(args, (pedict, injdict, constants), gen)
    torch.cuda.empty_cache()
    config_launches, config_ms = config_route(args, (pedict, injdict, constants), gen)
    torch.cuda.empty_cache()
    library_launches, library_ms = library_route(args, (pedict, injdict, constants), gen)
    torch.cuda.empty_cache()
    hmc_launches = config_hmc(pedict, injdict, constants, args)
    svi_launches, svi_ms = svi_route((pedict, injdict, constants), z_model, args)
    smc_launches, smc_stages, smc_peak = smc_route((pedict, injdict, constants), z_model, args)

    pe, inj = k1["flat_pe"], k1["flat_inj"]
    k2_common = {"route": "cuda", "source": os.path.relpath(STREAMED_FWD_KERNEL.source_path, HERE),
                 "library_ms": None, "flat_route_grad_ms": flat_ms, "streamed_route_grad_ms": streamed_ms}
    kernels = {"kernels": [
        {
            "name": "K1 double_logsumexp",
            "route": "cuda",
            "source": os.path.relpath(DLSE_KERNEL.source_path, HERE),
            "replaces": DLSE_KERNEL.replaces,
            "launches": k1_launches,
            "max_abs_err": max(pe["max_abs_err"], inj["max_abs_err"]),
            # one gradient's two calls: the PE bank and the injection row
            "ms": pe["ms"] + inj["ms"],
            "plain_ms": pe["plain_ms"] + inj["plain_ms"],
            "bound_ms": pe["bound_ms"] + inj["bound_ms"],
            "bound_by": pe["bound_by"],
            "library_ms": pe["library_ms"] + inj["library_ms"],
            # the unfused B-spline route's two calls (C = 8)
            "bspline_unfused_ms": k1["bspline_pe"]["ms"] + k1["bspline_inj"]["ms"],
            # the config route: its two calls at C = 4 (kernel, plain, library,
            # bound), its launches over the NUTS run, its gradient at C = 4, 16
            "config_ms": k1["config_pe"]["ms"] + k1["config_inj"]["ms"],
            "config_plain_ms": k1["config_pe"]["plain_ms"] + k1["config_inj"]["plain_ms"],
            "config_library_ms": k1["config_pe"]["library_ms"] + k1["config_inj"]["library_ms"],
            "config_bound_ms": k1["config_pe"]["bound_ms"] + k1["config_inj"]["bound_ms"],
            "config_route_launches": config_launches,
            "config_route_grad_ms": {str(C): v for C, v in config_ms.items()},
            # the library model's log route: its NUTS run's launches and its
            # gradient at C = 8 (its linear route launches none)
            "library_route_launches": library_launches,
            "library_route_grad_ms": library_ms,
            # SMC's two calls at 1024 particles (kernel, plain, library, bound)
            "smc_ms": k1["smc_pe"]["ms"] + k1["smc_inj"]["ms"],
            "smc_plain_ms": k1["smc_pe"]["plain_ms"] + k1["smc_inj"]["plain_ms"],
            "smc_library_ms": k1["smc_pe"]["library_ms"] + k1["smc_inj"]["library_ms"],
            "smc_bound_ms": k1["smc_pe"]["bound_ms"] + k1["smc_inj"]["bound_ms"],
            # the launches under each of the other engines (two a model run)
            "hmc_launches": hmc_launches,
            "svi_launches": svi_launches,
            "smc_launches": smc_launches,
            "smc_stages": smc_stages,
            "smc_peak_gb": smc_peak,
            "svi_ms_per_step": svi_ms,
        },
        # one gradient's launches: the PE bank and the injection rows
        dict(k2_common, name="K2 streamed forward", replaces=STREAMED_FWD_KERNEL.replaces,
             also_replaces="gwinferno_tpu/ops/streamed.py:115", launches=n_fwd, **k2["fwd"]),
        dict(k2_common, name="K2 streamed backward", replaces=STREAMED_BWD_KERNEL.replaces,
             also_replaces="gwinferno_tpu/ops/streamed.py:134", launches=n_bwd, **k2["bwd"]),
        # one gradient's two launches at C = 8: the PE bank and the injection row
        dict(name="K3 fused_logweight_logsumexp", route="cuda", source=os.path.relpath(FLW_KERNEL.source_path, HERE),
             replaces=FLW_KERNEL.replaces, launches=k3_launches, fused_route_grad_ms=bspline_ms["fused"],
             unfused_route_grad_ms=bspline_ms["unfused"], **k3),
    ]}
    log(card)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
