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
   torch version in float32 and float64, gradient included, at the main
   path's shapes plus all--inf and partly--inf rows; kernel, plain and
   library times;
4. the main path at full catalog width: a synthetic catalog made from
   ``--seed`` with numpy (69 events x 8000 PE samples, 46,770 found
   injections), the bench model's potential and gradient for 16 chains
   (checked against a float64 CPU evaluation on a slice of the catalog),
   then a 16-chain dense-mass NUTS run (depth 6) with warmup;
5. the kernels line (one JSON object), then the contract line
   ``{"ok": true, "device": {...}}``, last on stdout.

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
import time
from contextlib import contextmanager

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import torch  # noqa: E402

from gwinferno_tpu_torch.cosmology import PLANCK_2015_LVK_Cosmology as COSMO  # noqa: E402
from gwinferno_tpu_torch.infer import MCMC  # noqa: E402
from gwinferno_tpu_torch.infer import NUTS  # noqa: E402
from gwinferno_tpu_torch.infer.diagnostics import effective_sample_size  # noqa: E402
from gwinferno_tpu_torch.infer.diagnostics import split_rhat  # noqa: E402
from gwinferno_tpu_torch.models.parametric.parametric import PowerlawRedshiftModel  # noqa: E402
from gwinferno_tpu_torch.ops._build import build_all  # noqa: E402
from gwinferno_tpu_torch.ops.fused import DLSE_KERNEL  # noqa: E402
from gwinferno_tpu_torch.ops.fused import _dlse_torch  # noqa: E402
from gwinferno_tpu_torch.ops.fused import double_logsumexp  # noqa: E402
from gwinferno_tpu_torch.pipeline.bench_model import TRUTH  # noqa: E402
from gwinferno_tpu_torch.pipeline.bench_model import BenchModel  # noqa: E402
from gwinferno_tpu_torch.pipeline.bench_model import jittered_init  # noqa: E402
from gwinferno_tpu_torch.pipeline.bench_model import beta_ab  # noqa: E402
from gwinferno_tpu_torch.ppl import ModelPotential  # noqa: E402

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
    lines of something else: the input comes from device memory."""
    flush = torch.ones(16 * 2**20, dtype=torch.float32, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.sum()
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
        raise AssertionError("K1: infinities differ from the plain version")
    return float(torch.where(same_inf, 0.0, (got - want).abs()).max())


def check_k1(gen):
    """K1 against its plain version; returns the per-shape f32 results."""
    main_shapes = [("pe", (N_CHAINS * N_EVENTS, N_SAMPLES)), ("inj", (N_CHAINS, N_FOUND))]
    extra_shapes = [("all_-inf_rows", (8, 1000)), ("part_-inf_rows", (64, 3000))]
    tol = {torch.float32: dict(atol=1e-4, rtol=0.0), torch.float64: dict(atol=0.0, rtol=1e-12)}
    gtol = {torch.float32: dict(atol=1e-7, rtol=1e-4), torch.float64: dict(atol=1e-16, rtol=1e-10)}
    results = {}
    for dtype in (torch.float32, torch.float64):
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
            torch.cuda.synchronize()
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
            log(f"  K1 {name} {tuple(shape)} {str(dtype)[6:]}: max_abs_err={err:.3e} ok")
            if dtype == torch.float32 and name in ("pe", "inj"):
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
                log(
                    f"  K1 {name} {tuple(shape)} f32: kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
                    f"library_ms={lib_ms:.4f} bound_ms={max(bytes_ms, ops_ms):.4f} "
                    f"({results[name]['bound_by']}; {bytes_ms / k_ms:.1%} of the bound)"
                )
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


def main_path(args, gen):
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
    with phase(f"NUTS {args.warmup} warmup + {args.samples} samples, {N_CHAINS} chains, dense mass, depth {MAX_TREE_DEPTH}"):
        mcmc = MCMC(
            NUTS(model, dense_mass=True, max_tree_depth=MAX_TREE_DEPTH),
            num_warmup=args.warmup, num_samples=args.samples, num_chains=N_CHAINS, device=dev, dtype=dtype,
        )
        mcmc.run(args.seed, init_params={k: v.to(dev, dtype) for k, v in init.items()})
        torch.cuda.synchronize()
    launches = DLSE_KERNEL.launches
    if launches == 0:
        raise AssertionError("K1 was not launched on the main path")

    samples = mcmc.get_samples(group_by_chain=True)
    extra = mcmc.get_extra_fields()
    for k, v in samples.items():
        if tuple(v.shape) != (N_CHAINS, args.samples) or not bool(torch.isfinite(v).all()):
            raise AssertionError(f"site {k}: samples of shape {tuple(v.shape)} not finite")
    ess = {k: effective_sample_size(v) for k, v in samples.items()}
    rhat = {k: split_rhat(v) for k, v in samples.items()}
    n_grad = int(extra["num_steps"].sum())
    log(
        f"  timings: init {mcmc.timings['init']:.2f} s, warmup {mcmc.timings.get('warmup', 0.0):.2f} s, "
        f"sampling {mcmc.timings['sample']:.2f} s"
    )
    log(
        f"  mean tree depth {float(extra['tree_depth'].double().mean()):.2f}, "
        f"divergences {int(extra['diverging'].sum())}, mean accept {float(extra['accept_prob'].mean()):.3f}, "
        f"min ESS {min(ess.values()):.1f}, max split-Rhat {max(rhat.values()):.3f}, "
        f"leapfrogs in sampling {n_grad}, K1 launches {launches}"
    )
    log("  posterior means: " + ", ".join(f"{k}={float(v.double().mean()):.3f}" for k, v in sorted(samples.items())))
    return launches


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--warmup", type=int, default=30)
    parser.add_argument("--samples", type=int, default=20)
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
        secs = build_all([DLSE_KERNEL])
        log(f"  K1 built with nvcc for sm_90a in {secs:.2f} s")
    with phase("K1 against its plain version"):
        k1 = check_k1(gen)
    launches = main_path(args, gen)

    pe, inj = k1["pe"], k1["inj"]
    kernels = {"kernels": [{
        "name": "K1 double_logsumexp",
        "route": "cuda",
        "source": os.path.relpath(DLSE_KERNEL.source_path, HERE),
        "replaces": DLSE_KERNEL.replaces,
        "launches": launches,
        "max_abs_err": max(pe["max_abs_err"], inj["max_abs_err"]),
        # one gradient's two calls: the PE bank and the injection row
        "ms": pe["ms"] + inj["ms"],
        "plain_ms": pe["plain_ms"] + inj["plain_ms"],
        "bound_ms": pe["bound_ms"] + inj["bound_ms"],
        "bound_by": pe["bound_by"],
        "library_ms": pe["library_ms"] + inj["library_ms"],
    }]}
    log(card)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
