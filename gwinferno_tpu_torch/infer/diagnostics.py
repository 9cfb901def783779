"""Convergence diagnostics: effective sample size, split R-hat, the HPDI and
the posterior summary.

Counterpart of ``gwinferno_tpu/infer/diagnostics.py`` (FFT autocorrelation
ESS with Geyer's initial monotone sequence; split R-hat), on host numpy.
Tensors are copied to the host first.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["effective_sample_size", "split_rhat", "hpdi", "summary", "print_summary"]


def _host(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = np.asarray(x, dtype=np.float64)
    return x[None] if x.ndim == 1 else x


def _autocovariance(x):
    """Autocovariance along axis 0 via FFT.  x: (n, chains)."""
    n = x.shape[0]
    xc = x - x.mean(axis=0, keepdims=True)
    size = 2 ** int(np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(xc, size, axis=0)
    acov = np.fft.irfft(f * np.conj(f), size, axis=0)[:n].real
    return acov / n


def effective_sample_size(x):
    """ESS for draws ``x`` of shape (chains, n).  Returns a float."""
    x = _host(x)
    m, n = x.shape
    if np.all(x == x[:, :1]):
        # every chain constant = a stuck sampler, not perfect mixing
        return 0.0
    if n < 4:
        return float(m * n)
    acov = _autocovariance(x.T)  # (n, m)
    mean_var = acov[0].mean()
    var_plus = mean_var * (n - 1) / n
    if m > 1:
        var_plus += x.mean(axis=1).var(ddof=1)
    if var_plus <= 0 or not np.isfinite(var_plus):
        return 0.0
    rho = 1.0 - (mean_var - acov.mean(axis=1)) / var_plus  # (n,)
    # Geyer initial positive + monotone sequence over pair sums
    npairs = (n - 1) // 2
    pair = rho[1 : 2 * npairs + 1].reshape(npairs, 2).sum(axis=1)
    pos = pair > 0
    if not pos.all():
        pair = pair[: int(np.argmax(~pos))]
    if len(pair) > 0:
        pair = np.minimum.accumulate(pair)
    tau = 1.0 + 2.0 * pair.sum() + rho[0] - 1.0  # rho[0] == 1
    tau = max(tau, 1.0 / np.log10(max(n, 10)))
    return float(m * n / tau)


def split_rhat(x):
    """Split R-hat for draws ``x`` of shape (chains, n)."""
    x = _host(x)
    m, n = x.shape
    half = n // 2
    if half < 2:
        return np.nan
    halves = np.concatenate([x[:, :half], x[:, half : 2 * half]], axis=0)  # (2m, half)
    W = halves.var(axis=1, ddof=1).mean()
    B = half * halves.mean(axis=1).var(ddof=1)
    if W <= 0:
        return np.nan
    return float(np.sqrt(((half - 1) / half * W + B / half) / W))


def hpdi(x, prob=0.9):
    """Highest posterior density interval ``(lo, hi)`` of 1-D draws: the
    narrowest window holding ``floor(prob * n)`` sorted draws."""
    x = np.sort(_host(x).ravel())
    n = len(x)
    size = max(1, int(np.floor(prob * n)))
    i = int(np.argmin(x[size:] - x[: n - size]))
    return x[i], x[i + size]


def summary(samples_by_chain, prob=0.9):
    """``{label: {statistic: value}}`` for samples ``{site: (chains, n,
    *event)}``: one row per site and event element (``name[i,j]``) with the
    mean, std, median, HPDI bounds, ESS and split R-hat."""
    rows = {}
    for name, arr in samples_by_chain.items():
        arr = arr.detach().cpu().numpy() if isinstance(arr, torch.Tensor) else np.asarray(arr)
        ev_shape = arr.shape[2:]
        for idx in [()] if ev_shape == () else list(np.ndindex(*ev_shape)):
            cell = arr[(slice(None), slice(None)) + idx]
            label = name if idx == () else f"{name}[{','.join(map(str, idx))}]"
            lo, hi = hpdi(cell, prob)
            rows[label] = {
                "mean": float(cell.mean()),
                "std": float(cell.std()),
                "median": float(np.median(cell)),
                f"{prob:.0%} hpdi lo": float(lo),
                f"{prob:.0%} hpdi hi": float(hi),
                "n_eff": effective_sample_size(cell),
                "r_hat": split_rhat(cell),
            }
    return rows


def print_summary(samples_by_chain, prob=0.9):
    """Print :func:`summary` as a table to stdout."""
    rows = summary(samples_by_chain, prob)
    if not rows:
        print("(no samples)")
        return
    cols = list(next(iter(rows.values())).keys())
    name_w = max(12, max(len(k) for k in rows))
    print(" ".join([f"{'':>{name_w}}"] + [f"{c:>12}" for c in cols]))
    for name, stats in rows.items():
        vals = " ".join(f"{v:12.3f}" if np.isfinite(v) else f"{'nan':>12}" for v in stats.values())
        print(f"{name:>{name_w}} {vals}")
