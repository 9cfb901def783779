"""Elementary population-model log-pdfs on torch tensors.

Counterpart of ``gwinferno_tpu/distributions.py`` for the functions the
powerlaw+peak main path uses.  The error function and log-gamma are torch's
own (``torch.special.erf``, ``torch.lgamma``): the JAX package's Cody and
Lanczos rational forms exist only because Pallas TPU kernels cannot lower
those primitives.

Every piecewise branch keeps the reference's guard semantics: out-of-support
points get the ``floor`` (``-inf`` by default), and the in-support formula is
evaluated at a clipped or otherwise safe operand, so the gradient stays
finite where the selected value is the floor (the double-``where`` pattern).

Bounds and data may be tensors or Python numbers; hyperparameters are
tensors that broadcast against the data (a leading chain axis is the
caller's choice of shape).
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "safe_log",
    "safe_logaddexp",
    "smooth",
    "log_powerlaw_pdf",
    "log_truncnorm_pdf",
    "log_betadist",
]

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


def _log(v):
    return torch.log(v) if isinstance(v, torch.Tensor) else math.log(v)


def _clip(x, low, high):
    """``clip(x, low, high)`` where either bound may be a tensor or a number."""
    x = torch.maximum(x, low) if isinstance(low, torch.Tensor) else x.clamp_min(low)
    return torch.minimum(x, high) if isinstance(high, torch.Tensor) else x.clamp_max(high)


def safe_log(p):
    """``log(p)`` with ``-inf`` at ``p <= 0`` and a zero (not NaN) gradient
    there."""
    pos = p > 0
    return torch.where(pos, torch.log(torch.where(pos, p, 1.0)), -math.inf)


def safe_logaddexp(a, b):
    """``logaddexp(a, b)`` whose gradient is zero (not NaN) where both inputs
    are ``-inf``."""
    both = (a == -math.inf) & (b == -math.inf)
    a_safe = torch.where(both, 0.0, a)
    b_safe = torch.where(both, 0.0, b)
    return torch.where(both, -math.inf, torch.logaddexp(a_safe, b_safe))


def smooth(dx, x, xmin):
    """Planck-taper low-mass window: 0 below ``xmin``, 1 from ``xmin + dx``,
    ``sigmoid(-(dx/(x-xmin) + dx/(x-xmin-dx)))`` in between."""
    below = x < xmin
    above = x >= xmin + dx
    in_window = ~below & ~above
    safe_x = torch.where(in_window, x, xmin + 0.5 * dx)
    z = dx / (safe_x - xmin) + dx / (safe_x - xmin - dx)
    window = torch.sigmoid(-z)
    return torch.where(below, 0.0, torch.where(above, 1.0, window))


def _powerlaw_log_norm(alpha, low, high):
    """log of the truncated-powerlaw normalization on ``[low, high]``.

    ``alpha == -1`` takes the logarithmic normalization.  The span
    ``|high^(1+a) - low^(1+a)|`` is evaluated in log space through ``expm1``
    (the direct difference cancels in float32 when per-sample bounds such as
    ``mmin/m1`` approach ``high``), clamped to the dtype's eps so that
    degenerate supports keep a finite gradient."""
    is_m1 = alpha == -1.0
    ap1 = 1.0 + torch.where(is_m1, 0.0, alpha)
    log_low, log_high = _log(low), _log(high)
    a = ap1 * log_high
    b = ap1 * log_low
    eps = torch.finfo(ap1.dtype).eps
    d = torch.abs(a - b).clamp_min(eps)
    log_span = torch.maximum(a, b) + torch.log(-torch.expm1(-d))
    generic = torch.log(torch.abs(ap1)) - log_span
    span = log_high - log_low
    if isinstance(span, torch.Tensor):
        special = -torch.log(span.abs().clamp_min(eps))
    else:
        special = -math.log(max(abs(span), eps))
    return torch.where(is_m1, special, generic)


def log_powerlaw_pdf(xx, alpha, low, high, floor=-math.inf):
    """Log-pdf of the sharply truncated powerlaw ``x**alpha`` on
    ``[low, high]``; ``floor`` outside."""
    oob = (xx < low) | (xx > high)
    log_safe_x = torch.log(_clip(xx, low, high))
    logp = alpha * log_safe_x + _powerlaw_log_norm(alpha, low, high)
    return torch.where(oob, floor, logp)


def _norm_cdf(z):
    return 0.5 * (1.0 + torch.special.erf(z / math.sqrt(2.0)))


def log_truncnorm_pdf(xx, mu, sig, low, high, log=False):
    """Log-pdf of a normal truncated to ``[low, high]`` (``log=True``: a
    truncated lognormal, with the ``1/x`` Jacobian); ``-inf`` outside."""
    if log:
        u = torch.log(_clip(xx, low, high))
        lo, hi = _log(low), _log(high)
        jac = -u
    else:
        u = _clip(xx, low, high)
        lo, hi = low, high
        jac = 0.0
    denom = _norm_cdf((hi - mu) / sig) - _norm_cdf((lo - mu) / sig)
    logp = -0.5 * ((u - mu) / sig) ** 2 - torch.log(sig) - _LOG_SQRT_2PI - torch.log(denom) + jac
    oob = (xx > high) | (xx < low)
    return torch.where(oob, -math.inf, logp)


def _betaln(a, b):
    return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)


def log_betadist(xx, alpha, beta, scale=1.0, floor=-math.inf):
    """Log-pdf of a Beta distribution stretched onto ``[0, scale]``;
    ``floor`` outside.

    Out-of-support points are evaluated at ``scale / 2``, so their gradient
    is zero; the JAX package clips them onto the endpoints, where the logs
    are infinite and its gradient is NaN."""
    inb = (xx <= scale) & (xx >= 0.0)
    safe_x = torch.where(inb, xx, 0.5 * scale)
    ln = (
        (alpha - 1.0) * torch.log(safe_x)
        + (beta - 1.0) * torch.log(scale - safe_x)
        - (alpha + beta - 1.0) * _log(scale)
        - _betaln(alpha, beta)
    )
    return torch.where(inb, ln, floor)
