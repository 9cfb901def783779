"""Elementary population-model pdfs on torch tensors.

Counterpart of ``gwinferno_tpu/distributions.py``: the log-space pdfs and
the linear ones (each the ``exp`` of its log form, or the reference's
linear formula).  The error function and log-gamma are torch's
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
    "logistic_function",
    "logistic_unit",
    "log_logistic_unit",
    "powerlaw_logit_pdf",
    "powerlaw_pdf",
    "log_powerlaw_pdf",
    "truncnorm_pdf",
    "log_truncnorm_pdf",
    "betadist",
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


def logistic_function(x, L, k, x0):
    """Logistic curve ``L / (1 + exp(-k (x - x0)))``."""
    return L * torch.sigmoid(k * (x - x0))


def logistic_unit(x, x0, sgn=1, sc=4):
    """Logistic window of unit height centred at ``x0``: ``sgn=1``
    truncates on the right, ``sgn=-1`` on the left; ``sc`` sets the
    sharpness."""
    return logistic_function(x, 1.0, -1 * sgn * sc, x0)


def log_logistic_unit(x, x0, sgn=1, sc=4):
    """Log of :func:`logistic_unit`, finite (linear) deep in the truncated
    tail: ``log sigmoid(t) = t - log1p(exp(t))`` for ``t < 0``."""
    t = -sgn * sc * (x - x0)
    neg = t < 0
    return torch.where(
        neg,
        t - torch.log1p(torch.exp(torch.where(neg, t, -t))),
        -torch.log1p(torch.exp(torch.where(neg, 0.0, -t))),
    )


def powerlaw_logit_pdf(xx, alpha, low=None, high=None, low_fall_off=4.0, high_fall_off=4.0):
    """Unnormalized powerlaw ``x**alpha`` with soft (logistic) truncations
    at ``low`` and ``high``."""
    prob = torch.pow(xx, alpha)
    if low is not None:
        prob = prob * logistic_unit(xx, low, sgn=-1.0, sc=low_fall_off)
    if high is not None:
        prob = prob * logistic_unit(xx, high, sgn=1.0, sc=high_fall_off)
    return prob


def per_chain(v, ndim):
    """A ``(C,)`` hyperparameter as ``(C, 1, ...)`` against a bank of
    ``ndim`` axes; numbers and 0-d tensors are returned as they are."""
    if isinstance(v, torch.Tensor) and v.ndim == 1:
        return v.reshape(v.shape + (1,) * ndim)
    return v


def _as_tensor_like(v, like):
    """A hyperparameter as a tensor in ``like``'s dtype and device (numbers
    become 0-d tensors, tensors are kept)."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


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


def powerlaw_pdf(xx, alpha, low, high, floor=0.0):
    """pdf of the sharply truncated powerlaw ``x**alpha``, normalized on
    ``[low, high]`` (``alpha == -1``: the logarithmic normalization);
    ``floor`` outside."""
    alpha = _as_tensor_like(alpha, xx)
    oob = (xx < low) | (xx > high)
    log_safe_x = torch.log(torch.where(oob, low, xx))
    prob = torch.exp(alpha * log_safe_x + _powerlaw_log_norm(alpha, low, high))
    return torch.where(oob, floor, prob)


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


def truncnorm_pdf(xx, mu, sig, low, high, log=False):
    """pdf of a normal truncated to ``[low, high]`` (``log=True``: a
    truncated lognormal); 0 outside."""
    mu, sig = _as_tensor_like(mu, xx), _as_tensor_like(sig, xx)
    safe_x = torch.where(xx <= 0.0, low, xx) if log else xx
    oob = (xx > high) | (xx < low)
    return torch.where(oob, 0.0, torch.exp(log_truncnorm_pdf(safe_x, mu, sig, low, high, log=log)))


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


def betadist(xx, alpha, beta, scale=1.0, floor=0.0):
    """pdf of a Beta distribution on ``[0, scale]``; ``floor`` outside."""
    alpha, beta = _as_tensor_like(alpha, xx), _as_tensor_like(beta, xx)
    inb = (xx <= scale) & (xx >= 0.0)
    return torch.where(inb, torch.exp(log_betadist(xx, alpha, beta, scale=scale)), floor)
