"""The last API gaps of the port against the JAX package, on the CPU in
float64: every spline basis' ``eval``, ``__call__`` and ``get_coefficients``;
the PPL's ``get_rng_key`` and ``seed.next_key``; ``Distribution.
expand_shapes``; and a listing of both packages' public names.

Tolerances: curves rtol 1e-12 (the same float64 arithmetic, sums in another
order); least-squares coefficients and fits rtol 1e-9 (two LAPACK routines
on one well-posed system).
"""

import ast
import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gwinferno_tpu import interpolation as jinterp
from gwinferno_tpu.ppl import distributions as jdist
from gwinferno_tpu_torch import interpolation
from gwinferno_tpu_torch import ppl
from gwinferno_tpu_torch.ppl import distributions as dist

F64 = dict(device="cpu", dtype=torch.float64)
N = 9

# class name -> (constructor keywords, the range the test points span)
BASES = {
    "BasisSpline": (dict(xrange=(0.0, 1.0)), (0.0, 1.0)),
    "BSpline": (dict(xrange=(-1.0, 1.0), normalize=True), (-1.0, 1.0)),
    "LogXBSpline": (dict(xrange=(0.05, 2.0)), (0.05, 2.0)),
    "LogYBSpline": (dict(xrange=(0.0, 1.0)), (0.0, 1.0)),
    "LogXLogYBSpline": (dict(xrange=(3.0, 100.0)), (3.0, 100.0)),
}


def _pair(name):
    kw, span = BASES[name]
    return getattr(interpolation, name)(N, **kw, **F64), getattr(jinterp, name)(N, **kw), span


def _coefs(name, rng, shape):
    c = rng.normal(0.0, 0.4, shape)
    return np.abs(c) + 0.1 if name == "BasisSpline" else c


@pytest.mark.parametrize("name", list(BASES))
def test_eval_and_call_match_jax(name):
    """A single ``(N,)`` vector gives the JAX method's ``xs.shape``; a
    ``(C, N)`` batch gives one such curve per chain; ``__call__`` is
    ``eval``."""
    port, ref, (lo, hi) = _pair(name)
    rng = np.random.default_rng(0)
    xs = np.concatenate([rng.uniform(lo, hi, 120), [lo, hi]])
    one = _coefs(name, rng, N)
    got = port.eval(xs, one)
    want = np.asarray(ref.eval(jnp.asarray(xs), jnp.asarray(one)))
    assert tuple(got.shape) == want.shape == xs.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-14 * float(np.abs(want).max()))
    assert torch.equal(port(xs, one), got)
    batch = _coefs(name, rng, (3, N))
    got = port(xs, torch.tensor(batch))
    assert tuple(got.shape) == (3,) + xs.shape
    for c in range(3):
        want = np.asarray(ref(jnp.asarray(xs), jnp.asarray(batch[c])))
        np.testing.assert_allclose(got[c].numpy(), want, rtol=1e-12, atol=1e-14 * float(np.abs(want).max()))


@pytest.mark.parametrize("name", list(BASES))
def test_get_coefficients_matches_jax(name):
    """The least-squares fit to a smooth curve: ``(alpha, fit, design)``
    with the JAX method's values and shapes, float64 on the host; the fit
    is ``design @ alpha``."""
    port, ref, (lo, hi) = _pair(name)
    xs = np.linspace(lo + 1e-3 * (hi - lo), hi - 1e-3 * (hi - lo), 200)
    ys = 1.0 + 0.5 * np.sin(3.0 * (xs - lo) / (hi - lo))
    alpha, fit, design = port.get_coefficients(xs, ys)
    ja, jfit, jdesign = (np.asarray(v) for v in ref.get_coefficients(jnp.asarray(xs), jnp.asarray(ys)))
    assert alpha.dtype == fit.dtype == design.dtype == torch.float64 and alpha.device.type == "cpu"
    assert tuple(alpha.shape) == ja.shape == (N,) and tuple(design.shape) == jdesign.shape == (xs.size, N)
    np.testing.assert_allclose(design.numpy(), jdesign, rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(alpha.numpy(), ja, rtol=1e-9, atol=1e-9 * float(np.abs(ja).max()))
    np.testing.assert_allclose(fit.numpy(), jfit, rtol=1e-9)
    torch.testing.assert_close(fit, design @ alpha, rtol=0.0, atol=0.0)
    assert float(np.abs(fit.numpy() - ys).max()) < 0.05


def test_eval_runs_on_the_basis_device_in_its_dtype():
    port = interpolation.BSpline(6, xrange=(0.0, 1.0), normalize=True, device="cpu", dtype=torch.float32)
    out = port.eval(np.linspace(0.0, 1.0, 11), np.ones(6))
    assert out.dtype == torch.float32 and out.device.type == "cpu" and tuple(out.shape) == (11,)


def test_get_rng_key_splits_off_the_innermost_seed():
    """None outside any ``seed``; inside, a fresh generator on the handler's
    device drawn from the innermost handler's generator, which it advances:
    two calls give two streams, the same seed the same two."""
    assert ppl.get_rng_key() is None

    def two_keys(seed):
        with ppl.seed(rng_seed=0), ppl.seed(rng_seed=seed):
            keys = ppl.get_rng_key(), ppl.get_rng_key()
        return [torch.rand(4, generator=k, dtype=torch.float64) for k in keys]

    a, b = two_keys(7)
    assert not torch.equal(a, b)
    again = two_keys(7)
    assert torch.equal(a, again[0]) and torch.equal(b, again[1])
    assert not torch.equal(a, two_keys(8)[0])
    # the innermost handler's generator is the one that advances
    outer, inner = torch.Generator().manual_seed(0), torch.Generator().manual_seed(7)
    with ppl.seed(rng_seed=outer), ppl.seed(rng_seed=inner):
        k = ppl.get_rng_key()
    assert isinstance(k, torch.Generator) and k.device.type == "cpu"
    assert torch.equal(outer.get_state(), torch.Generator().manual_seed(0).get_state())
    assert not torch.equal(inner.get_state(), torch.Generator().manual_seed(7).get_state())


def test_seed_next_key_and_the_sites_it_seeds():
    """``seed.next_key`` gives a new generator each call; an un-valued
    sample site still draws from the handler's generator."""
    handler = ppl.seed(rng_seed=3)
    k1, k2 = handler.next_key(), handler.next_key()
    assert isinstance(k1, torch.Generator) and k1 is not k2
    assert not torch.equal(torch.rand(3, generator=k1), torch.rand(3, generator=k2))
    with ppl.trace() as tr, ppl.seed(rng_seed=torch.Generator().manual_seed(5)):
        ppl.sample("x", dist.Normal(0.0, 1.0))
    assert torch.isfinite(torch.as_tensor(tr.trace["x"]["value"])).all()


@pytest.mark.parametrize("sample_shape", [(), (4,), (2, 3)])
def test_expand_shapes_matches_jax(sample_shape):
    cases = [
        (dist.Normal(torch.zeros(3), 1.0), jdist.Normal(jnp.zeros(3), 1.0)),
        (dist.Uniform(0.0, torch.ones(2, 5)), jdist.Uniform(0.0, jnp.ones((2, 5)))),
        (dist.Normal(0.0, 1.0), jdist.Normal(0.0, 1.0)),
    ]
    for d, jd in cases:
        assert d.expand_shapes(sample_shape) == tuple(jd.expand_shapes(sample_shape))


# the JAX package's public names that have no counterpart by nature (ROADMAP,
# queue 1): a Pallas-safe special function, the optax bridge, the pytree
# hooks, the XLA twin of the fused Pallas kernel (the port's plain version
# is ``fused_logweight_logsumexp_torch``) and the numpy-or-jnp dispatch
JAX_ONLY = {
    ("distributions", "pallas_safe_special_fns", None),
    ("infer.svi", "Adam", "to_optax"),
    ("interpolation", "NaturalCubicUnivariateSpline", "tree_flatten"),
    ("interpolation", "NaturalCubicUnivariateSpline", "tree_unflatten"),
    ("ops.fused", "fused_logweight_logsumexp_xla", None),
    ("utils.host", "is_traced", None),
    ("utils.host", "xp_for", None),
}


def _public_listing(pkg):
    """``(module, name, method)`` of every public top-level function and
    class of ``pkg`` and every public method (and ``__call__``) of those
    classes, read with ``ast``."""
    out = []
    for dirpath, _, files in os.walk(pkg):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            mod = os.path.relpath(path, pkg)[:-3].replace(os.sep, ".")
            mod = "" if mod == "__init__" else mod.removesuffix(".__init__")
            with open(path) as fh:
                tree = ast.parse(fh.read())
            for node in tree.body:
                if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and not node.name.startswith("_"):
                    out.append((mod, node.name, None))
                    if isinstance(node, ast.ClassDef):
                        out += [(mod, node.name, m.name) for m in node.body if isinstance(m, ast.FunctionDef)
                                and (not m.name.startswith("_") or m.name == "__call__")]
    return out


def test_public_api_covers_the_jax_package():
    """Every public function, class and method of the JAX package has a
    counterpart at the same module path of the port (inherited methods
    count), but the names in ``JAX_ONLY``."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    missing = set()
    for mod, name, meth in _public_listing(os.path.join(root, "gwinferno_tpu")):
        try:
            module = importlib.import_module("gwinferno_tpu_torch" + (f".{mod}" if mod else ""))
        except ImportError:
            missing.add((mod, name, meth))
            continue
        obj = getattr(module, name, None)
        if obj is None or (meth is not None and not hasattr(obj, meth)):
            missing.add((mod, name, meth))
    assert missing == JAX_ONLY
