"""K1's plain version (the CPU path of ``double_logsumexp``) against the JAX
package's Pallas kernel in interpret mode and its XLA oracle, in float64:
values and gradients, rows that are all or partly -inf, and a (C, E, S)
batch.  Tolerance rtol 1e-12 on values and 1e-10 on gradients (float64;
the sums are taken in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gwinferno_tpu.ops.fused import _dlse_xla
from gwinferno_tpu.ops.fused import double_logsumexp as jax_dlse
from gwinferno_tpu_torch.ops.fused import double_logsumexp


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = 10.0 + 3.0 * rng.standard_normal(shape)
    flat = x.reshape(-1, shape[-1])
    flat[1] = -np.inf  # an all--inf row (a masked event)
    flat[2, ::3] = -np.inf  # a partly -inf row (out-of-support samples)
    return x


def _check(got, want, rtol):
    got, want = got.detach().numpy(), np.asarray(want)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol)


@pytest.mark.parametrize("shape", [(5, 300), (3, 4, 300), (2, 3, 2500)])
@pytest.mark.parametrize("oracle", ["pallas_interpret", "xla"])
def test_double_logsumexp_matches_jax(shape, oracle):
    x = _inputs(shape, seed=len(shape))
    if oracle == "xla":
        jfn = _dlse_xla
    else:
        def jfn(v):
            return jax_dlse(v, mode="1", interpret=True)

    w1 = np.random.default_rng(1).uniform(size=shape[:-1])
    w2 = np.random.default_rng(2).uniform(size=shape[:-1])
    want = jfn(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    got = double_logsumexp(xt)
    _check(got[0], want[0], 1e-12)
    _check(got[1], want[1], 1e-12)

    # gradient of a weighted sum over the rows that are not all -inf
    live = np.isfinite(np.asarray(want[0]))

    def jloss(v):
        l1, l2 = jfn(v)
        return jnp.sum(jnp.where(live, w1 * l1 + w2 * l2, 0.0))

    jg = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    live_t = torch.tensor(live)
    loss = torch.where(live_t, torch.tensor(w1) * got[0] + torch.tensor(w2) * got[1], 0.0).sum()
    (tg,) = torch.autograd.grad(loss, xt)
    assert torch.isfinite(tg).all()
    jg = np.nan_to_num(jg)  # the XLA oracle's gradient is NaN on all--inf rows
    np.testing.assert_allclose(tg.numpy(), jg, rtol=1e-10, atol=1e-15)


def test_double_logsumexp_axis_and_empty_rows():
    x = torch.randn(4, 6, 3, dtype=torch.float64)
    l1, l2 = double_logsumexp(x, axis=1)
    torch.testing.assert_close(l1, torch.logsumexp(x, dim=1))
    torch.testing.assert_close(l2, torch.logsumexp(2 * x, dim=1))
    e1, e2 = double_logsumexp(torch.full((2, 5), -torch.inf, dtype=torch.float64))
    assert torch.equal(e1, torch.full((2,), -torch.inf, dtype=torch.float64))
    assert torch.equal(e2, torch.full((2,), -torch.inf, dtype=torch.float64))
