"""The generic streamed op's backward ``ops/streamed.py::lse_vjp`` on the
CPU (no card), where it runs its plain version: the gradient of the row
pair ``(logsumexp(lw), logsumexp(2 lw))`` against torch autograd at the
generic op's block shapes and at odd row lengths, its edge rows, and the
devices the wrapper refuses.  The CUDA kernel itself is held to the plain
version in ``test_torch_isolation.py`` (marked ``cuda``) and in
``chip_smoke.py``."""

import pytest
import torch

from gwinferno_tpu_torch.ops import streamed

SHAPES = [(1, 8, 8000), (16, 8, 8000), (1, 6, 8192), (16, 6, 8192), (3, 8193), (7, 1), (4, 3), (2, 9, 4099)]
TOL = {torch.float32: dict(atol=1e-6, rtol=1e-5), torch.float64: dict(atol=1e-15, rtol=1e-12)}


def _block(shape, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    lw = 2.0 * torch.randn(shape, generator=g, dtype=torch.float64) - 3.0
    g1 = torch.rand(shape[:-1], generator=g, dtype=torch.float64)
    g2 = torch.rand(shape[:-1], generator=g, dtype=torch.float64)
    return lw.to(dtype), g1.to(dtype), g2.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", SHAPES)
def test_lse_vjp_is_the_gradient_of_the_row_pair(shape, dtype):
    """``g1 d logsumexp(lw) + g2 d logsumexp(2 lw)`` by autograd, with a
    third of one row's entries at -inf (their cotangent 0)."""
    lw, g1, g2 = _block(shape, dtype, seed=sum(shape))
    if shape[-1] > 2:
        lw[..., 0, ::3] = -torch.inf
    x = lw.clone().requires_grad_(True)
    l1, l2 = torch.logsumexp(x, -1), torch.logsumexp(2.0 * x, -1)
    (want,) = torch.autograd.grad((g1 * l1 + g2 * l2).sum(), x)
    got = streamed.lse_vjp(lw, g1, g2, l1.detach(), l2.detach())
    assert got.shape == lw.shape and got.dtype == dtype
    torch.testing.assert_close(got, want, **TOL[dtype])
    if shape[-1] > 2:
        assert bool((got[..., 0, ::3] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_lse_vjp_edge_rows(dtype):
    """An all -inf row (``l1``, ``l2`` -inf) takes a zero cotangent, never
    NaN; a row whose ``l2`` is +inf keeps only its ``g1`` term."""
    lw, g1, g2 = _block((4, 8, 300), dtype, seed=3)
    lw[:, 0] = -torch.inf
    l1, l2 = torch.logsumexp(lw, -1), torch.logsumexp(2.0 * lw, -1)
    l2[:, 1] = torch.inf
    got = streamed.lse_vjp(lw, g1, g2, l1, l2)
    assert bool(torch.isfinite(got).all()) and bool((got[:, 0] == 0).all())
    torch.testing.assert_close(got[:, 1], g1[:, 1, None] * torch.exp(lw[:, 1] - l1[:, 1, None]), **TOL[dtype])


def test_lse_vjp_refuses_a_device_without_its_kernel():
    """A tensor neither on the CPU nor on a CUDA card raises: the wrapper
    falls back to its plain version only for a CPU tensor."""
    lw = torch.zeros(2, 5, device="meta")
    rows = torch.zeros(2, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        streamed.lse_vjp(lw, rows, rows, rows, rows)


def test_lse_vjp_cuda_refuses_a_cpu_tensor():
    rows = torch.zeros(2)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        streamed.lse_vjp_cuda(torch.zeros(2, 5), rows, rows, rows, rows)
