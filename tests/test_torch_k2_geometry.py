"""K2's launch geometry and the merge-order invariance its partials rely on,
on the CPU (no card: the kernels themselves are held to their plain versions
by the ``cuda``-marked test in ``tests/test_torch_isolation.py`` and by
``chip_smoke.py``).

Tolerance: the plain versions in float64 against the unchunked sums, rtol
1e-12 (sums of ~10^4 terms taken in another order).
"""

import math
import os
import re
import sys

import numpy as np
import pytest
import torch

from gwinferno_tpu_torch.ops import streamed
from gwinferno_tpu_torch.pipeline.bench_model import MMAX, MMIN

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

# the streamed route's banks and the smoke's edge bank
BANKS = {"pe": (69, 8000), "injections": (6, 8192), "edge": (6, 700)}
F32 = torch.float32


@pytest.mark.parametrize("bank", BANKS)
@pytest.mark.parametrize("num_sms", [132, 114])
@pytest.mark.parametrize("num_chains", [1, 16, 17])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_geometry_fits_the_bank_and_the_card(bank, num_sms, num_chains, dtype, direction):
    """What the kernels rely on: whole blocks of threads a forward tile and
    whole warps a backward slice, every chain in one forward chain group of
    at most ``FWD_GROUP``, every backward warp busy, the staged tile within
    the shared-memory cap, the tiles covering the row, and the partials in
    the shape the kernels index."""
    rows, S = BANKS[bank]
    bps = 4 if direction == "fwd" else 3
    g = streamed.k2_geometry(rows, S, num_chains, num_sms, bps, dtype, direction)
    if direction == "fwd":
        assert g.tile % streamed._THREADS == 0
        assert 1 <= g.group <= streamed.FWD_GROUP
        assert (g.chain_blocks - 1) * g.group < num_chains <= g.chain_blocks * g.group
        assert g.part_shape == (num_chains, rows, g.n_tiles, 3)
    else:
        assert g.tile % (32 * g.slices) == 0
        assert num_chains * g.slices >= streamed._WARPS and g.slices <= streamed._WARPS
        assert g.smem <= streamed._MAX_SMEM
        assert g.part_shape == (num_chains, rows, g.n_tiles, g.slices, streamed.P_STRIDE)
    assert (g.n_tiles - 1) * g.tile < S <= g.n_tiles * g.tile
    assert 1 <= g.resident <= bps


@pytest.mark.parametrize(
    "bank, direction, want",
    [
        # (tile, chains a block or warp, samples a thread or lane, blocks)
        ("pe", "fwd", (1024, 4, 4, 2208)),
        ("pe", "bwd", (512, 1, 16, 1104)),
        ("injections", "fwd", (512, 4, 2, 384)),
        ("injections", "bwd", (128, 1, 4, 384)),
    ],
)
def test_geometry_of_the_main_path_on_an_h100(bank, direction, want):
    """The streamed route's launches at C = 16, float32, on 132 SMs with the
    occupancy the kernels reach there (4 forward and 3 backward blocks per
    SM): the geometries that timed fastest on the card (PERF.md).  Both
    banks fill at least most of a wave, the PE bank several; the PE forward
    covers 4 samples a thread per chain, the PE backward 16 a lane."""
    rows, S = BANKS[bank]
    g = streamed.k2_geometry(rows, S, 16, 132, 4 if direction == "fwd" else 3, F32, direction)
    assert (g.tile, g.group, g.per_thread, g.blocks) == want
    assert g.waves >= (4.0 if bank == "pe" and direction == "fwd" else 0.7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_geometry_for_many_chains(dtype):
    """The backward's shared memory does not grow with the chains (each
    warp stages its own chain's parameters), so thousands of chains launch
    with the same tile as 16; the forward's chain groups stay within the
    grid's z limit."""
    few = streamed.k2_geometry(69, 8000, 16, 132, 1, dtype, "bwd")
    many = streamed.k2_geometry(69, 8000, 4096, 132, 1, dtype, "bwd")
    assert (many.tile, many.smem, many.slices) == (few.tile, few.smem, few.slices)
    assert many.smem <= streamed._MAX_SMEM
    fwd = streamed.k2_geometry(69, 8000, 4096, 132, 1, dtype, "fwd")
    assert fwd.group == streamed.FWD_GROUP and fwd.chain_blocks == 1024 <= 65535


def test_geometry_follows_the_sm_count():
    small = streamed.k2_geometry(69, 8000, 16, 66, 4, F32, "fwd")
    big = streamed.k2_geometry(69, 8000, 16, 264, 4, F32, "fwd")
    assert small.waves > big.waves
    assert small.per_thread >= big.per_thread
    with pytest.raises(ValueError, match="direction"):
        streamed.k2_geometry_at(6, 700, 4, 132, 3, F32, "up", 4)


def test_device_geometry_reads_the_sm_count_and_occupancy(monkeypatch):
    """The wrappers' geometry comes from the card: its SM count and the
    kernel's occupancy, here stubbed (no card on this host)."""
    seen = []
    monkeypatch.setattr(streamed, "_sm_count", lambda dev: 114)
    monkeypatch.setattr(streamed, "_blocks_per_sm", lambda *a: seen.append(a) or 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    cols, P = torch.zeros(streamed.N_COL, 69, 8000), torch.zeros(16, streamed.P_STRIDE)
    for d in ("fwd", "bwd"):
        assert streamed.device_geometry(cols, P, d) == streamed.k2_geometry(69, 8000, 16, 114, 2, torch.float32, d)
    assert seen == [(torch.float32, "fwd", 4, 0), (torch.float32, "bwd", 1, 0)]


def test_c_interface_matches_the_ctypes_signatures():
    """Each exported C function of ``csrc/streamed.cu`` takes as many
    arguments as its ctypes ``argtypes`` list (a mismatch would pass
    garbage to the card)."""
    with open(streamed.STREAMED_FWD_KERNEL.source_path) as f:
        src = f.read()
    sigs = dict(re.findall(r"^int (gw_k2_\w+)\(([^)]*)\)", src, re.M))
    want = {**streamed.STREAMED_FWD_KERNEL.functions, **streamed.STREAMED_BWD_KERNEL.functions}
    assert set(sigs) == set(want)
    for name, args in sigs.items():
        assert len(args.split(",")) == len(want[name]), name


def _bank(seed, rows, S):
    banks, valid, zmax = chip_smoke.k2_edge_case(seed=seed, rows=rows, n_samples=S)
    return streamed.StreamedBank(banks, MMIN, MMAX, zmax, valid=valid).columns(torch.float64, "cpu")


def _cotangents(l1, l2, seed):
    rng = np.random.default_rng(seed)
    g1 = torch.where(torch.isfinite(l1), torch.tensor(rng.uniform(0.2, 1.0, l1.shape)), 0.0)
    g2 = torch.where(torch.isfinite(l2), torch.tensor(rng.uniform(-1.0, 1.0, l2.shape)), 0.0)
    return g1, g2, torch.where(torch.isfinite(l1), l1, 0.0), torch.where(torch.isfinite(l2), l2, 0.0)


def _unchunked(cols, flags, P, g1, g2, l1, l2):
    """The sums over each whole row at once: ``(lse1, lse2)`` and ``dP``."""
    lw, parts = streamed._chain_terms(cols, flags, P, grad=True)
    lse1, lse2 = torch.logsumexp(lw, dim=-1), torch.logsumexp(2.0 * lw, dim=-1)
    live = lw > -math.inf
    w = torch.where(g1[..., None] != 0, torch.exp(lw - l1[..., None]) * g1[..., None], 0.0) + torch.where(
        g2[..., None] != 0, torch.exp(2.0 * lw - l2[..., None]) * (2.0 * g2[..., None]), 0.0
    )
    w = torch.where(live, w, 0.0)
    dP = torch.zeros_like(P)
    for j, part in parts.items():
        dP[:, j] = torch.where(live, w * part, 0.0).sum(dim=(1, 2))
    return (lse1, lse2), dP


def _assert_same(got, want):
    for g, w in zip(got, want):
        assert torch.equal(torch.isinf(g), torch.isinf(w))
        fin = torch.isfinite(w)
        np.testing.assert_allclose(g[fin].numpy(), w[fin].numpy(), rtol=1e-12, atol=0)


@pytest.mark.parametrize("chunk", [1, 256, 8192])
def test_plain_versions_do_not_depend_on_the_chunking(chunk):
    """``(lse1, lse2)`` and ``dP`` of the plain versions for sample chunks of
    1, 256 and 8192 (more than a row) against the unchunked sums, float64:
    the merge of online states and of partial sums in any grouping gives
    the same result, which the kernels' per-tile partials rely on."""
    cols, flags = _bank(11, 3, 8300 if chunk > 1 else 1200)
    P = streamed.chain_params(chip_smoke.k2_edge_theta(3), MMIN, MMAX)
    lse = streamed._streamed_fwd_torch(cols, flags, P, chunk=chunk)
    g1, g2, l1, l2 = _cotangents(*lse, seed=chunk)
    want_lse, want_dP = _unchunked(cols, flags, P, g1, g2, l1, l2)
    _assert_same(lse, want_lse)
    dP = streamed._streamed_bwd_torch(cols, flags, P, g1, g2, l1, l2, chunk=chunk)
    np.testing.assert_allclose(dP.numpy(), want_dP.numpy(), rtol=1e-12, atol=1e-12 * float(want_dP.abs().max()))
