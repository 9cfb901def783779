"""K1's and K3's launch geometry, and the merge of tile partials that
their last blocks do, on the CPU (no card: the kernels themselves, and how
they cut a bank into tiles, are held to their plain versions by the
``cuda``-marked tests in ``tests/test_torch_isolation.py`` and by
``chip_smoke.py``).

Tolerance: the merge of tile partials in float64 against the unchunked
``torch.logsumexp``, rtol 1e-12 (sums of ~10^4 terms taken in another
order).
"""

import math
import os
import re
import sys

import numpy as np
import pytest
import torch

from gwinferno_tpu_torch.ops import fused

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

# K1's calls on the main path: the flat route's PE and injection calls at
# C = 16, the unfused B-spline route's at C = 8, and the smoke's edge shapes
K1_SHAPES = {
    "flat_pe": (1104, 8000),
    "bspline_pe": (552, 8000),
    "flat_inj": (16, 46770),
    "bspline_inj": (8, 46770),
    "all_-inf_rows": (8, 1000),
    "part_-inf_rows": (64, 3000),
}
# K3's banks (events, samples, design rows): the fused route's PE bank and
# injection row, and the smoke's edge bank (chip_smoke.k3_edge_case)
K3_BANKS = {"pe": (69, 8000, 165), "injections": (1, 46770, 165), "edge": (4, 2300, 165)}
DTYPES = [torch.float32, torch.float64]
DTYPE_IDS = ["f32", "f64"]


@pytest.mark.parametrize("shape", K1_SHAPES)
@pytest.mark.parametrize("num_sms", [132, 114])
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_k1_geometry_fits_the_rows_and_the_card(shape, num_sms, dtype):
    """What ``csrc/dlse.cu`` relies on: a tile of whole 16-byte vectors for
    every thread, tiles covering the row with none empty, and partials in
    the shape the kernel indexes (none when a row is one tile); a long row
    is cut into enough blocks to cover at least half the SMs."""
    rows, n = K1_SHAPES[shape]
    bps = 8 if dtype == torch.float32 else 3  # the kernel's occupancy on an H100
    g = fused.dlse_geometry(rows, n, dtype, num_sms, bps)
    assert g.tile % (fused._THREADS * fused._vec(dtype)) == 0
    assert (g.n_tiles - 1) * g.tile < n <= g.n_tiles * g.tile
    assert g.blocks == rows * g.n_tiles
    assert g.part_shape == ((rows, g.n_tiles, 3) if g.n_tiles > 1 else None)
    if n > 40000:
        assert g.n_tiles > 1 and g.blocks >= num_sms // 2


# K1's calls under SMC on the bench model's flat route: 1024 particles
# (the JAX package's default) over the PE bank and the injections
K1_SMC_SHAPES = {"smc_pe": (1024 * 69, 8000), "smc_inj": (1024, 46770)}


@pytest.mark.parametrize("shape", K1_SMC_SHAPES)
@pytest.mark.parametrize("num_sms", [132, 114])
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_k1_geometry_at_the_smc_shapes(shape, num_sms, dtype):
    """At SMC's shapes the grid is whole waves: it fills at least 90% of
    one wave of the card and uses at least 80% of the slots of the waves it
    runs in; the tiles cover every row.  The PE call's last row starts
    5.65e8 elements (2.26 GB in float32) in, past a 32-bit byte offset."""
    rows, n = K1_SMC_SHAPES[shape]
    bps = 8 if dtype == torch.float32 else 3  # the kernel's occupancy on an H100
    g = fused.dlse_geometry(rows, n, dtype, num_sms, bps)
    wave = num_sms * g.resident
    assert g.blocks >= 0.9 * wave and g.waves / math.ceil(g.waves) >= 0.8
    assert g.tile % (fused._THREADS * fused._vec(dtype)) == 0
    assert (g.n_tiles - 1) * g.tile < n <= g.n_tiles * g.tile and g.blocks == rows * g.n_tiles
    assert g.part_shape == ((rows, g.n_tiles, 3) if g.n_tiles > 1 else None)
    if shape == "smc_pe":
        assert (rows - 1) * n * 4 > 2**31


@pytest.mark.parametrize("bank", K3_BANKS)
@pytest.mark.parametrize("num_sms", [132, 114])
@pytest.mark.parametrize("num_chains", [1, 8, 16, 17])
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_k3_geometry_fits_the_bank_and_the_card(bank, num_sms, num_chains, dtype):
    """What ``csrc/flw.cu`` relies on: the rows split into 1, 2 or 4 slices
    of whole warps, a tile of whole 16-byte vectors, tiles covering each
    event with none empty, the chains in launches of at most 16 on an
    instantiation of 1, 8 or 16, the shared memory within its cap, and the
    partials in the shape the kernel indexes.  A bank whose rows are split
    over the warps gets at most a block per SM."""
    E, S, K = K3_BANKS[bank]
    bps = 1 if num_chains > 8 else 2  # the kernel's register-limited occupancy on an H100
    g = fused.flw_geometry(E, S, num_chains, K, dtype, num_sms, bps)
    assert g.ksplit in (1, 2, 4) and (fused._THREADS // g.ksplit) % 32 == 0
    assert g.tile % fused._vec(dtype) == 0
    assert (g.n_tiles - 1) * g.tile < S <= g.n_tiles * g.tile
    assert g.width == (1 if num_chains == 1 else (8 if num_chains <= 8 else 16))
    assert g.groups == -(-num_chains // 16) and g.blocks == E * g.n_tiles
    assert g.smem + fused._FLW_STATIC_SMEM <= fused._MAX_SMEM
    assert g.part_shape == ((num_chains, E, g.n_tiles, 3) if g.n_tiles > 1 else None)
    if g.ksplit > 1:
        assert g.blocks <= max(num_sms, E)


@pytest.mark.parametrize("num_sms", [132, 114])
def test_k3_short_bank_gets_a_block_per_sm(num_sms):
    """The injection row, too short to fill a wave with whole rows, is cut
    into equal tiles of whole 16-byte runs, one block per SM, with the rows
    split over the warps; a split whose partial sums would not fit in
    shared memory falls back to a smaller one."""
    g = fused.flw_geometry(1, 46770, 8, 165, torch.float32, num_sms, 2)
    assert g.ksplit == fused._FLW_SHORT_SPLIT
    assert g.tile == -(-(-(-46770 // num_sms)) // 4) * 4
    assert g.blocks == -(-46770 // g.tile) <= num_sms
    # 128 KB of coefficients (2000 rows x 16 chains) leave no room for the
    # slices' partial sums beside the ring: the rows stay whole
    wide = fused.flw_geometry(1, 46770, 16, 2000, torch.float32, num_sms, 1)
    assert wide.ksplit == 1 and wide.smem + fused._FLW_STATIC_SMEM <= fused._MAX_SMEM


def test_k3_geometry_refuses_coefficients_beyond_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        fused.flw_geometry(2, 100, 16, 4000, torch.float64, 132, 1)


def test_device_geometry_reads_the_sm_count_and_occupancy(monkeypatch):
    """The wrappers' geometries come from the card: its SM count and each
    kernel's occupancy, here stubbed (no card on this host)."""
    seen = []
    monkeypatch.setattr(fused, "_sm_count", lambda dev: 114)
    monkeypatch.setattr(fused, "_dlse_blocks_per_sm", lambda *a: seen.append(("k1",) + a) or 6)
    monkeypatch.setattr(fused, "_flw_blocks_per_sm", lambda *a: seen.append(("k3",) + a) or 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    x = torch.zeros(16, 46770)
    assert fused.dlse_device_geometry(x) == fused.dlse_geometry(16, 46770, torch.float32, 114, 6)
    coefs, design = torch.zeros(8, 165, dtype=torch.float64), torch.zeros(165, 10)
    assert fused.flw_device_geometry(coefs, design, 2, 5) == fused.flw_geometry(2, 5, 8, 165, torch.float64, 114, 2)
    assert seen == [("k1", torch.float32, 0), ("k3", torch.float64, 8, 0)]


@pytest.mark.parametrize("kernel", ["dlse", "flw"])
def test_c_interface_matches_the_ctypes_signatures(kernel):
    """Each exported C function takes as many arguments as its ctypes
    ``argtypes`` list (a mismatch would pass garbage to the card)."""
    k = fused.DLSE_KERNEL if kernel == "dlse" else fused.FLW_KERNEL
    with open(k.source_path) as f:
        src = f.read()
    sigs = dict(re.findall(r"^int (gw_\w+)\(([^)]*)\)", src, re.M))
    assert set(sigs) == set(k.functions)
    for name, args in sigs.items():
        assert len(args.split(",")) == len(k.functions[name]), name


# ----------------------------------------------------------------- the tile-partial merge


def _state(v):
    """``(m, s1, s2)`` of the values ``v`` (-inf weighs 0)."""
    m = float(v.max()) if v.numel() else -math.inf
    if m == -math.inf:
        return (-math.inf, 0.0, 0.0)
    e = torch.exp(v - m)
    return (m, float(e.sum()), float((e * e).sum()))


def _merge(a, b):
    """The kernels' merge of two online states: an empty state (m = -inf)
    adds nothing, and two empty states stay empty, never NaN."""
    m = max(a[0], b[0])
    if m == -math.inf:
        return a
    ea, eb = math.exp(a[0] - m), math.exp(b[0] - m)
    return (m, a[1] * ea + b[1] * eb, a[2] * ea * ea + b[2] * eb * eb)


@pytest.mark.parametrize("case", ["flat_inj", "bspline_inj", "part_-inf_rows", "k3_injections"])
def test_tile_partials_merged_in_tile_order_match_the_unchunked_sums(case):
    """Rows cut into the tiles of their geometry (K1's, or K3's on the
    injection row), each tile's state, and the states merged in tile order,
    against ``torch.logsumexp`` of the whole row, float64; with an all--inf
    tile inside a row and a row that is all -inf."""
    if case == "k3_injections":
        rows, n = 6, 46770
        g = fused.flw_geometry(1, n, 8, 165, torch.float64, 132, 2)
    else:
        rows, n = min(K1_SHAPES[case][0], 6), K1_SHAPES[case][1]
        g = fused.dlse_geometry(rows, n, torch.float64, 132, 8)
    assert g.n_tiles > 1
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.normal(10.0, 3.0, (rows, n)))
    x[torch.tensor(rng.uniform(size=(rows, n)) < 0.3)] = -math.inf
    x[1, : g.tile] = -math.inf  # an empty leading tile
    x[2] = -math.inf  # an empty row
    for r in range(rows):
        st = (-math.inf, 0.0, 0.0)
        for t in range(g.n_tiles):
            st = _merge(st, _state(x[r, t * g.tile : (t + 1) * g.tile]))
        m, s1, s2 = st
        got = (m + math.log(s1) if s1 > 0 else -math.inf, 2 * m + math.log(s2) if s2 > 0 else -math.inf)
        want = (float(torch.logsumexp(x[r], 0)), float(torch.logsumexp(2.0 * x[r], 0)))
        for gv, wv in zip(got, want):
            if wv == -math.inf:
                assert gv == -math.inf
            else:
                assert math.isclose(gv, wv, rel_tol=1e-12)


# ----------------------------------------------------------------- the padded design


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_padded_rows_is_a_view_the_plain_version_reads_unchanged(dtype):
    """``padded_rows`` keeps the values, strides its rows by whole 16-byte
    vectors (here a row of 903 values: 904 apart) and leaves zeros outside
    the view; the plain version gives the same results on it as on the
    contiguous design."""
    coefs, design, nlp, E, S = (torch.as_tensor(v, dtype=dtype) if isinstance(v, np.ndarray) else v
                                for v in chip_smoke.k3_edge_case(seed=6, num_chains=2, n_events=3, n_samples=301))
    view = fused.padded_rows(design)
    assert view.shape == design.shape and view.stride() == (904, 1)
    assert torch.equal(view, design)
    base = torch.as_strided(view, (view.shape[0], view.stride(0)), view.stride())
    assert bool((base[:, E * S:] == 0).all())
    rtol = 1e-14 if dtype == torch.float64 else 1e-6
    for a, b in zip(fused._flw_torch(coefs, view, nlp, E, S), fused._flw_torch(coefs, design, nlp, E, S)):
        assert torch.equal(torch.isinf(a), torch.isinf(b))
        torch.testing.assert_close(a[torch.isfinite(b)], b[torch.isfinite(b)], rtol=rtol, atol=0)


@pytest.mark.parametrize(
    "shape, want",
    [
        # (tile, tiles a row, vectors a thread, blocks)
        ("flat_pe", (8192, 1, 8, 1104)),
        ("bspline_pe", (8192, 1, 8, 552)),
        ("flat_inj", (4096, 12, 4, 192)),
        ("bspline_inj", (4096, 12, 4, 96)),
    ],
)
def test_k1_geometry_of_the_main_path_on_an_h100(shape, want):
    """K1's calls on the flat and unfused B-spline routes, float32, on 132
    SMs with the 8 blocks per SM the kernel reaches there: the geometries
    that timed fastest on the card (PERF.md): a whole PE row a block, the
    injection rows split into 12 tiles each."""
    g = fused.dlse_geometry(*K1_SHAPES[shape], torch.float32, 132, 8)
    assert (g.tile, g.n_tiles, g.per_thread, g.blocks) == want


@pytest.mark.parametrize(
    "bank, want",
    [
        # (tile, row split, runs a lane, blocks)
        ("pe", (1024, 1, 1, 552)),
        ("injections", (356, 4, 2, 132)),
    ],
)
def test_k3_geometry_of_the_main_path_on_an_h100(bank, want):
    """K3's two banks on the fused B-spline route (C = 8, float32) on 132
    SMs with the 2 blocks per SM the kernel reaches there: every row in
    each thread over tiles of 1024 samples on the PE bank (2.09 waves), the
    rows split 4 ways over 132 tiles of 356 samples on the injection row,
    one block per SM; the geometries that timed fastest on the card
    (PERF.md)."""
    E, S, K = K3_BANKS[bank]
    g = fused.flw_geometry(E, S, 8, K, torch.float32, 132, 2)
    assert (g.tile, g.ksplit, g.steps, g.blocks) == want
