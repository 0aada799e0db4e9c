"""Host planning of the band-operator family, PyTorch port against the JAX
package bit for bit: the lat-lon grid, interval-overlap bands, the
conservative regrid operator, the aligned plan and the unit resize band;
and the invariants of the 2-D kernel's planner."""

import numpy as np
import pytest

from aainterp import api as j_api
from aainterp import regrid as j_regrid
from aainterp.ops import apply as j_apply

from aainterp_torch import api as t_api
from aainterp_torch import regrid as t_regrid
from aainterp_torch.ops import apply as t_apply
from aainterp_torch.ops import cuda_apply, cuda_apply_2d, overlap1d


def _bands_equal(a, b):
    assert (a.n_src, a.n_dst) == (b.n_src, b.n_dst)
    assert a.start.dtype == b.start.dtype and a.weights.dtype == b.weights.dtype
    assert np.array_equal(a.start, b.start)
    assert np.array_equal(a.weights, b.weights)


REGRIDS = [((360, 720), (36, 72)), ((1800, 3600), (180, 360)),
           ((1800, 3600), (720, 1440)), ((170, 360), (18, 36)),
           ((18, 36), (40, 50))]


@pytest.mark.parametrize("n_lat,n_lon", [(1, 1), (18, 36), (1800, 3600)])
def test_lat_lon_grid_edges(n_lat, n_lon):
    j, t = j_regrid.LatLonGrid(n_lat, n_lon), t_regrid.LatLonGrid(n_lat, n_lon)
    assert np.array_equal(j.lat_edges, t.lat_edges)
    assert np.array_equal(j.lon_edges, t.lon_edges)


@pytest.mark.parametrize("src,dst", REGRIDS)
def test_conservative_regrid_operator_bit_equal(src, dst):
    jb = j_regrid.conservative_regrid_operator(j_regrid.LatLonGrid(*src),
                                               j_regrid.LatLonGrid(*dst))
    tb = t_regrid.conservative_regrid_operator(t_regrid.LatLonGrid(*src),
                                               t_regrid.LatLonGrid(*dst))
    for a, b in zip(jb, tb):
        _bands_equal(a, b)
        np.testing.assert_allclose(b.weights.sum(axis=1), 1.0, atol=1e-12)


@pytest.mark.parametrize("edges,band", [
    ((np.linspace(0.0, 10.0, 11), np.linspace(0.0, 10.0, 4)), 6),   # ascending
    ((np.sin(np.radians(np.linspace(90.0, -90.0, 13))),
      np.sin(np.radians(np.linspace(90.0, -90.0, 5)))), 5),         # descending
    ((np.sin(np.radians(np.linspace(90.0, -90.0, 4))),
      np.sin(np.radians(np.linspace(90.0, -90.0, 8)))), 5),         # n_src < band
    ((np.linspace(0.0, 3.0, 4), np.linspace(0.0, 3.0, 9)), 5),      # ascending, n_src < band
])
def test_interval_overlap_band_bit_equal(edges, band):
    src_edges, dst_edges = edges
    _bands_equal(j_regrid._interval_overlap_band(src_edges, dst_edges, band),
                 t_regrid._interval_overlap_band(src_edges, dst_edges, band))


@pytest.mark.parametrize("n_src,n_dst", [(10, 3), (2160, 720), (3840, 1366),
                                         (7, 7), (5, 13), (1, 4)])
def test_unit_resize_band_bit_equal(n_src, n_dst):
    _bands_equal(j_api._unit_resize_band(n_src, n_dst),
                 t_api._unit_resize_band(n_src, n_dst))


@pytest.mark.parametrize("src,dst", REGRIDS)
def test_aligned_axis_plan_bit_equal(src, dst):
    by, bx = t_regrid.conservative_regrid_operator(t_regrid.LatLonGrid(*src),
                                                   t_regrid.LatLonGrid(*dst))
    for b in (by, bx):
        w32 = np.asarray(b.weights, np.float32)
        jp = j_apply.aligned_axis_plan(b.start, w32, b.n_src)
        tp = t_apply.aligned_axis_plan(b.start, w32, b.n_src)
        assert (jp is None) == (tp is None)
        if jp is not None:
            assert (jp["m"], jp["c0"]) == (tp["m"], tp["c0"])
            assert np.array_equal(jp["wk"], tp["wk"])
    tabs = t_regrid.band_tables(by, bx)
    ratio = src[0] // dst[0] if src[0] % dst[0] == 0 else 0
    assert (tabs.aligned is not None) == (ratio > 1 and src[1] % dst[1] == 0)


def _plan_holds_every_tap(plan, ys, xs, ky, kx):
    for starts, k, tile, base, span in ((ys, ky, plan["TY"], plan["row_base"],
                                         plan["SY"]),
                                        (xs, kx, plan["TX"], plan["col_base"],
                                         plan["SX"])):
        tile_of = np.arange(starts.shape[0]) // tile
        off = starts.astype(np.int64) - base[tile_of]
        assert (off >= 0).all() and (off + k <= span).all()
    assert plan["smem"] == cuda_apply.band_smem(
        plan["TY"], plan["TX"], plan["SY"], plan["SX"], ky)
    assert plan["nty"] == -(-ys.shape[0] // plan["TY"])
    assert plan["ntx"] == -(-xs.shape[0] // plan["TX"])


@pytest.mark.parametrize("src,dst", REGRIDS + [((2160, 3840), (720, 1280)),
                                               ((2160, 3840), (768, 1366)),
                                               ((24, 24), (12, 12))])
def test_plan_2d_every_tap_inside_its_block(src, dst):
    if src == (2160, 3840) or src == (24, 24):
        by, bx = t_api.resize_bands(src, dst)
    else:
        by, bx = t_regrid.conservative_regrid_operator(
            t_regrid.LatLonGrid(*src), t_regrid.LatLonGrid(*dst))
    plan = cuda_apply_2d.plan_separable_2d(by.start, bx.start, by.band,
                                           bx.band)
    _plan_holds_every_tap(plan, by.start, bx.start, by.band, bx.band)
    assert plan["smem"] <= cuda_apply_2d.SMEM_TARGET
    if src == (1800, 3600) and dst == (180, 360):
        # config 5: 12-tap bands at a 10x ratio; TX halves before TY
        assert (plan["TY"], plan["TX"], plan["SY"], plan["SX"]) == \
            (16, 8, 162, 82)


def test_plan_2d_handles_non_monotone_and_negative_starts():
    rng = np.random.default_rng(3)
    ys = rng.integers(-3, 200, 77).astype(np.int32)
    xs = rng.integers(-5, 300, 45).astype(np.int32)
    plan = cuda_apply_2d.plan_separable_2d(ys, xs, 4, 6)
    _plan_holds_every_tap(plan, ys, xs, 4, 6)


def test_plan_2d_budget_and_rejection():
    # one dst pixel's block above the target but within the 227 KB limit:
    # accepted at 1 x 1 tiles
    ys, xs = np.zeros(40, np.int32), np.zeros(2, np.int32)
    plan = cuda_apply_2d.plan_separable_2d(ys, xs, 200, 200)
    assert (plan["TY"], plan["TX"], plan["direct"]) == (1, 1, False)
    assert cuda_apply_2d.SMEM_TARGET < plan["smem"] <= cuda_apply_2d.SMEM_LIMIT
    # beyond the limit: not rejected, but the direct form (no shared memory)
    plan = cuda_apply_2d.plan_separable_2d(ys, xs, 300, 300)
    assert (plan["direct"], plan["smem"]) == (True, 0)
    assert (plan["x_lo"], plan["x_hi"]) == (0, 300)
    # a smaller budget halves TX, then TY, the larger first
    by, bx = t_api.resize_bands((2160, 3840), (720, 1280))
    sizes = [(p["TY"], p["TX"]) for p in (
        cuda_apply_2d.plan_separable_2d(by.start, bx.start, 5, 5,
                                        smem_target=t)
        for t in (64 << 10, 32 << 10, 16 << 10, 8 << 10))]
    assert sizes == [(32, 32), (16, 32), (16, 16), (8, 16)] or \
        all(a[0] >= b[0] and a[1] >= b[1] for a, b in zip(sizes, sizes[1:]))


def test_kernel_plan_is_cached_by_content():
    ys, yw = np.zeros(2, np.int32), np.full((2, 400), 1 / 400, np.float32)
    plan = cuda_apply_2d.kernel_plan(ys, yw, ys, yw)
    assert plan["direct"]
    assert cuda_apply_2d.kernel_plan(ys.copy(), yw.copy(), ys, yw) is plan
    assert cuda_apply_2d.kernel_plan(ys, yw * 2, ys, yw) is not plan


REGRID_AND_FLIPPED = [("regrid", (1800, 3600), (180, 360)),
                      ("regrid", (1800, 3600), (720, 1440)),
                      ("regrid", (3, 3), (1, 1)),
                      ("resize", (96, 250), (336, 875)),
                      ("flipped", (200, 500), (90, 171))]


@pytest.mark.parametrize("kind,src,dst", REGRID_AND_FLIPPED)
def test_transpose_band_any_starts(kind, src, dst):
    # the kernel route's adjoint tables: the dense transpose for any starts,
    # and the port's monotone transpose_band where the starts are monotone
    if kind == "regrid":
        bands = t_regrid.conservative_regrid_operator(
            t_regrid.LatLonGrid(*src), t_regrid.LatLonGrid(*dst))
    else:
        bands = t_api.resize_bands(src, dst)
    if kind == "flipped":
        bands = tuple(overlap1d.flip_band(b) for b in bands)
    for b in bands:
        t = t_regrid.transpose_band(b)
        assert (t.n_src, t.n_dst) == (b.n_dst, b.n_src)
        assert np.array_equal(t.dense(), b.dense().T)
        if np.all(np.diff(b.start) >= 0):
            assert np.array_equal(t.dense(),
                                  overlap1d.transpose_band(b).dense())
