"""The rotated shear kernel's host tile tables (``cuda_shear.shear_tiles``)
and its fused plain version (``cuda_shear.vhshear_plain``).

The shear kernel of ``csrc/ell_shear.cu`` cuts its output into tiles of
TY x TX cells, one CUDA block each, and stages the source window that a
host table gives each tile.  Three forms share it: vshear (S from q, gy
only), hshear (T from S, hx only) and the fused form the rotated route
launches (T from q).  These tests hold the tables, on the CPU, to a numpy
brute force of the shear formula, at the rotated flagship (2048² at 30°,
1.0 -> 0.5) and at small geometries (30°, quadrant 1 at 120°, the film
geometry in fast mode, ±44°, odd widths, one-row and one-column planes):

* every source element that an output of a tile reads lies in the tile's
  window, and no window reaches outside the source;
* a tile marked empty reads nothing, so its outputs are all zero fill;
* the kernel's per-element logic, emulated in numpy on the windows
  (column test first, then the staged gy, then the row test), gives the
  plain version exactly.

The fused plain version is held bit for bit to the plain composition of
the two shears in bf16 and f32, and the fused wrapper takes it on a CPU
tensor.  The kernels themselves are checked on the card
(tests/test_torch_kernel_cuda.py, chip_smoke.py).
"""

import dataclasses
import types

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as hs

import aainterp_torch as at
from aainterp_torch.ops import cuda_shear, shear_apply
from aainterp_torch.ops import weights as t_weights

FLAGSHIP = ((2048, 2048), 1.0, 0.5, (1024.0, 1024.0), 30.0)
GEOMS = [
    (((40, 52), 1.0, 0.5, (26.0, 20.0), 30.0), "exact"),
    (((36, 48), 1.0, 0.5, (20.0, 15.0), 120.0), "exact"),     # quadrant 1
    (((60, 60), 150.0, 25.4, (30.0, 30.0), 1.5), "fast"),      # film
    (((45, 37), 1.0, 0.5, (18.0, 22.0), 44.0), "exact"),       # odd widths
    (((45, 37), 1.0, 0.5, (18.0, 22.0), -44.0), "exact"),
]
IDS = ["30", "120", "film-fast", "44", "-44"]
FORMS = tuple(cuda_shear.FORMS)


def _plan(args, mode):
    op = t_weights.ell_operator(at.make_grid_spec(*args), mode=mode,
                                prefer_native=False)
    if op.spec.quadrant:
        op = t_weights.fold_quadrant_ell(op)[0]
    return cuda_shear.plan_from_operator(op)


def _shifts_plan(args):
    """The flagship's shear shifts and plane shapes (what the tile tables
    read of a plan), without its weights."""
    spec = at.make_grid_spec(*args)
    gy, hx, TH, TW = shear_apply.shear_shifts(spec)
    qH, qW = spec.qrot_shape
    return types.SimpleNamespace(gy=gy.astype(np.int32),
                                 hx=hx.astype(np.int32), qH=qH, qW=qW,
                                 TH=TH, TW=TW)


def _shifts(plan, form):
    use_gy, use_hx = cuda_shear.FORMS[form]
    return (plan.gy if use_gy else None), (plan.hx if use_hx else None)


def _reads(gy, hx, src, y0, y1, dW):
    """(valid, r, c) of out[y, x] for rows [y0, y1), all columns: the
    source element each output reads, and whether it reads one."""
    y = np.arange(y0, y1, dtype=np.int64)[:, None]
    x = np.arange(dW, dtype=np.int64)[None, :]
    c = x - (0 if hx is None else hx[y0:y1].astype(np.int64)[:, None])
    c = np.broadcast_to(c, (y1 - y0, dW))
    valid = (c >= 0) & (c < src[1])
    cc = np.clip(c, 0, src[1] - 1)
    r = y - (0 if gy is None else gy.astype(np.int64)[cc])
    valid &= (r >= 0) & (r < src[0])
    return valid, np.broadcast_to(r, valid.shape), c


def _check_tiles(t, gy, hx, src, dst):
    """Every read inside its tile's window, windows inside the source,
    empty tiles read nothing.  Returns the empty mask per tile."""
    dH, dW = dst
    n_ty, n_tx = -(-dH // t.TY), -(-dW // t.TX)
    win = t.win.astype(np.int64)
    assert win.shape == (n_ty * n_tx, 4) and t.win.dtype == np.int32
    r_lo, r_hi, c_lo, c_hi = win.T
    empty = r_hi <= r_lo
    assert not win[empty].any()                       # an empty tile is all 0
    assert ((0 <= r_lo) & (r_lo < r_hi) & (r_hi <= src[0]))[~empty].all()
    assert ((0 <= c_lo) & (c_lo < c_hi) & (c_hi <= src[1]))[~empty].all()
    assert t.rows == (r_hi - r_lo).max() and t.cols == (c_hi - c_lo).max()
    tx = np.arange(dW) // t.TX
    for ty in range(n_ty):                            # one row of tiles
        y0, y1 = ty * t.TY, min((ty + 1) * t.TY, dH)
        valid, r, c = _reads(gy, hx, src, y0, y1, dW)
        k = ty * n_tx + tx[None, :]
        assert not (valid & empty[k]).any()
        inside = ((r_lo[k] <= r) & (r < r_hi[k])
                  & (c_lo[k] <= c) & (c < c_hi[k]))
        assert (~valid | inside).all()
    return empty


def _emulate(t, gy, hx, x, dst):
    """The kernel's per-element logic on the tables, in numpy: zero unless
    c - c_lo is inside the window's columns and then y - gy[c] - r_lo
    inside its rows, read from the window."""
    dH, dW = dst
    n_tx = -(-dW // t.TX)
    y = np.arange(dH)[:, None]
    xs = np.arange(dW)[None, :]
    k = (y // t.TY) * n_tx + xs // t.TX
    r_lo, r_hi, c_lo, c_hi = (t.win[:, i].astype(np.int64)[k]
                              for i in range(4))
    c = xs - (0 if hx is None else hx.astype(np.int64)[:, None]) - c_lo
    ok = (c >= 0) & (c < c_hi - c_lo)
    cg = np.clip(c + c_lo, 0, len(gy) - 1) if gy is not None else None
    r = y - (0 if gy is None else gy.astype(np.int64)[cg]) - r_lo
    ok &= (r >= 0) & (r < r_hi - r_lo)
    src = x[:, np.where(ok, r + r_lo, 0), np.where(ok, c + c_lo, 0)]
    return np.where(ok[None], src, 0)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("geom", GEOMS, ids=IDS)
def test_tile_tables_small(geom, form):
    plan = _plan(*geom)
    t = plan.form_tiles(form)
    gy, hx = _shifts(plan, form)
    src, dst = cuda_shear._form_shapes(plan, form)
    empty = _check_tiles(t, gy, hx, src, dst)
    # the kernel's logic on the tables gives the plain version, whose
    # empty tiles are zero
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        0.5, 1, (2,) + src).astype(np.float32))
    want = getattr(cuda_shear, f"{form}_plain")(x, plan).numpy()
    np.testing.assert_array_equal(_emulate(t, gy, hx, x.numpy(), dst), want)
    n_tx = -(-dst[1] // t.TX)
    tile = ((np.arange(dst[0]) // t.TY)[:, None] * n_tx
            + (np.arange(dst[1]) // t.TX)[None, :])
    assert not want[:, empty[tile]].any()


@pytest.mark.parametrize("form", FORMS)
def test_tile_tables_flagship(form):
    plan = _shifts_plan(FLAGSHIP)
    assert (plan.TH, plan.TW) == (3231, 3448)
    t = cuda_shear.plan_tiles(plan, form)
    gy, hx = _shifts(plan, form)
    src, dst = cuda_shear._form_shapes(plan, form)
    empty = _check_tiles(t, gy, hx, src, dst)
    # 64 x 64 tiles whose windows fit the f32 budget; the rotated image's
    # corners leave tiles empty (most of T's tiles: T is 62 % zero fill)
    assert (t.TY, t.TX) == (64, 64)
    assert cuda_shear.shear_smem(form, 64, t.rows, t.cols, 4) <= \
        cuda_shear.SMEM_BUDGET
    assert empty.mean() > (0.5 if form == "vhshear" else 0.3)
    # the windows stage the source about 2-3 times over (their overlap,
    # which L2 serves): a bound on the tables' read amplification
    w = t.win.astype(np.int64)
    staged = ((w[:, 1] - w[:, 0]) * (w[:, 3] - w[:, 2])).sum()
    assert staged <= 3.0 * src[0] * src[1]


@pytest.mark.parametrize("src,dst,gy,hx", [
    ((1, 9), (3, 9), [0, 0, 1, 1, 1, 2, 2, 2, 2], None),      # one row
    ((9, 1), (11, 1), [2], None),                             # one column
    ((1, 9), (1, 14), None, [5]),
    ((9, 1), (9, 6), None, [5, 4, 4, 3, 2, 2, 1, 1, 0]),
    ((1, 9), (3, 14), [0, 0, 1, 1, 1, 2, 2, 2, 2], [5, 3, 0]),
    ((9, 1), (11, 6), [2], [5, 5, 4, 4, 3, 2, 2, 1, 1, 0, 0]),
], ids=["v-row", "v-col", "h-row", "h-col", "vh-row", "vh-col"])
def test_tile_tables_one_row_and_one_column_planes(src, dst, gy, hx):
    gy = None if gy is None else np.asarray(gy, np.int32)
    hx = None if hx is None else np.asarray(hx, np.int32)
    x = np.random.default_rng(2).uniform(0.5, 1, (1,) + src)
    valid, r, c = _reads(gy, hx, src, 0, dst[0], dst[1])
    want = np.where(valid, x[0, np.clip(r, 0, src[0] - 1),
                             np.clip(c, 0, src[1] - 1)], 0)
    for TY, TX in cuda_shear._TILES:
        t = cuda_shear.shear_tiles(gy, hx, src, dst, TY, TX)
        _check_tiles(t, gy, hx, src, dst)
        np.testing.assert_array_equal(_emulate(t, gy, hx, x, dst)[0], want)


@settings(max_examples=40, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(sH=hs.integers(1, 40), sW=hs.integers(1, 40),
       tiles=hs.sampled_from(cuda_shear._TILES + ((3, 5), (7, 1))),
       slope_y=hs.floats(-1.5, 3.0), slope_x=hs.floats(-0.6, 0.6),
       form=hs.sampled_from(FORMS), seed=hs.integers(0, 2 ** 16))
def test_tile_tables_property(sH, sW, tiles, slope_y, slope_x, form, seed):
    # shifts of any sign and slope (monotone, as the planner's are, or
    # jittered), planes of any size
    rng = np.random.default_rng(seed)
    use_gy, use_hx = cuda_shear.FORMS[form]
    gy = np.round(np.arange(sW) * slope_y + rng.integers(-1, 2, sW))
    dH = sH + (int(np.abs(gy).max()) + 1 if use_gy else 0)
    hx = np.round(np.arange(dH) * slope_x)
    hx = hx - hx.min()
    dW = sW + (int(hx.max()) + 1 if use_hx else 0)
    gy = gy.astype(np.int32) if use_gy else None
    hx = hx.astype(np.int32) if use_hx else None
    t = cuda_shear.shear_tiles(gy, hx, (sH, sW), (dH, dW), *tiles)
    _check_tiles(t, gy, hx, (sH, sW), (dH, dW))
    x = rng.uniform(0.5, 1, (1, sH, sW))
    valid, r, c = _reads(gy, hx, (sH, sW), 0, dH, dW)
    want = np.where(valid, x[0, np.clip(r, 0, sH - 1), np.clip(c, 0, sW - 1)],
                    0)
    np.testing.assert_array_equal(_emulate(t, gy, hx, x, (dH, dW))[0], want)


@pytest.mark.parametrize("angle", [60.0, 80.0])
def test_steep_shears_take_smaller_tiles_that_fit(angle):
    # the vertical shear's slope is tan(angle) after the quadrant fold:
    # windows grow with it, and the planner steps down its tile list until
    # a window fits the budget, far inside the card's opt-in
    plan = _shifts_plan(((2048, 2048), 1.0, 2.0, (1024.0, 1024.0), angle))
    tiles = {form: cuda_shear.plan_tiles(plan, form) for form in FORMS}
    for form, t in tiles.items():
        smem = cuda_shear.shear_smem(form, t.TY, t.rows, t.cols, 4)
        assert smem <= cuda_shear.SMEM_BUDGET, form
    assert (tiles["vhshear"].TY, tiles["vhshear"].TX) != (64, 64)


def test_shear_smem_counts_each_form_tables():
    assert cuda_shear.shear_smem("hshear", 64, 64, 92, 2) == \
        256 + 48 + 64 * (92 * 2 + 47)
    assert cuda_shear.shear_smem("vshear", 64, 101, 64, 4) == \
        256 + 48 + 101 * (64 * 4 + 47)
    assert cuda_shear.shear_smem("vhshear", 64, 85, 92, 2) == \
        624 + 48 + 85 * (92 * 2 + 47)


# ---------------------------------------------------------------------------
# the fused plain version and its wrapper
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("geom", GEOMS, ids=IDS)
def test_vhshear_plain_is_the_two_shears(geom, dtype):
    plan = _plan(*geom)
    q = torch.from_numpy(np.random.default_rng(3).uniform(
        0, 1, (3, plan.qH, plan.qW)).astype(np.float32)).to(dtype)
    t = cuda_shear.vhshear_plain(q, plan)
    assert t.dtype == dtype and t.shape == (3, plan.TH, plan.TW)
    assert torch.equal(t, cuda_shear.hshear_plain(
        cuda_shear.vshear_plain(q, plan), plan))
    out = torch.full((3, plan.TH, plan.TW), float("nan"), dtype=dtype)
    assert cuda_shear.vhshear_plain(q, plan, out=out) is out
    assert torch.equal(out, t)


def test_fused_wrapper_takes_the_plain_version_on_cpu():
    plan = _plan(*GEOMS[0])
    q = torch.from_numpy(np.random.default_rng(4).uniform(
        0, 1, (2, plan.qH, plan.qW)).astype(np.float32))
    before = dict(cuda_shear.LAUNCHES)
    out = torch.full((2, plan.TH, plan.TW), float("nan"))
    got = cuda_shear.vhshear_kernel(q, plan, out=out)
    assert cuda_shear.LAUNCHES == before          # nothing launched
    assert got is out and torch.equal(out, cuda_shear.vhshear_plain(q, plan))
    with pytest.raises(ValueError, match="for this plan"):
        cuda_shear.vhshear_kernel(torch.zeros(2, plan.TH, plan.qW), plan)


def test_plan_tables_hold_each_forms_tiles():
    plan = _plan(*GEOMS[1])
    # the plain routes plan no tiles and upload no tile table
    q = torch.from_numpy(np.random.default_rng(5).uniform(
        0, 1, (2, plan.qH, plan.qW)).astype(np.float32))
    cuda_shear.apply_ell_shear_plain(q, plan)
    cuda_shear.apply_ell_shear_kernel(q, plan)
    tabs = plan.tables(torch.device("cpu"))
    assert plan.tiles == {} and not any(k.startswith("win_") for k in tabs)
    # a form's tiles are planned and uploaded at its first use, then kept
    for form in FORMS:
        win = plan.form_windows(form, torch.device("cpu"))
        t = plan.form_tiles(form)
        assert t is plan.tiles[form] and plan.form_tiles(form) is t
        assert torch.equal(win, torch.from_numpy(t.win))
        assert tabs[f"win_{form}"] is win
        assert plan.form_windows(form, torch.device("cpu")) is win
        src, dst = cuda_shear._form_shapes(plan, form)
        want = cuda_shear.plan_tiles(plan, form)
        assert (t.TY, t.TX) == (want.TY, want.TX)
        np.testing.assert_array_equal(t.win, want.win)
    # a plan made anew from other shifts gets its own tables
    moved = dataclasses.replace(plan, gy=plan.gy + plan.TH, tiles={},
                                dev={})
    assert (moved.form_tiles("vhshear").win == 0).all()
    assert (moved.form_tiles("vshear").win == 0).all()


# the steepest slopes: build_shear_plan caps the sheared window at 24 taps,
# which it exceeds before 88 degrees after the quadrant fold (the steepest
# geometries accepted lie near 87 degrees, on upscales)
STEEP = ((64, 64), 1.0, 2.0, (32.0, 32.0))


@pytest.mark.parametrize("angle", [87.0, 88.0])
def test_steepest_shears_fit_the_card(angle):
    # 87 degrees in fast mode is accepted, 88 rejected (a window of 35
    # taps); at both, on a plane large enough that no window is clipped,
    # every form's tiles plan within the card's opt-in, and the fused
    # form's window fits the 48 KB budget on the smallest tile
    op = t_weights.ell_operator(at.make_grid_spec(*STEEP, angle),
                                mode="fast", prefer_native=False)
    if angle < 88:
        assert cuda_shear.plan_from_operator(op).Ka <= 24
    else:
        with pytest.raises(ValueError, match="too large"):
            cuda_shear.plan_from_operator(op)
    plan = _shifts_plan(((512, 512), 1.0, 2.0, (256.0, 256.0), angle))
    for form in FORMS:
        t = cuda_shear.plan_tiles(plan, form)
        smem = cuda_shear.shear_smem(form, t.TY, t.rows, t.cols, 4)
        assert smem <= cuda_shear.SMEM_BUDGET <= cuda_shear.SMEM_LIMIT, form
        assert t.rows < plan.qH                     # not clipped
    TY, TX = cuda_shear._TILES[-1]
    t = cuda_shear.shear_tiles(plan.gy, plan.hx, (plan.qH, plan.qW),
                               (plan.TH, plan.TW), TY, TX)
    assert cuda_shear.shear_smem("vhshear", TY, t.rows, t.cols, 4) <= \
        cuda_shear.SMEM_BUDGET


def test_tiles_beyond_the_card_raise():
    # a kernel limit raises RuntimeError, which the rotated route's
    # 'auto' does not take for a rejected geometry (ValueError)
    plan = _shifts_plan(((4096, 32), 1.0, 2.0, (2048.0, 16.0), 89.7))
    with pytest.raises(RuntimeError, match="exceeds the shared memory"):
        cuda_shear.plan_tiles(plan, "vhshear")
