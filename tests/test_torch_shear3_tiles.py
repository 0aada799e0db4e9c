"""The stage kernels' host tile tables (``shear3.plan_tiles``).

Each stage of a ``mode='shear'`` plan is cut into tiles of TL lines by TU
output cells, one CUDA block each, and a table gives each tile the input
window [lo, hi) it stages (and, for a pre-band, the mid cells [mlo, mhi)
it computes).  These tests hold the tables to the plain stages
(``shear3.ystage_plain`` / ``xstage_plain``) on the CPU, for every stage of
both decompositions and of their adjoint plans, at the shear flagship
(8x2048² at 30°, 1.0 -> 0.5) and at the small geometries of the GPU tests:

* every input cell that the plain stage reads for an output of a tile
  (each tap inside the input, zero weight or not) lies in the tile's
  window, and every mid cell inside [0, n_mid) in its mid range;
* no window reaches outside [0, n_in) (or [0, n_mid));
* a tile marked empty has plain-stage outputs that are exactly 0, even
  on an input that is NaN everywhere.
"""

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as hs

import aainterp_torch as at
from aainterp_torch.ops import shear3

FLAGSHIP = ((2048, 2048), 1.0, 0.5, (1024.0, 1024.0), 30.0)
# tests/test_torch_kernel_cuda.py's SHEAR3_GEOMS
SMALL = [
    ((96, 128), 1.0, 0.5, (64.0, 48.0), 30.0),
    ((80, 64), 1.0, 1.0, (32.0, 40.0), 30.0),
    ((64, 96), 2.0, 1.5, (48.0, 32.0), 104.0),
]


def _stage_plans(args):
    """Stage plans of both decompositions (where the geometry admits
    'yxy') and of their adjoints, with names."""
    spec = at.make_grid_spec(*args)
    out = []
    decs = ("xyx", "yxy") if spec.scale < spec.dst_side else ("xyx",)
    for dec in decs:
        plan = shear3.build_shear3_plan(spec, dec)
        out.append((dec, shear3.stage_plan(plan)))
        out.append((f"{dec}^T",
                    shear3.stage_plan(shear3.transpose_shear3_plan(plan))))
    return out


def _tap_range(st, u):
    """[a, b) per output (u[i], line): the input cells inside [0, n_in)
    that the plain stage reads for it (a == b when none), and [m0, m1)
    the mid cells inside [0, n_mid) it reads (pre-band)."""
    d = st.d.astype(np.int64)[None, :]
    uc = (u.astype(np.int64) + st.crop)[:, None]
    m0 = m1 = np.zeros((len(u), st.n_lines), np.int64)
    if st.form == shear3.TRANSLATE:          # in[u + crop - d - 1 .. - d]
        a, b = uc - d - 1, uc - d + 1
    elif st.form == shear3.POST_BAND:
        # T[c] for c = start[u] + k inside [0, n_t); T[c] reads
        # in[c - d - 1 .. c - d]
        s = st.start[u].astype(np.int64)[:, None]
        c0, c1 = np.maximum(s, 0), np.minimum(s + st.K, st.n_t)
        a, b = c0 - d - 1, c1 - d
        a, b = np.where(c1 > c0, a, 0), np.where(c1 > c0, b, 0)
    else:                                    # mid[u + crop - d - 1 .. - d]
        m0 = np.maximum(uc - d - 1, 0)
        m1 = np.minimum(uc - d + 1, st.n_mid)
        ok = m1 > m0
        s = st.start.astype(np.int64)
        s0 = s[np.clip(m0, 0, st.n_mid - 1)]
        s1 = s[np.clip(m1 - 1, 0, st.n_mid - 1)]
        a = np.where(ok, np.minimum(s0, s1), 0)
        b = np.where(ok, np.maximum(s0, s1) + st.K, 0)
        m0, m1 = np.where(ok, m0, 0), np.where(ok, m1, 0)
    a, b = np.clip(a, 0, st.n_in), np.clip(b, 0, st.n_in)
    return a, np.maximum(a, b), m0, m1


def _check_windows(st):
    t = st.tiles
    win = t.win.astype(np.int64)
    lo, hi, mlo, mhi = (win[..., k] for k in range(4))
    n_tu, n_tl = win.shape[:2]
    assert (n_tu, n_tl) == (-(-st.n_out // t.TU), -(-st.n_lines // t.TL))
    assert ((0 <= lo) & (lo <= hi) & (hi <= st.n_in)).all()
    assert ((0 <= mlo) & (mlo <= mhi) & (mhi <= st.n_mid)).all()
    if st.form != shear3.PRE_BAND:
        assert not mhi.any()
    assert t.max_win == (hi - lo).max() and t.max_mid == (mhi - mlo).max()
    empty = hi <= lo
    assert not win[empty].any()                  # an empty tile is all 0
    tile_l = np.arange(st.n_lines) // t.TL
    for a_ in range(n_tu):                       # one row of tiles at a time
        u = np.arange(a_ * t.TU, min((a_ + 1) * t.TU, st.n_out))
        a, b, m0, m1 = _tap_range(st, u)
        read = b > a
        assert not (read & empty[a_, tile_l][None, :]).any()
        assert (~read | ((lo[a_, tile_l] <= a) & (b <= hi[a_, tile_l]))).all()
        if st.form == shear3.PRE_BAND:
            reads_mid = m1 > m0
            inside = (mlo[a_, tile_l] <= m0) & (m1 <= mhi[a_, tile_l])
            assert (~reads_mid | empty[a_, tile_l][None, :] | inside).all()
    return empty


def _check_empty_tiles_are_zero(sp, i, empty):
    """The plain stage on a NaN input: exactly 0 on every empty tile."""
    st = sp.stages[i]
    x = torch.full((1,) + st.in_shape, float("nan"))
    plain = shear3.ystage_plain if st.axis == "y" else shear3.xstage_plain
    out = plain(x, sp, i)[0].numpy()
    if st.axis == "x":
        out = out.T                              # (n_out, n_lines)
    t = st.tiles
    mask = np.repeat(np.repeat(empty, t.TU, 0), t.TL, 1)[:st.n_out,
                                                         :st.n_lines]
    assert np.array_equal(out[mask], np.zeros(int(mask.sum()), np.float32))


@pytest.mark.parametrize("args", SMALL, ids=["band", "fold", "quadrant1"])
def test_tile_windows_small(args):
    for name, sp in _stage_plans(args):
        for i, st in enumerate(sp.stages):
            empty = _check_windows(st)
            _check_empty_tiles_are_zero(sp, i, empty)


@pytest.fixture(scope="module")
def flagship():
    return _stage_plans(FLAGSHIP)


@pytest.mark.parametrize("plan_i", range(4))
def test_tile_windows_flagship(flagship, plan_i):
    name, sp = flagship[plan_i]
    assert tuple(st.axis for st in sp.stages) == (
        tuple(name[:3]) if "^T" not in name else tuple(reversed(name[:3])))
    for i, st in enumerate(sp.stages):
        empty = _check_windows(st)
        _check_empty_tiles_are_zero(sp, i, empty)


def test_flagship_tiles_stage_little_more_than_the_input(flagship):
    # the windows hold the input about once (the halo between tiles and
    # the shear's spread over a tile's lines), and the rotated image's
    # corners leave tiles empty; every block fits the f32 budget
    quality = dict(flagship)["xyx"]
    for st in quality.stages:
        t = st.tiles
        staged = (t.win[..., 1] - t.win[..., 0]).astype(np.int64).sum() * t.TL
        assert staged <= 1.3 * st.n_in * st.n_lines
        assert shear3.stage_smem(st, t.TL, t.max_win, t.max_mid, 4) <= \
            shear3.SMEM_BUDGET
    y = quality.stages[1]
    empty = y.tiles.win[..., 1] <= y.tiles.win[..., 0]
    assert (y.tiles.TL, y.tiles.TU) == (64, 64) and empty.any()


def test_seg_pitch_keeps_the_stride_mod_16():
    for nbytes in (0, 2, 64, 128, 130, 2798):
        for stride in (1, 2, 4, 5196, 2798, 1399, 4096):
            p = shear3.seg_pitch(nbytes, stride)
            assert nbytes + 32 <= p < nbytes + 48 and (p - stride) % 16 == 0


@settings(max_examples=25, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(h=hs.integers(8, 48), w=hs.integers(8, 48),
       angle=hs.floats(0.5, 359.5), src=hs.sampled_from([1.0, 2.0, 3.0]),
       dst=hs.sampled_from([0.4, 0.5, 1.0, 1.5, 2.5]))
def test_tile_windows_property(h, w, angle, src, dst):
    spec = at.make_grid_spec((h, w), src, dst, (w / 2, h / 2), angle)
    if spec.is_axis_aligned:
        return
    for name, sp in _stage_plans(((h, w), src, dst, (w / 2, h / 2), angle)):
        for i, st in enumerate(sp.stages):
            empty = _check_windows(st)
            _check_empty_tiles_are_zero(sp, i, empty)


def test_stage_beyond_the_opt_in_takes_the_direct_form():
    # 8192^2 at 30 deg, 1.0 -> 1/3000 (dst 4x4), 'fast': stage 0, a y
    # pre-band of some 3000 taps, needs 290,208 bytes of shared memory on
    # its smallest tile (4 lines x 1 output), above the card's 232,448
    spec = at.make_grid_spec((8192, 8192), 1.0, 1 / 3000, (4096.0, 4096.0),
                             30.0)
    assert spec.dst_shape == (4, 4)
    sp = shear3.stage_plan(shear3.build_shear3_plan(spec, "fast"))
    st = sp.stages[0]
    t = st.tiles
    assert (st.axis, st.form, t.TL, t.TU) == ("y", shear3.PRE_BAND, 4, 1)
    smem = shear3.stage_smem(st, t.TL, t.max_win, t.max_mid, 4)
    assert smem == 290208 and smem > shear3.SMEM_LIMIT == 232448
    assert t.direct
    # the other stages fit and keep their staged tiles
    for st in sp.stages[1:]:
        t = st.tiles
        assert not t.direct
        assert shear3.stage_smem(st, t.TL, t.max_win, t.max_mid, 4) <= \
            shear3.SMEM_LIMIT
