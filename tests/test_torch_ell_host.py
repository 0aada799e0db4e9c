"""Host side of the PyTorch port's exact rotated family against the JAX
package, bit for bit.

The clipper, the ELL weight-gen (exact and fast), ``ell_operator``, the
quadrant fold and its dst permutations, ``build_shear_plan``, the ELL
branch of the operator sanitizer, the numpy carry-over of ELL tables
(convert.py) — all equal to the JAX package's numpy path
(``np.array_equal``).  The port's native engine (g++ build of
``native/aainterp_native.cpp``) is pinned to the port's numpy path at
atol 1e-13, as tests/test_native.py pins the JAX package's.  The JAX side
always takes its numpy weight-gen here (``prefer_native=False``).
"""

import dataclasses
import shutil
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aainterp as aa
from aainterp.ops import clipper as j_clipper
from aainterp.ops import compat as j_compat
from aainterp.ops import shear_apply as j_shear
from aainterp.ops import weights as j_weights

import aainterp_torch as at
from aainterp_torch import convert
from aainterp_torch import native as t_native
from aainterp_torch.ops import clipper as t_clipper
from aainterp_torch.ops import shear_apply as t_shear
from aainterp_torch.ops import weights as t_weights

# (src_shape, src_resolution, dst_resolution, src_isocenter, angle):
# quadrants 0-3, a film-like small-angle geometry, a prescale (scale > 1)
GEOMS = [
    ((40, 52), 1.0, 0.5, (26.0, 20.0), 30.0),
    ((36, 48), 1.0, 0.5, (20.0, 15.0), 120.0),
    ((44, 40), 1.0, 0.5, (20.0, 22.0), 210.0),
    ((38, 46), 1.0, 0.5, (23.0, 19.0), 300.5),
    ((60, 60), 150.0, 25.4, (30.0, 30.0), 1.5),
    ((12, 10), 25.4, 72.0, (5.0, 6.0), 100.0),
]
IDS = ["30", "120", "210", "300.5", "film1.5", "scale100"]


def _specs(args):
    return aa.make_grid_spec(*args), at.make_grid_spec(*args)


def _ops(args, mode="exact"):
    js, ts = _specs(args)
    return (j_weights.ell_operator(js, mode=mode, prefer_native=False),
            t_weights.ell_operator(ts, mode=mode, prefer_native=False))


def _ell_equal(j, t):
    assert dataclasses.asdict(j.spec) == dataclasses.asdict(t.spec)
    for name in ("base", "weights", "raw_row_sums"):
        a, b = np.asarray(getattr(j, name)), np.asarray(getattr(t, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(a, b), name
    assert j.mode == t.mode


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_clipper_bit_equal(seed):
    rng = np.random.default_rng(seed)
    n = 500
    px, py = rng.uniform(-2, 2, n), rng.uniform(-2, 2, n)
    ang = rng.uniform(0, np.pi / 2)
    c, s = np.cos(ang), np.sin(ang)
    side = rng.uniform(0.5, 3.0)
    jq = j_clipper.quad_vertices(np, px, py, side, c, s)
    tq = t_clipper.quad_vertices(px, py, side, c, s)
    for a, b in zip(jq, tq):
        assert np.array_equal(a, b)
    lo_x, lo_y = rng.uniform(-3, 1, n), rng.uniform(-3, 1, n)
    w = rng.uniform(0.1, 2.0, n)
    ja = j_clipper.quad_rect_overlap_area(np, *jq, lo_x, lo_y, lo_x + w,
                                          lo_y + w)
    ta = t_clipper.quad_rect_overlap_area(*tq, lo_x, lo_y, lo_x + w, lo_y + w)
    assert np.array_equal(ja, ta)
    assert (ta >= 0).all() and (ta <= w * w + 1e-12).all()


def test_clipper_full_and_empty_overlap():
    # a unit square quad fully inside a big box, and far outside it
    qx, qy = t_clipper.quad_vertices(np.zeros(2), np.zeros(2), 1.0, 1.0, 0.0)
    area = t_clipper.quad_rect_overlap_area(
        qx, qy, np.array([-5.0, 10.0]), np.array([-5.0, 10.0]),
        np.array([5.0, 11.0]), np.array([5.0, 11.0]))
    np.testing.assert_allclose(area, [1.0, 0.0], atol=1e-15)


@pytest.mark.parametrize("mode", ["exact", "fast"])
@pytest.mark.parametrize("args", GEOMS, ids=IDS)
def test_ell_weights_bit_equal(args, mode):
    js, ts = _specs(args)
    jb, jw, jsum = j_weights.ell_weights(js, mode=mode)
    tb, tw, tsum = t_weights.ell_weights(ts, mode=mode)
    for a, b in ((jb, tb), (jw, tw), (jsum, tsum)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # a row slice is the same rows of the full table
    Hd = ts.dst_shape[0]
    sb, sw, ss = t_weights.ell_weights(ts, mode=mode,
                                       dy_slice=(1, max(2, Hd // 2)))
    assert np.array_equal(sw, tw[1:max(2, Hd // 2)])
    assert np.array_equal(sb, tb[1:max(2, Hd // 2)])


@pytest.mark.parametrize("mode", ["exact", "fast"])
@pytest.mark.parametrize("args", GEOMS, ids=IDS)
def test_ell_operator_bit_equal(args, mode):
    jop, top = _ops(args, mode)
    _ell_equal(jop, top)
    # chunked over dst rows, the numpy operator is the same
    _ell_equal(jop, t_weights.ell_operator(_specs(args)[1], mode=mode,
                                           row_chunk=3, prefer_native=False))
    assert j_weights.validate_operator(jop) == t_weights.validate_operator(top)


@pytest.mark.parametrize("args", GEOMS[1:4], ids=IDS[1:4])
def test_fold_quadrant_ell_bit_equal(args):
    jop, top = _ops(args)
    assert top.spec.quadrant in (1, 2, 3)
    jf, jpost = j_weights.fold_quadrant_ell(jop)
    tf, tpost = t_weights.fold_quadrant_ell(top)
    _ell_equal(jf, tf)
    assert tf.spec.quadrant == 0
    # post maps the folded dst orientation back, as JAX's does
    y = np.random.default_rng(3).uniform(
        0, 1, (2,) + tf.spec.dst_shape).astype(np.float32)
    want = np.asarray(jpost(jnp.asarray(y)))
    got = tpost(torch.from_numpy(y)).numpy()
    assert np.array_equal(got, want)
    assert got.shape[-2:] == tuple(top.spec.dst_shape)
    # and post_inv undoes it, as JAX's does
    q = top.spec.quadrant
    inv = t_weights.ell_fold_post_inv(q)
    assert torch.equal(inv(tpost(torch.from_numpy(y))), torch.from_numpy(y))
    np.testing.assert_array_equal(
        inv(torch.from_numpy(want)).numpy(),
        np.asarray(j_weights.ell_fold_post_inv(q)(jnp.asarray(want))))


def test_fold_quadrant_ell_identity_and_cache():
    _, top0 = _ops(GEOMS[0])
    assert t_weights.fold_quadrant_ell(top0) is None
    assert t_weights.ell_fold_post_inv(0) is None
    _, top = _ops(GEOMS[1])
    first = t_weights.fold_quadrant_ell_cached(top)
    assert t_weights.fold_quadrant_ell_cached(top) is first


@pytest.mark.parametrize("args", GEOMS[:5], ids=IDS[:5])
def test_shear_plan_bit_equal(args):
    jop, top = _ops(args)
    if top.spec.quadrant:
        jop = j_weights.fold_quadrant_ell(jop)[0]
        top = t_weights.fold_quadrant_ell(top)[0]
    jp = j_shear.build_shear_plan(jop)
    tp = t_shear.build_shear_plan(top)
    for f in dataclasses.fields(jp):
        a, b = getattr(jp, f.name), getattr(tp, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, f.name


def test_shear_plan_rejects_wide_windows_and_empty_operators():
    _, top = _ops(GEOMS[0])
    with pytest.raises(ValueError, match="too large"):
        t_shear.build_shear_plan(top, max_window=3)
    empty = dataclasses.replace(top, weights=np.zeros_like(top.weights))
    with pytest.raises(ValueError, match="empty operator"):
        t_shear.build_shear_plan(empty)


@pytest.mark.parametrize("corrupt,match", [
    ("scale", "not normalised"),
    ("nan", "non-finite"),
    ("base", "negative ELL window base"),
    ("sums", "raw sums exceed"),
])
def test_validate_rejects_corrupted_ell(corrupt, match):
    _, top = _ops(GEOMS[0])
    if corrupt == "scale":
        w = top.weights.copy()
        dy, dx = np.argwhere(w.sum(axis=(-1, -2)) > 0.5)[0]
        w[dy, dx] *= 1.5
        bad = dataclasses.replace(top, weights=w)
    elif corrupt == "nan":
        w = top.weights.copy()
        w[0, 0, 0, 0] = np.nan
        bad = dataclasses.replace(top, weights=w)
    elif corrupt == "base":
        b = top.base.copy()
        b[2, 2, 1] = -1
        bad = dataclasses.replace(top, base=b)
    else:
        s = top.raw_row_sums.copy()
        s[1, 1] = 100.0
        bad = dataclasses.replace(top, raw_row_sums=s)
    with pytest.raises(at.OperatorValidationError, match=match):
        t_weights.validate_operator(bad)


def test_validate_rejects_unknown_operator_types():
    with pytest.raises(TypeError, match="EllOperator"):
        t_weights.validate_operator(object())


def test_compat_ell_operator_and_unknown_modes():
    js, ts = _specs(GEOMS[0])
    top = t_weights.ell_operator(ts, mode="compat", prefer_native=False)
    base, w, sums = j_compat.compat_ell_weights(js, prefer_native=False)
    assert top.mode == "compat" and top.window > ts.window_cells
    for a, b in ((base, top.base), (w, top.weights),
                 (sums, top.raw_row_sums)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    with pytest.raises(ValueError, match="mode"):
        t_weights.ell_operator(_specs(GEOMS[0])[1], mode="bogus",
                               prefer_native=False)


def test_convert_ell_operator_from_jax_tables():
    jop, top = _ops(GEOMS[2], "fast")
    cop = convert.ell_operator_from_numpy(
        dataclasses.asdict(jop.spec), np.asarray(jop.base),
        np.asarray(jop.weights), np.asarray(jop.raw_row_sums), jop.mode)
    _ell_equal(cop, top)
    t_weights.validate_operator(cop)
    with pytest.raises(ValueError, match="do not match"):
        convert.ell_operator_from_numpy(
            dataclasses.asdict(jop.spec), jop.base[:-1], jop.weights,
            jop.raw_row_sums)


def test_ell_operator_dense_matches_jax():
    jop, top = _ops(GEOMS[1])
    assert np.array_equal(jop.dense(), top.dense())
    assert top.window == jop.window


@pytest.fixture
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("no g++ on PATH: the native weight-gen engine cannot be "
                    "built")


@pytest.mark.parametrize("mode,atol", [("exact", 1e-13), ("fast", 1e-12)])
@pytest.mark.parametrize("args", GEOMS, ids=IDS)
def test_native_matches_numpy(gxx, args, mode, atol):
    ts = _specs(args)[1]
    nb, nw, ns = t_native.ell_weights_native(ts, mode=mode)
    pb, pw, ps = t_weights.ell_weights(ts, mode=mode)
    np.testing.assert_array_equal(nb, pb)
    np.testing.assert_allclose(nw, pw, atol=atol, rtol=0)
    np.testing.assert_allclose(ns, ps, atol=10 * atol, rtol=0)


def test_ell_operator_prefers_native(gxx):
    ts = _specs(GEOMS[0])[1]
    before = dict(t_weights.WEIGHT_GEN_ENGINES)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        op = t_weights.ell_operator(ts)
    assert t_weights.WEIGHT_GEN_ENGINES["native"] == before["native"] + 1
    assert t_weights.WEIGHT_GEN_ENGINES["numpy"] == before["numpy"]
    t_weights.validate_operator(op)
    # deterministic across thread counts
    one = t_native.ell_weights_native(ts, n_threads=1)
    many = t_native.ell_weights_native(ts, n_threads=5)
    for a, b in zip(one, many):
        assert np.array_equal(a, b)


def test_ell_operator_falls_back_to_numpy_with_a_warning(monkeypatch):
    def broken(*args, **kwargs):
        raise RuntimeError("g++ not found")

    monkeypatch.setattr(t_native, "ell_weights_native", broken)
    ts = _specs(GEOMS[0])[1]
    before = t_weights.WEIGHT_GEN_ENGINES["numpy"]
    with pytest.warns(RuntimeWarning, match="falling back to the numpy"):
        op = t_weights.ell_operator(ts)
    assert t_weights.WEIGHT_GEN_ENGINES["numpy"] == before + 1
    _ell_equal(j_weights.ell_operator(_specs(GEOMS[0])[0],
                                      prefer_native=False), op)
