"""The rest of the port's public surface against the JAX package on the CPU.

``squared_operator`` / ``propagate_variance``, ``apply_operator_transpose``
on separable operators, ``compose_band`` / ``compose_separable``,
``apply_separable_dense``, ``area_rotate`` and the reference-named
``area_average_interpolation`` / ``fast_area_average_interpolation``.
Tables bit-equal (``np.array_equal``: the same float64 host arithmetic);
applies within f32 atol 1e-6 on [0, 1] inputs (the same tables, summed
in another order; 1e-5 where two applies chain); float64 references
(dense matrices) within 1e-12.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aainterp as aa
from aainterp.ops import apply as j_apply
from aainterp.ops import overlap1d as j_overlap
from aainterp.ops import weights as j_weights

import aainterp_torch as at
from aainterp_torch.ops import apply as t_apply
from aainterp_torch.ops import overlap1d as t_overlap
from aainterp_torch.ops import weights as t_weights

SEP_ANGLES = [0.0, 90.0, 180.0, 270.0]


def _sep_ops(shape, sr, dr, angle=0.0, iso=(0.0, 0.0), mode="exact"):
    args = (shape, sr, dr, iso, angle)
    return (j_weights.separable_operator(aa.make_grid_spec(*args), mode=mode),
            t_weights.separable_operator(at.make_grid_spec(*args), mode=mode))


def _band_equal(a, b):
    assert (a.n_src, a.n_dst) == (b.n_src, b.n_dst)
    assert np.array_equal(a.start, b.start)
    assert a.weights.dtype == b.weights.dtype
    assert np.array_equal(a.weights, b.weights)


def test_exports():
    for name in ("area_rotate", "area_average_interpolation",
                 "fast_area_average_interpolation", "propagate_variance",
                 "apply_operator_transpose", "compose_separable"):
        assert name in at.__all__ and callable(getattr(at, name))


@pytest.mark.parametrize("srm,drm", [(2.0, 1.0), (150.0, 60.0), (1.0, 3.0)])
def test_compose_band_bit_equal(srm, drm):
    j1, t1 = _sep_ops((96, 120), 4.0, srm)
    j2, t2 = _sep_ops((j1.wy.n_dst, j1.wx.n_dst), srm, drm)
    for jo, ji, to, ti in ((j2.wy, j1.wy, t2.wy, t1.wy),
                           (j2.wx, j1.wx, t2.wx, t1.wx)):
        tc = t_overlap.compose_band(to, ti)
        _band_equal(j_overlap.compose_band(jo, ji), tc)
        np.testing.assert_allclose(tc.dense(), to.dense() @ ti.dense(),
                                   atol=1e-12)


def test_compose_separable_matches_jax_and_two_applies():
    j1, t1 = _sep_ops((100, 140), 4.0, 2.0)
    j2, t2 = _sep_ops((j1.wy.n_dst, j1.wx.n_dst), 150.0, 60.0)
    jc, tc = j_weights.compose_separable(j2, j1), at.compose_separable(t2, t1)
    _band_equal(jc.wy, tc.wy)
    _band_equal(jc.wx, tc.wx)
    assert dataclasses.asdict(tc.spec) == dataclasses.asdict(jc.spec)
    at.validate_operator(tc)
    x = np.random.default_rng(60).uniform(0, 1, (2, 100, 140)).astype(
        np.float32)
    xt = torch.from_numpy(x)
    one = at.apply_operator(tc, xt)
    chained = at.apply_operator(t2, at.apply_operator(t1, xt))
    torch.testing.assert_close(one, chained, atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        one.numpy(), np.asarray(aa.apply_operator(jc, jnp.asarray(x))),
        atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="chain"):
        at.compose_separable(t1, t1)
    _, tq = _sep_ops((40, 60), 2.0, 1.0, angle=90.0)
    with pytest.raises(ValueError, match="quadrant"):
        at.compose_separable(tq, tq)


@pytest.mark.parametrize("angle", SEP_ANGLES)
def test_squared_operator_and_variance_separable(angle):
    jop, top = _sep_ops((40, 56), 2.0, 1.0, angle, (1.0, 2.0))
    jsq, tsq = j_weights.squared_operator(jop), at.squared_operator(top)
    _band_equal(jsq.wy, tsq.wy)
    _band_equal(jsq.wx, tsq.wx)
    var = np.random.default_rng(61).uniform(0, 1, (2, 40, 56)).astype(
        np.float32)
    got = at.propagate_variance(top, torch.from_numpy(var))
    ref = np.asarray(aa.propagate_variance(jop, jnp.asarray(var)))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("angle", [30.0, 210.0])
def test_squared_operator_and_variance_rotated(angle):
    args = ((36, 44), 1.0, 0.5, (22.3, 17.8), angle)
    jop = j_weights.ell_operator(aa.make_grid_spec(*args),
                                 prefer_native=False)
    top = t_weights.ell_operator(at.make_grid_spec(*args),
                                 prefer_native=False)
    tsq = at.squared_operator(top)
    assert np.array_equal(j_weights.squared_operator(jop).weights,
                          tsq.weights)
    var = np.random.default_rng(62).uniform(0, 1, (2, 36, 44))
    ref = np.asarray(aa.propagate_variance(jop, jnp.asarray(var)))
    for impl in ("gather", "sheared"):
        got = at.propagate_variance(top, torch.from_numpy(var), impl=impl)
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)
    # float64 against the dense squared operator
    got = at.propagate_variance(top, torch.from_numpy(var),
                                weight_dtype=torch.float64, impl="gather")
    dense = tsq.dense()
    q = np.rot90(var, -top.spec.quadrant, axes=(-2, -1))
    want = (dense @ q.reshape(2, -1).T).T.reshape(got.shape)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-12, rtol=0)
    with pytest.raises(TypeError):
        at.squared_operator(object())


def test_propagate_variance_squares_each_operator_once():
    from aainterp_torch import api as t_api
    # a geometry no other test of this file uses, so the cache holds one
    # squared operator of its spec
    args = ((34, 42), 1.0, 0.5, (21.0, 17.0), 33.0)
    top = at.build_operator(at.make_grid_spec(*args))
    var = torch.rand(2, 34, 42, generator=torch.Generator().manual_seed(9))
    first = at.propagate_variance(top, var)
    hits = [v for v in t_api._SQUARED_CACHE._d.values()
            if isinstance(v, at.EllOperator) and v.spec == top.spec]
    assert len(hits) == 1 and np.array_equal(hits[0].weights,
                                             top.weights ** 2)
    assert torch.equal(at.propagate_variance(top, var), first)
    again = [v for v in t_api._SQUARED_CACHE._d.values()
             if isinstance(v, at.EllOperator) and v.spec == top.spec]
    assert len(again) == 1 and again[0] is hits[0]
    with pytest.raises(TypeError, match="operator type"):
        at.propagate_variance(object(), var)


@pytest.mark.parametrize("angle", SEP_ANGLES)
def test_apply_operator_transpose_separable(angle):
    jop, top = _sep_ops((48, 64), 2.0, 1.0, angle)
    spec = top.spec
    cot = np.random.default_rng(63).uniform(-1, 1, (2,) + spec.dst_shape
                                            ).astype(np.float32)
    got = at.apply_operator_transpose(top, torch.from_numpy(cot))
    ref = np.asarray(aa.apply_operator_transpose(jop, jnp.asarray(cot)))
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)
    # float64: the adjoint identity <A u, v> == <u, A^T v>
    u = torch.from_numpy(np.random.default_rng(64).uniform(-1, 1, (48, 64)))
    v = torch.from_numpy(cot[0].astype(np.float64))
    au = at.apply_operator(top, u, impl="banded", weight_dtype=torch.float64)
    atv = at.apply_operator_transpose(top, v, weight_dtype=torch.float64)
    assert abs(float((au * v).sum()) - float((u * atv).sum())) <= 1e-12
    with pytest.raises(ValueError, match="CUDA"):
        at.apply_operator_transpose(top, torch.from_numpy(cot), impl="kernel")
    with pytest.raises(ValueError, match="impl"):
        at.apply_operator_transpose(top, torch.from_numpy(cot), impl="xla")


def test_apply_separable_dense_matches_jax_and_banded():
    jop, top = _sep_ops((40, 56), 150.0, 60.0)
    wy, wx = top.dense()
    x = np.random.default_rng(65).uniform(0, 1, (3, 40, 56)).astype(
        np.float32)
    ref = np.asarray(j_apply.apply_separable_dense(
        jnp.asarray(x), jnp.asarray(wy, jnp.float32),
        jnp.asarray(wx, jnp.float32)))
    got = t_apply.apply_separable_dense(
        torch.from_numpy(x), torch.from_numpy(wy).float(),
        torch.from_numpy(wx).float())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        got.numpy(), at.apply_operator(top, torch.from_numpy(x),
                                       impl="banded").numpy(),
        atol=1e-6, rtol=0)
    got64 = t_apply.apply_separable_dense(torch.from_numpy(x).double(),
                                          torch.from_numpy(wy),
                                          torch.from_numpy(wx))
    assert got64.dtype == torch.float64
    np.testing.assert_allclose(got64.numpy(), wy @ x.astype(np.float64)
                               @ wx.T, atol=1e-12, rtol=0)


@pytest.mark.parametrize("angle", [30.0, 135.0])
def test_area_rotate_matches_jax_and_conserves(angle):
    img = np.random.default_rng(66).uniform(0, 1, (2, 32, 40)).astype(
        np.float32)
    got = at.area_rotate(torch.from_numpy(img), angle)
    ref = np.asarray(aa.area_rotate(jnp.asarray(img), angle))
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)
    direct = at.area_average_interpolate(torch.from_numpy(img), 1.0, 1.0,
                                         (20.0, 16.0), angle).dst
    assert torch.equal(got, direct)
    # each dst pixel is a mean over its covered area: weighted by that
    # area (the raw row sums, in mod cells, scale^2 to a source cell) the
    # output holds the input's flux.  The output grid cuts off a corner of
    # one or two corner cells, so the image has a zero border here.
    framed = np.zeros_like(img)
    framed[:, 2:-2, 2:-2] = img[:, 2:-2, 2:-2]
    out = at.area_rotate(torch.from_numpy(framed), angle)
    op = at.build_operator(at.make_grid_spec((32, 40), 1.0, 1.0,
                                             (20.0, 16.0), angle))
    flux_in = framed.astype(np.float64).sum(axis=(-2, -1))
    flux_out = (out.double().numpy() * op.raw_row_sums).sum(
        axis=(-2, -1)) / op.spec.scale ** 2
    np.testing.assert_allclose(flux_out, flux_in, rtol=1e-6)
    const = at.area_rotate(torch.full((32, 40), 2.5), angle)
    inside = const != 0
    assert inside.any() and not inside.all()
    torch.testing.assert_close(const[inside], torch.full_like(
        const[inside], 2.5), atol=0, rtol=1e-5)
    iso = at.area_rotate(torch.from_numpy(img), angle, isocenter=(10.0, 8.0))
    assert torch.equal(iso, at.area_average_interpolate(
        torch.from_numpy(img), 1.0, 1.0, (10.0, 8.0), angle).dst)


@pytest.mark.parametrize("angle", [0.0, 30.0, 120.0])
def test_reference_named_wrappers_match_jax(angle):
    x = np.random.default_rng(67).uniform(0, 1, (36, 44)).astype(np.float32)
    args = (1.0, 0.5, (22.3, 17.8), angle)
    for j_fn, t_fn, mode in (
            (aa.area_average_interpolation, at.area_average_interpolation,
             "exact"),
            (aa.fast_area_average_interpolation,
             at.fast_area_average_interpolation, "fast")):
        spec = aa.make_grid_spec((36, 44), *args)
        jop = (j_weights.ell_operator(spec, mode=mode, prefer_native=False)
               if not spec.is_axis_aligned else None)
        jd, jiso = j_fn(jnp.asarray(x), *args, operator=jop)
        td, tiso = t_fn(torch.from_numpy(x), *args)
        assert tiso == jiso
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6,
                                   rtol=0)
        ref = at.area_average_interpolate(torch.from_numpy(x), *args,
                                          mode=mode).dst
        assert torch.equal(td, ref)
