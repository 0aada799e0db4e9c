"""Rotated ``mode='compat'`` of the PyTorch port against the JAX package on
the CPU.

The carried ``ops/compat.py`` (the reference's exact mode, defects
included) gives tables equal to the JAX package's numpy path bit for bit
(``np.array_equal``), chunked or whole; the port's native engine gives the
numpy replica's areas bit for bit (the build disables floating-point
contraction, as tests/test_native.py pins it for the JAX package).  The
JAX side always takes its numpy replica (``prefer_native=False``).
Outputs of ``area_average_interpolate(mode='compat')`` on every rotated
route equal the JAX package's within f32 atol 1e-5 on [0, 1] inputs
(the same tables, summed in another order).
"""

import dataclasses
import shutil
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aainterp as aa
from aainterp.ops import compat as j_compat
from aainterp.ops import weights as j_weights

import aainterp_torch as at
from aainterp_torch import convert
from aainterp_torch import native as t_native
from aainterp_torch.ops import compat as t_compat
from aainterp_torch.ops import cuda_shear
from aainterp_torch.ops import weights as t_weights

# (src_shape, src_resolution, dst_resolution, src_isocenter, angle):
# quadrants 0-3, the film geometry at 1.5 degrees, a tangency at 30
# degrees (sin = 0.5 exactly) and a prescale (scale > 1)
GEOMS = [
    ((36, 44), 1.0, 0.5, (22.3, 17.8), 30.0),
    ((32, 36), 1.0, 0.5, (18.0, 16.0), 120.0),
    ((34, 30), 1.0, 0.5, (15.0, 17.0), 210.0),
    ((30, 34), 1.0, 0.5, (17.0, 15.0), 300.5),
    ((48, 48), 150.0, 25.4, (24.0, 24.0), 1.5),
    ((12, 10), 25.4, 72.0, (5.0, 6.0), 100.0),
]
IDS = ["30", "120", "210", "300.5", "film1.5", "scale"]


def _specs(args):
    return aa.make_grid_spec(*args), at.make_grid_spec(*args)


def _jax_compat_op(js):
    """The JAX package's compat operator from its numpy replica."""
    base, w, sums = j_compat.compat_ell_weights(js, prefer_native=False)
    return j_weights.EllOperator(spec=js, base=base, weights=w,
                                 raw_row_sums=sums, mode="compat")


def _needs_gxx():
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no g++ to build the native engine")


@pytest.mark.parametrize("args", GEOMS, ids=IDS)
def test_compat_tables_bit_equal(args):
    js, ts = _specs(args)
    jt = j_compat.compat_ell_weights(js, prefer_native=False)
    tt = t_compat.compat_ell_weights(ts, prefer_native=False)
    for a, b in zip(jt, tt):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)
    # a block of rows, un-normalised
    Hd = ts.dst_shape[0]
    sl = (Hd // 3, Hd // 3 + 2)
    jt = j_compat.compat_ell_weights(js, dy_slice=sl, normalise=False,
                                     prefer_native=False)
    tt = t_compat.compat_ell_weights(ts, dy_slice=sl, normalise=False,
                                     prefer_native=False)
    for a, b in zip(jt, tt):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1])
def test_compat_cell_state_and_area_bit_equal(seed):
    rng = np.random.default_rng(seed)
    n = 400
    cx, cy = rng.uniform(-1, 1, n), rng.uniform(-1, 1, n)
    ang = rng.uniform(0.05, np.pi / 2 - 0.05)
    c, s = np.cos(ang), np.sin(ang)
    h = rng.uniform(0.4, 1.6)
    us, vs = np.array([-h, h, -h, h]), np.array([-h, -h, h, h])
    qvx = cx[:, None] + us * c + vs * s       # v0, v1, v2, v3
    qvy = cy[:, None] - us * s + vs * c
    x0, y0 = rng.uniform(-1.5, 0.5, n), rng.uniform(-1.5, 0.5, n)
    js = j_compat.compat_cell_state(qvx, qvy, x0, y0)
    ts = t_compat.compat_cell_state(qvx, qvy, x0, y0)
    assert sorted(js) == sorted(ts)
    for k in js:
        assert np.array_equal(js[k], ts[k]), k
    assert np.array_equal(j_compat.compat_get_area(js),
                          t_compat.compat_get_area(ts))


@pytest.mark.parametrize("args", GEOMS[:1] + GEOMS[4:5], ids=["30", "film1.5"])
def test_native_compat_areas_equal_the_numpy_replica(args):
    _needs_gxx()
    ts = at.make_grid_spec(*args)
    before = dict(t_compat.ENGINES)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)   # no fallback
        nat = t_compat.compat_ell_weights(ts, prefer_native=True)
    ref = t_compat.compat_ell_weights(ts, prefer_native=False)
    assert t_compat.ENGINES == {"native": before["native"] + 1,
                                "numpy": before["numpy"] + 1}
    for a, b in zip(nat, ref):
        assert np.array_equal(a, b)


def test_native_compat_failure_falls_back_with_a_warning(monkeypatch):
    ts = at.make_grid_spec(*GEOMS[0])

    def broken(*a, **k):
        raise OSError("no library")

    monkeypatch.setattr(t_native, "compat_cell_areas_native", broken)
    before = dict(t_weights.WEIGHT_GEN_ENGINES)
    with pytest.warns(RuntimeWarning, match="numpy replica"):
        op = t_weights.ell_operator(ts, mode="compat")
    assert t_weights.WEIGHT_GEN_ENGINES["numpy"] == before["numpy"] + 1
    assert t_weights.WEIGHT_GEN_ENGINES["native"] == before["native"]
    ref = t_compat.compat_ell_weights(ts, prefer_native=False)
    assert np.array_equal(op.weights, ref[1])


@pytest.mark.parametrize("args", GEOMS[:4], ids=IDS[:4])
def test_compat_operator_chunks_and_validates(args):
    js, ts = _specs(args)
    jop = _jax_compat_op(js)
    whole = t_weights.ell_operator(ts, mode="compat", prefer_native=False)
    # one dst row per chunk: the chunked operator is the same table
    rows = t_weights.ell_operator(ts, mode="compat", row_chunk=1,
                                  prefer_native=False)
    for top in (whole, rows):
        assert top.mode == "compat"
        for name in ("base", "weights", "raw_row_sums"):
            assert np.array_equal(getattr(jop, name), getattr(top, name))
    stats = t_weights.validate_operator(whole)
    assert stats == j_weights.validate_operator(jop)


@pytest.mark.parametrize("impl,jimpl", [("gather", "xla"),
                                        ("sheared", "sheared"),
                                        ("auto", "xla")])
@pytest.mark.parametrize("args", GEOMS[:5], ids=IDS[:5])
def test_compat_outputs_match_jax(args, impl, jimpl):
    js, ts = _specs(args)
    jop = _jax_compat_op(js)
    top = at.build_operator(ts, mode="compat")
    x = np.random.default_rng(30).uniform(0, 1, (2,) + args[0]).astype(
        np.float32)
    ref = np.asarray(aa.area_average_interpolate(
        jnp.asarray(x), *args[1:], mode="compat", operator=jop).dst)
    got = at.apply_operator(top, torch.from_numpy(x), impl=impl)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)
    if impl == "auto":
        res = at.area_average_interpolate(torch.from_numpy(x), *args[1:],
                                          mode="compat")
        j = aa.area_average_interpolate(jnp.asarray(x), *args[1:],
                                        mode="compat", operator=jop)
        assert res.dst_isocenter == j.dst_isocenter
        np.testing.assert_allclose(res.dst.numpy(), ref, atol=1e-5, rtol=0)


def test_compat_against_a_dense_float64_reference():
    args = GEOMS[0]
    op = at.build_operator(at.make_grid_spec(*args), mode="compat")
    x = np.random.default_rng(31).uniform(0, 1, args[0])
    ref = (op.dense() @ x.reshape(-1)).reshape(op.spec.dst_shape)
    got = at.apply_operator(op, torch.from_numpy(x), impl="gather",
                            weight_dtype=torch.float64)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-12, rtol=0)


def test_axis_aligned_compat_is_exact_and_method_ell_builds_compat():
    x = torch.rand(2, 24, 32, generator=torch.Generator().manual_seed(3))
    args = (2.0, 1.0, (0.0, 0.0), 90.0)
    torch.testing.assert_close(
        at.area_average_interpolate(x, *args, mode="compat").dst,
        at.area_average_interpolate(x, *args).dst, atol=0, rtol=0)
    spec = at.make_grid_spec((24, 32), *args)
    cop = at.build_operator(spec, mode="compat", method="ell")
    assert isinstance(cop, at.EllOperator) and cop.mode == "compat"
    sep = at.build_operator(spec, mode="compat")
    assert isinstance(sep, at.SeparableOperator)


def test_compat_window_rides_the_shear_plan():
    # the compat window (Kc 10 at 1.0 -> 0.5, as at the rotated flagship)
    # is wider than exact mode's K 6; its live cells shear into the same
    # 5 x 5 window, so the kernel route takes it
    spec = at.make_grid_spec((96, 96), 1.0, 0.5, (48.0, 48.0), 30.0)
    cop = at.build_operator(spec, mode="compat")
    eop = at.build_operator(spec)
    assert (cop.window, eop.window) == (10, 6)
    cplan, eplan = cuda_shear.kernel_plan(cop), cuda_shear.kernel_plan(eop)
    assert (cplan.Ka, cplan.Kb) == (eplan.Ka, eplan.Kb) == (5, 5)
    x = torch.rand(2, 96, 96, generator=torch.Generator().manual_seed(4))
    # the kernel route's wrappers take their plain versions on the CPU
    got = cuda_shear.apply_ell_shear_kernel(x, cplan)
    ref = at.apply_operator(cop, x, impl="gather")
    torch.testing.assert_close(got, ref, atol=1e-6, rtol=0)


def test_convert_carries_a_jax_compat_operator():
    js = aa.make_grid_spec(*GEOMS[0])
    jop = _jax_compat_op(js)
    assert jop.window > js.window_cells
    top = convert.ell_operator_from_numpy(
        dataclasses.asdict(jop.spec), np.asarray(jop.base),
        np.asarray(jop.weights), np.asarray(jop.raw_row_sums), mode="compat")
    assert top.mode == "compat" and top.window == jop.window
    at.validate_operator(top)
    x = torch.rand(36, 44, generator=torch.Generator().manual_seed(5))
    torch.testing.assert_close(
        at.apply_operator(top, x),
        at.area_average_interpolate(x, *GEOMS[0][1:], mode="compat").dst,
        atol=0, rtol=0)
