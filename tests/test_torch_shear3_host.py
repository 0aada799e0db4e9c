"""Host planning of the port's mode='shear' against the JAX package.

The carried planner (``aainterp_torch/ops/shear3.py``) against
``aainterp/ops/shear3.py``, bit for bit (``np.array_equal``): every
pass's shifts, fractions, grid sizes, crops and bands, the reciprocal
coverage, the transposed (adjoint) plan and the float64 numpy reference
apply; the planner's errors; the numpy carry-over
(``convert.shear3_plan_from_numpy``); and the stage plan the plain stages
and the kernels take.
"""

import dataclasses

import numpy as np
import pytest
import torch

import aainterp as aa
from aainterp.ops import shear3 as j_shear3

import aainterp_torch as at
from aainterp_torch import convert
from aainterp_torch.ops import shear3 as t_shear3

# tests/test_shear3.py:21-31: band and fold (s == L) branches, steep
# angles, anisotropic shapes, quadrants 1-3
GEOMS = [
    (96, 96, 1.0, 0.5, 30.0),
    (64, 80, 1.0, 1.0, 30.0),
    (72, 72, 1.0, 1.0, 75.0),
    (64, 64, 2.0, 1.5, 14.0),
    (64, 64, 1.0, 0.8, 100.0),
    (48, 64, 1.0, 0.7, 213.0),
    (64, 48, 1.0, 1.0, 322.0),
]


def _cases():
    """(geometry, decomposition) for every decomposition the geometry
    admits: xyx always, yxy when scale < dst_side."""
    out = []
    for g in GEOMS:
        H, W, sr, dr, ang = g
        spec = aa.make_grid_spec((H, W), sr, dr, (W / 2, H / 2), ang)
        for dec in ("xyx", "yxy"):
            if dec == "xyx" or spec.scale < spec.dst_side:
                out.append(pytest.param(g, dec, id=f"{H}x{W}-{ang:g}-{dec}"))
    return out


CASES = _cases()


def _plans(g, dec):
    H, W, sr, dr, ang = g
    iso = (W / 2, H / 2)
    return (j_shear3.build_shear3_plan(aa.make_grid_spec((H, W), sr, dr, iso,
                                                         ang), dec),
            t_shear3.build_shear3_plan(at.make_grid_spec((H, W), sr, dr, iso,
                                                         ang), dec))


def _assert_plans_equal(jp, tp):
    assert dataclasses.asdict(jp.spec) == dataclasses.asdict(tp.spec)
    assert (jp.in_shape, jp.out_shape) == (tp.in_shape, tp.out_shape)
    assert (jp.src_shape, jp.dst_shape) == (tp.src_shape, tp.dst_shape)
    if jp.inv_cov is None:
        assert tp.inv_cov is None
    else:
        assert tp.inv_cov.dtype == jp.inv_cov.dtype == np.float32
        assert np.array_equal(jp.inv_cov, tp.inv_cov)
    assert len(jp.passes) == len(tp.passes) == 3
    for a, b in zip(jp.passes, tp.passes):
        assert (a.axis, a.band_first, a.n_t, a.crop, a.n_out) == \
            (b.axis, b.band_first, b.n_t, b.crop, b.n_out)
        for name in ("d", "f"):
            x, y = getattr(a, name), getattr(b, name)
            assert x.dtype == y.dtype and np.array_equal(x, y), name
        assert (a.band is None) == (b.band is None)
        if a.band is not None:
            assert (a.band.n_src, a.band.n_dst) == (b.band.n_src, b.band.n_dst)
            assert np.array_equal(a.band.start, b.band.start)
            assert a.band.weights.dtype == b.band.weights.dtype
            assert np.array_equal(a.band.weights, b.band.weights)


@pytest.mark.parametrize("g,dec", CASES)
def test_plan_bit_equal(g, dec):
    jp, tp = _plans(g, dec)
    _assert_plans_equal(jp, tp)


@pytest.mark.parametrize("g,dec", CASES)
def test_transposed_plan_bit_equal(g, dec):
    jp, tp = _plans(g, dec)
    _assert_plans_equal(j_shear3.transpose_shear3_plan(jp),
                        t_shear3.transpose_shear3_plan(tp))


@pytest.mark.parametrize("g,dec", CASES[:4])
def test_numpy_reference_bit_equal(g, dec):
    jp, tp = _plans(g, dec)
    qH, qW = tp.src_shape
    q = np.random.default_rng(3).uniform(0, 1, (2, qH, qW))
    assert np.array_equal(j_shear3.apply_shear3_np(jp, q),
                          t_shear3.apply_shear3_np(tp, q))
    g_ = np.random.default_rng(4).uniform(0, 1, (2,) + tp.dst_shape)
    assert np.array_equal(
        j_shear3.apply_shear3_np(j_shear3.transpose_shear3_plan(jp), g_),
        t_shear3.apply_shear3_np(t_shear3.transpose_shear3_plan(tp), g_))


def test_decomposition_names():
    spec = at.make_grid_spec((64, 64), 1.0, 0.5, (32.0, 32.0), 30.0)
    xyx = t_shear3.build_shear3_plan(spec, "xyx")
    for name in ("auto", "quality"):
        _assert_plans_equal(t_shear3.build_shear3_plan(spec, name), xyx)
    _assert_plans_equal(t_shear3.build_shear3_plan(spec, "fast"),
                        t_shear3.build_shear3_plan(spec, "yxy"))
    # 'fast' at rho >= 1 (scale == dst_side) is x-y-x
    eq = at.make_grid_spec((64, 64), 1.0, 1.0, (32.0, 32.0), 30.0)
    _assert_plans_equal(t_shear3.build_shear3_plan(eq, "fast"),
                        t_shear3.build_shear3_plan(eq, "xyx"))


@pytest.mark.parametrize("args,dec,match", [
    (((64, 64), 1.0, 0.5, (32.0, 32.0), 90.0), "auto", "rotated"),
    (((64, 64), 1.0, 1.0, (32.0, 32.0), 30.0), "yxy", "scale < dst_side"),
    (((64, 64), 1.0, 0.5, (32.0, 32.0), 30.0), "bogus", "unknown decomp"),
])
def test_planner_errors_match_jax(args, dec, match):
    for mod, pkg in ((t_shear3, at), (j_shear3, aa)):
        with pytest.raises(ValueError, match=match):
            mod.build_shear3_plan(pkg.make_grid_spec(*args), dec)


def _fields(jp):
    passes = [dict(axis=p.axis, band_first=p.band_first, d=p.d, f=p.f,
                   n_t=p.n_t, crop=p.crop, n_out=p.n_out,
                   band=None if p.band is None else (
                       p.band.start, p.band.weights, p.band.n_src,
                       p.band.n_dst))
              for p in jp.passes]
    return (dataclasses.asdict(jp.spec), passes, jp.inv_cov, jp.in_shape,
            jp.out_shape)


@pytest.mark.parametrize("g,dec", CASES[:2])
def test_convert_shear3_plan_from_jax(g, dec):
    jp, tp = _plans(g, dec)
    for j, t in ((jp, tp), (j_shear3.transpose_shear3_plan(jp),
                            t_shear3.transpose_shear3_plan(tp))):
        conv = convert.shear3_plan_from_numpy(*_fields(j))
        _assert_plans_equal(j, conv)
        _assert_plans_equal(conv, t)
    spec_f, passes, inv_cov, _, _ = _fields(jp)
    bad = [dict(p) for p in passes]
    bad[0]["axis"] = "z"
    with pytest.raises(ValueError, match="axis"):
        convert.shear3_plan_from_numpy(spec_f, bad, inv_cov)
    bad = [dict(p) for p in passes]
    bad[1]["f"] = bad[1]["f"][:-1]
    with pytest.raises(ValueError, match="do not match"):
        convert.shear3_plan_from_numpy(spec_f, bad, inv_cov)


def test_stage_plan_forms_sizes_and_cache():
    spec = at.make_grid_spec((96, 96), 1.0, 0.5, (48.0, 48.0), 30.0)
    T, PRE, POST = (t_shear3.TRANSLATE, t_shear3.PRE_BAND,
                    t_shear3.POST_BAND)
    for dec, forms in (("xyx", (T, POST, POST)), ("yxy", (PRE, PRE, T))):
        plan = t_shear3.build_shear3_plan(spec, dec)
        sp = t_shear3.stage_plan(plan)
        assert t_shear3.stage_plan(plan) is sp
        assert tuple(s.form for s in sp.stages) == forms
        assert tuple(s.axis for s in sp.stages) == tuple(dec)
        # the chain: each stage's output is the next stage's input
        shape = plan.src_shape
        for st in sp.stages:
            assert st.in_shape == shape
            assert st.d.dtype == np.int32 and st.f.dtype == np.float32
            if st.K:
                rows = st.n_out if st.form == POST else st.n_mid
                assert st.w.dtype == np.float32
                assert st.w.shape == (rows, st.K)
            shape = st.out_shape
        assert shape == plan.dst_shape == sp.dst_shape
        # the adjoint swaps pre- and post-bands and runs the axes reversed
        spT = t_shear3.stage_plan(t_shear3.transpose_shear3_plan(plan))
        swap = {T: T, PRE: POST, POST: PRE}
        assert tuple(s.form for s in spT.stages) == tuple(
            swap[f] for f in reversed(forms))
        assert spT.inv_cov is None and spT.src_shape == plan.dst_shape
        # an equal plan from other arrays finds the same stage plan
        copy = convert.shear3_plan_from_numpy(*_fields(plan))
        assert t_shear3.stage_plan(copy) is sp
        tabs = sp.tables(torch.device("cpu"))
        assert sp.tables(torch.device("cpu")) is tabs
        assert tabs[1].dtype == torch.float32
        assert tabs[1].shape == plan.dst_shape


def test_stage_plan_rejects_a_broken_chain():
    spec = at.make_grid_spec((64, 64), 1.0, 0.5, (32.0, 32.0), 30.0)
    plan = t_shear3.build_shear3_plan(spec)
    p = plan.passes[1]
    short = dataclasses.replace(p, d=p.d[:-1], f=p.f[:-1])
    with pytest.raises(ValueError, match="shifts"):
        t_shear3.stage_plan(dataclasses.replace(
            plan, passes=(plan.passes[0], short, plan.passes[2])))
    with pytest.raises(ValueError, match="inv_cov"):
        t_shear3.stage_plan(dataclasses.replace(
            plan, inv_cov=plan.inv_cov[:-1]))
    with pytest.raises(ValueError, match="translate grid"):
        t_shear3.stage_plan(dataclasses.replace(
            plan, passes=(dataclasses.replace(plan.passes[0], crop=5),)
            + plan.passes[1:]))
