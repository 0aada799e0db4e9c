"""Plain rotated applies of the PyTorch port against the JAX package.

Each plain shear stage of ``ops/cuda_shear.py`` against a numpy statement
of its formula; the plain shear pipeline and the plain ``apply_ell``
against JAX's ``apply_ell`` and against JAX's Pallas rotated apply in
interpret mode (``make_pallas_shear_apply(op, interpret=True)``, as
tests/test_pallas_shear.py runs it), both as the three plain stages and
as the card's route (the fused shear, then the contraction).  The kernel wrappers take these plain
versions on CPU tensors; the kernels themselves are checked on the card
(tests/test_torch_kernel_cuda.py, chip_smoke.py).

Tolerances: f32 pipeline vs JAX apply_ell atol 1e-6 on [0, 1] inputs
(summation order only); vs interpret-mode Pallas f32 atol 1e-5; bf16
outputs within one bf16 ulp of each other (both round an f32 sum).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aainterp as aa
from aainterp.ops import apply as j_apply
from aainterp.ops import weights as j_weights
from aainterp.ops.pallas_shear import make_pallas_shear_apply

import aainterp_torch as at
from aainterp_torch.ops import apply as t_apply
from aainterp_torch.ops import cuda_shear
from aainterp_torch.ops import weights as t_weights

GEOMS = [
    ((40, 52), 1.0, 0.5, (26.0, 20.0), 30.0),
    ((36, 48), 1.0, 0.5, (20.0, 15.0), 120.0),
    ((60, 60), 150.0, 25.4, (30.0, 30.0), 1.5),
]
IDS = ["30", "120", "film1.5"]


def _ops(args, mode="exact"):
    """(jax op, port op), both folded to quadrant 0, from equal tables."""
    jop = j_weights.ell_operator(aa.make_grid_spec(*args), mode=mode,
                                 prefer_native=False)
    top = t_weights.ell_operator(at.make_grid_spec(*args), mode=mode,
                                 prefer_native=False)
    if top.spec.quadrant:
        jop = j_weights.fold_quadrant_ell(jop)[0]
        top = t_weights.fold_quadrant_ell(top)[0]
    return jop, top


def _frames(shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |x| (8 significant bits), as f64."""
    a = x.double().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def _plan(top):
    return cuda_shear.plan_from_operator(top)


# ---------------------------------------------------------------------------
# each plain stage against a numpy statement of its formula
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("args", GEOMS, ids=IDS)
def test_vshear_plain_formula(args, dtype):
    plan = _plan(_ops(args)[1])
    q = torch.from_numpy(_frames((2, plan.qH, plan.qW))).to(dtype)
    s = cuda_shear.vshear_plain(q, plan)
    qn = q.float().numpy()
    want = np.zeros((2, plan.TH, plan.qW), np.float32)
    for x in range(plan.qW):
        for y in range(plan.TH):
            r = y - plan.gy[x]
            if 0 <= r < plan.qH:
                want[:, y, x] = qn[:, r, x]
    assert s.dtype == dtype
    np.testing.assert_array_equal(s.float().numpy(), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("args", GEOMS, ids=IDS)
def test_hshear_plain_formula(args, dtype):
    plan = _plan(_ops(args)[1])
    s = torch.from_numpy(_frames((2, plan.TH, plan.qW), 1)).to(dtype)
    t = cuda_shear.hshear_plain(s, plan)
    sn = s.float().numpy()
    want = np.zeros((2, plan.TH, plan.TW), np.float32)
    for y in range(plan.TH):
        for x in range(plan.TW):
            c = x - plan.hx[y]
            if 0 <= c < plan.qW:
                want[:, y, x] = sn[:, y, c]
    assert t.dtype == dtype
    np.testing.assert_array_equal(t.float().numpy(), want)


@pytest.mark.parametrize("args", GEOMS, ids=IDS)
def test_contract_plain_formula(args):
    plan = _plan(_ops(args)[1])
    t = torch.from_numpy(_frames((2, plan.TH, plan.TW), 2))
    got = cuda_shear.contract_plain(t, plan)
    tn = t.double().numpy()
    w2 = plan.w2.astype(np.float64)
    want = np.zeros((2, plan.Hd, plan.Wd))
    for a in range(plan.Ka):
        rows = np.clip(plan.ry0 + a, 0, plan.TH - 1)
        for b in range(plan.Kb):
            cols = np.clip(plan.cx0 + b, 0, plan.TW - 1)
            want += w2[a * plan.Kb + b] * tn[:, rows][:, :, cols]
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    # bf16 T keeps bf16 out, within one ulp of the f32 sum
    tb = t.to(torch.bfloat16)
    got_b = cuda_shear.contract_plain(tb, plan)
    ref_b = cuda_shear.contract_plain(tb, plan, out_dtype=torch.float32)
    assert got_b.dtype == torch.bfloat16
    assert ((got_b.double() - ref_b.double()).abs()
            <= bf16_ulp(ref_b)).all()


@pytest.mark.parametrize("stage", ["vshear", "hshear", "vhshear"])
def test_shears_write_every_element_of_a_nan_plane(stage):
    # a zero-weight contraction tap reads whatever the shears left in T:
    # the shears must overwrite every element, zeros included (NaN * 0 is
    # NaN), so a plane pre-filled with NaN comes back finite
    plan = _plan(_ops(GEOMS[0])[1])
    if stage == "vshear":
        src = torch.from_numpy(_frames((2, plan.qH, plan.qW)))
        shape, fns = (2, plan.TH, plan.qW), (cuda_shear.vshear_plain,
                                             cuda_shear.vshear_kernel)
    elif stage == "vhshear":
        src = torch.from_numpy(_frames((2, plan.qH, plan.qW)))
        shape, fns = (2, plan.TH, plan.TW), (cuda_shear.vhshear_plain,
                                             cuda_shear.vhshear_kernel)
    else:
        src = torch.from_numpy(_frames((2, plan.TH, plan.qW)))
        shape, fns = (2, plan.TH, plan.TW), (cuda_shear.hshear_plain,
                                             cuda_shear.hshear_kernel)
    want = fns[0](src, plan)
    assert (want == 0).any()                 # the zero fill is exercised
    for fn in fns:
        out = torch.full(shape, float("nan"))
        got = fn(src, plan, out=out)
        assert got is out
        assert torch.isfinite(out).all()
        assert torch.equal(out, want)
    # and the pipeline out of NaN-free frames is finite end to end
    q = torch.from_numpy(_frames((2, plan.qH, plan.qW)))
    assert torch.isfinite(cuda_shear.apply_ell_shear_plain(q, plan)).all()


# ---------------------------------------------------------------------------
# plain pipelines against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("args", GEOMS, ids=IDS)
def test_plain_routes_match_jax_apply_ell(args):
    jop, top = _ops(args)
    plan = _plan(top)
    x = _frames((2, 3) + tuple(top.spec.qrot_shape), 4)
    ref = np.asarray(j_apply.apply_ell(jnp.asarray(x), jnp.asarray(jop.base),
                                       jnp.asarray(jop.weights, jnp.float32)))
    xt = torch.from_numpy(x)
    got = t_apply.apply_ell(xt, torch.from_numpy(top.base),
                            torch.from_numpy(top.weights).float())
    assert got.shape == (2, 3) + tuple(top.spec.dst_shape)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)
    sheared = cuda_shear.apply_ell_shear_plain(
        xt.reshape((6,) + xt.shape[-2:]), plan).reshape(got.shape)
    np.testing.assert_allclose(sheared.numpy(), ref, atol=1e-6, rtol=0)
    # float64 weights accumulate in float64 on the gather route
    got64 = t_apply.apply_ell(xt.double(), torch.from_numpy(top.base),
                              torch.from_numpy(top.weights))
    ref64 = (top.dense() @ x.reshape(6, -1).T.astype(np.float64)).T
    np.testing.assert_allclose(got64.numpy().reshape(6, -1), ref64,
                               atol=1e-12, rtol=0)


def test_apply_ell_clamps_out_of_range_taps():
    # a window base past the edge reads clamped cells with zero weight
    q = torch.arange(12.0).reshape(3, 4)
    base = torch.tensor([[[2, 3]]], dtype=torch.int32)    # rows 2..3, cols 3..4
    w = torch.tensor([[[[1.0, 0.0], [0.0, 0.0]]]])
    assert t_apply.apply_ell(q, base, w).item() == 11.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("args", [GEOMS[0], GEOMS[1]], ids=IDS[:2])
def test_shear_pipeline_matches_pallas_interpret(args, dtype):
    jop, top = _ops(args)
    plan = _plan(top)
    x = _frames((2,) + tuple(top.spec.qrot_shape), 5)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    fn, arrs = make_pallas_shear_apply(jop, interpret=True)
    ref = fn(jnp.asarray(x, jdt), **arrs)
    xt = torch.from_numpy(np.array(jnp.asarray(x, jdt).astype(jnp.float32)))
    xt = xt.to(getattr(torch, dtype))
    got = cuda_shear.apply_ell_shear_plain(xt, plan)
    # the card's route: the fused shear (T straight from q), then the
    # contraction
    fused = cuda_shear.contract_plain(cuda_shear.vhshear_plain(xt, plan),
                                      plan)
    assert got.dtype == xt.dtype and ref.dtype == jdt
    assert fused.dtype == xt.dtype
    ref_t = torch.from_numpy(np.asarray(ref.astype(jnp.float32)))
    for out in (got, fused):
        if dtype == "float32":
            np.testing.assert_allclose(out.numpy(), ref_t.numpy(), atol=1e-5,
                                       rtol=0)
        else:
            assert ((out.double() - ref_t.double()).abs()
                    <= bf16_ulp(ref_t)).all()


# ---------------------------------------------------------------------------
# wrappers on the CPU
# ---------------------------------------------------------------------------


def test_kernel_wrappers_take_the_plain_version_on_cpu():
    _, top = _ops(GEOMS[0])
    plan = _plan(top)
    q = torch.from_numpy(_frames((3, plan.qH, plan.qW), 6))
    before = dict(cuda_shear.LAUNCHES)
    got = cuda_shear.apply_ell_shear_kernel(q, plan)
    assert cuda_shear.LAUNCHES == before        # nothing launched
    assert torch.equal(got, cuda_shear.apply_ell_shear_plain(q, plan))
    # (qH, qW) frames, and u8 frames give f32 (pallas_shear.py:789-792)
    assert torch.equal(cuda_shear.apply_ell_shear_kernel(q[0], plan), got[0])
    u8 = (q * 255).round().to(torch.uint8)
    out = cuda_shear.apply_ell_shear_kernel(u8, plan)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(
        out.numpy(), cuda_shear.apply_ell_shear_plain(u8.float(), plan),
        atol=0)


@pytest.mark.parametrize("stage", ["vshear", "hshear", "vhshear",
                                   "contract"])
def test_wrappers_reject_shapes_that_do_not_match_the_plan(stage):
    plan = _plan(_ops(GEOMS[0])[1])
    fn = getattr(cuda_shear, f"{stage}_kernel")
    with pytest.raises(ValueError, match="for this plan"):
        fn(torch.zeros(2, plan.qH + 1, plan.qW + 1), plan)
    with pytest.raises(ValueError, match="for this plan"):
        fn(torch.zeros(plan.qH, plan.qW), plan)      # 2-D: no frame axis


def test_out_buffer_is_checked():
    plan = _plan(_ops(GEOMS[0])[1])
    q = torch.zeros(2, plan.qH, plan.qW)
    with pytest.raises(ValueError, match="out must be"):
        cuda_shear.vshear_plain(q, plan, out=torch.zeros(2, plan.TH, 1))


def test_kernel_plan_is_cached_and_caches_rejections():
    _, top = _ops(GEOMS[2])
    p1 = cuda_shear.kernel_plan(top)
    assert cuda_shear.kernel_plan(top) is p1
    assert p1.w2.dtype == np.float32 and p1.w2.flags.c_contiguous
    assert p1.w2.shape == (p1.Ka * p1.Kb, p1.Hd, p1.Wd)
    empty = dataclasses.replace(top, weights=np.zeros_like(top.weights))
    for _ in range(2):
        with pytest.raises(ValueError, match="empty operator"):
            cuda_shear.kernel_plan(empty)
    tabs = p1.tables(torch.device("cpu"))
    assert p1.tables(torch.device("cpu")) is tabs
    assert tabs["w2"].dtype == torch.float32
