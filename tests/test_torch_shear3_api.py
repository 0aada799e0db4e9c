"""The port's ``area_average_interpolate(mode='shear')`` against the JAX
package, and the ``Shear3Linear`` gradient.

On CPU tensors the API takes the plain pipeline (JAX's 'xla' route there);
``Shear3Linear`` runs its stages through the kernel wrappers, which take
their plain versions on CPU tensors.  The kernels themselves are checked
on the card (tests/test_torch_kernel_cuda.py, chip_smoke.py).

Tolerances, with their reasons: the API and the gradient against JAX
atol 2e-5 and 3e-6, as JAX's own tests (test_shear3.py:144, :417-425);
the adjoint identity relative 1e-9 in float64 (test_shear3.py:435).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aainterp as aa
from aainterp.ops import shear3 as j_shear3

import aainterp_torch as at
from aainterp_torch import api as t_api
from aainterp_torch.ops import cuda_shear3
from aainterp_torch.ops import shear3 as t_shear3

# one geometry per quadrant (test_shear3.py:21-31): (H, W, sres, dres, angle)
QUAD_GEOMS = [
    (96, 96, 1.0, 0.5, 30.0),
    (64, 64, 1.0, 0.8, 100.0),
    (48, 64, 1.0, 0.7, 213.0),
    (64, 48, 1.0, 1.0, 322.0),
]


def _frames(shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("dec", ["quality", "fast"])
@pytest.mark.parametrize("g", QUAD_GEOMS, ids=lambda g: f"{g[4]:g}deg")
def test_api_matches_jax(g, dec):
    H, W, sr, dr, ang = g
    iso = (W / 2, H / 2)
    src = _frames((2, H, W), 1)
    ref = aa.area_average_interpolate(src, sr, dr, iso, ang, mode="shear",
                                      method="xla", shear_decomposition=dec)
    got = at.area_average_interpolate(torch.from_numpy(src), sr, dr, iso, ang,
                                      mode="shear", shear_decomposition=dec)
    assert got.spec.quadrant == g[4] // 90
    assert got.dst.dtype == torch.float32
    assert got.dst_isocenter == ref.dst_isocenter
    assert tuple(got.dst.shape) == (2,) + got.spec.dst_shape
    np.testing.assert_allclose(got.dst.numpy(), np.asarray(ref.dst),
                               atol=2e-5, rtol=0)
    plain = at.area_average_interpolate(
        torch.from_numpy(src), sr, dr, iso, ang, mode="shear",
        method="plain", shear_decomposition=dec)
    assert torch.equal(plain.dst, got.dst)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.uint8])
def test_api_dtype_contract(dtype):
    # both shear routes return the input's dtype (shear3.py:483-486), unlike
    # the separable and ELL plain routes, which give f32 for bf16 and u8
    src = torch.from_numpy(_frames((2, 64, 64), 2) * 255).to(dtype)
    res = at.area_average_interpolate(src, 1.0, 0.5, (32.0, 32.0), 30.0,
                                      mode="shear")
    assert res.dst.dtype == dtype
    ref = at.area_average_interpolate(src.float(), 1.0, 0.5, (32.0, 32.0),
                                      30.0, mode="shear").dst
    atol = {torch.float32: 0.0, torch.bfloat16: 1.0, torch.uint8: 1.0}[dtype]
    assert (res.dst.double() - ref.double()).abs().max() <= atol


@pytest.mark.parametrize("angle", [0.0, 90.0, 180.0])
def test_axis_aligned_falls_through_to_exact(angle):
    src = torch.from_numpy(_frames((2, 48, 64), 3))
    args = (1.0, 0.5, (32.0, 24.0), angle)
    ex = at.area_average_interpolate(src, *args, mode="exact").dst
    for method in ("auto", "plain"):
        sh = at.area_average_interpolate(src, *args, mode="shear",
                                         method=method).dst
        assert torch.equal(sh, ex), method
    # the shear method picks the separable impl: 'kernel' needs a CUDA
    # tensor there too (not the JAX package's "unknown method")
    with pytest.raises(ValueError, match="CUDA"):
        at.area_average_interpolate(src, *args, mode="shear", method="kernel")
    # an explicit operator is allowed, as for mode='exact'
    op = at.build_operator(at.make_grid_spec((48, 64), *args))
    assert torch.equal(at.area_average_interpolate(
        src, *args, mode="shear", operator=op).dst, ex)


def test_shear_errors():
    src = torch.from_numpy(_frames((48, 48), 4))
    args = (1.0, 0.5, (24.0, 24.0), 30.0)
    op = at.build_operator(at.make_grid_spec((48, 48), *args))
    with pytest.raises(ValueError, match="builds no Operator"):
        at.area_average_interpolate(src, *args, mode="shear", operator=op)
    with pytest.raises(ValueError, match="builds no Operator"):
        at.area_average_interpolate(src, *args, mode="shear", fused=True)
    with pytest.raises(ValueError, match="auto/kernel/plain"):
        at.area_average_interpolate(src, *args, mode="shear", method="xla")
    with pytest.raises(ValueError, match="auto/kernel/plain"):
        at.area_average_interpolate(src, 1.0, 0.5, (24.0, 24.0), 0.0,
                                    mode="shear", method="pallas")
    with pytest.raises(ValueError, match="CUDA"):
        at.area_average_interpolate(src, *args, mode="shear", method="kernel")
    with pytest.raises(ValueError, match="unknown decomposition"):
        at.area_average_interpolate(src, *args, mode="shear",
                                    shear_decomposition="bogus")
    with pytest.raises(ValueError, match="weight_dtype"):
        at.area_average_interpolate(src, *args, mode="shear",
                                    weight_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="operator-free"):
        at.build_operator(at.make_grid_spec((48, 48), *args), mode="shear")
    with pytest.raises(ValueError, match="exact/fast/compat/shear"):
        at.area_average_interpolate(src, *args, mode="bogus")


def test_plan_cache_is_byte_bounded_and_reused():
    assert t_api._SHEAR3_CACHE.max_bytes is not None
    spec = at.make_grid_spec((40, 40), 1.0, 0.5, (20.0, 20.0), 30.0)
    p1 = t_api._shear3_plan(spec, "fast")
    assert t_api._shear3_plan(spec, "fast") is p1
    assert t_api._shear3_plan(spec, "quality") is not p1


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------


def _grad_spec():
    # test_shear3.py:409: a band branch with a valid y-x-y decomposition
    return (48, 64, 1.0, 0.6, (32.0, 24.0), 23.0)


@pytest.mark.parametrize("dec", ["xyx", "yxy"])
def test_shear3_linear_matches_jax_vjp(dec):
    H, W, sr, dr, iso, ang = _grad_spec()
    jp = j_shear3.build_shear3_plan(aa.make_grid_spec((H, W), sr, dr, iso,
                                                      ang), dec)
    tp = t_shear3.build_shear3_plan(at.make_grid_spec((H, W), sr, dr, iso,
                                                      ang), dec)
    q = _frames(tp.src_shape, 5)
    cot = np.random.default_rng(6).uniform(-1, 1, tp.dst_shape).astype(
        np.float32)
    arrs = j_shear3.plan_arrays(jp)
    out_ref, vjp_ref = jax.vjp(
        jax.jit(lambda x: j_shear3.apply_shear3_xla(jp, x, arrs)),
        jnp.asarray(q))
    g_ref = np.asarray(vjp_ref(jnp.asarray(cot))[0])
    fn = cuda_shear3.make_shear3_linear(tp)
    assert cuda_shear3.make_shear3_linear(tp) is fn      # cached per plan
    x = torch.from_numpy(q).requires_grad_(True)
    out = fn(x)
    (g,) = torch.autograd.grad(out, x, torch.from_numpy(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_ref),
                               atol=3e-6, rtol=0)
    assert g.dtype == torch.float32
    np.testing.assert_allclose(g.numpy(), g_ref, atol=3e-6, rtol=0)
    # torch autograd of the plain pipeline gives the same gradient
    xp = torch.from_numpy(q).requires_grad_(True)
    (gp,) = torch.autograd.grad(t_shear3.apply_shear3_plain(xp, tp), xp,
                                torch.from_numpy(cot))
    np.testing.assert_allclose(g.numpy(), gp.numpy(), atol=3e-6, rtol=0)


def test_shear3_linear_batched_bf16_and_u8():
    H, W, sr, dr, iso, ang = _grad_spec()
    tp = t_shear3.build_shear3_plan(at.make_grid_spec((H, W), sr, dr, iso,
                                                      ang))
    fn = cuda_shear3.make_shear3_linear(tp)
    x = torch.from_numpy(_frames((2, 3) + tp.src_shape, 7)).bfloat16()
    x.requires_grad_(True)
    out = fn(x)
    assert out.dtype == torch.bfloat16 and out.shape == (2, 3) + tp.dst_shape
    (g,) = torch.autograd.grad(out.float().sum(), x)
    assert g.dtype == torch.bfloat16 and g.shape == x.shape
    assert torch.isfinite(g.float()).all()
    with pytest.raises(TypeError, match="float-only"):
        fn(torch.zeros(tp.src_shape, dtype=torch.uint8))


def test_adjoint_identity():
    H, W, sr, dr, iso, ang = _grad_spec()
    spec = at.make_grid_spec((H, W), sr, dr, iso, ang)
    rng = np.random.default_rng(8)
    for dec in ("xyx", "yxy"):
        plan = t_shear3.build_shear3_plan(spec, dec)
        planT = t_shear3.transpose_shear3_plan(plan)
        g = rng.uniform(0, 1, spec.dst_shape)
        q = rng.uniform(0, 1, spec.qrot_shape)
        lhs = float((t_shear3.apply_shear3_np(plan, q, normalize=False)
                     * g).sum())
        rhs = float((q * t_shear3.apply_shear3_np(planT, g,
                                                  normalize=False)).sum())
        assert abs(lhs - rhs) / abs(lhs) < 1e-9, dec


def test_api_differentiable_matches_jax_grad():
    src = np.asarray(_frames((48, 48), 9))

    def j_loss(x):
        return jnp.sum(aa.area_average_interpolate(
            x, 1.0, 1.0, (24.0, 24.0), 30.0, mode="shear",
            method="xla").dst ** 2)

    g_ref = np.asarray(jax.grad(j_loss)(jnp.asarray(src)))
    x = torch.from_numpy(src).requires_grad_(True)
    loss = (at.area_average_interpolate(x, 1.0, 1.0, (24.0, 24.0), 30.0,
                                        mode="shear",
                                        differentiable=True).dst ** 2).sum()
    (g,) = torch.autograd.grad(loss, x)
    np.testing.assert_allclose(g.numpy(), g_ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dec", ["quality", "fast"])
def test_weight_dtype_float64_matches_jax_x64(dec):
    # JAX's XLA route with x64 on keeps the plan's band weights and inv_cov
    # in float64 (aainterp/ops/shear3.py:458-472) but casts them to the f32
    # pipeline's dtype where it uses them (:454, :507): the result is f32,
    # and the port's plain route, which computes in f32 whatever
    # weight_dtype says, gives the same bits
    H, W, sr, dr, ang = 72, 56, 1.0, 0.6, 37.0
    iso = (W / 2, H / 2)
    src = _frames((2, H, W), 6)
    with jax.enable_x64(True):
        ref = aa.area_average_interpolate(
            jnp.asarray(src), sr, dr, iso, ang, mode="shear", method="xla",
            weight_dtype=jnp.float64, shear_decomposition=dec).dst
        ref = np.asarray(ref)
    assert ref.dtype == np.float32
    for method in ("auto", "plain"):
        got = at.area_average_interpolate(
            torch.from_numpy(src), sr, dr, iso, ang, mode="shear",
            method=method, weight_dtype=torch.float64,
            shear_decomposition=dec).dst
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), ref)
