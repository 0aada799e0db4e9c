"""The rotated apply's custom gradient (``autodiff.EllLinear``) and its
scatter-add adjoint against the JAX package on the CPU.

Forward and ``jax.vjp`` gradients of the gather and sheared routes at
quadrants 0-3 within f32 atol 1e-5 (the JAX tests' own pin,
tests/test_autodiff.py:162-195, 300-328); the kernel route's code path
(its wrappers take their plain versions on a CPU tensor) likewise.  The
differentiable forward equals the non-differentiable one bit for bit
(the same route); the adjoint identity <A u, v> = <u, A^T v> holds to
rel 1e-12 in float64; ``apply_ell_transpose`` equals JAX's within f32
atol 1e-6 (the same terms summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aainterp as aa
from aainterp.ops import apply as j_apply
from aainterp.ops import weights as j_weights

import aainterp_torch as at
from aainterp_torch import autodiff as t_autodiff
from aainterp_torch.ops import apply as t_apply
from aainterp_torch.ops import cuda_shear
from aainterp_torch.ops import weights as t_weights

ANGLES = [30.0, 120.0, 210.0, 300.5]       # quadrants 0-3


def _args(shape, angle):
    H, W = shape
    return ((H, W), 1.0, 0.5, (W / 2.0 + 0.3, H / 2.0 - 0.2), angle)


def _ops(args):
    jop = j_weights.ell_operator(aa.make_grid_spec(*args), prefer_native=False)
    top = at.build_operator(at.make_grid_spec(*args))
    return jop, top


def _inputs(args, seed, frames=2):
    spec = at.make_grid_spec(*args)
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (frames,) + args[0]).astype(np.float32)
    g = rng.uniform(-1, 1, (frames,) + spec.dst_shape).astype(np.float32)
    return x, g


def _jax_vjp(jop, x, g):
    y, vjp = jax.vjp(lambda v: aa.apply_operator(jop, v, impl="xla",
                                                 differentiable=True),
                     jnp.asarray(x))
    (gx,) = vjp(jnp.asarray(g))
    return np.asarray(y), np.asarray(gx)


@pytest.mark.parametrize("impl", ["gather", "sheared"])
@pytest.mark.parametrize("angle", ANGLES)
def test_ell_linear_matches_jax_vjp(angle, impl):
    args = _args((36, 44), angle)
    jop, top = _ops(args)
    x, g = _inputs(args, 40)
    jy, jg = _jax_vjp(jop, x, g)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = at.apply_operator(top, xt, impl=impl, differentiable=True)
    (gx,) = torch.autograd.grad(y, xt, torch.from_numpy(g))
    assert y.dtype == gx.dtype == torch.float32
    np.testing.assert_allclose(y.detach().numpy(), jy, atol=1e-5, rtol=0)
    np.testing.assert_allclose(gx.numpy(), jg, atol=1e-5, rtol=0)


@pytest.mark.parametrize("angle", ANGLES)
def test_kernel_route_code_path_matches_jax_vjp(angle):
    # the 'kernel' route's EllFn on a CPU tensor: its wrappers take their
    # plain versions, so the route's forward/backward wiring runs here
    args = _args((36, 44), angle)
    jop, top = _ops(args)
    x, g = _inputs(args, 41)
    jy, jg = _jax_vjp(jop, x, g)
    fop, post = (t_weights.fold_quadrant_ell_cached(top)
                 if top.spec.quadrant else (top, None))
    fn = t_autodiff.ell_linear_for(
        fop, "kernel", cuda_shear.kernel_plan(fop), torch.float32, post,
        t_weights.ell_fold_post_inv(top.spec.quadrant), top.spec.quadrant)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = fn(xt)
    (gx,) = torch.autograd.grad(y, xt, torch.from_numpy(g))
    np.testing.assert_allclose(y.detach().numpy(), jy, atol=1e-5, rtol=0)
    np.testing.assert_allclose(gx.numpy(), jg, atol=1e-5, rtol=0)


@pytest.mark.parametrize("impl", ["gather", "sheared", "auto"])
@pytest.mark.parametrize("angle", [30.0, 210.0])
def test_differentiable_forward_equals_the_plain_forward(angle, impl):
    args = _args((40, 32), angle)
    top = at.build_operator(at.make_grid_spec(*args))
    x = torch.rand(3, 40, 32, generator=torch.Generator().manual_seed(2))
    ref = at.apply_operator(top, x, impl=impl)
    got = at.apply_operator(top, x, impl=impl, differentiable=True)
    assert torch.equal(got, ref)
    # an input that requires grad takes EllLinear without the flag too
    xg = x.clone().requires_grad_(True)
    y = at.apply_operator(top, xg, impl=impl)
    assert torch.equal(y.detach(), ref)
    assert type(y.grad_fn).__name__ == "EllLinearBackward"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float64])
def test_cotangent_comes_back_in_the_input_dtype(dtype):
    args = _args((32, 36), 120.0)
    top = at.build_operator(at.make_grid_spec(*args))
    x32, g = _inputs(args, 42, frames=1)
    x = torch.from_numpy(x32).to(dtype).requires_grad_(True)
    y = at.apply_operator(top, x, impl="gather", differentiable=True)
    (gx,) = torch.autograd.grad(y, x, torch.from_numpy(g))
    assert gx.dtype == dtype
    # the f32 scatter, folded into the original image's cells, against the
    # public adjoint's, rotated back: the same terms in another order
    ref = at.apply_operator_transpose(top, torch.from_numpy(g))
    torch.testing.assert_close(gx.double(), ref.to(dtype).double(),
                               atol=1e-6 if dtype == torch.float64 else 1e-2,
                               rtol=0)


def test_uint8_is_float_only():
    args = _args((32, 36), 30.0)
    top = at.build_operator(at.make_grid_spec(*args))
    u8 = torch.randint(0, 256, (1, 32, 36), dtype=torch.uint8,
                       generator=torch.Generator().manual_seed(3))
    with pytest.raises(TypeError, match="float-only"):
        at.apply_operator(top, u8, differentiable=True)
    assert at.apply_operator(top, u8).dtype == torch.float32


def test_ell_linear_cache_and_folded_tables():
    args = _args((36, 44), 120.0)
    top = at.build_operator(at.make_grid_spec(*args))
    fop, post = t_weights.fold_quadrant_ell_cached(top)
    inv = t_weights.ell_fold_post_inv(1)
    a = t_autodiff.ell_linear_for(fop, "gather", None, torch.float32, post,
                                  inv, 1)
    assert t_autodiff.ell_linear_for(fop, "gather", None, torch.float32,
                                     post, inv, 1) is a
    assert t_autodiff.ell_linear_for(fop, "gather", None, torch.float64,
                                     post, inv, 1) is not a
    with pytest.raises(ValueError, match="quadrant-0"):
        t_autodiff.ell_linear_for(top, "gather", None, torch.float32)
    with pytest.raises(ValueError, match="route"):
        t_autodiff.ell_linear_for(fop, "xla", None, torch.float32)


@pytest.mark.parametrize("angle", ANGLES)
def test_apply_ell_transpose_matches_jax(angle):
    args = _args((30, 34), angle)
    jop, top = _ops(args)
    spec = top.spec
    g = np.random.default_rng(43).uniform(-1, 1, (2,) + spec.dst_shape
                                          ).astype(np.float32)
    ref = np.asarray(j_apply.apply_ell_transpose(
        jnp.asarray(g), jnp.asarray(jop.base),
        jnp.asarray(jop.weights, jnp.float32), spec.qrot_shape))
    got = t_apply.apply_ell_transpose(
        torch.from_numpy(g), torch.from_numpy(top.base),
        torch.from_numpy(top.weights).float(), spec.qrot_shape)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)
    # the public adjoint rotates back by the quadrant
    np.testing.assert_allclose(
        at.apply_operator_transpose(top, torch.from_numpy(g)).numpy(),
        np.asarray(aa.apply_operator_transpose(jop, jnp.asarray(g))),
        atol=1e-6, rtol=0)


@pytest.mark.parametrize("mode", ["exact", "compat"])
@pytest.mark.parametrize("angle", ANGLES)
def test_adjoint_identity_float64(angle, mode):
    args = _args((28, 30), angle)
    op = at.build_operator(at.make_grid_spec(*args), mode=mode)
    rng = np.random.default_rng(44)
    u = torch.from_numpy(rng.uniform(-1, 1, args[0]))
    v = torch.from_numpy(rng.uniform(-1, 1, op.spec.dst_shape))
    au = at.apply_operator(op, u, weight_dtype=torch.float64)
    atv = at.apply_operator_transpose(op, v, weight_dtype=torch.float64)
    lhs, rhs = float((au * v).sum()), float((u * atv).sum())
    assert abs(lhs - rhs) <= 1e-12 * max(abs(lhs), 1.0)
