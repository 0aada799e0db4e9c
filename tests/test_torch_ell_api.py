"""Rotated public API of the PyTorch port against the JAX package on the CPU.

``area_average_interpolate`` and ``apply_operator`` with an EllOperator,
modes exact and fast, all four quadrants, dtypes f32 / bf16 / u8 (plain
routes give f32, as JAX's XLA routes do), batch ranks, and the routing
and error cases.  The JAX side is given an operator from its numpy
weight-gen (``operator=``); the port builds its own (native engine, or
numpy where no g++ is found), so outputs agree to summation order: f32
atol 1e-6 on [0, 1] inputs, u8 inputs atol 1e-6 * 255.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import aainterp as aa
from aainterp.ops import weights as j_weights

import aainterp_torch as at
from aainterp_torch import api as t_api
from aainterp_torch.ops import cuda_shear

ANGLES = [30.0, 120.0, 210.0, 300.5, 1.5]


def _jax_op(args, mode):
    return j_weights.ell_operator(aa.make_grid_spec(*args), mode=mode,
                                  prefer_native=False)


def _args(shape, angle, ratio=(1.0, 0.5)):
    H, W = shape
    return ((H, W), ratio[0], ratio[1], (W / 2.0 + 0.3, H / 2.0 - 0.2), angle)


@pytest.mark.parametrize("mode", ["exact", "fast"])
@pytest.mark.parametrize("angle", ANGLES)
def test_rotated_interpolate_matches_jax(angle, mode):
    args = _args((36, 44), angle)
    x = np.random.default_rng(20).uniform(0, 1, (2, 36, 44)).astype(
        np.float32)
    j = aa.area_average_interpolate(jnp.asarray(x), *args[1:], mode=mode,
                                    operator=_jax_op(args, mode))
    t = at.area_average_interpolate(torch.from_numpy(x), *args[1:],
                                    mode=mode)
    assert t.dst_isocenter == j.dst_isocenter
    assert t.spec == at.make_grid_spec(*args)
    assert t.dst.dtype == torch.float32
    assert tuple(t.dst.shape) == tuple(j.dst.shape)
    np.testing.assert_allclose(t.dst.numpy(), np.asarray(j.dst), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "uint8"])
@pytest.mark.parametrize("angle", [30.0, 210.0])
def test_rotated_dtypes_match_jax(angle, dtype):
    args = _args((40, 32), angle)
    x = np.random.default_rng(21).uniform(0, 255, (2, 40, 32)).astype(
        np.float32)
    if dtype == "uint8":
        xj = jnp.asarray(x.astype(np.uint8))
        xt = torch.from_numpy(x.astype(np.uint8))
    else:
        xj = jnp.asarray(x, getattr(jnp, dtype))
        xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
            getattr(torch, dtype))
    j = aa.area_average_interpolate(xj, *args[1:],
                                    operator=_jax_op(args, "exact")).dst
    t = at.area_average_interpolate(xt, *args[1:]).dst
    assert j.dtype == jnp.float32 and t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=255e-6, rtol=0)


@pytest.mark.parametrize("impl,jimpl", [("gather", "xla"),
                                        ("sheared", "sheared"),
                                        ("auto", "xla")])
@pytest.mark.parametrize("angle", [30.0, 120.0, 300.5])
def test_apply_operator_routes_match_jax(angle, impl, jimpl):
    args = _args((48, 40), angle)
    jop = _jax_op(args, "exact")
    top = at.build_operator(at.make_grid_spec(*args))
    assert isinstance(top, at.EllOperator)
    x = np.random.default_rng(22).uniform(0, 1, (3, 48, 40)).astype(
        np.float32)
    ref = np.asarray(aa.apply_operator(jop, jnp.asarray(x), impl=jimpl))
    got = at.apply_operator(top, torch.from_numpy(x), impl=impl)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("shape", [(36, 52), (2, 3, 36, 52)])
@pytest.mark.parametrize("impl", ["gather", "sheared"])
def test_rotated_batch_ranks(shape, impl):
    args = _args((36, 52), 120.0)
    x = np.random.default_rng(23).uniform(0, 1, shape).astype(np.float32)
    ref = np.asarray(aa.apply_operator(_jax_op(args, "exact"),
                                       jnp.asarray(x), impl="xla"))
    got = at.apply_operator(at.build_operator(at.make_grid_spec(*args)),
                            torch.from_numpy(x), impl=impl)
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)


def test_float64_weights_on_the_gather_route():
    args = _args((30, 34), 30.0)
    op = at.build_operator(at.make_grid_spec(*args))
    x = np.random.default_rng(24).uniform(0, 1, (30, 34))
    got = at.apply_operator(op, torch.from_numpy(x), impl="gather",
                            weight_dtype=torch.float64)
    assert got.dtype == torch.float64
    ref = (op.dense() @ x.reshape(-1)).reshape(op.spec.dst_shape)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-12, rtol=0)


def test_method_ell_and_prebuilt_operator():
    # method='ell' on an axis-aligned geometry builds an ELL operator, as
    # JAX does; a prebuilt operator is used as it is
    spec = at.make_grid_spec((24, 32), 2.0, 1.0, (0.0, 0.0), 0.0)
    op = at.build_operator(spec, method="ell")
    assert isinstance(op, at.EllOperator)
    x = torch.rand(2, 24, 32, generator=torch.Generator().manual_seed(0))
    sep = at.area_average_interpolate(x, 2.0, 1.0, (0.0, 0.0), 0.0).dst
    ell = at.area_average_interpolate(x, 2.0, 1.0, (0.0, 0.0), 0.0,
                                      method="ell").dst
    torch.testing.assert_close(ell, sep, atol=1e-6, rtol=0)
    args = _args((36, 44), 30.0)
    rop = at.build_operator(at.make_grid_spec(*args))
    xr = torch.rand(36, 44, generator=torch.Generator().manual_seed(1))
    a = at.area_average_interpolate(xr, *args[1:], operator=rop).dst
    b = at.area_average_interpolate(xr, *args[1:]).dst
    assert torch.equal(a, b)


def test_rotated_errors_and_unported_options():
    args = _args((36, 44), 30.0)
    op = at.build_operator(at.make_grid_spec(*args))
    x = torch.rand(1, 36, 44)
    with pytest.raises(ValueError, match="unknown impl"):
        at.apply_operator(op, x, impl="xla")
    with pytest.raises(ValueError, match="CUDA"):
        at.apply_operator(op, x, impl="kernel")
    with pytest.raises(ValueError, match="must end in"):
        at.apply_operator(op, torch.rand(1, 44, 36))
    with pytest.raises(ValueError, match="weight_dtype"):
        at.apply_operator(op, x, weight_dtype=torch.bfloat16)
    # compat, fused=True and differentiable=True are ported (the rest of
    # slice 3); what is left of them raises
    res = at.area_average_interpolate(x, *args[1:], mode="compat")
    assert res.dst.shape == (1,) + res.spec.dst_shape
    assert at.build_operator(at.make_grid_spec(*args),
                             mode="compat").mode == "compat"
    assert at.area_average_interpolate(
        x, *args[1:], fused=True).dst.dtype == torch.float32
    xg = x.clone().requires_grad_(True)
    at.area_average_interpolate(xg, *args[1:],
                                differentiable=True).dst.sum().backward()
    assert xg.grad.shape == x.shape
    with pytest.raises(ValueError, match="fused"):
        at.area_average_interpolate(x, *args[1:], mode="compat", fused=True)
    with pytest.raises(TypeError, match="float-only"):
        at.area_average_interpolate((x * 255).to(torch.uint8), *args[1:],
                                    differentiable=True)
    # mode='shear' is ported (slice 4) and builds no operator
    res = at.area_average_interpolate(x, *args[1:], mode="shear")
    assert res.dst.shape == (1,) + res.spec.dst_shape
    with pytest.raises(ValueError, match="builds no Operator"):
        at.area_average_interpolate(x, *args[1:], mode="shear", operator=op)


def _wide_window_op():
    # a 20x downscale at 30 degrees: the sheared window is 26x20 cells,
    # above build_shear_plan's max_window of 24
    spec = at.make_grid_spec((64, 64), 20.0, 1.0, (32.0, 32.0), 30.0)
    return at.build_operator(spec)


def test_wide_window_routes_auto_to_gather_with_a_warning():
    op = _wide_window_op()
    with pytest.raises(ValueError, match="too large"):
        cuda_shear.kernel_plan(op)
    before = t_api.SHEAR_PLAN_FALLBACKS
    # the route a CUDA tensor would take, decided before any launch
    with pytest.warns(RuntimeWarning, match="gather"):
        route, plan = t_api._ell_route(op, "auto", on_cuda=True)
    assert (route, plan) == ("gather", None)
    assert t_api.SHEAR_PLAN_FALLBACKS == before + 1
    with pytest.raises(ValueError, match="too large"):
        t_api._ell_route(op, "kernel", on_cuda=True)
    x = torch.rand(2, 64, 64, generator=torch.Generator().manual_seed(2))
    with pytest.raises(ValueError, match="too large"):
        at.apply_operator(op, x, impl="sheared")
    # the CPU auto route never needs a plan: gather, no warning
    assert t_api._ell_route(op, "auto", on_cuda=False) == ("gather", None)
    out = at.apply_operator(op, x)
    ref = (op.dense() @ x.double().reshape(2, -1).numpy().T).T
    np.testing.assert_allclose(out.reshape(2, -1).numpy(), ref, atol=1e-6)


def test_kernel_route_choice_on_a_good_geometry():
    op = at.build_operator(at.make_grid_spec(*_args((36, 44), 30.0)))
    route, plan = t_api._ell_route(op, "auto", on_cuda=True)
    assert route == "kernel" and plan is cuda_shear.kernel_plan(op)
    assert t_api._ell_route(op, "sheared", on_cuda=False)[0] == "sheared"
