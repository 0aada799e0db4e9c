"""Public API of the PyTorch port against the JAX package on the CPU.

``area_average_interpolate`` at every quadrant, the CPU routes and their
dtypes, ``SeparableLinear``'s gradient against ``jax.vjp``, the routes
that raise, and ``chip_smoke.py`` refusing to run without a GPU.
"""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aainterp as aa
from aainterp.autodiff import separable_linear_for as j_separable_linear_for

import aainterp_torch as at
from aainterp_torch import autodiff as t_autodiff

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ANGLES = [0.0, 90.0, 180.0, 270.0]


def _both(x, *args, **kw):
    j = aa.area_average_interpolate(jnp.asarray(x), *args, **kw)
    t = at.area_average_interpolate(torch.from_numpy(x), *args, **kw)
    assert j.dst_isocenter == t.dst_isocenter
    assert tuple(t.dst.shape) == tuple(j.dst.shape)
    return np.asarray(j.dst), t.dst


@pytest.mark.parametrize("angle", ANGLES)
@pytest.mark.parametrize("H,W,sr,dr,iso,mode", [
    (48, 64, 2.0, 1.0, (0.0, 0.0), "exact"),     # flagship stencil, banded
    (48, 64, 2.0, 1.0, (0.5, 0.5), "exact"),     # uniform box route
    (40, 56, 150.0, 60.0, (3.0, 2.0), "fast"),
])
def test_interpolate_matches_jax(H, W, sr, dr, iso, mode, angle):
    rng = np.random.default_rng(10)
    x = rng.uniform(0, 1, (2, H, W)).astype(np.float32)
    ref, got = _both(x, sr, dr, iso, angle, mode=mode)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)


def test_interpolate_compat_is_exact_when_axis_aligned():
    rng = np.random.default_rng(11)
    x = rng.uniform(0, 1, (30, 44)).astype(np.float32)
    ref, got = _both(x, 150.0, 60.0, (0.0, 0.0), 90.0, mode="compat")
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)
    exact = at.area_average_interpolate(torch.from_numpy(x), 150.0, 60.0,
                                        (0.0, 0.0), 90.0).dst
    assert torch.equal(got, exact)


@pytest.mark.parametrize("dtype", ["uint8", "bfloat16"])
def test_cpu_routes_give_float32_like_xla(dtype):
    # plain CPU routes keep JAX's XLA contract: bf16 / u8 in -> f32 out
    rng = np.random.default_rng(12)
    x = rng.uniform(0, 255, (2, 40, 64)).astype(np.float32)
    if dtype == "uint8":
        xj, xt = jnp.asarray(x.astype(np.uint8)), torch.from_numpy(
            x.astype(np.uint8))
    else:
        xj = jnp.asarray(x, jnp.bfloat16)
        xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
            torch.bfloat16)
    ref = aa.area_average_interpolate(xj, 2.0, 1.0, (0.0, 0.0), 90.0).dst
    got = at.area_average_interpolate(xt, 2.0, 1.0, (0.0, 0.0), 90.0).dst
    assert got.dtype == torch.float32 and ref.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


@pytest.mark.parametrize("shape", [(36, 52), (2, 3, 36, 52)])
def test_batch_ranks(shape):
    rng = np.random.default_rng(13)
    x = rng.uniform(0, 1, shape).astype(np.float32)
    ref, got = _both(x, 2.0, 1.0, (0.0, 0.0), 270.0)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)


@pytest.mark.parametrize("kind", ["kernel", "banded"])
@pytest.mark.parametrize("angle", ANGLES)
def test_separable_linear_grad_matches_jax_vjp(angle, kind):
    rng = np.random.default_rng(14)
    H, W = 40, 56
    spec_j = aa.make_grid_spec((H, W), 150.0, 60.0, (0.0, 0.0), angle)
    op_j = aa.build_operator(spec_j)
    op_t = at.build_operator(at.make_grid_spec((H, W), 150.0, 60.0,
                                               (0.0, 0.0), angle))
    x = rng.uniform(0, 1, (2, H, W)).astype(np.float32)
    out_j, vjp = jax.vjp(j_separable_linear_for(op_j, jnp.float32, "xla"),
                         jnp.asarray(x))
    g = rng.uniform(-1, 1, out_j.shape).astype(np.float32)
    (grad_j,) = vjp(jnp.asarray(g))

    xt = torch.from_numpy(x).requires_grad_(True)
    lin = at.separable_linear_for(op_t, torch.float32, kind)
    out_t = lin(xt)
    (grad_t,) = torch.autograd.grad(out_t, xt, torch.from_numpy(g))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               atol=1e-5)
    assert grad_t.dtype == torch.float32
    np.testing.assert_allclose(grad_t.numpy(), np.asarray(grad_j), atol=1e-5)


def test_differentiable_flag_matches_native_autograd():
    rng = np.random.default_rng(15)
    op = at.build_operator(at.make_grid_spec((32, 48), 2.0, 1.0, (0.0, 0.0),
                                             90.0))
    x = torch.from_numpy(rng.uniform(0, 1, (2, 32, 48)).astype(np.float32))
    grads = []
    for differentiable in (False, True):
        xt = x.clone().requires_grad_(True)
        out = at.apply_operator(op, xt, differentiable=differentiable)
        grads.append(torch.autograd.grad(out.square().sum(), xt)[0])
    torch.testing.assert_close(grads[0], grads[1], atol=1e-6, rtol=0)


def test_backward_returns_input_dtype():
    op = at.build_operator(at.make_grid_spec((32, 48), 2.0, 1.0, (0.0, 0.0),
                                             0.0))
    x = torch.rand(1, 32, 48, dtype=torch.float64, requires_grad=True)
    out = at.separable_linear_for(op, torch.float32, "banded")(x)
    (g,) = torch.autograd.grad(out.sum(), x)
    assert g.dtype == torch.float64


def test_box_impl_matches_banded_and_rejects_non_box():
    box_op = at.build_operator(at.make_grid_spec((48, 64), 2.0, 1.0,
                                                 (0.5, 0.5), 90.0))
    x = torch.rand(2, 48, 64, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(at.apply_operator(box_op, x, impl="box"),
                               at.apply_operator(box_op, x, impl="banded"),
                               atol=1e-6, rtol=0)
    stencil_op = at.build_operator(at.make_grid_spec((48, 64), 2.0, 1.0,
                                                     (0.0, 0.0), 0.0))
    with pytest.raises(ValueError, match="box"):
        at.apply_operator(stencil_op, x, impl="box")


def test_unported_and_invalid_routes_raise():
    x = torch.rand(1, 32, 48)
    op = at.build_operator(at.make_grid_spec((32, 48), 2.0, 1.0, (0.0, 0.0),
                                             0.0))
    with pytest.raises(ValueError, match="CUDA"):
        at.apply_operator(op, x, impl="kernel")
    with pytest.raises(ValueError, match="impl"):
        at.apply_operator(op, x, impl="pallas")
    with pytest.raises(ValueError, match="weight_dtype"):
        at.apply_operator(op, x, weight_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="kind"):
        t_autodiff.separable_linear_for(op, torch.float32, "xla")
    # rotated mode='compat', fused=True and method='ell' with compat are
    # ported (the rest of slice 3): each runs, and what is left raises
    rot_spec = at.make_grid_spec((32, 48), 2.0, 1.0, (0.0, 0.0), 30.0)
    cop = at.build_operator(rot_spec, mode="compat")
    assert isinstance(cop, at.EllOperator) and cop.mode == "compat"
    torch.testing.assert_close(
        at.area_average_interpolate(x, 2.0, 1.0, (0.0, 0.0), 30.0,
                                    mode="compat").dst,
        at.apply_operator(cop, x), atol=0, rtol=0)
    fused = at.area_average_interpolate(x, 2.0, 1.0, (0.0, 0.0), 0.0,
                                        fused=True).dst
    assert fused.dtype == torch.float32
    torch.testing.assert_close(fused, at.apply_operator(op, x), atol=2e-4,
                               rtol=0)
    ell = at.area_average_interpolate(x, 2.0, 1.0, (0.0, 0.0), 0.0,
                                      method="ell", mode="compat").dst
    torch.testing.assert_close(ell, at.apply_operator(op, x), atol=1e-6,
                               rtol=0)
    with pytest.raises(ValueError, match="fused"):
        at.area_average_interpolate(x, 2.0, 1.0, (0.0, 0.0), 30.0,
                                    mode="compat", fused=True)
    with pytest.raises(ValueError, match="mode"):
        at.area_average_interpolate(x, 2.0, 1.0, (0.0, 0.0), 0.0,
                                    mode="bogus")
    # mode='shear' is ported (slice 4): axis-aligned it is mode='exact'
    torch.testing.assert_close(
        at.area_average_interpolate(x, 2.0, 1.0, (0.0, 0.0), 0.0,
                                    mode="shear").dst,
        at.area_average_interpolate(x, 2.0, 1.0, (0.0, 0.0), 0.0).dst,
        atol=0, rtol=0)


def _run_smoke(cwd):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_a_gpu():
    res = _run_smoke(REPO)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "is_available() is False" in res.stderr


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    res = _run_smoke(tmp_path)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "aainterp_torch" in res.stderr      # the package is not there
