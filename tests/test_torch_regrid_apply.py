"""The 2-D banded-tile apply and the aligned / one-axis applies of the
PyTorch port against the JAX package on the CPU.

* ``cuda_apply_2d.apply_separable_2d_plain`` (the plain version of the
  CUDA kernel ``csrc/separable_apply_2d.cu``) against
  ``apply_separable_pallas_2d(..., interpret=True)``: f32 atol 1e-5 on
  [0, 1] inputs (tests/test_pallas.py:139-153); the config-5-style regrid
  bands rtol 1e-6, atol 1e-3 on [250, 300] fields (:156-169); uint8
  within one gray level; 'bf16x3' rtol 1e-5 (both split the operands the
  same way); 'default' within 1e-2 relative (the port rounds the operands
  to bf16, JAX's interpret mode is exact at any precision);
* the wrapper ``apply_separable_kernel_2d`` on a CPU tensor takes the
  plain version and launches nothing;
* ``apply_separable_aligned``, ``apply_aligned_axis`` and
  ``apply_band_axis`` against JAX's (f32, atol 1e-6).
The CUDA kernel itself runs in tests/test_torch_kernel_cuda.py on a GPU.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import aainterp as aa
from aainterp import api as j_api
from aainterp import regrid as j_regrid
from aainterp.ops import apply as j_apply
from aainterp.ops.pallas_apply import apply_separable_pallas_2d
from aainterp.ops.weights import separable_operator

from aainterp_torch import api as t_api
from aainterp_torch.ops import apply as t_apply
from aainterp_torch.ops import cuda_apply_2d


def _spec_tables(H, W, sr, dr):
    op = separable_operator(aa.make_grid_spec((H, W), sr, dr, (0.0, 0.0), 0.0))
    return (op.wy.start, np.asarray(op.wy.weights, np.float32),
            op.wx.start, np.asarray(op.wx.weights, np.float32))


def _regrid_tables(src=(360, 720), dst=(36, 72)):
    by, bx = j_regrid.conservative_regrid_operator(j_regrid.LatLonGrid(*src),
                                                   j_regrid.LatLonGrid(*dst))
    return (by.start, np.asarray(by.weights, np.float32),
            bx.start, np.asarray(bx.weights, np.float32))


def _pallas(x, tabs, **kw):
    out = apply_separable_pallas_2d(jnp.asarray(x),
                                    *(jnp.asarray(t) for t in tabs),
                                    interpret=True, **kw)
    assert out is not None, "the JAX 2-D kernel rejected the geometry"
    return np.asarray(out)


def _plain(x, tabs, **kw):
    return cuda_apply_2d.apply_separable_2d_plain(torch.from_numpy(x), *tabs,
                                                  **kw)


# tests/test_pallas.py:139-145
GEOMS = [
    (360, 600, 10.0, 1.0),    # 10x downscale, odd width (regrid shape)
    (256, 500, 2.0, 1.0),     # odd width, narrow band
    (200, 384, 150.0, 60.0),  # non-integer ratio
    (128, 256, 1.0, 2.0),     # 2x upscale
    (96, 250, 1.0, 3.5),      # non-integer upscale, odd width
]


@pytest.mark.parametrize("H,W,sr,dr", GEOMS)
def test_plain_2d_matches_pallas_2d_f32(H, W, sr, dr):
    rng = np.random.default_rng(0)
    tabs = _spec_tables(H, W, sr, dr)
    x = rng.uniform(0, 1, (2, H, W)).astype(np.float32)
    got = _plain(x, tabs)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _pallas(x, tabs), atol=1e-5)


def test_plain_2d_matches_pallas_2d_on_regrid_bands():
    rng = np.random.default_rng(1)
    tabs = _regrid_tables()
    x = rng.uniform(250, 300, (2, 360, 720)).astype(np.float32)
    np.testing.assert_allclose(_plain(x, tabs).numpy(), _pallas(x, tabs),
                               rtol=1e-6, atol=1e-3)


@pytest.mark.parametrize("tabs_of", ["resize", "regrid"])
def test_plain_2d_uint8_within_one_level(tabs_of):
    rng = np.random.default_rng(2)
    if tabs_of == "resize":
        tabs, shape = _spec_tables(200, 500, 2.0, 1.0), (2, 200, 500)
    else:
        tabs, shape = _regrid_tables(), (2, 360, 720)
    x = rng.integers(0, 256, shape, dtype=np.uint8)
    got = _plain(x, tabs)
    ref = _pallas(x, tabs)
    assert got.dtype == torch.uint8 and ref.dtype == np.uint8
    assert np.abs(got.numpy().astype(np.int32)
                  - ref.astype(np.int32)).max() <= 1


@pytest.mark.parametrize("precision", ["auto", "high", "highest"])
def test_plain_2d_f32_precisions_are_exact(precision):
    rng = np.random.default_rng(3)
    tabs = _spec_tables(200, 500, 2.0, 1.0)
    x = rng.uniform(0, 1, (2, 200, 500)).astype(np.float32)
    got = _plain(x, tabs, precision=precision)
    np.testing.assert_allclose(got.numpy(), _pallas(x, tabs,
                                                    precision=precision),
                               rtol=1e-6, atol=1e-6)
    assert torch.equal(got, _plain(x, tabs))


@pytest.mark.parametrize("tabs_of", ["resize", "regrid"])
def test_plain_2d_bf16x3_matches_pallas(tabs_of):
    rng = np.random.default_rng(4)
    if tabs_of == "resize":
        tabs, shape, lo = _spec_tables(200, 500, 2.0, 1.0), (2, 200, 500), 0
    else:
        tabs, shape, lo = _regrid_tables(), (2, 360, 720), 250
    x = rng.uniform(lo, lo + 1 if lo == 0 else 300, shape).astype(np.float32)
    got = _plain(x, tabs, precision="bf16x3")
    np.testing.assert_allclose(got.numpy(), _pallas(x, tabs,
                                                    precision="bf16x3"),
                               rtol=1e-5, atol=1e-6)


def test_plain_2d_default_rounds_operands_to_bf16():
    rng = np.random.default_rng(5)
    tabs = _regrid_tables()
    x = rng.uniform(250, 300, (2, 360, 720)).astype(np.float32)
    got = _plain(x, tabs, precision="default").numpy()
    ref = _pallas(x, tabs, precision="default")   # exact in interpret mode
    np.testing.assert_allclose(got, ref, rtol=1e-2)
    assert not np.array_equal(got, ref)     # the operands really were rounded
    # bf16 input: its pixels are bf16 already, so 'bf16x3' is 'default'
    xb = torch.from_numpy(x).to(torch.bfloat16)
    a = cuda_apply_2d.apply_separable_2d_plain(xb, *tabs, precision="bf16x3")
    b = cuda_apply_2d.apply_separable_2d_plain(xb, *tabs, precision="default")
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)


def test_plain_2d_rejects_bad_precision():
    tabs = _spec_tables(64, 96, 2.0, 1.0)
    x = torch.zeros(1, 64, 96)
    with pytest.raises(ValueError,
                       match="precision must be auto/default/high/highest/"
                             "bf16x3"):
        cuda_apply_2d.apply_separable_2d_plain(x, *tabs, precision="bogus")
    with pytest.raises(ValueError, match="precision must be"):
        cuda_apply_2d.apply_separable_kernel_2d(x, *tabs, precision="fast")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.uint8, torch.float64])
def test_wrapper_on_cpu_takes_the_plain_version(dtype):
    rng = np.random.default_rng(6)
    tabs = _spec_tables(96, 250, 1.0, 3.5)
    x = torch.from_numpy(rng.uniform(0, 200, (3, 96, 250))).to(dtype)
    before = cuda_apply_2d.LAUNCHES
    got = cuda_apply_2d.apply_separable_kernel_2d(x, *tabs)
    assert cuda_apply_2d.LAUNCHES == before
    want = cuda_apply_2d.apply_separable_2d_plain(x, *tabs)
    assert got.dtype == (torch.float32 if dtype == torch.float64 else dtype)
    assert torch.equal(got, want)
    # (H, W) in -> (Hd, Wd) out; out= receives the result
    buf = torch.full(got.shape, float("nan")).to(got.dtype)
    assert cuda_apply_2d.apply_separable_kernel_2d(x, *tabs, out=buf) is buf
    assert torch.equal(buf, want)
    assert torch.equal(cuda_apply_2d.apply_separable_kernel_2d(x[1], *tabs),
                       want[1])


def test_wrapper_rejects_bad_input():
    tabs = _spec_tables(64, 96, 2.0, 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_apply_2d.apply_separable_kernel_2d(
            torch.zeros(2, 96, 64).transpose(1, 2), *tabs)
    with pytest.raises(ValueError, match="out must be"):
        cuda_apply_2d.apply_separable_kernel_2d(
            torch.zeros(2, 64, 96), *tabs, out=torch.zeros(2, 3, 3))
    with pytest.raises(TypeError):
        cuda_apply_2d.apply_separable_kernel_2d(np.zeros((2, 64, 96)), *tabs)


# ----------------------------------------------------------------------
# the aligned integer-ratio applies and the one-axis band contraction
# ----------------------------------------------------------------------


@pytest.mark.parametrize("src,dst,lead", [((360, 720), (36, 72), (2,)),
                                          ((180, 360), (90, 120), (2, 2)),
                                          ((90, 180), (30, 60), ())])
def test_aligned_separable_matches_jax(src, dst, lead):
    rng = np.random.default_rng(7)
    ys, yw, xs, xw = _regrid_tables(src, dst)
    yp = j_apply.aligned_axis_plan(ys, yw, src[0])
    xp = j_apply.aligned_axis_plan(xs, xw, src[1])
    assert yp is not None and xp is not None
    x = rng.uniform(250, 300, lead + src).astype(np.float32)
    ref = np.asarray(j_apply.apply_separable_aligned(jnp.asarray(x), yp, xp))
    got = t_apply.apply_separable_aligned(
        torch.from_numpy(x), t_apply.aligned_axis_plan(ys, yw, src[0]),
        t_apply.aligned_axis_plan(xs, xw, src[1]))
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("axis", [0, 1, -1])
@pytest.mark.parametrize("n_src,n_dst", [(12, 4), (12, 5), (7, 13)])
def test_axis_applies_match_jax(axis, n_src, n_dst):
    rng = np.random.default_rng(8)
    shape = [5, 6, 7]
    shape[axis] = n_src
    x = rng.uniform(0, 1, shape).astype(np.float32)
    b = j_api._unit_resize_band(n_src, n_dst)
    w32 = np.asarray(b.weights, np.float32)
    ref = np.asarray(j_apply.apply_band_axis(
        jnp.asarray(x), jnp.asarray(b.start), jnp.asarray(w32), axis))
    got = t_apply.apply_band_axis(torch.from_numpy(x),
                                  torch.from_numpy(b.start),
                                  torch.from_numpy(w32), axis)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)
    plan = t_apply.aligned_axis_plan(b.start, b.weights, n_src)
    jplan = j_apply.aligned_axis_plan(b.start, b.weights, n_src)
    assert (plan is None) == (jplan is None) == (n_src % n_dst != 0)
    if plan is not None:
        ref = np.asarray(j_apply.apply_aligned_axis(jnp.asarray(x), jplan,
                                                    axis))
        got = t_apply.apply_aligned_axis(torch.from_numpy(x), plan, axis)
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)
    # the resize band of t_api is the JAX package's (bit for bit)
    tb = t_api._unit_resize_band(n_src, n_dst)
    assert np.array_equal(tb.weights, b.weights)
