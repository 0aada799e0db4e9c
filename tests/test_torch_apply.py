"""Apply stage of the PyTorch port against the JAX package on the CPU.

* plain ``apply_separable_banded`` / ``apply_box_mean`` / ``quadrant_rotate``
  against their JAX counterparts (f32, atol 1e-6);
* ``cuda_apply.apply_separable_kernel`` on a CPU tensor (its plain version)
  against ``apply_separable_pallas(..., interpret=True)``: f32 atol 1e-5,
  bf16 out atol 1e-2 (one bf16 ulp on [0, 1]), uint8 within one gray level;
* the kernel's host tile plan, run through a numpy emulation of the
  kernel's y-pass/x-pass tiling, against the plain version (the CUDA
  kernel itself runs in tests/test_torch_kernel_cuda.py on a GPU).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import aainterp as aa
from aainterp.ops import apply as j_apply
from aainterp.ops.pallas_apply import apply_separable_pallas

import aainterp_torch as at
from aainterp_torch.ops import apply as t_apply
from aainterp_torch.ops import cuda_apply
from aainterp_torch.ops import weights as t_weights

GEOMS = [
    (256, 512, 2.0, 1.0),
    (512, 768, 150.0, 60.0),
    (384, 640, 4.0, 1.0),
    (128, 256, 1.0, 2.0),
]


def _tables(H, W, sr, dr, angle=0.0, iso=(0.0, 0.0)):
    op = t_weights.separable_operator(at.make_grid_spec((H, W), sr, dr, iso,
                                                        angle))
    yb, xb, _ = t_weights.fold_quadrant_separable(op)
    return (yb.start, yb.weights.astype(np.float32),
            xb.start, xb.weights.astype(np.float32))


def _jax(tabs):
    return tuple(jnp.asarray(t) for t in tabs)


def _torch(tabs):
    return tuple(torch.as_tensor(np.asarray(t)) for t in tabs)


@pytest.mark.parametrize("lead", [(2,), (2, 3)])
@pytest.mark.parametrize("H,W,sr,dr", GEOMS)
def test_banded_matches_jax_f32(H, W, sr, dr, lead):
    rng = np.random.default_rng(1)
    tabs = _tables(H, W, sr, dr)
    x = rng.uniform(0, 1, lead + (H, W)).astype(np.float32)
    ref = np.asarray(j_apply.apply_separable_banded(jnp.asarray(x),
                                                    *_jax(tabs)))
    got = t_apply.apply_separable_banded(torch.from_numpy(x), *_torch(tabs))
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)


def test_banded_clamps_band_wider_than_image():
    # 24x24 at iso (4, 4): the 2x band reaches past the image edge
    rng = np.random.default_rng(2)
    tabs = _tables(24, 24, 2.0, 1.0, iso=(4.0, 4.0))
    x = rng.uniform(0, 1, (1, 24, 24)).astype(np.float32)
    ref = np.asarray(j_apply.apply_separable_banded(jnp.asarray(x),
                                                    *_jax(tabs)))
    got = t_apply.apply_separable_banded(torch.from_numpy(x), *_torch(tabs))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)


@pytest.mark.parametrize("my,mx,shape", [(2, 2, (2, 64, 96)),
                                         (3, 2, (3, 45, 64)),
                                         (4, 4, (128, 64))])
def test_box_mean_matches_jax(my, mx, shape):
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 1, shape).astype(np.float32)
    ref = np.asarray(j_apply.apply_box_mean(jnp.asarray(x), my, mx))
    got = t_apply.apply_box_mean(torch.from_numpy(x), my, mx)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)


@pytest.mark.parametrize("quadrant", [0, 1, 2, 3])
def test_quadrant_rotate_matches_jax(quadrant):
    x = np.arange(2 * 5 * 7, dtype=np.float32).reshape(2, 5, 7)
    ref = np.asarray(j_apply.quadrant_rotate(jnp.asarray(x), quadrant))
    got = t_apply.quadrant_rotate(torch.from_numpy(x), quadrant)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("H,W,sr,dr,iso", [
    (256, 512, 2.0, 1.0, (0.5, 0.5)),    # box
    (256, 512, 2.0, 1.0, (0.0, 0.0)),    # flagship stencil, not a box
    (90, 120, 3.0, 1.0, (1.0, 1.0)),     # box, m = 3
    (512, 768, 150.0, 60.0, (0.0, 0.0)),
])
def test_uniform_box_params_matches_jax(H, W, sr, dr, iso):
    tabs = _tables(H, W, sr, dr, iso=iso)
    assert (t_apply.uniform_box_params(*tabs, H, W)
            == j_apply.uniform_box_params(*tabs, H, W))


# ----------------------------------------------------------------------
# the kernel wrapper on CPU tensors (plain path) vs Pallas interpret mode
# ----------------------------------------------------------------------


@pytest.mark.parametrize("H,W,sr,dr", [
    (256, 512, 2.0, 1.0),
    (512, 768, 150.0, 60.0),
    (128, 250, 2.0, 1.0),     # odd width: JAX takes its 2-D kernel here
])
def test_kernel_wrapper_matches_pallas_f32(H, W, sr, dr):
    rng = np.random.default_rng(4)
    tabs = _tables(H, W, sr, dr)
    x = rng.uniform(0, 1, (2, H, W)).astype(np.float32)
    ref = np.asarray(apply_separable_pallas(jnp.asarray(x), *_jax(tabs),
                                            interpret=True))
    got = cuda_apply.apply_separable_kernel(torch.from_numpy(x), *tabs)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


def test_kernel_wrapper_matches_pallas_bf16():
    rng = np.random.default_rng(5)
    tabs = _tables(256, 512, 2.0, 1.0)
    x = rng.uniform(0, 1, (1, 256, 512)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    ref = np.asarray(apply_separable_pallas(xj, *_jax(tabs), interpret=True),
                     np.float32)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        torch.bfloat16)
    got = cuda_apply.apply_separable_kernel(xt, *tabs)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, atol=1e-2)


@pytest.mark.parametrize("H,W,out_name", [
    (256, 512, "uint8"),
    (256, 512, "bfloat16"),
    (128, 250, "uint8"),      # odd width: JAX's 2-D kernel / XLA fallback
])
def test_kernel_wrapper_matches_pallas_uint8(H, W, out_name):
    rng = np.random.default_rng(6)
    tabs = _tables(H, W, 150.0, 60.0)
    u8 = rng.integers(0, 256, (2, H, W), dtype=np.uint8)
    ref = np.asarray(apply_separable_pallas(
        jnp.asarray(u8), *_jax(tabs), out_dtype=jnp.dtype(out_name),
        interpret=True)).astype(np.float32)
    got = cuda_apply.apply_separable_kernel(
        torch.from_numpy(u8), *tabs, out_dtype=getattr(torch, out_name))
    assert got.dtype == getattr(torch, out_name)
    diff = np.abs(got.float().numpy() - ref).max()
    assert diff <= 1.0, diff


def test_kernel_wrapper_default_dtypes_and_shapes():
    tabs = _tables(64, 96, 2.0, 1.0)
    u8 = torch.randint(0, 256, (64, 96), dtype=torch.uint8,
                       generator=torch.Generator().manual_seed(0))
    out = cuda_apply.apply_separable_kernel(u8, *tabs)       # 2-D in, 2-D out
    assert out.dtype == torch.uint8 and tuple(out.shape) == (32, 48)
    want = cuda_apply.apply_separable_plain(u8[None].float(), *tabs)[0]
    assert (out.float() - want.round().clamp(0, 255)).abs().max() == 0
    f64 = u8.to(torch.float64)[None]
    assert cuda_apply.apply_separable_kernel(f64, *tabs).dtype == torch.float32
    i16 = u8.to(torch.int16)[None]
    assert cuda_apply.apply_separable_kernel(i16, *tabs).dtype == torch.float32


def test_kernel_wrapper_rejects_bad_input():
    tabs = _tables(64, 96, 2.0, 1.0)
    x = torch.rand(2, 64, 96)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_apply.apply_separable_kernel(x.transpose(1, 2).contiguous()
                                          .transpose(1, 2), *tabs)
    with pytest.raises(ValueError, match="shape"):
        cuda_apply.apply_separable_kernel(x[None], *tabs)
    with pytest.raises(TypeError, match="dtype"):
        cuda_apply.apply_separable_kernel(x.to(torch.complex64), *tabs)
    with pytest.raises(TypeError):
        cuda_apply.apply_separable_kernel(x.numpy(), *tabs)
    with pytest.raises(ValueError, match="band tables"):
        cuda_apply.apply_separable_kernel(x, tabs[0][:-1], *tabs[1:])


# ----------------------------------------------------------------------
# the kernel's tile plan, emulated in numpy
# ----------------------------------------------------------------------


def _emulate_kernel(frames, ys, yw, xs, xw, plan):
    """The kernel's arithmetic per (row tile, column tile), in float64."""
    F, H, W = frames.shape
    Hd, ky = yw.shape
    Wd, kx = xw.shape
    TY, TX, S, c0 = plan["TY"], plan["TX"], plan["S"], plan["col_base"]
    out = np.full((F, Hd, Wd), np.nan)
    for ty in range(plan["nty"]):
        i = np.arange(ty * TY, min((ty + 1) * TY, Hd))
        rows = np.clip(ys[i][:, None] + np.arange(ky), 0, H - 1)
        for tx in range(plan["ntx"]):
            j = np.arange(tx * TX, min((tx + 1) * TX, Wd))
            cols = np.clip(c0[tx] + np.arange(S), 0, W - 1)
            band = frames[:, rows][..., cols]                 # (F, r, ky, S)
            T = np.einsum("rk,frkc->frc", yw[i], band)        # shared memory
            off = xs[j][:, None] - c0[tx] + np.arange(kx)     # (c, kx)
            assert off.min() >= 0 and off.max() < S
            out[:, i[:, None], j[None, :]] = np.einsum(
                "jk,frjk->frj", xw[j], T[:, :, off])
    return out


@pytest.mark.parametrize("H,W,sr,dr,angle,iso,budget", [
    (64, 96, 2.0, 1.0, 0.0, (0.0, 0.0), cuda_apply.SMEM_BUDGET),
    (64, 96, 2.0, 1.0, 180.0, (0.0, 0.0), cuda_apply.SMEM_BUDGET),  # flipped
    (48, 80, 150.0, 60.0, 90.0, (0.0, 0.0), cuda_apply.SMEM_BUDGET),
    (24, 24, 2.0, 1.0, 0.0, (4.0, 4.0), cuda_apply.SMEM_BUDGET),    # wide band
    (40, 56, 1.0, 2.5, 270.0, (0.0, 0.0), cuda_apply.SMEM_BUDGET),  # upscale
    (60, 500, 40.0, 1.0, 0.0, (0.0, 0.0), 400),   # 42-tap band: TX halves to 1
    (60, 500, 40.0, 1.0, 0.0, (0.0, 0.0), 200),   # and TY halves to 1
])
def test_tile_plan_emulation_matches_plain(H, W, sr, dr, angle, iso, budget):
    rng = np.random.default_rng(7)
    ys, yw, xs, xw = _tables(H, W, sr, dr, angle, iso)
    frames = rng.uniform(0, 1, (2, H, W))   # folded tables read the original
    plan = cuda_apply.plan_separable(ys, xs, yw.shape[1], xw.shape[1],
                                     smem_budget=budget)
    assert plan["TY"] * plan["S"] * 4 <= budget
    got = _emulate_kernel(frames, ys, yw.astype(np.float64), xs,
                          xw.astype(np.float64), plan)
    want = cuda_apply.apply_separable_plain(
        torch.from_numpy(frames.astype(np.float32)), ys, yw, xs, xw)
    np.testing.assert_allclose(got, want.numpy(), atol=1e-5)


def test_tile_plan_shapes():
    ys, yw, xs, xw = _tables(2160, 3840, 2.0, 1.0)
    plan = cuda_apply.plan_separable(ys, xs, yw.shape[1], xw.shape[1])
    # flagship: full 16 x 128 tiles, span 2 * 127 + 4 source columns
    assert (plan["TY"], plan["TX"], plan["S"]) == (16, 128, 258)
    assert (plan["nty"], plan["ntx"]) == (68, 15)
    with pytest.raises(ValueError, match="shared"):
        cuda_apply.plan_separable(ys, xs, yw.shape[1], 30000)


def test_plan_cache_uploads_tables_once():
    tabs = _tables(64, 96, 2.0, 1.0)
    plan = cuda_apply._plan_for(*tabs)
    assert cuda_apply._plan_for(*tabs) is plan
    dev = torch.device("cpu")
    first = cuda_apply._device_tables(plan, dev)
    assert cuda_apply._device_tables(plan, dev) is first
    assert first[4].dtype == torch.int32 and first[1].dtype == torch.float32
