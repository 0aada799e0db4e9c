"""Apply stage of the PyTorch port against the JAX package on the CPU.

* plain ``apply_separable_banded`` / ``apply_box_mean`` / ``quadrant_rotate``
  against their JAX counterparts (f32, atol 1e-6);
* ``cuda_apply.apply_separable_kernel`` on a CPU tensor (its plain version)
  against ``apply_separable_pallas(..., interpret=True)``: f32 atol 1e-5,
  bf16 out atol 1e-2 (one bf16 ulp on [0, 1]), uint8 within one gray level;
* the kernel's host tile plan, run through a numpy emulation of the
  staged form (strips, runs of row tiles, raw windows copied in aligned
  16-byte chunks, clamped or zero-filled taps), against the plain version
  (the CUDA kernel itself runs in tests/test_torch_kernel_cuda.py on a
  GPU); the emulation also serves kernel 2's plans
  (tests/test_torch_regrid_apply.py).
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
from aainterp_torch import regrid as t_regrid
from aainterp_torch.ops import cuda_apply, cuda_apply_2d, overlap1d
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
# the staged form's plan (csrc/band_apply.cuh), emulated in numpy
# ----------------------------------------------------------------------


def _seg_pitch(nbytes, stride):
    p = nbytes + 32
    return p + (stride - p) % 16


def emulate_band_kernel(frames, ys, yw, xs, xw, plan, *, clamp, addr0=0):
    """The staged form of csrc/band_apply.cuh, block by block, in float64.

    ``frames`` is (F, H, W) of a 1-, 2- or 4-byte integer or float dtype
    whose first byte sits at address ``addr0`` (mod 16).  Each block (frame,
    strip of TX dst columns, row tile of TY dst rows) copies the tile's window
    of source rows into a byte array the way the kernel's cp.async loop
    does: the 16-byte aligned chunks of each row's image part, to shared
    offset wbase + r * pitch + off with the pitch equal to the row stride
    mod 16.  The y and x passes then read pixels back from those bytes at
    the kernel's offsets, clamped (kernel 1) or zero-filled (kernel 2), and
    the test fails if any read falls on a byte that no chunk wrote.
    Returns the (F, Hd, Wd) output, NaN where nothing was written."""
    F, H, W = frames.shape
    Hd, ky = yw.shape
    Wd, kx = xw.shape
    es = frames.dtype.itemsize
    TY, TX, SY, SX = (plan[k] for k in ("TY", "TX", "SY", "SX"))
    nty, ntx = plan["nty"], plan["ntx"]
    assert nty == -(-Hd // TY) and ntx == -(-Wd // TX)
    # the global bytes, with 16 bytes either side: a chunk may overhang
    # the rows it serves, never the 16-byte block that holds their bytes
    pad = 16 + (addr0 % 16)
    glob = np.concatenate([np.full(pad, 0xAB, np.uint8),
                           frames.reshape(-1).view(np.uint8),
                           np.full(32, 0xAB, np.uint8)])
    stride = W * es
    pitch = _seg_pitch(SX * es, stride)

    def clip(lo, n, size):
        if clamp:
            return min(max(lo, 0), size - 1), min(max(lo + n - 1, 0), size - 1) + 1
        return max(lo, 0), min(lo + n, size)

    out = np.full((F, Hd, Wd), np.nan)
    for f in range(F):
        for strip in range(ntx):
            j = np.arange(strip * TX, min((strip + 1) * TX, Wd))
            cb = int(plan["col_base"][strip])
            xa, xb = clip(cb, SX, W)
            off_x = xs[j][:, None] - cb + np.arange(kx)          # T columns
            assert off_x.min() >= 0 and off_x.max() < SX
            for rt in range(nty):
                i = np.arange(rt * TY, min((rt + 1) * TY, Hd))
                rb = int(plan["row_base"][rt])
                ya, yb = clip(rb, SY, H)
                rel = ys[i][:, None] - rb + np.arange(ky)
                assert rel.min() >= 0 and rel.max() < SY
                smem = np.zeros(16 + 32 + SY * pitch, np.uint8)
                written = np.zeros(smem.shape, bool)
                nb = (xb - xa) * es
                a0 = addr0 + ((f * H + ya) * W + xa) * es
                wbase = 16 + a0 % 16
                for r in range(max(yb - ya, 0) if nb > 0 else 0):
                    a = a0 + r * stride
                    for c in range((nb + 30) // 16):
                        off = c * 16 - a % 16
                        if off >= nb:
                            continue
                        dst = wbase + r * pitch + off
                        assert dst % 16 == 0 and (a + off) % 16 == 0
                        g = a + off - addr0 + pad
                        smem[dst:dst + 16] = glob[g:g + 16]
                        written[dst:dst + 16] = True

                def pix(y, x):
                    """the kernel's read of source pixel (y, x)"""
                    if clamp:
                        y = min(max(y, 0), H - 1)
                        x = min(max(x, 0), W - 1)
                    elif not (ya <= y < yb and xa <= x < xb):
                        return 0.0
                    o = wbase + (y - ya) * pitch + (x - xa) * es
                    assert written[o:o + es].all(), (y, x)
                    return float(smem[o:o + es].view(frames.dtype)[0])

                T = np.array([[sum(yw[ii, a] * pix(ys[ii] + a, cb + c)
                                   for a in range(ky))
                               for c in range(SX)] for ii in i])
                out[f, i[:, None], j[None, :]] = np.einsum(
                    "jk,rjk->rj", xw[j], T[:, off_x])
    return out


@pytest.mark.parametrize("H,W,sr,dr,angle,iso,target", [
    (64, 96, 2.0, 1.0, 0.0, (0.0, 0.0), cuda_apply.SMEM_TARGET),
    (64, 96, 2.0, 1.0, 180.0, (0.0, 0.0), cuda_apply.SMEM_TARGET),  # flipped
    (48, 80, 150.0, 60.0, 90.0, (0.0, 0.0), cuda_apply.SMEM_TARGET),
    (24, 24, 2.0, 1.0, 0.0, (4.0, 4.0), cuda_apply.SMEM_TARGET),    # wide band
    (40, 56, 1.0, 2.5, 270.0, (0.0, 0.0), cuda_apply.SMEM_TARGET),  # upscale
    (60, 500, 40.0, 1.0, 0.0, (0.0, 0.0), 24000),  # 42-tap band: TX halves
    (60, 500, 40.0, 1.0, 0.0, (0.0, 0.0), 1),      # and TY: 1-pixel tiles
])
def test_tile_plan_emulation_matches_plain(H, W, sr, dr, angle, iso, target):
    rng = np.random.default_rng(7)
    ys, yw, xs, xw = _tables(H, W, sr, dr, angle, iso)
    frames = rng.uniform(0, 1, (2, H, W)).astype(np.float32)
    plan = cuda_apply.plan_separable(ys, xs, yw.shape[1], xw.shape[1],
                                     smem_target=target)
    assert plan["smem"] <= max(target, cuda_apply.SMEM_LIMIT)
    assert plan["smem"] == cuda_apply.band_smem(
        plan["TY"], plan["TX"], plan["SY"], plan["SX"], yw.shape[1])
    if target == 1:
        assert (plan["TY"], plan["TX"]) == (1, 1)
    got = emulate_band_kernel(frames, ys, yw.astype(np.float64), xs,
                              xw.astype(np.float64), plan, clamp=True,
                              addr0=4 * (H % 4))
    want = cuda_apply.apply_separable_plain(torch.from_numpy(frames), ys, yw,
                                            xs, xw)
    np.testing.assert_allclose(got, want.numpy(), atol=1e-5)


@pytest.mark.parametrize("dtype,W,addr0", [
    (np.uint8, 37, 3), (np.uint16, 45, 6), (np.uint16, 40, 0),
    (np.float32, 33, 12)])
def test_tile_plan_emulation_unaligned_rows(dtype, W, addr0):
    # rows whose byte stride is not a multiple of 16 and frames that start
    # off a 16-byte boundary: the chunks still land where the passes read
    rng = np.random.default_rng(8)
    ys, yw, xs, xw = _tables(30, W, 3.0, 2.0, 90.0, (1.0, 2.0))
    frames = rng.integers(0, 200, (2, 30, W)).astype(dtype)
    plan = cuda_apply.plan_separable(ys, xs, yw.shape[1], xw.shape[1],
                                     smem_target=6000)
    got = emulate_band_kernel(frames, ys, yw.astype(np.float64), xs,
                              xw.astype(np.float64), plan, clamp=True,
                              addr0=addr0)
    want = cuda_apply.apply_separable_plain(
        torch.from_numpy(frames.astype(np.float32)), ys, yw, xs, xw)
    np.testing.assert_allclose(got, want.numpy(), atol=1e-3)


KERNEL_2D_PLANS = {
    # (kind, src, dst, shared-memory target): a 10x regrid (config 5's
    # ratio), an upsampling regrid, a band wider than its source, an odd
    # resize and its flipped bands; small targets force several strips and
    # runs
    "regrid_10x": ("regrid", (90, 180), (9, 18), 14000),
    "regrid_up": ("regrid", (18, 36), (40, 50), 9000),
    "n_src_lt_band": ("regrid", (3, 3), (1, 1), cuda_apply_2d.SMEM_TARGET),
    "resize_odd": ("resize", (60, 150), (27, 52), 7000),
    "flipped": ("flipped", (60, 150), (27, 52), 7000),
}


@pytest.mark.parametrize("name", sorted(KERNEL_2D_PLANS))
@pytest.mark.parametrize("dtype,addr0", [(np.float32, 0), (np.uint16, 6),
                                         (np.uint8, 9)])
def test_kernel_2d_plan_emulation_matches_plain(name, dtype, addr0):
    # kernel 2's plans through the same staged form, taps outside the image
    # zero-filled: every tap of every output lies in its block's window
    kind, src, dst, target = KERNEL_2D_PLANS[name]
    if kind == "regrid":
        by, bx = t_regrid.conservative_regrid_operator(
            t_regrid.LatLonGrid(*src), t_regrid.LatLonGrid(*dst))
    else:
        by, bx = at.resize_bands(src, dst)
        if kind == "flipped":
            by, bx = overlap1d.flip_band(by), overlap1d.flip_band(bx)
    ys, yw, xs, xw = (by.start, by.weights.astype(np.float32), bx.start,
                      bx.weights.astype(np.float32))
    plan = cuda_apply_2d.plan_separable_2d(ys, xs, yw.shape[1], xw.shape[1],
                                           smem_target=target)
    assert not plan["direct"]
    frames = np.random.default_rng(9).integers(0, 250, (2,) + src).astype(
        dtype)
    got = emulate_band_kernel(frames, ys, yw.astype(np.float64), xs,
                              xw.astype(np.float64), plan, clamp=False,
                              addr0=addr0)
    want = cuda_apply_2d.apply_separable_2d_plain(
        torch.from_numpy(frames.astype(np.float32)), ys, yw, xs, xw)
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-6, atol=1e-3)


def test_tile_plan_shapes():
    ys, yw, xs, xw = _tables(2160, 3840, 2.0, 1.0)
    plan = cuda_apply.plan_separable(ys, xs, yw.shape[1], xw.shape[1])
    # flagship: strips of 240 dst columns (482 source columns), row tiles
    # of 8 dst rows (18 source rows), one row tile per block
    assert (plan["TY"], plan["TX"], plan["SY"], plan["SX"]) == \
        (8, 240, 18, 482)
    assert (plan["nty"], plan["ntx"]) == (135, 8)
    assert plan["smem"] <= cuda_apply.SMEM_TARGET
    # a band whose one-pixel window exceeds the card's shared memory: kernel
    # 1's planner does not take it, and the wrapper sends it to kernel 2
    assert cuda_apply.plan_separable(ys, xs, yw.shape[1], 30000) is None
    wide = np.full((xs.shape[0], 30000), 1 / 30000, np.float32)
    assert cuda_apply._plan_for(ys, yw, xs, wide)["kernel_2d"]
    assert not cuda_apply._plan_for(ys, yw, xs, xw)["kernel_2d"]


def test_plan_cache_uploads_tables_once():
    tabs = _tables(64, 96, 2.0, 1.0)
    plan = cuda_apply._plan_for(*tabs)
    assert cuda_apply._plan_for(*tabs) is plan
    dev = torch.device("cpu")
    first = cuda_apply._device_tables(plan, dev)
    assert cuda_apply._device_tables(plan, dev) is first
    assert first[4].dtype == torch.int32 and first[1].dtype == torch.float32
