"""The band-operator family of the PyTorch port against the JAX package on
the CPU: ``regrid.apply_band_operators`` (routes and dtypes), the masked
variant, ``conservative_regrid``, ``area_weighted_mean`` and the
area-resize front doors (``area_resize``, ``resize``, ``resize_bands``,
``area_resize_nd``, ``area_pyramid``); gradients of the aligned and
banded routes and of the kernel route's adjoint (``BandKernelLinear``,
its plain version on the CPU) against ``jax.grad``; and the device rule
of the public entry points.

Tolerances: f32 fields in [250, 300] rtol 1e-6, atol 1e-3
(tests/test_pallas.py:168-169); [0, 1] images atol 1e-6; bf16 input gives
f32 on the CPU routes, as in JAX, and is held to the same bound; uint8
within one gray level (summation order can flip a .5 rounding);
gradients atol 1e-6.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import aainterp as aa
from aainterp import regrid as j_regrid

import aainterp_torch as at
from aainterp_torch import regrid as t_regrid
from aainterp_torch.ops import cuda_apply_2d


def _bands(src, dst):
    return (j_regrid.conservative_regrid_operator(j_regrid.LatLonGrid(*src),
                                                  j_regrid.LatLonGrid(*dst)),
            t_regrid.conservative_regrid_operator(t_regrid.LatLonGrid(*src),
                                                  t_regrid.LatLonGrid(*dst)))


def _field(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == "uint8":
        return rng.integers(0, 256, shape, dtype=np.uint8)
    return rng.uniform(250, 300, shape).astype(np.float32)


def _to_torch(x, dtype):
    t = torch.from_numpy(x)
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


def _to_jax(x, dtype):
    j = jnp.asarray(x)
    return j.astype(jnp.bfloat16) if dtype == "bfloat16" else j


def _close(got, ref, what=""):
    got = got.detach()
    ref = np.asarray(ref)
    assert tuple(got.shape) == ref.shape, what
    if ref.dtype == np.uint8:
        assert got.dtype == torch.uint8, what
        assert np.abs(got.numpy().astype(np.int32)
                      - ref.astype(np.int32)).max() <= 1, what
        return
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), rtol=1e-6,
                               atol=1e-3, equal_nan=True, err_msg=what)


# (src, dst): aligned (10x, config 5's ratio), aligned at 2x3, and a
# non-aligned 2.5x regrid (the 0.1 -> 0.25 degree ratio)
REGRIDS = [((360, 720), (36, 72)), ((180, 360), (90, 120)),
           ((180, 360), (72, 144))]
JAX_IMPL = {"auto": "auto", "aligned": "aligned", "banded": "xla"}


@pytest.mark.parametrize("src,dst", REGRIDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "uint8"])
@pytest.mark.parametrize("impl", ["auto", "aligned", "banded"])
def test_apply_band_operators_matches_jax(src, dst, dtype, impl):
    (jy, jx), (ty, tx) = _bands(src, dst)
    aligned = src[0] % dst[0] == 0 and src[1] % dst[1] == 0
    x = _field((2,) + src, dtype)
    if impl == "aligned" and not aligned:
        with pytest.raises(ValueError, match="aligned"):
            at.apply_band_operators(_to_torch(x, dtype), ty, tx, impl=impl)
        return
    ref = j_regrid.apply_band_operators(_to_jax(x, dtype), jy, jx,
                                        impl=JAX_IMPL[impl])
    got = at.apply_band_operators(_to_torch(x, dtype), ty, tx, impl=impl)
    # u8 -> u8 on every route; bf16 -> f32 on the CPU routes, as in JAX
    assert str(got.dtype).split(".")[-1] == str(ref.dtype)
    _close(got, ref, f"{impl} {dtype}")


def test_auto_route_memoises_the_aligned_plan_by_content():
    (_, _), (ty, tx) = _bands((360, 720), (36, 72))
    a = t_regrid.band_tables(ty, tx)
    ty2 = t_regrid.conservative_regrid_operator(t_regrid.LatLonGrid(360, 720),
                                                t_regrid.LatLonGrid(36, 72))[0]
    assert t_regrid.band_tables(ty2, tx) is a and a.aligned is not None
    assert a.aligned[0]["m"] == 10 and a.aligned[1]["m"] == 10


def _fake(dtype, is_cuda):
    """What the route reads of a field, for a CUDA field on a CPU-only
    machine."""
    return types.SimpleNamespace(dtype=dtype, is_cuda=is_cuda)


def test_routes_are_decided_before_any_launch():
    _, (ty, tx) = _bands((360, 720), (36, 72))
    _, (ny, nx) = _bands((180, 360), (72, 144))
    tabs, ntabs = t_regrid.band_tables(ty, tx), t_regrid.band_tables(ny, nx)
    route = t_regrid._route
    # on the card 'auto' takes the kernel for every dtype, aligned or not
    for dtype in (torch.float32, torch.bfloat16, torch.uint8):
        for tb in (tabs, ntabs):
            assert route("auto", _fake(dtype, True), tb, "auto") == "kernel"
    # on the CPU it follows the JAX package
    assert route("auto", _fake(torch.float32, False), tabs, "auto") == \
        "aligned"
    assert route("auto", _fake(torch.bfloat16, False), tabs, "auto") == \
        "banded"
    assert route("auto", _fake(torch.float32, False), ntabs, "auto") == \
        "banded"
    # bands beyond the kernel's shared-memory limit get the kernel's direct
    # form: no band pair is sent off the kernel
    wide = t_regrid.band_tables(*(t_regrid.Band1D(
        start=np.zeros(3, np.int32), weights=np.full((3, 400), 1 / 400),
        n_src=400, n_dst=3) for _ in range(2)))
    before = cuda_apply_2d.LAUNCHES
    assert wide.plan["direct"] and not tabs.plan["direct"]
    assert route("auto", _fake(torch.bfloat16, True), wide, "auto") == \
        "kernel"
    assert cuda_apply_2d.LAUNCHES == before


def test_route_errors():
    _, (ty, tx) = _bands((180, 360), (72, 144))
    x = torch.from_numpy(_field((2, 180, 360), "float32"))
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        at.apply_band_operators(x, ty, tx, impl="kernel")
    with pytest.raises(ValueError, match="'auto', 'aligned', 'kernel', "
                                         "'banded'"):
        at.apply_band_operators(x, ty, tx, impl="pallas")
    with pytest.raises(ValueError, match="precision must be"):
        at.apply_band_operators(x, ty, tx, precision="bogus")
    with pytest.raises(ValueError, match="must end in"):
        at.apply_band_operators(x[..., :-1], ty, tx)
    with pytest.raises(ValueError, match="not an exactly aligned"):
        at.apply_band_operators(x, ty, tx, impl="aligned")


@pytest.mark.parametrize("src,dst", REGRIDS)
@pytest.mark.parametrize("mask_shape", ["shared", "per_field"])
@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_masked_matches_jax(src, dst, mask_shape, dtype):
    (jy, jx), (ty, tx) = _bands(src, dst)
    x = _field((2,) + src, dtype)
    rng = np.random.default_rng(3)
    shape = src if mask_shape == "shared" else (2,) + src
    mask = (rng.uniform(0, 1, shape) > 0.4).astype(np.float32)
    mask[..., : src[0] // 4, :] = 0.0          # empty destination rows
    ref, rcov = j_regrid.apply_band_operators_masked(x, mask, jy, jx)
    got, cov = at.apply_band_operators_masked(torch.from_numpy(x),
                                              torch.from_numpy(mask), ty, tx)
    assert got.dtype == torch.float32 and bool(torch.isnan(got).any())
    _close(got, ref, "out")
    np.testing.assert_allclose(cov.numpy(), np.asarray(rcov), atol=1e-6)


@pytest.mark.parametrize("src,dst", REGRIDS)
@pytest.mark.parametrize("masked", [False, True])
def test_conservative_regrid_matches_jax(src, dst, masked):
    x = _field((3,) + src, "float32", seed=4)
    mask = None
    if masked:
        mask = (np.random.default_rng(5).uniform(0, 1, src) > 0.3)
    ref = j_regrid.conservative_regrid(x, j_regrid.LatLonGrid(*src),
                                       j_regrid.LatLonGrid(*dst),
                                       src_mask=mask, fill_value=-1.0)
    got = at.conservative_regrid(
        torch.from_numpy(x), at.LatLonGrid(*src), at.LatLonGrid(*dst),
        src_mask=None if mask is None else torch.from_numpy(mask),
        fill_value=-1.0)
    _close(got, ref)


@pytest.mark.parametrize("src,dst", REGRIDS)
def test_area_weighted_mean_and_flux(src, dst):
    x = _field((2,) + src, "float32", seed=6)
    sg, dg = at.LatLonGrid(*src), at.LatLonGrid(*dst)
    m_src = at.area_weighted_mean(torch.from_numpy(x), sg)
    np.testing.assert_allclose(
        m_src.numpy(),
        np.asarray(j_regrid.area_weighted_mean(x, j_regrid.LatLonGrid(*src))),
        rtol=1e-6)
    out = at.conservative_regrid(torch.from_numpy(x), sg, dg)
    m_dst = at.area_weighted_mean(out, dg)
    # conservation: the regrid keeps the spherical-area-weighted mean
    np.testing.assert_allclose(m_dst.double().numpy(),
                               m_src.double().numpy(), rtol=1e-6)


# ----------------------------------------------------------------------
# area-resize front doors
# ----------------------------------------------------------------------

RESIZES = [((128, 192), (64, 96)),     # aligned 2x
           ((120, 160), (45, 77)),     # odd, non-integer
           ((30, 40), (70, 90))]       # upscale


def _image(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == "uint8":
        return rng.integers(0, 256, shape, dtype=np.uint8)
    return rng.uniform(0, 1, shape).astype(np.float32)


def _close_img(got, ref, what=""):
    ref = np.asarray(ref)
    assert tuple(got.shape) == ref.shape, what
    if ref.dtype == np.uint8:
        assert got.dtype == torch.uint8
        assert np.abs(got.numpy().astype(np.int32)
                      - ref.astype(np.int32)).max() <= 1, what
    else:
        np.testing.assert_allclose(got.detach().float().numpy(),
                                   np.asarray(ref, np.float32), atol=1e-6,
                                   equal_nan=True, err_msg=what)


@pytest.mark.parametrize("src,dst", RESIZES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "uint8"])
def test_area_resize_matches_jax(src, dst, dtype):
    x = _image((2,) + src, dtype)
    ref = aa.area_resize(_to_jax(x, dtype), dst)
    got = at.area_resize(_to_torch(x, dtype), dst)
    assert str(got.dtype).split(".")[-1] == str(ref.dtype)
    _close_img(got, ref, dtype)
    # the mean is conserved at any ratio
    if dtype == "float32":
        np.testing.assert_allclose(got.double().mean().item(),
                                   float(x.astype(np.float64).mean()),
                                   rtol=1e-6)


@pytest.mark.parametrize("src,dst", RESIZES)
def test_area_resize_masked_and_resize_matches_jax(src, dst):
    x = _image((2,) + src, "float32", seed=1)
    mask = np.random.default_rng(2).uniform(0, 1, src) > 0.5
    ref = aa.area_resize(x, dst, mask=mask, fill_value=0.0)
    got = at.area_resize(torch.from_numpy(x), dst,
                         mask=torch.from_numpy(mask), fill_value=0.0)
    _close_img(got, ref, "masked")
    assert torch.equal(at.resize(torch.from_numpy(x), dst, method="area"),
                       at.area_resize(torch.from_numpy(x), dst))
    jb, tb = aa.api.resize_bands(src, dst), at.resize_bands(src, dst)
    for a, b in zip(jb, tb):
        assert np.array_equal(a.start, b.start)
        assert np.array_equal(a.weights, b.weights)


def test_resize_errors():
    x = torch.zeros(1, 8, 8)
    with pytest.raises(NotImplementedError, match="slice 5"):
        at.resize(x, (4, 4), method="bilinear")
    with pytest.raises(NotImplementedError, match="baselines"):
        at.resize(x, (4, 4), method="bicubic")
    with pytest.raises(ValueError, match="method must be"):
        at.resize(x, (4, 4), method="nearest")
    with pytest.raises(ValueError, match="positive"):
        at.area_resize(x, (0, 4))
    with pytest.raises(ValueError, match="positive"):
        at.resize_bands((8, 8), (4, -1))


ND_CASES = [
    ((6, 24, 36), (3, 12, 18), None),        # every axis, aligned
    ((5, 24, 30), (3, 16, 20), None),        # every axis, non-aligned
    ((4, 9, 24, 30), (6,), (1,)),            # one leading axis only
    ((7, 24, 30), (5, 30), (0, 2)),          # a leading and the last axis
    ((3, 24, 30), (24, 30), None),           # no-op: returns the input
    ((2, 24, 30), (12, 17), None),           # trailing 2-D only
]


@pytest.mark.parametrize("shape,dst,axes", ND_CASES)
@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_area_resize_nd_matches_jax(shape, dst, axes, dtype):
    x = _image(shape, dtype, seed=3)
    ref = aa.area_resize_nd(jnp.asarray(x), dst, axes=axes)
    got = at.area_resize_nd(torch.from_numpy(x), dst, axes=axes)
    assert str(got.dtype).split(".")[-1] == str(ref.dtype)
    _close_img(got, ref, f"{shape} -> {dst} axes {axes}")


@pytest.mark.parametrize("shape,dst,axes", ND_CASES[:4])
def test_area_resize_nd_masked_matches_jax(shape, dst, axes):
    x = _image(shape, "float32", seed=4)
    mask = np.random.default_rng(5).uniform(0, 1, shape[-2:]) > 0.3
    ref = aa.area_resize_nd(x, dst, axes=axes, mask=mask, fill_value=-1.0)
    got = at.area_resize_nd(torch.from_numpy(x), dst, axes=axes,
                            mask=torch.from_numpy(mask), fill_value=-1.0)
    assert got.dtype == torch.float32
    _close_img(got, ref)


def test_area_resize_nd_errors():
    x = torch.zeros(4, 6, 8)
    with pytest.raises(ValueError, match="entries"):
        at.area_resize_nd(x, (1, 2, 3, 4))
    with pytest.raises(ValueError, match="mismatch"):
        at.area_resize_nd(x, (2, 3), axes=(0,))
    with pytest.raises(ValueError, match="duplicate"):
        at.area_resize_nd(x, (2, 3), axes=(1, -2))
    with pytest.raises(ValueError, match="positive"):
        at.area_resize_nd(x, (0, 3))
    assert at.area_resize_nd(x, (6, 8)) is x


@pytest.mark.parametrize("shape,levels,factor", [((2, 64, 96), 4, 2),
                                                 ((50, 70), 5, 3),
                                                 ((9, 4), 8, 2)])
def test_area_pyramid_matches_jax(shape, levels, factor):
    x = _image(shape, "float32", seed=6)
    ref = aa.area_pyramid(jnp.asarray(x), levels, factor=factor)
    got = at.area_pyramid(torch.from_numpy(x), levels, factor=factor)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        _close_img(g, r)
        np.testing.assert_allclose(g.double().mean().item(),
                                   float(x.astype(np.float64).mean()),
                                   rtol=1e-6)
    with pytest.raises(ValueError, match="num_levels"):
        at.area_pyramid(torch.from_numpy(x), 0)
    with pytest.raises(ValueError, match="factor"):
        at.area_pyramid(torch.from_numpy(x), 2, factor=1)


@pytest.mark.parametrize("src,dst,impl", [((360, 720), (36, 72), "aligned"),
                                          ((180, 360), (72, 144), "banded"),
                                          ((180, 360), (72, 144), "auto")])
def test_gradients_match_jax_grad(src, dst, impl):
    (jy, jx), (ty, tx) = _bands(src, dst)
    rng = np.random.default_rng(7)
    x = rng.uniform(0, 1, (2,) + src).astype(np.float32)
    g = rng.uniform(0, 1, (2,) + dst).astype(np.float32)
    ref = jax.grad(lambda a: jnp.sum(j_regrid.apply_band_operators(
        a, jy, jx, impl=JAX_IMPL.get(impl, "auto")) * g))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (gt,) = torch.autograd.grad(
        (at.apply_band_operators(xt, ty, tx, impl=impl)
         * torch.from_numpy(g)).sum(), xt)
    np.testing.assert_allclose(gt.numpy(), np.asarray(ref), atol=1e-6)


def _flipped(b):
    """A band with decreasing starts (the source axis reversed)."""
    from aainterp_torch.ops import overlap1d
    return overlap1d.flip_band(b)


@pytest.mark.parametrize("src,dst,flip", [(s, d, False) for s, d in REGRIDS]
                         + [((180, 360), (72, 144), True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_route_adjoint_matches_jax_grad(src, dst, flip, dtype):
    # BandKernelLinear is the kernel route's differentiable apply; on CPU
    # tensors its wrapper runs the kernel's plain version, so the adjoint
    # (the transposed tables) is checked here and its launches on the card
    (jy, jx), (ty, tx) = _bands(src, dst)
    if flip:
        from aainterp.ops import overlap1d as j_overlap1d
        jx, tx = j_overlap1d.flip_band(jx), _flipped(tx)
    rng = np.random.default_rng(9)
    x = rng.uniform(0, 1, (2,) + src).astype(np.float32)
    g = rng.uniform(0, 1, (2,) + dst).astype(np.float32)
    ref = jax.grad(lambda a: jnp.sum(j_regrid.apply_band_operators(
        a, jy, jx, impl="xla") * g))(jnp.asarray(x))
    tabs = t_regrid.band_tables(ty, tx)
    xt = _to_torch(x, dtype).requires_grad_(True)
    out = t_regrid.BandKernelLinear.apply(xt, tabs, "auto")
    assert out.dtype == xt.dtype
    (gt,) = torch.autograd.grad((out.float() * torch.from_numpy(g)).sum(),
                                xt)
    assert gt.dtype == xt.dtype
    if dtype == "float32":
        np.testing.assert_allclose(gt.numpy(), np.asarray(ref), atol=1e-6)
    else:   # the forward's and backward's bf16 outputs: 1e-2 relative
        np.testing.assert_allclose(gt.float().numpy(), np.asarray(ref),
                                   rtol=1e-2, atol=1e-3)


def test_transposed_tables_are_the_dense_transpose():
    _, (ty, tx) = _bands((180, 360), (72, 144))
    tabs = t_regrid.band_tables(ty, _flipped(tx))
    tt = tabs.transposed()
    assert tabs.transposed() is tt
    assert np.array_equal(tt.by.dense(), tabs.by.dense().T)
    assert np.array_equal(tt.bx.dense(), tabs.bx.dense().T)
    assert tt.n_src == (72, 144)


# ----------------------------------------------------------------------
# the device rule: numpy input goes to the GPU unless device= says
# otherwise, and raises where there is none
# ----------------------------------------------------------------------

_by, _bx = t_regrid.conservative_regrid_operator(t_regrid.LatLonGrid(18, 36),
                                                 t_regrid.LatLonGrid(6, 12))
ENTRY_POINTS = {
    "area_average_interpolate": lambda x, **kw: at.area_average_interpolate(
        x, 2.0, 1.0, (0.0, 0.0), 0.0, **kw).dst,
    "apply_operator": lambda x, **kw: at.apply_operator(
        at.build_operator(at.make_grid_spec((18, 36), 2.0, 1.0, (0.0, 0.0),
                                            0.0)), x, **kw),
    "apply_band_operators": lambda x, **kw: at.apply_band_operators(
        x, _by, _bx, **kw),
    "apply_band_operators_masked": lambda x, **kw:
        at.apply_band_operators_masked(x, np.ones((18, 36)), _by, _bx,
                                       **kw)[0],
    "conservative_regrid": lambda x, **kw: at.conservative_regrid(
        x, at.LatLonGrid(18, 36), at.LatLonGrid(6, 12), **kw),
    "area_weighted_mean": lambda x, **kw: at.area_weighted_mean(
        x, at.LatLonGrid(18, 36), **kw),
    "area_resize": lambda x, **kw: at.area_resize(x, (9, 12), **kw),
    "resize": lambda x, **kw: at.resize(x, (9, 12), **kw),
    "area_resize_nd": lambda x, **kw: at.area_resize_nd(x, (9, 12), **kw),
    "area_pyramid": lambda x, **kw: at.area_pyramid(x, 3, **kw)[-1],
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_numpy_input_without_a_gpu_raises_unless_device_is_given(
        name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fn = ENTRY_POINTS[name]
    x = np.random.default_rng(8).uniform(0, 1, (2, 18, 36)).astype(np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fn(x)
    got = fn(x, device="cpu")
    assert got.device.type == "cpu"
    # a tensor keeps its device; a list goes to device=
    assert torch.equal(fn(torch.from_numpy(x)), got)
    assert torch.equal(fn(x.tolist(), device=torch.device("cpu")), got)
    # device= is where the call computes: a CPU tensor asked onto the GPU
    # raises here, never carries on on the CPU
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn(torch.from_numpy(x), device="cuda")
    assert torch.equal(fn(torch.from_numpy(x), device="cpu"), got)


def test_device_moves_a_tensor_to_the_device_asked_for():
    from aainterp_torch.utils.device import as_input
    x = torch.ones(2, 3)
    assert as_input(x) is x and as_input(x, "cpu") is x
    moved = as_input(x, "meta")
    assert moved.device.type == "meta" and moved.shape == x.shape
    assert as_input(np.ones(3), torch.device("meta")).device.type == "meta"
