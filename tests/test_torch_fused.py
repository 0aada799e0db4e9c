"""``fused=True`` (on-device float32 ELL weight-gen, then the plain gather)
and the torch path of the weight-gen and the clipper, against the JAX
package on the CPU.

``ell_weights_torch`` in float32 against JAX's jax.numpy float32 path
(the one its fused route runs): equal bases; overlap areas (weights times
row sums) within atol 1e-5 of jitted exact mode (XLA fuses and contracts
the float32 clip) and 2e-6 of fast mode op by op; in float64 against the
numpy path within atol 1e-13.  Fused outputs
within 2e-4 of the host-operator route at the JAX package's own pins
(tests/test_api.py:95-122; pixels that one path leaves 0 and the other
covers by a float32 sliver, less than 1 % of them, are left out), and in
exact mode on every geometry for the pixels at least half inside the
image; against JAX's fused route within 2e-5 (float32 on both sides).
The torch clipper equals the numpy one within 1e-14 on float64 quads.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aainterp as aa
from aainterp.ops import weights as j_weights

import aainterp_torch as at
from aainterp_torch import api as t_api
from aainterp_torch.ops import clipper as t_clipper
from aainterp_torch.ops import weights as t_weights

GEOMS = [
    ((36, 44), 1.0, 0.5, (22.3, 17.8), 30.0),
    ((32, 36), 1.0, 0.5, (18.0, 16.0), 120.0),
    ((34, 30), 1.0, 0.5, (15.0, 17.0), 210.0),
    ((30, 34), 1.0, 0.5, (17.0, 15.0), 300.5),
    ((48, 48), 150.0, 25.4, (24.0, 24.0), 1.5),
    ((24, 24), 1.0, 1.0, (11.5, 12.5), 30.0),
]
IDS = ["30", "120", "210", "300.5", "film1.5", "equal30"]


def _close_but_edges(a, b, atol):
    """The JAX package's fused pin: outside the cells that one side leaves
    exactly 0 (fewer than 1 %), ``a`` and ``b`` agree within ``atol``."""
    edge = (a == 0.0) != (b == 0.0)
    assert edge.mean() < 0.01
    np.testing.assert_allclose(a[~edge], b[~edge], atol=atol, rtol=0)


@pytest.mark.parametrize("mode", ["exact", "fast"])
@pytest.mark.parametrize("args", GEOMS, ids=IDS)
def test_ell_weights_torch_matches_jax_float32(args, mode):
    js, ts = aa.make_grid_spec(*args), at.make_grid_spec(*args)
    gen = functools.partial(j_weights.ell_weights, js, xp=jnp,
                            dtype=jnp.float32, mode=mode)
    # exact mode under jit, as JAX's fused route runs it (op by op its
    # clip takes seconds to dispatch here); fast mode op by op, since
    # XLA's contracted float32 moves replica centres across the edge
    jb, jw, js_ = jax.jit(gen)() if mode == "exact" else gen()
    tb, tw, ts_ = t_weights.ell_weights_torch(ts, mode)
    assert tb.dtype == torch.int32 and tw.dtype == torch.float32
    assert np.array_equal(np.asarray(jb), tb.numpy())
    atol = 1e-5 if mode == "exact" else 2e-6
    np.testing.assert_allclose(ts_.numpy(), np.asarray(js_), atol=atol,
                               rtol=1e-6)
    # the overlap areas (weights times their row sums): a normalised weight
    # of a pixel that barely meets the image magnifies float32 rounding
    np.testing.assert_allclose((tw * ts_[..., None, None]).numpy(),
                               np.asarray(jw * js_[..., None, None]),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("mode", ["exact", "fast"])
@pytest.mark.parametrize("args", GEOMS[:2] + GEOMS[4:5], ids=["30", "120",
                                                            "film1.5"])
def test_ell_weights_torch_float64_matches_numpy(args, mode):
    ts = at.make_grid_spec(*args)
    Hd = ts.dst_shape[0]
    sl = (Hd // 4, Hd // 4 + 3)
    nb, nw, ns = t_weights.ell_weights(ts, mode, dy_slice=sl)
    tb, tw, tsum = t_weights.ell_weights_torch(ts, mode, sl,
                                               dtype=torch.float64)
    assert np.array_equal(nb, tb.numpy())
    np.testing.assert_allclose(tw.numpy(), nw, atol=1e-13, rtol=0)
    np.testing.assert_allclose(tsum.numpy(), ns, atol=1e-13, rtol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_torch_clipper_matches_numpy(seed):
    rng = np.random.default_rng(seed)
    n = 400
    px, py = rng.uniform(-2, 2, n), rng.uniform(-2, 2, n)
    ang = rng.uniform(0, np.pi / 2)
    c, s = np.cos(ang), np.sin(ang)
    side = rng.uniform(0.5, 3.0)
    qx, qy = t_clipper.quad_vertices(px, py, side, c, s)
    tqx, tqy = t_clipper.quad_vertices_torch(torch.from_numpy(px),
                                             torch.from_numpy(py), side, c, s)
    assert np.array_equal(qx, tqx.numpy()) and np.array_equal(qy, tqy.numpy())
    lo_x, lo_y = rng.uniform(-3, 1, n), rng.uniform(-3, 1, n)
    w = rng.uniform(0.1, 2.0, n)
    ref = t_clipper.quad_rect_overlap_area(qx, qy, lo_x, lo_y, lo_x + w,
                                           lo_y + w)
    got = t_clipper.quad_rect_overlap_area_torch(
        tqx, tqy, *(torch.from_numpy(v) for v in (lo_x, lo_y, lo_x + w,
                                                  lo_y + w)))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-14, rtol=0)


# the JAX package's own fused pins (tests/test_api.py:95-122): exact at
# 1.0 -> 0.5 and fast at equal resolution, 24 x 24 about (11.5, 12.5)
PINS = [(((24, 24), 1.0, 0.5, (11.5, 12.5), 30.0), "exact"),
        (((24, 24), 1.0, 1.0, (11.5, 12.5), 30.0), "fast")]


def _fused_host_jax(args, mode):
    x = np.random.default_rng(50).uniform(0, 1, (2,) + args[0]).astype(
        np.float32)
    xt = torch.from_numpy(x)
    got = at.area_average_interpolate(xt, *args[1:], mode=mode, fused=True)
    host = at.area_average_interpolate(xt, *args[1:], mode=mode)
    assert got.dst.dtype == torch.float32
    assert got.dst.shape == host.dst.shape
    assert got.dst_isocenter == host.dst_isocenter
    jf = np.asarray(aa.area_average_interpolate(
        jnp.asarray(x), *args[1:], mode=mode, fused=True).dst)
    return got.dst.numpy(), host.dst.numpy(), jf


@pytest.mark.parametrize("args,mode", PINS, ids=["exact", "fast"])
def test_fused_holds_the_jax_pins(args, mode):
    got, host, jf = _fused_host_jax(args, mode)
    _close_but_edges(got, host, 2e-4)
    _close_but_edges(got, jf, 2e-5)


@pytest.mark.parametrize("args", GEOMS, ids=IDS)
def test_fused_exact_matches_the_host_route_and_jax(args):
    got, host, jf = _fused_host_jax(args, "exact")
    # a pixel whose footprint barely meets the image normalises float32
    # slivers (areas under 64 eps extent^2, zeroed in float32 and kept in
    # float64) into a large share of its weights: compare the pixels at
    # least half inside the image.  (In fast mode float32 moves replica
    # centres across the footprint's edge where the grids align, in JAX's
    # fused route too, so it is held at the pin only.)
    spec = at.make_grid_spec(*args)
    op = at.build_operator(spec)
    inside = np.broadcast_to(op.raw_row_sums >= 0.5 * spec.dst_side ** 2,
                             got.shape)
    assert inside.mean() > 0.5
    np.testing.assert_allclose(got[inside], host[inside], atol=2e-4, rtol=0)
    np.testing.assert_allclose(got[inside], jf[inside], atol=2e-5, rtol=0)


def test_fused_chunks_change_no_weight(monkeypatch):
    args = GEOMS[0]
    spec = at.make_grid_spec(*args)
    whole = t_weights.ell_weights_torch(spec)
    rows = [t_weights.ell_weights_torch(spec, "exact", (i, i + 1))
            for i in range(spec.dst_shape[0])]
    for k in range(3):
        assert torch.equal(whole[k], torch.cat([r[k] for r in rows]))
    # the gather sums the same products; only its order may follow the
    # chunk's shape
    x = torch.rand(2, 36, 44, generator=torch.Generator().manual_seed(6))
    one = at.area_average_interpolate(x, *args[1:], fused=True).dst
    monkeypatch.setattr(t_api, "_FUSED_CHUNK_CELLS", 1)   # one row each
    per_row = at.area_average_interpolate(x, *args[1:], fused=True).dst
    torch.testing.assert_close(one, per_row, atol=1e-6, rtol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.uint8])
def test_fused_gives_float32(dtype):
    args = GEOMS[1]
    x = torch.rand(1, 32, 36, generator=torch.Generator().manual_seed(7))
    x = (x * 255).round().to(dtype) if dtype == torch.uint8 else x.to(dtype)
    out = at.area_average_interpolate(x, *args[1:], fused=True).dst
    assert out.dtype == torch.float32
    ref = at.area_average_interpolate(x.float(), *args[1:], fused=True).dst
    assert torch.equal(out, ref)


def test_fused_compat_raises_and_axis_aligned_fused_runs():
    x = torch.rand(1, 24, 32, generator=torch.Generator().manual_seed(8))
    with pytest.raises(ValueError, match="fused"):
        at.area_average_interpolate(x, 1.0, 0.5, (16.0, 12.0), 30.0,
                                    mode="compat", fused=True)
    # axis-aligned compat is exact mode, which fuses (as in JAX)
    a = at.area_average_interpolate(x, 2.0, 1.0, (0.0, 0.0), 90.0,
                                    mode="compat", fused=True).dst
    ref = at.area_average_interpolate(x, 2.0, 1.0, (0.0, 0.0), 90.0).dst
    torch.testing.assert_close(a, ref, atol=2e-4, rtol=0)
