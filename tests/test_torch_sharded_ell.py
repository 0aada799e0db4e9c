"""The port's row-sharded rotated (ELL) apply, its conservation flux and
the fold of explicit tables (``aainterp_torch.parallel.sharding.
sharded_apply_ell``, ``sharded_apply_ell_kernel``,
``ops.cuda_shear.build_sharded_kernel_plan``, ``parallel.conserve.
ell_flux_factors`` / ``sharded_flux_ell``, ``ops.weights.
fold_tables_device``) against the JAX package's on the 8-device virtual
CPU mesh (tests/conftest.py).

The port's ranks are gloo processes on the CPU, one torch thread each,
started once for the module (``RankPool``, 4 and 8 ranks); their side of
each case is in tests/torch_dist_ranks.py, which imports no jax.  On the
CPU the kernel route's wrappers take their plain versions, on each rank's
plan.  Inputs are made from numpy seeds and the operators go to the port
through ``convert.ell_operator_from_numpy``.  Tolerances: float32 atol
1e-5, flux rtol 1e-5, and ``torch.equal`` / ``np.array_equal`` where a
case says so.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aainterp as aa
from aainterp.ops import pallas_shear as j_pallas_shear
from aainterp.ops.weights import ell_operator
from aainterp.ops.weights import fold_tables_device as j_fold_tables_device
from aainterp.parallel import conserve as j_conserve
from aainterp.parallel import sharding as j_sharding

import torch_dist_ranks as ranks
from aainterp_torch import api as t_api
from aainterp_torch.ops import cuda_shear
from aainterp_torch.ops import weights as t_weights
from aainterp_torch.parallel import conserve as t_conserve
from aainterp_torch.parallel import sharding as t_sharding
from test_torch_sharded import (_jmesh, _put, _run,  # noqa: F401
                                plan_cache_dir, pools)

pytestmark = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs 8 (virtual) devices")

MESHES = ((1, 4), (2, 2), (2, 4))
ATOL = 1e-5
RTOL_FLUX = 1e-5


def _op(H, W, angle, iso=None, res_dst=0.5):
    """A JAX EllOperator: (H, W) at 1.0 -> ``res_dst``, exact."""
    spec = aa.make_grid_spec((H, W), 1.0, res_dst,
                             iso or (W / 2, H / 2), angle)
    return ell_operator(spec, mode="exact")


def _tables(op):
    """A JAX EllOperator's tables for convert.ell_operator_from_numpy."""
    return dict(spec_fields=dataclasses.asdict(op.spec),
                base=np.asarray(op.base), weights=np.asarray(op.weights),
                raw_row_sums=np.asarray(op.raw_row_sums), mode=op.mode)


def _port(op):
    return ranks._ell_op(_tables(op))


def _frames(seed, shape):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(
        np.float32)


def _jax_ell(frames, op, mesh_shape, **kw):
    mesh = _jmesh(*mesh_shape)
    return jax.jit(lambda f: j_sharding.sharded_apply_ell(
        f, op, mesh, **kw))(_put(frames, mesh))


def _ref(op, frames):
    return np.asarray(aa.apply_operator(op, jnp.asarray(frames)))


# ---------------------------------------------------------------------------
# the gather route ('auto' on the CPU) against JAX's 'xla' route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_gather_route_matches_jax(pools, mesh_shape):
    # 8 deg, 2x downscale: dst rows 68 and src rows 128 divide 4
    B, H, W = 4, 128, 64
    frames = _frames(0, (B, H, W))
    op = _op(H, W, 8.0)
    ref = np.asarray(_jax_ell(frames, op, mesh_shape, impl="xla"))
    res = _run(pools, ranks.ell, mesh_shape, frames, _tables(op))
    np.testing.assert_allclose(res[0]["out"], ref, atol=ATOL)
    np.testing.assert_allclose(res[0]["out"], _ref(op, frames), atol=ATOL)
    assert res[0]["dtype"] == "torch.float32"
    n_data, n_rows = mesh_shape
    for rank, r in enumerate(res):
        d, i = divmod(rank, n_rows)
        b, rows = B // n_data, ref.shape[1] // n_rows
        np.testing.assert_array_equal(
            r["local"], res[0]["out"][d * b:(d + 1) * b,
                                      i * rows:(i + 1) * rows])
        assert r["traffic"]["all_reduce"] == 0


def test_multi_hop_halo_at_45_degrees(pools):
    # 32 x 512 at 45 deg: halo 28 rows over blocks of 4, the 7-hop ring
    H, W = 32, 512
    op = _op(H, W, 45.0)
    frames = _frames(1, (1, H, W))
    ref = np.asarray(_jax_ell(frames, op, (1, 8), impl="xla"))
    kp = cuda_shear.build_sharded_kernel_plan(_port(op), 8)
    assert (kp.halo, kp.sb) == (28, 4)
    for kernel in (False, True):
        res = _run(pools, ranks.ell, (1, 8), frames, _tables(op), "auto",
                   False, kernel)
        np.testing.assert_allclose(res[0]["out"], ref, atol=ATOL)
        # rank 0 sends its whole block on each of its 7 hops, and no rank
        # sends more than hops x block on either side
        block = H // 8 * W * 4
        assert res[0]["traffic"]["p2p"] == 7 * block
        assert all(r["traffic"]["p2p"] <= 2 * 7 * block for r in res)


def test_fuzz_angles_both_routes(pools):
    rng = np.random.default_rng(99)
    checked = 0
    for _ in range(60):
        if checked >= 4:
            break
        H = int(rng.integers(12, 40)) * 8
        W = int(rng.integers(8, 24)) * 8
        ang = float(rng.uniform(1.0, 359.0))
        spec = aa.make_grid_spec((H, W), 1.0, 0.5, (W / 2, H / 2), ang)
        if spec.is_axis_aligned or spec.dst_shape[0] % 4 or \
                spec.qrot_shape[0] % 4:
            continue
        op = ell_operator(spec, mode="exact")
        frames = _frames(2 + checked, (2, H, W))
        ref = np.asarray(_jax_ell(frames, op, (2, 4), impl="xla"))
        for kernel in (False, True):
            res = _run(pools, ranks.ell, (2, 4), frames, _tables(op),
                       "auto", False, kernel)
            np.testing.assert_allclose(res[0]["out"], ref, atol=ATOL,
                                       err_msg=f"{H}x{W} at {ang}")
        checked += 1
    assert checked >= 3


# ---------------------------------------------------------------------------
# the kernel route on CPU tensors (plain versions on the rank plans)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("H, W, angle", ((128, 64, 8.0), (32, 128, 37.5),
                                         (64, 128, 98.0)))
def test_kernel_route_matches_jax_pallas_and_unsharded(pools, H, W, angle):
    # TestShardedEllPallas's geometries: a small angle, a 3-hop halo, and
    # quadrant 1, whose folded dst rows (41) do not divide 4: the rot90
    # route, on the unfolded operator's plan
    frames = _frames(3, (2, H, W))
    op = _op(H, W, angle)
    mesh = _jmesh(2, 4)
    jout = np.asarray(jax.jit(lambda f: j_sharding.sharded_apply_ell_pallas(
        f, op, mesh, interpret=True))(_put(frames, mesh)))
    res = _run(pools, ranks.ell_kernel_vs_unsharded, (2, 4), frames,
               _tables(op))
    np.testing.assert_allclose(res[0]["out"], jout, atol=ATOL)
    for r in res:
        # bit-equal to the unsharded kernel route; on the CPU the
        # wrappers launch nothing
        assert r["cmp"]["equal"], r["cmp"]
        assert set(r["launches"].values()) == {0}
        assert not r["folded"]


def test_rank_plans_are_the_global_plans_rows_shifted():
    for H, W, angle, n in ((128, 64, 8.0, 4), (32, 512, 45.0, 8),
                           (32, 128, 37.5, 4)):
        jop = _op(H, W, angle)
        kp = cuda_shear.build_sharded_kernel_plan(_port(jop), n)
        g = kp.plan
        # JAX's exact halo (its kernel plan rounds it up to 8 rows)
        assert kp.halo == j_sharding._ell_axis_halo(
            jop.base[..., 0], jop.window, kp.db, kp.sb, n)
        assert kp.Hloc == kp.sb + 2 * kp.halo
        assert cuda_shear.build_sharded_kernel_plan(_port(jop), n) is kp
        for i in range(n):
            p, off = kp.rank(i), i * kp.sb - kp.halo
            rows = slice(i * kp.db, (i + 1) * kp.db)
            assert (p.qH, p.qW, p.Hd, p.Wd, p.TW, p.Ka, p.Kb) == (
                kp.Hloc, g.qW, kp.db, g.Wd, g.TW, g.Ka, g.Kb)
            assert p.TH == kp.Hloc + int(g.gy.max()) + 1
            np.testing.assert_array_equal(p.ry0, g.ry0[rows] - off)
            np.testing.assert_array_equal(
                p.hx, g.hx[np.clip(off + np.arange(p.TH), 0, g.TH - 1)])
            np.testing.assert_array_equal(p.w2, g.w2[:, rows])
            np.testing.assert_array_equal(p.span, g.span[rows])
            np.testing.assert_array_equal(p.gy, g.gy)
            np.testing.assert_array_equal(p.cx0, g.cx0)
            # every live tap reads a T row of the local plane, and the
            # sheared T column of the global plan
            for t in range(p.Ka * p.Kb):
                dy, _ = np.nonzero(p.w2[t])
                y = p.ry0[dy] + t // p.Kb
                assert ((y >= 0) & (y < p.TH)).all()
                np.testing.assert_array_equal(p.hx[y], g.hx[y + off])


def test_unaligned_blocks_the_port_accepts(pools):
    # src rows 100 over 4 ranks: blocks of 25, not 8-aligned; JAX's
    # sharded plan rejects them (a TPU tile rule), the port plans them
    H, W = 100, 64
    op = _op(H, W, 12.0)
    assert op.spec.dst_shape[0] % 4 == 0
    with pytest.raises(ValueError, match="8-aligned"):
        j_pallas_shear.build_sharded_kernel_plan(op, 4)
    kp = cuda_shear.build_sharded_kernel_plan(_port(op), 4)
    assert kp.sb == 25
    frames = _frames(4, (2, H, W))
    res = _run(pools, ranks.ell_kernel_vs_unsharded, (1, 4), frames,
               _tables(op))
    np.testing.assert_allclose(res[0]["out"], _ref(op, frames), atol=ATOL)
    assert all(r["cmp"]["equal"] for r in res)


# ---------------------------------------------------------------------------
# the planner's rejections and the route choice
# ---------------------------------------------------------------------------


def _wide_window_op():
    # a 20x downscale at 30 degrees: the sheared window is 26 x 20 cells,
    # above build_shear_plan's max_window of 24
    return ell_operator(aa.make_grid_spec((64, 64), 20.0, 1.0,
                                          (32.0, 32.0), 30.0))


def _past_the_ring_op():
    # a 4-row image at 4x downscale: windows of 9 rows over blocks of 1
    return _op(4, 64, 10.0, res_dst=0.25)


@pytest.mark.parametrize("case, n, match", (
    ("indivisible", 4, "divisible"), ("ring", 4, "ring hops"),
    ("window", 4, "too large")))
def test_planner_rejects(case, n, match):
    jop = {"indivisible": lambda: _op(130, 64, 8.0),
           "ring": _past_the_ring_op, "window": _wide_window_op}[case]()
    op = _port(jop)
    for _ in range(2):                      # the second from the cache
        with pytest.raises(ValueError, match=match):
            cuda_shear.build_sharded_kernel_plan(op, n)
    with pytest.raises(ValueError):
        j_pallas_shear.build_sharded_kernel_plan(jop, n)


def test_rank_rows_check_catches_a_short_halo():
    # without a halo the ranks' live taps leave their blocks
    op = _port(_op(128, 64, 8.0))
    kp = cuda_shear.build_sharded_kernel_plan(op, 4)
    cuda_shear.check_rank_blocks(op, kp.plan, 4, kp.halo)
    with pytest.raises(ValueError, match="outside"):
        cuda_shear.check_rank_blocks(op, kp.plan, 4, 0)


def test_auto_falls_back_to_gather_with_a_warning(pools):
    op = _port(_wide_window_op())
    before = t_api.SHEAR_PLAN_FALLBACKS
    # the route a CUDA tensor would take, decided before any launch
    with pytest.warns(RuntimeWarning, match="gather"):
        assert t_sharding._ell_route(op, 4, "auto", True) == ("gather", None)
    assert t_api.SHEAR_PLAN_FALLBACKS == before + 1
    with pytest.raises(ValueError, match="too large"):
        t_sharding._ell_route(op, 4, "kernel", True)
    # the CPU auto route needs no plan: gather, no warning
    assert t_sharding._ell_route(op, 4, "auto", False) == ("gather", None)
    assert t_api.SHEAR_PLAN_FALLBACKS == before + 1
    jop = _wide_window_op()
    frames = _frames(5, (2, 64, 64))
    res = _run(pools, ranks.ell, (1, 4), frames, _tables(jop))
    np.testing.assert_allclose(res[0]["out"], _ref(jop, frames), atol=ATOL)


@pytest.mark.parametrize("case, match", (
    ("kernel_on_cpu", "CUDA tensor"), ("unknown_impl", "unknown impl"),
    ("indivisible", "divisible"), ("ring", "ring hops")))
def test_guards_on_ranks(pools, case, match):
    jop = {"indivisible": lambda: _op(130, 64, 8.0),
           "ring": _past_the_ring_op}.get(case, lambda: _op(128, 64, 8.0))()
    impl = {"kernel_on_cpu": "kernel", "unknown_impl": "pallas"}.get(
        case, "auto")
    H, W = jop.spec.src_shape
    frames = _frames(6, (2, H, W))
    if case in ("indivisible", "ring"):
        mesh = _jmesh(2, 4)
        with pytest.raises(ValueError, match=match):
            jax.jit(lambda f: j_sharding.sharded_apply_ell(
                f, jop, mesh, impl="xla"))(_put(frames, mesh))
    res = _run(pools, ranks.ell, (2, 4), frames, _tables(jop), impl)
    assert all(match in r["error"] for r in res), res[0]


# ---------------------------------------------------------------------------
# conservation flux
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("angle", (8.0, 121.5))
def test_ell_flux_factors_equal_jax(angle):
    jop = _op(128, 96, angle)
    for got, want in zip(t_conserve.ell_flux_factors(_port(jop)),
                         j_conserve.ell_flux_factors(jop)):
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, want)


def _check_flux(flux, jflux, frames, factors_src):
    fd, fs = flux
    assert fd > 0
    np.testing.assert_allclose(fd, fs, rtol=RTOL_FLUX)
    np.testing.assert_allclose(flux, np.asarray(jflux), rtol=RTOL_FLUX)
    host = float(np.einsum("byx,yx->", frames.astype(np.float64),
                           factors_src))
    np.testing.assert_allclose(fs, host, rtol=RTOL_FLUX)


@pytest.mark.parametrize("angle", (8.0, 93.5))
def test_flux_matches_jax(pools, angle):
    # 93.5 deg: quadrant 1, folded; the flux pairs the folded operator's
    # factors with the un-rotated frames
    B, H, W = 2, 128, 64
    frames = _frames(7, (B, H, W))
    op = _op(H, W, angle)
    jout, jflux = _jax_ell(frames, op, (2, 4), impl="xla", conserve=True)
    res = _run(pools, ranks.ell, (2, 4), frames, _tables(op), "auto", True)
    plain = _run(pools, ranks.ell, (2, 4), frames, _tables(op))
    np.testing.assert_allclose(res[0]["out"], np.asarray(jout), atol=ATOL)
    fold = t_weights.fold_quadrant_ell(_port(op))
    src_op = _port(op) if fold is None else fold[0]
    _check_flux(res[0]["flux"], jflux, frames,
                t_conserve.ell_flux_factors(src_op)[1])
    for r, p in zip(res, plain):
        np.testing.assert_array_equal(r["flux"], res[0]["flux"])
        # conserve adds exactly one all_reduce of the 16-byte pair
        assert r["traffic"]["all_reduce"] == 16
        assert p["traffic"]["all_reduce"] == 0
        assert r["traffic"]["p2p"] == p["traffic"]["p2p"]


def test_flux_on_the_kernel_route(pools):
    B, H, W = 2, 128, 64
    frames = _frames(8, (B, H, W))
    op = _op(H, W, 8.0)
    mesh = _jmesh(2, 4)
    _, jflux = jax.jit(lambda f: j_sharding.sharded_apply_ell(
        f, op, mesh, interpret=True, conserve=True))(_put(frames, mesh))
    res = _run(pools, ranks.ell_kernel_vs_unsharded, (2, 4), frames,
               _tables(op))
    _check_flux(res[0]["flux"], jflux, frames,
                t_conserve.ell_flux_factors(_port(op))[1])


def test_flux_catches_corruption(pools):
    frames = _frames(9, (2, 128, 64))
    op = _op(128, 64, 8.0)
    res = _run(pools, ranks.ell_corrupted_flux, (2, 4), frames, _tables(op))
    (gd, gs), (bd, bs) = res[0]
    np.testing.assert_allclose(gd, gs, rtol=RTOL_FLUX)
    assert abs(bd - bs) / abs(bs) > 1e-3


# ---------------------------------------------------------------------------
# quadrant folds and explicit tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("angle", (121.5, 211.5, 301.5))
def test_folds_match_jax_with_flux(pools, angle):
    H, W = 128, 96
    op = _op(H, W, angle)
    assert op.spec.quadrant in (1, 2, 3)
    frames = _frames(10, (2, H, W))
    ref = _ref(op, frames)
    _, jflux = _jax_ell(frames, op, (2, 4), impl="xla", conserve=True)
    res = _run(pools, ranks.ell, (2, 4), frames, _tables(op), "auto", True)
    np.testing.assert_allclose(res[0]["out"], ref, atol=ATOL)
    fd, fs = res[0]["flux"]
    np.testing.assert_allclose(fd, fs, rtol=RTOL_FLUX)
    np.testing.assert_allclose(res[0]["flux"], np.asarray(jflux),
                               rtol=RTOL_FLUX)
    # no source-sized collective: the halo and the dst's all-gather
    assert res[0]["traffic"]["all_gather"] <= frames.nbytes // 8
    kres = _run(pools, ranks.ell_kernel_vs_unsharded, (2, 4), frames,
                _tables(op))
    np.testing.assert_allclose(kres[0]["out"], ref, atol=ATOL)
    assert all(r["cmp"]["equal"] for r in kres)


def test_indivisible_fold_falls_back_to_rot90(pools):
    # quadrant 1 on 100 x 128: the folded dst rows (55) do not divide 4,
    # the rot90 ones (68, over 128 source rows) do
    H, W = 100, 128
    op = _op(H, W, 94.5)
    folded, _ = t_weights.fold_quadrant_ell(_port(op))
    assert folded.spec.dst_shape[0] % 4 and op.spec.dst_shape[0] % 4 == 0
    frames = _frames(11, (2, H, W))
    ref = np.asarray(_jax_ell(frames, op, (2, 4), impl="xla"))
    np.testing.assert_allclose(ref, _ref(op, frames), atol=ATOL)
    for kernel in (False, True):
        res = _run(pools, ranks.ell, (2, 4), frames, _tables(op), "auto",
                   False, kernel)
        np.testing.assert_allclose(res[0]["out"], ref, atol=ATOL)
        # the route gathers the whole source: (4 - 1) ranks' blocks arrive
        assert res[0]["traffic"]["all_gather"] >= frames.nbytes // 8


def test_explicit_tables_quadrant_conserve(pools):
    # JAX's explicit-tables case: float32 tables as arguments, folded
    # with the quadrant, with the flux
    spec = aa.make_grid_spec((128, 96), 1.0, 0.5, (48.0, 64.0), 121.5)
    op = ell_operator(spec, mode="exact")
    frames = _frames(12, (2, 128, 96))
    mesh = _jmesh(2, 4)
    jout, jflux = jax.jit(lambda f, b, w: j_sharding.sharded_apply_ell(
        f, op, mesh, impl="xla", base=b, weights=w, conserve=True))(
        _put(frames, mesh), jnp.asarray(op.base),
        jnp.asarray(op.weights, jnp.float32))
    own = _run(pools, ranks.ell, (2, 4), frames, _tables(op), "auto", True)
    res = _run(pools, ranks.ell, (2, 4), frames, _tables(op), "auto", True,
               False, "float32")
    np.testing.assert_allclose(res[0]["out"], np.asarray(jout), atol=ATOL)
    np.testing.assert_array_equal(res[0]["out"], own[0]["out"])
    np.testing.assert_allclose(res[0]["flux"], np.asarray(jflux),
                               rtol=RTOL_FLUX)
    fd, fs = res[0]["flux"]
    np.testing.assert_allclose(fd, fs, rtol=RTOL_FLUX)
    # the kernel route plans from the explicit tables: float32 weights
    # give the same float32 plan, float64 the operator's own
    kown = _run(pools, ranks.ell, (2, 4), frames, _tables(op), "auto",
                False, True)
    for dtype in ("float32", "float64"):
        kres = _run(pools, ranks.ell, (2, 4), frames, _tables(op), "auto",
                    False, True, dtype)
        np.testing.assert_array_equal(kres[0]["out"], kown[0]["out"])
    np.testing.assert_allclose(kown[0]["out"], np.asarray(jout), atol=ATOL)


def test_explicit_tables_are_the_ones_applied(pools):
    # other tables than the operator's: the output follows them on both
    # routes (weights scaled by 2 double the output)
    H, W = 128, 96
    op = _op(H, W, 121.5)
    frames = _frames(13, (2, H, W))
    doubled = dict(_tables(op), weights=2.0 * np.asarray(op.weights))
    for kernel in (False, True):
        res = _run(pools, ranks.ell_tables_of, (2, 4), frames, _tables(op),
                   doubled, kernel)
        np.testing.assert_allclose(res[0]["out"], 2.0 * _ref(op, frames),
                                   atol=2 * ATOL)


@pytest.mark.parametrize("angle", (30.0, 95.0, 200.0, 301.5))
def test_fold_tables_device_matches_host_fold(angle):
    jop = ell_operator(aa.make_grid_spec((48, 40), 1.0, 0.5, (20.0, 24.0),
                                         angle), mode="exact")
    op = _port(jop)
    base = torch.as_tensor(op.base)
    w = torch.as_tensor(op.weights, dtype=torch.float32)
    nb, nw = t_weights.fold_tables_device(base, w, op.spec.quadrant,
                                          *op.spec.qrot_shape)
    if op.spec.quadrant == 0:
        assert nb is base and nw is w
        return
    fop = t_weights.fold_quadrant_ell(op)[0]
    assert torch.equal(nb, torch.as_tensor(fop.base))
    assert torch.equal(nw, torch.as_tensor(fop.weights.astype(np.float32)))
    jb, jw = j_fold_tables_device(jnp.asarray(jop.base),
                                  jnp.asarray(jop.weights, jnp.float32),
                                  jop.spec.quadrant, *jop.spec.qrot_shape)
    np.testing.assert_array_equal(nb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(nw.numpy(), np.asarray(jw))


def test_ell_ranks_load_no_jax(pools):
    # the ranks ran every case of this file above: none imported JAX
    for world, shape in ((4, (1, 4)), (8, (2, 4))):
        assert pools(world).run(ranks.loaded_modules, shape) == [[]] * world
