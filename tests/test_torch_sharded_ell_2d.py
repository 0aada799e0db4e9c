"""The port's 2-D (rows x cols) sharded rotated (ELL) apply, its
conservation flux, its rank plans and the fold of explicit tables
(``aainterp_torch.parallel.sharding.sharded_apply_ell_2d``,
``sharded_apply_ell_2d_kernel``, ``ops.cuda_shear.
build_sharded_kernel_plan_2d`` / ``Sharded2DKernelPlan.rank``,
``check_rank_blocks``, ``parallel.conserve.sharded_flux_ell_2d``) against
the JAX package's 2-D functions on the 8-device virtual CPU mesh
(tests/conftest.py).

The port's ranks are gloo processes on the CPU, one torch thread each,
started once for the module (``RankPool``, 4 and 8 ranks); their side of
each case is in tests/torch_dist_ranks.py, which imports no jax.  On the
CPU the kernel route's wrappers take their plain versions, on each rank's
plan.  Inputs are made from numpy seeds and the operators go to the port
through ``convert.ell_operator_from_numpy``.  Tolerances: float32 atol
1e-5, flux rtol 1e-5, and ``torch.equal`` / ``np.array_equal`` where a
case says so (the kernel route against the unsharded kernel route: its
plain stages gather and sum each pixel's taps in one order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aainterp as aa
from aainterp.ops import pallas_shear as j_pallas_shear
from aainterp.ops.weights import ell_operator
from aainterp.parallel import sharding as j_sharding

import torch_dist_ranks as ranks
from aainterp_torch import api as t_api
from aainterp_torch.ops import cuda_shear
from aainterp_torch.ops import weights as t_weights
from aainterp_torch.parallel import conserve as t_conserve
from aainterp_torch.parallel import sharding as t_sharding
from test_torch_sharded import _run, plan_cache_dir, pools  # noqa: F401
from test_torch_sharded_2d import _jmesh3, _put3
from test_torch_sharded_ell import _frames, _op, _port, _ref, _tables

pytestmark = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs 8 (virtual) devices")

ATOL = 1e-5
RTOL_FLUX = 1e-5
# JAX's 2-D geometry: 14 degrees, dst 74 x 62 over a 128 x 96 source
H14, W14, ISO14 = 128, 96, (48.0, 64.0)


def _op14(angle=14.0):
    return _op(H14, W14, angle, ISO14)


def _jax_ell_2d(frames, op, mesh_shape, **kw):
    mesh = _jmesh3(*mesh_shape)
    return jax.jit(lambda f: j_sharding.sharded_apply_ell_2d(
        f, op, mesh, **kw))(_put3(frames, mesh))


# ---------------------------------------------------------------------------
# both routes against JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh_shape", ((2, 2, 2), (1, 2, 2)))
def test_gather_route_matches_jax(pools, mesh_shape):
    B = 4
    frames = _frames(0, (B, H14, W14))
    op = _op14()
    ref = np.asarray(_jax_ell_2d(frames, op, mesh_shape, impl="xla"))
    res = _run(pools, ranks.ell, mesh_shape, frames, _tables(op))
    np.testing.assert_allclose(res[0]["out"], ref, atol=ATOL)
    np.testing.assert_allclose(res[0]["out"], _ref(op, frames), atol=ATOL)
    assert res[0]["dtype"] == "torch.float32"
    n_data, n_r, n_c = mesh_shape
    b, rows, cols = B // n_data, ref.shape[1] // n_r, ref.shape[2] // n_c
    for rank, r in enumerate(res):
        d, rest = divmod(rank, n_r * n_c)
        i, j = divmod(rest, n_c)
        np.testing.assert_array_equal(
            r["local"], res[0]["out"][d * b:(d + 1) * b,
                                      i * rows:(i + 1) * rows,
                                      j * cols:(j + 1) * cols])
        assert r["traffic"]["all_reduce"] == 0
        assert r["traffic"]["all_gather"] == 0


def test_kernel_route_matches_jax_pallas_and_unsharded(pools):
    # JAX's per-chip three-kernel route in interpret mode against the
    # port's rank plans (the plain stages on CPU tensors), and the port's
    # sharded kernel route bit-equal to its unsharded one
    frames = _frames(1, (2, H14, W14))
    op = _op14()
    jout = np.asarray(_jax_ell_2d(frames, op, (2, 2, 2), impl="pallas",
                                  interpret=True))
    res = _run(pools, ranks.ell_kernel_vs_unsharded, (2, 2, 2), frames,
               _tables(op))
    np.testing.assert_allclose(res[0]["out"], jout, atol=ATOL)
    for r in res:
        assert r["cmp"]["equal"], r["cmp"]
        assert set(r["launches"].values()) == {0}
        assert not r["folded"]


def test_steeper_angle_multi_hop(pools):
    # 31 degrees over a (1, 2, 4) mesh: the halos grow with W sin(angle)
    # and the column halo takes two hops over blocks of 32
    H = W = 128
    op = _op(H, W, 31.0, (64.0, 64.0))
    assert op.spec.dst_shape[0] % 2 == 0 and op.spec.dst_shape[1] % 4 == 0
    kp = cuda_shear.build_sharded_kernel_plan_2d(_port(op), 2, 4)
    assert -(-kp.halo_x // kp.sb_c) >= 2, (kp.halo_x, kp.sb_c)
    halo_y, halo_x = j_sharding._ell_halo_2d(op, 2, 4)[:2]
    assert (kp.halo_y, kp.halo_x) == (halo_y, halo_x)
    frames = _frames(2, (1, H, W))
    ref = np.asarray(_jax_ell_2d(frames, op, (1, 2, 4), impl="xla"))
    for kernel in (False, True):
        res = _run(pools, ranks.ell, (1, 2, 4), frames, _tables(op), "auto",
                   False, kernel)
        np.testing.assert_allclose(res[0]["out"], ref, atol=ATOL)
    kres = _run(pools, ranks.ell_kernel_vs_unsharded, (1, 2, 4), frames,
                _tables(op))
    assert all(r["cmp"]["equal"] for r in kres)


@pytest.mark.parametrize("angle", (121.5, 211.5, 301.5))
def test_folds_match_jax_with_flux(pools, angle):
    op = _op14(angle)
    assert op.spec.quadrant in (1, 2, 3)
    frames = _frames(3, (2, H14, W14))
    ref = _ref(op, frames)
    _, jflux = _jax_ell_2d(frames, op, (2, 2, 2), impl="xla", conserve=True)
    res = _run(pools, ranks.ell, (2, 2, 2), frames, _tables(op), "auto",
               True)
    np.testing.assert_allclose(res[0]["out"], ref, atol=ATOL)
    fd, fs = res[0]["flux"]
    np.testing.assert_allclose(fd, fs, rtol=RTOL_FLUX)
    np.testing.assert_allclose(res[0]["flux"], np.asarray(jflux),
                               rtol=RTOL_FLUX)
    # no source-sized collective: the halos and the dst's all-gather
    # (a rank's dst block over the cols group, then its row of blocks
    # over the rows group: less than its batch's whole dst)
    dst_bytes = 1 * op.spec.dst_shape[0] * op.spec.dst_shape[1] * 4
    assert res[0]["traffic"]["all_gather"] <= dst_bytes < frames.nbytes // 2
    kres = _run(pools, ranks.ell_kernel_vs_unsharded, (2, 2, 2), frames,
                _tables(op))
    np.testing.assert_allclose(kres[0]["out"], ref, atol=ATOL)
    assert all(r["cmp"]["equal"] and r["folded"] for r in kres)


def test_indivisible_fold_falls_back_to_rot90(pools):
    # quadrant 1 on 96 x 128 over (1, 2, 4): the folded dst (56 x 70)
    # does not divide 4 columns, the rot90 route's (70 x 56, over a 128 x
    # 96 source) does
    H, W = 96, 128
    op = _op(H, W, 98.0)
    folded, _ = t_weights.fold_quadrant_ell(_port(op))
    assert folded.spec.dst_shape[1] % 4 and op.spec.dst_shape == (70, 56)
    frames = _frames(4, (2, H, W))
    ref = np.asarray(_jax_ell_2d(frames, op, (1, 2, 4), impl="xla"))
    np.testing.assert_allclose(ref, _ref(op, frames), atol=ATOL)
    for kernel in (False, True):
        res = _run(pools, ranks.ell, (1, 2, 4), frames, _tables(op), "auto",
                   False, kernel)
        np.testing.assert_allclose(res[0]["out"], ref, atol=ATOL)
        # the route gathers the whole source: a rank's row of blocks over
        # the cols group, then the rows over the rows group
        assert res[0]["traffic"]["all_gather"] >= frames.nbytes // 2
    kres = _run(pools, ranks.ell_kernel_vs_unsharded, (1, 2, 4), frames,
                _tables(op))
    assert all(r["cmp"]["equal"] and not r["folded"] for r in kres)


# ---------------------------------------------------------------------------
# conservation flux
# ---------------------------------------------------------------------------


def test_flux_on_both_routes(pools):
    frames = _frames(5, (2, H14, W14))
    op = _op14()
    _, jflux = _jax_ell_2d(frames, op, (2, 2, 2), impl="xla", conserve=True)
    res = _run(pools, ranks.ell, (2, 2, 2), frames, _tables(op), "auto",
               True)
    plain = _run(pools, ranks.ell, (2, 2, 2), frames, _tables(op))
    kres = _run(pools, ranks.ell_kernel_vs_unsharded, (2, 2, 2), frames,
                _tables(op))
    host = float(np.einsum("byx,yx->", frames.astype(np.float64),
                           t_conserve.ell_flux_factors(_port(op))[1]))
    for flux in (res[0]["flux"], kres[0]["flux"]):
        fd, fs = flux
        np.testing.assert_allclose(fd, fs, rtol=RTOL_FLUX)
        np.testing.assert_allclose(flux, np.asarray(jflux), rtol=RTOL_FLUX)
        np.testing.assert_allclose(fs, host, rtol=RTOL_FLUX)
    for r, p in zip(res, plain):
        np.testing.assert_array_equal(r["flux"], res[0]["flux"])
        # conserve adds exactly one all_reduce of the 16-byte pair
        assert r["traffic"]["all_reduce"] == 16
        assert p["traffic"]["all_reduce"] == 0
        assert r["traffic"]["p2p"] == p["traffic"]["p2p"]


def test_flux_catches_corruption(pools):
    frames = _frames(6, (2, H14, W14))
    res = _run(pools, ranks.ell_corrupted_flux, (2, 2, 2), frames,
               _tables(_op14()))
    (gd, gs), (bd, bs) = res[0]
    np.testing.assert_allclose(gd, gs, rtol=RTOL_FLUX)
    assert abs(bd - bs) / abs(bs) > 1e-3


# ---------------------------------------------------------------------------
# explicit tables
# ---------------------------------------------------------------------------


def test_explicit_tables_quadrant_conserve(pools):
    # float32 tables as arguments, folded with the quadrant, with the
    # flux; on the kernel route too, where JAX's 2-D Pallas route drops
    # them (sharding.py:1664-1696)
    op = _op14(121.5)
    frames = _frames(7, (2, H14, W14))
    mesh = _jmesh3(2, 2, 2)
    jout, jflux = jax.jit(lambda f, b, w: j_sharding.sharded_apply_ell_2d(
        f, op, mesh, impl="xla", base=b, weights=w, conserve=True))(
        _put3(frames, mesh), jnp.asarray(op.base),
        jnp.asarray(op.weights, jnp.float32))
    own = _run(pools, ranks.ell, (2, 2, 2), frames, _tables(op), "auto",
               True)
    res = _run(pools, ranks.ell, (2, 2, 2), frames, _tables(op), "auto",
               True, False, "float32")
    np.testing.assert_allclose(res[0]["out"], np.asarray(jout), atol=ATOL)
    np.testing.assert_array_equal(res[0]["out"], own[0]["out"])
    np.testing.assert_allclose(res[0]["flux"], np.asarray(jflux),
                               rtol=RTOL_FLUX)
    kown = _run(pools, ranks.ell, (2, 2, 2), frames, _tables(op), "auto",
                False, True)
    for dtype in ("float32", "float64"):
        kres = _run(pools, ranks.ell, (2, 2, 2), frames, _tables(op),
                    "auto", False, True, dtype)
        np.testing.assert_array_equal(kres[0]["out"], kown[0]["out"])
    np.testing.assert_allclose(kown[0]["out"], np.asarray(jout), atol=ATOL)


def test_explicit_tables_are_the_ones_applied(pools):
    # other tables than the operator's: the output follows them on both
    # routes (weights scaled by 2 double the output)
    op = _op14(121.5)
    frames = _frames(8, (2, H14, W14))
    doubled = dict(_tables(op), weights=2.0 * np.asarray(op.weights))
    for kernel in (False, True):
        res = _run(pools, ranks.ell_tables_of, (2, 2, 2), frames,
                   _tables(op), doubled, kernel)
        np.testing.assert_allclose(res[0]["out"], 2.0 * _ref(op, frames),
                                   atol=2 * ATOL)


# ---------------------------------------------------------------------------
# the rank plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("angle, n_r, n_c", ((14.0, 2, 2), (31.0, 2, 4),
                                             (121.5, 2, 2)))
def test_rank_plans_are_the_global_plan_shifted(angle, n_r, n_c):
    if angle == 31.0:
        jop = _op(128, 128, angle, (64.0, 64.0))
    else:
        jop = _op14(angle)
    op = _port(jop)
    if op.spec.quadrant:
        op = t_weights.fold_quadrant_ell(op)[0]
    kp = cuda_shear.build_sharded_kernel_plan_2d(op, n_r, n_c)
    g = kp.plan
    assert cuda_shear.build_sharded_kernel_plan_2d(op, n_r, n_c) is kp
    # JAX's exact halos (its kernel plan rounds the rows up to 8)
    assert (kp.halo_y, kp.halo_x) == j_sharding._ell_halo_2d(op, n_r,
                                                             n_c)[:2]
    rng = np.random.default_rng(9)
    q = torch.as_tensor(rng.uniform(0, 1, (1,) + op.spec.qrot_shape)
                        .astype(np.float32))
    T = cuda_shear.vhshear_plain(q, g)[0]
    padded = torch.nn.functional.pad(q, (kp.halo_x, kp.halo_x, kp.halo_y,
                                         kp.halo_y))
    for i in range(n_r):
        for j in range(n_c):
            p = kp.rank(i, j)
            off_i, off_j = i * kp.sb_r - kp.halo_y, j * kp.sb_c - kp.halo_x
            rows = slice(i * kp.db_r, (i + 1) * kp.db_r)
            cols = slice(j * kp.db_c, (j + 1) * kp.db_c)
            assert (p.qH, p.qW, p.Hd, p.Wd, p.Ka, p.Kb) == (
                kp.Hloc, kp.Wloc, kp.db_r, kp.db_c, g.Ka, g.Kb)
            np.testing.assert_array_equal(p.ry0, g.ry0[rows] - off_i)
            np.testing.assert_array_equal(p.cx0, g.cx0[cols] - off_j)
            np.testing.assert_array_equal(p.w2, g.w2[:, rows, cols])
            np.testing.assert_array_equal(p.span, cuda_shear.live_spans(p.w2))
            assert p.TH == kp.Hloc + int(p.gy.max()) + 1
            assert p.TW >= kp.Wloc + int(p.hx.max()) + 1
            # every live tap reads a T pixel of the local plane, and the
            # value the global T holds there
            ext = padded[:, off_i + kp.halo_y:off_i + kp.halo_y + kp.Hloc,
                         off_j + kp.halo_x:off_j + kp.halo_x + kp.Wloc]
            Tl = cuda_shear.vhshear_plain(ext.contiguous(), p)[0]
            for t in range(p.Ka * p.Kb):
                dy, dx = np.nonzero(p.w2[t])
                y = p.ry0[dy] + t // p.Kb
                x = p.cx0[dx] + t % p.Kb
                assert ((y >= 0) & (y < p.TH) & (x >= 0) & (x < p.TW)).all()
                assert torch.equal(Tl[y, x], T[y + off_i, x + off_j])


def test_one_column_rank_plan_is_the_row_plan():
    # an n_c = 1 2-D plan: rank (i, 0) is the row-sharded plan's rank(i)
    # where the column halo is 0; T's width is the block's own (the
    # global T's columns past it are zero), and the route's output is
    # the same
    op = _port(_op(128, 64, 8.0))
    kp2 = cuda_shear.build_sharded_kernel_plan_2d(op, 4, 1)
    kp1 = cuda_shear.build_sharded_kernel_plan(op, 4)
    assert (kp2.halo_y, kp2.halo_x, kp2.Hloc) == (kp1.halo, 0, kp1.Hloc)
    rng = np.random.default_rng(10)
    for i in range(4):
        p2, p1 = kp2.rank(i, 0), kp1.rank(i)
        for k in ("qH", "qW", "TH", "Hd", "Wd", "Ka", "Kb"):
            assert getattr(p2, k) == getattr(p1, k), k
        for k in ("gy", "hx", "ry0", "cx0", "w2", "span"):
            np.testing.assert_array_equal(getattr(p2, k), getattr(p1, k))
        assert p2.TW <= p1.TW
        q = torch.as_tensor(rng.uniform(0, 1, (2, p1.qH, p1.qW))
                            .astype(np.float32))
        t1 = cuda_shear.vhshear_plain(q, p1)
        assert torch.equal(cuda_shear.vhshear_plain(q, p2), t1[..., :p2.TW])
        assert not t1[..., p2.TW:].any()
        assert torch.equal(cuda_shear.apply_ell_shear_kernel(q, p2),
                           cuda_shear.apply_ell_shear_kernel(q, p1))


def _wide_window_op():
    # a 20x downscale at 30 degrees: the sheared window is 26 x 20 cells,
    # above build_shear_plan's max_window of 24
    return ell_operator(aa.make_grid_spec((64, 64), 20.0, 1.0,
                                          (32.0, 32.0), 30.0))


@pytest.mark.parametrize("case, match", (
    ("cols", "divisible"), ("ring", "ring hops"), ("window", "too large")))
def test_planner_rejects(case, match):
    # "cols": 62 dst columns over 4; "ring": a 4-row image at 4x
    # downscale, windows of 9 rows over blocks of 1
    jop = {"cols": lambda: _op14(),
           "ring": lambda: _op(4, 64, 10.0, res_dst=0.25),
           "window": _wide_window_op}[case]()
    n_r, n_c = {"cols": (2, 4), "ring": (4, 1), "window": (2, 2)}[case]
    op = _port(jop)
    for _ in range(2):                      # the second from the cache
        with pytest.raises(ValueError, match=match):
            cuda_shear.build_sharded_kernel_plan_2d(op, n_r, n_c)
    with pytest.raises(ValueError):
        j_pallas_shear.build_sharded_kernel_plan_2d(jop, n_r, n_c)


def test_block_check_catches_short_halos():
    op = _port(_op14())
    kp = cuda_shear.build_sharded_kernel_plan_2d(op, 2, 2)
    cuda_shear.check_rank_blocks(op, kp.plan, 2, kp.halo_y, 2, kp.halo_x)
    with pytest.raises(ValueError, match="columns outside"):
        cuda_shear.check_rank_blocks(op, kp.plan, 2, kp.halo_y, 2, 0)
    with pytest.raises(ValueError, match="rows outside"):
        cuda_shear.check_rank_blocks(op, kp.plan, 2, 0, 2, kp.halo_x)


def test_auto_falls_back_to_gather_with_a_warning(pools):
    op = _port(_wide_window_op())
    before = t_api.SHEAR_PLAN_FALLBACKS
    # the route a CUDA tensor would take, decided before any launch
    with pytest.warns(RuntimeWarning, match="gather"):
        assert t_sharding._ell_route(op, 2, "auto", True, 2) == (
            "gather", None)
    assert t_api.SHEAR_PLAN_FALLBACKS == before + 1
    with pytest.raises(ValueError, match="too large"):
        t_sharding._ell_route(op, 2, "kernel", True, 2)
    assert t_sharding._ell_route(op, 2, "auto", False, 2) == ("gather", None)
    assert t_api.SHEAR_PLAN_FALLBACKS == before + 1
    jop = _wide_window_op()
    frames = _frames(11, (2, 64, 64))
    res = _run(pools, ranks.ell, (1, 2, 2), frames, _tables(jop))
    np.testing.assert_allclose(res[0]["out"], _ref(jop, frames), atol=ATOL)


@pytest.mark.parametrize("case, match", (
    ("kernel_on_cpu", "CUDA tensor"), ("unknown_impl", "unknown impl"),
    ("cols", "divisible")))
def test_guards_on_ranks(pools, case, match):
    impl = {"kernel_on_cpu": "kernel", "unknown_impl": "xla"}.get(case,
                                                                  "auto")
    frames = _frames(12, (2, H14, W14))
    res = _run(pools, ranks.ell, (1, 2, 4), frames, _tables(_op14()), impl)
    assert all(match in r["error"] for r in res), res[0]


# ---------------------------------------------------------------------------
# collectives, no JAX on the ranks
# ---------------------------------------------------------------------------


def test_collectives_are_halos_and_the_flux_pair(pools):
    # quadrant 0: point-to-point halos only, no send above one block (a
    # multi-hop halo sends whole blocks); conserve adds one 16-byte
    # all_reduce
    frames = _frames(13, (2, H14, W14))
    op = _op14()
    plain = pools(8).run(ranks.collective_sizes, (2, 2, 2), "ell", frames,
                         _tables(op))
    cons = pools(8).run(ranks.collective_sizes, (2, 2, 2), "ell", frames,
                        _tables(op), True)
    for p, c in zip(plain, cons):
        assert p["sizes"]["all_gather"] == [] == p["sizes"]["all_reduce"]
        assert p["sizes"]["p2p"] and max(p["sizes"]["p2p"]) <= p["block"]
        assert c["sizes"]["all_reduce"] == [16]
        assert c["sizes"]["p2p"] == p["sizes"]["p2p"]


def test_ell_2d_ranks_load_no_jax(pools):
    for world, shape in ((4, (1, 2, 2)), (8, (2, 2, 2))):
        assert pools(world).run(ranks.loaded_modules, shape) == [[]] * world
