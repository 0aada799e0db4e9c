"""The port's row-sharded separable apply, its conservation flux and the
sharded regrid (``aainterp_torch.parallel``, ``regrid.
conservative_regrid_sharded``) against the JAX package's sharded
functions on the 8-device virtual CPU mesh (tests/conftest.py).

The port's ranks are gloo processes on the CPU, one torch thread each,
started once for the module (``RankPool``, 4 and 8 ranks); their side of
each case is in tests/torch_dist_ranks.py, which imports no jax.  Inputs
are made from numpy seeds and the operators go to the port through
``convert.operator_from_numpy``.  Tolerances: float32 atol 1e-5, flux
rtol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import aainterp as aa
from aainterp import regrid as j_regrid
from aainterp.ops.overlap1d import Band1D as JBand
from aainterp.ops.weights import separable_operator, squared_operator
from aainterp.parallel import conserve as j_conserve
from aainterp.parallel import sharding as j_sharding

import torch_dist_ranks as ranks
from aainterp_torch.parallel import mesh as pmesh
from aainterp_torch.parallel import sharding as t_sharding
from aainterp_torch.utils import cache as t_cache

pytestmark = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs 8 (virtual) devices")

MESHES = ((1, 4), (2, 2), (2, 4))
ATOL = 1e-5
RTOL_FLUX = 1e-5


@pytest.fixture(scope="module", autouse=True)
def plan_cache_dir(tmp_path_factory):
    """The rotated kernel route's shear plans (``kernel_plan_cached``) go
    to a directory of the module's own, in this process and in the ranks,
    which read ``AAINTERP_CACHE_DIR`` when they start (after this
    fixture: autouse fixtures of a scope come first)."""
    path = str(tmp_path_factory.mktemp("plans"))
    mp = pytest.MonkeyPatch()
    mp.setenv("AAINTERP_CACHE_DIR", path)
    mp.setattr(t_cache, "DEFAULT_CACHE_DIR", path)
    yield path
    mp.undo()


@pytest.fixture(scope="module")
def pools():
    """Gloo rank pools on the CPU, by world size, started at first use."""
    live = {}

    def get(world):
        if world not in live:
            live[world] = pmesh.RankPool(world, backend="gloo", device="cpu",
                                         threads=1, timeout=300.0)
        return live[world]

    yield get
    for pool in live.values():
        pool.close()


def _run(pools, fn, mesh_shape, *args):
    """Every rank's result; every rank gathered the same output."""
    res = pools(int(np.prod(mesh_shape))).run(fn, mesh_shape, *args)
    for r in res[1:]:
        if isinstance(r, dict) and "out" in r:
            np.testing.assert_array_equal(r["out"], res[0]["out"])
    return res


def _jmesh(data, rows):
    devs = np.asarray(jax.devices()[: data * rows]).reshape(data, rows)
    return Mesh(devs, ("data", "rows"))


def _put(x, mesh):
    return jax.device_put(jnp.asarray(x),
                          NamedSharding(mesh, P("data", "rows", None)))


def _unpack(b):
    return (np.asarray(b.start), np.asarray(b.weights), b.n_src, b.n_dst)


def _tables(op):
    """A JAX SeparableOperator's tables for convert.operator_from_numpy."""
    return dict(spec_fields=dataclasses.asdict(op.spec), wy=_unpack(op.wy),
                wx=_unpack(op.wx),
                raw_row_sums=tuple(np.asarray(s) for s in op.raw_row_sums),
                mode=op.mode)


def _frames(seed, shape, lo=0.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _op(shape, res_src, res_dst, iso, angle):
    return separable_operator(aa.make_grid_spec(shape, res_src, res_dst,
                                                iso, angle))


def _jax_sharded(frames, op, mesh_shape, **kw):
    mesh = _jmesh(*mesh_shape)
    return jax.jit(lambda f: j_sharding.sharded_apply_separable(
        f, op, mesh, **kw))(_put(frames, mesh))


# ---------------------------------------------------------------------------
# the separable apply
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_sharded_separable_matches_jax(pools, mesh_shape):
    B, H, W = 4, 128, 64
    frames = _frames(0, (B, H, W))
    op = _op((H, W), 2.0, 1.0, (0.0, 0.0), 0.0)
    ref = np.asarray(_jax_sharded(frames, op, mesh_shape))
    res = _run(pools, ranks.separable, mesh_shape, frames, _tables(op))
    np.testing.assert_allclose(res[0]["out"], ref, atol=ATOL)
    n_data, n_rows = mesh_shape
    # each rank holds its (B / n_data, Hd / n_rows, Wd) block
    for rank, r in enumerate(res):
        d, i = divmod(rank, n_rows)
        b, rows = B // n_data, ref.shape[1] // n_rows
        np.testing.assert_array_equal(
            r["local"], res[0]["out"][d * b:(d + 1) * b,
                                      i * rows:(i + 1) * rows])
    # the apply reduces nothing
    assert res[0]["traffic"]["all_reduce"] == 0


def test_sharded_separable_noninteger_ratio(pools):
    B, H, W = 2, 160, 64
    frames = _frames(1, (B, H, W))
    op = _op((H, W), 150.0, 30.0, (0.0, 0.0), 0.0)
    assert op.spec.dst_shape[0] % 4 == 0
    ref = np.asarray(_jax_sharded(frames, op, (2, 4)))
    res = _run(pools, ranks.separable, (2, 4), frames, _tables(op))
    np.testing.assert_allclose(res[0]["out"], ref, atol=ATOL)
    # every rank reads halo rows from a neighbour
    assert all(r["traffic"]["p2p"] > 0 for r in res)


def _full_ring_band(n, k):
    start = np.zeros(n, np.int32)
    weights = np.full((n, k), 1.0 / k, np.float64)
    return start, weights


def test_full_ring_multi_hop_halo(pools):
    """Every dst row reads src rows 0..2: the last rank needs rows 7 hops
    away, the (n - 1)-hop exchange, on the plain and the kernel route."""
    n = 32
    start, weights = _full_ring_band(n, 3)
    jband = JBand(start=start, weights=weights, n_src=n, n_dst=n)
    frames = _frames(2, (1, n, n))
    mesh = _jmesh(1, 8)
    ref = np.asarray(jax.jit(lambda f: j_sharding.sharded_apply_banded(
        f, jband, jband, mesh))(_put(frames, mesh)))
    band = (start, weights, n, n)
    for kernel in (False, True):
        res = _run(pools, ranks.banded, (1, 8), frames, band, band, kernel)
        np.testing.assert_allclose(res[0]["out"], ref, atol=ATOL)
        assert res[0]["dtype"] == "torch.float32"
        # rank 0 sends its 4 rows to each of the 7 ranks behind it
        assert res[0]["traffic"]["p2p"] == 7 * 4 * n * 4


def test_halo_past_the_ring_raises(pools):
    # a band wider than the image: rank 0's taps reach 40 rows, 9 hops
    n = 32
    start, weights = _full_ring_band(n, 40)
    jband = JBand(start=start, weights=weights, n_src=n, n_dst=n)
    frames = _frames(3, (1, n, n))
    mesh = _jmesh(1, 8)
    with pytest.raises(ValueError, match="ring hops"):
        j_sharding.sharded_apply_banded(_put(frames, mesh), jband, jband,
                                        mesh)
    band = (start, weights, n, n)
    res = _run(pools, ranks.banded, (1, 8), frames, band, band)
    assert all("ring hops" in r["error"] for r in res)


def test_sharded_variance_propagation(pools):
    B, H, W = 4, 128, 64
    var = _frames(4, (B, H, W), 0.5, 2.0)
    op = _op((H, W), 2.0, 1.0, (0.0, 0.0), 0.0)
    sq = squared_operator(op)
    ref = np.asarray(_jax_sharded(var, sq, (2, 4)))
    np.testing.assert_allclose(
        ref, np.asarray(aa.propagate_variance(op, jnp.asarray(var))),
        atol=1e-6)
    res = _run(pools, ranks.separable, (2, 4), var, _tables(sq))
    np.testing.assert_allclose(res[0]["out"], ref, atol=ATOL)


# ---------------------------------------------------------------------------
# quadrant folding under sharding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("angle", (90.0, 180.0, 270.0))
def test_folded_quadrant_matches_jax_with_flux(pools, angle):
    H = W = 128
    frames = _frames(5, (2, H, W))
    op = _op((H, W), 2.0, 1.0, (3.0, 5.0), angle)
    assert j_sharding._folded_sharded_bands(op, 4) is not None
    out, flux = _jax_sharded(frames, op, (2, 4), impl="banded",
                             conserve=True)
    res = _run(pools, ranks.separable, (2, 4), frames, _tables(op),
               "banded", True)
    assert res[0]["folded"]
    np.testing.assert_allclose(res[0]["out"], np.asarray(out), atol=ATOL)
    fd, fs = res[0]["flux"]
    np.testing.assert_allclose(fd, fs, rtol=RTOL_FLUX)
    np.testing.assert_allclose(res[0]["flux"], np.asarray(flux),
                               rtol=RTOL_FLUX)
    for r in res[1:]:
        np.testing.assert_array_equal(r["flux"], res[0]["flux"])


def test_indivisible_fold_falls_back_to_rot90(pools):
    # quadrant 1 with H = 100: the folded inner dst rows (50) do not
    # divide 4 ranks, the rot90 ones (64) do
    H, W = 100, 128
    frames = _frames(6, (2, H, W))
    op = _op((H, W), 2.0, 1.0, (0.0, 0.0), 90.0)
    assert op.spec.quadrant == 1
    assert j_sharding._folded_sharded_bands(op, 4) is None
    ref = np.asarray(_jax_sharded(frames, op, (2, 4), impl="banded"))
    res = _run(pools, ranks.separable, (2, 4), frames, _tables(op))
    assert not res[0]["folded"]
    np.testing.assert_allclose(res[0]["out"], ref, atol=ATOL)
    # the route gathers the whole source: (4 - 1) ranks' blocks arrive
    assert res[0]["traffic"]["all_gather"] >= frames.nbytes // 8


def test_folded_dst_rows_that_do_not_divide(pools):
    # quadrant 1 on a 128 x 100 image: the inner bands divide 4 ranks,
    # the final dst rows (50) split as ceil blocks of 13 (the last 11)
    H, W = 128, 100
    frames = _frames(7, (2, H, W))
    op = _op((H, W), 2.0, 1.0, (0.0, 0.0), 90.0)
    assert j_sharding._folded_sharded_bands(op, 4) is not None
    ref = np.asarray(aa.apply_operator(op, jnp.asarray(frames), impl="xla"))
    assert ref.shape[1] % 4 != 0
    res = _run(pools, ranks.separable, (1, 4), frames, _tables(op))
    np.testing.assert_allclose(res[0]["out"], ref, atol=ATOL)
    assert [r["local"].shape[1] for r in res] == [13, 13, 13, 11]


def test_fold_post_inv_inverts_post():
    x = torch.arange(2 * 6 * 5, dtype=torch.float32).reshape(2, 6, 5)
    for angle in (90.0, 180.0, 270.0):
        op = _op((128, 96), 2.0, 1.0, (0.0, 0.0), angle)
        fold = t_sharding._folded_sharded_bands(ranks._op(_tables(op)), 4)
        assert torch.equal(fold["post_inv"](fold["post"](x)), x)


# ---------------------------------------------------------------------------
# conservation flux
# ---------------------------------------------------------------------------


def test_separable_flux(pools):
    B, H, W = 4, 160, 128
    frames = _frames(8, (B, H, W))
    op = _op((H, W), 150.0, 30.0, (0.0, 0.0), 0.0)
    _, jflux = _jax_sharded(frames, op, (2, 4), conserve=True)
    res = _run(pools, ranks.separable, (2, 4), frames, _tables(op), "auto",
               True)
    fd, fs = res[0]["flux"]
    assert fd > 0
    np.testing.assert_allclose(fd, fs, rtol=RTOL_FLUX)
    np.testing.assert_allclose(res[0]["flux"], np.asarray(jflux),
                               rtol=RTOL_FLUX)
    _, _, covy, covx = j_conserve.separable_flux_factors(
        op.wy, op.wx, raw_sums=op.raw_row_sums)
    host_fs = np.einsum("byx,y,x->", frames.astype(np.float64), covy, covx)
    np.testing.assert_allclose(fs, host_fs, rtol=RTOL_FLUX)
    # the flux is one all_reduce of two float64s
    assert all(r["traffic"]["all_reduce"] == 16 for r in res)


def test_separable_flux_catches_corruption(pools):
    B, H, W = 2, 160, 128
    frames = _frames(9, (B, H, W))
    op = _op((H, W), 150.0, 30.0, (0.0, 0.0), 0.0)
    res = _run(pools, ranks.corrupted_flux, (2, 4), frames, _tables(op))
    (gd, gs), (bd, bs) = res[0]
    np.testing.assert_allclose(gd, gs, rtol=RTOL_FLUX)
    assert abs(bd - bs) / abs(bs) > 1e-3


# ---------------------------------------------------------------------------
# uint8 and the guards
# ---------------------------------------------------------------------------


def test_sharded_uint8_quantises(pools):
    # u8 in -> u8 out on the banded route (and through kernel 1's plain
    # version on the CPU), as JAX's banded route quantises: both apply the
    # frames as float32, on the aligned local path for this 2:1 partition
    H, W, B = 128, 96, 2
    frames = np.random.default_rng(10).integers(0, 256, (B, H, W),
                                                dtype=np.uint8)
    op = _op((H, W), 2.0, 1.0, (0.0, 0.0), 0.0)
    jref = np.asarray(_jax_sharded(frames, op, (1, 8), impl="banded"))
    assert jref.dtype == np.uint8
    res = _run(pools, ranks.separable, (1, 8), frames, _tables(op))
    out = res[0]["out"]
    assert out.dtype == np.uint8
    np.testing.assert_array_equal(out, jref)
    y, x = _unpack(op.wy), _unpack(op.wx)
    kres = _run(pools, ranks.banded, (1, 8), frames, y, x, True)
    assert kres[0]["dtype"] == "torch.uint8"
    np.testing.assert_array_equal(kres[0]["out"], out)


def test_sharded_uint8_conserve_raises(pools):
    H, W = 128, 128
    frames = np.random.default_rng(11).integers(0, 256, (2, H, W),
                                                dtype=np.uint8)
    op = _op((H, W), 2.0, 1.0, (0.0, 0.0), 0.0)
    with pytest.raises(ValueError, match="conserve"):
        j_sharding.sharded_apply_separable(jnp.asarray(frames), op,
                                           _jmesh(1, 8), conserve=True)
    res = _run(pools, ranks.separable, (1, 8), frames, _tables(op), "auto",
               True)
    assert all("conserve" in r["error"] for r in res)


def test_nondivisible_rows_raise_value_error(pools):
    H, W = 130, 64                        # src rows 130 % 4 != 0
    frames = _frames(12, (2, H, W))
    op = _op((H, W), 2.0, 1.0, (0.0, 0.0), 0.0)
    with pytest.raises(ValueError, match="divisible"):
        j_sharding.sharded_apply_separable(jnp.asarray(frames), op,
                                           _jmesh(2, 4))
    res = _run(pools, ranks.separable, (2, 4), frames, _tables(op))
    assert all("divisible" in r["error"] for r in res)


def test_impl_kernel_on_cpu_and_unknown_impl_raise(pools):
    frames = _frames(13, (2, 64, 64))
    op = _op((64, 64), 2.0, 1.0, (0.0, 0.0), 0.0)
    for impl, what in (("kernel", "CUDA tensor"), ("pallas", "unknown")):
        res = _run(pools, ranks.separable, (1, 4), frames, _tables(op), impl)
        assert all(what in r["error"] for r in res)


def test_rank_pool_backend_is_the_callers():
    with pytest.raises(ValueError, match="NCCL"):
        pmesh.RankPool(2, backend="nccl", device="cpu")
    with pytest.raises(ValueError, match="backend"):
        pmesh.RankPool(2, backend="mpi", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pmesh.RankPool(2, backend="gloo", device="cuda")


def test_ranks_load_no_jax(pools):
    # the ranks ran every case of this file above: none imported JAX
    for world, shape in ((4, (1, 4)), (8, (1, 8))):
        assert pools(world).run(ranks.loaded_modules, shape) == [[]] * world


def test_run_spmd_returns_each_ranks_result():
    frames = _frames(21, (2, 8, 3))
    res = pmesh.run_spmd(ranks.rows_roundtrip, (1, 2), backend="gloo",
                         device="cpu", args=(frames,), threads=1,
                         timeout=120.0)
    assert [r["shape"] for r in res] == [(2, 4, 3)] * 2
    for r in res:
        np.testing.assert_array_equal(r["out"], frames)


def test_a_failing_rank_ends_the_pool():
    pool = pmesh.RankPool(2, backend="gloo", device="cpu", threads=1,
                          timeout=120.0)
    try:
        assert pool.run(ranks.fail_on, (1, 2), 5) == [0, 1]
        with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
            pool.run(ranks.fail_on, (1, 2), 1)
        with pytest.raises(RuntimeError, match="closed"):
            pool.run(ranks.fail_on, (1, 2), 5)
        assert not any(p.is_alive() for p in pool._procs)
    finally:
        pool.close()


@pytest.mark.parametrize("mesh_shape", ((1, 4), (2, 2)))
def test_sharded_calls_match_unsharded_on_each_rank(pools, mesh_shape):
    # the card test's rank function (tests/test_torch_sharded_cuda.py,
    # over NCCL there) on gloo ranks on the CPU
    res = pools(4).run(ranks.sharded_vs_unsharded, mesh_shape)
    ranks.check_sharded_vs_unsharded(res, mesh_shape, on_card=False)


def test_shard_and_gather_rows_round_trip(pools):
    frames = _frames(14, (4, 50, 6))      # 50 rows: blocks 13, 13, 13, 11
    res = _run(pools, ranks.rows_roundtrip, (2, 2), frames)
    np.testing.assert_array_equal(res[0]["out"], frames)
    assert [r["shape"] for r in res] == [(2, 25, 6)] * 4
    res = _run(pools, ranks.rows_roundtrip, (1, 4), frames)
    np.testing.assert_array_equal(res[0]["out"], frames)
    assert [r["shape"][1] for r in res] == [13, 13, 13, 11]


# ---------------------------------------------------------------------------
# the sharded regrid (BASELINE config 5's shape at a small size)
# ---------------------------------------------------------------------------

SRC, DST = (96, 72), (24, 18)


def _jax_regrid(fields, mesh_shape, **kw):
    mesh = _jmesh(*mesh_shape)
    return jax.jit(lambda f: j_regrid.conservative_regrid_sharded(
        f, j_regrid.LatLonGrid(*SRC), j_regrid.LatLonGrid(*DST), mesh,
        **kw))(_put(fields, mesh))


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_sharded_regrid_matches_jax(pools, mesh_shape):
    fields = _frames(15, (4,) + SRC)
    ref = np.asarray(_jax_regrid(fields, mesh_shape))
    res = _run(pools, ranks.regrid_sharded, mesh_shape, fields, SRC, DST)
    np.testing.assert_allclose(res[0]["out"], ref, atol=ATOL)


def test_sharded_regrid_aligned_local_path(pools):
    """An integer-ratio regrid takes the aligned local apply on the CPU
    (the route of apply_band_operators(impl='auto')), one per rank; a
    non-partition pair takes the banded one."""
    fields = _frames(16, (2,) + SRC)
    res = _run(pools, ranks.regrid_sharded, (2, 4), fields, SRC, DST)
    assert all(r["aligned_calls"] == 1 for r in res)
    ref = np.asarray(j_regrid.conservative_regrid(
        fields, j_regrid.LatLonGrid(*SRC), j_regrid.LatLonGrid(*DST),
        impl="xla"))
    np.testing.assert_allclose(res[0]["out"], ref, atol=ATOL)
    odd = (24, 20)                        # 72 -> 20 columns: not aligned
    res = _run(pools, ranks.regrid_sharded, (2, 4), fields, SRC, odd)
    assert all(r["aligned_calls"] == 0 for r in res)
    ref = np.asarray(j_regrid.conservative_regrid(
        fields, j_regrid.LatLonGrid(*SRC), j_regrid.LatLonGrid(*odd),
        impl="xla"))
    np.testing.assert_allclose(res[0]["out"], ref, atol=ATOL)


def test_sharded_regrid_flux_spherical(pools):
    fields = _frames(17, (2,) + SRC, 200.0, 300.0)
    _, jflux = _jax_regrid(fields, (2, 4), conserve=True)
    res = _run(pools, ranks.regrid_sharded, (2, 4), fields, SRC, DST, True)
    fd, fs = res[0]["flux"]
    np.testing.assert_allclose(fd, fs, rtol=RTOL_FLUX)
    np.testing.assert_allclose(res[0]["flux"], np.asarray(jflux),
                               rtol=RTOL_FLUX)
    # full-coverage grids: the flux is the spherical integral
    src = j_regrid.LatLonGrid(*SRC)
    my = np.abs(np.diff(np.sin(np.radians(src.lat_edges))))
    mx = np.diff(src.lon_edges)
    true_int = np.einsum("byx,y,x->", fields.astype(np.float64), my, mx)
    np.testing.assert_allclose(fs, true_int, rtol=RTOL_FLUX)


def test_sharded_regrid_masked(pools):
    fields = _frames(18, (2,) + SRC)
    mask = np.random.default_rng(19).uniform(0, 1, SRC) > 0.3
    mask[:12] = False                     # whole dst rows without coverage
    ref = np.asarray(_jax_regrid(fields, (2, 4), src_mask=mask))
    res = _run(pools, ranks.regrid_sharded, (2, 4), fields, SRC, DST, False,
               mask)
    np.testing.assert_allclose(res[0]["out"], ref, atol=ATOL)
    assert np.isnan(res[0]["out"][:, :3]).all()


def test_sharded_regrid_col_axis_not_ported(pools):
    # col_axis is ported (tests/test_torch_sharded_2d.py); on a ("data",
    # "rows") mesh, which has no cols dim, it raises and names the dim
    fields = _frames(20, (2,) + SRC)
    res = _run(pools, ranks.regrid_sharded, (1, 4), fields, SRC, DST, False,
               None, "cols")
    assert all("no 'cols' dim" in r["error"] for r in res)
