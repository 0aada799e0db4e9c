"""The port's 2-D (rows x cols) sharded separable apply, its conservation
flux and the lat-and-lon sharded regrid (``aainterp_torch.parallel``:
``sharding.sharded_apply_separable_2d``, ``sharded_apply_banded_2d``,
``sharded_apply_banded_2d_kernel``, ``conserve.sharded_flux_separable_2d``,
``mesh.shard_blocks`` / ``gather_blocks``; ``regrid.
conservative_regrid_sharded(col_axis="cols")``) against the JAX
package's 2-D functions on the 8-device virtual CPU mesh
(tests/conftest.py).

The port's ranks are gloo processes on the CPU, one torch thread each,
started once for the module (``RankPool``, 4 and 8 ranks); their side of
each case is in tests/torch_dist_ranks.py, which imports no jax.  A
("data", "rows", "cols") mesh of the port stands in for JAX's; JAX's
``data_axis=None`` mesh ("rows", "cols") has no counterpart and a (1,
n_r, n_c) mesh takes its cases.  Inputs are made from numpy seeds and the
operators go to the port through ``convert.operator_from_numpy``.
Tolerances: float32 atol 1e-5, flux rtol 1e-5; bf16 within one bf16 ulp;
uint8 equal, or against JAX's Pallas route within one level at .5 ties
(the count stated); ``np.array_equal`` where a case says so.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import aainterp as aa
from aainterp import regrid as j_regrid
from aainterp.ops.overlap1d import Band1D as JBand
from aainterp.ops.weights import separable_operator
from aainterp.parallel import conserve as j_conserve
from aainterp.parallel import sharding as j_sharding

import torch_dist_ranks as ranks
from aainterp_torch.parallel import sharding as t_sharding
from test_torch_sharded import (_run, _tables, _unpack,  # noqa: F401
                                plan_cache_dir, pools)

pytestmark = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs 8 (virtual) devices")

MESHES = ((2, 2, 2), (1, 2, 4))
ATOL = 1e-5
RTOL_FLUX = 1e-5


def _jmesh3(data, rows, cols):
    devs = np.asarray(jax.devices()[: data * rows * cols]).reshape(
        data, rows, cols)
    return Mesh(devs, ("data", "rows", "cols"))


def _put3(x, mesh):
    return jax.device_put(jnp.asarray(x),
                          NamedSharding(mesh, P("data", "rows", "cols")))


def _frames(seed, shape, lo=0.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _op(shape, res_src, res_dst, iso, angle):
    return separable_operator(aa.make_grid_spec(shape, res_src, res_dst,
                                                iso, angle))


def _jax_2d(frames, op, mesh_shape, **kw):
    mesh = _jmesh3(*mesh_shape)
    return jax.jit(lambda f: j_sharding.sharded_apply_separable_2d(
        f, op, mesh, **kw))(_put3(frames, mesh))


def _ref(op, frames):
    return np.asarray(aa.apply_operator(op, jnp.asarray(frames)))


# ---------------------------------------------------------------------------
# the separable apply
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_sharded_2d_matches_jax(pools, mesh_shape):
    B, H, W = 4, 128, 64
    frames = _frames(0, (B, H, W))
    op = _op((H, W), 2.0, 1.0, (0.0, 0.0), 0.0)
    ref = np.asarray(_jax_2d(frames, op, mesh_shape))
    res = _run(pools, ranks.separable, mesh_shape, frames, _tables(op))
    np.testing.assert_allclose(res[0]["out"], ref, atol=ATOL)
    np.testing.assert_allclose(res[0]["out"], _ref(op, frames), atol=ATOL)
    n_data, n_r, n_c = mesh_shape
    b, rows, cols = B // n_data, ref.shape[1] // n_r, ref.shape[2] // n_c
    for rank, r in enumerate(res):
        d, rest = divmod(rank, n_r * n_c)
        i, j = divmod(rest, n_c)
        # each rank holds its (B / n_data, Hd / n_r, Wd / n_c) block
        np.testing.assert_array_equal(
            r["local"], res[0]["out"][d * b:(d + 1) * b,
                                      i * rows:(i + 1) * rows,
                                      j * cols:(j + 1) * cols])
        # the apply gathers and reduces nothing
        assert r["traffic"]["all_reduce"] == 0
        assert r["traffic"]["all_gather"] == 0


def test_sharded_2d_noninteger_ratio_and_offsets(pools):
    # fractional edge overlaps and an offset isocenter: the halos differ
    # per axis and per rank
    B, H, W = 2, 96, 160
    frames = _frames(1, (B, H, W))
    op = _op((H, W), 1.0, 0.5, (13.0, 7.0), 0.0)
    assert op.spec.dst_shape[0] % 2 == 0 and op.spec.dst_shape[1] % 2 == 0
    ref = np.asarray(_jax_2d(frames, op, (2, 2, 2)))
    res = _run(pools, ranks.separable, (2, 2, 2), frames, _tables(op))
    np.testing.assert_allclose(res[0]["out"], ref, atol=ATOL)
    assert all(r["traffic"]["p2p"] > 0 for r in res)


def test_narrow_column_shards(pools):
    # 8 column shards of a 40-wide source: every rank's x window leans on
    # its neighbours (halo_x > 0 at sb_c = 5)
    H, W = 32, 40
    op = _op((H, W), 150.0, 30.0, (3.0, 3.0), 0.0)
    assert op.spec.dst_shape[1] % 8 == 0
    halo_x = t_sharding._row_halo(op.wx.start, op.wx.band, W,
                                  op.spec.dst_shape[1], 8)
    assert halo_x > 0
    frames = _frames(2, (1, H, W))
    ref = np.asarray(_jax_2d(frames, op, (1, 1, 8)))
    res = _run(pools, ranks.separable, (1, 1, 8), frames, _tables(op))
    np.testing.assert_allclose(res[0]["out"], ref, atol=ATOL)
    np.testing.assert_allclose(res[0]["out"], _ref(op, frames), atol=ATOL)


def test_halo_extend_cols_multihop(pools):
    """JAX's ``test_halo_extend_cols_multihop``: a column halo of 9 over
    blocks of 4 (3 hops, the last partial) against the numpy construction
    with zeros past the edges; then a row halo over the same mesh
    transposed."""
    n, sb, h = 8, 4, 9
    W = n * sb
    x = np.arange(2 * 3 * W, dtype=np.float32).reshape(2, 3, W) + 1.0
    res = pools(8).run(ranks.halo_extend, (1, 1, 8), x, h, "cols")
    padded = np.pad(x, ((0, 0), (0, 0), (h, h)))
    for j, r in enumerate(res):
        np.testing.assert_array_equal(r["ext"],
                                      padded[..., j * sb:j * sb + sb + 2 * h])
    # rank 0 sends its whole block to ranks 1 and 2 and 1 column to 3
    assert res[0]["p2p"] == (sb + sb + 1) * 2 * 3 * 4
    xt = np.ascontiguousarray(x.transpose(0, 2, 1))
    res = pools(8).run(ranks.halo_extend, (1, 8, 1), xt, h, "rows")
    padded = np.pad(xt, ((0, 0), (h, h), (0, 0)))
    for i, r in enumerate(res):
        np.testing.assert_array_equal(r["ext"],
                                      padded[:, i * sb:i * sb + sb + 2 * h])


def test_halo_reaches_the_corner_blocks(pools):
    # a 3 x 3 box sum on a 16 x 16 plane over (1, 2, 2): the dst pixels
    # at the four blocks' meeting point read all four blocks, the
    # diagonal one through the edge neighbour's row halo
    n = 16
    start = np.clip(np.arange(n) - 1, 0, n - 3).astype(np.int32)
    weights = np.full((n, 3), 1.0 / 3.0)
    jband = JBand(start=start, weights=weights, n_src=n, n_dst=n)
    frames = _frames(3, (1, n, n))
    mesh = _jmesh3(1, 2, 2)
    ref = np.asarray(jax.jit(lambda f: j_sharding.sharded_apply_banded_2d(
        f, jband, jband, mesh))(_put3(frames, mesh)))
    band = (start, weights, n, n)
    for kernel in (False, True):
        res = _run(pools, ranks.banded, (1, 2, 2), frames, band, band,
                   kernel)
        np.testing.assert_allclose(res[0]["out"], ref, atol=ATOL)
    dense = jband.dense()
    np.testing.assert_allclose(ref[0], dense @ frames[0] @ dense.T,
                               atol=ATOL)


# ---------------------------------------------------------------------------
# quadrant folding under 2-D sharding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("angle", (90.0, 180.0, 270.0))
def test_fold_tables_equal_jax(angle):
    # the 2-D fold is not the 1-D fold with a second axis: a flipped x
    # band runs forward too; every table, measure and count equals JAX's
    op = _op((64, 96), 2.0, 1.0, (4.0, 7.0), angle)
    fold = t_sharding._folded_sharded_bands_2d(ranks._op(_tables(op)), 2, 2)
    jfold = j_sharding._folded_sharded_bands_2d(op, 2, 2)
    for k in ("y", "x"):
        np.testing.assert_array_equal(fold[k].start, np.asarray(jfold[k].start))
        np.testing.assert_array_equal(fold[k].weights,
                                      np.asarray(jfold[k].weights))
        assert (fold[k].n_src, fold[k].n_dst) == (jfold[k].n_src,
                                                  jfold[k].n_dst)
    for got, want in zip(fold["measures"], jfold["measures"]):
        np.testing.assert_array_equal(got, want)
    x = np.arange(2 * 6 * 5, dtype=np.float32).reshape(2, 6, 5)
    np.testing.assert_array_equal(fold["post"](torch.as_tensor(x)).numpy(),
                                  np.asarray(jfold["post"](jnp.asarray(x))))
    assert torch.equal(fold["post_inv"](fold["post"](torch.as_tensor(x))),
                       torch.as_tensor(x))


@pytest.mark.parametrize("angle", (90.0, 180.0, 270.0))
def test_folded_quadrant_matches_jax_with_flux(pools, angle):
    H = W = 64
    frames = _frames(4, (2, H, W))
    op = _op((H, W), 2.0, 1.0, (4.0, 7.0), angle)
    assert j_sharding._folded_sharded_bands_2d(op, 2, 2) is not None
    out, flux = _jax_2d(frames, op, (2, 2, 2), impl="banded",
                        conserve=True)
    res = _run(pools, ranks.separable, (2, 2, 2), frames, _tables(op),
               "banded", True)
    assert res[0]["folded"]
    np.testing.assert_allclose(res[0]["out"], np.asarray(out), atol=ATOL)
    np.testing.assert_allclose(res[0]["out"], _ref(op, frames), atol=ATOL)
    fd, fs = res[0]["flux"]
    np.testing.assert_allclose(fd, fs, rtol=RTOL_FLUX)
    np.testing.assert_allclose(res[0]["flux"], np.asarray(flux),
                               rtol=RTOL_FLUX)
    for r in res:
        np.testing.assert_array_equal(r["flux"], res[0]["flux"])
        # only the dst moves: the post's all-gather of the inner dst
        assert r["traffic"]["all_gather"] <= frames.nbytes // 8


def test_indivisible_fold_falls_back_to_rot90(pools):
    # 90 degrees on a (1, 2, 4) mesh: the fold's x band (wy) does not
    # divide 4 columns, the rot90 route's counts do
    H, W = 64, 68
    frames = _frames(5, (1, H, W))
    op = _op((H, W), 2.0, 1.0, (0.0, 0.0), 90.0)
    assert j_sharding._folded_sharded_bands_2d(op, 2, 4) is None
    ref = np.asarray(_jax_2d(frames, op, (1, 2, 4)))
    res = _run(pools, ranks.separable, (1, 2, 4), frames, _tables(op))
    assert not res[0]["folded"]
    np.testing.assert_allclose(res[0]["out"], ref, atol=ATOL)
    np.testing.assert_allclose(res[0]["out"], _ref(op, frames), atol=ATOL)
    # the route gathers the whole source: 7 ranks' blocks arrive
    assert res[0]["traffic"]["all_gather"] >= frames.nbytes // 8


# ---------------------------------------------------------------------------
# conservation flux
# ---------------------------------------------------------------------------


def test_separable_2d_flux(pools):
    B, H, W = 4, 160, 128
    frames = _frames(6, (B, H, W))
    op = _op((H, W), 150.0, 30.0, (0.0, 0.0), 0.0)
    _, jflux = _jax_2d(frames, op, (2, 2, 2), conserve=True)
    res = _run(pools, ranks.separable, (2, 2, 2), frames, _tables(op),
               "auto", True)
    fd, fs = res[0]["flux"]
    assert fd > 0
    np.testing.assert_allclose(fd, fs, rtol=RTOL_FLUX)
    np.testing.assert_allclose(res[0]["flux"], np.asarray(jflux),
                               rtol=RTOL_FLUX)
    _, _, covy, covx = j_conserve.separable_flux_factors(
        op.wy, op.wx, raw_sums=op.raw_row_sums)
    host_fs = np.einsum("byx,y,x->", frames.astype(np.float64), covy, covx)
    np.testing.assert_allclose(fs, host_fs, rtol=RTOL_FLUX)
    # the flux is one all_reduce of two float64s over the whole mesh
    assert all(r["traffic"]["all_reduce"] == 16 for r in res)


def test_separable_2d_flux_catches_corruption(pools):
    frames = _frames(7, (2, 160, 128))
    op = _op((160, 128), 150.0, 30.0, (0.0, 0.0), 0.0)
    res = _run(pools, ranks.corrupted_flux, (2, 2, 2), frames, _tables(op))
    (gd, gs), (bd, bs) = res[0]
    np.testing.assert_allclose(gd, gs, rtol=RTOL_FLUX)
    assert abs(bd - bs) / abs(bs) > 1e-3


# ---------------------------------------------------------------------------
# the aligned local path and the kernel route
# ---------------------------------------------------------------------------


def test_aligned_local_path(pools):
    """Strict integer-ratio partitions on both axes take the aligned local
    apply (JAX: sharding.py:841-879), one per rank; a fractional ratio on
    either axis takes the banded one."""
    for (H, W), (Hd, Wd), aligned in (((96, 72), (24, 18), 1),
                                      ((88, 72), (24, 18), 0),
                                      ((96, 72), (24, 20), 0)):
        by, bx = j_regrid.conservative_regrid_operator(
            j_regrid.LatLonGrid(H, W), j_regrid.LatLonGrid(Hd, Wd))
        if Wd % 2 or Hd % 2:
            continue
        fields = _frames(8, (2, H, W))
        mesh = _jmesh3(2, 2, 2)
        ref = np.asarray(jax.jit(lambda f: j_sharding.sharded_apply_banded_2d(
            f, by, bx, mesh))(_put3(fields, mesh)))
        res = _run(pools, ranks.banded, (2, 2, 2), fields, _unpack(by),
                   _unpack(bx))
        assert all(r["aligned_calls"] == aligned for r in res), (H, W, Hd, Wd)
        np.testing.assert_allclose(res[0]["out"], ref, atol=ATOL)


@pytest.mark.parametrize("shape, res_dst, iso", (
    ((128, 64), 1.0, (0.0, 0.0)), ((96, 160), 0.5, (13.0, 7.0))))
def test_kernel_route_matches_jax_pallas(pools, shape, res_dst, iso):
    # JAX's per-shard Pallas kernel in interpret mode against the port's
    # kernel-1 route (its plain version on CPU tensors) on the same mesh
    res_src = 2.0 if res_dst == 1.0 else 1.0
    op = _op(shape, res_src, res_dst, iso, 0.0)
    frames = _frames(9, (2,) + shape)
    mesh = _jmesh3(2, 2, 2)
    jout = np.asarray(jax.jit(
        lambda f: j_sharding.sharded_apply_banded_2d_pallas(
            f, op.wy, op.wx, mesh, interpret=True))(_put3(frames, mesh)))
    res = _run(pools, ranks.banded, (2, 2, 2), frames, _unpack(op.wy),
               _unpack(op.wx), True)
    assert res[0]["dtype"] == "torch.float32"
    np.testing.assert_allclose(res[0]["out"], jout, atol=ATOL)
    np.testing.assert_allclose(res[0]["out"], _ref(op, frames), atol=ATOL)


def _levels_off(got, want):
    """(largest difference, count of differing pixels) of two u8 arrays."""
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    return int(diff.max()), int((diff > 0).sum())


def test_uint8_both_routes(pools):
    # u8 in -> u8 out.  The banded route applies float32 and rounds, as
    # JAX's banded route does; the plain torch einsum and XLA sum in their
    # own orders, as do kernel 1's plain version and JAX's Pallas u8
    # route, so a .5 tie may land one level off (1 pixel of 6,144 here on
    # each pair); on the card the kernel is bit-equal to its unsharded
    # call (tests/test_torch_sharded_cuda.py)
    H, W, B = 128, 96, 2
    frames = np.random.default_rng(10).integers(0, 256, (B, H, W),
                                                dtype=np.uint8)
    op = _op((H, W), 2.0, 1.0, (0.0, 0.0), 0.0)
    jref = np.asarray(_jax_2d(frames, op, (2, 2, 2), impl="banded"))
    assert jref.dtype == np.uint8
    res = _run(pools, ranks.separable, (2, 2, 2), frames, _tables(op))
    out = res[0]["out"]
    assert out.dtype == np.uint8
    kres = _run(pools, ranks.banded, (2, 2, 2), frames, _unpack(op.wy),
                _unpack(op.wx), True)
    assert kres[0]["dtype"] == "torch.uint8"
    mesh = _jmesh3(2, 2, 2)
    jpal = np.asarray(jax.jit(lambda f: j_sharding.sharded_apply_separable_2d(
        f, op, mesh, impl="pallas", interpret=True))(_put3(frames, mesh)))
    for got, want in ((out, jref), (kres[0]["out"], out), (jpal, out)):
        most, count = _levels_off(got, want)
        assert most <= 1 and count <= 0.001 * got.size, (most, count)


def test_uint8_folded_quadrant(pools):
    H, W = 128, 64
    frames = np.random.default_rng(11).integers(0, 256, (2, H, W),
                                                dtype=np.uint8)
    op = _op((H, W), 2.0, 1.0, (0.0, 0.0), 180.0)
    assert op.spec.quadrant == 2
    jref = np.asarray(_jax_2d(frames, op, (2, 2, 2), impl="banded"))
    res = _run(pools, ranks.separable, (2, 2, 2), frames, _tables(op))
    assert res[0]["folded"]
    most, count = _levels_off(res[0]["out"], jref)
    assert most <= 1 and count <= 0.001 * jref.size, (most, count)


def test_uint8_conserve_raises(pools):
    H, W = 128, 64
    frames = np.random.default_rng(12).integers(0, 256, (2, H, W),
                                                dtype=np.uint8)
    op = _op((H, W), 2.0, 1.0, (0.0, 0.0), 0.0)
    with pytest.raises(ValueError, match="conserve"):
        j_sharding.sharded_apply_separable_2d(
            jnp.asarray(frames), op, _jmesh3(2, 2, 2), conserve=True,
            interpret=True)
    res = _run(pools, ranks.separable, (2, 2, 2), frames, _tables(op),
               "auto", True)
    assert all("conserve" in r["error"] for r in res)


@pytest.mark.parametrize("case, match", (
    ("kernel_on_cpu", "CUDA tensor"), ("unknown_impl", "unknown impl"),
    ("rows", "divisible"), ("cols", "divisible")))
def test_guards_on_ranks(pools, case, match):
    shape = {"rows": (130, 64), "cols": (128, 66)}.get(case, (128, 64))
    op = _op(shape, 2.0, 1.0, (0.0, 0.0), 0.0)
    impl = {"kernel_on_cpu": "kernel", "unknown_impl": "pallas"}.get(
        case, "auto")
    frames = _frames(13, (2,) + shape)
    if case in ("rows", "cols"):
        with pytest.raises(ValueError, match=match):
            _jax_2d(frames, op, (1, 2, 4))
    res = _run(pools, ranks.separable, (1, 2, 4), frames, _tables(op), impl)
    assert all(match in r["error"] for r in res), res[0]


def test_2d_applies_need_a_cols_dim(pools):
    # a 2-D entry point on a ("data", "rows") mesh names the cols dim
    res = pools(4).run(ranks.regrid_sharded, (1, 4), _frames(15, (2, 96, 72)),
                       (96, 72), (24, 18), False, None, "cols")
    assert all("no 'cols' dim" in r["error"] for r in res), res[0]


# ---------------------------------------------------------------------------
# collectives: the kinds and payloads tests/test_ici_traffic.py pins
# ---------------------------------------------------------------------------


def test_collectives_are_halos_and_the_flux_pair(pools):
    # quadrant 0: point-to-point halos only, each send below one block;
    # conserve adds one 16-byte all_reduce; a fold adds only the
    # dst-sized all-gather of its post
    H, W = 256, 512
    frames = _frames(16, (2, H, W))
    op = _op((H, W), 2.0, 1.0, (0.0, 0.0), 0.0)
    plain = pools(8).run(ranks.collective_sizes, (2, 2, 2), "separable",
                         frames, _tables(op))
    cons = pools(8).run(ranks.collective_sizes, (2, 2, 2), "separable",
                        frames, _tables(op), True)
    for p, c in zip(plain, cons):
        assert p["sizes"]["all_gather"] == [] == p["sizes"]["all_reduce"]
        assert p["sizes"]["p2p"] and max(p["sizes"]["p2p"]) < p["block"]
        assert c["sizes"]["all_reduce"] == [16]
        assert c["sizes"]["p2p"] == p["sizes"]["p2p"]
    fold = _op((H, W), 2.0, 1.0, (0.0, 0.0), 90.0)
    res = pools(8).run(ranks.collective_sizes, (2, 2, 2), "separable",
                       frames, _tables(fold))
    dst_block = (2 // 2) * (fold.spec.dst_shape[0] // 2) * (
        fold.spec.dst_shape[1] // 2) * 4
    for r in res:
        assert max(r["sizes"]["all_gather"]) <= 2 * dst_block
        assert max(r["sizes"]["p2p"]) < r["block"]


# ---------------------------------------------------------------------------
# rank-local checks, shard/gather, no JAX on the ranks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh_shape", ((1, 2, 2), (1, 1, 4)))
def test_sharded_2d_calls_match_unsharded_on_each_rank(pools, mesh_shape):
    # the card test's rank function (tests/test_torch_sharded_cuda.py,
    # over NCCL there) on gloo ranks on the CPU
    res = pools(4).run(ranks.sharded_2d_vs_unsharded, mesh_shape)
    ranks.check_sharded_2d_vs_unsharded(res, on_card=False)


def test_shard_and_gather_blocks_round_trip(pools):
    frames = _frames(17, (4, 50, 7))    # ceil blocks on both axes
    res = _run(pools, ranks.rows_roundtrip, (2, 2, 2), frames)
    np.testing.assert_array_equal(res[0]["out"], frames)
    assert [r["shape"] for r in res] == [
        (2, 25, 4), (2, 25, 3), (2, 25, 4), (2, 25, 3)] * 2
    res = _run(pools, ranks.rows_roundtrip, (1, 1, 4), frames)
    np.testing.assert_array_equal(res[0]["out"], frames)
    assert [r["shape"][2] for r in res] == [2, 2, 2, 1]


def test_ranks_load_no_jax(pools):
    # the ranks ran every case of this file above: none imported JAX
    for world, shape in ((4, (1, 2, 2)), (8, (2, 2, 2))):
        assert pools(world).run(ranks.loaded_modules, shape) == [[]] * world


# ---------------------------------------------------------------------------
# the lat-and-lon sharded regrid (BASELINE config 5's shape, small)
# ---------------------------------------------------------------------------

SRC, DST = (96, 72), (24, 18)


def _jax_regrid(fields, mesh_shape, **kw):
    mesh = _jmesh3(*mesh_shape)
    return jax.jit(lambda f: j_regrid.conservative_regrid_sharded(
        f, j_regrid.LatLonGrid(*SRC), j_regrid.LatLonGrid(*DST), mesh,
        col_axis="cols", **kw))(_put3(fields, mesh))


@pytest.mark.parametrize("mesh_shape", ((2, 2, 2), (1, 2, 2)))
def test_regrid_lat_and_lon_matches_jax(pools, mesh_shape):
    fields = _frames(18, (4,) + SRC)
    ref = np.asarray(_jax_regrid(fields, mesh_shape))
    res = _run(pools, ranks.regrid_sharded, mesh_shape, fields, SRC, DST,
               False, None, "cols")
    np.testing.assert_allclose(res[0]["out"], ref, atol=ATOL)
    # the integer-ratio regrid takes the aligned local route on the CPU
    assert all(r["aligned_calls"] == 1 for r in res)


def test_regrid_lat_and_lon_flux(pools):
    fields = _frames(19, (2,) + SRC, 200.0, 300.0)
    _, jflux = _jax_regrid(fields, (2, 2, 2), conserve=True)
    res = _run(pools, ranks.regrid_sharded, (2, 2, 2), fields, SRC, DST,
               True, None, "cols")
    fd, fs = res[0]["flux"]
    np.testing.assert_allclose(fd, fs, rtol=RTOL_FLUX)
    np.testing.assert_allclose(res[0]["flux"], np.asarray(jflux),
                               rtol=RTOL_FLUX)
    src = j_regrid.LatLonGrid(*SRC)
    my = np.abs(np.diff(np.sin(np.radians(src.lat_edges))))
    mx = np.diff(src.lon_edges)
    true_int = np.einsum("byx,y,x->", fields.astype(np.float64), my, mx)
    np.testing.assert_allclose(fs, true_int, rtol=RTOL_FLUX)


def test_regrid_lat_and_lon_masked(pools):
    fields = _frames(20, (2,) + SRC)
    mask = np.random.default_rng(21).uniform(0, 1, SRC) > 0.3
    mask[:12] = False                     # whole dst rows without coverage
    ref = np.asarray(_jax_regrid(fields, (2, 2, 2), src_mask=mask))
    res = _run(pools, ranks.regrid_sharded, (2, 2, 2), fields, SRC, DST,
               False, mask, "cols")
    np.testing.assert_allclose(res[0]["out"], ref, atol=ATOL)
    assert np.isnan(res[0]["out"][:, :3]).all()


def test_regrid_col_axis_names_the_cols_dim(pools):
    fields = _frames(22, (2,) + SRC)
    res = _run(pools, ranks.regrid_sharded, (1, 2, 2), fields, SRC, DST,
               False, None, "lon")
    assert all("col_axis must be None or 'cols'" in r["error"] for r in res)
