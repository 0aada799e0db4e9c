"""The port's row-sharded transposes and autograd wrappers
(``aainterp_torch.parallel.sharding``: ``_halo_reduce``,
``sharded_apply_separable_transpose``, ``sharded_apply_ell_transpose``,
``make_sharded_separable_linear``, ``make_sharded_ell_linear``) against
the JAX package's on the 8-device virtual CPU mesh (tests/conftest.py),
the cases of tests/test_sharded_autodiff.py; and the rot90 route on
source or cotangent blocks that do not divide the mesh.

The port's ranks are gloo processes on the CPU, one torch thread each,
started once for the module (``RankPool``, 4 and 8 ranks); their side of
each case is in tests/torch_dist_ranks.py, which imports no jax.  On the
CPU ``impl='auto'`` takes the plain banded route for the separable
transposes; the ELL transposes scatter with ``index_add_`` on every
device.  Tolerances: separable float32 atol 1e-5 (gradients 1e-4, JAX's),
ELL float32 atol 1e-5 (the unsharded scatter's tolerance), the adjoint identity
rel 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aainterp as aa
from aainterp import autodiff as j_autodiff
from aainterp.ops import overlap1d as j_overlap1d
from aainterp.ops.weights import ell_operator, fold_quadrant_ell
from aainterp.parallel import sharding as j_sharding

import torch_dist_ranks as ranks
from aainterp_torch import api as t_api
from aainterp_torch import autodiff as t_autodiff
from aainterp_torch.parallel import sharding as t_sharding
from test_torch_sharded import (_jmesh, _op, _put, _run,  # noqa: F401
                                _tables, plan_cache_dir, pools)
from test_torch_sharded_ell import _tables as _ell_tables

pytestmark = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs 8 (virtual) devices")

MESHES = ((1, 4), (2, 2), (2, 4))
ATOL = 1e-5
ATOL_GRAD = 1e-4
RTOL_ADJOINT = 1e-5


def _frames(seed, shape, lo=0.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _ell(shape, res_src, res_dst, iso, angle):
    return ell_operator(aa.make_grid_spec(shape, res_src, res_dst, iso,
                                          angle), mode="exact")


def _jax_t(fn, cot, op, mesh_shape, put=True, **kw):
    """JAX's sharded transpose ``fn`` of the cotangent (``put``: sharded
    over the mesh as the forward's output; else whole, for a dst whose
    rows do not divide the mesh)."""
    mesh = _jmesh(*mesh_shape)
    g = _put(cot, mesh) if put else jnp.asarray(cot)
    return np.asarray(jax.jit(lambda c: fn(c, op, mesh, **kw))(g))


def _ref_t(op, cot, **kw):
    """JAX's unsharded transpose."""
    return np.asarray(j_autodiff.apply_operator_transpose(
        op, jnp.asarray(cot), **kw))


def _port_sep(op):
    return ranks._op(_tables(op))


def _port_ell(op):
    return ranks._ell_op(_ell_tables(op))


def _torch_grad(port_op, frames, tgt=None):
    """The unsharded gradient of sum((A x - tgt)^2) through the port's
    ``apply_operator(differentiable=True)`` on the CPU
    (``SeparableLinear`` / ``EllLinear``)."""
    x = torch.as_tensor(frames).clone().requires_grad_(True)
    out = t_api.apply_operator(port_op, x, differentiable=True)
    r = out if tgt is None else out - torch.as_tensor(tgt)
    (r ** 2).sum().backward()
    return x.grad.numpy()


# ---------------------------------------------------------------------------
# the rot90 route on blocks that do not divide the mesh (the repaired
# gather: these failed before it, every rank aborting in the all-gather)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernel", (False, True))
def test_uneven_source_blocks_ell(pools, kernel):
    # 31 x 32 at 97 deg, 1.0 -> 1.0: the folded dst has 35 rows, so the
    # rot90 route runs on source blocks of 8, 8, 8 and 7 rows
    H, W = 31, 32
    op = _ell((H, W), 1.0, 1.0, (W / 2, H / 2), 97.0)
    assert fold_quadrant_ell(op)[0].spec.dst_shape[0] % 4
    assert op.spec.dst_shape[0] % 4 == 0 == op.spec.qrot_shape[0] % 4
    frames = _frames(0, (2, H, W))
    mesh = _jmesh(1, 4)
    ref = np.asarray(jax.jit(lambda f: j_sharding.sharded_apply_ell(
        f, op, mesh, impl="xla"))(jnp.asarray(frames)))
    np.testing.assert_allclose(
        ref, np.asarray(aa.apply_operator(op, jnp.asarray(frames))),
        atol=ATOL)
    res = _run(pools, ranks.ell, (1, 4), frames, _ell_tables(op), "auto",
               False, kernel)
    assert "error" not in res[0], res[0]
    np.testing.assert_allclose(res[0]["out"], ref, atol=ATOL)


def test_uneven_source_blocks_separable(pools):
    # 30 x 32 at 90 deg, 2.0 -> 1.0: the fold does not divide 4, the
    # rot90 route runs on source blocks of 8, 8, 8 and 6 rows
    H, W = 30, 32
    frames = _frames(1, (2, H, W))
    op = _op((H, W), 2.0, 1.0, (0.0, 0.0), 90.0)
    assert j_sharding._folded_sharded_bands(op, 4) is None
    mesh = _jmesh(1, 4)
    ref = np.asarray(jax.jit(lambda f: j_sharding.sharded_apply_separable(
        f, op, mesh))(jnp.asarray(frames)))
    res = _run(pools, ranks.separable, (1, 4), frames, _tables(op))
    assert "error" not in res[0], res[0]
    assert not res[0]["folded"]
    np.testing.assert_allclose(res[0]["out"], ref, atol=ATOL)
    # and back: the transpose's cotangent is the forward's output blocks,
    # its output the uneven source blocks
    cot = _frames(2, (2,) + op.spec.dst_shape, -1.0, 1.0)
    ref_t = _jax_t(j_sharding.sharded_apply_separable_transpose, cot, op,
                   (1, 4), put=False)
    np.testing.assert_allclose(ref_t, _ref_t(op, cot, impl="xla"),
                               atol=ATOL)
    res = _run(pools, ranks.transpose, (1, 4), cot, _tables(op))
    np.testing.assert_allclose(res[0]["out"], ref_t, atol=ATOL)
    assert [r["local"].shape[1] for r in res] == [8, 8, 8, 6]


# ---------------------------------------------------------------------------
# the separable transpose
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_separable_transpose_matches_jax(pools, mesh_shape):
    H, W, B = 128, 64, 4
    op = _op((H, W), 2.0, 1.0, (0.0, 0.0), 0.0)
    cot = _frames(3, (B,) + op.spec.dst_shape, -1.0, 1.0)
    ref = _jax_t(j_sharding.sharded_apply_separable_transpose, cot, op,
                 mesh_shape)
    np.testing.assert_allclose(ref, _ref_t(op, cot, impl="xla"), atol=ATOL)
    res = _run(pools, ranks.transpose, mesh_shape, cot, _tables(op))
    np.testing.assert_allclose(res[0]["out"], ref, atol=ATOL)
    np.testing.assert_allclose(
        res[0]["out"], t_autodiff.apply_operator_transpose(
            _port_sep(op), torch.as_tensor(cot)).numpy(), atol=ATOL)
    assert res[0]["dtype"] == "torch.float32"
    n_data, n_rows = mesh_shape
    for rank, r in enumerate(res):
        d, i = divmod(rank, n_rows)
        b, rows = B // n_data, H // n_rows
        np.testing.assert_array_equal(
            r["local"], res[0]["out"][d * b:(d + 1) * b,
                                      i * rows:(i + 1) * rows])


@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("angle", (90.0, 180.0, 270.0))
def test_separable_transpose_quadrants(pools, mesh_shape, angle):
    # JAX's quadrant cases: 64 x 128 at 180 and 128 x 128 at 90 / 270
    # about (2, 6); the folded route on every mesh here
    shape = (64, 128) if angle == 180.0 else (128, 128)
    op = _op(shape, 2.0, 1.0, (2.0, 6.0), angle)
    assert j_sharding._folded_sharded_bands(op, mesh_shape[1]) is not None
    cot = _frames(4, (2,) + op.spec.dst_shape, -1.0, 1.0)
    ref = _jax_t(j_sharding.sharded_apply_separable_transpose, cot, op,
                 mesh_shape)
    np.testing.assert_allclose(ref, _ref_t(op, cot, impl="xla"), atol=ATOL)
    res = _run(pools, ranks.transpose, mesh_shape, cot, _tables(op))
    np.testing.assert_allclose(res[0]["out"], ref, atol=ATOL)
    assert res[0]["out"].shape == (2,) + shape


@pytest.mark.parametrize("q", (0, 1, 2, 3))
@pytest.mark.parametrize("cols", (False, True))
def test_folded_transposes_pinned(q, cols):
    """The (t_y, t_x) table against JAX's identities (sharding.py:1853-1860
    for 1-D, 1047-1054 for 2-D), band for band, and each the exact
    transpose of its folded band."""
    op = _op((48, 40), 2.0, 1.0, (3.0, 5.0), 90.0 * q)
    assert op.spec.quadrant == q
    ty, tx = j_autodiff.transposed_separable(op)
    flip, rr = j_overlap1d.flip_band, j_overlap1d.reverse_rows_band
    want = {0: (ty, tx), 1: (flip(rr(tx)), ty),
            2: (flip(rr(ty)), flip(rr(tx)) if cols else rr(tx)),
            3: (tx, flip(rr(ty)) if cols else rr(ty))}[q]
    port = _port_sep(op)
    got = t_sharding._folded_transposes(port, cols)
    fold = (t_sharding._folded_sharded_bands_2d(port, 1, 1) if cols
            else t_sharding._folded_sharded_bands(port, 1))
    for g, w, b in zip(got, want, (fold["y"], fold["x"])):
        np.testing.assert_array_equal(g.start, np.asarray(w.start))
        np.testing.assert_array_equal(g.weights, np.asarray(w.weights))
        assert (g.n_src, g.n_dst) == (w.n_src, w.n_dst)
        np.testing.assert_allclose(g.dense(), b.dense().T, atol=1e-12)
        # the identities keep the band as narrow as the unfolded one's
        assert g.band <= max(ty.band, tx.band)


def test_separable_adjoint_identity(pools):
    H, W = 128, 64
    op = _op((H, W), 2.0, 1.0, (0.0, 0.0), 0.0)
    x = _frames(5, (2, H, W))
    y = _frames(6, (2,) + op.spec.dst_shape)
    res = _run(pools, ranks.adjoint_pair, (2, 2), x, y, _tables(op))
    lhs, rhs = res[0]
    np.testing.assert_allclose(lhs, rhs, rtol=RTOL_ADJOINT)
    assert all(r == res[0] for r in res)


# ---------------------------------------------------------------------------
# the ELL transpose
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("angle,dr", [(12.0, 1.16), (30.0, 1.2),
                                      (62.0, 1.2)])
def test_ell_transpose_matches_jax(pools, angle, dr):
    op = _ell((64, 64), 2.0, dr, (0.0, 0.0), angle)
    assert op.spec.dst_shape[0] % 4 == 0 == op.spec.qrot_shape[0] % 4
    cot = _frames(7, (2,) + op.spec.dst_shape, -1.0, 1.0)
    ref = _jax_t(j_sharding.sharded_apply_ell_transpose, cot, op, (2, 4))
    np.testing.assert_allclose(ref, _ref_t(op, cot), atol=ATOL)
    res = _run(pools, ranks.transpose, (2, 4), cot, _ell_tables(op))
    np.testing.assert_allclose(res[0]["out"], ref, atol=ATOL)
    assert res[0]["dtype"] == "torch.float32"
    np.testing.assert_allclose(
        res[0]["out"], t_autodiff.apply_operator_transpose(
            _port_ell(op), torch.as_tensor(cot)).numpy(), atol=ATOL)


def test_ell_transpose_multihop(pools):
    # 2.0 / 0.9 at 55 deg: a halo of 44 rows over blocks of 8, six hops
    op = _ell((64, 64), 2.0, 0.9, (0.0, 0.0), 55.0)
    db, sb, halo = t_sharding._ell_blocks(_port_ell(op), 8)[:3]
    assert -(-halo // sb) == 6, (halo, sb)
    cot = _frames(8, (1,) + op.spec.dst_shape, -1.0, 1.0)
    ref = _jax_t(j_sharding.sharded_apply_ell_transpose, cot, op, (1, 8))
    res = _run(pools, ranks.transpose, (1, 8), cot, _ell_tables(op))
    np.testing.assert_allclose(res[0]["out"], ref, atol=ATOL)
    np.testing.assert_allclose(res[0]["out"], _ref_t(op, cot), atol=ATOL)


@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("angle", (121.5, 211.5, 301.5))
def test_ell_transpose_quadrant_folded(pools, mesh_shape, angle):
    # the true dst rows (74 at 121.5 and 301.5) do not divide 4: the
    # cotangent arrives in ceil blocks and pays the inverse permutation
    # through the gather of uneven blocks
    op = _ell((128, 96), 1.0, 0.5, (48.0, 64.0), angle)
    assert op.spec.quadrant in (1, 2, 3)
    fop = fold_quadrant_ell(op)[0]
    assert fop.spec.dst_shape[0] % 4 == 0 == fop.spec.qrot_shape[0] % 4
    cot = _frames(9, (2,) + op.spec.dst_shape, -1.0, 1.0)
    ref = _jax_t(j_sharding.sharded_apply_ell_transpose, cot, op,
                 mesh_shape, put=False)
    np.testing.assert_allclose(ref, _ref_t(op, cot), atol=ATOL)
    res = _run(pools, ranks.transpose, mesh_shape, cot, _ell_tables(op))
    np.testing.assert_allclose(res[0]["out"], ref, atol=ATOL,
                               err_msg=str(angle))


@pytest.mark.parametrize("tables_as", ("float32", "float64"))
def test_ell_transpose_explicit_tables(pools, tables_as):
    # the operator's own tables as arguments, folded with the quadrant
    op = _ell((128, 96), 1.0, 0.5, (48.0, 64.0), 121.5)
    cot = _frames(10, (2,) + op.spec.dst_shape, -1.0, 1.0)
    mesh = _jmesh(2, 4)
    ref = np.asarray(jax.jit(lambda c: j_sharding.sharded_apply_ell_transpose(
        c, op, mesh, base=jnp.asarray(op.base),
        weights=jnp.asarray(op.weights, jnp.float32)))(jnp.asarray(cot)))
    res = _run(pools, ranks.transpose, (2, 4), cot, _ell_tables(op), None,
               tables_as)
    np.testing.assert_allclose(res[0]["out"], ref, atol=ATOL)


def test_ell_transpose_rot90_route(pools):
    # 100 x 128 at 94.5 deg: the folded dst rows (55) do not divide 4,
    # the rot90 route's do; the output is rotated back
    op = _ell((100, 128), 1.0, 0.5, (64.0, 50.0), 94.5)
    assert fold_quadrant_ell(op)[0].spec.dst_shape[0] % 4
    cot = _frames(11, (2,) + op.spec.dst_shape, -1.0, 1.0)
    ref = _jax_t(j_sharding.sharded_apply_ell_transpose, cot, op, (2, 4))
    np.testing.assert_allclose(ref, _ref_t(op, cot), atol=ATOL)
    res = _run(pools, ranks.transpose, (2, 4), cot, _ell_tables(op))
    np.testing.assert_allclose(res[0]["out"], ref, atol=ATOL)


def test_ell_adjoint_identity(pools):
    op = _ell((64, 64), 2.0, 1.2, (0.0, 0.0), 30.0)
    x = _frames(12, (2, 64, 64))
    y = _frames(13, (2,) + op.spec.dst_shape)
    res = _run(pools, ranks.adjoint_pair, (1, 4), x, y, _ell_tables(op))
    lhs, rhs = res[0]
    np.testing.assert_allclose(lhs, rhs, rtol=RTOL_ADJOINT)


# ---------------------------------------------------------------------------
# _halo_reduce: the adjoint of _halo_extend, and its traffic
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h", (3, 8, 21))
def test_halo_reduce_is_the_adjoint(pools, h):
    # blocks of 8 rows over 4 ranks: one hop, one full hop, three hops;
    # float64, so the two dots agree to its rounding
    x = _frames(14, (2, 32, 6)).astype(np.float64)
    res = _run(pools, ranks.halo_pair, (1, 4), x, h, "rows")
    for r in res:
        assert "error" not in r, r
        np.testing.assert_allclose(*r["dots"], rtol=1e-12)
        assert r["p2p_reduce"] == r["p2p_extend"]
        assert r["shape"] == r["block"]
    # rank 0 sends on each hop to rank k only, its rows min(8, h - 8 (k-1))
    assert res[0]["p2p_extend"] == h * 2 * 6 * 8


def test_halo_reduce_guard(pools):
    res = _run(pools, ranks.halo_pair, (1, 4), _frames(15, (1, 32, 4)), 25,
               "rows")
    for r in res:
        assert "4 ring hops but only 3 neighbours" in r["error"], r
        assert "4 ring hops but only 3 neighbours" in r["error_reduce"], r


def test_ell_transpose_traffic_equals_forward(pools):
    # f32 frames and an f32 cotangent: the reverse ring sends exactly the
    # bytes of the forward ring, slab for slab, on every rank
    op = _ell((64, 64), 2.0, 0.9, (0.0, 0.0), 55.0)
    frames = _frames(16, (1, 64, 64))
    cot = _frames(17, (1,) + op.spec.dst_shape)
    fwd = pools(8).run(ranks.collective_sizes, (1, 8), "ell", frames,
                       _ell_tables(op))
    bwd = pools(8).run(ranks.collective_sizes, (1, 8), "ell_transpose", cot,
                       _ell_tables(op))
    for f, b in zip(fwd, bwd):
        assert sorted(b["sizes"]["p2p"]) == sorted(f["sizes"]["p2p"])
        assert b["sizes"]["all_gather"] == [] == b["sizes"]["all_reduce"]
    assert sum(fwd[0]["sizes"]["p2p"]) > 0


def test_folded_transposes_gather_no_source(pools):
    # at 90 deg the separable and the ELL transposes move the cotangent
    # (a dst-sized all-gather for post_inv) and halos, never the source
    H = W = 128
    op = _op((H, W), 2.0, 1.0, (2.0, 6.0), 90.0)
    src_block = (2 // 2) * (H // 4) * W * 4
    cot = _frames(18, (2,) + op.spec.dst_shape)
    res = pools(8).run(ranks.collective_sizes, (2, 4), "separable_transpose",
                       cot, _tables(op))
    for r in res:
        assert max(r["sizes"]["all_gather"]) <= r["block"] < src_block
        assert max(r["sizes"]["p2p"]) < r["block"]
    eop = _ell((128, 96), 1.0, 0.5, (48.0, 64.0), 121.5)
    cot = _frames(19, (2,) + eop.spec.dst_shape)
    res = pools(8).run(ranks.collective_sizes, (2, 4), "ell_transpose", cot,
                       _ell_tables(eop))
    src_block = (2 // 2) * (128 // 4) * 96 * 4
    for r in res:
        assert max(r["sizes"]["all_gather"]) < src_block


# ---------------------------------------------------------------------------
# the makers' gradients
# ---------------------------------------------------------------------------


def test_separable_grad(pools):
    H, W, B = 128, 64, 4
    op = _op((H, W), 2.0, 1.0, (0.0, 0.0), 0.0)
    frames = _frames(20, (B, H, W))
    tgt = _frames(21, (B,) + op.spec.dst_shape)
    mesh = _jmesh(2, 4)
    lin = j_sharding.make_sharded_separable_linear(op, mesh, impl="banded")
    tdev = _put(tgt, mesh)
    g_jax = np.asarray(jax.jit(jax.grad(
        lambda f: jnp.sum((lin(f) - tdev) ** 2)))(_put(frames, mesh)))
    res = _run(pools, ranks.grad, (2, 4), frames, _tables(op), tgt)
    np.testing.assert_allclose(res[0]["grad"], g_jax, atol=ATOL_GRAD)
    np.testing.assert_allclose(
        res[0]["grad"], _torch_grad(_port_sep(op), frames, tgt),
        atol=ATOL_GRAD)
    assert res[0]["dtype"] == "torch.float32"


@pytest.mark.parametrize("angle", (90.0, 180.0))
def test_separable_grad_folded_quadrant(pools, angle):
    H = W = 128
    op = _op((H, W), 2.0, 1.0, (0.0, 0.0), angle)
    frames = _frames(22, (2, H, W))
    tgt = _frames(23, (2,) + op.spec.dst_shape)
    mesh = _jmesh(2, 4)
    lin = j_sharding.make_sharded_separable_linear(op, mesh, impl="banded")
    tdev = _put(tgt, mesh)
    g_jax = np.asarray(jax.jit(jax.grad(
        lambda f: jnp.sum((lin(f) - tdev) ** 2)))(_put(frames, mesh)))
    res = _run(pools, ranks.grad, (2, 4), frames, _tables(op), tgt,
               "banded")
    np.testing.assert_allclose(res[0]["grad"], g_jax, atol=2e-4)
    np.testing.assert_allclose(
        res[0]["grad"], _torch_grad(_port_sep(op), frames, tgt), atol=2e-4)


@pytest.mark.parametrize("explicit", (False, True))
def test_ell_grad(pools, explicit):
    op = _ell((64, 64), 2.0, 1.12, (0.0, 0.0), 25.0)
    assert op.spec.dst_shape[0] % 4 == 0 == op.spec.qrot_shape[0] % 4
    frames = _frames(24, (2, 64, 64))
    mesh = _jmesh(2, 4)
    lin = j_sharding.make_sharded_ell_linear(op, mesh, impl="xla")
    base, w = jnp.asarray(op.base), jnp.asarray(op.weights, jnp.float32)
    g_jax = np.asarray(jax.jit(jax.grad(
        lambda f: jnp.sum(lin(f, base, w) ** 2)))(_put(frames, mesh)))
    res = _run(pools, ranks.grad, (2, 4), frames, _ell_tables(op), None,
               "auto", explicit)
    np.testing.assert_allclose(res[0]["grad"], g_jax, atol=ATOL_GRAD)
    np.testing.assert_allclose(
        res[0]["grad"], _torch_grad(_port_ell(op), frames),
        atol=ATOL_GRAD)


def test_ell_linear_fold_only_geometry(pools):
    # 74 true dst rows over 4 row shards: the fold makes it divide; the
    # explicit tables fold on their device
    op = _ell((128, 96), 1.0, 0.5, (48.0, 64.0), 121.5)
    assert op.spec.dst_shape[0] % 4 != 0
    frames = _frames(25, (2, 128, 96))
    fdev = jnp.asarray(frames)
    res = _run(pools, ranks.grad, (2, 4), frames, _ell_tables(op), None,
               "auto", True)
    ref = np.asarray(aa.apply_operator(op, fdev, impl="xla"))
    np.testing.assert_allclose(res[0]["out"], ref, atol=ATOL)
    g_ref = np.asarray(jax.grad(lambda f: jnp.sum(
        aa.apply_operator(op, f, impl="xla") ** 2))(fdev))
    np.testing.assert_allclose(res[0]["grad"], g_ref, atol=ATOL_GRAD)
    np.testing.assert_allclose(
        res[0]["grad"], _torch_grad(_port_ell(op), frames),
        atol=ATOL_GRAD)


def test_ell_eager_fold_only_geometry(pools):
    op = _ell((128, 96), 1.0, 0.5, (48.0, 64.0), 121.5)
    frames = _frames(26, (2, 128, 96))
    mesh = _jmesh(2, 4)
    ref = np.asarray(j_sharding.sharded_apply_ell(jnp.asarray(frames), op,
                                                  mesh, impl="xla"))
    res = _run(pools, ranks.ell, (2, 4), frames, _ell_tables(op))
    np.testing.assert_allclose(res[0]["out"], ref, atol=ATOL)


def test_impl_typos_raise():
    port_sep = _port_sep(_op((128, 64), 2.0, 1.0, (0.0, 0.0), 0.0))
    port_ell = _port_ell(_ell((128, 96), 1.0, 0.5, (48.0, 64.0), 14.0))
    cot = torch.zeros((2, 64, 32))
    for fn in (t_sharding.sharded_apply_separable_transpose,
               t_sharding.sharded_apply_separable_2d_transpose):
        with pytest.raises(ValueError, match="unknown impl"):
            fn(cot, port_sep, None, impl="palas")
        # the kernel route needs a CUDA tensor
        with pytest.raises(ValueError, match="needs a CUDA tensor"):
            fn(cot, port_sep, None, impl="kernel")
    for maker in (t_sharding.make_sharded_separable_linear,
                  t_sharding.make_sharded_separable_2d_linear):
        with pytest.raises(ValueError, match="unknown impl"):
            maker(port_sep, None, impl="palas")
    for maker in (t_sharding.make_sharded_ell_linear,
                  t_sharding.make_sharded_ell_2d_linear):
        with pytest.raises(ValueError, match="unknown impl"):
            maker(port_ell, None, impl="sheared")


@pytest.mark.parametrize("mesh_shape", ((1, 4), (2, 2)))
def test_grad_vs_unsharded_rank_function(pools, mesh_shape):
    # the card test's rank function (tests/test_torch_sharded_cuda.py)
    # over gloo on the CPU, where the routes are plain
    res = pools(4).run(ranks.sharded_grad_vs_unsharded, mesh_shape)
    ranks.check_sharded_grad_vs_unsharded(res, on_card=False)
