"""The port's 2-D (rows x cols) sharded transposes and autograd wrappers
(``aainterp_torch.parallel.sharding``: ``sharded_apply_separable_2d_
transpose``, ``sharded_apply_ell_2d_transpose``, ``make_sharded_
separable_2d_linear``, ``make_sharded_ell_2d_linear``, ``_halo_reduce``
over the cols dim) against the JAX package's on the 8-device virtual CPU
mesh (tests/conftest.py), the cases of tests/test_sharded_2d.py:230-304
and tests/test_sharded_ell_2d.py:208-293; and the 2-D rot90 route on
uneven column blocks.

The port's ranks are gloo processes on the CPU, one torch thread each,
started once for the module (``RankPool``, 4 and 8 ranks); their side is
in tests/torch_dist_ranks.py, which imports no jax.  On a mesh whose rows
and columns are cut in two each, (1, 2, 2), a rot90 route's rotated
counts divide only if the source's do too, so the uneven-column case
runs on (1, 1, 4).  Tolerances: separable float32 atol 1e-5 (gradients
1e-4, JAX's), ELL float32 atol 1e-5, the adjoint identity rel 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import aainterp as aa
from aainterp import autodiff as j_autodiff
from aainterp.ops.weights import fold_quadrant_ell
from aainterp.parallel import sharding as j_sharding

import torch_dist_ranks as ranks
from aainterp_torch.parallel import sharding as t_sharding
from test_torch_sharded import _run, _tables, plan_cache_dir, pools  # noqa
from test_torch_sharded_2d import _jmesh3, _op, _put3
from test_torch_sharded_autodiff import (_ell, _frames, _port_ell,
                                         _port_sep, _torch_grad)
from test_torch_sharded_ell import _tables as _ell_tables

pytestmark = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs 8 (virtual) devices")

ATOL = 1e-5
ATOL_GRAD = 1e-4
RTOL_ADJOINT = 1e-5


def _jax_t2(fn, cot, op, mesh_shape, **kw):
    mesh = _jmesh3(*mesh_shape)
    return np.asarray(jax.jit(lambda c: fn(c, op, mesh, **kw))(
        _put3(cot, mesh)))


def _ref_t(op, cot, **kw):
    return np.asarray(j_autodiff.apply_operator_transpose(
        op, jnp.asarray(cot), **kw))


# ---------------------------------------------------------------------------
# the rot90 route on uneven column blocks (failed before the repaired
# gather)
# ---------------------------------------------------------------------------


def test_uneven_column_blocks_separable(pools):
    # 32 x 30 at 90 deg on (1, 1, 4): the fold's x band (30 source
    # columns) does not divide 4; the rot90 route runs on column blocks
    # of 8, 8, 8 and 6
    H, W = 32, 30
    op = _op((H, W), 2.0, 1.0, (0.0, 0.0), 90.0)
    assert j_sharding._folded_sharded_bands_2d(op, 1, 4) is None
    frames = _frames(30, (2, H, W))
    mesh = _jmesh3(1, 1, 4)
    ref = np.asarray(jax.jit(lambda f: j_sharding.sharded_apply_separable_2d(
        f, op, mesh))(jnp.asarray(frames)))
    res = _run(pools, ranks.separable, (1, 1, 4), frames, _tables(op))
    assert "error" not in res[0], res[0]
    np.testing.assert_allclose(res[0]["out"], ref, atol=ATOL)
    cot = _frames(31, (2,) + op.spec.dst_shape, -1.0, 1.0)
    ref_t = np.asarray(jax.jit(
        lambda c: j_sharding.sharded_apply_separable_2d_transpose(
            c, op, mesh))(jnp.asarray(cot)))
    np.testing.assert_allclose(ref_t, _ref_t(op, cot, impl="xla"),
                               atol=ATOL)
    res = _run(pools, ranks.transpose, (1, 1, 4), cot, _tables(op))
    np.testing.assert_allclose(res[0]["out"], ref_t, atol=ATOL)
    assert [r["local"].shape[-1] for r in res] == [8, 8, 8, 6]


@pytest.mark.parametrize("kernel", (False, True))
def test_uneven_column_blocks_ell(pools, kernel):
    # 32 x 31 at 97 deg, 1.0 -> 1.0 on (1, 1, 4): the fold's source
    # columns (31) do not divide 4, the rot90 route's (32) do
    H, W = 32, 31
    op = _ell((H, W), 1.0, 1.0, (W / 2, H / 2), 97.0)
    assert fold_quadrant_ell(op)[0].spec.qrot_shape[1] % 4
    assert op.spec.dst_shape[1] % 4 == 0 == op.spec.qrot_shape[1] % 4
    frames = _frames(32, (2, H, W))
    mesh = _jmesh3(1, 1, 4)
    ref = np.asarray(jax.jit(lambda f: j_sharding.sharded_apply_ell_2d(
        f, op, mesh, impl="xla"))(jnp.asarray(frames)))
    np.testing.assert_allclose(
        ref, np.asarray(aa.apply_operator(op, jnp.asarray(frames))),
        atol=ATOL)
    res = _run(pools, ranks.ell, (1, 1, 4), frames, _ell_tables(op), "auto",
               False, kernel)
    assert "error" not in res[0], res[0]
    np.testing.assert_allclose(res[0]["out"], ref, atol=ATOL)
    if not kernel:
        cot = _frames(33, (2,) + op.spec.dst_shape, -1.0, 1.0)
        res = _run(pools, ranks.transpose, (1, 1, 4), cot, _ell_tables(op))
        np.testing.assert_allclose(res[0]["out"], _ref_t(op, cot),
                                   atol=ATOL)
        assert [r["local"].shape[-1] for r in res] == [8, 8, 8, 7]


# ---------------------------------------------------------------------------
# the separable transpose and its maker
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh_shape", ((2, 2, 2), (1, 2, 2), (1, 2, 4)))
def test_2d_transpose_dot_identity(pools, mesh_shape):
    """<A x, y> == <x, A^T y> with both sides on the 2-D mesh, and A^T y
    against JAX's sharded and unsharded adjoints."""
    op = _op((128, 64), 2.0, 1.0, (0.0, 0.0), 0.0)
    x = _frames(34, (2, 128, 64))
    y = _frames(35, (2,) + op.spec.dst_shape)
    ref = _jax_t2(j_sharding.sharded_apply_separable_2d_transpose, y, op,
                  mesh_shape)
    np.testing.assert_allclose(ref, _ref_t(op, y), atol=ATOL)
    res = _run(pools, ranks.transpose, mesh_shape, y, _tables(op))
    np.testing.assert_allclose(res[0]["out"], ref, atol=ATOL)
    lhs, rhs = _run(pools, ranks.adjoint_pair, mesh_shape, x, y,
                    _tables(op))[0]
    np.testing.assert_allclose(lhs, rhs, rtol=RTOL_ADJOINT)


@pytest.mark.parametrize("mesh_shape", ((2, 2, 2), (1, 2, 2)))
@pytest.mark.parametrize("ang", (90.0, 180.0, 270.0))
def test_2d_transpose_quadrant(pools, mesh_shape, ang):
    op = _op((64, 64), 2.0, 1.0, (4.0, 7.0), ang)
    assert op.spec.quadrant != 0
    assert j_sharding._folded_sharded_bands_2d(op, 2, 2) is not None
    g = _frames(36, (2,) + op.spec.dst_shape)
    ref = _jax_t2(j_sharding.sharded_apply_separable_2d_transpose, g, op,
                  mesh_shape)
    np.testing.assert_allclose(ref, _ref_t(op, g), atol=ATOL)
    res = _run(pools, ranks.transpose, mesh_shape, g, _tables(op))
    np.testing.assert_allclose(res[0]["out"], ref, atol=ATOL)


def test_2d_transpose_rot90_route(pools):
    # 90 deg on (1, 2, 4) at 64 x 68: the fold's x band does not divide
    # 4 columns, the rot90 route's counts do; rotated back after
    op = _op((64, 68), 2.0, 1.0, (0.0, 0.0), 90.0)
    assert j_sharding._folded_sharded_bands_2d(op, 2, 4) is None
    g = _frames(37, (1,) + op.spec.dst_shape)
    ref = _jax_t2(j_sharding.sharded_apply_separable_2d_transpose, g, op,
                  (1, 2, 4))
    np.testing.assert_allclose(ref, _ref_t(op, g), atol=ATOL)
    res = _run(pools, ranks.transpose, (1, 2, 4), g, _tables(op))
    np.testing.assert_allclose(res[0]["out"], ref, atol=ATOL)


@pytest.mark.parametrize("ang", (0.0, 90.0))
def test_2d_grad(pools, ang):
    op = _op((128, 64), 2.0, 1.0, (0.0, 0.0), ang)
    x = _frames(38, (2, 128, 64))
    tgt = _frames(39, (2,) + op.spec.dst_shape)
    mesh = _jmesh3(2, 2, 2)
    lin = j_sharding.make_sharded_separable_2d_linear(op, mesh)
    tdev = _put3(tgt, mesh)
    g_jax = np.asarray(jax.jit(jax.grad(
        lambda f: jnp.sum((lin(f) - tdev) ** 2)))(_put3(x, mesh)))
    res = _run(pools, ranks.grad, (2, 2, 2), x, _tables(op), tgt)
    np.testing.assert_allclose(res[0]["grad"], g_jax, atol=ATOL_GRAD)
    np.testing.assert_allclose(res[0]["grad"],
                               _torch_grad(_port_sep(op), x, tgt),
                               atol=ATOL_GRAD)


# ---------------------------------------------------------------------------
# the ELL transpose and its maker
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh_shape", ((2, 2, 2), (1, 2, 2)))
def test_2d_ell_transpose_matches_jax(pools, mesh_shape):
    op = _ell((128, 96), 1.0, 0.5, (48.0, 64.0), 14.0)
    cot = _frames(40, (2,) + op.spec.dst_shape, -1.0, 1.0)
    ref = _jax_t2(j_sharding.sharded_apply_ell_2d_transpose, cot, op,
                  mesh_shape)
    np.testing.assert_allclose(ref, _ref_t(op, cot), atol=ATOL)
    res = _run(pools, ranks.transpose, mesh_shape, cot, _ell_tables(op))
    np.testing.assert_allclose(res[0]["out"], ref, atol=ATOL)
    assert res[0]["dtype"] == "torch.float32"
    lhs, rhs = _run(pools, ranks.adjoint_pair, mesh_shape,
                    _frames(41, (2, 128, 96)),
                    _frames(42, (2,) + op.spec.dst_shape),
                    _ell_tables(op))[0]
    np.testing.assert_allclose(lhs, rhs, rtol=RTOL_ADJOINT)


@pytest.mark.parametrize("mesh_shape", ((2, 2, 2), (1, 2, 2)))
@pytest.mark.parametrize("angle", (121.5, 211.5, 301.5))
def test_2d_ell_transpose_quadrant_folded(pools, mesh_shape, angle):
    op = _ell((128, 96), 1.0, 0.5, (48.0, 64.0), angle)
    assert op.spec.quadrant in (1, 2, 3)
    cot = _frames(43, (2,) + op.spec.dst_shape, -1.0, 1.0)
    ref = _jax_t2(j_sharding.sharded_apply_ell_2d_transpose, cot, op,
                  mesh_shape)
    np.testing.assert_allclose(ref, _ref_t(op, cot), atol=ATOL)
    res = _run(pools, ranks.transpose, mesh_shape, cot, _ell_tables(op))
    np.testing.assert_allclose(res[0]["out"], ref, atol=ATOL,
                               err_msg=str(angle))


def test_2d_ell_transpose_explicit_tables(pools):
    op = _ell((128, 96), 1.0, 0.5, (48.0, 64.0), 211.5)
    cot = _frames(44, (2,) + op.spec.dst_shape, -1.0, 1.0)
    ref = _jax_t2(j_sharding.sharded_apply_ell_2d_transpose, cot, op,
                  (2, 2, 2), base=jnp.asarray(op.base),
                  weights=jnp.asarray(op.weights, jnp.float32))
    res = _run(pools, ranks.transpose, (2, 2, 2), cot, _ell_tables(op),
               None, "float32")
    np.testing.assert_allclose(res[0]["out"], ref, atol=ATOL)


@pytest.mark.parametrize("explicit", (False, True))
def test_2d_ell_grad(pools, explicit):
    op = _ell((128, 96), 1.0, 0.5, (48.0, 64.0), 14.0)
    frames = _frames(45, (2, 128, 96))
    mesh = _jmesh3(2, 2, 2)
    lin = j_sharding.make_sharded_ell_2d_linear(op, mesh, impl="xla")
    base, w = jnp.asarray(op.base), jnp.asarray(op.weights, jnp.float32)
    g_jax = np.asarray(jax.jit(jax.grad(
        lambda f: jnp.sum(lin(f, base, w) ** 2)))(_put3(frames, mesh)))
    res = _run(pools, ranks.grad, (2, 2, 2), frames, _ell_tables(op), None,
               "auto", explicit)
    np.testing.assert_allclose(res[0]["grad"], g_jax, atol=ATOL_GRAD)
    np.testing.assert_allclose(res[0]["grad"],
                               _torch_grad(_port_ell(op), frames),
                               atol=ATOL_GRAD)


def test_2d_ell_transpose_steep_multihop_cols(pools):
    """Multi-hop over the column ring: 31 deg on a 4-way cols mesh, the
    column halo beyond one block."""
    op = _ell((128, 128), 1.0, 0.5, (64.0, 64.0), 31.0)
    blocks = t_sharding._ell_blocks(_port_ell(op), 2, 4)
    halo_x, sb_c = blocks[5], blocks[4]
    assert halo_x > sb_c, blocks
    cot = _frames(46, (1,) + op.spec.dst_shape, -1.0, 1.0)
    ref = _jax_t2(j_sharding.sharded_apply_ell_2d_transpose, cot, op,
                  (1, 2, 4))
    np.testing.assert_allclose(ref, _ref_t(op, cot), atol=ATOL)
    res = _run(pools, ranks.transpose, (1, 2, 4), cot, _ell_tables(op))
    np.testing.assert_allclose(res[0]["out"], ref, atol=ATOL)


@pytest.mark.parametrize("h", (5, 19))
def test_halo_reduce_cols_is_the_adjoint(pools, h):
    # column blocks of 8 over 4 ranks: one hop, three hops
    x = _frames(47, (2, 6, 32)).astype(np.float64)
    res = _run(pools, ranks.halo_pair, (1, 1, 4), x, h, "cols")
    for r in res:
        assert "error" not in r, r
        np.testing.assert_allclose(*r["dots"], rtol=1e-12)
        assert r["p2p_reduce"] == r["p2p_extend"]
        assert r["shape"] == r["block"]


def test_2d_ell_transpose_traffic_equals_forward(pools):
    # both reverse rings send exactly the forward rings' bytes at f32
    op = _ell((128, 128), 1.0, 0.5, (64.0, 64.0), 31.0)
    frames = _frames(48, (1, 128, 128))
    cot = _frames(49, (1,) + op.spec.dst_shape)
    fwd = pools(8).run(ranks.collective_sizes, (1, 2, 4), "ell", frames,
                       _ell_tables(op))
    bwd = pools(8).run(ranks.collective_sizes, (1, 2, 4), "ell_transpose",
                       cot, _ell_tables(op))
    for f, b in zip(fwd, bwd):
        assert sum(b["sizes"]["p2p"]) == sum(f["sizes"]["p2p"]) > 0
        assert sorted(b["sizes"]["p2p"]) == sorted(f["sizes"]["p2p"])
        assert b["sizes"]["all_gather"] == [] == b["sizes"]["all_reduce"]


def test_2d_folded_transpose_gathers_no_source(pools):
    op = _op((128, 128), 2.0, 1.0, (2.0, 6.0), 90.0)
    cot = _frames(50, (2,) + op.spec.dst_shape)
    res = pools(8).run(ranks.collective_sizes, (2, 2, 2),
                       "separable_transpose", cot, _tables(op))
    src_block = (2 // 2) * (128 // 2) * (128 // 2) * 4
    for r in res:
        assert max(r["sizes"]["all_gather"]) <= 2 * r["block"] < src_block


def test_grad_vs_unsharded_rank_function_2d(pools):
    # the card test's rank function over gloo on the CPU, mesh (1, 2, 2)
    res = pools(4).run(ranks.sharded_grad_vs_unsharded, (1, 2, 2))
    ranks.check_sharded_grad_vs_unsharded(res, on_card=False)
