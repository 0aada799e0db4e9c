"""Kernel 2's direct form (``csrc/separable_apply_2d.cu``) on the CPU: its
host plan, and the wrapper's plain version against the JAX package.

Band pairs whose one-pixel staged block exceeds the card's shared memory
(thumbnails of 4K and 8K frames, a global box mean, the 480-tap cell of
``chip_smoke.py``) take the direct form: a y pass over the source columns
[c0, c0 + span) of ``cuda_apply_2d.direct_columns``, then an x pass.
Here:

* the planner picks the direct form for those tables, and kernel 1's
  planner hands them to kernel 2, while 4K -> 32 x 18 stays staged;
* every tap of every dst pixel lies inside the direct form's host tables,
  and every tap inside the image inside [c0, c0 + span) (brute force);
* ``apply_separable_kernel_2d`` on CPU tensors (the plain version) against
  the function the JAX package runs for these shapes on the TPU,
  ``aainterp.ops.apply.apply_separable_banded`` (XLA; its 2-D Pallas
  kernel is not used for them), at a 242-tap band pair on 2 x 960 x 1920
  f32 frames: rtol 1e-6, atol 1e-6 (f32 sums in another order);
* 'default' and 'bf16x3' against the JAX 2-D kernel's contractions
  (its ``_split_bf16`` and ``_dot_bf16x3``; 'default' one pass of bf16
  operands) on the dense operators, since its 2-D kernel rejects these
  bands, with tests/test_torch_regrid_apply.py's tolerances: 'bf16x3'
  rtol 1e-5, atol 1e-6 (both split the operands the same way, sums in
  another order); 'default' within 1e-2 relative (a y sum that rounds to
  the other bf16 neighbour).  Both tolerances admit IEEE f32 sums too, so
  each mode's result must also lie ten times nearer its reference than
  'auto''s does.

The kernel itself runs in tests/test_torch_kernel_cuda.py on a GPU.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import aainterp as aa
from aainterp.ops.apply import apply_separable_banded
from aainterp.ops.pallas_apply import apply_separable_pallas_2d
from aainterp.ops.weights import separable_operator

import aainterp_torch as at
from aainterp_torch import api as t_api
from aainterp_torch.ops import cuda_apply, cuda_apply_2d


def _port_tables(shape, ratio):
    """The port's kernel tables (ys, yw, xs, xw) of a ``ratio`` x
    downscale of ``shape`` frames, as ``apply_operator`` gives them."""
    op = at.build_operator(at.make_grid_spec(shape, ratio, 1.0, (0, 0), 0))
    return tuple(np.asarray(t) for t in
                 at.separable_linear_for(op, torch.float32, "kernel").tables)


def _wide_cell():
    """chip_smoke.py's 480-tap cell: 480 x 480 -> 4 x 4, one box each."""
    ys, yw = np.zeros(4, np.int32), np.full((4, 480), 1 / 480, np.float32)
    return ys, yw, ys, yw


def _mean_tables():
    by, bx = t_api.resize_bands((1800, 3600), (1, 1))
    return (by.start, by.weights.astype(np.float32), bx.start,
            bx.weights.astype(np.float32))


DIRECT = {
    "cell_480": (_wide_cell, 480),
    "thumb_4k": (lambda: _port_tables((2160, 3840), 240.0), 3840),
    "thumb_8k": (lambda: _port_tables((4320, 7680), 480.0), 7680),
    "mean_1x1": (_mean_tables, 3600),
}


def _plan(tabs):
    ys, yw, xs, xw = tabs
    return cuda_apply_2d.plan_separable_2d(ys, xs, yw.shape[1], xw.shape[1])


@pytest.mark.parametrize("name", list(DIRECT))
def test_planner_takes_the_direct_form(name):
    tabs = DIRECT[name][0]()
    plan = _plan(tabs)
    assert plan["direct"] and plan["smem"] == 0
    # kernel 1's planner rejects them and its route hands them to kernel 2
    assert cuda_apply._plan_for(*tabs)["kernel_2d"]


def test_planner_keeps_the_staged_form_at_32x18():
    tabs = _port_tables((2160, 3840), 120.0)
    assert tabs[1].shape == (18, 122) and tabs[3].shape == (32, 122)
    plan = _plan(tabs)
    assert not plan["direct"] and 0 < plan["smem"] <= cuda_apply_2d.SMEM_LIMIT
    assert not cuda_apply._plan_for(*tabs)["kernel_2d"]


def _taps_inside(plan, xs, kx, W, vec=1):
    x = xs.astype(np.int64)[:, None] + np.arange(kx)
    assert plan["x_lo"] <= x.min() and x.max() < plan["x_hi"]
    c0, span = cuda_apply_2d.direct_columns(plan, W, vec)
    assert 0 <= c0 and 0 <= span and c0 + span <= W
    assert c0 % vec == 0 and span % vec == 0
    inside = x[(x >= 0) & (x < W)]
    assert ((inside >= c0) & (inside < c0 + span)).all()
    return c0, span


@pytest.mark.parametrize("vec", [1, 4, 8, 16])
@pytest.mark.parametrize("name", list(DIRECT))
def test_direct_columns_hold_every_tap(name, vec):
    # every W here is a multiple of 16: 16-byte chunks of f32, bf16, u8
    make, W = DIRECT[name]
    tabs = make()
    plan = _plan(tabs)
    c0, span = _taps_inside(plan, tabs[2], tabs[3].shape[1], W, vec)
    assert span > 0


@pytest.mark.parametrize("dtype,vec", [(torch.float32, 4),
                                       (torch.bfloat16, 8),
                                       (torch.uint8, 16)])
def test_direct_vec_takes_16_byte_chunks_where_rows_allow(dtype, vec):
    many = cuda_apply_2d.VEC_MIN_COLUMNS
    x = torch.zeros((1, 2, 3840), dtype=dtype)
    assert cuda_apply_2d.direct_vec(x, many) == vec
    # few columns (the 480-tap cell's 15,360): a column a thread
    assert cuda_apply_2d.direct_vec(x, 15360) == 1 < many
    # rows that are not whole 16-byte chunks, or a misaligned start
    assert cuda_apply_2d.direct_vec(torch.zeros((1, 2, 1001), dtype=dtype),
                                    many) == 1
    shifted = torch.zeros(2 * 3840 + 1, dtype=dtype)[1:].view(1, 2, 3840)
    assert cuda_apply_2d.direct_vec(shifted, many) == 1


@pytest.mark.parametrize("seed", range(3))
def test_direct_columns_at_edges_flips_and_gaps(seed):
    # starts off both edges, descending (a flipped quadrant), far apart
    rng = np.random.default_rng(seed)
    W, kx = 700, 300
    xs = np.sort(rng.integers(-350, W + 50, 6)).astype(np.int32)[::-1].copy()
    plan = cuda_apply_2d.plan_separable_2d(np.zeros(3, np.int32), xs, 300,
                                           kx)
    assert plan["direct"]
    _taps_inside(plan, xs, kx, W)
    # every window left of the image: nothing for the y pass to sum
    off = np.array([-400, -350], np.int32)
    plan = cuda_apply_2d.plan_separable_2d(np.zeros(3, np.int32), off, 300,
                                           kx)
    assert cuda_apply_2d.direct_columns(plan, W)[1] == 0


def test_forced_direct_plan_keeps_its_tables(monkeypatch):
    tabs = _port_tables((200, 500), 2.0)
    staged = cuda_apply_2d.make_plan(*tabs)
    assert not staged["direct"] and len(staged["tables"]) == 6
    # no shared memory to spare: the direct form, which uploads the band
    # tables alone
    monkeypatch.setattr(cuda_apply_2d, "SMEM_LIMIT", 0)
    plan = cuda_apply_2d.make_plan(*tabs)
    assert plan["direct"] and len(plan["tables"]) == 4
    assert all(a is b for a, b in zip(plan["tables"], tabs))
    _taps_inside(plan, tabs[2], tabs[3].shape[1], 500)


def _jax_tables(shape, ratio):
    op = separable_operator(aa.make_grid_spec(shape, ratio, 1.0, (0.0, 0.0),
                                              0.0))
    return (np.asarray(op.wy.start, np.int32),
            np.asarray(op.wy.weights, np.float32),
            np.asarray(op.wx.start, np.int32),
            np.asarray(op.wx.weights, np.float32))


@pytest.fixture(scope="module")
def thumb_960():
    tabs = _jax_tables((960, 1920), 240.0)
    assert tabs[1].shape == (4, 242) and tabs[3].shape == (8, 242)
    assert _plan(tabs)["direct"]
    rng = np.random.default_rng(7)
    x = rng.uniform(0, 1, (2, 960, 1920)).astype(np.float32)
    return tabs, x


def test_plain_direct_matches_jax_banded(thumb_960):
    tabs, x = thumb_960
    before = cuda_apply_2d.LAUNCHES
    got = cuda_apply_2d.apply_separable_kernel_2d(torch.from_numpy(x), *tabs)
    assert cuda_apply_2d.LAUNCHES == before      # the plain version
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 4, 8)
    ref = np.asarray(apply_separable_banded(jnp.asarray(x),
                                            *(jnp.asarray(t) for t in tabs)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


def _dense(start, weights, n_src):
    """(n_dst, n_src) f32 matrix of a band (taps outside dropped)."""
    m = np.zeros((weights.shape[0], n_src), np.float32)
    for i, (s0, w) in enumerate(zip(start, weights)):
        a = np.arange(w.shape[0]) + int(s0)
        ok = (a >= 0) & (a < n_src)
        m[i, a[ok]] = w[ok]
    return m


def _jax_kernel_2(x, tabs, precision):
    """The JAX 2-D kernel's two contractions on dense operators, with its
    own operand handling: 'bf16x3' through ``_split_bf16`` and
    ``_dot_bf16x3`` (pallas_apply.py:808-846), 'default' as one pass of
    bf16 operands with f32 sums (the MXU's DEFAULT)."""
    from aainterp.ops.pallas_apply import _dot_bf16x3, _split_bf16

    wy = jnp.asarray(_dense(tabs[0], tabs[1], x.shape[-2]))
    wxt = jnp.asarray(_dense(tabs[2], tabs[3], x.shape[-1]).T)

    def dot(a, b):
        if precision == "bf16x3":
            return _dot_bf16x3(*_split_bf16(a), *_split_bf16(b))
        return jnp.dot(a.astype(jnp.bfloat16), b.astype(jnp.bfloat16),
                       preferred_element_type=jnp.float32)

    return np.stack([np.asarray(dot(dot(wy, jnp.asarray(f)), wxt))
                     for f in x])


@pytest.mark.parametrize("precision,rtol,atol", [("bf16x3", 1e-5, 1e-6),
                                                 ("default", 1e-2, 0.0)])
def test_plain_direct_precisions_match_jax_kernel_2(thumb_960, precision,
                                                    rtol, atol):
    tabs, x = thumb_960
    # the JAX package runs these bands on XLA, not its 2-D kernel
    assert apply_separable_pallas_2d(
        jnp.asarray(x), *(jnp.asarray(t) for t in tabs),
        precision=precision, interpret=True) is None
    got = cuda_apply_2d.apply_separable_kernel_2d(
        torch.from_numpy(x), *tabs, precision=precision).numpy()
    ref = _jax_kernel_2(x, tabs, precision)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)
    # the mode is not ignored: IEEE f32 sums ('auto') lie at least ten
    # times farther from this mode's reference than the mode's own result
    f32 = cuda_apply_2d.apply_separable_kernel_2d(
        torch.from_numpy(x), *tabs, precision="auto").numpy()
    assert np.abs(got - ref).max() * 10 < np.abs(f32 - ref).max()
