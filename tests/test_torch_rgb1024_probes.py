"""rgb1024's probes (``aainterp_torch/probes/rgb1024_experiments.py`` and
``band_probes``' modes ``xonly`` and ``densex``) against the JAX package's
probes in ``benchmarks/rgb1024_experiments.py`` and against float64
statements of their definitions, on the CPU.

The JAX probes take no ``interpret=`` argument: they run under
``pltpu.force_tpu_interpret_mode()``, at a smaller 150 -> 60 dpi geometry
than rgb1024's 1024^2 (256 x 256 -> 102 x 102), set through
``monkeypatch`` of the JAX module's ``H``, ``W``, ``TY`` and ``TX`` (32:
4 row and 4 column blocks, as at 1024^2 with 128), with its ``_build_*``
caches cleared before and after.  The port's plain versions run at the
same geometry on kernel 1's own tables; on a CPU tensor the wrapper takes
them.

* ``ypass`` against the port's ``stagey`` at JAX's columns ``xs[j]``,
  ``xonly`` (the stage ring) and ``xonly_direct`` (its first form) on
  ``[:Hd, :Wd]`` with the same ``tmp[:Hd]``, ``fulldense``
  against ``densex`` on ``[:Hd, :Wd]``: f32 atol 1e-5 on [0, 1] inputs (the
  TPU probes sum through matrix products in another order), bf16 within
  one bf16 ulp.
* ``densex`` in f32 equal to production's plain output bit for bit; its
  dense operator equal to the one JAX builds.  The kernel's arithmetic, a
  bf16 split on the tensor cores, stated in float64
  (``dense_x_split_plain``): f32's four products within 2^-17 ·
  max|plain| of the f32 statement (under ``DENSEX_RTOL``), bf16x3 within
  ``DENSEX_RTOL``, bf16's two products within one bf16 ulp, at the small
  geometry and at one 1024^2 frame, while one bf16 pass misses the f32
  tolerance by more than 10 x; the packed operator unpacks to the table.
* The byte and operation counts, the plans and their shared memory at
  1024^2 (the xonly ring's windows of TY rows and its x table), the entry points with ``device="cpu"`` (no launch, the host's
  clock) and, without a GPU, the default device raising.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aainterp_torch.ops import cuda_apply
from aainterp_torch.probes import band_probes, copy_ceiling
from aainterp_torch.probes import rgb1024_experiments as rgb

SMALL = (256, 256)
HD = WD = 102
BLOCK = 32                 # JAX's TY and TX here
F = 2
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def jrgb(monkeypatch):
    from benchmarks import rgb1024_experiments as jr
    monkeypatch.setattr(jr, "H", SMALL[0])
    monkeypatch.setattr(jr, "W", SMALL[1])
    monkeypatch.setattr(jr, "TY", BLOCK)
    monkeypatch.setattr(jr, "TX", BLOCK)
    _clear(jr)
    return jr


@pytest.fixture(autouse=True)
def _clear_jax_builders():
    yield
    from benchmarks import rgb1024_experiments as jr
    _clear(jr)


def _clear(jr):
    for b in (jr._build_copy, jr._build_band_probe, jr._build_xonly,
              jr._build_full_dense_x):
        b.cache_clear()


def _tables(shape=SMALL):
    return rgb.tables(shape)


def _x(dtype, shape, seed):
    x = np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)
    return torch.from_numpy(x).to(dtype)


def _jx(x: torch.Tensor):
    dt = jnp.bfloat16 if x.dtype == torch.bfloat16 else jnp.float32
    return jnp.asarray(x.float().numpy(), dt)


def _dname(dtype) -> str:
    return "float32" if dtype == torch.float32 else "bfloat16"


def bf16_ulp(x):
    a = np.maximum(np.abs(np.asarray(x, np.float64)), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(a)) - 7)


def _close(got: torch.Tensor, want: np.ndarray):
    """The module's tolerance for ``got``'s dtype."""
    g = got.float().numpy().astype(np.float64)
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape
    if got.dtype == torch.bfloat16:
        assert (np.abs(g - w) <= bf16_ulp(w)).all(), np.abs(g - w).max()
    else:
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


def _interpret(build, *args):
    """``build()(*args)`` in TPU interpret mode (a ``pallas_call`` takes the
    mode where it is built: its builder runs inside the context)."""
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        out = build()(*args)
    return np.asarray(out.astype(jnp.float32))


def _jax_dense_x(op, W):
    """exp_fulldense's (W, Wd_pad) operator (rgb1024_experiments.py:247-
    254), built the JAX file's way."""
    Wd = int(np.asarray(op.wx.weights).shape[0])
    Wd_pad = ((Wd + 127) // 128) * 128
    xs = np.asarray(op.wx.start)
    xw = np.asarray(op.wx.weights, np.float32)
    kx = xw.shape[1]
    wx_dense = np.zeros((W, Wd_pad), np.float32)
    for j in range(Wd):
        wx_dense[xs[j]: xs[j] + kx, j] = xw[j]
    return wx_dense, Wd_pad


# ---------------------------------------------------------------------------
# against the JAX probes (interpret mode, the small geometry)
# ---------------------------------------------------------------------------


def test_small_geometry_has_rgb1024s_blocks(jrgb):
    op, row_base, wy_b, SY, col_base, wx_b, SX = jrgb._geometry()
    assert wy_b.shape[0] == 4 and wx_b.shape[0] == 4       # nty, ntx
    ys, yw, xs, xw = _tables()
    assert (len(ys), len(xs)) == (HD, WD)
    np.testing.assert_array_equal(np.asarray(op.wx.start), xs)
    np.testing.assert_array_equal(np.asarray(op.wx.weights, np.float32), xw)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_ypass_matches_band_probe(jrgb, dtype):
    op, row_base, wy_b, SY, *_ = jrgb._geometry()
    nty = wy_b.shape[0]
    x = _x(dtype, (F,) + SMALL, 1)
    want = _interpret(lambda: jrgb._build_band_probe(F, SY, nty,
                                                     _dname(dtype), True),
                      jnp.asarray(row_base), _jx(x),
                      jnp.asarray(wy_b))[:, :HD]        # (F, Hd, W) y sums
    tables = _tables()
    got = band_probes.band_probe_kernel(x, tables, "stagey")
    assert got.dtype == dtype and got.shape == (F, HD, WD)
    _close(got, want[:, :, tables[2]])


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_xonly_matches_build_xonly(jrgb, dtype):
    op, row_base, wy_b, SY, col_base, wx_b, SX = jrgb._geometry()
    nty, ntx = wy_b.shape[0], wx_b.shape[0]
    tmp = _x(dtype, (F, nty * BLOCK, SMALL[1]), 2)
    want = _interpret(lambda: jrgb._build_xonly(F, nty, ntx, SX,
                                                _dname(dtype)),
                      jnp.asarray(col_base), _jx(tmp),
                      jnp.asarray(wx_b))[:, :HD, :WD]
    before = dict(band_probes.LAUNCHES)
    for mode in ("xonly", "xonly_direct"):
        got = rgb.band_probe_kernel(tmp[:, :HD].contiguous(), _tables(),
                                    mode)
        assert got.dtype == dtype and got.shape == (F, HD, WD)
        _close(got, want)
    assert dict(band_probes.LAUNCHES) == before


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_densex_matches_build_full_dense_x(jrgb, dtype):
    op, row_base, wy_b, SY, *_ = jrgb._geometry()
    nty = wy_b.shape[0]
    wx_dense, Wd_pad = _jax_dense_x(op, SMALL[1])
    tables = _tables()
    # the port's dense operator is JAX's, unpadded
    np.testing.assert_array_equal(
        band_probes.dense_x_table(tables[2], tables[3], SMALL[1]),
        wx_dense[:, :WD])
    x = _x(dtype, (F,) + SMALL, 3)
    jw = jnp.asarray(wx_dense, dtype=jnp.float32 if dtype == torch.float32
                     else jnp.bfloat16)
    want = _interpret(lambda: jrgb._build_full_dense_x(F, SY, nty, Wd_pad,
                                                       _dname(dtype)),
                      jnp.asarray(row_base), _jx(x),
                      jnp.asarray(wy_b), jw)[:, :HD, :WD]
    got = band_probes.band_probe_kernel(x, tables, "densex")
    assert got.dtype == dtype and got.shape == (F, HD, WD)
    _close(got, want)


def test_copy_is_the_rgb1024_copy(jrgb):
    x = _x(torch.bfloat16, (F,) + SMALL, 4)
    want = _interpret(lambda: jrgb._build_copy(F, "bfloat16"), _jx(x))
    got = copy_ceiling.copy_rows_kernel(x, BLOCK)
    np.testing.assert_array_equal(got.float().numpy(), want)


# ---------------------------------------------------------------------------
# the plain versions against float64 statements
# ---------------------------------------------------------------------------


def _dense_y(tables, H):
    ys, yw = tables[0], tables[1]
    wy = np.zeros((len(ys), H))
    for a in range(yw.shape[1]):
        np.add.at(wy, (np.arange(len(ys)), np.clip(ys + a, 0, H - 1)),
                  yw[:, a])
    return wy


@pytest.mark.parametrize("shape", [SMALL, (97, 131)])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_x_modes_meet_their_definitions(shape, dtype):
    tables = rgb.tables(shape)
    ys, yw, xs, xw = tables
    H, W = shape
    tmp = _x(dtype, (F, len(ys), W), 5)
    t64 = tmp.double().numpy()
    want = np.zeros((F, len(ys), len(xs)))
    for b in range(xw.shape[1]):
        want += xw[None, None, :, b] * t64[:, :, np.clip(xs + b, 0, W - 1)]
    for mode in ("xonly", "xonly_direct"):
        _close(band_probes.band_probe_plain(tmp, tables, mode), want)
    x = _x(dtype, (F,) + shape, 6)
    wxd = band_probes.dense_x_table(xs, xw, W)
    wxd = torch.from_numpy(wxd).to(dtype).double().numpy()   # as stored
    want = np.einsum("iy,fyx,xj->fij", _dense_y(tables, H),
                     x.double().numpy(), wxd)
    _close(band_probes.band_probe_plain(x, tables, "densex"), want)


@pytest.mark.parametrize("shape", [SMALL, (97, 131), (64, 160)])
def test_densex_f32_is_production_bit_for_bit(shape):
    tables = rgb.tables(shape)
    x = _x(torch.float32, (F,) + shape, 7)
    got = band_probes.band_probe_plain(x, tables, "densex")
    assert torch.equal(got, band_probes.band_probe_plain(x, tables, "walk2"))


DENSE_GEOMS = [SMALL, (1024, 1024)]


@functools.lru_cache(maxsize=4)
def _split_cases(shape, dtype):
    """T (1 frame; the y pass's f32 sums), the operator in ``dtype`` and
    the plain x pass, the f32 statement (W float64 steps of the frame's
    outputs: on one thread, which is faster than several contending with
    the other test workers)."""
    tables = rgb.tables(shape)
    x = _x(dtype, (1,) + shape, 9)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        t = band_probes.y_sums(x, tables)
        wxd = band_probes._densex_device(tables, shape[1], dtype, "cpu")
        return t, wxd, band_probes.dense_x_sums(t, wxd.float())
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("shape", DENSE_GEOMS, ids=["small", "rgb1024"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_dense_x_split_meets_the_tolerances(shape, dtype):
    t, wxd, plain = _split_cases(shape, dtype)
    if dtype == torch.float32:          # against the f32 statement
        top = float(plain.abs().max())
        for passes, rtol in ((4, 2.0 ** -17), (3, band_probes.DENSEX_RTOL)):
            got = band_probes.dense_x_split_plain(t, wxd, passes)
            d = float((got.double() - plain.double()).abs().max())
            assert d <= rtol * top, passes
    else:                               # hi + lo, stored in bf16
        got = band_probes.dense_x_split_plain(t, wxd, 2).to(dtype)
        want = plain.to(dtype)
        _close(got, want.float().numpy())


@pytest.mark.parametrize("shape", DENSE_GEOMS, ids=["small", "rgb1024"])
def test_one_bf16_pass_misses_the_f32_tolerance(shape):
    t, wxd, plain = _split_cases(shape, torch.float32)
    tol = band_probes.DENSEX_RTOL * float(plain.abs().max())
    one = band_probes.dense_x_split_plain(t, wxd, 1)
    assert float((one.double() - plain.double()).abs().max()) > 10 * tol
    with pytest.raises(ValueError, match="passes"):
        band_probes.dense_x_split_plain(t, wxd, 5)


def _unpack(ops: torch.Tensor, Ws: int, Wd: int) -> torch.Tensor:
    """``pack_dense_x``'s image back to (parts, Ws, Wd) float32, element
    by element at its core-matrix offset."""
    n_cb, nc, parts, size = ops.shape
    nb, kc = size // 32, 32
    n = np.arange(nb)[:, None]
    k = np.arange(kc)[None, :]
    off = torch.from_numpy(((n // 8) * 4 + k // 8) * 64 + (n % 8) * 8
                           + k % 8)
    out = torch.zeros(parts, nc * kc, n_cb * nb)
    for b in range(n_cb):
        for c in range(nc):
            for p in range(parts):
                img = ops[b, c, p].float()[off]         # (nb, kc): [n, k]
                out[p, c * kc:(c + 1) * kc, b * nb:(b + 1) * nb] = img.T
    return out[:, :Ws, :Wd]


@pytest.mark.parametrize("shape", [SMALL, (97, 131), (64, 1000)])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_packed_operator_unpacks_to_the_table(shape, dtype):
    tables = rgb.tables(shape)
    W = shape[1]
    table = torch.from_numpy(band_probes.dense_x_table(tables[2], tables[3],
                                                       W))
    wxd = table.to(dtype)
    ops = band_probes.pack_dense_x(wxd)
    # f32: blocks of 416 columns (two warpgroups), bf16: of 208
    nb = 416 if dtype == torch.float32 else 208
    assert band_probes.DENSE_WARPGROUPS[dtype.itemsize] * 208 == nb
    parts = 2 if dtype == torch.float32 else 1
    assert ops.dtype == torch.bfloat16 and ops.shape == (
        -(-table.shape[1] // nb), -(-W // 32), parts, nb * 32)
    got = _unpack(ops, *table.shape)
    hi = wxd.float().to(torch.bfloat16)
    assert torch.equal(got[0], hi.float())
    if dtype == torch.float32:
        lo = (table - hi.float()).to(torch.bfloat16)
        assert torch.equal(got[1], lo.float())
        # hi + lo carries the f32 operator to 2^-16 of each weight
        d = (got[0].double() + got[1].double() - table.double()).abs()
        assert bool((d <= table.double().abs() * 2.0 ** -16).all())
    else:
        assert torch.equal(got[0], wxd.float())   # exact in bf16
    # the padding past W and Wd is zeros
    full = ops.float().sum()
    assert float(full) == pytest.approx(float(sum(g.sum() for g in got)))


def test_pack_dense_x_rejects_other_operators():
    with pytest.raises(ValueError, match="2-D float32 or bfloat16"):
        band_probes.pack_dense_x(torch.zeros(4, 4, dtype=torch.float64))
    with pytest.raises(ValueError, match="2-D float32 or bfloat16"):
        band_probes.pack_dense_x(torch.zeros(4))


def test_dense_x_table_drops_taps_outside_the_image():
    xs = np.array([0, 3, 5])
    xw = np.array([[0.5, 0.5, 0.0], [0.25, 0.5, 0.25], [0.5, 0.25, 0.25]],
                  np.float32)
    tab = band_probes.dense_x_table(xs, xw, 6)
    want = np.zeros((6, 3), np.float32)
    want[0:3, 0] = xw[0]
    want[3:6, 1] = xw[1]
    want[5, 2] = xw[2, 0]               # columns 6 and 7 lie outside
    np.testing.assert_array_equal(tab, want)


# ---------------------------------------------------------------------------
# plans, shared memory, byte counts, errors
# ---------------------------------------------------------------------------


def test_rgb1024_plans_and_shared_memory():
    tables = rgb.tables()
    plan = band_probes._plan(tables)
    assert (plan["TY"], plan["TX"], plan["SY"], plan["SX"]) == (8, 240, 21,
                                                                600)
    # the ring's xonly stages its tile's 8 rows alone; its first form
    # production's window of SY rows
    assert band_probes.window_rows(plan, "xonly") == 8
    assert band_probes.window_rows(plan, "xonly_direct") == 21
    for elem, dense_smem in ((2, 64000), (4, 164352)):
        # xonly_direct: production's layout, as stagey's first form
        assert band_probes.smem_bytes(plan, "xonly_direct", 1024, 410, 4,
                                      elem) == \
            band_probes.smem_bytes(plan, "stagey_direct", 1024, 410, 4, elem)
        # densex (csrc/dense_x.cu): 7 row tiles of 64 whose taps span 161
        # rows, 32 chunks of 32 columns; two stages of the chunk's operator
        # (f32: hi and lo) and T's hi and lo, and two windows of 161 rows
        dp = band_probes.densex_plan(tables, 1024)
        assert (dp["n_rt"], dp["nc"], dp["Ws"], dp["SY"]) == (7, 32, 1024,
                                                               161)
        np.testing.assert_array_equal(dp["tables"][2], [0, 159, 319, 479,
                                                        639, 799, 959])
        parts, nw = (2, 2) if elem == 4 else (1, 1)
        window = -(-161 * 32 * elem // 128) * 128
        assert dense_smem == 256 + 2 * 2 * 32 * (parts * nw * 208 + 128) \
            + 2 * window
        assert band_probes.dense_x_smem(elem, 161) == dense_smem
        assert band_probes.dense_x_window(161, 1024, elem)
    # no box for rows of a ragged number of 16-byte chunks, nor past 256
    # rows: the y pass then reads global memory
    assert not band_probes.dense_x_window(161, 1022, 2)
    assert not band_probes.dense_x_window(257, 1024, 2)
    assert band_probes.dense_x_window(256, 1024, 4)
    assert band_probes.smem_bytes(plan, "stagey_direct", 1024, 410, 4, 4) <= \
        cuda_apply.band_smem(8, 240, 21, 600, 4)


@pytest.mark.parametrize("elem", [2, 4])
def test_stage_ring_shared_memory_at_rgb1024(elem):
    # the stage ring's layout at rgb1024's plan (SY 21, SX 600): n windows
    # (each with its tap table and two mbarriers), T for stagey alone,
    # output tiles of 8 rows of 240 dst pixels (stage two, stagey one), no
    # zero row
    tables = rgb.tables()
    plan = band_probes._plan(tables)

    def up16(v):
        return -(-v // 16) * 16

    pitch = band_probes._seg_pitch(600 * elem, 1024 * elem)
    window = up16(32 + 21 * pitch)
    out_tile = up16(32 + 8 * band_probes._seg_pitch(240 * elem, 410 * elem))
    n = band_probes.STAGE_SLOTS
    stage = band_probes.smem_bytes(plan, "stage", 1024, 410, 4, elem)
    stagey = band_probes.smem_bytes(plan, "stagey", 1024, 410, 4, elem)
    assert stage == n * (window + 32 + 16) + 2 * out_tile
    # T: 8 rows of 600 f32 (stage_t_pitch, a multiple of 4 already); one
    # output tile
    assert band_probes.stage_t_pitch(600) == 600
    assert stagey == n * (window + 8 * 8 * 4 + 32 + 16) + 8 * 600 * 4 \
        + out_tile
    assert max(stage, stagey) <= band_probes.SMEM_LIMIT


@pytest.mark.parametrize("elem", [2, 4])
def test_xonly_ring_geometry_at_rgb1024(elem):
    # two windows of the tile's 8 rows of the y pass's output (each with
    # its two mbarriers), no tap table, no T, no output tile; the x table
    # once a block: 4 rows of weights and one of offsets, 410 columns
    # rounded up to 412
    tables = rgb.tables()
    plan = band_probes._plan(tables)

    def up16(v):
        return -(-v // 16) * 16

    pitch = band_probes._seg_pitch(600 * elem, 1024 * elem)
    window = up16(32 + 8 * pitch)
    ring = band_probes.smem_bytes(plan, "xonly", 1024, 410, 4, elem)
    assert ring == 2 * (window + 16) + 5 * 412 * 4
    # less than the first form's one window of 21 rows, T and an output
    # tile, though it holds two windows: room for 4 blocks an SM or more
    direct = band_probes.smem_bytes(plan, "xonly_direct", 1024, 410, 4,
                                    elem)
    assert ring < direct and 233472 // (ring + 1024) >= 4
    assert "xonly" in band_probes.RING_MODES
    assert "xonly_direct" in band_probes.DIRECT_MODES
    assert band_probes.MODES["xonly_direct"] == 11


@pytest.mark.parametrize("elem", [2, 4])
def test_xonly_ring_geometry_at_an_upsampling_band(elem):
    # 64 x 160 at 1 -> 2: 2-tap x bands, SY 5 under TY 8: the ring's
    # windows still hold the tile's 8 rows of the y pass's output (its
    # first form's, production's layout, SY rows raised to TY), the x
    # table 2 rows of weights and one of offsets, 320 columns
    tables = band_probes.flagship_tables((64, 160), 1.0, 2.0)
    plan = band_probes._plan(tables)
    assert plan["SY"] < plan["TY"] == 8 and tables[3].shape == (320, 2)
    assert band_probes.window_rows(plan, "xonly") == 8
    assert band_probes.window_rows(plan, "xonly_direct") == 8
    pitch = band_probes._seg_pitch(plan["SX"] * elem, 160 * elem)
    window = -(-(32 + 8 * pitch) // 16) * 16
    assert band_probes.smem_bytes(plan, "xonly", 160, 320, 2, elem) == \
        2 * (window + 16) + 3 * 320 * 4
    assert plan["tables"][3].shape[1] <= band_probes.RING_X_TAPS


def test_xonly_wide_x_bands_take_the_plain_function():
    # 20:1 has 22-tap x bands, more than the ring's registers hold (on the
    # card it refuses them before any launch, naming the mode); its first
    # form and the plain version take them, and on the CPU both modes are
    # the plain function
    tables = band_probes.flagship_tables((40, 960), 20.0, 1.0)
    tmp = _x(torch.float32, (1, len(tables[0]), 960), 9)
    assert tables[3].shape[1] == 22 > band_probes.RING_X_TAPS
    want = band_probes.band_probe_plain(tmp, tables, "xonly")
    for mode in ("xonly", "xonly_direct"):
        assert torch.equal(band_probes.band_probe_kernel(tmp, tables, mode),
                           want)


@pytest.mark.parametrize("F", [1, 24, 25])
@pytest.mark.parametrize("blocks", [132, 264, 528, 2496, 10 ** 5])
def test_stage_grid_deals_every_tile_once(F, blocks):
    # rgb1024: two strips (240 and 170 dst columns), 52 row tiles (the last
    # of 2 rows); the ring's persistent grid deals each tile to one block,
    # round-robin (the blocks' k-th tiles then lie side by side)
    tables = rgb.tables()
    plan = band_probes._plan(tables)
    n_strip, n_rt = -(-410 // plan["TX"]), -(-410 // plan["TY"])
    assert (n_strip, n_rt) == (2, 52)
    items = F * n_strip * n_rt
    shares = band_probes.stage_shares(items, blocks)
    grid = min(items, blocks)
    assert len(shares) == grid
    sizes = [len(sh) for sh in shares]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    assert sorted(i for sh in shares for i in sh) == list(range(items))
    for k in range(max(sizes)):
        kth = [sh[k] for sh in shares if k < len(sh)]
        assert kth == list(range(k * grid, k * grid + len(kth)))


def test_densex_plan_halves_rows_and_keeps_one_strip():
    # the tensor-core kernel halves no rows: its blocks keep 64 dst rows at
    # any width, K walks the source columns in chunks of 32, and shared
    # memory holds two chunks (dense_x_smem), not a row
    tables = band_probes.flagship_tables()          # 4K: 3840 columns
    dp = band_probes.densex_plan(tables, 3840)
    assert (dp["n_rt"], dp["nc"]) == (-(-1080 // 64), 3840 // 32)
    assert band_probes.dense_x_window(dp["SY"], 3840, 4)
    # upsampling: the window of xonly holds the tile's TY rows
    plan = band_probes._plan(band_probes.flagship_tables((64, 160), 1.0,
                                                         2.0))
    assert plan["SY"] < plan["TY"] == band_probes.window_rows(plan, "xonly")
    # the width that raised "shared memory" before now plans: 1875 chunks,
    # the last one whole
    wide = band_probes.flagship_tables((8, 60000), 2.0, 1.0)
    assert band_probes.densex_plan(wide, 60000)["nc"] == 1875


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_densex_plan_is_cached_and_uploads_as_kernel_1s(dtype):
    tables = band_probes.flagship_tables((64, 160), 150.0, 60.0)
    dp = band_probes.densex_plan(tables, 160)
    assert band_probes.densex_plan(tables, 160) is dp
    dev = cuda_apply._device_tables(dp, "cpu")
    assert cuda_apply._device_tables(dp, "cpu") is dev
    # kernel 1's y tables, ys and yw, and each 64-row tile's first tap row
    assert len(dev) == 3
    for host, got in zip(dp["tables"], dev):
        np.testing.assert_array_equal(got.numpy(), host)
    for host, want in zip(dp["tables"], tables[:2]):
        np.testing.assert_array_equal(host, want)
    base, SY = cuda_apply._tiles(tables[0].astype(np.int64),
                                 tables[1].shape[1], 64)
    np.testing.assert_array_equal(dp["tables"][2], base)
    assert dp["SY"] == SY
    # the dense operator in the frame dtype, built once per dtype and device
    wxd = band_probes._densex_device(tables, 160, dtype, "cpu")
    assert band_probes._densex_device(tables, 160, dtype, "cpu") is wxd
    assert wxd.dtype == dtype and wxd.shape == (160, len(tables[2]))
    assert torch.equal(wxd, torch.from_numpy(band_probes.dense_x_table(
        tables[2], tables[3], 160)).to(dtype))
    # and its packed image, once per dtype, device and warpgroups
    ops = band_probes._densex_packed(tables, 160, dtype, "cpu")
    assert band_probes._densex_packed(tables, 160, dtype, "cpu") is ops
    assert torch.equal(ops, band_probes.pack_dense_x(wxd))


def test_traffic_counts_what_each_mode_reads():
    tables = rgb.tables()
    ys, yw, xs, xw = tables
    plan = band_probes._plan(tables)
    F24, e = 24, 2
    frames, tmp, out = F24 * 1024 * 1024 * e, F24 * 410 * 1024 * e, \
        F24 * 410 * 410 * e
    bases = plan["row_base"].nbytes + plan["col_base"].nbytes
    y_tab = ys.nbytes + yw.nbytes
    y_ops = 2 * F24 * 410 * 1024 * 4
    tr = band_probes.traffic
    # stage reads the 410 rows of the dst rows' first taps alone, each at
    # its dst columns' first taps, 2.5 pixels apart: every 32-byte sector
    # of the row (rows of 2,048 bytes); stagey every row its taps cover
    assert len(np.unique(np.clip(ys, 0, 1023))) == 410
    assert tr("stage", tables, (F24, 1024, 1024), e) == (
        F24 * 410 * 1024 * e + out + ys.nbytes + xs.nbytes + bases, 0)
    assert tr("stagey", tables, (F24, 1024, 1024), e) == (
        frames + out + y_tab + xs.nbytes + bases, y_ops)
    assert tr("xonly", tables, (F24, 410, 1024), e) == (
        tmp + out + xs.nbytes + xw.nbytes + plan["col_base"].nbytes,
        2 * F24 * 410 * 410 * 4)
    assert tr("xonly_direct", tables, (F24, 410, 1024), e) == \
        tr("xonly", tables, (F24, 410, 1024), e)
    nbytes, ops = tr("densex", tables, (F24, 1024, 1024), e)
    # the frames, the output, the y tables, 7 row bases, the operator
    assert nbytes == frames + out + y_tab + 7 * 4 + 1024 * 410 * e
    # the split's products on the tensor cores: two for bf16 frames, three
    # (bf16x3) for f32
    tc = band_probes.tensor_core_ops("densex", tables, (F24, 1024, 1024), e)
    assert tc == 2 * 2 * F24 * 410 * 1024 * 410
    assert band_probes.tensor_core_ops("densex", tables, (F24, 1024, 1024),
                                       4) == 2 * tc
    assert band_probes.tensor_core_ops("xonly", tables, (F24, 410, 1024),
                                       e) == 0
    assert ops == y_ops + tc
    # the bounds of the kernel table: bytes over 3.35 TB/s, the products
    # over 989 TFLOP/s and the y pass over 67 (every product an f32 FMA,
    # as first stated: 0.1245 ms)
    assert round(nbytes / 3.35e12 * 1e3, 4) == 0.0177
    assert round(tc / 989e12 * 1e3, 4) == 0.0167
    assert round(y_ops / 67e12 * 1e3, 4) == 0.0012
    assert round((y_ops + tc // 2) / 67e12 * 1e3, 4) == 0.1245
    assert round(tr("full", tables, (F24, 1024, 1024), e)[0] / 3.35e12
                 * 1e3, 4) == 0.0174
    assert round(tr("xonly", tables, (F24, 410, 1024), e)[0] / 3.35e12
                 * 1e3, 4) == 0.0084


def test_x_probes_reject_what_they_cannot_take():
    tables = _tables()
    x = _x(torch.float32, (F,) + SMALL, 8)
    with pytest.raises(ValueError, match="y pass's output"):
        band_probes.band_probe_kernel(x, tables, "xonly")
    with pytest.raises(ValueError, match="y pass's output"):
        band_probes.band_probe_plain(x, tables, "xonly")
    with pytest.raises(ValueError, match="no torch.uint8 instance"):
        band_probes.band_probe_kernel(x.to(torch.uint8), tables, "densex")
    buf = torch.full((F, HD, WD), float("nan"))
    got = band_probes.band_probe_kernel(x, tables, "densex", out=buf)
    assert got is buf and torch.equal(
        got, band_probes.band_probe_plain(x, tables, "densex"))


# ---------------------------------------------------------------------------
# the entry points on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("exp", sorted(rgb.EXPS))
def test_experiments_run_on_cpu(exp):
    before = (dict(band_probes.LAUNCHES), cuda_apply.LAUNCHES,
              copy_ceiling.LAUNCHES)
    r = rgb.EXPS[exp](1, torch.float32, "cpu", shape=SMALL)
    assert (dict(band_probes.LAUNCHES), cuda_apply.LAUNCHES,
            copy_ceiling.LAUNCHES) == before
    assert r["clock"] == "host" and r["device"] == "cpu"
    assert r["exp"] == exp and r["batch"] == 3 and r["shape"] == list(SMALL)
    assert r["mode"] == (rgb.MODES[exp] or "full")
    assert r["ms_per_batch"] > 0 and r["gpixel_s"] > 0
    assert r["us_per_frame"] == pytest.approx(r["ms_per_batch"] * 1e3 / 3)
    if exp == "copy":
        assert r["bytes"] == 2 * 3 * 256 * 256 * 4
    else:
        shape = (3, HD, SMALL[1]) if exp == "xonly" else (3,) + SMALL
        assert exp != "xonly" or r["mode"] in band_probes.RING_MODES
        assert (r["bytes"], r["operations"]) == band_probes.traffic(
            r["mode"], _tables(), shape, 4)


def test_entry_points_main_and_default_device(capsys):
    assert rgb.main(["--exp", "xonly", "--batch", "1", "--dtype", "float32",
                     "--device", "cpu", "--shape", "64", "160"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("xonly: ") and "Gpixel/s  (" in out
    assert "host's clock" in out
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rgb.EXPS["dma"](1, torch.float32, shape=(64, 160))
    assert rgb.main(["--exp", "fulldense"]) == 2
    assert "device='cpu'" in capsys.readouterr().err
