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
  ``xonly`` on ``[:Hd, :Wd]`` with the same ``tmp[:Hd]``, ``fulldense``
  against ``densex`` on ``[:Hd, :Wd]``: f32 atol 1e-5 on [0, 1] inputs (the
  TPU probes sum through matrix products in another order), bf16 within
  one bf16 ulp.
* ``densex`` in f32 equal to production's plain output bit for bit; its
  dense operator equal to the one JAX builds.
* The byte and operation counts, the plans and their shared memory at
  1024^2, the entry points with ``device="cpu"`` (no launch, the host's
  clock) and, without a GPU, the default device raising.
"""

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
    got = rgb.band_probe_kernel(tmp[:, :HD].contiguous(), _tables(), "xonly")
    assert dict(band_probes.LAUNCHES) == before
    assert got.dtype == dtype and got.shape == (F, HD, WD)
    _close(got, want)


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
    _close(band_probes.band_probe_plain(tmp, tables, "xonly"), want)
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
    assert band_probes.window_rows(plan, "xonly") == 21
    for elem, dense_smem in ((2, 85696), (4, 137312)):
        # xonly: production's layout
        assert band_probes.smem_bytes(plan, "xonly", 1024, 410, 4, elem) == \
            band_probes.smem_bytes(plan, "stagey", 1024, 410, 4, elem)
        dp = band_probes.densex_plan(tables, 1024, elem)
        assert (dp["TY"], dp["TX"], dp["SY"], dp["SX"]) == (8, 410, 21, 1024)
        np.testing.assert_array_equal(dp["row_base"], plan["row_base"])
        np.testing.assert_array_equal(dp["col_base"], [0])
        # T holds 8 whole rows of 1024 f32: 32 KB of it
        need = band_probes.smem_bytes(dp, "densex", 1024, 410, 4, elem)
        assert need == dense_smem <= band_probes.SMEM_LIMIT
    assert band_probes.smem_bytes(plan, "stagey", 1024, 410, 4, 4) <= \
        cuda_apply.band_smem(8, 240, 21, 600, 4)


def test_densex_plan_halves_rows_and_keeps_one_strip():
    tables = band_probes.flagship_tables()          # 4K: T of 3840 columns
    for elem, ty in ((2, 4), (4, 2)):
        dp = band_probes.densex_plan(tables, 3840, elem)
        assert (dp["TY"], dp["TX"], dp["SX"]) == (ty, 1920, 3840)
        assert band_probes.smem_bytes(dp, "densex", 3840, 1920, 4, elem) \
            <= band_probes.SMEM_LIMIT
    # upsampling: the window of xonly holds the tile's TY rows
    plan = band_probes._plan(band_probes.flagship_tables((64, 160), 1.0,
                                                         2.0))
    assert plan["SY"] < plan["TY"] == band_probes.window_rows(plan, "xonly")
    wide = band_probes.flagship_tables((8, 60000), 2.0, 1.0)
    with pytest.raises(ValueError, match="shared memory"):
        band_probes.densex_plan(wide, 60000, 4)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_densex_plan_is_cached_and_uploads_as_kernel_1s(dtype):
    tables = band_probes.flagship_tables((64, 160), 150.0, 60.0)
    dp = band_probes.densex_plan(tables, 160, dtype.itemsize)
    assert band_probes.densex_plan(tables, 160, dtype.itemsize) is dp
    dev = cuda_apply._device_tables(dp, "cpu")
    assert cuda_apply._device_tables(dp, "cpu") is dev
    for host, got in zip(dp["tables"], dev):
        np.testing.assert_array_equal(got.numpy(), host)
    np.testing.assert_array_equal(dev[4].numpy(), dp["row_base"])
    # the dense operator in the frame dtype, built once per dtype and device
    wxd = band_probes._densex_device(tables, 160, dtype, "cpu")
    assert band_probes._densex_device(tables, 160, dtype, "cpu") is wxd
    assert wxd.dtype == dtype and wxd.shape == (160, len(tables[2]))
    assert torch.equal(wxd, torch.from_numpy(band_probes.dense_x_table(
        tables[2], tables[3], 160)).to(dtype))


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
    assert tr("stage", tables, (F24, 1024, 1024), e) == (
        frames + out + y_tab + xs.nbytes + bases, 0)
    assert tr("xonly", tables, (F24, 410, 1024), e) == (
        tmp + out + xs.nbytes + xw.nbytes + plan["col_base"].nbytes,
        2 * F24 * 410 * 410 * 4)
    nbytes, ops = tr("densex", tables, (F24, 1024, 1024), e)
    assert nbytes == frames + out + y_tab + 1024 * 410 * e \
        + plan["row_base"].nbytes + 4
    assert ops == y_ops + 2 * F24 * 410 * 1024 * 410
    # the bounds of the kernel table: bytes over 3.35 TB/s, operations over
    # 67 TFLOP/s
    assert round(ops / 67e12 * 1e3, 4) == 0.1245
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
