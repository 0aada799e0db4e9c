"""Kernel 1's probe modes (``aainterp_torch/probes/band_probes.py``,
``flagship_experiments``, ``u8_experiments``) against the JAX package's
probes under ``benchmarks/`` and against float64 statements of their
definitions, on the CPU.

The JAX probes run in interpret mode at a smaller ratio-2 geometry than
the 4K flagship (at 4K they take minutes here): 240 x 512 -> 120 x 256,
set through ``monkeypatch`` of the JAX modules' ``H``, ``W``, ``TY`` (40)
and ``Wd`` (256) constants, with their ``_build_*`` caches cleared before
and after.  The port's plain versions run at the same geometry on kernel
1's own tables (``band_probes.flagship_tables``); on a CPU tensor the
wrapper takes them.

* ``full2/3/4`` (the port's walk modes: production's output) against
  ``flagship_experiments._build_full_nslot``, ``u8chunk2/4`` (the port's
  ``u8convert2/4``: production's output) against ``_build_u8chunk`` (its
  SY 112, SX 384 at this geometry), and ``full`` (the production
  kernel's plain version) against ``apply_separable_pallas``: f32 atol 1e-5
  on [0, 1] inputs (the TPU kernel sums through matrix products in another
  order), bf16 within one bf16 ulp, u8 within one level (a .5 can round
  either way).
* u8 ``ydot`` (the port's ``stagey``: the y sum at each dst column's first
  tap, ``T[i, xs[j]]``) against ``u8_experiments._build_stage_probe('ydot')``
  (the y sums of source columns 0 .. Wd - 1) on the columns both compute,
  and ``xpair`` against its ``'xpair'`` stage on every dst element, both
  within one level, as JAX's ``check_stages`` holds them.
* The stage-cut modes against float64 numpy statements: ``stage`` equal to
  the first tap's pixel; ``stagey`` and the u8 conversions within f32
  atol 1e-5 (f32), one bf16 ulp (bf16) or one level (u8).
* ``fma32``, on which the plain versions rest, against exact rational
  arithmetic (one double-rounding case included); the u8 word order of
  ``u8words`` (``word_pixels``: little-endian) on the host; the plain
  versions of the production-output modes all equal; the tables and byte
  counts; the walk's split of the tiles over its persistent grid
  (``walk_shares``: each tile once, a strip's row tiles in order); the
  entry points with ``device="cpu"`` (no launch, the host's clock) and,
  without a GPU, the default device raising.
"""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aainterp.ops.pallas_apply import apply_separable_pallas

from aainterp_torch.ops import apply as t_apply
from aainterp_torch.ops import cuda_apply
from aainterp_torch.probes import band_probes, flagship_experiments
from aainterp_torch.probes import u8_experiments

SMALL = (240, 512)       # the JAX probes' geometry here: 2.0 -> 1.0
HD, WD = 120, 256


@pytest.fixture
def jflag(monkeypatch):
    from benchmarks import flagship_experiments as fe
    _patch(monkeypatch, fe, (fe._build_full_nslot, fe._build_band_probe))
    return fe


@pytest.fixture
def jchunk(monkeypatch):
    from benchmarks import flagship_experiments as fe
    _patch(monkeypatch, fe, (fe._build_u8chunk,))
    return fe


@pytest.fixture
def jbitcast(monkeypatch):
    from benchmarks import flagship_experiments as fe
    _patch(monkeypatch, fe, (fe._build_u8bitcast,))
    return fe


@pytest.fixture
def ju8(monkeypatch):
    from benchmarks import u8_experiments as ue
    _patch(monkeypatch, ue, (ue._build_stage_probe,))
    monkeypatch.setattr(ue, "Wd", WD)
    return ue


def _patch(monkeypatch, mod, builders):
    monkeypatch.setattr(mod, "H", SMALL[0])
    monkeypatch.setattr(mod, "W", SMALL[1])
    monkeypatch.setattr(mod, "TY", 40)
    for b in builders:
        b.cache_clear()


@pytest.fixture(autouse=True)
def _clear_jax_builders():
    yield
    from benchmarks import flagship_experiments as fe
    from benchmarks import u8_experiments as ue
    for b in (fe._build_full_nslot, fe._build_band_probe, fe._build_u8chunk,
              fe._build_u8bitcast, ue._build_stage_probe):
        b.cache_clear()


def _x(dtype, F=1, seed=3, shape=SMALL):
    rng = np.random.default_rng(seed)
    if dtype == torch.uint8:
        return torch.from_numpy(rng.integers(0, 256, (F,) + shape,
                                             dtype=np.uint8))
    x = torch.from_numpy(rng.uniform(0, 1, (F,) + shape).astype(np.float32))
    return x.to(dtype)


def _jx(x: torch.Tensor):
    if x.dtype == torch.uint8:
        return jnp.asarray(x.numpy())
    dt = jnp.bfloat16 if x.dtype == torch.bfloat16 else jnp.float32
    return jnp.asarray(x.float().numpy(), dt)


def bf16_ulp(x):
    a = np.maximum(np.abs(np.asarray(x, np.float64)), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(a)) - 7)


def _close(got: torch.Tensor, want: np.ndarray):
    """The module's tolerance for ``got``'s dtype."""
    g = got.float().numpy().astype(np.float64)
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape
    if got.dtype == torch.uint8:
        assert np.abs(g - w).max() <= 1
    elif got.dtype == torch.bfloat16:
        assert (np.abs(g - w) <= bf16_ulp(w)).all()
    else:
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


def _dense(shape=SMALL):
    """float64 (Hd, H) and (Wd, W) band matrices, taps clamped."""
    ys, yw, xs, xw = band_probes.flagship_tables(shape)
    H, W = shape
    wy = np.zeros((len(ys), H))
    wx = np.zeros((len(xs), W))
    for a in range(yw.shape[1]):
        np.add.at(wy, (np.arange(len(ys)), np.clip(ys + a, 0, H - 1)),
                  yw[:, a])
    for b in range(xw.shape[1]):
        np.add.at(wx, (np.arange(len(xs)), np.clip(xs + b, 0, W - 1)),
                  xw[:, b])
    return wy, wx


def _cast64(v: np.ndarray, dtype) -> np.ndarray:
    if dtype == torch.uint8:
        return np.clip(np.round(v), 0, 255)
    return v


# ---------------------------------------------------------------------------
# against the JAX probes (interpret mode, the small geometry)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nslot", [2, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_walk_modes_match_full_nslot(jflag, nslot, dtype):
    op, row_base, wy_b, SY, col_base, wx_b, SX = jflag._geometry()
    nty, ntx = wy_b.shape[0], wx_b.shape[0]
    dname = "float32" if dtype == torch.float32 else "bfloat16"
    probe = jflag._build_full_nslot(1, SY, SX, nty, ntx, WD, dname, nslot,
                                    interpret=True)
    x = _x(dtype)
    want = probe(jnp.asarray(row_base), jnp.asarray(col_base), _jx(x),
                 jnp.asarray(wy_b), jnp.asarray(wx_b))
    want = np.asarray(want.astype(jnp.float32))[:, :HD, :WD]
    tables = band_probes.flagship_tables(SMALL)
    got = band_probes.band_probe_kernel(x, tables, f"walk{nslot}")
    assert got.dtype == dtype and got.shape == (1, HD, WD)
    _close(got, want)


@pytest.mark.parametrize("n", [2, 4])
def test_u8convert_modes_match_u8chunk(jchunk, n):
    op, row_base, wy_p, SY, col_base, wx_b, SX = jchunk._u8chunk_setup(
        n, interpret=True)
    assert (SY, SX) == (112, 384)
    probe = jchunk._build_u8chunk(1, SY, SX, wy_p.shape[0], wx_b.shape[0], WD,
                                  n, interpret=True)
    x = _x(torch.uint8, seed=7)
    want = np.asarray(probe(jnp.asarray(row_base), jnp.asarray(col_base),
                            _jx(x), jnp.asarray(wy_p), jnp.asarray(wx_b)))
    assert want.shape == (1, HD, WD)
    tables = band_probes.flagship_tables(SMALL)
    got = band_probes.band_probe_kernel(x, tables, f"u8convert{n}")
    assert got.dtype == torch.uint8 and got.shape == (1, HD, WD)
    _close(got, want.astype(np.float64))


def test_u8words_matches_u8bitcast(jbitcast):
    # JAX's bitcast byte-split probe (flagship_experiments.py:341), its rows
    # scrambled by the interpret backend's pack order and unscrambled in wy,
    # against the port's u8words (the word read of 4 neighbouring pixels)
    op, row_base, wy_p, SY, col_base, wx_b, SX = jbitcast._u8bitcast_setup(
        interpret=True)
    assert (SY, SX) == (112, 384)
    probe = jbitcast._build_u8bitcast(1, SY, SX, wy_p.shape[0],
                                      wx_b.shape[0], WD, interpret=True)
    x = _x(torch.uint8, seed=13)
    want = np.asarray(probe(jnp.asarray(row_base), jnp.asarray(col_base),
                            _jx(x), jnp.asarray(wy_p), jnp.asarray(wx_b)))
    assert want.shape == (1, HD, WD)
    tables = band_probes.flagship_tables(SMALL)
    for mode in ("u8words", "u8words_direct"):
        got = u8_experiments.band_probe_kernel(x, tables, mode)
        assert got.dtype == torch.uint8 and got.shape == (1, HD, WD)
        _close(got, want.astype(np.float64))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.uint8])
def test_full_matches_apply_separable_pallas(dtype):
    tables = band_probes.flagship_tables(SMALL)
    x = _x(dtype, F=2)
    want = apply_separable_pallas(_jx(x), *(jnp.asarray(t) for t in tables),
                                  interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    got = flagship_experiments.band_probe_plain(
        x, tables, "u8words" if dtype == torch.uint8 else "walk2")
    _close(got, want)
    # the production kernel's own plain version, for the same tables
    _close(cuda_apply.apply_separable_kernel(x, *tables), want)


def test_ydot_matches_stage_probe(ju8):
    row_base, wy_perm, SY, nty, _, _, _, wx = ju8._stage_tables(
        "ydot", interpret=True)
    probe = ju8._build_stage_probe(1, SY, nty, "ydot", interpret=True)
    x = _x(torch.uint8, seed=5)
    want = np.asarray(probe(jnp.asarray(row_base), _jx(x),
                            jnp.asarray(wy_perm), wx))[:, :HD].astype(int)
    tables = band_probes.flagship_tables(SMALL)
    got = u8_experiments.band_probe_plain(x, tables, "stagey").numpy()
    xs = tables[2]
    cols = np.nonzero(xs < WD)[0]          # dst columns whose first tap
    assert len(cols) > WD // 3             # lies in JAX's stored columns
    err = np.abs(got[:, :, cols].astype(int) - want[:, :, xs[cols]])
    assert err.max() <= 1


def test_xpair_matches_stage_probe(ju8):
    rb, wy, SY, nty, _, _, _, tab = ju8._stage_tables("xpair",
                                                      interpret=True)
    probe = ju8._build_stage_probe(1, SY, nty, "xpair", 0, 0, (),
                                   interpret=True)
    x = _x(torch.uint8, seed=6)
    want = np.asarray(probe(jnp.asarray(rb), _jx(x), jnp.asarray(wy),
                            tab))[:, :HD].astype(int)
    tables = band_probes.flagship_tables(SMALL)
    got = u8_experiments.band_probe_kernel(x, tables, "xpair")
    assert got.dtype == torch.uint8
    assert np.abs(got.numpy().astype(int) - want).max() <= 1
    # the port's (4, Wd) table is JAX's
    np.testing.assert_array_equal(
        band_probes.xpair_table(tables[2], tables[3]), np.asarray(tab))


# ---------------------------------------------------------------------------
# the stage-cut modes against float64 statements
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [SMALL, (97, 131)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.uint8])
def test_stage_modes_meet_their_definitions(shape, dtype):
    tables = band_probes.flagship_tables(shape)
    ys, yw, xs, xw = tables
    H, W = shape
    x = _x(dtype, F=2, seed=8, shape=shape)
    x64 = x.double().numpy()
    rows, cols = np.clip(ys, 0, H - 1), np.clip(xs, 0, W - 1)
    got = band_probes.band_probe_plain(x, tables, "stage")
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.double().numpy(),
                                  x64[:, rows][:, :, cols])
    wy, wx = _dense(shape)
    t64 = np.einsum("iy,fyx->fix", wy, x64)
    _close(band_probes.band_probe_plain(x, tables, "stagey"),
           _cast64(t64[:, :, cols], dtype))
    full64 = _cast64(np.einsum("fix,jx->fij", t64, wx), dtype)
    modes = (band_probes.U8_MODES[2:] if dtype == torch.uint8
             else band_probes.FLOAT_MODES[2:])
    for mode in modes:
        _close(band_probes.band_probe_plain(x, tables, mode), full64)


def test_production_output_modes_agree():
    tables = band_probes.flagship_tables((97, 131))
    u8 = _x(torch.uint8, F=2, seed=9, shape=(97, 131))
    outs = [band_probes.band_probe_plain(u8, tables, m)
            for m in ("u8words", "u8convert1", "u8convert2", "u8convert4")]
    assert all(torch.equal(o, outs[0]) for o in outs)
    f = _x(torch.float32, F=2, seed=9, shape=(97, 131))
    outs = [band_probes.band_probe_plain(f, tables, m)
            for m in ("walk2", "walk3", "walk4")]
    assert all(torch.equal(o, outs[0]) for o in outs)
    # the exact ratio-2 band: xpair is production's, bit for bit
    u8 = _x(torch.uint8, F=2, seed=10)
    t = band_probes.flagship_tables(SMALL)
    assert torch.equal(band_probes.band_probe_plain(u8, t, "xpair"),
                       band_probes.band_probe_plain(u8, t, "u8words"))


# ---------------------------------------------------------------------------
# the arithmetic and the byte order the plain versions and u8words rest on
# ---------------------------------------------------------------------------


def _fma_exact(a, b, c) -> np.float32:
    """a * b + c rounded once to float32 (nearest, ties to even)."""
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    f = np.float32(float(exact))
    cands = [np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf))]
    dist = [abs(Fraction(float(v)) - exact) for v in cands]
    best = min(dist)
    ties = [v for v, d in zip(cands, dist) if d == best]
    if len(ties) > 1:
        ties = [v for v in ties if int(np.array(v).view(np.int32)) % 2 == 0]
    return ties[0]


def test_fma32_rounds_once():
    rng = np.random.default_rng(0)
    a = rng.uniform(-2, 2, 400).astype(np.float32)
    b = rng.uniform(-300, 300, 400).astype(np.float32)
    c = (rng.uniform(-1, 1, 400) * 10.0 ** rng.integers(-6, 4, 400)
         ).astype(np.float32)
    # a double-rounding case: a * b + c lies just below an f32 midpoint
    # that the float64 sum rounds to
    a[0] = np.float32(2.0 ** -24 * (1 + 2.0 ** -18))
    b[0] = np.float32(1 - 2.0 ** -18)
    c[0] = np.float32(1 + 3 * 2.0 ** -23)
    got = t_apply.fma32(torch.from_numpy(a), torch.from_numpy(b),
                        torch.from_numpy(c)).numpy()
    want = np.array([_fma_exact(*v) for v in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got, want)
    assert got[0] == np.float32(1 + 3 * 2.0 ** -23)
    naive = np.float32(np.float64(a[0]) * np.float64(b[0]) + np.float64(c[0]))
    assert naive != got[0]                 # the case is a real one


def test_u8_word_order_on_the_host():
    rng = np.random.default_rng(1)
    buf = rng.integers(0, 256, 64, dtype=np.uint8)
    for p in range(0, 56):
        np.testing.assert_array_equal(band_probes.word_pixels(buf, p),
                                      buf[p:p + 4])
    # little-endian: byte k of a 32-bit word is the pixel at offset k
    w = torch.from_numpy(buf[:16].copy()).view(torch.int32).numpy()
    for k in range(4):
        np.testing.assert_array_equal((w.view(np.uint32) >> (8 * k)) & 0xFF,
                                      buf[:16].reshape(4, 4)[:, k])


# ---------------------------------------------------------------------------
# tables, byte counts, errors
# ---------------------------------------------------------------------------


def test_flagship_plan_and_shared_memory():
    tables = band_probes.flagship_tables()
    plan = band_probes._plan(tables)
    assert (plan["TY"], plan["TX"], plan["SY"], plan["SX"]) == (8, 240, 18,
                                                                482)
    for mode in band_probes.MODES:
        for elem in (1, 2, 4):
            need = band_probes.smem_bytes(plan, mode, 3840, 1920, 4, elem)
            assert need <= band_probes.SMEM_LIMIT, (mode, elem)
    # production's layout: the first forms of stage and stagey
    base = band_probes.smem_bytes(plan, "stage_direct", 3840, 1920, 4, 4)
    assert base == band_probes.smem_bytes(plan, "stagey_direct", 3840, 1920,
                                          4, 4)
    assert base <= cuda_apply.band_smem(8, 240, 18, 482, 4)
    w4 = band_probes.smem_bytes(plan, "walk4", 3840, 1920, 4, 4)
    # three more windows: 18 rows at a pitch of 482 * 4 + 32 bytes rounded
    # up to the row stride mod 16 (3840 * 4: 1968 bytes), from 16 bytes in;
    # three more tap tables (8 rows x 4 taps, an int and a float each) and
    # the ring's 8 mbarriers; no zero row (a row's pitch + 32 bytes)
    window = -(-(32 + 18 * 1968) // 16) * 16
    assert w4 - base == 3 * window + 3 * 8 * 4 * 8 + 8 * 8 - (1968 + 32)
    # walk2's ring leaves 4 bf16 blocks an SM (227 KB, 1 KB reserved a
    # block), as many as production's 5 less one
    w2 = band_probes.smem_bytes(plan, "walk2", 3840, 1920, 4, 2)
    assert 233472 // (w2 + 1024) == 4
    # u8convert<n>: bf16 chunk buffers of 18 rows, 32 bytes for each of
    # ceil(31 / n) + 1 aligned window chunks a row; two buffers, one for n 1
    u8 = band_probes.smem_bytes(plan, "stage_direct", 3840, 1920, 4, 1)
    for n, pitch, bufs in ((1, 1024, 1), (2, 544, 2), (4, 288, 2)):
        assert band_probes.convert_pitch(482, n) == pitch
        assert (band_probes.smem_bytes(plan, f"u8convert{n}", 3840, 1920, 4,
                                       1) - u8 == bufs * 18 * pitch)
    assert [band_probes.smem_bytes(plan, m, 3840, 1920, 4, 1)
            for m in ("u8convert1", "u8convert2", "u8convert4")] == [
                46416, 47568, 38352]


@pytest.mark.parametrize("F", [1, 8, 11])
@pytest.mark.parametrize("blocks", [66, 264, 528, 1081, 10 ** 5])
def test_walk_shares_deal_every_tile_once(F, blocks):
    tables = band_probes.flagship_tables()
    plan = band_probes._plan(tables)
    n_strip, n_rt = 1920 // plan["TX"], 1080 // plan["TY"]
    items = F * n_strip * n_rt
    shares = band_probes.walk_shares(items, blocks)
    assert len(shares) == min(items, blocks)
    sizes = [hi - lo for lo, hi in shares]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    tiles = []
    for lo, hi in shares:
        walk = [(i // n_rt // n_strip, i // n_rt % n_strip, i % n_rt)
                for i in range(lo, hi)]
        # a strip's row tiles in order along the share
        for a, b in zip(walk, walk[1:]):
            assert b[:2] != a[:2] or b[2] == a[2] + 1
        tiles += walk
    assert len(tiles) == items
    assert sorted(set(tiles)) == [(f, s, r) for f in range(F)
                                  for s in range(n_strip)
                                  for r in range(n_rt)]


def _ring_layout(plan, mode, n, Ws, Wd, ky, elem):
    """The stage ring's layout (band_apply.cuh's stage_geo), by its parts:
    n windows as production stages them, n tap tables and 2n mbarriers, T
    for stagey and u8words alone (u8words' rows 3 columns longer, for its
    shift to the window's words), two output tiles for stage, one for
    stagey and u8words, none for xpair (its words go straight out; it
    keeps its (4, Wd) x table whole instead, rows of Wd rounded up to 4
    floats), no zero row."""
    TY, TX, SY, SX = plan["TY"], plan["TX"], plan["SY"], plan["SX"]

    def up16(v):
        return -(-v // 16) * 16

    pitch = (SX * elem + 32) + ((Ws * elem - (SX * elem + 32)) % 16)
    window = up16(32 + SY * pitch)
    tab = up16(8 * TY * ky + 4 * TY) if mode != "stage" else up16(4 * TY)
    t_cols = {"stagey": SX, "u8words": SX + 3}.get(mode)
    t = up16(4 * TY * ((t_cols + 3) // 4 * 4)) if t_cols else 0
    pitch_out = (TX * elem + 32) + ((Wd * elem - (TX * elem + 32)) % 16)
    tiles = {"stage": 2, "xpair": 0}.get(mode, 1)
    xtab = up16(4 * 4 * ((Wd + 3) // 4 * 4)) if mode == "xpair" else 0
    return n * window + t + n * tab + tiles * up16(32 + TY * pitch_out) \
        + xtab + 16 * n


@pytest.mark.parametrize("elem", [1, 2, 4])
def test_stage_ring_shared_memory(elem):
    tables = band_probes.flagship_tables()
    plan = band_probes._plan(tables)
    n = band_probes.STAGE_SLOTS
    assert n == 2
    dtype = {1: torch.uint8, 2: torch.bfloat16, 4: torch.float32}[elem]
    modes = [m for m in band_probes.RING_MODES
             if m in band_probes.modes_of(dtype)]
    assert modes == (["stage", "stagey", "u8words", "xpair"] if elem == 1
                     else ["stage", "stagey"])
    got = {}
    for mode in modes:
        got[mode] = band_probes.smem_bytes(plan, mode, 3840, 1920, 4, elem)
        assert got[mode] == _ring_layout(plan, mode, n, 3840, 1920, 4, elem)
        assert got[mode] <= band_probes.SMEM_LIMIT
    pitch = band_probes._seg_pitch(482 * elem, 3840 * elem)
    window = -(-(32 + 18 * pitch) // 16) * 16
    # stagey: one T (8 rows of 482 f32, padded to 484) and its larger tap
    # tables, one output tile less
    assert band_probes.stage_t_pitch(482) == 484
    out_tile = -(-(32 + 8 * band_probes._seg_pitch(240 * elem, 1920 * elem))
                 // 16) * 16
    assert got["stagey"] - got["stage"] == \
        8 * 484 * 4 + n * (8 * 8 * 4 + 32 - 32) - out_tile
    # no zero row and no T in the ring's stage, two output tiles: the ring
    # of 2 holds one more window than the first form, less its zero row and
    # T, plus an output tile
    direct = band_probes.smem_bytes(plan, "stage_direct", 3840, 1920, 4, elem)
    assert got["stage"] - direct == (
        window - (pitch + 32 + (-(pitch + 32)) % 16) - 8 * 482 * 4
        + 2 * 32 - 8 * 4 * 8 + out_tile + 32)
    if elem == 1:
        # u8words: stagey's layout with T's rows 488 floats, not 484;
        # xpair: stagey's without T and without its output tile, with the
        # (4, 1920) f32 x table
        assert band_probes.ring_t_pitch(482, "u8words") == 488
        assert got["u8words"] - got["stagey"] == 8 * (488 - 484) * 4
        assert got["xpair"] == (got["stagey"] - 8 * 484 * 4 - out_tile
                                + 4 * 1920 * 4)
        # the first forms keep production's layout
        for mode in ("u8words", "xpair"):
            assert band_probes.smem_bytes(plan, f"{mode}_direct", 3840,
                                          1920, 4, 1) == direct


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.uint8])
def test_direct_modes_share_plain_and_rejections(dtype):
    tables = band_probes.flagship_tables((97, 131))
    x = _x(dtype, F=2, seed=12, shape=(97, 131))
    ring = [m for m in band_probes.RING_MODES
            if m in band_probes.modes_of(dtype)]
    assert [f"{m}_direct" for m in ring] == [
        m for m in band_probes.modes_of(dtype) if m.endswith("_direct")]
    for mode in ring:
        want = band_probes.band_probe_plain(x, tables, mode)
        direct = f"{mode}_direct"
        assert torch.equal(band_probes.band_probe_plain(x, tables, direct),
                           want)
        buf = torch.empty_like(want)
        got = band_probes.band_probe_kernel(x, tables, direct, out=buf)
        assert got is buf and torch.equal(got, want)
        assert band_probes.traffic(direct, tables, (2, 97, 131), 4) == \
            band_probes.traffic(mode, tables, (2, 97, 131), 4)
        # what the ring's mode rejects, its first form rejects alike
        for bad, err in ((x[0], ValueError), ("frames", TypeError),
                         (x.double(), ValueError)):
            for m in (mode, direct):
                with pytest.raises(err):
                    band_probes.band_probe_kernel(bad, tables, m)
    # the u8 ring modes and their first forms have no float instance
    for m in ("u8words", "xpair", "u8words_direct", "xpair_direct"):
        if dtype != torch.uint8:
            with pytest.raises(ValueError, match="instance"):
                band_probes.band_probe_kernel(x, tables, m)
    with pytest.raises(ValueError, match="stage_grid takes"):
        band_probes.stage_grid(x, tables, "stage")
    with pytest.raises(ValueError, match="stage_grid takes"):
        band_probes.stage_grid(x, tables, "stage_direct")


def _window_bytes(plan, strip, H, W, elem=1):
    """(wbase, cb, xa, xb, pitch) of strip ``strip``'s window of frame 0's
    first row tile, staged at shared byte 0 from a batch at a 16-byte
    aligned address, as band_apply.cuh lays it out (window_base: the first
    pixel at 16 + its address mod 16; the row pitch equal to the row
    stride mod 16)."""
    cb = int(plan["col_base"][strip])
    xa = min(max(cb, 0), W - 1)
    xb = min(max(cb + plan["SX"] - 1, 0), W - 1) + 1
    ya = min(max(int(plan["row_base"][0]), 0), H - 1)
    wbase = 16 + (ya * W + xa) * elem % 16
    return wbase, cb, xa, xb, band_probes._seg_pitch(plan["SX"] * elem,
                                                     W * elem)


@pytest.mark.parametrize("shape", [(2160, 3840), (540, 1923), (250, 998)])
def test_ring_words_and_pairs_align(shape):
    # u8words: T shifted by o = (wbase + cb - xa) mod 4, so that every
    # whole group's 4 pixels are one aligned word in every tap row where
    # the row pitch is a multiple of 4 (W mod 4 == 0), and where it is not
    # (W 1923, 998) the rows' alignment differs and the kernel takes the
    # funnel-shift read.  xpair: the lanes' 8 source columns from 2 J (J a
    # multiple of 4) are two aligned words exactly where the pitch and the
    # strip's 2 j0 are
    H, W = shape
    tables = band_probes.flagship_tables(shape)
    plan = band_probes._plan(tables)
    SX, TX = plan["SX"], plan["TX"]
    flagship = W % 4 == 0
    for strip in range(len(plan["col_base"])):
        wbase, cb, xa, xb, pitch = _window_bytes(plan, strip, H, W)
        o = (wbase + cb - xa) & 3             # words_y_pass's T offset
        assert 0 <= o < 4
        ng = (SX + o + 3) // 4
        assert 4 * ng <= band_probes.ring_t_pitch(SX, "u8words")
        whole = 0
        for gi in range(ng):
            x0 = cb + 4 * gi - o
            if x0 < xa or x0 + 4 > xb:
                continue
            whole += 1
            assert (wbase + x0 - xa) % 4 == 0
            rows_aligned = all((wbase + r * pitch + x0 - xa) % 4 == 0
                               for r in range(plan["SY"]))
            assert rows_aligned == flagship
        # the groups astride the window's edges alone read pixel by pixel
        assert whole >= (xb - xa) // 4 - 1
        j0 = strip * TX
        pair_aligned = (pitch | (wbase + 2 * j0 - xa)) & 3 == 0
        assert pair_aligned == flagship
        if flagship:
            for gi in range(-(-min(TX, tables[2].shape[0] - j0) // 4)):
                x0 = 2 * (j0 + 4 * gi)
                if xa <= x0 and x0 + 8 <= xb:
                    assert (wbase + x0 - xa) % 4 == 0


def test_traffic_counts_what_each_mode_reads():
    tables = band_probes.flagship_tables()
    ys, yw, xs, xw = tables
    plan = band_probes._plan(tables)
    shape, e = (8, 2160, 3840), 2
    frames, out = 8 * 2160 * 3840 * e, 8 * 1080 * 1920 * e
    bases = plan["row_base"].nbytes + plan["col_base"].nbytes
    y_ops, x_ops = 2 * 8 * 1080 * 3840 * 4, 2 * 8 * 1080 * 1920 * 4
    tr = band_probes.traffic
    # stage reads the rows of the dst rows' first taps alone (1080 of
    # 2160), each at its dst columns' first taps, every other pixel: every
    # 32-byte sector of the row; stagey every row its taps cover, all
    assert len(np.unique(np.clip(ys, 0, 2159))) == 1080
    assert tr("stage", tables, shape, e) == (
        8 * 1080 * 3840 * e + out + ys.nbytes + xs.nbytes + bases, 0)
    assert tr("stagey", tables, shape, e) == (
        frames + out + ys.nbytes + yw.nbytes + xs.nbytes + bases, y_ops)
    full = (frames + out + ys.nbytes + yw.nbytes + xs.nbytes + xw.nbytes
            + bases, y_ops + x_ops)
    for mode in ("full", "walk2", "walk4", "u8words", "u8convert2"):
        assert tr(mode, tables, shape, e) == full
    assert tr("xpair", tables, shape, 1)[1] == y_ops + x_ops


@pytest.mark.parametrize("F,Hs,Ws", [(1, 5, 64), (3, 7, 33), (2, 4, 1923)])
@pytest.mark.parametrize("elem", [1, 2, 4])
def test_read_sectors_counts_the_touched_sectors(F, Hs, Ws, elem):
    # against the set of 32-byte sectors that the picked pixels' bytes
    # fall in, batch at byte 0; rows and columns repeated and unsorted
    rng = np.random.default_rng(F * 100 + Ws + elem)
    rows = rng.integers(0, Hs, 2 * Hs)
    cols = rng.integers(0, Ws, Ws // 2 + 1)
    want = {((f * Hs + r) * Ws + c) * elem // 32
            for f in range(F) for r in rows for c in cols}
    assert band_probes.read_sectors(rows, cols, F, Hs, Ws, elem) == \
        32 * len(want)


def test_probes_reject_what_they_cannot_take(monkeypatch):
    tables = band_probes.flagship_tables(SMALL)
    f = _x(torch.float32)
    with pytest.raises(ValueError, match="probe mode"):
        band_probes.band_probe_kernel(f, tables, "none")
    with pytest.raises(ValueError, match="no torch.float32 instance"):
        band_probes.band_probe_kernel(f, tables, "xpair")
    with pytest.raises(ValueError, match="no torch.uint8 instance"):
        band_probes.band_probe_kernel(_x(torch.uint8), tables, "walk2")
    with pytest.raises(ValueError, match="F, H, W"):
        band_probes.band_probe_kernel(f[0], tables, "stage")
    # a 3:1 band is no exact ratio-2 partition
    from aainterp_torch import api, autodiff, grids
    op = api.build_operator(grids.make_grid_spec(SMALL, 3.0, 1.0, (0, 0), 0))
    t3 = autodiff.separable_linear_for(op, torch.float32, "kernel").tables
    with pytest.raises(ValueError, match="exact ratio-2"):
        band_probes.xpair_table(t3[2], t3[3])
    buf = torch.full((1, HD, WD), float("nan"))
    got = band_probes.band_probe_kernel(f, tables, "stagey", out=buf)
    assert got is buf and torch.equal(
        got, band_probes.band_probe_plain(f, tables, "stagey"))


# ---------------------------------------------------------------------------
# the entry points on the CPU
# ---------------------------------------------------------------------------


def _launches():
    return dict(band_probes.LAUNCHES), cuda_apply.LAUNCHES


@pytest.mark.parametrize("module,exp", [
    (flagship_experiments, e) for e in sorted(flagship_experiments.EXPS)] + [
    (u8_experiments, e) for e in sorted(u8_experiments.EXPS)])
def test_experiments_run_on_cpu(module, exp):
    dtype = torch.uint8 if module is u8_experiments else torch.float32
    before = _launches()
    r = module.EXPS[exp](2, dtype, "cpu", shape=(48, 64))
    assert _launches() == before
    assert r["clock"] == "host" and r["device"] == "cpu"
    assert r["exp"] == exp and r["batch"] == 2 and r["shape"] == [48, 64]
    assert r["mode"] == (module.MODES[exp] or "full")
    assert r["ms_per_batch"] > 0 and r["gpixel_s"] > 0
    assert r["us_per_frame"] == pytest.approx(r["ms_per_batch"] * 500)
    assert (r["bytes"], r["operations"]) == band_probes.traffic(
        r["mode"], band_probes.flagship_tables((48, 64)), (2, 48, 64),
        1 if dtype == torch.uint8 else 4)
    if exp in ("xdot", "xdot1"):
        assert "production kernel" in r["runs"]


def test_entry_points_main_and_default_device(capsys):
    assert flagship_experiments.main(
        ["--exp", "ypass", "--batch", "1", "--dtype", "float32", "--device",
         "cpu", "--shape", "48", "64"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("ypass: ") and "Gpixel/s" in out
    assert "host's clock" in out
    with pytest.raises(ValueError, match="uint8 experiment"):
        u8_experiments.EXPS["ydot"](1, torch.float32, "cpu", shape=(48, 64))
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        flagship_experiments.EXPS["stage"](1, torch.float32, shape=(48, 64))
    assert u8_experiments.main(["--exp", "xpair"]) == 2
    assert "device='cpu'" in capsys.readouterr().err
