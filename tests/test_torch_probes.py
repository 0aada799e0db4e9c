"""The port's probe kernels (``aainterp_torch/probes``) against the JAX
package's probes under ``benchmarks/``, on the CPU.

* The row-tiled copy: ``copy_rows_plain`` and the wrapper on a CPU tensor
  bit-equal to ``benchmarks/copy_ceiling.py::_build_copy`` under
  ``pltpu.force_tpu_interpret_mode()`` (bf16, f32, u8; H a multiple of TY
  and not) and to ``benchmarks/rgb1024_experiments.py::_build_copy`` at its
  constants (1024 x 1024, TY 128) with F = 1.
* The contraction probes against ``benchmarks/rot_experiments.py``'s in
  ``interpret=True``, on ``[:Hd, :Wd]`` of JAX's padded output, at 96 x 80
  / 30 degrees (one JAX tile) and 300 x 260 / 17 degrees (2 x 2 JAX
  tiles), f32 and bf16.  Both packages build their plans from
  ``build_shear_plan`` of the same operator; JAX's probes take the port's
  T zero-padded to its (THp, TWp) with its own r0/c0/rsel/csel/w2t
  (``_jax_inputs``).  JAX sums b-major, the port a-major, so: noweight f32
  atol 2e-5 (25 unweighted taps in [0, 1], sums up to 25), the weighted
  probes f32 atol 1e-5 (tests/test_torch_ell_apply.py's pin against
  interpret-mode Pallas), bf16 within one bf16 ulp of each other (both
  round an f32 sum).  JAX's noweight selects no tap of a dst row or column
  whose weights are all 0 (its one-hot selectors are built on the live
  rows and columns only) and writes 0 there; the port's sums the window
  there too, so the comparison is on the live rows and columns, and JAX's
  zeros are checked on the rest.  The shares off (JAX's masked
  contraction) are held against the port's production contraction.
* The tiled probes against their definitions (the route's tiled
  contraction with one stream pinned; 0 outside each dst row's live span,
  as JAX's share probes skip dead tiles): pipelined is the tiled
  contraction's plain version bit for bit; tshare is the same for every
  frame and reads nothing of T outside frame 0's corner of the largest
  window's rows and columns; wshare is the tiled contraction on the
  shared tile's own pixels, and everywhere on a plan with one live tile;
  every mode is within 1e-5 of a float64 numpy statement of it, tile by
  tile (noweight, unmasked, 2e-5); the plain versions launch nothing; a
  plan without tiles makes every tiled mode raise, naming it.
* The entry points: each ``EXPS`` function and ``copy_ceiling.measure``
  with ``device="cpu"`` at a small shape (the plain versions on the
  host's clock, ``clock == "host"``), no kernel launched; without a GPU
  the default device raises and names ``device="cpu"``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aainterp as aa
from aainterp.ops import weights as j_weights
from aainterp.ops.pallas_shear import build_kernel_plan, tile_masks

import aainterp_torch as at
from aainterp_torch.ops import cuda_shear
from aainterp_torch.ops import weights as t_weights
from aainterp_torch.probes import copy_ceiling, harness, rot_experiments
from aainterp_torch.utils import cache as t_cache

GEOMS = [((96, 80), 30.0), ((300, 260), 17.0)]
GIDS = ["96x80-30", "300x260-17"]
DTYPES = [torch.float32, torch.bfloat16]
F = 2


@pytest.fixture(scope="module")
def jprobes():
    """The JAX probe modules (imported here: they set bench.py's JAX
    compilation cache on import)."""
    from benchmarks import copy_ceiling as j_copy
    from benchmarks import rgb1024_experiments as j_rgb
    from benchmarks import rot_experiments as j_rot
    return j_copy, j_rgb, j_rot


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |x| (8 significant bits)."""
    a = np.maximum(np.abs(x.astype(np.float64)), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(a)) - 7)


def assert_within_bf16_ulp(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    d = np.abs(a - b)
    assert (d <= bf16_ulp(b)).all(), d.max()


@dataclasses.dataclass
class Case:
    plan: cuda_shear.ShearKernelPlan
    kp: object                 # the JAX plan
    live_rows: np.ndarray
    live_cols: np.ndarray


_CASES = {}


def _case(geom) -> Case:
    if geom not in _CASES:
        (H, W), angle = geom
        args = ((H, W), 1.0, 0.5, (W / 2, H / 2), angle)
        jop = j_weights.ell_operator(aa.make_grid_spec(*args), mode="exact",
                                     prefer_native=False)
        top = t_weights.ell_operator(at.make_grid_spec(*args), mode="exact",
                                     prefer_native=False)
        plan = cuda_shear.plan_from_operator(top)
        live = plan.w2 != 0
        _CASES[geom] = Case(plan, build_kernel_plan(jop),
                            live.any(axis=(0, 2)), live.any(axis=(0, 1)))
    return _CASES[geom]


def _t(plan, dtype, seed=0, frames=F):
    t = np.random.default_rng(seed).uniform(
        0, 1, (frames, plan.TH, plan.TW)).astype(np.float32)
    return torch.from_numpy(t).to(dtype)


def _jax_inputs(case: Case, t: torch.Tensor, dtype):
    """The port's T zero-padded to JAX's (THp, TWp), and the JAX plan's
    tables, in ``dtype`` where its probes take it."""
    kp, plan = case.kp, case.plan
    assert kp.THp >= plan.TH and kp.TWp >= plan.TW
    tp = np.zeros((t.shape[0], kp.THp, kp.TWp), np.float32)
    tp[:, :plan.TH, :plan.TW] = t.float().numpy()
    dt = jnp.dtype("float32" if dtype == torch.float32 else "bfloat16")
    return dict(r0=jnp.asarray(kp.r0), c0=jnp.asarray(kp.c0),
                t=jnp.asarray(tp, dt), rsel=jnp.asarray(kp.rsel, dt),
                csel=jnp.asarray(kp.csel, dt), w2t=jnp.asarray(kp.w2t),
                masks=jnp.asarray(tile_masks(kp.w2t)), dname=dt.name)


def _dims(kp):
    return (kp.THp, kp.TWp, kp.nty, kp.ntx, kp.TYd, kp.TXd, kp.Ka, kp.Kb,
            kp.SRF, kp.SCF)


def _crop(case, out):
    return np.asarray(out.astype(jnp.float32))[:, :case.plan.Hd,
                                               :case.plan.Wd]


# ---------------------------------------------------------------------------
# the row-tiled copy against the JAX probe
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("H,W,TY", [(24, 40, 8), (30, 37, 8), (17, 5, 17)],
                         ids=["multiple", "ragged", "one-tile"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.uint8], ids=["bf16", "f32", "u8"])
def test_copy_rows_matches_jax_copy(jprobes, H, W, TY, dtype):
    from jax.experimental.pallas import tpu as pltpu

    j_copy = jprobes[0]
    x = harness.uniform((3, H, W), dtype, harness.seeded(
        torch.device("cpu"), H), torch.device("cpu"))
    jname = {torch.bfloat16: "bfloat16", torch.float32: "float32",
             torch.uint8: "uint8"}[dtype]
    xj = jnp.asarray(x.float().numpy(), jnp.dtype(jname))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(j_copy._build_copy(3, H, W, TY, jname)(xj)
                          .astype(jnp.float32))
    plain = copy_ceiling.copy_rows_plain(x, TY)
    assert plain.dtype == dtype and plain.shape == (3, H // TY * TY, W)
    np.testing.assert_array_equal(plain.float().numpy(), want)
    before = copy_ceiling.LAUNCHES
    buf = torch.full(plain.shape, 77, dtype=dtype)
    got = copy_ceiling.copy_rows_kernel(x, TY, out=buf)
    assert got is buf and torch.equal(got, plain)
    assert torch.equal(copy_ceiling.copy_rows_kernel(x, TY), plain)
    assert copy_ceiling.LAUNCHES == before


def test_copy_rows_matches_rgb1024_copy(jprobes):
    from jax.experimental.pallas import tpu as pltpu

    j_rgb = jprobes[1]
    x = harness.uniform((1, j_rgb.H, j_rgb.W), torch.bfloat16,
                        harness.seeded(torch.device("cpu"), 3),
                        torch.device("cpu"))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(j_rgb._build_copy(1, "bfloat16")(
            jnp.asarray(x.float().numpy(), jnp.bfloat16)).astype(jnp.float32))
    got = copy_ceiling.copy_rows_kernel(x, j_rgb.TY)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_copy_grid_fills_the_card():
    # the persistent grid: BLOCKS_PER_SM blocks on each of the H100's 132
    # SMs wherever there are that many pieces
    full = copy_ceiling.BLOCKS_PER_SM * 132
    # 8 x 1024^2 bf16, TY 128: 64 row tiles of 256 KB, 16 pieces each
    assert copy_ceiling.pieces(8, 1024, 1024, 128, 2) == 64 * 16
    assert copy_ceiling.grid_blocks(8, 1024, 1024, 128, 2, 132) == full
    # rgb1024's 24 planes and 4K: every SM busy, many pieces a block
    assert copy_ceiling.grid_blocks(24, 1024, 1024, 128, 2, 132) == full
    assert copy_ceiling.pieces(8, 2160, 3840, 120, 2) == 144 * 57
    assert copy_ceiling.grid_blocks(8, 2160, 3840, 120, 2, 132) == full
    # fewer pieces than the grid: a block a piece
    assert copy_ceiling.grid_blocks(3, 17, 5, 17, 2, 132) == 3


def test_copy_rows_rejects_bad_arguments():
    x = torch.zeros((2, 8, 4))
    for ty in (0, 9):
        with pytest.raises(ValueError, match="tile_y"):
            copy_ceiling.copy_rows_kernel(x, ty)
    with pytest.raises(ValueError, match="F, H, W"):
        copy_ceiling.copy_rows_kernel(torch.zeros((8, 4)), 2)
    with pytest.raises(ValueError, match="out must be"):
        copy_ceiling.copy_rows_kernel(x, 3, out=torch.zeros((2, 8, 4)))


# ---------------------------------------------------------------------------
# the contraction probes against the JAX probes (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("geom", GEOMS, ids=GIDS)
def test_noweight_matches_jax(jprobes, geom, dtype):
    j_rot = jprobes[2]
    case = _case(geom)
    t = _t(case.plan, dtype)
    j = _jax_inputs(case, t, dtype)
    fn = j_rot._build_contract_noweight(F, *_dims(case.kp), j["dname"], True)
    want = _crop(case, fn(j["r0"], j["c0"], j["t"], j["rsel"], j["csel"]))
    got = rot_experiments.contract_probe_kernel(t, case.plan, "noweight")
    assert got.dtype == dtype
    got = got.float().numpy()
    live = case.live_rows[:, None] & case.live_cols[None, :]
    assert live.any()
    assert (want[:, ~live] == 0).all()
    if dtype == torch.float32:
        np.testing.assert_allclose(got[:, live], want[:, live], rtol=0,
                                   atol=2e-5)
    else:
        assert_within_bf16_ulp(got[:, live], want[:, live])


@pytest.mark.parametrize("probe", ["pipelined", "shares_off"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("geom", GEOMS, ids=GIDS)
def test_weighted_probes_match_jax(jprobes, geom, dtype, probe):
    j_rot = jprobes[2]
    case = _case(geom)
    t = _t(case.plan, dtype, seed=1)
    j = _jax_inputs(case, t, dtype)
    if probe == "pipelined":
        fn = j_rot._build_contract_pipelined(F, *_dims(case.kp), j["dname"],
                                             True)
        want = fn(j["r0"], j["c0"], j["t"], j["rsel"], j["csel"], j["w2t"])
        got = rot_experiments.contract_probe_kernel(t, case.plan, "pipelined")
    else:
        fn = j_rot._build_contract_share(F, *_dims(case.kp), j["dname"],
                                         False, False, True)
        want = fn(j["r0"], j["c0"], j["masks"], j["t"], j["rsel"], j["csel"],
                  j["w2t"])
        got = cuda_shear.contract_kernel(t, case.plan)
    want = _crop(case, want)
    assert got.dtype == dtype
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    else:
        assert_within_bf16_ulp(got.float().numpy(), want)


# ---------------------------------------------------------------------------
# the tiled probes against their definitions
# ---------------------------------------------------------------------------

TILED = ("tshare", "wshare", "bothshare", "pipelined")


def _elem(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _formula(t: np.ndarray, plan, mode: str, elem: int) -> np.ndarray:
    """float64 numpy statement of a probe mode.  noweight: the unmasked
    sums of the T windows.  The tiled modes, tile by tile on the route's
    table for ``elem``-byte frames: each in-span pixel of a live tile sums
    its taps from its tile's window at window-local indices, the window
    taken from frame 0 at T's origin (tshare, bothshare), the weights
    from the first live tile at the pixel's position within it, clamped
    (wshare, bothshare); every other pixel is 0."""
    tn = t.astype(np.float64)
    w2 = plan.w2.astype(np.float64)
    Ka, Kb, Hd, Wd = plan.Ka, plan.Kb, plan.Hd, plan.Wd
    out = np.zeros((tn.shape[0], Hd, Wd))
    if mode == "noweight":
        for a in range(Ka):
            for b in range(Kb):
                rows = np.clip(plan.ry0 + a, 0, plan.TH - 1)
                cols = np.clip(plan.cx0 + b, 0, plan.TW - 1)
                out += tn[:, rows][:, :, cols]
        return out
    share_t = mode in ("tshare", "bothshare")
    share_w = mode in ("wshare", "bothshare")
    tiles = plan.contract_plan(elem)
    TYd, TXd = tiles.TYd, tiles.TXd
    n_tx = -(-Wd // TXd)
    first = int(np.flatnonzero(tiles.win[:, 2] > 0)[0])
    wy0, wx0 = first // n_tx * TYd, first % n_tx * TXd
    for i, (r0, c0, rows, cols) in enumerate(tiles.win.tolist()):
        if rows == 0:
            continue
        y0, x0 = i // n_tx * TYd, i % n_tx * TXd
        window = (tn[:1, :rows, :cols] if share_t
                  else tn[:, r0:r0 + rows, c0:c0 + cols])
        for dy in range(y0, min(y0 + TYd, Hd)):
            lo, hi = plan.span[dy]
            lr = np.clip(plan.ry0[dy] + np.arange(Ka), 0, plan.TH - 1) - r0
            for dx in range(max(x0, lo), min(x0 + TXd, hi)):
                lc = (np.clip(plan.cx0[dx] + np.arange(Kb), 0, plan.TW - 1)
                      - c0)
                assert lr.min() >= 0 and lr.max() < rows
                assert lc.min() >= 0 and lc.max() < cols
                wy, wx = ((min(wy0 + dy - y0, Hd - 1), min(wx0 + dx - x0,
                                                          Wd - 1))
                          if share_w else (dy, dx))
                taps = w2[:, wy, wx].reshape(Ka, Kb)
                out[:, dy, dx] = (window[:, lr][:, :, lc] * taps).sum((1, 2))
    return out


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("geom", GEOMS, ids=GIDS)
def test_share_modes_meet_their_definitions(geom, dtype):
    plan = _case(geom).plan
    t = _t(plan, dtype, seed=2, frames=3)
    tiles = plan.contract_plan(_elem(dtype))
    tiled = cuda_shear.contract_tiled_plain(t, plan, tiles)
    live = cuda_shear.live_mask(plan, t.device)
    out = {m: rot_experiments.contract_probe_kernel(t, plan, m)
           for m in TILED}
    ts, ws, bs = out["tshare"], out["wshare"], out["bothshare"]
    # pipelined is the route's tiled contraction, bit for bit
    assert torch.equal(out["pipelined"], tiled)
    # every mode skips dead pixels, as the route's contraction does
    for x in out.values():
        assert x.dtype == dtype and (x[:, ~live] == 0).all()
    # tshare and bothshare sum frame 0's corner: the same for every frame
    for x in (ts, bs):
        assert all(torch.equal(x[f], x[0]) for f in range(3))
    # on the shared tile's own pixels wshare reads its own weights, and
    # bothshare's weights are tshare's
    first = rot_experiments.shared_tile(tiles)
    assert tiles.win[first, 2] > 0 and (tiles.win[:first, 2] == 0).all()
    n_tx = -(-plan.Wd // tiles.TXd)
    ys = slice(first // n_tx * tiles.TYd, (first // n_tx + 1) * tiles.TYd)
    xs = slice(first % n_tx * tiles.TXd, (first % n_tx + 1) * tiles.TXd)
    assert torch.equal(ws[:, ys, xs], tiled[:, ys, xs])
    assert torch.equal(bs[:, ys, xs], ts[:, ys, xs])
    assert (ws[:, ys, xs] != 0).any()


@pytest.mark.parametrize("mode", sorted(rot_experiments.MODES))
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("geom", GEOMS, ids=GIDS)
def test_probe_modes_match_float64_statement(geom, dtype, mode):
    plan = _case(geom).plan
    t = _t(plan, dtype, seed=3, frames=3)
    got = rot_experiments.contract_probe_plain(t, plan, mode,
                                               out_dtype=torch.float32)
    want = _formula(t.float().numpy(), plan, mode, _elem(dtype))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2e-5 if mode == "noweight" else 1e-5)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("geom", GEOMS, ids=GIDS)
def test_tshare_reads_only_frame0_corner(geom, dtype):
    plan = _case(geom).plan
    t = _t(plan, dtype, seed=4, frames=3)
    win = plan.contract_plan(_elem(dtype)).win
    rows, cols = int(win[:, 2].max()), int(win[:, 3].max())
    assert rows < plan.TH or cols < plan.TW
    other = _t(plan, dtype, seed=5, frames=3)
    other[0, :rows, :cols] = t[0, :rows, :cols]
    assert not torch.equal(other, t)
    for mode in ("tshare", "bothshare"):
        assert torch.equal(
            rot_experiments.contract_probe_plain(other, plan, mode),
            rot_experiments.contract_probe_plain(t, plan, mode))
    assert not torch.equal(
        rot_experiments.contract_probe_plain(other, plan, "wshare"),
        rot_experiments.contract_probe_plain(t, plan, "wshare"))


def _one_live_tile(plan, elem):
    """``plan`` with every dst pixel outside one live tile of its tile
    table made dead (its rows' spans cut to the tile), so that its table
    has that one live tile."""
    tiles = plan.contract_plan(elem)
    n_tx = -(-plan.Wd // tiles.TXd)
    pick = np.flatnonzero(tiles.win[:, 2] > 0)
    i = int(pick[len(pick) // 2])
    y0, x0 = i // n_tx * tiles.TYd, i % n_tx * tiles.TXd
    span = np.zeros_like(plan.span)
    ys = slice(y0, min(y0 + tiles.TYd, plan.Hd))
    span[ys, 0] = np.clip(plan.span[ys, 0], x0, x0 + tiles.TXd)
    span[ys, 1] = np.clip(plan.span[ys, 1], x0, x0 + tiles.TXd)
    span[span[:, 0] >= span[:, 1]] = 0
    one = dataclasses.replace(plan, span=span, tiles={}, dev={})
    assert (one.contract_plan(elem).win[:, 2] > 0).sum() == 1
    return one


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("geom", GEOMS, ids=GIDS)
def test_wshare_on_one_live_tile_is_the_tiled_contraction(geom, dtype):
    plan = _one_live_tile(_case(geom).plan, _elem(dtype))
    t = _t(plan, dtype, seed=6, frames=3)
    want = cuda_shear.contract_tiled_plain(
        t, plan, plan.contract_plan(_elem(dtype)))
    assert (want != 0).any()
    assert torch.equal(
        rot_experiments.contract_probe_plain(t, plan, "wshare"), want)


@pytest.mark.parametrize("geom", GEOMS, ids=GIDS)
def test_pipeline_order_deals_the_fullest_live_tiles_first(geom):
    plan = _case(geom).plan
    tiles = plan.contract_plan(2)
    order, n_live = rot_experiments.pipeline_order(plan, tiles)
    assert order.dtype == np.int32
    assert sorted(order.tolist()) == list(range(len(tiles.win)))
    live = tiles.win[:, 2] > 0
    assert n_live == live.sum() and live[order[:n_live]].all()
    assert not live[order[n_live:]].any()
    # in-span pixels of each live tile, brute force: non-increasing,
    # ties in tile order
    n_tx = -(-plan.Wd // tiles.TXd)
    work = []
    for i in order[:n_live]:
        y0, x0 = i // n_tx * tiles.TYd, i % n_tx * tiles.TXd
        work.append(sum(max(0, min(x0 + tiles.TXd, plan.Wd, hi)
                            - max(x0, lo))
                        for lo, hi in plan.span[y0:y0 + tiles.TYd]))
    assert all(a > b or (a == b and i < j) for a, b, i, j in zip(
        work, work[1:], order[:n_live], order[1:n_live]))


def test_plain_versions_launch_nothing():
    plan = _case(GEOMS[0]).plan
    t = _t(plan, torch.bfloat16, frames=11)
    before = (dict(rot_experiments.LAUNCHES), dict(cuda_shear.LAUNCHES))
    for mode in rot_experiments.MODES:
        y = rot_experiments.contract_probe_plain(t, plan, mode)
        assert y.shape == (11, plan.Hd, plan.Wd) and y.is_contiguous()
        z = rot_experiments.contract_probe_kernel(t, plan, mode)
        assert torch.equal(y, z)
    assert (dict(rot_experiments.LAUNCHES), dict(cuda_shear.LAUNCHES)) == \
        before


@pytest.mark.parametrize("mode", TILED)
def test_tiled_probes_need_the_plans_tiles(mode):
    plan = _case(GEOMS[0]).plan
    bare = dataclasses.replace(plan, tiles={"contract2": None,
                                            "contract4": None})
    t = _t(plan, torch.float32)
    for fn in (rot_experiments.contract_probe_plain,
               rot_experiments.contract_probe_kernel):
        with pytest.raises(RuntimeError, match=f"contract probe {mode}"):
            fn(t, bare, mode)
    if mode != "pipelined":         # its traffic is the route's
        with pytest.raises(RuntimeError, match=f"contract probe {mode}"):
            rot_experiments.traffic(bare, F, 4, mode)
    assert torch.equal(
        rot_experiments.contract_probe_plain(t, bare, "noweight"),
        rot_experiments.contract_probe_plain(t, plan, "noweight"))


def test_contract_probe_rejects_bad_arguments():
    plan = _case(GEOMS[0]).plan
    t = _t(plan, torch.float32)
    with pytest.raises(ValueError, match="probe mode"):
        rot_experiments.contract_probe_kernel(t, plan, "contract")
    with pytest.raises(ValueError, match="T must be"):
        rot_experiments.contract_probe_kernel(t[:, 1:], plan, "noweight")
    buf = torch.full((F, plan.Hd, plan.Wd), float("nan"))
    got = rot_experiments.contract_probe_kernel(t, plan, "wshare", out=buf)
    assert got is buf and torch.equal(
        got, rot_experiments.contract_probe_plain(t, plan, "wshare"))


def test_traffic_counts_what_each_mode_reads():
    p = _case(GEOMS[1]).plan
    e = 2
    t_b, o_b = F * p.TH * p.TW * e, F * p.Hd * p.Wd * e
    w_b, idx = p.Ka * p.Kb * p.Hd * p.Wd * 4, (p.Hd + p.Wd) * 4
    taps = F * p.Hd * p.Wd * p.Ka * p.Kb
    # the dead-pixel skip: the live pixels and the T elements the live
    # pixels' windows touch (brute force)
    cols = np.arange(p.Wd)[None, :]
    live = (cols >= p.span[:, :1]) & (cols < p.span[:, 1:])
    touched = np.zeros((p.TH, p.TW), bool)
    for dy, dx in zip(*np.nonzero(live)):
        for a in range(p.Ka):
            for b in range(p.Kb):
                touched[min(max(p.ry0[dy] + a, 0), p.TH - 1),
                        min(max(p.cx0[dx] + b, 0), p.TW - 1)] = True
    n_live = int(live.sum())
    assert 0 < n_live < p.Hd * p.Wd
    t_lb, w_lb = F * int(touched.sum()) * e, p.Ka * p.Kb * n_live * 4
    sp, live_taps = p.Hd * 8, F * n_live * p.Ka * p.Kb
    tr = rot_experiments.traffic
    assert tr(p, F, e, "contract") == (t_b + w_b + o_b + idx, 2 * taps)
    masked = (t_lb + w_lb + o_b + idx + sp, 2 * live_taps)
    assert tr(p, F, e, "contract_masked") == masked
    assert tr(p, F, e, "pipelined") == masked
    assert tr(p, F, e, "noweight") == (t_b + o_b + idx, taps)
    # a shared T: frame 0's largest window, once; shared weights: one
    # tile's
    win = p.contract_plan(e).win
    t_win = int((win[:, 2] * win[:, 3]).max()) * e
    w_tile = p.Ka * p.Kb * 8 * 32 * 4
    assert tr(p, F, e, "tshare") == (t_win + w_lb + o_b + idx + sp,
                                     2 * live_taps)
    assert tr(p, F, e, "wshare") == (t_lb + w_tile + o_b + idx + sp,
                                     2 * live_taps)
    assert tr(p, F, e, "bothshare") == (t_win + w_tile + o_b + idx + sp,
                                        2 * live_taps)


# ---------------------------------------------------------------------------
# the entry points on the CPU
# ---------------------------------------------------------------------------


@pytest.fixture
def small_cache(tmp_path, monkeypatch):
    monkeypatch.setattr(t_cache, "DEFAULT_CACHE_DIR", str(tmp_path))
    return tmp_path


def _launch_counts():
    return (copy_ceiling.LAUNCHES, dict(rot_experiments.LAUNCHES),
            dict(cuda_shear.LAUNCHES))


@pytest.mark.parametrize("exp", sorted(rot_experiments.EXPS))
def test_rot_experiments_run_on_cpu(small_cache, exp):
    before = _launch_counts()
    r = rot_experiments.EXPS[exp](2, torch.bfloat16, "cpu", shape=(96, 80),
                                  angle=30.0)
    assert _launch_counts() == before
    assert r["clock"] == "host" and r["device"] == "cpu"
    assert r["exp"] == exp and r["batch"] == 2 and r["shape"] == [96, 80]
    assert r["ms_per_batch"] > 0 and r["gpixel_s"] > 0
    assert r["us_per_frame"] == pytest.approx(r["ms_per_batch"] * 500)
    if exp == "shears":
        assert r["vshear_ms"] > 0 and r["hshear_ms"] > 0


def test_copy_ceiling_runs_on_cpu(capsys):
    before = _launch_counts()
    r = copy_ceiling.measure(24, 40, 8, batch=2, dtype=torch.uint8,
                             device="cpu")
    assert r["clock"] == "host" and r["bytes_per_batch"] == 2 * 2 * 24 * 40
    assert r["gb_s_combined"] == pytest.approx(2 * r["gb_s_each_way"])
    rc = copy_ceiling.main(["--H", "24", "--W", "40", "--tile_y", "8",
                            "--batch", "2", "--dtype", "float32",
                            "--device", "cpu"])
    assert rc == 0 and _launch_counts() == before
    line = capsys.readouterr().out.splitlines()[0]
    assert line.startswith("copy 24x40 float32 tile_y=8: ")
    assert "us/frame" in line and "GB/s combined (" in line
    with pytest.raises(SystemExit):
        copy_ceiling.main(["--H", "30", "--tile_y", "8", "--device", "cpu"])


def test_entry_points_default_to_the_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("checks the error without a GPU")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rot_experiments.EXPS["noweight"](2, torch.float32, shape=(96, 80))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        copy_ceiling.measure(24, 40, 8)
    assert rot_experiments.main(["--exp", "contract"]) == 2
    assert copy_ceiling.main([]) == 2
    assert "device='cpu'" in capsys.readouterr().err
