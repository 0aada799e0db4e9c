"""The tiled masked contraction (``ops/cuda_shear``: TPU kernel 6 with
``masked=True``, the exact rotated route's) and the copy's persistent ring
of bulk copies (``probes/copy_ceiling``).

On the CPU:

* The tile table (``contract_tiles`` / ``plan_contract``) at the rotated
  flagship cut down to 256^2 (1.0 -> 0.5 at 30 degrees), at compat and at
  6 seeded random angles and scales, for bf16 and f32 frames: each tile's
  window is, by brute force over the tile's pixels, the hull of the taps
  of its in-span pixels and of no other (rows and columns outside the
  footprint carry ry0 = cx0 = 0 and do not widen it: a plan with dead
  rows and columns pins that), rounded out to whole ``COL_ALIGN``
  columns; dead tiles are all 0; every window fits the shared-memory
  budget (the last tile shape: the card's opt-in).
* ``contract_tiled_plain``, which reads T only through each tile's window
  and indices local to it, is ``torch.equal`` to ``contract_plain(
  masked=True, fused=True)`` for bf16 and f32, F 1, 3 and 11.
* The route on the tiled plan (the fused shear's plain version, then
  ``contract_tiled_plain``) against JAX's masked route
  (``make_pallas_shear_apply``, ``interpret=True``) at the flagship cut
  down and two random geometries, with the pins of
  tests/test_torch_masked_contract.py: f32 atol 1e-5, bf16 within one
  bf16 ulp.
* Which plans take the direct form: a 1 -> 0.065 downscale at 30 degrees
  in f32 (its smallest tile window exceeds the card's opt-in), no other
  plan here; a table that misses a tap is refused.
* The copy's piece split (``span_segments``, the kernel's split): every
  byte of a span once, bulk copies 16-byte aligned on both sides, heads,
  tails and spans whose source and output differ mod 16; its grid.

On the card (marker ``cuda``, skipped here; JAX is imported only inside
the parity test's fixture, so the card's run needs none): the tiled kernel
``torch.equal`` to the unmasked instance (the direct form) and into
NaN-filled outputs for bf16 and f32, F 1, 3, 8 and 11, at the rotated
flagship, compat and random geometries, 0 outside the spans on NaN T,
the direct route where the planner sends it; the copy bit-exact at ragged
shapes and at source and output offsets that differ mod 16.
"""

import dataclasses

import numpy as np
import pytest
import torch

import aainterp_torch as at
from aainterp_torch.ops import cuda_shear
from aainterp_torch.ops import weights as t_weights
from aainterp_torch.probes import copy_ceiling
from aainterp_torch.utils.device import SMEM_LIMIT


def _random_geoms(n=6, seed=17):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        h, w = (int(v) for v in rng.integers(60, 140, 2))
        ratio = float(rng.choice([0.4, 0.5, 0.75, 1.0, 1.5]))
        angle = float(np.round(rng.uniform(3.0, 87.0), 2))
        out.append(((h, w), 1.0, ratio, (h / 2 + 0.3, w / 2 - 0.7), angle))
    return out


FLAGSHIP_CUT = ((256, 256), 1.0, 0.5, (128.0, 128.0), 30.0)
COMPAT = ((64, 64), 1.0, 0.5, (32.0, 32.0), 30.0)
RANDOM = _random_geoms()
CASES = ([(FLAGSHIP_CUT, "exact"), (COMPAT, "compat")]
         + [(g, "exact") for g in RANDOM])
IDS = ["flagship256", "compat"] + [f"random{i}" for i in range(len(RANDOM))]
# a 1 -> 0.065 downscale: the smallest tile's window fits the opt-in in
# bf16, not in f32
DIRECT = ((400, 400), 1.0, 0.065, (200.0, 200.0), 30.0)
ELEMS = {torch.bfloat16: 2, torch.float32: 4}
_PLANS = {}


def _plan(args, mode="exact"):
    if (args, mode) not in _PLANS:
        op = t_weights.ell_operator(at.make_grid_spec(*args), mode=mode,
                                    prefer_native=False)
        _PLANS[(args, mode)] = (op, cuda_shear.plan_from_operator(op))
    return _PLANS[(args, mode)][1]


def _t(plan, dtype, frames, seed=3):
    t = np.random.default_rng(seed).uniform(
        0, 1, (frames, plan.TH, plan.TW)).astype(np.float32)
    return torch.from_numpy(t).to(dtype)


def _brute_window(plan, dys, dxs):
    """The window (r0, c0, rows, cols) of the in-span pixels among rows
    ``dys`` and columns ``dxs``, one pixel at a time; None if none."""
    r = []
    c = []
    for dy in dys:
        lo, hi = plan.span[dy]
        for dx in dxs:
            if lo <= dx < hi:
                for a in range(plan.Ka):
                    r.append(min(max(int(plan.ry0[dy]) + a, 0), plan.TH - 1))
                for b in range(plan.Kb):
                    c.append(min(max(int(plan.cx0[dx]) + b, 0), plan.TW - 1))
    if not r:
        return None
    a = cuda_shear.COL_ALIGN
    c0 = min(c) // a * a
    c1 = min(-(-(max(c) + 1) // a) * a, plan.TW)
    return (min(r), c0, max(r) + 1 - min(r), c1 - c0)


@pytest.mark.parametrize("elem", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("args,mode", CASES, ids=IDS)
def test_tiles_hold_the_taps_of_in_span_pixels_only(args, mode, elem):
    plan = _plan(args, mode)
    tiles = cuda_shear.plan_contract(plan, elem)
    assert tiles is not None and tiles.win.dtype == np.int32
    n_ty = -(-plan.Hd // tiles.TYd)
    n_tx = -(-plan.Wd // tiles.TXd)
    assert tiles.win.shape == (n_ty * n_tx, 4)
    for i, got in enumerate(tiles.win.tolist()):
        ty, tx = divmod(i, n_tx)
        want = _brute_window(
            plan, range(ty * tiles.TYd, min((ty + 1) * tiles.TYd, plan.Hd)),
            range(tx * tiles.TXd, min((tx + 1) * tiles.TXd, plan.Wd)))
        assert got == list(want or (0, 0, 0, 0)), (i, got, want)
    live = tiles.win[tiles.win[:, 2] > 0]
    assert len(live) and (live[:, 1] % cuda_shear.COL_ALIGN == 0).all()
    assert tiles.cells == int((live[:, 2] * live[:, 3]).max())
    # the budget, or the opt-in for the last tile shape
    limit = (SMEM_LIMIT if (tiles.TYd, tiles.TXd)
             == cuda_shear._CONTRACT_TILES[-1]
             else cuda_shear.CONTRACT_SMEM_BUDGET)
    assert tiles.smem(elem) <= limit
    assert tiles.smem(elem) == -(-tiles.cells * 8 * elem // 128) * 128


def _dead_plan(plan):
    """``plan`` with every 7th dst row and its first 9 and last 5 columns
    dead (weights 0), their ry0 / cx0 set to 0 as ``build_shear_plan``
    sets them outside the footprint, spans recomputed."""
    w2, ry0, cx0 = plan.w2.copy(), plan.ry0.copy(), plan.cx0.copy()
    w2[:, ::7] = 0.0
    ry0[::7] = 0
    for cols in (slice(0, 9), slice(-5, None)):
        w2[:, :, cols] = 0.0
        cx0[cols] = 0
    return dataclasses.replace(plan, w2=w2, ry0=ry0, cx0=cx0,
                               span=cuda_shear.live_spans(w2), tiles={},
                               dev={})


@pytest.mark.parametrize("elem", [2, 4], ids=["bf16", "f32"])
def test_dead_rows_and_columns_do_not_widen_windows(elem):
    plan = _dead_plan(_plan(FLAGSHIP_CUT))
    tiles = plan.contract_plan(elem)
    n_tx = -(-plan.Wd // tiles.TXd)
    touched = 0
    for i, (r0, c0, rows, cols) in enumerate(tiles.win.tolist()):
        ty, tx = divmod(i, n_tx)
        ys = range(ty * tiles.TYd, min((ty + 1) * tiles.TYd, plan.Hd))
        xs = range(tx * tiles.TXd, min((tx + 1) * tiles.TXd, plan.Wd))
        want = _brute_window(plan, ys, xs)
        assert [r0, c0, rows, cols] == list(want or (0, 0, 0, 0))
        if rows and (any(y % 7 == 0 for y in ys) or xs[0] < 9
                     or xs[-1] >= plan.Wd - 5):
            touched += 1
            # T row or column 0 would stretch the window over the plane
            assert 0 < r0 and 0 < c0
            assert rows < plan.TH // 4 and cols < plan.TW // 4
    assert touched > 0
    assert torch.equal(
        cuda_shear.contract_tiled_plain(_t(plan, torch.float32, 2), plan,
                                        tiles),
        cuda_shear.contract_plain(_t(plan, torch.float32, 2), plan,
                                  fused=True))


@pytest.mark.parametrize("frames", [1, 3, 11])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("args,mode", CASES[:4], ids=IDS[:4])
def test_tiled_plain_equals_masked_plain(args, mode, dtype, frames):
    plan = _plan(args, mode)
    t = _t(plan, dtype, frames)
    tiles = plan.contract_plan(ELEMS[dtype])
    got = cuda_shear.contract_tiled_plain(t, plan, tiles)
    assert got.dtype == dtype
    assert torch.equal(got, cuda_shear.contract_plain(t, plan, fused=True))


def test_tiled_plain_reads_only_the_windows():
    plan = _plan(FLAGSHIP_CUT)
    tiles = plan.contract_plan(4)
    t = _t(plan, torch.float32, 2)
    # T outside every window: NaN, which no output may see
    seen = torch.zeros((plan.TH, plan.TW), dtype=torch.bool)
    for r0, c0, rows, cols in tiles.win.tolist():
        seen[r0:r0 + rows, c0:c0 + cols] = True
    t[:, ~seen] = float("nan")
    assert (~seen).any()
    got = cuda_shear.contract_tiled_plain(t, plan, tiles)
    assert not torch.isnan(got).any()
    # a window one column short misses a tap: the plain version and the
    # planner's check both refuse it
    win = tiles.win.copy()
    i = int(np.argmax(win[:, 2] * win[:, 3]))
    win[i, 3] = cuda_shear.COL_ALIGN * (win[i, 3] // cuda_shear.COL_ALIGN - 1)
    short = dataclasses.replace(tiles, win=win)
    with pytest.raises(IndexError):
        cuda_shear.contract_tiled_plain(t, plan, short)
    with pytest.raises(RuntimeError, match="misses the taps"):
        cuda_shear._check_windows(plan, win, tiles.TYd, tiles.TXd)


@pytest.fixture(scope="module")
def jax_route():
    """JAX's masked route and array module (imported here, so the card's
    run, which has no JAX, never imports them)."""
    import jax.numpy as jnp

    import aainterp as aa
    from aainterp.ops import weights as j_weights
    from aainterp.ops.pallas_shear import make_pallas_shear_apply
    return jnp, aa, j_weights, make_pallas_shear_apply


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    a = np.maximum(np.abs(x.astype(np.float64)), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(a)) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("args", [FLAGSHIP_CUT] + RANDOM[:2],
                         ids=["flagship256", "random0", "random1"])
def test_tiled_route_matches_jax_masked_route(jax_route, args, dtype):
    jnp, aa, j_weights, make_pallas_shear_apply = jax_route
    jop = j_weights.ell_operator(aa.make_grid_spec(*args), mode="exact",
                                 prefer_native=False)
    plan = _plan(args)
    x = np.random.default_rng(5).uniform(
        0, 1, (2, plan.qH, plan.qW)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    fn, arrs = make_pallas_shear_apply(jop, interpret=True)
    want = np.asarray(fn(jnp.asarray(x, jdt), **arrs).astype(jnp.float32))
    xt = torch.from_numpy(np.asarray(jnp.asarray(x, jdt).astype(jnp.float32)))
    tdt = getattr(torch, dtype)
    t = cuda_shear.vhshear_plain(xt.to(tdt), plan)
    got = cuda_shear.contract_tiled_plain(t, plan,
                                          plan.contract_plan(ELEMS[tdt]))
    assert got.dtype == tdt
    assert want.shape == tuple(got.shape) == (2, plan.Hd, plan.Wd)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        assert (np.abs(got.astype(np.float64) - want) <= _bf16_ulp(want)).all()


def test_direct_route_geometries():
    plan = _plan(DIRECT)
    assert (plan.Ka, plan.Kb) == (21, 16)
    bf16 = plan.contract_plan(2)
    assert (bf16.TYd, bf16.TXd) == cuda_shear._CONTRACT_TILES[-1]
    assert cuda_shear.CONTRACT_SMEM_BUDGET < bf16.smem(2) <= SMEM_LIMIT
    assert plan.contract_plan(4) is None
    assert cuda_shear.contract_tiles(plan, 1, 32).smem(4) > SMEM_LIMIT
    # every other plan of this file takes the tiled kernel at both sizes
    for args, mode in CASES:
        p = _plan(args, mode)
        assert p.contract_plan(2) is not None and p.contract_plan(4) is not None
    # on a CPU tensor the wrapper takes the plain version, no launch
    t = _t(plan, torch.float32, 2)
    before = dict(cuda_shear.LAUNCHES)
    assert torch.equal(cuda_shear.contract_kernel(t, plan),
                       cuda_shear.contract_plain(t, plan))
    assert cuda_shear.LAUNCHES == before


# ---------------------------------------------------------------------------
# the copy's piece split and grid
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,elem", [(921600, 2), (262144, 2), (40000, 4),
                                    (1023, 1), (125 * 1023, 1), (5, 1),
                                    (2 * 3 * 37, 2), (7 * 8, 8), (16, 2),
                                    (3 * 16384 + 24, 8)])
@pytest.mark.parametrize("src,dst", [(0, 0), (6, 22), (3, 5), (8, 0),
                                     (4, 8), (2, 6), (12, 28)])
def test_copy_span_segments_cover_every_byte_once(n, elem, src, dst):
    src, dst = src // elem * elem, dst // elem * elem    # element-aligned
    base_s, base_d = 4096 + src, 8192 + dst
    parts = -(-n // copy_ceiling.PIECE_BYTES)
    hits = np.zeros(n, np.int64)
    agree = (base_s ^ base_d) & 15 == 0
    for part in range(parts):
        for kind, off, nbytes, unit in copy_ceiling.span_segments(
                base_s, base_d, n, elem, part, parts):
            assert nbytes > 0 and nbytes % unit == 0
            assert (base_s + off) % unit == 0 == (base_d + off) % unit
            if kind == "bulk":
                assert agree and unit == 16
                assert nbytes <= copy_ceiling.PIECE_BYTES
            else:
                assert kind == "words" and unit in (elem, 4, 8)
            hits[off:off + nbytes] += 1
    assert (hits == 1).all()


def test_copy_span_segments_use_bulk_copies_where_aligned():
    segs = [s for p in range(57) for s in copy_ceiling.span_segments(
        4096 + 6, 8192 + 22, 921600, 2, p, 57)]
    kinds = [k for k, *_ in segs]
    assert kinds[0] == "words" and segs[0][2] == 10        # the head
    assert kinds[-1] == "words" and segs[-1][2] == 6       # the tail
    assert kinds[1:-1] == ["bulk"] * 57
    assert sum(s[2] for s in segs if s[0] == "bulk") == 921600 - 16
    # no bulk copy where the two differ mod 16
    assert all(k == "words" for p in range(2) for k, *_ in
               copy_ceiling.span_segments(4096 + 3, 8192 + 5, 20000, 1, p, 2))


def test_copy_grid_pieces():
    P = copy_ceiling.PIECE_BYTES
    # 8 x 2160 x 3840 bf16, TY 120: 144 row tiles of 921,600 bytes
    assert copy_ceiling.pieces(8, 2160, 3840, 120, 2) == 144 * -(-921600 // P)
    assert copy_ceiling.pieces(3, 17, 5, 17, 2) == 3
    assert copy_ceiling.grid_blocks(3, 17, 5, 17, 2, 132) == 3


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda:0")


_CARD_PLANS = {}


def _card_plan(name):
    """Plans on the card's host: the rotated flagship and compat at 512^2
    on the native engine, the random geometries and the flagship cut down
    with dead rows and columns (``_dead_plan``) as above."""
    if name not in _CARD_PLANS:
        if name == "flagship":
            op = at.build_operator(at.make_grid_spec(
                (2048, 2048), 1.0, 0.5, (1024.0, 1024.0), 30.0),
                mode="exact")
        elif name == "compat":
            op = at.build_operator(at.make_grid_spec(
                (512, 512), 1.0, 0.5, (256.0, 256.0), 30.0), mode="compat")
        elif name == "dead":
            _CARD_PLANS[name] = _dead_plan(_plan(FLAGSHIP_CUT))
            return _CARD_PLANS[name]
        else:
            op = t_weights.ell_operator(at.make_grid_spec(
                *RANDOM[int(name[-1])]), mode="exact", prefer_native=False)
        _CARD_PLANS[name] = cuda_shear.plan_from_operator(op)
    return _CARD_PLANS[name]


def _card_t(plan, dtype, frames, device, seed=7):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.rand((frames, plan.TH, plan.TW), generator=g,
                      device=device).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("frames", [1, 3, 8, 11])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["flagship", "compat", "random0",
                                  "random3", "random5", "dead"])
def test_tiled_kernel_equals_unmasked_on_the_card(cuda, name, dtype, frames):
    plan = _card_plan(name)
    t = _card_t(plan, dtype, frames, cuda)
    before = dict(cuda_shear.LAUNCHES)
    out = torch.full((frames, plan.Hd, plan.Wd), float("nan"), dtype=dtype,
                     device=cuda)
    got = cuda_shear.contract_kernel(t, plan, out=out)
    un = cuda_shear.contract_unmasked_kernel(t, plan)
    torch.cuda.synchronize()
    assert got is out
    assert {k: cuda_shear.LAUNCHES[k] - before[k] for k in before} == {
        "vshear": 0, "hshear": 0, "vhshear": 0, "contract": 1,
        "contract_unmasked": 1, "contract_direct": 0}
    assert torch.equal(got, un)
    if name != "flagship":
        assert torch.equal(got.cpu(), cuda_shear.contract_plain(
            t.cpu(), plan, fused=True))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["flagship", "compat", "random1"])
def test_tiled_kernel_nan_t_gives_zero_outside_spans(cuda, name, dtype):
    plan = _card_plan(name)
    nan = torch.full((3, plan.TH, plan.TW), float("nan"), dtype=dtype,
                     device=cuda)
    got = cuda_shear.contract_kernel(nan, plan)
    torch.cuda.synchronize()
    live = cuda_shear.live_mask(plan, cuda)
    assert (got[:, ~live] == 0).all()
    weighted = torch.from_numpy((plan.w2 != 0).any(axis=0)).to(cuda)
    assert torch.isnan(got[:, weighted]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_direct_route_on_the_card(cuda, dtype):
    plan = _plan(DIRECT)
    t = _card_t(plan, dtype, 3, cuda)
    before = dict(cuda_shear.LAUNCHES)
    got = cuda_shear.contract_kernel(t, plan)
    un = cuda_shear.contract_unmasked_kernel(t, plan)
    torch.cuda.synchronize()
    direct = dtype == torch.float32          # the planner's choice
    moved = {k: cuda_shear.LAUNCHES[k] - before[k] for k in before}
    assert moved["contract"] == int(not direct)
    assert moved["contract_direct"] == int(direct)
    assert torch.equal(got, un)


@pytest.mark.cuda
@pytest.mark.parametrize("src_off,dst_off", [(0, 0), (3, 5), (8, 0), (1, 9)])
@pytest.mark.parametrize("shape,ty", [((3, 70, 256), 16), ((2, 31, 37), 5),
                                      ((2, 1080, 1919), 120),
                                      ((24, 1024, 1024), 128),
                                      ((3, 1001, 1023), 125)])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.bfloat16,
                                   torch.float32])
def test_copy_ring_bit_exact_at_offsets(cuda, shape, ty, dtype, src_off,
                                        dst_off):
    n = shape[0] * shape[1] * shape[2]
    g = torch.Generator(device=cuda).manual_seed(1)
    raw = torch.randint(0, 256, ((n + src_off) * dtype.itemsize,),
                        generator=g, dtype=torch.uint8, device=cuda)
    x = raw.view(dtype)[src_off:].view(shape)
    rows = shape[1] // ty * ty
    buf = torch.empty((shape[0] * rows * shape[2] + dst_off,), dtype=dtype,
                      device=cuda)
    buf.view(torch.uint8).fill_(0xFF)
    out = buf[dst_off:].view(shape[0], rows, shape[2])
    before = copy_ceiling.LAUNCHES
    got = copy_ceiling.copy_rows_kernel(x, ty, out=out)
    torch.cuda.synchronize()
    assert got is out and copy_ceiling.LAUNCHES == before + 1
    assert torch.equal(got.view(torch.uint8),
                       copy_ceiling.copy_rows_plain(x, ty).view(torch.uint8))
