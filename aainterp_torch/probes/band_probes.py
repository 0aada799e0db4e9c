"""Kernel 1's probe modes: the production separable kernel
(``csrc/band_apply.cuh``) with one thing changed per mode, on
``csrc/band_probes.cu``, at kernel 1's own plan (``ops/cuda_apply``:
8 x 240 dst tiles at the 4K flagship and at rgb1024); ``densex`` on
``csrc/dense_x.cu``, a wgmma product on the tensor cores.
``flagship_experiments``, ``u8_experiments`` and ``rgb1024_experiments``
run them; this module holds what they share.

Modes (``MODES``; each stores one value per dst element of the
production's tiles, derived from what it keeps):

* ``stage`` — the window staging and the output stores, no y or x pass:
  ``out[f, i, j] = cast(frames[f, ys[i], xs[j]])``, the first tap's pixel
  (clamped to the image, as every tap is);
* ``stagey`` — staging and the y pass: ``out[f, i, j] = cast(T[i, xs[j]])``
  with ``T`` the y pass's f32 sums, the first x tap's y sum.  Both, and
  ``u8words`` and ``xpair`` below (``RING_MODES``), run on
  the stage ring (``band_stage_kernel``): a persistent grid
  (``stage_grid``; its blocks deal the tiles round-robin, ``stage_shares``) whose
  blocks take their windows from a ring of ``STAGE_SLOTS`` that a
  producer warp fills with bulk copies, ``stagey``'s y pass
  register-blocked over a group of adjacent columns, walking the tile's
  dst rows (the f32 instance shifts the tap pixels from row to row);
* ``walk2``, ``walk3``, ``walk4`` — production's output from a persistent
  grid (``walk_grid``) whose blocks each walk a contiguous share of the
  (frame, strip, row tile) tiles (``walk_shares``) through a ring of n
  windows that a producer warp fills with bulk copies;
* ``u8words`` (u8) — production's output, the y pass reading 4 pixels per
  32-bit shared word, byte k of a word the pixel of column x0 + k
  (little-endian, ``word_pixels``), on the stage ring: T's columns
  shifted so that each group's word is aligned where the row pitch is a
  multiple of 4 (else a funnel shift of two), then production's x pass;
* ``u8convert1``, ``u8convert2``, ``u8convert4`` (u8) — production's
  output, the staged window converted to bf16 (exact for u8) in shared
  memory in n column chunks, 16 pixels a thread, chunk c + 1 converted
  while chunk c is y-passed;
* ``xpair`` (u8) — production's output from an x pass for an exact ratio-2
  band: dst column j reads source columns 2j - 1 .. 2j + 2 with weights
  from a (4, Wd) table (``xpair_table``; ``ValueError`` on other bands),
  on the stage ring with no T: a lane sums the y taps of its 4 dst
  columns' 10 source columns in registers (two words a tap row, the
  edge columns as the neighbouring words' bytes) and stores the 4 pixels
  as one word;
* ``stage_direct``, ``stagey_direct``, ``u8words_direct``,
  ``xpair_direct``, ``xonly_direct`` — the five stage-ring functions on
  their first form,
  production's kernel with one block a tile (kept beside the ring so that
  kernel 1's split is read on production's own layout, and the ring's
  gain in the same call);
* ``xonly`` — production's x pass alone: its input is not frames but the
  y pass's output, (F, Hd, W) in the frame dtype, and ``out[f, i, j] =
  cast(sum_b xw[j, b] * tmp[f, i, clamp(xs[j] + b)])``, on the stage ring
  with no T: its windows are the tile's TY rows of that input
  (``window_rows``), a lane reads its 4 dst columns' taps from the
  window into registers, sums each column's taps in order and stores its
  4 values at once, the x weights and offsets staged once a block (x
  bands of at most ``RING_X_TAPS`` taps; ``ValueError`` on wider ones);
* ``densex`` — production's y pass, then a dense x operator: ``out[f, i,
  j] = cast(sum over all W columns x of T[i, x] * Wxd[x, j])`` with
  ``Wxd`` the band as a (W, Wd) matrix in the frame dtype
  (``dense_x_table``).  Its plain version is the f32 statement, every
  column fused-multiply-added in order from 0, which in f32 is
  production's output bit for bit (the extra products are exact zeros).
  The kernel (``csrc/dense_x.cu``, ``densex_plan``) takes the sum as a
  wgmma product on a bf16 split of T, two products for bf16 frames and
  all four of the split of T and the operator for f32 (bf16x3 and lo·lo;
  ``dense_x_split_plain`` states them in float64), with the
  operator packed once on the host into the shared-memory image of a
  chunk (``pack_dense_x``): its sums come in the tensor cores' order, so
  it is held to ``DENSEX_RTOL`` (f32) or one bf16 ulp (bf16) of the plain
  version, not bit for bit.

``band_probe_kernel(frames, tables, mode)`` launches one (a CPU tensor
takes ``band_probe_plain``), counted per mode in ``LAUNCHES``.  The plain
versions repeat the kernel's arithmetic exactly: each tap is one fused
multiply-add rounded once to f32 (``ops.apply.fma32``), the y taps
summed in order from 0, then the x taps; so every mode but ``densex``
equals its plain version bit for bit.  A mode whose shared memory
exceeds the card's opt-in (``smem_bytes``) raises ``ValueError`` before
any launch; ``densex``'s holds two chunks of K and fits at any width.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from .. import _build
from ..api import build_operator
from ..autodiff import separable_linear_for
from ..grids import make_grid_spec
from ..ops import cuda_apply
from ..ops.apply import fma32
from ..utils.device import SMEM_LIMIT, out_buffer
from ..utils.digest import array_digest
from ..utils.lru import LruDict

# probe mode -> the kernel's mode code (band_apply.cuh's Probe; densex
# runs on csrc/dense_x.cu)
MODES = {"stage": 12, "stagey": 13, "u8words": 14, "xpair": 15,
         "xonly": 16, "stage_direct": 1, "stagey_direct": 2,
         "u8words_direct": 3, "xpair_direct": 4, "xonly_direct": 11,
         "u8convert1": 5, "u8convert2": 6, "u8convert4": 7, "walk2": 8,
         "walk3": 9, "walk4": 10, "densex": None}
# the modes each input dtype has (the kernel's instances); each also has
# the first forms of its stage-ring modes (``first_forms``)
FLOAT_MODES = ("stage", "stagey", "walk2", "walk3", "walk4")
# the stage ring's modes and the first form of each (its mode + "_direct":
# production's kernel with one block a tile, launched by no experiment)
RING_MODES = ("stage", "stagey", "u8words", "xpair", "xonly")
DIRECT_MODES = tuple(f"{m}_direct" for m in RING_MODES)
# the stage ring's windows (band_apply.cuh kStageSlots); a ring that does
# not fit the card's opt-in raises
STAGE_SLOTS = 2
# the stage ring's dst rows a tile at most (band_apply.cuh kStageRows)
STAGE_ROWS = 8
# rgb1024's x-pass probes, float frames too: xonly reads the y pass's
# output, not frames, and densex's cost is its dense x operator
X_MODES = ("xonly", "densex")
# the x taps a column the ring's xonly takes at most (band_apply.cuh
# kShiftTaps)
RING_X_TAPS = 4
U8_MODES = ("stage", "stagey", "u8words", "u8convert1", "u8convert2",
            "u8convert4", "xpair")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2}
# kernel launches so far per mode, counted where the wrapper launches
LAUNCHES = {m: 0 for m in MODES}

H, W = 2160, 3840   # the flagship: 4K -> 1080p, exact

# densex's kernel (csrc/dense_x.cu): dst rows a block (one wgmma M tile),
# source columns a chunk of K, dst columns a warpgroup (one m64n208k16)
DENSE_ROWS, DENSE_K, DENSE_N = 64, 32, 208
# warpgroups a block by frame element size (its columns: 208 each): bf16
# takes rgb1024's 410 dst columns in two blocks of one (336 blocks, up to
# three an SM), f32, whose operator and windows weigh twice as much, in
# one block of two (the y pass once a tile), each the faster at rgb1024
DENSE_WARPGROUPS = {2: 1, 4: 2}
# densex f32 (its four split products): |kernel - plain| <= 1e-5
# max|plain|, high_dot's tolerance for bf16x3
DENSEX_RTOL = 1e-5


@functools.lru_cache(maxsize=8)
def flagship_tables(shape=(H, W), src_res: float = 2.0,
                    dst_res: float = 1.0):
    """Kernel 1's host tables (ys, yw, xs, xw) of ``shape`` at ``src_res``
    -> ``dst_res`` (the 4K -> 1080p flagship, 2.0 -> 1.0, by default),
    exact, no rotation."""
    op = build_operator(make_grid_spec(tuple(shape), float(src_res),
                                       float(dst_res), (0.0, 0.0), 0.0))
    return tuple(np.ascontiguousarray(t) for t in
                 separable_linear_for(op, torch.float32, "kernel").tables)


def _host(tables):
    ys, yw, xs, xw = tables
    return (np.asarray(ys, np.int32), np.asarray(yw, np.float32),
            np.asarray(xs, np.int32), np.asarray(xw, np.float32))


def first_forms(modes) -> tuple:
    """The first forms (mode + "_direct") of the stage-ring modes among
    ``modes``."""
    return tuple(f"{m}_direct" for m in modes if m in RING_MODES)


def modes_of(dtype: torch.dtype) -> tuple:
    """Kernel 1's probe modes at the flagship for frames of ``dtype``: the
    dtype's modes and the first forms of its stage-ring modes (rgb1024's
    ``X_MODES`` apart)."""
    have = U8_MODES if dtype == torch.uint8 else FLOAT_MODES
    return have + first_forms(have)


def _check_mode(mode: str, dtype: torch.dtype) -> None:
    if mode not in MODES:
        raise ValueError(f"probe mode must be one of {sorted(MODES)}, got "
                         f"{mode!r}")
    floats = modes_of(torch.float32) + X_MODES + first_forms(X_MODES)
    have = modes_of(dtype) if dtype == torch.uint8 else floats
    if dtype not in _DTYPE_CODES or mode not in have:
        raise ValueError(f"probe mode {mode!r} has no {dtype} instance "
                         f"(float32 / bfloat16: {floats}; uint8: "
                         f"{modes_of(torch.uint8)})")


def _plan(tables):
    plan = cuda_apply._plan_for(*_host(tables))
    if plan["kernel_2d"]:
        raise ValueError("these bands take kernel 2: kernel 1 has no plan "
                         "for them, nor its probes")
    return plan


def window_rows(plan: dict, mode: str) -> int:
    """The rows of a block's staged window, passed to the kernel as SY:
    the plan's SY; ``xonly`` TY, its tile's rows of the y pass's output
    (the ring's windows hold them alone), ``xonly_direct`` at least TY
    (production's layout, sized by SY)."""
    if mode == "xonly":
        return plan["TY"]
    return max(plan["SY"], plan["TY"]) if mode == "xonly_direct" \
        else plan["SY"]


def _seg_pitch(nbytes: int, stride: int) -> int:
    p = nbytes + 32
    return p + (stride - p) % 16


def _up16(n: int) -> int:
    return -(-n // 16) * 16


def smem_bytes(plan: dict, mode: str, Ws: int, Wd: int, ky: int,
               elem: int) -> int:
    """Dynamic shared memory of ``mode``'s block for frames Ws pixels wide
    (dst Wd) of ``elem``-byte pixels in and out on ``plan``: the production
    layout (band_apply.cuh's ``make_geo``; the direct modes'), the walk's
    (``walk_geo``: n windows, n tap tables and 2n mbarriers, no zero row),
    or the stage ring's (``stage_geo``: ``STAGE_SLOTS`` windows, each with
    its tap table (``stage``: a row offset a dst row; ``stagey``: the (TY,
    ky) offsets and weights and a shift a row)
    and two mbarriers, T for ``stagey`` only (``stage_t_pitch`` floats a
    row), two output tiles for ``stage`` and one for ``stagey``, no zero
    row; ``u8words``: T's rows 3 columns longer, ``ring_t_pitch``;
    ``xpair``: no T and no output tile, its (4, Wd) x table instead, rows
    of Wd rounded up to 4 floats; ``xonly``: no tap table, no T and no
    output tile, its windows of TY rows (``window_rows``) and its x table
    instead, kx rows of weights and one of offsets, each of Wd rounded up
    to 4),
    plus the bf16 chunk buffers for u8convert<n> (two, one for n = 1;
    ``convert_pitch`` bytes a window row).  ``xonly_direct`` stages its
    tile's TY rows of the y pass's output in production's window
    (``window_rows``).
    ``densex`` runs on ``csrc/dense_x.cu`` (``dense_x_smem``)."""
    TY, TX, SX = plan["TY"], plan["TX"], plan["SX"]
    SY = window_rows(plan, mode)
    pitch_in = _seg_pitch(SX * elem, Ws * elem)
    window = _up16(32 + SY * pitch_in)
    out_tile = _up16(32 + TY * _seg_pitch(TX * elem, Wd * elem))
    tab = _up16(8 * TY * ky)
    if mode.startswith("walk"):   # no zero row: the walk's taps are clamped
        n = int(mode[-1])
        return n * (window + tab + 16) + _up16(4 * TY * SX) + out_tile
    if mode == "xonly":
        kx = plan["tables"][3].shape[1]
        xtab = _up16(4 * (kx + 1) * (-(-Wd // 4) * 4))
        return STAGE_SLOTS * (window + 16) + xtab
    if mode in RING_MODES:
        n = STAGE_SLOTS
        y = mode != "stage"
        tab = _up16(8 * TY * ky + 4 * TY if y else 4 * TY)
        t = (_up16(4 * TY * ring_t_pitch(SX, mode))
             if mode in ("stagey", "u8words") else 0)
        tiles = {"stage": 2, "xpair": 0}.get(mode, 1)
        # xpair keeps its (4, Wd) x table whole, rows of Wd rounded up to 4
        xtab = _up16(16 * (-(-Wd // 4) * 4)) if mode == "xpair" else 0
        return n * (window + tab + 16) + t + tiles * out_tile + xtab
    total = (window + _up16(pitch_in + 32) + _up16(4 * TY * SX) + tab
             + out_tile)
    if mode.startswith("u8convert"):
        n = int(mode[-1])
        total += min(n, 2) * _up16(SY * convert_pitch(SX, n))
    return total


def stage_t_pitch(SX: int) -> int:
    """Floats a row of the stage ring's T (band_apply.cuh's
    ``stage_t_pitch``): SX rounded up to 4, so that every y-pass group's
    columns start on a 16-byte boundary."""
    return (SX + 3) // 4 * 4


def ring_t_pitch(SX: int, mode: str) -> int:
    """Floats a row of T for the ring's ``mode`` (band_apply.cuh's
    ``ring_t_pitch``): ``u8words`` holds SX + 3 columns, its T shifted by
    0-3 columns to the window's word alignment."""
    return stage_t_pitch(SX + 3 if mode == "u8words" else SX)


def convert_pitch(SX: int, n: int) -> int:
    """Bytes a window row of a u8convert<n> chunk buffer (band_apply.cuh's
    ``convert_pitch``): 32 bytes of bf16 for each aligned 16-byte window
    chunk a column chunk may take, its share of ceil(SX / 16) and one
    more where a row starts inside a chunk."""
    chunks = -(-SX // 16)
    return 32 * (-(-chunks // n) + 1)


def walk_shares(items: int, blocks: int) -> list:
    """The walk's split of ``items`` tiles (row tiles fastest, then
    strips, then frames) over its persistent grid of G = min(items,
    ``blocks``) blocks, ``blocks`` being SMs x blocks an SM
    (csrc/band_probes.cu and band_apply.cuh's ``band_walk_kernel``): block
    b takes tiles [b * items // G, (b + 1) * items // G)."""
    grid = min(items, blocks)
    return [(b * items // grid, (b + 1) * items // grid)
            for b in range(grid)]


def stage_shares(items: int, blocks: int) -> list:
    """The stage ring's split of ``items`` tiles over its persistent grid
    of G = min(items, ``blocks``) blocks (band_apply.cuh's
    ``band_stage_kernel``): block b takes tiles b, b + G, b + 2G, ... in
    production's order (strips fastest, then row tiles, then frames), so
    the blocks at work at any moment hold neighbouring windows."""
    grid = min(items, blocks)
    return [list(range(b, items, grid)) for b in range(grid)]


def walk_grid(frames: torch.Tensor, tables, mode: str) -> dict:
    """The walk mode ``mode``'s launch on ``frames`` (CUDA, float32 or
    bfloat16; the card is asked): the SMs, blocks an SM (the occupancy of
    its shared memory and registers), registers a thread, shared memory a
    block, tiles and the persistent grid, min(tiles, SMs x blocks an SM).
    ``RuntimeError`` where the card refuses the ring."""
    if not mode.startswith("walk") or frames.device.type != "cuda":
        raise ValueError(f"walk_grid takes a walk mode on CUDA frames, got "
                         f"{mode!r} on {frames.device}")
    _check_mode(mode, frames.dtype)
    ys, yw, xs, xw = _host(tables)
    plan = _plan(tables)
    F, Hs, Ws = frames.shape
    out = (ctypes.c_int * 4)()
    fn = _build.load(_build.BAND_PROBES).aainterp_band_walk_grid
    with torch.cuda.device(frames.device):
        rc = fn(Hs, Ws, yw.shape[0], xw.shape[0], yw.shape[1], xw.shape[1],
                plan["TY"], plan["TX"], plan["SY"], plan["SX"], MODES[mode],
                _DTYPE_CODES[frames.dtype], ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"band probe {mode}: no launch geometry, CUDA "
                           f"error {rc}")
    sms, per_sm, regs, smem = out
    tiles = (F * -(-xw.shape[0] // plan["TX"])
             * -(-yw.shape[0] // plan["TY"]))
    return {"sms": sms, "blocks_per_sm": per_sm, "registers": regs,
            "smem": smem, "tiles": tiles,
            "grid": len(walk_shares(tiles, sms * per_sm))}


def stage_grid(frames: torch.Tensor, tables, mode: str) -> dict:
    """The stage ring's launch for ``mode`` (one of ``RING_MODES``) on
    ``frames`` (CUDA; the card is asked): the SMs, blocks an SM, registers
    a thread, shared memory a block, the ring depth, tiles and the
    persistent grid,
    min(tiles, SMs x blocks an SM), split by ``stage_shares``.
    ``RuntimeError`` where the card refuses the ring."""
    if mode not in RING_MODES or frames.device.type != "cuda":
        raise ValueError(f"stage_grid takes a stage ring mode {RING_MODES} "
                         f"on CUDA frames, got {mode!r} on {frames.device}")
    _check_frames(frames, tables, mode)
    _check_mode(mode, frames.dtype)
    ys, yw, xs, xw = _host(tables)
    plan = _plan(tables)
    F, Hs, Ws = frames.shape
    out = (ctypes.c_int * 4)()
    fn = _build.load(_build.BAND_PROBES).aainterp_band_stage_grid
    with torch.cuda.device(frames.device):
        rc = fn(Hs, Ws, yw.shape[0], xw.shape[0], yw.shape[1], xw.shape[1],
                plan["TY"], plan["TX"], window_rows(plan, mode), plan["SX"],
                MODES[mode], _DTYPE_CODES[frames.dtype],
                ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"band probe {mode}: no launch geometry for a ring "
                           f"of {STAGE_SLOTS} windows, CUDA error {rc}")
    sms, per_sm, regs, smem = out
    tiles = (F * -(-xw.shape[0] // plan["TX"])
             * -(-yw.shape[0] // plan["TY"]))
    return {"sms": sms, "blocks_per_sm": per_sm, "registers": regs,
            "smem": smem, "slots": STAGE_SLOTS, "tiles": tiles,
            "grid": len(stage_shares(tiles, sms * per_sm))}


def xpair_table(xs: np.ndarray, xw: np.ndarray) -> np.ndarray:
    """(4, Wd) f32: row b holds dst column j's weight of source column
    2j - 1 + b, as ``u8_experiments._stage_tables('xpair')`` tables it
    (rows o_prev, e, o, e_next); ``ValueError`` where a nonzero tap lies
    elsewhere (the band is no exact ratio-2 partition)."""
    xs = np.asarray(xs, np.int64)
    xw = np.asarray(xw, np.float32)
    Wd, kx = xw.shape
    tab = np.zeros((4, Wd), np.float32)
    j = np.arange(Wd)[:, None]
    b = xs[:, None] + np.arange(kx)[None, :] - (2 * j - 1)
    live = xw != 0
    if ((b < 0) | (b > 3))[live].any():
        raise ValueError("xpair needs an exact ratio-2 band: every nonzero "
                         "tap of dst column j on source columns 2j - 1 .. "
                         "2j + 2")
    jj, kk = np.nonzero(live)
    np.add.at(tab, (b[jj, kk], jj), xw[jj, kk])
    return tab


def dense_x_table(xs: np.ndarray, xw: np.ndarray, Ws: int) -> np.ndarray:
    """(Ws, Wd) f32: the x band as a dense matrix, as
    ``rgb1024_experiments.exp_fulldense`` builds it (column j holds xw[j,
    b] at row xs[j] + b; a tap outside [0, Ws) is dropped, as JAX's slice
    assignment cuts at W)."""
    xs = np.asarray(xs, np.int64)
    xw = np.asarray(xw, np.float32)
    Wd, kx = xw.shape
    tab = np.zeros((Ws, Wd), np.float32)
    rows = xs[:, None] + np.arange(kx)[None, :]
    ok = (rows >= 0) & (rows < Ws)
    jj, bb = np.nonzero(ok)
    tab[rows[jj, bb], jj] = xw[jj, bb]
    return tab


def dense_x_smem(elem: int, SY: int = 0) -> int:
    """Dynamic shared memory of a ``csrc/dense_x.cu`` block for
    ``elem``-byte frames: 128 bytes of alignment slack and 128 for the
    mbarriers; two stages, each the chunk's operator (two bf16 parts for
    f32 frames, one for bf16; 208 columns a warpgroup) and T's hi and lo
    (64 rows), 32 source columns each; and, where the y pass reads a
    window of ``SY`` source rows (``dense_x_window``), two windows of SY
    rows x 32 columns, each in whole 128-byte lines."""
    parts = 2 if elem == 4 else 1
    stage = (parts * DENSE_WARPGROUPS[elem] * DENSE_N
             + 2 * DENSE_ROWS) * DENSE_K
    window = -(-SY * DENSE_K * elem // 128) * 128
    return 128 + 128 + 2 * 2 * stage + 2 * window


def dense_x_window(SY: int, W: int, elem: int) -> bool:
    """Whether ``csrc/dense_x.cu``'s y pass reads its tile's window from a
    TMA box (rows a whole number of 16-byte chunks, SY at most 256 rows,
    the block within the card's opt-in; frames 16-byte aligned, as a
    contiguous tensor's storage is) or global memory."""
    return (W * elem % 16 == 0 and SY <= 256
            and dense_x_smem(elem, SY) <= SMEM_LIMIT)


# (tables' digests, Ws) -> densex's plan
_DENSEX_PLANS = LruDict(8, name="band_probes.densex")


def densex_plan(tables, Ws: int) -> dict:
    """densex's plan for frames Ws wide: kernel 1's y tables and each
    64-row tile's first tap row (``tables``: ys, yw, row_base, uploaded by
    ``cuda_apply._device_tables``), the rows every tile's taps span
    (``SY``), the grid of ``csrc/dense_x.cu`` (blocks of 64 dst rows, K in
    chunks of 32 source columns), and, by (dtype, device), the dense (Ws,
    Wd) operator (``wxd``) and its packed image (``packed``), each built
    and uploaded once."""
    host = _host(tables)
    key = (tuple(array_digest(t) for t in host), int(Ws))
    dp = _DENSEX_PLANS.get(key)
    if dp is not None:
        return dp
    ys, yw, xs, xw = host
    row_base, SY = cuda_apply._tiles(ys.astype(np.int64), yw.shape[1],
                                     DENSE_ROWS)
    dp = dict(tables=(ys, yw, row_base.astype(np.int32)), SY=SY, dev={},
              wxd={}, packed={}, Ws=int(Ws), n_rt=len(row_base),
              nc=-(-int(Ws) // DENSE_K))
    _DENSEX_PLANS.put(key, dp)
    return dp


def _densex_device(tables, Ws: int, dtype: torch.dtype, device):
    """densex's (Ws, Wd) operator in ``dtype`` on ``device`` (the frame
    dtype, as JAX stores it), built and uploaded once (kept on densex's
    plan)."""
    wxd = densex_plan(tables, Ws)["wxd"]
    key = (dtype, torch.device(device))
    if key not in wxd:
        ys, yw, xs, xw = _host(tables)
        wxd[key] = torch.from_numpy(dense_x_table(xs, xw, Ws)).to(
            device=device, dtype=dtype)
    return wxd[key]


def pack_dense_x(wxd: torch.Tensor) -> torch.Tensor:
    """The dense (Ws, Wd) operator (float32 or bfloat16) as
    ``csrc/dense_x.cu`` reads it: bf16 (n_cb, nc, parts, 208 NW x 32) with
    NW the dtype's warpgroups (``DENSE_WARPGROUPS``), for each block of 208
    NW dst columns and each chunk of 32 source columns one stage's exact
    shared-memory image, zero-padded
    past Ws and Wd.  Part 0 is hi = bf16(Wxd), part 1 (float32 only) lo =
    bf16(Wxd - hi); column n, source column k of a part at the K-major core
    matrix offset ((n // 8) * 4 + k // 8) * 64 + (n % 8) * 8 + k % 8."""
    if wxd.ndim != 2 or wxd.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"pack_dense_x takes a 2-D float32 or bfloat16 "
                         f"operator, got {wxd.dtype} {tuple(wxd.shape)}")
    Ws, Wd = wxd.shape
    nb = DENSE_WARPGROUPS[wxd.element_size()] * DENSE_N
    nc, n_cb = -(-Ws // DENSE_K), -(-Wd // nb)
    w = torch.zeros(nc * DENSE_K, n_cb * nb, dtype=torch.float32)
    w[:Ws, :Wd] = wxd.detach().cpu().float()
    hi = w.to(torch.bfloat16)
    parts = [hi] if wxd.dtype == torch.bfloat16 else [
        hi, (w - hi.float()).to(torch.bfloat16)]
    p = torch.stack(parts)
    # (part, chunk, k // 8, k % 8, block, n // 8, n % 8) -> (block, chunk,
    # part, n // 8, k // 8, n % 8, k % 8)
    p = p.view(len(parts), nc, DENSE_K // 8, 8, n_cb, nb // 8, 8)
    return p.permute(4, 1, 0, 5, 2, 6, 3).contiguous().view(
        n_cb, nc, len(parts), nb * DENSE_K)


def _densex_packed(tables, Ws: int, dtype: torch.dtype, device):
    """densex's packed operator (``pack_dense_x``) on ``device``, built and
    uploaded once (kept on densex's plan)."""
    packed = densex_plan(tables, Ws)["packed"]
    key = (dtype, torch.device(device))
    if key not in packed:
        packed[key] = pack_dense_x(_densex_device(
            tables, Ws, dtype, "cpu")).to(device)
    return packed[key]


def _xpair_device(plan: dict, tables, device) -> torch.Tensor:
    """The plan's (4, Wd) xpair table on ``device``, built and uploaded
    once (kept on the plan)."""
    key = ("xpair", torch.device(device))
    if key not in plan:
        ys, yw, xs, xw = _host(tables)
        plan[key] = torch.from_numpy(xpair_table(xs, xw)).to(device)
    return plan[key]


# ---------------------------------------------------------------------------
# plain versions: the kernel's arithmetic, exactly
# ---------------------------------------------------------------------------


def _cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The kernel's store: bf16 round to nearest even; u8 round half to
    even, then saturate."""
    if dtype == torch.uint8:
        return x.round().clamp(0.0, 255.0).to(torch.uint8)
    return x.to(dtype)


def _tabs(tables, device):
    """(ys, yw, xs, xw) on ``device``: the plan's copies, uploaded once (so
    a plain version can run inside CUDA-graph capture), starts as int64."""
    ys, yw, xs, xw, _, _ = cuda_apply._device_tables(_plan(tables), device)
    return ys.long(), yw, xs.long(), xw


def y_sums(frames: torch.Tensor, tables) -> torch.Tensor:
    """The y pass, (F, H, W) -> (F, Hd, W) f32: T[f, i, x] = the taps
    wy[i, a] * frames[f, clamp(ys[i] + a), x] fused-multiply-added in
    order from 0."""
    ys, yw, _, _ = _tabs(tables, frames.device)
    F, Hs, Ws = frames.shape
    acc = torch.zeros((F, ys.shape[0], Ws), dtype=torch.float32,
                      device=frames.device)
    for a in range(yw.shape[1]):
        v = frames.index_select(1, (ys + a).clamp(0, Hs - 1)).float()
        acc = fma32(yw[:, a, None], v, acc)
    return acc


def x_sums(t: torch.Tensor, xs: torch.Tensor,
           xw: torch.Tensor) -> torch.Tensor:
    """The x pass, (F, Hd, W) f32 -> (F, Hd, Wd): the taps xw[j, b] *
    t[f, i, clamp(xs[j] + b)] fused-multiply-added in order from 0."""
    Ws = t.shape[2]
    acc = torch.zeros(t.shape[:2] + (xs.shape[0],), dtype=torch.float32,
                      device=t.device)
    for b in range(xw.shape[1]):
        v = t.index_select(2, (xs + b).clamp(0, Ws - 1))
        acc = fma32(xw[:, b], v, acc)
    return acc


def dense_x_sums(t: torch.Tensor, wxd: torch.Tensor) -> torch.Tensor:
    """densex's x pass, (F, Hd, W) f32 -> (F, Hd, Wd): t[f, i, x] *
    wxd[x, j] fused-multiply-added over every column x in order from 0."""
    acc = torch.zeros(t.shape[:2] + (wxd.shape[1],), dtype=torch.float32,
                      device=t.device)
    for x in range(t.shape[2]):
        acc = fma32(t[:, :, x, None], wxd[x], acc)
    return acc


def dense_x_split_plain(t: torch.Tensor, wxd: torch.Tensor,
                        passes: int) -> torch.Tensor:
    """densex's x pass as ``csrc/dense_x.cu`` takes it on the tensor
    cores, (F, Hd, W) f32 -> (F, Hd, Wd) f32, stated in float64: T split
    into hi = bf16(T) and lo = bf16(T - hi), the operator ``wxd`` (in the
    frame dtype) likewise, each product exact, the sum rounded once to f32.
    ``passes`` 4: all four products, bf16x3 + lo·Wlo (f32 frames); 3:
    bf16x3, hi·Whi + hi·Wlo + lo·Whi (high_dot's); 2: hi·W + lo·W (bf16
    frames, whose operator is exact in bf16); 1: one bf16 pass, hi·Whi (the
    TPU's DEFAULT precision, which densex's f32 check refuses)."""
    if passes not in (1, 2, 3, 4):
        raise ValueError(f"passes must be 1, 2, 3 or 4, got {passes}")
    th = t.to(torch.bfloat16)
    tl = (t - th.float()).to(torch.bfloat16)
    w = wxd.float()
    wh = w.to(torch.bfloat16)
    wl = (w - wh.float()).to(torch.bfloat16)
    th, tl, wh, wl = (v.double() for v in (th, tl, wh, wl))
    if passes == 1:
        out = th @ wh
    elif passes == 2:
        out = (th + tl) @ wh
    else:
        out = th @ wh + th @ wl + tl @ wh
        if passes == 4:
            out = out + tl @ wl
    return out.float()


def band_probe_plain(frames: torch.Tensor, tables, mode: str) -> torch.Tensor:
    """The probe ``mode``'s function in plain torch, on ``frames``' device,
    bit for bit the kernel's (output dtype = input dtype); ``xonly`` takes
    the y pass's output, (F, Hd, W), as its frames; ``stage_direct`` and
    ``stagey_direct`` are ``stage``'s and ``stagey``'s."""
    _check_frames(frames, tables, mode)
    _check_mode(mode, frames.dtype)
    mode = mode.removesuffix("_direct")      # a first form's function
    ys, yw, xs, xw = _tabs(tables, frames.device)
    Hs, Ws = frames.shape[1:]
    if mode == "xonly":
        out = x_sums(frames.float(), xs, xw)
    elif mode == "densex":
        wxd = _densex_device(tables, Ws, frames.dtype, frames.device)
        out = dense_x_sums(y_sums(frames, tables), wxd.float())
    elif mode == "stage":
        out = frames.index_select(1, ys.clamp(0, Hs - 1)).index_select(
            2, xs.clamp(0, Ws - 1)).float()
    elif mode == "stagey":
        out = y_sums(frames, tables).index_select(2, xs.clamp(0, Ws - 1))
    elif mode == "xpair":
        tab = _xpair_device(_plan(tables), tables, frames.device)
        first = 2 * torch.arange(xs.shape[0], device=frames.device) - 1
        out = x_sums(y_sums(frames, tables), first, tab.T.contiguous())
    else:                       # walk, u8words, u8convert: production's
        out = x_sums(y_sums(frames, tables), xs, xw)
    return _cast(out, frames.dtype)


# ---------------------------------------------------------------------------
# the kernel wrapper
# ---------------------------------------------------------------------------


def _check_frames(frames, tables=None, mode: str = "") -> None:
    if not isinstance(frames, torch.Tensor):
        raise TypeError(f"frames must be a torch.Tensor, got {type(frames)}")
    if frames.ndim != 3 or 0 in frames.shape:
        raise ValueError(f"frames must be (F, H, W) with none of them 0, got "
                         f"{tuple(frames.shape)}")
    if mode.removesuffix("_direct") == "xonly" and \
            frames.shape[1] != len(tables[0]):
        raise ValueError(f"xonly takes the y pass's output, (F, Hd="
                         f"{len(tables[0])}, W), got {tuple(frames.shape)}")


def band_probe_kernel(frames: torch.Tensor, tables, mode: str, *,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The probe ``mode`` on ``csrc/band_probes.cu``: (F, H, W) -> (F, Hd,
    Wd) in the frames' dtype (``xonly`` and ``xonly_direct``: (F, Hd, W)
    -> (F, Hd, Wd));
    ``tables`` are kernel 1's host tables (ys, yw, xs, xw).  A CPU tensor
    takes ``band_probe_plain``; ``out`` may be given (any contents: every
    element is written)."""
    _check_frames(frames, tables, mode)
    _check_mode(mode, frames.dtype)
    ys, yw, xs, xw = _host(tables)
    F, Hs, Ws = frames.shape
    shape = (F, yw.shape[0], xw.shape[0])
    if frames.device.type == "cpu":
        y = band_probe_plain(frames, tables, mode)
        return y if out is None else out_buffer(
            out, shape, frames.dtype, frames.device).copy_(y)
    if frames.device.type != "cuda":
        raise ValueError(f"no kernel for device {frames.device}")
    if not frames.is_contiguous():
        raise ValueError("frames must be contiguous")
    if mode == "densex":
        return _dense_x_kernel(frames, tables, shape, out)
    plan = _plan(tables)
    need = smem_bytes(plan, mode, Ws, shape[2], yw.shape[1],
                      frames.element_size())
    if need > SMEM_LIMIT:
        raise ValueError(f"probe mode {mode!r} needs {need} bytes of shared "
                         f"memory a block, over the card's {SMEM_LIMIT}")
    if mode in ("xpair", "xpair_direct"):
        xpair_table(xs, xw)                          # raises on other bands
    if mode == "xonly" and xw.shape[1] > RING_X_TAPS:
        raise ValueError(f"probe mode 'xonly' takes x bands of at most "
                         f"{RING_X_TAPS} taps, these have {xw.shape[1]}")
    if mode in RING_MODES:
        return _stage_kernel(frames, tables, mode, plan, shape, need, out)
    out = out_buffer(out, shape, frames.dtype, frames.device)
    d_ys, d_yw, d_xs, d_xw, d_rb, d_cb = cuda_apply._device_tables(
        plan, frames.device)
    wx_ptr = _wx_ptr(mode, plan, tables, d_xw, frames.device)
    fn = _build.load(_build.BAND_PROBES).aainterp_band_probe
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream(frames.device).cuda_stream
        rc = fn(frames.data_ptr(), out.data_ptr(), d_ys.data_ptr(),
                d_yw.data_ptr(), d_xs.data_ptr(), wx_ptr, d_rb.data_ptr(),
                d_cb.data_ptr(), F, Hs, Ws, shape[1], shape[2], yw.shape[1],
                xw.shape[1], plan["TY"], plan["TX"], window_rows(plan, mode),
                plan["SX"], MODES[mode], _DTYPE_CODES[frames.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"band probe {mode} launch failed: CUDA error {rc}"
                           f" (F={F}, H={Hs}, W={Ws}, plan TY={plan['TY']} "
                           f"TX={plan['TX']} SY={plan['SY']} "
                           f"SX={plan['SX']}, {need} bytes of shared memory)")
    LAUNCHES[mode] += 1
    return out


def _wx_ptr(mode: str, plan: dict, tables, d_xw: torch.Tensor,
            device) -> int:
    """The x weights a mode's kernel reads: the (4, Wd) table for xpair
    (and its first form), production's otherwise."""
    if mode.removesuffix("_direct") == "xpair":
        return _xpair_device(plan, tables, device).data_ptr()
    return d_xw.data_ptr()


def _stage_kernel(frames: torch.Tensor, tables, mode: str, plan: dict, shape,
                  need: int, out: Optional[torch.Tensor]) -> torch.Tensor:
    """A stage-ring mode (``RING_MODES``) on the stage ring
    (``aainterp_band_stage``; CUDA frames, the ring's shared memory and
    xpair's band checked by the caller)."""
    F, Hs, Ws = frames.shape
    _, yw, _, xw = _host(tables)
    if plan["TY"] > STAGE_ROWS:
        raise ValueError(f"probe mode {mode!r} takes row tiles of at most "
                         f"{STAGE_ROWS} rows, the plan has {plan['TY']}")
    out = out_buffer(out, shape, frames.dtype, frames.device)
    d_ys, d_yw, d_xs, d_xw, d_rb, d_cb = cuda_apply._device_tables(
        plan, frames.device)
    wx_ptr = _wx_ptr(mode, plan, tables, d_xw, frames.device)
    fn = _build.load(_build.BAND_PROBES).aainterp_band_stage
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream(frames.device).cuda_stream
        rc = fn(frames.data_ptr(), out.data_ptr(), d_ys.data_ptr(),
                d_yw.data_ptr(), d_xs.data_ptr(), wx_ptr, d_rb.data_ptr(),
                d_cb.data_ptr(), F, Hs, Ws, shape[1], shape[2], yw.shape[1],
                xw.shape[1], plan["TY"], plan["TX"], window_rows(plan, mode),
                plan["SX"], MODES[mode], _DTYPE_CODES[frames.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"band probe {mode} launch failed: CUDA error {rc}"
                           f" (F={F}, H={Hs}, W={Ws}, plan TY={plan['TY']} "
                           f"TX={plan['TX']} SY={window_rows(plan, mode)} "
                           f"SX={plan['SX']}, a ring of {STAGE_SLOTS} windows, "
                           f"{need} "
                           "bytes of shared memory)")
    LAUNCHES[mode] += 1
    return out


def _dense_x_kernel(frames: torch.Tensor, tables, shape,
                    out: Optional[torch.Tensor]) -> torch.Tensor:
    """densex on ``csrc/dense_x.cu`` (CUDA frames, checked by the caller)."""
    F, Hs, Ws = frames.shape
    elem = frames.element_size()
    dp = densex_plan(tables, Ws)
    d_ys, d_yw, d_rb = cuda_apply._device_tables(dp, frames.device)
    ops = _densex_packed(tables, Ws, frames.dtype, frames.device)
    out = out_buffer(out, shape, frames.dtype, frames.device)
    # the bytes the two windows may take: what the card's opt-in leaves
    budget = SMEM_LIMIT - dense_x_smem(elem)
    fn = _build.load(_build.DENSE_X).aainterp_dense_x
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream(frames.device).cuda_stream
        rc = fn(frames.data_ptr(), out.data_ptr(), d_ys.data_ptr(),
                d_yw.data_ptr(), d_rb.data_ptr(), ops.data_ptr(), F, Hs, Ws,
                shape[1], shape[2], d_yw.shape[1], dp["SY"],
                DENSE_WARPGROUPS[elem], budget, _DTYPE_CODES[frames.dtype],
                stream)
    if rc != 0:
        window = dense_x_window(dp["SY"], Ws, elem)
        raise RuntimeError(
            f"band probe densex launch failed: CUDA error {rc} (F={F}, H={Hs},"
            f" W={Ws}, Hd={shape[1]}, Wd={shape[2]}, SY={dp['SY']}, "
            f"{DENSE_WARPGROUPS[elem]} warpgroup(s), y pass from "
            f"{'a TMA window' if window else 'global memory'}, "
            f"{dense_x_smem(elem, dp['SY'] if window else 0)} bytes of "
            "shared memory)")
    LAUNCHES["densex"] += 1
    return out


def tensor_core_ops(mode: str, tables, shape, elem: int) -> int:
    """The operations of ``traffic(mode, ...)`` that run on the tensor
    cores in bf16: ``densex``'s split products, 2 · F·Hd·W·Wd each, two
    for bf16 frames and four for f32; 0 for every other mode."""
    if mode != "densex":
        return 0
    _, yw, _, xw = _host(tables)
    F, _, Ws = shape
    return (4 if elem == 4 else 2) * 2 * F * yw.shape[0] * Ws * xw.shape[0]


def traffic(mode: str, tables, shape, elem: int) -> tuple:
    """(bytes, operations) of one batch of (F, H, W) inputs of
    ``elem``-byte pixels through ``mode`` ('full': the production kernel):
    the input read once (``xonly``'s: the y pass's output, (F, Hd, W);
    ``stage`` and ``stagey``: the rows and columns their functions read,
    ``read_sectors``), the output written once, the tables the mode reads
    (``stage`` no y weights); 2 operations per
    tap of each pass it keeps (``stage`` keeps none, ``stagey`` the y pass,
    ``xonly`` the x pass); ``densex`` reads the y tables, its tiles' row
    bases and its dense operator (W x Wd in the frame dtype) and does the y
    pass's f32 taps plus its split products on the tensor cores
    (``tensor_core_ops``)."""
    mode = mode.removesuffix("_direct")
    ys, yw, xs, xw = _host(tables)
    F, Hs, Ws = shape
    Hd, ky = yw.shape
    Wd, kx = xw.shape
    frames, outb = F * Hs * Ws * elem, F * Hd * Wd * elem
    plan = _plan(tables)
    bases = plan["row_base"].nbytes + plan["col_base"].nbytes
    y_tab = ys.nbytes + yw.nbytes
    y_ops = 2 * F * Hd * Ws * ky
    x_ops = 2 * F * Hd * Wd * kx
    if mode == "xonly":
        return (frames + outb + xs.nbytes + xw.nbytes
                + plan["col_base"].nbytes, x_ops)
    if mode == "densex":
        bases = densex_plan(tables, Ws)["tables"][2].nbytes
        return (frames + outb + y_tab + bases + Ws * Wd * elem,
                y_ops + tensor_core_ops(mode, tables, shape, elem))
    if mode in ("stage", "stagey"):
        # the first tap's pixel (stage), or the y sum of every tap (stagey),
        # at each dst column's first x tap, clamped
        taps = 1 if mode == "stage" else ky
        rows = np.clip(ys[:, None] + np.arange(taps), 0, Hs - 1)
        read = read_sectors(rows, np.clip(xs, 0, Ws - 1), F, Hs, Ws, elem)
        if mode == "stage":
            return read + outb + ys.nbytes + xs.nbytes + bases, 0
        return read + outb + y_tab + xs.nbytes + bases, y_ops
    if mode == "xpair":                  # the (4, Wd) table, 4 taps
        return (frames + outb + y_tab + 4 * Wd * 4 + bases,
                y_ops + 2 * F * Hd * Wd * 4)
    return (frames + outb + y_tab + xs.nbytes + xw.nbytes + bases,
            y_ops + x_ops)


def read_sectors(rows, cols, F: int, Hs: int, Ws: int, elem: int) -> int:
    """Bytes of the whole 32-byte sectors that reading pixels (r, c), r in
    ``rows`` and c in ``cols``, of each of F contiguous (Hs, Ws) frames of
    ``elem``-byte pixels touches (the batch 32-byte aligned, as the
    allocator gives it).  A row's sectors are those of its picked columns,
    which depend on its start mod 32 alone; rows in address order, a
    row's sectors all precede the next row's, so two rows share at most
    the one sector where the first ends and the next begins."""
    rows, cols = np.unique(rows), np.unique(cols).astype(np.int64)
    starts = ((np.arange(F, dtype=np.int64)[:, None] * Hs + rows)
              * (Ws * elem)).ravel()
    res, n = np.unique(starts % 32, return_counts=True)
    each = sum(int(k) * len(np.unique((r + cols * elem) // 32))
               for r, k in zip(res, n))
    first = (starts + cols[0] * elem) // 32
    last = (starts + cols[-1] * elem) // 32
    return 32 * (each - int(np.count_nonzero(last[:-1] == first[1:])))


def word_pixels(buf: np.ndarray, p: int) -> np.ndarray:
    """The 4 pixels that u8words' y pass reads at shared byte ``p`` of
    ``buf`` (uint8): the two aligned 32-bit words at ``p & ~3``, joined and
    shifted right by 8 * (p & 3) (``__funnelshift_r``), then byte k of the
    word, (v >> 8k) & 0xff, as the pixel of column x0 + k.  The card's
    words are little-endian, as the host's."""
    lo = p & ~3
    w = np.frombuffer(buf[lo:lo + 8].tobytes(), "<u4").astype(np.uint64)
    v = int(((w[1] << np.uint64(32)) | w[0]) >> np.uint64(8 * (p & 3)))
    return np.array([(v >> (8 * k)) & 0xFF for k in range(4)], np.uint8)


def run_exp(exp: str, mode: Optional[str], batch: int, dtype, device,
            shape=(H, W), res=(2.0, 1.0), **extra) -> dict:
    """Time ``mode`` (None: the production kernel,
    ``cuda_apply.apply_separable_kernel``) on K = 8 distinct seeded frame
    batches of (batch, *shape) at ``res`` (source -> destination
    resolution) in ``dtype`` on ``device`` (default: the card), warmed up
    on one more (``xonly`` and its first form: batches of the y pass's
    output, (batch, Hd, W)); the result carries the batch's bytes and operations
    (``traffic``)."""
    from ..utils.device import target
    from . import harness

    dev = target(device)
    tables = flagship_tables(tuple(shape), *res)
    gen = harness.seeded(dev, 0)
    in_shape = ((len(tables[0]), shape[1])
                if mode and mode.removesuffix("_direct") == "xonly"
                else tuple(shape))
    xs = [harness.uniform((batch,) + in_shape, dtype, gen, dev)
          for _ in range(9)]
    if mode is None:
        def fn(x):
            return cuda_apply.apply_separable_kernel(x, *tables)
    else:
        def fn(x):
            return band_probe_kernel(x, tables, mode)
    t = harness.measure(fn, xs[1:], xs[:1])
    nbytes, ops = traffic(mode or "full", tables, (batch,) + in_shape,
                          xs[0].element_size())
    px = batch * shape[0] * shape[1]
    return {"exp": exp, "mode": mode or "full", "ms_per_batch": t.ms,
            "gpixel_s": px / (t.ms * 1e-3) / 1e9,
            "us_per_frame": t.ms * 1e3 / batch, "batch": batch,
            "dtype": str(dtype).split(".")[-1], "shape": list(shape),
            "bytes": nbytes, "operations": ops, "clock": t.clock,
            "device": t.device, **extra}


def main(exps: dict, doc: str, dtypes, argv=None, shape=(H, W),
         res=(2.0, 1.0)) -> int:
    """The probe modules' command line: ``--exp`` (one of ``exps``),
    ``--batch``, ``--dtype`` (one of ``dtypes``), ``--device``,
    ``--shape`` (default ``shape``, at ``res``)."""
    import argparse
    import sys

    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--exp", required=True, choices=sorted(exps))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--dtype", default=dtypes[0], choices=dtypes)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--shape", type=int, nargs=2, default=tuple(shape),
                    metavar=("H", "W"),
                    help=f"frame shape ({res[0]} -> {res[1]})")
    args = ap.parse_args(argv)
    try:
        r = exps[args.exp](args.batch, getattr(torch, args.dtype),
                           args.device, tuple(args.shape))
    except (RuntimeError, ValueError) as e:
        print(e, file=sys.stderr)
        return 2
    print(f"{args.exp}: {r['gpixel_s']:.2f} Gpixel/s  "
          f"({r['us_per_frame']:.1f} us/frame)")
    if r.get("runs"):
        print(f"({args.exp}: {r['runs']})")
    if r["clock"] != "cuda_events":
        print(f"({r['device']}: the plain versions on the host's clock, not "
              "a device time)")
    return 0
