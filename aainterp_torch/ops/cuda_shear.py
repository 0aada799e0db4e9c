"""Exact rotated apply on the CUDA kernels ``csrc/ell_shear.cu``.

Counterpart of ``aainterp/ops/pallas_shear.py`` (``make_pallas_shear_apply``
and its kernels ``_build_vshear``, ``_build_hshear``, ``_build_contract``):
(F, qH, qW) -> (F, Hd, Wd) through two integer shears and a window
contraction, with the exact ELL weights re-indexed by
``ops.shear_apply.build_shear_plan``.

* ``ShearKernelPlan`` is the host plan in the layout the kernels take:
  ``gy`` (qW,), ``hx`` (TH,), ``ry0`` (Hd,), ``cx0`` (Wd,) int32, the
  weights tap-major, ``w2`` (Ka*Kb, Hd, Wd) f32, each dst row's live
  span ``span`` (Hd, 2) int32 (``live_spans``), and the shear kernel's
  tile table of each form it launches (``ShearTiles``: each output tile's
  source window, ``shear_tiles`` / ``plan_tiles``), planned at the form's
  first launch, so a plan that only plain routes use builds none.  None
  of the TPU's 8/16/128 alignments, one-hot selectors or residual-roll
  bases remain: a GPU thread reads any address.  Each plan uploads its
  tables to a device once and keeps them.
* ``kernel_plan(op)`` builds it from an EllOperator, cached in memory by
  table content (the counterpart of ``aainterp/api.py::_pallas_shear_plan``).
  Geometries that ``build_shear_plan`` rejects raise ValueError, and the
  rejection is cached too.  ``kernel_plan_cached(op)`` (the counterpart of
  ``build_kernel_plan_cached``, pallas_shear.py:715-748) keeps the plan's
  tables on disk as well, keyed by geometry and mode, so a new process
  loads what another built; the rotated kernel route uses it.
* The shear kernel has three forms: ``vshear_kernel`` (S from q),
  ``hshear_kernel`` (T from S) and ``vhshear_kernel`` (T from q, both
  shears at once); ``contract_kernel`` is the window contraction.  Each
  wrapper counts its launches in ``LAUNCHES``.  A CUDA tensor launches the
  kernel or raises — there is no fallback.  A CPU tensor takes the plain
  version (``vshear_plain``, ``hshear_plain``, ``vhshear_plain``,
  ``contract_plain``, torch indexing).
* The contraction skips dead pixels, as the TPU route's
  (``_build_contract(masked=True)``, pallas_shear.py:802) skips dead
  tiles: a dst pixel outside its row's span of live columns is 0 and
  reads neither T nor the weights.  Its kernel is tiled: one block per
  dst tile stages the tile's T window in shared memory.  The windows are
  a host table (``ContractTiles``: ``contract_tiles`` / ``plan_contract``,
  planned per element size at the first launch, the way ``plan_tiles``
  plans the shear's).  A plan whose smallest tile window does not fit in
  shared memory takes the direct form instead (every tap gathered from
  device memory), counted as ``LAUNCHES["contract_direct"]``;
  ``contract_tiled_plain`` is the tiled form's plain version.  For
  finite T the output is the unmasked sum's (a dead pixel sums zero
  weights); with NaN or Inf in T a pixel outside its row's span is 0
  where the unmasked sum can be NaN (JAX gives 0 on its dead 128 x 128
  tiles and NaN on dead pixels of live ones): the area average over no
  source area is 0.
  ``contract_unmasked_kernel`` launches the direct form without the
  skip (``contract_plain(masked=False)`` its plain version).
* ``apply_ell_shear_kernel`` is the route on the card: the fused shear,
  then the masked contraction (two launches; S never reaches device
  memory).  ``apply_ell_shear_plain`` composes the three plain stages
  unmasked (JAX's 'sheared' route has no mask either).
* ``build_sharded_kernel_plan(op, n)`` (the counterpart of
  pallas_shear.py:537) gives the row-sharded apply its plans: each rank's
  ``ShearKernelPlan`` over its halo-extended block is the global plan's
  rows shifted (``ShardedKernelPlan.rank``), so the same two kernels run
  per shard (``parallel.sharding.sharded_apply_ell_kernel``).
  ``build_sharded_kernel_plan_2d(op, n_r, n_c)`` (pallas_shear.py:872)
  does the same on a rows x cols mesh: both shears commute with 2-D
  sharding, so rank (i, j)'s plan is the global plan shifted along both
  axes, with its live spans recomputed on its block of the weights
  (``Sharded2DKernelPlan.rank``).

Dtype contract (pallas_shear.py:789-792): bf16 and f32 frames give that
dtype out; any other real dtype is cast to f32 first and gives f32.
Accumulation is f32 with f32 weights.  Every shear form writes every
element of its output (zeros where the source index leaves the plane), so
a zero-weight tap never meets an uninitialised value.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
import warnings
import zipfile
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import _build
from ..utils.digest import array_digest
from ..utils.lru import LruDict
from ..utils.device import SMEM_LIMIT, upload
from .apply import fma32
from .shear_apply import build_shear_plan
from .weights import EllOperator

# Kernel launches so far, counted where each wrapper launches its kernel.
LAUNCHES = {"vshear": 0, "hshear": 0, "vhshear": 0, "contract": 0,
            "contract_unmasked": 0, "contract_direct": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# the shear kernel's forms: which shift tables each reads (gy, hx)
FORMS = {"vshear": (True, False), "hshear": (False, True),
         "vhshear": (True, True)}
# output tile shapes (TY rows x TX columns), the first whose largest window
# fits SMEM_BUDGET at f32 is taken (bf16 stages in half); the last one's
# windows fit the card's opt-in for every geometry build_shear_plan takes
_TILES = ((64, 64), (32, 64), (32, 32), (16, 32), (8, 32), (4, 16), (1, 16))
SMEM_BUDGET = 48 * 1024

# the tiled contraction (contract.cuh): dst tile shapes (TYd rows x TXd
# columns, a warp a tile row), the first whose largest window fits
# CONTRACT_SMEM_BUDGET at the frames' element size is taken, else the last
# one if it fits SMEM_LIMIT, else the plan takes the direct form; windows
# start at multiples of COL_ALIGN columns and hold KFRAMES frames a cell
_CONTRACT_TILES = ((8, 32), (4, 32), (2, 32), (1, 32))
CONTRACT_SMEM_BUDGET = 75 * 1024          # three blocks an SM
COL_ALIGN = 8
KFRAMES = 8

# bounded: each plan holds its f32 weight table (196 MB at 2048^2/30 deg)
# on the host and once more per device
_PLAN_CACHE = LruDict(4, max_bytes=4 << 30)


@dataclasses.dataclass(frozen=True, eq=False)
class ShearTiles:
    """One shear form's tiles: TY x TX output cells each, row-major over
    the output plane, and each tile's source window."""

    TY: int
    TX: int
    win: np.ndarray   # (tiles, 4) int32 (r_lo, r_hi, c_lo, c_hi); all 0: empty
    rows: int         # the largest window's rows ...
    cols: int         # ... and columns


def _range_min_max(a: np.ndarray, lo: np.ndarray, hi: np.ndarray):
    """(min, max) of a[lo:hi] for each pair of index arrays with lo < hi
    (a sparse table; pairs with lo >= hi give any value)."""
    n = len(a)
    mins, maxs = [a.astype(np.int64)], [a.astype(np.int64)]
    while 2 << (len(mins) - 1) <= n:
        h = 1 << (len(mins) - 1)
        mins.append(np.minimum(mins[-1][:-h], mins[-1][h:]))
        maxs.append(np.maximum(maxs[-1][:-h], maxs[-1][h:]))
    span = np.maximum(hi - lo, 1)
    k = np.floor(np.log2(span)).astype(np.int64)
    lo = np.clip(lo, 0, n - 1)
    out = []
    for levels in (mins, maxs):
        table = np.stack([np.pad(t, (0, n - len(t)), mode="edge")
                          for t in levels])
        j = np.clip(lo + span - (1 << k), 0, n - 1)
        pick = np.minimum if levels is mins else np.maximum
        out.append(pick(table[k, lo], table[k, j]))
    return out[0], out[1]


def shear_tiles(gy: Optional[np.ndarray], hx: Optional[np.ndarray],
                src_shape, dst_shape, TY: int, TX: int) -> ShearTiles:
    """Tiles of ``out[y, x] = src[y - gy[c], c]``, ``c = x - hx[y]`` (0
    where the index leaves ``src``; gy None: 0, hx None: 0) and the source
    window of each: rows [r_lo, r_hi) and columns [c_lo, c_hi), clipped
    to the source.  Every source element a tile reads lies in its window;
    a tile that reads nothing is empty (all four 0) and is all zero fill.
    A row of a tile reads the columns [x0 - hx[y], x1 - hx[y]) inside the
    source and, of those, the rows between y - max gy and y - min gy
    inside it; the window bounds the rows that read anything."""
    sH, sW = src_shape
    dH, dW = dst_shape
    n_ty, n_tx = -(-dH // TY), -(-dW // TX)
    y = np.arange(n_ty * TY, dtype=np.int64)[:, None]
    x0 = np.arange(n_tx, dtype=np.int64)[None, :] * TX
    x1 = np.minimum(x0 + TX, dW)
    h = np.zeros((n_ty * TY, 1), np.int64)
    if hx is not None:
        h[:dH, 0] = hx[:dH]
    clo = np.maximum(x0 - h, 0)
    chi = np.minimum(x1 - h, sW)
    read = (clo < chi) & (y < dH)
    if gy is None:
        rlo, rhi = y, y + 1
    else:
        gmin, gmax = _range_min_max(gy, clo, chi)
        rlo, rhi = y - gmax, y - gmin + 1
    rlo, rhi = np.maximum(rlo, 0), np.minimum(rhi, sH)
    read &= rlo < rhi
    big = np.int64(1) << 40
    win = []
    for v, fill, pick in ((rlo, big, np.min), (rhi, -big, np.max),
                          (clo, big, np.min), (chi, -big, np.max)):
        v = np.broadcast_to(v, read.shape)
        win.append(pick(np.where(read, v, fill).reshape(n_ty, TY, n_tx),
                        axis=1))
    win = np.stack(win, -1).reshape(-1, 4)
    win[~read.reshape(n_ty, TY, n_tx).any(axis=1).reshape(-1)] = 0
    return ShearTiles(TY=TY, TX=TX,
                      win=np.ascontiguousarray(win, dtype=np.int32),
                      rows=int((win[:, 1] - win[:, 0]).max()),
                      cols=int((win[:, 3] - win[:, 2]).max()))


def shear_smem(form: str, TY: int, rows: int, cols: int, elem: int) -> int:
    """Dynamic shared memory, in bytes, of a block of ``form`` staging
    windows of up to rows x cols words of ``elem`` bytes (ell_shear.cu's
    ``shear_smem``): the shift tables, 16 bytes of lead, each row at its
    pitch (``seg_pitch``: 32-47 bytes beyond the row), 32 bytes of tail."""
    use_gy, use_hx = FORMS[form]
    tab = -(-4 * ((TY if use_hx else 0) + (cols if use_gy else 0)) // 16) * 16
    return tab + 48 + rows * (cols * elem + 47)


def _form_shapes(plan, form: str):
    """(source, output) plane shapes of a shear form."""
    return {"vshear": ((plan.qH, plan.qW), (plan.TH, plan.qW)),
            "hshear": ((plan.TH, plan.qW), (plan.TH, plan.TW)),
            "vhshear": ((plan.qH, plan.qW), (plan.TH, plan.TW))}[form]


def plan_tiles(plan, form: str) -> ShearTiles:
    """A shear form's tiles: the first shape of ``_TILES`` whose largest
    window fits ``SMEM_BUDGET`` at f32, else the last one.  Raises
    RuntimeError where even that one's window exceeds the card's opt-in
    (``SMEM_LIMIT``): a limit of the kernel, not a geometry to route
    elsewhere.  No geometry that ``build_shear_plan`` accepts comes near
    it (tests/test_torch_ell_tiles.py)."""
    use_gy, use_hx = FORMS[form]
    src, dst = _form_shapes(plan, form)
    for TY, TX in _TILES:
        t = shear_tiles(plan.gy if use_gy else None,
                        plan.hx if use_hx else None, src, dst, TY, TX)
        if shear_smem(form, TY, t.rows, t.cols, 4) <= SMEM_BUDGET:
            return t
    if shear_smem(form, TY, t.rows, t.cols, 4) > SMEM_LIMIT:
        raise RuntimeError(f"{form} window {t.rows}x{t.cols} of a {TY}x{TX} "
                           "tile exceeds the shared memory of a block")
    return t


@dataclasses.dataclass(frozen=True, eq=False)
class ContractTiles:
    """The tiled contraction's tiles: TYd x TXd dst pixels each,
    row-major over the dst plane, and each tile's T window."""

    TYd: int
    TXd: int
    win: np.ndarray   # (tiles, 4) int32 (r0, c0, rows, cols); all 0: dead
    cells: int        # the largest window's rows * cols

    def smem(self, elem: int) -> int:
        """Dynamic shared memory of a block, in bytes, for frames of
        ``elem`` bytes: the largest window's cells of KFRAMES frames,
        rounded up to a 128-byte line (the kernel's swizzle permutes
        16-byte units within a line)."""
        return -(-self.cells * KFRAMES * elem // 128) * 128


def contract_tiles(plan, TYd: int, TXd: int) -> ContractTiles:
    """The tiled contraction's tiles of TYd x TXd dst pixels and the T
    window of each: rows [r0, r0 + rows) and columns [c0, c0 + cols) that
    hold every tap ``T[clamp(ry0[dy] + a), clamp(cx0[dx] + b)]`` of the
    tile's pixels inside their rows' spans, and no tap of another pixel
    (rows and columns outside the footprint carry ry0 = cx0 = 0); c0 is
    rounded down to a multiple of COL_ALIGN and c0 + cols up to one, or to
    TW.  A tile with no in-span pixel is dead (all four 0).  Raises
    RuntimeError if an in-span pixel's taps leave its tile's window."""
    Hd, Wd, TH, TW = plan.Hd, plan.Wd, plan.TH, plan.TW
    n_ty, n_tx = -(-Hd // TYd), -(-Wd // TXd)
    lo = plan.span[:, :1].astype(np.int64)
    hi = plan.span[:, 1:].astype(np.int64)
    x0 = np.arange(n_tx, dtype=np.int64)[None, :] * TXd
    clo = np.maximum(lo, x0)                        # (Hd, n_tx): each row's
    chi = np.minimum(hi, np.minimum(x0 + TXd, Wd))  # in-span columns per tile
    live = clo < chi
    cmin, cmax = _range_min_max(plan.cx0, clo, chi)
    ry0 = plan.ry0.astype(np.int64)[:, None]
    taps = {"r0": np.clip(ry0, 0, TH - 1),
            "r1": np.clip(ry0 + plan.Ka - 1, 0, TH - 1) + 1,
            "c0": np.clip(cmin, 0, TW - 1),
            "c1": np.clip(cmax + plan.Kb - 1, 0, TW - 1) + 1}
    big = np.int64(1) << 40
    pad = np.zeros((n_ty * TYd - Hd, n_tx), bool)
    live_t = np.concatenate([live, pad]).reshape(n_ty, TYd, n_tx)
    ends = {}
    for k, v in taps.items():
        fill, pick = (big, np.min) if k in ("r0", "c0") else (-big, np.max)
        v = np.broadcast_to(v, live.shape)
        v = np.concatenate([v, np.zeros_like(pad, dtype=np.int64)])
        ends[k] = pick(np.where(live_t, v.reshape(live_t.shape), fill),
                       axis=1).reshape(-1)
    c0 = ends["c0"] // COL_ALIGN * COL_ALIGN
    c1 = np.minimum(-(-ends["c1"] // COL_ALIGN) * COL_ALIGN, TW)
    win = np.stack([ends["r0"], c0, ends["r1"] - ends["r0"], c1 - c0], -1)
    win[~live_t.any(axis=1).reshape(-1)] = 0
    win = np.ascontiguousarray(win, dtype=np.int32)
    _check_windows(plan, win, TYd, TXd)
    return ContractTiles(TYd=TYd, TXd=TXd, win=win,
                         cells=int((win[:, 2].astype(np.int64)
                                    * win[:, 3]).max()))


def _check_windows(plan, win: np.ndarray, TYd: int, TXd: int) -> None:
    """Raise RuntimeError unless every in-span pixel's taps lie inside its
    tile's window (each pixel checked, the tile table as the kernel reads
    it)."""
    n_tx = -(-plan.Wd // TXd)
    dy = np.arange(plan.Hd)[:, None]
    dx = np.arange(plan.Wd)[None, :]
    w = win[(dy // TYd) * n_tx + dx // TXd]               # (Hd, Wd, 4)
    inside = (dx >= plan.span[:, :1]) & (dx < plan.span[:, 1:])
    ry0 = plan.ry0.astype(np.int64)[:, None]
    cx0 = plan.cx0.astype(np.int64)[None, :]
    r_lo, r_hi = (np.clip(ry0 + k, 0, plan.TH - 1) for k in (0, plan.Ka - 1))
    c_lo, c_hi = (np.clip(cx0 + k, 0, plan.TW - 1) for k in (0, plan.Kb - 1))
    ok = ((r_lo >= w[..., 0]) & (r_hi < w[..., 0] + w[..., 2])
          & (c_lo >= w[..., 1]) & (c_hi < w[..., 1] + w[..., 3]))
    bad = inside & ~ok
    if bad.any():
        y, x = np.argwhere(bad)[0]
        raise RuntimeError(f"contraction tile window {w[y, x].tolist()} "
                           f"misses the taps of dst pixel ({y}, {x})")


def plan_contract(plan, elem: int) -> Optional[ContractTiles]:
    """The tiled contraction's tiles for frames of ``elem`` bytes: the
    first shape of ``_CONTRACT_TILES`` whose largest window fits
    ``CONTRACT_SMEM_BUDGET``, else the last one if it fits the card's
    opt-in (``SMEM_LIMIT``), else None: the plan takes the direct form."""
    for TYd, TXd in _CONTRACT_TILES:
        t = contract_tiles(plan, TYd, TXd)
        if t.smem(elem) <= CONTRACT_SMEM_BUDGET:
            return t
    return t if t.smem(elem) <= SMEM_LIMIT else None


@dataclasses.dataclass(eq=False)
class ShearKernelPlan:
    """Host tables of the kernels for one EllOperator."""

    qH: int
    qW: int
    TH: int
    TW: int
    Hd: int
    Wd: int
    Ka: int
    Kb: int
    gy: np.ndarray    # (qW,) int32 vertical shift per source column
    hx: np.ndarray    # (TH,) int32 horizontal shift per sheared row
    ry0: np.ndarray   # (Hd,) int32 first T row of each dst row's window
    cx0: np.ndarray   # (Wd,) int32 first T column of each dst column's window
    w2: np.ndarray    # (Ka*Kb, Hd, Wd) float32, tap a*Kb+b
    span: np.ndarray  # (Hd, 2) int32 live columns [lo, hi) per dst row
    # the tiles of each shear form (form_tiles) and of the contraction
    # per element size (contract_plan, "contract<elem>") planned so far
    tiles: Dict[str, object] = dataclasses.field(
        default_factory=dict, repr=False)
    dev: Dict[torch.device, Dict[str, torch.Tensor]] = dataclasses.field(
        default_factory=dict, repr=False)
    # the plan whose device tables this one shares but for the span
    # (with_span); None: its own
    base: Optional["ShearKernelPlan"] = dataclasses.field(
        default=None, repr=False, compare=False)

    def with_span(self, span: np.ndarray) -> "ShearKernelPlan":
        """This plan with ``span`` (Hd, 2) for its span table: tiles of its
        own, planned for that span, and on each device this plan's tables
        but the span, so that the weights are not uploaded again."""
        return dataclasses.replace(self, span=span, tiles={}, dev={},
                                   base=self if self.base is None else self.base)

    def form_tiles(self, form: str) -> ShearTiles:
        """``form``'s tiles (``plan_tiles``), planned at the first call
        and kept."""
        hit = self.tiles.get(form)
        if hit is None:
            hit = self.tiles[form] = plan_tiles(self, form)
        return hit

    def contract_plan(self, elem: int) -> Optional[ContractTiles]:
        """The tiled contraction's tiles for frames of ``elem`` bytes
        (``plan_contract``; None: the direct form), planned at the first
        call and kept."""
        key = f"contract{elem}"
        if key not in self.tiles:
            self.tiles[key] = plan_contract(self, elem)
        return self.tiles[key]

    def tables(self, device: torch.device,
               pinned: bool = False) -> Dict[str, torch.Tensor]:
        """The plan's tables on ``device``, uploaded once and kept; a
        form's tile windows join them as ``win_<form>`` (``form_windows``),
        the contraction's as ``win_contract<elem>`` (``contract_windows``).
        ``pinned``: see ``utils.device.upload``."""
        device = torch.device(device)
        hit = self.dev.get(device)
        if hit is None:
            shared = (self.base.tables(device, pinned)
                      if self.base is not None else {})
            hit = {name: shared[name] if name in shared and name != "span"
                   else upload(getattr(self, name), device, pinned=pinned)
                   for name in _PLAN_ARRAYS}
            self.dev[device] = hit
        return hit

    def form_windows(self, form: str, device: torch.device) -> torch.Tensor:
        """``form``'s tile windows on ``device``, (tiles, 4) int32,
        planned and uploaded at the first call."""
        tabs = self.tables(device)
        key = f"win_{form}"
        if key not in tabs:
            tabs[key] = torch.from_numpy(self.form_tiles(form).win).to(device)
        return tabs[key]

    def contract_windows(self, elem: int,
                         device: torch.device) -> torch.Tensor:
        """The tiled contraction's tile windows for frames of ``elem``
        bytes on ``device``, (tiles, 4) int32, uploaded at the first call;
        the plan must have tiles (``contract_plan(elem)`` not None)."""
        tabs = self.tables(device)
        key = f"win_contract{elem}"
        if key not in tabs:
            tabs[key] = torch.from_numpy(self.contract_plan(elem).win).to(
                device)
        return tabs[key]


def live_spans(w2: np.ndarray) -> np.ndarray:
    """(Hd, 2) int32: for each dst row of the tap-major weights ``w2``
    (taps, Hd, Wd), the half-open range [lo, hi) from its first to one
    past its last column whose taps are not all 0; (0, 0) for a row with
    none.  The counterpart of JAX's ``lv_row`` / ``lv_col`` and
    ``tile_masks`` (pallas_shear.py:307, 371-373), per row rather than per
    128 x 128 tile."""
    live = np.zeros(w2.shape[1:], bool)
    for tap in w2:
        live |= tap != 0
    any_ = live.any(axis=1)
    lo = np.where(any_, live.argmax(axis=1), 0)
    hi = np.where(any_, live.shape[1] - live[:, ::-1].argmax(axis=1), 0)
    return np.ascontiguousarray(np.stack([lo, hi], axis=1), dtype=np.int32)


def plan_from_operator(op: EllOperator) -> ShearKernelPlan:
    """Build the kernels' plan for ``op`` (uncached; raises ValueError
    where build_shear_plan rejects the geometry)."""
    sp = build_shear_plan(op)
    Hd, Wd, Ka, Kb = sp.weights.shape
    w2 = np.ascontiguousarray(
        np.moveaxis(sp.weights.reshape(Hd, Wd, Ka * Kb), -1, 0),
        dtype=np.float32)
    return ShearKernelPlan(
        qH=sp.qH, qW=sp.qW, TH=sp.TH, TW=sp.TW, Hd=Hd, Wd=Wd, Ka=Ka, Kb=Kb,
        gy=np.ascontiguousarray(sp.gy, dtype=np.int32),
        hx=np.ascontiguousarray(sp.hx, dtype=np.int32),
        ry0=np.ascontiguousarray(sp.ry0, dtype=np.int32),
        cx0=np.ascontiguousarray(sp.cx0, dtype=np.int32),
        w2=w2, span=live_spans(w2))


def _plan_key(op: EllOperator):
    return (array_digest(op.weights), array_digest(op.base),
            op.weights.shape, op.spec.qrot_shape)


def kernel_plan(op: EllOperator) -> ShearKernelPlan:
    """Cached ``plan_from_operator``: keyed by the operator's table
    content; a rejected geometry is cached as its ValueError message."""
    key = _plan_key(op)
    hit = _PLAN_CACHE.get(key)
    if hit is None:
        try:
            hit = plan_from_operator(op)
        except ValueError as e:
            hit = str(e)
        _PLAN_CACHE.put(key, hit)
    if isinstance(hit, str):
        raise ValueError(hit)
    return hit


# the disk plan cache: the key's method tag, the plan's array and integer
# fields, and what each process built or loaded (kernel_plan_cached).  v2
# stores the live spans; a v1 entry (no spans) has another key, and an
# entry without spans is not read as a plan
PLAN_CACHE_VERSION = "cuda_shear_v2"
_PLAN_ARRAYS = ("gy", "hx", "ry0", "cx0", "w2", "span")
_PLAN_DIMS = ("qH", "qW", "TH", "TW", "Hd", "Wd", "Ka", "Kb")
PLAN_DISK = {"built": 0, "loaded": 0}


def table_fingerprint(op: EllOperator) -> str:
    """A fingerprint of ``op``'s tables that is stable across processes:
    their shapes, dtypes and a strided sample of at most 2^20 elements of
    each.  Two operators of one geometry and mode but other weights (the
    squared operator of ``propagate_variance``) differ in it."""
    h = hashlib.blake2b(digest_size=16)
    for a in (op.base, op.weights):
        a = np.asarray(a)
        flat = a.reshape(-1)
        h.update(f"{a.shape}{a.dtype.str}".encode())
        h.update(np.ascontiguousarray(flat[::max(1, flat.size >> 20)]))
    return h.hexdigest()


def plan_cache_path(op: EllOperator, cache_dir: Optional[str] = None) -> str:
    """The file of ``op``'s plan in the disk cache: ``<key>.plan.npz``,
    key ``utils.cache.spec_key(op.spec, op.mode, PLAN_CACHE_VERSION)``."""
    from ..utils import cache

    key = cache.spec_key(op.spec, op.mode, PLAN_CACHE_VERSION)
    return os.path.join(cache_dir or cache.DEFAULT_CACHE_DIR,
                        f"{key}.plan.npz")


def save_plan(plan: ShearKernelPlan, op: EllOperator,
              cache_dir: Optional[str] = None) -> str:
    """Write ``plan`` (its integer fields, the table fingerprint and its
    arrays gy, hx, ry0, cx0, w2, span) to the disk cache through a temporary
    file of a unique name, renamed into place: two processes saving at
    once each write their own file, and a reader sees a whole file or
    none.  Tile tables are not stored (planned at a form's first
    launch)."""
    path = plan_cache_path(op, cache_dir)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    meta = {d: int(getattr(plan, d)) for d in _PLAN_DIMS}
    meta["fingerprint"] = table_fingerprint(op)
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + ".",
                               suffix=".tmp", dir=os.path.dirname(path))
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, __meta__=json.dumps(meta),
                     **{n: getattr(plan, n) for n in _PLAN_ARRAYS})
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def load_plan(op: EllOperator,
              cache_dir: Optional[str] = None) -> Optional[ShearKernelPlan]:
    """``op``'s plan from the disk cache, or None: no entry, an entry of
    another operator of the same geometry (fingerprint), or an entry that
    cannot be read (with a RuntimeWarning; the caller rebuilds it, as
    ``utils.cache.load_operator``'s contract is)."""
    path = plan_cache_path(op, cache_dir)
    if not os.path.exists(path):
        return None
    try:
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["__meta__"]))
            if meta["fingerprint"] != table_fingerprint(op):
                return None
            plan = ShearKernelPlan(
                **{d: int(meta[d]) for d in _PLAN_DIMS},
                **{n: np.ascontiguousarray(z[n]) for n in _PLAN_ARRAYS})
        shapes = {"gy": (plan.qW,), "hx": (plan.TH,), "ry0": (plan.Hd,),
                  "cx0": (plan.Wd,), "w2": (plan.Ka * plan.Kb, plan.Hd,
                                            plan.Wd), "span": (plan.Hd, 2)}
        for n, shape in shapes.items():
            a = getattr(plan, n)
            want = np.float32 if n == "w2" else np.int32
            if a.shape != shape or a.dtype != want:
                raise ValueError(f"{n} is {a.dtype} {a.shape}, expected "
                                 f"{np.dtype(want)} {shape}")
    except (OSError, KeyError, ValueError, EOFError,
            zipfile.BadZipFile) as e:
        warnings.warn(f"ignoring unreadable shear plan cache entry {path}: "
                      f"{type(e).__name__}: {e}", RuntimeWarning)
        return None
    return plan


def kernel_plan_cached(op: EllOperator,
                       cache_dir: Optional[str] = None) -> ShearKernelPlan:
    """``kernel_plan`` with a disk cache (``cache_dir``, default
    ``utils.cache.DEFAULT_CACHE_DIR``): the in-memory cache first, then
    the disk, then a build that is saved (a save that fails warns and
    the plan is used all the same).  ``PLAN_DISK`` counts the builds and
    loads.  Rejected geometries raise ValueError and are not saved."""
    key = _plan_key(op)
    hit = _PLAN_CACHE.get(key)
    if hit is None:
        hit = load_plan(op, cache_dir)
        if hit is not None:
            PLAN_DISK["loaded"] += 1
        else:
            try:
                hit = plan_from_operator(op)
            except ValueError as e:
                hit = str(e)
            else:
                PLAN_DISK["built"] += 1
                try:
                    save_plan(hit, op, cache_dir)
                except OSError as e:
                    warnings.warn(f"shear plan not saved: {e}",
                                  RuntimeWarning)
        _PLAN_CACHE.put(key, hit)
    if isinstance(hit, str):
        raise ValueError(hit)
    return hit


# row-sharded plans by table content and rank count (build_sharded_kernel_plan)
_SHARDED_CACHE = LruDict(4, max_bytes=2 << 30)


@dataclasses.dataclass(eq=False)
class ShardedKernelPlan:
    """The row-sharded rotated apply's plans (counterpart of
    ``ShardedShearPlan``, pallas_shear.py:487-535): ``n_dev`` ranks along
    the rows, each holding ``sb`` source rows extended by ``halo`` on
    each side (``Hloc = sb + 2 * halo``) and computing ``db`` dst rows.

    The vertical shear commutes with row sharding: with rank offset
    ``off_i = i * sb - halo``, a local sheared row is the global one
    shifted by ``off_i``, so rank i's plan is the global ``plan``'s rows
    shifted (``rank``): ``hx`` sliced, ``ry0 - off_i``, its dst rows of
    ``w2`` and ``span``; the column tables ``gy``, ``cx0`` and ``TW`` are
    the global ones.  Each rank's plan is an ordinary ``ShearKernelPlan``,
    tiled by the usual planners at its first launch."""

    n_dev: int
    halo: int
    sb: int
    db: int
    Hloc: int
    plan: ShearKernelPlan
    ranks: Dict[int, ShearKernelPlan] = dataclasses.field(
        default_factory=dict, repr=False)

    def rank(self, i: int) -> ShearKernelPlan:
        """Rank i's plan over its extended block, derived at the first
        call and kept."""
        hit = self.ranks.get(i)
        if hit is None:
            p, off = self.plan, i * self.sb - self.halo
            rows = slice(i * self.db, (i + 1) * self.db)
            TH = self.Hloc + int(p.gy.max()) + 1
            u = np.clip(off + np.arange(TH), 0, p.TH - 1)
            hit = self.ranks[i] = ShearKernelPlan(
                qH=self.Hloc, qW=p.qW, TH=TH, TW=p.TW, Hd=self.db, Wd=p.Wd,
                Ka=p.Ka, Kb=p.Kb, gy=p.gy,
                hx=np.ascontiguousarray(p.hx[u]),
                ry0=np.ascontiguousarray(p.ry0[rows] - off, dtype=np.int32),
                cx0=p.cx0, w2=np.ascontiguousarray(p.w2[:, rows]),
                span=np.ascontiguousarray(p.span[rows]))
        return hit


def _rank_shears(p: ShearKernelPlan, off_i: int, off_j: int, Hloc: int,
                 Wloc: int, cols: slice):
    """(gy, hx, cx0, TH, TW) of the plan of a rank whose extended block of
    Hloc x Wloc source pixels starts at global (off_i, off_j) and whose
    dst columns are ``cols``: T_loc[t, x] = T_glob[t + off_i, x + off_j],
    so ``gy`` is the global table at the block's columns, ``hx`` at its
    sheared rows and ``cx0`` shifted; TH and TW hold every T row and
    column that is not all zero and every window (indices past the
    global tables clip to their ends, where the block holds zeros)."""
    gy = np.ascontiguousarray(p.gy[np.clip(off_j + np.arange(Wloc), 0,
                                           p.qW - 1)])
    TH = Hloc + int(gy.max()) + 1
    hx = np.ascontiguousarray(p.hx[np.clip(off_i + np.arange(TH), 0,
                                           p.TH - 1)])
    cx0 = np.ascontiguousarray(p.cx0[cols].astype(np.int64) - off_j,
                               dtype=np.int32)
    TW = max(Wloc + int(hx.max()) + 1, int(cx0.max()) + p.Kb)
    return gy, hx, cx0, TH, TW


def check_rank_blocks(op: EllOperator, plan: ShearKernelPlan, n_r: int,
                      halo_y: int, n_c: int = 0, halo_x: int = 0) -> None:
    """Raise ValueError unless, on every rank, every live tap of its dst
    pixels reads a source pixel inside its extended block (the ELL
    table's live taps) and a T pixel inside its local plane (the plan's
    live taps, ``_rank_shears``' TH x TW), with ``halo_y`` rows (and with
    ``n_c`` column ranks, ``halo_x`` columns) on each side.  ``n_c`` 0:
    the columns are not sharded, the rows alone are checked against
    ``[0, Hloc + max gy + 1)`` (the row-sharded plan keeps the global
    TW).  Every rank checks every rank, so all ranks take the same
    route."""
    Hd, Wd = op.spec.dst_shape
    qH, qW = op.spec.qrot_shape
    cols_split = n_c > 0
    n_c = max(n_c, 1)
    db_r, sb_r, db_c, sb_c = Hd // n_r, qH // n_r, Wd // n_c, qW // n_c
    Hloc, Wloc = sb_r + 2 * halo_y, sb_c + 2 * halo_x
    ri, cj = np.arange(Hd) // db_r, np.arange(Wd) // db_c
    off_r = (ri * sb_r - halo_y).astype(np.int64)[:, None]    # (Hd, 1)
    off_c = (cj * sb_c - halo_x).astype(np.int64)[None, :]    # (1, Wd)
    ext = np.zeros((2, n_r, n_c), np.int64)                    # TH, TW
    for i in range(n_r):
        for j in range(n_c):
            ext[:, i, j] = _rank_shears(
                plan, i * sb_r - halo_y, j * sb_c - halo_x, Hloc, Wloc,
                slice(j * db_c, (j + 1) * db_c))[3:]
    TH, TW = (e[ri][:, cj] for e in ext)                       # (Hd, Wd)
    big = np.int64(1) << 40

    def outside(first, off, live, hi):
        """Pixels whose live taps (first + k, live (Hd, Wd, k)) leave
        [0, hi) once rebased by their rank's offset."""
        r = (np.broadcast_to(first, (Hd, Wd)).astype(np.int64) - off)[
            ..., None] + np.arange(live.shape[-1])
        lo = np.where(live, r, big).min(axis=-1)
        top = np.where(live, r, -big).max(axis=-1)
        return np.argwhere((lo < 0) | (top >= hi))

    live_ell = np.asarray(op.weights) != 0                     # (Hd, Wd, K, K)
    checks = [(op.base[..., 0], off_r, live_ell.any(axis=-1), Hloc,
               f"source rows outside its rank's block of {sb_r} rows and a "
               f"halo of {halo_y}")]
    live_a = np.zeros((Hd, Wd, plan.Ka), bool)
    live_b = np.zeros((Hd, Wd, plan.Kb), bool)
    for t in range(plan.Ka * plan.Kb):
        nz = plan.w2[t] != 0
        live_a[..., t // plan.Kb] |= nz
        live_b[..., t % plan.Kb] |= nz
    checks.append((plan.ry0[:, None], off_r, live_a, TH,
                   "T rows outside its rank's local plane"))
    if cols_split:
        checks += [(op.base[..., 1], off_c, live_ell.any(axis=-2), Wloc,
                    f"source columns outside its rank's block of {sb_c} "
                    f"columns and a halo of {halo_x}"),
                   (plan.cx0[None, :], off_c, live_b, TW,
                    "T columns outside its rank's local plane")]
    for first, off, live, hi, what in checks:
        bad = outside(first, off, live, hi)
        if len(bad):
            y, x = bad[0]
            raise ValueError(f"dst pixel ({y}, {x}) (dst row {y}) reads "
                             f"{what}")


def build_sharded_kernel_plan(op: EllOperator,
                              n_dev: int) -> ShardedKernelPlan:
    """The row-sharded plans of ``op`` over ``n_dev`` ranks (counterpart of
    ``build_sharded_kernel_plan``, pallas_shear.py:537), cached by table
    content and ``n_dev``; the global plan comes through
    ``kernel_plan_cached``.  Raises ValueError (cached too) where the row
    counts do not divide ``n_dev``, the halo needs more than ``n_dev -
    1`` ring hops, ``build_shear_plan`` rejects the geometry, or a live
    tap of some rank's rows would leave its block (``check_rank_blocks``).
    Every rank checks every rank's rows, so all take the same route.
    The halo is exact (``parallel.sharding._ell_blocks``); JAX's 8-row
    rounding and 8-aligned blocks are TPU layout and are not kept."""
    from ..parallel.sharding import _ell_blocks

    key = _plan_key(op) + (int(n_dev),)
    hit = _SHARDED_CACHE.get(key)
    if hit is None:
        try:
            db, sb, halo = _ell_blocks(op, n_dev)[:3]
            plan = kernel_plan_cached(op)
            check_rank_blocks(op, plan, n_dev, halo)
            hit = ShardedKernelPlan(n_dev=int(n_dev), halo=halo, sb=sb,
                                    db=db, Hloc=sb + 2 * halo, plan=plan)
        except ValueError as e:
            hit = str(e)
        _SHARDED_CACHE.put(key, hit)
    if isinstance(hit, str):
        raise ValueError(hit)
    return hit


@dataclasses.dataclass(eq=False)
class Sharded2DKernelPlan:
    """The (rows x cols) sharded rotated apply's plans (counterpart of
    ``Sharded2DShearPlan``, pallas_shear.py:819-870): ``n_r`` x ``n_c``
    ranks, rank (i, j) holding ``sb_r`` x ``sb_c`` source pixels extended
    by ``halo_y`` rows and ``halo_x`` columns on each side (``Hloc`` x
    ``Wloc``) and computing ``db_r`` x ``db_c`` dst pixels.

    Both shears commute with 2-D sharding: gy is indexed by source column
    and hx by sheared row, so with offsets ``off_i = i * sb_r - halo_y``
    and ``off_j = j * sb_c - halo_x`` a rank's T is the global T shifted,
    ``T_loc[t, x] = T_glob[t + off_i, x + off_j]``, and its plan is the
    global ``plan`` shifted along both axes (``rank``): ``gy`` at its
    columns, ``hx`` at its sheared rows, ``ry0 - off_i``, ``cx0 - off_j``,
    its block of ``w2``, and its live spans recomputed on that block (a
    dst row may have no live pixel in a column block: span (0, 0), dead
    tiles).  Each rank's plan is an ordinary ``ShearKernelPlan``, tiled by
    the usual planners at its first launch."""

    n_r: int
    n_c: int
    halo_y: int
    halo_x: int
    sb_r: int
    sb_c: int
    db_r: int
    db_c: int
    plan: ShearKernelPlan
    ranks: Dict[Tuple[int, int], ShearKernelPlan] = dataclasses.field(
        default_factory=dict, repr=False)

    @property
    def Hloc(self) -> int:
        return self.sb_r + 2 * self.halo_y

    @property
    def Wloc(self) -> int:
        return self.sb_c + 2 * self.halo_x

    def rank(self, i: int, j: int) -> ShearKernelPlan:
        """Rank (i, j)'s plan over its extended block, derived at the
        first call and kept."""
        hit = self.ranks.get((i, j))
        if hit is None:
            p = self.plan
            rows = slice(i * self.db_r, (i + 1) * self.db_r)
            cols = slice(j * self.db_c, (j + 1) * self.db_c)
            off_i = i * self.sb_r - self.halo_y
            gy, hx, cx0, TH, TW = _rank_shears(
                p, off_i, j * self.sb_c - self.halo_x, self.Hloc, self.Wloc,
                cols)
            w2 = np.ascontiguousarray(p.w2[:, rows, cols])
            hit = self.ranks[(i, j)] = ShearKernelPlan(
                qH=self.Hloc, qW=self.Wloc, TH=TH, TW=TW, Hd=self.db_r,
                Wd=self.db_c, Ka=p.Ka, Kb=p.Kb, gy=gy, hx=hx,
                ry0=np.ascontiguousarray(p.ry0[rows] - off_i,
                                         dtype=np.int32),
                cx0=cx0, w2=w2, span=live_spans(w2))
        return hit


def build_sharded_kernel_plan_2d(op: EllOperator, n_r: int,
                                 n_c: int) -> Sharded2DKernelPlan:
    """The (rows x cols) sharded plans of ``op`` over ``n_r`` x ``n_c``
    ranks (counterpart of ``build_sharded_kernel_plan_2d``,
    pallas_shear.py:872), cached by table content and ``(n_r, n_c)``; the
    global plan comes through ``kernel_plan_cached``.  Raises ValueError
    (cached too) where a count does not divide the mesh, a halo needs
    more ring hops than its axis has neighbours, ``build_shear_plan``
    rejects the geometry, or a live tap of some rank would leave its
    block or its local T plane (``check_rank_blocks``).  The halos are
    exact (``parallel.sharding._ell_blocks``); JAX's 8-row rounding, its
    ``sb_r % 8`` rule and its 128-column bases are TPU layout and are not
    kept."""
    from ..parallel.sharding import _ell_blocks

    key = _plan_key(op) + (int(n_r), int(n_c))
    hit = _SHARDED_CACHE.get(key)
    if hit is None:
        try:
            db_r, sb_r, halo_y, db_c, sb_c, halo_x = _ell_blocks(op, n_r, n_c)
            plan = kernel_plan_cached(op)
            check_rank_blocks(op, plan, n_r, halo_y, n_c, halo_x)
            hit = Sharded2DKernelPlan(
                n_r=int(n_r), n_c=int(n_c), halo_y=halo_y, halo_x=halo_x,
                sb_r=sb_r, sb_c=sb_c, db_r=db_r, db_c=db_c, plan=plan)
        except ValueError as e:
            hit = str(e)
        _SHARDED_CACHE.put(key, hit)
    if isinstance(hit, str):
        raise ValueError(hit)
    return hit


def _out_dtype(dtype: torch.dtype) -> torch.dtype:
    """Output dtype for frames of ``dtype`` (pallas_shear.py:789-792)."""
    return dtype if dtype in _DTYPE_CODES else torch.float32


def _check_frames(x: torch.Tensor, shape, what: str) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{what} must be a torch.Tensor, got {type(x)}")
    if x.ndim != 3 or tuple(x.shape[1:]) != tuple(shape):
        raise ValueError(f"{what} must be (F, {shape[0]}, {shape[1]}) for "
                         f"this plan, got {tuple(x.shape)}")
    if x.shape[0] == 0:
        raise ValueError(f"{what} has no frames")


def _out_buffer(out, shape, like: torch.Tensor) -> torch.Tensor:
    if out is None:
        return torch.empty(shape, dtype=like.dtype, device=like.device)
    if (tuple(out.shape) != tuple(shape) or out.dtype != like.dtype
            or out.device != like.device or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous {like.dtype} tensor of "
                         f"shape {tuple(shape)} on {like.device}")
    return out


def _launch(name: str, fn, args, what: str) -> None:
    """Call a C launcher; raise on a CUDA error, else count the launch."""
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({what})")
    LAUNCHES[name] += 1


def _cuda_frames(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{what} must be bfloat16 or float32 for the kernel, "
                        f"got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


# ---------------------------------------------------------------------------
# plain versions (torch indexing, any device)
# ---------------------------------------------------------------------------


def vshear_plain(q: torch.Tensor, plan: ShearKernelPlan, *,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """S[f, y, x] = q[f, y - gy[x], x], zero outside: (F, TH, qW)."""
    _check_frames(q, (plan.qH, plan.qW), "q")
    gy = plan.tables(q.device)["gy"]
    rows = (torch.arange(plan.TH, device=q.device)[:, None]
            - gy[None, :].to(torch.int64))                       # (TH, qW)
    valid = (rows >= 0) & (rows < plan.qH)
    idx = rows.clamp(0, plan.qH - 1).expand(q.shape[0], -1, -1)
    s = torch.where(valid, torch.gather(q, 1, idx),
                    torch.zeros((), dtype=q.dtype, device=q.device))
    if out is None:
        return s
    return _out_buffer(out, s.shape, q).copy_(s)


def hshear_plain(s: torch.Tensor, plan: ShearKernelPlan, *,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """T[f, y, x] = S[f, y, x - hx[y]], zero outside: (F, TH, TW)."""
    _check_frames(s, (plan.TH, plan.qW), "S")
    hx = plan.tables(s.device)["hx"]
    cols = (torch.arange(plan.TW, device=s.device)[None, :]
            - hx[:, None].to(torch.int64))                       # (TH, TW)
    valid = (cols >= 0) & (cols < plan.qW)
    idx = cols.clamp(0, plan.qW - 1).expand(s.shape[0], -1, -1)
    t = torch.where(valid, torch.gather(s, 2, idx),
                    torch.zeros((), dtype=s.dtype, device=s.device))
    if out is None:
        return t
    return _out_buffer(out, t.shape, s).copy_(t)


def vhshear_plain(q: torch.Tensor, plan: ShearKernelPlan, *,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Both shears at once, T[f, y, x] = q[f, y - gy[c], c] with
    c = x - hx[y], zero outside: (F, qH, qW) -> (F, TH, TW), one gather."""
    _check_frames(q, (plan.qH, plan.qW), "q")
    tabs = plan.tables(q.device)
    cols = (torch.arange(plan.TW, device=q.device)[None, :]
            - tabs["hx"][:, None].to(torch.int64))               # (TH, TW)
    valid = (cols >= 0) & (cols < plan.qW)
    cols = cols.clamp(0, plan.qW - 1)
    rows = (torch.arange(plan.TH, device=q.device)[:, None]
            - tabs["gy"].to(torch.int64)[cols])
    valid &= (rows >= 0) & (rows < plan.qH)
    idx = (rows.clamp(0, plan.qH - 1) * plan.qW + cols).reshape(1, -1)
    F = q.shape[0]
    t = torch.gather(q.reshape(F, -1), 1, idx.expand(F, -1)).reshape(
        F, plan.TH, plan.TW)
    t = torch.where(valid, t, torch.zeros((), dtype=q.dtype, device=q.device))
    if out is None:
        return t
    return _out_buffer(out, t.shape, q).copy_(t)


def live_mask(plan: ShearKernelPlan, device) -> torch.Tensor:
    """(Hd, Wd) bool on ``device``: dst pixels inside their row's span."""
    span = plan.tables(device)["span"].to(torch.int64)
    cols = torch.arange(plan.Wd, device=device)[None, :]
    return (cols >= span[:, :1]) & (cols < span[:, 1:])


def contract_plain(t: torch.Tensor, plan: ShearKernelPlan, *,
                   out_dtype: Optional[torch.dtype] = None,
                   masked: bool = True, fused: bool = False) -> torch.Tensor:
    """out[f, dy, dx] = sum_ab w2[a*Kb+b, dy, dx] * T[f, ry0[dy]+a, cx0[dx]+b]
    in f32 (taps a-major, then b), cast to ``out_dtype`` (default: T's
    dtype for bf16/f32, else f32); ``masked`` (the kernel's dead-pixel
    skip): 0 outside each dst row's span, whatever T holds; ``fused``:
    each tap a fused multiply-add rounded once (``ops.apply.fma32``), the
    kernel's arithmetic bit for bit (otherwise a product and a sum, each
    rounded)."""
    _check_frames(t, (plan.TH, plan.TW), "T")
    tabs = plan.tables(t.device)
    ry0 = tabs["ry0"].to(torch.int64)
    cx0 = tabs["cx0"].to(torch.int64)
    acc = torch.zeros((t.shape[0], plan.Hd, plan.Wd), dtype=torch.float32,
                      device=t.device)
    for a in range(plan.Ka):
        rows = t.index_select(1, (ry0 + a).clamp(0, plan.TH - 1))
        for b in range(plan.Kb):
            vals = rows.index_select(2, (cx0 + b).clamp(0, plan.TW - 1))
            w = tabs["w2"][a * plan.Kb + b]
            if fused:
                acc = fma32(w, vals.to(torch.float32), acc)
            else:
                acc = acc + w * vals.to(torch.float32)
    if masked:
        acc = torch.where(live_mask(plan, t.device), acc, 0.0)
    return acc.to(out_dtype or _out_dtype(t.dtype))


def contract_tiled_plain(t: torch.Tensor, plan: ShearKernelPlan,
                         tiles: ContractTiles, *,
                         out_dtype: Optional[torch.dtype] = None
                         ) -> torch.Tensor:
    """The tiled kernel's plain version: ``contract_plain(masked=True,
    fused=True)``, each tile's pixels reading T only through the tile's
    window ``tiles.win`` and indices local to it (an index outside the
    window raises); a dead tile and a pixel outside its row's span are 0.
    A loop over the tiles: for small planes."""
    _check_frames(t, (plan.TH, plan.TW), "T")
    F = t.shape[0]
    tabs = plan.tables(t.device)
    ry0 = tabs["ry0"].to(torch.int64)
    cx0 = tabs["cx0"].to(torch.int64)
    live = live_mask(plan, t.device)
    out = torch.zeros((F, plan.Hd, plan.Wd), dtype=torch.float32,
                      device=t.device)
    n_tx = -(-plan.Wd // tiles.TXd)
    for i, (r0, c0, rows, cols) in enumerate(tiles.win.tolist()):
        if rows == 0:
            continue
        y0, x0 = i // n_tx * tiles.TYd, i % n_tx * tiles.TXd
        ys = slice(y0, min(y0 + tiles.TYd, plan.Hd))
        xs = slice(x0, min(x0 + tiles.TXd, plan.Wd))
        window = t[:, r0:r0 + rows, c0:c0 + cols]
        acc = torch.zeros((F, ys.stop - y0, xs.stop - x0),
                          dtype=torch.float32, device=t.device)
        for a in range(plan.Ka):
            lr = (ry0[ys] + a).clamp(0, plan.TH - 1) - r0
            # a row or column without an in-span pixel reads window 0
            lr = torch.where(live[ys, xs].any(dim=1), lr, 0)
            rows_a = window.index_select(1, lr)
            for b in range(plan.Kb):
                lc = (cx0[xs] + b).clamp(0, plan.TW - 1) - c0
                lc = torch.where(live[ys, xs].any(dim=0), lc, 0)
                vals = rows_a.index_select(2, lc)
                w = tabs["w2"][a * plan.Kb + b, ys, xs]
                acc = fma32(w, vals.to(torch.float32), acc)
        out[:, ys, xs] = torch.where(live[ys, xs], acc, 0.0)
    return out.to(out_dtype or _out_dtype(t.dtype))


def apply_ell_shear_plain(q: torch.Tensor, plan: ShearKernelPlan, *,
                          out_dtype: Optional[torch.dtype] = None
                          ) -> torch.Tensor:
    """The three plain stages, the contraction unmasked (JAX's 'sheared'
    route): (F, qH, qW) -> (F, Hd, Wd); (qH, qW) -> (Hd, Wd).  Frames of a
    dtype other than bf16/f32 are cast to f32."""
    if q.ndim == 2:
        return apply_ell_shear_plain(q[None], plan, out_dtype=out_dtype)[0]
    q = q.to(_out_dtype(q.dtype))
    return contract_plain(hshear_plain(vshear_plain(q, plan), plan), plan,
                          out_dtype=out_dtype, masked=False)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


_PLAIN = {"vshear": vshear_plain, "hshear": hshear_plain,
          "vhshear": vhshear_plain}


def _shear_kernel(form: str, x: torch.Tensor, plan: ShearKernelPlan,
                  out: Optional[torch.Tensor]) -> torch.Tensor:
    """Launch one form of the shear kernel (a CPU tensor takes the plain
    version); every element of ``out`` is written."""
    src, dst = _form_shapes(plan, form)
    what = "S" if form == "hshear" else "q"
    _check_frames(x, src, what)
    if x.device.type == "cpu":
        return _PLAIN[form](x, plan, out=out)
    _cuda_frames(x, what)
    F = x.shape[0]
    out = _out_buffer(out, (F,) + dst, x)
    tiles = plan.form_tiles(form)
    win = plan.form_windows(form, x.device)
    tabs = plan.tables(x.device)
    use_gy, use_hx = FORMS[form]
    ptrs = ([x.data_ptr(), out.data_ptr()]
            + [tabs[n].data_ptr() for n, on in (("gy", use_gy),
                                                 ("hx", use_hx)) if on]
            + [win.data_ptr()])
    dims = src + ((dst[0],) if use_gy else ()) + ((dst[1],) if use_hx else ())
    fn = getattr(_build.load(_build.ELL_SHEAR), f"aainterp_{form}")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _launch(form, fn, (*ptrs, F, *dims, tiles.TY, tiles.TX, tiles.rows,
                           tiles.cols, x.element_size(), stream),
                f"F={F}, {src} -> {dst}, tiles {tiles.TY}x{tiles.TX}, "
                f"windows up to {tiles.rows}x{tiles.cols}")
    return out


def vshear_kernel(q: torch.Tensor, plan: ShearKernelPlan, *,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Vertical shear (F, qH, qW) -> (F, TH, qW) on the CUDA kernel; a CPU
    tensor takes ``vshear_plain``.  ``out`` may be given (any contents:
    every element is written)."""
    return _shear_kernel("vshear", q, plan, out)


def hshear_kernel(s: torch.Tensor, plan: ShearKernelPlan, *,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Horizontal shear (F, TH, qW) -> (F, TH, TW) on the CUDA kernel; a
    CPU tensor takes ``hshear_plain``."""
    return _shear_kernel("hshear", s, plan, out)


def vhshear_kernel(q: torch.Tensor, plan: ShearKernelPlan, *,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Both shears at once, (F, qH, qW) -> (F, TH, TW), on the CUDA kernel;
    a CPU tensor takes ``vhshear_plain``."""
    return _shear_kernel("vhshear", q, plan, out)


def _contract(name: str, t: torch.Tensor, plan: ShearKernelPlan,
              masked: bool, out: Optional[torch.Tensor]) -> torch.Tensor:
    """Launch the contraction, masked or not (a CPU tensor takes
    ``contract_plain``); every element of ``out`` is written.  Masked, the
    plan's tiles for T's element size pick the tiled kernel, or, where
    ``contract_plan`` gives none, the direct form (``contract_direct``)."""
    _check_frames(t, (plan.TH, plan.TW), "T")
    F = t.shape[0]
    if t.device.type == "cpu":
        y = contract_plain(t, plan, masked=masked)
        return y if out is None else _out_buffer(out, y.shape, y).copy_(y)
    _cuda_frames(t, "T")
    out = _out_buffer(out, (F, plan.Hd, plan.Wd), t)
    tabs = plan.tables(t.device)
    lib = _build.load(_build.ELL_SHEAR)
    ptrs = [t.data_ptr(), out.data_ptr(), tabs["ry0"].data_ptr(),
            tabs["cx0"].data_ptr(), tabs["w2"].data_ptr()]
    dims = [F, plan.TH, plan.TW, plan.Hd, plan.Wd, plan.Ka, plan.Kb]
    what = (f"F={F}, TH={plan.TH}, TW={plan.TW}, Hd={plan.Hd}, "
            f"Wd={plan.Wd}, Ka={plan.Ka}, Kb={plan.Kb}")
    tiles = plan.contract_plan(t.element_size()) if masked else None
    if tiles is not None:
        fn = lib.aainterp_contract
        ptrs += [tabs["span"].data_ptr(),
                 plan.contract_windows(t.element_size(), t.device).data_ptr()]
        dims += [tiles.TYd, tiles.TXd, tiles.smem(t.element_size())]
        what += (f", tiles {tiles.TYd}x{tiles.TXd}, "
                 f"{tiles.smem(t.element_size())} bytes of shared memory")
    elif masked:
        name = "contract_direct"
        fn = lib.aainterp_contract_direct
        ptrs.append(tabs["span"].data_ptr())
    else:
        fn = lib.aainterp_contract_unmasked
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        _launch(name, fn, (*ptrs, *dims, _DTYPE_CODES[t.dtype], stream),
                what)
    return out


def contract_kernel(t: torch.Tensor, plan: ShearKernelPlan, *,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Window contraction (F, TH, TW) -> (F, Hd, Wd) in T's dtype on the
    CUDA kernel, dead pixels skipped (0 outside each dst row's span): the
    tiled kernel, or the direct form for a plan whose windows do not fit
    in shared memory (``contract_plan`` None); a CPU tensor takes
    ``contract_plain``.  ``out`` may be given (any contents: every element
    is written)."""
    return _contract("contract", t, plan, True, out)


def contract_unmasked_kernel(t: torch.Tensor, plan: ShearKernelPlan, *,
                             out: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """The contraction without the dead-pixel skip: every dst pixel sums
    its taps (a CPU tensor takes ``contract_plain(masked=False)``)."""
    return _contract("contract_unmasked", t, plan, False, out)


def apply_ell_shear_kernel(q: torch.Tensor,
                           plan: ShearKernelPlan) -> torch.Tensor:
    """The rotated apply on two kernels, the fused shear and the masked
    contraction: (F, qH, qW) -> (F, Hd, Wd); (qH, qW) -> (Hd, Wd).  Frames
    of a dtype other than bf16/f32 are cast to f32 first
    (pallas_shear.py:789-792)."""
    if not isinstance(q, torch.Tensor):
        raise TypeError(f"frames must be a torch.Tensor, got {type(q)}")
    if q.ndim == 2:
        return apply_ell_shear_kernel(q[None], plan)[0]
    if q.dtype.is_complex or q.dtype == torch.bool:
        raise TypeError(f"unsupported frame dtype {q.dtype}")
    q = q.to(_out_dtype(q.dtype)).contiguous()
    return contract_kernel(vhshear_kernel(q, plan), plan)
