"""The exact rotated route's decomposition at the rotated flagship: the
counterpart of ``benchmarks/rot_experiments.py``.

The route is two kernels (``ops/cuda_shear.py``): the fused shear, which
writes the sheared plane T straight from the frames, and the window
contraction with its dead-pixel skip (0 outside each dst row's span of
live columns: JAX's masked contraction), tiled: one block per dst tile
on the tile's T window, staged in shared memory from the route's tile
table (``contract_tiled_kernel``).  The contraction's probe modes
(``csrc/contract.cuh`` under ``csrc/probes.cu``) each change one thing in
the kernel they split and so split its time between the streams it
reads:

* ``noweight`` — the tiled kernel with ``out = sum_ab T window``: no
  weight load, no multiply, each tap one f32 add
  (``_build_contract_noweight``, rot_experiments.py:130), and JAX's
  function on every pixel: JAX's one-hot selectors take the live dst
  rows and columns only (those whose weights are not all 0), so it writes
  0 on every other row and column.  The kernel
  (``contract_noweight_tiled_kernel``) runs on a plan of its own,
  ``noweight_plan``: the live rectangle as its span (``noweight_span``:
  the live columns, one range, on each live row) and the tiles
  ``contract_tiles`` plans for that span, so JAX's zeros come from the
  tiled body's skip; ``noweight_direct`` is its first form, the direct
  form (a thread a pixel, its taps gathered from device memory) masked by
  the same span;
* ``tshare`` — the tiled kernel with every live tile's window staged from
  frame 0 at T's origin, ``T[0, 0:rows, 0:cols]``, for every frame: no T
  stream from device memory, the same output for every frame
  (``_build_contract_share``, :247);
* ``wshare`` — the tiled kernel with every tile reading the weights of
  the first live tile (``shared_tile``) at the pixel's position within
  it: no weight stream (the same);
* ``bothshare`` — both;
* ``pipelined`` — the tiled kernel's function and sum order on a
  persistent grid, each block staging its next tile's window while it
  sums the current one, the live tiles dealt out to the blocks in
  ``pipeline_order``: bit-equal to ``contract_kernel``
  (``_build_contract_pipelined``, :392).

Like JAX's, every mode writes 0 and reads nothing for dead tiles and
for pixels outside their row's span (noweight's: the live rectangle).
The share and pipelined modes read the route's tile table
(``plan.contract_plan``), noweight the live rectangle's
(``noweight_tiles``); a plan without one (windows beyond shared memory,
where the route takes the direct form) raises ``RuntimeError`` naming the
mode, and a plan whose live columns are not one range raises
``ValueError`` for both noweight modes.

``contract_probe_kernel(t, plan, mode)`` launches one (a CPU tensor takes
``contract_probe_plain``), counted per mode in ``LAUNCHES``; the plain
versions are ``ops.cuda_shear.contract_plain`` with those substitutions,
each tile window indexed as ``contract_tiled_plain`` indexes it and each
tap a fused multiply-add (``fma32``) as in the kernels.

``EXPS`` are the JAX file's experiments under its names: ``full`` (the
route's two kernels), ``shears`` (the fused shear, with the single forms
beside it), ``contract`` (the contraction without the skip,
``contract_unmasked_kernel``), ``contract_masked`` (the route's
contraction, ``contract_kernel``, tiled), and the six probe modes; and
``contract_tiled_unmasked``, noweight's tiled yardstick: the route's
tiled kernel on ``noweight_plan``, the weighted sums on the live
rectangle (``contract_tiled_unmasked_kernel``).
Each builds the flagship's plan (``_plan``: 2048^2 at 1.0 -> 0.5, 30
degrees about the center, exact; K 6, Ka x Kb 5 x 5), makes seeded
inputs on the device and times the kernels with ``harness.measure``.
JAX's ``--tile_y`` sized its contraction's dst row tile, which the port's
plan does not have; it is not carried.

    python -m aainterp_torch.probes.rot_experiments --exp noweight \\
        [--batch 8] [--dtype bfloat16] [--device cuda]

prints the JAX probe's line, ``{exp}: ... Gpixel/s  (... us/frame)``.
"""

from __future__ import annotations

import argparse
import functools
import sys
from typing import Optional

import numpy as np
import torch

from .. import _build
from ..grids import make_grid_spec
from ..ops import cuda_shear
from ..ops.apply import fma32
from ..ops.weights import ell_operator
from ..utils.device import SMEM_LIMIT, Device, target
from ..utils.lru import LruDict
from . import harness

# probe mode -> the kernel's mode code (contract.cuh's Probe)
MODES = {"noweight": 1, "noweight_direct": 6, "tshare": 2, "wshare": 3,
         "bothshare": 4, "pipelined": 5}
# the modes of noweight's function: the tiled kernel and its first form
NOWEIGHT = ("noweight", "noweight_direct")
# kernel launches so far per mode, counted where the wrapper launches
LAUNCHES = {m: 0 for m in MODES}
# id(plan) -> (plan, noweight_plan(plan)): the probe's own plans, kept
# out of the route's plan caches
_NOWEIGHT_PLANS = LruDict(4, name="rot_experiments.noweight")


def _shares(mode: str):
    """(T shared, weights shared) of a probe mode."""
    if mode not in MODES:
        raise ValueError(f"probe mode must be one of {sorted(MODES)}, got "
                         f"{mode!r}")
    return mode in ("tshare", "bothshare"), mode in ("wshare", "bothshare")


def noweight_span(plan: cuda_shear.ShearKernelPlan) -> np.ndarray:
    """(Hd, 2) int32: the live rectangle as a span table, the dst pixels
    JAX's noweight sums (``_build_contract_noweight`` selects the live rows
    and columns alone, ``lv_row`` and ``lv_col`` of pallas_shear.py:372-373:
    those whose weights are not all 0): (first live column, last + 1) on
    each live row, (0, 0) on every other.  ``ValueError`` naming noweight
    where the live columns are not one range (a rectangle's rotation never
    gives that, but a span table cannot carry a gap)."""
    live = plan.w2 != 0
    rows = live.any(axis=(0, 2))
    cols = np.flatnonzero(live.any(axis=(0, 1)))
    if cols.size and cols[-1] + 1 - cols[0] != cols.size:
        raise ValueError(
            f"contract probe noweight: the live dst columns are not one "
            f"range ({cols.size} live in [{cols[0]}, {cols[-1] + 1})), so "
            "no span table holds JAX's zeros")
    span = np.zeros((plan.Hd, 2), np.int32)
    if cols.size:
        span[rows] = (cols[0], cols[-1] + 1)
    return span


def noweight_plan(plan: cuda_shear.ShearKernelPlan,
                  device=None) -> cuda_shear.ShearKernelPlan:
    """``plan`` with the live rectangle for its span (``noweight_span``,
    ``ShearKernelPlan.with_span``), made once a plan and kept here:
    noweight's tile table is its ``contract_plan`` (``contract_tiles`` on
    that span, whose window check then covers every pixel noweight
    computes), and the route's tiled kernel on it is
    ``contract_tiled_unmasked``.  Its tables on a device are the plan's,
    but for the span: the weights are not uploaded again.  ``device``
    (optional) uploads them there now."""
    hit = _NOWEIGHT_PLANS.get(id(plan))
    if hit is None or hit[0] is not plan:
        hit = (plan, plan.with_span(noweight_span(plan)))
        _NOWEIGHT_PLANS.put(id(plan), hit)
    if device is not None:
        hit[1].tables(torch.device(device))
    return hit[1]


def noweight_tiles(plan: cuda_shear.ShearKernelPlan,
                   elem: int) -> cuda_shear.ContractTiles:
    """noweight's tile table for frames of ``elem`` bytes: the first shape
    of the route's that fits (``plan_contract`` on ``noweight_plan``);
    ``RuntimeError`` naming noweight where none fits (its windows exceed
    shared memory), as ``probe_tiles`` raises for the share probes."""
    tiles = noweight_plan(plan).contract_plan(elem)
    if tiles is None:
        raise RuntimeError(
            f"contract probe noweight: the live rectangle's windows do not "
            f"fit in shared memory for {elem}-byte frames at any tile shape")
    return tiles


def probe_tiles(plan: cuda_shear.ShearKernelPlan, mode: str,
                elem: int) -> cuda_shear.ContractTiles:
    """The route's tile table for frames of ``elem`` bytes, which the
    tiled probe ``mode`` reads; RuntimeError naming the mode where the
    plan has none (its windows exceed shared memory, and the route takes
    the direct form, which no tiled probe splits)."""
    tiles = plan.contract_plan(elem)
    if tiles is None:
        raise RuntimeError(
            f"contract probe {mode}: the plan has no contraction tiles for "
            f"{elem}-byte frames (windows beyond shared memory; the route "
            "takes the direct form there)")
    return tiles


def shared_tile(tiles: cuda_shear.ContractTiles) -> int:
    """The tile whose weights wshare and bothshare read: the first live
    tile in row-major order (tile 0 is a dead corner at the rotated
    flagship, all of whose weights are 0), or 0 where none is live."""
    live = np.flatnonzero(tiles.win[:, 2] > 0)
    return int(live[0]) if live.size else 0


def pipeline_order(plan: cuda_shear.ShearKernelPlan,
                   tiles: cuda_shear.ContractTiles):
    """(order, n_live): the tiles in the order the pipelined form deals
    them out to its blocks in turn, (tiles,) int32: the n_live live ones
    first, most in-span pixels first (ties in tile order), so that the
    blocks' shares of the sums come out even, then the dead ones."""
    TYd, TXd = tiles.TYd, tiles.TXd
    n_ty, n_tx = -(-plan.Hd // TYd), -(-plan.Wd // TXd)
    cols = np.arange(plan.Wd)[None, :]
    live = np.zeros((n_ty * TYd, n_tx * TXd), bool)
    live[:plan.Hd, :plan.Wd] = ((cols >= plan.span[:, :1])
                                & (cols < plan.span[:, 1:]))
    work = live.reshape(n_ty, TYd, n_tx, TXd).sum(axis=(1, 3)).reshape(-1)
    is_live = tiles.win[:, 2] > 0
    lv = np.flatnonzero(is_live)
    order = np.concatenate([lv[np.argsort(-work[lv], kind="stable")],
                            np.flatnonzero(~is_live)])
    return order.astype(np.int32), len(lv)


def _window_origins(plan, tiles, elem: int, device):
    """(r0, c0), (Hd, Wd) int64: the origin of each dst pixel's tile
    window."""
    win = plan.contract_windows(elem, device).to(torch.int64)
    n_tx = -(-plan.Wd // tiles.TXd)
    tile = ((torch.arange(plan.Hd, device=device) // tiles.TYd)[:, None]
            * n_tx + (torch.arange(plan.Wd, device=device)
                      // tiles.TXd)[None, :])
    return win[tile, 0], win[tile, 1]


def _shared_weights(plan, tiles, device):
    """(rows (Hd,), cols (Wd,)) int64 of the weights wshare reads at each
    dst pixel: ``shared_tile``'s pixel at the same position within its
    tile, clamped to the plane (made on ``device``: no host copy, so a
    CUDA graph can capture it)."""
    n_tx = -(-plan.Wd // tiles.TXd)
    wt = shared_tile(tiles)
    y0, x0 = wt // n_tx * tiles.TYd, wt % n_tx * tiles.TXd
    rows = torch.arange(plan.Hd, device=device) % tiles.TYd + y0
    cols = torch.arange(plan.Wd, device=device) % tiles.TXd + x0
    return rows.clamp(max=plan.Hd - 1), cols.clamp(max=plan.Wd - 1)


def contract_probe_plain(t: torch.Tensor, plan: cuda_shear.ShearKernelPlan,
                         mode: str, *,
                         out_dtype: Optional[torch.dtype] = None
                         ) -> torch.Tensor:
    """The probe ``mode``'s function in plain torch, f32 sums (taps
    a-major, then b) cast to ``out_dtype`` (default: T's dtype for
    bf16/f32, else f32).  The share and pipelined modes (RuntimeError
    without the plan's tiles, ``probe_tiles``): ``contract_plain(fused=True)``, 0 outside each dst
    row's span, with each tile's window read from frame 0 at T's origin,
    ``T[0, lr, lc]`` at the tap's window-local row and column (tshare,
    bothshare: the same for every frame), and the weights of
    ``shared_tile`` at the pixel's position within its tile (wshare,
    bothshare); pipelined: as it is.  noweight and noweight_direct: the
    sums of the T windows without weights, 0 outside the live rectangle
    (``noweight_span``), as JAX's."""
    share_t, share_w = _shares(mode)
    cuda_shear._check_frames(t, (plan.TH, plan.TW), "T")
    out_dtype = out_dtype or cuda_shear._out_dtype(t.dtype)
    F, dev = t.shape[0], t.device
    tabs = plan.tables(dev)
    ry0 = tabs["ry0"].to(torch.int64)
    cx0 = tabs["cx0"].to(torch.int64)
    if mode in NOWEIGHT:
        nw = noweight_plan(plan, dev)
        acc = torch.zeros((F, plan.Hd, plan.Wd), dtype=torch.float32,
                          device=dev)
        for a in range(plan.Ka):
            rows = t.index_select(1, (ry0 + a).clamp(0, plan.TH - 1))
            for b in range(plan.Kb):
                acc = acc + rows.index_select(
                    2, (cx0 + b).clamp(0, plan.TW - 1)).to(torch.float32)
        acc = torch.where(cuda_shear.live_mask(nw, dev), acc, 0.0)
        return acc.to(out_dtype)
    elem = t.element_size()
    tiles = probe_tiles(plan, mode, elem)
    if mode == "pipelined":
        return cuda_shear.contract_plain(t, plan, out_dtype=out_dtype,
                                         fused=True)
    if share_t:
        r0, c0 = _window_origins(plan, tiles, elem, dev)
        corner = t[0].reshape(-1)
    if share_w:
        wr, wc = _shared_weights(plan, tiles, dev)
    acc = torch.zeros((1 if share_t else F, plan.Hd, plan.Wd),
                      dtype=torch.float32, device=dev)
    for a in range(plan.Ka):
        rows = (ry0 + a).clamp(0, plan.TH - 1)
        if not share_t:
            t_rows = t.index_select(1, rows)
        for b in range(plan.Kb):
            cols = (cx0 + b).clamp(0, plan.TW - 1)
            if share_t:
                # the window-local (row, col) in frame 0's corner; a pixel
                # outside its span (0 below) may fall off the corner
                at = ((rows[:, None] - r0) * plan.TW + cols[None, :] - c0)
                vals = corner[at.clamp(0, corner.numel() - 1)][None]
            else:
                vals = t_rows.index_select(2, cols)
            w = tabs["w2"][a * plan.Kb + b]
            if share_w:
                w = w.index_select(0, wr).index_select(1, wc)
            acc = fma32(w, vals.to(torch.float32), acc)
    acc = torch.where(cuda_shear.live_mask(plan, dev), acc, 0.0)
    return acc.to(out_dtype).expand(F, -1, -1).contiguous()


def contract_probe_kernel(t: torch.Tensor, plan: cuda_shear.ShearKernelPlan,
                          mode: str, *,
                          out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The probe ``mode`` on the CUDA kernel, (F, TH, TW) -> (F, Hd, Wd)
    in T's dtype (bf16 or f32); a CPU tensor takes
    ``contract_probe_plain``.  ``out`` may be given (any contents: every
    element is written).  The tiled modes raise RuntimeError where the
    plan has no tiles (``probe_tiles``, ``noweight_tiles``), and pipelined
    where its two windows exceed the card's shared memory; both noweight
    modes ValueError where the live columns are not one range
    (``noweight_span``, on the CPU too); the launch's own refusal
    (pipelined: a tile of more pixels than the kernel's summing threads)
    raises RuntimeError too."""
    _shares(mode)
    cuda_shear._check_frames(t, (plan.TH, plan.TW), "T")
    shape = (t.shape[0], plan.Hd, plan.Wd)
    if t.device.type == "cpu":
        y = contract_probe_plain(t, plan, mode)
        return y if out is None else cuda_shear._out_buffer(
            out, shape, y).copy_(y)
    cuda_shear._cuda_frames(t, "T")
    elem = t.element_size()
    tabs = plan.tables(t.device)
    span = tabs["span"]
    # tiles, order, TYd, TXd, smem, wtile, n_live
    tiled = (0, 0, 0, 0, 0, 0, 0)
    if mode in NOWEIGHT:
        nw = noweight_plan(plan, t.device)
        span = nw.tables(t.device)["span"]
        if mode == "noweight":
            tiles = noweight_tiles(plan, elem)
            tiled = (nw.contract_windows(elem, t.device).data_ptr(), 0,
                     tiles.TYd, tiles.TXd, tiles.smem(elem), 0, 0)
    else:
        tiles = probe_tiles(plan, mode, elem)
        smem = tiles.smem(elem)
        if mode == "pipelined" and 2 * smem > SMEM_LIMIT:
            raise RuntimeError(
                f"contract probe pipelined: two windows of {smem} bytes "
                f"(limit {SMEM_LIMIT}) do not fit")
        order, n_live = 0, 0
        if mode == "pipelined":
            key = f"order_contract{elem}"        # uploaded once
            if key not in tabs:
                tabs[key] = torch.from_numpy(
                    pipeline_order(plan, tiles)[0]).to(t.device)
            order = tabs[key].data_ptr()
            n_live = int((tiles.win[:, 2] > 0).sum())
        tiled = (plan.contract_windows(elem, t.device).data_ptr(), order,
                 tiles.TYd, tiles.TXd, smem, shared_tile(tiles), n_live)
    out = cuda_shear._out_buffer(out, shape, t)
    fn = _build.load(_build.PROBES).aainterp_contract_probe
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        rc = fn(t.data_ptr(), out.data_ptr(), tabs["ry0"].data_ptr(),
                tabs["cx0"].data_ptr(), tabs["w2"].data_ptr(),
                span.data_ptr(), *tiled[:2], t.shape[0],
                plan.TH, plan.TW, plan.Hd, plan.Wd, plan.Ka, plan.Kb,
                *tiled[2:], MODES[mode], cuda_shear._DTYPE_CODES[t.dtype],
                stream)
    if rc != 0:
        raise RuntimeError(f"contract probe {mode} launch failed: CUDA error "
                           f"{rc} (F={t.shape[0]}, TH={plan.TH}, "
                           f"TW={plan.TW}, Hd={plan.Hd}, Wd={plan.Wd}, "
                           f"tiles {tiled[2]}x{tiled[3]}, {tiled[4]} bytes "
                           "of shared memory)")
    LAUNCHES[mode] += 1
    return out


def contract_tiled_unmasked_plain(t: torch.Tensor,
                                  plan: cuda_shear.ShearKernelPlan
                                  ) -> torch.Tensor:
    """``contract_tiled_unmasked_kernel``'s function: ``contract_plain
    (fused=True)`` on ``noweight_plan``, the weighted sums of every pixel
    of the live rectangle, 0 elsewhere."""
    cuda_shear._check_frames(t, (plan.TH, plan.TW), "T")
    return cuda_shear.contract_plain(t, noweight_plan(plan, t.device),
                                     fused=True)


def contract_tiled_unmasked_kernel(t: torch.Tensor,
                                   plan: cuda_shear.ShearKernelPlan, *,
                                   out: Optional[torch.Tensor] = None
                                   ) -> torch.Tensor:
    """noweight's tiled yardstick: the route's own tiled kernel
    (``cuda_shear.contract_kernel``, counted there as ``contract``) on
    ``noweight_plan`` and noweight's tile table, so that it and noweight
    differ by the weights alone.  A CPU tensor takes
    ``contract_tiled_unmasked_plain``; a plan without noweight's tiles
    raises RuntimeError (``noweight_tiles``), never taking the direct
    form."""
    cuda_shear._check_frames(t, (plan.TH, plan.TW), "T")
    if t.device.type == "cpu":
        y = contract_tiled_unmasked_plain(t, plan)
        return y if out is None else cuda_shear._out_buffer(
            out, y.shape, y).copy_(y)
    noweight_tiles(plan, t.element_size())
    return cuda_shear.contract_kernel(t, noweight_plan(plan, t.device),
                                      out=out)


def _live(plan: cuda_shear.ShearKernelPlan):
    """(live dst pixels, T elements their windows read) of the dead-pixel
    skip: the pixels inside their rows' spans, and the T elements the
    windows of those pixels touch."""
    span = plan.span.astype(np.int64)
    width = span[:, 1] - span[:, 0]
    touched = np.zeros((plan.TH, plan.TW), bool)
    for dy in np.nonzero(width > 0)[0]:
        lo, hi = span[dy]
        c = np.clip(plan.cx0[lo:hi, None] + np.arange(plan.Kb), 0,
                    plan.TW - 1)
        r = np.clip(plan.ry0[dy] + np.arange(plan.Ka), 0, plan.TH - 1)
        touched[np.ix_(r, np.unique(c))] = True
    return int(width.sum()), int(touched.sum())


def traffic(plan: cuda_shear.ShearKernelPlan, batch: int, elem: int,
            what: str) -> tuple:
    """(bytes, operations) of one batch of ``what`` (an experiment, a
    probe mode, or a shear form): each input read once and each output
    written once, as far as this plan's data needs it (the dead-pixel
    skip reads the weights of the live pixels and the T elements of their
    windows, and does their taps only; a shared T is frame 0's largest
    tile window, ``tiles.cells`` elements; shared weights are one tile's,
    Ka * Kb * TYd * TXd floats); 2 operations per weighted tap, 1 per
    unweighted one."""
    p = plan
    n_live, t_live = _live(p)
    taps = p.Ka * p.Kb
    t_b = batch * p.TH * p.TW * elem
    t_lb = batch * t_live * elem                 # T the live windows read
    q_b = batch * p.qH * p.qW * elem
    s_b = batch * p.TH * p.qW * elem
    w_b = taps * p.Hd * p.Wd * 4
    w_lb = taps * n_live * 4                     # the live pixels' weights
    o_b = batch * p.Hd * p.Wd * elem
    idx = (p.Hd + p.Wd) * 4                       # ry0, cx0
    sp = p.Hd * 8                                 # span
    ops = batch * p.Hd * p.Wd * taps
    ops_l = batch * n_live * taps
    masked = (t_lb + w_lb + o_b + idx + sp, 2 * ops_l)
    if what in NOWEIGHT + ("contract_tiled_unmasked",):
        n_nw, t_nw = _live(noweight_plan(p))
        nw = batch * t_nw * elem + o_b + idx + sp
        if what in NOWEIGHT:
            return nw, batch * n_nw * taps
        return nw + taps * n_nw * 4, 2 * batch * n_nw * taps
    if what in ("tshare", "wshare", "bothshare"):
        tiles = probe_tiles(p, what, elem)
        share_t, share_w = _shares(what)
        t_read = tiles.cells * elem if share_t else t_lb
        w_read = taps * tiles.TYd * tiles.TXd * 4 if share_w else w_lb
        return (t_read + w_read + o_b + idx + sp, 2 * ops_l)
    return {
        "vshear": (q_b + s_b + p.qW * 4, 0),
        "hshear": (s_b + t_b + p.TH * 4, 0),
        "shears": (q_b + t_b + (p.qW + p.TH) * 4, 0),
        "contract": (t_b + w_b + o_b + idx, 2 * ops),
        "contract_masked": masked,
        "pipelined": masked,
        # T written by the fused shear, its live windows read by the
        # masked contraction
        "full": (q_b + t_b + (p.qW + p.TH) * 4 + masked[0], masked[1]),
    }[what]


def _plan(shape=(2048, 2048), angle: float = 30.0):
    """(spec, operator, kernel plan) of ``shape`` at 1.0 -> 0.5, rotated
    ``angle`` degrees about the center, exact; the plan through the disk
    cache (``kernel_plan_cached``).  The last one is kept."""
    return _plan_cached(tuple(int(n) for n in shape), float(angle))


@functools.lru_cache(maxsize=1)
def _plan_cached(shape, angle: float):
    H, W = shape
    spec = make_grid_spec((H, W), 1.0, 0.5, (W / 2, H / 2), angle)
    op = ell_operator(spec, mode="exact")
    return spec, op, cuda_shear.kernel_plan_cached(op)


def _frames(K: int, batch: int, shape, dtype, dev, seed: int = 0):
    """K + 1 distinct seeded (batch, H, W) stacks: one to warm up on, K to
    measure."""
    gen = harness.seeded(dev, seed)
    return [harness.uniform((batch,) + tuple(shape), dtype, gen, dev)
            for _ in range(K + 1)]


def _contract_inputs(kp, batch: int, dtype, dev, K: int = 4):
    """K = 4 distinct random T stacks (stand-ins for the sheared plane; 23
    MB per bf16 frame at the flagship) and one to warm up on."""
    return _frames(K, batch, (kp.TH, kp.TW), dtype, dev, seed=1)


def _result(exp: str, t: harness.Timing, batch: int, dtype, shape,
            angle: float, **extra) -> dict:
    px = batch * shape[0] * shape[1]
    return {"exp": exp, "ms_per_batch": t.ms,
            "gpixel_s": px / (t.ms * 1e-3) / 1e9,
            "us_per_frame": t.ms * 1e3 / batch, "batch": batch,
            "dtype": str(dtype).split(".")[-1], "shape": list(shape),
            "angle": angle, "clock": t.clock, "device": t.device, **extra}


def _timed(exp: str, fn, inputs_of, batch, dtype, device, shape, angle,
           **extra):
    dev = target(device)
    spec, op, kp = _plan(shape, angle)
    xs = inputs_of(kp, dev)
    t = harness.measure(lambda x: fn(x, kp), xs[1:], xs[:1])
    return _result(exp, t, batch, dtype, shape, angle, **extra)


def exp_full(batch: int = 8, dtype=torch.bfloat16, device: Device = None,
             shape=(2048, 2048), angle: float = 30.0):
    """The route's two kernels (``apply_ell_shear_kernel``) on K = 8
    distinct frame batches."""
    return _timed("full", cuda_shear.apply_ell_shear_kernel,
                  lambda kp, dev: _frames(8, batch, shape, dtype, dev),
                  batch, dtype, device, shape, angle)


def exp_shears(batch: int = 8, dtype=torch.bfloat16, device: Device = None,
               shape=(2048, 2048), angle: float = 30.0):
    """T from the frames: the fused shear (the route's), with the single
    forms beside it (``vshear_ms``: S from q; ``hshear_ms``: T from S)."""
    dev = target(device)
    spec, op, kp = _plan(shape, angle)
    qs = _frames(8, batch, shape, dtype, dev)
    ss = [cuda_shear.vshear_plain(q, kp) for q in qs]
    t = harness.measure(lambda q: cuda_shear.vhshear_kernel(q, kp), qs[1:],
                        qs[:1])
    singles = {f"{form}_ms": harness.measure(
        lambda x, form=form: getattr(cuda_shear, f"{form}_kernel")(x, kp),
        xs[1:], xs[:1]).ms
        for form, xs in (("vshear", qs), ("hshear", ss))}
    return _result("shears", t, batch, dtype, shape, angle, **singles)


def exp_contract(batch: int = 8, dtype=torch.bfloat16, device: Device = None,
                 shape=(2048, 2048), angle: float = 30.0):
    """The contraction without the dead-pixel skip
    (``contract_unmasked_kernel``, JAX's ``masked=False``) on K = 4
    random T stacks."""
    return _timed("contract", cuda_shear.contract_unmasked_kernel,
                  lambda kp, dev: _contract_inputs(kp, batch, dtype, dev),
                  batch, dtype, device, shape, angle)


def exp_contract_masked(batch: int = 8, dtype=torch.bfloat16,
                        device: Device = None, shape=(2048, 2048),
                        angle: float = 30.0):
    """The route's contraction, dead pixels skipped (``contract_kernel``,
    JAX's ``masked=True``), on K = 4 random T stacks."""
    return _timed("contract_masked", cuda_shear.contract_kernel,
                  lambda kp, dev: _contract_inputs(kp, batch, dtype, dev),
                  batch, dtype, device, shape, angle)


def exp_contract_tiled_unmasked(batch: int = 8, dtype=torch.bfloat16,
                                device: Device = None, shape=(2048, 2048),
                                angle: float = 30.0):
    """The route's tiled kernel on the live rectangle
    (``contract_tiled_unmasked_kernel``), noweight's yardstick, on K = 4
    random T stacks."""
    return _timed("contract_tiled_unmasked", contract_tiled_unmasked_kernel,
                  lambda kp, dev: _contract_inputs(kp, batch, dtype, dev),
                  batch, dtype, device, shape, angle)


def _probe_exp(mode: str):
    def exp(batch: int = 8, dtype=torch.bfloat16, device: Device = None,
            shape=(2048, 2048), angle: float = 30.0):
        return _timed(mode, lambda t, kp: contract_probe_kernel(t, kp, mode),
                      lambda kp, dev: _contract_inputs(kp, batch, dtype, dev),
                      batch, dtype, device, shape, angle)
    exp.__name__ = f"exp_{mode}"
    exp.__doc__ = (f"The contraction's {mode} probe "
                   "(``contract_probe_kernel``) on K = 4 random T stacks.")
    return exp


EXPS = {"full": exp_full, "shears": exp_shears, "contract": exp_contract,
        "contract_masked": exp_contract_masked,
        "contract_tiled_unmasked": exp_contract_tiled_unmasked,
        **{mode: _probe_exp(mode) for mode in
           ("noweight", "noweight_direct", "pipelined", "tshare", "wshare",
            "bothshare")}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--exp", required=True, choices=sorted(EXPS))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    try:
        r = EXPS[args.exp](args.batch, getattr(torch, args.dtype),
                           args.device)
    except RuntimeError as e:
        print(e, file=sys.stderr)
        return 2
    print(f"{args.exp}: {r['gpixel_s']:.2f} Gpixel/s  "
          f"({r['us_per_frame']:.0f} us/frame)")
    if args.exp == "shears":
        print(f"single forms: vshear {r['vshear_ms']:.4f} ms, hshear "
              f"{r['hshear_ms']:.4f} ms per batch (fused "
              f"{r['ms_per_batch']:.4f})")
    if r["clock"] != "cuda_events":
        print(f"({r['device']}: the plain versions on the host's clock, not "
              "a device time)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
