"""Separable banded apply on the CUDA kernel ``csrc/separable_apply.cu``.

Counterpart of ``aainterp/ops/pallas_apply.py::apply_separable_pallas``
and its kernel ``_build_separable_kernel``: (F, H, W) -> (F, Hd, Wd).

* ``plan_separable`` is the host planner (``band_plan``, shared with
  kernel 2): dst column strips of TX and row tiles of TY, each strip's
  first source column ``c0`` and each tile's first source row, the common
  spans SX and SY that hold every tap.  One block takes one row tile of
  one strip.  It halves the tile until the block's shared memory
  (``band_smem``: the raw source window, the f32 y-pass rows, the tile's
  tap table and an output tile) fits ``SMEM_TARGET``; at one dst pixel per
  tile it accepts up to the card's opt-in limit.  A band pair beyond that,
  which kernel 1 cannot take, goes to kernel 2 (``cuda_apply_2d``, which
  has a direct form for any band), decided on the host before any launch;
  that launch counts in ``cuda_apply_2d.LAUNCHES``.
* ``apply_separable_kernel`` is the wrapper.  A CUDA tensor launches a
  kernel or raises — there is no fallback to a plain version.  A CPU
  tensor takes the plain version, ``apply_separable_plain``.
* Plans are cached by table content; each plan uploads its tables to a
  device once and keeps them.

Dtype contract (pallas_apply.py:514-517, :583-584): bf16, f32 and uint8
frames give that dtype out by default; any other real dtype is cast to
f32 and gives f32.  Accumulation is f32.  uint8 output rounds half to
even and saturates to [0, 255].  An explicit ``out_dtype`` is honoured:
the kernel writes f32, bf16 or uint8 itself and any other dtype is a cast
of its f32 output.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import _build
from ..utils.device import SMEM_LIMIT, out_buffer, upload
from ..utils.digest import array_digest
from ..utils.log import build_span, span
from ..utils.lru import LruDict
from .apply import apply_separable_banded

# Kernel launches so far, counted where the wrapper launches its kernel.
LAUNCHES = 0

# measured on the H100 (PERF.md, chip_sweep.py): 8 x 240 tiles.  At the
# flagship a 240-column strip reads 482 source columns, four whole y-pass
# groups of 128 (256 columns read 514: a fifth group for 2 columns), and
# 1920 columns make 8 equal strips
TILE_Y = 8                   # dst rows per row tile, at most
TILE_X = 240                 # dst columns per strip, at most
SMEM_TARGET = 112 * 1024     # bytes of dynamic shared memory a block aims at
_THREADS = 256               # threads per block of the staged form
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2}

# bounded: each plan holds its host tables plus one device copy per device
_PLAN_CACHE = LruDict(16, max_bytes=256 << 20, name="cuda_apply.plan")


def _host(a, dtype) -> np.ndarray:
    """A band table as a host numpy array of ``dtype`` (no copy if it is)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=dtype)


def table_on(t, dtype, device) -> torch.Tensor:
    """A band table (host array or tensor on any device) as a ``dtype``
    tensor on ``device``; a tensor already there is used as it is."""
    if isinstance(t, torch.Tensor):
        return t.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(t), dtype=dtype, device=device)


def _resolve_out_dtype(in_dtype: torch.dtype, out_dtype=None) -> torch.dtype:
    """The output dtype for frames of ``in_dtype`` (pallas_apply.py:514-517)."""
    if out_dtype is not None:
        return out_dtype
    return in_dtype if in_dtype in _DTYPE_CODES else torch.float32


def check_inputs(frames: torch.Tensor, y_start, y_w, x_start, x_w,
                 out_dtype=None):
    """The checks and conversions both separable kernel wrappers share.

    ``frames`` is a contiguous (F, H, W) tensor; a dtype the kernels do
    not read is cast to f32.  Returns (frames, out_dtype, ys, yw, xs, xw)
    with the band tables as host int32 starts and f32 weights.
    """
    if frames.ndim != 3:
        raise ValueError(f"frames must be (F, H, W) or (H, W), got shape "
                         f"{tuple(frames.shape)}")
    if not frames.is_contiguous():
        raise ValueError("frames must be contiguous")
    if frames.dtype.is_complex or frames.dtype == torch.bool:
        raise TypeError(f"unsupported frame dtype {frames.dtype}")
    out_dtype = _resolve_out_dtype(frames.dtype, out_dtype)
    if frames.dtype not in _DTYPE_CODES:
        frames = frames.to(torch.float32)   # pallas_apply.py:583-584
    ys, yw = _host(y_start, np.int32), _host(y_w, np.float32)
    xs, xw = _host(x_start, np.int32), _host(x_w, np.float32)
    if yw.ndim != 2 or xw.ndim != 2 or ys.shape != yw.shape[:1] \
            or xs.shape != xw.shape[:1]:
        raise ValueError("band tables must be start (n,) and weights (n, k)")
    return frames, out_dtype, ys, yw, xs, xw


def _tiles(starts: np.ndarray, k: int, tile: int):
    """(base per tile, common span) of a band's dst tiles of ``tile``."""
    edges = np.arange(0, starts.shape[0], tile)
    base = np.minimum.reduceat(starts, edges)
    span = int((np.maximum.reduceat(starts, edges) + k - base).max())
    return base, span


def band_smem(TY: int, TX: int, SY: int, SX: int, ky: int,
              elem: int = 4) -> int:
    """Bytes of shared memory of a staged block of csrc/band_apply.cuh
    (``make_geo``) for ``elem``-byte pixels in and out, bounded from above
    over every row stride: the raw source window, a zero row, the f32
    y-pass rows (TY, SX), the tile's tap table (TY, ky) and the output
    tile.  Each staged row's pitch is its bytes + 32, rounded to the row
    stride mod 16 (<= + 47)."""
    def up16(n):
        return -(-n // 16) * 16
    pitch_in, pitch_out = SX * elem + 47, TX * elem + 47
    return (up16(32 + SY * pitch_in) + up16(pitch_in + 32)
            + up16(4 * TY * SX) + up16(8 * TY * ky)
            + up16(32 + TY * pitch_out))


def band_plan(ys: np.ndarray, xs: np.ndarray, ky: int, kx: int, *,
              tile_y: int, tile_x: int, smem_target: int,
              smem_limit: int = SMEM_LIMIT) -> Optional[dict]:
    """Tile plan of the staged form of both separable kernels.

    Returns dict(TY, TX, SY, SX, nty, ntx, smem, row_base, col_base):
    every tap of dst row i lies in source rows [row_base[i // TY], +SY)
    and every tap of dst column j in columns [col_base[j // TX], +SX); a
    block takes one row tile of one strip.  Starts need not be monotone
    (flipped bands of the folded quadrants decrease, clamped starts
    repeat).  TX halves, then TY (the larger first), from ``tile_y`` x
    ``tile_x`` until ``band_smem`` fits ``smem_target``; at 1 x 1 the plan
    takes up to ``smem_limit``.  None where even that does not fit.
    """
    ys64, xs64 = ys.astype(np.int64), xs.astype(np.int64)
    Hd, Wd = int(ys64.shape[0]), int(xs64.shape[0])
    # a strip's columns are owned by a block's threads (band_apply.cuh)
    TY, TX = max(1, min(tile_y, Hd)), max(1, min(tile_x, Wd, _THREADS))
    while True:
        row_base, SY = _tiles(ys64, ky, TY)
        col_base, SX = _tiles(xs64, kx, TX)
        smem = band_smem(TY, TX, SY, SX, ky)
        if smem <= smem_target:
            break
        if TX > 1 and TX >= TY:
            TX //= 2
        elif TY > 1:
            TY //= 2
        else:
            break
    if smem > smem_limit:
        return None
    return dict(TY=TY, TX=TX, SY=SY, SX=SX, nty=-(-Hd // TY),
                ntx=-(-Wd // TX), smem=smem,
                row_base=row_base.astype(np.int32),
                col_base=col_base.astype(np.int32))


def plan_separable(ys: np.ndarray, xs: np.ndarray, ky: int, kx: int,
                   smem_target: int = SMEM_TARGET) -> Optional[dict]:
    """Kernel 1's tile plan (``band_plan`` from TILE_Y x TILE_X), or None
    for a band pair that kernel 1 cannot take (it goes to kernel 2)."""
    return band_plan(ys, xs, ky, kx, tile_y=TILE_Y, tile_x=TILE_X,
                     smem_target=smem_target)


def _plan_for(ys, yw, xs, xw):
    """Cached plan + host tables for one set of band tables; the plan of
    a band pair that kernel 1 cannot take is ``{"kernel_2d": True}``."""
    key = (array_digest(ys), array_digest(yw), array_digest(xs),
           array_digest(xw))
    plan = _PLAN_CACHE.get(key)
    if plan is None:
        with build_span("build.band_plan"):
            plan = plan_separable(ys, xs, yw.shape[1], xw.shape[1])
        if plan is None:
            plan = {"kernel_2d": True}
        else:
            plan["kernel_2d"] = False
            plan["tables"] = (ys, yw, xs, xw, plan["row_base"],
                              plan["col_base"])
            plan["dev"] = {}
        _PLAN_CACHE.put(key, plan)
    return plan


def _device_tables(plan, device: torch.device, pinned: bool = False):
    """The plan's tables on ``device``, uploaded once and kept on the plan
    (``pinned``: see ``utils.device.upload``)."""
    device = torch.device(device)
    dev = plan["dev"].get(device)
    if dev is None:
        with build_span("build.upload"):
            dev = tuple(upload(t, device, pinned=pinned)
                        for t in plan["tables"])
        plan["dev"][device] = dev
    return dev


def apply_separable_plain(frames: torch.Tensor, y_start, y_w, x_start, x_w,
                          *, out_dtype=None) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on ``frames``' device.

    ``apply_separable_banded`` in f32 followed by the kernel's cast or
    quantise (round half to even, saturate) to the output dtype.  Tables
    may be host arrays or tensors (on any device; tensors already on
    ``frames``' device are used as they are).
    """
    out_dtype = _resolve_out_dtype(frames.dtype, out_dtype)
    dev = frames.device
    out = apply_separable_banded(
        frames, table_on(y_start, torch.int64, dev),
        table_on(y_w, torch.float32, dev),
        table_on(x_start, torch.int64, dev),
        table_on(x_w, torch.float32, dev))
    if out_dtype == torch.uint8:
        out = out.round().clamp(0.0, 255.0)
    return out.to(out_dtype)


def apply_separable_kernel(frames: torch.Tensor, y_start, y_w, x_start, x_w,
                           *, out_dtype=None, out=None) -> torch.Tensor:
    """Separable banded apply: (F, H, W) -> (F, Hd, Wd); (H, W) -> (Hd, Wd).

    Band tables are host arrays (numpy, or CPU tensors): the planner needs
    their values, and their device copies are cached by content.  A band
    pair whose one-pixel window exceeds the card's shared memory runs on
    kernel 2 (``cuda_apply_2d.apply_separable_kernel_2d``, precision
    'auto': IEEE f32, the same function and dtypes).  Kernel 1 clamps taps
    outside the image to the edge pixel and kernel 2 reads 0 there; such
    taps carry zero weight, so the two agree for finite input.  ``out``,
    if given, is a contiguous tensor of the output's shape, dtype and
    device that receives the result (the kernels write every element).
    """
    global LAUNCHES
    if not isinstance(frames, torch.Tensor):
        raise TypeError(f"frames must be a torch.Tensor, got {type(frames)}")
    if frames.ndim == 2:
        return apply_separable_kernel(
            frames[None], y_start, y_w, x_start, x_w, out_dtype=out_dtype,
            out=None if out is None else out[None])[0]
    frames, out_dtype, ys, yw, xs, xw = check_inputs(
        frames, y_start, y_w, x_start, x_w, out_dtype)

    F, H, W = frames.shape
    Hd, ky = yw.shape
    Wd, kx = xw.shape
    if out is not None:
        out_buffer(out, (F, Hd, Wd), out_dtype, frames.device)  # checks it
    if frames.device.type == "cpu":
        res = apply_separable_plain(frames, ys, yw, xs, xw,
                                    out_dtype=out_dtype)
        return res if out is None else out.copy_(res)
    if frames.device.type != "cuda":
        raise ValueError(f"no kernel for device {frames.device}")

    kernel_out = out_dtype if out_dtype in _DTYPE_CODES else torch.float32
    if out is not None and kernel_out != out_dtype:
        raise ValueError(f"out= takes a float32, bfloat16 or uint8 tensor, "
                         f"not {out_dtype}")
    if F * Hd * Wd == 0:
        return out_buffer(out, (F, Hd, Wd), out_dtype, frames.device)
    if H == 0 or W == 0:
        raise ValueError("frames have an empty spatial axis")
    plan = _plan_for(ys, yw, xs, xw)
    if plan["kernel_2d"]:
        from . import cuda_apply_2d
        return cuda_apply_2d.apply_separable_kernel_2d(
            frames, ys, yw, xs, xw, precision="auto", out_dtype=out_dtype,
            out=out)
    out = out_buffer(out, (F, Hd, Wd), kernel_out, frames.device)
    d_ys, d_yw, d_xs, d_xw, d_rb, d_cb = _device_tables(plan, frames.device)
    fn = _build.load(_build.SEPARABLE).aainterp_separable_apply
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream(frames.device).cuda_stream
        with span("aa.launch.separable"):
            rc = fn(frames.data_ptr(), out.data_ptr(), d_ys.data_ptr(),
                    d_yw.data_ptr(), d_xs.data_ptr(), d_xw.data_ptr(),
                    d_rb.data_ptr(), d_cb.data_ptr(), F, H, W, Hd, Wd, ky,
                    kx, plan["TY"], plan["TX"], plan["SY"], plan["SX"],
                    _DTYPE_CODES[frames.dtype], _DTYPE_CODES[kernel_out],
                    stream)
    if rc != 0:
        raise RuntimeError(f"separable_apply kernel launch failed: CUDA error "
                           f"{rc} (F={F}, H={H}, W={W}, Hd={Hd}, Wd={Wd}, "
                           f"ky={ky}, kx={kx}, plan TY={plan['TY']} "
                           f"TX={plan['TX']} SY={plan['SY']} "
                           f"SX={plan['SX']})")
    LAUNCHES += 1
    return out if kernel_out == out_dtype else out.to(out_dtype)
