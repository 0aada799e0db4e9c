"""Separable banded apply on the CUDA kernel ``csrc/separable_apply.cu``.

Counterpart of ``aainterp/ops/pallas_apply.py::apply_separable_pallas``
and its kernel ``_build_separable_kernel``: (F, H, W) -> (F, Hd, Wd).

* ``plan_separable`` is the host planner: per dst column tile it gives the
  first source column ``c0`` and the common span ``S`` of source columns
  the tile reads, and it halves the tile width (then height) until the
  tile's (TY, S) f32 y-pass fits the shared-memory budget.  TX = TY = 1
  fits any band narrower than the budget, so every shape runs (the TPU
  kernel's 128-lane and full-width-band limits do not exist here).
* ``apply_separable_kernel`` is the wrapper.  A CUDA tensor launches the
  kernel or raises — there is no fallback.  A CPU tensor takes the plain
  version, ``apply_separable_plain``.
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

import numpy as np
import torch

from .. import _build
from ..utils.digest import array_digest
from ..utils.lru import LruDict
from .apply import apply_separable_banded

# Kernel launches so far, counted where the wrapper launches its kernel.
LAUNCHES = 0

TILE_Y = 16
TILE_X = 128
SMEM_BUDGET = 96 * 1024  # bytes of dynamic shared memory per block
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2}

# bounded: each plan holds its host tables plus one device copy per device
_PLAN_CACHE = LruDict(16, max_bytes=256 << 20)


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


def plan_separable(ys: np.ndarray, xs: np.ndarray, ky: int, kx: int,
                   smem_budget: int = SMEM_BUDGET) -> dict:
    """Tile plan for the kernel: TY, TX, span S and per-column-tile c0.

    ``c0[t]`` is the least band start of column tile t and ``S`` the
    largest ``max(start) + kx - c0`` over the tiles, so every tap of every
    tile lies inside its span.  Starts need not be monotone (flipped bands
    of the folded quadrants decrease).  TX halves from TILE_X, then TY
    from TILE_Y, until TY * S * 4 bytes fit ``smem_budget``.
    """
    Hd, Wd = int(ys.shape[0]), int(xs.shape[0])
    TY, TX = max(1, min(TILE_Y, Hd)), TILE_X
    xs64 = xs.astype(np.int64)
    while True:
        tiles = np.arange(0, Wd, TX)
        c0 = np.minimum.reduceat(xs64, tiles)
        S = int((np.maximum.reduceat(xs64, tiles) + kx - c0).max())
        if TY * S * 4 <= smem_budget:
            break
        if TX > 1:
            TX //= 2
        elif TY > 1:
            TY //= 2
        else:
            raise ValueError(
                f"a band of {kx} source columns needs {S * 4} bytes of shared "
                f"memory for one dst pixel, above the {smem_budget}-byte budget")
    return dict(TY=TY, TX=TX, S=S, nty=-(-Hd // TY), ntx=len(tiles),
                col_base=c0.astype(np.int32))


def _plan_for(ys, yw, xs, xw):
    """Cached plan + host tables for one set of band tables."""
    key = (array_digest(ys), array_digest(yw), array_digest(xs),
           array_digest(xw))
    plan = _PLAN_CACHE.get(key)
    if plan is None:
        plan = plan_separable(ys, xs, yw.shape[1], xw.shape[1])
        plan["tables"] = (ys, yw, xs, xw, plan["col_base"])
        plan["dev"] = {}
        _PLAN_CACHE.put(key, plan)
    return plan


def _device_tables(plan, device: torch.device):
    """The plan's tables on ``device``, uploaded once and kept on the plan."""
    dev = plan["dev"].get(device)
    if dev is None:
        dev = tuple(torch.from_numpy(np.ascontiguousarray(t)).to(device)
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
                           *, out_dtype=None) -> torch.Tensor:
    """Separable banded apply: (F, H, W) -> (F, Hd, Wd); (H, W) -> (Hd, Wd).

    Band tables are host arrays (numpy, or CPU tensors): the planner needs
    their values, and their device copies are cached by content.
    """
    global LAUNCHES
    if not isinstance(frames, torch.Tensor):
        raise TypeError(f"frames must be a torch.Tensor, got {type(frames)}")
    if frames.ndim == 2:
        return apply_separable_kernel(frames[None], y_start, y_w, x_start,
                                      x_w, out_dtype=out_dtype)[0]
    frames, out_dtype, ys, yw, xs, xw = check_inputs(
        frames, y_start, y_w, x_start, x_w, out_dtype)

    if frames.device.type == "cpu":
        return apply_separable_plain(frames, ys, yw, xs, xw,
                                     out_dtype=out_dtype)
    if frames.device.type != "cuda":
        raise ValueError(f"no kernel for device {frames.device}")

    F, H, W = frames.shape
    Hd, ky = yw.shape
    Wd, kx = xw.shape
    kernel_out = out_dtype if out_dtype in _DTYPE_CODES else torch.float32
    out = torch.empty((F, Hd, Wd), dtype=kernel_out, device=frames.device)
    if out.numel() == 0:
        return out.to(out_dtype)
    if H == 0 or W == 0:
        raise ValueError("frames have an empty spatial axis")
    plan = _plan_for(ys, yw, xs, xw)
    d_ys, d_yw, d_xs, d_xw, d_c0 = _device_tables(plan, frames.device)
    fn = _build.load(_build.SEPARABLE).aainterp_separable_apply
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream(frames.device).cuda_stream
        rc = fn(frames.data_ptr(), out.data_ptr(), d_ys.data_ptr(),
                d_yw.data_ptr(), d_xs.data_ptr(), d_xw.data_ptr(),
                d_c0.data_ptr(), F, H, W, Hd, Wd, ky, kx,
                plan["TY"], plan["TX"], plan["S"],
                _DTYPE_CODES[frames.dtype], _DTYPE_CODES[kernel_out], stream)
    if rc != 0:
        raise RuntimeError(f"separable_apply kernel launch failed: CUDA error "
                           f"{rc} (F={F}, H={H}, W={W}, Hd={Hd}, Wd={Wd}, "
                           f"ky={ky}, kx={kx}, plan TY={plan['TY']} "
                           f"TX={plan['TX']} S={plan['S']})")
    LAUNCHES += 1
    return out if kernel_out == out_dtype else out.to(out_dtype)
