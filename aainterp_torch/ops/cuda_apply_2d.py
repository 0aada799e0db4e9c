"""2-D banded-tile separable apply on the CUDA kernel
``csrc/separable_apply_2d.cu``.

Counterpart of ``aainterp/ops/pallas_apply.py::apply_separable_pallas_2d``
and its kernel ``_build_separable_kernel_2d``: (F, H, W) -> (F, Hd, Wd),

    out[f, i, j] = cast(sum_b wx[j, b] * (sum_a wy[i, a]
                                          * src[f, ys[i] + a, xs[j] + b]))

with f32 sums, the y pass first.  It serves the band-operator family
(``regrid.apply_band_operators`` and the area-resize front doors), whose
bands are wide (the config-5 regrid: 12 taps at a 10x ratio).

* ``plan_separable_2d`` is the host planner: ``cuda_apply.band_plan``
  (shared with kernel 1) from 32 x 32 tiles, halving TX, then TY (the
  larger first), until the block (the raw source window, the f32 y-pass
  rows, the tile's tap table and an output tile; ``cuda_apply.band_smem``
  at f32) fits ``SMEM_TARGET``; at one dst pixel per tile it accepts up to
  the card's 227 KB limit.  Each block takes one row tile of one column
  strip.  Beyond the limit the plan is the kernel's direct form
  (one thread per output element, taps read from device memory, the same
  bits), so no band pair is rejected.  None of the TPU kernel's 8/32/128
  alignments or padding remain.
* ``make_plan`` adds the host tables to a plan; each plan uploads them to a
  device once (``device_tables``).  ``kernel_plan`` caches plans by table
  content, for callers that hold only the tables.
* ``apply_separable_kernel_2d`` is the wrapper.  A CUDA tensor launches
  the kernel or raises, with no fallback, and counts the launch in
  ``LAUNCHES``.  A CPU tensor takes the plain version,
  ``apply_separable_2d_plain``.

Precision (pallas_apply.py:798-846, :1022-1028), as launch modes:

* 'auto', 'high', 'highest': IEEE f32 products and sums for every input
  dtype.  (On the TPU, 'auto' runs one bf16 MXU pass for bf16/u8 input,
  which truncates the f32 weights; that is an artefact of Mosaic's dot
  lowering, not the function, and is not copied.  The JAX package's own
  CPU tests pin the exact reading.)
* 'default': bf16 operands with f32 sums: the weights, the pixels and the
  y-pass intermediate are rounded to bf16 (nearest even) before each
  product.  This is the TPU's one-pass meaning.
* 'bf16x3': each operand split into hi = bf16(x) and lo = bf16(x - hi);
  three products hi*hi + hi*lo + lo*hi per contraction, summed as three
  dots (``_split_bf16_np`` / ``_dot_bf16x3``).  f32 input only: bf16 and
  u8 input take 'default', as the JAX package does.

Dtypes (pallas_apply.py:1020-1021, :1093-1095): bf16, f32 and uint8 frames
give that dtype out by default; other real dtypes are cast to f32 and give
f32.  uint8 output rounds half to even and saturates.  An explicit
``out_dtype`` is honoured (f32, bf16, u8 written by the kernel; others are
a cast of its f32 output).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..utils.device import SMEM_LIMIT, out_buffer, upload
from ..utils.digest import array_digest
from ..utils.lru import LruDict
from .apply import _band_index, apply_separable_banded
from .cuda_apply import (_DTYPE_CODES, _resolve_out_dtype, band_plan,
                         check_inputs, table_on)

# Kernel launches so far, counted where the wrapper launches its kernel.
LAUNCHES = 0

PRECISIONS = ("auto", "default", "high", "highest", "bf16x3")
_MODES = {"auto": 0, "high": 0, "highest": 0, "default": 1, "bf16x3": 2}
TILE = 32
SMEM_TARGET = 112 * 1024        # bytes of dynamic shared memory a block aims at

# bounded: each plan holds its host tables plus one device copy per device
_PLAN_CACHE = LruDict(32, max_bytes=256 << 20)


def check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be auto/default/high/highest/"
                         f"bf16x3, got {precision!r}")


def _mode(precision: str, in_dtype: torch.dtype) -> int:
    """The kernel's arithmetic mode for ``precision`` on frames of
    ``in_dtype`` (after the f32 cast of other dtypes)."""
    check_precision(precision)
    mode = _MODES[precision]
    if mode == 2 and in_dtype != torch.float32:
        mode = 1     # bf16/u8 operands: 'bf16x3' is 'default' (:1027-1028)
    return mode


def plan_separable_2d(ys: np.ndarray, xs: np.ndarray, ky: int, kx: int,
                      smem_target: int = SMEM_TARGET,
                      smem_limit: int = SMEM_LIMIT) -> dict:
    """Tile plan of the 2-D kernel (module docstring).

    Returns dict(direct, TY, TX, SY, SX, nty, ntx, smem, row_base,
    col_base): every tap of dst row i lies in rows [row_base[i // TY], +SY)
    and every tap of dst column j in columns [col_base[j // TX], +SX); a
    block takes one row tile of one strip.  Starts need not be monotone
    (descending sin-lat bands are reversed, clamped starts repeat).  Where
    one dst pixel's block exceeds ``smem_limit`` bytes the plan is the
    direct form: ``direct`` True, 1 x 1 tiles, spans ky x kx and no shared
    memory.
    """
    plan = band_plan(ys, xs, ky, kx, tile_y=TILE, tile_x=TILE,
                     smem_target=smem_target, smem_limit=smem_limit)
    if plan is not None:
        return dict(plan, direct=False)
    Hd, Wd = int(ys.shape[0]), int(xs.shape[0])
    return dict(direct=True, TY=1, TX=1, SY=int(ky), SX=int(kx), nty=Hd,
                ntx=Wd, smem=0,
                row_base=np.asarray(ys, np.int32).copy(),
                col_base=np.asarray(xs, np.int32).copy())


def make_plan(ys: np.ndarray, yw: np.ndarray, xs: np.ndarray,
              xw: np.ndarray) -> dict:
    """``plan_separable_2d`` of host tables (int32 starts, f32 weights),
    keeping the tables for ``device_tables``."""
    plan = plan_separable_2d(ys, xs, yw.shape[1], xw.shape[1])
    plan["tables"] = (ys, yw, xs, xw, plan["row_base"], plan["col_base"])
    plan["dev"] = {}
    return plan


def kernel_plan(ys: np.ndarray, yw: np.ndarray, xs: np.ndarray,
                xw: np.ndarray) -> dict:
    """``make_plan``, cached by the tables' content."""
    key = (array_digest(ys), array_digest(yw), array_digest(xs),
           array_digest(xw))
    plan = _PLAN_CACHE.get(key)
    if plan is None:
        plan = make_plan(ys, yw, xs, xw)
        _PLAN_CACHE.put(key, plan)
    return plan


def device_tables(plan, device: torch.device, pinned: bool = False):
    """The plan's tables (ys, yw, xs, xw, row_base, col_base) on
    ``device``, uploaded once and kept on the plan (``pinned``: see
    ``utils.device.upload``)."""
    device = torch.device(device)
    dev = plan["dev"].get(device)
    if dev is None:
        dev = tuple(upload(t, device, pinned=pinned) for t in plan["tables"])
        plan["dev"][device] = dev
    return dev


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to bf16, nearest even, and back to f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _split(x: torch.Tensor):
    """(hi, lo) with hi = bf16(x), lo = bf16(x - hi), both as f32."""
    hi = _bf16(x)
    return hi, _bf16(x - hi)


def _rows(q: torch.Tensor, start, w) -> torch.Tensor:
    """y pass, taps summed one after another from 0 (the kernel's order):
    (..., H, W) -> (..., Hd, W)."""
    Hd, k = w.shape
    g = q.index_select(-2, _band_index(start, k, q.shape[-2]).reshape(-1))
    g = g.reshape(q.shape[:-2] + (Hd, k, q.shape[-1]))
    acc = g[..., 0, :] * w[:, 0, None]
    for a in range(1, k):
        acc = acc + g[..., a, :] * w[:, a, None]
    return acc


def _cols(t: torch.Tensor, start, w) -> torch.Tensor:
    """x pass in the kernel's order: (..., Hd, W) -> (..., Hd, Wd)."""
    Wd, k = w.shape
    g = t.index_select(-1, _band_index(start, k, t.shape[-1]).reshape(-1))
    g = g.reshape(t.shape[:-1] + (Wd, k))
    acc = g[..., 0] * w[:, 0]
    for b in range(1, k):
        acc = acc + g[..., b] * w[:, b]
    return acc


def apply_separable_2d_plain(frames: torch.Tensor, y_start, y_w, x_start,
                             x_w, *, precision: str = "auto",
                             out_dtype=None) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on ``frames``' device.

    The f32 modes are ``apply_separable_banded`` in f32.  'default' and
    'bf16x3' round or split the operands as the kernel does and sum the
    taps in its order; their products are exact in f32, so they equal the
    kernel bit for bit.  Then the kernel's cast (round half to even and
    saturate for u8).  Tables may be host arrays or tensors.
    """
    out_dtype = _resolve_out_dtype(frames.dtype, out_dtype)
    q = frames.to(torch.float32)
    mode = _mode(precision, frames.dtype if frames.dtype in _DTYPE_CODES
                 else torch.float32)
    dev = frames.device
    ys, xs = (table_on(t, torch.int64, dev) for t in (y_start, x_start))
    yw, xw = (table_on(t, torch.float32, dev) for t in (y_w, x_w))
    if mode == 0:
        out = apply_separable_banded(q, ys, yw, xs, xw)
    elif mode == 1:
        t = _bf16(_rows(_bf16(q), ys, _bf16(yw)))
        out = _cols(t, xs, _bf16(xw))
    else:
        # _dot_bf16x3's three sums: y pass (w_hi.x_hi + w_hi.x_lo) +
        # w_lo.x_hi, x pass (t_hi.w_hi + t_hi.w_lo) + t_lo.w_hi
        (qh, ql), (wh, wl) = _split(q), _split(yw)
        t = (_rows(qh, ys, wh) + _rows(ql, ys, wh)) + _rows(qh, ys, wl)
        (th, tl), (wh, wl) = _split(t), _split(xw)
        out = (_cols(th, xs, wh) + _cols(th, xs, wl)) + _cols(tl, xs, wh)
    if out_dtype == torch.uint8:
        out = out.round().clamp(0.0, 255.0)
    return out.to(out_dtype)


def apply_separable_kernel_2d(frames: torch.Tensor, y_start, y_w, x_start,
                              x_w, *, precision: str = "auto",
                              out_dtype=None, out=None,
                              plan=None) -> torch.Tensor:
    """2-D banded-tile apply: (F, H, W) -> (F, Hd, Wd); (H, W) -> (Hd, Wd).

    Band tables are host arrays (numpy, or CPU tensors): the planner needs
    their values, and their device copies are cached by content.  ``plan``,
    if given, is ``make_plan`` of these tables, held by the caller; the
    content cache is then not consulted.  ``out``, if given, is a
    contiguous tensor of the output's shape, dtype and device that
    receives the result (the kernel writes every element).
    """
    global LAUNCHES
    if not isinstance(frames, torch.Tensor):
        raise TypeError(f"frames must be a torch.Tensor, got {type(frames)}")
    if frames.ndim == 2:
        return apply_separable_kernel_2d(
            frames[None], y_start, y_w, x_start, x_w, precision=precision,
            out_dtype=out_dtype, out=None if out is None else out[None],
            plan=plan)[0]
    # other dtypes are cast to f32, as pallas_apply.py:1020-1021 does
    frames, out_dtype, ys, yw, xs, xw = check_inputs(
        frames, y_start, y_w, x_start, x_w, out_dtype)
    mode = _mode(precision, frames.dtype)

    F, H, W = frames.shape
    Hd, ky = yw.shape
    Wd, kx = xw.shape
    if out is not None:
        out_buffer(out, (F, Hd, Wd), out_dtype, frames.device)  # checks it
    if frames.device.type == "cpu":
        res = apply_separable_2d_plain(frames, ys, yw, xs, xw,
                                       precision=precision,
                                       out_dtype=out_dtype)
        return res if out is None else out.copy_(res)
    if frames.device.type != "cuda":
        raise ValueError(f"no kernel for device {frames.device}")

    kernel_out = out_dtype if out_dtype in _DTYPE_CODES else torch.float32
    if out is not None and kernel_out != out_dtype:
        raise ValueError(f"out= takes a float32, bfloat16 or uint8 tensor, "
                         f"not {out_dtype}")
    out = out_buffer(out, (F, Hd, Wd), kernel_out, frames.device)
    if out.numel() == 0:
        return out.to(out_dtype)
    if H == 0 or W == 0:
        raise ValueError("frames have an empty spatial axis")
    if plan is None:
        plan = kernel_plan(ys, yw, xs, xw)
    d_ys, d_yw, d_xs, d_xw, d_rb, d_cb = device_tables(plan, frames.device)
    # SY = SX = 0 launches the direct form
    SY, SX = (0, 0) if plan["direct"] else (plan["SY"], plan["SX"])
    fn = _build.load(_build.SEPARABLE_2D).aainterp_separable_apply_2d
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream(frames.device).cuda_stream
        rc = fn(frames.data_ptr(), out.data_ptr(), d_ys.data_ptr(),
                d_yw.data_ptr(), d_xs.data_ptr(), d_xw.data_ptr(),
                d_rb.data_ptr(), d_cb.data_ptr(), F, H, W, Hd, Wd, ky, kx,
                plan["TY"], plan["TX"], SY, SX, mode,
                _DTYPE_CODES[frames.dtype], _DTYPE_CODES[kernel_out], stream)
    if rc != 0:
        raise RuntimeError(
            f"separable_apply_2d kernel launch failed: CUDA error {rc} "
            f"(F={F}, H={H}, W={W}, Hd={Hd}, Wd={Wd}, ky={ky}, kx={kx}, "
            f"plan TY={plan['TY']} TX={plan['TX']} SY={plan['SY']} "
            f"SX={plan['SX']} direct={plan['direct']}, "
            f"mode {mode})")
    LAUNCHES += 1
    return out if kernel_out == out_dtype else out.to(out_dtype)
