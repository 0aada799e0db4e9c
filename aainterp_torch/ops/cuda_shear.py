"""Exact rotated apply on the CUDA kernels ``csrc/ell_shear.cu``.

Counterpart of ``aainterp/ops/pallas_shear.py`` (``make_pallas_shear_apply``
and its kernels ``_build_vshear``, ``_build_hshear``, ``_build_contract``):
(F, qH, qW) -> (F, Hd, Wd) through two integer shears and a window
contraction, with the exact ELL weights re-indexed by
``ops.shear_apply.build_shear_plan``.

* ``ShearKernelPlan`` is the host plan in the layout the kernels take:
  ``gy`` (qW,), ``hx`` (TH,), ``ry0`` (Hd,), ``cx0`` (Wd,) int32 and the
  weights tap-major, ``w2`` (Ka*Kb, Hd, Wd) f32.  None of the TPU's
  8/16/128 alignments, one-hot selectors or residual-roll bases remain:
  a GPU thread reads any address.  Each plan uploads its tables to a
  device once and keeps them.
* ``kernel_plan(op)`` builds it from an EllOperator, cached by table
  content (the counterpart of ``aainterp/api.py::_pallas_shear_plan``;
  in memory only).  Geometries that ``build_shear_plan`` rejects raise
  ValueError, and the rejection is cached too.
* ``vshear_kernel``, ``hshear_kernel``, ``contract_kernel`` are the
  wrappers, each counting its launches in ``LAUNCHES``.  A CUDA tensor
  launches the kernel or raises — there is no fallback.  A CPU tensor
  takes the plain version (``vshear_plain``, ``hshear_plain``,
  ``contract_plain``, torch indexing).
* ``apply_ell_shear_kernel`` / ``apply_ell_shear_plain`` compose them.

Dtype contract (pallas_shear.py:789-792): bf16 and f32 frames give that
dtype out; any other real dtype is cast to f32 first and gives f32.
Accumulation is f32 with f32 weights.  Both shears write every element of
their output (zeros where the source index leaves the plane), so a
zero-weight tap never meets an uninitialised value.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from .. import _build
from ..utils.digest import array_digest
from ..utils.lru import LruDict
from .shear_apply import build_shear_plan
from .weights import EllOperator

# Kernel launches so far, counted where each wrapper launches its kernel.
LAUNCHES = {"vshear": 0, "hshear": 0, "contract": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# bounded: each plan holds its f32 weight table (196 MB at 2048^2/30 deg)
# on the host and once more per device
_PLAN_CACHE = LruDict(4, max_bytes=4 << 30)


@dataclasses.dataclass(eq=False)
class ShearKernelPlan:
    """Host tables of the three kernels for one EllOperator."""

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
    dev: Dict[torch.device, Dict[str, torch.Tensor]] = dataclasses.field(
        default_factory=dict, repr=False)

    def tables(self, device: torch.device) -> Dict[str, torch.Tensor]:
        """The plan's tables on ``device``, uploaded once and kept."""
        device = torch.device(device)
        hit = self.dev.get(device)
        if hit is None:
            hit = {name: torch.from_numpy(getattr(self, name)).to(device)
                   for name in ("gy", "hx", "ry0", "cx0", "w2")}
            self.dev[device] = hit
        return hit


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
        w2=w2)


def kernel_plan(op: EllOperator) -> ShearKernelPlan:
    """Cached ``plan_from_operator``: keyed by the operator's table
    content; a rejected geometry is cached as its ValueError message."""
    key = (array_digest(op.weights), array_digest(op.base),
           op.weights.shape, op.spec.qrot_shape)
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


def contract_plain(t: torch.Tensor, plan: ShearKernelPlan, *,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """out[f, dy, dx] = sum_ab w2[a*Kb+b, dy, dx] * T[f, ry0[dy]+a, cx0[dx]+b]
    in f32 (taps a-major, then b), cast to ``out_dtype`` (default: T's
    dtype for bf16/f32, else f32)."""
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
            acc = acc + tabs["w2"][a * plan.Kb + b] * vals.to(torch.float32)
    return acc.to(out_dtype or _out_dtype(t.dtype))


def apply_ell_shear_plain(q: torch.Tensor, plan: ShearKernelPlan, *,
                          out_dtype: Optional[torch.dtype] = None
                          ) -> torch.Tensor:
    """The three plain stages: (F, qH, qW) -> (F, Hd, Wd); (qH, qW) ->
    (Hd, Wd).  Frames of a dtype other than bf16/f32 are cast to f32."""
    if q.ndim == 2:
        return apply_ell_shear_plain(q[None], plan, out_dtype=out_dtype)[0]
    q = q.to(_out_dtype(q.dtype))
    return contract_plain(hshear_plain(vshear_plain(q, plan), plan), plan,
                          out_dtype=out_dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def vshear_kernel(q: torch.Tensor, plan: ShearKernelPlan, *,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Vertical shear (F, qH, qW) -> (F, TH, qW) on the CUDA kernel; a CPU
    tensor takes ``vshear_plain``.  ``out`` may be given (any contents:
    every element is written)."""
    _check_frames(q, (plan.qH, plan.qW), "q")
    if q.device.type == "cpu":
        return vshear_plain(q, plan, out=out)
    _cuda_frames(q, "q")
    F = q.shape[0]
    out = _out_buffer(out, (F, plan.TH, plan.qW), q)
    fn = _build.load(_build.ELL_SHEAR).aainterp_vshear
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _launch("vshear", fn, (
            q.data_ptr(), out.data_ptr(), plan.tables(q.device)["gy"].data_ptr(),
            F, plan.qH, plan.qW, plan.TH, q.element_size(), stream),
            f"F={F}, qH={plan.qH}, qW={plan.qW}, TH={plan.TH}")
    return out


def hshear_kernel(s: torch.Tensor, plan: ShearKernelPlan, *,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Horizontal shear (F, TH, qW) -> (F, TH, TW) on the CUDA kernel; a
    CPU tensor takes ``hshear_plain``."""
    _check_frames(s, (plan.TH, plan.qW), "S")
    if s.device.type == "cpu":
        return hshear_plain(s, plan, out=out)
    _cuda_frames(s, "S")
    F = s.shape[0]
    out = _out_buffer(out, (F, plan.TH, plan.TW), s)
    fn = _build.load(_build.ELL_SHEAR).aainterp_hshear
    with torch.cuda.device(s.device):
        stream = torch.cuda.current_stream(s.device).cuda_stream
        _launch("hshear", fn, (
            s.data_ptr(), out.data_ptr(), plan.tables(s.device)["hx"].data_ptr(),
            F, plan.TH, plan.qW, plan.TW, s.element_size(), stream),
            f"F={F}, TH={plan.TH}, qW={plan.qW}, TW={plan.TW}")
    return out


def contract_kernel(t: torch.Tensor, plan: ShearKernelPlan) -> torch.Tensor:
    """Window contraction (F, TH, TW) -> (F, Hd, Wd) in T's dtype on the
    CUDA kernel; a CPU tensor takes ``contract_plain``."""
    _check_frames(t, (plan.TH, plan.TW), "T")
    if t.device.type == "cpu":
        return contract_plain(t, plan)
    _cuda_frames(t, "T")
    F = t.shape[0]
    out = torch.empty((F, plan.Hd, plan.Wd), dtype=t.dtype, device=t.device)
    tabs = plan.tables(t.device)
    fn = _build.load(_build.ELL_SHEAR).aainterp_contract
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        _launch("contract", fn, (
            t.data_ptr(), out.data_ptr(), tabs["ry0"].data_ptr(),
            tabs["cx0"].data_ptr(), tabs["w2"].data_ptr(),
            F, plan.TH, plan.TW, plan.Hd, plan.Wd, plan.Ka, plan.Kb,
            _DTYPE_CODES[t.dtype], stream),
            f"F={F}, TH={plan.TH}, TW={plan.TW}, Hd={plan.Hd}, "
            f"Wd={plan.Wd}, Ka={plan.Ka}, Kb={plan.Kb}")
    return out


def apply_ell_shear_kernel(q: torch.Tensor,
                           plan: ShearKernelPlan) -> torch.Tensor:
    """The rotated apply on the three kernels: (F, qH, qW) -> (F, Hd, Wd);
    (qH, qW) -> (Hd, Wd).  Frames of a dtype other than bf16/f32 are cast
    to f32 first (pallas_shear.py:789-792)."""
    if not isinstance(q, torch.Tensor):
        raise TypeError(f"frames must be a torch.Tensor, got {type(q)}")
    if q.ndim == 2:
        return apply_ell_shear_kernel(q[None], plan)[0]
    if q.dtype.is_complex or q.dtype == torch.bool:
        raise TypeError(f"unsupported frame dtype {q.dtype}")
    q = q.to(_out_dtype(q.dtype)).contiguous()
    return contract_kernel(hshear_kernel(vshear_kernel(q, plan), plan), plan)
