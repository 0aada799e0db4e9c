"""The 3-pass shear mode on the CUDA kernels ``csrc/shear3_stage.cu``.

Counterpart of ``aainterp/ops/pallas_shear3.py``
(``apply_shear3_pallas``, ``make_shear3_linear`` and the kernels
``_build_y_stage`` / ``_build_x_stage``).  Each kernel runs one whole
pass of a ``Shear3Plan`` in one launch, from the plan's own tables
(``shear3.stage_plan``), one block per tile of the stage's work split
(``Stage.tiles``: each tile's input window, staged in shared memory;
a stage beyond the card's shared memory takes the direct form):
none of the Pallas plan's 128/16 padding, aligned crop lifts, densified
MXU band blocks or bit rolls remain.

* ``ystage_kernel`` / ``xstage_kernel`` are the wrappers, each counting
  its launches in ``LAUNCHES``.  A CUDA tensor launches the kernel or
  raises — there is no fallback.  A CPU tensor takes the plain version
  (``shear3.ystage_plain`` / ``xstage_plain``).
* ``apply_shear3_kernel`` runs a plan's three stages: three launches.
* ``make_shear3_linear`` gives a differentiable apply whose backward runs
  the transposed plan (``shear3.transpose_shear3_plan``) on the same
  kernels: q_bar = P^T(inv_cov * cot), staged in f32.

Dtype contract (pallas_shear3.py:484-491): the stages read bf16, f32 or
uint8; intermediates are bf16 for bf16 and uint8 input and f32 for f32
input; the last stage multiplies by the reciprocal coverage and writes
the input's dtype (uint8 rounds half to even and saturates).  Sums are
f32, in the plain stages' order, with every product rounded before its
add, so a kernel stage equals its plain version bit for bit.  Every
output element is written, zeros included.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import _build
from ..utils.device import out_buffer
from ..utils.log import span
from ..utils.lru import LruDict
from . import shear3 as shear3_ops
from .shear3 import Shear3Plan, StagePlan

# Kernel launches so far, counted where each wrapper launches its kernel.
LAUNCHES = {"ystage": 0, "xstage": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2}


def _stage_kernel(x: torch.Tensor, sp: StagePlan, i: int, axis: str,
                  out_dtype: torch.dtype, out) -> torch.Tensor:
    st = sp.stages[i]
    shear3_ops.check_stage_input(x, st, axis)
    if x.device.type == "cpu":
        plain = (shear3_ops.ystage_plain if axis == "y"
                 else shear3_ops.xstage_plain)
        return plain(x, sp, i, out_dtype=out_dtype, out=out)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if not x.is_contiguous():
        raise ValueError("stage input must be contiguous")
    if out_dtype not in _DTYPE_CODES:
        raise TypeError(f"out_dtype must be one of {tuple(_DTYPE_CODES)}, "
                        f"got {out_dtype}")
    F = x.shape[0]
    out = out_buffer(out, (F,) + st.out_shape, out_dtype, x.device)
    per, cov = sp.tables(x.device)
    t = per[i]
    use_cov = i == len(sp.stages) - 1 and cov is not None
    lib = _build.load(_build.SHEAR3_STAGE)
    fn = lib.aainterp_shear3_ystage if axis == "y" \
        else lib.aainterp_shear3_xstage
    tiles = st.tiles
    # TL = TU = 0 launches the direct form
    TL, TU = (0, 0) if tiles.direct else (tiles.TL, tiles.TU)
    name = f"{axis}stage"
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        with span(f"aa.launch.{name}"):
            rc = fn(x.data_ptr(), out.data_ptr(), t["d"].data_ptr(),
                    t["f"].data_ptr(), t["start"].data_ptr(),
                    t["w"].data_ptr(), cov.data_ptr() if use_cov else None,
                    t["win"].data_ptr(), F, st.n_lines, st.n_in, st.n_mid,
                    st.n_t, st.crop, st.n_out, st.K, st.form, TL, TU,
                    tiles.max_win, tiles.max_mid, _DTYPE_CODES[x.dtype],
                    _DTYPE_CODES[out_dtype], stream)
    if rc != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: CUDA error {rc} (F={F}, "
            f"lines={st.n_lines}, n_in={st.n_in}, n_out={st.n_out}, "
            f"form={st.form}, K={st.K}, tile {tiles.TL}x{tiles.TU}, "
            f"direct={tiles.direct})")
    LAUNCHES[name] += 1
    return out


def ystage_kernel(x: torch.Tensor, sp: StagePlan, i: int, *,
                  out_dtype: torch.dtype = torch.float32,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stage ``i`` of ``sp``, a pass along y, on the CUDA kernel:
    (F, n_in, n_lines) -> (F, n_out, n_lines) in ``out_dtype``; a CPU
    tensor takes ``shear3.ystage_plain``.  ``out`` may be given (any
    contents: every element is written)."""
    return _stage_kernel(x, sp, i, "y", out_dtype, out)


def xstage_kernel(x: torch.Tensor, sp: StagePlan, i: int, *,
                  out_dtype: torch.dtype = torch.float32,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stage ``i`` of ``sp``, a pass along x, on the CUDA kernel:
    (F, n_lines, n_in) -> (F, n_lines, n_out); a CPU tensor takes
    ``shear3.xstage_plain``."""
    return _stage_kernel(x, sp, i, "x", out_dtype, out)


def apply_shear3_kernel(q: torch.Tensor, plan: Shear3Plan, *,
                        mid_dtype: torch.dtype = torch.bfloat16,
                        out_dtype: Optional[torch.dtype] = None
                        ) -> torch.Tensor:
    """The pass pipeline on the two stage kernels, one launch per pass:
    (..., qH, qW) -> (..., Hd, Wd).  bf16 intermediates by default; f32
    input stages in f32; the output is in the input's dtype (bf16, f32,
    u8; other dtypes are read as f32 and give f32)."""
    return shear3_ops.run_stages(q, plan, (ystage_kernel, xstage_kernel),
                                 mid_dtype=mid_dtype, out_dtype=out_dtype)


# ----------------------------------------------------------------------
# autograd: backward = the transposed pass pipeline on the same kernels
# ----------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class Shear3Fn:
    """A plan and its adjoint; calling it applies :class:`Shear3Linear`."""

    plan: Shear3Plan
    plan_T: Shear3Plan

    def __call__(self, q: torch.Tensor) -> torch.Tensor:
        if q.dtype == torch.uint8:
            raise TypeError(
                "make_shear3_linear is float-only (u8 round/saturate is not "
                "differentiable); cast to bfloat16/float32")
        return Shear3Linear.apply(q, self)


class Shear3Linear(torch.autograd.Function):
    """The kernel route with the exact adjoint as its backward:
    q_bar = P^T(inv_cov * cot) on the transposed plan, staged in f32, in
    the input's dtype (the counterpart of the custom VJP of
    ``aainterp.ops.pallas_shear3.make_shear3_linear``)."""

    @staticmethod
    def forward(ctx, q: torch.Tensor, fn: Shear3Fn):
        ctx.fn = fn
        ctx.q_dtype = q.dtype
        return apply_shear3_kernel(q, fn.plan)

    @staticmethod
    def backward(ctx, cot: torch.Tensor):
        fn = ctx.fn
        g = cot.to(torch.float32)
        cov = shear3_ops.stage_plan(fn.plan).tables(g.device)[1]
        if cov is not None:
            g = g * cov
        qbar = apply_shear3_kernel(g, fn.plan_T, mid_dtype=torch.float32,
                                   out_dtype=torch.float32)
        return qbar.to(ctx.q_dtype), None


# bounded: each entry holds a plan and its adjoint (coverage image,
# bands); their device tables live in shear3's stage-plan cache
_LINEAR_CACHE = LruDict(16, max_bytes=1 << 30, name="cuda_shear3.linear")


def make_shear3_linear(plan: Shear3Plan) -> Shear3Fn:
    """Differentiable kernel apply for ``plan``: fn(q) -> dst, whose
    backward runs the adjoint pipeline on the same two kernels (3 more
    launches).  Float input only; the adjoint plan is built once per plan
    object."""
    hit = _LINEAR_CACHE.get(id(plan))
    if hit is None or hit.plan is not plan:
        hit = Shear3Fn(plan, shear3_ops.transpose_shear3_plan(plan))
        _LINEAR_CACHE.put(id(plan), hit)
    return hit
