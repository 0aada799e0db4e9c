"""Exact adjoints for the separable apply: a ``torch.autograd.Function``.

Counterpart of the separable part of ``aainterp/autodiff.py``.  The
resampling operator is LINEAR in the image, so its vector-Jacobian
product is the transposed operator — itself a separable banded apply
that runs on the same kernel as the forward:

    dst   = rot90^{-quad} -> (Wy @ q @ Wx.T)          (forward)
    q_bar = (Wy.T @ g @ Wx) -> rot90^{+quad}          (adjoint)

The quadrant pre-rotation is folded into the band tables for both
directions (``folded_separable_tables``), so neither ever materialises a
rot90 of the large array.  The ELL adjoint waits for the rotated slice
(ROADMAP.md slice 3).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .ops import apply as apply_ops
from .ops import cuda_apply
from .ops import overlap1d
from .ops import weights as weights_ops
from .utils.digest import array_digest
from .utils.lru import LruDict

KINDS = ("kernel", "banded")
_NP_WEIGHT_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}

_TBAND_CACHE = LruDict(64)


def transposed_separable(
    op: weights_ops.SeparableOperator,
) -> Tuple[overlap1d.Band1D, overlap1d.Band1D]:
    """(Wy^T, Wx^T) as banded operators, content-cached."""
    key = (array_digest(op.wy.weights), array_digest(op.wx.weights),
           array_digest(op.wy.start), array_digest(op.wx.start))
    hit = _TBAND_CACHE.get(key)
    if hit is None:
        hit = (overlap1d.transpose_band(op.wy), overlap1d.transpose_band(op.wx))
        _TBAND_CACHE.put(key, hit)
    return hit


def folded_separable_tables(op: weights_ops.SeparableOperator):
    """Quadrant-folded forward/backward bands: (yb, xb, tyb, txb, out_t).

    The quadrant pre-rotation is folded into the band tables
    (weights.fold_quadrant_separable) so neither direction ever
    materialises a rot90 of the LARGE array: forward consumes the
    original image, backward produces the original-image cotangent
    directly.  Transposes of flipped bands use the identity
    ``(W P)^T == P W^T`` (overlap1d.reverse_rows_band of the transposed
    band); quadrants 1/3 additionally transpose the SMALL dst-side array
    (``out_t``): the forward transposes its output, the backward its
    incoming cotangent.
    """
    yb, xb, out_t = weights_ops.fold_quadrant_separable(op)
    ty, tx = transposed_separable(op)
    rr = overlap1d.reverse_rows_band
    q = op.spec.quadrant % 4
    if q == 0:
        tyb, txb = ty, tx
    elif q == 1:      # yb = wx @ P  ->  yb^T = P @ wx^T ; xb = wy
        tyb, txb = rr(tx), ty
    elif q == 2:      # both flipped
        tyb, txb = rr(ty), rr(tx)
    else:             # yb = wx ; xb = wy @ P
        tyb, txb = tx, rr(ty)
    return yb, xb, tyb, txb, out_t


def _sep_apply(kind: str, q: torch.Tensor, ys, yw, xs, xw) -> torch.Tensor:
    """One separable apply on (..., H, W) with host tables.

    'kernel' goes through ``cuda_apply.apply_separable_kernel`` (the CUDA
    kernel for a CUDA tensor, its plain version for a CPU tensor);
    'banded' is the plain banded apply on q's device.
    """
    if kind == "banded":
        dev = q.device
        return apply_ops.apply_separable_banded(
            q, torch.as_tensor(ys, device=dev), torch.as_tensor(yw, device=dev),
            torch.as_tensor(xs, device=dev), torch.as_tensor(xw, device=dev))
    lead = q.shape[:-2]
    q3 = q.reshape((-1,) + q.shape[-2:])
    # uint8 pixels ride the kernel's 8-bit loads, but the api-level
    # contract is float32 output on every route (autodiff.py:89-97);
    # uint8 in -> uint8 out is the ops-level apply_separable_kernel surface
    out_dtype = torch.float32 if q3.dtype == torch.uint8 else None
    out = cuda_apply.apply_separable_kernel(q3, ys, yw, xs, xw,
                                            out_dtype=out_dtype)
    return out.reshape(lead + out.shape[-2:])


@dataclasses.dataclass(frozen=True, eq=False)
class FoldedSeparable:
    """Host tables of one quadrant-folded separable apply and its adjoint.

    ``tables`` / ``t_tables`` are (ys, yw, xs, xw) numpy arrays for the
    folded forward and its transpose; ``out_t`` transposes the small
    dst-side array for quadrants 1/3.  Calling it applies
    :class:`SeparableLinear`.
    """

    kind: str
    tables: tuple
    t_tables: tuple
    out_t: bool

    def forward(self, src: torch.Tensor) -> torch.Tensor:
        out = _sep_apply(self.kind, src, *self.tables)
        return out.transpose(-1, -2).contiguous() if self.out_t else out

    def backward(self, g: torch.Tensor) -> torch.Tensor:
        gq = g.transpose(-1, -2) if self.out_t else g
        return _sep_apply(self.kind, gq.contiguous(), *self.t_tables)

    def __call__(self, src: torch.Tensor) -> torch.Tensor:
        return SeparableLinear.apply(src, self)


class SeparableLinear(torch.autograd.Function):
    """Quadrant-folded separable apply whose backward is the same apply on
    the transposed folded tables (the counterpart of
    ``aainterp.autodiff.make_separable_linear``).  The cotangent comes back
    in the input's dtype."""

    @staticmethod
    def forward(ctx, src: torch.Tensor, lin: FoldedSeparable):
        ctx.lin = lin
        ctx.src_dtype = src.dtype
        return lin.forward(src)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return ctx.lin.backward(g).to(ctx.src_dtype), None


_SEP_LINEAR_CACHE = LruDict(32)


def numpy_weight_dtype(weight_dtype: torch.dtype):
    if weight_dtype not in _NP_WEIGHT_DTYPES:
        raise ValueError(f"weight_dtype must be torch.float32 or "
                         f"torch.float64, got {weight_dtype}")
    return _NP_WEIGHT_DTYPES[weight_dtype]


def separable_linear_for(op: weights_ops.SeparableOperator,
                         weight_dtype: torch.dtype, kind: str
                         ) -> FoldedSeparable:
    """Cached differentiable apply for a SeparableOperator.

    kind: 'kernel' (CUDA kernel; the counterpart of JAX's 'pallas') or
    'banded' (plain torch; the counterpart of JAX's 'xla').  The kernel
    computes in f32 whatever ``weight_dtype`` says.
    """
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    np_dtype = numpy_weight_dtype(weight_dtype)
    key = (kind, str(weight_dtype), op.spec.quadrant,
           array_digest(op.wy.weights), array_digest(op.wx.weights),
           array_digest(op.wy.start), array_digest(op.wx.start))
    hit = _SEP_LINEAR_CACHE.get(key)
    if hit is None:
        yb, xb, tyb, txb, out_t = folded_separable_tables(op)
        # the kernel's tables are int32 starts and f32 weights; stored so,
        # its plan cache finds them by digest without a per-call cast
        start_dtype, w_dtype = ((np.int32, np.float32) if kind == "kernel"
                                else (np.int64, np_dtype))

        def _pair(b):
            return (np.ascontiguousarray(b.start, dtype=start_dtype),
                    np.ascontiguousarray(b.weights, dtype=w_dtype))

        hit = FoldedSeparable(kind, _pair(yb) + _pair(xb),
                              _pair(tyb) + _pair(txb), out_t)
        _SEP_LINEAR_CACHE.put(key, hit)
    return hit
