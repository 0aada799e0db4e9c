"""Exact adjoints: ``torch.autograd.Function``s for the separable and the
rotated (ELL) applies, and the public transposed apply.

Counterpart of ``aainterp/autodiff.py``.  The resampling operator is
LINEAR in the image, so its vector-Jacobian product is the transposed
operator.  Separable: itself a banded apply that runs on the same kernel
as the forward:

    dst   = rot90^{-quad} -> (Wy @ q @ Wx.T)          (forward)
    q_bar = (Wy.T @ g @ Wx) -> rot90^{+quad}          (adjoint)

The quadrant pre-rotation is folded into the band tables for both
directions (``folded_separable_tables``), so neither ever materialises a
rot90 of the large array.

Rotated (``EllLinear``): any route's forward on the quadrant-folded
tables (the fused shear and the contraction on the card, the plain
sheared or gather route), the small dst permutation ``post`` after it;
the backward carries the cotangent through ``post``'s inverse and
scatters it into the original image's cells (``ops.apply.
apply_ell_transpose``), as the JAX package's custom VJP does
(autodiff.py:196-252).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .ops import apply as apply_ops
from .ops import cuda_apply, cuda_shear
from .ops import overlap1d
from .ops import weights as weights_ops
from .utils.device import Device, as_input, upload
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


# ----------------------------------------------------------------------
# Rotated (ELL) apply: any route forward, scatter-add backward
# ----------------------------------------------------------------------

ELL_ROUTES = ("kernel", "sheared", "gather")

# device copies of ELL tables (the 'gather' route's forward and every
# route's backward scatter), content-keyed
_ELL_TABLES = LruDict(4, max_bytes=4 << 30)

# EllFn per (route, tables, quadrants, weight dtype); each holds its folded
# operator (the fold cache holds the same arrays)
_ELL_LINEAR_CACHE = LruDict(8, max_bytes=4 << 30)


def ell_tables(op: weights_ops.EllOperator, weight_dtype: torch.dtype,
               device: torch.device, pinned: bool = False):
    """(base, weights) of ``op`` on ``device``, weights in
    ``weight_dtype``, uploaded once per table content, dtype and device
    (``pinned``: see ``utils.device.upload``)."""
    key = (array_digest(op.weights), array_digest(op.base),
           op.weights.shape, weight_dtype, torch.device(device))
    hit = _ELL_TABLES.get(key)
    if hit is None:
        hit = (upload(op.base, device, pinned=pinned),
               upload(op.weights, device, weight_dtype, pinned=pinned))
        _ELL_TABLES.put(key, hit)
    return hit


def ell_forward(op: weights_ops.EllOperator, route: str,
                plan: Optional[cuda_shear.ShearKernelPlan],
                src: torch.Tensor, weight_dtype: torch.dtype) -> torch.Tensor:
    """One rotated apply of a quadrant-0 (folded) EllOperator on ``route``:
    'kernel' (the fused shear and the contraction, ``plan``'s kernels),
    'sheared' (the same pipeline in plain torch) or 'gather' (plain
    ``apply_ell`` in ``weight_dtype``).  (..., qH, qW) -> (..., Hd, Wd)."""
    if route == "gather":
        base, w = ell_tables(op, weight_dtype, src.device)
        return apply_ops.apply_ell(src, base, w)
    # the shear pipeline computes in f32 whatever weight_dtype says
    qH, qW = op.spec.qrot_shape
    lead = src.shape[:-2]
    frames = src.reshape((-1, qH, qW))
    if route == "kernel":
        out = cuda_shear.apply_ell_shear_kernel(frames.contiguous(), plan)
    else:
        out = cuda_shear.apply_ell_shear_plain(frames, plan,
                                               out_dtype=torch.float32)
    return out.reshape(lead + out.shape[-2:])


@dataclasses.dataclass(frozen=True, eq=False)
class EllFn:
    """One rotated apply and its adjoint: ``op`` is the quadrant-folded
    (quadrant 0) operator both directions use, ``route`` and ``plan`` the
    forward's (``ell_forward``), ``post`` / ``post_inv`` the dst
    permutation of the fold and its inverse (None at quadrant 0).
    Calling it applies :class:`EllLinear`."""

    op: weights_ops.EllOperator
    route: str
    plan: Optional[cuda_shear.ShearKernelPlan]
    weight_dtype: torch.dtype
    post: Optional[Callable] = None
    post_inv: Optional[Callable] = None

    def forward(self, src: torch.Tensor) -> torch.Tensor:
        out = ell_forward(self.op, self.route, self.plan, src,
                          self.weight_dtype)
        return out if self.post is None else self.post(out)

    def backward(self, g: torch.Tensor) -> torch.Tensor:
        """The cotangent of the original image, in ``weight_dtype``."""
        if self.post_inv is not None:
            g = self.post_inv(g)
        base, w = ell_tables(self.op, self.weight_dtype, g.device)
        return apply_ops.apply_ell_transpose(g, base, w,
                                             self.op.spec.qrot_shape)

    def __call__(self, src: torch.Tensor) -> torch.Tensor:
        if src.dtype == torch.uint8:
            raise TypeError(
                "the differentiable rotated apply is float-only (uint8 "
                "input is not differentiable); cast to bfloat16/float32")
        return EllLinear.apply(src, self)


class EllLinear(torch.autograd.Function):
    """A rotated apply whose backward is the exact scatter-add adjoint
    (the counterpart of ``aainterp.autodiff.make_ell_linear``).  The
    forward is the route's own, so it equals the non-differentiable apply
    bit for bit; the cotangent comes back in the input's dtype."""

    @staticmethod
    def forward(ctx, src: torch.Tensor, fn: EllFn):
        ctx.fn = fn
        ctx.src_dtype = src.dtype
        return fn.forward(src)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return ctx.fn.backward(g).to(ctx.src_dtype), None


def ell_linear_for(op: weights_ops.EllOperator, route: str,
                   plan: Optional[cuda_shear.ShearKernelPlan],
                   weight_dtype: torch.dtype,
                   post: Optional[Callable] = None,
                   post_inv: Optional[Callable] = None,
                   orig_quadrant: int = 0) -> EllFn:
    """Cached differentiable rotated apply of a folded (quadrant-0)
    EllOperator, keyed as the JAX package keys its custom-VJP wrappers
    (api.py:515-517): route, table content, the folded and the original
    quadrant (at exact 90-degree multiples different quadrants can share
    folded tables), the source shape and the weight dtype."""
    if route not in ELL_ROUTES:
        raise ValueError(f"route must be one of {ELL_ROUTES}, got {route!r}")
    if op.spec.quadrant != 0:
        # the folded tables consume the original image: a nonzero quadrant
        # here would skip a rotation with no error
        raise ValueError("ell_linear_for takes folded (quadrant-0) tables, "
                         f"got quadrant {op.spec.quadrant}")
    key = (route, array_digest(op.weights), array_digest(op.base),
           op.spec.quadrant, orig_quadrant, op.spec.qrot_shape,
           weight_dtype)
    hit = _ELL_LINEAR_CACHE.get(key)
    if hit is None:
        hit = EllFn(op, route, plan, weight_dtype, post, post_inv)
        _ELL_LINEAR_CACHE.put(key, hit)
    return hit


# ----------------------------------------------------------------------
# Public adjoint apply ("splatting": dst-grid data back to the src grid)
# ----------------------------------------------------------------------

TRANSPOSE_IMPLS = ("auto", "kernel", "banded")


def apply_operator_transpose(
    op,
    cot,
    weight_dtype: torch.dtype = torch.float32,
    impl: str = "auto",
    device: Device = None,
) -> torch.Tensor:
    """Apply the TRANSPOSED operator: (..., Hd, Wd) -> (..., H, W).

    The exact adjoint of ``apply_operator(op, .)`` as a linear map: for
    any images u, v, ``<apply(op, u), v> == <u, apply_transpose(op, v)>``
    up to float rounding.  Conservative splatting of dst-grid quantities
    back onto the source grid (the counterpart of autodiff.py:258-299).

    Separable operators run the transposed folded tables, the backward of
    ``SeparableLinear``: ``impl='auto'`` takes the CUDA kernel for a CUDA
    tensor and the plain banded apply for a CPU tensor; 'kernel' raises
    on a CPU tensor.  Output dtypes follow the route, as the forward's.
    ELL operators scatter (``ops.apply.apply_ell_transpose``, in
    ``weight_dtype``) and rotate the result back by the quadrant, on any
    device; ``impl`` applies to separable operators only.  ``device``:
    see ``api``.
    """
    cot = as_input(cot, device)
    numpy_weight_dtype(weight_dtype)  # raises on other dtypes
    if impl not in TRANSPOSE_IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of "
                         f"{TRANSPOSE_IMPLS}")
    if isinstance(op, weights_ops.SeparableOperator):
        if impl == "auto":
            impl = "kernel" if cot.is_cuda else "banded"
        if impl == "kernel" and not cot.is_cuda:
            raise ValueError(
                "impl='kernel' needs a CUDA tensor; got one on "
                f"{cot.device} (use impl='auto' or 'banded' on the CPU)")
        return separable_linear_for(op, weight_dtype, impl).backward(cot)
    if isinstance(op, weights_ops.EllOperator):
        base, w = ell_tables(op, weight_dtype, cot.device)
        qbar = apply_ops.apply_ell_transpose(cot, base, w,
                                             op.spec.qrot_shape)
        return apply_ops.quadrant_rotate(qbar, -op.spec.quadrant)
    raise TypeError(f"unknown operator type {type(op)!r}")
