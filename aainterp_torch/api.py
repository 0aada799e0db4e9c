"""Public API: area-average (conservative) interpolation in PyTorch.

Counterpart of the separable part of ``aainterp/api.py``:

    spec = make_grid_spec(...)            # geometry (grids.py)
    op   = build_operator(spec, mode)     # host float64, cacheable (ops/weights.py)
    dst  = apply_operator(op, src)        # torch / CUDA apply

Routing (``apply_operator``, counterpart of api.py:185-236):

* a CUDA tensor with ``impl='auto'`` always goes to the CUDA kernel, at
  every size, through :class:`autodiff.SeparableLinear`;
* a CPU tensor with ``impl='auto'`` takes the box mean when the operator
  is an exact uniform integer box, otherwise the plain banded apply;
* ``impl='kernel'`` forces the kernel and raises on a CPU tensor;
  ``impl='banded'`` (JAX's 'xla') and ``impl='box'`` force the plain
  routes on either device.

Dtypes follow the route, as in JAX: the kernel keeps bf16 in -> bf16 out
(Pallas contract); the plain routes give f32 for bf16 input (XLA
contract).  uint8 input gives f32 on every route at this level.

Rotated geometries, ``mode='shear'``, ``fused=True`` and ``method='ell'``
raise NotImplementedError naming the ROADMAP.md slice that brings them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from . import autodiff
from .grids import GridSpec, make_grid_spec
from .ops import apply as apply_ops
from .ops import weights as weights_ops

Operator = weights_ops.SeparableOperator

IMPLS = ("auto", "kernel", "banded", "box")


@dataclasses.dataclass(frozen=True)
class InterpResult:
    """Result of one interpolation: image + the forwarded isocenter."""

    dst: torch.Tensor
    dst_isocenter: Tuple[int, int]  # (x, y), integer part (Source.cpp:185-186)
    spec: GridSpec


def _rotated_not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} needs the exact rotated (ELL) family, which the PyTorch "
        "port brings in ROADMAP.md slice 3; use the JAX package aainterp "
        "meanwhile")


def build_operator(
    spec: GridSpec,
    mode: str = "exact",
    method: str = "auto",
    validate: bool = True,
) -> Operator:
    """Build the (host, float64, row-normalised) separable operator.

    method: 'auto' or 'separable' (zero residual rotation).  validate runs
    the numerical sanitizer (weights.validate_operator) on the result.
    """
    if mode not in ("exact", "fast", "compat"):
        raise ValueError(
            f"build_operator mode must be exact/fast/compat, got {mode!r}")
    if method == "ell" or (method == "auto" and not spec.is_axis_aligned):
        raise _rotated_not_ported("an ELL operator (rotated geometry or "
                                  "method='ell')")
    if method not in ("auto", "separable"):
        raise ValueError(f"unknown method {method!r}")
    op = weights_ops.separable_operator(spec, mode=mode)
    if validate:
        weights_ops.validate_operator(op)
    return op


def _apply_box(src, quadrant: int, my: int, mx: int, acc):
    # quadrant folded to the output side: box means are permutation-
    # invariant within each m x m block and rot90 maps blocks to blocks,
    # so the rot90 runs on the SMALL output (api.py:84-95)
    if quadrant % 2:
        my, mx = mx, my
    out = apply_ops.apply_box_mean(src, my, mx, acc_dtype=acc)
    return apply_ops.quadrant_rotate(out, quadrant)


def apply_operator(
    op: Operator,
    src: torch.Tensor,
    weight_dtype: torch.dtype = torch.float32,
    impl: str = "auto",
    differentiable: bool = False,
) -> torch.Tensor:
    """Apply a prebuilt separable operator to (..., H, W) image(s).

    See the module docstring for ``impl``.  Gradients: the kernel route
    always carries the transposed-band backward (autodiff.SeparableLinear);
    ``differentiable=True`` routes the plain banded apply through the same
    Function (otherwise torch differentiates the plain ops directly).
    """
    if not isinstance(op, weights_ops.SeparableOperator):
        raise _rotated_not_ported(f"applying a {type(op).__name__}")
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
    autodiff.numpy_weight_dtype(weight_dtype)  # raises on other dtypes
    src = torch.as_tensor(src)
    quadrant = op.spec.quadrant

    def _box_params():
        qH, qW = op.spec.qrot_shape
        return apply_ops.uniform_box_params(
            op.wy.start, op.wy.weights, op.wx.start, op.wx.weights, qH, qW)

    if impl == "auto":
        if src.is_cuda:
            impl = "kernel"
        else:
            box = _box_params()
            if box is not None:
                return _apply_box(src, quadrant, box[0], box[1], weight_dtype)
            impl = "banded"
    if impl == "box":
        box = _box_params()
        if box is None:
            raise ValueError("operator is not a uniform integer box filter")
        return _apply_box(src, quadrant, box[0], box[1], weight_dtype)
    if impl == "kernel":
        if not src.is_cuda:
            raise ValueError(
                "impl='kernel' needs a CUDA tensor; got one on "
                f"{src.device} (use impl='auto' or 'banded' on the CPU)")
        return autodiff.separable_linear_for(
            op, weight_dtype, "kernel")(src.contiguous())
    lin = autodiff.separable_linear_for(op, weight_dtype, "banded")
    # without differentiable=True torch differentiates the plain ops itself
    return lin(src) if differentiable else lin.forward(src)


def area_average_interpolate(
    src,
    src_resolution: float,
    dst_resolution: float,
    src_isocenter: Tuple[float, float],
    rotation_angle: float,
    *,
    mode: str = "exact",
    method: str = "auto",
    operator: Optional[Operator] = None,
    weight_dtype: torch.dtype = torch.float32,
    fused: bool = False,
    differentiable: bool = False,
) -> InterpResult:
    """Area-average interpolation with an axis-aligned rotation (k * 90°).

    Parameters mirror the reference program's signature (Source.cpp:55-57):
    ``src`` is a (..., H, W) tensor; resolutions are scalar; ``src_isocenter``
    is (x, y) in source pixels; ``rotation_angle`` is degrees, clockwise
    positive.  mode: 'exact' (true overlap areas), 'fast' (replica-center
    counting, Source.cpp mode 2) or 'compat' (equal to 'exact' when the
    geometry is axis-aligned).  The apply takes apply_operator's auto route.
    """
    if mode == "shear":
        raise NotImplementedError(
            "mode='shear' (3-pass conservative shear) comes to the PyTorch "
            "port in ROADMAP.md slice 4; use mode='exact' or the JAX package")
    if mode not in ("exact", "fast", "compat"):
        raise ValueError(f"mode must be exact/fast/compat, got {mode!r}")
    if fused:
        raise NotImplementedError(
            "fused on-device ELL weight-gen comes to the PyTorch port in "
            "ROADMAP.md slice 3")
    if method == "ell":
        raise _rotated_not_ported("method='ell'")
    src = torch.as_tensor(src)
    spec = make_grid_spec(
        (src.shape[-2], src.shape[-1]),
        src_resolution,
        dst_resolution,
        src_isocenter,
        rotation_angle,
    )
    if not spec.is_axis_aligned:
        raise _rotated_not_ported(
            f"rotation_angle={rotation_angle} (not a multiple of 90 degrees)")
    if mode == "compat":
        # axis-aligned compat == exact separable (no taxonomy involved)
        mode = "exact"
    if operator is None:
        operator = build_operator(spec, mode=mode, method=method)
    dst = apply_operator(operator, src, weight_dtype=weight_dtype,
                         differentiable=differentiable)
    return InterpResult(dst=dst, dst_isocenter=spec.dst_isocenter, spec=spec)
