"""Public API: area-average (conservative) interpolation in PyTorch.

Counterpart of ``aainterp/api.py``, separable and exact rotated (ELL)
families:

    spec = make_grid_spec(...)            # geometry (grids.py)
    op   = build_operator(spec, mode)     # host float64, cacheable (ops/weights.py)
    dst  = apply_operator(op, src)        # torch / CUDA apply

Separable routes (``apply_operator`` on a SeparableOperator, counterpart
of api.py:185-236):

* a CUDA tensor with ``impl='auto'`` always goes to the CUDA kernel, at
  every size, through :class:`autodiff.SeparableLinear`;
* a CPU tensor with ``impl='auto'`` takes the box mean when the operator
  is an exact uniform integer box, otherwise the plain banded apply;
* ``impl='kernel'`` forces the kernel and raises on a CPU tensor;
  ``impl='banded'`` (JAX's 'xla') and ``impl='box'`` force the plain
  routes on either device.

Rotated routes (``apply_operator`` on an EllOperator, counterpart of
api.py:237-317).  The quadrant pre-rotation is folded into the tables
(``weights.fold_quadrant_ell_cached``) and only the small output pays a
flip/transpose:

* ``impl='kernel'`` (JAX's 'pallas'): the three CUDA kernels of
  ``ops/cuda_shear.py``; raises on a CPU tensor or where
  ``build_shear_plan`` rejects the geometry;
* ``impl='sheared'`` (JAX's 'sheared'): the same shear pipeline in plain
  torch, on either device;
* ``impl='gather'`` (JAX's 'xla'): the plain flat-gather ``apply_ell``;
* ``impl='auto'`` takes 'kernel' for a CUDA tensor at every size and
  'gather' for a CPU tensor.  Where the geometry has no shear plan
  (sheared window wider than 24, or an empty operator) it takes 'gather'
  with a RuntimeWarning, counted in ``SHEAR_PLAN_FALLBACKS``; the choice is
  made before any launch.

Dtypes follow the route, as in JAX: the kernel routes keep bf16 in ->
bf16 out (Pallas contract); the plain routes give f32 for bf16 input (XLA
contract).  uint8 input gives f32 on every route at this level.

Rotated gradients: ``differentiable=True``, or an input that requires
grad, sends every rotated route through ``autodiff.EllLinear``: the
route's own forward (on the card the same two kernel launches), and a
backward that scatters the cotangent into the original image
(``ops.apply.apply_ell_transpose``, ``index_add_``), returning the
input's dtype; uint8 raises TypeError.  A CUDA input stays on the
kernels.

``mode='compat'`` (the reference's exact mode, defects included,
``ops/compat.py``): an axis-aligned geometry takes ``mode='exact'``; a
rotated one builds a compat EllOperator (``method='ell'``, native engine)
whose wider window rides the same rotated routes.  ``fused=True`` (modes
exact and fast; compat raises ValueError) generates the ELL weights in
float32 on the input's device (``weights.ell_weights_torch``), chunked
over dst rows, and applies them with the plain gather; it returns f32
whatever ``weight_dtype`` says, as JAX's ``_fused_ell_jit`` does.

``mode='shear'`` (``area_average_interpolate`` only; counterpart of
api.py:393-460, 606-619): the 3-pass conservative shear approximation
of ``ops/shear3.py``, with no Operator.  The plan is cached per geometry
and ``shear_decomposition`` ('quality' x-y-x, the default, or 'fast'
y-x-y); the source is quadrant-rotated first.  ``method``:

* ``'kernel'`` (JAX's 'pallas'): the two CUDA stage kernels of
  ``ops/cuda_shear3.py``, three launches; bf16 intermediates for bf16
  and uint8 input, f32 for f32; raises on a CPU tensor;
* ``'plain'`` (JAX's 'xla'): the plain torch pipeline, f32 throughout;
* ``'auto'``: 'kernel' for a CUDA tensor, 'plain' for a CPU tensor.

Both shear routes return the input's dtype (bf16, f32 or uint8) and
compute in f32 whatever ``weight_dtype`` says (f32 or f64 accepted).  So
do JAX's: its XLA route keeps float64 tables with x64 on
(shear3.py:458-472) but casts them to the f32 working type where it uses
them (:454, :507), and the plain route here gives its bits
(tests/test_torch_shear3_api.py pins them against JAX with x64 on).
``differentiable=True`` on the kernel route goes through
``cuda_shear3.Shear3Linear`` (backward = the adjoint plan on the same
kernels); the plain route differentiates natively.  Axis-aligned
geometries take ``mode='exact'``, with 'kernel' and 'plain' mapped to the
separable impls 'kernel' and 'banded'.

Area-resize front doors (counterparts of api.py:636-882): ``area_resize``
(any (Hd, Wd), axes resized independently), ``resize`` (``method='area'``),
``resize_bands``, ``area_resize_nd`` (any set of axes of an N-D array) and
``area_pyramid``.  They build unit-cell interval-overlap bands and ride
``regrid.apply_band_operators`` (routes 'auto', 'aligned', 'kernel' on
the 2-D CUDA kernel, 'banded'), with its ``mask=``, ``impl=`` and
``precision=`` knobs; JAX's ``interpret=`` has no counterpart.

Device: every entry point takes ``device=``, and computes there when it
is given, moving a tensor from another device.  Without it a
``torch.Tensor`` input keeps its device and any other input (numpy, a
list) goes to the GPU, raising RuntimeError where there is none
(``utils.device.as_input``).

Reference-named front doors (api.py:885-953): ``area_rotate`` (equal
resolutions, about the image center by default),
``area_average_interpolation`` (exact) and
``fast_area_average_interpolation`` (fast), which return
``(dst, dst_isocenter)``; and ``propagate_variance`` (the squared
operator on the same routes).

``resize(method='bilinear'|'bicubic')`` takes the baselines of
``baselines.py`` (``F.interpolate`` with antialias, a library call as
the JAX package's ``jax.image.resize`` is).
"""

from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import autodiff
from . import regrid
from .grids import GridSpec, make_grid_spec
from .ops import apply as apply_ops
from .ops import cuda_shear, cuda_shear3
from .ops import shear3 as shear3_ops
from .ops import weights as weights_ops
from .ops.overlap1d import Band1D
from .utils.device import Device, as_input
from .utils.digest import array_digest
from .utils.log import build_span, span
from .utils.lru import LruDict

Operator = Union[weights_ops.SeparableOperator, weights_ops.EllOperator]

IMPLS = ("auto", "kernel", "banded", "box")
ELL_IMPLS = ("auto", "kernel", "sheared", "gather")
SHEAR_METHODS = ("auto", "kernel", "plain")
# the separable impl an axis-aligned mode='shear' takes, per shear method
_SHEAR_AXIS_ALIGNED_IMPLS = {"auto": "auto", "kernel": "kernel",
                             "plain": "banded"}

# mode='shear' plans, keyed by (spec, decomposition): O(H + W) tables and
# an (Hd, Wd) coverage image; byte-bounded like the other table caches
_SHEAR3_CACHE = LruDict(8, max_bytes=1 << 30, name="api.shear3")

# 'auto' rotated applies that took 'gather' because the geometry has no
# shear plan (see apply_operator)
SHEAR_PLAN_FALLBACKS = 0

# dst cells per chunk of the fused route's on-device weight-gen: bounds
# its clip temporaries (36 vertices per candidate cell)
_FUSED_CHUNK_CELLS = 1 << 20

# propagate_variance's squared operators, keyed by their parent's tables:
# squaring and digesting the table of a 2048^2 rotated operator anew cost
# 0.68 s of host time per call (chip_smoke.py phase 35, "NVIDIA H100 80GB
# HBM3, 700.00 W" host)
_SQUARED_CACHE = LruDict(4, max_bytes=4 << 30, name="api.squared")


@dataclasses.dataclass(frozen=True)
class InterpResult:
    """Result of one interpolation: image + the forwarded isocenter."""

    dst: torch.Tensor
    dst_isocenter: Tuple[int, int]  # (x, y), integer part (Source.cpp:185-186)
    spec: GridSpec


def build_operator(
    spec: GridSpec,
    mode: str = "exact",
    method: str = "auto",
    validate: bool = True,
) -> Operator:
    """Build the (host, float64, row-normalised) resampling operator.

    method: 'auto' picks separable for zero residual rotation, ELL
    otherwise.  The ELL weight-gen (modes exact, fast and compat) runs on
    the native C++ engine (built with g++ at first use) and falls back to
    numpy with a RuntimeWarning.  validate runs the numerical sanitizer
    (weights.validate_operator) on the result.
    """
    if mode not in ("exact", "fast", "compat"):
        raise ValueError(
            f"build_operator mode must be exact/fast/compat, got {mode!r}"
            + (" (mode='shear' is operator-free: call "
               "area_average_interpolate(mode='shear'))"
               if mode == "shear" else ""))
    if method == "auto":
        method = "separable" if spec.is_axis_aligned else "ell"
    if method not in ("separable", "ell"):
        raise ValueError(f"unknown method {method!r}")
    with build_span("build.operator"):
        if method == "separable":
            op = weights_ops.separable_operator(spec, mode=mode)
        else:
            op = weights_ops.ell_operator(spec, mode=mode)
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
    device: Device = None,
) -> torch.Tensor:
    """Apply a prebuilt operator to (..., H, W) image(s).

    See the module docstring for ``impl`` and ``device``.  Gradients:
    on a SeparableOperator the kernel route always carries the
    transposed-band backward (autodiff.SeparableLinear), and
    ``differentiable=True`` routes the plain banded apply through the same
    Function (otherwise torch differentiates the plain ops directly); on
    an EllOperator ``differentiable=True`` or an input that requires grad
    takes autodiff.EllLinear on every route.
    """
    src = as_input(src, device)
    if isinstance(op, weights_ops.EllOperator):
        return _apply_ell_operator(op, src, weight_dtype, impl,
                                   differentiable)
    if not isinstance(op, weights_ops.SeparableOperator):
        raise TypeError(f"unknown operator type {type(op)!r}")
    with span("aa.route"):
        fn, src = _separable_route(op, src, weight_dtype, impl,
                                   differentiable)
    return fn(src)


def _separable_route(op: weights_ops.SeparableOperator, src: torch.Tensor,
                     weight_dtype: torch.dtype, impl: str,
                     differentiable: bool):
    """(fn, src): the separable route's callable and the input it takes
    (module docstring)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
    autodiff.numpy_weight_dtype(weight_dtype)  # raises on other dtypes

    def _box_params():
        qH, qW = op.spec.qrot_shape
        return apply_ops.uniform_box_params(
            op.wy.start, op.wy.weights, op.wx.start, op.wx.weights, qH, qW)

    if impl == "auto":
        if src.is_cuda:
            impl = "kernel"
        else:
            box = _box_params()
            impl = "banded" if box is None else "box"
    elif impl == "box":
        box = _box_params()
        if box is None:
            raise ValueError("operator is not a uniform integer box filter")
    if impl == "box":
        return functools.partial(_apply_box, quadrant=op.spec.quadrant,
                                 my=box[0], mx=box[1], acc=weight_dtype), src
    if impl == "kernel":
        if not src.is_cuda:
            raise ValueError(
                "impl='kernel' needs a CUDA tensor; got one on "
                f"{src.device} (use impl='auto' or 'banded' on the CPU)")
        return (autodiff.separable_linear_for(op, weight_dtype, "kernel"),
                src.contiguous())
    lin = autodiff.separable_linear_for(op, weight_dtype, "banded")
    # without differentiable=True torch differentiates the plain ops itself
    return (lin if differentiable else lin.forward), src


def _ell_route(op: weights_ops.EllOperator, impl: str, on_cuda: bool):
    """(route, shear plan or None) for a quadrant-0 (folded) EllOperator.

    'auto' takes 'kernel' for a CUDA tensor and 'gather' for a CPU one; a
    geometry without a shear plan sends 'auto' to 'gather' with a
    RuntimeWarning (counted in SHEAR_PLAN_FALLBACKS), decided here before
    any launch.  Forced 'kernel' / 'sheared' raise ValueError instead.
    The kernel route's plan goes through the disk plan cache
    (``cuda_shear.kernel_plan_cached``, as the JAX package persists the
    Pallas plan, its api.py:469-472); the plain routes write nothing.
    """
    global SHEAR_PLAN_FALLBACKS
    if impl == "auto":
        if not on_cuda:
            return "gather", None
        try:
            return "kernel", cuda_shear.kernel_plan_cached(op)
        except ValueError as e:
            warnings.warn(f"rotated apply takes the plain gather route: {e}",
                          RuntimeWarning)
            SHEAR_PLAN_FALLBACKS += 1
            return "gather", None
    if impl == "kernel" and not on_cuda:
        raise ValueError(
            "impl='kernel' needs a CUDA tensor (use impl='auto', 'sheared' "
            "or 'gather' on the CPU)")
    if impl == "kernel":
        return impl, cuda_shear.kernel_plan_cached(op)
    if impl == "sheared":
        return impl, cuda_shear.kernel_plan(op)
    return "gather", None


def _apply_ell_operator(op, src, weight_dtype, impl, differentiable):
    """The rotated routes of ``apply_operator`` (module docstring)."""
    with span("aa.route"):
        if impl not in ELL_IMPLS:
            raise ValueError(f"unknown impl {impl!r} for an EllOperator; "
                             f"expected one of {ELL_IMPLS}")
        autodiff.numpy_weight_dtype(weight_dtype)  # raises on other dtypes
        orig_quadrant = op.spec.quadrant
        post = post_inv = None
        if orig_quadrant % 4:
            # the rot90 pre-rotation folds into the table: the apply reads
            # the ORIGINAL image and only the small output is flipped/
            # transposed; the backward carries cotangents through post's
            # inverse
            op, post = weights_ops.fold_quadrant_ell_cached(op)
            post_inv = weights_ops.ell_fold_post_inv(orig_quadrant)
        qH, qW = op.spec.qrot_shape
        if tuple(src.shape[-2:]) != (qH, qW):
            raise ValueError(f"source (..., H, W) must end in {(qH, qW)} "
                             f"for this operator, got {tuple(src.shape)}")
        route, plan = _ell_route(op, impl, src.is_cuda)
        lin = None
        if differentiable or src.requires_grad:
            lin = autodiff.ell_linear_for(op, route, plan, weight_dtype,
                                          post, post_inv, orig_quadrant)
    if lin is not None:
        return lin(src)
    out = autodiff.ell_forward(op, route, plan, src, weight_dtype)
    return out if post is None else post(out)


def _shear3_plan(spec: GridSpec,
                 decomposition: str) -> shear3_ops.Shear3Plan:
    """The cached mode='shear' plan of one geometry and decomposition."""
    key = (spec, decomposition)
    plan = _SHEAR3_CACHE.get(key)
    if plan is None:
        with build_span("build.shear3_plan"):
            plan = shear3_ops.build_shear3_plan(spec,
                                                decomposition=decomposition)
        _SHEAR3_CACHE.put(key, plan)
    return plan


def _apply_shear3(spec: GridSpec, src: torch.Tensor, method: str,
                  decomposition: str, differentiable: bool) -> torch.Tensor:
    """The rotated mode='shear' routes (module docstring)."""
    with span("aa.route"):
        plan = _shear3_plan(spec, decomposition)
        q = apply_ops.quadrant_rotate(src, spec.quadrant)
        if method == "auto":
            method = "kernel" if q.is_cuda else "plain"
        if method == "kernel" and not q.is_cuda:
            raise ValueError(
                "method='kernel' needs a CUDA tensor; got one on "
                f"{q.device} (use method='auto' or 'plain' on the CPU)")
    if method == "plain":
        # torch differentiates the plain pipeline itself
        return shear3_ops.apply_shear3_plain(q, plan)
    if differentiable or q.requires_grad:
        return cuda_shear3.make_shear3_linear(plan)(q)
    return cuda_shear3.apply_shear3_kernel(q, plan)


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
    shear_decomposition: str = "quality",
    device: Device = None,
) -> InterpResult:
    """Area-average interpolation with optional rotation about an isocenter.

    Parameters mirror the reference program's signature (Source.cpp:55-57):
    ``src`` is a (..., H, W) tensor; resolutions are scalar; ``src_isocenter``
    is (x, y) in source pixels; ``rotation_angle`` is degrees, clockwise
    positive.  mode: 'exact' (true overlap areas), 'fast' (replica-center
    counting, Source.cpp mode 2), 'compat' (the reference's exact mode,
    its rotated type-2 area defect included, for bit-compatible migration;
    PARITY.md; equal to 'exact' when the geometry is axis-aligned) or 'shear'
    (the 3-pass conservative shear approximation, ops/shear3.py: exact
    flux conservation, bilinear-class smearing against the exact operator;
    axis-aligned geometries fall through to 'exact').  For the first three
    the operator is built here unless ``operator=`` passes a prebuilt one
    (reuse it across requests: the rotated weight-gen is the costly step),
    and the apply takes apply_operator's auto route.  With mode='shear' no
    Operator is built: ``method`` picks the route ('auto', 'kernel',
    'plain'; module docstring) and ``shear_decomposition`` the plan
    ('quality' or 'fast').  ``fused=True`` (exact and fast) builds no host
    operator: the weights are generated on the input's device in float32
    and applied by the plain gather (module docstring).  ``device``: see
    the module docstring.
    """
    if mode not in ("exact", "fast", "compat", "shear"):
        raise ValueError(
            f"mode must be exact/fast/compat/shear, got {mode!r}")
    with span("aa.interpolate"):
        with span("aa.spec"):
            src = as_input(src, device)
            spec = make_grid_spec((src.shape[-2], src.shape[-1]),
                                  src_resolution, dst_resolution,
                                  src_isocenter, rotation_angle)
        impl = "auto"
        if mode == "shear":
            if method not in SHEAR_METHODS:
                raise ValueError(f"unknown shear method {method!r} "
                                 f"(expected {'/'.join(SHEAR_METHODS)})")
            if spec.is_axis_aligned:
                # a zero-angle shear decomposition IS the exact separable
                # operator; the shear method picks the separable impl
                mode, impl, method = (
                    "exact", _SHEAR_AXIS_ALIGNED_IMPLS[method], "auto")
            else:
                if operator is not None or fused:
                    raise ValueError(
                        "mode='shear' builds no Operator (pass mode='exact' "
                        "to use an explicit operator, and fused=False)")
                autodiff.numpy_weight_dtype(weight_dtype)  # raises on others
                dst = _apply_shear3(spec, src, method, shear_decomposition,
                                    differentiable)
                return InterpResult(dst=dst,
                                    dst_isocenter=spec.dst_isocenter,
                                    spec=spec)
        if mode == "compat" and method == "auto":
            # axis-aligned compat == exact separable (no taxonomy involved);
            # rotated compat is an ELL operator (api.py:588-597)
            if spec.is_axis_aligned:
                mode = "exact"
            else:
                method = "ell"
        if fused:
            if mode not in ("exact", "fast"):
                raise ValueError(
                    "fused weight-gen supports mode='exact'/'fast' only "
                    "(compat weight-gen is host-side, ops/compat.py)")
            dst = _apply_fused(spec, src, mode)
            return InterpResult(dst=dst, dst_isocenter=spec.dst_isocenter,
                                spec=spec)
        if operator is None:
            operator = build_operator(spec, mode=mode, method=method)
        dst = apply_operator(operator, src, weight_dtype=weight_dtype,
                             impl=impl, differentiable=differentiable)
        return InterpResult(dst=dst, dst_isocenter=spec.dst_isocenter,
                            spec=spec)


def _apply_fused(spec: GridSpec, src: torch.Tensor,
                 mode: str) -> torch.Tensor:
    """Weight-gen and apply on the input's device, chunked over dst rows
    (the counterpart of api.py:114-129): float32 ELL weights
    (``weights.ell_weights_torch``) and the plain gather, f32 out.  A
    chunk's weights equal those of one piece; only the gather's summation
    order may follow the chunk's shape."""
    q = apply_ops.quadrant_rotate(src, spec.quadrant)
    Hd, Wd = spec.dst_shape
    K = spec.window_cells
    rows = max(1, _FUSED_CHUNK_CELLS // max(Wd * K * K, 1))
    outs = []
    for dy0 in range(0, Hd, rows):
        base, w, _ = weights_ops.ell_weights_torch(
            spec, mode, (dy0, min(dy0 + rows, Hd)), device=q.device)
        outs.append(apply_ops.apply_ell(q, base, w))
    return torch.cat(outs, dim=-2)


def _unit_resize_band(n_src: int, n_dst: int) -> Band1D:
    """Row-normalised interval-overlap band for resizing a unit-cell axis
    of ``n_src`` cells to ``n_dst`` equal destination cells (each dst
    weight row is the exact area-average stencil; rows sum to 1)."""
    band = max(2, -(-n_src // n_dst) + 2)
    b = regrid._interval_overlap_band(
        np.linspace(0.0, float(n_src), n_src + 1),
        np.linspace(0.0, float(n_src), n_dst + 1),
        band,
    )
    s = b.weights.sum(axis=1, keepdims=True)  # == n_src/n_dst exactly
    return Band1D(start=b.start, weights=b.weights / s,
                  n_src=n_src, n_dst=n_dst)


def area_resize(
    image,
    dst_shape: Tuple[int, int],
    *,
    mask=None,
    fill_value: float = float("nan"),
    min_coverage: float = 1e-6,
    impl: str = "auto",
    precision: str = "auto",
    device: Device = None,
) -> torch.Tensor:
    """Conservative (area-average) resize of (..., H, W) to any shape.

    Each destination pixel is the exact area-weighted mean of the source
    pixels its footprint covers, the two axes resized independently;
    the mean is conserved at any ratio, up or down.  ``impl`` and
    ``precision`` as in ``regrid.apply_band_operators``.

    mask: optional validity mask broadcastable to the trailing (H, W)
    dims (nonzero = valid): the result is the valid-cell-renormalised
    mean, and destination pixels whose valid coverage is <= min_coverage
    get fill_value.  Masked output is float.
    """
    image = as_input(image, device)
    H, W = int(image.shape[-2]), int(image.shape[-1])
    Hd, Wd = int(dst_shape[0]), int(dst_shape[1])
    if Hd <= 0 or Wd <= 0:
        raise ValueError(f"dst_shape must be positive, got {dst_shape!r}")
    by, bx = _unit_resize_band(H, Hd), _unit_resize_band(W, Wd)
    if mask is not None:
        out, _ = regrid.apply_band_operators_masked(
            image, mask, by, bx, fill_value=fill_value,
            min_coverage=min_coverage, impl=impl, precision=precision)
        return out
    return regrid.apply_band_operators(image, by, bx, impl=impl,
                                       precision=precision)


def resize(image, dst_shape: Tuple[int, int], *, method: str = "area",
           device: Device = None, **kwargs) -> torch.Tensor:
    """One resize entry: ``method='area'`` is ``area_resize`` (with its
    mask=/impl=/precision= knobs); 'bilinear' and 'bicubic' are the
    standard interpolators of ``baselines.resize_baseline`` (a library
    call, ``F.interpolate`` with antialias, as JAX's is
    ``jax.image.resize``), which take no other options."""
    if method == "area":
        return area_resize(image, dst_shape, device=device, **kwargs)
    if method in ("bilinear", "bicubic"):
        if kwargs:
            raise TypeError(
                f"method={method!r} takes no extra options, got "
                f"{sorted(kwargs)}")
        from .baselines import resize_baseline

        return resize_baseline(image, dst_shape, method, device=device)
    raise ValueError(
        f"method must be 'area', 'bilinear' or 'bicubic', got {method!r}")


def resize_bands(src_shape: Tuple[int, int],
                 dst_shape: Tuple[int, int]) -> Tuple[Band1D, Band1D]:
    """The ``(by, bx)`` Band1D pair behind ``area_resize``, for reuse with
    ``regrid.apply_band_operators``."""
    H, W = int(src_shape[0]), int(src_shape[1])
    Hd, Wd = int(dst_shape[0]), int(dst_shape[1])
    if H <= 0 or W <= 0 or Hd <= 0 or Wd <= 0:
        raise ValueError(
            f"shapes must be positive, got {src_shape!r} -> {dst_shape!r}")
    return _unit_resize_band(H, Hd), _unit_resize_band(W, Wd)


def area_resize_nd(
    volume,
    dst_shape: Sequence[int],
    *,
    axes: Optional[Sequence[int]] = None,
    mask=None,
    fill_value: float = float("nan"),
    min_coverage: float = 1e-6,
    impl: str = "auto",
    precision: str = "auto",
    device: Device = None,
) -> torch.Tensor:
    """Conservative (area-average) resize along any set of axes of an N-D
    array (volumes, hyperspectral stacks, video cubes).

    dst_shape: target sizes for ``axes``; ``axes`` defaults to the last
    ``len(dst_shape)`` axes.  Axes whose size does not change are
    skipped.  When both trailing axes are resized they ride
    ``regrid.apply_band_operators`` (``impl``/``precision``); every other
    axis runs one contraction (``ops.apply.apply_aligned_axis`` for
    integer-ratio axes, else ``apply_band_axis``).  uint8 input quantises
    once at the end (round half to even, saturate), except the pure
    trailing-2-D case, which takes the band apply's own u8 route.

    mask: optional validity mask broadcastable to ``volume`` (nonzero =
    valid): the result is R(x*m)/R(m), with cells whose valid coverage is
    <= min_coverage set to fill_value.  Masked output is float32.
    """
    volume = as_input(volume, device)
    nd = volume.ndim
    dst_shape = tuple(int(s) for s in dst_shape)
    if axes is None:
        if len(dst_shape) > nd:
            raise ValueError(
                f"dst_shape has {len(dst_shape)} entries for a {nd}-D array")
        axes = tuple(range(nd - len(dst_shape), nd))
    axes = tuple(a % nd for a in axes)
    if len(axes) != len(dst_shape):
        raise ValueError(
            f"axes {axes!r} and dst_shape {dst_shape!r} length mismatch")
    if len(set(axes)) != len(axes):
        raise ValueError(f"duplicate axis in {axes!r}")
    if any(s <= 0 for s in dst_shape):
        raise ValueError(f"dst_shape must be positive, got {dst_shape!r}")

    # per-axis bands, skipping no-op axes
    bands = {
        ax: _unit_resize_band(int(volume.shape[ax]), s)
        for ax, s in zip(axes, dst_shape)
        if int(volume.shape[ax]) != s
    }

    def _resize(x):
        todo = dict(bands)
        if nd - 2 in todo and nd - 1 in todo:
            by, bx = todo.pop(nd - 2), todo.pop(nd - 1)
            x = regrid.apply_band_operators(x, by, bx, impl=impl,
                                            precision=precision)
        for ax in sorted(todo):
            b = todo[ax]
            # integer-ratio axes skip the gather (reshape + weighted tap
            # sum; ops/apply.aligned_axis_plan)
            plan = apply_ops.aligned_axis_plan(b.start, b.weights, b.n_src)
            if plan is not None:
                x = apply_ops.apply_aligned_axis(x, plan, ax)
            else:
                x = apply_ops.apply_band_axis(
                    x, torch.as_tensor(b.start, device=x.device),
                    torch.as_tensor(b.weights, dtype=torch.float32,
                                    device=x.device), ax)
        return x

    if mask is not None:
        m = (torch.as_tensor(mask, device=volume.device).to(torch.float32)
             != 0).broadcast_to(volume.shape).to(torch.float32)
        num = _resize(volume.to(torch.float32) * m)
        den = _resize(m)
        return regrid._masked_ratio(num, den, fill_value, min_coverage)

    if not bands:
        return volume
    u8 = volume.dtype == torch.uint8
    if u8 and set(bands) == {nd - 2, nd - 1}:
        return _resize(volume)  # the band apply's u8 route, rounds once
    out = _resize(volume.to(torch.float32) if u8 else volume)
    return regrid._quantise_u8(out) if u8 else out


def area_pyramid(image, num_levels: int, *, factor: int = 2,
                 min_size: int = 1, device: Device = None,
                 **kwargs) -> List[torch.Tensor]:
    """Flux-conserving image pyramid: successive ``area_resize`` by
    ``1/factor`` per level (ceil division, floored at ``min_size``).

    Returns ``[image, level1, ...]`` with at most ``num_levels`` entries
    (fewer once both axes reach ``min_size``); every level has the input's
    mean to float tolerance.  kwargs pass to ``area_resize``
    (impl/precision/mask...).
    """
    if num_levels < 1:
        raise ValueError(f"num_levels must be >= 1, got {num_levels}")
    if factor < 2:
        raise ValueError(f"factor must be >= 2, got {factor}")
    levels = [as_input(image, device)]
    while len(levels) < num_levels:
        H, W = int(levels[-1].shape[-2]), int(levels[-1].shape[-1])
        nxt = (max(min_size, -(-H // factor)), max(min_size, -(-W // factor)))
        if nxt == (H, W):
            break
        levels.append(area_resize(levels[-1], nxt, **kwargs))
    return levels


def area_rotate(image, angle: float, *, isocenter=None, mode: str = "exact",
                device: Device = None, **kwargs) -> torch.Tensor:
    """Flux-conserving rotation of (..., H, W) about ``isocenter``
    (default: the image center, (W/2, H/2) in (x, y) source pixels).

    ``area_average_interpolate`` at equal source and destination
    resolution: each output pixel is the exact overlap-area-weighted mean
    of the input pixels under the rotated footprint.  Returns the rotated
    array; use ``area_average_interpolate`` for the destination isocenter.
    kwargs pass to it (``method``, ``operator``, ``differentiable``, ...).
    """
    image = as_input(image, device)
    H, W = image.shape[-2], image.shape[-1]
    if isocenter is None:
        isocenter = (W / 2.0, H / 2.0)
    return area_average_interpolate(
        image, 1.0, 1.0, isocenter, angle, mode=mode, **kwargs).dst


def propagate_variance(op: Operator, var, *, impl: str = "auto",
                       weight_dtype: torch.dtype = torch.float32,
                       device: Device = None) -> torch.Tensor:
    """Exact variance map of a resampled image: ``Var(out) = A2 @ var``
    where A2 is ``op`` with elementwise-squared weights
    (``weights.squared_operator``), for independent input pixels (a
    diagonal input covariance).  Correlated inputs need the full A Σ A^T,
    which this does not compute.  Rides ``apply_operator``'s routes (the
    kernels on the card), so a (mean, variance) pair costs two applies.
    The squared operator is cached by the parent's table content.
    """
    if isinstance(op, weights_ops.EllOperator):
        tables = (op.weights, op.base)
    elif isinstance(op, weights_ops.SeparableOperator):
        tables = (op.wy.weights, op.wy.start, op.wx.weights, op.wx.start)
    else:
        raise TypeError(f"unknown operator type {type(op)!r}")
    key = (type(op).__name__, op.spec) + tuple(array_digest(t)
                                                 for t in tables)
    sq = _SQUARED_CACHE.get(key)
    if sq is None:
        sq = weights_ops.squared_operator(op)
        _SQUARED_CACHE.put(key, sq)
    return apply_operator(sq, var, weight_dtype=weight_dtype, impl=impl,
                          device=device)


# ----------------------------------------------------------------------
# Reference-named wrappers (Source.cpp API surface)
# ----------------------------------------------------------------------


def area_average_interpolation(src, src_resolution, dst_resolution,
                               src_isocenter, rotation_angle, **kwargs):
    """Reference-parity wrapper: exact mode.  Returns (dst, dst_isocenter)."""
    r = area_average_interpolate(
        src, src_resolution, dst_resolution, src_isocenter, rotation_angle,
        mode="exact", **kwargs)
    return r.dst, r.dst_isocenter


def fast_area_average_interpolation(src, src_resolution, dst_resolution,
                                    src_isocenter, rotation_angle, **kwargs):
    """Reference-parity wrapper: fast mode.  Returns (dst, dst_isocenter)."""
    r = area_average_interpolate(
        src, src_resolution, dst_resolution, src_isocenter, rotation_angle,
        mode="fast", **kwargs)
    return r.dst, r.dst_isocenter
