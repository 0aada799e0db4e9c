"""aainterp_torch: area-average (conservative) image resampling in PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper (H100).

The PyTorch port of the JAX package ``aainterp``, which stays the
reference.  This package imports torch and numpy, never jax or aainterp.
Ported so far (ROADMAP.md slices 1-4; slice 2 without its strided-stencil
path):

* axis-aligned resampling (any multiple of 90 degrees) through the
  separable banded apply, with the CUDA kernel ``csrc/separable_apply.cu``
  on CUDA tensors and plain torch on CPU tensors, and exact gradients
  through ``autodiff.SeparableLinear``;
* exact rotated resampling (modes exact, fast and the reference's
  bug-for-bug compat) through the ELL operator (native C++ weight-gen,
  built with g++ at first use) and the kernels of ``csrc/ell_shear.cu``
  (the shear kernel, whose fused form the route launches, and the window
  contraction), with plain torch routes beside them, exact gradients
  through ``autodiff.EllLinear`` (scatter-add backward) and the fused
  on-device weight-gen route (``fused=True``);
* the approximate rotated mode ``mode='shear'`` (3 conservative 1-D
  passes, ``ops/shear3.py``) on the two CUDA stage kernels of
  ``csrc/shear3_stage.cu``, differentiable through
  ``ops.cuda_shear3.Shear3Linear``, with a plain torch pipeline beside it;
* the band-operator family: the conservative lat-lon regrid
  (``regrid.py``, masked and unmasked) and the area-resize front doors
  (``area_resize``, ``resize``, ``resize_bands``, ``area_resize_nd``,
  ``area_pyramid``), on the aligned integer-ratio route (plain torch) or
  the 2-D banded-tile CUDA kernel ``csrc/separable_apply_2d.cu``;
* the transposed apply (``apply_operator_transpose``), variance maps
  (``propagate_variance``), operator composition (``compose_separable``),
  ``area_rotate`` and the reference-named ``area_average_interpolation``
  and ``fast_area_average_interpolation``.

Entry points compute where a tensor input lies; other input (numpy, a
list) goes to ``device=`` or, by default, the GPU.

    import torch, aainterp_torch as aa
    frames = torch.rand(8, 2160, 3840, device="cuda").to(torch.bfloat16)
    res = aa.area_average_interpolate(frames, 2.0, 1.0, (0.0, 0.0), 0.0)
    res.dst.shape   # (8, 1080, 1920), bf16
    rot = aa.area_average_interpolate(frames[..., :2048, :2048], 1.0, 0.5,
                                      (1024.0, 1024.0), 30.0)
    rot.dst.shape   # (8, 1399, 1399), bf16
    fast = aa.area_average_interpolate(frames[..., :2048, :2048], 1.0, 0.5,
                                       (1024.0, 1024.0), 30.0, mode="shear")
    fast.dst.shape  # (8, 1399, 1399), bf16
    fields = torch.rand(8, 1800, 3600, device="cuda") * 50 + 250
    aa.conservative_regrid(fields, aa.LatLonGrid(1800, 3600),
                           aa.LatLonGrid(720, 1440)).shape  # (8, 720, 1440)
    aa.area_resize(frames, (720, 1280)).shape               # (8, 720, 1280)
    aa.area_rotate(frames[..., :2048, :2048], 30.0).shape   # (8, 2798, 2798)
"""

from .api import (
    InterpResult,
    apply_operator,
    area_average_interpolate,
    area_average_interpolation,
    area_pyramid,
    area_resize,
    area_resize_nd,
    area_rotate,
    build_operator,
    fast_area_average_interpolation,
    propagate_variance,
    resize,
    resize_bands,
)
from .autodiff import (
    EllLinear,
    SeparableLinear,
    apply_operator_transpose,
    ell_linear_for,
    separable_linear_for,
)
from .convert import (
    ell_operator_from_numpy,
    operator_from_numpy,
    shear3_plan_from_numpy,
)
from .grids import (
    DBL_EPSILON,
    GridSpec,
    ValidationError,
    make_grid_spec,
    validate_args,
)
from .ops.cuda_apply import apply_separable_kernel, apply_separable_plain
from .ops.cuda_apply_2d import (
    apply_separable_2d_plain,
    apply_separable_kernel_2d,
)
from .ops.cuda_shear3 import Shear3Linear, make_shear3_linear
from .ops.weights import (
    EllOperator,
    OperatorValidationError,
    SeparableOperator,
    compose_separable,
    ell_operator,
    separable_operator,
    squared_operator,
    validate_operator,
)
from .regrid import (
    LatLonGrid,
    apply_band_operators,
    apply_band_operators_masked,
    area_weighted_mean,
    conservative_regrid,
    conservative_regrid_operator,
)

__all__ = [
    "DBL_EPSILON",
    "EllLinear",
    "EllOperator",
    "GridSpec",
    "InterpResult",
    "LatLonGrid",
    "OperatorValidationError",
    "SeparableLinear",
    "SeparableOperator",
    "Shear3Linear",
    "ValidationError",
    "apply_band_operators",
    "apply_band_operators_masked",
    "apply_operator",
    "apply_operator_transpose",
    "apply_separable_2d_plain",
    "apply_separable_kernel",
    "apply_separable_kernel_2d",
    "apply_separable_plain",
    "area_average_interpolate",
    "area_average_interpolation",
    "area_pyramid",
    "area_resize",
    "area_resize_nd",
    "area_rotate",
    "area_weighted_mean",
    "build_operator",
    "compose_separable",
    "conservative_regrid",
    "conservative_regrid_operator",
    "ell_linear_for",
    "ell_operator",
    "ell_operator_from_numpy",
    "fast_area_average_interpolation",
    "make_grid_spec",
    "make_shear3_linear",
    "operator_from_numpy",
    "propagate_variance",
    "resize",
    "resize_bands",
    "separable_linear_for",
    "separable_operator",
    "shear3_plan_from_numpy",
    "squared_operator",
    "validate_args",
    "validate_operator",
]
