"""Persistent operator cache: the checkpoint/resume story of the port.

Counterpart of ``aainterp/utils/cache.py``.  The sparse resampling
operator is data-independent and depends only on the grid geometry
(SURVEY.md §5: "the intermediate product worth persisting ... cache it
to disk keyed by (src grid, dst grid, angle)").  For repeated serving
with fixed geometry, weight-gen happens once per key and resume is a
memory-mapped load.

The on-disk format is the JAX package's, so a cache either package wrote
loads in the other: ``<key>.op/`` holds one ``.npy`` file per table and a
``meta.json``; single-file ``<key>.npz`` entries of the JAX package's
first round stay readable; ``spec_key`` gives the same key string.  The
rotated kernel route's plans have a disk cache of their own
(``ops.cuda_shear.kernel_plan_cached``) in the same directory.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import tempfile
import warnings
from typing import Optional, Union

import numpy as np
import torch

from ..grids import GridSpec
from ..ops import overlap1d, weights as weights_ops
from .device import Device, target

DEFAULT_CACHE_DIR = os.environ.get(
    "AAINTERP_CACHE_DIR", os.path.expanduser("~/.cache/aainterp")
)

Operator = Union[weights_ops.SeparableOperator, weights_ops.EllOperator]


def spec_key(spec: GridSpec, mode: str, method: str) -> str:
    payload = json.dumps(
        {
            "v": 1,
            "src_shape": spec.src_shape,
            "src_resolution": spec.src_resolution,
            "dst_resolution": spec.dst_resolution,
            "src_isocenter": spec.src_isocenter,
            "rotation_angle": spec.rotation_angle,
            "mode": mode,
            "method": method,
        },
        sort_keys=True,
    )
    return hashlib.sha256(payload.encode()).hexdigest()[:24]


def save_operator(op: Operator, mode: str,
                  cache_dir: Optional[str] = None) -> str:
    """Persist as a directory of raw .npy files so loads can mmap (npz
    members cannot be memory-mapped).  Written into a staging directory
    of a unique name and renamed into place, so two concurrent savers
    never interleave their files."""
    cache_dir = cache_dir or DEFAULT_CACHE_DIR
    if isinstance(op, weights_ops.SeparableOperator):
        method = "separable"
        arrays = dict(
            wy_start=op.wy.start, wy_w=op.wy.weights,
            wx_start=op.wx.start, wx_w=op.wx.weights,
            sums_y=op.raw_row_sums[0], sums_x=op.raw_row_sums[1],
        )
    else:
        method = "ell"
        arrays = dict(base=op.base, w=op.weights, sums=op.raw_row_sums)
    key = spec_key(op.spec, mode, method)
    path = os.path.join(cache_dir, f"{key}.op")
    os.makedirs(cache_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f"{key}.op.tmp.", dir=cache_dir)
    meta = dict(spec=dataclasses.asdict(op.spec), method=method,
                mode=op.mode, arrays=sorted(arrays))
    for name, arr in arrays.items():
        np.save(os.path.join(tmp, f"{name}.npy"), np.asarray(arr))
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    return path


def load_operator(
    spec: GridSpec, mode: str, method: str, cache_dir: Optional[str] = None,
    mmap: bool = True,
) -> Optional[Operator]:
    """The cached operator of (spec, mode, method), or None where there
    is none.  A corrupted or partly written entry is ignored with a
    RuntimeWarning and None returned (callers rebuild it)."""
    cache_dir = cache_dir or DEFAULT_CACHE_DIR
    key = spec_key(spec, mode, method)
    dpath = os.path.join(cache_dir, f"{key}.op")
    npz_path = os.path.join(cache_dir, f"{key}.npz")
    try:
        if os.path.isdir(dpath):
            with open(os.path.join(dpath, "meta.json")) as f:
                meta = json.load(f)
            mm = "r" if mmap else None
            z = {name: np.load(os.path.join(dpath, f"{name}.npy"),
                               mmap_mode=mm)
                 for name in meta["arrays"]}
            saved_mode = meta.get("mode", mode)
        elif os.path.exists(npz_path):
            # single-file entries of the JAX package's first round (no mmap)
            z = np.load(npz_path, allow_pickle=False)
            saved_mode = str(z["__mode__"]) if "__mode__" in z else mode
        else:
            return None
    except (OSError, KeyError, ValueError, json.JSONDecodeError) as e:
        warnings.warn(
            f"ignoring unreadable operator cache entry {dpath}: "
            f"{type(e).__name__}: {e}", RuntimeWarning)
        return None
    # the operator's weight-gen mode comes from the file: validate_operator's
    # slack for compat overcounts keys off op.mode, so a cached compat or
    # fast operator must not reload labelled "exact"
    if method == "separable":
        qH, qW = spec.qrot_shape
        dstH, dstW = spec.dst_shape
        wy = overlap1d.Band1D(z["wy_start"], z["wy_w"], qH, dstH)
        wx = overlap1d.Band1D(z["wx_start"], z["wx_w"], qW, dstW)
        return weights_ops.SeparableOperator(
            spec=spec, wy=wy, wx=wx,
            raw_row_sums=(z["sums_y"], z["sums_x"]), mode=saved_mode,
        )
    return weights_ops.EllOperator(
        spec=spec, base=z["base"], weights=z["w"], raw_row_sums=z["sums"],
        mode=saved_mode,
    )


def build_operator_cached(
    spec: GridSpec, mode: str = "exact", method: str = "auto",
    cache_dir: Optional[str] = None, validate: bool = True,
) -> Operator:
    """build_operator with a persistent disk cache.

    With ``validate`` (default), a cache hit runs the numerical sanitizer
    (``weights.validate_operator``); a poisoned or corrupted entry is
    discarded with a warning and the operator is rebuilt from geometry —
    the cache is derived state, so corruption is always recoverable.
    """
    from ..api import build_operator

    if method == "auto":
        method = "separable" if spec.is_axis_aligned else "ell"
    op = load_operator(spec, mode, method, cache_dir)
    if op is not None and validate:
        try:
            weights_ops.validate_operator(op)
        except weights_ops.OperatorValidationError as e:
            warnings.warn(
                f"cached operator failed validation ({e}); rebuilding",
                RuntimeWarning)
            op = None
    if op is None:
        op = build_operator(spec, mode=mode, method=method,
                            validate=validate)
        save_operator(op, mode, cache_dir)
    return op


def prefetch_operator(op: Operator, device: Device = None,
                      weight_dtype: torch.dtype = torch.float32) -> Operator:
    """Upload ``op``'s apply tables to ``device`` (default ``cuda``) ahead
    of its first apply, and return ``op``.

    The tables go from pinned host memory with ``non_blocking=True`` on
    the current stream, so the call returns while they travel (an
    mmap-paged load overlaps with whatever follows), into the same
    per-device caches the applies read, so the apply reuses the upload:

    * a SeparableOperator: its quadrant-folded band pair's
      ``regrid.BandTables`` (the route of ``pipeline.stream_apply`` and
      ``regrid.apply_band_operators``) and the plan of ``apply_operator``'s
      kernel route (kernel 1, or kernel 2 where kernel 1 cannot take the
      bands);
    * an EllOperator: its quadrant-folded tables in
      ``autodiff._ELL_TABLES`` (the 'gather' route and every backward),
      weights in ``weight_dtype`` (float64 is honoured: torch has no x64
      switch), and, on a CUDA device, the shear plan's tables
      (``ShearKernelPlan.tables``, the kernel route; the plan comes from
      the disk plan cache, as the route's does).

    The counterpart of the JAX package's ``prefetch_operator`` (whose
    float64 ValueError exists because x64 is off in JAX).  Work queued
    on another stream must wait for the current one before it applies.
    """
    from .. import autodiff, regrid
    from ..ops import cuda_apply, cuda_apply_2d, cuda_shear

    device = target(device)
    if device.type == "cuda" and device.index is None:
        # the caches key devices as the applies see them: with an index
        device = torch.device("cuda", torch.cuda.current_device())
    autodiff.numpy_weight_dtype(weight_dtype)       # raises on other dtypes
    if isinstance(op, weights_ops.SeparableOperator):
        yb, xb, _ = weights_ops.fold_quadrant_separable(op)
        regrid.band_tables(yb, xb).tables(device, pinned=True)
        if device.type == "cuda":
            tabs = autodiff.separable_linear_for(op, torch.float32,
                                                 "kernel").tables
            plan = cuda_apply._plan_for(*tabs)
            if plan["kernel_2d"]:
                plan = cuda_apply_2d.kernel_plan(*tabs)
                cuda_apply_2d.device_tables(plan, device, pinned=True)
            else:
                cuda_apply._device_tables(plan, device, pinned=True)
        return op
    if not isinstance(op, weights_ops.EllOperator):
        raise TypeError(f"unknown operator type {type(op)!r}")
    folded = op
    if op.spec.quadrant % 4:
        folded, _ = weights_ops.fold_quadrant_ell_cached(op)
    autodiff.ell_tables(folded, weight_dtype, device, pinned=True)
    if device.type == "cuda":
        try:
            plan = cuda_shear.kernel_plan_cached(folded)
        except ValueError:
            return op           # no shear plan: the route takes 'gather'
        plan.tables(device, pinned=True)
    return op
