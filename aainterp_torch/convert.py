"""Carry an operator's host tables into the port as plain numpy.

The port's "parameters" are the operator's tables.  A separable or ELL
operator, or a mode='shear' plan, built anywhere (the JAX package, a disk
cache, another process) can be unpacked into numpy arrays and rebuilt
here, so both sides apply identical tables.  Nothing here imports the JAX
package.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple

import numpy as np

from .grids import GridSpec
from .ops.overlap1d import Band1D
from .ops.shear3 import Pass1D, Shear3Plan
from .ops.weights import EllOperator, SeparableOperator


def band_from_numpy(band: Sequence) -> Band1D:
    """Band1D from ``(start, weights, n_src, n_dst)``."""
    start, weights, n_src, n_dst = band
    start = np.ascontiguousarray(start, dtype=np.int32)
    weights = np.ascontiguousarray(weights, dtype=np.float64)
    if weights.ndim != 2 or start.shape != (weights.shape[0],):
        raise ValueError(f"band start {start.shape} / weights "
                         f"{weights.shape} do not match")
    if weights.shape[0] != int(n_dst):
        raise ValueError(f"band has {weights.shape[0]} rows, n_dst={n_dst}")
    return Band1D(start=start, weights=weights, n_src=int(n_src),
                  n_dst=int(n_dst))


def spec_from_fields(fields: Mapping) -> GridSpec:
    """GridSpec from a mapping of its fields (e.g. ``dataclasses.asdict``);
    tuple-valued fields may arrive as lists."""
    return GridSpec(**{k: tuple(v) if isinstance(v, list) else v
                       for k, v in fields.items()})


def operator_from_numpy(
    spec_fields: Mapping,
    wy: Sequence,
    wx: Sequence,
    raw_row_sums: Tuple[np.ndarray, np.ndarray],
    mode: str = "exact",
) -> SeparableOperator:
    """The port's SeparableOperator from plain numpy tables.

    ``wy`` / ``wx`` are ``(start, weights, n_src, n_dst)``; ``raw_row_sums``
    the (y, x) pre-normalisation sums.
    """
    sy, sx = raw_row_sums
    return SeparableOperator(
        spec=spec_from_fields(spec_fields),
        wy=band_from_numpy(wy),
        wx=band_from_numpy(wx),
        raw_row_sums=(np.asarray(sy, dtype=np.float64),
                      np.asarray(sx, dtype=np.float64)),
        mode=mode,
    )


def ell_operator_from_numpy(
    spec_fields: Mapping,
    base: np.ndarray,
    weights: np.ndarray,
    raw_row_sums: np.ndarray,
    mode: str = "exact",
) -> EllOperator:
    """The port's EllOperator from plain numpy tables: ``base`` (Hd, Wd, 2)
    int32 window bases, ``weights`` (Hd, Wd, K, K) and ``raw_row_sums``
    (Hd, Wd), as an EllOperator of the JAX package holds them."""
    spec = spec_from_fields(spec_fields)
    base = np.ascontiguousarray(base, dtype=np.int32)
    weights = np.ascontiguousarray(weights, dtype=np.float64)
    raw_row_sums = np.ascontiguousarray(raw_row_sums, dtype=np.float64)
    Hd, Wd = spec.dst_shape
    if (base.shape != (Hd, Wd, 2) or weights.ndim != 4
            or weights.shape[:2] != (Hd, Wd)
            or weights.shape[2] != weights.shape[3]
            or raw_row_sums.shape != (Hd, Wd)):
        raise ValueError(
            f"ELL tables base {base.shape} / weights {weights.shape} / raw "
            f"sums {raw_row_sums.shape} do not match dst {(Hd, Wd)}")
    return EllOperator(spec=spec, base=base, weights=weights,
                       raw_row_sums=raw_row_sums, mode=mode)


def shear3_plan_from_numpy(
    spec_fields: Mapping,
    passes: Sequence[Mapping],
    inv_cov: Optional[np.ndarray],
    in_shape: Optional[Tuple[int, int]] = None,
    out_shape: Optional[Tuple[int, int]] = None,
) -> Shear3Plan:
    """The port's mode='shear' plan from plain numpy tables, as a
    ``Shear3Plan`` of the JAX package holds them.

    Each pass is a mapping with ``axis`` ('x' or 'y'), ``band`` (None or
    ``(start, weights, n_src, n_dst)``), ``band_first``, ``d`` and ``f``
    (one per line), ``n_t``, ``crop`` and ``n_out``.  ``inv_cov`` is the
    (Hd, Wd) reciprocal coverage, or None for an adjoint plan.  The stage
    plan checks the chain of shapes when the plan is first applied.
    """
    out = []
    for p in passes:
        if p["axis"] not in ("x", "y"):
            raise ValueError(f"pass axis must be 'x' or 'y', got "
                             f"{p['axis']!r}")
        d = np.ascontiguousarray(p["d"], dtype=np.int32)
        f = np.ascontiguousarray(p["f"], dtype=np.float32)
        if d.ndim != 1 or d.shape != f.shape:
            raise ValueError(f"pass shifts d {d.shape} / fractions f "
                             f"{f.shape} do not match")
        band = None if p["band"] is None else band_from_numpy(p["band"])
        out.append(Pass1D(axis=p["axis"], band=band,
                          band_first=bool(p["band_first"]), d=d, f=f,
                          n_t=int(p["n_t"]), crop=int(p["crop"]),
                          n_out=int(p["n_out"])))
    if inv_cov is not None:
        inv_cov = np.ascontiguousarray(inv_cov, dtype=np.float32)
    return Shear3Plan(
        spec=spec_from_fields(spec_fields), passes=tuple(out),
        inv_cov=inv_cov,
        in_shape=None if in_shape is None else tuple(in_shape),
        out_shape=None if out_shape is None else tuple(out_shape))
