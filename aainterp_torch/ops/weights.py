"""Weight-generation: the separable resampling operator from a GridSpec.

Counterpart of the separable part of ``aainterp/ops/weights.py``
(host numpy float64, carried over).  The ELL, compose and squared
operators wait for later slices (ROADMAP.md, slices 2 and 3).

Weight-gen is a data-independent stage producing a static-shape operator
with ``dst = (Wy @ q) @ Wx.T`` where each row of Wy / Wx is pre-normalised
to sum to 1 (rows with ~zero total overlap are all-zero, reproducing the
reference's ``dst = 0`` fallback at Source.cpp:577/905).  The overlap
area factors into 1-D interval overlaps per axis; normalisation also
factors (sumArea = (sum wy)*(sum wx)), so each axis band is
row-normalised.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np

from ..grids import DBL_EPSILON, GridSpec
from . import overlap1d


@dataclasses.dataclass(frozen=True)
class SeparableOperator:
    """dst = (Wy @ q) @ Wx.T with row-normalised banded Wy/Wx.

    ``q`` is the quadrant-pre-rotated original image (rot90(src, -quadrant),
    equivalent to Source.cpp:159-172 at cell level).
    """

    spec: GridSpec
    wy: overlap1d.Band1D  # row-normalised
    wx: overlap1d.Band1D  # row-normalised
    raw_row_sums: Tuple[np.ndarray, np.ndarray]  # pre-normalisation sums (y, x)
    mode: str = "exact"

    def dense(self) -> Tuple[np.ndarray, np.ndarray]:
        return self.wy.dense(), self.wx.dense()


def _normalise_band(band: overlap1d.Band1D):
    sums = band.row_sums()
    safe = np.where(np.abs(sums) > DBL_EPSILON, sums, 1.0)
    w = np.where(
        (np.abs(sums) > DBL_EPSILON)[:, None], band.weights / safe[:, None], 0.0
    )
    return (
        overlap1d.Band1D(
            start=band.start, weights=w, n_src=band.n_src, n_dst=band.n_dst
        ),
        sums,
    )


def separable_operator(spec: GridSpec, mode: str = "exact") -> SeparableOperator:
    """Build the separable operator (requires spec.is_axis_aligned)."""
    if not spec.is_axis_aligned:
        raise ValueError("separable operator requires zero residual rotation")
    if mode in ("exact", "compat"):
        # axis-aligned compat == exact: the reference's type-2 defect only
        # fires under true rotation (Source.cpp:1055-1062), so compat gets
        # true 1-D overlaps here, NOT the fast replica-center counting
        gen = overlap1d.overlap_band_1d
    elif mode == "fast":
        gen = overlap1d.count_band_1d
    else:
        raise ValueError(f"unknown mode {mode!r}")
    qH, qW = spec.qrot_shape
    dstH, dstW = spec.dst_shape
    # offset is identically 0 at zero residual angle (Source.cpp:189-200)
    by = gen(dstH, qH, spec.dst_side, spec.scale, spec.iso_offset[1])
    bx = gen(dstW, qW, spec.dst_side, spec.scale, spec.iso_offset[0])
    by_n, sy = _normalise_band(by)
    bx_n, sx = _normalise_band(bx)
    return SeparableOperator(spec=spec, wy=by_n, wx=bx_n,
                             raw_row_sums=(sy, sx), mode=mode)


class OperatorValidationError(ValueError):
    """A built/loaded operator failed the numerical sanitizer."""


def _check(cond, msg) -> None:
    # not `assert`: must survive python -O (production serving)
    if not cond:
        raise OperatorValidationError(msg)


def validate_operator(op: SeparableOperator) -> dict:
    """Numerical sanitizer for a built separable operator.

    Checks: finite weights; normalised rows sum to 1 (or exactly 0 for
    empty footprints); raw row sums within [0, the per-axis bound of the
    weight-gen mode].  Returns a dict of stats; raises
    OperatorValidationError on violation.
    """
    if not isinstance(op, SeparableOperator):
        raise TypeError(
            f"validate_operator takes a SeparableOperator, got "
            f"{type(op).__name__} (ELL operators arrive with the rotated "
            "slice, ROADMAP.md slice 3)")
    L = op.spec.dst_side
    mode = op.mode
    # per-axis raw-sum upper bound by weight-gen semantics:
    #  exact — true overlap length, <= L
    #  compat — the reference's type-2 defect can overcount (rotated only,
    #           but the bound is kept as in the JAX package)
    #  fast — raw sums are COUNTS of unit-spaced replica centers inside the
    #         L-side footprint (Source.cpp:899-905), at most floor(L)+1
    if mode == "fast":
        bound_1d = math.floor(L + 1e-9) + 1.0
    elif mode == "compat":
        bound_1d = 2.0 * L
    else:
        bound_1d = L * (1.0 + 1e-9)
    stats = {}
    for name, band, sums in (
        ("y", op.wy, op.raw_row_sums[0]),
        ("x", op.wx, op.raw_row_sums[1]),
    ):
        w = band.weights
        _check(np.isfinite(w).all(), f"non-finite {name} weights")
        rs = w.sum(axis=1)
        ok = np.isclose(rs, 1.0, atol=1e-9) | (rs == 0.0)
        _check(ok.all(), f"{name} rows not normalised")
        _check((sums >= -1e-12).all(), f"negative {name} raw sums")
        _check((sums <= bound_1d + 1e-9).all(),
               f"{name} raw sums exceed the {mode} bound {bound_1d}")
        stats[f"{name}_zero_rows"] = int((rs == 0.0).sum())
    return stats


def fold_quadrant_separable(op: SeparableOperator):
    """(y_band, x_band, out_transpose): quadrant folded into the tables.

    The quadrant pre-rotation (Source.cpp:159-172) is a permutation of
    source cells, so for a separable operator it folds into the 1-D
    bands instead of materialising ``rot90(src)`` (a full read and write
    of the large source).  With A the ORIGINAL image, B = rot90(A, -q),
    and the apply out = Wy @ B @ Wx^T:

      q=0:  out =   Wy      @ A @  Wx^T
      q=1:  out = ((Wx P_H) @ A @  Wy^T)^T        B[i,j] = A[H-1-j, i]
      q=2:  out =  (Wy P_H) @ A @ (Wx P_W)^T      B[i,j] = A[H-1-i, W-1-j]
      q=3:  out = ( Wx      @ A @ (Wy P_W)^T)^T   B[i,j] = A[j, W-1-i]

    (P_n = source reversal, overlap1d.flip_band).  Quadrants 1/3 cost
    one transpose of the SMALL output instead of a rot90 of the large
    input; quadrant 2 costs nothing at all.
    """
    q = op.spec.quadrant % 4
    if q == 0:
        return op.wy, op.wx, False
    if q == 1:
        return overlap1d.flip_band(op.wx), op.wy, True
    if q == 2:
        return overlap1d.flip_band(op.wy), overlap1d.flip_band(op.wx), False
    return op.wx, overlap1d.flip_band(op.wy), True
