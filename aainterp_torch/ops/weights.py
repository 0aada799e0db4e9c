"""Weight-generation: the resampling operators from a GridSpec.

Counterpart of ``aainterp/ops/weights.py`` (host numpy float64, carried
over): the separable operator (axis-aligned geometries), its composition
(``compose_separable``) and the ELL operator (rotated geometries; modes
exact, fast and the reference-compatible compat of ``ops/compat.py``),
with the operator sanitizer, the squared operator of variance maps and
the quadrant folds.  ``ell_weights_torch`` is the ELL weight-gen on
tensors (any device, float32 by default), the counterpart of the JAX
package's jax.numpy path that its fused route runs on the device.

Weight-gen is a data-independent stage producing a static-shape operator
with ``dst = (Wy @ q) @ Wx.T`` where each row of Wy / Wx is pre-normalised
to sum to 1 (rows with ~zero total overlap are all-zero, reproducing the
reference's ``dst = 0`` fallback at Source.cpp:577/905).  The overlap
area factors into 1-D interval overlaps per axis; normalisation also
factors (sumArea = (sum wy)*(sum wx)), so each axis band is
row-normalised.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
import warnings
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..grids import DBL_EPSILON, GridSpec
from ..utils.digest import array_digest
from ..utils.lru import LruDict
from . import compat as compat_ops
from . import overlap1d
from .clipper import (quad_rect_overlap_area, quad_rect_overlap_area_torch,
                      quad_vertices, quad_vertices_torch)

# folded quadrant ELL operators, content-keyed (fold_quadrant_ell_cached);
# the fold copies the (Hd, Wd, K, K) table, hundreds of MB at 2048^2
_FOLD_CACHE = LruDict(4, max_bytes=3 << 30, name="weights.fold")

# which engine built each ELL operator (ell_operator): 'native' or 'numpy'
WEIGHT_GEN_ENGINES = {"native": 0, "numpy": 0}


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


def compose_separable(outer: SeparableOperator,
                      inner: SeparableOperator) -> SeparableOperator:
    """Fuse two axis-aligned resampling stages into ONE operator.

    ``inner`` maps the source grid to an intermediate grid, ``outer``
    maps that intermediate to the final grid; the returned operator is
    their exact matrix product per axis (overlap1d.compose_band, float64
    host arithmetic), so a chained pipeline runs as a single banded
    apply: one pass over the pixels, the intermediate image never
    materialised, every apply and autograd path available unchanged.
    Row-normalised stages compose to a row-normalised operator (rows of
    W2 @ W1 sum to 1).

    Both stages must be quadrant-0 (fold a quadrant rotation into one of
    the stages before composing).  Metadata: dst-side fields (shape,
    side, isocenter, raw_row_sums, mode) come from ``outer``; source-
    side fields from ``inner``.
    """
    if inner.spec.quadrant != 0 or outer.spec.quadrant != 0:
        raise ValueError(
            "compose_separable requires quadrant-0 stages (fold the "
            "rot90 into a single stage before composing)")
    if (outer.wy.n_src, outer.wx.n_src) != (inner.wy.n_dst,
                                            inner.wx.n_dst):
        raise ValueError(
            f"stage shapes don't chain: outer source "
            f"{(outer.wy.n_src, outer.wx.n_src)} != inner dst "
            f"{(inner.wy.n_dst, inner.wx.n_dst)}")
    spec = dataclasses.replace(
        outer.spec,
        src_shape=inner.spec.src_shape,
        src_resolution=inner.spec.src_resolution,
        src_isocenter=inner.spec.src_isocenter,
        scale=inner.spec.scale,
        qrot_shape=inner.spec.qrot_shape,
        mod_shape=inner.spec.mod_shape,
        mod_isocenter=inner.spec.mod_isocenter,
    )
    return SeparableOperator(
        spec=spec,
        wy=overlap1d.compose_band(outer.wy, inner.wy),
        wx=overlap1d.compose_band(outer.wx, inner.wx),
        raw_row_sums=outer.raw_row_sums,
        mode=outer.mode,
    )


@dataclasses.dataclass(frozen=True)
class EllOperator:
    """Fixed-window sparse operator for rotated resampling.

    ``weights[dy, dx, a, b]`` multiplies the quadrant-rotated source cell
    ``(base[dy, dx, 0] + a, base[dy, dx, 1] + b)``; rows are pre-normalised.
    """

    spec: GridSpec
    base: np.ndarray     # (Hd, Wd, 2) int32 — (jy0, jx0)
    weights: np.ndarray  # (Hd, Wd, K, K)
    raw_row_sums: np.ndarray  # (Hd, Wd) pre-normalisation overlap totals
    mode: str = "exact"

    @property
    def window(self) -> int:
        return self.weights.shape[-1]

    def dense(self) -> np.ndarray:
        """(Hd*Wd, qH*qW) dense matrix — tests only."""
        qH, qW = self.spec.qrot_shape
        Hd, Wd = self.spec.dst_shape
        K = self.window
        W = np.zeros((Hd * Wd, qH * qW), dtype=self.weights.dtype)
        for dy in range(Hd):
            for dx in range(Wd):
                jy0, jx0 = self.base[dy, dx]
                for a in range(K):
                    for b in range(K):
                        jy, jx = jy0 + a, jx0 + b
                        if 0 <= jy < qH and 0 <= jx < qW:
                            W[dy * Wd + dx, jy * qW + jx] = self.weights[
                                dy, dx, a, b
                            ]
        return W


class OperatorValidationError(ValueError):
    """A built/loaded operator failed the numerical sanitizer."""


def _check(cond, msg) -> None:
    # not `assert`: must survive python -O (production serving)
    if not cond:
        raise OperatorValidationError(msg)


def validate_operator(op) -> dict:
    """Numerical sanitizer for a built separable or ELL operator.

    Checks: finite weights; normalised rows sum to 1 (or exactly 0 for
    empty footprints); raw row sums within [0, the bound of the
    weight-gen mode]; ELL window bases inside the rotated source.
    Returns a dict of stats; raises OperatorValidationError on violation.
    """
    if not isinstance(op, (SeparableOperator, EllOperator)):
        raise TypeError(f"validate_operator takes a SeparableOperator or "
                        f"an EllOperator, got {type(op).__name__}")
    L = op.spec.dst_side
    mode = op.mode
    # per-axis raw-sum upper bound by weight-gen semantics:
    #  exact — true overlap length, <= L
    #  compat — the reference's type-2 defect can overcount its areas
    #  fast — raw sums are COUNTS of unit-spaced replica centers inside the
    #         L-side footprint (Source.cpp:899-905), at most floor(L)+1
    if mode == "fast":
        bound_1d = math.floor(L + 1e-9) + 1.0
        # rotated footprint: centers inside the square lie in its bbox of
        # side L*(|cos|+|sin|)
        span = L * (abs(op.spec.cos) + abs(op.spec.sin))
        bound_2d = (math.floor(span + 1e-9) + 1.0) ** 2
    elif mode == "compat":
        bound_1d = 2.0 * L
        bound_2d = 2.0 * L * L
    else:
        bound_1d = L * (1.0 + 1e-9)
        bound_2d = L * L * (1.0 + 1e-9)
    if isinstance(op, SeparableOperator):
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
    w = op.weights
    _check(np.isfinite(w).all(), "non-finite ELL weights")
    rs = w.sum(axis=(-1, -2))
    ok = np.isclose(rs, 1.0, atol=1e-9) | (rs == 0.0)
    _check(ok.all(), "ELL rows not normalised")
    _check((op.raw_row_sums >= -1e-12).all(), "negative ELL raw sums")
    _check((op.raw_row_sums <= bound_2d + 1e-9).all(),
           f"ELL raw sums exceed the {mode} bound {bound_2d}")
    qH, qW = op.spec.qrot_shape
    K = op.window
    _check((op.base >= 0).all(), "negative ELL window base")
    _check((op.base[..., 0] + K <= max(qH, K)).all(),
           "ELL window base exceeds rotated rows")
    _check((op.base[..., 1] + K <= max(qW, K)).all(),
           "ELL window base exceeds rotated cols")
    return {"zero_rows": int((rs == 0.0).sum())}


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


def _window_base(p, radius, scale, n, K):
    """First candidate cell index covering [p - radius, p + radius], clamped.

    Smallest j with j*scale + scale - 0.5 > p - radius; clamped to [0, n-K]
    so gathers are in-range (out-of-range cells are masked to weight 0, and
    the clamp never shifts a genuinely-overlapping in-range cell out of the
    window — see window-size bound in GridSpec.window_cells).
    """
    j0 = np.floor((p - radius + 0.5) / scale - 1.0).astype(np.int32) + 1
    return np.clip(j0, 0, max(n - K, 0))


def ell_weights(
    spec: GridSpec,
    mode: str = "exact",
    dy_slice: Optional[Tuple[int, int]] = None,
):
    """Compute (base, weights, raw_sums) for dst rows [dy0, dy1), float64,
    rows normalised.

    Static output shapes: (R, Wd, 2), (R, Wd, K, K), (R, Wd).
    """
    dtype = np.float64
    Hd, Wd = spec.dst_shape
    dy0, dy1 = dy_slice if dy_slice is not None else (0, Hd)
    R = dy1 - dy0
    K = spec.window_cells
    qH, qW = spec.qrot_shape
    s = float(spec.scale)
    L = spec.dst_side
    c, sn = spec.cos, spec.sin

    p00, ex, ey = spec.linear_map
    dx = np.arange(Wd, dtype=dtype)
    dy = np.arange(dy0, dy1, dtype=dtype)
    px = p00[0] + dx[None, :] * ex[0] + dy[:, None] * ey[0]   # (R, Wd)
    py = p00[1] + dx[None, :] * ex[1] + dy[:, None] * ey[1]

    radius = L * (abs(c) + abs(sn)) / 2.0
    jy0 = _window_base(py, radius, s, qH, K)                   # (R, Wd)
    jx0 = _window_base(px, radius, s, qW, K)

    a = np.arange(K, dtype=dtype)
    jy = jy0[..., None].astype(dtype) + a                      # (R, Wd, K)
    jx = jx0[..., None].astype(dtype) + a

    # local coordinates relative to the dst pixel center (px, py)
    # candidate cell rectangles: [j*s - 0.5 - p, j*s + s - 0.5 - p]
    cell_ylo = jy * s - 0.5 - py[..., None]
    cell_xlo = jx * s - 0.5 - px[..., None]

    if mode == "exact":
        zero = np.zeros((R, Wd), dtype=dtype)
        qx, qy = quad_vertices(zero, zero, L, c, sn)           # (R, Wd, 4)
        # broadcast to (R, Wd, K, K)
        lo_y = cell_ylo[..., :, None] + np.zeros_like(cell_xlo[..., None, :])
        lo_x = cell_xlo[..., None, :] + np.zeros_like(cell_ylo[..., :, None])
        w = quad_rect_overlap_area(
            np.broadcast_to(qx[..., None, None, :], (R, Wd, K, K, 4)),
            np.broadcast_to(qy[..., None, None, :], (R, Wd, K, K, 4)),
            lo_x,
            lo_y,
            lo_x + s,
            lo_y + s,
        )
        # zero out numerical slivers: the clamp-clip shoelace leaves
        # O(eps * extent^2) noise on empty/tangent overlaps; without this, a
        # dst pixel whose footprint misses the image entirely would normalise
        # noise into a garbage value (the reference gets exact zeros there via
        # its empty search window, Source.cpp:426-429/577)
        extent = K * s + L
        machine_eps = float(np.finfo(np.dtype(dtype)).eps)
        sliver = 64.0 * machine_eps * extent * extent
        w = np.where(w > sliver, w, np.zeros_like(w))
    elif mode == "fast":
        # count replica centers (j*s + m) inside the rotated dst square:
        # |R(theta) (center - p)|_inf <= L/2 (boundary inclusive, matching the
        # DBL_EPSILON-fuzzed ray cast at Source.cpp:837-864)
        eps = 1e-9
        w = np.zeros((R, Wd, K, K), dtype=dtype)
        scale_i = int(spec.scale)
        for my in range(scale_i):
            for mx in range(scale_i):
                cy = (cell_ylo + 0.5 + my)[..., :, None]       # (R, Wd, K, 1)
                cx = (cell_xlo + 0.5 + mx)[..., None, :]       # (R, Wd, 1, K)
                u = cx * c - cy * sn
                v = cx * sn + cy * c
                inside = np.logical_and(
                    np.abs(u) <= L / 2.0 + eps, np.abs(v) <= L / 2.0 + eps
                )
                w = w + inside.astype(dtype)
    else:
        raise ValueError(f"unknown mode {mode!r}")

    # mask out-of-range cells
    valid = np.logical_and(
        np.logical_and(jy[..., :, None] >= 0, jy[..., :, None] <= qH - 1),
        np.logical_and(jx[..., None, :] >= 0, jx[..., None, :] <= qW - 1),
    )
    w = np.where(valid, w, np.zeros_like(w))

    sums = np.sum(w, axis=(-1, -2))
    guard = DBL_EPSILON
    safe = np.where(np.abs(sums) > guard, sums, np.ones_like(sums))
    w = np.where(
        (np.abs(sums) > guard)[..., None, None], w / safe[..., None, None],
        np.zeros_like(w),
    )
    base = np.stack([jy0, jx0], axis=-1)
    return base, w, sums


def _window_base_torch(p, radius, scale, n, K):
    """``_window_base`` on a tensor: int32 first candidate cells."""
    j0 = torch.floor((p - radius + 0.5) / scale - 1.0).to(torch.int32) + 1
    return torch.clamp(j0, 0, max(n - K, 0))


def ell_weights_torch(
    spec: GridSpec,
    mode: str = "exact",
    dy_slice: Optional[Tuple[int, int]] = None,
    *,
    device=None,
    dtype: torch.dtype = torch.float32,
):
    """``ell_weights`` on tensors, on ``device`` in ``dtype``: (base (R, Wd,
    2) int32, weights (R, Wd, K, K), sums (R, Wd)) for dst rows [dy0, dy1),
    rows normalised.

    The counterpart of the JAX package's jax.numpy path (weights.py:271-
    386), which its fused route runs on the device in float32: the same
    operations in the same order.  Geometry in dst-local coordinates keeps
    float32 accurate to about 1e-6.  The float32 normalisation guard is
    1e-12, as there.
    """
    Hd, Wd = spec.dst_shape
    dy0, dy1 = dy_slice if dy_slice is not None else (0, Hd)
    R = dy1 - dy0
    K = spec.window_cells
    qH, qW = spec.qrot_shape
    s = float(spec.scale)
    L = float(spec.dst_side)
    c, sn = float(spec.cos), float(spec.sin)

    p00, ex, ey = (tuple(float(v) for v in t) for t in spec.linear_map)
    dx = torch.arange(Wd, dtype=dtype, device=device)
    dy = torch.arange(dy0, dy1, dtype=dtype, device=device)
    px = p00[0] + dx[None, :] * ex[0] + dy[:, None] * ey[0]   # (R, Wd)
    py = p00[1] + dx[None, :] * ex[1] + dy[:, None] * ey[1]

    radius = L * (abs(c) + abs(sn)) / 2.0
    jy0 = _window_base_torch(py, radius, s, qH, K)             # (R, Wd)
    jx0 = _window_base_torch(px, radius, s, qW, K)

    a = torch.arange(K, dtype=dtype, device=device)
    jy = jy0[..., None].to(dtype) + a                          # (R, Wd, K)
    jx = jx0[..., None].to(dtype) + a

    # local coordinates relative to the dst pixel center (px, py)
    cell_ylo = jy * s - 0.5 - py[..., None]
    cell_xlo = jx * s - 0.5 - px[..., None]

    if mode == "exact":
        zero = torch.zeros((R, Wd), dtype=dtype, device=device)
        qx, qy = quad_vertices_torch(zero, zero, L, c, sn)     # (R, Wd, 4)
        lo_y = (cell_ylo[..., :, None]
                + torch.zeros_like(cell_xlo[..., None, :]))
        lo_x = (cell_xlo[..., None, :]
                + torch.zeros_like(cell_ylo[..., :, None]))
        w = quad_rect_overlap_area_torch(
            qx[..., None, None, :].expand(R, Wd, K, K, 4),
            qy[..., None, None, :].expand(R, Wd, K, K, 4),
            lo_x,
            lo_y,
            lo_x + s,
            lo_y + s,
        )
        # zero out numerical slivers (see ell_weights)
        extent = K * s + L
        sliver = 64.0 * torch.finfo(dtype).eps * extent * extent
        w = torch.where(w > sliver, w, torch.zeros_like(w))
    elif mode == "fast":
        # count replica centers inside the rotated dst square (ell_weights)
        eps = 1e-9
        w = torch.zeros((R, Wd, K, K), dtype=dtype, device=device)
        scale_i = int(spec.scale)
        for my in range(scale_i):
            for mx in range(scale_i):
                cy = (cell_ylo + 0.5 + my)[..., :, None]       # (R, Wd, K, 1)
                cx = (cell_xlo + 0.5 + mx)[..., None, :]       # (R, Wd, 1, K)
                u = cx * c - cy * sn
                v = cx * sn + cy * c
                inside = torch.logical_and(
                    torch.abs(u) <= L / 2.0 + eps,
                    torch.abs(v) <= L / 2.0 + eps)
                w = w + inside.to(dtype)
    else:
        raise ValueError(f"unknown mode {mode!r}")

    # mask out-of-range cells
    valid = torch.logical_and(
        torch.logical_and(jy[..., :, None] >= 0, jy[..., :, None] <= qH - 1),
        torch.logical_and(jx[..., None, :] >= 0, jx[..., None, :] <= qW - 1),
    )
    w = torch.where(valid, w, torch.zeros_like(w))

    sums = torch.sum(w, dim=(-1, -2))
    guard = DBL_EPSILON if dtype == torch.float64 else 1e-12
    safe = torch.where(torch.abs(sums) > guard, sums, torch.ones_like(sums))
    w = torch.where(
        (torch.abs(sums) > guard)[..., None, None], w / safe[..., None, None],
        torch.zeros_like(w),
    )
    base = torch.stack([jy0, jx0], dim=-1)
    return base, w, sums


def _compat_operator(spec: GridSpec, row_chunk: int,
                     prefer_native: bool) -> EllOperator:
    """The compat ELL operator, chunked over dst rows (the per-cell state
    machine is memory-heavy), as weights.py:399-419 does; ``row_chunk``
    rows at a time, or the JAX package's sizing where it is <= 0."""
    Hd, Wd = spec.dst_shape
    Km = spec.window_cells  # proxy for sizing
    chunk = (row_chunk if row_chunk > 0
             else max(1, int(2.0e6 / max(Wd * Km * Km, 1))))
    numpy_before = compat_ops.ENGINES["numpy"]
    base = None
    for dy0 in range(0, Hd, chunk):
        dy1 = min(dy0 + chunk, Hd)
        b, w_c, s_c = compat_ops.compat_ell_weights(
            spec, dy_slice=(dy0, dy1), prefer_native=prefer_native)
        if base is None:
            Kc = w_c.shape[-1]
            base = np.empty((Hd, Wd, 2), dtype=np.int32)
            w = np.empty((Hd, Wd, Kc, Kc), dtype=np.float64)
            sums = np.empty((Hd, Wd), dtype=np.float64)
        base[dy0:dy1] = b
        w[dy0:dy1] = w_c
        sums[dy0:dy1] = s_c
    engine = ("numpy" if compat_ops.ENGINES["numpy"] > numpy_before
              else "native")
    WEIGHT_GEN_ENGINES[engine] += 1
    return EllOperator(spec=spec, base=base, weights=w, raw_row_sums=sums,
                       mode="compat")


def ell_operator(spec: GridSpec, mode: str = "exact", row_chunk: int = 0,
                 prefer_native: bool = True) -> EllOperator:
    """Host (float64) ELL operator, modes 'exact', 'fast' and 'compat'.

    Uses the multithreaded native C++ engine (``aainterp_torch.native``,
    built with g++ at first use; about 10-50x the numpy path on large
    grids, equal to it within 1e-13 in modes exact and fast and bit for
    bit in compat), falling back to numpy chunked over dst rows with a
    RuntimeWarning when the engine cannot be built or loaded.
    ``WEIGHT_GEN_ENGINES`` counts which engine ran ('numpy' where any
    chunk of a compat operator took the replica).  The compat window
    (``ops/compat.py``) may exceed ``spec.window_cells``.  ``row_chunk``
    sets the dst rows per chunk of the numpy and compat paths (<= 0: sized
    to bound their temporaries); chunking changes no value.
    """
    if mode == "compat":
        return _compat_operator(spec, row_chunk, prefer_native)
    if mode not in ("exact", "fast"):
        raise ValueError(f"unknown mode {mode!r}")
    if prefer_native:
        from .. import native

        try:
            base, w, sums = native.ell_weights_native(spec, mode=mode)
        except (RuntimeError, OSError, AttributeError, TypeError,
                ValueError, ctypes.ArgumentError) as e:
            # observable fallback: the numpy weight-gen is correct, but a
            # silent ~30x slowdown would hide a broken native build
            warnings.warn(
                f"native weight-gen failed ({type(e).__name__}: {e}); "
                "falling back to the numpy path", RuntimeWarning)
        else:
            WEIGHT_GEN_ENGINES["native"] += 1
            return EllOperator(spec=spec, base=base, weights=w,
                               raw_row_sums=sums, mode=mode)
    Hd, Wd = spec.dst_shape
    K = spec.window_cells
    if row_chunk <= 0:
        # keep the clip batch (~36 vertices * a few temporaries, float64)
        # around a few hundred MB
        row_chunk = max(1, int(8.0e6 / max(Wd * K * K, 1)))
    base = np.empty((Hd, Wd, 2), dtype=np.int32)
    weights = np.empty((Hd, Wd, K, K), dtype=np.float64)
    sums = np.empty((Hd, Wd), dtype=np.float64)
    for dy0 in range(0, Hd, row_chunk):
        dy1 = min(dy0 + row_chunk, Hd)
        b, w, sm = ell_weights(spec, mode=mode, dy_slice=(dy0, dy1))
        base[dy0:dy1] = b
        weights[dy0:dy1] = w
        sums[dy0:dy1] = sm
    WEIGHT_GEN_ENGINES["numpy"] += 1
    return EllOperator(spec=spec, base=base, weights=weights,
                       raw_row_sums=sums, mode=mode)


def squared_operator(op):
    """The same operator with elementwise-SQUARED weights.

    For a linear resampling ``out = sum_j w_j x_j`` of independent
    pixels, ``Var(out) = sum_j w_j^2 Var(x_j)`` — and the squared
    operator stays banded/separable (the combined separable weight
    wy*wx squares to wy^2 * wx^2), so variance maps ride the exact same
    apply kernels.  Row sums are intentionally NOT renormalised (they
    are < 1 for any genuine average); do not validate_operator the
    result.  raw_row_sums are kept from the parent (unused by applies).
    """
    if isinstance(op, SeparableOperator):
        def sq(b: overlap1d.Band1D) -> overlap1d.Band1D:
            return overlap1d.Band1D(start=b.start, weights=b.weights ** 2,
                                    n_src=b.n_src, n_dst=b.n_dst)

        return dataclasses.replace(op, wy=sq(op.wy), wx=sq(op.wx))
    if isinstance(op, EllOperator):
        return dataclasses.replace(op, weights=op.weights ** 2)
    raise TypeError(f"unknown operator type {type(op)!r}")


def fold_quadrant_ell(op: EllOperator):
    """Fold the quadrant pre-rotation into the ELL table itself.

    The op consumes B = rot90(A, -quadrant) (Source.cpp:159-172, cell
    permutation); every K x K window of B is a (flipped/transposed) K x K
    window of the ORIGINAL image A, so the rotation folds into the table:
    re-indexed bases + tap-permuted weights that consume A directly.  To
    keep the folded base_y monotone in the table row (the property the
    shear decomposition relies on), the dst index is permuted by the
    matching axis map, so the folded tables have exactly the un-rotated
    +theta structure again and build_shear_plan's gy/hx serve them
    unchanged.

    Returns ``(folded_op, post)`` or ``None`` for quadrant 0:

    * ``folded_op`` — EllOperator with quadrant=0 whose source is A
      (qrot_shape = A.shape) and whose dst axes are permuted
      (transposed for quadrants 1/3); ``raw_row_sums`` ride the same
      permutation.
    * ``post`` — torch callable mapping the folded output (trailing two
      axes) back to the true dst orientation: a dst-sized flip /
      transpose, r^2 cheaper than the source-sized rot90 at ratio r.

    Zero-weight clamped fringe taps are preserved by construction
    (apply_ell clamps indices; clamped taps carry zero weight).
    """
    q = op.spec.quadrant % 4
    if q == 0:
        return None
    qH, qW = op.spec.qrot_shape
    K = op.window
    base = np.asarray(op.base)
    w = np.asarray(op.weights)
    rrs = np.asarray(op.raw_row_sums)
    by, bx = base[..., 0], base[..., 1]
    # A (original source) shape: rot90 swaps axes for quadrants 1/3
    H, W = (qW, qH) if q in (1, 3) else (qH, qW)
    if q == 1:
        # B[i, j] = A[H-1-j, i]: window base (H-K-bx, by), taps
        # (a, b) = (K-1-dx, dy)
        nb_y, nb_x = H - K - bx, by
        nw = np.swapaxes(w[..., :, ::-1], -1, -2)
        dst_perm = (lambda x: np.swapaxes(x[::-1], 0, 1))
        post = (lambda t: torch.flip(torch.transpose(t, -2, -1), dims=(-2,)))
    elif q == 2:
        # B[i, j] = A[H-1-i, W-1-j]: base (H-K-by, W-K-bx), taps reversed
        nb_y, nb_x = H - K - by, W - K - bx
        nw = w[..., ::-1, ::-1]
        dst_perm = (lambda x: x[::-1, ::-1])
        post = (lambda t: torch.flip(t, dims=(-2, -1)))
    else:
        # B[i, j] = A[j, W-1-i]: base (bx, W-K-by), taps (K-1-dy -> b)
        nb_y, nb_x = bx, W - K - by
        nw = np.swapaxes(w[..., ::-1, :], -1, -2)
        dst_perm = (lambda x: np.swapaxes(x[:, ::-1], 0, 1))
        post = (lambda t: torch.flip(torch.transpose(t, -2, -1), dims=(-1,)))
    nb = np.stack([dst_perm(nb_y), dst_perm(nb_x)], axis=-1)
    nw = np.ascontiguousarray(dst_perm(nw))
    spec2 = dataclasses.replace(
        op.spec, quadrant=0, qrot_shape=(H, W),
        dst_shape=tuple(int(s) for s in nw.shape[:2]))
    folded = EllOperator(
        spec=spec2, base=np.ascontiguousarray(nb).astype(base.dtype),
        weights=nw, raw_row_sums=np.ascontiguousarray(dst_perm(rrs)),
        mode=op.mode)
    return folded, post


def fold_quadrant_ell_cached(op: EllOperator):
    """LRU-cached fold_quadrant_ell, keyed by table content.

    The fold copies the (Hd, Wd, K, K) table; content-keyed reuse makes
    repeat calls free.  quadrant/qrot_shape are part of the key: at exact
    90-deg multiples different quadrants share identical tables.
    raw_row_sums and mode join the key too, so two operators with equal
    normalised weights but differently scaled cell areas do not alias.
    """
    key = (array_digest(op.weights), array_digest(op.base),
           array_digest(op.raw_row_sums), op.mode,
           op.spec.quadrant, op.spec.qrot_shape)
    hit = _FOLD_CACHE.get(key)
    if hit is None:
        hit = fold_quadrant_ell(op)
        _FOLD_CACHE.put(key, hit)
    return hit


def fold_tables_device(base: torch.Tensor, w: torch.Tensor, quadrant: int,
                       qH: int, qW: int):
    """The quadrant fold of explicit ELL tables, on their own device.

    ``base`` (Hd, Wd, 2) and ``w`` (Hd, Wd, K, K) are tensors standing in
    for an operator's own tables; ``qH, qW`` are the unfolded operator's
    ``qrot_shape``.  Returns (folded_base, folded_weights), bit-equal to
    ``fold_quadrant_ell`` of the same host tables: the weights are
    permuted by flips and transposes, never recomputed.  Quadrant 0
    returns the tables unchanged.
    """
    q = quadrant % 4
    if q == 0:
        return base, w
    K = w.shape[-1]
    by, bx = base[..., 0], base[..., 1]
    H, W = (qW, qH) if q in (1, 3) else (qH, qW)
    if q == 1:
        nb_y, nb_x = H - K - bx, by
        nw = w.flip(-1).transpose(-1, -2)
        dst_perm = (lambda x: x.flip(0).transpose(0, 1))
    elif q == 2:
        nb_y, nb_x = H - K - by, W - K - bx
        nw = w.flip(-2, -1)
        dst_perm = (lambda x: x.flip(0, 1))
    else:
        nb_y, nb_x = bx, W - K - by
        nw = w.flip(-2).transpose(-1, -2)
        dst_perm = (lambda x: x.flip(1).transpose(0, 1))
    nb = torch.stack([dst_perm(nb_y), dst_perm(nb_x)], dim=-1)
    return nb.to(base.dtype).contiguous(), dst_perm(nw).contiguous()


def ell_fold_post_inv(quadrant: int) -> Optional[Callable]:
    """Inverse of fold_quadrant_ell's ``post`` dst permutation, or None.

    ``post`` maps the folded-orientation output to the true dst; its
    inverse carries dst cotangents (or any true-dst array) back into the
    folded orientation — permutations transpose to their inverses, so
    this is also the VJP of ``post``.
    """
    q = quadrant % 4
    if q == 0:
        return None
    if q == 1:
        # post: out[r, c] = t[c, Hd-1-r]  ->  inv: t[R, C] = y[Hd-1-C, R]
        return lambda y: torch.transpose(torch.flip(y, dims=(-2,)), -2, -1)
    if q == 2:
        return lambda y: torch.flip(y, dims=(-2, -1))
    # post: out[r, c] = t[Wd-1-c, r]  ->  inv: t[R, C] = y[C, Wd-1-R]
    return lambda y: torch.flip(torch.transpose(y, -2, -1), dims=(-2,))
