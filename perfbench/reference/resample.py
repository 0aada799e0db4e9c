"""Plain area-average resampling, worked out again from the geometry.

Three functions of the same frames, each in plain torch on any device:

* ``separable``: an axis-aligned geometry, the 1-D interval overlaps of
  each destination interval with the source cells, rows normalised;
* ``rotated``: a rotated geometry in mode 'exact', the overlap areas of
  each rotated destination square with the source cells, rows
  normalised;
* ``shear_xyx``: a rotated geometry in mode 'shear' with the 'quality'
  decomposition, three axis-aligned conservative passes (a translate at
  source pitch along x, a translate and an interval band along y, the
  same along x), then a multiply by the reciprocal coverage.

``dtype`` is the arithmetic: float64 for the reference, bfloat16 for the
control, where every product and every sum is rounded to bf16.  Each
function returns the values before the output's own rounding, in
``dtype``.  ``mid_dtype`` (shear only) rounds the first two passes'
outputs as the configuration states.  Frames are (F, H, W) of any dtype.

Imports nothing of the program under test.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .geometry import DBL_EPSILON, Geometry

# destination cells per block of the rotated weight-gen
_CELLS_PER_BLOCK = 1 << 21
# frames per block of an apply
_FRAMES_PER_BLOCK = 8


def quadrant_turn(x: torch.Tensor, quadrant: int) -> torch.Tensor:
    """The reference's pre-rotation: quadrant k turns the image k * 90
    degrees clockwise."""
    return x if quadrant % 4 == 0 else torch.rot90(x, k=-quadrant,
                                                   dims=(-2, -1))


def _normalise(w: torch.Tensor) -> torch.Tensor:
    """Rows (the last axis) divided by their sums; rows whose total
    overlap is at most DBL_EPSILON give 0 (Source.cpp:577)."""
    s = w.sum(dim=-1, keepdim=True)
    ok = s > DBL_EPSILON
    return torch.where(ok, w / torch.where(ok, s, torch.ones_like(s)),
                       torch.zeros_like(w))


# ----------------------------------------------------------------------
# banded 1-D operators: (start, weights) with out-of-range taps at 0
# ----------------------------------------------------------------------


def _band_apply(x: torch.Tensor, start: torch.Tensor, w: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """out[..., i] = sum_k w[i, k] * x[..., start[i] + k] along the last
    axis, in ``dtype``, taps in order; w is 0 where the tap is outside."""
    n = x.shape[-1]
    xd = x.to(dtype)
    wd = w.to(dtype)
    out = torch.zeros(x.shape[:-1] + (w.shape[0],), dtype=dtype,
                      device=x.device)
    for k in range(w.shape[1]):
        j = (start + k).clamp(0, n - 1)
        out = out + wd[:, k] * xd[..., j]
    return out


def _interval_overlaps(lo: torch.Tensor, length: float, edge0: float,
                       pitch: float, n_src: int):
    """Band of the overlaps of [lo_i, lo_i + length] with the source
    cells [edge0 + j*pitch, edge0 + (j+1)*pitch), j in [0, n_src)."""
    taps = int(math.floor(length / pitch)) + 2
    start = torch.floor((lo - edge0) / pitch - 1.0).to(torch.int64) + 1
    j = start[:, None] + torch.arange(taps, device=lo.device)[None, :]
    c_lo = edge0 + j.to(torch.float64) * pitch
    w = (torch.minimum(lo[:, None] + length, c_lo + pitch)
         - torch.maximum(lo[:, None], c_lo)).clamp_min(0.0)
    w = torch.where((j >= 0) & (j < n_src), w, torch.zeros_like(w))
    return start, w


# ----------------------------------------------------------------------
# axis-aligned: separable interval overlaps
# ----------------------------------------------------------------------


def separable_bands(geo: Geometry, device):
    """(start_y, wy, start_x, wx), rows normalised, float64."""
    if not geo.axis_aligned:
        raise ValueError("separable_bands needs an axis-aligned geometry")
    L, s = geo.side, float(geo.scale)
    bands = []
    for axis, n_dst, n_src in ((1, geo.dst_shape[0], geo.q_shape[0]),
                               (0, geo.dst_shape[1], geo.q_shape[1])):
        centre = geo.p00[axis] + L * torch.arange(
            n_dst, dtype=torch.float64, device=device)
        start, w = _interval_overlaps(centre - L / 2.0, L, -0.5, s, n_src)
        bands += [start, _normalise(w)]
    return tuple(bands)


def separable(geo: Geometry, x: torch.Tensor, dtype: torch.dtype,
              bands=None) -> torch.Tensor:
    """(F, H, W) -> (F, Hd, Wd): the y pass, then the x pass."""
    sy, wy, sx, wx = bands or separable_bands(geo, x.device)
    q = quadrant_turn(x, geo.quadrant)
    outs = []
    for f0 in range(0, q.shape[0], _FRAMES_PER_BLOCK):
        t = _band_apply(q[f0:f0 + _FRAMES_PER_BLOCK].transpose(-1, -2),
                        sy, wy, dtype)                   # (f, W, Hd)
        outs.append(_band_apply(t.transpose(-1, -2), sx, wx, dtype))
    return torch.cat(outs)


# ----------------------------------------------------------------------
# rotated, mode 'exact': overlap areas of a rotated square and a cell
# ----------------------------------------------------------------------


def _clip_t(n0: torch.Tensor, n1: torch.Tensor, t0, t1):
    """Narrow [t0, t1] to the t with n0 + t * n1 >= 0."""
    par = n1 == 0
    safe = torch.where(par, torch.ones_like(n1), n1)
    t = -n0 / safe
    t0 = torch.where(~par & (n1 > 0), torch.maximum(t0, t), t0)
    t1 = torch.where(~par & (n1 < 0), torch.minimum(t1, t), t1)
    # a segment parallel to the edge and outside it is empty
    t1 = torch.where(par & (n0 < 0), torch.full_like(t1, -1.0), t1)
    return t0, t1


def _segment_term(px, py, qx, qy, t0, t1):
    """0.5 * cross(A, B) of the part [t0, t1] of the segment P -> Q, 0
    where the part is empty."""
    dx, dy = qx - px, qy - py
    ax, ay = px + t0 * dx, py + t0 * dy
    bx, by = px + t1 * dx, py + t1 * dy
    term = 0.5 * (ax * by - bx * ay)
    return torch.where(t1 > t0, term, torch.zeros_like(term))


def quad_box_areas(quad, x0, y0, x1, y1):
    """Area of the convex quadrilateral ``quad`` (four (x, y) corners in
    counter-clockwise order, plain floats) within each box [x0, x1] x
    [y0, y1] (tensors of one shape).

    The boundary of the intersection is the part of each polygon's edges
    inside the other; the area is the sum of cross(A, B) / 2 over those
    parts.  An edge of the quadrilateral is clipped to the box on the
    box's four half-planes, an edge of the box to the quadrilateral on its
    four; no edge of one may lie along an edge of the other.
    """
    zero = torch.zeros_like(x0)
    one = torch.ones_like(x0)
    area = zero.clone()
    for k in range(4):
        (px, py), (qx, qy) = quad[k], quad[(k + 1) % 4]
        t0, t1 = zero, one
        dx, dy = zero + (qx - px), zero + (qy - py)
        # x >= x0, x <= x1, y >= y0, y <= y1 on X = P + t (Q - P)
        for n0, n1 in ((px - x0, dx), (x1 - px, -dx), (py - y0, dy),
                       (y1 - py, -dy)):
            t0, t1 = _clip_t(n0, n1, t0, t1)
        area = area + _segment_term(zero + px, zero + py, zero + qx,
                                    zero + qy, t0, t1)
    box = ((x0, y0), (x1, y0), (x1, y1), (x0, y1))
    for k in range(4):
        (px, py), (qx, qy) = box[k], box[(k + 1) % 4]
        t0, t1 = zero, one
        for e in range(4):
            (ex, ey), (fx, fy) = quad[e], quad[(e + 1) % 4]
            ux, uy = fx - ex, fy - ey
            # inside: cross(u, X - E) >= 0 on X = P + t (Q - P)
            n0 = ux * (py - ey) - uy * (px - ex)
            n1 = ux * (qy - py) - uy * (qx - px)
            t0, t1 = _clip_t(n0, n1, t0, t1)
        area = area + _segment_term(px, py, qx, qy, t0, t1)
    return area.abs()


def rotated_weights(geo: Geometry, device) -> Tuple[torch.Tensor, ...]:
    """(jy0, jx0, w): each destination cell's first candidate cell per
    axis, (Hd, Wd) int64, and its normalised overlaps with the n x n
    candidates, (Hd, Wd, n, n) float64.

    Overlaps at or below the program's sliver level, 64 * eps * (K*s +
    L)^2 with K its candidate window, count as none: areas that small
    are round-off of an empty or tangent overlap."""
    if geo.axis_aligned:
        raise ValueError("rotated_weights needs a rotated geometry")
    L, s = geo.side, float(geo.scale)
    c, sn = geo.cos, geo.sin
    h = L / 2.0
    # corners relative to the cell's centre, counter-clockwise
    quad = tuple((u * c + v * sn, -u * sn + v * c)
                 for u, v in ((-h, -h), (h, -h), (h, h), (-h, h)))
    r = h * (abs(c) + abs(sn))
    n = int(math.ceil(2.0 * r / s)) + 1
    sliver = 64.0 * 2.220446049250313e-16 * (geo.window * s + L) ** 2
    Hd, Wd = geo.dst_shape
    qH, qW = geo.q_shape
    rows = max(1, _CELLS_PER_BLOCK // max(Wd * n * n, 1))
    f64 = dict(dtype=torch.float64, device=device)
    k = torch.arange(n, device=device)
    jy0s, jx0s, ws = [], [], []
    for dy0 in range(0, Hd, rows):
        dy = torch.arange(dy0, min(dy0 + rows, Hd), **f64)[:, None]
        dx = torch.arange(Wd, **f64)[None, :]
        px = geo.p00[0] + dx * geo.ex[0] + dy * geo.ey[0]
        py = geo.p00[1] + dx * geo.ex[1] + dy * geo.ey[1]
        jy0 = torch.floor((py - r + 0.5) / s - 1.0).to(torch.int64) + 1
        jx0 = torch.floor((px - r + 0.5) / s - 1.0).to(torch.int64) + 1
        jy = jy0[..., None, None] + k[:, None]
        jx = jx0[..., None, None] + k[None, :]
        y0 = jy.to(torch.float64) * s - 0.5 - py[..., None, None]
        x0 = jx.to(torch.float64) * s - 0.5 - px[..., None, None]
        y0, x0 = torch.broadcast_tensors(y0, x0)
        a = quad_box_areas(quad, x0, y0, x0 + s, y0 + s)
        inside = (jy >= 0) & (jy < qH) & (jx >= 0) & (jx < qW)
        a = torch.where(inside & (a > sliver), a, torch.zeros_like(a))
        shape = a.shape
        ws.append(_normalise(a.reshape(shape[:2] + (n * n,))).reshape(shape))
        jy0s.append(jy0)
        jx0s.append(jx0)
    return torch.cat(jy0s), torch.cat(jx0s), torch.cat(ws)


def rotated(geo: Geometry, x: torch.Tensor, dtype: torch.dtype,
            weights=None) -> torch.Tensor:
    """(F, H, W) -> (F, Hd, Wd): each output the overlap-weighted mean
    of its candidates, taps in row-major order."""
    jy0, jx0, w = weights or rotated_weights(geo, x.device)
    q = quadrant_turn(x, geo.quadrant)
    qH, qW = geo.q_shape
    Hd, Wd = geo.dst_shape
    n = w.shape[-1]
    wd = w.to(dtype)
    outs = []
    for f0 in range(0, q.shape[0], _FRAMES_PER_BLOCK):
        flat = q[f0:f0 + _FRAMES_PER_BLOCK].reshape(-1, qH * qW).to(dtype)
        acc = torch.zeros((flat.shape[0], Hd, Wd), dtype=dtype,
                          device=x.device)
        for a in range(n):
            iy = (jy0 + a).clamp(0, qH - 1)
            for b in range(n):
                idx = iy * qW + (jx0 + b).clamp(0, qW - 1)
                acc = acc + wd[..., a, b] * flat[:, idx]
        outs.append(acc)
    return torch.cat(outs)


# ----------------------------------------------------------------------
# rotated, mode 'shear', decomposition 'quality': x-y-x
# ----------------------------------------------------------------------


def _translate(x: torch.Tensor, delta: torch.Tensor, n_t: int, crop: int,
               n_out: int, dtype: torch.dtype) -> torch.Tensor:
    """Shift each line (axis -2) along the last axis by delta >= 0:
    out[u] = (1 - f) x[u - d] + f x[u - d - 1], d = floor(delta), f its
    fraction, taps outside at 0; then [crop, crop + n_out)."""
    d = torch.floor(delta)
    f = (delta - d).to(dtype)[:, None]
    d = d.to(torch.int64)[:, None]
    n_in = x.shape[-1]
    u = torch.arange(crop, crop + n_out, device=x.device)[None, :]
    out = torch.zeros(x.shape[:-1] + (n_out,), dtype=dtype, device=x.device)
    xd = x.to(dtype)
    for j, wt in ((u - d, 1 - f), (u - d - 1, f)):
        ok = (j >= 0) & (j < n_in) & (u < n_t)
        vals = torch.gather(xd, -1, j.clamp(0, n_in - 1).expand(
            x.shape[:-1] + (n_out,)))
        out = out + torch.where(ok, wt, torch.zeros_like(wt)) * vals
    return out


def _band(x: torch.Tensor, edge0: float, pitch: float, n_dst: int,
          dtype: torch.dtype) -> torch.Tensor:
    """Unit destination cells [i, i + 1) over source cells of ``pitch``
    from ``edge0``, along the last axis; weights are overlap lengths."""
    lo = torch.arange(n_dst, dtype=torch.float64, device=x.device)
    start, w = _interval_overlaps(lo, 1.0, edge0, pitch, x.shape[-1])
    return _band_apply(x, start, w, dtype)


def _pass(x, axis: str, delta, n_t: int, crop: int, n_out: int, band,
          dtype):
    """One pass along ``axis``: translate, then the band if any."""
    if axis == "y":
        x = x.transpose(-1, -2)
    if band is None:
        x = _translate(x, delta, n_t, crop, n_out, dtype)
    else:
        x = _translate(x, delta, n_t, 0, n_t, dtype)
        x = _band(x, band[0], band[1], n_out, dtype)
    return x.transpose(-1, -2) if axis == "y" else x


def shear_passes(geo: Geometry, device):
    """The three passes of the x-y-x decomposition, each (axis, delta,
    n_t, crop, n_out, band or None)."""
    if geo.axis_aligned:
        raise ValueError("shear_passes needs a rotated geometry")
    qH, qW = geo.q_shape
    Hd, Wd = geo.dst_shape
    s, L = float(geo.scale), geo.side
    c, n = geo.cos, geo.sin
    t = (1.0 - c) / n
    rho = s / L
    p0x, p0y = geo.p00
    C2 = (-n * p0x - c * p0y) / L
    C3 = (-c * p0x + n * p0y) / L + t * C2
    f64 = dict(dtype=torch.float64, device=device)

    # x1 = x - t*y: translate the rows at source pitch
    y_c = torch.arange(qH, **f64) * s + (s - 1.0) / 2.0
    delta1 = t * (y_c[-1] - y_c) / s
    W1 = qW + int(torch.floor(delta1).max()) + 2
    o1 = -0.5 - t * float(y_c[-1])
    passes = [("x", delta1, W1, 0, W1, None)]

    # dst_y = (n*x1 + y)/L + C2: translate the columns, then resample
    delta2 = n * torch.arange(W1, **f64)
    E2 = (n * (o1 + 0.5 * s) - 0.5) / L + C2
    if s == L:
        delta2 = delta2 + E2 + 0.5
        crop = max(0, math.ceil(-float(delta2.min())))
        delta2 = delta2 + crop
        H1 = max(crop + Hd, qH + int(torch.floor(delta2).max()) + 2)
        passes.append(("y", delta2, H1, crop, Hd, None))
    else:
        H1 = qH + int(torch.floor(delta2).max()) + 2
        passes.append(("y", delta2, H1, 0, Hd, (E2 + 0.5, rho)))

    # dst_x = x1/L - t*dst_y + C3: translate the rows, then resample
    v = torch.arange(Hd, **f64)
    delta3 = t * (v[-1] - v) * L / s
    E3 = o1 / L - t * (Hd - 1.0) + C3
    if s == L:
        delta3 = delta3 + E3 + 0.5
        crop = max(0, math.ceil(-float(delta3.min())))
        delta3 = delta3 + crop
        W2 = max(crop + Wd, W1 + int(torch.floor(delta3).max()) + 2)
        passes.append(("x", delta3, W2, crop, Wd, None))
    else:
        W2 = W1 + int(torch.floor(delta3).max()) + 2
        passes.append(("x", delta3, W2, 0, Wd, (E3 + 0.5, rho)))
    return passes


def _run_passes(x, passes, dtype, mid_dtype):
    for i, (axis, delta, n_t, crop, n_out, band) in enumerate(passes):
        x = _pass(x, axis, delta, n_t, crop, n_out, band, dtype)
        if mid_dtype is not None and i < len(passes) - 1:
            x = x.to(mid_dtype)
    return x


def shear_coverage(geo: Geometry, device, passes=None) -> torch.Tensor:
    """The reciprocal of the pipeline on a ones image (float64), 0 where
    that coverage is at most 1e-6."""
    passes = passes or shear_passes(geo, device)
    ones = torch.ones((1,) + geo.q_shape, dtype=torch.float64,
                      device=device)
    cov = _run_passes(ones, passes, torch.float64, None)[0]
    ok = cov > 1e-6
    return torch.where(ok, 1.0 / torch.where(ok, cov, torch.ones_like(cov)),
                       torch.zeros_like(cov))


def shear_xyx(geo: Geometry, x: torch.Tensor, dtype: torch.dtype,
              mid_dtype: Optional[torch.dtype] = None,
              tables=None) -> torch.Tensor:
    """(F, H, W) -> (F, Hd, Wd) through the three passes."""
    passes, inv_cov = tables or shear_tables(geo, x.device)
    q = quadrant_turn(x, geo.quadrant)
    outs = []
    for f0 in range(0, q.shape[0], _FRAMES_PER_BLOCK):
        y = _run_passes(q[f0:f0 + _FRAMES_PER_BLOCK], passes, dtype,
                        mid_dtype)
        outs.append(y * inv_cov.to(dtype))
    return torch.cat(outs)


def shear_tables(geo: Geometry, device):
    passes = shear_passes(geo, device)
    return passes, shear_coverage(geo, device, passes)
