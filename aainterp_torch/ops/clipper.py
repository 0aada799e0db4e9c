"""Exact quad∩cell overlap areas, branch-free and fully elementwise.

Counterpart of ``aainterp/ops/clipper.py``, carried over.  The numpy
path (host float64 weight-gen) does the same operations in the same
order, so its areas are bit-identical to the JAX package's numpy path.
The torch path (``quad_vertices_torch``, ``quad_rect_overlap_area_torch``;
any device and float dtype) repeats them on tensors, the counterpart of
the JAX package's jax.numpy path that the fused on-device weight-gen runs
in float32.

This routine replaces the reference's whole overlap-area engine
(Source.cpp:914-1431: intersection points and types, the per-cell state
machine, the 10-type polygon taxonomy and its tangency rules).

Algorithm: *clamp-form Sutherland–Hodgman* for axis-aligned boxes.
Clipping a closed chain against the half-plane pair {u >= lo, u <= hi}
clamps the u-coordinate of every vertex into [lo, hi] and inserts the
true line intersections of every crossing edge, in order along the edge.
Correctness rests on the line integral ∮x dy being path-independent along
a fixed clip line, so the clamped excursions outside the box contribute
exactly like the straight connection between their entry and exit
intersections.  Tangencies produce zero-length edges, with no case
analysis.  Vertex counts are static (4 -> 12 -> 36).

Callers pass coordinates relative to the dst-pixel center, so magnitudes
stay about the dst side length.
"""

from __future__ import annotations

import numpy as np
import torch


def _interleave3(a, b, c):
    """Stack three (..., N) arrays into (..., 3N) as a0,b0,c0,a1,b1,c1,..."""
    out = np.stack([a, b, c], axis=-1)
    return out.reshape(a.shape[:-1] + (3 * a.shape[-1],))


def _clamp_pass(u, w, lo, hi):
    """Clip the closed chain (u, w) against lo <= u <= hi (clamp form).

    u, w : (..., N) — u is the coordinate being clipped, w its partner.
    lo, hi : broadcastable to (..., 1).
    Returns (u', w') with N' = 3N vertices.
    """
    u_n = np.roll(u, -1, axis=-1)
    w_n = np.roll(w, -1, axis=-1)

    du = u_n - u
    safe = np.where(du != 0.0, du, 1.0)

    cross_lo = (u < lo) != (u_n < lo)
    cross_hi = (u > hi) != (u_n > hi)
    t_lo = np.where(cross_lo, (lo - u) / safe, 2.0)
    t_hi = np.where(cross_hi, (hi - u) / safe, 2.0)

    t1 = np.minimum(t_lo, t_hi)
    t2 = np.maximum(t_lo, t_hi)
    u1 = np.where(t_lo <= t_hi, lo + np.zeros_like(u), hi + np.zeros_like(u))
    u2 = np.where(t_lo <= t_hi, hi + np.zeros_like(u), lo + np.zeros_like(u))

    uc = np.clip(u, lo, hi)
    has1 = t1 <= 1.0
    has2 = t2 <= 1.0

    s1_u = np.where(has1, u1, uc)
    s1_w = np.where(has1, w + t1 * (w_n - w), w)
    s2_u = np.where(has2, u2, s1_u)
    s2_w = np.where(has2, w + t2 * (w_n - w), s1_w)

    return _interleave3(uc, s1_u, s2_u), _interleave3(w, s1_w, s2_w)


def _shoelace(x, y):
    x_n = np.roll(x, -1, axis=-1)
    y_n = np.roll(y, -1, axis=-1)
    return 0.5 * np.abs(np.sum(x * y_n - x_n * y, axis=-1))


def quad_rect_overlap_area(quad_x, quad_y, lo_x, lo_y, hi_x, hi_y):
    """Area of (convex quad) ∩ (axis-aligned rectangle), batched.

    quad_x, quad_y : (..., 4) quad vertices in boundary order
    lo_x, lo_y, hi_x, hi_y : (...,) rectangle bounds
    Returns (...,) areas.
    """
    vx, vy = _clamp_pass(quad_x, quad_y, lo_x[..., None], hi_x[..., None])
    vy, vx = _clamp_pass(vy, vx, lo_y[..., None], hi_y[..., None])
    return _shoelace(vx, vy)


def quad_vertices(px, py, dst_side, cos_v, sin_v):
    """Corners of the rotated dst pixel centered at (px, py).

    The dst pixel is a square of side ``dst_side`` rotated by the inverse
    residual rotation R_inv = [[c, s], [-s, c]] (Source.cpp:229-305,
    419-422), returned in boundary order [v0, v1, v3, v2], the clockwise
    order of Source.cpp:377.

    px, py : (...,) center positions; returns (..., 4) x and y.
    """
    h = dst_side / 2.0
    us = np.asarray([-h, h, h, -h], dtype=px.dtype)
    vs = np.asarray([-h, -h, h, h], dtype=px.dtype)
    qx = px[..., None] + us * cos_v + vs * sin_v
    qy = py[..., None] - us * sin_v + vs * cos_v
    return qx, qy


# ---------------------------------------------------------------------------
# torch path: the same operations in the same order, on tensors
# ---------------------------------------------------------------------------


def _interleave3_torch(a, b, c):
    out = torch.stack([a, b, c], dim=-1)
    return out.reshape(a.shape[:-1] + (3 * a.shape[-1],))


def _clamp_pass_torch(u, w, lo, hi):
    """``_clamp_pass`` on tensors."""
    u_n = torch.roll(u, -1, dims=-1)
    w_n = torch.roll(w, -1, dims=-1)

    du = u_n - u
    safe = torch.where(du != 0.0, du, 1.0)

    cross_lo = (u < lo) != (u_n < lo)
    cross_hi = (u > hi) != (u_n > hi)
    t_lo = torch.where(cross_lo, (lo - u) / safe, 2.0)
    t_hi = torch.where(cross_hi, (hi - u) / safe, 2.0)

    t1 = torch.minimum(t_lo, t_hi)
    t2 = torch.maximum(t_lo, t_hi)
    pick_lo = t_lo <= t_hi
    lo_u, hi_u = lo + torch.zeros_like(u), hi + torch.zeros_like(u)
    u1 = torch.where(pick_lo, lo_u, hi_u)
    u2 = torch.where(pick_lo, hi_u, lo_u)

    uc = torch.minimum(torch.maximum(u, lo), hi)
    has1 = t1 <= 1.0
    has2 = t2 <= 1.0

    s1_u = torch.where(has1, u1, uc)
    s1_w = torch.where(has1, w + t1 * (w_n - w), w)
    s2_u = torch.where(has2, u2, s1_u)
    s2_w = torch.where(has2, w + t2 * (w_n - w), s1_w)

    return (_interleave3_torch(uc, s1_u, s2_u),
            _interleave3_torch(w, s1_w, s2_w))


def quad_rect_overlap_area_torch(quad_x, quad_y, lo_x, lo_y, hi_x, hi_y):
    """``quad_rect_overlap_area`` on tensors of one float dtype."""
    vx, vy = _clamp_pass_torch(quad_x, quad_y, lo_x[..., None],
                               hi_x[..., None])
    vy, vx = _clamp_pass_torch(vy, vx, lo_y[..., None], hi_y[..., None])
    x_n = torch.roll(vx, -1, dims=-1)
    y_n = torch.roll(vy, -1, dims=-1)
    return 0.5 * torch.abs(torch.sum(vx * y_n - x_n * vy, dim=-1))


def quad_vertices_torch(px, py, dst_side, cos_v, sin_v):
    """``quad_vertices`` on tensors: (...,) centers -> (..., 4) x and y."""
    h = dst_side / 2.0
    us = torch.tensor([-h, h, h, -h], dtype=px.dtype, device=px.device)
    vs = torch.tensor([-h, -h, h, h], dtype=px.dtype, device=px.device)
    qx = px[..., None] + us * cos_v + vs * sin_v
    qy = py[..., None] - us * sin_v + vs * cos_v
    return qx, qy
