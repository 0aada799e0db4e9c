"""Reference-compatibility exact mode: bug-for-bug weight generation.

Counterpart of ``aainterp/ops/compat.py`` (host numpy float64), carried
over: the same operations in the same order, so the tables are
bit-identical to the JAX package's numpy path.  The port imports nothing
of the JAX package, so it keeps its own copy.

The default exact mode computes *true* overlap areas (ops/clipper.py); under
rotation those differ from the C++ reference because the reference's type-2
triangle formula is wrong for mixed side pairs (Source.cpp:1055-1062 — see
PARITY.md).  Some users migrating from the reference need bit-compatible
outputs, so this module reproduces the reference's per-cell pipeline
faithfully, vectorised in numpy float64:

  - 16 segment-intersection tests with the reference's DBL_EPSILON
    conventions (getIntersectionType, Source.cpp:986-1034)
  - the tangent-contact edge filter (updatePixelState_intersection,
    Source.cpp:327-342)
  - the infinite-ray-cast center-inclusion test (Source.cpp:368-398)
  - the strict vertex-in-cell test (Source.cpp:399-409)
  - sort + tangency dedup rules 1 & 2 (Source.cpp:496-564)
  - the full type 0-9 dispatch and closed-form areas (Source.cpp:1035-1431),
    including the type-2/type-4 mixed-pair defect, the type-3 center
    disambiguation, all type-5/6/8/9 subcases, the type-7-vs-9 rule, and
    the boundary fallbacks (Source.cpp:1411-1412, 1430)

It operates on unit *mod* cells (the reference's replicated-pixel grid) and
collapses replica weights into original-cell ELL weights afterwards (exact:
replicas share one value).  The per-cell state machine runs on the native
engine (``aainterp_torch.native.compat_cell_areas_native``) where it
builds, and on the numpy replica here otherwise; ``ENGINES`` counts which
one each call took.

Corner coordinates replicate the reference's edge-line construction and
getIntersectionPoint bit-for-bit (see _reference_corners), so DBL_EPSILON
classifications agree even at exact tangencies.  Known, documented
divergence (unreachable here): the reference's ray test reuses stale r/s
values when a ray is parallel to a quad edge — possible only at residual
angle 0, where the separable path is used instead.
"""

from __future__ import annotations

import ctypes
import math
import warnings
from typing import Optional, Tuple

import numpy as np

from ..grids import DBL_EPSILON, GridSpec

_EPS = DBL_EPSILON
_INF = np.inf

# which engine computed the cell areas of each compat_ell_weights call
ENGINES = {"native": 0, "numpy": 0}


def _seg_intersections(p1x, p1y, p2x, p2y, q1x, q1y, q2x, q2y):
    """Vectorised getIntersectionType (Source.cpp:986-1034).

    Returns (type, r, s); r/s are NaN where not computed (parallel/overlap).
    """
    den = (p2x - p1x) * (q2y - q1y) - (p2y - p1y) * (q2x - q1x)
    rn = (q1x - p1x) * (q2y - q1y) - (q1y - p1y) * (q2x - q1x)
    sn = (p2y - p1y) * (q1x - p1x) - (p2x - p1x) * (q1y - p1y)
    par = np.abs(den) <= _EPS
    overlap = par & (np.abs(rn) <= _EPS) & (np.abs(sn) <= _EPS)
    safe = np.where(par, 1.0, den)
    r = rn / safe
    s = sn / safe
    in01 = (-_EPS <= r) & (r <= 1.0 + _EPS) & (-_EPS <= s) & (s <= 1.0 + _EPS)
    endpoint = (
        (np.abs(r) <= _EPS) | (np.abs(r - 1.0) <= _EPS)
        | (np.abs(s) <= _EPS) | (np.abs(s - 1.0) <= _EPS)
    )
    typ = np.where(
        overlap, 2,
        np.where(par, 1, np.where(in01 & endpoint, 4, np.where(in01, 3, 5))),
    )
    return typ, r, s


def _reference_corners(spec: GridSpec, dy0: int, dy1: int):
    """dst quad corners exactly as the reference computes them.

    Replicates the edge-line construction (Source.cpp:229-305, with the
    <45-vs->=45 conditioning branch and the |tan|<eps zeroing at 240) and
    getIntersectionPoint (Source.cpp:962-985, including the missing-parens
    quirk at 978) with the reference's floating-point operation order, so
    DBL_EPSILON classifications at exact tangencies (e.g. 30 deg where
    sin = 0.5 exactly) agree bit-for-bit.

    Returns qvx, qvy of shape (dy1-dy0, Wd, 4) in dstVertex order
    v0=H[dy]xV[dx], v1=H[dy]xV[dx+1], v2=H[dy+1]xV[dx], v3=H[dy+1]xV[dx+1].
    """
    Hd, Wd = spec.dst_shape
    L = spec.dst_side
    icx, icy = spec.mod_isocenter
    fx, fy = spec.iso_offset
    ox, oy = spec.offset
    c, s = spec.cos, spec.sin
    ang = spec.residual_angle

    # dstPos with the reference's exact association (Source.cpp:212-219)
    def pos(dx_arr, dy_arr):
        tx = (dx_arr + fx) * L - icx + ox
        ty = (dy_arr + fy) * L - icy + oy
        px = tx * c + ty * s + icx
        py = -tx * s + ty * c + icy
        return px, py

    dxs = np.arange(Wd, dtype=np.float64)
    dys = np.arange(Hd, dtype=np.float64)
    px_col0, py_col0 = pos(np.float64(0.0), dys)      # dstPos[dy][0]
    px_row0, py_row0 = pos(dxs, np.float64(0.0))      # dstPos[0][dx]

    if ang < 45.0:
        ts, tc = s, c
        tt = math.tan(ang / 180.0 * math.pi)
    else:
        ts = math.sin((ang - 90.0) / 180.0 * math.pi)
        tc = math.cos((ang - 90.0) / 180.0 * math.pi)
        tt = math.tan((ang - 90.0) / 180.0 * math.pi)
    if abs(tt) < _EPS:
        tt = 0.0

    hf = L / 2.0
    cH = np.empty(Hd + 1)
    cV = np.empty(Wd + 1)
    if ang < 45.0:
        aH, bH = tt, 1.0
        aV, bV = 1.0, -tt
        cH[:Hd] = (-aH * (px_col0 - hf * (tc + ts))
                   - (py_col0 - hf * (tc - ts)))
        cH[Hd] = (-aH * (px_col0[-1] - hf * (tc - ts))
                  - (py_col0[-1] + hf * (tc + ts)))
        cV[:Wd] = (-(px_row0 - hf * (tc + ts))
                   - bV * (py_row0 - hf * (tc - ts)))
        cV[Wd] = (-(px_row0[-1] + hf * (tc - ts))
                  - bV * (py_row0[-1] - hf * (tc + ts)))
    else:
        aH, bH = 1.0, -tt
        aV, bV = tt, 1.0
        cH[:Hd] = (-(px_col0 - hf * (tc + ts))
                   - bH * (py_col0 - hf * (tc - ts)))
        cH[Hd] = (-(px_col0[-1] + hf * (tc - ts))
                  - bH * (py_col0[-1] - hf * (tc + ts)))
        cV[:Wd] = (-aV * (px_row0 - hf * (tc - ts))
                   - (py_row0 + hf * (tc + ts)))
        cV[Wd] = (-aV * (px_row0[-1] - hf * (tc + ts))
                  - (py_row0[-1] - hf * (tc - ts)))

    # getIntersectionPoint(H[i], V[j]) for all line pairs
    c1 = cH[:, None]      # (Hd+1, 1)
    c2 = cV[None, :]      # (1, Wd+1)
    if abs(bV) <= _EPS:
        # the line-978 quirk branch: py = ((a1*c2 - a2*c1)/a2)*b1
        vx = -c2 / aV + np.zeros_like(c1)
        vy = (aH * c2 - aV * c1) / aV * bH
    else:
        den = aV * bH - aH * bV
        vx = (bV * c1 - bH * c2) / den
        vy = (aH * c2 - aV * c1) / den
    vx = np.broadcast_to(vx, (Hd + 1, Wd + 1))
    vy = np.broadcast_to(vy, (Hd + 1, Wd + 1))

    R = dy1 - dy0
    qvx = np.empty((R, Wd, 4))
    qvy = np.empty((R, Wd, 4))
    qvx[..., 0] = vx[dy0:dy1, :Wd]
    qvx[..., 1] = vx[dy0:dy1, 1:]
    qvx[..., 2] = vx[dy0 + 1: dy1 + 1, :Wd]
    qvx[..., 3] = vx[dy0 + 1: dy1 + 1, 1:]
    qvy[..., 0] = vy[dy0:dy1, :Wd]
    qvy[..., 1] = vy[dy0:dy1, 1:]
    qvy[..., 2] = vy[dy0 + 1: dy1 + 1, :Wd]
    qvy[..., 3] = vy[dy0 + 1: dy1 + 1, 1:]
    return qvx, qvy


def _compact_sorted(vals, valid):
    """Sort each row's valid values ascending into the leading slots."""
    v = np.where(valid, vals, _INF)
    v.sort(axis=-1)
    cnt = valid.sum(axis=-1)
    return v, cnt


def compat_cell_state(qvx, qvy, cell_x0, cell_y0):
    """Per (pixel-window) mod cell: the reference's PixelState, vectorised.

    qvx, qvy: (..., 4) dst quad vertices v0..v3 (Source.cpp ordering).
    cell_x0, cell_y0: (...,) top-left corner of the unit cell.
    Returns dict of arrays: side lists (4 slots each, sorted), counts,
    center_in, vertex_in, vertex_pos.
    """
    x0, y0 = cell_x0, cell_y0
    x1, y1 = x0 + 1.0, y0 + 1.0
    shape = x0.shape

    # dst edges in the main-loop order (Source.cpp:446-468)
    edges = [(0, 1), (2, 3), (0, 2), (1, 3)]
    # cell sides in test order i=0..3 -> keys xa, ya, yb, xb
    # (q1 -> q2 defines the s parameter direction)
    sides = [
        (x0, y0, x1, y0),  # xa: top, s along +x
        (x0, y0, x0, y1),  # ya: left, s along +y
        (x1, y0, x1, y1),  # yb: right, s along +y
        (x0, y1, x1, y1),  # xb: bottom, s along +x
    ]

    s_vals = np.full(shape + (4, 4), _INF)   # [edge, side]
    types = np.zeros(shape + (4, 4), dtype=np.int8)
    for e, (a, b) in enumerate(edges):
        p1x, p1y = qvx[..., a], qvy[..., a]
        p2x, p2y = qvx[..., b], qvy[..., b]
        for i, (q1x, q1y, q2x, q2y) in enumerate(sides):
            typ, r, s = _seg_intersections(
                p1x, p1y, p2x, p2y, q1x, q1y, q2x, q2y
            )
            types[..., e, i] = typ
            s_vals[..., e, i] = s

    # tangent-contact edge filter (Source.cpp:327-342): skip the edge when
    # exactly one side touches at an endpoint and no other side crosses
    cnt4 = (types == 4).sum(axis=-1)
    cnt3 = (types == 3).sum(axis=-1)
    skip_edge = (cnt4 == 1) & (cnt3 == 0)               # (..., 4)
    emit = ((types == 3) | (types == 4)) & ~skip_edge[..., None]

    # side lists: 4 slots per side (one per edge)
    lists = {}
    valid = {}
    for i, key in enumerate(("xa", "ya", "yb", "xb")):
        lists[key] = np.where(emit[..., :, i], s_vals[..., :, i], _INF)
        valid[key] = emit[..., :, i].copy()

    # sort (Source.cpp:496) BEFORE dedup, as the reference does
    for key in lists:
        order = np.argsort(lists[key], axis=-1)
        lists[key] = np.take_along_axis(lists[key], order, axis=-1)
        valid[key] = np.take_along_axis(valid[key], order, axis=-1)

    # dedup rules 1 & 2 (Source.cpp:498-564), predicates on ORIGINAL x lists
    def _exists(key, pred):
        return (valid[key] & pred(lists[key])).any(axis=-1)

    xa_le = _exists("xa", lambda v: v <= _EPS)[..., None]
    xb_le = _exists("xb", lambda v: v <= _EPS)[..., None]
    xa_ge = _exists("xa", lambda v: 1.0 - v <= _EPS)[..., None]
    xb_ge = _exists("xb", lambda v: 1.0 - v <= _EPS)[..., None]

    ya = lists["ya"]
    keep = np.where(
        ya <= _EPS, xa_le, np.where(1.0 - ya <= _EPS, xb_le, True)
    )
    valid["ya"] &= keep
    yb = lists["yb"]
    keep = np.where(
        yb <= _EPS, xa_ge, np.where(1.0 - yb <= _EPS, xb_ge, True)
    )
    valid["yb"] &= keep
    for key in ("xa", "xb"):
        v = lists[key]
        valid[key] &= (v > _EPS) & (1.0 - v > _EPS)

    out = {}
    counts = {}
    for key in lists:
        out[key], counts[key] = _compact_sorted(lists[key], valid[key])

    # center-inclusion: infinite axis ray cast (Source.cpp:368-398), quad
    # cycle order v0, v1, v3, v2
    cyc = [0, 1, 3, 2]
    cx = (x0 + x1) / 2.0
    cy = (y0 + y1) / 2.0
    center_in = np.ones(shape, dtype=bool)
    for dx, dy in ((0.0, -100.0), (0.0, 100.0), (-100.0, 0.0), (100.0, 0.0)):
        crossed = np.zeros(shape, dtype=bool)
        for k in range(4):
            a, b = cyc[k], cyc[(k + 1) % 4]
            typ, r, s = _seg_intersections(
                cx, cy, cx + dx, cy + dy,
                qvx[..., a], qvy[..., a], qvx[..., b], qvy[..., b],
            )
            hit = (typ >= 3) & (-_EPS < r) & (-_EPS < s) & (s < 1.0 + _EPS)
            crossed |= hit
        center_in &= crossed

    # vertex-in-cell (Source.cpp:399-409): strict with eps, LAST vertex wins
    vert_in = np.zeros(shape, dtype=bool)
    vpx = np.full(shape, -1.0)
    vpy = np.full(shape, -1.0)
    for i in range(4):
        vx, vy = qvx[..., i], qvy[..., i]
        inside = (
            (x0 + _EPS < vx) & (vx < x1 - _EPS)
            & (y0 + _EPS < vy) & (vy < y1 - _EPS)
        )
        vert_in |= inside
        vpx = np.where(inside, vx - x0, vpx)
        vpy = np.where(inside, vy - y0, vpy)

    return dict(
        xa=out["xa"], ya=out["ya"], yb=out["yb"], xb=out["xb"],
        n_xa=counts["xa"], n_ya=counts["ya"], n_yb=counts["yb"],
        n_xb=counts["xb"],
        center_in=center_in, vertex_in=vert_in, vpx=vpx, vpy=vpy,
    )


def compat_get_area(st) -> np.ndarray:
    """Vectorised getArea dispatch (Source.cpp:1035-1431), bug-for-bug."""
    xa, xb, ya, yb = st["xa"], st["xb"], st["ya"], st["yb"]
    nxa, nxb, nya, nyb = st["n_xa"], st["n_xb"], st["n_ya"], st["n_yb"]
    xc = nxa + nxb
    yc = nya + nyb
    cen = st["center_in"]
    ver = st["vertex_in"]
    vx, vy = st["vpx"], st["vpy"]

    z = np.zeros_like(xa[..., 0])
    one = np.ones_like(z)

    def first(arr, cnt, alt=0.0):
        return np.where(cnt > 0, np.where(np.isfinite(arr[..., 0]),
                                          arr[..., 0], alt), alt)

    xa0 = first(xa, nxa)
    xa1 = np.where(nxa > 1, xa[..., 1], 0.0)
    xb0 = first(xb, nxb)
    xb1 = np.where(nxb > 1, xb[..., 1], 0.0)
    ya0 = first(ya, nya)
    ya1 = np.where(nya > 1, ya[..., 1], 0.0)
    yb0 = first(yb, nyb)
    yb1 = np.where(nyb > 1, yb[..., 1], 0.0)

    # --- type 2 (faithfully including the mixed-pair defect) ---
    t2x = np.where(nxa != 0, xa0, 1.0 - xb0)
    t2y = np.where(nya != 0, ya0, 1.0 - yb0)
    type2 = 0.5 * t2x * t2y
    type4 = 1.0 - type2

    # --- type 3: trapezoid with center disambiguation ---
    has_x = (nxa != 0) & (nxb != 0)
    has_y = (nya != 0) & (nyb != 0)
    s1 = np.where(has_x, xa0, ya0)
    s2 = np.where(has_x, xb0, yb0)
    trap = 0.5 * (s1 + s2)
    type3_val = np.where(cen, np.maximum(trap, 1.0 - trap),
                         np.minimum(trap, 1.0 - trap))
    type3 = np.where(has_x | has_y, type3_val, np.where(cen, 1.0, 0.0))

    # --- type 5: 1 - (trapezoid + triangle), 8 subcases ---
    # branch structure transcribed from Source.cpp:1087-1219
    x1y3 = (xc == 1) & (yc == 3)
    # xa 0, xb 1, ya 1, yb 2
    sb_a = ya0
    lb_a = np.minimum(yb0, yb1)
    ba_a = 1.0 - xb0
    he_a = 1.0 - np.maximum(yb0, yb1)
    # xa 0, xb 1, ya 2, yb 1
    sb_b = np.minimum(ya0, ya1)
    lb_b = yb0
    ba_b = xb0
    he_b = 1.0 - np.maximum(ya0, ya1)
    # xa 1, xb 0, ya 1, yb 2
    sb_c = 1.0 - ya0
    lb_c = 1.0 - np.maximum(yb0, yb1)
    ba_c = 1.0 - xa0
    he_c = np.minimum(yb0, yb1)
    # xa 1, xb 0, ya 2, yb 1
    sb_d = 1.0 - np.maximum(ya0, ya1)
    lb_d = 1.0 - yb0
    ba_d = xa0
    he_d = np.minimum(ya0, ya1)
    in_x1y3_a = (nxa == 0) & (nya == 1)
    in_x1y3_b = (nxa == 0) & (nya != 1)
    in_x1y3_c = (nxa != 0) & (nya == 1)
    # xa 1, xb 2, ya 0, yb 1
    sb_e = xa0
    lb_e = np.minimum(xb0, xb1)
    ba_e = 1.0 - np.maximum(xb0, xb1)
    he_e = 1.0 - yb0
    # xa 2, xb 1, ya 0, yb 1
    sb_f = xb0
    lb_f = np.minimum(xa0, xa1)
    ba_f = 1.0 - np.maximum(xa0, xa1)
    he_f = yb0
    # xa 1, xb 2, ya 1, yb 0
    sb_g = 1.0 - xa0
    lb_g = 1.0 - np.maximum(xb0, xb1)
    ba_g = np.minimum(xb0, xb1)
    he_g = 1.0 - ya0
    # xa 2, xb 1, ya 1, yb 0
    sb_h = 1.0 - xb0
    lb_h = 1.0 - np.maximum(xa0, xa1)
    ba_h = np.minimum(xa0, xa1)
    he_h = ya0
    in_x3_e = (nya == 0) & (nxa == 1)
    in_x3_f = (nya == 0) & (nxa != 1)
    in_x3_g = (nya != 0) & (nxa == 1)

    sb = np.where(
        x1y3,
        np.where(in_x1y3_a, sb_a, np.where(in_x1y3_b, sb_b,
                 np.where(in_x1y3_c, sb_c, sb_d))),
        np.where(in_x3_e, sb_e, np.where(in_x3_f, sb_f,
                 np.where(in_x3_g, sb_g, sb_h))),
    )
    lb = np.where(
        x1y3,
        np.where(in_x1y3_a, lb_a, np.where(in_x1y3_b, lb_b,
                 np.where(in_x1y3_c, lb_c, lb_d))),
        np.where(in_x3_e, lb_e, np.where(in_x3_f, lb_f,
                 np.where(in_x3_g, lb_g, lb_h))),
    )
    ba = np.where(
        x1y3,
        np.where(in_x1y3_a, ba_a, np.where(in_x1y3_b, ba_b,
                 np.where(in_x1y3_c, ba_c, ba_d))),
        np.where(in_x3_e, ba_e, np.where(in_x3_f, ba_f,
                 np.where(in_x3_g, ba_g, ba_h))),
    )
    he = np.where(
        x1y3,
        np.where(in_x1y3_a, he_a, np.where(in_x1y3_b, he_b,
                 np.where(in_x1y3_c, he_c, he_d))),
        np.where(in_x3_e, he_e, np.where(in_x3_f, he_f,
                 np.where(in_x3_g, he_g, he_h))),
    )
    type5 = 1.0 - 0.5 * (sb + lb) - 0.5 * ba * he

    # --- type 6: hexagon = 1 - 2 corner triangles, 4 subcases ---
    t6 = np.where(
        nxa == 2,
        0.5 * np.minimum(xa0, xa1) * ya0
        + 0.5 * (1.0 - np.maximum(xa0, xa1)) * yb0,
        np.where(
            nxb == 2,
            0.5 * np.minimum(xb0, xb1) * (1.0 - ya0)
            + 0.5 * (1.0 - np.maximum(xb0, xb1)) * (1.0 - yb0),
            np.where(
                nya == 2,
                0.5 * xa0 * np.minimum(ya0, ya1)
                + 0.5 * xb0 * (1.0 - np.maximum(ya0, ya1)),
                np.where(
                    nyb == 2,
                    0.5 * (1.0 - xa0) * np.minimum(yb0, yb1)
                    + 0.5 * (1.0 - xb0) * (1.0 - np.maximum(yb0, yb1)),
                    0.0,
                ),
            ),
        ),
    )
    type6 = 1.0 - t6

    # --- type 7: triangle cut by an included dst vertex ---
    # the side with 2 points; C++ map order xa < xb < ya < yb, last wins
    base7 = np.zeros_like(z)
    height7 = np.zeros_like(z)
    for key, cnt, a0, a1v, h in (
        ("xa", nxa, xa0, xa1, vy),
        ("xb", nxb, xb0, xb1, 1.0 - vy),
        ("ya", nya, ya0, ya1, vx),
        ("yb", nyb, yb0, yb1, 1.0 - vx),
    ):
        two = cnt == 2
        base7 = np.where(two, np.abs(a0 - a1v), base7)
        height7 = np.where(two, h, height7)
    type7 = 0.5 * base7 * height7

    # --- type 8: quadrangle with dst vertex, 4 subcases ---
    c_aa = (nxa == 1) & (nya == 1)
    c_ab = (nxa == 1) & (nyb == 1)
    c_ba = (nxb == 1) & (nya == 1)
    type8 = np.where(
        c_aa, 0.5 * xa0 * vy + 0.5 * ya0 * vx,
        np.where(
            c_ab, 0.5 * (1.0 - xa0) * vy + 0.5 * yb0 * (1.0 - vx),
            np.where(
                c_ba, 0.5 * xb0 * (1.0 - vy) + 0.5 * (1.0 - ya0) * vx,
                0.5 * (1.0 - xb0) * (1.0 - vy) + 0.5 * (1.0 - yb0) * (1.0 - vx),
            ),
        ),
    )

    # --- type 9: pentagon with dst vertex, 4 subcases ---
    x_pair = (nxa == 1) & (nxb == 1)
    t9x = np.where(
        np.maximum(xa0, xb0) <= vx,
        0.5 * xa0 * vy + 0.5 * vx + 0.5 * xb0 * (1.0 - vy),
        0.5 * (1.0 - xa0) * vy + 0.5 * (1.0 - vx) + 0.5 * (1.0 - xb0) * (1.0 - vy),
    )
    t9y = np.where(
        np.maximum(ya0, yb0) <= vy,
        0.5 * ya0 * vx + 0.5 * vy + 0.5 * yb0 * (1.0 - vx),
        0.5 * (1.0 - ya0) * vx + 0.5 * (1.0 - vy) + 0.5 * (1.0 - yb0) * (1.0 - vx),
    )
    type9 = np.where(x_pair, t9x, t9y)

    # --- dispatch (Source.cpp:1403-1430) ---
    fallback = np.where(cen, one, z)
    any_two = (nxa == 2) | (nxb == 2) | (nya == 2) | (nyb == 2)

    no_vertex = np.select(
        [
            (xc == 0) & (yc == 0) & ~cen,
            (xc == 0) & (yc == 0) & cen,
            (xc == 1) & (yc == 1) & ~cen,
            ((xc == 2) & (yc == 0)) | ((xc == 0) & (yc == 2)),
            (xc == 1) & (yc == 1) & cen,
            ((xc == 3) & (yc == 1)) | ((xc == 1) & (yc == 3)),
            (xc == 2) & (yc == 2),
            (xc == 0) & (yc == 1) & ~cen,
            (xc == 0) & (yc == 1) & cen,
        ],
        [z, one, type2, type3, type4, type5, type6, z, one],
        default=fallback,
    )
    with_vertex = np.select(
        [
            (((xc == 2) & (yc == 0)) | ((xc == 0) & (yc == 2))) & any_two,
            ((xc == 2) & (yc == 0)) | ((xc == 0) & (yc == 2)),
            (xc == 1) & (yc == 1),
        ],
        [type7, type9, type8],
        default=fallback,
    )
    return np.where(ver, with_vertex, no_vertex)


def compat_ell_weights(
    spec: GridSpec,
    dy_slice: Optional[Tuple[int, int]] = None,
    normalise: bool = True,
    prefer_native: bool = True,
):
    """Reference-compatible exact weights, collapsed to original-cell ELL.

    Returns (base (R,Wd,2) int32 original-cell window bases, w (R,Wd,Kc,Kc),
    sums (R,Wd)); Kc covers the reference's full clamped search window (may
    exceed spec.window_cells) — drop-in compatible with apply_ell.
    """
    Hd, Wd = spec.dst_shape
    dy0, dy1 = dy_slice if dy_slice is not None else (0, Hd)
    R = dy1 - dy0
    modH, modW = spec.mod_shape
    qH, qW = spec.qrot_shape
    s = int(spec.scale)
    L = spec.dst_side
    c, sn = spec.cos, spec.sin

    # dstPos with the reference's exact fp association (Source.cpp:212-219)
    icx, icy = spec.mod_isocenter
    fx, fy = spec.iso_offset
    ox, oy = spec.offset
    dxs = np.arange(Wd, dtype=np.float64)
    dys = np.arange(dy0, dy1, dtype=np.float64)
    tx = (dxs[None, :] + fx) * L - icx + ox
    ty = (dys[:, None] + fy) * L - icy + oy
    px = tx * c + ty * sn + icx
    py = -tx * sn + ty * c + icy

    # quad vertices from the reference's edge lines + line intersections
    qvx, qvy = _reference_corners(spec, dy0, dy1)

    # mod-cell window (reference search bound, Source.cpp:426-429)
    r_mod = L * math.sqrt(2.0) / 2.0 + 1.0
    Km = int(math.ceil(2.0 * r_mod)) + 3
    mx0 = np.clip(np.floor(px - r_mod).astype(np.int64), 0,
                  max(modW - Km, 0))
    my0 = np.clip(np.floor(py - r_mod).astype(np.int64), 0,
                  max(modH - Km, 0))

    k = np.arange(Km)
    mx = mx0[..., None, None] + k[None, None, None, :]   # (R,Wd,1,Km)
    my = my0[..., None, None] + k[None, None, :, None]   # (R,Wd,Km,1)
    mx = np.broadcast_to(mx, (R, Wd, Km, Km))
    my = np.broadcast_to(my, (R, Wd, Km, Km))

    areas = None
    if prefer_native:
        # multithreaded C++ state machine (native/aainterp_native.cpp),
        # bit-exact vs the numpy path below (-ffp-contract=off build) and
        # ~100x faster
        from .. import native

        try:
            areas = native.compat_cell_areas_native(
                qvx, qvy, mx0, my0, Km, modH, modW)
        except (RuntimeError, OSError, AttributeError, TypeError,
                ValueError, ctypes.ArgumentError) as e:
            # correctness is covered by the numpy replica below, but a
            # silent fallback hides real native-path defects (bad binding,
            # shape drift) behind a ~100x slowdown — make it observable
            warnings.warn(
                "native compat weight-gen failed "
                f"({type(e).__name__}: {e}); using the numpy replica",
                RuntimeWarning)
            areas = None
    ENGINES["numpy" if areas is None else "native"] += 1
    if areas is None:
        cell_x0 = mx - 0.5
        cell_y0 = my - 0.5
        st = compat_cell_state(
            np.broadcast_to(qvx[..., None, None, :], (R, Wd, Km, Km, 4)),
            np.broadcast_to(qvy[..., None, None, :], (R, Wd, Km, Km, 4)),
            cell_x0.astype(np.float64), cell_y0.astype(np.float64),
        )
        areas = compat_get_area(st)
        in_range = ((mx >= 0) & (mx <= modW - 1)
                    & (my >= 0) & (my <= modH - 1))
        areas = np.where(in_range, areas, 0.0)

    # collapse replica (mod) cells into original cells.  The original-cell
    # window must cover the ENTIRE mod search window (at image edges the
    # clamped mod window can extend far from the quad, and the oracle's only
    # nonzero cell may sit at its fringe), so Kc >= ceil(Km/s) + 1; Kc may
    # exceed spec.window_cells — apply_ell takes any K.
    Kc = (Km + s - 1) // s + 2
    Kc = min(Kc, max(qH, qW))
    jy = my // s                                          # (R,Wd,Km,Km)
    jx = mx // s
    base_y = np.clip(jy.min(axis=(-1, -2)), 0, max(qH - Kc, 0))
    base_x = np.clip(jx.min(axis=(-1, -2)), 0, max(qW - Kc, 0))
    off_y = jy - base_y[..., None, None]
    off_x = jx - base_x[..., None, None]
    oob = (off_y < 0) | (off_y >= Kc) | (off_x < 0) | (off_x >= Kc)
    if oob.any():
        # not `assert`: must hold under python -O too
        if np.any(np.abs(areas[oob]) > 0):
            raise RuntimeError(
                "compat collapse window too small: nonzero weight outside Kc")
        off_y = np.clip(off_y, 0, Kc - 1)
        off_x = np.clip(off_x, 0, Kc - 1)
        areas = np.where(oob, 0.0, areas)
    flat = (off_y * Kc + off_x).reshape(R * Wd, Km * Km)
    w = np.zeros((R * Wd, Kc * Kc))
    np.add.at(
        w,
        (np.repeat(np.arange(R * Wd), Km * Km), flat.ravel()),
        areas.reshape(R * Wd, Km * Km).ravel(),
    )
    w = w.reshape(R, Wd, Kc, Kc)
    sums = w.sum(axis=(-1, -2))
    if normalise:
        safe = np.where(np.abs(sums) > _EPS, sums, 1.0)
        w = np.where((np.abs(sums) > _EPS)[..., None, None], w / safe[..., None, None], 0.0)
    base = np.stack([base_y, base_x], axis=-1).astype(np.int32)
    return base, w, sums
