"""The geometry of one resample, worked out again from its arguments.

A plain rewrite of the reference program's set-up arithmetic
(Source.cpp:135-221 of Ishikawa-lab/Area_average_interpolation): the
integer prescale, the quadrant pre-rotation, the destination size of the
rotated bounding box, the split destination isocenter, the corner-min
offset and the affine map from a destination index to the centre of its
cell.  Coordinates are the reference's "mod" coordinates: source cell
(jx, jy) spans [jx*s - 0.5, jx*s + s - 0.5] on each axis, s the prescale.
The destination cell (dx, dy) is the square
{p(dx, dy) + u*ex + v*ey : u, v in [-1/2, 1/2]}.

Imports nothing of the program under test.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

DBL_EPSILON = 2.220446049250313e-16


@dataclasses.dataclass(frozen=True)
class Geometry:
    src_shape: Tuple[int, int]      # (H, W) as given
    scale: int                      # s
    quadrant: int                   # rot90 pre-rotation, 0..3
    sin: float
    cos: float
    q_shape: Tuple[int, int]        # (H, W) after the pre-rotation
    side: float                     # L, the destination cell's side
    dst_shape: Tuple[int, int]      # (Hd, Wd)
    p00: Tuple[float, float]        # centre of destination cell (0, 0)
    ex: Tuple[float, float]         # step of dx
    ey: Tuple[float, float]         # step of dy

    @property
    def axis_aligned(self) -> bool:
        return self.sin == 0.0

    @property
    def window(self) -> int:
        """Candidate cells per axis the program searches (its sliver
        threshold is set from it)."""
        L, s = self.side, self.scale
        return int(math.ceil((L * math.sqrt(2.0) + s) / s)) + 2


def geometry(src_shape, src_resolution: float, dst_resolution: float,
             src_isocenter, rotation_angle: float) -> Geometry:
    H, W = int(src_shape[0]), int(src_shape[1])
    s = int(dst_resolution / src_resolution * math.sqrt(2.0) + 1.0
            + DBL_EPSILON)
    angle = float(rotation_angle) % 360.0
    quadrant = int(angle // 90.0)
    angle -= 90.0 * quadrant
    sn = math.sin(angle / 180.0 * math.pi)
    cs = math.cos(angle / 180.0 * math.pi)
    qH, qW = (H, W) if quadrant % 2 == 0 else (W, H)
    modW, modH = qW * s, qH * s
    # the reference scales the isocenter without turning it with the image
    icx = src_isocenter[0] * s + (s - 1) / 2.0
    icy = src_isocenter[1] * s + (s - 1) / 2.0
    ratio = dst_resolution / (src_resolution * s)
    L = 1.0 / ratio
    Wd = int(math.floor((modW * abs(cs) + modH * abs(sn)) * ratio + 0.5))
    Hd = int(math.floor((modW * abs(sn) + modH * abs(cs)) * ratio + 0.5))
    dix = (icx * cs + (modH - icy) * sn) * ratio
    diy = (icx * sn + icy * cs) * ratio
    fx, fy = dix - int(dix), diy - int(diy)
    ox = oy = 0.0
    for cx, cy in ((0.0, 0.0), (modW - 1.0, 0.0), (0.0, modH - 1.0),
                   (modW - 1.0, modH - 1.0)):
        ox = min(ox, (cx - icx) * cs - (cy - icy) * sn + icx)
        oy = min(oy, (cx - icx) * sn + (cy - icy) * cs + icy)
    ax = fx * L - icx + ox
    ay = fy * L - icy + oy
    return Geometry(
        src_shape=(H, W), scale=s, quadrant=quadrant, sin=sn, cos=cs,
        q_shape=(qH, qW), side=L, dst_shape=(Hd, Wd),
        p00=(ax * cs + ay * sn + icx, -ax * sn + ay * cs + icy),
        ex=(L * cs, -L * sn), ey=(L * sn, L * cs))


def from_config(cfg: dict) -> Geometry:
    return geometry(cfg["src_shape"], cfg["src_resolution"],
                    cfg["dst_resolution"], cfg["src_isocenter"],
                    cfg["rotation_angle"])
