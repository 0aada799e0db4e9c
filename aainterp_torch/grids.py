"""Grid geometry for area-average (conservative) resampling.

Counterpart of ``aainterp/grids.py``, carried over unchanged: pure Python /
float64 scalars, no tensors.  A :class:`GridSpec` captures every derived
geometric quantity the reference computes inside its entry functions, so
that the weight-generation and apply stages are functions of the spec alone.

Reference parity (semantics replicated from the reference's Source.cpp):
  - integer prescale factor             Source.cpp:139   (``scale``)
  - quadrant pre-rotation               Source.cpp:140-146
  - modSrc size / isocenter rescale     Source.cpp:150-176
  - expansion ratio / dst side length   Source.cpp:177-178
  - rotated-bounding-box dst size       Source.cpp:179-180
  - dst isocenter forward map + split   Source.cpp:181-186
  - corner-min translation offset       Source.cpp:187-200
  - dst->src inverse position map       Source.cpp:203-221

Design note: the reference materialises the ``scale``-times
replicated image ``modSrc`` (Source.cpp:157-172).  We never do: replicating a
pixel and area-averaging the replicas is identical to overlapping against the
original cell (each original cell is a ``scale x scale`` block of unit mod
cells with one constant value).  All geometry below is therefore expressed in
"mod coordinates" (the reference's coordinate system, where a replicated
pixel has unit side and integer center), but weights are generated against
*original* cells of side ``scale`` — bit-identical total overlap, no memory
blowup.

Known reference quirk replicated on purpose: for rotation angles >= 90 the
reference quadrant-rotates the image but does *not* remap the isocenter into
the rotated frame (Source.cpp:173-174 uses the raw isocenter after the image
was already quadrant-rotated at 163-167).  We reproduce that behaviour so
outputs match.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

# C++ DBL_EPSILON — the reference uses it pervasively for tolerance tests.
DBL_EPSILON = 2.220446049250313e-16


class ValidationError(ValueError):
    """Raised for the argument errors the reference reports as (false, msg).

    Reference: Source.cpp:111-132 (exact) / 637-658 (fast) return
    pair<bool,string>; we raise instead (Python API layer, SURVEY.md C2).
    """


def validate_args(
    src_shape: Tuple[int, int],
    src_resolution: Tuple[float, float],
    dst_resolution: Tuple[float, float],
) -> None:
    """Argument validation with the reference's exact error messages.

    Reference: Source.cpp:111-132.
    """
    if (
        DBL_EPSILON < abs(src_resolution[0] - src_resolution[1])
        or DBL_EPSILON < abs(dst_resolution[0] - dst_resolution[1])
    ):
        raise ValidationError("Assumed X & Y resolution are same.")
    if src_resolution[0] <= DBL_EPSILON or dst_resolution[0] <= DBL_EPSILON:
        raise ValidationError("0 or negative resolution is not acceptable.")
    if src_shape[0] == 0:
        raise ValidationError("There is no data in src array.")
    if src_shape[1] == 0:
        raise ValidationError(
            "There is no data in the second dimension of src array."
        )


def _round_half_away(x: float) -> int:
    """C's round(): half away from zero (values here are non-negative)."""
    return int(math.floor(x + 0.5))


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """All static geometry of one resample problem.

    Coordinates: "mod coordinates" = pixel indices of the reference's
    replicated image; mod pixel (mx,my) is the unit square centered at
    (mx,my), i.e. [mx-0.5, mx+0.5] x [my-0.5, my+0.5].  Original (quadrant-
    pre-rotated) cell (jx,jy) spans [jx*scale-0.5, jx*scale+scale-0.5] per
    axis.  The destination pixel (dx,dy) is a square of side ``dst_side``
    centered at ``dst_center(dx,dy)`` rotated by the *inverse* residual
    rotation (Source.cpp:203-221).
    """

    # --- user inputs (after normalisation) ---
    src_shape: Tuple[int, int]          # (H, W) of the original image
    src_resolution: float
    dst_resolution: float
    src_isocenter: Tuple[float, float]  # (x, y) in original src pixels
    rotation_angle: float               # degrees, normalised to [0, 360)

    # --- derived (Source.cpp:135-200) ---
    scale: int                          # integer prescale (Source.cpp:139)
    quadrant: int                       # 0/1/2/3 => 0/90/180/270 deg pre-rot
    residual_angle: float               # degrees in [0, 90)
    sin: float
    cos: float
    qrot_shape: Tuple[int, int]         # (H, W) of quadrant-rotated original
    mod_shape: Tuple[int, int]          # (H', W') of the virtual modSrc
    mod_isocenter: Tuple[float, float]  # scaled isocenter (x, y), mod coords
    expansion_ratio: float              # dstRes / (srcRes*scale)
    dst_side: float                     # dst pixel side in mod units (>=  sqrt2 when rotated)
    dst_shape: Tuple[int, int]          # (Hd, Wd)
    dst_isocenter: Tuple[int, int]      # integer part (x, y)
    iso_offset: Tuple[float, float]     # fractional part (x, y)
    offset: Tuple[float, float]         # corner-min translation (x, y)

    # ------------------------------------------------------------------
    @property
    def is_axis_aligned(self) -> bool:
        """True when the residual rotation is exactly zero.

        Then the operator is separable (outer product of 1-D overlaps)."""
        return self.sin == 0.0

    @property
    def linear_map(self):
        """Coefficients of the dst-index -> mod-coordinate affine map.

        dst pixel (dx,dy) center position p (mod coords):
            px = (dx*L + ax)*cos + (dy*L + ay)*sin + icx
            py = -(dx*L + ax)*sin + (dy*L + ay)*cos + icy
        with ax = fx*L - icx + ox, ay = fy*L - icy + oy — exactly
        Source.cpp:212-219 refactored into affine form.
        Returns (p00, ex, ey): p(dx,dy) = p00 + dx*ex + dy*ey (2-vectors).
        """
        L = self.dst_side
        icx, icy = self.mod_isocenter
        fx, fy = self.iso_offset
        ox, oy = self.offset
        c, s = self.cos, self.sin
        ax = fx * L - icx + ox
        ay = fy * L - icy + oy
        p00 = (ax * c + ay * s + icx, -ax * s + ay * c + icy)
        ex = (L * c, -L * s)
        ey = (L * s, L * c)
        return p00, ex, ey

    def dst_center(self, dx: float, dy: float) -> Tuple[float, float]:
        """Center of dst pixel (dx,dy) in mod coordinates (Source.cpp:212-219)."""
        p00, ex, ey = self.linear_map
        return (
            p00[0] + dx * ex[0] + dy * ey[0],
            p00[1] + dx * ex[1] + dy * ey[1],
        )

    @property
    def window_cells(self) -> int:
        """Candidate window size K (per axis, in original cells) for rotated
        weight generation.  The dst quad has circumradius L*sqrt(2)/2; the
        reference pads its mod-pixel search window by +1 (Source.cpp:426-429).
        In original-cell units (side ``scale``) the quad can touch at most
        ceil((L*sqrt2 + scale) / scale) + 1 cells per axis; +1 more for the
        base-rounding slack."""
        L = self.dst_side
        return int(math.ceil((L * math.sqrt(2.0) + self.scale) / self.scale)) + 2


def make_grid_spec(
    src_shape: Tuple[int, int],
    src_resolution: float,
    dst_resolution: float,
    src_isocenter: Tuple[float, float],
    rotation_angle: float,
) -> GridSpec:
    """Compute every derived geometric parameter, matching Source.cpp:135-200.

    ``src_shape`` is (H, W); ``src_isocenter`` is (x, y).
    """
    validate_args(src_shape, (src_resolution, src_resolution),
                  (dst_resolution, dst_resolution))
    H, W = src_shape

    # integer prescale (Source.cpp:139) — C-style truncation
    scale = int(dst_resolution / src_resolution * math.sqrt(2.0) + 1.0
                + DBL_EPSILON)

    # normalise angle into [0, 360) exactly like the while-loops at 141-142
    angle = float(rotation_angle)
    while angle < 0.0:
        angle += 360.0
    while angle >= 360.0:
        angle -= 360.0
    norm_angle = angle

    # quadrant pre-rotation (Source.cpp:143-146)
    if angle < 90.0:
        quadrant = 0
    elif angle < 180.0:
        quadrant = 1
        angle -= 90.0
    elif angle < 270.0:
        quadrant = 2
        angle -= 180.0
    else:
        quadrant = 3
        angle -= 270.0
    sin_v = math.sin(angle / 180.0 * math.pi)
    cos_v = math.cos(angle / 180.0 * math.pi)

    # modSrc size (Source.cpp:150-156): swap axes for 90/270 pre-rotation
    if quadrant in (0, 2):
        qH, qW = H, W
    else:
        qH, qW = W, H
    modW, modH = qW * scale, qH * scale

    # scaled isocenter & resolution (Source.cpp:173-176).  NOTE the reference
    # does NOT remap the isocenter through the quadrant rotation — replicated.
    icx = src_isocenter[0] * scale + (scale - 1) / 2.0
    icy = src_isocenter[1] * scale + (scale - 1) / 2.0
    mod_resolution = src_resolution * scale

    expansion_ratio = dst_resolution / mod_resolution
    dst_side = mod_resolution / dst_resolution

    # rotated-bounding-box dst size (Source.cpp:179-180)
    dstW = _round_half_away((modW * abs(cos_v) + modH * abs(sin_v))
                            * expansion_ratio)
    dstH = _round_half_away((modW * abs(sin_v) + modH * abs(cos_v))
                            * expansion_ratio)

    # forward-rotated dst isocenter, split int/frac (Source.cpp:181-186)
    dst_icx = (icx * cos_v + (modH - icy) * sin_v) * expansion_ratio
    dst_icy = (icx * sin_v + icy * cos_v) * expansion_ratio
    fx = dst_icx - int(dst_icx)
    fy = dst_icy - int(dst_icy)
    dst_icx_i = int(dst_icx)
    dst_icy_i = int(dst_icy)

    # corner-min translation offset (Source.cpp:187-200): rotate the four
    # mod-image corners about the isocenter, track the min coordinate so the
    # rotated footprint is never clipped.
    ox = oy = 0.0
    corners = (
        (0.0, 0.0),
        (modW - 1.0, 0.0),
        (0.0, modH - 1.0),
        (modW - 1.0, modH - 1.0),
    )
    for cxp, cyp in corners:
        rx = (cxp - icx) * cos_v - (cyp - icy) * sin_v + icx
        ry = (cxp - icx) * sin_v + (cyp - icy) * cos_v + icy
        ox = min(ox, rx)
        oy = min(oy, ry)

    return GridSpec(
        src_shape=(H, W),
        src_resolution=float(src_resolution),
        dst_resolution=float(dst_resolution),
        src_isocenter=(float(src_isocenter[0]), float(src_isocenter[1])),
        rotation_angle=norm_angle,
        scale=scale,
        quadrant=quadrant,
        residual_angle=angle,
        sin=sin_v,
        cos=cos_v,
        qrot_shape=(qH, qW),
        mod_shape=(modH, modW),
        mod_isocenter=(icx, icy),
        expansion_ratio=expansion_ratio,
        dst_side=dst_side,
        dst_shape=(dstH, dstW),
        dst_isocenter=(dst_icx_i, dst_icy_i),
        iso_offset=(fx, fy),
        offset=(ox, oy),
    )
