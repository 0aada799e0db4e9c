"""3-pass conservative shear decomposition: the approximate rotated mode.

Counterpart of ``aainterp/ops/shear3.py`` (``mode='shear'``).  The host
planner is carried over unchanged (numpy float64; importing the JAX
module imports jax), and the tests hold its tables to the JAX package's
bit for bit.  The XLA apply becomes a plain torch pipeline,
``apply_shear3_plain``; the CUDA stage kernels that the same plan drives
live in ``ops/cuda_shear3.py``.

Method: the dst-index map of the rotated resample factors into three
AXIS-ALIGNED passes, chosen by the per-axis cell ratio rho = scale/dst_side:

  rho >= 1, or 'quality':   x-y-x, translates at source pitch
  rho < 1 and 'fast':       y-x-y, "reduce first" (bands before translates)

Each pass is a 1-D conservative resample of its axis: a shared banded
interval-overlap resample and a per-line fractional translate (integer
shift + 2-tap blend, the exact 1-D overlap weights of a pure
translation).  Every stage is mass-preserving on the interior; the
per-pixel boundary renormalisation is a multiply by the reciprocal of the
same pipeline applied to a ones image (``Shear3Plan.inv_cov``).

The plan is O(H + W) tables plus an (Hd, Wd) coverage image; there is no
ELL operator.

* ``StagePlan`` / ``stage_plan(plan)``: the passes in the layout the plain
  stages and the kernels take (int32 shifts, f32 fractions and band
  weights, each stage's input size), cached by table content; each stage
  plan uploads its tables to a device once and keeps them.
* ``plan_tiles`` / ``StageTiles``: each stage's work split for the CUDA
  kernels, tiles of lines by output cells with the input window each
  tile stages (``tile_windows``); a stage whose smallest tile needs more
  shared memory than the card's opt-in limit takes the kernels' direct
  form (``StageTiles.direct``: one thread per output, taps read from
  device memory, the same bits).
* ``ystage_plain`` / ``xstage_plain``: one pass in plain torch, the
  reference the kernels are held to.  Sums are f32, in the order of the
  JAX XLA route (translate tap ``(1-f)`` first, band taps in order, each
  product rounded before its add).
* ``apply_shear3_plain``: the whole pipeline; with ``mid_dtype=float32``
  it is JAX's ``apply_shear3_xla`` (the CPU route of the API), with
  ``mid_dtype=bfloat16`` each stage's output is rounded as the kernel
  route rounds it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..grids import GridSpec
from ..utils.device import SMEM_LIMIT, out_buffer
from ..utils.digest import array_digest
from ..utils.log import build_span
from ..utils.lru import LruDict
from .overlap1d import Band1D


def _interval_band(src_edge0: float, src_pitch: float, n_src: int,
                   n_dst: int) -> Band1D:
    """Banded overlap of unit dst cells [i, i+1) with the uniform source
    grid whose cell j spans [src_edge0 + j*pitch, src_edge0 + (j+1)*pitch).

    Weights are overlap lengths in dst units (interior rows sum to 1
    exactly: the source grid partitions the line), float64 host math.
    """
    p = float(src_pitch)
    e0 = float(src_edge0)
    band = int(math.floor(1.0 / p)) + 2 if p < 1.0 else 2
    i = np.arange(n_dst, dtype=np.float64)
    lo = i          # dst cell i = [i, i+1)
    hi = i + 1.0
    # first source cell whose right edge exceeds lo
    start = np.floor((lo - e0) / p - 1.0).astype(np.int64) + 1
    start = np.clip(start, 0, max(n_src - band, 0))
    k = np.arange(band, dtype=np.float64)
    j = start[:, None] + k[None, :]
    c_lo = e0 + j * p
    c_hi = c_lo + p
    w = np.minimum(hi[:, None], c_hi) - np.maximum(lo[:, None], c_lo)
    w = np.maximum(w, 0.0)
    valid = (j >= 0) & (j < n_src)
    w = np.where(valid, w, 0.0)
    return Band1D(start=start.astype(np.int32), weights=w,
                  n_src=n_src, n_dst=n_dst)


@dataclasses.dataclass(frozen=True)
class Pass1D:
    """One axis-aligned conservative pass of the shear pipeline.

    Translate convention: shifting a line by delta >= 0 cells means
    ``out[u] = (1-f)*v[u-d] + f*v[u-d-1]`` with d = floor(delta),
    f = frac(delta); out-of-range taps read 0.  These are the exact 1-D
    conservative weights of a pure translation.

    Composition order along the pass axis:
      band is None:        out = translate(in)[crop : crop + n_out]
      band_first = True:   out = translate(band(in))[crop : crop + n_out]
      band_first = False:  out = band(translate(in))   (crop == 0; the
                           band maps the translate grid to n_out)
    """

    axis: str                 # 'x' (last axis) or 'y' (second-to-last)
    band: Optional[Band1D]
    band_first: bool
    d: np.ndarray             # (n_lines,) int32 — lines = the OTHER axis
    f: np.ndarray             # (n_lines,) float32
    n_t: int                  # translate-grid size along the pass axis
    crop: int
    n_out: int                # output size along the pass axis


@dataclasses.dataclass(frozen=True)
class Shear3Plan:
    """Host tables for the 3-pass sheared rotated apply (one geometry).

    ``in_shape``/``out_shape`` default to the spec's qrot/dst shapes;
    ADJOINT plans (transpose_shear3_plan) run the reversed transposed
    passes, so their shapes swap and ``inv_cov`` is None (the caller
    chain-rules the coverage onto the cotangent instead)."""

    spec: GridSpec
    passes: Tuple[Pass1D, ...]
    # reciprocal coverage (0 where the footprint never lands,
    # Source.cpp:577's zero-background convention)
    inv_cov: Optional[np.ndarray]    # (out_shape) float32, or None
    in_shape: Optional[Tuple[int, int]] = None
    out_shape: Optional[Tuple[int, int]] = None

    @property
    def src_shape(self) -> Tuple[int, int]:
        return self.in_shape or self.spec.qrot_shape

    @property
    def dst_shape(self) -> Tuple[int, int]:
        return self.out_shape or self.spec.dst_shape


def _split_shift(delta: np.ndarray):
    d = np.floor(delta).astype(np.int64)
    return d, (delta - d)


def _passes_xyx(spec: GridSpec) -> Tuple[Pass1D, ...]:
    """Expand-late x-y-x decomposition (rho = s/L >= 1, and rho == 1)."""
    qH, qW = spec.qrot_shape
    Hd, Wd = spec.dst_shape
    s = float(spec.scale)
    L = spec.dst_side
    c, n = spec.cos, spec.sin
    t = (1.0 - c) / n
    rho = s / L

    p00, _, _ = spec.linear_map
    C2 = (-n * p00[0] - c * p00[1]) / L          # dst_y = (n*x1 + y)/L + C2
    C3 = (-c * p00[0] + n * p00[1]) / L + t * C2

    # ---- pass 1: x1 = x - t*y, pure translate at source pitch --------
    jy = np.arange(qH, dtype=np.float64)
    y_c = jy * s + (s - 1.0) / 2.0
    delta1 = t * (y_c[-1] - y_c) / s             # >= 0, slope t
    d1, f1 = _split_shift(delta1)
    W1 = qW + int(d1.max()) + 2
    o1 = -0.5 - t * y_c[-1]                      # pass-1 grid offset
    passes = [Pass1D(axis="x", band=None, band_first=False,
                     d=d1.astype(np.int32), f=f1.astype(np.float32),
                     n_t=W1, crop=0, n_out=W1)]

    # ---- pass 2: dst_y = (n*x1 + y)/L + C2 ---------------------------
    u = np.arange(W1, dtype=np.float64)
    delta2 = n * u                               # per-column, slope n
    x1c0 = o1 + 0.5 * s
    E2_0 = (n * x1c0 - 0.5) / L + C2
    if s == L:
        delta2 = delta2 + E2_0 + 0.5
        crop2 = max(0, int(math.ceil(-float(delta2.min()))))
        delta2 = delta2 + crop2
        d2, f2 = _split_shift(delta2)
        H1 = max(crop2 + Hd, qH + int(d2.max()) + 2)
        passes.append(Pass1D(axis="y", band=None, band_first=False,
                             d=d2.astype(np.int32),
                             f=f2.astype(np.float32),
                             n_t=H1, crop=crop2, n_out=Hd))
    else:
        d2, f2 = _split_shift(delta2)
        H1 = qH + int(d2.max()) + 2
        passes.append(Pass1D(
            axis="y", band=_interval_band(E2_0 + 0.5, rho, H1, Hd),
            band_first=False, d=d2.astype(np.int32),
            f=f2.astype(np.float32), n_t=H1, crop=0, n_out=Hd))

    # ---- pass 3: dst_x = x1/L - t*dst_y + C3 -------------------------
    v = np.arange(Hd, dtype=np.float64)
    delta3 = t * (v[-1] - v) * L / s             # >= 0
    E3_0 = o1 / L - t * (Hd - 1.0) + C3
    if s == L:
        delta3 = delta3 + E3_0 + 0.5
        crop3 = max(0, int(math.ceil(-float(delta3.min()))))
        delta3 = delta3 + crop3
        d3, f3 = _split_shift(delta3)
        W2 = max(crop3 + Wd, W1 + int(d3.max()) + 2)
        passes.append(Pass1D(axis="x", band=None, band_first=False,
                             d=d3.astype(np.int32),
                             f=f3.astype(np.float32),
                             n_t=W2, crop=crop3, n_out=Wd))
    else:
        d3, f3 = _split_shift(delta3)
        W2 = W1 + int(d3.max()) + 2
        passes.append(Pass1D(
            axis="x", band=_interval_band(E3_0 + 0.5, rho, W2, Wd),
            band_first=False, d=d3.astype(np.int32),
            f=f3.astype(np.float32), n_t=W2, crop=0, n_out=Wd))
    return tuple(passes)


def _passes_yxy(spec: GridSpec) -> Tuple[Pass1D, ...]:
    """Reduce-first y-x-y decomposition (rho = s/L < 1, downscaling).

      y1    = (t*x + y)/L + c1     band-first: reduce rows, then shift
      dst_x = x/L - n*y1 + c2      band-first: reduce cols, then shift
      dst_y = y1 + t*dst_x + c3    pure translate at dst pitch

    Verified: x/L - n*(tx+y)/L = (c*x - n*y)/L and
    (tx+y)/L + t*(cx-ny)/L = (n*x + c*y)/L — the exact dst-index maps.
    """
    qH, qW = spec.qrot_shape
    Hd, Wd = spec.dst_shape
    s = float(spec.scale)
    L = spec.dst_side
    c, n = spec.cos, spec.sin
    t = (1.0 - c) / n
    rho = s / L
    p00, _, _ = spec.linear_map
    Cx0 = -(c * p00[0] - n * p00[1]) / L         # dst_x = (c*x - n*y)/L + Cx0
    Cy0 = -(n * p00[0] + c * p00[1]) / L         # dst_y = (n*x + c*y)/L + Cy0
    c3 = Cy0 - t * Cx0                           # dst_y = y1 + t*dst_x + c3

    # ---- pass 1 (y): band reduce mu = y/L, then shift by t*x/L -------
    # source row j spans mu in [(j*s-0.5)/L, +rho); mid rows unit cells
    # [r + om, r+1+om) with om = -0.5/L  ->  band edges at 0 relative
    n_mid1 = int(math.ceil(qH * rho)) + 2
    om = -0.5 / L
    B1 = _interval_band(0.0, rho, qH, n_mid1)
    x_c = (np.arange(qW, dtype=np.float64) * s + (s - 1.0) / 2.0)
    delta1 = t * (x_c - x_c[0]) / L              # >= 0, slope t*s/L
    d1, f1 = _split_shift(delta1)
    n_t1 = n_mid1 + int(d1.max()) + 2
    # y1 grid: cell v = [v + o1v, v+1+o1v) with o1v = om + t*x_c[0]/L + c1;
    # c1 is free — fold it to 0 and carry the offset symbolically
    o1v = om + t * x_c[0] / L
    passes = [Pass1D(axis="y", band=B1, band_first=True,
                     d=d1.astype(np.int32), f=f1.astype(np.float32),
                     n_t=n_t1, crop=0, n_out=n_t1)]

    # ---- pass 2 (x): band reduce xi = x/L, then shift by -n*y1 + c2 --
    n_mid2 = int(math.ceil(qW * rho)) + 2
    B2 = _interval_band(0.0, rho, qW, n_mid2)
    oxi = -0.5 / L
    # out position (xt = dst_x + 0.5): mid cell m + oxi - n*y1c(v) + Cx0
    # + 0.5; y1 center of row v: v + 0.5 + o1v
    v = np.arange(n_t1, dtype=np.float64)
    delta2 = oxi - n * (v + 0.5 + o1v) + Cx0 + 0.5
    crop2 = max(0, int(math.ceil(-float(delta2.min()))))
    delta2 = delta2 + crop2
    assert delta2.min() >= 0.0
    d2, f2 = _split_shift(delta2)
    n_t2 = max(crop2 + Wd, n_mid2 + int(d2.max()) + 2)
    passes.append(Pass1D(axis="x", band=B2, band_first=True,
                         d=d2.astype(np.int32), f=f2.astype(np.float32),
                         n_t=n_t2, crop=crop2, n_out=Wd))

    # ---- pass 3 (y): pure translate, dst pitch -----------------------
    # out position (yt = dst_y + 0.5): y1 cell v + o1v + t*k + c3 + 0.5
    # per dst column k (dst_x center = k)
    k = np.arange(Wd, dtype=np.float64)
    delta3 = o1v + t * k + c3 + 0.5
    crop3 = max(0, int(math.ceil(-float(delta3.min()))))
    delta3 = delta3 + crop3
    assert delta3.min() >= 0.0
    d3, f3 = _split_shift(delta3)
    n_t3 = max(crop3 + Hd, n_t1 + int(d3.max()) + 2)
    passes.append(Pass1D(axis="y", band=None, band_first=False,
                         d=d3.astype(np.int32), f=f3.astype(np.float32),
                         n_t=n_t3, crop=crop3, n_out=Hd))
    return tuple(passes)


def build_shear3_plan(spec: GridSpec,
                      decomposition: str = "auto") -> Shear3Plan:
    """Pass tables for one GridSpec (host float64).

    decomposition:
      'auto'/'quality' — x-y-x with translates at source pitch: the
          robust accuracy point.
      'fast' — y-x-y reduce-first when the geometry downscales
          (scale < dst_side), else x-y-x: the per-line translates run on
          the REDUCED grids, at dst-pitch translate quantisation.
      'xyx' / 'yxy' — force a specific decomposition (yxy requires
          scale < dst_side).
    Valid for any residual angle in (0, 90); axis-aligned geometries
    should use the separable operator (raises ValueError).
    """
    if spec.is_axis_aligned:
        raise ValueError("shear3 is for rotated geometries; axis-aligned "
                         "specs take the separable path")
    rho = spec.scale / spec.dst_side
    if decomposition in ("auto", "quality"):
        decomposition = "xyx"
    elif decomposition == "fast":
        decomposition = "yxy" if rho < 1.0 else "xyx"
    if decomposition == "xyx":
        passes = _passes_xyx(spec)
    elif decomposition == "yxy":
        if rho >= 1.0:
            raise ValueError("yxy (reduce-first) needs scale < dst_side")
        passes = _passes_yxy(spec)
    else:
        raise ValueError(f"unknown decomposition {decomposition!r}")
    plan = Shear3Plan(spec=spec, passes=passes,
                      inv_cov=np.ones((1, 1), np.float32))
    cov = _coverage_np(plan)
    inv_cov = np.where(cov > 1e-6, 1.0 / np.maximum(cov, 1e-30), 0.0)
    return dataclasses.replace(plan, inv_cov=inv_cov.astype(np.float32))


# ----------------------------------------------------------------------
# host (numpy) reference apply — also builds the coverage image
# ----------------------------------------------------------------------


def _translate_np(x: np.ndarray, d: np.ndarray, f: np.ndarray,
                  n_out: int) -> np.ndarray:
    """Per-line fractional translate along the LAST axis (float64).

    out[u] = (1-f)*x[u-d] + f*x[u-d-1]; (d, f) vary along axis -2."""
    n_in = x.shape[-1]
    lines = x.shape[-2]
    assert d.shape[0] == lines, (d.shape, x.shape)
    u = np.arange(n_out)
    j0 = u[None, :] - d[:, None].astype(np.int64)
    out = np.zeros(x.shape[:-1] + (n_out,), np.float64)
    for tap, wf in ((j0, 1.0 - f[:, None]), (j0 - 1, f[:, None])):
        valid = (tap >= 0) & (tap < n_in)
        tc = np.clip(tap, 0, n_in - 1)
        vals = np.take_along_axis(
            x, np.broadcast_to(tc, x.shape[:-1] + (n_out,)), axis=-1)
        out += np.where(valid, vals * wf, 0.0)
    return out


def _band_np(x: np.ndarray, band: Band1D) -> np.ndarray:
    """Banded 1-D resample along the LAST axis (numpy, float64)."""
    n_in = x.shape[-1]
    K = band.band
    start = band.start.astype(np.int64)
    out = np.zeros(x.shape[:-1] + (band.n_dst,), np.float64)
    for k in range(K):
        j = start + k
        valid = (j >= 0) & (j < n_in)
        jc = np.clip(j, 0, n_in - 1)
        vals = np.take_along_axis(
            x, np.broadcast_to(jc, x.shape[:-1] + (band.n_dst,)), axis=-1)
        out += np.where(valid, vals * band.weights[:, k], 0.0)
    return out


def _apply_pass_np(x: np.ndarray, p: Pass1D) -> np.ndarray:
    if p.axis == "y":
        x = np.swapaxes(x, -1, -2)
    f64 = p.f.astype(np.float64)
    if p.band is not None and p.band_first:
        x = _band_np(x, p.band)
        x = _translate_np(x, p.d, f64, p.n_t)
        x = x[..., p.crop: p.crop + p.n_out]
    elif p.band is not None:
        x = _translate_np(x, p.d, f64, p.n_t)
        x = _band_np(x, p.band)
    else:
        x = _translate_np(x, p.d, f64, p.n_t)
        x = x[..., p.crop: p.crop + p.n_out]
    if p.axis == "y":
        x = np.swapaxes(x, -1, -2)
    return x


def apply_shear3_np(plan: Shear3Plan, q: np.ndarray,
                    normalize: bool = True) -> np.ndarray:
    """Reference numpy apply of the pass pipeline: (..., qH, qW) ->
    (..., Hd, Wd), float64.  Used by tests and the coverage build."""
    x = np.asarray(q, np.float64)
    for p in plan.passes:
        x = _apply_pass_np(x, p)
    if normalize and plan.inv_cov is not None:
        x = x * plan.inv_cov.astype(np.float64)
    return x


def _coverage_np(plan: Shear3Plan) -> np.ndarray:
    """Coverage = pipeline applied to a ones image (interior == 1)."""
    qH, qW = plan.src_shape
    return apply_shear3_np(plan, np.ones((qH, qW)), normalize=False)


# ----------------------------------------------------------------------
# adjoint plan: the pass vocabulary is closed under transposition
# ----------------------------------------------------------------------


def _transpose_translate(d: np.ndarray, f: np.ndarray, n_in: int,
                         crop: int, n_out: int):
    """Tables of (crop o translate)^T as another (translate, crop) pair.

    Forward (n_in -> n_out): out[u] = (1-f) v[u+crop-d] + f v[u+crop-d-1]
    for u in [0, n_out).  The adjoint scatters cot back:
    v_bar[j] = (1-f) cot[j+d-crop] + f cot[j+d+1-crop] — itself a
    fractional translate with per-line shift crop - d - f, lifted by an
    integer K so every shift is >= 0 and realised as translate-then-crop.
    Returns (d_T, f_T, n_t_T, crop_T=K, n_out_T=n_in).
    """
    d = d.astype(np.int64)
    fpos = f > 0.0
    d_T = np.where(fpos, crop - d - 1, crop - d)
    f_T = np.where(fpos, 1.0 - f, 0.0)
    K = max(0, int(-d_T.min()))
    d_T = d_T + K
    n_t_T = max(K + n_in, n_out + int(d_T.max()) + 2)
    return (d_T.astype(np.int32), f_T.astype(np.float32), int(n_t_T),
            int(K), int(n_in))


def _stage_inputs(plan: Shear3Plan) -> Tuple[int, ...]:
    """Each pass's input size along its own axis (Pass1D doesn't store
    it): walk the chain from the plan's source shape."""
    rows, cols = plan.src_shape
    sizes = []
    for p in plan.passes:
        sizes.append(rows if p.axis == "y" else cols)
        if p.axis == "y":
            rows = p.n_out
        else:
            cols = p.n_out
    return tuple(sizes)


def transpose_shear3_plan(plan: Shear3Plan) -> Shear3Plan:
    """The exact adjoint pipeline as another Shear3Plan.

    Reverse the passes and transpose each component: translate^T is a
    translate with lifted negated shifts (+ crop by the lift), band^T
    is overlap1d.transpose_band, and pre-band <-> post-band swap.  The
    adjoint plan carries inv_cov=None — the coverage chain rule
    (q_bar = P^T (inv_cov * cot)) belongs to the caller.
    """
    from .overlap1d import transpose_band

    passes_T = []
    for p, n_stage_in in zip(reversed(plan.passes),
                             reversed(_stage_inputs(plan))):
        if p.band is not None and p.band_first:
            # forward: crop o T o B   (B: n_stage_in -> band.n_dst;
            #                          T: band.n_dst -> crop window)
            # adjoint: B^T o T^T — band AFTER translate
            d_T, f_T, n_t_T, K, _ = _transpose_translate(
                p.d, p.f, p.band.n_dst, p.crop, p.n_out)
            bT = transpose_band(p.band)      # band.n_dst -> n_stage_in
            # the post-band consumes the translate GRID in our pass
            # semantics: fold the crop K into the band's start offsets
            bT2 = Band1D(start=(bT.start.astype(np.int64) + K
                                ).astype(np.int32),
                         weights=bT.weights, n_src=n_t_T,
                         n_dst=bT.n_dst)
            passes_T.append(Pass1D(axis=p.axis, band=bT2,
                                   band_first=False, d=d_T, f=f_T,
                                   n_t=n_t_T, crop=0, n_out=bT.n_dst))
        elif p.band is not None:
            # forward: B o T   (T: n_stage_in -> n_t; B: n_t -> n_out)
            # adjoint: T^T o B^T — band FIRST, then translate + crop
            bT = transpose_band(p.band)      # n_out -> n_t
            d_T, f_T, n_t_T, K, n_out_T = _transpose_translate(
                p.d, p.f, n_stage_in, 0, p.n_t)
            passes_T.append(Pass1D(axis=p.axis, band=bT,
                                   band_first=True, d=d_T, f=f_T,
                                   n_t=n_t_T, crop=K, n_out=n_out_T))
        else:
            d_T, f_T, n_t_T, K, n_out_T = _transpose_translate(
                p.d, p.f, n_stage_in, p.crop, p.n_out)
            passes_T.append(Pass1D(axis=p.axis, band=None,
                                   band_first=False, d=d_T, f=f_T,
                                   n_t=n_t_T, crop=K, n_out=n_out_T))
    return Shear3Plan(spec=plan.spec, passes=tuple(passes_T),
                      inv_cov=None, in_shape=plan.dst_shape,
                      out_shape=plan.src_shape)


# ----------------------------------------------------------------------
# stage plan: the passes in the layout the plain stages and kernels take
# ----------------------------------------------------------------------

# stage forms, as the kernels number them
TRANSLATE, PRE_BAND, POST_BAND = 0, 1, 2
_DTYPES = (torch.float32, torch.bfloat16, torch.uint8)


@dataclasses.dataclass(frozen=True, eq=False)
class StageTiles:
    """The stage kernels' work split: tiles of ``TL`` lines by ``TU``
    output cells, one block each, and each tile's window.

    ``win[a, b]`` = (lo, hi, mlo, mhi) for output tile ``a`` and line
    tile ``b``: input cells [lo, hi) along the pass axis hold every tap
    that the tile's outputs read inside the input, and for a PRE_BAND
    stage mid cells [mlo, mhi) every mid cell they read inside
    [0, n_mid).  All four are 0 for an empty tile, whose outputs are 0
    whatever the input.  ``direct``: even the smallest tile's block needs
    more shared memory than the card's opt-in limit, so the kernels take
    their direct form (one thread per output element, taps read from
    device memory in the same order; the tiles are then unused)."""

    TL: int
    TU: int
    win: np.ndarray          # (n_out tiles, n_lines tiles, 4) int32
    max_win: int             # max hi - lo
    max_mid: int             # max mhi - mlo (PRE_BAND), else 0
    direct: bool = False


@dataclasses.dataclass(frozen=True, eq=False)
class Stage:
    """One pass: ``form`` TRANSLATE (translate, crop), PRE_BAND (band to
    ``n_mid``, translate, crop) or POST_BAND (translate over the grid of
    ``n_t``, band to ``n_out``).  Lines run along the other axis;
    ``tiles`` is the kernels' work split (``stage_tiles``)."""

    axis: str
    form: int
    n_in: int            # input size along the pass axis
    n_lines: int
    n_mid: int           # the pre-band's output size (PRE_BAND), else n_in
    n_t: int
    crop: int
    n_out: int
    K: int               # band width, 0 without a band
    d: np.ndarray        # (n_lines,) int32
    f: np.ndarray        # (n_lines,) float32
    start: np.ndarray    # (band rows,) int32; empty without a band
    w: np.ndarray        # (band rows, K) float32; empty without a band
    tiles: Optional[StageTiles] = None

    def frame_shape(self, n: int) -> Tuple[int, int]:
        """(rows, cols) of a frame with ``n`` cells along the pass axis."""
        return (n, self.n_lines) if self.axis == "y" else (self.n_lines, n)

    @property
    def in_shape(self) -> Tuple[int, int]:
        return self.frame_shape(self.n_in)

    @property
    def out_shape(self) -> Tuple[int, int]:
        return self.frame_shape(self.n_out)


@dataclasses.dataclass(eq=False)
class StagePlan:
    """A Shear3Plan's stages and reciprocal coverage, host and device."""

    stages: Tuple[Stage, ...]
    inv_cov: Optional[np.ndarray]    # (Hd, Wd) float32, or None
    src_shape: Tuple[int, int]
    dst_shape: Tuple[int, int]
    dev: Dict[torch.device, tuple] = dataclasses.field(
        default_factory=dict, repr=False)

    def tables(self, device) -> tuple:
        """(per-stage dicts of d, f, start, w and the tile windows
        ``win``; inv_cov or None) on ``device``, uploaded once and
        kept."""
        device = torch.device(device)
        hit = self.dev.get(device)
        if hit is None:
            with build_span("build.upload"):
                per = tuple(
                    {**{k: torch.from_numpy(getattr(st, k)).to(device)
                        for k in ("d", "f", "start", "w")},
                     "win": torch.from_numpy(st.tiles.win).to(device)}
                    for st in self.stages)
                cov = (None if self.inv_cov is None
                       else torch.from_numpy(self.inv_cov).to(device))
            hit = (per, cov)
            self.dev[device] = hit
        return hit


# bounded: each stage plan holds its coverage image (7.8 MB f32 at
# 1399^2) on the host and once more per device
_STAGE_CACHE = LruDict(16, max_bytes=1 << 30, name="shear3.stage")


def _stage(p: Pass1D, n_in: int, n_lines: int) -> Stage:
    if p.d.shape != (n_lines,) or p.f.shape != (n_lines,):
        raise ValueError(f"pass along {p.axis} has {p.d.shape[0]} shifts "
                         f"for {n_lines} lines")
    if p.band is None:
        form, n_mid, K = TRANSLATE, n_in, 0
    elif p.band_first:
        form, n_mid, K = PRE_BAND, p.band.n_dst, p.band.band
        if p.band.n_src != n_in:
            raise ValueError(f"pre-band reads {p.band.n_src} cells of a "
                             f"{n_in}-cell input")
    else:
        form, n_mid, K = POST_BAND, n_in, p.band.band
        if (p.band.n_src, p.band.n_dst, p.crop) != (p.n_t, p.n_out, 0):
            raise ValueError("post-band must map the translate grid to the "
                             "output, uncropped")
    if form != POST_BAND and p.crop + p.n_out > p.n_t:
        raise ValueError(f"crop {p.crop} + n_out {p.n_out} exceeds the "
                         f"translate grid {p.n_t}")
    if p.band is None:
        start = np.zeros(0, np.int32)
        w = np.zeros((0, 0), np.float32)
    else:
        start = np.ascontiguousarray(p.band.start, dtype=np.int32)
        w = np.ascontiguousarray(p.band.weights, dtype=np.float32)
    st = Stage(axis=p.axis, form=form, n_in=int(n_in),
               n_lines=int(n_lines), n_mid=int(n_mid), n_t=int(p.n_t),
               crop=int(p.crop), n_out=int(p.n_out), K=int(K),
               d=np.ascontiguousarray(p.d, dtype=np.int32),
               f=np.ascontiguousarray(p.f, dtype=np.float32),
               start=start, w=w)
    with build_span("build.tiles"):
        tiles = plan_tiles(st)
    return dataclasses.replace(st, tiles=tiles)


# ----------------------------------------------------------------------
# the stage kernels' tiles (csrc/shear3_stage.cu)
# ----------------------------------------------------------------------

# tile shapes (TL lines, TU outputs), in order of preference (measured at
# the shear flagship on the H100, PERF.md): a y-stage block owns TL
# neighbouring columns by TU rows, an x-stage block TL rows by TU
# neighbouring cells.  Each of a block's _THREADS threads computes 4 lines
# at a time: y takes TL <= 128, x TL <= 4 * _THREADS / 32 and a
# power-of-two TU (csrc/shear3_stage.cu, run_stage)
_THREADS = 128
_Y_TILES = ((64, 64), (32, 64), (32, 32), (16, 32), (16, 16), (8, 16), (8, 8),
            (4, 8), (4, 4), (4, 2), (4, 1))
_X_TILES = ((8, 256), (8, 128), (4, 128), (4, 64), (4, 32), (4, 16), (4, 8),
            (4, 4))
# the first tile whose shared memory at f32 fits this is taken (bf16 and u8
# stage in less)
SMEM_BUDGET = 72 * 1024


def seg_pitch(seg_bytes: int, stride_bytes: int) -> int:
    """Shared-memory pitch of one staged segment: at least ``seg_bytes`` +
    32 and equal to the segment's global stride mod 16, so a 16-byte
    global chunk lands on a 16-byte shared address and element e of
    segment s sits at ``base + s * pitch + e * elem`` (csrc/shear3_stage.cu,
    ``Dims::pitch``)."""
    p = seg_bytes + 32
    return p + (stride_bytes - p) % 16


def stage_smem(st: Stage, TL: int, max_win: int, max_mid: int,
               elem: int) -> int:
    """Dynamic shared memory, in bytes, of a block of ``st`` staging
    ``elem``-byte input: the window's segments (y: one per input row, TL
    lines wide; x: one per line, ``max_win`` cells long), the f32 mid
    cells of a PRE_BAND stage, and the f32 output transpose (4 outputs of
    each thread)."""
    if st.axis == "y":
        segs, pitch = max_win, seg_pitch(TL * elem, st.n_lines * elem)
    else:
        segs, pitch = TL, seg_pitch(max_win * elem, st.n_in * elem)

    def up16(n):
        return -(-n // 16) * 16
    mid = 4 * TL * max_mid if st.form == PRE_BAND else 0
    return up16(32 + segs * pitch) + up16(mid) + 4 * _THREADS * 4


def _range_reduce(a: np.ndarray, lo: np.ndarray, hi: np.ndarray, op):
    """op(a[lo:hi]) for each pair (lo < hi) of the index arrays, by a
    sparse table of power-of-two spans."""
    levels = [a]
    while 2 ** len(levels) <= len(a):
        prev, h = levels[-1], 2 ** (len(levels) - 1)
        levels.append(op(prev[:-h], prev[h:]))
    n = np.maximum(hi - lo, 1)
    k = np.floor(np.log2(n)).astype(np.int64)
    out = np.empty(lo.shape, a.dtype)
    for lv in np.unique(k):
        sel = k == lv
        tab = levels[lv]
        out[sel] = op(tab[lo[sel]], tab[hi[sel] - 2 ** lv])
    return out


def tile_windows(st: Stage, TL: int, TU: int) -> np.ndarray:
    """(lo, hi, mlo, mhi) of every tile of ``TL`` lines by ``TU`` output
    cells of ``st``, (n_out tiles, n_lines tiles, 4) int32: see
    ``StageTiles``.  A window is the union over the tile's lines of the
    taps its outputs read, clipped to the input (and the mid line)."""
    d = st.d.astype(np.int64)
    l0 = np.arange(0, st.n_lines, TL)
    dmin = np.minimum.reduceat(d, l0)[None, :]
    dmax = np.maximum.reduceat(d, l0)[None, :]
    u0 = np.arange(0, st.n_out, TU)
    u1 = np.minimum(u0 + TU, st.n_out) - 1          # last output of a tile
    zero = np.zeros((len(u0), len(l0)), np.int64)
    mlo = mhi = zero
    empty = np.zeros(zero.shape, bool)
    if st.form == TRANSLATE:
        # out[u] reads in[u + crop - d - 1 .. u + crop - d]
        lo = (u0 + st.crop)[:, None] - dmax - 1
        hi = (u1 + st.crop)[:, None] - dmin + 1
    elif st.form == POST_BAND:
        # out[u] reads the translate grid cells c = start[u] + k inside
        # [0, n_t), and T[c] reads in[c - d - 1 .. c - d]
        s = st.start.astype(np.int64)
        cmin = np.maximum(np.minimum.reduceat(s, u0), 0)
        cmax = np.minimum(np.maximum.reduceat(s, u0) + st.K - 1, st.n_t - 1)
        lo = cmin[:, None] - dmax - 1
        hi = cmax[:, None] - dmin + 1
        empty |= (cmin > cmax)[:, None]
    else:
        # out[u] reads mid[u + crop - d - 1 .. u + crop - d] inside
        # [0, n_mid), and mid[m] reads in[start[m] .. start[m] + K - 1]
        mlo = np.clip((u0 + st.crop)[:, None] - dmax - 1, 0, st.n_mid)
        mhi = np.clip((u1 + st.crop)[:, None] - dmin + 1, 0, st.n_mid)
        empty |= mhi <= mlo
        s = st.start.astype(np.int64)
        a, b = np.where(empty, 0, mlo), np.where(empty, 1, mhi)
        lo = _range_reduce(s, a.ravel(), b.ravel(), np.minimum
                           ).reshape(a.shape)
        hi = _range_reduce(s, a.ravel(), b.ravel(), np.maximum
                           ).reshape(a.shape) + st.K
    lo = np.clip(lo, 0, st.n_in)
    hi = np.clip(hi, 0, st.n_in)
    empty |= hi <= lo
    win = np.stack([lo, hi, mlo, mhi], axis=-1)
    win[empty] = 0
    return np.ascontiguousarray(win, dtype=np.int32)


def plan_tiles(st: Stage) -> StageTiles:
    """The first tile shape of the stage's axis whose block fits
    ``SMEM_BUDGET`` at f32, with its windows.  If none fits, the smallest
    shape: the launch then asks for more shared memory, up to the card's
    opt-in limit ``SMEM_LIMIT``, and beyond it the stage takes the direct
    form (``StageTiles.direct``)."""
    for TL, TU in (_Y_TILES if st.axis == "y" else _X_TILES):
        win = tile_windows(st, TL, TU)
        max_win = int((win[..., 1] - win[..., 0]).max())
        max_mid = int((win[..., 3] - win[..., 2]).max())
        smem = stage_smem(st, TL, max_win, max_mid, 4)
        if smem <= SMEM_BUDGET:
            break
    return StageTiles(TL=TL, TU=TU, win=win, max_win=max_win,
                      max_mid=max_mid, direct=smem > SMEM_LIMIT)


def stage_plan(plan: Shear3Plan) -> StagePlan:
    """The stages of ``plan``, cached by table content."""
    key = [plan.src_shape, plan.dst_shape,
           None if plan.inv_cov is None else array_digest(plan.inv_cov)]
    for p in plan.passes:
        key += [p.axis, p.band_first, p.n_t, p.crop, p.n_out,
                array_digest(p.d), array_digest(p.f)]
        if p.band is not None:
            key += [p.band.n_src, p.band.n_dst, array_digest(p.band.start),
                    array_digest(p.band.weights)]
    key = tuple(key)
    hit = _STAGE_CACHE.get(key)
    if hit is None:
        rows, cols = plan.src_shape
        stages = []
        for p, n_in in zip(plan.passes, _stage_inputs(plan)):
            stages.append(_stage(p, n_in, cols if p.axis == "y" else rows))
            if p.axis == "y":
                rows = p.n_out
            else:
                cols = p.n_out
        if (rows, cols) != tuple(plan.dst_shape):
            raise ValueError(f"passes end at {(rows, cols)}, plan says "
                             f"{plan.dst_shape}")
        inv_cov = None
        if plan.inv_cov is not None:
            inv_cov = np.ascontiguousarray(plan.inv_cov, dtype=np.float32)
            if inv_cov.shape != (rows, cols):
                raise ValueError(f"inv_cov {inv_cov.shape} != dst "
                                 f"{(rows, cols)}")
        hit = StagePlan(stages=tuple(stages), inv_cov=inv_cov,
                        src_shape=tuple(plan.src_shape),
                        dst_shape=(rows, cols))
        _STAGE_CACHE.put(key, hit)
    return hit


def stage_dtypes(in_dtype: torch.dtype, mid_dtype: torch.dtype,
                 out_dtype: Optional[torch.dtype]):
    """(input, mid, output) dtypes of a pipeline run, as both routes take
    them (pallas_shear3.py:484-491): inputs other than bf16/f32/u8 are
    read as f32, the output defaults to the input's dtype, and an f32
    input never stages in bf16."""
    if in_dtype not in _DTYPES:
        in_dtype = torch.float32
    out_dtype = in_dtype if out_dtype is None else out_dtype
    if mid_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"mid_dtype must be float32 or bfloat16, got "
                        f"{mid_dtype}")
    if in_dtype == torch.float32:
        mid_dtype = torch.float32
    if out_dtype not in _DTYPES:
        raise TypeError(f"out_dtype must be one of {_DTYPES}, got "
                        f"{out_dtype}")
    return in_dtype, mid_dtype, out_dtype


def check_stage_input(x: torch.Tensor, st: Stage, axis: str) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"stage input must be a torch.Tensor, got {type(x)}")
    if st.axis != axis:
        raise ValueError(f"this stage runs along {st.axis}, not {axis}")
    if x.ndim != 3 or tuple(x.shape[1:]) != st.in_shape:
        raise ValueError(f"stage input must be (F, {st.in_shape[0]}, "
                         f"{st.in_shape[1]}) for this plan, got "
                         f"{tuple(x.shape)}")
    if x.shape[0] == 0:
        raise ValueError("stage input has no frames")
    if x.dtype not in _DTYPES:
        raise TypeError(f"stage input must be one of {_DTYPES}, got "
                        f"{x.dtype}")


# ----------------------------------------------------------------------
# plain torch stages and pipeline (the twin of apply_shear3_xla)
# ----------------------------------------------------------------------


def _translate(x: torch.Tensor, d: torch.Tensor, f: torch.Tensor,
               n_out: int, offset: int = 0) -> torch.Tensor:
    """Translate-grid cells ``offset .. offset + n_out - 1`` of a
    per-line fractional translate along the last axis (f32):
    ``out[u] = (1-f) x[u-d] + f x[u-d-1]``, taps outside read 0."""
    n_in = x.shape[-1]
    u = torch.arange(offset, offset + n_out, device=x.device)
    j0 = u[None, :] - d[:, None].to(torch.int64)
    fw = f[:, None]
    out = torch.zeros(x.shape[:-1] + (n_out,), dtype=x.dtype,
                      device=x.device)
    for tap, wf in ((j0, 1.0 - fw), (j0 - 1, fw)):
        valid = (tap >= 0) & (tap < n_in)
        idx = tap.clamp(0, n_in - 1).expand(x.shape[:-1] + (n_out,))
        out = out + torch.where(valid, torch.gather(x, -1, idx) * wf, 0.0)
    return out


def _band(x: torch.Tensor, start: torch.Tensor, w: torch.Tensor,
          n_dst: int) -> torch.Tensor:
    """Banded 1-D resample along the last axis (f32), masked to the
    input: ``out[i] = sum_k w[i, k] x[start[i] + k]``."""
    n_in = x.shape[-1]
    out = torch.zeros(x.shape[:-1] + (n_dst,), dtype=x.dtype,
                      device=x.device)
    for k in range(w.shape[1]):
        j = start.to(torch.int64) + k
        valid = (j >= 0) & (j < n_in)
        vals = x.index_select(-1, j.clamp(0, n_in - 1))
        out = out + torch.where(valid, vals * w[:, k], 0.0)
    return out


def cast_out(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """f32 -> ``dtype``; uint8 rounds half to even and saturates."""
    if dtype == torch.uint8:
        return torch.clamp(torch.round(x), 0.0, 255.0).to(torch.uint8)
    return x.to(dtype)


def _stage_plain(x, sp: StagePlan, i: int, axis: str, out_dtype, out):
    st = sp.stages[i]
    check_stage_input(x, st, axis)
    per, cov = sp.tables(x.device)
    t = per[i]
    v = x.to(torch.float32)
    if axis == "y":
        v = v.transpose(-1, -2)
    if st.form == PRE_BAND:
        v = _band(v, t["start"], t["w"], st.n_mid)
        v = _translate(v, t["d"], t["f"], st.n_out, st.crop)
    elif st.form == POST_BAND:
        v = _translate(v, t["d"], t["f"], st.n_t)
        v = _band(v, t["start"], t["w"], st.n_out)
    else:
        v = _translate(v, t["d"], t["f"], st.n_out, st.crop)
    if axis == "y":
        v = v.transpose(-1, -2)
    if i == len(sp.stages) - 1 and cov is not None:
        v = v * cov
    v = cast_out(v, out_dtype).contiguous()   # a stage writes a fresh frame
    if out is None:
        return v
    return out_buffer(out, v.shape, out_dtype, x.device).copy_(v)


def ystage_plain(x: torch.Tensor, sp: StagePlan, i: int, *,
                 out_dtype: torch.dtype = torch.float32,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stage ``i`` of ``sp``, a pass along y (lines are columns), in plain
    torch: (F, n_in, n_lines) -> (F, n_out, n_lines) in ``out_dtype``.
    The plan's last stage multiplies by the reciprocal coverage before
    the cast."""
    return _stage_plain(x, sp, i, "y", out_dtype, out)


def xstage_plain(x: torch.Tensor, sp: StagePlan, i: int, *,
                 out_dtype: torch.dtype = torch.float32,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stage ``i`` of ``sp``, a pass along x (lines are rows), in plain
    torch: (F, n_lines, n_in) -> (F, n_lines, n_out)."""
    return _stage_plain(x, sp, i, "x", out_dtype, out)


def run_stages(q: torch.Tensor, plan: Shear3Plan, stage_fns, *,
               mid_dtype: torch.dtype,
               out_dtype: Optional[torch.dtype]) -> torch.Tensor:
    """(..., qH, qW) -> (..., Hd, Wd) through ``stage_fns`` =
    (ystage, xstage), each stage's output in the mid dtype and the last
    one's in the output dtype (see ``stage_dtypes``)."""
    if not isinstance(q, torch.Tensor):
        raise TypeError(f"frames must be a torch.Tensor, got {type(q)}")
    if q.dtype.is_complex or q.dtype == torch.bool:
        raise TypeError(f"unsupported frame dtype {q.dtype}")
    sp = stage_plan(plan)
    if q.ndim < 2 or tuple(q.shape[-2:]) != sp.src_shape:
        raise ValueError(f"frames must be (..., {sp.src_shape[0]}, "
                         f"{sp.src_shape[1]}) for this plan, got "
                         f"{tuple(q.shape)}")
    in_dtype, mid, out_dtype = stage_dtypes(q.dtype, mid_dtype, out_dtype)
    lead = q.shape[:-2]
    x = q.to(in_dtype).reshape((-1,) + sp.src_shape).contiguous()
    ystage, xstage = stage_fns
    n = len(sp.stages)
    for i, st in enumerate(sp.stages):
        fn = ystage if st.axis == "y" else xstage
        x = fn(x, sp, i, out_dtype=out_dtype if i == n - 1 else mid)
    return x.reshape(lead + sp.dst_shape)


def apply_shear3_plain(q: torch.Tensor, plan: Shear3Plan, *,
                       mid_dtype: torch.dtype = torch.float32,
                       out_dtype: Optional[torch.dtype] = None
                       ) -> torch.Tensor:
    """The pass pipeline in plain torch: (..., qH, qW) -> (..., Hd, Wd).

    With ``mid_dtype=float32`` (the default) it is JAX's
    ``apply_shear3_xla``: every stage in f32, the output in the input's
    dtype (bf16, f32, u8; other dtypes give f32).  With ``bfloat16`` each
    stage's output is rounded to bf16 as the kernel route rounds it.
    Differentiable by torch autograd.
    """
    return run_stages(q, plan, (ystage_plain, xstage_plain),
                      mid_dtype=mid_dtype, out_dtype=out_dtype)
