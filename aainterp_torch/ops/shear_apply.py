"""Shear re-indexing of the ELL operator (host, exact ints and float64).

Counterpart of ``build_shear_plan`` in ``aainterp/ops/shear_apply.py``,
carried over.  Two integer shears — a vertical one per source column,
then a horizontal one per sheared row — move every destination pixel's
candidate window to ``T[ry0(dy) + a, cx0(dx) + b]``, with per-row and
per-column bases.  The shear composition is a bijection on cell
coordinates, so the exact ELL weights are re-indexed into the sheared
window with no change in value.  Window growth from the two roundings is
about +2 per axis; geometries whose sheared windows blow up are rejected
(ValueError), and callers then take the flat-gather apply.

The device side is ``ops/cuda_shear.py``: the two shears and the window
contraction, as CUDA kernels and as plain torch.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .weights import EllOperator


@dataclasses.dataclass(frozen=True)
class ShearPlan:
    """Host-precomputed shear layout for one EllOperator."""

    TH: int
    TW: int
    qH: int
    qW: int
    gy: np.ndarray      # (qW,) vertical shift per source column
    hx: np.ndarray      # (TH,) horizontal shift per sheared row (>= 0)
    ry0: np.ndarray     # (Hd,) per-dst-row tap base in T rows
    cx0: np.ndarray     # (Wd,) per-dst-col tap base in T cols
    weights: np.ndarray  # (Hd, Wd, Ka, Kb) re-indexed exact weights


def shear_shifts(spec):
    """(gy, hx, TH, TW) of a grid spec's two integer shears: gy (qW,) the
    vertical shift of each source column, hx (TH,) the horizontal shift
    of each sheared row (>= 0), int64, and the sheared planes' height and
    width."""
    qH, qW = spec.qrot_shape
    c, sn = spec.cos, spec.sin
    tan = sn / c if c != 0 else 0.0

    # vertical shear cancels the dx-dependence of the row index:
    #   Ty ~ jy + jx*tan(theta); horizontal shear must then cancel the
    # dy-dependence of the column index given u ~ dy*L/(s*cos):
    #   hx(u) = -u*sin*cos  (so  jx + hx(Ty) loses its dy term exactly)
    gy = np.round(np.arange(qW) * tan).astype(np.int64)
    TH = int(qH + (gy.max() if qW else 0) + 1)
    u = np.arange(TH)
    hx_raw = -np.round(u * (sn * c)).astype(np.int64)
    hx = hx_raw - hx_raw.min()
    TW = int(qW + hx.max() + 1)
    return gy, hx, TH, TW


def build_shear_plan(op: EllOperator, max_window: int = 24) -> ShearPlan:
    """Re-index an ELL operator into the sheared layout (host, float64).

    Raises ValueError for an empty operator or a sheared window wider
    than ``max_window`` on either axis.
    """
    spec = op.spec
    qH, qW = spec.qrot_shape
    Hd, Wd = spec.dst_shape
    K = op.window
    gy, hx, TH, TW = shear_shifts(spec)

    # int32 working set: (Hd, Wd, K, K) reaches ~70M cells at 2048^2 —
    # narrow dtypes + no broadcast materialisation keep this pass in
    # seconds
    a = np.arange(K, dtype=np.int32)
    gy32 = gy.astype(np.int32)
    hx32 = hx.astype(np.int32)
    jyc = np.clip(op.base[..., 0:1, None] + a[:, None], 0, qH - 1)
    jxc = np.clip(
        op.base[..., 1:2, None].swapaxes(-1, -2) + a[None, :], 0, qW - 1
    )
    Ty = jyc + gy32[jxc]        # (Hd, Wd, K, K) by broadcasting
    Tx = jxc + hx32[Ty]

    # spreads are computed over nonzero-weight cells only (edge windows are
    # clamped into range, and their zero-weight fringe cells would otherwise
    # inflate the sheared window)
    live = op.weights != 0.0
    if not live.any():
        raise ValueError("empty operator")
    iy, ix, ia, ib = np.nonzero(live)
    Ty_l = Ty[iy, ix, ia, ib]
    Tx_l = Tx[iy, ix, ia, ib]
    BIG = np.int32(1 << 30)
    Ty_live = np.where(live, Ty, BIG)
    Tx_live = np.where(live, Tx, BIG)
    ry0 = Ty_live.min(axis=(1, 2, 3))
    cx0 = Tx_live.min(axis=(0, 2, 3))
    # all-zero rows/cols (outside the rotated footprint): harmless base
    ry0 = np.where(ry0 == BIG, 0, ry0)
    cx0 = np.where(cx0 == BIG, 0, cx0)
    Ty_hi = np.where(live, Ty, -1)
    Tx_hi = np.where(live, Tx, -1)
    Ka = int((Ty_hi.max(axis=(1, 2, 3)) - ry0).max()) + 1
    Kb = int((Tx_hi.max(axis=(0, 2, 3)) - cx0).max()) + 1
    if Ka > max_window or Kb > max_window:
        raise ValueError(f"sheared window {Ka}x{Kb} too large")
    # keep gathers in range
    ry0 = np.clip(ry0, 0, max(TH - Ka, 0)).astype(np.int32)
    cx0 = np.clip(cx0, 0, max(TW - Kb, 0)).astype(np.int32)
    a2_l = Ty_l - ry0[iy]
    b2_l = Tx_l - cx0[ix]
    # zero-weight cells may land anywhere; live cells must fit the window
    assert a2_l.min() >= 0 and a2_l.max() < Ka
    assert b2_l.min() >= 0 and b2_l.max() < Kb

    # the shear composition is bijective on cells, so live cells never
    # collide: plain fancy assignment replaces the (slow) np.add.at
    w2 = np.zeros((Hd, Wd, Ka, Kb), dtype=op.weights.dtype)
    w2[iy, ix, a2_l, b2_l] = op.weights[iy, ix, ia, ib]

    return ShearPlan(TH=TH, TW=TW, qH=qH, qW=qW,
                     gy=gy.astype(np.int32), hx=hx.astype(np.int32),
                     ry0=ry0, cx0=cx0, weights=w2)
