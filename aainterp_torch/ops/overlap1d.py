"""1-D interval-overlap weights: the separable weight-generation stage.

Counterpart of ``aainterp/ops/overlap1d.py`` (host numpy, carried over so
the port never imports the JAX package; the tests hold both to identical
tables).

For axis-aligned resampling (residual rotation == 0) the exact overlap area
between a destination pixel and a source cell factors into a product of two
1-D interval overlaps, so the whole operator is ``dst = Wy @ src @ Wx.T``
followed by a separable normalisation.

Geometry (mod coordinates, see aainterp_torch.grids):
  dst interval i  : [(i + f)*L - L/2, (i + f)*L + L/2]     (Source.cpp:212-219 at angle 0)
  src cell j      : [j*scale - 0.5, j*scale + scale - 0.5]  (replica block)
  overlap(i, j)   = clip(min(hi_i, hi_j) - max(lo_i, lo_j), 0)

Weights are generated on the host in float64 (data-independent, cacheable)
in a banded layout with a static band width.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class Band1D:
    """Banded 1-D overlap operator with a static band width.

    ``weights[i, k]`` is the overlap of dst interval ``i`` with src cell
    ``start[i] + k``; entries for out-of-range cells are 0.  ``start`` is
    clamped so that ``start[i] + band - 1 < n_src`` whenever possible.
    """

    start: np.ndarray    # (n_dst,) int32, first src cell of the band
    weights: np.ndarray  # (n_dst, band) float64
    n_src: int
    n_dst: int

    @property
    def band(self) -> int:
        return self.weights.shape[1]

    def dense(self) -> np.ndarray:
        """Materialise the (n_dst, n_src) dense operator (tests/small sizes)."""
        W = np.zeros((self.n_dst, self.n_src), dtype=self.weights.dtype)
        for k in range(self.band):
            j = self.start + k
            valid = (j >= 0) & (j < self.n_src)
            W[np.arange(self.n_dst)[valid], j[valid]] = self.weights[valid, k]
        return W

    def row_sums(self) -> np.ndarray:
        return self.weights.sum(axis=1)


def overlap_band_1d(
    n_dst: int,
    n_src: int,
    dst_side: float,
    scale: int,
    iso_offset: float,
    offset: float = 0.0,
) -> Band1D:
    """Exact 1-D interval overlaps, banded with static width.

    Parameters mirror one axis of a GridSpec: dst interval i is
    ``[(i+iso_offset)*dst_side + offset - dst_side/2, ... + dst_side/2]`` and
    src cell j is ``[j*scale - 0.5, j*scale + scale - 0.5]`` (mod coords).
    """
    L = float(dst_side)
    s = float(scale)
    i = np.arange(n_dst, dtype=np.float64)
    lo = (i + iso_offset) * L + offset - L / 2.0
    hi = lo + L

    # band width: a dst interval of length L can overlap at most
    # floor(L/s) + 2 cells of length s.
    band = int(math.floor(L / s)) + 2

    # first candidate cell: smallest j with j*s + s - 0.5 > lo
    start = np.floor((lo + 0.5) / s - 1.0).astype(np.int64) + 1
    # clamp into range so gather indices are always valid; weights of the
    # shifted-in cells are computed honestly and come out 0 when disjoint.
    start = np.clip(start, 0, max(n_src - band, 0))

    k = np.arange(band, dtype=np.float64)
    j = start[:, None] + k[None, :]
    cell_lo = j * s - 0.5
    cell_hi = cell_lo + s
    w = np.minimum(hi[:, None], cell_hi) - np.maximum(lo[:, None], cell_lo)
    w = np.maximum(w, 0.0)
    # mask cells outside the image (can appear after clamping start to 0)
    valid = (j >= 0) & (j < n_src)
    w = np.where(valid, w, 0.0)

    return Band1D(
        start=start.astype(np.int32),
        weights=w,
        n_src=n_src,
        n_dst=n_dst,
    )


def count_band_1d(
    n_dst: int,
    n_src: int,
    dst_side: float,
    scale: int,
    iso_offset: float,
    offset: float = 0.0,
    eps: float = 1e-9,
) -> Band1D:
    """Fast-mode 1-D weights: replica-center counts instead of overlaps.

    The reference's fast mode counts replicated pixel centers inside the dst
    footprint (Source.cpp:866-907).  In 1-D, the weight of original cell j is
    the number of replica centers ``j*scale + m`` (m = 0..scale-1) inside the
    dst interval, boundary inclusive (the ray-cast at Source.cpp:837-864
    counts tangent points as inside via DBL_EPSILON fuzz).
    """
    L = float(dst_side)
    s = int(scale)
    i = np.arange(n_dst, dtype=np.float64)
    lo = (i + iso_offset) * L + offset - L / 2.0
    hi = lo + L

    band = int(math.floor(L / s)) + 2
    start = np.floor((lo + 0.5) / s - 1.0).astype(np.int64) + 1
    start = np.clip(start, 0, max(n_src - band, 0))

    k = np.arange(band)
    j = start[:, None] + k[None, :]
    counts = np.zeros((n_dst, band), dtype=np.float64)
    for m in range(s):
        c = j * float(s) + m  # replica center coordinate
        inside = (lo[:, None] - eps <= c) & (c <= hi[:, None] + eps)
        counts += inside.astype(np.float64)
    valid = (j >= 0) & (j < n_src)
    counts = np.where(valid, counts, 0.0)

    return Band1D(
        start=start.astype(np.int32),
        weights=counts,
        n_src=n_src,
        n_dst=n_dst,
    )


def transpose_band(band: Band1D) -> Band1D:
    """Banded layout of the transposed 1-D operator (n_src rows).

    ``start`` is monotone non-decreasing (overlap windows slide forward),
    so the dst rows touching a given src cell ``j`` form one contiguous
    run and the transpose is banded too, with band width
    ``max_j #{i : start[i] <= j < start[i] + band}``.  Exact:
    ``transpose_band(b).dense() == b.dense().T`` entry for entry.

    This is the host half of the apply stage's autograd backward: the
    adjoint of ``dst = Wy @ q @ Wx.T`` is ``q_bar = Wy.T @ g @ Wx``, i.e.
    another separable banded apply with transposed bands.
    """
    start = band.start.astype(np.int64)
    w = band.weights
    Nd, K = w.shape
    Ns = int(band.n_src)
    j = np.arange(Ns, dtype=np.int64)
    # contributing rows for column j: start[i] in (j - K, j]
    i_lo = np.searchsorted(start, j - K, side="right")
    i_hi = np.searchsorted(start, j, side="right") - 1
    Kp = max(1, int((i_hi - i_lo + 1).max(initial=1)))
    st = np.clip(i_lo, 0, max(Nd - Kp, 0))
    m = np.arange(Kp, dtype=np.int64)
    ii = st[:, None] + m[None, :]
    ii_c = np.clip(ii, 0, Nd - 1)
    kk = j[:, None] - start[ii_c]
    valid = (ii < Nd) & (kk >= 0) & (kk < K)
    wt = np.where(valid, w[ii_c, np.clip(kk, 0, K - 1)], 0.0)
    return Band1D(start=st.astype(np.int32), weights=wt, n_src=Nd, n_dst=Ns)


def reverse_rows_band(band: Band1D) -> Band1D:
    """Band of ``P @ W`` where P reverses the destination axis.

    A row permutation just permutes the per-row (start, weights) table.
    Needed for the transposes of flipped bands:
    ``(W P)^T == P W^T == reverse_rows_band(transpose_band(W))`` — the
    backward tables of the quadrant-folded separable apply.
    """
    return Band1D(start=np.ascontiguousarray(band.start[::-1]),
                  weights=np.ascontiguousarray(band.weights[::-1]),
                  n_src=band.n_src, n_dst=band.n_dst)


def flip_band(band: Band1D) -> Band1D:
    """Band of ``W @ P`` where P reverses the source axis.

    Folds a source-index reversal into the table: entry (i, j) of the
    result equals ``band``'s entry (i, n_src-1-j).  With the quadrant
    pre-rotation expressed as source flips/swaps, this lets the separable
    apply consume the ORIGINAL image for any quadrant — no rotated copy
    is ever materialised.
    """
    n, K = int(band.n_src), band.band
    start = band.start.astype(np.int64)
    start_new = np.clip(n - K - start, 0, max(n - K, 0))
    # entry k of the new row i is source column start_new+k, i.e. old
    # column n-1-(start_new+k), i.e. old tap n-1-start_new-k-start
    k = np.arange(K, dtype=np.int64)
    old_tap = (n - 1 - start_new[:, None]) - k[None, :] - start[:, None]
    valid = (old_tap >= 0) & (old_tap < K)
    w = np.where(valid,
                 band.weights[np.arange(len(start))[:, None],
                              np.clip(old_tap, 0, K - 1)], 0.0)
    return Band1D(start=start_new.astype(np.int32), weights=w,
                  n_src=band.n_src, n_dst=band.n_dst)


def compose_band(outer: Band1D, inner: Band1D) -> Band1D:
    """Band of the matrix product ``outer @ inner`` (one fused operator).

    ``inner`` maps n_src -> n_mid and ``outer`` maps n_mid -> n_dst; the
    product of two banded operators is banded (width < inner.band +
    outer.band * stride), so a multi-stage resampling pipeline — e.g.
    coarsen then regrid, or two chained resizes — collapses into ONE
    banded apply: one pass over the pixels instead of one per stage,
    with the intermediate image never materialised.  Exact (float64
    host arithmetic); row-normalised inputs stay row-normalised.
    """
    if outer.n_src != inner.n_dst:
        raise ValueError(
            f"outer.n_src ({outer.n_src}) != inner.n_dst ({inner.n_dst})")
    n_dst, n_src = outer.n_dst, inner.n_src
    ko, ki = outer.band, inner.band
    j = outer.start.astype(np.int64)[:, None] + np.arange(ko)[None, :]
    valid = (j >= 0) & (j < inner.n_dst) & (outer.weights != 0.0)
    jc = np.clip(j, 0, inner.n_dst - 1)
    s_inner = inner.start.astype(np.int64)[jc]          # (n_dst, ko)
    big = np.iinfo(np.int64).max
    lo = np.where(valid, s_inner, big).min(axis=1)
    hi = np.where(valid, s_inner + ki, 0).max(axis=1)
    empty = ~valid.any(axis=1)
    lo = np.where(empty, 0, lo)
    hi = np.where(empty, 1, hi)
    Kc = int((hi - lo).max())
    # reference clamp convention: start + band - 1 < n_src when possible
    start = np.clip(np.minimum(lo, n_src - Kc), 0, None)
    w = np.zeros((n_dst, Kc), dtype=np.float64)
    rows = np.repeat(np.arange(n_dst), ki)
    taps = np.arange(ki)[None, :]
    for t in range(ko):
        off = s_inner[:, t] - start                      # (n_dst,) >= 0
        contrib = (outer.weights[:, t:t + 1]
                   * inner.weights[jc[:, t]]
                   * valid[:, t:t + 1])
        cols = np.clip(off[:, None] + taps, 0, Kc - 1).ravel()
        np.add.at(w, (rows, cols), contrib.ravel())
    return Band1D(start=start.astype(np.int32), weights=w,
                  n_src=n_src, n_dst=n_dst)
