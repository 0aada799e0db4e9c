"""Apply stage, plain PyTorch: the separable banded and dense applies,
the box mean, the ELL (rotated) gather apply and its scatter adjoint.

Counterpart of the plain part of ``aainterp/ops/apply.py``.  These are
the reference implementations the CUDA kernels (``ops/cuda_apply.py``,
``ops/cuda_shear.py``, ``ops/cuda_apply_2d.py``) are held to, and the
routes a CPU tensor takes.  The aligned integer-ratio applies and the
one-axis band contraction serve the band-operator family (``regrid.py``,
the area-resize front doors).  ``apply_ell_transpose`` is the backward of
the rotated apply on every route and device: the JAX package computes it
with XLA's scatter outside any Pallas kernel, and here it is
``index_add_``, whose CUDA form sums with atomics in no fixed order.  The
strided-stencil path (JAX's ``impl='stencil'``) is not ported.

Accumulation is float32 (or the weight dtype) regardless of image dtype,
and the output is in the accumulation dtype: bf16 or uint8 pixels give a
float32 result here, as the JAX XLA route does.  The kernel route keeps
bf16 in -> bf16 out instead (see ``cuda_apply``).
"""

from __future__ import annotations

import numpy as np
import torch


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``fmaf(a, b, c)`` of float32 tensors (broadcast): a * b + c rounded
    once to float32, as the CUDA kernels' fused multiply-adds are, so a
    plain version built on it repeats their sums bit for bit.  The product
    is exact in float64 (24 + 24 bits) and the sum's rounding error exact
    by TwoSum; rounding the sum to odd where it was inexact, then to
    float32, rounds once (53 >= 24 + 2 bits)."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    return torch.where((err != 0) & even, torch.nextafter(s, toward),
                       s).float()


def quadrant_rotate(src: torch.Tensor, quadrant: int) -> torch.Tensor:
    """90-degree quadrant pre-rotation of the source image.

    Cell-level equivalent of the reference's replication loop rotation cases
    (Source.cpp:159-172): quadrant k (k*90 degrees clockwise) is
    ``rot90(src, -k)`` on the trailing two axes.  Quadrant 0 returns
    ``src`` itself (``torch.rot90`` with k=0 would copy it).
    """
    if int(quadrant) % 4 == 0:
        return src
    return torch.rot90(src, k=-int(quadrant), dims=(-2, -1))


def _band_index(start: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """(n_dst, k) source indices of a band, clamped into [0, n).

    When a band is wider than the image the trailing indices go out of
    range (their weights are 0); torch's index_select raises on them,
    where jnp.take fills, so they are clamped first.
    """
    idx = start.to(torch.int64)[:, None] + torch.arange(
        k, dtype=torch.int64, device=start.device)
    return idx.clamp_(0, n - 1)


def apply_separable_banded(
    q: torch.Tensor,
    y_start: torch.Tensor,  # (Hd,) int
    y_w: torch.Tensor,      # (Hd, ky)
    x_start: torch.Tensor,  # (Wd,) int
    x_w: torch.Tensor,      # (Wd, kx)
) -> torch.Tensor:
    """dst = (Wy @ q) @ Wx.T with banded row-normalised weights.

    O(k) work per output pixel instead of the dense O(n).  q may have
    arbitrary leading batch dims: (..., H, W) -> (..., Hd, Wd).  The
    tables must lie on q's device.
    """
    acc_dtype = y_w.dtype
    Hd, ky = y_w.shape
    Wd, kx = x_w.shape
    H, W = q.shape[-2], q.shape[-1]
    lead = q.shape[:-2]
    rows = _band_index(y_start, ky, H)                       # (Hd, ky)
    g = q.index_select(-2, rows.reshape(-1))                 # (..., Hd*ky, W)
    g = g.reshape(lead + (Hd, ky, W)).to(acc_dtype)
    t = torch.einsum("hk,...hkw->...hw", y_w, g)             # (..., Hd, W)
    cols = _band_index(x_start, kx, W)                       # (Wd, kx)
    g2 = t.index_select(-1, cols.reshape(-1))                # (..., Hd, Wd*kx)
    g2 = g2.reshape(lead + (Hd, Wd, kx))
    return torch.einsum("wk,...hwk->...hw", x_w.to(acc_dtype), g2)


def apply_band_axis(q: torch.Tensor, start: torch.Tensor, w: torch.Tensor,
                    axis: int) -> torch.Tensor:
    """Banded contraction along ONE axis of an N-D array.

    out[..., i, ...] = sum_k w[i, k] * q[..., clamp(start[i] + k), ...]
    along ``axis``, in ``w``'s dtype (counterpart of apply.py:69-99; the
    building block of ``api.area_resize_nd``).  The tables must lie on
    q's device.
    """
    k = w.shape[1]
    v = q.movedim(axis, -1)
    idx = _band_index(start, k, v.shape[-1])                 # (n_dst, k)
    g = v.index_select(-1, idx.reshape(-1))
    g = g.reshape(v.shape[:-1] + tuple(idx.shape)).to(w.dtype)
    return torch.einsum("nk,...nk->...n", w, g).movedim(-1, axis)


def aligned_axis_plan(start, w, n: int):
    """dict(m, c0, wk) for an exactly aligned integer-ratio band, else None.

    Aligned means the destination cells PARTITION a contiguous run of
    source cells into equal blocks of m: every dst cell i has exactly m
    contiguous live taps whose first source index is c0 + m*i, and the
    run c0 .. c0 + m*n_dst fits inside the n source cells.  Weights may
    vary per row (the sin-lat weights of an integer-ratio conservative
    regrid qualify: the config-5 0.1 deg -> 1 deg case, m = 10).  Host
    numpy, carried from apply.py:175-218; ``wk`` is the (n_dst, m)
    compacted tap table.
    """
    s = np.asarray(start).astype(np.int64)
    wt = np.asarray(w)
    nd, k = wt.shape
    if nd == 0:
        return None
    live = wt != 0.0
    m = int(live[0].sum())
    if m < 1 or m > k or (live.sum(axis=1) != m).any():
        return None
    first = live.argmax(axis=1)
    idx = np.arange(k)
    run = (first[:, None] <= idx) & (idx < first[:, None] + m)
    if (live != run).any():
        return None  # live taps not one contiguous run
    eff = s + first
    c0 = int(eff[0])
    if c0 < 0 or (eff != c0 + m * np.arange(nd)).any() or c0 + m * nd > n:
        return None
    wk = wt[np.arange(nd)[:, None], first[:, None] + idx[None, :m]]
    return dict(m=m, c0=c0, wk=np.ascontiguousarray(wk))


def _as_weights(wk, acc_dtype, device) -> torch.Tensor:
    if isinstance(wk, torch.Tensor):
        return wk.to(device=device, dtype=acc_dtype)
    return torch.as_tensor(np.asarray(wk), dtype=acc_dtype, device=device)


def apply_separable_aligned(q: torch.Tensor, y_plan, x_plan,
                            acc_dtype=torch.float32) -> torch.Tensor:
    """Aligned integer-ratio separable apply: reshape + weighted tap sum.

    (..., H, W) -> (..., Hd, Wd) for band pairs whose ``aligned_axis_plan``
    exists on both axes; rows first, then columns, in ``acc_dtype`` (the
    order of apply.py:221-249).  Plain torch and differentiable; ``wk``
    may be host arrays or tensors.
    """
    my, cy = int(y_plan["m"]), int(y_plan["c0"])
    mx, cx = int(x_plan["m"]), int(x_plan["c0"])
    wy = _as_weights(y_plan["wk"], acc_dtype, q.device)
    wx = _as_weights(x_plan["wk"], acc_dtype, q.device)
    hd, wd = wy.shape[0], wx.shape[0]
    lead = q.shape[:-2]
    if cy or q.shape[-2] != cy + my * hd:
        q = q.narrow(-2, cy, my * hd)
    t = (q.reshape(lead + (hd, my, q.shape[-1])).to(acc_dtype)
         * wy[:, :, None]).sum(dim=-2)
    if cx or t.shape[-1] != cx + mx * wd:
        t = t.narrow(-1, cx, mx * wd)
    return (t.reshape(lead + (hd, wd, mx)) * wx).sum(dim=-1)


def apply_aligned_axis(q: torch.Tensor, plan, axis: int,
                       acc_dtype=torch.float32) -> torch.Tensor:
    """Aligned integer-ratio banded contraction along ONE axis (the N-D
    sibling of ``apply_separable_aligned``, apply.py:252-271)."""
    m, c0 = int(plan["m"]), int(plan["c0"])
    wk = _as_weights(plan["wk"], acc_dtype, q.device)
    nd_out = wk.shape[0]
    v = q.movedim(axis, -1)
    if c0 or v.shape[-1] != c0 + m * nd_out:
        v = v.narrow(-1, c0, m * nd_out)
    out = (v.reshape(v.shape[:-1] + (nd_out, m)).to(acc_dtype)
           * wk).sum(dim=-1)
    return out.movedim(-1, axis)


def uniform_box_params(y_start, y_w, x_start, x_w, H: int, W: int):
    """(my, mx) if the banded separable operator is an exact uniform integer
    box filter; None otherwise.

    Integer-ratio downscales whose dst-cell edges land on src-cell edges
    produce bands of constant stride m whose m live taps all carry weight
    1/m: the area-average reduces to an m x m box mean.  Edge alignment
    requires the forward-mapped isocenter fraction (m-1)/(2m) per axis,
    i.e. src_isocenter = ((m-1)/2, (m-1)/2) — NOTE the flagship iso=(0,0)
    ratio-2 grid is offset half a src cell (3-tap [1/4, 1/2, 1/4]
    stencil) and is correctly rejected here.  Detection is exact: strides
    must equal m with zero anchor offset, H == m * Hd, all live taps
    bit-identical, and m * w0 == 1 within one rounding of 1/m.
    Host numpy on the band tables.
    """
    params = []
    for start, w, n in ((y_start, y_w, H), (x_start, x_w, W)):
        s = np.asarray(start).astype(np.int64)
        wt = np.asarray(w)
        nd, k = wt.shape
        if nd == 0:
            return None
        live = wt != 0.0
        m = int(live[0].sum())
        if m < 1 or (live.sum(axis=1) != m).any():
            return None
        # live taps must be one contiguous run (boundary rows store a
        # clamped `start` with the weights shifted into trailing columns)
        first = live.argmax(axis=1)
        run = (first[:, None] <= np.arange(k)) & (np.arange(k)
                                                  < first[:, None] + m)
        if (live != run).any():
            return None
        w0 = wt[0, first[0]]
        if (np.where(run, wt, w0) != w0).any():
            return None
        if abs(m * float(w0) - 1.0) > 4e-7:  # one f32 rounding of 1/m
            return None
        eff = s + first  # effective first source row of each dst cell
        if n != m * nd or (eff != m * np.arange(nd)).any():
            return None
        params.append(m)
    return tuple(params)


def apply_box_mean(q: torch.Tensor, my: int, mx: int,
                   acc_dtype=torch.float32) -> torch.Tensor:
    """Exact uniform integer-ratio area average: strided slices + mean.

    Equivalent (to accumulation rounding) to apply_separable_banded with the
    stride-m uniform bands that uniform_box_params detects, but touches each
    source pixel exactly once with zero weight traffic.  Same summation
    order as the JAX version: rows first in the accumulation dtype, then
    columns, then one multiply by 1/(my*mx).
    """
    t = None
    for i in range(my):
        part = q[..., i::my, :].to(acc_dtype)
        t = part if t is None else t + part
    o = None
    for j in range(mx):
        part = t[..., j::mx]
        o = part if o is None else o + part
    return o * torch.tensor(1.0 / (my * mx), dtype=acc_dtype, device=o.device)


def apply_separable_dense(q: torch.Tensor, wy: torch.Tensor,
                          wx: torch.Tensor) -> torch.Tensor:
    """dst = Wy @ q @ Wx.T with dense (Hd, H) / (Wd, W) operators.

    Two matrix products, in float32 (float64 when ``wy`` is float64):
    wasteful for narrow bands, but a cross-check of the banded applies
    and a route for very wide bands.  The operators must lie on q's
    device.
    """
    acc = torch.float64 if wy.dtype == torch.float64 else torch.float32
    t = torch.einsum("yh,...hw->...yw", wy.to(acc), q.to(acc))
    return torch.einsum("...yw,xw->...yx", t, wx.to(acc))


def apply_ell(
    q: torch.Tensor,
    base: torch.Tensor,     # (Hd, Wd, 2) int
    weights: torch.Tensor,  # (Hd, Wd, K, K)
) -> torch.Tensor:
    """Gather-weighted window reduction for the rotated operator.

    For each dst pixel, gathers its K x K candidate source cells (indices
    clamped into the image, as jnp.take does; clamped taps carry zero
    weight) and reduces them with the pre-normalised overlap weights, in
    the weights' dtype.  q: (..., qH, qW) -> (..., Hd, Wd), on q's device
    (the tables must lie there too).
    """
    K = weights.shape[-1]
    qH, qW = q.shape[-2], q.shape[-1]
    lead = q.shape[:-2]
    a = torch.arange(K, dtype=torch.int64, device=base.device)
    ry = (base[..., 0:1].to(torch.int64) + a).clamp_(0, qH - 1)  # (Hd, Wd, K)
    rx = (base[..., 1:2].to(torch.int64) + a).clamp_(0, qW - 1)
    idx = ry[..., :, None] * qW + rx[..., None, :]               # (Hd, Wd, K, K)
    # tap axis leads, as in the JAX version: (K*K, Hd, Wd)
    idx = idx.reshape(idx.shape[:-2] + (K * K,)).movedim(-1, 0)
    w_t = weights.reshape(weights.shape[:-2] + (K * K,)).movedim(-1, 0)
    vals = q.reshape(lead + (qH * qW,)).index_select(-1, idx.reshape(-1))
    vals = vals.reshape(lead + tuple(idx.shape)).to(weights.dtype)
    return (vals * w_t).sum(dim=-3)


def apply_ell_transpose(
    g: torch.Tensor,
    base: torch.Tensor,     # (Hd, Wd, 2) int
    weights: torch.Tensor,  # (Hd, Wd, K, K)
    q_shape,
) -> torch.Tensor:
    """Adjoint of ``apply_ell``: scatter dst cotangents into source cells.

    out[jy, jx] = sum over (dy, dx, a, b) with clip(base[dy,dx] + (a,b))
    == (jy, jx) of weights[dy,dx,a,b] * g[..., dy, dx] — the exact
    transpose of the matrix ``apply_ell`` evaluates (indices clipped the
    same way; clipped taps carry zero weight).  ``index_add_`` in the
    weights' dtype; on a CUDA tensor its atomics sum each source cell's
    terms in no fixed order, so two runs may differ by a few float
    roundings.  g: (..., Hd, Wd) -> (..., qH, qW), on g's device (the
    tables must lie there too).
    """
    qH, qW = int(q_shape[0]), int(q_shape[1])
    K = weights.shape[-1]
    lead = g.shape[:-2]
    a = torch.arange(K, dtype=torch.int64, device=base.device)
    ry = (base[..., 0:1].to(torch.int64) + a).clamp_(0, qH - 1)  # (Hd, Wd, K)
    rx = (base[..., 1:2].to(torch.int64) + a).clamp_(0, qW - 1)
    idx = (ry[..., :, None] * qW + rx[..., None, :]).reshape(-1)
    contrib = weights * g[..., None, None].to(weights.dtype)
    out = torch.zeros(lead + (qH * qW,), dtype=weights.dtype, device=g.device)
    out.index_add_(-1, idx, contrib.reshape(lead + (-1,)))
    return out.reshape(lead + (qH, qW))
