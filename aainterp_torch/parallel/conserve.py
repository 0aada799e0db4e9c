"""Sharded global conservation check (counterpart of
``aainterp/parallel/conserve.py``): local dots, then one ``all_reduce``,
for row-sharded and 2-D (rows x cols) sharded applies.

The check is an exact linear identity.  For a resampling operator
``dst = W_norm @ src`` with raw (un-normalised) overlap weights
``W_raw[d, s] = W_norm[d, s] * raw_row_sum[d]``:

    sum_d raw_row_sum[d] * dst[d]  ==  sum_s cov[s] * src[s],
    cov[s] = sum_d W_raw[d, s]      (source-cell coverage)

Both sides are the same triple sum reordered, so they agree to rounding
on any input (the multi-device form of Source.cpp:573-577).  ``cov`` is
data-independent and made on the host; each rank adds its block's dots
and one ``all_reduce`` gives every rank the global pair.  A halo, rebase
or kernel fault on any rank breaks the identity.

The local dots are summed in float64, where JAX sums them in float32: at
8 x 2160 x 3840 source terms (66 M) float32 sums would leave the pair's
own rounding near the check's tolerance.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import upload
from . import mesh as mesh_ops


def separable_flux_factors(y_band, x_band, raw_sums=None):
    """Host factors (my, mx, covy, covx) for a separable operator.

    The 2-D raw weight factorises as
    ``W_raw[(r,c),(jy,jx)] = my[r]*wy[r,jy] * mx[c]*wx[c,jx]`` with
    ``my/mx`` the per-axis raw overlap sums, so both fluxes factorise into
    row/column dots: flux_dst = my^T dst mx, flux_src = covy^T src covx.

    raw_sums: optional (sums_y, sums_x) from SeparableOperator.
    raw_row_sums; defaults to all-ones measure (valid — the identity holds
    for any dst measure, ones simply checks plain row-sum conservation).
    """
    my = np.ones(y_band.n_dst) if raw_sums is None else np.asarray(raw_sums[0], np.float64)
    mx = np.ones(x_band.n_dst) if raw_sums is None else np.asarray(raw_sums[1], np.float64)
    covy = np.zeros(y_band.n_src, np.float64)
    covx = np.zeros(x_band.n_src, np.float64)
    ys = np.asarray(y_band.start)
    yw = np.asarray(y_band.weights, np.float64)
    for k in range(yw.shape[1]):
        np.add.at(covy, np.clip(ys + k, 0, y_band.n_src - 1), my * yw[:, k])
    xs = np.asarray(x_band.start)
    xw = np.asarray(x_band.weights, np.float64)
    for k in range(xw.shape[1]):
        np.add.at(covx, np.clip(xs + k, 0, x_band.n_src - 1), mx * xw[:, k])
    return my, mx, covy, covx


def ell_flux_factors(op):
    """Host factors (m2, cov) for an ELL operator.

    m2[d] = raw 2-D overlap area of dst cell d (op.raw_row_sums);
    cov[jy, jx] = sum_d m2[d] * weights[d, a, b] scattered to the source
    cell each tap addresses (indices clipped as the apply clips them) —
    the coverage of that rotated-source cell.  The scatter is a
    ``np.bincount`` in the taps' order, the same sums in the same order
    as JAX's ``np.add.at``.
    """
    qH, qW = op.spec.qrot_shape
    K = op.window
    m2 = np.asarray(op.raw_row_sums, np.float64)
    w = np.asarray(op.weights, np.float64) * m2[..., None, None]
    a = np.arange(K)
    jy = np.clip(op.base[..., 0:1, None] + a[:, None], 0, qH - 1)
    jx = np.clip(op.base[..., 1:2, None].swapaxes(-1, -2) + a[None, :], 0,
                 qW - 1)
    idx = np.broadcast_to(jy * qW + jx, w.shape)
    cov = np.bincount(idx.ravel(), weights=w.ravel(), minlength=qH * qW)
    return m2, cov.reshape(qH, qW)


def _cut(v: np.ndarray, mesh, name: str, local: int, what: str):
    """This rank's block of a host factor ``v`` along its leading axis,
    cut over the mesh dim ``name``; ``local`` is the block's length."""
    n, i, _ = mesh_ops.axis(mesh, name)
    if len(v) % n or len(v) // n != local:
        raise ValueError(f"{what} block has {local} {name}; the factors "
                         f"give {len(v)} {name} over {n} shards")
    return v[i * local:(i + 1) * local]


def _reduce(fd: torch.Tensor, fs: torch.Tensor) -> torch.Tensor:
    """The (2,) float64 pair of this rank's dots, summed over the whole
    mesh (``mesh.make_mesh`` spans every rank of the process group) in
    one ``all_reduce``."""
    return mesh_ops.all_reduce(torch.stack([fd, fs]), None)


def _separable(src, dst, factors, mesh, cols: bool) -> torch.Tensor:
    my, mx, covy, covx = (np.ascontiguousarray(f, dtype=np.float64)
                          for f in factors)
    dev = dst.device
    my = _cut(my, mesh, mesh_ops.ROWS, dst.shape[-2], "dst")
    covy = _cut(covy, mesh, mesh_ops.ROWS, src.shape[-2], "src")
    if cols:
        mx = _cut(mx, mesh, mesh_ops.COLS, dst.shape[-1], "dst")
        covx = _cut(covx, mesh, mesh_ops.COLS, src.shape[-1], "src")

    def dot(x, rows, cols):
        return torch.einsum("...rc,r,c->", x.to(torch.float64),
                            torch.as_tensor(rows, device=dev),
                            torch.as_tensor(cols, device=dev))

    return _reduce(dot(dst, my, mx), dot(src.to(dev), covy, covx))


def sharded_flux_separable(src: torch.Tensor, dst: torch.Tensor, factors,
                           mesh) -> torch.Tensor:
    """(2,) float64 [flux_dst, flux_src] on ``dst``'s device, the same on
    every rank: this rank's float64 dots, then one ``all_reduce`` over the
    whole mesh.

    src/dst: this rank's row blocks, (b, rows, cols) (src in the
    orientation of the band operators).  The row factors are cut to the
    rank's rows; the column factors are whole.
    """
    return _separable(src, dst, factors, mesh, False)


def sharded_flux_separable_2d(src: torch.Tensor, dst: torch.Tensor,
                              factors, mesh) -> torch.Tensor:
    """``sharded_flux_separable`` for 2-D (rows x cols) sharded applies:
    src/dst are this rank's 2-D blocks; the row factors are cut to its
    rows and the column factors to its columns (JAX: conserve.py:128)."""
    return _separable(src, dst, factors, mesh, True)


def _ell(src, dst, factors, mesh, cols: bool) -> torch.Tensor:
    m2, cov = (np.ascontiguousarray(f, dtype=np.float64) for f in factors)
    dev = dst.device
    m2 = _cut(m2, mesh, mesh_ops.ROWS, dst.shape[-2], "dst")
    cov = _cut(cov, mesh, mesh_ops.ROWS, src.shape[-2], "src")
    if cols:
        m2 = _cut(m2.T, mesh, mesh_ops.COLS, dst.shape[-1], "dst").T
        cov = _cut(cov.T, mesh, mesh_ops.COLS, src.shape[-1], "src").T

    def dot(x, f):
        return torch.einsum("...rc,rc->", x.to(torch.float64),
                            upload(np.ascontiguousarray(f), dev))

    return _reduce(dot(dst, m2), dot(src.to(dev), cov))


def sharded_flux_ell(src: torch.Tensor, dst: torch.Tensor, factors,
                     mesh) -> torch.Tensor:
    """(2,) float64 [flux_dst, flux_src] of the rotated (ELL) apply on
    ``dst``'s device, the same on every rank: this rank's float64 dots
    ``sum(dst * m2)`` and ``sum(src * cov)`` over its rows, then one
    ``all_reduce`` over the whole mesh.

    src: this rank's source rows in the orientation of the operator whose
    ``ell_flux_factors`` these are; dst: its output rows.  (m2, cov) are
    whole (Hd, Wd) and (qH, qW) host arrays, cut to the rank's rows.
    """
    return _ell(src, dst, factors, mesh, False)


def sharded_flux_ell_2d(src: torch.Tensor, dst: torch.Tensor, factors,
                        mesh) -> torch.Tensor:
    """``sharded_flux_ell`` for the 2-D (rows x cols) sharded rotated
    apply: m2 and cov are cut to this rank's rows and columns (JAX:
    conserve.py:203)."""
    return _ell(src, dst, factors, mesh, True)
