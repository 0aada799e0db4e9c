"""Conservative lat-lon regridding with spherical cell areas, in PyTorch.

Counterpart of ``aainterp/regrid.py``.  The area of a lat-lon cell is
proportional to delta(sin lat) * delta(lon), so the exact conservative
regrid is a separable banded apply whose latitude weights are 1-D
interval overlaps in sin(latitude) and whose longitude weights are plain
angular overlaps.  The host part (``LatLonGrid``,
``_interval_overlap_band``, ``conservative_regrid_operator``) is carried
numpy, bit-equal to the JAX package's tables.

``apply_band_operators`` applies any (y, x) ``Band1D`` pair to (..., H,
W) fields; the area-resize front doors of ``api.py`` ride it too.
Routes (``impl``):

* ``'aligned'``: bands that partition the source into equal integer-ratio
  blocks (``ops.apply.aligned_axis_plan``; the config-5 0.1 deg -> 1 deg
  regrid qualifies with m = 10) run as a reshape + weighted tap sum in
  plain torch, exact f32, differentiable; raises where the bands do not
  qualify;
* ``'kernel'`` (JAX's 'pallas'): the 2-D banded-tile CUDA kernel
  ``csrc/separable_apply_2d.cu`` through ``ops.cuda_apply_2d``; raises on
  a CPU tensor.  It differentiates through ``BandKernelLinear``, whose
  backward is the same kernel on the transposed bands (Pallas has no VJP
  in JAX; the operator is linear, so its adjoint is exact);
* ``'banded'`` (JAX's 'xla'): the plain ``ops.apply.apply_separable_banded``,
  differentiable;
* ``'auto'`` selects by device: ``'kernel'`` for a CUDA tensor, for every
  dtype (on the H100 the kernel takes 0.14 ms for the config-5 f32 batch
  where the aligned route takes 0.31 ms, PERF.md); on the CPU, as the JAX
  package does, ``'aligned'`` for f32 fields whose bands qualify (memoised
  by table content) and ``'banded'`` otherwise.  The kernel's planner
  accepts every band pair, so no route is changed after it is chosen.

Dtypes: uint8 in gives uint8 out on every route (round half to even,
saturate); the kernel route keeps bf16 -> bf16 and f32 -> f32; the plain
routes give f32 for bf16.  ``precision`` (auto/default/high/highest/
bf16x3) selects the kernel's arithmetic (see ``ops.cuda_apply_2d``); the
aligned and banded routes are exact f32 and ignore it.

Public entry points take ``device=``: where given, the call computes
there; without it a tensor keeps its device and other input goes to the
GPU (``utils.device``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .ops import cuda_apply_2d
from .ops.apply import (
    aligned_axis_plan, apply_separable_aligned, apply_separable_banded,
)
from .ops.overlap1d import Band1D
from .utils.device import Device, as_input, upload
from .utils.digest import array_digest
from .utils.lru import LruDict

IMPLS = ("auto", "aligned", "kernel", "banded")


@dataclasses.dataclass(frozen=True)
class LatLonGrid:
    """Regular lat-lon grid: n_lat rows from +90..-90, n_lon cols 0..360."""

    n_lat: int
    n_lon: int

    @property
    def lat_edges(self) -> np.ndarray:
        return np.linspace(90.0, -90.0, self.n_lat + 1)

    @property
    def lon_edges(self) -> np.ndarray:
        return np.linspace(0.0, 360.0, self.n_lon + 1)


def _interval_overlap_band(src_edges: np.ndarray, dst_edges: np.ndarray,
                           band: int) -> Band1D:
    """Generic monotone-interval overlap band (edges may be non-uniform and
    ascending or descending — lat edges run north->south, i.e. descending
    in sin(lat))."""
    n_src = src_edges.size - 1
    n_dst = dst_edges.size - 1
    descending = src_edges[0] > src_edges[-1]
    se = src_edges[::-1] if descending else src_edges

    lo = np.minimum(dst_edges[:-1], dst_edges[1:])
    hi = np.maximum(dst_edges[:-1], dst_edges[1:])
    slo, shi = se[:-1], se[1:]
    # first (ascending-order) src cell with shi > lo
    start = np.clip(np.searchsorted(shi, lo, side="right"), 0,
                    max(n_src - band, 0)).astype(np.int64)
    k = np.arange(band)
    j = np.clip(start[:, None] + k[None, :], 0, n_src - 1)
    w = np.maximum(
        0.0,
        np.minimum(hi[:, None], shi[j]) - np.maximum(lo[:, None], slo[j]),
    )
    # de-duplicate clipped j repeats (when n_src < band)
    dup = np.zeros_like(w, dtype=bool)
    dup[:, 1:] = j[:, 1:] == j[:, :-1]
    w = np.where(dup, 0.0, w)
    if descending:
        # map ascending indices back to the original (descending) cell
        # order: original j = n_src - 1 - ascending j; keep start+k
        # contiguous by reversing the band
        start = n_src - band - start
        w = w[:, ::-1].copy()
        valid_fix = start < 0
        if valid_fix.any():
            # n_src < band edge case: shift and zero-pad
            shift = -start[valid_fix]
            start[valid_fix] = 0
            for i, sh in zip(np.where(valid_fix)[0], shift):
                w[i] = np.roll(w[i], -sh)
                w[i, band - sh:] = 0.0
    return Band1D(start=start.astype(np.int32), weights=w,
                  n_src=n_src, n_dst=n_dst)


def conservative_regrid_operator(
    src: LatLonGrid, dst: LatLonGrid
) -> Tuple[Band1D, Band1D]:
    """(lat_band, lon_band): row-normalised spherical-area overlap operators.

    Latitude weights are overlaps in sin(lat); longitude in degrees.
    Together w[iy,jy]*w[ix,jx] is proportional to the spherical area of
    cell(j) covered by cell(i), so the normalised 2-pass apply is the exact
    area-weighted (conservative first-order) regrid.
    """
    sin_src = np.sin(np.radians(src.lat_edges))
    sin_dst = np.sin(np.radians(dst.lat_edges))
    band_lat = max(2, int(math.ceil(src.n_lat / dst.n_lat)) + 2)
    by = _interval_overlap_band(sin_src, sin_dst, band_lat)
    band_lon = max(2, int(math.ceil(src.n_lon / dst.n_lon)) + 2)
    bx = _interval_overlap_band(src.lon_edges, dst.lon_edges, band_lon)

    def _norm(b: Band1D) -> Band1D:
        s = b.weights.sum(axis=1, keepdims=True)
        safe = np.where(np.abs(s) > 1e-300, s, 1.0)
        return Band1D(start=b.start, weights=np.where(np.abs(s) > 1e-300,
                      b.weights / safe, 0.0), n_src=b.n_src, n_dst=b.n_dst)

    return _norm(by), _norm(bx)


def transpose_band(band: Band1D) -> Band1D:
    """Banded layout of the transposed 1-D operator, for any starts.

    ``ops.overlap1d.transpose_band`` needs monotone starts; a band pair
    given to ``apply_band_operators`` may have any (a flipped band's
    decrease).  Row j of the result holds, from ``start[j]`` on, every dst
    row i whose taps reach source cell j.  Exact:
    ``transpose_band(b).dense() == b.dense().T``.
    """
    Nd, K = band.weights.shape
    Ns = int(band.n_src)
    j = band.start.astype(np.int64)[:, None] + np.arange(K)
    valid = (j >= 0) & (j < Ns)
    i = np.broadcast_to(np.arange(Nd)[:, None], j.shape)[valid]
    j, w = j[valid], band.weights[valid]
    lo = np.full(Ns, Nd, np.int64)
    hi = np.full(Ns, -1, np.int64)
    np.minimum.at(lo, j, i)
    np.maximum.at(hi, j, i)
    touched = hi >= 0
    kt = max(1, int((hi - lo + 1)[touched].max(initial=1)))
    st = np.where(touched, np.clip(lo, 0, max(Nd - kt, 0)), 0)
    wt = np.zeros((Ns, kt), band.weights.dtype)
    wt[j, i - st[j]] = w        # (i, j) pairs are distinct: no sums
    return Band1D(start=st.astype(np.int32), weights=wt, n_src=Nd, n_dst=Ns)


@dataclasses.dataclass(eq=False)
class BandTables:
    """One (y, x) band pair in the layouts its routes take: f32 host
    tables, the aligned plans (None where the bands do not qualify), the
    2-D kernel's plan, and their device copies, uploaded once per device."""

    by: Band1D
    bx: Band1D
    ys: np.ndarray      # (Hd,) int32
    yw: np.ndarray      # (Hd, ky) float32
    xs: np.ndarray      # (Wd,) int32
    xw: np.ndarray      # (Wd, kx) float32
    n_src: Tuple[int, int]
    aligned: Optional[Tuple[dict, dict]]
    plan: dict          # ops.cuda_apply_2d.make_plan of (ys, yw, xs, xw)
    dev: Dict[torch.device, dict] = dataclasses.field(default_factory=dict,
                                                      repr=False)
    _transposed: Optional["BandTables"] = dataclasses.field(default=None,
                                                            repr=False)

    @classmethod
    def of(cls, by: Band1D, bx: Band1D) -> "BandTables":
        ys, yw, xs, xw = (
            np.ascontiguousarray(by.start, dtype=np.int32),
            np.ascontiguousarray(by.weights, dtype=np.float32),
            np.ascontiguousarray(bx.start, dtype=np.int32),
            np.ascontiguousarray(bx.weights, dtype=np.float32))
        # detected on the f32 tables, as regrid.py:153-179 does
        yp = aligned_axis_plan(ys, yw, by.n_src)
        xp = aligned_axis_plan(xs, xw, bx.n_src) if yp is not None else None
        return cls(by=by, bx=bx, ys=ys, yw=yw, xs=xs, xw=xw,
                   n_src=(int(by.n_src), int(bx.n_src)),
                   aligned=None if xp is None else (yp, xp),
                   plan=cuda_apply_2d.make_plan(ys, yw, xs, xw))

    def tables(self, device: torch.device, pinned: bool = False) -> dict:
        """Device copies: 'banded' (ys, yw, xs, xw; the kernel plan's own
        copies) and 'aligned' plans (``pinned``: see
        ``utils.device.upload``)."""
        device = torch.device(device)
        hit = self.dev.get(device)
        if hit is None:
            hit = {"banded": cuda_apply_2d.device_tables(
                self.plan, device, pinned)[:4]}
            if self.aligned is not None:
                hit["aligned"] = tuple(
                    dict(p, wk=upload(p["wk"], device, pinned=pinned))
                    for p in self.aligned)
            self.dev[device] = hit
        return hit

    def transposed(self) -> "BandTables":
        """The tables of the adjoint apply (Wy^T, Wx^T), built once."""
        if self._transposed is None:
            self._transposed = BandTables.of(transpose_band(self.by),
                                             transpose_band(self.bx))
        return self._transposed

    def kernel(self, frames: torch.Tensor, precision: str) -> torch.Tensor:
        """The 2-D kernel on (F, H, W) frames with this pair's plan."""
        return cuda_apply_2d.apply_separable_kernel_2d(
            frames, self.ys, self.yw, self.xs, self.xw, precision=precision,
            plan=self.plan)


# keyed by band-table content; each entry holds small host tables plus one
# device copy per device
_BAND_TABLES = LruDict(32, max_bytes=256 << 20, name="regrid.band_tables")


def band_tables(by: Band1D, bx: Band1D) -> BandTables:
    """The cached ``BandTables`` of a band pair (keyed by table content;
    the aligned plan and the kernel plan are made once per pair)."""
    key = (array_digest(by.start), array_digest(by.weights),
           array_digest(bx.start), array_digest(bx.weights),
           int(by.n_src), int(bx.n_src))
    hit = _BAND_TABLES.get(key)
    if hit is None:
        hit = BandTables.of(by, bx)
        _BAND_TABLES.put(key, hit)
    return hit


class BandKernelLinear(torch.autograd.Function):
    """The kernel route as a differentiable apply: the adjoint of
    ``out = Wy @ q @ Wx^T`` is ``Wy^T @ g @ Wx``, the same kernel on the
    transposed tables at the same precision.  The cotangent comes back in
    the input's dtype."""

    @staticmethod
    def forward(ctx, frames: torch.Tensor, tabs: BandTables,
                precision: str):
        ctx.tabs, ctx.precision, ctx.dtype = tabs, precision, frames.dtype
        return tabs.kernel(frames, precision)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        gq = ctx.tabs.transposed().kernel(g.contiguous(), ctx.precision)
        return gq.to(ctx.dtype), None, None


def _quantise_u8(out: torch.Tensor) -> torch.Tensor:
    """Round half to even and saturate to uint8 (the u8 -> u8 contract)."""
    return out.round().clamp(0.0, 255.0).to(torch.uint8)


def _route(impl: str, field: torch.Tensor, tabs: BandTables,
           precision: str) -> str:
    """The route of one apply, decided before any launch (module
    docstring)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
    cuda_apply_2d.check_precision(precision)
    if impl == "auto":
        if field.is_cuda:
            return "kernel"
        return ("aligned" if field.dtype == torch.float32
                and tabs.aligned is not None else "banded")
    if impl == "aligned" and tabs.aligned is None:
        raise ValueError(
            "impl='aligned' forced but the band pair is not an exactly "
            "aligned integer-ratio partition (aligned_axis_plan returned "
            "None)")
    if impl == "kernel" and not field.is_cuda:
        raise ValueError(
            "impl='kernel' needs a CUDA tensor; got one on "
            f"{field.device} (use impl='auto', 'aligned' or 'banded' on "
            "the CPU)")
    return impl


def apply_band_operators(field, by: Band1D, bx: Band1D, *,
                         impl: str = "auto", precision: str = "auto",
                         device: Device = None) -> torch.Tensor:
    """Apply a (y, x) Band1D pair to (..., H, W) fields (module docstring
    for ``impl``, ``precision``, dtypes and ``device``)."""
    field = as_input(field, device)
    tabs = band_tables(by, bx)
    if tuple(field.shape[-2:]) != tabs.n_src:
        raise ValueError(f"field (..., H, W) must end in {tabs.n_src} for "
                         f"these bands, got {tuple(field.shape)}")
    route = _route(impl, field, tabs, precision)
    u8 = field.dtype == torch.uint8
    if route == "kernel":
        lead = field.shape[:-2]
        frames = field.reshape((-1,) + tuple(field.shape[-2:])).contiguous()
        out = BandKernelLinear.apply(frames, tabs, precision)
        return out.reshape(lead + out.shape[-2:])
    dev = tabs.tables(field.device)
    f = field.to(torch.float32) if u8 else field
    if route == "aligned":
        out = apply_separable_aligned(f, *dev["aligned"])
    else:
        out = apply_separable_banded(f, *dev["banded"])
    return _quantise_u8(out) if u8 else out


def _masked_ratio(num, den, fill_value: float, min_coverage: float):
    """num/den where den > min_coverage, else fill_value (safe divide)."""
    keep = den > min_coverage
    return torch.where(keep, num / torch.where(keep, den, torch.ones_like(den)),
                       torch.tensor(fill_value, dtype=num.dtype,
                                    device=num.device))


def apply_band_operators_masked(field, mask, by: Band1D, bx: Band1D, *,
                                fill_value: float = float("nan"),
                                min_coverage: float = 1e-6,
                                impl: str = "auto", precision: str = "auto",
                                device: Device = None):
    """Masked (valid-cell-renormalised) banded apply.

    ``out = A(field * mask) / A(mask)`` with the same row-normalised
    operator A for both applies: the overlap-area-weighted mean over valid
    cells.  Destination cells whose valid coverage is <= ``min_coverage``
    get ``fill_value``.  ``mask``: (H, W) or broadcastable to ``field``'s
    trailing dims, nonzero = valid; it goes to the field's device.  A
    shared (H, W) mask takes one denominator apply.  Output is float (the
    u8 contract does not apply).  Returns (out, coverage), coverage =
    A(mask) per destination cell.
    """
    field = as_input(field, device)
    m = torch.as_tensor(mask, device=field.device).to(torch.float32)
    f = field.to(torch.float32) if field.dtype == torch.uint8 else field
    kw = dict(impl=impl, precision=precision)
    num = apply_band_operators(f * m, by, bx, **kw)
    # a shared (H, W) mask needs ONE denominator apply: it broadcasts
    # against the batched numerator in the ratio
    den = apply_band_operators(m, by, bx, **kw)
    return _masked_ratio(num, den, fill_value, min_coverage), den


def conservative_regrid(field, src: LatLonGrid, dst: LatLonGrid, *,
                        src_mask=None, fill_value: float = float("nan"),
                        min_coverage: float = 1e-6, impl: str = "auto",
                        precision: str = "auto",
                        device: Device = None) -> torch.Tensor:
    """Regrid (..., n_lat, n_lon) fields conservatively.  Routing knobs as
    in ``apply_band_operators``.

    src_mask: optional (n_lat, n_lon) validity mask (nonzero = valid):
    the result is then the valid-cell-renormalised conservative mean and
    destination cells with coverage <= min_coverage get fill_value (call
    ``apply_band_operators_masked`` for the coverage itself)."""
    by, bx = conservative_regrid_operator(src, dst)
    if src_mask is not None:
        out, _ = apply_band_operators_masked(
            field, src_mask, by, bx, fill_value=fill_value,
            min_coverage=min_coverage, impl=impl, precision=precision,
            device=device)
        return out
    return apply_band_operators(field, by, bx, impl=impl,
                                precision=precision, device=device)


def conservative_regrid_sharded(field: torch.Tensor, src: LatLonGrid,
                                dst: LatLonGrid, mesh, *, col_axis=None,
                                conserve: bool = False, src_mask=None,
                                fill_value: float = float("nan"),
                                min_coverage: float = 1e-6):
    """Multi-device conservative regrid (BASELINE config 5): latitude rows
    sharded over the mesh's ``rows`` dim with a ring halo exchange
    (``parallel.sharding``), the batch over its ``data`` dim; with
    ``col_axis="cols"`` longitude too, over the ``cols`` dim of a
    ("data", "rows", "cols") mesh, with a second ring halo (for global
    grids too large for a latitude-only split).  Any other ``col_axis``
    raises.

    ``field`` is this rank's block, (B / n_data, n_lat / n_rows, n_lon)
    (``parallel.mesh.shard_rows``), or with ``col_axis`` (B / n_data,
    n_lat / n_rows, n_lon / n_cols) (``parallel.mesh.shard_blocks``);
    returns its block of the dst.  Each rank applies its rows (and
    columns) of the bands, rebased into its halo-extended block
    (``parallel.sharding.sharded_local_apply``), on the route
    ``apply_band_operators(impl='auto')`` takes: kernel 2 on a CUDA
    tensor, the aligned or banded plain route on the CPU.

    src_mask: the whole (n_lat, n_lon) validity mask (nonzero = valid),
    the same on every rank; its block is halo-extended as the field's is,
    and the result is ``apply_band_operators_masked``'s
    valid-cell-renormalised mean, as ``conservative_regrid`` gives it.

    conserve: also return the (2,) float64 [flux_dst, flux_src] global
    spherical-flux pair, the same on every rank (area-weighted dst
    integral == coverage-weighted src integral; ``parallel.conserve``).
    """
    if col_axis not in (None, "cols"):
        raise ValueError(f"col_axis must be None or 'cols' (the mesh's "
                         f"column dim), got {col_axis!r}")
    from .parallel import conserve as cons
    from .parallel.mesh import ROWS, axis, plane_block, row_block
    from .parallel.sharding import sharded_local_apply

    cols = col_axis is not None
    by, bx = conservative_regrid_operator(src, dst)
    if src_mask is not None:
        if conserve:
            raise ValueError("conserve=True with src_mask is not supported: "
                             "the masked result is a renormalised mean, not "
                             "a flux-conserving map of the raw field")
        m = torch.as_tensor(src_mask, device=field.device)
        if cols:
            m = plane_block(m, mesh)
        else:
            n, i, _ = axis(mesh, ROWS)
            lo, hi = row_block(src.n_lat, n, i)
            m = m[lo:hi]

        def masked(f, mk, y, x):
            return apply_band_operators_masked(
                f, mk, y, x, fill_value=fill_value,
                min_coverage=min_coverage)[0]

        return sharded_local_apply(by, bx, mesh, masked, field,
                                   m.to(torch.float32).contiguous(),
                                   cols=cols)
    out = sharded_local_apply(by, bx, mesh, apply_band_operators, field,
                              cols=cols)
    if not conserve:
        return out
    # true spherical dst cell measures: |d sin(lat)| x d lon
    my = np.abs(np.diff(np.sin(np.radians(dst.lat_edges))))
    mx = np.diff(dst.lon_edges)
    factors = cons.separable_flux_factors(by, bx, raw_sums=(my, mx))
    flux = (cons.sharded_flux_separable_2d if cols
            else cons.sharded_flux_separable)
    return out, flux(field, out, factors, mesh)


def area_weighted_mean(field, grid: LatLonGrid,
                       device: Device = None) -> torch.Tensor:
    """Spherical-area-weighted global mean over the trailing (n_lat,
    n_lon) axes, in f32 (for conservation checks)."""
    field = as_input(field, device)
    sin_edges = np.sin(np.radians(grid.lat_edges))
    w = np.abs(np.diff(sin_edges))[:, None] * np.ones((1, grid.n_lon))
    w = torch.as_tensor(w / w.sum(), dtype=torch.float32, device=field.device)
    return (field.to(torch.float32) * w).sum(dim=(-2, -1))
