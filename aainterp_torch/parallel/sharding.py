"""Row-sharded separable and rotated (ELL) applies with a ring halo
exchange, on ``torch.distributed`` (counterpart of the 1-D part of
``aainterp/parallel/sharding.py``).

Every rank holds its block of the batch, ``(B / n_data, qH / n_rows, W)``
(``mesh.shard_rows``), and computes its own block of destination rows,
``(B / n_data, Hd / n_rows, Wd)``.  Each dst row's taps reach at most
``halo`` source rows past the rank's own block (``_row_halo``, from the
host tables), so the rank first fetches that many rows from its ring
neighbours (``_halo_extend``: point-to-point sends, one batch per hop),
then applies its rows of the y band, rebased into the extended block:
``y_start - (i * sb - halo)``.  Ranks at the ring's ends get zero rows
where a neighbour is missing, as ``ppermute`` gives, so every block is
``sb + 2 * halo`` rows and the rebase is the same on every rank; the
rebased taps never reach those rows.

The local apply is one of three:

* ``sharded_apply_banded``: the plain banded apply, or, for float32
  frames whose y band partitions the source into equal integer blocks
  (``c0 == 0``, ``qH == m * Hd``), the aligned apply;
* ``sharded_apply_banded_kernel``: kernel 1 (``ops.cuda_apply``, the port
  of ``pallas_apply.py:230``), planned by its own planner on each rank's
  tables; band pairs too wide for shared memory go on to kernel 2 there,
  as they do unsharded.  JAX needs one kernel plan uniform over the chips
  (its ``_sharded_pallas_plan``) because ``shard_map`` runs one program;
  here each rank is a process of its own and plans its own shard.  On a
  CPU tensor the wrapper takes its plain version;
* the regrid's (``regrid.conservative_regrid_sharded``): the route of the
  unsharded ``regrid.apply_band_operators(impl='auto')``.

``sharded_apply_separable`` folds a 90-degree quadrant into the bands
(``_folded_sharded_bands``) and moves the residual flip or transpose to
the small dst side; where the folded row counts do not divide the mesh,
the source is gathered, rotated and cut again (the global rot90 route).

``sharded_apply_ell`` is the rotated apply under the same scheme.  Its
halo is the overhang of each rank's K-window bases (``_ell_axis_halo``),
which grows with W * sin(angle) and may take several hops.  The local
apply is the plain ``apply_ell`` on the rank's rows of the table, rebased
('gather'), or the fused shear and the masked contraction of
``ops.cuda_shear`` on the rank's plan, the global shear plan's rows
shifted (``sharded_apply_ell_kernel``, ``build_sharded_kernel_plan``).
JAX's ``make_sharded_ell_pallas`` returns its plan tables to pass them
as jit arguments; a rank here plans once and keeps its plan, so the
maker has no counterpart.  A quadrant folds into the table, explicit
tables with it (``fold_tables_device``), on both routes.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from .. import api as api_mod
from ..ops import cuda_apply, cuda_shear
from ..ops import overlap1d
from ..ops import weights as weights_ops
from ..ops.apply import (aligned_axis_plan, apply_ell,
                         apply_separable_aligned, apply_separable_banded,
                         quadrant_rotate)
from ..utils.device import upload
from ..utils.digest import array_digest
from ..utils.lru import LruDict
from . import mesh as mesh_ops

IMPLS = ("auto", "kernel", "banded")
ELL_IMPLS = ("auto", "kernel", "gather")

# ELL halos by base table content and blocks (_ell_rows): milliseconds of
# host work a call at 2048^2 otherwise
_HALO_CACHE = LruDict(16)


def _folded_sharded_bands(op: weights_ops.SeparableOperator, n_dev: int):
    """Quadrant folding under row sharding, or None (use the rot90 route).

    A flipped y band's window slides backward, which would mirror the halo
    into a full-ring exchange; reversing its dst rows restores a forward
    window, and the residual permutation moves to the small dst side
    (R = dst-row reversal, T = trailing transpose, P = source flip):

      q=0:  out =   inner                      inner = Wy       A Wx^T
      q=1:  out = T(R inner)                   inner = R(Wx P_H) A Wy^T
      q=2:  out =   R inner                    inner = R(Wy P_H) A (Wx P_W)^T
      q=3:  out = T(inner)                     inner = Wx        A (Wy P_W)^T

    Returns dict(y, x, post, post_inv, measures): ``post`` maps the inner
    output to the final dst, ``post_inv`` is its inverse, and ``measures``
    are the per-row raw sums in the inner orientation (for the flux).
    None when the folded row counts do not divide ``n_dev``.
    """
    q = op.spec.quadrant % 4
    ry, rx = op.raw_row_sums
    flip, rr = overlap1d.flip_band, overlap1d.reverse_rows_band
    if q == 0:
        y_use, x_use, post, post_inv, meas = (
            op.wy, op.wx, None, None, (ry, rx))
    elif q == 1:
        y_use = rr(flip(op.wx))
        x_use = op.wy
        post = lambda o: o.flip(-2).transpose(-1, -2)
        post_inv = lambda g: g.transpose(-1, -2).flip(-2)
        meas = (rx[::-1], ry)
    elif q == 2:
        y_use = rr(flip(op.wy))
        x_use = flip(op.wx)
        post = post_inv = lambda o: o.flip(-2)
        meas = (ry[::-1], rx)
    else:
        y_use = op.wx
        x_use = flip(op.wy)
        post = post_inv = lambda o: o.transpose(-1, -2)
        meas = (rx, ry)
    if y_use.n_dst % n_dev != 0 or y_use.n_src % n_dev != 0:
        return None
    return dict(y=y_use, x=x_use, post=post, post_inv=post_inv,
                measures=meas)


def _row_halo(y_start: np.ndarray, band: int, n_src: int, n_dst: int,
              n_dev: int) -> int:
    """Most rows any rank needs beyond its own source row block."""
    if n_dst % n_dev or n_src % n_dev:
        # a ValueError (not assert) so the guard survives python -O
        raise ValueError(
            "row-sharded apply requires divisible row counts "
            f"(dst {n_dst}, src {n_src}, devices {n_dev})")
    db = n_dst // n_dev
    sb = n_src // n_dev
    h = 0
    for i in range(n_dev):
        lo = int(y_start[i * db: (i + 1) * db].min())
        hi = int(y_start[i * db: (i + 1) * db].max()) + band
        h = max(h, i * sb - lo, hi - (i + 1) * sb)
    return max(h, 0)


def _halo_extend(x: torch.Tensor, h: int, mesh) -> torch.Tensor:
    """Extend a rank's row block (axis -2) by ``h`` rows on each side from
    its ring neighbours.

    Hop k in 1..ceil(h / sb) fetches a block (partial on the last hop)
    from the ranks k places away on each side, in one batch of
    point-to-point sends and receives.  A missing neighbour gives zero
    rows.  Band indices lie in [0, n_src), so the halo is at most
    (n - 1) * sb and any valid operator is covered; more hops raise.
    """
    if h == 0:
        return x
    n, i, group = mesh_ops.axis(mesh, mesh_ops.ROWS)
    sb = x.shape[-2]
    hops = -(-h // sb)
    if hops > n - 1:
        raise ValueError(
            f"halo of {h} needs {hops} ring hops but only "
            f"{n - 1} neighbours exist (per-rank block {sb}); "
            "use fewer shards along this axis for this operator")
    parts_prev, parts_next = [], []
    for k in range(1, hops + 1):
        hk = min(sb, h - (k - 1) * sb)     # partial block on the last hop
        shape = x.shape[:-2] + (hk, x.shape[-1])
        nxt = x.new_zeros(shape)           # leading hk rows of rank i + k
        prv = x.new_zeros(shape)           # trailing hk rows of rank i - k
        sends, recvs = [], []
        if i + k < n:
            recvs.append((nxt, i + k))
            sends.append((x[..., sb - hk:, :], i + k))
        if i - k >= 0:
            sends.append((x[..., :hk, :], i - k))
            recvs.append((prv, i - k))
        mesh_ops.exchange(sends, recvs, group)
        parts_next.append(nxt)
        parts_prev.append(prv)
    return torch.cat(parts_prev[::-1] + [x] + parts_next, dim=-2)


def sharded_local_apply(y_band, x_band, mesh, apply_fn, *blocks):
    """The step every row-sharded apply shares: halo-extend each of this
    rank's row blocks ``blocks`` (each ending in (qH / n_rows, W) rows x
    columns), rebase this rank's rows of the y band into the extended
    block, and return ``apply_fn(*extended_blocks, y_local, x_band)``.

    ``y_local`` is a Band1D of this rank's Hd / n_rows dst rows over the
    sb + 2 * halo rows of an extended block.
    """
    n, i, _ = mesh_ops.axis(mesh, mesh_ops.ROWS)
    qH, Hd = y_band.n_src, y_band.n_dst
    halo = _row_halo(y_band.start, y_band.band, qH, Hd, n)
    sb, db = qH // n, Hd // n
    for b in blocks:
        if b.ndim < 2 or tuple(b.shape[-2:]) != (sb, x_band.n_src):
            raise ValueError(f"this rank's block must end in ({sb}, "
                             f"{x_band.n_src}) rows x columns, got "
                             f"{tuple(b.shape)}")
    ext = [_halo_extend(b, halo, mesh) for b in blocks]
    rows = slice(i * db, (i + 1) * db)
    local = overlap1d.Band1D(
        start=(np.asarray(y_band.start[rows], np.int64)
               - (i * sb - halo)).astype(np.int32),
        weights=np.asarray(y_band.weights[rows]),
        n_src=sb + 2 * halo, n_dst=db)
    return apply_fn(*ext, local, x_band)


def _aligned_x_plan(y_band, x_band):
    """The x band's aligned plan where the pair is a strict integer-ratio
    partition (the y band's ``c0 == 0`` and ``qH == m * Hd``), else None.
    Every rank's rebased y rows are then aligned too, at ``c0 = halo``."""
    yp = aligned_axis_plan(y_band.start, y_band.weights, y_band.n_src)
    if yp is None or yp["c0"] != 0 or yp["m"] * y_band.n_dst != y_band.n_src:
        return None
    return aligned_axis_plan(x_band.start, x_band.weights, x_band.n_src)


def _f32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32)


def sharded_apply_banded(frames: torch.Tensor, y_band, x_band,
                         mesh) -> torch.Tensor:
    """Row-sharded banded apply of a (y, x) Band1D pair on this rank's
    block, in plain torch: (b, qH / n, W) -> (b, Hd / n, Wd), f32 (the
    plain route's accumulation dtype).  Float32 frames on a strict
    integer-ratio partition take the aligned apply.  Only the rows group
    talks; the batch needs no collective."""
    xp = (_aligned_x_plan(y_band, x_band)
          if frames.dtype == torch.float32 else None)

    def local(ext, y, x):
        if xp is not None:
            return apply_separable_aligned(
                ext, aligned_axis_plan(y.start, y.weights, y.n_src), xp)
        dev = ext.device
        return apply_separable_banded(
            ext, torch.as_tensor(y.start, dtype=torch.int64, device=dev),
            torch.as_tensor(_f32(y.weights), device=dev),
            torch.as_tensor(x.start, dtype=torch.int64, device=dev),
            torch.as_tensor(_f32(x.weights), device=dev))

    return sharded_local_apply(y_band, x_band, mesh, local, frames)


def sharded_apply_banded_kernel(frames: torch.Tensor, y_band, x_band,
                                mesh) -> torch.Tensor:
    """Row-sharded apply with kernel 1 per shard (counterpart of
    ``sharded_apply_banded_pallas``): the same halo exchange, then
    ``cuda_apply.apply_separable_kernel`` on this rank's extended block
    and rebased tables.  bf16, f32 and uint8 frames give that dtype out
    (the kernel's contract); on a CPU tensor the wrapper takes its plain
    version."""

    def local(ext, y, x):
        return cuda_apply.apply_separable_kernel(
            ext.contiguous(), y.start, _f32(y.weights),
            np.ascontiguousarray(x.start, dtype=np.int32), _f32(x.weights))

    return sharded_local_apply(y_band, x_band, mesh, local, frames)


def _rot90_rows(frames: torch.Tensor, quadrant: int, mesh):
    """The global rot90 route: gather the source over the rows group,
    rotate it, and cut this rank's rows out of the rotated source."""
    if quadrant % 4 == 0:
        return frames
    n, i, group = mesh_ops.axis(mesh, mesh_ops.ROWS)
    whole = torch.cat(mesh_ops.all_gather(frames, group), dim=-2)
    rot = quadrant_rotate(whole, quadrant)
    lo, hi = mesh_ops.row_block(rot.shape[-2], n, i)
    return rot[..., lo:hi, :].contiguous()


def _post_rows(post, out: torch.Tensor, mesh) -> torch.Tensor:
    """Apply a dst-side flip or transpose to the row-sharded inner output:
    gather the inner dst over the rows group, permute it, and keep this
    rank's rows (the dst-sized reshard; the source never moves)."""
    n, i, group = mesh_ops.axis(mesh, mesh_ops.ROWS)
    whole = post(torch.cat(mesh_ops.all_gather(out, group), dim=-2))
    lo, hi = mesh_ops.row_block(whole.shape[-2], n, i)
    return whole[..., lo:hi, :].contiguous()


def sharded_apply_separable(frames: torch.Tensor,
                            op: weights_ops.SeparableOperator, mesh, *,
                            impl: str = "auto", conserve: bool = False):
    """Apply a separable operator with src and dst rows sharded over the
    mesh's ``rows`` dim and the batch over its ``data`` dim.

    ``frames`` is this rank's block, (B / n_data, H / n_rows, W)
    (``mesh.shard_rows``); returns its block of the dst, (B / n_data,
    Hd / n_rows, Wd) (dst rows that do not divide the mesh: blocks of
    ceil(Hd / n_rows) rows, see ``mesh.row_block``).

    impl: 'kernel' runs kernel 1 per shard (``sharded_apply_banded_kernel``;
    raises on a CPU tensor), 'banded' the plain banded apply
    (``sharded_apply_banded``), 'auto' the kernel for a CUDA tensor and
    'banded' on the CPU.  uint8 in gives uint8 out on both ('banded'
    applies it as float32 and rounds, as JAX's banded route does).

    conserve: also return the (2,) float64 [flux_dst, flux_src] global
    conservation pair, the same on every rank (``conserve.py``); the two
    agree to rounding iff every rank's halo and local apply are right.

    A quadrant != 0 is folded into the bands (``_folded_sharded_bands``);
    where the folded row counts do not divide the mesh, the global rot90
    route runs instead.
    """
    n = mesh_ops.axis(mesh, mesh_ops.ROWS)[0]
    u8 = frames.dtype == torch.uint8    # u8 in -> u8 out, like apply_operator
    if u8 and conserve:
        raise ValueError(
            "conserve=True needs float outputs (the u8 round+saturate "
            "quantisation breaks the exact flux identity); cast the "
            "frames to float32 for conservation checks")
    if impl not in IMPLS:
        raise ValueError(
            f"unknown impl {impl!r} for the sharded separable apply; "
            f"expected one of {IMPLS}")
    if impl == "auto":
        impl = "kernel" if frames.is_cuda else "banded"
    if impl == "kernel" and not frames.is_cuda:
        raise ValueError(
            "impl='kernel' needs a CUDA tensor; got one on "
            f"{frames.device} (use impl='auto' or 'banded' on the CPU)")
    fold = _folded_sharded_bands(op, n)
    if fold is None:
        # the folded row counts do not divide: rotate the whole source
        frames = _rot90_rows(frames, op.spec.quadrant, mesh)
        fold = dict(y=op.wy, x=op.wx, post=None, post_inv=None,
                    measures=op.raw_row_sums)
    y_use, x_use, post = fold["y"], fold["x"], fold["post"]
    if impl == "kernel":
        out = sharded_apply_banded_kernel(frames, y_use, x_use, mesh)
    else:
        out = sharded_apply_banded(frames.to(torch.float32) if u8 else frames,
                                   y_use, x_use, mesh)
        if u8:      # quantise as the kernel does
            out = out.round().clamp(0.0, 255.0).to(torch.uint8)
    if conserve:
        from .conserve import separable_flux_factors, sharded_flux_separable

        # the factors pair with the inner orientation, where frames and
        # out are row-sharded as the band tables are
        factors = separable_flux_factors(y_use, x_use,
                                         raw_sums=fold["measures"])
        flux = sharded_flux_separable(frames, out, factors, mesh)
    if post is not None:
        out = _post_rows(post, out, mesh)
    if not conserve:
        return out
    return out, flux


# ---------------------------------------------------------------------------
# the rotated (ELL) apply
# ---------------------------------------------------------------------------


def _ell_axis_halo(base_axis, K: int, db: int, sb: int, n_dev: int) -> int:
    """Most rows any rank's dst block reaches past its own source block
    along one sharded axis: the overhang of its K-window bases
    (``op.base[..., 0]`` for rows).  Exact: no rounding to a tile."""
    halo = 0
    for i in range(n_dev):
        blk = base_axis[i * db: (i + 1) * db]
        halo = max(halo, i * sb - int(blk.min()),
                   int(blk.max()) + K - (i + 1) * sb)
    return max(halo, 0)


def _ell_rows(op: weights_ops.EllOperator, n_dev: int):
    """(db, sb, halo) of the row-sharded apply of ``op`` over ``n_dev``
    ranks.  ValueError where the rows do not divide or the halo needs more
    than ``n_dev - 1`` ring hops."""
    qH, Hd = op.spec.qrot_shape[0], op.spec.dst_shape[0]
    if Hd % n_dev or qH % n_dev:
        raise ValueError(
            "row-sharded ELL apply requires divisible row counts "
            f"(dst {Hd}, src {qH}, devices {n_dev})")
    db, sb = Hd // n_dev, qH // n_dev
    key = (array_digest(op.base), op.base.shape, op.window, sb, n_dev)
    halo = _HALO_CACHE.get(key)
    if halo is None:
        halo = _ell_axis_halo(op.base[..., 0], op.window, db, sb, n_dev)
        _HALO_CACHE.put(key, halo)
    hops = -(-halo // sb)
    if hops > n_dev - 1:
        raise ValueError(
            f"halo of {halo} needs {hops} ring hops but only {n_dev - 1} "
            f"neighbours exist (per-rank block {sb}); use fewer shards "
            "along this axis for this operator")
    return db, sb, halo


def _check_tables(op: weights_ops.EllOperator, base, weights) -> None:
    Hd, Wd = op.spec.dst_shape
    K = op.window
    for name, t, shape in (("base", base, (Hd, Wd, 2)),
                           ("weights", weights, (Hd, Wd, K, K))):
        if t is None:
            continue
        if not isinstance(t, torch.Tensor) or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be a tensor of shape {shape} for "
                             f"this operator, got {type(t).__name__} "
                             f"{tuple(getattr(t, 'shape', ()))}")


def _ell_fold(op: weights_ops.EllOperator, n_dev: int, base, weights):
    """The apply's orientation, decided on the host: (op, post, base,
    weights, rotate).  A quadrant folds into the table
    (``fold_quadrant_ell_cached``), explicit tables with it
    (``fold_tables_device``), and ``post`` is the residual flip or
    transpose of the dst; where the folded row counts do not divide the
    mesh, ``rotate`` asks for the global rot90 route instead."""
    q = op.spec.quadrant % 4
    if q == 0:
        return op, None, base, weights, False
    folded, post = weights_ops.fold_quadrant_ell_cached(op)
    if folded.spec.dst_shape[0] % n_dev or folded.spec.qrot_shape[0] % n_dev:
        return op, None, base, weights, True
    if base is not None or weights is not None:
        dev = (base if base is not None else weights).device
        base, weights = weights_ops.fold_tables_device(
            upload(op.base, dev) if base is None else base,
            upload(op.weights, dev) if weights is None else weights, q,
            *op.spec.qrot_shape)
    return folded, post, base, weights, False


def _host_tables(op: weights_ops.EllOperator, base, weights,
                 with_weights: bool) -> weights_ops.EllOperator:
    """``op`` with explicit tables in place of its own, copied to the host
    once: the base always (the halo reads it), the weights where
    ``with_weights`` (the kernel route plans from them; the plan cache
    keys on their content)."""
    kw = {}
    if base is not None:
        kw["base"] = np.ascontiguousarray(base.detach().cpu().numpy(),
                                          dtype=np.int32)
    if weights is not None and with_weights:
        kw["weights"] = weights.detach().cpu().to(torch.float64).numpy()
    return dataclasses.replace(op, **kw) if kw else op


def _ell_route(op: weights_ops.EllOperator, n_dev: int, impl: str,
               on_cuda: bool):
    """(route, ShardedKernelPlan or None), decided on the host before any
    launch (``api._ell_route``'s rule under sharding): 'auto' takes
    'kernel' for a CUDA tensor and 'gather' for a CPU one; a geometry that
    ``build_sharded_kernel_plan`` rejects sends 'auto' to 'gather' with a
    RuntimeWarning, counted in ``api.SHEAR_PLAN_FALLBACKS``, and makes
    'kernel' raise."""
    if impl == "gather" or (impl == "auto" and not on_cuda):
        return "gather", None
    try:
        return "kernel", cuda_shear.build_sharded_kernel_plan(op, n_dev)
    except ValueError as e:
        if impl == "kernel":
            raise
        warnings.warn(f"sharded rotated apply takes the plain gather route: "
                      f"{e}", RuntimeWarning)
        api_mod.SHEAR_PLAN_FALLBACKS += 1
        return "gather", None


def _rows_on(t, rows: slice, device, dtype) -> torch.Tensor:
    """Rows of a table (numpy or a tensor on any device) on ``device``."""
    if isinstance(t, torch.Tensor):
        return t[rows].to(device=device, dtype=dtype)
    return upload(t[rows], device, dtype)


def _sharded_ell(frames, op, mesh, impl, base, weights, conserve):
    """The body of both ELL entry points; ``impl`` is checked by them."""
    n, i, _ = mesh_ops.axis(mesh, mesh_ops.ROWS)
    _check_tables(op, base, weights)
    quadrant = op.spec.quadrant
    op, post, base, weights, rotate = _ell_fold(op, n, base, weights)
    on_cuda = frames.is_cuda
    host = _host_tables(op, base, weights,
                        impl == "kernel" or (impl == "auto" and on_cuda))
    db, sb, halo = _ell_rows(host, n)
    route, kp = _ell_route(host, n, impl, on_cuda)
    if rotate:
        frames = _rot90_rows(frames, quadrant, mesh)
    qW = op.spec.qrot_shape[1]
    if frames.ndim < 2 or tuple(frames.shape[-2:]) != (sb, qW):
        raise ValueError(f"this rank's block must end in ({sb}, {qW}) rows "
                         f"x columns, got {tuple(frames.shape)}")
    ext = _halo_extend(frames, halo, mesh)
    if route == "kernel":
        out = cuda_shear.apply_ell_shear_kernel(ext, kp.rank(i))
    else:
        rows = slice(i * db, (i + 1) * db)
        b = _rows_on(op.base if base is None else base, rows, ext.device,
                     torch.int64)
        b = b - b.new_tensor([i * sb - halo, 0])
        out = apply_ell(ext, b, _rows_on(op.weights if weights is None
                                         else weights, rows, ext.device,
                                         torch.float32))
    if conserve:
        from .conserve import ell_flux_factors, sharded_flux_ell

        # the folded operator's factors pair with the un-rotated frames
        # and the output before ``post``, row-sharded as its tables are
        flux = sharded_flux_ell(frames, out, ell_flux_factors(op), mesh)
    if post is not None:
        out = _post_rows(post, out, mesh)
    return (out, flux) if conserve else out


def sharded_apply_ell_kernel(frames: torch.Tensor,
                             op: weights_ops.EllOperator, mesh, *,
                             base=None, weights=None) -> torch.Tensor:
    """Row-sharded rotated apply with the fused shear and the masked
    contraction per shard (counterpart of ``make_sharded_ell_pallas`` and
    ``sharded_apply_ell_pallas``): the halo exchange, then
    ``cuda_shear.apply_ell_shear_kernel`` on this rank's extended block
    with its plan ``build_sharded_kernel_plan(op, n).rank(i)``.  A
    quadrant folds as in ``sharded_apply_ell``.  bf16 and f32 frames give
    that dtype out, others are cast to f32; on a CPU tensor the wrappers
    take their plain versions.  Raises ValueError where the planner
    rejects the geometry."""
    return _sharded_ell(frames, op, mesh, "kernel", base, weights, False)


def sharded_apply_ell(frames: torch.Tensor, op: weights_ops.EllOperator,
                      mesh, *, conserve: bool = False, base=None,
                      weights=None, impl: str = "auto"):
    """Row-sharded rotated (ELL) apply: this rank's block (B / n_data,
    qH / n_rows, qW) of the source (``mesh.shard_rows``) -> its block of
    the dst (dst rows that do not divide the mesh after a fold: blocks of
    ceil(Hd / n_rows) rows).  Each rank fetches the rows its dst rows'
    windows reach from its ring neighbours (``_halo_extend``; the halo
    grows with the angle and may take several hops).

    impl: 'kernel' the fused shear and the masked contraction per shard
    (``sharded_apply_ell_kernel``; raises on a CPU tensor or where the
    planner rejects the geometry), 'gather' the plain
    ``ops.apply.apply_ell`` on the extended block with this rank's rows
    of the tables rebased (f32 out), 'auto' the kernel for a CUDA tensor
    (the gather route, with a RuntimeWarning counted in
    ``api.SHEAR_PLAN_FALLBACKS``, for a geometry the planner rejects) and
    the gather route on the CPU.

    conserve: also return the (2,) float64 [flux_dst, flux_src] global
    conservation pair, the same on every rank (``conserve.py``).

    base / weights: tensors (on any device) of shape (Hd, Wd, 2) and
    (Hd, Wd, K, K) in place of ``op.base`` / ``op.weights``, honoured on
    both routes: the whole tables go to every rank; the kernel route
    copies them to the host once and plans from them.

    A quadrant != 0 folds into the table (``fold_quadrant_ell_cached``,
    explicit tables through ``fold_tables_device``): the source stays
    sharded un-rotated and only the dst pays a flip or transpose
    (``_post_rows``).  Where the folded row counts do not divide the
    mesh, the global rot90 route runs instead.
    """
    if impl not in ELL_IMPLS:
        raise ValueError(
            f"unknown impl {impl!r} for the sharded ELL apply; expected one "
            f"of {ELL_IMPLS}")
    if impl == "kernel" and not frames.is_cuda:
        raise ValueError(
            "impl='kernel' needs a CUDA tensor; got one on "
            f"{frames.device} (use impl='auto' or 'gather' on the CPU)")
    return _sharded_ell(frames, op, mesh, impl, base, weights, conserve)
