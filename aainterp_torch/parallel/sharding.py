"""Row-sharded and 2-D (rows x cols) sharded separable and rotated (ELL)
applies with a ring halo exchange, their transposes and autograd
wrappers, on ``torch.distributed`` (counterpart of
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

The ``_2d`` applies shard the columns too, over the ``cols`` dim of a
``("data", "rows", "cols")`` mesh (``mesh.shard_blocks``): a rank holds
``(B / n_data, qH / n_rows, W / n_cols)``, extends it by the row halo
and then by the column halo of the row-extended block (so the corners
arrive through the edge neighbour, as JAX's ``sharded_apply_separable_2d``
documents), and rebases both bands: ``x_start - (j * sb_c - halo_x)``.
``sharded_local_apply`` is that step for every separable route, 1-D and
2-D, so only it knows the rebase.

The local apply is one of three:

* ``sharded_apply_banded`` (``_2d``): the plain banded apply, or, for
  float32 frames whose bands partition the source into equal integer
  blocks (the y band's, and on a 2-D mesh the x band's too: ``c0 == 0``,
  ``n_src == m * n_dst``), the aligned apply;
* ``sharded_apply_banded_kernel`` (``_2d_kernel``): kernel 1
  (``ops.cuda_apply``, the port of ``pallas_apply.py:230``), planned by
  its own planner on each rank's tables; band pairs too wide for shared
  memory go on to kernel 2 there, as they do unsharded.  JAX needs one
  kernel plan uniform over the chips (its ``_sharded_pallas_plan`` and
  ``_sharded_pallas_plan_2d``) because ``shard_map`` runs one program;
  here each rank is a process of its own and plans its own shard.  On a
  CPU tensor the wrapper takes its plain version;
* the regrid's (``regrid.conservative_regrid_sharded``): the route of the
  unsharded ``regrid.apply_band_operators(impl='auto')``.

``sharded_apply_separable`` (``_2d``) folds a 90-degree quadrant into the
bands (``_folded_sharded_bands``, ``_2d``) and moves the residual flip or
transpose to the small dst side; where the folded counts do not divide
the mesh, the source is gathered, rotated and cut again (the global rot90
route).

``sharded_apply_ell`` (``_2d``) is the rotated apply under the same
scheme.  Its halo is the overhang of each rank's K-window bases
(``_ell_axis_halo``, per axis), which grows with W * sin(angle) and may
take several hops.  The local apply is the plain ``apply_ell`` on the
rank's block of the table, rebased ('gather'), or the fused shear and the
masked contraction of ``ops.cuda_shear`` on the rank's plan, the global
shear plan shifted (``sharded_apply_ell_kernel``,
``build_sharded_kernel_plan``; ``_2d``: ``build_sharded_kernel_plan_2d``).
JAX's ``make_sharded_ell_pallas`` (``_2d``) returns its plan tables to
pass them as jit arguments; a rank here plans once and keeps its plan, so
the makers have no counterpart.  A quadrant folds into the table, explicit
tables with it (``fold_tables_device``), on both routes.

The transposes run the same scheme backwards.  The separable ones
(``sharded_apply_separable_transpose``, ``_2d``) are the forward's apply
on the transposed bands (kernel 1 per shard on the card): the halo comes
from the transposed y band and the cotangent's rows move.  The ELL ones
(``sharded_apply_ell_transpose``, ``_2d``) scatter each rank's cotangent
block into its extended source block (``ops.apply.apply_ell_transpose``)
and send the halo's sums back to their owners (``_halo_reduce``, the
exact adjoint of ``_halo_extend``).  ``make_sharded_separable_linear``,
``make_sharded_separable_2d_linear``, ``make_sharded_ell_linear`` and
``make_sharded_ell_2d_linear`` wrap a forward and its transpose in one
``torch.autograd.Function`` (``ShardedLinear``); its backward holds
collectives, so every rank must run it.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from .. import api as api_mod
from .. import autodiff as autodiff_ops
from ..ops import cuda_apply, cuda_shear
from ..ops import overlap1d
from ..ops import weights as weights_ops
from ..ops.apply import (aligned_axis_plan, apply_ell, apply_ell_transpose,
                         apply_separable_aligned, apply_separable_banded,
                         quadrant_rotate)
from ..utils.device import upload
from ..utils.digest import array_digest
from ..utils.lru import LruDict
from . import mesh as mesh_ops
from .mesh import COLS, ROWS

IMPLS = ("auto", "kernel", "banded")
ELL_IMPLS = ("auto", "kernel", "gather")

# ELL halos by base table content and blocks (_ell_blocks): milliseconds of
# host work a call at 2048^2 otherwise
_HALO_CACHE = LruDict(16, name="sharding.halo")

# a rank's blocks of host ELL tables on its device (_block_on)
_TABLE_BLOCKS = LruDict(8, max_bytes=4 << 30, name="sharding.table_blocks")


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


def _folded_sharded_bands_2d(op: weights_ops.SeparableOperator, n_r: int,
                             n_c: int):
    """Quadrant folding under 2-D (rows x cols) sharding, or None (use the
    rot90 route).

    Not the 1-D fold with a second axis: with columns sharded the x band
    must slide forward too, so a flipped x band takes the same dst-order
    reversal as a flipped y band (``rr(flip(.))``) and the residual
    column reversal moves into ``post`` (R_r = dst-row reversal, T =
    trailing transpose):

      q=0:  out =      inner             y = wy            x = wx
      q=1:  out = T(R_r inner)           y = rr(flip(wx))  x = wy
      q=2:  out = rot180(inner)          y = rr(flip(wy))  x = rr(flip(wx))
      q=3:  out = R_r(T(inner))          y = wx            x = rr(flip(wy))

    Returns dict(y, x, post, post_inv, measures) as
    ``_folded_sharded_bands``; None when the folded row counts do not
    divide ``n_r`` or the folded column counts ``n_c``.
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
        x_use = rr(flip(op.wx))
        post = post_inv = lambda o: o.flip(-2, -1)
        meas = (ry[::-1], rx[::-1])
    else:
        y_use = op.wx
        x_use = rr(flip(op.wy))
        post = lambda o: o.transpose(-1, -2).flip(-2)
        post_inv = lambda g: g.flip(-2).transpose(-1, -2)
        meas = (rx, ry[::-1])
    if (y_use.n_dst % n_r or y_use.n_src % n_r
            or x_use.n_dst % n_c or x_use.n_src % n_c):
        return None
    return dict(y=y_use, x=x_use, post=post, post_inv=post_inv,
                measures=meas)


def _folded_transposes(op: weights_ops.SeparableOperator, cols: bool):
    """(t_y, t_x): the transposes of the folded bands of
    ``_folded_sharded_bands`` (with ``cols``, ``_folded_sharded_bands_2d``),
    keyed by the same q, from the content-cached (Wy^T, Wx^T) of
    ``autodiff.transposed_separable`` through (W P)^T = P W^T and
    (R W)^T = W^T R:

      t(flip(b))     = rr(t(b))
      t(rr(flip(b))) = flip(rr(t(b)))

            1-D                       2-D
      q=0:  (ty, tx)                  (ty, tx)
      q=1:  (flip(rr(tx)), ty)        (flip(rr(tx)), ty)
      q=2:  (flip(rr(ty)), rr(tx))    (flip(rr(ty)), flip(rr(tx)))
      q=3:  (tx, rr(ty))              (tx, flip(rr(ty)))

    Not ``transpose_band`` of a folded band: a backward-sliding band
    (``flip(w)``) breaks its non-decreasing ``start`` and comes out many
    taps wider (JAX: sharding.py:1047-1054, 1853-1860)."""
    ty, tx = autodiff_ops.transposed_separable(op)
    flip, rr = overlap1d.flip_band, overlap1d.reverse_rows_band
    q = op.spec.quadrant % 4
    if q == 0:
        return ty, tx
    if q == 1:
        return flip(rr(tx)), ty
    if q == 2:
        return flip(rr(ty)), (flip(rr(tx)) if cols else rr(tx))
    return tx, (flip(rr(ty)) if cols else rr(ty))


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


def _ring_hops(h: int, sb: int, n: int) -> int:
    """Ring hops a halo of ``h`` over blocks of ``sb`` takes on an axis of
    ``n`` ranks; ValueError where it needs more than ``n - 1``."""
    hops = -(-h // sb)
    if hops > n - 1:
        raise ValueError(
            f"halo of {h} needs {hops} ring hops but only "
            f"{n - 1} neighbours exist (per-rank block {sb}); "
            "use fewer shards along this axis for this operator")
    return hops


def _halo_extend(x: torch.Tensor, h: int, mesh, name: str = ROWS
                 ) -> torch.Tensor:
    """Extend a rank's block by ``h`` entries on each side from its ring
    neighbours along the mesh dim ``name``: rows (tensor axis -2) over
    ``rows``, columns (axis -1) over ``cols`` (JAX's ``_halo_extend(x, h,
    axis_name, n_dev, axis=)``).

    Hop k in 1..ceil(h / sb) fetches a block (partial on the last hop)
    from the ranks k places away on each side, in one batch of
    point-to-point sends and receives.  A missing neighbour gives zeros.
    Band indices lie in [0, n_src), so the halo is at most (n - 1) * sb
    and any valid operator is covered; more hops raise.
    """
    if h == 0:
        return x
    dim = -2 if name == ROWS else -1
    n, i, group = mesh_ops.axis(mesh, name)
    sb = x.shape[dim]
    hops = _ring_hops(h, sb, n)
    parts_prev, parts_next = [], []
    for k in range(1, hops + 1):
        hk = min(sb, h - (k - 1) * sb)     # partial block on the last hop
        shape = list(x.shape)
        shape[dim] = hk
        nxt = x.new_zeros(shape)           # leading hk of rank i + k
        prv = x.new_zeros(shape)           # trailing hk of rank i - k
        sends, recvs = [], []
        if i + k < n:
            recvs.append((nxt, i + k))
            sends.append((x.narrow(dim, sb - hk, hk), i + k))
        if i - k >= 0:
            sends.append((x.narrow(dim, 0, hk), i - k))
            recvs.append((prv, i - k))
        mesh_ops.exchange(sends, recvs, group)
        parts_next.append(nxt)
        parts_prev.append(prv)
    return torch.cat(parts_prev[::-1] + [x] + parts_next, dim=dim)


def _halo_reduce(x_ext: torch.Tensor, h: int, mesh, name: str = ROWS
                 ) -> torch.Tensor:
    """The exact adjoint of ``_halo_extend``: fold the ``h`` halo entries on
    each side of a rank's extended block back into their owners' blocks,
    along the mesh dim ``name`` (rows, tensor axis -2; or columns, axis
    -1) (JAX's ``_halo_reduce``, sharding.py:1767-1809).

    Hop k sends this rank's hop-k slab of the leading halo to rank i - k
    (whose trailing rows it mirrors) and its slab of the trailing halo to
    rank i + k, in one ``mesh.exchange``, and adds what arrives into its
    own trailing and leading ``hk`` entries: the forward's schedule with
    the direction reversed, so the bytes sent equal the forward's at one
    dtype.  An edge rank's orphan slabs, the forward's zero fill, are
    dropped.  Returns the block without the halo, (..., sb) along the
    axis; more hops than the axis has neighbours raise, as they do in
    the forward.
    """
    if h == 0:
        return x_ext
    dim = -2 if name == ROWS else -1
    n, i, group = mesh_ops.axis(mesh, name)
    sb = x_ext.shape[dim] - 2 * h
    hops = _ring_hops(h, sb, n)
    core = x_ext.narrow(dim, h, sb).clone()
    for k in range(1, hops + 1):
        hk = min(sb, h - (k - 1) * sb)     # partial block on the last hop
        shape = list(x_ext.shape)
        shape[dim] = hk
        sends, recvs, adds = [], [], []
        if i - k >= 0:      # leading slab k: rank i - k's trailing entries
            sends.append((x_ext.narrow(dim, h - (k - 1) * sb - hk, hk),
                          i - k))
            top = x_ext.new_empty(shape)    # rank i - k's trailing slab
            recvs.append((top, i - k))
            adds.append((0, top))
        if i + k < n:       # trailing slab k: rank i + k's leading entries
            sends.append((x_ext.narrow(dim, h + k * sb, hk), i + k))
            bottom = x_ext.new_empty(shape)
            recvs.append((bottom, i + k))
            adds.append((sb - hk, bottom))
        mesh_ops.exchange(sends, recvs, group)
        for lo, part in adds:
            core.narrow(dim, lo, hk).add_(part)
    return core


def _local_band(band, mesh, name: str):
    """(this rank's band, halo) along the mesh dim ``name``: its
    ``n_dst / n`` dst rows of ``band``, rebased into a block extended by
    ``halo`` on each side (``start - (i * sb - halo)``)."""
    n, i, _ = mesh_ops.axis(mesh, name)
    halo = _row_halo(band.start, band.band, band.n_src, band.n_dst, n)
    sb, db = band.n_src // n, band.n_dst // n
    rows = slice(i * db, (i + 1) * db)
    return overlap1d.Band1D(
        start=(np.asarray(band.start[rows], np.int64)
               - (i * sb - halo)).astype(np.int32),
        weights=np.asarray(band.weights[rows]),
        n_src=sb + 2 * halo, n_dst=db), halo


def sharded_local_apply(y_band, x_band, mesh, apply_fn, *blocks,
                        cols: bool = False):
    """The step every sharded separable apply shares: halo-extend each of
    this rank's blocks ``blocks`` (each ending in (qH / n_rows, W) rows x
    columns; with ``cols``, (qH / n_rows, W / n_cols), extended by rows
    first, then by columns of the row-extended block), rebase this rank's
    rows of the y band (and with ``cols`` of the x band) into the
    extended block, and return ``apply_fn(*extended_blocks, y_local,
    x_local)``.

    ``y_local`` is a Band1D of this rank's Hd / n_rows dst rows over the
    sb + 2 * halo rows of an extended block; ``x_local`` is the whole x
    band, or with ``cols`` its Wd / n_cols dst columns over the extended
    block's columns.
    """
    y, halo_y = _local_band(y_band, mesh, ROWS)
    x, halo_x = _local_band(x_band, mesh, COLS) if cols else (x_band, 0)
    want = (y.n_src - 2 * halo_y, x.n_src - 2 * halo_x)
    for b in blocks:
        if b.ndim < 2 or tuple(b.shape[-2:]) != want:
            raise ValueError(f"this rank's block must end in {want} rows x "
                             f"columns, got {tuple(b.shape)}")
    ext = [_halo_extend(_halo_extend(b, halo_y, mesh), halo_x, mesh, COLS)
           for b in blocks]
    return apply_fn(*ext, y, x)


def _strict_partition(band) -> bool:
    """Whether ``band`` partitions its source into equal integer blocks
    from cell 0 (``c0 == 0``, ``n_src == m * n_dst``): every rank's
    rebased rows are then aligned too, at ``c0 = halo``."""
    p = aligned_axis_plan(band.start, band.weights, band.n_src)
    return p is not None and p["c0"] == 0 and p["m"] * band.n_dst == band.n_src


def _f32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32)


def _banded(frames, y_band, x_band, mesh, cols: bool) -> torch.Tensor:
    """The plain local apply of ``sharded_apply_banded`` (``_2d``): the
    aligned apply for float32 frames where the y band is a strict
    partition and the x band aligned (on a 2-D mesh: a strict partition
    too), else the banded apply."""
    aligned = (frames.dtype == torch.float32 and _strict_partition(y_band)
               and (_strict_partition(x_band) if cols else aligned_axis_plan(
                   x_band.start, x_band.weights, x_band.n_src) is not None))

    def local(ext, y, x):
        if aligned:
            return apply_separable_aligned(
                ext, aligned_axis_plan(y.start, y.weights, y.n_src),
                aligned_axis_plan(x.start, x.weights, x.n_src))
        dev = ext.device
        return apply_separable_banded(
            ext, torch.as_tensor(y.start, dtype=torch.int64, device=dev),
            torch.as_tensor(_f32(y.weights), device=dev),
            torch.as_tensor(x.start, dtype=torch.int64, device=dev),
            torch.as_tensor(_f32(x.weights), device=dev))

    return sharded_local_apply(y_band, x_band, mesh, local, frames,
                               cols=cols)


def sharded_apply_banded(frames: torch.Tensor, y_band, x_band,
                         mesh) -> torch.Tensor:
    """Row-sharded banded apply of a (y, x) Band1D pair on this rank's
    block, in plain torch: (b, qH / n, W) -> (b, Hd / n, Wd), f32 (the
    plain route's accumulation dtype).  Float32 frames on a strict
    integer-ratio partition take the aligned apply.  Only the rows group
    talks; the batch needs no collective."""
    return _banded(frames, y_band, x_band, mesh, False)


def sharded_apply_banded_2d(frames: torch.Tensor, y_band, x_band,
                            mesh) -> torch.Tensor:
    """2-D sharded banded apply of a (y, x) Band1D pair on this rank's
    block, in plain torch: (b, qH / n_rows, W / n_cols) -> (b, Hd /
    n_rows, Wd / n_cols), f32.  One ring-halo exchange per mesh dim (rows,
    then the columns of the row-extended block), both bands rebased.
    Float32 frames whose bands are both strict integer-ratio partitions
    take the aligned apply (JAX: sharding.py:841-879)."""
    return _banded(frames, y_band, x_band, mesh, True)


def _kernel1(ext, y, x):
    return cuda_apply.apply_separable_kernel(
        ext.contiguous(), np.ascontiguousarray(y.start, dtype=np.int32),
        _f32(y.weights), np.ascontiguousarray(x.start, dtype=np.int32),
        _f32(x.weights))


def sharded_apply_banded_kernel(frames: torch.Tensor, y_band, x_band,
                                mesh) -> torch.Tensor:
    """Row-sharded apply with kernel 1 per shard (counterpart of
    ``sharded_apply_banded_pallas``): the same halo exchange, then
    ``cuda_apply.apply_separable_kernel`` on this rank's extended block
    and rebased tables.  bf16, f32 and uint8 frames give that dtype out
    (the kernel's contract); on a CPU tensor the wrapper takes its plain
    version."""
    return sharded_local_apply(y_band, x_band, mesh, _kernel1, frames)


def sharded_apply_banded_2d_kernel(frames: torch.Tensor, y_band, x_band,
                                   mesh) -> torch.Tensor:
    """2-D sharded apply with kernel 1 per shard (counterpart of
    ``sharded_apply_banded_2d_pallas``): both halo exchanges, then
    ``cuda_apply.apply_separable_kernel`` on this rank's extended block
    with its rows of the y band and its columns of the x band rebased.
    The kernel's own planner plans the shard (kernel 2 for bands too wide
    for shared memory); JAX's uniform ``_sharded_pallas_plan_2d`` has no
    counterpart.  Dtypes as ``sharded_apply_banded_kernel``."""
    return sharded_local_apply(y_band, x_band, mesh, _kernel1, frames,
                               cols=True)


def _gather_whole(t: torch.Tensor, mesh, cols: bool) -> torch.Tensor:
    """Whole planes from every rank's block: over the cols group (with
    ``cols``), then the rows group.  The blocks may be uneven (the ceil
    blocks of ``mesh.row_block`` that ``shard_rows`` cuts from counts that
    do not divide the mesh): ``mesh._gather_along`` pads them to one size
    for the all-gather and cuts them back."""
    if cols:
        t = mesh_ops._gather_along(t, COLS, mesh, -1)
    return mesh_ops._gather_along(t, ROWS, mesh, -2)


def _own_block(whole: torch.Tensor, mesh, cols: bool) -> torch.Tensor:
    """This rank's rows (with ``cols``: rows and columns) of whole planes,
    ceil blocks (``mesh.row_block``)."""
    if cols:
        return mesh_ops.plane_block(whole, mesh)
    n, i, _ = mesh_ops.axis(mesh, ROWS)
    lo, hi = mesh_ops.row_block(whole.shape[-2], n, i)
    return whole[..., lo:hi, :].contiguous()


def _rot90(frames: torch.Tensor, quadrant: int, mesh, cols: bool = False):
    """The global rot90 route: gather the source over the rows group (and
    the cols group), rotate it, and cut this rank's block out of the
    rotated source."""
    if quadrant % 4 == 0:
        return frames
    whole = quadrant_rotate(_gather_whole(frames, mesh, cols), quadrant)
    return _own_block(whole, mesh, cols)


def _post(post, out: torch.Tensor, mesh, cols: bool = False) -> torch.Tensor:
    """Apply a dst-side flip or transpose to the sharded inner output:
    gather the inner dst over the rows group (and the cols group), permute
    it, and keep this rank's block (the dst-sized reshard; the source
    never moves)."""
    return _own_block(post(_gather_whole(out, mesh, cols)), mesh, cols)


def _check_impl(frames: torch.Tensor, impl: str, conserve: bool) -> str:
    """The separable route for ``impl`` ('auto': the kernel for a CUDA
    tensor, 'banded' on the CPU); raises on an unknown impl, 'kernel' on
    a CPU tensor and ``conserve`` with uint8 frames."""
    if frames.dtype == torch.uint8 and conserve:
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
    return impl


def _separable(frames, op, mesh, impl, conserve, cols):
    """The body of both separable entry points."""
    impl = _check_impl(frames, impl, conserve)
    n_r = mesh_ops.axis(mesh, ROWS)[0]
    fold = (_folded_sharded_bands_2d(op, n_r, mesh_ops.axis(mesh, COLS)[0])
            if cols else _folded_sharded_bands(op, n_r))
    if fold is None:
        # the folded counts do not divide: rotate the whole source
        frames = _rot90(frames, op.spec.quadrant, mesh, cols)
        fold = dict(y=op.wy, x=op.wx, post=None, post_inv=None,
                    measures=op.raw_row_sums)
    y_use, x_use, post = fold["y"], fold["x"], fold["post"]
    u8 = frames.dtype == torch.uint8    # u8 in -> u8 out, like apply_operator
    if impl == "kernel":
        out = sharded_local_apply(y_use, x_use, mesh, _kernel1, frames,
                                  cols=cols)
    else:
        out = _banded(frames.to(torch.float32) if u8 else frames, y_use,
                      x_use, mesh, cols)
        if u8:      # quantise as the kernel does
            out = out.round().clamp(0.0, 255.0).to(torch.uint8)
    if conserve:
        from . import conserve as cons

        # the factors pair with the inner orientation, where frames and
        # out are sharded as the band tables are
        factors = cons.separable_flux_factors(y_use, x_use,
                                              raw_sums=fold["measures"])
        flux = (cons.sharded_flux_separable_2d if cols
                else cons.sharded_flux_separable)(frames, out, factors, mesh)
    if post is not None:
        out = _post(post, out, mesh, cols)
    if not conserve:
        return out
    return out, flux


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
    return _separable(frames, op, mesh, impl, conserve, False)


def sharded_apply_separable_2d(frames: torch.Tensor,
                               op: weights_ops.SeparableOperator, mesh, *,
                               impl: str = "auto", conserve: bool = False):
    """Apply a separable operator with BOTH image axes sharded: rows over
    the ``rows`` dim and columns over the ``cols`` dim of a ("data",
    "rows", "cols") mesh (``mesh.make_mesh((n_data, n_rows, n_cols),
    ...)``), the batch over ``data``.  The scaling form for frames too
    large for a 1-D row split: the blocks stay square.

    ``frames`` is this rank's block, (B / n_data, H / n_rows, W / n_cols)
    (``mesh.shard_blocks``); returns its block of the dst (counts that do
    not divide after a fold: ceil blocks on each axis).  One ring-halo
    exchange per mesh dim, rows first, then the columns of the
    row-extended block; never an all-gather of the source on the main
    route.

    impl, uint8 and conserve as ``sharded_apply_separable`` ('kernel':
    ``sharded_apply_banded_2d_kernel``, 'banded':
    ``sharded_apply_banded_2d``; the flux is reduced over the whole
    mesh).  A quadrant != 0 folds into both bands
    (``_folded_sharded_bands_2d``) and only the dst pays the flip,
    rot180 or transpose; where the folded counts do not divide the mesh,
    the global rot90 route runs instead.
    """
    return _separable(frames, op, mesh, impl, conserve, True)


def _separable_transpose(cot, op, mesh, impl, cols):
    """The body of both separable transposes."""
    impl = _check_impl(cot, impl, False)
    n_r = mesh_ops.axis(mesh, ROWS)[0]
    fold = (_folded_sharded_bands_2d(op, n_r, mesh_ops.axis(mesh, COLS)[0])
            if cols else _folded_sharded_bands(op, n_r))
    if fold is None:
        # the rot90 route: the unfolded transposes, then rotate back
        t_y, t_x = autodiff_ops.transposed_separable(op)
    else:
        t_y, t_x = _folded_transposes(op, cols)
        if fold["post_inv"] is not None:
            cot = _post(fold["post_inv"], cot, mesh, cols)
    if impl == "kernel":
        out = sharded_local_apply(t_y, t_x, mesh, _kernel1, cot, cols=cols)
    else:
        out = _banded(cot, t_y, t_x, mesh, cols)
    if fold is None:
        out = _rot90(out, -op.spec.quadrant, mesh, cols)
    return out


def sharded_apply_separable_transpose(cot: torch.Tensor,
                                      op: weights_ops.SeparableOperator,
                                      mesh, *, impl: str = "auto"
                                      ) -> torch.Tensor:
    """The adjoint of ``sharded_apply_separable``: this rank's block of a
    dst cotangent, (B / n_data, Hd / n_rows, Wd) (the forward's output
    blocks), -> its block of the source, (B / n_data, H / n_rows, W).

    The transpose of a banded separable operator is another one, so this
    is the forward's machinery on the transposed bands: the halo comes
    from the transposed y band and the cotangent's rows are exchanged
    (JAX: sharding.py:1812).  A quadrant folds as in the forward: the
    cotangent pays the small inverse permutation first (``post_inv``, a
    dst-sized gather), and the transposes of the folded bands
    (``_folded_transposes``) give the source in its own orientation; on
    the rot90 route the output is rotated back by -quadrant.

    impl: 'kernel' runs kernel 1 per shard on the transposed bands (kernel
    2 for a band pair too wide for shared memory; raises on a CPU tensor),
    'banded' the plain banded apply, 'auto' the kernel for a CUDA tensor
    and 'banded' on the CPU.  The kernel gives the cotangent's dtype out,
    'banded' float32.
    """
    return _separable_transpose(cot, op, mesh, impl, False)


def sharded_apply_separable_2d_transpose(cot: torch.Tensor,
                                         op: weights_ops.SeparableOperator,
                                         mesh, *, impl: str = "auto"
                                         ) -> torch.Tensor:
    """The adjoint of ``sharded_apply_separable_2d``: this rank's 2-D block
    of a dst cotangent -> its 2-D block of the source, over the rows and
    cols dims of a ("data", "rows", "cols") mesh (JAX: sharding.py:1010).
    The transposed bands run under the forward's two-axis ring halo; a
    quadrant folds with the 2-D table of ``_folded_transposes``.  impl
    and dtypes as ``sharded_apply_separable_transpose``."""
    return _separable_transpose(cot, op, mesh, impl, True)


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


def _ell_blocks(op: weights_ops.EllOperator, n_r: int, n_c: int = 0):
    """(db_r, sb_r, halo_y, db_c, sb_c, halo_x) of the sharded apply of
    ``op`` over ``n_r`` row ranks and, with ``n_c``, ``n_c`` column ranks
    (JAX's ``_ell_halo_2d``; ``n_c`` 0: rows only, the column entries
    whole and 0).  The halos are exact and cached by table content.
    ValueError where a count does not divide or a halo needs more ring
    hops than the axis has neighbours."""
    qH, qW = op.spec.qrot_shape
    Hd, Wd = op.spec.dst_shape
    if n_c and (Hd % n_r or qH % n_r or Wd % n_c or qW % n_c):
        raise ValueError(
            "2-D-sharded ELL apply requires divisible row and column counts "
            f"(dst {Hd}x{Wd}, src {qH}x{qW}, mesh {n_r}x{n_c})")
    if Hd % n_r or qH % n_r:
        raise ValueError(
            "row-sharded ELL apply requires divisible row counts "
            f"(dst {Hd}, src {qH}, devices {n_r})")
    key = (array_digest(op.base), op.base.shape, op.window, n_r, n_c)
    hit = _HALO_CACHE.get(key)
    if hit is None:
        K = op.window
        hit = (_ell_axis_halo(op.base[..., 0], K, Hd // n_r, qH // n_r, n_r),
               _ell_axis_halo(op.base[..., 1].T, K, Wd // n_c, qW // n_c, n_c)
               if n_c else 0)
        _HALO_CACHE.put(key, hit)
    halo_y, halo_x = hit
    out = (Hd // n_r, qH // n_r, halo_y) + (
        (Wd // n_c, qW // n_c, halo_x) if n_c else (Wd, qW, 0))
    for n, sb, halo in ((n_r, out[1], halo_y), (n_c, out[4], halo_x)):
        if n:
            _ring_hops(halo, sb, n)
    return out


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


def _ell_fold(op: weights_ops.EllOperator, n_r: int, base, weights,
              n_c: int = 0):
    """The apply's orientation, decided on the host: (op, post, base,
    weights, rotate).  A quadrant folds into the table
    (``fold_quadrant_ell_cached``), explicit tables with it
    (``fold_tables_device``), and ``post`` is the residual flip or
    transpose of the dst; where the folded row counts (with ``n_c``, and
    column counts) do not divide the mesh, ``rotate`` asks for the global
    rot90 route instead."""
    q = op.spec.quadrant % 4
    if q == 0:
        return op, None, base, weights, False
    folded, post = weights_ops.fold_quadrant_ell_cached(op)
    (Hd, Wd), (qH, qW) = folded.spec.dst_shape, folded.spec.qrot_shape
    if Hd % n_r or qH % n_r or (n_c and (Wd % n_c or qW % n_c)):
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
               on_cuda: bool, n_c: int = 0):
    """(route, sharded kernel plan or None), decided on the host before
    any launch (``api._ell_route``'s rule under sharding): 'auto' takes
    'kernel' for a CUDA tensor and 'gather' for a CPU one; a geometry that
    ``build_sharded_kernel_plan`` (with ``n_c``,
    ``build_sharded_kernel_plan_2d``) rejects sends 'auto' to 'gather'
    with a RuntimeWarning, counted in ``api.SHEAR_PLAN_FALLBACKS``, and
    makes 'kernel' raise."""
    if impl == "gather" or (impl == "auto" and not on_cuda):
        return "gather", None
    try:
        return "kernel", (
            cuda_shear.build_sharded_kernel_plan_2d(op, n_dev, n_c) if n_c
            else cuda_shear.build_sharded_kernel_plan(op, n_dev))
    except ValueError as e:
        if impl == "kernel":
            raise
        warnings.warn(f"sharded rotated apply takes the plain gather route: "
                      f"{e}", RuntimeWarning)
        api_mod.SHEAR_PLAN_FALLBACKS += 1
        return "gather", None


def _block_on(t, rows: slice, cols: slice, device, dtype) -> torch.Tensor:
    """A block of a table (numpy or a tensor on any device) on
    ``device``: a tensor's sliced, a host table's uploaded once per
    content, block, device and dtype (a rank's block of the rotated
    flagship's weights is 70 MB; its upload took longer than the
    scatter)."""
    if isinstance(t, torch.Tensor):
        return t[rows, cols].to(device=device, dtype=dtype)
    key = (array_digest(t), t.shape, rows.start, rows.stop, cols.start,
           cols.stop, torch.device(device), dtype)
    hit = _TABLE_BLOCKS.get(key)
    if hit is None:
        hit = upload(t[rows, cols], device, dtype)
        _TABLE_BLOCKS.put(key, hit)
    return hit


def _sharded_ell(frames, op, mesh, impl, base, weights, conserve,
                 cols=False):
    """The body of the ELL entry points, 1-D and (``cols``) 2-D; ``impl``
    is checked by them."""
    n_r, i, _ = mesh_ops.axis(mesh, ROWS)
    n_c, j, _ = mesh_ops.axis(mesh, COLS) if cols else (0, 0, None)
    _check_tables(op, base, weights)
    quadrant = op.spec.quadrant
    op, post, base, weights, rotate = _ell_fold(op, n_r, base, weights, n_c)
    on_cuda = frames.is_cuda
    host = _host_tables(op, base, weights,
                        impl == "kernel" or (impl == "auto" and on_cuda))
    db_r, sb_r, halo_y, db_c, sb_c, halo_x = _ell_blocks(host, n_r, n_c)
    route, kp = _ell_route(host, n_r, impl, on_cuda, n_c)
    if rotate:
        frames = _rot90(frames, quadrant, mesh, cols)
    if frames.ndim < 2 or tuple(frames.shape[-2:]) != (sb_r, sb_c):
        raise ValueError(f"this rank's block must end in ({sb_r}, {sb_c}) "
                         f"rows x columns, got {tuple(frames.shape)}")
    ext = _halo_extend(_halo_extend(frames, halo_y, mesh), halo_x, mesh,
                       COLS)
    if route == "kernel":
        out = cuda_shear.apply_ell_shear_kernel(
            ext, kp.rank(i, j) if cols else kp.rank(i))
    else:
        rows = slice(i * db_r, (i + 1) * db_r)
        cs = slice(j * db_c, (j + 1) * db_c)
        b = _block_on(op.base if base is None else base, rows, cs,
                      ext.device, torch.int64)
        b = b - b.new_tensor([i * sb_r - halo_y, j * sb_c - halo_x])
        out = apply_ell(ext, b, _block_on(op.weights if weights is None
                                          else weights, rows, cs, ext.device,
                                          torch.float32))
    if conserve:
        from . import conserve as cons

        # the folded operator's factors pair with the un-rotated frames
        # and the output before ``post``, sharded as its tables are
        flux = (cons.sharded_flux_ell_2d if cols else cons.sharded_flux_ell)(
            frames, out, cons.ell_flux_factors(op), mesh)
    if post is not None:
        out = _post(post, out, mesh, cols)
    return (out, flux) if conserve else out


def _check_ell_impl(frames: torch.Tensor, impl: str) -> None:
    if impl not in ELL_IMPLS:
        raise ValueError(
            f"unknown impl {impl!r} for the sharded ELL apply; expected one "
            f"of {ELL_IMPLS}")
    if impl == "kernel" and not frames.is_cuda:
        raise ValueError(
            "impl='kernel' needs a CUDA tensor; got one on "
            f"{frames.device} (use impl='auto' or 'gather' on the CPU)")


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


def sharded_apply_ell_2d_kernel(frames: torch.Tensor,
                                op: weights_ops.EllOperator, mesh, *,
                                base=None, weights=None) -> torch.Tensor:
    """2-D sharded rotated apply with the fused shear and the masked
    contraction per shard (counterpart of ``make_sharded_ell_pallas_2d``):
    both halo exchanges, then ``cuda_shear.apply_ell_shear_kernel`` on
    this rank's extended block with its plan
    ``build_sharded_kernel_plan_2d(op, n_r, n_c).rank(i, j)``.  Folds,
    dtypes and CPU tensors as ``sharded_apply_ell_kernel``."""
    return _sharded_ell(frames, op, mesh, "kernel", base, weights, False,
                        True)


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
    (``_post``).  Where the folded row counts do not divide the mesh,
    the global rot90 route runs instead.
    """
    _check_ell_impl(frames, impl)
    return _sharded_ell(frames, op, mesh, impl, base, weights, conserve)


def sharded_apply_ell_2d(frames: torch.Tensor, op: weights_ops.EllOperator,
                         mesh, *, conserve: bool = False, base=None,
                         weights=None, impl: str = "auto"):
    """Rotated (ELL) apply with BOTH image axes sharded, over the rows and
    cols dims of a ("data", "rows", "cols") mesh: this rank's block
    (B / n_data, qH / n_rows, qW / n_cols) (``mesh.shard_blocks``) -> its
    block of the dst.  One ring-halo exchange per mesh dim (rows, then the
    columns of the row-extended block); each halo grows with the angle
    and may take several hops.

    impl: 'kernel' (``sharded_apply_ell_2d_kernel``), 'gather' (the plain
    ``apply_ell`` on the extended block with this rank's (dst rows, dst
    columns) block of the tables, both bases rebased) or 'auto', with the
    rules of ``sharded_apply_ell``.  conserve: the flux pair reduced over
    the whole mesh.  base / weights: explicit tables, honoured on both
    routes and folded with a quadrant (JAX's Pallas 2-D route drops them:
    sharding.py:1664-1696).  A quadrant folds into the table where the
    folded row and column counts divide the mesh, else the global rot90
    route runs.
    """
    _check_ell_impl(frames, impl)
    return _sharded_ell(frames, op, mesh, impl, base, weights, conserve,
                        True)


def _sharded_ell_transpose(cot, op, mesh, base, weights, cols):
    """The body of both ELL transposes."""
    n_r, i, _ = mesh_ops.axis(mesh, ROWS)
    n_c, j, _ = mesh_ops.axis(mesh, COLS) if cols else (0, 0, None)
    _check_tables(op, base, weights)
    quadrant = op.spec.quadrant
    op, post, base, weights, rotate = _ell_fold(op, n_r, base, weights, n_c)
    host = _host_tables(op, base, weights, False)
    db_r, sb_r, halo_y, db_c, sb_c, halo_x = _ell_blocks(host, n_r, n_c)
    if post is not None:
        cot = _post(weights_ops.ell_fold_post_inv(quadrant), cot, mesh, cols)
    if cot.ndim < 2 or tuple(cot.shape[-2:]) != (db_r, db_c):
        raise ValueError(f"this rank's cotangent block must end in ({db_r}, "
                         f"{db_c}) rows x columns, got {tuple(cot.shape)}")
    rows = slice(i * db_r, (i + 1) * db_r)
    cs = slice(j * db_c, (j + 1) * db_c)
    b = _block_on(op.base if base is None else base, rows, cs, cot.device,
                  torch.int64)
    b = b - b.new_tensor([i * sb_r - halo_y, j * sb_c - halo_x])
    w = _block_on(op.weights if weights is None else weights, rows, cs,
                  cot.device, torch.float32)
    ext = apply_ell_transpose(cot, b, w, (sb_r + 2 * halo_y,
                                          sb_c + 2 * halo_x))
    out = _halo_reduce(_halo_reduce(ext, halo_x, mesh, COLS), halo_y, mesh)
    if rotate:
        out = _rot90(out, -quadrant, mesh, cols)
    return out


def sharded_apply_ell_transpose(cot: torch.Tensor,
                                op: weights_ops.EllOperator, mesh, *,
                                base=None, weights=None) -> torch.Tensor:
    """The adjoint of ``sharded_apply_ell``: this rank's block of a dst
    cotangent (the forward's output blocks) -> its block of the source,
    (B / n_data, H / n_rows, W), float32 (JAX: sharding.py:1887).

    Each rank scatters its cotangent block into its halo-extended source
    block with the forward's rebased window bases
    (``ops.apply.apply_ell_transpose``, ``index_add_``: the plain scatter
    on every device, as JAX's is XLA's), then ``_halo_reduce`` sends the
    halo's sums back to the ranks that own those rows, hop for hop the
    forward's exchange reversed.  A quadrant folds as in the forward: the
    cotangent pays the inverse dst permutation first
    (``weights.ell_fold_post_inv``) and the scatter lands in the source's
    own orientation; where the folded counts do not divide the mesh, the
    rot90 route runs and the output is rotated back.  ``base`` /
    ``weights``: explicit tables as in the forward, folded with the
    quadrant (``fold_tables_device``).
    """
    return _sharded_ell_transpose(cot, op, mesh, base, weights, False)


def sharded_apply_ell_2d_transpose(cot: torch.Tensor,
                                   op: weights_ops.EllOperator, mesh, *,
                                   base=None, weights=None) -> torch.Tensor:
    """The adjoint of ``sharded_apply_ell_2d``: this rank's 2-D block of a
    dst cotangent -> its 2-D block of the source, float32 (JAX:
    sharding.py:2005).  The local scatter, then ``_halo_reduce`` over the
    columns and then the rows, the forward's order reversed.  Folds and
    tables as ``sharded_apply_ell_transpose``."""
    return _sharded_ell_transpose(cot, op, mesh, base, weights, True)


# ---------------------------------------------------------------------------
# the autograd wrappers
# ---------------------------------------------------------------------------


class ShardedLinear(torch.autograd.Function):
    """A sharded apply whose backward is its sharded transpose (JAX's
    ``custom_vjp`` of the ``make_sharded_*_linear`` makers).  The whole
    sharded call is one node: autograd never traces ``mesh.exchange`` or
    an all-gather.  Both directions hold collectives, so every rank of the
    mesh must run the forward and the backward.  The cotangent comes back
    in the frames' dtype; explicit tables get no gradient."""

    @staticmethod
    def forward(ctx, frames: torch.Tensor, base, weights, fwd, bwd):
        ctx.bwd, ctx.dtype = bwd, frames.dtype
        ctx.tables = (base, weights)
        return fwd(frames, *ctx.tables)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return (ctx.bwd(g.contiguous(), *ctx.tables).to(ctx.dtype), None,
                None, None, None)


def _check_maker_impl(impl: str, impls) -> None:
    if impl not in impls:
        raise ValueError(f"unknown impl {impl!r} for the sharded apply; "
                         f"expected one of {impls}")


def make_sharded_separable_linear(op: weights_ops.SeparableOperator, mesh,
                                  *, impl: str = "auto"):
    """``f(frames)``: ``sharded_apply_separable`` on this rank's block, with
    ``sharded_apply_separable_transpose`` as its backward (JAX:
    sharding.py:1969), both on ``impl``'s route.  The backward holds
    collectives: every rank must call ``backward`` (or ``autograd.grad``)
    through ``f``'s output, never only some of them."""
    _check_maker_impl(impl, IMPLS)
    return lambda frames: ShardedLinear.apply(
        frames, None, None,
        lambda x, b, w: sharded_apply_separable(x, op, mesh, impl=impl),
        lambda g, b, w: sharded_apply_separable_transpose(g, op, mesh,
                                                          impl=impl))


def make_sharded_separable_2d_linear(op: weights_ops.SeparableOperator,
                                     mesh, *, impl: str = "auto"):
    """``f(frames)``: ``sharded_apply_separable_2d`` with
    ``sharded_apply_separable_2d_transpose`` as its backward (JAX:
    sharding.py:1082).  Every rank must run the backward, as
    ``make_sharded_separable_linear`` says."""
    _check_maker_impl(impl, IMPLS)
    return lambda frames: ShardedLinear.apply(
        frames, None, None,
        lambda x, b, w: sharded_apply_separable_2d(x, op, mesh, impl=impl),
        lambda g, b, w: sharded_apply_separable_2d_transpose(g, op, mesh,
                                                             impl=impl))


def make_sharded_ell_linear(op: weights_ops.EllOperator, mesh, *,
                            impl: str = "auto"):
    """``f(frames, base=None, weights=None)``: ``sharded_apply_ell`` on
    ``impl``'s route (the fused shear and the masked contraction per shard
    on the card) with ``sharded_apply_ell_transpose`` (the scatter per
    shard and ``_halo_reduce``) as its backward, the explicit tables in
    both (JAX: sharding.py:2126, whose tables ride as arguments as
    here).  The tables get no gradient.  Every rank must run the
    backward."""
    _check_maker_impl(impl, ELL_IMPLS)

    def f(frames, base=None, weights=None):
        return ShardedLinear.apply(
            frames, base, weights,
            lambda x, b, w: sharded_apply_ell(x, op, mesh, base=b, weights=w,
                                              impl=impl),
            lambda g, b, w: sharded_apply_ell_transpose(g, op, mesh, base=b,
                                                        weights=w))
    return f


def make_sharded_ell_2d_linear(op: weights_ops.EllOperator, mesh, *,
                               impl: str = "auto"):
    """``f(frames, base=None, weights=None)``: ``sharded_apply_ell_2d`` with
    ``sharded_apply_ell_2d_transpose`` as its backward (JAX:
    sharding.py:2090); tables and ranks as ``make_sharded_ell_linear``."""
    _check_maker_impl(impl, ELL_IMPLS)

    def f(frames, base=None, weights=None):
        return ShardedLinear.apply(
            frames, base, weights,
            lambda x, b, w: sharded_apply_ell_2d(x, op, mesh, base=b,
                                                 weights=w, impl=impl),
            lambda g, b, w: sharded_apply_ell_2d_transpose(g, op, mesh,
                                                           base=b, weights=w))
    return f
