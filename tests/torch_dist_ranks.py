"""Rank-side functions of tests/test_torch_sharded.py,
tests/test_torch_sharded_ell.py, tests/test_torch_sharded_2d.py,
tests/test_torch_sharded_ell_2d.py, tests/test_torch_sharded_autodiff.py,
tests/test_torch_sharded_autodiff_2d.py and
tests/test_torch_sharded_cuda.py.

Each runs on every rank of an ``aainterp_torch.parallel.mesh.RankPool``
as ``fn(mesh, *args)``: it cuts the rank's block out of the whole input
(numpy, made by the test from a seed, or made on the rank from a seed),
runs the port's sharded function, gathers the result and returns numpy.
On a ("data", "rows") mesh the block is the rank's rows and the function
the row-sharded one; on a ("data", "rows", "cols") mesh the block is the
rank's 2-D block and the function the ``_2d`` one.
``check_sharded_vs_unsharded`` and ``check_sharded_2d_vs_unsharded``
check the ranks' results of ``sharded_vs_unsharded`` and
``sharded_2d_vs_unsharded`` for the CPU and the card files.  This module
imports neither jax nor the test files, so the rank processes never load
JAX.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

import aainterp_torch as at
from aainterp_torch import convert
from aainterp_torch import regrid
from aainterp_torch.ops import cuda_apply, cuda_apply_2d, cuda_shear
from aainterp_torch.ops import weights as weights_ops
from aainterp_torch.ops.apply import quadrant_rotate
from aainterp_torch.ops.overlap1d import Band1D
from aainterp_torch.parallel import conserve, mesh as pmesh, sharding


def _op(tables: dict):
    return convert.operator_from_numpy(**tables)


def _band(b) -> Band1D:
    return convert.band_from_numpy(b)


def _traffic() -> dict:
    return dict(pmesh.TRAFFIC)


def _delta(before: dict) -> dict:
    return {k: pmesh.TRAFFIC[k] - before[k] for k in before}


def _flux(flux):
    return None if flux is None else flux.numpy()


def _is_2d(mesh) -> bool:
    """A ("data", "rows", "cols") mesh: 2-D blocks and the _2d functions."""
    return pmesh.COLS in mesh.mesh_dim_names


def _shard(x, mesh) -> torch.Tensor:
    """This rank's block: its 2-D block on a 2-D mesh, else its rows."""
    x = torch.as_tensor(x)
    return (pmesh.shard_blocks if _is_2d(mesh) else pmesh.shard_rows)(x, mesh)


def _gather(x, mesh) -> torch.Tensor:
    return (pmesh.gather_blocks if _is_2d(mesh) else pmesh.gather_rows)(
        x, mesh)


def _shape(mesh):
    """(n_rows, n_cols) of the mesh, n_cols 0 without a cols dim."""
    return (pmesh.axis(mesh, pmesh.ROWS)[0],
            pmesh.axis(mesh, pmesh.COLS)[0] if _is_2d(mesh) else 0)


def _folded(op, mesh) -> bool:
    n_r, n_c = _shape(mesh)
    fold = (sharding._folded_sharded_bands_2d(op, n_r, n_c) if n_c
            else sharding._folded_sharded_bands(op, n_r))
    return fold is not None


def separable(mesh, frames, tables, impl="auto", conserve=False):
    """sharded_apply_separable (``_2d``) on this rank's block; the gathered
    output, this rank's block, the flux and the traffic of the call (or
    the ValueError's message)."""
    op = _op(tables)
    x = _shard(frames, mesh)
    fn = (sharding.sharded_apply_separable_2d if _is_2d(mesh)
          else sharding.sharded_apply_separable)
    before = _traffic()
    try:
        res = fn(x, op, mesh, impl=impl, conserve=conserve)
    except ValueError as e:
        return {"error": str(e)}
    traffic = _delta(before)
    out, flux = res if conserve else (res, None)
    return {"out": _gather(out, mesh).numpy(),
            "local": out.numpy(), "flux": _flux(flux), "traffic": traffic,
            "folded": _folded(op, mesh)}


def banded(mesh, frames, y, x, kernel=False):
    """sharded_apply_banded (``_2d``; or, with ``kernel``, the kernel-1
    route, whose wrapper takes its plain version on the CPU) of two
    Band1D tables; the gathered output, the halo's bytes and how many
    local applies took the aligned route (or the error)."""
    fn = {(False, False): sharding.sharded_apply_banded,
          (False, True): sharding.sharded_apply_banded_kernel,
          (True, False): sharding.sharded_apply_banded_2d,
          (True, True): sharding.sharded_apply_banded_2d_kernel}[
        (_is_2d(mesh), bool(kernel))]
    blk = _shard(frames, mesh)
    calls = []
    aligned = sharding.apply_separable_aligned

    def counted(*a, **k):
        calls.append(1)
        return aligned(*a, **k)

    sharding.apply_separable_aligned = counted
    before = _traffic()
    try:
        out = fn(blk, _band(y), _band(x), mesh)
    except ValueError as e:
        return {"error": str(e)}
    finally:
        sharding.apply_separable_aligned = aligned
    return {"out": _gather(out, mesh).numpy(),
            "dtype": str(out.dtype), "traffic": _delta(before),
            "aligned_calls": len(calls)}


def corrupted_flux(mesh, frames, tables):
    """The flux of a good sharded apply and of its output with two dst
    rows zeroed (a rank-local fault)."""
    op = _op(tables)
    blk = _shard(frames, mesh)
    two_d = _is_2d(mesh)
    good = (sharding.sharded_apply_separable_2d if two_d
            else sharding.sharded_apply_separable)(blk, op, mesh)
    bad = _gather(good, mesh).clone()
    bad[:, 5:7, :] = 0.0
    factors = conserve.separable_flux_factors(op.wy, op.wx,
                                              raw_sums=op.raw_row_sums)
    flux = (conserve.sharded_flux_separable_2d if two_d
            else conserve.sharded_flux_separable)
    return [flux(blk, _shard(d, mesh), factors, mesh).numpy()
            for d in (_gather(good, mesh), bad)]


def regrid_sharded(mesh, fields, src, dst, conserve=False, mask=None,
                   col_axis=None):
    """conservative_regrid_sharded on this rank's block (its 2-D block on
    a 2-D mesh); the gathered output, the flux, and how many local
    applies took the aligned route (or the ValueError's message)."""
    calls = []
    aligned = regrid.apply_separable_aligned

    def counted(*a, **k):
        calls.append(1)
        return aligned(*a, **k)

    regrid.apply_separable_aligned = counted
    try:
        blk = _shard(fields, mesh)
        res = regrid.conservative_regrid_sharded(
            blk, regrid.LatLonGrid(*src), regrid.LatLonGrid(*dst), mesh,
            conserve=conserve, src_mask=mask, col_axis=col_axis)
    except ValueError as e:
        return {"error": str(e)}
    finally:
        regrid.apply_separable_aligned = aligned
    out, flux = res if conserve else (res, None)
    return {"out": _gather(out, mesh).numpy(), "flux": _flux(flux),
            "aligned_calls": len(calls)}


def _ell_op(tables: dict):
    return convert.ell_operator_from_numpy(**tables)


def _ell_fn(mesh, kernel: bool):
    """The sharded ELL entry point for this mesh: row-sharded or 2-D, the
    kernel route or the one that takes ``impl``."""
    if _is_2d(mesh):
        return (sharding.sharded_apply_ell_2d_kernel if kernel
                else sharding.sharded_apply_ell_2d)
    return (sharding.sharded_apply_ell_kernel if kernel
            else sharding.sharded_apply_ell)


def ell(mesh, frames, tables, impl="auto", conserve=False, kernel=False,
        tables_as=None):
    """sharded_apply_ell (``_2d``; or, with ``kernel``,
    sharded_apply_ell_kernel (``_2d``), whose wrappers take their plain
    versions on the CPU) on this rank's block; the gathered output, this
    rank's block, the flux and the traffic of the call (or the
    ValueError's message).  ``tables_as``: a dtype name; the operator's
    own tables go in again as explicit ``base`` / ``weights`` tensors,
    the weights in that dtype."""
    op = _ell_op(tables)
    x = _shard(frames, mesh)
    kw = {}
    if tables_as is not None:
        kw = dict(base=torch.as_tensor(op.base),
                  weights=torch.as_tensor(op.weights).to(
                      getattr(torch, tables_as)))
    if not kernel:
        kw.update(impl=impl, conserve=conserve)
    before = _traffic()
    try:
        res = _ell_fn(mesh, kernel)(x, op, mesh, **kw)
    except ValueError as e:
        return {"error": str(e)}
    traffic = _delta(before)
    out, flux = res if conserve and not kernel else (res, None)
    return {"out": _gather(out, mesh).numpy(),
            "local": out.numpy(), "flux": _flux(flux), "traffic": traffic,
            "dtype": str(out.dtype)}


def ell_tables_of(mesh, frames, tables, other, kernel):
    """The sharded ELL apply of ``tables``' operator with ``other``'s base
    and weights as explicit tensors, on the gather route or (``kernel``)
    the kernel route; the gathered output."""
    op, o = _ell_op(tables), _ell_op(other)
    kw = dict(base=torch.as_tensor(o.base), weights=torch.as_tensor(o.weights))
    out = _ell_fn(mesh, kernel)(_shard(frames, mesh), op, mesh, **kw)
    return {"out": _gather(out, mesh).numpy()}


def _ell_unsharded_kernel(frames: torch.Tensor, op, n_rows: int,
                          n_cols: int = 0):
    """The unsharded kernel route, on any device (on the CPU the wrappers
    take their plain versions), in the orientation the sharded route
    takes over ``n_rows`` row shards (and ``n_cols`` column shards): the
    quadrant folded into the table, as ``apply_operator(impl='kernel')``
    folds it, where the folded counts divide; else the frames rotated.
    Returns (output, folded)."""
    q = op.spec.quadrant % 4
    fold = weights_ops.fold_quadrant_ell_cached(op) if q else None
    folded = fold is not None
    if folded:
        (Hd, Wd), (qH, qW) = fold[0].spec.dst_shape, fold[0].spec.qrot_shape
        folded = not (Hd % n_rows or qH % n_rows
                      or (n_cols and (Wd % n_cols or qW % n_cols)))
    if folded:
        op, post = fold
    elif q:
        frames = quadrant_rotate(frames, q)
    out = cuda_shear.apply_ell_shear_kernel(frames,
                                            cuda_shear.kernel_plan(op))
    return (post(out) if folded else out), folded


def ell_kernel_vs_unsharded(mesh, frames, tables):
    """The sharded kernel route against the unsharded one on this rank's
    device, bit for bit; the gathered output, the flux pair of the
    kernel route's output and its launches."""
    op = _ell_op(tables)
    whole = torch.as_tensor(frames)
    ref, folded = _ell_unsharded_kernel(whole, op, *_shape(mesh))
    before = dict(cuda_shear.LAUNCHES)
    out = _ell_fn(mesh, True)(_shard(whole, mesh), op, mesh)
    launches = {k: cuda_shear.LAUNCHES[k] - before[k] for k in before}
    got = _gather(out, mesh)
    res = {"out": got.numpy(), "cmp": _cmp(got, ref), "launches": launches,
           "folded": folded}
    if op.spec.quadrant == 0:
        flux = (conserve.sharded_flux_ell_2d if _is_2d(mesh)
                else conserve.sharded_flux_ell)
        res["flux"] = flux(_shard(whole, mesh), out,
                           conserve.ell_flux_factors(op), mesh).numpy()
    return res


def ell_corrupted_flux(mesh, frames, tables):
    """The flux of a good sharded ELL apply and of its output with two dst
    rows zeroed (a rank-local fault)."""
    op = _ell_op(tables)
    blk = _shard(frames, mesh)
    good = _gather(_ell_fn(mesh, False)(blk, op, mesh), mesh)
    bad = good.clone()
    bad[:, 5:7, :] = 0.0
    factors = conserve.ell_flux_factors(op)
    flux = (conserve.sharded_flux_ell_2d if _is_2d(mesh)
            else conserve.sharded_flux_ell)
    return [flux(blk, _shard(d, mesh), factors, mesh).numpy()
            for d in (good, bad)]


def rows_roundtrip(mesh, frames):
    """shard_rows then gather_rows (on a 2-D mesh shard_blocks then
    gather_blocks), with this rank's block's shape."""
    blk = _shard(frames, mesh)
    return {"shape": tuple(blk.shape), "out": _gather(blk, mesh).numpy()}


def halo_extend(mesh, x, h, dim):
    """``sharding._halo_extend`` of this rank's 2-D block by ``h`` along
    the mesh dim ``dim`` ('rows' or 'cols'); the extended block and the
    point-to-point bytes this rank sent."""
    before = _traffic()
    ext = sharding._halo_extend(_shard(x, mesh), h, mesh, dim)
    return {"ext": ext.numpy(), "p2p": _delta(before)["p2p"]}


def collective_sizes(mesh, kind, frames, tables, conserve=False):
    """The bytes of each collective one sharded call hands over, by kind
    (each point-to-point send, each rank's block of an all-gather, each
    all-reduced tensor): ``kind`` 'separable' or 'ell', on this rank's
    block (its 2-D block on a 2-D mesh), with ``conserve``; or
    'separable_transpose' or 'ell_transpose' on this rank's block of the
    cotangent ``frames``."""
    sizes = {"p2p": [], "all_gather": [], "all_reduce": []}
    saved = pmesh.exchange, pmesh.all_gather, pmesh.all_reduce

    def exchange(sends, recvs, group):
        sizes["p2p"] += [t.nbytes for t, _ in sends]
        return saved[0](sends, recvs, group)

    def all_gather(t, group):
        sizes["all_gather"].append(t.nbytes)
        return saved[1](t, group)

    def all_reduce(t, group):
        sizes["all_reduce"].append(t.nbytes)
        return saved[2](t, group)

    x = _shard(frames, mesh)
    pmesh.exchange, pmesh.all_gather, pmesh.all_reduce = (
        exchange, all_gather, all_reduce)
    try:
        if kind.endswith("_transpose"):
            ell = kind == "ell_transpose"
            _transpose_fn(mesh, ell)(x, (_ell_op if ell else _op)(tables),
                                     mesh)
        elif kind == "separable":
            fn = (sharding.sharded_apply_separable_2d if _is_2d(mesh)
                  else sharding.sharded_apply_separable)
            fn(x, _op(tables), mesh, conserve=conserve)
        else:
            _ell_fn(mesh, False)(x, _ell_op(tables), mesh, conserve=conserve)
    finally:
        pmesh.exchange, pmesh.all_gather, pmesh.all_reduce = saved
    return {"sizes": sizes, "block": x.nbytes}


# ---------------------------------------------------------------------------
# the transposes and the autograd wrappers
# ---------------------------------------------------------------------------


def _is_ell(tables: dict) -> bool:
    return "base" in tables


def _any_op(tables: dict):
    return _ell_op(tables) if _is_ell(tables) else _op(tables)


def _transpose_fn(mesh, ell: bool):
    if ell:
        return (sharding.sharded_apply_ell_2d_transpose if _is_2d(mesh)
                else sharding.sharded_apply_ell_transpose)
    return (sharding.sharded_apply_separable_2d_transpose if _is_2d(mesh)
            else sharding.sharded_apply_separable_transpose)


def _maker(mesh, ell: bool):
    if ell:
        return (sharding.make_sharded_ell_2d_linear if _is_2d(mesh)
                else sharding.make_sharded_ell_linear)
    return (sharding.make_sharded_separable_2d_linear if _is_2d(mesh)
            else sharding.make_sharded_separable_linear)


def transpose(mesh, cot, tables, impl=None, tables_as=None):
    """The sharded transpose (separable or ELL by ``tables``; row-sharded
    or ``_2d`` by the mesh) of this rank's block of the dst cotangent
    ``cot``: the gathered output, this rank's block, its dtype and the
    traffic of the call (or the ValueError's message).  ``impl``: the
    separable route; ``tables_as``: a dtype name, the ELL operator's own
    tables as explicit tensors, the weights in that dtype."""
    ell = _is_ell(tables)
    op = _any_op(tables)
    kw = {} if impl is None else {"impl": impl}
    if tables_as is not None:
        kw = dict(base=torch.as_tensor(op.base),
                  weights=torch.as_tensor(op.weights).to(
                      getattr(torch, tables_as)))
    g = _shard(cot, mesh)
    before = _traffic()
    try:
        out = _transpose_fn(mesh, ell)(g, op, mesh, **kw)
    except ValueError as e:
        return {"error": str(e)}
    traffic = _delta(before)
    return {"out": _gather(out, mesh).numpy(), "local": out.numpy(),
            "dtype": str(out.dtype), "traffic": traffic}


def adjoint_pair(mesh, x, y, tables):
    """<A x, y> and <x, A^T y> in float64, each from the sharded forward
    and the sharded transpose on this rank's blocks (local float64 dots,
    then one all_reduce)."""
    ell = _is_ell(tables)
    op = _any_op(tables)
    fwd = (_ell_fn(mesh, False) if ell else
           (sharding.sharded_apply_separable_2d if _is_2d(mesh)
            else sharding.sharded_apply_separable))
    xs, ys = _shard(x, mesh), _shard(y, mesh)
    ax = fwd(xs, op, mesh)
    aty = _transpose_fn(mesh, ell)(ys, op, mesh)
    dots = torch.stack([(ax.double() * ys.double()).sum(),
                        (xs.double() * aty.double()).sum()])
    return pmesh.all_reduce(dots, None).tolist()


def grad(mesh, frames, tables, tgt=None, impl="auto", explicit=False):
    """The gradient of sum((f(x) - tgt)^2) (without ``tgt``: sum(f(x)^2))
    through the maker of ``tables``' kind on this rank's block, each rank
    running its own loss's backward; the gathered forward output and
    gradient, and the gradient's dtype.  ``explicit``: the ELL tables go
    in as arguments, float32."""
    ell = _is_ell(tables)
    op = _any_op(tables)
    lin = _maker(mesh, ell)(op, mesh, impl=impl)
    x = _shard(frames, mesh).clone().requires_grad_(True)
    args = ()
    if explicit:
        args = (torch.as_tensor(op.base),
                torch.as_tensor(op.weights, dtype=torch.float32))
    out = lin(x, *args)
    r = out if tgt is None else out - _shard(tgt, mesh)
    (r.float() ** 2).sum().backward()
    return {"out": _gather(out.detach(), mesh).numpy(),
            "grad": _gather(x.grad, mesh).numpy(),
            "dtype": str(x.grad.dtype)}


def halo_pair(mesh, x, h, dim):
    """``_halo_extend`` of this rank's block of ``x`` (its 2-D block on a
    2-D mesh) by ``h`` along the mesh dim ``dim``, and ``_halo_reduce`` of
    a random block ``y`` of the extended shape (seeded by the rank):
    <extend(x), y> and <x, reduce(y)> summed over the mesh in float64,
    and each one's point-to-point bytes on this rank; or, where a halo
    needs more hops than the axis has neighbours, both calls' messages."""
    xs = _shard(x, mesh)
    axis = -2 if dim == pmesh.ROWS else -1
    shape = list(xs.shape)
    shape[axis] += 2 * h
    y = _rand(tuple(shape), 100 + torch.distributed.get_rank(), xs.device,
              xs.dtype)
    res = {}
    before = _traffic()
    try:
        ext = sharding._halo_extend(xs, h, mesh, dim)
    except ValueError as e:
        res["error"] = str(e)
    res["p2p_extend"] = _delta(before)["p2p"]
    before = _traffic()
    try:
        red = sharding._halo_reduce(y, h, mesh, dim)
    except ValueError as e:
        res["error_reduce"] = str(e)
        return res
    res["p2p_reduce"] = _delta(before)["p2p"]
    dots = torch.stack([(ext.double() * y.double()).sum(),
                        (xs.double() * red.double()).sum()])
    res.update(dots=pmesh.all_reduce(dots, None).tolist(),
               shape=tuple(red.shape), block=tuple(xs.shape))
    return res


def loaded_modules(mesh):
    """The modules of jax or of the JAX package this rank has loaded."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "aainterp"))


def fail_on(mesh, rank):
    """Raises on one rank (the others return its index)."""
    me = pmesh.axis(mesh, "rows")[1]
    if me == rank:
        raise ValueError(f"rank {me} fails on purpose")
    return me


# ---------------------------------------------------------------------------
# the same functions on the rank's device, against the unsharded calls
# (tests/test_torch_sharded_cuda.py runs them over NCCL on the card; the
# CPU tests run them over gloo, where the kernels' wrappers take their
# plain versions)
# ---------------------------------------------------------------------------


def _rand(shape, seed, dev, dtype=torch.float32):
    """The same uniform [0, 1) tensor on every rank."""
    g = torch.Generator().manual_seed(seed)
    return torch.rand(shape, generator=g).to(device=dev, dtype=dtype)


def _cmp(got: torch.Tensor, ref: torch.Tensor) -> dict:
    """Bit equality (NaN where the other has NaN) and the largest
    difference, of two whole outputs."""
    same = (got.shape == ref.shape and got.dtype == ref.dtype
            and torch.equal(got.isnan(), ref.isnan())
            and torch.equal(got.nan_to_num(0.0), ref.nan_to_num(0.0)))
    err = ((got.double() - ref.double()).nan_to_num(0.0).abs().max().item()
           if got.shape == ref.shape else float("inf"))
    return {"equal": same, "max_abs_err": err,
            "device": str(got.device)}


def _kernel1(frames, y, x):
    """The unsharded kernel-1 apply of a (y, x) Band1D pair."""
    return cuda_apply.apply_separable_kernel(
        frames, np.ascontiguousarray(y.start, np.int32),
        np.ascontiguousarray(y.weights, np.float32),
        np.ascontiguousarray(x.start, np.int32),
        np.ascontiguousarray(x.weights, np.float32))


def sharded_vs_unsharded(mesh):
    """Every sharded route on this rank's device against the unsharded
    call on the same inputs: kernel 1 at bf16 and u8, the f32 flux, the
    90-degree fold, the full-ring halo (the last ranks' taps reach rank
    0, so the exchange takes n - 1 hops and middle ranks post nothing on
    the later ones) on both routes, the regrid (kernel 2) plain and
    masked, the rotated apply's kernel route in bf16, and shard/gather
    of rows that do not divide.  Also counts the kernels' launches of
    the sharded calls."""
    dev = pmesh.rank_device()
    n_rows = pmesh.axis(mesh, pmesh.ROWS)[0]
    res = {}
    shape = (4, 256, 384)
    op = at.build_operator(at.make_grid_spec(shape[1:], 2.0, 1.0,
                                             (0.0, 0.0), 0.0))
    launches = {}
    for name, dtype in (("bf16", torch.bfloat16), ("u8", torch.uint8)):
        frames = _rand(shape, 1, dev)
        frames = ((frames * 255).round().to(dtype) if dtype == torch.uint8
                  else frames.to(dtype))
        ref = _kernel1(frames, op.wy, op.wx)
        before = cuda_apply.LAUNCHES
        out = sharding.sharded_apply_separable(
            pmesh.shard_rows(frames, mesh), op, mesh)
        launches[name] = cuda_apply.LAUNCHES - before
        res[name] = _cmp(pmesh.gather_rows(out, mesh), ref)
    frames = _rand(shape, 2, dev)
    out, flux = sharding.sharded_apply_separable(
        pmesh.shard_rows(frames, mesh), op, mesh, conserve=True)
    res["f32"] = _cmp(pmesh.gather_rows(out, mesh), _kernel1(frames, op.wy,
                                                             op.wx))
    _, _, covy, covx = conserve.separable_flux_factors(
        op.wy, op.wx, raw_sums=op.raw_row_sums)
    res["flux"] = flux.cpu().tolist()
    res["flux_device"] = str(flux.device)
    res["host_fs"] = float(np.einsum("fyx,y,x->",
                                     frames.cpu().double().numpy(), covy,
                                     covx))
    fold = at.build_operator(at.make_grid_spec(shape[1:], 2.0, 1.0,
                                               (3.0, 5.0), 90.0))
    out = sharding.sharded_apply_separable(pmesh.shard_rows(frames, mesh),
                                           fold, mesh)
    res["fold"] = _cmp(pmesh.gather_rows(out, mesh),
                       at.apply_operator(fold, frames))
    res["ref_max"] = float(frames.abs().max())
    n = 8 * n_rows
    ring = Band1D(start=np.zeros(n, np.int32),
                  weights=np.full((n, 3), 1.0 / 3.0), n_src=n, n_dst=n)
    frames = _rand((2, n, n), 3, dev)
    blk = pmesh.shard_rows(frames, mesh)
    before = dict(pmesh.TRAFFIC)
    out = sharding.sharded_apply_banded_kernel(blk, ring, ring, mesh)
    res["ring_p2p"] = pmesh.TRAFFIC["p2p"] - before["p2p"]
    res["ring_kernel"] = _cmp(pmesh.gather_rows(out, mesh),
                              _kernel1(frames, ring, ring))
    out = sharding.sharded_apply_banded(blk, ring, ring, mesh)
    res["ring_banded"] = _cmp(pmesh.gather_rows(out, mesh),
                              _kernel1(frames, ring, ring))
    src, dst = regrid.LatLonGrid(360, 720), regrid.LatLonGrid(36, 72)
    fields = _rand((4, 360, 720), 4, dev) * 50.0 + 250.0
    mask = _rand((360, 720), 5, dev) > 0.3
    mask[:20] = False                   # two dst rows with no valid cell
    for name, m in (("regrid", None), ("regrid_masked", mask)):
        before = cuda_apply_2d.LAUNCHES
        out = regrid.conservative_regrid_sharded(
            pmesh.shard_rows(fields, mesh), src, dst, mesh, src_mask=m)
        launches[name] = cuda_apply_2d.LAUNCHES - before
        res[name] = _cmp(pmesh.gather_rows(out, mesh),
                         regrid.conservative_regrid(fields, src, dst,
                                                    src_mask=m))
    # the rotated apply's kernel route (the fused shear and the masked
    # contraction per shard): 8 degrees, dst rows 68 over 128 src rows
    ell = at.build_operator(at.make_grid_spec((128, 64), 1.0, 0.5,
                                              (32.0, 64.0), 8.0))
    frames = _rand((2, 128, 64), 7, dev, torch.bfloat16)
    before = dict(cuda_shear.LAUNCHES)
    out = sharding.sharded_apply_ell_kernel(pmesh.shard_rows(frames, mesh),
                                            ell, mesh)
    launches["ell"] = {k: cuda_shear.LAUNCHES[k] - before[k]
                       for k in ("vhshear", "contract")}
    res["ell"] = _cmp(pmesh.gather_rows(out, mesh), cuda_shear.
                      apply_ell_shear_kernel(frames,
                                             cuda_shear.kernel_plan(ell)))
    res["launches"] = launches
    odd = _rand((2, 50, 6), 6, dev)      # 50 rows: ceil blocks
    res["roundtrip"] = _cmp(pmesh.gather_rows(pmesh.shard_rows(odd, mesh),
                                              mesh), odd)
    return res


def check_sharded_vs_unsharded(res: list, mesh_shape, on_card: bool):
    """Check every rank's ``sharded_vs_unsharded`` result.

    Bit equality wherever the sharded and the unsharded call take the
    same route: each dst row sums the same taps in the same order, only
    the row indices are rebased (the rotated kernel route's too: each
    rank's plan is the global plan's rows shifted).  Within f32 1e-5 (times the input's
    largest value for the fold) where they do not: the fold's residual
    flip or transpose against ``apply_operator``, and the ring on the
    plain banded route against kernel 1.  On the CPU ``impl='auto'``
    takes the plain banded route, which gives bf16 in float32 out: it is
    held within one bf16 ulp of kernel 1's plain version there.  On the
    card every rank launches kernel 1 once a separable call, kernel 2
    once a regrid (twice masked) and the fused shear and the contraction
    once a rotated call; on the CPU the wrappers launch nothing.
    """
    n_data, n_rows = mesh_shape
    for r in res:
        exact = ["u8", "f32", "regrid", "regrid_masked", "ring_kernel",
                 "ell", "roundtrip"] + (["bf16"] if on_card else [])
        for name in exact:
            assert r[name]["equal"], (name, r[name])
        assert on_card or r["bf16"]["max_abs_err"] <= 2.0 ** -8, r["bf16"]
        assert r["fold"]["max_abs_err"] <= 1e-5 * r["ref_max"], r["fold"]
        assert r["ring_banded"]["max_abs_err"] <= 1e-5, r["ring_banded"]
        want = "cuda" if on_card else "cpu"
        assert all(r[k]["device"].startswith(want) for k in exact)
        assert r["flux_device"].startswith(want)
        fd, fs = r["flux"]
        assert abs(fd - fs) <= 1e-5 * abs(fs), r["flux"]
        assert abs(fs - r["host_fs"]) <= 1e-5 * abs(r["host_fs"]), r
        assert r["flux"] == res[0]["flux"]
        assert r["launches"] == (
            {"bf16": 1, "u8": 1, "regrid": 1, "regrid_masked": 2,
             "ell": {"vhshear": 1, "contract": 1}} if on_card
            else {"bf16": 0, "u8": 0, "regrid": 0, "regrid_masked": 0,
                  "ell": {"vhshear": 0, "contract": 0}})
    # rank 0 sends its whole f32 block, b x 8 rows x (8 n_rows) columns,
    # on each of the ring's n_rows - 1 hops
    assert res[0]["ring_p2p"] == ((n_rows - 1) * (2 // n_data) * 8
                                  * 8 * n_rows * 4)


def sharded_2d_vs_unsharded(mesh):
    """The 2-D (rows x cols) sharded routes on this rank's device against
    the unsharded calls on the same inputs: kernel 1 at bf16 and u8, f32
    with the flux, the 90-degree fold, the lon-sharded regrid (kernel 2)
    plain and masked, the rotated apply's kernel route in bf16, and
    shard/gather of counts that do not divide; with the kernels' launches
    of the sharded calls."""
    dev = pmesh.rank_device()
    res, launches = {}, {}
    shape = (4, 256, 384)
    op = at.build_operator(at.make_grid_spec(shape[1:], 2.0, 1.0,
                                             (0.0, 0.0), 0.0))
    for name, dtype in (("bf16", torch.bfloat16), ("u8", torch.uint8)):
        frames = _rand(shape, 11, dev)
        frames = ((frames * 255).round().to(dtype) if dtype == torch.uint8
                  else frames.to(dtype))
        ref = _kernel1(frames, op.wy, op.wx)
        before = cuda_apply.LAUNCHES
        out = sharding.sharded_apply_separable_2d(
            pmesh.shard_blocks(frames, mesh), op, mesh)
        launches[name] = cuda_apply.LAUNCHES - before
        res[name] = _cmp(pmesh.gather_blocks(out, mesh), ref)
    frames = _rand(shape, 12, dev)
    out, flux = sharding.sharded_apply_separable_2d(
        pmesh.shard_blocks(frames, mesh), op, mesh, conserve=True)
    res["f32"] = _cmp(pmesh.gather_blocks(out, mesh),
                      _kernel1(frames, op.wy, op.wx))
    _, _, covy, covx = conserve.separable_flux_factors(
        op.wy, op.wx, raw_sums=op.raw_row_sums)
    res["flux"] = flux.cpu().tolist()
    res["flux_device"] = str(flux.device)
    res["host_fs"] = float(np.einsum("fyx,y,x->",
                                     frames.cpu().double().numpy(), covy,
                                     covx))
    fold = at.build_operator(at.make_grid_spec(shape[1:], 2.0, 1.0,
                                               (3.0, 5.0), 90.0))
    out = sharding.sharded_apply_separable_2d(
        pmesh.shard_blocks(frames, mesh), fold, mesh)
    res["fold"] = _cmp(pmesh.gather_blocks(out, mesh),
                       at.apply_operator(fold, frames))
    res["ref_max"] = float(frames.abs().max())
    src, dst = regrid.LatLonGrid(360, 720), regrid.LatLonGrid(36, 72)
    fields = _rand((4, 360, 720), 14, dev) * 50.0 + 250.0
    mask = _rand((360, 720), 15, dev) > 0.3
    mask[:20] = False                   # two dst rows with no valid cell
    for name, m in (("regrid", None), ("regrid_masked", mask)):
        before = cuda_apply_2d.LAUNCHES
        out = regrid.conservative_regrid_sharded(
            pmesh.shard_blocks(fields, mesh), src, dst, mesh, src_mask=m,
            col_axis="cols")
        launches[name] = cuda_apply_2d.LAUNCHES - before
        res[name] = _cmp(pmesh.gather_blocks(out, mesh),
                         regrid.conservative_regrid(fields, src, dst,
                                                    src_mask=m))
    # the rotated apply's kernel route: 31 degrees on a 128 x 128 source
    # (JAX's 2-D multi-hop geometry), whose dst rows divide 2 and columns
    # divide 4
    ell = at.build_operator(at.make_grid_spec((128, 128), 1.0, 0.5,
                                              (64.0, 64.0), 31.0))
    frames = _rand((2, 128, 128), 16, dev, torch.bfloat16)
    before = dict(cuda_shear.LAUNCHES)
    out = sharding.sharded_apply_ell_2d_kernel(
        pmesh.shard_blocks(frames, mesh), ell, mesh)
    launches["ell"] = {k: cuda_shear.LAUNCHES[k] - before[k]
                       for k in ("vhshear", "contract")}
    res["ell"] = _cmp(pmesh.gather_blocks(out, mesh), cuda_shear.
                      apply_ell_shear_kernel(frames,
                                             cuda_shear.kernel_plan(ell)))
    res["launches"] = launches
    odd = _rand((2, 50, 7), 17, dev)    # ceil blocks on both axes
    res["roundtrip"] = _cmp(pmesh.gather_blocks(pmesh.shard_blocks(odd, mesh),
                                                mesh), odd)
    return res


def check_sharded_2d_vs_unsharded(res: list, on_card: bool):
    """Check every rank's ``sharded_2d_vs_unsharded`` result.

    On the card, bit equality wherever the sharded and the unsharded call
    take one route (each dst pixel sums the same taps in the same order,
    only both indices are rebased).  On the CPU the separable routes are
    plain torch, whose sums run in an order that follows the block
    shapes: bf16 within one bf16 ulp (the plain route gives float32 out),
    u8 within one level (a .5 tie), f32 within 1e-5, the regrid's fields
    (250-300) within 1e-4; the rotated route's plain stages and
    shard/gather stay bit-equal.  Everywhere: the fold within f32 1e-5 of the largest
    input, the flux pair equal on every rank and within rtol 1e-5 of the
    float64 host sum, and the launches."""
    for r in res:
        exact = ["ell", "roundtrip"] + (
            ["bf16", "u8", "f32", "regrid", "regrid_masked"] if on_card
            else [])
        for name in exact:
            assert r[name]["equal"], (name, r[name])
        if not on_card:             # regrid fields lie in [250, 300)
            for name, tol in (("bf16", 2.0 ** -8), ("u8", 1.0),
                              ("f32", 1e-5), ("regrid", 1e-4),
                              ("regrid_masked", 1e-4)):
                assert r[name]["max_abs_err"] <= tol, (name, r[name])
        assert r["fold"]["max_abs_err"] <= 1e-5 * r["ref_max"], r["fold"]
        want = "cuda" if on_card else "cpu"
        assert all(r[k]["device"].startswith(want) for k in exact)
        assert r["flux_device"].startswith(want)
        fd, fs = r["flux"]
        assert abs(fd - fs) <= 1e-5 * abs(fs), r["flux"]
        assert abs(fs - r["host_fs"]) <= 1e-5 * abs(r["host_fs"]), r
        assert r["flux"] == res[0]["flux"]
        n = 1 if on_card else 0
        assert r["launches"] == {"bf16": n, "u8": n, "regrid": n,
                                 "regrid_masked": 2 * n,
                                 "ell": {"vhshear": n, "contract": n}}


def sharded_grad_vs_unsharded(mesh):
    """The makers' gradient steps on this rank's device against the
    unsharded autograd (``apply_operator(differentiable=True)``:
    ``SeparableLinear``, ``EllLinear``) on the same frames and cotangent:
    the separable maker at bf16 and, folded at 90 degrees, f32 (row-sharded
    or ``_2d`` by the mesh), and the rotated maker at f32 (8 degrees on
    128 x 64, or on a 2-D mesh 31 degrees on 128 x 128); kernel 1's
    launches of each separable step, forward and backward."""
    dev = pmesh.rank_device()
    res, launches = {}, {}
    spec = lambda ang: at.make_grid_spec((256, 384), 2.0, 1.0, (3.0, 5.0),
                                         ang)
    ell_spec = (at.make_grid_spec((128, 128), 1.0, 0.5, (64.0, 64.0), 31.0)
                if _is_2d(mesh) else
                at.make_grid_spec((128, 64), 1.0, 0.5, (32.0, 64.0), 8.0))
    cases = (("bf16", spec(0.0), torch.bfloat16, False),
             ("fold", spec(90.0), torch.float32, False),
             ("ell", ell_spec, torch.float32, True))
    for name, sp, dtype, ell in cases:
        op = at.build_operator(sp)
        frames = _rand((4,) + sp.src_shape, 21, dev, dtype)
        xr = frames.clone().requires_grad_(True)
        out_ref = at.apply_operator(op, xr, differentiable=True)
        g = _rand(tuple(out_ref.shape), 22, dev, out_ref.dtype)
        (ref,) = torch.autograd.grad(out_ref, xr, g)
        lin = _maker(mesh, ell)(op, mesh)
        x = _shard(frames, mesh).clone().requires_grad_(True)
        before = cuda_apply.LAUNCHES
        out = lin(x)
        (gx,) = torch.autograd.grad(out, x, _shard(g, mesh))
        launches[name] = cuda_apply.LAUNCHES - before
        res[name] = _cmp(_gather(gx, mesh), ref)
        res[name + "_fwd"] = _cmp(_gather(out.detach(), mesh),
                                  out_ref.detach())
        res[name + "_max"] = float(ref.abs().max())
    res["launches"] = launches
    return res


def check_sharded_grad_vs_unsharded(res: list, on_card: bool):
    """Check every rank's ``sharded_grad_vs_unsharded`` result.  On the
    card the bf16 step is bit-equal to the unsharded one, forward and
    gradient (kernel 1 on each rank's rows of the same tables, and of the
    transposed tables), with 1 launch in the forward and 1 in the
    backward; on the CPU (plain routes, sums in a shape-dependent order)
    within one bf16 ulp.  The fold within 1e-6 x the largest gradient on
    the card (1e-5 on the CPU); the rotated gradient (the scatter) within
    f32 1e-5, its forward bit-equal on the card."""
    for r in res:
        want = "cuda" if on_card else "cpu"
        assert all(r[k]["device"].startswith(want)
                   for k in ("bf16", "fold", "ell")), r
        if on_card:
            assert r["bf16"]["equal"] and r["bf16_fwd"]["equal"], r
            assert r["ell_fwd"]["equal"], r["ell_fwd"]
        else:
            assert r["bf16"]["max_abs_err"] <= 2.0 ** -8 * r["bf16_max"], r
        tol = (1e-6 if on_card else 1e-5) * r["fold_max"]
        assert r["fold"]["max_abs_err"] <= tol, r["fold"]
        assert r["ell"]["max_abs_err"] <= 1e-5, r["ell"]
        n = 2 if on_card else 0
        assert r["launches"] == {"bf16": n, "fold": n, "ell": 0}, r


def collectives_to_self(mesh):
    """The three collectives on this rank's device, each rank sending to
    itself: ``exchange`` with the rank as its own peer, ``all_gather``
    and ``all_reduce``.  Returns whether each gave what it must.  NCCL
    sends to the sending rank; gloo's pairs do not (a rank has no pair
    to itself there)."""
    dev = pmesh.rank_device()
    n, i, group = pmesh.axis(mesh, pmesh.ROWS)
    res = {}
    for dtype in (torch.bfloat16, torch.float32, torch.uint8):
        x = (torch.arange(24, device=dev) + 3 * i).reshape(2, 3, 4).to(dtype)
        into = torch.zeros((2, 2, 4), dtype=dtype, device=dev)
        pmesh.exchange([(x[:, 1:], i)], [(into, i)], group)   # a strided send
        res[f"exchange_{dtype}"] = torch.equal(into, x[:, 1:])
    parts = pmesh.all_gather(torch.full((5,), float(i), device=dev), group)
    res["all_gather"] = (len(parts) == n and all(
        p.device == dev and torch.equal(p, torch.full((5,), float(r),
                                                      device=dev))
        for r, p in enumerate(parts)))
    t = torch.tensor([1.0, 2.0], dtype=torch.float64, device=dev)
    pmesh.all_reduce(t, None)
    res["all_reduce"] = (t.device == dev and t.tolist()
                         == [1.0 * mesh.mesh.numel(), 2.0 * mesh.mesh.numel()])
    return res
