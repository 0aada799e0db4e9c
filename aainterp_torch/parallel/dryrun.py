"""One step of every sharded path over n gloo ranks on the CPU, at tiny
shapes (the counterpart of the JAX package's ``dryrun_multichip``).

    python -m aainterp_torch.parallel.dryrun 4

``dryrun_multichip(n)`` builds the operators here (host weight-gen), then
starts n rank processes (``mesh.RankPool``, gloo on the CPU) and runs on
each rank, over a ("data", "rows") mesh with the rows capped at 4 as JAX
caps them:

* the separable apply (f32, and uint8 in and out), its 180- and
  90-degree folds;
* the rotated (ELL) apply on both routes (the kernel route's wrappers
  take their plain versions on the CPU) with its conservation flux, and
  a folded quadrant-1 geometry;
* the sharded lat-lon regrid with its flux, and masked;
* the gradients of ``make_sharded_separable_linear`` and
  ``make_sharded_ell_linear`` (explicit tables);

and, where 4 divides n, over a ("data", "rows", "cols") mesh of (n / 4,
2, 2): the 2-D separable apply with its flux and in uint8, the 2-D
rotated apply with its flux, the lat-and-lon regrid and the 2-D makers'
gradients.  Each result is gathered and held against the unsharded
``apply_operator`` / ``apply_operator_transpose`` at atol 1e-5 (the
regrid's fields, in [200, 300]: 1e-4; uint8: one level); the flux pairs
agree to rel 1e-4.  A rank that fails fails the run.  Imports no JAX.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from .. import api
from .. import autodiff
from .. import grids
from .. import regrid
from ..ops import weights as weights_ops
from . import mesh as mesh_ops
from . import sharding

ATOL = 1e-5
ATOL_REGRID = 1e-4
RTOL_FLUX = 1e-4


def mesh_shape(n_devices: int):
    """(data, rows): the rows capped at 4 shards, the data dim grown with
    the device count (JAX's rule: a 4-way row split already exercises the
    ring on both edges)."""
    rows = 1
    for r in (4, 2):
        if n_devices % r == 0 and n_devices >= 2 * r:
            rows = r
            break
    return n_devices // rows, rows


def _scan_ell(shape, angles, divides):
    """The first exact ELL operator over ``angles`` (1.0 -> 0.5 about the
    centre) whose counts pass ``divides(op)``."""
    H, W = shape
    for angle in angles:
        spec = grids.make_grid_spec(shape, 1.0, 0.5, (W / 2, H / 2), angle)
        op = api.build_operator(spec)
        if divides(op):
            return op
    raise RuntimeError(f"no dry-run rotation in {angles[0]}..{angles[-1]} "
                       f"degrees fits the mesh")


def operators(n_devices: int) -> dict:
    """The dry run's operators, built once on the host."""
    data, rows = mesh_shape(n_devices)
    H, W = rows * 32, 64
    sep = lambda shape, ang, iso=(0.0, 0.0): api.build_operator(
        grids.make_grid_spec(shape, 2.0, 1.0, iso, ang))
    ops = {"sep": sep((H, W), 0.0), "u8": sep((H, 128), 0.0),
           "q180": sep((H, W), 180.0, (4.0, 7.0)),
           "q90": sep((H, W), 90.0, (4.0, 7.0))}
    ops["ell"] = _scan_ell(
        (H, W), [x / 2.0 for x in range(3, 89)],
        lambda op: not (op.spec.dst_shape[0] % rows
                        or op.spec.qrot_shape[0] % rows))

    def folded_divides(op):
        f = weights_ops.fold_quadrant_ell_cached(op)[0]
        return not (f.spec.dst_shape[0] % rows or f.spec.qrot_shape[0] % rows)

    ops["ell_q1"] = _scan_ell((H, W), [90.0 + x / 2.0 for x in range(3, 89)],
                              folded_divides)
    if n_devices % 4 == 0:
        ops["sep2"] = sep((64, 64), 0.0)
        ops["ell2"] = _scan_ell(
            (64, 64), [x / 2.0 for x in range(3, 89)],
            lambda op: not any(n % 2 for n in op.spec.dst_shape
                               + op.spec.qrot_shape))
    return ops


def _close(got, ref, atol, what):
    got, ref = torch.as_tensor(got).double(), torch.as_tensor(ref).double()
    if got.shape != ref.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)}, want "
                             f"{tuple(ref.shape)}")
    err = float((got - ref).abs().max())
    if not err <= atol:
        raise AssertionError(f"{what}: max |sharded - unsharded| {err} > "
                             f"{atol}")
    return err


def _flux_ok(flux, what):
    fd, fs = (float(v) for v in flux)
    if not abs(fd - fs) <= RTOL_FLUX * abs(fs):
        raise AssertionError(f"{what}: flux dst {fd} vs src {fs}")
    return fd, fs


def _grad(lin, frames, mesh, shard, gather, tgt=None, args=()):
    """The gathered gradient of sum((f(x) - tgt)^2) through a maker, each
    rank running its own loss's backward."""
    x = shard(frames, mesh).clone().requires_grad_(True)
    out = lin(x, *args)
    r = out if tgt is None else out - shard(tgt, mesh)
    (r ** 2).sum().backward()
    return gather(x.grad, mesh)


def _runner(mesh, shard, gather, out: dict):
    """``run(name, fn, x, conserve=False)``: ``fn`` on this rank's block of
    ``x``, its flux pair checked (with ``conserve``), the whole output
    gathered; records the output's shape (and the flux) under ``name``."""
    def run(name, fn, x, conserve=False):
        res = fn(shard(x, mesh))
        if conserve:
            res, flux = res
            out[name + "_flux"] = _flux_ok(flux, name)
        got = gather(res, mesh)
        out[name] = tuple(got.shape)
        return got
    return run


def _rows_step(mesh, ops: dict, seed: int) -> dict:
    """The row-sharded paths on this rank; returns the checked shapes."""
    shard, gather = mesh_ops.shard_rows, mesh_ops.gather_rows
    data = mesh_ops.axis(mesh, mesh_ops.DATA)[0]
    rows = mesh_ops.axis(mesh, mesh_ops.ROWS)[0]
    rng = np.random.default_rng(seed)
    B, H, W = data * 2, rows * 32, 64
    frames = torch.as_tensor(rng.uniform(0, 1, (B, H, W)).astype(np.float32))
    out = {}
    run = _runner(mesh, shard, gather, out)
    sep, ell = sharding.sharded_apply_separable, sharding.sharded_apply_ell

    op = ops["sep"]
    ref = api.apply_operator(op, frames)
    _close(run("separable", lambda x: sep(x, op, mesh), frames), ref, ATOL,
           "separable")
    u8 = torch.as_tensor(rng.integers(0, 256, (B, H, 128), dtype=np.uint8))
    got = run("separable_u8", lambda x: sep(x, ops["u8"], mesh), u8)
    if got.dtype != torch.uint8:
        raise AssertionError(f"u8 in gave {got.dtype} out")
    _close(got, api.apply_operator(ops["u8"], u8.float()).round().clamp(
        0, 255), 1.0, "separable u8")
    for name in ("q180", "q90"):
        if sharding._folded_sharded_bands(ops[name], rows) is None:
            raise AssertionError(f"{name} must take the folded route")
        _close(run(name, lambda x: sep(x, ops[name], mesh), frames),
               api.apply_operator(ops[name], frames), ATOL, name)
    rop = ops["ell"]
    ref_r = api.apply_operator(rop, frames)
    _close(run("ell", lambda x: ell(x, rop, mesh), frames), ref_r, ATOL,
           "ell gather")
    _close(run("ell_kernel_route", lambda x: sharding.
               sharded_apply_ell_kernel(x, rop, mesh), frames), ref_r, ATOL,
           "ell kernel route")
    run("ell_conserve", lambda x: ell(x, rop, mesh, conserve=True), frames,
        True)
    q1 = ops["ell_q1"]
    _close(run("ell_q1", lambda x: ell(x, q1, mesh, conserve=True), frames,
               True), api.apply_operator(q1, frames), ATOL,
           "ell folded quadrant 1")
    g_src = regrid.LatLonGrid(rows * 12, 72)
    g_dst = regrid.LatLonGrid(rows * 3, 18)
    fields = torch.as_tensor(rng.uniform(200, 300, (B, rows * 12, 72))
                             .astype(np.float32))
    mask = torch.as_tensor(rng.uniform(0, 1, (rows * 12, 72)) > 0.3)
    _close(run("regrid", lambda f: regrid.conservative_regrid_sharded(
        f, g_src, g_dst, mesh, conserve=True), fields, True),
        regrid.conservative_regrid(fields, g_src, g_dst), ATOL_REGRID,
        "regrid")
    _close(run("regrid_masked", lambda f: regrid.conservative_regrid_sharded(
        f, g_src, g_dst, mesh, src_mask=mask), fields),
        regrid.conservative_regrid(fields, g_src, g_dst, src_mask=mask),
        ATOL_REGRID, "masked regrid")
    tgt = torch.as_tensor(rng.uniform(0, 1, tuple(ref.shape)).astype(
        np.float32))
    gs = _grad(sharding.make_sharded_separable_linear(op, mesh), frames,
               mesh, shard, gather, tgt)
    _close(gs, autodiff.apply_operator_transpose(op, 2.0 * (ref - tgt)),
           ATOL, "separable gradient")
    out["separable_grad"] = tuple(gs.shape)
    gr = _grad(sharding.make_sharded_ell_linear(rop, mesh), frames, mesh,
               shard, gather,
               args=(torch.as_tensor(rop.base),
                     torch.as_tensor(rop.weights, dtype=torch.float32)))
    _close(gr, autodiff.apply_operator_transpose(rop, 2.0 * ref_r), ATOL,
           "rotated gradient")
    out["ell_grad"] = tuple(gr.shape)
    return out


def _blocks_step(mesh, ops: dict, seed: int) -> dict:
    """The 2-D (rows x cols) sharded paths on this rank."""
    shard, gather = mesh_ops.shard_blocks, mesh_ops.gather_blocks
    data = mesh_ops.axis(mesh, mesh_ops.DATA)[0]
    rng = np.random.default_rng(seed + 1)
    B = data * 2
    frames = torch.as_tensor(rng.uniform(0, 1, (B, 64, 64)).astype(
        np.float32))
    out = {}
    run = _runner(mesh, shard, gather, out)
    sep, ell = sharding.sharded_apply_separable_2d, sharding.sharded_apply_ell_2d
    op, rop = ops["sep2"], ops["ell2"]
    ref = api.apply_operator(op, frames)
    _close(run("separable_2d", lambda x: sep(x, op, mesh, conserve=True),
               frames, True), ref, ATOL, "2-D separable")
    u8 = torch.as_tensor(rng.integers(0, 256, (B, 64, 64), dtype=np.uint8))
    got = run("separable_2d_u8", lambda x: sep(x, op, mesh), u8)
    if got.dtype != torch.uint8:
        raise AssertionError(f"2-D u8 in gave {got.dtype} out")
    _close(got, api.apply_operator(op, u8.float()).round().clamp(0, 255),
           1.0, "2-D separable u8")
    ref_r = api.apply_operator(rop, frames)
    _close(run("ell_2d", lambda x: ell(x, rop, mesh, conserve=True), frames,
               True), ref_r, ATOL, "2-D rotated gather")
    _close(run("ell_2d_kernel_route", lambda x: sharding.
               sharded_apply_ell_2d_kernel(x, rop, mesh), frames), ref_r,
           ATOL, "2-D rotated kernel route")
    g_src, g_dst = regrid.LatLonGrid(48, 72), regrid.LatLonGrid(12, 18)
    fields = torch.as_tensor(rng.uniform(200, 300, (B, 48, 72)).astype(
        np.float32))
    _close(run("regrid_2d", lambda f: regrid.conservative_regrid_sharded(
        f, g_src, g_dst, mesh, col_axis="cols"), fields),
        regrid.conservative_regrid(fields, g_src, g_dst), ATOL_REGRID,
        "2-D regrid")
    tgt = torch.as_tensor(rng.uniform(0, 1, tuple(ref.shape)).astype(
        np.float32))
    gs = _grad(sharding.make_sharded_separable_2d_linear(op, mesh), frames,
               mesh, shard, gather, tgt)
    _close(gs, autodiff.apply_operator_transpose(op, 2.0 * (ref - tgt)),
           ATOL, "2-D separable gradient")
    gr = _grad(sharding.make_sharded_ell_2d_linear(rop, mesh), frames, mesh,
               shard, gather)
    _close(gr, autodiff.apply_operator_transpose(rop, 2.0 * ref_r), ATOL,
           "2-D rotated gradient")
    out["grads_2d"] = (tuple(gs.shape), tuple(gr.shape))
    return out


def dryrun_multichip(n_devices: int, seed: int = 0) -> dict:
    """Run the dry run over ``n_devices`` gloo ranks on the CPU; raises
    (RuntimeError with the failing rank's traceback) where a check fails.
    Returns rank 0's checked shapes and flux pairs by path, and prints one
    line."""
    t0 = time.perf_counter()
    data, rows = mesh_shape(n_devices)
    ops = operators(n_devices)
    with mesh_ops.RankPool(n_devices, backend="gloo", device="cpu",
                           threads=1, timeout=600.0) as pool:
        summary = {"mesh": (data, rows)}
        summary.update(pool.run(_rows_step, (data, rows), ops, seed)[0])
        if n_devices % 4 == 0:
            summary["mesh_2d"] = (n_devices // 4, 2, 2)
            summary.update(pool.run(_blocks_step, summary["mesh_2d"], ops,
                                    seed)[0])
    summary["seconds"] = time.perf_counter() - t0
    print(f"dryrun_multichip OK: {n_devices} gloo ranks, mesh "
          f"{summary['mesh']}"
          + (f" and {summary['mesh_2d']}" if "mesh_2d" in summary else "")
          + f"; separable {summary['separable']} (+ u8, folds 180/90), "
          f"rotated {summary['ell']} (both routes, flux "
          f"{summary['ell_conserve_flux'][0]:.4f}~"
          f"{summary['ell_conserve_flux'][1]:.4f}), folded rotated "
          f"{summary['ell_q1']}, regrid {summary['regrid']} (+ masked), "
          f"gradients separable {summary['separable_grad']} + rotated "
          f"{summary['ell_grad']}"
          + (f"; 2-D separable {summary['separable_2d']} (+ u8), 2-D "
             f"rotated {summary['ell_2d']}, 2-D regrid "
             f"{summary['regrid_2d']}, 2-D gradients "
             f"{summary['grads_2d']}" if "mesh_2d" in summary else "")
          + f"; {summary['seconds']:.1f} s")
    return summary


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
