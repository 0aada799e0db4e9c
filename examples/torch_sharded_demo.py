"""Multi-device spatial sharding in the port (``aainterp_torch.parallel``),
the counterpart of examples/sharded_demo.py.

Run:  python examples/torch_sharded_demo.py                  (NCCL, one
                                                             rank a card)
      python examples/torch_sharded_demo.py --device cpu     (4 gloo ranks)

Image rows are sharded over the ranks of a ``torch.distributed`` mesh,
each rank computing its destination rows from its own source rows and a
ring-exchanged halo (several hops for steep rotations); the sharded
conservative lat-lon regrid with its conservation flux; a 2-D (rows x
cols) mesh with a folded quadrant; and a sharded gradient step, whose
backward runs the transposed operator per shard and returns the halo's
sums over the reverse ring.  Every rank is a process of its own
(``mesh.run_spmd``); on the card each runs the kernels on its shard.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import aainterp_torch as at  # noqa: E402
from aainterp_torch import regrid  # noqa: E402
from aainterp_torch.parallel import mesh as pmesh  # noqa: E402
from aainterp_torch.parallel import sharding  # noqa: E402


def _err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def rows_demo(mesh, seed: int) -> list:
    """Sections 1-3 and 5 on one rank of a ("data", "rows") mesh; rank 0's
    lines are printed."""
    dev = pmesh.rank_device()
    n_data = pmesh.axis(mesh, pmesh.DATA)[0]
    n_rows = pmesh.axis(mesh, pmesh.ROWS)[0]
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, device=dev)
    lines = [f"mesh: data {n_data} x rows {n_rows} on {dev}"]

    # 1. separable 2x downscale, the batch over 'data', rows over 'rows'
    B, H, W = 2 * n_data, 64 * n_rows, 128
    frames = t(rng.uniform(0, 1, (B, H, W)).astype(np.float32))
    op = at.build_operator(at.make_grid_spec((H, W), 2.0, 1.0, (0.0, 0.0),
                                             0.0))
    local = pmesh.shard_rows(frames, mesh)
    out = sharding.sharded_apply_separable(local, op, mesh)
    ref = at.apply_operator(op, frames)
    lines.append(f"separable: {tuple(frames.shape)} -> {tuple(ref.shape)}, "
                 f"this rank's block {tuple(out.shape)}, max |sharded - "
                 f"unsharded| = {_err(pmesh.gather_rows(out, mesh), ref):.2e}")

    # 2. rotated (ELL) apply with a multi-hop ring halo: 45 degrees on a
    #    wide, short image reaches several row shards
    H2, W2 = 8 * n_rows, 512
    op_r = at.build_operator(at.make_grid_spec((H2, W2), 1.0, 0.5,
                                               (W2 / 2, H2 / 2), 45.0))
    img = t(rng.uniform(0, 1, (1, H2, W2)).astype(np.float32))
    if op_r.spec.dst_shape[0] % n_rows == 0:
        out_r = sharding.sharded_apply_ell(pmesh.shard_rows(img, mesh), op_r,
                                           mesh)
        err = _err(pmesh.gather_rows(out_r, mesh), at.apply_operator(op_r,
                                                                     img))
        lines.append(f"rotated 45 deg over {n_rows} row shards: "
                     f"{tuple(img.shape)} -> {tuple(op_r.spec.dst_shape)}, "
                     f"max err {err:.2e}")

    # 3. conservative lat-lon regrid with the global conservation check:
    #    the [flux_dst, flux_src] pair (one all-reduce over the mesh)
    #    agrees iff every rank's halo and contraction are right
    src, dst = regrid.LatLonGrid(24 * n_rows, 72), regrid.LatLonGrid(
        6 * n_rows, 18)
    fields = t(rng.uniform(200, 300, (B, 24 * n_rows, 72)).astype(
        np.float32))
    out_g, flux = regrid.conservative_regrid_sharded(
        pmesh.shard_rows(fields, mesh), src, dst, mesh, conserve=True)
    fd, fs = flux.tolist()
    err = _err(pmesh.gather_rows(out_g, mesh),
               regrid.conservative_regrid(fields, src, dst))
    lines.append(f"regrid: {tuple(fields.shape)} -> ({B}, {dst.n_lat}, "
                 f"{dst.n_lon}), max err {err:.2e}, flux dst/src = "
                 f"{fd:.2f}/{fs:.2f} (rel diff {abs(fd - fs) / abs(fs):.1e})")

    # 5. a sharded gradient step: recover the frames from their 2x
    #    downscale by gradient descent on sum((A x - y)^2), each rank
    #    holding its rows; the backward is the transposed bands per shard
    lin = sharding.make_sharded_separable_linear(op, mesh)
    y = pmesh.shard_rows(ref, mesh)
    x = torch.zeros_like(local)
    losses = []
    for _ in range(5):
        x.requires_grad_(True)
        loss = ((lin(x) - y) ** 2).sum()
        (g,) = torch.autograd.grad(loss, x)
        total = pmesh.all_reduce(loss.detach().double().reshape(1), None)
        losses.append(float(total))
        x = (x - 0.5 * g).detach()
    g_ref = at.apply_operator_transpose(op, 2.0 * (at.apply_operator(
        op, pmesh.gather_rows(x, mesh)) - ref))
    x.requires_grad_(True)
    (g,) = torch.autograd.grad(((lin(x) - y) ** 2).sum(), x)
    lines.append(f"sharded gradient steps (separable): loss "
                 f"{[round(v, 4) for v in losses]}, last gradient vs the "
                 f"unsharded adjoint max err "
                 f"{_err(pmesh.gather_rows(g, mesh), g_ref):.2e}")
    lin_r = sharding.make_sharded_ell_linear(op_r, mesh)
    if op_r.spec.dst_shape[0] % n_rows == 0:
        xr = pmesh.shard_rows(img, mesh).clone().requires_grad_(True)
        (gr,) = torch.autograd.grad((lin_r(xr) ** 2).sum(), xr)
        gr_ref = at.apply_operator_transpose(
            op_r, 2.0 * at.apply_operator(op_r, img))
        lines.append(f"sharded gradient (rotated 45 deg, reverse-ring halo "
                     f"sums): max err "
                     f"{_err(pmesh.gather_rows(gr, mesh), gr_ref):.2e}")
    return lines


def blocks_demo(mesh, seed: int) -> list:
    """Section 4 on one rank of a ("data", "rows", "cols") mesh: both
    image axes sharded, a ring halo per axis; at 121.5 degrees the
    quadrant folds into the tables, with the flux pair."""
    dev = pmesh.rank_device()
    shape = tuple(mesh.mesh.shape)
    rng = np.random.default_rng(seed + 1)
    H, W = 128, 96
    op = at.build_operator(at.make_grid_spec((H, W), 1.0, 0.5, (48.0, 64.0),
                                             121.5))
    img = torch.as_tensor(rng.uniform(0, 1, (shape[0] * 2, H, W)).astype(
        np.float32), device=dev)
    out, flux = sharding.sharded_apply_ell_2d(pmesh.shard_blocks(img, mesh),
                                              op, mesh, conserve=True)
    fd, fs = flux.tolist()
    err = _err(pmesh.gather_blocks(out, mesh), at.apply_operator(op, img))
    lin = sharding.make_sharded_ell_2d_linear(op, mesh)
    x = pmesh.shard_blocks(img, mesh).clone().requires_grad_(True)
    (g,) = torch.autograd.grad((lin(x) ** 2).sum(), x)
    g_ref = at.apply_operator_transpose(op, 2.0 * at.apply_operator(op, img))
    return [f"rotated 121.5 deg on a {shape} (data, rows, cols) mesh, "
            f"quadrant folded: {tuple(img.shape)} -> "
            f"{tuple(op.spec.dst_shape)}, max err {err:.2e}, flux rel diff "
            f"{abs(fd - fs) / abs(fs):.1e}; its gradient max err "
            f"{_err(pmesh.gather_blocks(g, mesh), g_ref):.2e}"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--ranks", type=int, default=None,
                    help="rank processes (default: 4 on the CPU, one a "
                         "card on cuda)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("--device cuda: torch.cuda.is_available() is False; pass "
                 "--device cpu to run on the CPU")
    n = args.ranks or (4 if args.device == "cpu"
                       else torch.cuda.device_count())
    backend = "gloo" if args.device == "cpu" else "nccl"
    rows = 4 if n % 4 == 0 else (2 if n % 2 == 0 else 1)
    mesh_1d = (n // rows, rows)
    mesh_2d = (n // 4, 2, 2) if n % 4 == 0 else (1, 1, n)
    with pmesh.RankPool(n, backend=backend, device=args.device,
                        threads=1 if args.device == "cpu" else None) as pool:
        lines = pool.run(rows_demo, mesh_1d, 0)[0]
        lines += pool.run(blocks_demo, mesh_2d, 0)[0]
    print(f"{n} {backend} rank(s) on {args.device}")
    for line in lines:
        print(line)


if __name__ == "__main__":
    main()
