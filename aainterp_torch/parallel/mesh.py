"""The ("data", "rows") and ("data", "rows", "cols") device meshes, a
rank's block of a batch, the collectives of the sharded applies, and the
rank processes.

Counterpart of the JAX package's ``Mesh``, of
``device_put(frames, NamedSharding(mesh, P("data", "rows", None)))`` and
of the 8-device virtual CPU mesh of its tests.  JAX runs one SPMD program
over the mesh; here every rank is a process of its own that holds its
block of the batch, ``(B / n_data, H / n_rows, W)``, and calls the same
function.

* ``make_mesh`` builds a ``torch.distributed.device_mesh.DeviceMesh``
  over every rank of the process group: dims ``("data", "rows")`` from
  ``(n_data, n_rows)``, or ``("data", "rows", "cols")`` from ``(n_data,
  n_rows, n_cols)`` for the 2-D (rows x cols) sharded applies.
* ``shard_rows`` cuts a rank's block out of a whole batch, and
  ``gather_rows`` puts the whole batch back together on every rank;
  ``shard_blocks`` / ``gather_blocks`` do the same for the 2-D blocks
  ``(B / n_data, H / n_rows, W / n_cols)``.  Counts that do not divide
  the mesh split as JAX's uneven sharding does: blocks of ceil(H / n)
  rows (or columns), the last ones shorter.
* ``exchange``, ``all_gather`` and ``all_reduce`` are the collectives the
  sharded applies use.  Under NCCL a CUDA tensor goes to the collective as
  it is.  Under gloo a CUDA tensor is staged through pinned host memory:
  NCCL refuses two ranks on one card, so ranks that share a card talk
  over gloo and the host.  ``TRAFFIC`` counts the bytes this process
  handed to each kind.
* ``RankPool`` starts ``world`` rank processes on this host, each with
  its process group (``tcp://localhost:<free port>``), and runs a
  function on all of them; ``run_spmd`` is one such call.  Rank ``r``
  computes on ``cuda:(r % device_count)`` unless the caller asks for the
  CPU.  The backend is always the caller's choice: nothing here changes
  it, or the device, because one of them failed.
"""

from __future__ import annotations

import datetime
import math
import multiprocessing
import queue
import socket
import time
import traceback
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

DIMS = ("data", "rows")
DIMS_2D = ("data", "rows", "cols")
DATA, ROWS, COLS = DIMS_2D
BACKENDS = ("nccl", "gloo")
DEVICES = ("cuda", "cpu")

# bytes this process handed to each kind of collective: the tensors it
# sent point to point, its own block of each all-gather, each tensor it
# all-reduced
TRAFFIC = {"p2p": 0, "all_gather": 0, "all_reduce": 0}

# the device of this rank, set where RankPool starts it
_DEVICE: Optional[torch.device] = None


def rank_device() -> torch.device:
    """The device this rank computes on (inside a ``RankPool`` rank)."""
    if _DEVICE is None:
        raise RuntimeError("rank_device() is called inside a rank of "
                           "RankPool or run_spmd only")
    return _DEVICE


def make_mesh(mesh_shape: Sequence[int], backend: str):
    """The DeviceMesh over every rank of the default process group: dims
    ``("data", "rows")`` for an ``(n_data, n_rows)`` shape, ``("data",
    "rows", "cols")`` for ``(n_data, n_rows, n_cols)``.  Its device type
    is the collectives' own: ``cuda`` under NCCL, ``cpu`` under gloo
    (which stages CUDA tensors)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = tuple(int(n) for n in mesh_shape)
    dims = {len(DIMS): DIMS, len(DIMS_2D): DIMS_2D}.get(len(shape))
    if dims is None or math.prod(shape) != dist.get_world_size():
        raise ValueError(f"mesh shape {shape} must be (n_data, n_rows) or "
                         f"(n_data, n_rows, n_cols) with its product == "
                         f"{dist.get_world_size()} ranks")
    return init_device_mesh("cuda" if backend == "nccl" else "cpu", shape,
                            mesh_dim_names=dims)


def axis(mesh, name: str):
    """(size, this rank's index, process group) of the mesh dim ``name``."""
    if name not in mesh.mesh_dim_names:
        raise ValueError(f"the mesh has no {name!r} dim (dims "
                         f"{mesh.mesh_dim_names}); a 2-D sharded apply takes "
                         f"a make_mesh((n_data, n_rows, n_cols), ...) mesh")
    dim = mesh.mesh_dim_names.index(name)
    return mesh.size(dim), mesh.get_local_rank(name), mesh.get_group(name)


def row_block(n: int, parts: int, i: int) -> Tuple[int, int]:
    """[lo, hi) of block ``i`` of ``n`` rows cut into ``parts`` blocks of
    ceil(n / parts) rows (the last ones shorter, or empty)."""
    size = -(-n // parts)
    lo = min(i * size, n)
    return lo, min(lo + size, n)


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _pinned_copy(t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return host.copy_(t)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's storage as a flat uint8 tensor (gloo's
    all-gather is typed; bytes take every dtype)."""
    return t.reshape(-1).view(torch.uint8)


def exchange(sends, recvs, group) -> None:
    """Point-to-point sends and receives in one ``batch_isend_irecv``.

    ``sends`` and ``recvs`` are lists of ``(tensor, peer)``, ``peer`` a
    rank of ``group``, at most one each way per peer; each received tensor
    is written in place (it must be contiguous).  A sent tensor is made
    contiguous first."""
    if not sends and not recvs:
        return
    staged = any(_staged(t, group) for t, _ in list(sends) + list(recvs))
    out = [t.contiguous() for t, _ in sends]
    out = [_pinned_copy(t) if staged else t for t in out]
    into = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            if staged else t for t, _ in recvs]
    ops = [dist.P2POp(dist.isend, t, dist.get_global_rank(group, peer), group)
           for t, (_, peer) in zip(out, sends)]
    ops += [dist.P2POp(dist.irecv, t, dist.get_global_rank(group, peer),
                       group)
            for t, (_, peer) in zip(into, recvs)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if staged:
        for (t, _), host in zip(recvs, into):
            t.copy_(host)
    TRAFFIC["p2p"] += sum(t.nbytes for t in out)


def all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``t`` (same shape and dtype on each), in the group's
    rank order, on ``t``'s device."""
    t = t.contiguous()
    src = _pinned_copy(t) if _staged(t, group) else t
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather([_bytes(p) for p in parts], _bytes(src), group=group)
    TRAFFIC["all_gather"] += t.nbytes
    return [p.to(t.device) for p in parts]


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place; returns ``t``."""
    if _staged(t, group):
        host = _pinned_copy(t)
        dist.all_reduce(host, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=group)
    TRAFFIC["all_reduce"] += t.nbytes
    return t


def _block_along(x: torch.Tensor, name: str, mesh, dim: int) -> torch.Tensor:
    """This rank's block of ``x`` along tensor dim ``dim``, cut over the
    mesh dim ``name`` (``row_block``)."""
    n, i, _ = axis(mesh, name)
    lo, hi = row_block(x.shape[dim], n, i)
    return x.narrow(dim, lo, hi - lo)


def _gather_along(local: torch.Tensor, name: str, mesh,
                  dim: int) -> torch.Tensor:
    """The whole of tensor dim ``dim`` from every rank of the mesh dim
    ``name`` (blocks of ``row_block``'s sizes, padded to one size for
    the all-gather), on ``local``'s device."""
    group = axis(mesh, name)[2]
    dim = dim % local.ndim
    n = torch.tensor([local.shape[dim]], dtype=torch.int64,
                     device=local.device)
    counts = [int(c) for c in all_gather(n, group)]
    most = max(counts)
    if local.shape[dim] < most:         # blocks of one size for the gather
        shape = list(local.shape)
        shape[dim] = most - local.shape[dim]
        local = torch.cat([local, local.new_zeros(shape)], dim=dim)
    parts = all_gather(local, group)
    return torch.cat([p.narrow(dim, 0, c) for p, c in zip(parts, counts)],
                     dim=dim)


def _data_block(frames: torch.Tensor, mesh) -> torch.Tensor:
    n_d, i_d, _ = axis(mesh, DATA)
    if frames.ndim != 3 or frames.shape[0] % n_d:
        raise ValueError(f"frames {tuple(frames.shape)} must be (B, H, W) "
                         f"with B divisible by the {n_d} data shards")
    b = frames.shape[0] // n_d
    return frames[i_d * b:(i_d + 1) * b]


def shard_rows(frames: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's block of a whole batch: (B, H, W) -> (B / n_data, rows
    of its block, W)."""
    return _block_along(_data_block(frames, mesh), ROWS, mesh,
                        -2).contiguous()


def gather_rows(local: torch.Tensor, mesh) -> torch.Tensor:
    """The whole batch from every rank's block (``shard_rows``' inverse),
    on every rank, on ``local``'s device."""
    out = _gather_along(local, ROWS, mesh, -2)
    return torch.cat(all_gather(out, axis(mesh, DATA)[2]), dim=0)


def plane_block(whole: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's (rows, cols) block of whole (..., H, W) planes on a
    ("data", "rows", "cols") mesh (``row_block`` on each axis)."""
    return _block_along(_block_along(whole, ROWS, mesh, -2), COLS, mesh,
                        -1).contiguous()


def shard_blocks(frames: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's 2-D block of a whole batch on a ("data", "rows",
    "cols") mesh: (B, H, W) -> (B / n_data, rows of its block, columns of
    its block)."""
    return plane_block(_data_block(frames, mesh), mesh)


def gather_blocks(local: torch.Tensor, mesh) -> torch.Tensor:
    """The whole batch from every rank's 2-D block (``shard_blocks``'
    inverse), on every rank, on ``local``'s device."""
    planes = _gather_along(_gather_along(local, COLS, mesh, -1), ROWS, mesh,
                           -2)
    return torch.cat(all_gather(planes, axis(mesh, DATA)[2]), dim=0)


# ---------------------------------------------------------------------------
# rank processes
# ---------------------------------------------------------------------------


def free_port() -> int:
    """A TCP port on localhost that no socket holds now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, addr: str, device: str, backend: str,
               threads: Optional[int], timeout: float, tasks, results) -> None:
    """A rank: join the process group, then run each task (fn, mesh
    shape, args) as ``fn(mesh, *args)`` until a None arrives."""
    global _DEVICE
    try:
        if threads:
            torch.set_num_threads(threads)
        if device == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"rank {rank}: no CUDA device")
            _DEVICE = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(_DEVICE)
        else:
            _DEVICE = torch.device("cpu")
        # NCCL binds each rank to its card; gloo ranks may share one
        dist.init_process_group(
            backend, init_method=addr, world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout),
            device_id=_DEVICE if backend == "nccl" else None)
    except Exception:
        results.put((rank, False, traceback.format_exc()))
        return
    meshes = {}
    try:
        while True:
            task = tasks.get()
            if task is None:
                break
            fn, shape, args = task
            try:
                if shape not in meshes:
                    meshes[shape] = make_mesh(shape, backend)
                results.put((rank, True, fn(meshes[shape], *args)))
            except Exception:
                results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class RankPool:
    """``world`` rank processes on this host, each in one process group of
    ``backend`` ('nccl' or 'gloo', the caller's choice) on ``device``
    ('cuda': rank r on ``cuda:(r % device_count)``; 'cpu').

    ``run(fn, mesh_shape, *args)`` calls ``fn(mesh, *args)`` on every rank
    (``fn`` a module-level function, ``args`` picklable) and returns the
    ranks' results in rank order; a rank that raises, dies or outlasts
    ``timeout`` seconds ends the pool and raises RuntimeError with its
    traceback.  ``threads`` sets each rank's torch threads.  Use it as a
    context manager, or call ``close``.
    """

    def __init__(self, world: int, *, backend: str, device: str = "cuda",
                 threads: Optional[int] = None, timeout: float = 900.0):
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got "
                             f"{backend!r}")
        if device not in DEVICES:
            raise ValueError(f"device must be one of {DEVICES}, got "
                             f"{device!r}")
        if backend == "nccl" and device != "cuda":
            raise ValueError("the NCCL backend needs device='cuda'")
        if device == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' and no CUDA device is "
                               "available: pass device='cpu' and "
                               "backend='gloo' to run the ranks on the CPU")
        self.world, self.timeout = int(world), float(timeout)
        ctx = multiprocessing.get_context("spawn")
        self._tasks = [ctx.Queue() for _ in range(self.world)]
        self._results = ctx.Queue()
        addr = f"tcp://localhost:{free_port()}"
        self._procs = [
            ctx.Process(target=_rank_main, daemon=True, args=(
                r, self.world, addr, device, backend, threads, self.timeout,
                self._tasks[r], self._results))
            for r in range(self.world)]
        for p in self._procs:
            p.start()
        self._open = True

    def run(self, fn: Callable, mesh_shape: Sequence[int], *args) -> list:
        if not self._open:
            raise RuntimeError("the rank pool is closed")
        shape = tuple(int(n) for n in mesh_shape)
        if math.prod(shape) != self.world:
            raise ValueError(f"mesh {shape} does not cover the pool's "
                             f"{self.world} ranks")
        for q in self._tasks:
            q.put((fn, shape, args))
        out: list = [None] * self.world
        got, deadline = 0, time.monotonic() + self.timeout
        while got < self.world:
            try:
                rank, ok, res = self._results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(self._procs)
                        if not p.is_alive()]
                if dead or time.monotonic() > deadline:
                    self.close()
                    raise RuntimeError(
                        f"{fn.__name__} on mesh {shape}: ranks {dead} died"
                        if dead else f"{fn.__name__} on mesh {shape}: no "
                        f"result within {self.timeout:.0f} s")
                continue
            if not ok:
                self.close()
                raise RuntimeError(f"{fn.__name__} on mesh {shape}: rank "
                                   f"{rank} failed:\n{res}")
            out[rank] = res
            got += 1
        return out

    def close(self) -> None:
        """Stop every rank (a rank that does not stop is terminated)."""
        if not self._open:
            return
        self._open = False
        for q in self._tasks:
            q.put(None)
        # drain results nobody will read, so no rank blocks on its queue
        deadline = time.monotonic() + 10.0
        while (any(p.is_alive() for p in self._procs)
               and time.monotonic() < deadline):
            try:
                self._results.get(timeout=0.1)
            except queue.Empty:
                pass
        for p in self._procs:
            p.join(timeout=1)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join()

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def run_spmd(fn: Callable, mesh_shape: Sequence[int], *, backend: str,
             device: str = "cuda", args: tuple = (),
             threads: Optional[int] = None, timeout: float = 900.0) -> list:
    """Start ``prod(mesh_shape)`` ranks, call ``fn(mesh, *args)`` on each
    and return each rank's result, in rank order (``RankPool``)."""
    with RankPool(math.prod(mesh_shape), backend=backend, device=device,
                  threads=threads, timeout=timeout) as pool:
        return pool.run(fn, mesh_shape, *args)
