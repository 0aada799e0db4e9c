"""Streaming executor: sustained host -> device -> host resampling.

Counterpart of ``aainterp/pipeline.py``.  The reference program's main()
is a strictly serial loop — read a CSV, compute, write, repeat
(Source.cpp:1216-1320) — so its end-to-end rate is the SUM of I/O and
compute time.  On the card the same workload is a pipelining problem:
the host-to-device copy of batch n+1 and the device-to-host copy of
batch n-1 should hide under the compute of batch n, and the host's own
work (decoding, copying frames in) under all three.  The JAX package
gets this from asynchronous dispatch; here it is explicit CUDA work:

* a ring of ``depth`` slots, each a pinned host input buffer of one
  batch, its device copy, and a pinned host output buffer;
* frames are copied by the host straight into the slot's pinned buffer
  (no staging stack); a partial last batch is zero-padded to the batch
  shape, and only its valid frames are yielded;
* the host-to-device copy runs on a copy stream, the step on a compute
  stream that waits for the copy's event, and the device-to-host copy
  (``non_blocking``, into pinned memory) on a third stream that waits
  for the compute's event; the step's output is marked used by that
  stream (``record_stream``), so the allocator does not hand its memory
  to the next batch before the copy has read it;
* at most ``depth`` batches are in flight; the host waits for the OLDEST
  batch's last event only, copies its valid frames out of the slot (the
  frames it yields never alias the ring, so a consumer may keep or
  modify them) and only then refills that slot.

With ``device='cpu'`` the same loop runs with no streams: the step runs
on the slot in place.  That is a choice of the caller, not a fallback:
on a CUDA target with no CUDA device the call raises
(``utils.device.target``).

Frames are numpy arrays or CPU tensors (a tensor may be bfloat16, which
numpy lacks); results are CPU tensors, in input order.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import (Callable, Iterable, Iterator, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from .ops import weights as weights_ops
from .ops.overlap1d import Band1D
from .utils.device import Device, target

OperatorLike = Union["weights_ops.SeparableOperator",
                     "weights_ops.EllOperator",
                     Tuple[Band1D, Band1D],
                     Callable]

# band-route impls that send an EllOperator to apply_operator's 'auto'
# (the JAX package maps its 'auto', 'pallas' and 'xla' so)
_ELL_AUTO_IMPLS = ("auto", "kernel", "banded")


def _make_step(op: OperatorLike, impl: str, weight_dtype, precision: str):
    """One-batch apply fn for ``op``; (..., H, W) in, (..., Hd, Wd) out.

    Uses the same routing as the public applies: a ``(Band1D, Band1D)``
    pair or a SeparableOperator (its quadrant folded into the bands,
    quadrants 1/3 transposing the small output) rides
    ``regrid.apply_band_operators`` (u8 in -> u8 out on every route; on
    the card the 2-D kernel, one launch per batch); an EllOperator rides
    ``api.apply_operator`` with uint8 cast to float32 (the rotated routes
    are float-out; on the card the fused shear and the contraction).  A
    callable is used as given.
    """
    from .regrid import apply_band_operators

    if not isinstance(op, (weights_ops.SeparableOperator,
                           weights_ops.EllOperator, tuple)) and callable(op):
        return op  # user-supplied step: any batch -> batch fn
    if isinstance(op, tuple):
        by, bx = op
        if not (isinstance(by, Band1D) and isinstance(bx, Band1D)):
            raise TypeError(
                "operator tuple must be a (Band1D, Band1D) pair, got "
                f"({type(by).__name__}, {type(bx).__name__})")
        return lambda x: apply_band_operators(x, by, bx, impl=impl,
                                              precision=precision)
    if isinstance(op, weights_ops.SeparableOperator):
        yb, xb, out_t = weights_ops.fold_quadrant_separable(op)

        def step(x):
            out = apply_band_operators(x, yb, xb, impl=impl,
                                       precision=precision)
            # quadrants 1/3 transpose the SMALL dst-side output
            return out.transpose(-1, -2) if out_t else out

        return step
    if isinstance(op, weights_ops.EllOperator):
        from .api import apply_operator

        ell_impl = "auto" if impl in _ELL_AUTO_IMPLS else impl

        def step(x):
            if x.dtype == torch.uint8:
                x = x.to(torch.float32)
            return apply_operator(op, x, weight_dtype=weight_dtype,
                                  impl=ell_impl)

        return step
    raise TypeError(f"unknown operator type {type(op)!r}")


def stream_apply(
    op: OperatorLike,
    frames: Iterable,
    *,
    batch: int = 8,
    depth: int = 2,
    impl: str = "auto",
    weight_dtype: torch.dtype = torch.float32,
    precision: str = "auto",
    device: Device = None,
) -> Iterator[torch.Tensor]:
    """Stream host frames through ``op``; yields one CPU tensor per frame.

    Parameters
    ----------
    op : a prebuilt Operator (``build_operator``), a raw ``(Band1D,
        Band1D)`` pair (``compose_separable`` output, a regrid operator,
        ``resize_bands``), or a callable batch -> batch step.
    frames : iterable of equally shaped host frames (numpy arrays or CPU
        tensors), each ``(H, W)`` or ``(..., H, W)`` (e.g. ``(C, H, W)``
        planar RGB).  uint8 frames keep the u8 in -> u8 out contract on
        the separable and banded routes.
    batch : frames per device batch (the tail is zero-padded to the same
        shape and trimmed on yield).
    depth : batches in flight, and the ring's number of slots.
        ``depth=1`` is the reference's serial read/compute/write loop;
        ``depth>=2`` overlaps the host's filling of a batch and the
        copies and compute of the batches before it.
    impl / precision : forwarded to the underlying apply
        (``regrid.apply_band_operators`` / ``api.apply_operator``);
        weight_dtype applies to the EllOperator route only.
    device : where the steps run (default ``cuda``; module docstring).

    Results come back in input order; the output dtype follows the
    underlying route (uint8 for uint8 separable input, else the apply's
    float dtype).  Validation (batch, depth, operator, device) is eager;
    the stream itself starts lazily.
    """
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    step = _make_step(op, impl, weight_dtype, precision)
    dev = target(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"stream_apply runs on cuda or cpu, not {dev}")
    return _stream_run(step, frames, batch, depth, dev)


def _torch_dtype(f) -> torch.dtype:
    if isinstance(f, torch.Tensor):
        return f.dtype
    return torch.from_numpy(np.empty(0, f.dtype)).dtype


class _Slot:
    """One ring slot: pinned host input, its device copy, pinned host
    output, the events that order them and the batch's valid count."""

    def __init__(self, shape, dtype, batch: int, device: torch.device):
        self.cuda = device.type == "cuda"
        self.host_in = torch.empty((batch,) + tuple(shape), dtype=dtype,
                                   pin_memory=self.cuda)
        self.np_in = (None if dtype == torch.bfloat16
                      else self.host_in.numpy())
        self.dev_in = (torch.empty_like(self.host_in, device=device)
                       if self.cuda else None)
        self.host_out: Optional[torch.Tensor] = None
        self.h2d = torch.cuda.Event() if self.cuda else None
        self.done = torch.cuda.Event() if self.cuda else None
        self.n = 0

    def put(self, i: int, f) -> None:
        """Copy frame ``f`` into row ``i`` of the pinned input."""
        if isinstance(f, torch.Tensor):
            self.host_in[i].copy_(f)
        else:
            np.copyto(self.np_in[i], f, casting="no")


def _stream_run(step, frames, batch: int, depth: int, device: torch.device):
    cuda = device.type == "cuda"
    if cuda:
        copy_s = torch.cuda.Stream(device)
        comp_s = torch.cuda.Stream(device)
        d2h_s = torch.cuda.Stream(device)
        # work queued before the stream (tables from prefetch_operator)
        # is visible to it
        here = torch.cuda.current_stream(device)
        copy_s.wait_stream(here)
        comp_s.wait_stream(here)
    slots: list = []
    inflight: deque = deque()          # slots in submission order
    shape = dtype = None
    k = fill = 0                       # batches submitted; frames in slot

    def _submit(slot: _Slot, n: int) -> None:
        if n < batch:                  # zero-pad the tail to the batch shape
            slot.host_in[n:].zero_()
        slot.n = n
        if not cuda:
            slot.host_out = step(slot.host_in)
            inflight.append(slot)
            return
        with torch.cuda.stream(copy_s):
            slot.dev_in.copy_(slot.host_in, non_blocking=True)
            slot.h2d.record(copy_s)
        with torch.cuda.stream(comp_s):
            comp_s.wait_event(slot.h2d)
            out = step(slot.dev_in).contiguous()
            computed = torch.cuda.Event()
            computed.record(comp_s)
        with torch.cuda.stream(d2h_s):
            d2h_s.wait_event(computed)
            if (slot.host_out is None or slot.host_out.shape != out.shape
                    or slot.host_out.dtype != out.dtype):
                slot.host_out = torch.empty(out.shape, dtype=out.dtype,
                                            pin_memory=True)
            slot.host_out.copy_(out, non_blocking=True)
            out.record_stream(d2h_s)
            slot.done.record(d2h_s)
        inflight.append(slot)

    def _drain_oldest():
        slot = inflight.popleft()
        if cuda:
            slot.done.synchronize()    # the OLDEST batch's last copy only
        host = slot.host_out[:slot.n].clone()   # never alias the ring
        for i in range(slot.n):
            yield host[i]

    try:
        for f in frames:
            if not isinstance(f, torch.Tensor):
                f = np.asarray(f)
            if shape is None:
                shape, dtype = tuple(f.shape), _torch_dtype(f)
                if len(shape) < 2:
                    raise ValueError(
                        f"frames must be at least 2-D (H, W), got shape "
                        f"{shape}")
            elif tuple(f.shape) != shape or _torch_dtype(f) != dtype:
                raise ValueError(
                    f"frame shape/dtype changed mid-stream: expected "
                    f"{shape}/{dtype}, got {tuple(f.shape)}/"
                    f"{_torch_dtype(f)}")
            if len(slots) <= k % depth:
                slots.append(_Slot(shape, dtype, batch, device))
            slot = slots[k % depth]
            slot.put(fill, f)
            fill += 1
            if fill == batch:
                _submit(slot, batch)
                k, fill = k + 1, 0
                if len(inflight) >= depth:  # at most `depth` in flight;
                    yield from _drain_oldest()  # depth=1 is truly serial
        if fill:
            _submit(slots[k % depth], fill)
        while inflight:
            yield from _drain_oldest()
    finally:
        # a consumer that stops early: let the copies in flight land
        # before the ring's buffers are freed
        for slot in inflight:
            if slot.done is not None:
                slot.done.synchronize()


# ----------------------------------------------------------------------
# File streaming: threaded prefetch loader + end-to-end serving loop
# ----------------------------------------------------------------------


def _default_reader(path: str) -> np.ndarray:
    """CSV via the reference-semantics reader — the buffered native C++
    decoder when it builds (its calls drop the GIL, so decodes overlap
    device work; Source.cpp:1450-1495 semantics) — and grayscale raster
    load otherwise."""
    from . import native
    from .utils import io as iom

    if path.lower().endswith(".csv"):
        if native.available():
            return native.csv_read_native(path)
        return iom.csv_read(path)
    return iom.image_read(path, as_gray=True)


def iter_files(paths: Sequence[str],
               reader: Optional[Callable[[str], np.ndarray]] = None,
               *, threads: int = 4, prefetch: int = 8
               ) -> Iterator[np.ndarray]:
    """Ordered prefetching file loader: up to ``prefetch`` reads in
    flight on a thread pool, yielded strictly in input order.

    The default reader is ``_default_reader`` (native CSV when built).
    Read errors surface on the yield of the failing file, in order.
    """
    if reader is None:
        reader = _default_reader
    paths = list(paths)
    with ThreadPoolExecutor(max_workers=max(1, threads)) as ex:
        pending = deque()
        i = 0
        while i < len(paths) or pending:
            while i < len(paths) and len(pending) < max(1, prefetch):
                pending.append(ex.submit(reader, paths[i]))
                i += 1
            yield pending.popleft().result()


def stream_apply_files(
    op: OperatorLike,
    in_paths: Sequence[str],
    out_paths: Optional[Sequence[str]] = None,
    *,
    batch: int = 8,
    depth: int = 2,
    threads: int = 4,
    sig_digits: int = 6,
    impl: str = "auto",
    weight_dtype: torch.dtype = torch.float32,
    precision: str = "auto",
    device: Device = None,
) -> list:
    """End-to-end file serving loop: read -> apply -> write, pipelined.

    The production counterpart of the reference's serial main()
    (Source.cpp:1216-1320, one file per process invocation): reads
    prefetch on a thread pool, ``stream_apply`` keeps ``depth`` batches
    in flight on ``device``, and CSV writes run on the pool too, so
    steady state overlaps decode, H2D, compute, D2H, and encode.  Outputs
    default to the reference's ``<base>_mod.csv`` naming next to each
    input; ``sig_digits=6`` matches the reference's stream precision
    (Source.cpp:1508).  Returns the output paths (all writes joined).
    """
    from .utils import io as iom

    in_paths = list(in_paths)
    if out_paths is None:
        out_paths = [iom.default_output_path(p) for p in in_paths]
    else:
        out_paths = list(out_paths)
        if len(out_paths) != len(in_paths):
            raise ValueError(
                f"{len(in_paths)} inputs but {len(out_paths)} outputs")
    # the apply computes in f32 (the 6-significant-digit CSV output loses
    # nothing), as the JAX package's does without x64
    frames = (f.astype(np.float32, copy=False)
              for f in iter_files(in_paths, threads=threads))
    with ThreadPoolExecutor(max_workers=max(1, threads)) as ex:
        # bound the pending-write queue: each future pins its output
        # until written, so an unbounded list would grow host memory
        # without limit when the disk is slower than the device
        writes: deque = deque()
        for out, path in zip(
            stream_apply(op, frames, batch=batch, depth=depth, impl=impl,
                         weight_dtype=weight_dtype, precision=precision,
                         device=device),
            out_paths,
        ):
            writes.append(ex.submit(iom.csv_write, path, out, sig_digits))
            while len(writes) > 2 * max(1, threads):
                writes.popleft().result()  # surface write errors, in order
        for w in writes:
            w.result()
    return out_paths
