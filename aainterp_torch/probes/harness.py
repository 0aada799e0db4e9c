"""The probes' timer: the counterpart of ``bench.timed_scan`` as far as
the probes use it.

``measure(fn, inputs, warm)`` warms ``fn`` up on ``warm`` (one input set,
distinct from the measured ones: plans, table uploads, lazy builds), then
times it on the K distinct ``inputs``.  On the card, one CUDA graph runs
``fn`` on each of the K inputs in turn, every output written to memory of
its own and kept; the graph is replayed ``reps`` times between two CUDA
events, and the result is the best of ``turns`` turns in ms per call (one
call = one batch).  No host work between calls can show up in it.  With
each input larger than the 50 MB L2 cache, no call finds its input there.

On the CPU (the plain versions, ``device="cpu"``) the same loop is timed
on the host's clock and the result says so (``clock="host"``): it is not
a device time.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class Timing:
    """ms per call, the clock it was read on and the device it ran on."""

    ms: float
    clock: str        # "cuda_events" (graph replays) or "host"
    device: str       # torch.cuda.get_device_name, or "cpu"


def _device(x) -> torch.device:
    while isinstance(x, (tuple, list)):
        x = x[0]
    return x.device


def _call(fn, x):
    return fn(*x) if isinstance(x, tuple) else fn(x)


def graph_ms(fn: Callable, inputs: Sequence, warm: Sequence, reps: int = 10,
             turns: int = 2) -> float:
    """Device ms per call of ``fn`` over the distinct CUDA ``inputs``,
    best of ``turns`` turns of ``reps`` replays of one CUDA graph; warmed
    up on ``warm`` first.  A tuple input is passed as arguments."""
    if _device(inputs[0]).type != "cuda":
        raise RuntimeError("graph_ms times CUDA tensors only; a CPU run has "
                           "no device time")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for x in warm:
            _call(fn, x)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [_call(fn, x) for x in inputs]   # noqa: F841 (kept alive)
    graph.replay()                               # the first replay uploads it
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(turns):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / (reps * len(inputs)))
    del graph, outs
    return best


def host_ms(fn: Callable, inputs: Sequence, warm: Sequence,
            turns: int = 2) -> float:
    """Host ms per call of ``fn`` over ``inputs`` (after ``warm``), best
    of ``turns`` turns; for CPU tensors."""
    for x in warm:
        _call(fn, x)
    best = float("inf")
    for _ in range(turns):
        t0 = time.perf_counter()
        for x in inputs:
            _call(fn, x)
        best = min(best, (time.perf_counter() - t0) * 1e3 / len(inputs))
    return best


def measure(fn: Callable, inputs: Sequence, warm: Sequence, reps: int = 10,
            turns: int = 2) -> Timing:
    """``graph_ms`` on the card, ``host_ms`` on the CPU, with the clock
    and device named."""
    dev = _device(inputs[0])
    if dev.type == "cuda":
        return Timing(graph_ms(fn, inputs, warm, reps, turns), "cuda_events",
                      torch.cuda.get_device_name(dev))
    return Timing(host_ms(fn, inputs, warm, turns), "host", str(dev))


def seeded(device: torch.device, seed: int) -> torch.Generator:
    """A generator on ``device`` (inputs are made where they are used)."""
    return torch.Generator(device=device).manual_seed(seed)


def uniform(shape, dtype: torch.dtype, gen: torch.Generator,
            device: torch.device) -> torch.Tensor:
    """Seeded values in [0, 1) (u8: 0..255) of ``dtype`` on ``device``."""
    x = torch.rand(shape, generator=gen, device=device)
    if dtype == torch.uint8:
        return (x * 255.0).round().to(torch.uint8)
    return x.to(dtype)
