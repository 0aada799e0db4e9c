"""One run of one cell: set-up, the window, the check.

Set-up (its seconds are ``setup_s``): the program's libraries, the
frames from the seed, the operator through the program's own API as a
user builds it, the first call (plans, built anew in every run: the
program's plan cache lies in the run's own scratch directory), then the
warm-up over every batch of the pool and a settle under the load.  The
window: a closed loop, one client, one batch in flight: pick the next
batch of the pool, call the entry that the traffic file names
(``perfbench/entries/<entry>.py``) on it, synchronise, and keep the
output on the device.  Each call's host spans (pick, call, synchronise) are
kept in memory.  With ``trace``, the profiler runs over the window's
last stretch and the spans are marked in its trace.  The check, once
the window has closed and the peak memory has been read: a sample of
the window's calls, drawn from the seed, against the plain reference.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import os
import random
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from . import check, count, inputs, spec
from . import trace as trace_mod
from .reference import Reference

# the stretch of a traced window that the profiler records, seconds
TRACE_S = 2.0
# warm-up: passes over the pool, then seconds of calls under the load
# (a window straight after set-up ran 3-4 % slow on the card)
WARMUP_ROUNDS = 2
SETTLE_S = 2.0
# the window's calls that the check compares, drawn from the seed
SAMPLE_CALLS = 3
FORBIDDEN = ("jax", "jaxlib", "flax", "aainterp")


def process_age_s() -> float:
    """Seconds since this process started (0 where /proc cannot say)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Run:
    """What a run measured; the metric readers read it (``ctx``)."""

    device: str
    counts: dict
    peak: Optional[dict]
    setup: Dict[str, float] = dataclasses.field(default_factory=dict)
    setup_s: float = 0.0
    window_s: float = 0.0
    batches: int = 0
    batch_ms: List[float] = dataclasses.field(default_factory=list)
    enqueue_ms: List[float] = dataclasses.field(default_factory=list)
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    trace: Optional[dict] = None
    trace_path: Optional[str] = None
    memory_peak_bytes: int = 0
    numbers: Dict[str, float] = dataclasses.field(default_factory=dict)
    checks: Dict[str, dict] = dataclasses.field(default_factory=dict)
    correct: bool = False
    compared: int = 0


class Session:
    """Set-up of one cell on one device from one seed."""

    def __init__(self, wl: spec.Workload, seed: int, device: str = "cuda",
                 t_start: Optional[float] = None, settle_s: float = SETTLE_S):
        t_start = time.perf_counter() if t_start is None else t_start
        self.wl, self.seed, self.device = wl, int(seed), device
        self.entry = spec.entry(wl.traffic["entry"])
        self.setup: Dict[str, float] = {}
        on_cuda = torch.device(device).type == "cuda"
        if on_cuda:
            t0 = time.perf_counter()
            self.entry.build()
            self.setup["libraries_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.pool = inputs.pool(wl.traffic, wl.config["src_shape"],
                                self.seed, device)
        _sync(device)
        self.setup["inputs_s"] = time.perf_counter() - t0
        if on_cuda:
            # the peak is the program's: from its operator on, not the
            # generator's temporaries
            torch.cuda.reset_peak_memory_stats(device)
        self.call, parts = self.entry.make(wl.config, wl.traffic)
        self.setup.update(parts)
        # the first call builds the plans; a second call on the same batch
        # stands for its device time and enqueue, which are not geometry
        t0 = time.perf_counter()
        out = self.call(self.pool[0])
        _sync(device)
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.call(self.pool[0])
        _sync(device)
        again = time.perf_counter() - t0
        self.setup["first_call_s"] = first
        self.setup["second_call_s"] = again
        self.setup["geometry_s"] = parts["build_operator_s"] + first - again
        self.out_dtype = out.dtype
        want = wl.traffic["out_dtype"]
        if on_cuda and str(out.dtype) != f"torch.{want}":
            raise RuntimeError(f"the call gives {out.dtype}; the traffic "
                               f"file states {want}")
        del out
        # every batch of the pool, then calls until the card's clocks have
        # settled under the load
        t0 = time.perf_counter()
        for i in range(WARMUP_ROUNDS * len(self.pool)):
            self.call(self.pool[i % len(self.pool)])
        _sync(device)
        settle = t0 + settle_s
        i = 0
        while time.perf_counter() < settle:
            self.call(self.pool[i % len(self.pool)])
            _sync(device)
            i += 1
        self.setup["warmup_s"] = time.perf_counter() - t0
        self.setup_s = time.perf_counter() - t_start


def window(sess: Session, run: Run, seconds: float, trace: bool,
           sample_calls: int = SAMPLE_CALLS) -> List[tuple]:
    """The closed loop; returns ``sample_calls`` of its calls (call
    index, pool index, output), drawn from the seed."""
    device, pool, call = sess.device, sess.pool, sess.call
    k = sample_calls
    rng = random.Random(sess.seed)
    kept: List[tuple] = []
    batch_ms, enq_ms = run.batch_ms, run.enqueue_ms
    prof = None
    on_cuda = torch.device(device).type == "cuda"
    c0 = sess.entry.counters()
    gc.collect()
    gc.freeze()
    n = 0
    t_start = time.perf_counter()
    # a traced run ends with a traced stretch, timed from when the
    # profiler has started
    trace_s = min(TRACE_S, seconds / 2.0) if trace else 0.0
    deadline = t_start + seconds - trace_s
    t3 = t_start
    while True:
        if trace and prof is None and t3 >= deadline:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if on_cuda:
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.start()
            deadline = time.perf_counter() + trace_s
        if prof is None:
            x = pool[n % len(pool)]
            t1 = time.perf_counter()
            out = call(x)
            t2 = time.perf_counter()
            _sync(device)
            t3 = time.perf_counter()
            enq_ms.append((t2 - t1) * 1e3)
        else:
            rf = torch.profiler.record_function
            with rf("pb.pick"):
                x = pool[n % len(pool)]
            t1 = time.perf_counter()
            with rf("pb.call"):
                out = call(x)
            with rf("pb.sync"):
                _sync(device)
            t3 = time.perf_counter()
        batch_ms.append((t3 - t1) * 1e3)
        # reservoir sample of the window's calls, from the seed
        if n < k:
            kept.append((n, n % len(pool), out))
        else:
            j = rng.randrange(n + 1)
            if j < k:
                kept[j] = (n, n % len(pool), out)
        del out
        n += 1
        if t3 >= deadline and (prof is not None or not trace):
            break
    run.window_s = t3 - t_start
    run.batches = n
    gc.unfreeze()
    c1 = sess.entry.counters()
    run.launches = {key: c1[key] - c0[key] for key in c1}
    if prof is not None:
        prof.stop()
        path = Path(tempfile.gettempdir()) / f"perfbench_{sess.wl.name}.json"
        prof.export_chrome_trace(str(path))
        run.trace_path = str(path)
        run.trace = trace_mod.summarise(trace_mod.load_events(path))
    return kept


def check_outputs(sess: Session, run: Run, kept: List[tuple],
                  ref: Optional[Reference] = None) -> None:
    """The sampled outputs against the reference, worked out again from
    the geometry and the same frames."""
    ref = ref or Reference(sess.wl.config, sess.wl.cell["reference"],
                           sess.device)
    by_batch: Dict[int, torch.Tensor] = {}
    nums: Dict[str, float] = {}
    total = 0
    for _, b, out in kept:
        if b not in by_batch:
            by_batch[b] = ref(sess.pool[b])
        r = by_batch[b]
        if tuple(out.shape) != tuple(r.shape):
            # an output of another shape is wrong everywhere
            got = {"excess_ulp": math.inf, "mismatch_share": 1.0,
                   "max_ulp": math.inf}
        else:
            got = check.numbers(out, r)
        nums = check.merge(nums, got, total, out.numel())
        total += out.numel()
    run.numbers = nums
    run.compared = len(kept)
    run.correct, run.checks = check.judge(nums, sess.wl.cell["limits"])


def execute(wl: spec.Workload, seed: int, seconds: float, trace: bool,
            device: str = "cuda", t_start: Optional[float] = None,
            setup_age_s: float = 0.0,
            setup_pre: Optional[Dict[str, float]] = None,
            settle_s: float = SETTLE_S,
            sample_calls: int = SAMPLE_CALLS) -> Run:
    """Set-up, window and check of one run, with the program's data
    caches in a scratch directory of the run's own under ``TMPDIR``."""
    entry = spec.entry(wl.traffic["entry"])
    with tempfile.TemporaryDirectory(prefix="perfbench_") as scratch, \
            entry.private_caches(Path(scratch)):
        return _execute(wl, seed, seconds, trace, device, t_start,
                        setup_age_s, setup_pre, settle_s, sample_calls)


def _execute(wl, seed, seconds, trace, device, t_start, setup_age_s,
             setup_pre, settle_s, sample_calls) -> Run:
    peaks = count.load_peaks(Path(__file__).with_name("peaks.json"))
    on_cuda = torch.device(device).type == "cuda"
    sess = Session(wl, seed, device, t_start, settle_s)
    name = torch.cuda.get_device_name(device) if on_cuda else "cpu"
    run = Run(device=name, counts=count.batch_counts(wl.config, wl.traffic),
              peak=peaks.get(name), setup={**(setup_pre or {}), **sess.setup},
              setup_s=sess.setup_s + setup_age_s)
    kept = window(sess, run, seconds, trace, sample_calls)
    if on_cuda:
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated(device))
    # the program's state goes before the reference runs
    keep = {b for _, b, _ in kept}
    sess.pool = [x if i in keep else None for i, x in enumerate(sess.pool)]
    sess.call = None
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    check_outputs(sess, run, kept)
    run.setup["check_s"] = time.perf_counter() - t0
    return run
