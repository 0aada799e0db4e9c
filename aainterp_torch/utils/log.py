"""Structured logging, timing, and profiler hooks.

Counterpart of ``aainterp/utils/log.py``.  The reference's observability
is cout banners + a wall-clock timer (Source.cpp:59-75, 1559-1581).
Here: structured JSON records, device-honest timing (the clock stops after
the card has finished the work queued on it, the counterpart of JAX's
``block_until_ready``), ``torch.profiler`` trace capture, and the
program's own spans.

Spans: ``span(name)`` marks a stretch of host work in whatever
``torch.profiler`` is recording (``profile_trace``, or any profiler a
caller runs), on the same clock as the card's kernels; with no profiler
recording it costs a flag read.  The call path marks ``aa.interpolate``
(the body of ``api.area_average_interpolate``), ``aa.spec`` (the input
and its grid), ``aa.route`` (the route choice and its cached lookups,
ending when the route's callable is in hand) and ``aa.launch.<kernel>``
(each call into a CUDA library, ``<kernel>`` as the wrappers' ``LAUNCHES``
name it).  The cold paths, which run once per geometry, take
``build_span``, which also counts each build and its host seconds in
``BUILDS`` with or without a profiler: ``build.operator``,
``build.band_plan``, ``build.shear_plan``, ``build.shear3_plan``,
``build.tiles``, ``build.upload``, ``build.plan_save``,
``build.plan_load`` and a table's hash, ``build.digest`` (``utils.digest``).
A plan cache's miss (``utils.lru``) is marked too, ``cache.<name>.miss``.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import tempfile
import time
from typing import Any, Dict, List, Optional

import torch
from torch.autograd import profiler as _profiler

logger = logging.getLogger("aainterp")

# [count, host seconds] of each cold path, by span name (build_span)
BUILDS: Dict[str, List[float]] = {}


class _NoSpan:
    """The context ``span`` gives where no profiler is recording."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_NO_SPAN = _NoSpan()


def span(name: str):
    """``torch.profiler.record_function(name)`` where a profiler is
    recording, else one shared no-op context (the flag is read at each
    call: an unguarded ``record_function`` costs microseconds a span)."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


def mark(name: str) -> None:
    """A span of no length, where a profiler is recording."""
    if _profiler._is_profiler_enabled:
        with torch.profiler.record_function(name):
            pass


@contextlib.contextmanager
def build_span(name: str):
    """``span(name)`` around a cold path that also adds one to the count
    and its host seconds to the seconds of ``BUILDS[name]``, profiler or
    not (a build that raises counts too: its time was spent)."""
    t0 = time.perf_counter()
    try:
        with span(name):
            yield
    finally:
        ent = BUILDS.setdefault(name, [0, 0.0])
        ent[0] += 1
        ent[1] += time.perf_counter() - t0


def log_record(event: str, **fields: Any) -> Dict[str, Any]:
    rec = {"event": event, **fields}
    logger.info(json.dumps(rec, default=str))
    return rec


def synchronize() -> None:
    """Wait for all work queued on the current CUDA device; nothing where
    CUDA was never initialised in this process (no work can be queued)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def device_timer(label: str, result_holder: Optional[dict] = None):
    """Wall-clock timer that prints the reference's timing line format
    (Source.cpp:1581).  CUDA is synchronised before the clock stops, so
    the time includes the device work queued inside the block."""
    t0 = time.perf_counter()
    yield
    synchronize()
    ms = (time.perf_counter() - t0) * 1000.0
    log_record("timing", label=label, ms=ms)
    print(f"Calculation time : {ms:g} [ms]")
    if result_holder is not None:
        result_holder[label] = ms


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str] = None):
    """Capture a ``torch.profiler`` trace of the block (CPU, and CUDA
    where it is available) and write it to ``log_dir/trace.json`` (Chrome
    trace format; open it in Perfetto or chrome://tracing).  The trace
    carries the program's own spans (``aa.*``, ``build.*``; module
    docstring) beside the card's kernels.  ``log_dir`` defaults to
    ``aainterp_trace`` in the temporary directory."""
    from torch.profiler import ProfilerActivity, profile

    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "aainterp_trace")
    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield log_dir
        synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def banner(fn_name: str, src_resolution, dst_resolution, src_isocenter,
           rotation_angle) -> str:
    """The reference's parameter banner, reproduced byte-for-byte.

    The reference prints this from each driver (Source.cpp:59-75 exact,
    588-604 fast): a 58-char box, values at ``setprecision(10)`` (~ %.10g)
    with ``setw(9)`` fields, unit labels right-justified by ``setw(20)``.
    Returns the banner string (callers print it)."""
    def g(v):
        return f"{float(v):.10g}"

    dpi = " [pixel/mm or dpi] *"
    lines = [
        "*" * 58,
        f"* {fn_name}".ljust(57) + "*",
        "* Input parameters".ljust(57) + "*",
        "*".ljust(57) + "*",
        f"* srcResolution : {g(src_resolution):>9}, {g(src_resolution):>9}"
        + dpi.rjust(20),
        f"* dstResolution : {g(dst_resolution):>9}, {g(dst_resolution):>9}"
        + dpi.rjust(20),
        f"* srcIsocenter  : {g(src_isocenter[0]):>9}, {g(src_isocenter[1]):>9}"
        + " [pixels] *".rjust(20),
        f"* rotationAngle : {g(rotation_angle):>20}" + " [degrees] *".rjust(20),
        "*" * 58,
    ]
    return "\n".join(lines)
