"""Structured logging, timing, and profiler hooks.

Counterpart of ``aainterp/utils/log.py``.  The reference's observability
is cout banners + a wall-clock timer (Source.cpp:59-75, 1559-1581).
Here: structured JSON records, device-honest timing (the clock stops after
the card has finished the work queued on it, the counterpart of JAX's
``block_until_ready``) and ``torch.profiler`` trace capture.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import tempfile
import time
from typing import Any, Dict, Optional

import torch

logger = logging.getLogger("aainterp")


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
    trace format; open it in Perfetto or chrome://tracing).  ``log_dir``
    defaults to ``aainterp_trace`` in the temporary directory."""
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
