"""The program's own spans and build counters, as a traced run reads them.

``aainterp_torch`` marks its call path with ``torch.profiler`` spans
(``aainterp_torch/utils/log.py``): ``aa.interpolate`` (the body of
``api.area_average_interpolate``), inside it ``aa.spec`` (the input and
its grid), ``aa.route`` (the route choice and its cached lookups) and one
``aa.launch.<kernel>`` around each call into a CUDA library; a cold path
is a ``build.*`` span (a table's hash ``build.digest``), a plan cache's
miss a ``cache.<name>.miss`` mark.  They land in the trace the
harness writes of a traced window's last stretch (``Run.trace_path``),
beside its ``pb.*`` spans and the card's kernels, on the profiler's one
clock.  ``summary`` reads a trace once (memoised by path) into:

* ``calls``: per traced ``aa.interpolate``, host us of it (``us``), of
  its ``aa.spec`` plus ``aa.route`` (``route_us``), of its summed launch
  spans (``launch_us``) and of the rest (``wrapper_us``: the wrappers'
  checks, plan and table lookups, output allocation and autograd glue),
  and its count of launch spans (``launches``);
* ``pb_call_us``: the harness's ``pb.call`` spans, us each;
* ``rebuilds``: the ``build.*`` spans and ``cache.*.miss`` marks inside
  the traced window (first ``pb.call`` to last ``pb.sync``);
* ``idle_by_span``: the card's idle seconds in that window under each
  innermost ``aa.*`` or ``pb.*`` span ('loop' outside them all);
* ``clock``: for each kernel launched in the window, its start less the
  start of the runtime or driver call of the same ``correlation``: the
  least of them in us (and that kernel's and call's names), the kernels
  matched, how many start before their call, how many of their calls lie
  inside an ``aa.launch.*`` span, and the drift: the slope, us a second,
  of the least delta of each tenth of the window (the device's clock
  against the host's; 0 where kineto keeps them together).

A trace of a program that marks no ``aa.interpolate`` has no ``calls``,
and the readers of ``perfbench/metrics/`` return None, as they do on the
CPU.  ``builds`` reads the program's ``BUILDS`` (count and host seconds
of each ``build.*`` span, kept with or without a profiler).

    python3 -m perfbench.spans <trace.json>

prints the medians, the idle split and the clock check as one JSON line.
"""

from __future__ import annotations

import bisect
import json
import os
import statistics
import sys
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from perfbench.trace import DEVICE_CATS, _merge, load_events

LAUNCH = "aa.launch."
CHILDREN = ("aa.spec", "aa.route")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# the disk plan cache's spans, apart from the builds
DISK = ("build.plan_save", "build.plan_load")
_MEMO: Dict[tuple, dict] = {}

Span = Tuple[float, float, str]


def _is_mark(name: str) -> bool:
    return name.startswith("build.") or (name.startswith("cache.")
                                          and name.endswith(".miss"))


def _covered(a: float, b: float, parts: List[Tuple[float, float]]) -> float:
    """Length of [a, b] that the union of ``parts`` covers."""
    return sum(max(0.0, min(b, y) - max(a, x))
               for x, y in _merge([(x, y) for x, y in parts]))


def _calls(spans: List[Span]) -> List[dict]:
    roots = [s for s in spans if s[2] == "aa.interpolate"]
    kids = [s for s in spans
            if s[2] in CHILDREN or s[2].startswith(LAUNCH)]
    starts = [s[0] for s in kids]
    out = []
    for a, b, _ in roots:
        lo, hi = bisect.bisect_left(starts, a), bisect.bisect_right(starts, b)
        inner = kids[lo:hi]
        launches = [s for s in inner if s[2].startswith(LAUNCH)]
        out.append({
            "us": b - a,
            "route_us": _covered(a, b, [(x, y) for x, y, n in inner
                                        if n in CHILDREN]),
            "launch_us": _covered(a, b, [(x, y) for x, y, _ in launches]),
            "wrapper_us": (b - a) - _covered(a, b,
                                             [(x, y) for x, y, _ in inner]),
            "launches": len(launches),
        })
    return out


def _timeline(spans: List[Span], w0: float, w1: float) -> List[Span]:
    """[w0, w1] cut into pieces, each named by the innermost span over
    it ('loop' where none is); the spans nest, as one thread's do."""
    out: List[Span] = []
    stack: List[Tuple[float, str]] = []
    t = w0

    def close_until(x: float) -> None:
        nonlocal t
        while stack and stack[-1][0] <= x:
            end, name = stack.pop()
            if end > t:
                out.append((t, end, name))
                t = end

    for a, b, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        close_until(a)
        if a > t:
            out.append((t, a, stack[-1][1] if stack else "loop"))
            t = a
        # a child that outlasts its parent (clock jitter) ends with it
        stack.append((min(b, stack[-1][0]) if stack else b, name))
    close_until(float("inf"))
    if w1 > t:
        out.append((t, w1, "loop"))
    return [(max(a, w0), min(b, w1), n) for a, b, n in out
            if b > w0 and a < w1]


def _idle(events: List[dict], spans: List[Span], w0: float,
          w1: float) -> Dict[str, float]:
    dev = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
           for e in events if e.get("cat") in DEVICE_CATS]
    busy = _merge([(max(a, w0), min(b, w1)) for a, b in dev
                   if b > w0 and a < w1])
    gaps, edge = [], w0
    for a, b in busy + [[w1, w1]]:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    line = _timeline([s for s in spans if s[2].startswith(("aa.", "pb."))],
                     w0, w1)
    idle: Dict[str, float] = defaultdict(float)
    i = 0
    for a, b in gaps:
        while i < len(line) and line[i][1] <= a:
            i += 1
        j = i
        while j < len(line) and line[j][0] < b:
            o = min(b, line[j][1]) - max(a, line[j][0])
            if o > 0:
                idle[line[j][2]] += o * 1e-6
            j += 1
    return dict(idle)


def _clock(events: List[dict], spans: List[Span], w0: float,
           w1: float) -> dict:
    calls = {e["args"]["correlation"]: e for e in events
             if e.get("cat") in LAUNCH_CATS
             and "correlation" in e.get("args", {})}
    launch = sorted((a, b) for a, b, n in spans if n.startswith(LAUNCH))
    starts = [a for a, _ in launch]
    deltas, inside, unmatched = [], 0, 0
    # the least delta of each tenth of the window, by launch time
    floor: Dict[int, float] = {}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        c = calls.get(e.get("args", {}).get("correlation"))
        if c is None:
            unmatched += 1
            continue
        a = float(c["ts"])
        if not w0 <= a <= w1:
            continue
        deltas.append((float(e["ts"]) - a, e["name"][:60], c["name"]))
        b = min(9, int(10 * (a - w0) / (w1 - w0)))
        floor[b] = min(floor.get(b, deltas[-1][0]), deltas[-1][0])
        k = bisect.bisect_right(starts, a) - 1
        if k >= 0 and launch[k][1] >= a + float(c["dur"]):
            inside += 1
    worst = min(deltas) if deltas else (None, None, None)
    return {"min_us": worst[0], "kernels": len(deltas),
            "negative": sum(1 for d in deltas if d[0] < 0),
            "in_launch_span": inside, "unmatched": unmatched,
            "worst": list(worst[1:]),
            "drift_us_per_s": _slope(floor, (w1 - w0) * 1e-6)}


def _slope(floor: Dict[int, float], window_s: float) -> Optional[float]:
    """Least-squares slope, us a second, of the tenths' least deltas: 0
    where the device's clock keeps pace with the host's."""
    if len(floor) < 2:
        return None
    xs = [(b + 0.5) * window_s / 10 for b in floor]
    ys = list(floor.values())
    mx, my = sum(xs) / len(xs), sum(ys) / len(ys)
    return (sum((x - mx) * (y - my) for x, y in zip(xs, ys))
            / sum((x - mx) ** 2 for x in xs))


def summarise(events: List[dict]) -> dict:
    """The reduction of the module docstring from one trace's events."""
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"]) for e in events
                   if e.get("cat") == "user_annotation")
    pb_calls = [s for s in spans if s[2] == "pb.call"]
    syncs = [s for s in spans if s[2] == "pb.sync"]
    calls = _calls(spans)
    w0, w1 = ((pb_calls[0][0], syncs[-1][1]) if pb_calls and syncs
              else (0.0, 0.0))
    return {
        "calls": calls,
        "pb_call_us": [b - a for a, b, _ in pb_calls],
        "rebuilds": sum(1 for a, _, n in spans
                        if _is_mark(n) and w0 <= a <= w1),
        "idle_by_span": _idle(events, spans, w0, w1),
        "clock": _clock(events, spans, w0, w1),
    }


def summary(path) -> dict:
    """``summarise`` of the trace at ``path``, read once per file."""
    st = os.stat(path)
    key = (str(path), st.st_mtime_ns, st.st_size)
    if key not in _MEMO:
        _MEMO[key] = summarise(load_events(Path(path)))
    return _MEMO[key]


def _traced(ctx) -> Optional[dict]:
    """The run's trace summary where it holds the program's calls."""
    if ctx.device == "cpu" or not ctx.trace_path:
        return None
    s = summary(ctx.trace_path)
    return s if s["calls"] else None


def median_of(ctx, key: str) -> Optional[float]:
    """The median over the traced calls of ``calls[*][key]``."""
    s = _traced(ctx)
    if s is None:
        return None
    return float(statistics.median(c[key] for c in s["calls"]))


def rebuilds_per_call(ctx) -> Optional[float]:
    """Cold-path marks inside the traced window over its traced calls."""
    s = _traced(ctx)
    if s is None:
        return None
    return s["rebuilds"] / (len(s["pb_call_us"]) or len(s["calls"]))


def builds(ctx, disk: bool) -> Optional[float]:
    """Host seconds of the program's ``build.*`` spans so far in this
    process: the disk plan cache's (``disk``) or every other's.  None on
    the CPU and where the program keeps no ``BUILDS``."""
    if ctx.device == "cpu":
        return None
    log = sys.modules.get("aainterp_torch.utils.log")
    table = getattr(log, "BUILDS", None)
    if table is None:
        return None
    return float(sum(s for name, (_, s) in table.items()
                     if (name in DISK) == disk))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print("usage: python3 -m perfbench.spans <trace.json>",
              file=sys.stderr)
        return 2
    s = summary(argv[0])
    calls = s["calls"]

    def med(key):
        return statistics.median(c[key] for c in calls) if calls else None

    print(json.dumps({
        "calls": len(calls),
        "interpolate_us": med("us"),
        "pb_call_us": (statistics.median(s["pb_call_us"])
                       if s["pb_call_us"] else None),
        "route_us": med("route_us"), "wrapper_us": med("wrapper_us"),
        "launch_us": med("launch_us"),
        "launches_per_call": (sum(c["launches"] for c in calls) / len(calls)
                              if calls else None),
        "rebuilds": s["rebuilds"],
        "idle_by_program_span_s": s["idle_by_span"],
        "clock": s["clock"],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
