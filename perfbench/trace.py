"""Reading a profiler trace of the window's traced stretch.

The loop marks each call's host spans with ``torch.profiler``'s
``record_function`` (``pb.pick``, ``pb.call``, ``pb.sync``), so they land
in the Chrome trace beside the device's kernels, copies and sets on one
clock.  ``summarise`` reduces the trace to:

* ``window_s``: from the first traced call's start to the last traced
  synchronise's end;
* ``busy_s``: the union of device activity within that window;
* ``device_s``: the summed durations of that activity (what the
  roofline divides by);
* ``calls``: the traced calls;
* ``ops``: seconds by device operation name, largest first;
* ``gaps``: the idle stretches of the device within the window, each
  named by the host span it overlaps most, longest first;
* ``idle_by_span``: the idle seconds under each host span.
"""

from __future__ import annotations

import json
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPANS = ("pb.pick", "pb.call", "pb.sync")


def load_events(path: Path) -> List[dict]:
    data = json.loads(Path(path).read_text())
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def _merge(intervals: List[Tuple[float, float]]):
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _attribute(a: float, b: float, spans, i: int):
    """Seconds of [a, b] under each host span ('loop' outside them), and
    the index of the first span that may overlap a later gap."""
    while i < len(spans) and spans[i][1] <= a:
        i += 1
    parts: Dict[str, float] = defaultdict(float)
    covered = 0.0
    j = i
    while j < len(spans) and spans[j][0] < b:
        o = min(b, spans[j][1]) - max(a, spans[j][0])
        if o > 0:
            parts[spans[j][2][3:]] += o * 1e-6
            covered += o
        j += 1
    if b - a - covered > 0:
        parts["loop"] += (b - a - covered) * 1e-6
    return parts, i


def summarise(events: List[dict]) -> Dict:
    """The reduction above from the events of one trace (times in us)."""
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"]) for e in events
                   if e.get("name") in SPANS
                   and e.get("cat") == "user_annotation")
    calls = [s for s in spans if s[2] == "pb.call"]
    syncs = [s for s in spans if s[2] == "pb.sync"]
    if not calls or not syncs:
        return {}
    w0, w1 = calls[0][0], syncs[-1][1]
    dev = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
           for e in events if e.get("cat") in DEVICE_CATS]
    dev = [(max(a, w0), min(b, w1), n) for a, b, n in dev if b > w0 and a < w1]
    ops: Dict[str, float] = defaultdict(float)
    for a, b, n in dev:
        ops[n] += (b - a) * 1e-6
    merged = _merge([(a, b) for a, b, _ in dev])
    busy = sum(b - a for a, b in merged)
    gaps, idle = [], defaultdict(float)
    edge, i = w0, 0
    for a, b in merged + [[w1, w1]]:
        if a > edge:
            parts, i = _attribute(edge, a, spans, i)
            for k, v in parts.items():
                idle[k] += v
            # a gap is named by the host span it overlaps most
            gaps.append((max(parts, key=parts.get), (a - edge) * 1e-6))
        edge = max(edge, b)
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy * 1e-6,
        "device_s": sum(ops.values()),
        "calls": len(calls),
        "ops": sorted(ops.items(), key=lambda kv: -kv[1]),
        "gaps": sorted(gaps, key=lambda g: -g[1]),
        "idle_by_span": dict(idle),
    }


def breakdown(summary: Dict, top: int = 10) -> Dict[str, list]:
    return {"device_ops": [[n, s] for n, s in summary["ops"][:top]],
            "idle_gaps": [[n, s] for n, s in summary["gaps"][:top]]}
