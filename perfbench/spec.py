"""Finding a cell's files by the names in ``BENCHMARK.json``.

Everything of one configuration, one traffic mix, one cell or one metric
is a file of its own under ``perfbench/``, found by name:

* ``configs/<config>.json`` (the path ``BENCHMARK.json`` gives): the
  geometry, its source and what was assumed or cut;
* ``traffic/<traffic>.json``: the mix, read by the one loop of
  ``harness.py``: the entry it calls (``entries/<entry>.py``), dtype,
  frames a batch, the pool of distinct batches, the call's mode and
  arguments;
* ``cells/<workload>.json``: the reference family the check runs
  (``reference/<family>.py``) and the numbers it compares, each with
  its limit and the readings the limit was set from;
* ``metrics/<metric>.py``: the reader of one metric, ``read(ctx)``.

A new cell, configuration or metric is new files and new entries.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

PACKAGE = "perfbench"


@dataclasses.dataclass(frozen=True)
class Workload:
    name: str
    chips: int
    config: dict
    traffic: dict
    cell: dict
    end_to_end: List[dict]      # the end-to-end metrics this cell reports
    per_layer: List[dict]       # the per-layer metrics this cell reports
    root: Path


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load(root: Path, workload: str) -> Workload:
    """The workload named ``workload`` of ``root/BENCHMARK.json``."""
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entries = [w for w in bench["workloads"] if w["name"] == workload]
    if not entries:
        names = ", ".join(w["name"] for w in bench["workloads"])
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(it has: {names})")
    entry = entries[0]
    cfgs = [c for c in bench["configs"] if c["name"] == entry["config"]]
    if not cfgs:
        raise KeyError(f"workload {workload!r} names no listed "
                       f"configuration {entry['config']!r}")
    base = root / PACKAGE
    return Workload(
        name=workload,
        chips=int(entry["chips"]),
        config=json.loads((root / cfgs[0]["file"]).read_text()),
        traffic=json.loads(
            (base / "traffic" / f"{entry['traffic']}.json").read_text()),
        cell=json.loads((base / "cells" / f"{workload}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"]
                    if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
        root=root)


def entry(name: str):
    """The module ``perfbench/entries/<name>.py``: the program's entry
    point that a traffic file names."""
    if not name.isidentifier():
        raise ValueError(f"no entry {name!r}")
    return importlib.import_module(f"{PACKAGE}.entries.{name}")


def reader(root: Path, metric: str) -> Callable:
    """``read(ctx)`` of ``root/perfbench/metrics/<metric>.py``."""
    path = Path(root) / PACKAGE / "metrics" / f"{metric}.py"
    mod_name = f"_perfbench_metric_{metric.replace('.', '_')}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(f"no reader for metric {metric!r} at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(wl: Workload, metrics: List[dict], ctx) -> Dict[str, dict]:
    """{name: {'value', 'unit'}} of each metric whose reader finds
    something to read; a reader returns None where it finds nothing."""
    out = {}
    for m in metrics:
        v = reader(wl.root, m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out
