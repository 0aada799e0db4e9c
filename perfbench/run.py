"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

(or ``python3 -m perfbench.run ...``) from the root of a checkout.  The
cell's files are found by its name in ``BENCHMARK.json``.  The last line
of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared beside its
limit; the last lines of standard error repeat the checks.  Exits 2,
printing no result, without CUDA or with fewer cards than the cell asks
for, and 3 where JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _err(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def result_line(wl, run, trace: bool) -> dict:
    """The result's JSON object; ``checks`` comes last."""
    from perfbench import spec
    from perfbench import trace as trace_mod

    metrics = spec.read_metrics(wl, wl.per_layer if trace else wl.end_to_end,
                                run)
    device = {"platform": "gpu", "kind": run.device, "count": wl.chips,
              "memory_peak_bytes": run.memory_peak_bytes}
    result = {"correct": run.correct, "attempted": run.batches, "failed": 0,
              "metrics": metrics, "device": device}
    if trace and run.trace:
        device["busy_s"] = run.trace["busy_s"]
        device["window_s"] = run.trace["window_s"]
        result["breakdown"] = trace_mod.breakdown(run.trace)
    result["checks"] = run.checks
    return result


def main(argv=None) -> int:
    t0 = time.perf_counter()
    from perfbench import harness, spec
    imports_s = time.perf_counter() - t0

    # process start to this file's first line (interpreter start-up)
    age = harness.process_age_s() - (time.perf_counter() - T0)
    if age < 0.0:
        age = 0.0
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    wl = spec.load(ROOT, a.workload)

    import torch
    pre = {"to_run_py_s": age, "imports_s": imports_s}
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        _err("perfbench: no CUDA device; the benchmark runs on the card only")
        return 2
    if torch.cuda.device_count() < wl.chips:
        _err(f"perfbench: {a.workload} needs {wl.chips} cards, "
             f"{torch.cuda.device_count()} visible")
        return 2

    torch.cuda.init()
    pre["cuda_init_s"] = time.perf_counter() - t0
    run = harness.execute(wl, a.seed, a.seconds, bool(a.trace),
                          device="cuda", t_start=T0, setup_age_s=age,
                          setup_pre=pre)
    bad = harness.forbidden_modules()
    if bad:
        _err(f"perfbench: loaded {', '.join(bad)}: the run must not load "
             "JAX or the JAX package")
        return 3

    result = result_line(wl, run, bool(a.trace))
    if a.trace and run.trace:
        _err("idle by host span (s):", json.dumps(run.trace["idle_by_span"]))
        _err("trace:", run.trace_path)
    _err("set-up (s):", json.dumps(run.setup))
    _err("window (host ms, medians):", json.dumps({
        "batches": run.batches,
        "enqueue": statistics.median(run.enqueue_ms) if run.enqueue_ms
        else None,
        "batch": statistics.median(run.batch_ms) if run.batch_ms else None}))
    _err("counters over the window:", json.dumps(run.launches))
    _err(f"compared {run.compared} sampled calls:", json.dumps(run.numbers))
    print(json.dumps(result), flush=True)
    for name, c in run.checks.items():
        _err(f"check {name} {c['value']!r} limit {c['limit']!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
