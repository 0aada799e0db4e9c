"""The readings a cell's limits are set from, on the card.

    python3 perfbench/readings.py --workload <cell> --seeds 12 \
        --control-seeds 3 --seconds 1 --first-seed <n>

One process: one set-up, then for each of ``--seeds`` seeds the cell's
frames from that seed, a short window of the cell's own loop and the
check of its sampled calls (the lower readings); then for each of
``--control-seeds`` seeds the control, the reference computed in the
nearest precision below the stated one (bf16 arithmetic), put in the
program's place on the same frames and judged by the same comparison
against the cell's limits (the upper readings; each has to read
``"correct": false``).  Prints one JSON line per reading and a summary.
"""

import argparse
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def control(sess, ref, seed: int) -> dict:
    """The control on every batch of the pool of ``seed``: its numbers,
    and whether the cell's limits take it for correct."""
    import torch
    from perfbench import check, inputs

    pool = inputs.pool(sess.wl.traffic, sess.wl.config["src_shape"], seed,
                       sess.device)
    nums, total = {}, 0
    for x in pool:
        got = ref(x, torch.bfloat16).to(sess.out_dtype)
        n = check.numbers(got, ref(x))
        nums = check.merge(nums, n, total, got.numel())
        total += got.numel()
    ok, checks = check.judge(nums, sess.wl.cell["limits"])
    return {"numbers": nums, "correct": ok, "checks": checks}


def main(argv=None) -> int:
    import torch
    from perfbench import spec

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--first-seed", type=int, default=1 << 31)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    if a.device == "cuda" and not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    wl = spec.load(ROOT, a.workload)
    with tempfile.TemporaryDirectory(prefix="perfbench_") as scratch, \
            spec.entry(wl.traffic["entry"]).private_caches(
                Path(scratch)):
        lower, upper = readings(wl, a)
    summary = {"workload": a.workload, "device": torch.cuda.get_device_name()
               if a.device == "cuda" else a.device,
               "program_correct": [r["correct"] for r in lower],
               "control_correct": [r["correct"] for r in upper]}
    first = (lower or upper)[0]["numbers"]
    for name in first:
        summary[name] = {
            "program_max": max(r["numbers"][name] for r in lower)
            if lower else None,
            "control_min": min(r["numbers"][name] for r in upper)
            if upper else None}
    print(json.dumps(summary), flush=True)
    return 0


def readings(wl, a):
    """The program's readings on ``a.seeds`` seeds and the control's on
    ``a.control_seeds``, each judged against the cell's limits."""
    from perfbench import harness, inputs
    from perfbench.reference import Reference

    sess = harness.Session(wl, a.first_seed, a.device)
    ref = Reference(wl.config, wl.cell["reference"], a.device)
    lower, upper = [], []
    for i in range(a.seeds):
        seed = a.first_seed + 7919 * i
        sess.seed = seed
        sess.pool = inputs.pool(wl.traffic, wl.config["src_shape"], seed,
                                a.device)
        run = harness.Run(device=a.device, counts={}, peak=None)
        kept = harness.window(sess, run, a.seconds, trace=False)
        harness.check_outputs(sess, run, kept, ref)
        del kept
        r = {"numbers": run.numbers, "correct": run.correct,
             "checks": run.checks}
        lower.append(r)
        print(json.dumps({"workload": wl.name, "side": "program",
                          "seed": seed, "batches": run.batches, **r}),
              flush=True)
    sess.pool = None
    for i in range(a.control_seeds):
        seed = a.first_seed + 104729 * (i + 1)
        r = control(sess, ref, seed)
        upper.append(r)
        print(json.dumps({"workload": wl.name, "side": "control",
                          "seed": seed, **r}), flush=True)
    return lower, upper


if __name__ == "__main__":
    sys.exit(main())
