"""``perfbench/spans.py`` on a small synthetic Chrome trace: the split of
each call, the idle under the innermost span, the clock check; the six
readers on it, on a trace without the program's spans and on the CPU dry
path."""

import json
import types

import pytest

from perfbench import harness, spans, spec
from perfbench.tests.roots import REPO

SIX = ("route_us", "wrapper_us", "launch_us", "build_s", "plan_disk_s",
       "rebuilds_per_batch")
CARD = "NVIDIA H100 80GB HBM3"


def _span(name, a, b):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": a,
            "dur": b - a, "pid": 1, "tid": 1}


def _launch(corr, a, b, cat="cuda_runtime"):
    return {"ph": "X", "cat": cat, "name": "cudaLaunchKernel", "ts": a,
            "dur": b - a, "pid": 1, "tid": 1, "args": {"correlation": corr}}


def _kernel(corr, a, b):
    return {"ph": "X", "cat": "kernel", "name": f"k{corr}", "ts": a,
            "dur": b - a, "pid": 0, "tid": 7, "args": {"correlation": corr}}


def _events(program=True, late=False):
    """Two calls, each two launches; times in us.  ``late``: call 2's
    first kernel starts before its launch call."""
    ev = [_span("pb.call", 0, 100), _span("pb.sync", 100, 300),
          _span("pb.call", 300, 400), _span("pb.sync", 400, 600),
          _launch(1, 52, 58), _launch(2, 72, 78),
          _launch(3, 341, 349, "cuda_driver"), _launch(4, 361, 369),
          _kernel(1, 60, 160), _kernel(2, 160, 290),
          _kernel(3, 330 if late else 355, 450), _kernel(4, 450, 590)]
    if program:
        ev += [_span("aa.interpolate", 5, 95), _span("aa.spec", 10, 20),
               _span("aa.route", 25, 40), _span("aa.launch.vhshear", 50, 60),
               _span("aa.launch.contract", 70, 80),
               _span("aa.interpolate", 305, 395), _span("aa.spec", 310, 315),
               _span("aa.route", 320, 330), _span("build.tiles", 331, 335),
               _span("cache.cuda_shear.plan.miss", 332, 332),
               _span("aa.launch.vhshear", 340, 350),
               _span("aa.launch.contract", 360, 370)]
    return ev


def _trace(tmp_path, **kw):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": _events(**kw)}))
    return path


def test_calls_split_self_time_and_launches(tmp_path):
    s = spans.summary(_trace(tmp_path))
    assert s["calls"] == [
        {"us": 90.0, "route_us": 25.0, "launch_us": 20.0,
         "wrapper_us": 45.0, "launches": 2},
        {"us": 90.0, "route_us": 15.0, "launch_us": 20.0,
         "wrapper_us": 55.0, "launches": 2}]
    assert s["pb_call_us"] == [100.0, 100.0]
    assert s["rebuilds"] == 2


def test_idle_goes_to_the_innermost_span(tmp_path):
    idle = spans.summary(_trace(tmp_path))["idle_by_span"]
    want = {"pb.call": 10, "aa.interpolate": 45, "aa.spec": 15,
            "aa.route": 25, "aa.launch.vhshear": 20, "pb.sync": 20}
    assert set(idle) == set(want)
    for k, us in want.items():
        assert idle[k] == pytest.approx(us * 1e-6)


@pytest.mark.parametrize("late", [False, True])
def test_clock_check(tmp_path, late):
    """Each kernel's start less its launch call's, matched by
    correlation (runtime or driver call); a kernel that starts before
    its launch call reads below 0."""
    clock = spans.summary(_trace(tmp_path, late=late))["clock"]
    assert clock["kernels"] == 4 and clock["in_launch_span"] == 4
    assert clock["negative"] == int(late)
    assert clock["min_us"] == (-11.0 if late else 8.0)
    assert clock["worst"] == (["k3", "cudaLaunchKernel"] if late
                              else ["k1", "cudaLaunchKernel"])
    assert clock["unmatched"] == 0


@pytest.mark.parametrize("drift", [0.0, -100.0])
def test_clock_drift(tmp_path, drift):
    """The slope of each tenth's least delta: the device's clock running
    slow against the host's by ``drift`` us a second."""
    ev = [_span("pb.call", 0, 10), _span("pb.sync", 999_990, 1_000_000)]
    for i in range(10):
        a = 50_000 + 100_000 * i
        ev += [_launch(i, a, a + 4),
               _kernel(i, a + 5 + drift * a * 1e-6, a + 500)]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    clock = spans.summary(path)["clock"]
    assert clock["drift_us_per_s"] == pytest.approx(drift, abs=1e-6)
    assert clock["negative"] == (0 if drift == 0 else 9)


def test_launch_calls_outside_launch_spans_are_counted(tmp_path):
    ev = [e for e in _events() if e["name"] != "aa.launch.contract"]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    assert spans.summary(path)["clock"]["in_launch_span"] == 2


def _ctx(path, device=CARD):
    return types.SimpleNamespace(device=device, trace_path=str(path))


def test_readers_on_a_traced_card_run(tmp_path, monkeypatch):
    from aainterp_torch.utils import log
    monkeypatch.setattr(log, "BUILDS", {
        "build.operator": [1, 0.5], "build.tiles": [2, 0.25],
        "build.plan_save": [1, 0.25], "build.plan_load": [1, 0.125]})
    ctx = _ctx(_trace(tmp_path))
    got = {m: spec.reader(REPO, m)(ctx) for m in SIX}
    assert got == {"route_us": 20.0, "wrapper_us": 50.0, "launch_us": 20.0,
                   "build_s": 0.75, "plan_disk_s": 0.375,
                   "rebuilds_per_batch": 1.0}


def test_readers_on_a_program_without_spans(tmp_path, monkeypatch):
    """The parent's program marks no spans and keeps no BUILDS: every
    reader returns None, and none raises."""
    from aainterp_torch.utils import log
    monkeypatch.delattr(log, "BUILDS")
    ctx = _ctx(_trace(tmp_path, program=False))
    assert {m: spec.reader(REPO, m)(ctx) for m in SIX} == dict.fromkeys(SIX)


def test_readers_return_none_on_the_cpu_dry_path(tiny_root):
    wl = spec.load(tiny_root, "rot30.shear.bf16.b64")
    run = harness.execute(wl, 3_000_000_019, 0.4, True, device="cpu",
                          settle_s=0.0)
    assert run.trace_path and spans.summary(run.trace_path)["calls"]
    six = [m for m in wl.per_layer if m["name"] in SIX]
    assert len(six) == 6
    assert spec.read_metrics(wl, six, run) == {}
