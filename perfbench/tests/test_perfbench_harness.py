"""The harness's CPU dry path: a whole run at tiny sizes with the card's
look skipped, its result line, the faults that must read not correct,
the control judged not correct, a cell added as new files only, the
program's plan cache kept to the run, and no JAX in the process."""

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import harness, readings, spec
from perfbench.tests.roots import REPO, make_root

CELLS = ["resize4k.bf16.b64", "rot30.exact.bf16.b64",
         "rot30.shear.bf16.b64", "resize4k.u8.b64"]
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def _run(root, cell, trace=False, seconds=0.2, **kw):
    wl = spec.load(root, cell)
    return wl, harness.execute(wl, 3_000_000_017, seconds, trace,
                               device="cpu", settle_s=0.0, **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_dry_run_is_correct_with_the_contracts_keys(cell, tiny_root):
    from perfbench import run as run_py
    wl, run = _run(tiny_root, cell)
    assert run.correct, run.checks
    assert run.batches >= 1 and run.compared >= 1
    line = run_py.result_line(wl, run, trace=False)
    assert list(line) == KEYS
    assert set(line["metrics"]) == {"gpix_s", "batch_ms_p95", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert json.loads(json.dumps(line)) == line


def test_traced_dry_run_reads_host_layers(tiny_root):
    from perfbench import run as run_py
    wl, run = _run(tiny_root, "rot30.exact.bf16.b64", trace=True,
                   seconds=0.4)
    line = run_py.result_line(wl, run, trace=True)
    # no device on the CPU: the device readers find nothing to read
    assert set(line["metrics"]) == {"geometry_s", "enqueue_ms"}
    assert run.trace["calls"] >= 1 and run.trace["busy_s"] == 0.0
    assert list(line)[-1] == "checks"


def _broken(monkeypatch, fault):
    from aainterp_torch import api
    real = api.area_average_interpolate

    def call(x, *args, **kwargs):
        r = real(x, *args, **kwargs)
        out = r.dst.clone()
        if fault == "state_unchanged":
            out = x.clone()
        elif fault == "half_batch":
            half = out.shape[0] // 2
            out[half:] = out[:half].mean(dim=0, keepdim=True)
        elif fault == "answer_altered":
            f, h, w = out.shape
            out[f - 1, h // 2, w // 2] += 0.5
        return type(r)(dst=out, dst_isocenter=r.dst_isocenter, spec=r.spec)

    monkeypatch.setattr(api, "area_average_interpolate", call)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
def test_a_broken_timed_path_reads_not_correct(cell, fault, tiny_root,
                                               monkeypatch):
    _broken(monkeypatch, fault)
    # every call of the window is sampled, so the altered one is judged
    _, run = _run(tiny_root, cell, sample_calls=10_000)
    assert not run.correct, run.checks


@pytest.mark.parametrize("cell", CELLS)
def test_readings_judge_the_control_not_correct(cell, tiny_root, capsys):
    """``readings.py`` judges each reading by the cell's limits: the
    program's read correct, the control's (bf16 arithmetic) not."""
    wl = spec.load(tiny_root, cell)
    a = argparse.Namespace(seeds=1, control_seeds=1, seconds=0.2,
                           first_seed=3_000_000_029, device="cpu")
    lower, upper = readings.readings(wl, a)
    assert [r["correct"] for r in lower] == [True]
    assert [r["correct"] for r in upper] == [False]
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [p["correct"] for p in printed if p["side"] == "control"] == [
        False]


def test_the_plan_cache_lives_for_one_run(tmp_path):
    """The entry points the program's disk cache of plans at the run's
    scratch directory, also where the program was imported before, and
    puts back what was there."""
    from aainterp_torch.utils import cache
    entry = spec.entry("area_average_interpolate")
    before = (os.environ.get("AAINTERP_CACHE_DIR"), cache.DEFAULT_CACHE_DIR)
    with entry.private_caches(tmp_path):
        assert os.environ["AAINTERP_CACHE_DIR"] == str(tmp_path / "plans")
        assert cache.DEFAULT_CACHE_DIR == str(tmp_path / "plans")
    assert (os.environ.get("AAINTERP_CACHE_DIR"),
            cache.DEFAULT_CACHE_DIR) == before


def test_a_runs_scratch_directory_is_gone_when_it_ends(tiny_root, tmp_path,
                                              monkeypatch):
    """A run's scratch directory, where the plans go, is gone when it
    ends."""
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    _, run = _run(tiny_root, "rot30.exact.bf16.b64")
    assert run.correct
    assert [p.name for p in Path(tmp_path).iterdir()
            if p.name.startswith("perfbench_")] == []


def test_a_cell_is_new_files_only(tmp_path):
    """A configuration, a traffic mix, a cell and a per-layer metric
    added as files and entries, with no file that is there edited."""
    root = make_root(tmp_path / "bench")
    b = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "perfbench/configs/rot2048.json").read_text())
    cfg.update(name="rot45small", rotation_angle=45.0,
               src_shape=[48, 40], src_isocenter=[20.0, 24.0])
    (root / "perfbench/configs/rot45small.json").write_text(json.dumps(cfg))
    tr = json.loads((root / "perfbench/traffic/exact.bf16.b64.json")
                    .read_text())
    (root / "perfbench/traffic/exact.f32.b3.json").write_text(json.dumps(
        dict(tr, dtype="float32", out_dtype="float32", frames=3, pool=2)))
    (root / "perfbench/cells/rot45.exact.f32.b3.json").write_text(
        json.dumps({"reference": "rotated",
                    "limits": {"excess_ulp": {"limit": 64.0}}}))
    (root / "perfbench/metrics/out_pixels_per_batch.py").write_text(
        "def read(ctx):\n"
        "    return ctx.counts['in_pixels'] and ctx.batches\n")
    b["configs"].append({"name": "rot45small", "source": "https://x.org",
                         "file": "perfbench/configs/rot45small.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "rot45.exact.f32.b3",
                           "config": "rot45small", "traffic": "exact.f32.b3",
                           "chips": 1, "why": "a test"})
    b["per_layer"].append({"name": "out_pixels_per_batch", "unit": "px",
                           "better": "higher", "source": "program_counter",
                           "layer": "a test", "moves": "gpix_s",
                           "workloads": ["rot45.exact.f32.b3"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    wl, run = _run(root, "rot45.exact.f32.b3")
    assert run.correct, run.checks
    got = spec.read_metrics(wl, wl.per_layer, run)
    assert got["out_pixels_per_batch"]["value"] == run.batches


def test_no_jax_in_the_process(tiny_root):
    """A dry run in a process of its own loads no module whose top-level
    name is jax, jaxlib, flax or aainterp (aainterp_torch is the port)."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from perfbench import harness, spec\n"
        "wl = spec.load(%r, 'rot30.exact.bf16.b64')\n"
        "run = harness.execute(wl, 5, 0.1, False, device='cpu', "
        "settle_s=0.0)\n"
        "assert run.correct\n"
        "import aainterp_torch\n"
        "print(harness.forbidden_modules())\n" % (str(REPO), str(tiny_root)))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
    assert harness.FORBIDDEN == ("jax", "jaxlib", "flax", "aainterp")


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    names = {m.split(".")[0] for m in sys.modules}
    monkeypatch.setitem(sys.modules, "aainterp_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    got = set(harness.forbidden_modules())
    assert "jaxlib" in got
    assert ("aainterp" in got) == ("aainterp" in names)


def test_run_py_without_a_card_prints_no_result(tmp_path):
    # the card, if any, is hidden from the run
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, str(REPO / "perfbench" / "run.py"), "--workload",
         "resize4k.bf16.b64", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, env=env, cwd=tmp_path,
        timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
