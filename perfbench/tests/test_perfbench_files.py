"""BENCHMARK.json against the benchmark's contract, and every cell's files
found by name."""

import json
import re

from perfbench import spec
from perfbench.tests.roots import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TEXT = re.compile(r"^[^\t\n\r]{1,200}$")

TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
CONFIG = {"name", "source", "file", "reduced", "why"}
WORKLOAD = {"name", "config", "traffic", "chips", "why"}
E2E = {"name", "unit", "better", "bound", "source"}
LAYER = {"name", "unit", "better", "source", "layer", "moves"}


def test_keys_and_shapes(bench):
    assert set(bench) == TOP
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(bench["command"]) <= 32
    assert all(TEXT.match(w) for w in bench["command"])
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    for c in bench["configs"]:
        assert set(c) == CONFIG
    for w in bench["workloads"]:
        assert set(w) == WORKLOAD and w["chips"] in (1, 4)
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == E2E
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == LAYER
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert TEXT.match(m["layer"])


def test_names_units_and_text(bench):
    names = [c["name"] for c in bench["configs"]]
    names += [w["name"] for w in bench["workloads"]]
    names += [w["traffic"] for w in bench["workloads"]]
    metrics = bench["end_to_end"] + bench["per_layer"]
    names += [m["name"] for m in metrics]
    names += [k for c in bench["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    for group in (bench["configs"], bench["workloads"], metrics):
        assert len({g["name"] for g in group}) == len(group)
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    for c in bench["configs"]:
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert c["source"].startswith("https://")
    assert all(TEXT.match(w["why"]) for w in bench["workloads"])
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_metrics_reach_every_cell(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
    for cell in cells:
        wl = spec.load(REPO, cell)
        got = {m["name"] for m in wl.end_to_end}
        assert "setup_s" in got and len(got) >= 2
        assert wl.per_layer
        for m in wl.per_layer:
            mv = e2e[m["moves"]]
            assert cell in mv.get("workloads", cells)
    layers = {}
    for m in bench["per_layer"]:
        layers.setdefault(m["layer"], []).append(m["name"])
    assert all(len(v) >= 1 for v in layers.values())


def test_every_cell_finds_its_files(bench):
    used = set()
    files = set()
    for c in bench["configs"]:
        assert (REPO / c["file"]).is_file()
        assert c["file"].startswith("perfbench/")
        files.add(c["file"])
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
    assert len(files) == len(bench["configs"])
    for w in bench["workloads"]:
        wl = spec.load(REPO, w["name"])
        used.add(w["config"])
        assert wl.traffic["mode"] in ("exact", "shear")
        entry = spec.entry(wl.traffic["entry"])
        assert all(callable(getattr(entry, f)) for f in (
            "private_caches", "build", "make", "counters"))
        assert (REPO / "perfbench" / "reference" /
                f"{wl.cell['reference']}.py").is_file()
        assert wl.cell["limits"]
        for name, lim in wl.cell["limits"].items():
            assert name in ("excess_ulp", "mismatch_share", "max_ulp")
            assert lim["limit"] > 0
        for m in wl.end_to_end + wl.per_layer:
            assert callable(spec.reader(REPO, m["name"]))
    assert used == {c["name"] for c in bench["configs"]}


def test_command_names_only_its_paths(bench):
    cmd = bench["command"]
    assert cmd[0] == "python3"
    for word in cmd[1:]:
        if "/" in word or word.endswith(".py"):
            assert any(word.startswith(p + "/") for p in bench["paths"])
            assert (REPO / word).is_file()
