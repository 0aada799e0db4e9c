"""The port's own spans and counters (``aainterp_torch/utils/log.py``,
``utils/lru.py``): the call path's ``aa.*`` spans in a profiler's trace,
nothing recorded with no profiler running, ``build_span``'s counts in
``log.BUILDS``, the plan caches' hits and misses and their names in
``lru.CACHES``.  On a GPU, each call's launch spans against the wrappers'
``LAUNCHES`` (marker ``cuda``; imports no JAX, so it runs with
``python -m pytest --noconftest -m cuda tests/test_torch_trace.py``).
"""

import importlib
import json
import os
import pkgutil

import pytest
import torch

import aainterp_torch as at
from aainterp_torch import api
from aainterp_torch.ops import cuda_apply, cuda_apply_2d, cuda_shear
from aainterp_torch.ops import cuda_shear3
from aainterp_torch.utils import digest, log, lru

ROT = ((40, 40), 1.0, 0.5, (20.0, 20.0), 30.0)
SEP = ((48, 64), 2.0, 1.0, (0.0, 0.0), 0.0)


def _call(route, x, op=None):
    """One ``area_average_interpolate`` on ``route``'s geometry: the
    separable operator, the rotated exact operator (the plain gather on
    the CPU, the fused shear and the contraction on the card) or
    ``mode='shear'``."""
    shape, *geo = SEP if route == "separable" else ROT
    kw = {"mode": "shear"} if route == "shear" else {"operator": op}
    return api.area_average_interpolate(x, *geo, **kw).dst


def _setup(route, device):
    shape = (SEP if route == "separable" else ROT)[0]
    op = None
    if route != "shear":
        op = at.build_operator(at.make_grid_spec(
            *(SEP if route == "separable" else ROT)))
    g = torch.Generator().manual_seed(0)
    x = torch.rand((2,) + shape, generator=g).to(device)
    return x, op


def _spans(trace_dir):
    with open(os.path.join(trace_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e["name"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation")


def _inside(spans, outer):
    a, b, _ = outer
    return [n for x, y, n in spans if a <= x and y <= b and (x, y) != (a, b)]


def test_no_profiler_no_span(monkeypatch):
    """With no profiler running, ``span`` is one shared no-op and the
    call path records nothing."""
    assert not torch.autograd.profiler._is_profiler_enabled
    assert log.span("aa.route") is log.span("aa.launch.separable")
    assert log.span("x") is log._NO_SPAN

    def recorder(*a, **k):
        raise AssertionError("record_function with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", recorder)
    x, op = _setup("rotated", "cpu")
    _call("rotated", x, op)
    log.mark("cache.test.miss")


@pytest.mark.parametrize("route", ["separable", "rotated", "shear"])
def test_call_path_spans_nest(route, tmp_path):
    """Under ``log.profile_trace`` a call exports ``aa.interpolate``
    with ``aa.spec`` and ``aa.route`` inside it, in that order."""
    x, op = _setup(route, "cpu")
    _call(route, x, op)
    with log.profile_trace(str(tmp_path)) as d:
        _call(route, x, op)
    spans = _spans(d)
    roots = [s for s in spans if s[2] == "aa.interpolate"]
    assert len(roots) == 1
    inner = [n for n in _inside(spans, roots[0]) if n in ("aa.spec",
                                                         "aa.route")]
    assert inner == ["aa.spec", "aa.route"]


def test_build_span_counts_misses_not_hits(tmp_path):
    """A plan cache's miss runs ``build_span``: one more count and some
    seconds in ``log.BUILDS``, a ``cache.<name>.miss`` mark and the
    ``build.*`` span in a trace; a hit adds nothing."""
    spec = at.make_grid_spec((24, 20), 1.0, 0.7, (10.0, 12.0), 17.0)
    before = list(log.BUILDS.get("build.shear3_plan", [0, 0.0]))
    misses = api._SHEAR3_CACHE.misses
    with log.profile_trace(str(tmp_path)) as d:
        api._shear3_plan(spec, "quality")
    n, s = log.BUILDS["build.shear3_plan"]
    assert n == before[0] + 1 and s > before[1]
    assert api._SHEAR3_CACHE.misses == misses + 1
    names = [n for _, _, n in _spans(d)]
    assert "build.shear3_plan" in names and "cache.api.shear3.miss" in names
    hits = api._SHEAR3_CACHE.hits
    api._shear3_plan(spec, "quality")
    assert log.BUILDS["build.shear3_plan"][0] == n
    assert api._SHEAR3_CACHE.hits == hits + 1


def test_build_span_counts_a_build_that_raises():
    name = "build.test_raises"
    log.BUILDS.pop(name, None)
    with pytest.raises(ValueError):
        with log.build_span(name):
            raise ValueError("rejected geometry")
    assert log.BUILDS.pop(name)[0] == 1


def test_lru_counts_hits_and_misses():
    c = lru.LruDict(2)
    assert c.get("a") is None
    c.put("a", 1)
    assert c.get("a") == 1 and c.get("b", 7) == 7
    assert (c.hits, c.misses) == (1, 2)
    assert "a" in c and (c.hits, c.misses) == (1, 2)   # not a lookup
    assert c.name is None and all(v is not c for v in lru.CACHES.values())


def _all_modules():
    mods = []
    for info in pkgutil.walk_packages(at.__path__, "aainterp_torch."):
        if info.name.endswith("__main__"):
            continue
        mods.append(importlib.import_module(info.name))
    return mods


def test_every_module_cache_has_a_unique_name():
    """Every module-level ``LruDict`` of the package is named and found
    under its name in ``lru.CACHES``, no two with one name."""
    found = {}
    for mod in _all_modules():
        for attr, v in vars(mod).items():
            if isinstance(v, lru.LruDict):
                found[f"{mod.__name__}.{attr}"] = v
    caches = {id(v): (k, v) for k, v in found.items()}
    assert len(caches) == 19
    names = [v.name for _, v in caches.values()]
    assert None not in names, [k for k, v in caches.values() if v.name is None]
    assert len(set(names)) == len(names)
    for _, v in caches.values():
        assert lru.CACHES[v.name] is v


def test_digest_hash_is_a_build_span(tmp_path):
    """A table's first hash is ``build.digest``, in the trace and in
    ``log.BUILDS``; the memo's hit is neither."""
    import numpy as np
    a = np.arange(12.0)
    n = log.BUILDS.get("build.digest", [0, 0.0])[0]
    with log.profile_trace(str(tmp_path)) as d:
        digest.array_digest(a)
        digest.array_digest(a)
    assert [n for _, _, n in _spans(d)].count("build.digest") == 1
    assert log.BUILDS["build.digest"][0] == n + 1


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda:0")


def _launches():
    return (cuda_apply.LAUNCHES + cuda_apply_2d.LAUNCHES
            + sum(cuda_shear.LAUNCHES.values())
            + sum(cuda_shear3.LAUNCHES.values()))


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["separable", "rotated", "shear"])
def test_launch_spans_match_launches(route, cuda, tmp_path, monkeypatch):
    """Each call's ``aa.launch.*`` spans inside its ``aa.interpolate``
    equal the wrappers' ``LAUNCHES`` delta (separable: kernel 1; the
    rotated exact route on the card: the fused shear and the
    contraction; shear: three stages)."""
    from aainterp_torch.utils import cache
    monkeypatch.setattr(cache, "DEFAULT_CACHE_DIR", str(tmp_path / "plans"))
    x, op = _setup(route, cuda)
    _call(route, x, op)
    torch.cuda.synchronize()
    n0 = _launches()
    with log.profile_trace(str(tmp_path / "trace")) as d:
        _call(route, x, op)
        _call(route, x, op)
    spans = _spans(d)
    per_call = [len([n for n in _inside(spans, r)
                     if n.startswith("aa.launch.")])
                for r in spans if r[2] == "aa.interpolate"]
    delta = _launches() - n0
    assert len(per_call) == 2 and sum(per_call) == delta
    assert per_call[0] == per_call[1] == {"separable": 1, "rotated": 2,
                                          "shear": 3}[route]
