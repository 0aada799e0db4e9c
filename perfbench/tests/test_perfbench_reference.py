"""The plain reference against the program's plain routes at tiny
geometries on the CPU, and the control against the cells' limits."""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import check
from perfbench.reference import Reference, resample
from perfbench.reference.geometry import geometry
from perfbench.tests.roots import REPO

# (src_shape, src_resolution, dst_resolution, isocenter, angle)
GEOMETRIES = [
    ((54, 96), 2.0, 1.0, (0.0, 0.0), 0.0),       # resize4k's ratio
    ((33, 41), 1.0, 0.7, (5.0, 3.0), 0.0),
    ((64, 64), 1.0, 0.5, (32.0, 32.0), 30.0),    # rot2048's
    ((40, 56), 1.0, 0.5, (20.0, 12.0), 30.2),
    ((30, 44), 1.0, 0.8, (10.0, 12.0), 127.0),
    ((30, 44), 1.0, 3.0, (10.0, 12.0), 17.0),    # prescale 5
    ((24, 20), 1.0, 1.0, (10.0, 12.0), 290.0),
]


def _frames(shape, n=2, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((n,) + shape, generator=g, dtype=torch.float64)


@pytest.mark.parametrize("g", GEOMETRIES)
def test_geometry_is_the_programs(g):
    from aainterp_torch.grids import make_grid_spec
    spec = make_grid_spec(*g)
    geo = geometry(*g)
    assert geo.dst_shape == spec.dst_shape
    assert (geo.scale, geo.quadrant) == (spec.scale, spec.quadrant)
    p00, ex, ey = spec.linear_map
    assert np.allclose(geo.p00, p00, rtol=0, atol=1e-12)
    assert np.allclose(geo.ex + geo.ey, ex + ey, rtol=0, atol=1e-12)


@pytest.mark.parametrize("g", GEOMETRIES)
def test_exact_operator_matches_the_programs(g):
    """Interval overlaps or clipped areas, rows normalised: the
    program's float64 operator applied in float64, within 1e-13."""
    from aainterp_torch.api import apply_operator, build_operator
    from aainterp_torch.grids import make_grid_spec
    spec = make_grid_spec(*g)
    op = build_operator(spec)
    x = _frames(g[0])
    impl = "banded" if spec.is_axis_aligned else "gather"
    want = apply_operator(op, x, weight_dtype=torch.float64, impl=impl,
                          device="cpu").to(torch.float64)
    geo = geometry(*g)
    fn = resample.separable if geo.axis_aligned else resample.rotated
    got = fn(geo, x, torch.float64)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) < 1e-13


@pytest.mark.parametrize("g", [g for g in GEOMETRIES if g[4] % 90])
def test_shear_passes_match_the_programs(g):
    """The three 'quality' passes: the program's plain route keeps its
    pass tables and sums in float32 and divides by the coverage, so
    1e-5; with bf16 between passes, as its
    kernel route states, all but a few elements round alike."""
    from aainterp_torch.grids import make_grid_spec
    from aainterp_torch.ops import shear3
    spec = make_grid_spec(*g)
    plan = shear3.build_shear3_plan(spec, decomposition="quality")
    geo = geometry(*g)
    x = _frames(g[0]).to(torch.float32)
    q = resample.quadrant_turn(x, geo.quadrant)
    want = shear3.apply_shear3_plain(q, plan)
    got = resample.shear_xyx(geo, x, torch.float64)
    assert float((got - want.double()).abs().max()) < 1e-5
    xb = x.to(torch.bfloat16)
    qb = resample.quadrant_turn(xb, geo.quadrant)
    want = shear3.apply_shear3_plain(qb, plan, mid_dtype=torch.bfloat16)
    got = resample.shear_xyx(geo, xb, torch.float64, torch.bfloat16)
    nums = check.numbers(want, got)
    assert nums["mismatch_share"] < 0.01
    assert nums["max_ulp"] < 4.0


@pytest.mark.parametrize("cell", ["resize4k.bf16.b64",
                                  "rot30.exact.bf16.b64",
                                  "rot30.shear.bf16.b64",
                                  "resize4k.u8.b64"])
def test_control_fails_the_cells_limits(cell, tiny_root):
    """The control, the reference in bf16 arithmetic put in the
    program's place, comes out not correct under the cell's own limits
    (at a test's size: 8 frames of the tiny geometry)."""
    from perfbench import inputs, spec
    wl = spec.load(tiny_root, cell)
    limits = json.loads((REPO / "perfbench" / "cells" /
                         f"{cell}.json").read_text())["limits"]
    ref = Reference(wl.config, wl.cell["reference"], "cpu")
    tr = dict(wl.traffic, frames=8, pool=1)
    x = inputs.pool(tr, wl.config["src_shape"], 4_000_000_000, "cpu")[0]
    out = ref(x, torch.bfloat16).to(inputs.DTYPES[tr["out_dtype"]])
    ok, checks = check.judge(check.numbers(out, ref(x)), limits)
    assert not ok, checks
    # the reference itself, rounded once, passes
    ok, checks = check.judge(
        check.numbers(ref(x).to(out.dtype), ref(x)), limits)
    assert ok, checks


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    mods = {m.split(".")[0]
            for p in (REPO / "perfbench" / "reference").glob("*.py")
            for m in _imports(p)}
    assert mods <= {"__future__", "dataclasses", "importlib", "math",
                    "typing", "torch"}


@pytest.mark.parametrize("frames, mid", [
    (torch.bfloat16, torch.bfloat16), (torch.uint8, torch.bfloat16),
    (torch.float32, torch.float32)])
def test_shear_family_rounds_between_passes_as_stated(frames, mid):
    """bf16 between passes, float32 for float32 frames, as the rot2048
    configuration states and the program's stage dtypes take it."""
    from aainterp_torch.ops import shear3
    from perfbench.reference import shear_quality
    assert shear_quality.mid_dtype(frames) == mid
    assert shear3.stage_dtypes(frames, torch.bfloat16, None)[1] == mid
