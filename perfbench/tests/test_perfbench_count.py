"""The byte and operation counts of each cell's function, pinned."""

import json

import pytest

from perfbench import count, spec
from perfbench.tests.roots import REPO

H100 = json.loads((REPO / "perfbench" / "peaks.json").read_text())[
    "NVIDIA H100 80GB HBM3"]


@pytest.mark.parametrize("cell, nbytes, bound_ms", [
    ("resize4k.bf16.b64", 1_327_104_000, 0.3962),
    # uint8 in, float32 out: the API's dtype for uint8 input
    ("resize4k.u8.b64", 1_061_683_200, 0.3169),
    ("rot30.exact.bf16.b64", 787_392_640, 0.2350),
    ("rot30.shear.bf16.b64", 787_392_640, 0.2350),
])
def test_batch_bytes_and_bound(cell, nbytes, bound_ms):
    wl = spec.load(REPO, cell)
    c = count.batch_counts(wl.config, wl.traffic)
    assert c["bytes"] == nbytes
    assert count.bound_s(c, H100) * 1e3 == pytest.approx(bound_ms, abs=5e-5)
    # bytes bind in every cell: operations take a tenth of the time or less
    assert c["flops"] / H100["float32_flops_per_s"] < 0.1 * count.bound_s(
        c, H100)


def test_u8_out_would_halve_the_bytes():
    # a uint8 output (the ops-level surface) is a quarter of float32's
    wl = spec.load(REPO, "resize4k.u8.b64")
    c = count.batch_counts(wl.config, dict(wl.traffic, out_dtype="uint8"))
    assert c["bytes"] == 663_552_000
    assert count.bound_s(c, H100) * 1e3 == pytest.approx(0.1981, abs=5e-5)
