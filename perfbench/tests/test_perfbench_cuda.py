"""On the card, at each cell's own size: a short run reads correct, and
the control, on three seeds, reads not correct.

    python3 -m pytest -m cuda perfbench/tests/test_perfbench_cuda.py
"""

import pytest
import torch

from perfbench import check, harness, inputs, spec
from perfbench.reference import Reference
from perfbench.tests.roots import REPO

CELLS = ["resize4k.bf16.b64", "rot30.exact.bf16.b64",
         "rot30.shear.bf16.b64", "resize4k.u8.b64"]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_is_correct(cell):
    _card()
    wl = spec.load(REPO, cell)
    run = harness.execute(wl, 4_200_000_001, 1.0, trace=True)
    assert run.correct, run.checks
    assert run.trace["busy_s"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    _card()
    wl = spec.load(REPO, cell)
    ref = Reference(wl.config, wl.cell["reference"], "cuda")
    out_dtype = inputs.DTYPES[wl.traffic["out_dtype"]]
    for seed in (4_300_000_001, 4_300_000_002, 4_300_000_003):
        x = inputs.pool(dict(wl.traffic, pool=1), wl.config["src_shape"],
                        seed, "cuda")[0]
        out = ref(x, torch.bfloat16).to(out_dtype)
        ok, checks = check.judge(check.numbers(out, ref(x)),
                                 wl.cell["limits"])
        assert not ok, (seed, checks)
