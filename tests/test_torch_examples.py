"""The port's examples (examples/torch_*.py) with ``--device cpu``, each
in a subprocess of its own with a time limit: each exits 0 and prints its
sections, and ``-X importtime`` shows that neither it nor the rank
processes it starts load jax or the JAX package.  ``--device cuda``
with no GPU visible exits non-zero with the device error."""

import os

import pytest

from test_torch_dryrun import JAX_MODULES, REPO, imported, run_python

EXAMPLES = {
    "torch_demo.py": ("batched apply: (8, 256, 256) -> (8, 128, 128)",
                      "resize(method=): area mean"),
    "torch_grad_demo.py": ("adjoint identity:", "reconstruction rmse"),
    "torch_shear_serving_demo.py": ("mode=shear: dst (175, 175)",
                                    "(machine-exact)", "done."),
    "torch_sharded_demo.py": ("4 gloo rank(s) on cpu",
                              "sharded gradient steps (separable)",
                              "sharded gradient (rotated 45 deg",
                              "quadrant folded"),
}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_the_cpu(name, tmp_path):
    args = [os.path.join(REPO, "examples", name), "--device", "cpu"]
    if name == "torch_demo.py":
        args += ["--cache-dir", str(tmp_path)]
    proc = run_python(args, 300)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-4000:]
    for want in EXAMPLES[name]:
        assert want in proc.stdout, (want, proc.stdout)
    mods = imported(proc.stderr)
    assert "aainterp_torch" in mods
    assert not mods & set(JAX_MODULES), mods & set(JAX_MODULES)


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_without_a_gpu_says_so(name):
    proc = run_python([os.path.join(REPO, "examples", name)], 120,
                      CUDA_VISIBLE_DEVICES="")
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in proc.stderr
