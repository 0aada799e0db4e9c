"""``aainterp_torch.parallel.dryrun.dryrun_multichip(4)``: one step of
every sharded path of the port, gradients included, over 4 gloo ranks on
the CPU at tiny shapes, each result held against the unsharded apply or
transpose (the checks and tolerances are the dry run's own, in
``dryrun.py``).  It runs in a subprocess of its own with a time limit, and
``-X importtime`` shows that neither it nor its ranks load jax or the JAX
package."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_MODULES = ("jax", "jaxlib", "aainterp")


def imported(stderr: str) -> set:
    """The top-level packages of the modules in ``-X importtime`` lines."""
    return {line.rsplit("|", 1)[-1].strip().split(".")[0]
            for line in stderr.splitlines() if line.startswith("import time:")}


def run_python(args, timeout: float, **env_extra):
    env = dict(os.environ, PYTHONPATH=REPO, **env_extra)
    return subprocess.run([sys.executable, "-X", "importtime"] + args,
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_dryrun_multichip_4():
    proc = run_python(["-m", "aainterp_torch.parallel.dryrun", "4"], 300)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-4000:]
    line = proc.stdout.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip OK: 4 gloo ranks, mesh (2, 2) "
                           "and (1, 2, 2)"), line
    for what in ("gradients separable (4, 64, 64) + rotated (4, 64, 64)",
                 "2-D gradients ((2, 64, 64), (2, 64, 64))"):
        assert what in line, line
    assert "aainterp_torch" in imported(proc.stderr)
    assert not imported(proc.stderr) & set(JAX_MODULES)
