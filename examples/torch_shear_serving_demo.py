"""mode='shear' in the port: approximate rotated serving, the
counterpart of examples/shear_serving_demo.py.

Run:  python examples/torch_shear_serving_demo.py                (GPU)
      python examples/torch_shear_serving_demo.py --device cpu

The 3-pass conservative shear decomposition (``ops/shear3.py``) beside
the exact and fast modes, its two accuracy points (quality / fast), its
exact flux conservation and its exact gradient (``Shear3Linear``).
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import aainterp_torch as at  # noqa: E402
from aainterp_torch.ops.shear3 import (  # noqa: E402
    apply_shear3_np, build_shear3_plan,
)


def device_of(name: str) -> torch.device:
    if name == "cuda" and not torch.cuda.is_available():
        sys.exit("--device cuda: torch.cuda.is_available() is False; pass "
                 "--device cpu to run on the CPU")
    return torch.device(name)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    H = W = 256
    yy, xx = np.mgrid[0:H, 0:W]
    dose = np.exp(-(((xx - 140) / 40.0) ** 2 + ((yy - 110) / 30.0) ** 2))
    src = torch.as_tensor(dose.astype(np.float32), device=dev)
    iso = (W / 2.0, H / 2.0)

    print("== rotated downscale, three weight modes ==")
    outs = {}
    for mode in ("exact", "fast", "shear"):
        r = at.area_average_interpolate(src, 1.0, 0.5, iso, 30.0, mode=mode)
        outs[mode] = r.dst.double().cpu().numpy()
        print(f"  mode={mode:5s}: dst {outs[mode].shape}, "
              f"sum {outs[mode].sum():.4f}")
    for m in ("fast", "shear"):
        d = outs[m] - outs["exact"]
        print(f"  {m:5s} vs exact: rms {np.sqrt((d ** 2).mean()):.5f}  "
              f"max {np.abs(d).max():.5f}")

    print("\n== the 'fast' decomposition (reduce first) ==")
    r_fast = at.area_average_interpolate(src, 1.0, 0.5, iso, 30.0,
                                         mode="shear",
                                         shear_decomposition="fast")
    d = r_fast.dst.double().cpu().numpy() - outs["exact"]
    print(f"  rms vs exact {np.sqrt((d ** 2).mean()):.5f} (the "
          "smooth-content contract)")

    print("\n== exact flux conservation (the mode's hard invariant) ==")
    spec = at.make_grid_spec((H, W), 1.0, 0.5, iso, 30.0)
    plan = build_shear3_plan(spec)
    interior = np.zeros((H, W))
    interior[64:-64, 64:-64] = dose[64:-64, 64:-64]
    un = apply_shear3_np(plan, interior, normalize=False)
    print(f"  flux in  {interior.sum() * spec.scale ** 2:.9f}")
    print(f"  flux out {un.sum() * spec.dst_side ** 2:.9f}  (machine-exact)")

    print("\n== differentiable serving (Shear3Linear) ==")
    x = src.clone().requires_grad_(True)
    r = at.area_average_interpolate(x, 1.0, 1.0, iso, 20.0, mode="shear",
                                    differentiable=True)
    (g,) = torch.autograd.grad((r.dst ** 2).sum(), x)
    print(f"  grad shape {tuple(g.shape)}, |g| max "
          f"{float(g.abs().max()):.4f}")
    print("\ndone.")


if __name__ == "__main__":
    main()
