"""Gradient-based use of the port's differentiable apply
(``aainterp_torch.autodiff``), the counterpart of examples/grad_demo.py.

Run:  python examples/torch_grad_demo.py                 (an NVIDIA GPU)
      python examples/torch_grad_demo.py --device cpu    (plain PyTorch)

The resampling operator is linear, so the port ships exact gradients:
the vector-Jacobian product of the apply is the transposed operator
(``SeparableLinear``, ``EllLinear``).  The forward-only C++ reference
has no analogue; this demo shows two things it therefore cannot do:

1. adjoint splatting: dst-grid data pushed back onto the source grid
   conservatively with ``apply_operator_transpose``;
2. gradient reconstruction: a high-resolution image recovered from its
   rotated area-averaged low-resolution measurement by gradient descent
   on ``|| A x - y ||^2`` with ``torch.autograd``.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import aainterp_torch as at  # noqa: E402


def device_of(name: str) -> torch.device:
    if name == "cuda" and not torch.cuda.is_available():
        sys.exit("--device cuda: torch.cuda.is_available() is False; pass "
                 "--device cpu to run on the CPU")
    return torch.device(name)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--iters", type=int, default=201)
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    rng = np.random.default_rng(0)

    # ground-truth high-res image: smooth blobs and a sharp box
    H = W = 96
    yy, xx = np.mgrid[0:H, 0:W]
    truth = (np.exp(-(((yy - 30) ** 2 + (xx - 40) ** 2) / 300.0))
             + 0.7 * np.exp(-(((yy - 70) ** 2 + (xx - 60) ** 2) / 120.0)))
    truth[20:28, 64:80] += 0.9
    truth = torch.as_tensor(truth.astype(np.float32), device=dev)

    # forward model: area-average downscale and an 8-degree rotation
    op = at.build_operator(at.make_grid_spec((H, W), 2.0, 1.0, (0.0, 0.0),
                                             8.0))
    fwd = lambda x: at.apply_operator(op, x, differentiable=True)
    y = fwd(truth)
    y_noisy = y + 0.01 * torch.as_tensor(
        rng.normal(size=tuple(y.shape)).astype(np.float32), device=dev)
    print(f"forward model: {tuple(truth.shape)} -> {tuple(y.shape)} at 8 deg")

    # 1. adjoint splatting: <A u, v> == <u, A^T v> (to float rounding)
    v = torch.as_tensor(rng.uniform(-1, 1, tuple(y.shape)).astype(
        np.float32), device=dev)
    lhs = float(torch.vdot(fwd(truth).flatten().double(),
                           v.flatten().double()))
    rhs = float(torch.vdot(truth.flatten().double(),
                           at.apply_operator_transpose(op, v).flatten()
                           .double()))
    print(f"adjoint identity: <Au,v>={lhs:.6f}  <u,A^Tv>={rhs:.6f}")

    # 2. gradient reconstruction of the high-res image; lr < 1 /
    #    sigma_max(A)^2 (~1.19 for this normalised operator)
    def loss(x):
        r = fwd(x) - y_noisy
        return (r * r).sum()

    x = torch.zeros_like(truth)
    lr = 0.7
    for it in range(args.iters):
        x.requires_grad_(True)
        (g,) = torch.autograd.grad(loss(x), x)
        x = (x - lr * g).detach()
        if it % 50 == 0:
            err = float(((x - truth) ** 2).mean().sqrt())
            print(f"  iter {it:3d}  loss {float(loss(x)):.5f}  "
                  f"rmse vs truth {err:.4f}")
    final = float(((x - truth) ** 2).mean().sqrt())
    base = float((truth ** 2).mean().sqrt())
    print(f"reconstruction rmse {final:.4f} (signal rms {base:.4f}), "
          f"recovered from a {y.shape[0]}x{y.shape[1]} rotated area-average "
          "measurement")


if __name__ == "__main__":
    main()
