"""The CUDA kernel ``aainterp_torch/csrc/separable_apply.cu`` against its
plain PyTorch version, on a GPU.

Skips without ``torch.cuda.is_available()``.  Imports no JAX, so it runs
on a machine with only PyTorch; there, skip the repo's conftest (which
sets up JAX) from the repo root:

    python -m pytest --noconftest -m cuda tests/test_torch_kernel_cuda.py

Tolerances, kernel against plain: f32 atol 1e-5 on [0, 1] inputs; bf16
output atol 1e-2 (one bf16 ulp on [0, 1]); uint8 within one gray level.
"""

import numpy as np
import pytest
import torch

import aainterp_torch as at
from aainterp_torch.ops import cuda_apply

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


def _tables(H, W, sr, dr, angle=0.0, iso=(0.0, 0.0)):
    op = at.build_operator(at.make_grid_spec((H, W), sr, dr, iso, angle))
    return op, at.separable_linear_for(op, torch.float32, "kernel").tables


def _frames(shape, dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.rand(shape, generator=g, device=device)
    return (x * 255).round().to(torch.uint8) if dtype == torch.uint8 \
        else x.to(dtype)


GEOMS = [
    (256, 512, 2.0, 1.0, 0.0, (0.0, 0.0)),
    (512, 768, 150.0, 60.0, 90.0, (0.0, 0.0)),
    (384, 640, 4.0, 1.0, 180.0, (0.0, 0.0)),
    (128, 256, 1.0, 2.0, 270.0, (0.0, 0.0)),
    (128, 250, 2.0, 1.0, 0.0, (0.0, 0.0)),      # odd width
    (24, 24, 2.0, 1.0, 0.0, (4.0, 4.0)),        # band wider than the image
    (60, 2000, 40.0, 1.0, 0.0, (0.0, 0.0)),     # heavy downscale
]


@pytest.mark.parametrize("H,W,sr,dr,angle,iso", GEOMS)
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 1e-2),
                                        (torch.uint8, 1.0)])
def test_kernel_matches_plain(cuda, H, W, sr, dr, angle, iso, dtype, atol):
    _, tabs = _tables(H, W, sr, dr, angle, iso)
    x = _frames((3, H, W), dtype, cuda)
    before = cuda_apply.LAUNCHES
    got = cuda_apply.apply_separable_kernel(x, *tabs)
    torch.cuda.synchronize()
    assert cuda_apply.LAUNCHES == before + 1
    assert got.dtype == dtype and got.is_cuda
    want = cuda_apply.apply_separable_plain(x, *tabs)
    err = (got.double() - want.double()).abs().max().item()
    assert err <= atol, err


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16,
                                       torch.float16])
def test_kernel_explicit_out_dtype(cuda, out_dtype):
    _, tabs = _tables(256, 512, 150.0, 60.0)
    x = _frames((2, 256, 512), torch.uint8, cuda)
    got = cuda_apply.apply_separable_kernel(x, *tabs, out_dtype=out_dtype)
    want = cuda_apply.apply_separable_plain(x, *tabs, out_dtype=out_dtype)
    assert got.dtype == out_dtype
    assert (got.double() - want.double()).abs().max().item() <= 1.0


def test_kernel_rounds_half_to_even(cuda):
    # a 2x box mean of (1, 2) pairs is exactly 1.5 and of (2, 3) 2.5:
    # half to even gives 2 and 2 (roundf would give 2 and 3)
    op = at.build_operator(at.make_grid_spec((2, 4), 2.0, 1.0, (0.5, 0.5),
                                             0.0))
    tabs = at.separable_linear_for(op, torch.float32, "kernel").tables
    x = torch.tensor([[[1, 2, 2, 3], [1, 2, 2, 3]]], dtype=torch.uint8,
                     device=cuda)
    got = cuda_apply.apply_separable_kernel(x, *tabs)
    assert got.cpu().tolist() == [[[2, 2]]]


def test_kernel_2d_and_api_quadrants(cuda):
    H, W = 240, 320
    x = _frames((H, W), torch.float32, cuda)
    for angle in (0.0, 90.0, 180.0, 270.0):
        op = at.build_operator(at.make_grid_spec((H, W), 2.0, 1.0,
                                                 (0.0, 0.0), angle))
        before = cuda_apply.LAUNCHES
        got = at.apply_operator(op, x)
        assert cuda_apply.LAUNCHES == before + 1
        want = at.apply_operator(op, x, impl="banded")
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def test_kernel_gradient_runs_kernel(cuda):
    H, W = 96, 160
    for angle in (0.0, 90.0, 180.0, 270.0):
        op = at.build_operator(at.make_grid_spec((H, W), 150.0, 60.0,
                                                 (0.0, 0.0), angle))
        x = _frames((2, H, W), torch.float32, cuda)
        xk = x.clone().requires_grad_(True)
        yk = at.apply_operator(op, xk)
        g = torch.rand_like(yk)
        before = cuda_apply.LAUNCHES
        (gk,) = torch.autograd.grad(yk, xk, g)
        assert cuda_apply.LAUNCHES == before + 1
        xp = x.clone().requires_grad_(True)
        (gp,) = torch.autograd.grad(
            at.apply_operator(op, xp, impl="banded"), xp, g)
        torch.testing.assert_close(gk, gp, atol=1e-5, rtol=0)


def test_kernel_rejects_bad_input(cuda):
    _, tabs = _tables(64, 96, 2.0, 1.0)
    x = _frames((2, 96, 64), torch.float32, cuda).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_apply.apply_separable_kernel(x, *tabs)


def test_kernel_matches_dense_reference(cuda):
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, (2, 64, 96))
    op = at.build_operator(at.make_grid_spec((64, 96), 150.0, 60.0,
                                             (1.0, 2.0), 90.0))
    wy, wx = op.dense()
    ref = wy @ np.rot90(a, -1, axes=(-2, -1)) @ wx.T
    got = at.area_average_interpolate(
        torch.tensor(a, dtype=torch.float32, device=cuda), 150.0, 60.0,
        (1.0, 2.0), 90.0).dst
    np.testing.assert_allclose(got.cpu().double().numpy(), ref, atol=1e-5)
