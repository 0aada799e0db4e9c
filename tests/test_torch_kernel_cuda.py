"""The CUDA kernels ``aainterp_torch/csrc/separable_apply.cu``,
``aainterp_torch/csrc/ell_shear.cu``, ``aainterp_torch/csrc/shear3_stage.cu``
and ``aainterp_torch/csrc/separable_apply_2d.cu`` against their plain
PyTorch versions, on a GPU.

Skips without ``torch.cuda.is_available()``.  Imports no JAX, so it runs
on a machine with only PyTorch; there, skip the repo's conftest (which
sets up JAX) from the repo root:

    python -m pytest --noconftest -m cuda tests/test_torch_kernel_cuda.py

Tolerances, kernel against plain: separable f32 atol 1e-5 on [0, 1]
inputs; bf16 output atol 1e-2 (one bf16 ulp on [0, 1]); uint8 within one
gray level.  Rotated: every shear form (vshear, hshear, the fused form)
bit-equal, into NaN-filled outputs at every start address mod 16, F 1 and
3, the smallest tile and an all-empty plan; contraction and route f32
atol 1e-6 on [0, 1] inputs (1e-6 * 255 for u8 input), bf16 within one
bf16 ulp of the plain f32 result.  Shear mode: each stage kernel against
its plain stage f32 atol 1e-6 and bf16 within one bf16 ulp (same sums in
the same order), and bit for bit into NaN-filled outputs on ragged tiles,
single lines, unaligned row pitches, u8 and mixed dtypes, empty tile rows
and the adjoint plans, and in the direct form (stages beyond shared memory)
for every (axis, form) and whole pipelines; the route within one bf16 ulp
(u8: one gray level) of the bf16-staged plain pipeline and within 2e-2 of the f32-staged one
(test_shear3.py:256-259); gradients atol 1e-5.  2-D banded-tile kernel:
f32 atol 1e-5 on [0, 1] inputs, bf16 within one bf16 ulp, uint8 within
one gray level; 'default' and 'bf16x3' rtol 1e-6 (the same bf16 operands
summed in the same order).  Its direct form (bands beyond shared memory):
bit-equal to the plain version in 'default' and 'bf16x3', into NaN-filled
outputs, at whole-image boxes, ragged widths, many frames, starts off the
edges, descending starts, the y pass's 16-byte chunks and the 4K -> 16 x 9
thumbnail through ``apply_operator``; and bit-equal to the staged form in
every mode where both run.  The rest of the rotated family: compat on the
kernel route as the exact operator's (1 fused shear + 1 contraction per
request); ``EllLinear``'s forward bit-equal to the kernel route and its
gradient within f32 atol 1e-5 (bf16: one bf16 ulp) of native autograd of
the plain gather (the scatter's atomics sum in no fixed order); fused
within 2e-4 of the host route (the JAX package's pin); the separable
transpose and variance on kernel 1 within f32 atol 1e-5 of the CPU.

The masked contraction (the route's) bit-equal to the unmasked one and to
its plain version on finite T, into NaN-filled outputs, with ragged spans,
empty rows and F > 8; on NaN T it writes 0 outside every span.  The
contraction's probes (``csrc/probes.cu``) into NaN-filled outputs, F 3
and 11, bf16 and f32, with T's rows 16-byte aligned and not: noweight
and the tiled share probes within f32 atol 1e-6 (bf16: one bf16 ulp) of
their plain versions, the pipelined form bit-equal to the route's tiled
contraction, and a plan without tiles raising for every tiled probe.  The copy
probe split over blocks (8 x 1024^2, odd widths) and kernel 1's probe
modes (``csrc/band_probes.cu``) bit-equal to their plain versions, into
0xFF-filled outputs, bf16, f32 and u8, F 1, 3 and 11, at a small and two
odd-pitch geometries (rows not 16-byte aligned), the first forms of stage
and stagey beside the stage ring; the walk's and the ring's persistent
grids against their tile counts; the stage ring at every ring depth that
fits (rgb1024's ratio 2.5, one row tile, upsampling, a 22-tap band); a
walk ring, a stage ring or u8 chunk buffers beyond the opt-in raising
before any launch.  rgb1024's x-only mode (``xonly``) and
the fused aligned regrid (``csrc/aligned_fused.cu``) bit-equal to their
plain versions into NaN-filled outputs: rgb1024, a ragged strip, one
row tile and an upsampling plan; config 5, ``c0`` offsets on odd widths and a dst row
split into chunks.  The dense-x mode (``densex``, ``csrc/dense_x.cu``, a
wgmma product on a bf16 split, its sums in the tensor cores' order) at
the same geometries within ``DENSEX_RTOL`` · max|plain| of its plain
version and of kernel 1 in f32, within one bf16 ulp in bf16, at a
width whose old form's shared memory refused it (12,000 columns), and
with its y pass from global memory where no TMA window takes the rows.
"""

import dataclasses

import numpy as np
import pytest
import torch

import aainterp_torch as at
from aainterp_torch import api as t_api
from aainterp_torch import autodiff as t_autodiff
from aainterp_torch import regrid as t_regrid
from aainterp_torch.ops import apply as apply_ops
from aainterp_torch.ops import (cuda_apply, cuda_apply_2d, cuda_shear,
                                cuda_shear3, shear3)
from aainterp_torch.ops import weights as t_weights

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    # TF32 off for this test only (restored after it)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
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


# ---------------------------------------------------------------------------
# the rotated apply's three kernels (csrc/ell_shear.cu)
# ---------------------------------------------------------------------------

ROT_GEOMS = [
    ((96, 128), 1.0, 0.5, (64.0, 48.0), 30.0, "exact"),
    ((128, 96), 1.0, 0.5, (40.0, 70.0), 120.0, "exact"),
    ((120, 120), 150.0, 25.4, (60.0, 60.0), 1.5, "fast"),
    ((80, 100), 1.0, 1.0, (50.0, 40.0), 300.5, "exact"),
]


def _bf16_ulp(x):
    a = x.double().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def _rot_plan(args):
    shape, sr, dr, iso, angle, mode = args
    op = at.build_operator(at.make_grid_spec(shape, sr, dr, iso, angle),
                           mode=mode)
    folded = op
    if op.spec.quadrant:
        folded = t_weights.fold_quadrant_ell(op)[0]
    return op, cuda_shear.kernel_plan(folded)


@pytest.mark.parametrize("args", ROT_GEOMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_shear_kernels_match_plain(cuda, args, dtype):
    _, plan = _rot_plan(args)
    q = _frames((3, plan.qH, plan.qW), dtype, cuda)
    before = dict(cuda_shear.LAUNCHES)
    s = cuda_shear.vshear_kernel(q, plan)
    t = cuda_shear.hshear_kernel(s, plan)
    t2 = cuda_shear.vhshear_kernel(q, plan)
    out = cuda_shear.contract_kernel(t, plan)
    torch.cuda.synchronize()
    assert {k: cuda_shear.LAUNCHES[k] - before[k] for k in before} == {
        "vshear": 1, "hshear": 1, "vhshear": 1, "contract": 1,
        "contract_unmasked": 0, "contract_direct": 0}
    assert torch.equal(s, cuda_shear.vshear_plain(q, plan))
    assert torch.equal(t, cuda_shear.hshear_plain(s, plan))
    assert torch.equal(t2, cuda_shear.vhshear_plain(q, plan))
    assert torch.equal(t2, t)
    assert out.dtype == dtype and out.shape == (3, plan.Hd, plan.Wd)
    ref = cuda_shear.contract_plain(t, plan, out_dtype=torch.float32)
    err = (out.double() - ref.double()).abs()
    if dtype == torch.float32:
        assert err.max().item() <= 1e-6
    else:
        assert (err <= _bf16_ulp(ref)).all()


@pytest.mark.parametrize("stage", ["vshear", "hshear", "vhshear"])
def test_shear_kernels_write_every_element(cuda, stage):
    _, plan = _rot_plan(ROT_GEOMS[0])
    if stage == "vshear":
        src = _frames((2, plan.qH, plan.qW), torch.float32, cuda)
        shape = (2, plan.TH, plan.qW)
    elif stage == "vhshear":
        src = _frames((2, plan.qH, plan.qW), torch.float32, cuda)
        shape = (2, plan.TH, plan.TW)
    else:
        src = _frames((2, plan.TH, plan.qW), torch.float32, cuda)
        shape = (2, plan.TH, plan.TW)
    out = torch.full(shape, float("nan"), device=cuda)
    getattr(cuda_shear, f"{stage}_kernel")(src, plan, out=out)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert torch.equal(out, getattr(cuda_shear, f"{stage}_plain")(src, plan))


def test_shear_kernels_reject_shapes_that_do_not_match_the_plan(cuda):
    _, plan = _rot_plan(ROT_GEOMS[0])
    before = dict(cuda_shear.LAUNCHES)
    bad = torch.zeros(2, plan.qH + 1, plan.qW, device=cuda)
    for fn in (cuda_shear.vshear_kernel, cuda_shear.hshear_kernel,
               cuda_shear.vhshear_kernel, cuda_shear.contract_kernel):
        with pytest.raises(ValueError, match="for this plan"):
            fn(bad, plan)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_shear.vshear_kernel(
            torch.zeros(2, plan.qW, plan.qH, device=cuda).transpose(1, 2),
            plan)
    assert cuda_shear.LAUNCHES == before


@pytest.mark.parametrize("args", ROT_GEOMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.uint8])
def test_rotated_api_routes(cuda, args, dtype):
    shape, sr, dr, iso, angle, mode = args
    op, _ = _rot_plan(args)
    x = _frames((2,) + shape, dtype, cuda)
    before = dict(cuda_shear.LAUNCHES)
    got = at.area_average_interpolate(x, sr, dr, iso, angle, mode=mode,
                                      operator=op).dst
    torch.cuda.synchronize()
    # the route: the fused shear (T straight from q), then the contraction
    assert {k: cuda_shear.LAUNCHES[k] - before[k] for k in before} == {
        "vshear": 0, "hshear": 0, "vhshear": 1, "contract": 1,
        "contract_unmasked": 0, "contract_direct": 0}
    want_dtype = torch.bfloat16 if dtype == torch.bfloat16 else torch.float32
    assert got.dtype == want_dtype and got.is_cuda
    scale = 255.0 if dtype == torch.uint8 else 1.0
    for impl in ("sheared", "gather"):
        ref = at.apply_operator(op, x, impl=impl)
        assert ref.dtype == torch.float32
        err = (got.double() - ref.double()).abs()
        if dtype == torch.bfloat16:
            assert (err <= _bf16_ulp(ref)).all(), impl
        else:
            assert err.max().item() <= 1e-6 * scale, impl


# odd source and sheared widths: rows start at every address mod 16
UNALIGNED_GEOMS = [
    ((77, 101), 1.0, 0.5, (50.0, 38.0), 30.0, "exact"),    # qW 101, TW 160
    ((101, 77), 1.0, 0.7, (30.0, 40.0), 17.0, "exact"),    # qW 77, TW 113
    ((77, 101), 1.0, 0.5, (50.0, 38.0), 250.0, "exact"),   # qW 101, TW 215
]
SHEAR_FORMS = ("vshear", "hshear", "vhshear")


def _shear_form_case(plan, form, dtype, F, device, in_off, out_off):
    """One shear form on frames and into a NaN-filled output, both views
    ``in_off`` / ``out_off`` elements into a buffer (so their rows start
    at other addresses mod 16); the kernel against its plain version."""
    src, dst = cuda_shear._form_shapes(plan, form)
    n_in, n_out = F * src[0] * src[1], F * dst[0] * dst[1]
    buf = torch.empty(n_in + 16, dtype=dtype, device=device)
    x = buf[in_off:in_off + n_in].view((F,) + src)
    x.copy_(_frames((F,) + src, dtype, device, seed=in_off))
    obuf = torch.full((n_out + 16,), float("nan"), dtype=dtype, device=device)
    out = obuf[out_off:out_off + n_out].view((F,) + dst)
    before = cuda_shear.LAUNCHES[form]
    got = getattr(cuda_shear, f"{form}_kernel")(x, plan, out=out)
    torch.cuda.synchronize()
    assert got is out and cuda_shear.LAUNCHES[form] == before + 1
    want = getattr(cuda_shear, f"{form}_plain")(x, plan)
    assert torch.equal(out, want), (form, dtype, F, in_off, out_off)
    # nothing written outside the output
    assert torch.isnan(obuf[:out_off]).all()
    assert torch.isnan(obuf[out_off + n_out:]).all()


@pytest.mark.parametrize("args", UNALIGNED_GEOMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("F", [1, 3])
def test_shear_forms_unaligned_into_nan_outputs(cuda, args, dtype, F):
    _, plan = _rot_plan(args)
    steps = 16 // torch.tensor([], dtype=dtype).element_size()
    for form in SHEAR_FORMS:
        for k in range(steps):                  # every start mod 16
            _shear_form_case(plan, form, dtype, F, cuda, k, (k * 3) % steps)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_shear_forms_smallest_tile(cuda, monkeypatch, dtype):
    # the last tile shape, which every accepted geometry fits, forced on
    # every form
    monkeypatch.setattr(cuda_shear, "_TILES", cuda_shear._TILES[-1:])
    for args in (ROT_GEOMS[0], UNALIGNED_GEOMS[2]):
        _, plan = _rot_plan(args)
        small = dataclasses.replace(plan, tiles={}, dev={})
        for form in SHEAR_FORMS:
            t = small.form_tiles(form)
            assert (t.TY, t.TX) == cuda_shear._TILES[-1]
            _shear_form_case(small, form, dtype, 3, cuda, 1, 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_shear_forms_all_empty_plan(cuda, dtype):
    # shifts that move every source element out of the output: every tile
    # is empty and the output all zero fill
    _, plan = _rot_plan(ROT_GEOMS[0])
    empty = dataclasses.replace(plan, gy=plan.gy + plan.TH,
                                hx=plan.hx + plan.TW, tiles={}, dev={})
    for form in SHEAR_FORMS:
        assert not empty.form_tiles(form).win.any()
        _shear_form_case(empty, form, dtype, 2, cuda, 0, 1)
        src, _ = cuda_shear._form_shapes(empty, form)
        x = _frames((2,) + src, dtype, cuda)
        assert not getattr(cuda_shear, f"{form}_kernel")(x, empty).any()


def test_rotated_dense_reference(cuda):
    rng = np.random.default_rng(1)
    a = rng.uniform(0, 1, (2, 48, 64))
    spec = at.make_grid_spec((48, 64), 1.0, 0.5, (32.0, 24.0), 30.0)
    op = at.build_operator(spec)
    ref = (op.dense() @ a.reshape(2, -1).T).T.reshape((2,) + spec.dst_shape)
    got = at.apply_operator(op, torch.tensor(a, dtype=torch.float32,
                                             device=cuda))
    np.testing.assert_allclose(got.cpu().double().numpy(), ref, atol=1e-6)


def test_rotated_wide_window_falls_back_before_launch(cuda):
    op = at.build_operator(at.make_grid_spec((64, 64), 20.0, 1.0,
                                             (32.0, 32.0), 30.0))
    x = _frames((2, 64, 64), torch.float32, cuda)
    before = dict(cuda_shear.LAUNCHES), t_api.SHEAR_PLAN_FALLBACKS
    with pytest.warns(RuntimeWarning, match="gather"):
        got = at.apply_operator(op, x)
    assert cuda_shear.LAUNCHES == before[0]
    assert t_api.SHEAR_PLAN_FALLBACKS == before[1] + 1
    torch.testing.assert_close(got, at.apply_operator(op, x, impl="gather"))
    with pytest.raises(ValueError, match="too large"):
        at.apply_operator(op, x, impl="kernel")


# ---------------------------------------------------------------------------
# the shear mode's two stage kernels (csrc/shear3_stage.cu)
# ---------------------------------------------------------------------------

SHEAR3_GEOMS = [
    ((96, 128), 1.0, 0.5, (64.0, 48.0), 30.0),     # band branch, quadrant 0
    ((80, 64), 1.0, 1.0, (32.0, 40.0), 30.0),      # s == L: translate + crop
    ((64, 96), 2.0, 1.5, (48.0, 32.0), 104.0),     # quadrant 1, scale 2
]


def _shear3_plans(args):
    """Forward and adjoint plans of every decomposition ``args`` admits."""
    spec = at.make_grid_spec(*args)
    decs = ("xyx", "yxy") if spec.scale < spec.dst_side else ("xyx",)
    plans = []
    for dec in decs:
        plan = shear3.build_shear3_plan(spec, dec)
        plans += [plan, shear3.transpose_shear3_plan(plan)]
    return plans


@pytest.mark.parametrize("args", SHEAR3_GEOMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_shear3_stages_match_plain(cuda, args, dtype):
    for plan in _shear3_plans(args):
        sp = shear3.stage_plan(plan)
        x = _frames((3,) + sp.src_shape, dtype, cuda)
        for i, st in enumerate(sp.stages):
            name = f"{st.axis}stage"
            kern = getattr(cuda_shear3, f"{name}_kernel")
            plain = getattr(shear3, f"{name}_plain")
            before = cuda_shear3.LAUNCHES[name]
            out = torch.full((3,) + st.out_shape, float("nan"), dtype=dtype,
                             device=cuda)
            got = kern(x, sp, i, out_dtype=dtype, out=out)
            torch.cuda.synchronize()
            assert got is out and cuda_shear3.LAUNCHES[name] == before + 1
            want = plain(x, sp, i, out_dtype=dtype)
            # same f32 sums in the same order, each product rounded first
            err = (got.double() - want.double()).abs()
            if dtype == torch.float32:
                assert err.max().item() <= 1e-6, (i, st.form)
            else:
                assert (err <= _bf16_ulp(want)).all(), (i, st.form)
            assert torch.isfinite(got.float()).all()
            x = want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.uint8])
def test_shear3_route_and_launches(cuda, dtype):
    shape, sr, dr, iso, angle = SHEAR3_GEOMS[0]
    x = _frames((2,) + shape, dtype, cuda)
    for dec in ("quality", "fast"):
        before = dict(cuda_shear3.LAUNCHES)
        got = at.area_average_interpolate(x, sr, dr, iso, angle, mode="shear",
                                          shear_decomposition=dec).dst
        torch.cuda.synchronize()
        axes = "xyx" if dec == "quality" else "yxy"
        assert {k: cuda_shear3.LAUNCHES[k] - before[k] for k in before} == {
            "ystage": axes.count("y"), "xstage": axes.count("x")}
        assert got.dtype == dtype and got.is_cuda
        plan = t_api._shear3_plan(at.make_grid_spec(shape, sr, dr, iso,
                                                    angle), dec)
        ref = shear3.apply_shear3_plain(x, plan, mid_dtype=torch.bfloat16)
        err = (got.double() - ref.double()).abs()
        if dtype == torch.bfloat16:
            assert (err <= _bf16_ulp(ref)).all()
        else:
            assert err.max().item() <= (1.0 if dtype == torch.uint8 else 1e-6)
        f32 = at.area_average_interpolate(x, sr, dr, iso, angle, mode="shear",
                                          method="plain",
                                          shear_decomposition=dec).dst
        scale = 255.0 if dtype == torch.uint8 else 1.0
        assert (got.double() - f32.double()).abs().max().item() <= \
            2e-2 * scale


def test_shear3_gradient_runs_the_kernels(cuda):
    shape, sr, dr, iso, angle = SHEAR3_GEOMS[2]
    x = _frames((2,) + shape, torch.float32, cuda)
    xk = x.clone().requires_grad_(True)
    yk = at.area_average_interpolate(xk, sr, dr, iso, angle, mode="shear",
                                     differentiable=True).dst
    g = torch.rand_like(yk)
    before = dict(cuda_shear3.LAUNCHES)
    (gk,) = torch.autograd.grad(yk, xk, g)
    assert sum(cuda_shear3.LAUNCHES[k] - before[k] for k in before) == 3
    xp = x.clone().requires_grad_(True)
    yp = at.area_average_interpolate(xp, sr, dr, iso, angle, mode="shear",
                                     method="plain").dst
    (gp,) = torch.autograd.grad(yp, xp, g)
    torch.testing.assert_close(yk, yp, atol=1e-6, rtol=0)
    torch.testing.assert_close(gk, gp, atol=1e-5, rtol=0)


def test_shear3_axis_aligned_kernel_is_the_separable_kernel(cuda):
    x = _frames((2, 96, 128), torch.bfloat16, cuda)
    before = cuda_apply.LAUNCHES
    got = at.area_average_interpolate(x, 2.0, 1.0, (0.0, 0.0), 0.0,
                                      mode="shear", method="kernel").dst
    assert cuda_apply.LAUNCHES == before + 1
    assert torch.equal(got, at.area_average_interpolate(
        x, 2.0, 1.0, (0.0, 0.0), 0.0).dst)
    plain = at.area_average_interpolate(x, 2.0, 1.0, (0.0, 0.0), 0.0,
                                        mode="shear", method="plain").dst
    assert plain.dtype == torch.float32        # the separable 'banded' route


def _synthetic_stage(axis, form, n_in, n_lines, *, d0=0.3, slope=0.6,
                     ratio=0.5, crop=3, inv_cov=True, seed=0):
    """A one-stage plan: shifts d0 + slope * line (steps of at most one
    cell), a 1-D overlap band at ``ratio`` output cells per input cell,
    and a random reciprocal coverage on its output."""
    delta = d0 + slope * np.arange(n_lines)
    d = np.floor(delta).astype(np.int32)
    f = (delta - d).astype(np.float32)
    n_t = n_in + int(d.max()) + 2
    band = None
    if form == shear3.PRE_BAND:
        n_mid = int(np.ceil(n_in * ratio)) + 2
        band = shear3._interval_band(0.0, ratio, n_in, n_mid)
        n_t = n_mid + int(d.max()) + 2
    elif form == shear3.POST_BAND:
        crop = 0
        band = shear3._interval_band(0.0, ratio, n_t,
                                     int(np.ceil(n_t * ratio)))
    n_out = band.n_dst if form == shear3.POST_BAND else n_t - crop
    p = shear3.Pass1D(axis=axis, band=band,
                      band_first=form == shear3.PRE_BAND, d=d, f=f, n_t=n_t,
                      crop=crop, n_out=n_out)
    st = shear3._stage(p, n_in, n_lines)
    cov = None
    if inv_cov:
        cov = np.random.default_rng(seed).uniform(
            0.5, 2.0, st.out_shape).astype(np.float32)
    return shear3.StagePlan(stages=(st,), inv_cov=cov, src_shape=st.in_shape,
                            dst_shape=st.out_shape)


def _nan_out(shape, dtype, device):
    if dtype == torch.uint8:
        return torch.full(shape, 77, dtype=dtype, device=device)
    return torch.full(shape, float("nan"), dtype=dtype, device=device)


def _stage_bit_equal(sp, i, x, out_dtype):
    st = sp.stages[i]
    name = f"{st.axis}stage"
    before = cuda_shear3.LAUNCHES[name]
    out = _nan_out((x.shape[0],) + st.out_shape, out_dtype, x.device)
    got = getattr(cuda_shear3, f"{name}_kernel")(x, sp, i, out_dtype=out_dtype,
                                                 out=out)
    torch.cuda.synchronize()
    assert got is out and cuda_shear3.LAUNCHES[name] == before + 1
    want = getattr(shear3, f"{name}_plain")(x, sp, i, out_dtype=out_dtype)
    assert torch.isfinite(got.float()).all(), (i, st.form)
    assert torch.equal(got, want), (i, st.axis, st.form,
                                    (got.double() - want.double()).abs().max())
    return got


_FORMS = {"translate": shear3.TRANSLATE, "pre": shear3.PRE_BAND,
          "post": shear3.POST_BAND}
# (axis, form, n_in, n_lines, F, in dtype, out dtype, synthetic kwargs)
STAGE_CASES = {
    # line counts and output lengths that are not multiples of the tile
    **{f"ragged_{a}_{k}": (a, k, 157, 203, 3, torch.bfloat16, torch.bfloat16,
                           {}) for a in "yx" for k in _FORMS},
    # a single line, one frame
    **{f"one_line_{a}_{k}": (a, k, 75, 1, 1, torch.float32, torch.float32, {})
       for a in "yx" for k in _FORMS},
    # rows whose byte pitch is not a multiple of 16
    "pitch_1399_y_bf16": ("y", "post", 40, 1399, 2, torch.bfloat16,
                          torch.bfloat16, {}),
    "pitch_1399_y_u8": ("y", "translate", 40, 1399, 2, torch.uint8,
                        torch.uint8, {}),
    "pitch_1399_x_bf16": ("x", "pre", 1399, 9, 2, torch.bfloat16,
                          torch.bfloat16, {}),
    "pitch_1399_x_u8": ("x", "post", 1399, 9, 2, torch.uint8, torch.uint8,
                        {}),
    # u8 in, f32 out of bf16 in, and an upsampling band
    "u8_in_f32_out_y": ("y", "pre", 130, 150, 2, torch.uint8, torch.float32,
                        {}),
    "bf16_in_f32_out_x": ("x", "post", 301, 33, 2, torch.bfloat16,
                          torch.float32, {"ratio": 1.7}),
    "f32_in_bf16_out_y": ("y", "post", 90, 130, 2, torch.float32,
                          torch.bfloat16, {"ratio": 2.5, "inv_cov": False}),
    # shifts far beyond the input: whole rows of tiles read nothing
    "empty_tile_rows_y": ("y", "translate", 40, 300, 2, torch.bfloat16,
                          torch.bfloat16, {"d0": 400.0, "slope": 0.9}),
    "empty_tile_rows_x": ("x", "translate", 900, 12, 2, torch.float32,
                          torch.float32, {"d0": 1500.0, "slope": 0.9}),
}


@pytest.mark.parametrize("case", sorted(STAGE_CASES))
def test_shear3_stage_kernel_cases_bit_equal(cuda, case):
    axis, form, n_in, n_lines, F, in_dtype, out_dtype, kw = STAGE_CASES[case]
    sp = _synthetic_stage(axis, _FORMS[form], n_in, n_lines, **kw)
    st = sp.stages[0]
    if case.startswith("ragged"):
        assert st.n_lines % st.tiles.TL and st.n_out % st.tiles.TU
    if case.startswith("empty"):
        empty = st.tiles.win[..., 1] <= st.tiles.win[..., 0]
        assert empty.all(axis=1).any()
    x = _frames((F,) + st.in_shape, in_dtype, cuda, seed=1)
    _stage_bit_equal(sp, 0, x, out_dtype)


@pytest.mark.parametrize("args", SHEAR3_GEOMS)
def test_shear3_adjoint_stages_bit_equal_f32(cuda, args):
    plans = _shear3_plans(args)
    for plan in plans[1::2]:                      # the adjoint plans
        sp = shear3.stage_plan(plan)
        x = _frames((2,) + sp.src_shape, torch.float32, cuda)
        for i in range(len(sp.stages)):
            x = _stage_bit_equal(sp, i, x, torch.float32)


def test_shear3_kernels_reject_bad_input(cuda):
    plan = _shear3_plans(SHEAR3_GEOMS[0])[0]
    sp = shear3.stage_plan(plan)
    st = sp.stages[0]
    before = dict(cuda_shear3.LAUNCHES)
    bad = torch.zeros((2, st.in_shape[1], st.in_shape[0]), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_shear3.xstage_kernel(bad.transpose(1, 2), sp, 0)
    with pytest.raises(ValueError, match="for this plan"):
        cuda_shear3.xstage_kernel(bad, sp, 0)
    with pytest.raises(ValueError, match="needs a CUDA"):
        at.area_average_interpolate(torch.zeros((96, 128)), 1.0, 0.5,
                                    (64.0, 48.0), 30.0, mode="shear",
                                    method="kernel")
    assert cuda_shear3.LAUNCHES == before


# ---------------------------------------------------------------------------
# the 2-D banded-tile kernel of the band-operator family
# (csrc/separable_apply_2d.cu)
# ---------------------------------------------------------------------------

BAND_GEOMS = {
    "regrid_aligned": ("regrid", (360, 720), (36, 72)),
    "regrid_2.5x": ("regrid", (360, 720), (144, 288)),
    "regrid_up": ("regrid", (18, 36), (40, 50)),
    "regrid_n_src_lt_band": ("regrid", (3, 3), (1, 1)),
    "resize_odd": ("resize", (200, 500), (90, 171)),
    "resize_up": ("resize", (96, 250), (336, 875)),
}


def _band_pair(name):
    kind, src, dst = BAND_GEOMS[name]
    if kind == "regrid":
        return src, t_regrid.conservative_regrid_operator(
            at.LatLonGrid(*src), at.LatLonGrid(*dst))
    return src, at.resize_bands(src, dst)


def _band_tabs(by, bx):
    return (by.start, by.weights.astype(np.float32), bx.start,
            bx.weights.astype(np.float32))


@pytest.mark.parametrize("name", sorted(BAND_GEOMS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.uint8])
@pytest.mark.parametrize("precision", ["auto", "default", "bf16x3"])
def test_kernel_2d_matches_plain(cuda, name, dtype, precision):
    src, (by, bx) = _band_pair(name)
    tabs = _band_tabs(by, bx)
    x = _frames((3,) + src, dtype, cuda)
    out = torch.full((3, by.n_dst, bx.n_dst), float("nan"), device=cuda
                     ).to(dtype)
    before = cuda_apply_2d.LAUNCHES
    got = cuda_apply_2d.apply_separable_kernel_2d(x, *tabs,
                                                  precision=precision, out=out)
    torch.cuda.synchronize()
    assert got is out and cuda_apply_2d.LAUNCHES == before + 1
    assert torch.isfinite(got.float()).all()
    want = cuda_apply_2d.apply_separable_2d_plain(x, *tabs,
                                                  precision=precision)
    err = (got.double() - want.double()).abs()
    if dtype == torch.uint8:
        assert err.max().item() <= 1.0
    elif precision != "auto":
        assert (err <= 1e-6 * want.double().abs() + 1e-30).all()
    elif dtype == torch.float32:
        assert err.max().item() <= 1e-5
    else:
        assert (err <= _bf16_ulp(want)).all()


def test_kernel_2d_rounds_half_to_even(cuda):
    # a 2-wide box mean of (1, 2) is exactly 1.5 and of (2, 3) 2.5: half to
    # even gives 2 and 2 (roundf would give 2 and 3)
    tabs = (np.zeros(1, np.int32), np.ones((1, 1), np.float32),
            np.array([0, 2], np.int32), np.full((2, 2), 0.5, np.float32))
    x = torch.tensor([[[1, 2, 2, 3]]], dtype=torch.uint8, device=cuda)
    got = cuda_apply_2d.apply_separable_kernel_2d(x, *tabs)
    assert got.dtype == torch.uint8 and got.cpu().tolist() == [[[2, 2]]]


def test_band_apply_routes_and_launches(cuda):
    src, (by, bx) = _band_pair("regrid_aligned")
    before = cuda_apply_2d.LAUNCHES
    x = _frames((2,) + src, torch.float32, cuda)
    aligned = at.apply_band_operators(x, by, bx, impl="aligned")
    assert cuda_apply_2d.LAUNCHES == before
    auto = at.apply_band_operators(x, by, bx)     # on the card: the kernel
    assert cuda_apply_2d.LAUNCHES == before + 1
    torch.testing.assert_close(auto, aligned, rtol=1e-6, atol=1e-6)
    for dtype in (torch.bfloat16, torch.uint8):
        xd = _frames((2,) + src, dtype, cuda)
        n = cuda_apply_2d.LAUNCHES
        got = at.apply_band_operators(xd, by, bx)
        assert cuda_apply_2d.LAUNCHES == n + 1 and got.dtype == dtype
        banded = at.apply_band_operators(xd, by, bx, impl="banded")
        assert banded.dtype == (torch.uint8 if dtype == torch.uint8
                                else torch.float32)
    # an input that requires grad stays on the kernel: one launch forward,
    # one backward on the transposed tables
    src, (by, bx) = _band_pair("regrid_2.5x")
    x = _frames((2,) + src, torch.float32, cuda)
    g = torch.rand((2, by.n_dst, bx.n_dst), device=cuda)
    xk = x.clone().requires_grad_(True)
    n = cuda_apply_2d.LAUNCHES
    (at.apply_band_operators(xk, by, bx) * g).sum().backward()
    assert cuda_apply_2d.LAUNCHES == n + 2
    xp = x.clone().requires_grad_(True)
    (at.apply_band_operators(xp, by, bx, impl="banded") * g).sum().backward()
    torch.testing.assert_close(xk.grad, xp.grad, rtol=1e-5, atol=1e-6)


def _band(starts, k, n_src, seed):
    """A band of ``k`` taps per dst index at ``starts`` over ``n_src``
    source indices, seeded positive weights, zero on taps outside the
    source (as every table of the port has)."""
    starts = np.asarray(starts, np.int32)
    w = np.random.default_rng(seed).uniform(0.5, 1.5, (starts.size, k))
    taps = starts[:, None].astype(np.int64) + np.arange(k)
    w[(taps < 0) | (taps >= n_src)] = 0.0
    return t_regrid.Band1D(start=starts, weights=w / w.sum(1, keepdims=True),
                           n_src=n_src, n_dst=starts.size)


# (F, H, W, y starts, ky, x starts, kx) of band pairs beyond shared memory:
# whole-image boxes; a ragged W (1001 columns, not a multiple of the y
# pass's 128) with Hd x Wd = 35 outputs a frame (beyond one x-pass block of
# 8) and 13 frames; starts off the image's edges; descending starts (a
# flipped quadrant) with windows in the middle of the image; enough
# columns for the y pass's 16-byte chunks, starts off the edges
DIRECT_CASES = {
    "boxes": (2, 400, 400, [0, 0, 0], 400, [0, 0, 0], 400),
    "ragged_many": (13, 300, 1001, [0, 10, 20, 40, 60], 240,
                    [0, 120, 300, 450, 600, 700, 761], 240),
    "edges": (3, 330, 517, [-37, 100, 200], 260, [-250, -3, 300], 260),
    "flipped": (2, 320, 640, [60, 40, 20, 0], 270, [370, 250, 130, 10], 260),
    # 8 x 9 x 1024 columns: the y pass's 16-byte chunks a thread
    "chunks_edges": (8, 300, 1024, [-40, -5, 0, 10, 20, 30, 35, 39, 40], 260,
                     [-200, 100, 500, 800], 260),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.uint8])
@pytest.mark.parametrize("precision", ["auto", "default", "bf16x3"])
@pytest.mark.parametrize("case", list(DIRECT_CASES))
def test_kernel_2d_wide_band_takes_the_direct_form(cuda, dtype, precision,
                                                   case):
    # one dst pixel's block beyond shared memory: the direct form, one
    # launch into a NaN-filled output, the plain version's bits in the bf16
    # modes
    F, H, W, ys, ky, xs, kx = DIRECT_CASES[case]
    by, bx = _band(ys, ky, H, 1), _band(xs, kx, W, 2)
    tabs = t_regrid.band_tables(by, bx)
    assert tabs.plan["direct"]
    x = _frames((F, H, W), dtype, cuda)
    out = torch.full((F, len(ys), len(xs)), float("nan"),
                     device=cuda).to(dtype)
    before = cuda_apply_2d.LAUNCHES
    got = cuda_apply_2d.apply_separable_kernel_2d(
        x, tabs.ys, tabs.yw, tabs.xs, tabs.xw, precision=precision, out=out,
        plan=tabs.plan)
    torch.cuda.synchronize()
    assert got is out and cuda_apply_2d.LAUNCHES == before + 1
    assert torch.isfinite(got.float()).all()
    want = cuda_apply_2d.apply_separable_2d_plain(
        x, tabs.ys, tabs.yw, tabs.xs, tabs.xw, precision=precision)
    err = (got.double() - want.double()).abs()
    if precision != "auto":
        assert torch.equal(got, want)
    elif dtype == torch.uint8:
        assert err.max().item() <= 1.0
    elif dtype == torch.float32:
        assert err.max().item() <= 1e-5
    else:
        assert (err <= _bf16_ulp(want)).all()
    n = cuda_apply_2d.LAUNCHES
    routed = at.apply_band_operators(x, by, bx, precision=precision)
    assert cuda_apply_2d.LAUNCHES == n + 1
    assert torch.equal(routed, got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.uint8])
def test_kernel_2d_direct_form_thumbnail(cuda, dtype):
    # 4K -> 16 x 9 through apply_operator: kernel 1's planner hands the
    # 242-tap bands to kernel 2, whose direct form takes them
    op, tabs = _tables(2160, 3840, 240.0, 1.0)
    assert cuda_apply._plan_for(*tabs)["kernel_2d"]
    assert cuda_apply_2d.kernel_plan(*tabs)["direct"]
    x = _frames((8, 2160, 3840), dtype, cuda)
    before = cuda_apply_2d.LAUNCHES
    got = at.apply_operator(op, x)
    torch.cuda.synchronize()
    assert cuda_apply_2d.LAUNCHES == before + 1
    # u8 frames give f32, as the separable path does for u8 input
    assert got.dtype == (torch.float32 if dtype == torch.uint8 else dtype)
    assert tuple(got.shape) == (8, 9, 16)
    assert torch.equal(got, cuda_apply_2d.apply_separable_kernel_2d(
        x, *tabs, out_dtype=got.dtype))
    for precision in ("auto", "default", "bf16x3"):
        out = torch.full((8, 9, 16), float("nan"), device=cuda).to(dtype)
        k = cuda_apply_2d.apply_separable_kernel_2d(x, *tabs,
                                                    precision=precision,
                                                    out=out)
        want = cuda_apply_2d.apply_separable_2d_plain(x, *tabs,
                                                      precision=precision)
        torch.cuda.synchronize()
        assert k is out and torch.isfinite(k.float()).all()
        if precision != "auto":
            assert torch.equal(k, want)
        elif dtype == torch.bfloat16:
            assert ((k.double() - want.double()).abs()
                    <= _bf16_ulp(want)).all()
        else:
            assert (k.double() - want.double()).abs().max().item() <= (
                1.0 if dtype == torch.uint8 else 1e-5)


@pytest.mark.parametrize("out_dtype", [None, torch.float32, torch.uint8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.uint8])
@pytest.mark.parametrize("precision", ["auto", "default", "bf16x3"])
@pytest.mark.parametrize("W,vec_min", [(1003, 0), (1024, 0),
                                       (1024, 1 << 40)],
                         ids=["ragged", "chunks", "columns"])
def test_kernel_2d_direct_form_equals_staged_form(cuda, monkeypatch, W,
                                                  vec_min, precision, dtype,
                                                  out_dtype):
    # a band pair both forms can run, the direct form forced by a plan
    # with no shared memory: the same sums in the same order, the same
    # bits in every mode, with the y pass's 16-byte chunks a thread (W
    # 1024) and a column a thread (rows of 1003, or chunks turned off);
    # starts off the edges
    monkeypatch.setattr(cuda_apply_2d, "VEC_MIN_COLUMNS", vec_min)
    by = _band([-3, 20, 41, 62, 83, 104, 125, 146, 167], 24, 181, 3)
    bx = _band(np.arange(-5, W, 20), 26, W, 4)
    tabs = (by.start, by.weights.astype(np.float32), bx.start,
            bx.weights.astype(np.float32))
    staged = cuda_apply_2d.make_plan(*tabs)
    monkeypatch.setattr(cuda_apply_2d, "SMEM_LIMIT", 0)
    direct = cuda_apply_2d.make_plan(*tabs)
    assert not staged["direct"] and direct["direct"]
    x = _frames((5, 181, W), dtype, cuda)
    got = {}
    for name, plan in (("staged", staged), ("direct", direct)):
        want_dtype = out_dtype or dtype
        out = torch.full((5, 9, bx.n_dst), float("nan"),
                         device=cuda).to(want_dtype)
        got[name] = cuda_apply_2d.apply_separable_kernel_2d(
            x, *tabs, precision=precision, out_dtype=out_dtype, out=out,
            plan=plan)
    torch.cuda.synchronize()
    assert torch.isfinite(got["direct"].float()).all()
    assert torch.equal(got["direct"], got["staged"])


def test_front_doors_on_the_kernel(cuda):
    x = _frames((2, 270, 480), torch.bfloat16, cuda)
    before = cuda_apply_2d.LAUNCHES
    got = at.area_resize(x, (160, 283))
    assert cuda_apply_2d.LAUNCHES == before + 1 and got.dtype == torch.bfloat16
    ref = at.area_resize(x, (160, 283), impl="banded")
    assert (((got.double() - ref.double()).abs()) <= _bf16_ulp(ref)).all()
    levels = at.area_pyramid(x[0], 4)
    assert [tuple(v.shape) for v in levels] == [(270, 480), (135, 240),
                                                (68, 120), (34, 60)]
    assert cuda_apply_2d.LAUNCHES == before + 4
    # numpy input goes to the GPU by default
    out = at.area_resize(np.ones((2, 30, 40), np.float32), (7, 9))
    assert out.is_cuda


# ---------------------------------------------------------------------------
# the redesigned separable kernels (csrc/band_apply.cuh): raw windows at any
# row alignment, ragged strips and row tiles, every element written, and
# kernel 1's route to kernel 2 for bands beyond shared memory
# ---------------------------------------------------------------------------

# (H, W, sr, dr, angle): rows of 1399 bf16 (2798 bytes) and 1001 u8 cells are
# not multiples of 16 bytes; dst widths and heights leave ragged last strips
# and row tiles
STAGED_GEOMS = [
    (121, 1399, 2.0, 1.0, 0.0),
    (121, 1399, 2.0, 1.0, 90.0),
    (300, 1001, 3.0, 2.0, 180.0),
    (97, 1001, 150.0, 60.0, 270.0),
    (2, 3, 1.0, 2.5, 0.0),          # one row tile, one strip, upscale
]


@pytest.mark.parametrize("g", STAGED_GEOMS, ids=lambda g: f"{g[0]}x{g[1]}"
                         f"@{g[4]:g}")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.uint8])
def test_staged_kernels_unaligned_rows_into_nan_outputs(cuda, g, dtype):
    H, W, sr, dr, angle = g
    _, tabs = _tables(H, W, sr, dr, angle)
    x = _frames((3, H, W), dtype, cuda, seed=2)
    Hd, Wd = tabs[1].shape[0], tabs[3].shape[0]
    plan = cuda_apply._plan_for(*tabs)
    assert not plan["kernel_2d"]
    if Hd > 16:
        assert Hd % plan["TY"] or Wd % plan["TX"]
    out = _nan_out((3, Hd, Wd), dtype, cuda)
    n1, n2 = cuda_apply.LAUNCHES, cuda_apply_2d.LAUNCHES
    got = cuda_apply.apply_separable_kernel(x, *tabs, out=out)
    torch.cuda.synchronize()
    assert got is out and cuda_apply.LAUNCHES == n1 + 1
    assert cuda_apply_2d.LAUNCHES == n2
    want = cuda_apply.apply_separable_plain(x, *tabs)
    err = (got.double() - want.double()).abs().max().item()
    assert err <= {torch.float32: 1e-5, torch.bfloat16: 1e-2,
                   torch.uint8: 1.0}[dtype], err
    if dtype == torch.uint8:
        assert (got != 77).any()
    # kernel 2 on the same tables: 'default' and 'bf16x3' bit-equal to plain
    for precision in ("default", "bf16x3"):
        out2 = _nan_out((3, Hd, Wd), dtype, cuda)
        got2 = cuda_apply_2d.apply_separable_kernel_2d(
            x, *tabs, precision=precision, out=out2)
        torch.cuda.synchronize()
        want2 = cuda_apply_2d.apply_separable_2d_plain(x, *tabs,
                                                       precision=precision)
        assert torch.equal(got2, want2), (precision, (
            got2.double() - want2.double()).abs().max().item())
    assert cuda_apply_2d.LAUNCHES == n2 + 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.uint8])
def test_kernel_1_band_beyond_shared_memory_takes_kernel_2(cuda, dtype):
    # one dst column reads 30,000 source columns (above the 24,576 kernel 1
    # took before): the route is kernel 2, chosen on the host, 1 launch
    ys = np.arange(0, 8, 2, dtype=np.int32)
    yw = np.full((4, 2), 0.5, np.float32)
    xs = np.zeros(1, np.int32)
    xw = np.full((1, 30000), 1 / 30000, np.float32)
    assert cuda_apply._plan_for(ys, yw, xs, xw)["kernel_2d"]
    x = _frames((2, 8, 30000), dtype, cuda, seed=3)
    n1, n2 = cuda_apply.LAUNCHES, cuda_apply_2d.LAUNCHES
    got = cuda_apply.apply_separable_kernel(x, ys, yw, xs, xw)
    torch.cuda.synchronize()
    assert (cuda_apply.LAUNCHES, cuda_apply_2d.LAUNCHES) == (n1, n2 + 1)
    assert got.dtype == dtype and tuple(got.shape) == (2, 4, 1)
    want = cuda_apply.apply_separable_plain(x, ys, yw, xs, xw)
    # a 30,000-term f32 sum in another order: 1e-4 on means of [0, 1]
    atol = 1.0 if dtype == torch.uint8 else 1e-4
    assert (got.double() - want.double()).abs().max().item() <= atol


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_shear3_stage_beyond_shared_memory_direct_form_bit_equal(cuda,
                                                                 out_dtype):
    # 8192^2 at 30 deg, 1.0 -> 1/3000, 'fast': stage 0's smallest tile needs
    # 290,208 bytes of shared memory; its direct form equals the plain stage
    spec = at.make_grid_spec((8192, 8192), 1.0, 1 / 3000, (4096.0, 4096.0),
                             30.0)
    sp = shear3.stage_plan(t_api._shear3_plan(spec, "fast"))
    assert sp.stages[0].tiles.direct
    in_dtype = torch.float32 if out_dtype == torch.float32 else torch.bfloat16
    x = _frames((1, 8192, 8192), in_dtype, cuda, seed=4)
    _stage_bit_equal(sp, 0, x, out_dtype)


@pytest.mark.parametrize("axis,form", [(a, k) for a in "yx" for k in _FORMS])
def test_shear3_direct_form_every_stage_form_bit_equal(cuda, monkeypatch, axis,
                                                       form):
    # with no shared memory to spare every stage takes the direct form: each
    # (axis, form), with the reciprocal coverage of the plan's last stage
    # (indexed (out row, line) along y and (line, out cell) along x)
    monkeypatch.setattr(shear3, "SMEM_LIMIT", 0)
    sp = _synthetic_stage(axis, _FORMS[form], 157, 203)
    assert sp.stages[0].tiles.direct and sp.inv_cov is not None
    for in_dtype, out_dtype in ((torch.float32, torch.float32),
                                (torch.bfloat16, torch.bfloat16),
                                (torch.bfloat16, torch.float32)):
        x = _frames((2,) + sp.stages[0].in_shape, in_dtype, cuda, seed=7)
        _stage_bit_equal(sp, 0, x, out_dtype)


@pytest.mark.parametrize("dec", ["xyx", "yxy"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_shear3_direct_form_pipelines_bit_equal(cuda, monkeypatch, dec, dtype):
    # every stage of a decomposition and of its adjoint in the direct form:
    # stage by stage and through the whole pipeline, equal to the plain one
    monkeypatch.setattr(shear3, "SMEM_LIMIT", 0)
    monkeypatch.setattr(shear3, "_STAGE_CACHE", type(shear3._STAGE_CACHE)(
        16, max_bytes=1 << 30))
    plan = shear3.build_shear3_plan(at.make_grid_spec(*SHEAR3_GEOMS[0]), dec)
    for p in (plan, shear3.transpose_shear3_plan(plan)):
        sp = shear3.stage_plan(p)
        assert all(st.tiles.direct for st in sp.stages)
        x0 = _frames((2,) + sp.src_shape, dtype, cuda, seed=8)
        x = x0
        for i in range(len(sp.stages)):
            x = _stage_bit_equal(sp, i, x, dtype)
        before = dict(cuda_shear3.LAUNCHES)
        got = cuda_shear3.apply_shear3_kernel(x0, p, mid_dtype=dtype)
        torch.cuda.synchronize()
        assert sum(cuda_shear3.LAUNCHES[k] - before[k] for k in before) == 3
        assert torch.equal(got, shear3.apply_shear3_plain(x0, p,
                                                          mid_dtype=dtype))


# ---------------------------------------------------------------------------
# the rest of the exact rotated family on the card: compat, EllLinear, fused
# ---------------------------------------------------------------------------

COMPAT_GEOMS = [
    ((96, 96), 1.0, 0.5, (48.0, 48.0), 30.0),
    ((96, 80), 1.0, 0.5, (40.0, 48.0), 120.0),     # quadrant 1
]


@pytest.mark.parametrize("args", COMPAT_GEOMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_compat_kernel_route_matches_gather(cuda, args, dtype):
    op = at.build_operator(at.make_grid_spec(*args), mode="compat")
    assert op.mode == "compat" and op.window == 10
    x = _frames((3,) + args[0], dtype, cuda)
    before = dict(cuda_shear.LAUNCHES), t_api.SHEAR_PLAN_FALLBACKS
    got = at.area_average_interpolate(x, *args[1:], mode="compat").dst
    torch.cuda.synchronize()
    assert {k: cuda_shear.LAUNCHES[k] - before[0][k] for k in before[0]} == {
        "vshear": 0, "hshear": 0, "vhshear": 1, "contract": 1,
        "contract_unmasked": 0, "contract_direct": 0}
    assert t_api.SHEAR_PLAN_FALLBACKS == before[1]
    assert got.dtype == dtype
    ref = at.apply_operator(op, x, impl="gather")
    err = (got.double() - ref.double()).abs()
    if dtype == torch.float32:
        assert err.max().item() <= 1e-6
    else:
        assert (err <= _bf16_ulp(ref)).all()


@pytest.mark.parametrize("angle", [30.0, 120.0, 210.0, 300.5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ell_linear_kernel_route_gradient(cuda, angle, dtype):
    args = ((96, 80), 1.0, 0.5, (40.0, 48.0), angle)
    op = at.build_operator(at.make_grid_spec(*args))
    x = _frames((2,) + args[0], dtype, cuda, seed=3)
    plain = at.apply_operator(op, x)                     # the kernel route
    xk = x.clone().requires_grad_(True)
    before = dict(cuda_shear.LAUNCHES), t_api.SHEAR_PLAN_FALLBACKS
    y = at.apply_operator(op, xk, differentiable=True)
    g = _frames(tuple(y.shape), torch.float32, cuda, seed=4).to(dtype)
    (gk,) = torch.autograd.grad(y, xk, g)
    torch.cuda.synchronize()
    assert {k: cuda_shear.LAUNCHES[k] - before[0][k] for k in before[0]} == {
        "vshear": 0, "hshear": 0, "vhshear": 1, "contract": 1,
        "contract_unmasked": 0, "contract_direct": 0}
    assert t_api.SHEAR_PLAN_FALLBACKS == before[1]
    assert torch.equal(y.detach(), plain) and gk.dtype == dtype
    # native autograd of the plain gather on the unfolded tables
    base, w = t_autodiff.ell_tables(op, torch.float32, cuda)
    xp = x.float().clone().requires_grad_(True)
    yp = apply_ops.apply_ell(apply_ops.quadrant_rotate(xp, op.spec.quadrant),
                             base, w)
    (gp,) = torch.autograd.grad(yp, xp, g.float())
    # the scatter's atomics sum each source cell's terms in no fixed order
    tol = 1e-5 if dtype == torch.float32 else None
    if tol is None:
        assert ((gk.double() - gp.double()).abs()
                <= _bf16_ulp(gp) + 1e-6).all()
    else:
        assert (gk.double() - gp.double()).abs().max().item() <= tol


def test_requires_grad_input_stays_on_the_kernels(cuda):
    args = COMPAT_GEOMS[0]
    op = at.build_operator(at.make_grid_spec(*args))
    x = _frames((2,) + args[0], torch.float32, cuda).requires_grad_(True)
    before = dict(cuda_shear.LAUNCHES), t_api.SHEAR_PLAN_FALLBACKS
    y = at.area_average_interpolate(x, *args[1:], operator=op).dst
    assert type(y.grad_fn).__name__ == "EllLinearBackward"
    y.square().sum().backward()
    torch.cuda.synchronize()
    assert cuda_shear.LAUNCHES["vhshear"] == before[0]["vhshear"] + 1
    assert cuda_shear.LAUNCHES["contract"] == before[0]["contract"] + 1
    assert t_api.SHEAR_PLAN_FALLBACKS == before[1]
    assert x.grad.is_cuda and torch.isfinite(x.grad).all()
    with pytest.raises(TypeError, match="float-only"):
        at.apply_operator(op, (x.detach() * 255).to(torch.uint8),
                          differentiable=True)


@pytest.mark.parametrize("args,mode", [
    (((24, 24), 1.0, 0.5, (11.5, 12.5), 30.0), "exact"),
    (((24, 24), 1.0, 1.0, (11.5, 12.5), 30.0), "fast"),
    (((256, 200), 1.0, 0.5, (100.0, 128.0), 120.0), "exact"),
])
def test_fused_on_the_card_matches_the_host_route(cuda, args, mode):
    x = _frames((2,) + args[0], torch.float32, cuda, seed=5)
    before = dict(cuda_shear.LAUNCHES)
    got = at.area_average_interpolate(x, *args[1:], mode=mode,
                                      fused=True).dst
    assert cuda_shear.LAUNCHES == before      # no kernel: weight-gen + gather
    assert got.is_cuda and got.dtype == torch.float32
    host = at.area_average_interpolate(x, *args[1:], mode=mode).dst
    a, b = got.cpu().numpy(), host.cpu().numpy()
    edge = (a == 0.0) != (b == 0.0)
    assert edge.mean() < 0.01
    if args[0] == (24, 24):
        # the JAX package's pin, tests/test_api.py:95-122
        np.testing.assert_allclose(a[~edge], b[~edge], atol=2e-4, rtol=0)
    else:
        spec = at.make_grid_spec(*args)
        op = at.build_operator(spec)
        inside = np.broadcast_to(op.raw_row_sums >= 0.5 * spec.dst_side ** 2,
                                 a.shape)
        np.testing.assert_allclose(a[inside], b[inside], atol=2e-4, rtol=0)


@pytest.mark.parametrize("angle", [0.0, 90.0])
def test_transpose_and_variance_on_the_separable_kernel(cuda, angle):
    op = at.build_operator(at.make_grid_spec((256, 384), 2.0, 1.0,
                                             (0.0, 0.0), angle))
    g = _frames((2,) + op.spec.dst_shape, torch.float32, cuda, seed=6)
    before = cuda_apply.LAUNCHES
    got = at.apply_operator_transpose(op, g)
    var = at.propagate_variance(op, _frames((2, 256, 384), torch.float32,
                                            cuda, seed=7))
    torch.cuda.synchronize()
    assert cuda_apply.LAUNCHES == before + 2
    ref = at.apply_operator_transpose(op, g.cpu())
    assert (got.cpu() - ref).abs().max().item() <= 1e-5
    vref = at.propagate_variance(op, _frames((2, 256, 384), torch.float32,
                                             cuda, seed=7).cpu())
    assert (var.cpu() - vref).abs().max().item() <= 1e-5


# ---------------------------------------------------------------------------
# Streaming executor on CUDA streams; prefetch_operator's pinned uploads
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.uint8])
def test_stream_ring_equals_direct_apply(cuda, dtype):
    """The pinned ring at batch 2, depth 3 over 20 distinct frames: every
    yielded frame equals the direct apply of its frame (one kernel-2 launch
    per batch), though the consumer overwrites each one as it arrives."""
    from aainterp_torch import pipeline

    op, _ = _tables(96, 160, 2.0, 1.0, 90.0)
    frames = [_frames((96, 160), dtype, "cpu", seed=100 + i)
              for i in range(20)]
    before = cuda_apply_2d.LAUNCHES
    got = []
    for g in pipeline.stream_apply(op, frames, batch=2, depth=3):
        assert g.device.type == "cpu"
        got.append(g.clone())
        g.fill_(0)
    assert cuda_apply_2d.LAUNCHES == before + 10
    yb, xb, out_t = t_weights.fold_quadrant_separable(op)
    assert out_t
    for f, g in zip(frames, got):
        ref = at.apply_band_operators(f.to(cuda), yb, xb).transpose(-1, -2)
        assert g.dtype == dtype and torch.equal(g, ref.cpu())


def test_stream_failing_step_raises(cuda):
    from aainterp_torch import pipeline

    calls = []

    def step(x):
        calls.append(x.device.type)
        if len(calls) == 3:
            raise RuntimeError("step failed")
        return x * 2

    frames = [torch.full((8, 8), float(i)) for i in range(12)]
    it = pipeline.stream_apply(step, frames, batch=2, depth=2)
    got = [next(it) for _ in range(2)]
    assert all(torch.equal(g, f * 2) for g, f in zip(got, frames))
    with pytest.raises(RuntimeError, match="step failed"):
        list(it)
    assert calls == ["cuda"] * 3


def test_prefetch_then_apply_does_not_reupload(cuda, tmp_path):
    """prefetch_operator fills the caches the applies read, from pinned
    memory; the applies after it take those very tensors."""
    from aainterp_torch import autodiff, regrid
    from aainterp_torch.utils import cache as t_cache

    op, tabs = _tables(256, 512, 2.0, 1.0)
    assert t_cache.prefetch_operator(op) is op
    plan = cuda_apply._plan_for(*tabs)
    dev1 = plan["dev"][cuda]
    yb, xb, _ = t_weights.fold_quadrant_separable(op)
    band = regrid.band_tables(yb, xb).dev[cuda]
    x = _frames((2, 256, 512), torch.float32, cuda)
    out = at.apply_operator(op, x)
    assert plan["dev"][cuda] is dev1
    assert regrid.band_tables(yb, xb).dev[cuda] is band
    assert (out - at.apply_operator(op, x.cpu()).to(cuda)).abs().max() <= 1e-5
    rop = at.build_operator(at.make_grid_spec((160, 160), 1.0, 0.5,
                                              (80.0, 80.0), 120.0))
    t_cache.prefetch_operator(rop)
    folded, _ = t_weights.fold_quadrant_ell_cached(rop)
    kplan = cuda_shear.kernel_plan_cached(folded)
    ktabs = kplan.dev[cuda]
    gather = autodiff.ell_tables(folded, torch.float32, cuda)
    assert all(t.is_cuda for t in gather)
    xr = _frames((2, 160, 160), torch.float32, cuda, seed=3)
    before = dict(cuda_shear.LAUNCHES)
    got = at.apply_operator(rop, xr)
    assert cuda_shear.LAUNCHES["vhshear"] == before["vhshear"] + 1
    assert kplan.dev[cuda] is ktabs
    assert autodiff.ell_tables(folded, torch.float32, cuda) is gather
    ref = at.apply_operator(rop, xr, impl="gather")
    assert (got - ref).abs().max().item() <= 1e-6


# ---------------------------------------------------------------------------
# the probe kernels (csrc/probes.cu): the row-tiled copy and the
# contraction's probe modes
# ---------------------------------------------------------------------------


def _ff(shape, dtype, device):
    """A tensor whose every byte is 0xFF (bf16 / f32: NaN)."""
    x = torch.empty(shape, dtype=dtype, device=device)
    x.view(torch.uint8).fill_(0xFF)
    return x


@pytest.mark.parametrize("shape,ty", [
    ((3, 64, 256), 16),          # whole tiles, 16-byte row pitches
    ((3, 70, 256), 16),          # a ragged last tile (rows 64-69 dropped)
    ((2, 31, 37), 5),            # odd row pitch: spans differ mod 16
    ((1, 7, 5), 3),              # tiny, misaligned, F = 1
    ((2, 1080, 1919), 120),      # a 4K-class odd width
])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.bfloat16,
                                   torch.float32])
def test_copy_rows_kernel_matches_plain(cuda, shape, ty, dtype):
    from aainterp_torch.probes import copy_ceiling

    x = _frames(shape, dtype, cuda)
    rows = shape[1] // ty * ty
    buf = _ff((shape[0], rows, shape[2]), dtype, cuda)
    before = copy_ceiling.LAUNCHES
    got = copy_ceiling.copy_rows_kernel(x, ty, out=buf)
    torch.cuda.synchronize()
    assert got is buf and copy_ceiling.LAUNCHES == before + 1
    assert torch.equal(got, copy_ceiling.copy_rows_plain(x, ty))
    assert torch.equal(copy_ceiling.copy_rows_kernel(x, ty),
                       copy_ceiling.copy_rows_plain(x, ty))


def test_copy_rows_kernel_at_a_view_offset(cuda):
    from aainterp_torch.probes import copy_ceiling

    base = _frames((2 * 40 * 33 + 3,), torch.bfloat16, cuda)
    x = base[3:].view(2, 40, 33)                 # starts 6 bytes in
    out = _ff((2, 40, 33), torch.bfloat16, cuda)
    copy_ceiling.copy_rows_kernel(x, 8, out=out)
    torch.cuda.synchronize()
    assert torch.equal(out, x)
    with pytest.raises(ValueError, match="contiguous"):
        copy_ceiling.copy_rows_kernel(x.transpose(1, 2), 8)


# the contraction probes' geometries: 256^2 at 30.0 degrees has T's rows
# 16-byte aligned (TW 432), at 30.2 not (TW 433), as the rotated flagship;
# at 1024^2 (1,936 tiles) each block of the pipelined form's persistent
# grid walks several tiles
PROBE_GEOMS = [((300, 260), 1.0, 0.5, (130.0, 150.0), 17.0, "exact"),
               ((256, 256), 1.0, 0.5, (128.0, 128.0), 30.0, "exact"),
               ((256, 256), 1.0, 0.5, (128.0, 128.0), 30.2, "exact"),
               ((1024, 1024), 1.0, 0.5, (512.0, 512.0), 30.0, "exact"),
               ROT_GEOMS[0], ROT_GEOMS[2]]
TILED_PROBES = ("tshare", "wshare", "bothshare", "pipelined")


@pytest.mark.parametrize("frames", [3, 11])
@pytest.mark.parametrize("args", PROBE_GEOMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_contract_probes_match_plain(cuda, args, dtype, frames):
    # the tiled probes on the route's tile table, into NaN-filled outputs,
    # with F past the kernel's 8 frames a group (11: the windows restage)
    from aainterp_torch.probes import rot_experiments

    _, plan = _rot_plan(args)
    t = _frames((frames, plan.TH, plan.TW), dtype, cuda, seed=5)
    assert plan.contract_plan(t.element_size()) is not None
    prod = cuda_shear.contract_kernel(t, plan)
    torch.cuda.synchronize()
    shear_before = dict(cuda_shear.LAUNCHES)
    for mode in rot_experiments.MODES:
        before = rot_experiments.LAUNCHES[mode]
        buf = torch.full((frames, plan.Hd, plan.Wd), float("nan"),
                         dtype=dtype, device=cuda)
        got = rot_experiments.contract_probe_kernel(t, plan, mode, out=buf)
        torch.cuda.synchronize()
        assert got is buf and rot_experiments.LAUNCHES[mode] == before + 1
        if mode == "pipelined":
            assert torch.equal(got, prod)
            continue
        ref = rot_experiments.contract_probe_plain(t, plan, mode,
                                                   out_dtype=torch.float32)
        err = (got.double() - ref.double()).abs()
        if dtype == torch.float32:
            assert err.max().item() <= 1e-6, mode
        else:
            assert (err <= _bf16_ulp(ref)).all(), mode
    assert dict(cuda_shear.LAUNCHES) == shear_before


def test_contract_probe_rejects_what_it_cannot_take(cuda):
    from aainterp_torch.probes import rot_experiments

    _, plan = _rot_plan(ROT_GEOMS[0])
    t = _frames((2, plan.TH, plan.TW), torch.float32, cuda)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        rot_experiments.contract_probe_kernel(t.double(), plan, "noweight")
    with pytest.raises(ValueError, match="probe mode"):
        rot_experiments.contract_probe_kernel(t, plan, "none")
    # a plan without tiles: every tiled probe raises, launching nothing
    bare = dataclasses.replace(plan, tiles={"contract2": None,
                                            "contract4": None})
    before = dict(rot_experiments.LAUNCHES)
    for mode in TILED_PROBES:
        with pytest.raises(RuntimeError, match=f"contract probe {mode}"):
            rot_experiments.contract_probe_kernel(t, bare, mode)
    assert dict(rot_experiments.LAUNCHES) == before


# ---------------------------------------------------------------------------
# the masked contraction (the route's dead-pixel skip)
# ---------------------------------------------------------------------------


def _ragged_plan(plan):
    """``plan`` with some dst rows' weights cleared (empty spans) and
    others cut to a ragged live run, spans recomputed."""
    w2 = plan.w2.copy()
    w2[:, ::7] = 0.0                                  # empty rows
    for dy in range(3, plan.Hd, 5):                   # ragged ends
        w2[:, dy, : (dy * 13) % plan.Wd] = 0.0
    return dataclasses.replace(plan, w2=w2, span=cuda_shear.live_spans(w2),
                               tiles={}, dev={})


@pytest.mark.parametrize("frames", [1, 9, 11])
@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("args", PROBE_GEOMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_masked_contraction_matches_unmasked(cuda, args, dtype, ragged,
                                              frames):
    _, plan = _rot_plan(args)
    if ragged:
        plan = _ragged_plan(plan)
        assert (plan.span[::7] == 0).all()
    t = _frames((frames, plan.TH, plan.TW), dtype, cuda, seed=7)
    before = dict(cuda_shear.LAUNCHES)
    got = cuda_shear.contract_kernel(t, plan)
    un = cuda_shear.contract_unmasked_kernel(t, plan)
    torch.cuda.synchronize()
    assert {k: cuda_shear.LAUNCHES[k] - before[k] for k in before} == {
        "vshear": 0, "hshear": 0, "vhshear": 0, "contract": 1,
        "contract_unmasked": 1, "contract_direct": 0}
    assert torch.equal(got, un)
    assert torch.equal(got, cuda_shear.contract_plain(t, plan, fused=True))
    ref = cuda_shear.contract_plain(t, plan, out_dtype=torch.float32)
    err = (got.double() - ref.double()).abs()
    if dtype == torch.float32:
        assert err.max().item() <= 1e-6
    else:
        assert (err <= _bf16_ulp(ref)).all()
    # into NaN-filled outputs: every element written
    live = cuda_shear.live_mask(plan, cuda)
    assert (got[:, ~live] == 0).all()
    nan = torch.full((frames, plan.TH, plan.TW), float("nan"), dtype=dtype,
                     device=cuda)
    out = cuda_shear.contract_kernel(nan, plan)
    torch.cuda.synchronize()
    assert (out[:, ~live] == 0).all()
    assert torch.isnan(out[:, torch.from_numpy(
        (plan.w2 != 0).any(axis=0)).to(cuda)]).all()
    assert torch.isnan(cuda_shear.contract_unmasked_kernel(nan, plan)).all()


def test_masked_route_keeps_its_launches(cuda):
    op, plan = _rot_plan(PROBE_GEOMS[0])
    x = _frames((3, plan.qH, plan.qW), torch.bfloat16, cuda, seed=2)
    before = dict(cuda_shear.LAUNCHES)
    got = cuda_shear.apply_ell_shear_kernel(x, plan)
    torch.cuda.synchronize()
    assert {k: cuda_shear.LAUNCHES[k] - before[k] for k in before} == {
        "vshear": 0, "hshear": 0, "vhshear": 1, "contract": 1,
        "contract_unmasked": 0, "contract_direct": 0}
    t = cuda_shear.vhshear_kernel(x, plan)
    assert torch.equal(got, cuda_shear.contract_unmasked_kernel(t, plan))


# ---------------------------------------------------------------------------
# the copy split over blocks, and kernel 1's probe modes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,ty", [((8, 1024, 1024), 128),
                                      ((3, 1024, 1021), 128),
                                      ((2, 513, 999), 64)])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.bfloat16,
                                   torch.float32])
def test_copy_rows_split_matches_plain(cuda, shape, ty, dtype):
    from aainterp_torch.probes import copy_ceiling

    x = _frames(shape, dtype, cuda, seed=1)
    buf = _ff((shape[0], shape[1] // ty * ty, shape[2]), dtype, cuda)
    got = copy_ceiling.copy_rows_kernel(x, ty, out=buf)
    torch.cuda.synchronize()
    assert torch.equal(got, copy_ceiling.copy_rows_plain(x, ty))


K1_PROBE_GEOMS = [(240, 512), (250, 998), (96, 130)]


# frames: 1 (at (240, 512) 30 tiles, fewer than the walk's persistent
# grid), 3, and 11
@pytest.mark.parametrize("F", [1, 3, 11])
@pytest.mark.parametrize("shape", K1_PROBE_GEOMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.uint8])
def test_band_probes_match_plain(cuda, shape, dtype, F):
    from aainterp_torch.probes import band_probes

    tables = band_probes.flagship_tables(shape)
    modes = band_probes.modes_of(dtype)
    # the modes whose function is not production's output
    cuts = ("stage", "stagey", "stage_direct", "stagey_direct")
    x = _frames((F,) + shape, dtype, cuda, seed=4)
    prod = cuda_apply.apply_separable_kernel(x, *tables)
    torch.cuda.synchronize()
    before = cuda_apply.LAUNCHES
    for mode in modes:
        n = band_probes.LAUNCHES[mode]
        buf = _ff(tuple(prod.shape), dtype, cuda)
        got = band_probes.band_probe_kernel(x, tables, mode, out=buf)
        torch.cuda.synchronize()
        assert got is buf and band_probes.LAUNCHES[mode] == n + 1
        plain = band_probes.band_probe_plain(x, tables, mode)
        assert torch.equal(got, plain), mode
        if mode not in cuts:
            assert torch.equal(got, prod), mode
    assert torch.equal(prod, band_probes.band_probe_plain(
        x, tables, "u8words" if dtype == torch.uint8 else "walk4"))
    assert cuda_apply.LAUNCHES == before
    # the walk's persistent grid: every SM, as many blocks as fit, fewer
    # where there are fewer tiles
    plan = band_probes._plan(tables)
    tiles = (F * -(-prod.shape[2] // plan["TX"])
             * -(-prod.shape[1] // plan["TY"]))
    for mode in modes:
        if mode.startswith("walk") or mode in band_probes.RING_MODES:
            g = (band_probes.walk_grid(x, tables, mode)
                 if mode.startswith("walk")
                 else band_probes.stage_grid(x, tables, mode))
            assert g["blocks_per_sm"] >= 1 and g["smem"] == (
                band_probes.smem_bytes(plan, mode, shape[1], prod.shape[2],
                                       tables[1].shape[1], x.element_size()))
            assert g["tiles"] == tiles and g["grid"] == min(
                tiles, g["sms"] * g["blocks_per_sm"])


# the stage ring at the other shapes of its plans: rgb1024's ratio 2.5
# (Wd 410: a strip of 170 columns, rows of 820 / 1,640 bytes), a tile of 6
# rows, upsampling (shifts of 0 and 1, SY 5 < TY), a 22-tap band (its y
# pass reads every tap)
STAGE_GEOMS = [((1024, 1024), 150.0, 60.0), ((12, 500), 2.0, 1.0),
               ((64, 160), 1.0, 2.0), ((960, 960), 20.0, 1.0)]


@pytest.mark.parametrize("geom", STAGE_GEOMS,
                         ids=["rgb1024", "one-tile", "upsampling", "20:1"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.uint8])
def test_stage_ring_matches_plain_at_its_plans(cuda, geom, dtype):
    from aainterp_torch.probes import band_probes

    shape, sr, dr = geom
    tables = band_probes.flagship_tables(shape, sr, dr)
    plan = band_probes._plan(tables)
    x = _frames((5,) + shape, dtype, cuda, seed=9)
    out_shape = (5, len(tables[0]), len(tables[2]))
    e = x.element_size()
    # u8words at every plan; xpair where the band is an exact ratio-2 one
    for mode in [m for m in band_probes.RING_MODES
                 if m in band_probes.modes_of(dtype)
                 and (m != "xpair" or (sr, dr) == (2.0, 1.0))]:
        plain = band_probes.band_probe_plain(x, tables, mode)
        got = band_probes.band_probe_kernel(
            x, tables, mode, out=_ff(out_shape, dtype, cuda))
        torch.cuda.synchronize()
        assert torch.equal(got, plain), mode
        g = band_probes.stage_grid(x, tables, mode)
        assert g["slots"] == band_probes.STAGE_SLOTS and g["smem"] == (
            band_probes.smem_bytes(plan, mode, shape[1], out_shape[2],
                                   tables[1].shape[1], e))


# u8words and xpair on the stage ring at the flagship, at the stage ring's
# odd shape (rows of no 4- or 16-byte multiple: the funnel-shift reads, the
# pair's byte stores) and at a W mod 4 != 0 ratio-2 shape with one frame
# (ragged last strip and row tile)
RING_U8_GEOMS = [(8, 2160, 3840), (3, 540, 1923), (1, 250, 998)]


@pytest.mark.parametrize("shape", RING_U8_GEOMS,
                         ids=["flagship", "odd", "ragged"])
def test_ring_words_and_pair_match_plain_and_production(cuda, shape):
    from aainterp_torch.probes import band_probes

    tables = band_probes.flagship_tables(shape[1:])
    x = _frames(shape, torch.uint8, cuda, seed=17)
    prod = cuda_apply.apply_separable_kernel(x, *tables)
    plan = band_probes._plan(tables)
    for mode in ("u8words", "xpair"):
        for m in (mode, f"{mode}_direct"):
            n = dict(band_probes.LAUNCHES)
            got = band_probes.band_probe_kernel(
                x, tables, m, out=_ff(tuple(prod.shape), torch.uint8, cuda))
            torch.cuda.synchronize()
            assert band_probes.LAUNCHES == dict(n, **{m: n[m] + 1})
            assert torch.equal(got, band_probes.band_probe_plain(x, tables,
                                                                 m)), m
            assert torch.equal(got, prod), m
        g = band_probes.stage_grid(x, tables, mode)
        assert g["slots"] == band_probes.STAGE_SLOTS and g["smem"] == (
            band_probes.smem_bytes(plan, mode, shape[2], prod.shape[2],
                                   tables[1].shape[1], 1))
        assert g["blocks_per_sm"] >= 1 and g["grid"] == min(
            g["tiles"], g["sms"] * g["blocks_per_sm"])


def test_band_probes_reject_what_they_cannot_take(cuda, monkeypatch):
    from aainterp_torch.probes import band_probes

    tables = band_probes.flagship_tables((240, 512))
    x = _frames((2, 240, 512), torch.float32, cuda)
    with pytest.raises(ValueError, match="no torch.float32 instance"):
        band_probes.band_probe_kernel(x, tables, "u8words")
    with pytest.raises(ValueError, match="probe mode"):
        band_probes.band_probe_kernel(x, tables, "none")
    op, t3 = _tables(240, 512, 3.0, 1.0)
    u8 = _frames((2, 240, 512), torch.uint8, cuda)
    for mode in ("xpair", "xpair_direct"):
        n = dict(band_probes.LAUNCHES)
        with pytest.raises(ValueError, match="exact ratio-2"):
            band_probes.band_probe_kernel(u8, t3, mode)
        assert band_probes.LAUNCHES == n
    # the ring takes row tiles of at most 8 rows: a plan of 16 raises
    # before any launch, and the first form is not taken in its place
    monkeypatch.setattr(cuda_apply, "TILE_Y", 16)
    monkeypatch.setattr(cuda_apply, "_PLAN_CACHE", type(
        cuda_apply._PLAN_CACHE)(16, max_bytes=256 << 20))
    u8s = _frames((1, 240, 512), torch.uint8, cuda)
    assert band_probes._plan(tables)["TY"] == 16
    n = dict(band_probes.LAUNCHES)
    for mode in band_probes.RING_MODES:
        with pytest.raises(ValueError, match="at most 8 rows"):
            band_probes.band_probe_kernel(u8s, tables, mode)
    assert band_probes.LAUNCHES == n
    # a ring or chunk buffers beyond the card's opt-in: a ValueError that
    # names the mode and the bytes, before any launch.  At 20:1 (SY 162)
    # f32 walk2 fits and walk4 does not; u8convert's buffers never outgrow
    # the f32 window the plan is sized for, so a lower limit stands in
    t20 = band_probes.flagship_tables((960, 960), 20.0, 1.0)
    plan = band_probes._plan(t20)
    x20 = _frames((1, 960, 960), torch.float32, cuda)
    n = dict(band_probes.LAUNCHES)
    need = band_probes.smem_bytes(plan, "walk4", 960, 48, t20[1].shape[1], 4)
    assert need > band_probes.SMEM_LIMIT
    with pytest.raises(ValueError, match=f"'walk4' needs {need} bytes"):
        band_probes.band_probe_kernel(x20, t20, "walk4")
    with pytest.raises(RuntimeError, match="walk4"):
        band_probes.walk_grid(x20, t20, "walk4")
    got = band_probes.band_probe_kernel(x20, t20, "walk2")
    torch.cuda.synchronize()
    assert torch.equal(got, cuda_apply.apply_separable_kernel(x20, *t20))
    u8 = _frames((1, 960, 960), torch.uint8, cuda)
    need = band_probes.smem_bytes(plan, "u8convert2", 960, 48,
                                  t20[1].shape[1], 1)
    monkeypatch.setattr(band_probes, "SMEM_LIMIT", need - 1)
    with pytest.raises(ValueError, match=f"'u8convert2' needs {need} bytes"):
        band_probes.band_probe_kernel(u8, t20, "u8convert2")
    assert band_probes.LAUNCHES == dict(n, walk2=n["walk2"] + 1)
    # the stage ring beyond the opt-in (a lower limit stands in, as its
    # two f32 windows of 162 rows fit): the ValueError names the mode and
    # the bytes, before any launch, and the first form is never taken in
    # its place
    need = band_probes.smem_bytes(plan, "stagey", 960, 48, t20[1].shape[1],
                                  4)
    monkeypatch.setattr(band_probes, "SMEM_LIMIT", need - 1)
    n = dict(band_probes.LAUNCHES)
    with pytest.raises(ValueError, match=f"'stagey' needs {need} bytes"):
        band_probes.band_probe_kernel(x20, t20, "stagey")
    assert band_probes.LAUNCHES == n


# ---------------------------------------------------------------------------
# rgb1024's x-pass probes (xonly, densex) and the fused aligned regrid
# ---------------------------------------------------------------------------

X_PROBE_GEOMS = [((1024, 1024), 150.0, 60.0),   # rgb1024: Wd 410, 2 strips
                 ((250, 998), 2.0, 1.0),        # Wd 499: a ragged strip
                 ((12, 500), 2.0, 1.0),         # Hd 6: one row tile
                 ((64, 160), 1.0, 2.0)]         # upsampling: SY 5 < TY 8


@pytest.mark.parametrize("geom", X_PROBE_GEOMS,
                         ids=["rgb1024", "ragged", "one-tile", "upsampling"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_x_probes_match_plain(cuda, geom, dtype):
    from aainterp_torch.probes import band_probes

    shape, sr, dr = geom
    tables = band_probes.flagship_tables(shape, sr, dr)
    Hd, Wd = len(tables[0]), len(tables[2])
    x = _frames((3,) + shape, dtype, cuda, seed=5)
    tmp = _frames((3, Hd, shape[1]), dtype, cuda, seed=6)
    before = cuda_apply.LAUNCHES
    for mode, inp in (("xonly", tmp), ("densex", x)):
        n = band_probes.LAUNCHES[mode]
        buf = _ff((3, Hd, Wd), dtype, cuda)
        got = band_probes.band_probe_kernel(inp, tables, mode, out=buf)
        torch.cuda.synchronize()
        assert got is buf and band_probes.LAUNCHES[mode] == n + 1
        plain = band_probes.band_probe_plain(inp, tables, mode)
        if mode == "xonly":
            assert torch.equal(got, plain)
    assert cuda_apply.LAUNCHES == before
    # densex: the tensor cores' sums against the f32 statement, and in f32
    # against production's (the statement's extra products are exact zeros)
    _densex_close(got, plain)
    if dtype == torch.float32:
        _densex_close(got, cuda_apply.apply_separable_kernel(x, *tables))


@pytest.mark.parametrize("case", [((1200, 512), 40.0, 1.0),
                                  ((250, 998), 2.0, 1.0),
                                  ((130, 1001), 2.0, 1.0)],
                         ids=["rows-past-a-box", "ragged-rows", "odd-width"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_densex_reads_global_memory_where_no_window_fits(cuda, case, dtype):
    # the y pass reads global memory where no TMA box takes the tile's
    # rows: 1,182 rows (over 256), rows of 998 or 1,001 pixels (not a
    # whole number of 16-byte chunks; 1,001 scalar loads)
    from aainterp_torch.probes import band_probes

    shape, sr, dr = case
    tables = band_probes.flagship_tables(shape, sr, dr)
    dp = band_probes.densex_plan(tables, shape[1])
    assert not band_probes.dense_x_window(dp["SY"], shape[1], dtype.itemsize)
    x = _frames((2,) + shape, dtype, cuda, seed=7)
    buf = _ff((2, len(tables[0]), len(tables[2])), dtype, cuda)
    got = band_probes.band_probe_kernel(x, tables, "densex", out=buf)
    torch.cuda.synchronize()
    assert got is buf
    _densex_close(got, band_probes.band_probe_plain(x, tables, "densex"))


def _densex_close(got, want):
    """densex's tolerance: f32 |got - want| <= DENSEX_RTOL * max|want|,
    bf16 within one bf16 ulp of want everywhere."""
    from aainterp_torch.probes import band_probes

    err = (got.double() - want.double()).abs()
    if got.dtype == torch.float32:
        assert float(err.max()) <= band_probes.DENSEX_RTOL * float(
            want.double().abs().max())
    else:
        assert bool((err <= _bf16_ulp(want)).all()), float(err.max())


def test_x_probes_reject_what_they_cannot_take(cuda):
    from aainterp_torch.probes import band_probes

    tables = band_probes.flagship_tables((64, 160), 150.0, 60.0)
    x = _frames((2, 64, 160), torch.float32, cuda)
    with pytest.raises(ValueError, match="y pass's output"):
        band_probes.band_probe_kernel(x, tables, "xonly")
    with pytest.raises(ValueError, match="no torch.uint8 instance"):
        band_probes.band_probe_kernel(x.to(torch.uint8), tables, "densex")
    with pytest.raises(ValueError, match="contiguous"):
        band_probes.band_probe_kernel(x.transpose(1, 2), tables, "densex")
    # a width that the old form's shared memory refused (T held whole
    # rows) now computes: K walks the 12,000 columns in chunks
    wide = band_probes.flagship_tables((8, 12000), 2.0, 1.0)
    xw = _frames((1, 8, 12000), torch.float32, cuda, seed=3)
    n = band_probes.LAUNCHES["densex"]
    got = band_probes.band_probe_kernel(xw, wide, "densex")
    torch.cuda.synchronize()
    assert band_probes.LAUNCHES["densex"] == n + 1
    _densex_close(got, band_probes.band_probe_plain(xw, wide, "densex"))


def _synthetic_plans(my, cy, hd, mx, cx, wd, seed):
    rng = np.random.default_rng(seed)
    return (dict(m=my, c0=cy, wk=rng.uniform(0, 1, (hd, my))
                 .astype(np.float32)),
            dict(m=mx, c0=cx, wk=rng.uniform(0, 1, (wd, mx))
                 .astype(np.float32)))


FUSED_CASES = {
    "config5": ((1800, 3600), (180, 360)),
    "small": ((180, 360), (18, 36)),
    # c0 offsets, odd widths (4-byte loads), extra rows and columns
    "offsets": ((2 + 3 * 7 + 1, 1 + 5 * 9 + 3), (3, 2, 7, 5, 1, 9)),
    # a dst row's y sums beyond one block: 250 columns in chunks
    "chunked": ((10, 60 * 250), (2, 0, 5, 60, 0, 250)),
}


@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_aligned_fused_matches_plain(cuda, case):
    from aainterp_torch.ops.apply import apply_separable_aligned
    from aainterp_torch.probes import aligned_fused_probe as af

    src, spec = FUSED_CASES[case]
    if case in ("config5", "small"):
        yp, xp = af.geometry(src, spec)
    else:
        yp, xp = _synthetic_plans(*spec, seed=7)
    x = _frames((2,) + src, torch.float32, cuda, seed=8) * 100.0 + 200.0
    hd, wd = len(yp["wk"]), len(xp["wk"])
    n = af.LAUNCHES
    buf = _ff((2, hd, wd), torch.float32, cuda)
    got = af.aligned_fused_kernel(x, yp, xp, out=buf)
    torch.cuda.synchronize()
    assert got is buf and af.LAUNCHES == n + 1
    assert torch.equal(got, af.aligned_fused_plain(x, yp, xp))
    torch.testing.assert_close(got, apply_separable_aligned(x, yp, xp),
                               rtol=1e-6, atol=1e-3)
    if case == "chunked":
        assert af.chunk_cols(wd, 60) < wd
