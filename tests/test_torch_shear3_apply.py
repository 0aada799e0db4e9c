"""The port's plain mode='shear' pipeline against the JAX package.

``apply_shear3_plain`` against JAX's ``apply_shear3_xla`` and against
JAX's Pallas pipeline in interpret mode (``apply_shear3_pallas(...,
interpret=True)``, as tests/test_shear3.py runs it); each plain stage
against the float64 numpy pass in all three forms (translate + crop,
pre-band, post-band) along both axes, forward and adjoint; the stage
wrappers of ``ops/cuda_shear3.py`` on CPU tensors.  The kernels
themselves are checked on the card (tests/test_torch_kernel_cuda.py,
chip_smoke.py).

Tolerances, with their reasons:
* f32 pipeline vs ``apply_shear3_xla``: atol 2e-5, as JAX's own test
  (test_shear3.py:115); the two sum in the same order, so it is 0 here.
* vs the interpret-mode Pallas pipeline with f32 staging: atol 3e-6, as
  test_shear3.py:255 (the Pallas bands are matmuls: another order).
* bf16 staging vs the interpret-mode Pallas bf16 run: within one bf16 ulp
  of the reference per stage (3 stages): a sum in another order can flip
  a stage's rounding, and a flip propagates as a weighted average.
* uint8 -> uint8 vs the interpret-mode Pallas run: one gray level.
* each plain stage vs the float64 numpy pass: atol 1e-6 on [0, 1]
  inputs (f32 rounding of a few products).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aainterp as aa
from aainterp.ops import shear3 as j_shear3
from aainterp.ops.pallas_shear3 import apply_shear3_pallas

import aainterp_torch as at
from aainterp_torch.ops import cuda_shear3
from aainterp_torch.ops import shear3 as t_shear3

GEOMS = [
    (96, 96, 1.0, 0.5, 30.0),
    (64, 80, 1.0, 1.0, 30.0),
    (72, 72, 1.0, 1.0, 75.0),
    (64, 64, 2.0, 1.5, 14.0),
    (64, 64, 1.0, 0.8, 100.0),
    (48, 64, 1.0, 0.7, 213.0),
    (64, 48, 1.0, 1.0, 322.0),
]


def _cases(geoms):
    out = []
    for g in geoms:
        H, W, sr, dr, ang = g
        spec = aa.make_grid_spec((H, W), sr, dr, (W / 2, H / 2), ang)
        for dec in ("xyx", "yxy"):
            if dec == "xyx" or spec.scale < spec.dst_side:
                out.append(pytest.param(g, dec, id=f"{H}x{W}-{ang:g}-{dec}"))
    return out


def _plans(g, dec):
    H, W, sr, dr, ang = g
    iso = (W / 2, H / 2)
    return (j_shear3.build_shear3_plan(aa.make_grid_spec((H, W), sr, dr, iso,
                                                         ang), dec),
            t_shear3.build_shear3_plan(at.make_grid_spec((H, W), sr, dr, iso,
                                                         ang), dec))


def _xla(jp, q):
    """JAX's apply_shear3_xla under jit (one compile instead of an eager
    dispatch per gather)."""
    fn = jax.jit(lambda x, a: j_shear3.apply_shear3_xla(jp, x, a))
    return np.asarray(fn(jnp.asarray(q), j_shear3.plan_arrays(jp)))


def _frames(shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def bf16_ulp(x) -> np.ndarray:
    """One bf16 ulp at |x| (8 significant bits), as f64."""
    a = np.maximum(np.abs(np.asarray(x, np.float64)), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(a)) - 7)


# ---------------------------------------------------------------------------
# the pipeline against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("g,dec", _cases(GEOMS))
def test_plain_matches_jax_xla(g, dec):
    jp, tp = _plans(g, dec)
    q = _frames((2,) + tp.src_shape, 1)
    ref = _xla(jp, q)
    got = t_shear3.apply_shear3_plain(torch.from_numpy(q), tp)
    assert got.dtype == torch.float32 and got.shape == (2,) + tp.dst_shape
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=0)


@pytest.mark.parametrize("g,dec", _cases(GEOMS[:5]))
def test_plain_matches_pallas_interpret_f32(g, dec):
    jp, tp = _plans(g, dec)
    q = _frames((2,) + tp.src_shape, 2)
    ref = np.asarray(apply_shear3_pallas(jp, jnp.asarray(q),
                                         mid_dtype=jnp.float32,
                                         interpret=True))
    got = t_shear3.apply_shear3_plain(torch.from_numpy(q), tp)
    np.testing.assert_allclose(got.numpy(), ref, atol=3e-6, rtol=0)


@pytest.mark.parametrize("g,dec", _cases(GEOMS[:4]))
def test_bf16_staging_matches_pallas_interpret(g, dec):
    jp, tp = _plans(g, dec)
    qb = jnp.asarray(_frames((2,) + tp.src_shape, 3), jnp.bfloat16)
    ref = np.asarray(apply_shear3_pallas(jp, qb, interpret=True)
                     .astype(jnp.float32), np.float64)
    q = torch.from_numpy(np.array(qb.astype(jnp.float32))).bfloat16()
    got = t_shear3.apply_shear3_plain(q, tp, mid_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    diff = np.abs(got.double().numpy() - ref)
    assert (diff <= 3 * bf16_ulp(ref)).all(), diff.max()
    # the kernel route's staging is the wrapper's default: same result
    k = cuda_shear3.apply_shear3_kernel(q, tp)
    assert torch.equal(k, got)


def test_u8_matches_pallas_interpret_and_xla():
    jp, tp = _plans((64, 64, 1.0, 1.0, 30.0), "xyx")
    q = np.random.default_rng(4).integers(0, 256, tp.src_shape,
                                          dtype=np.uint8)
    ref = np.asarray(apply_shear3_pallas(jp, jnp.asarray(q), interpret=True))
    got = t_shear3.apply_shear3_plain(torch.from_numpy(q), tp,
                                      mid_dtype=torch.bfloat16)
    assert got.dtype == torch.uint8 and ref.dtype == np.uint8
    assert np.abs(got.numpy().astype(int) - ref.astype(int)).max() <= 1
    ref_x = _xla(jp, q)
    got_x = t_shear3.apply_shear3_plain(torch.from_numpy(q), tp)
    assert got_x.dtype == torch.uint8
    assert np.abs(got_x.numpy().astype(int) - ref_x.astype(int)).max() <= 1


# ---------------------------------------------------------------------------
# each stage against the float64 numpy pass: three forms, both axes
# ---------------------------------------------------------------------------

STAGE_PLANS = [
    ((96, 96, 1.0, 0.5, 30.0), "xyx"),   # translate, post-band y, post x
    ((96, 96, 1.0, 0.5, 30.0), "yxy"),   # pre-band y, pre-band x, translate
    ((64, 80, 1.0, 1.0, 30.0), "xyx"),   # translate + crop along y and x
]


@pytest.mark.parametrize("adjoint", [False, True], ids=["fwd", "adj"])
@pytest.mark.parametrize("g,dec", STAGE_PLANS,
                         ids=["xyx-band", "yxy", "xyx-crop"])
def test_each_stage_matches_numpy_pass(g, dec, adjoint):
    _, plan = _plans(g, dec)
    if adjoint:
        plan = t_shear3.transpose_shear3_plan(plan)
    sp = t_shear3.stage_plan(plan)
    x = _frames((2,) + plan.src_shape, 5)
    for i, (p, st) in enumerate(zip(plan.passes, sp.stages)):
        fn = t_shear3.ystage_plain if st.axis == "y" else t_shear3.xstage_plain
        got = fn(torch.from_numpy(x), sp, i, out_dtype=torch.float32)
        want = t_shear3._apply_pass_np(x.astype(np.float64), p)
        if i == len(sp.stages) - 1 and plan.inv_cov is not None:
            want = want * plan.inv_cov
        assert got.shape == want.shape == (2,) + st.out_shape
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0,
                                   err_msg=f"stage {i} form {st.form}")
        x = got.numpy()


def test_forms_cover_both_axes():
    seen = set()
    for g, dec in STAGE_PLANS:
        _, plan = _plans(g, dec)
        for pl in (plan, t_shear3.transpose_shear3_plan(plan)):
            seen |= {(s.axis, s.form, s.crop > 0)
                     for s in t_shear3.stage_plan(pl).stages}
    T, PRE, POST = (t_shear3.TRANSLATE, t_shear3.PRE_BAND,
                    t_shear3.POST_BAND)
    for axis in "xy":
        for form in (T, PRE, POST):
            assert any(a == axis and f == form for a, f, _ in seen)
        assert (axis, T, True) in seen          # a translate with a crop


@pytest.mark.parametrize("adjoint", [False, True], ids=["fwd", "adj"])
def test_stages_write_every_element_of_a_nan_output(adjoint):
    _, plan = _plans((96, 96, 1.0, 0.5, 30.0), "yxy")
    if adjoint:
        plan = t_shear3.transpose_shear3_plan(plan)
    sp = t_shear3.stage_plan(plan)
    x = torch.from_numpy(_frames((2,) + plan.src_shape, 6))
    zeros = 0
    for i, st in enumerate(sp.stages):
        fns = ((t_shear3.ystage_plain, cuda_shear3.ystage_kernel)
               if st.axis == "y" else
               (t_shear3.xstage_plain, cuda_shear3.xstage_kernel))
        want = fns[0](x, sp, i)
        zeros += int((want == 0).sum())
        for fn in fns:
            out = torch.full((2,) + st.out_shape, float("nan"))
            got = fn(x, sp, i, out=out)
            assert got is out
            assert torch.isfinite(out).all()
            assert torch.equal(out, want)
        x = want
    assert zeros > 0                       # the zero fill is exercised


# ---------------------------------------------------------------------------
# shapes, dtypes, wrappers on the CPU
# ---------------------------------------------------------------------------


def test_batched_and_2d_inputs():
    _, plan = _plans((64, 64, 2.0, 1.5, 14.0), "yxy")
    q = torch.from_numpy(_frames((2, 3) + plan.src_shape, 7))
    got = t_shear3.apply_shear3_plain(q, plan)
    assert got.shape == (2, 3) + plan.dst_shape
    flat = t_shear3.apply_shear3_plain(q.reshape((6,) + plan.src_shape), plan)
    assert torch.equal(got.reshape(flat.shape), flat)
    assert torch.equal(t_shear3.apply_shear3_plain(q[1, 2], plan), flat[5])
    ref = t_shear3.apply_shear3_np(plan, q.double().numpy())
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=0)
    with pytest.raises(ValueError, match="for this plan"):
        t_shear3.apply_shear3_plain(q[..., 1:], plan)


@pytest.mark.parametrize("dtype,want", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.uint8, torch.uint8), (torch.float64, torch.float32),
    (torch.int16, torch.float32)])
def test_dtype_contract(dtype, want):
    _, plan = _plans((64, 64, 1.0, 0.8, 100.0), "xyx")
    q = torch.from_numpy(_frames((2,) + plan.src_shape, 8) * 200).to(dtype)
    assert t_shear3.apply_shear3_plain(q, plan).dtype == want
    assert cuda_shear3.apply_shear3_kernel(q, plan).dtype == want
    assert t_shear3.apply_shear3_plain(
        q, plan, out_dtype=torch.float32).dtype == torch.float32


def test_stage_dtypes():
    f32, bf16, u8 = torch.float32, torch.bfloat16, torch.uint8
    assert t_shear3.stage_dtypes(bf16, bf16, None) == (bf16, bf16, bf16)
    assert t_shear3.stage_dtypes(u8, bf16, None) == (u8, bf16, u8)
    # f32 input never stages in bf16 (pallas_shear3.py:490-491)
    assert t_shear3.stage_dtypes(f32, bf16, None) == (f32, f32, f32)
    assert t_shear3.stage_dtypes(torch.float64, bf16, None) == (f32, f32,
                                                                 f32)
    with pytest.raises(TypeError, match="mid_dtype"):
        t_shear3.stage_dtypes(bf16, torch.float16, None)
    with pytest.raises(TypeError, match="out_dtype"):
        t_shear3.stage_dtypes(bf16, bf16, torch.float16)


def test_kernel_wrappers_take_the_plain_version_on_cpu():
    _, plan = _plans((96, 96, 1.0, 0.5, 30.0), "xyx")
    q = torch.from_numpy(_frames((3,) + plan.src_shape, 9))
    before = dict(cuda_shear3.LAUNCHES)
    for dtype in (torch.float32, torch.bfloat16):
        got = cuda_shear3.apply_shear3_kernel(q.to(dtype), plan)
        assert torch.equal(got, t_shear3.apply_shear3_plain(
            q.to(dtype), plan, mid_dtype=torch.bfloat16))
    assert cuda_shear3.LAUNCHES == before        # nothing launched


def test_stage_inputs_are_checked():
    _, plan = _plans((96, 96, 1.0, 0.5, 30.0), "xyx")
    sp = t_shear3.stage_plan(plan)
    st = sp.stages[1]                            # a y-stage
    x = torch.zeros((2,) + st.in_shape)
    for fn in (t_shear3.xstage_plain, cuda_shear3.xstage_kernel):
        with pytest.raises(ValueError, match="runs along y"):
            fn(x, sp, 1)
    for fn in (t_shear3.ystage_plain, cuda_shear3.ystage_kernel):
        with pytest.raises(ValueError, match="for this plan"):
            fn(x[:, 1:], sp, 1)
        with pytest.raises(ValueError, match="for this plan"):
            fn(x[0], sp, 1)                      # 2-D: no frame axis
        with pytest.raises(TypeError, match="stage input"):
            fn(x.double(), sp, 1)
        with pytest.raises(ValueError, match="out must be"):
            fn(x, sp, 1, out=torch.zeros(2, 1, 1))
