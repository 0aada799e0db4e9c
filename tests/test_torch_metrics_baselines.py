"""The port's metrics and baselines (``aainterp_torch.metrics``,
``aainterp_torch.baselines``) against the JAX package's, on the CPU.

Tolerances: psnr and information_loss within 1e-6 relative of JAX's
(both float32); mean_flux_error within 1e-6 absolute (it is the
difference of two float32 means, each summed in its own order, over
their size);
``resize_baseline`` (``F.interpolate`` with antialias) within 1e-5 of
``jax.image.resize`` on [0, 1] images (measured 1.6e-6 at worst);
``compare_downscale``'s PSNRs within 1e-4 relative and flux errors
within 1e-6 absolute; the rotation round
trip keeps the PSNR ordering that tests/test_quality_claims.py pins for
the JAX package (area > bilinear + 3 dB, bilinear > bicubic).
"""

import numpy as np
import pytest
import torch

import aainterp.baselines as j_base
import aainterp.metrics as j_metrics

import aainterp_torch as at
import aainterp_torch.baselines as t_base
import aainterp_torch.metrics as t_metrics

RNG = np.random.default_rng(21)


def _pair(shape=(3, 40, 56)):
    a = RNG.uniform(0, 1, shape).astype(np.float32)
    b = (a + RNG.normal(0, 0.05, shape)).astype(np.float32)
    return a, b


@pytest.mark.parametrize("name", ["psnr", "mean_flux_error",
                                  "information_loss"])
def test_metrics_match_jax(name):
    a, b = _pair()
    got = getattr(t_metrics, name)(torch.from_numpy(a), torch.from_numpy(b))
    ref = np.asarray(getattr(j_metrics, name)(a, b))
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    if name == "mean_flux_error":
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    else:
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6)
    # numpy input computes on device= (here the CPU)
    np.testing.assert_array_equal(
        getattr(t_metrics, name)(a, b, device="cpu").numpy(), got.numpy())


def test_psnr_range_and_identity():
    a, b = _pair((2, 16, 16))
    np.testing.assert_allclose(
        t_metrics.psnr(torch.from_numpy(a), torch.from_numpy(b),
                       data_range=2.0).numpy(),
        np.asarray(j_metrics.psnr(a, b, data_range=2.0)), rtol=1e-6)
    x = torch.from_numpy(a)
    assert bool((t_metrics.psnr(x, x) > 200).all())


@pytest.mark.parametrize("dst", [(20, 30), (128, 100), (64, 40), (17, 90)])
@pytest.mark.parametrize("method", ["linear", "cubic"])
def test_resize_baseline_matches_jax_image_resize(dst, method):
    x = RNG.uniform(0, 1, (3, 64, 80)).astype(np.float32)
    got = t_base.resize_baseline(torch.from_numpy(x), dst, method)
    ref = np.asarray(j_base.resize_baseline(x, dst, method))
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    alias = {"linear": "bilinear", "cubic": "bicubic"}[method]
    assert torch.equal(at.resize(torch.from_numpy(x), dst, method=alias),
                       got)


def test_resize_baseline_dtypes_and_errors():
    x = torch.rand(2, 12, 12, dtype=torch.float64)
    assert t_base.resize_baseline(x, (5, 7), "linear").dtype == torch.float64
    xb = x.to(torch.bfloat16)
    assert t_base.resize_baseline(xb, (5, 7), "cubic").dtype == torch.bfloat16
    xu = (x * 255).to(torch.uint8)
    assert t_base.resize_baseline(xu, (5, 7), "linear").dtype == torch.float32
    with pytest.raises(ValueError, match="method"):
        t_base.resize_baseline(x, (5, 7), "nearest")


def test_compare_downscale_matches_jax():
    src = RNG.uniform(0, 1, (2, 48, 64)).astype(np.float32)
    got = t_base.compare_downscale(torch.from_numpy(src), 3.0, 2.0)
    ref = j_base.compare_downscale(src, 3.0, 2.0)
    assert sorted(got) == sorted(ref)
    for m in ref:
        np.testing.assert_allclose(got[m]["psnr_roundtrip"],
                                   ref[m]["psnr_roundtrip"], rtol=1e-4)
        np.testing.assert_allclose(got[m]["mean_flux_error"],
                                   ref[m]["mean_flux_error"], rtol=0,
                                   atol=1e-6)


def test_rotation_roundtrip_psnr_ordering_and_jax():
    """tests/test_quality_claims.py's pin, on the port: at a 64^2
    near-Nyquist scene the +30/-30 degree round trip orders area >
    bilinear + 3 dB > bicubic; every number within 1e-3 dB of JAX's
    (the bilinear/bicubic rotations are the same scipy calls)."""
    y, x = np.mgrid[0:64, 0:64].astype(np.float64)
    src = (np.sin(x * 0.9) * np.cos(y * 0.55) + 1.0) / 2.0
    got = t_base.compare_rotation_roundtrip(src, 30.0, device="cpu")
    ref = j_base.compare_rotation_roundtrip(src, 30.0)
    assert got["area_average"] > got["bilinear"] + 3.0, got
    assert got["bilinear"] > got["bicubic"], got
    for m in ref:
        assert abs(got[m] - ref[m]) < 1e-3, (m, got[m], ref[m])
