"""Quality metrics: PSNR and the information-loss harness.

Counterpart of ``aainterp/metrics.py``.  Quantifies the reference README's
qualitative claim (README.md:8-9) that area-average interpolation keeps
the image's information during reduction, unlike bilinear/bicubic: after
a downscale the *total flux* (mean x area) of a conservative resample
matches the source, and the round-trip error is lower.  Used by
``baselines``.  Every metric computes in float32 over the trailing two
axes, on the device of a tensor input, else on ``device=`` (default the
GPU; ``utils.device.as_input``).
"""

from __future__ import annotations

from typing import Optional

import torch

from .utils.device import Device, as_input


def _f32(x, device: Device) -> torch.Tensor:
    return as_input(x, device).to(torch.float32)


def psnr(a, b, data_range: Optional[float] = None,
         device: Device = None) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB over the trailing 2 axes (the
    range defaults to ``a``'s, floored at 1e-12)."""
    a = _f32(a, device)
    b = _f32(b, a.device)
    if data_range is None:
        data_range = torch.clamp_min(
            a.amax(dim=(-2, -1)) - a.amin(dim=(-2, -1)), 1e-12)
    mse = torch.mean((a - b) ** 2, dim=(-2, -1))
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp_min(mse, 1e-30))


def mean_flux_error(src, dst, device: Device = None) -> torch.Tensor:
    """Relative error of the image mean ('flux') after resampling.

    Conservative (area-average) resampling of a fully covered grid keeps
    the mean intact; bilinear/bicubic with even kernels generally do not
    at non-integer ratios.
    """
    src = _f32(src, device)
    dst = _f32(dst, src.device)
    ms = torch.mean(src, dim=(-2, -1))
    md = torch.mean(dst, dim=(-2, -1))
    return torch.abs(md - ms) / torch.clamp_min(torch.abs(ms), 1e-12)


def information_loss(src, roundtrip, device: Device = None) -> torch.Tensor:
    """RMS error of a downscale -> upscale round trip, normalised to the
    source's RMS."""
    src = _f32(src, device)
    rt = _f32(roundtrip, src.device)
    num = torch.sqrt(torch.mean((src - rt) ** 2, dim=(-2, -1)))
    den = torch.sqrt(torch.mean(src ** 2, dim=(-2, -1)))
    return num / torch.clamp_min(den, 1e-12)
