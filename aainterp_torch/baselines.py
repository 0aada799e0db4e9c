"""Bilinear/bicubic baselines and the information-preservation comparison.

Counterpart of ``aainterp/baselines.py``.  Reproduces the reference
README's qualitative claim (README.md:8-9 — area averaging "prevents the
loss of image information" during reduction, unlike bilinear/bicubic)
quantitatively: ``compare_downscale`` resamples with all three methods
and reports the PSNR of the round trip and the mean-flux error.

The baselines are library calls on purpose, as the JAX package's are
XLA's ``jax.image.resize``: ``torch.nn.functional.interpolate`` with
``antialias=True`` and ``align_corners=False``, which is what
``jax.image.resize(method='linear'|'cubic')`` computes (a triangle or
Keys cubic kernel widened by the scale on a downscale, half-pixel
centres).  Without ``antialias`` a downscale would sample instead of
filter and differ from JAX's by up to 0.65 on [0, 1] images.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import metrics
from .api import area_average_interpolate
from .utils.device import Device, as_input

# JAX's method names and the port's resize() names -> F.interpolate modes
_MODES = {"linear": "bilinear", "bilinear": "bilinear",
          "cubic": "bicubic", "bicubic": "bicubic"}


def resize_baseline(src, dst_shape: Tuple[int, int], method: str,
                    device: Device = None) -> torch.Tensor:
    """Bilinear ('linear') or bicubic ('cubic') resize of the trailing 2
    axes of (..., H, W) (``'bilinear'`` / ``'bicubic'`` are accepted too).
    Float inputs keep their dtype (computed in float32 for half types);
    other dtypes give float32."""
    if method not in _MODES:
        raise ValueError(f"method must be one of {sorted(_MODES)}, got "
                         f"{method!r}")
    src = as_input(src, device)
    out_dtype = src.dtype if src.dtype.is_floating_point else torch.float32
    work = src if src.dtype in (torch.float32, torch.float64) \
        else src.to(torch.float32)
    lead, (H, W) = tuple(src.shape[:-2]), tuple(src.shape[-2:])
    out = F.interpolate(work.reshape((1, -1, H, W)), size=tuple(dst_shape),
                        mode=_MODES[method], align_corners=False,
                        antialias=True)
    return out.reshape(lead + tuple(dst_shape)).to(out_dtype)


def compare_rotation_roundtrip(
    src,
    angle: float = 30.0,
    resolution: float = 1.0,
    device: Device = None,
) -> Dict[str, float]:
    """Rotate by +angle then -angle and PSNR the central region against
    the original: information preservation under rotation, area-average
    (on ``device``, default the GPU) against scipy's bilinear/bicubic
    rotation (the interpolators the reference's README positions itself
    against).  Returns {method: psnr_db}."""
    from scipy import ndimage

    if isinstance(src, torch.Tensor):
        src = src.detach().cpu().double().numpy()
    src = np.asarray(src, np.float64)
    H, W = src.shape
    iso = (W / 2.0, H / 2.0)
    results = {}

    def area(img, iso_, ang):
        x = torch.as_tensor(img.astype(np.float32))
        r = area_average_interpolate(x, resolution, resolution, iso_, ang,
                                     device=device or "cuda")
        return r.dst.detach().cpu().double().numpy()

    fwd = area(src, iso, angle)
    h2, w2 = fwd.shape
    back = area(fwd, (w2 / 2.0, h2 / 2.0), -angle)

    def center_crop_psnr(rt):
        hh, ww = rt.shape
        cy, cx = hh // 2, ww // 2
        k = min(H, W) // 4
        crop_rt = rt[cy - k: cy + k, cx - k: cx + k]
        crop_src = src[H // 2 - k: H // 2 + k, W // 2 - k: W // 2 + k]
        mse = float(np.mean((crop_rt - crop_src) ** 2))
        rng = float(crop_src.max() - crop_src.min()) or 1.0
        return 10.0 * math.log10(rng * rng / max(mse, 1e-30)) \
            if mse > 0 else float("inf")

    results["area_average"] = center_crop_psnr(back)
    for name, order in (("bilinear", 1), ("bicubic", 3)):
        fwd_s = ndimage.rotate(src, -angle, reshape=True, order=order)
        back_s = ndimage.rotate(fwd_s, angle, reshape=True, order=order)
        results[name] = center_crop_psnr(back_s)
    return results


def compare_downscale(
    src,
    src_resolution: float,
    dst_resolution: float,
    src_isocenter=(0.0, 0.0),
    device: Device = None,
) -> Dict[str, Dict[str, float]]:
    """Downscale with area-average / bilinear / bicubic and score each.

    Returns {method: {psnr_roundtrip, mean_flux_error}}.
    """
    src = as_input(src, device).to(torch.float32)
    r = area_average_interpolate(
        src, src_resolution, dst_resolution, src_isocenter, 0.0
    )
    dst_shape = tuple(r.dst.shape[-2:])
    results = {}
    candidates = {
        "area_average": r.dst,
        "bilinear": resize_baseline(src, dst_shape, "linear"),
        "bicubic": resize_baseline(src, dst_shape, "cubic"),
    }
    for name, dst in candidates.items():
        up = resize_baseline(dst, tuple(src.shape[-2:]), "linear")
        results[name] = {
            "psnr_roundtrip": float(metrics.psnr(src, up).mean()),
            "mean_flux_error": float(
                metrics.mean_flux_error(src, dst).mean()),
        }
    return results
