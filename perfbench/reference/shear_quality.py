"""Reference family ``shear_quality``: a rotated geometry in mode 'shear'
with the 'quality' decomposition, three conservative 1-D passes, then a
multiply by the reciprocal coverage.

Between passes the values are rounded as the configuration states the
route does: to float32 for float32 frames, to bf16 for every other
dtype."""

from __future__ import annotations

import torch

from . import resample
from .geometry import Geometry


def tables(geo: Geometry, device):
    return resample.shear_tables(geo, device)


def mid_dtype(frames: torch.dtype) -> torch.dtype:
    return torch.float32 if frames == torch.float32 else torch.bfloat16


def apply(geo: Geometry, x: torch.Tensor, dtype: torch.dtype,
          passes) -> torch.Tensor:
    return resample.shear_xyx(geo, x, dtype, mid_dtype(x.dtype), passes)
