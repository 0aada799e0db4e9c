"""Reference family ``separable``: an axis-aligned geometry, whatever the
mode, is the exact operator: the 1-D interval overlaps of each
destination interval with the source cells, rows normalised."""

from __future__ import annotations

import torch

from . import resample
from .geometry import Geometry


def tables(geo: Geometry, device):
    return resample.separable_bands(geo, device)


def apply(geo: Geometry, x: torch.Tensor, dtype: torch.dtype,
          bands) -> torch.Tensor:
    return resample.separable(geo, x, dtype, bands)
