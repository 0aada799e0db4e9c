"""Reference family ``rotated``: a rotated geometry in mode 'exact', the
overlap areas of each rotated destination square with the source cells
(polygon clipping), rows normalised."""

from __future__ import annotations

import torch

from . import resample
from .geometry import Geometry


def tables(geo: Geometry, device):
    return resample.rotated_weights(geo, device)


def apply(geo: Geometry, x: torch.Tensor, dtype: torch.dtype,
          weights) -> torch.Tensor:
    return resample.rotated(geo, x, dtype, weights)
