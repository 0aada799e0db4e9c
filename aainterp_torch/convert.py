"""Carry an operator's host tables into the port as plain numpy.

The port's "parameters" are the operator's band tables.  A separable
operator built anywhere (the JAX package, a disk cache, another process)
can be unpacked into numpy arrays and rebuilt here, so both sides apply
identical tables.  Nothing here imports the JAX package.
"""

from __future__ import annotations

from typing import Mapping, Sequence, Tuple

import numpy as np

from .grids import GridSpec
from .ops.overlap1d import Band1D
from .ops.weights import SeparableOperator


def band_from_numpy(band: Sequence) -> Band1D:
    """Band1D from ``(start, weights, n_src, n_dst)``."""
    start, weights, n_src, n_dst = band
    start = np.ascontiguousarray(start, dtype=np.int32)
    weights = np.ascontiguousarray(weights, dtype=np.float64)
    if weights.ndim != 2 or start.shape != (weights.shape[0],):
        raise ValueError(f"band start {start.shape} / weights "
                         f"{weights.shape} do not match")
    if weights.shape[0] != int(n_dst):
        raise ValueError(f"band has {weights.shape[0]} rows, n_dst={n_dst}")
    return Band1D(start=start, weights=weights, n_src=int(n_src),
                  n_dst=int(n_dst))


def spec_from_fields(fields: Mapping) -> GridSpec:
    """GridSpec from a mapping of its fields (e.g. ``dataclasses.asdict``);
    tuple-valued fields may arrive as lists."""
    return GridSpec(**{k: tuple(v) if isinstance(v, list) else v
                       for k, v in fields.items()})


def operator_from_numpy(
    spec_fields: Mapping,
    wy: Sequence,
    wx: Sequence,
    raw_row_sums: Tuple[np.ndarray, np.ndarray],
    mode: str = "exact",
) -> SeparableOperator:
    """The port's SeparableOperator from plain numpy tables.

    ``wy`` / ``wx`` are ``(start, weights, n_src, n_dst)``; ``raw_row_sums``
    the (y, x) pre-normalisation sums.
    """
    sy, sx = raw_row_sums
    return SeparableOperator(
        spec=spec_from_fields(spec_fields),
        wy=band_from_numpy(wy),
        wx=band_from_numpy(wx),
        raw_row_sums=(np.asarray(sy, dtype=np.float64),
                      np.asarray(sx, dtype=np.float64)),
        mode=mode,
    )
