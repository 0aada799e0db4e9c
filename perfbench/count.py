"""Bytes and operations of one batch of a cell's function.

The count is of the function, not of a route: each input frame's bytes
read once and each output byte written once, whatever a route reads
again or keeps in between (operator tables, the rotated route's T, a
stage's output).  Operations are the multiply-adds that any route needs
at least: each output is a weighted mean over the source cells its
footprint covers, (dst side / source side)^2 of them on average, 2
operations each.  The bound of a batch is the larger of bytes over the
card's memory bandwidth and operations over its float32 rate, so it
reads the same work whatever implements the cell.
"""

from __future__ import annotations

import json
from pathlib import Path

from .reference.geometry import from_config

ELEMENT_BYTES = {"uint8": 1, "bfloat16": 2, "float16": 2, "float32": 4,
                 "float64": 8}


def batch_counts(cfg: dict, traffic: dict) -> dict:
    """{'bytes', 'flops', 'in_pixels'} of one batch."""
    geo = from_config(cfg)
    F = int(traffic["frames"])
    H, W = geo.src_shape
    Hd, Wd = geo.dst_shape
    in_px = F * H * W
    out_px = F * Hd * Wd
    nbytes = (in_px * ELEMENT_BYTES[traffic["dtype"]]
              + out_px * ELEMENT_BYTES[traffic["out_dtype"]])
    cells_per_output = (geo.side / geo.scale) ** 2
    return {"bytes": nbytes, "flops": 2.0 * out_px * cells_per_output,
            "in_pixels": in_px}


def load_peaks(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def bound_s(counts: dict, peak: dict) -> float:
    """Least seconds a batch can take on a card with ``peak``."""
    return max(counts["bytes"] / peak["hbm_bytes_per_s"],
               counts["flops"] / peak["float32_flops_per_s"])
