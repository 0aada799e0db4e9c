"""Kernel 1 at rgb1024, decomposed: the counterpart of
``benchmarks/rgb1024_experiments.py``.

rgb1024 is ``bench.py``'s config 2: 8 RGB images flattened to 24 planes of
1024 x 1024 (``batch * 3`` frames, ``--batch 8``), 150 -> 60 dpi, exact
(4-tap bands, 1024 -> 410), bf16 (or f32), on kernel 1's own plan
(``ops/cuda_apply``: 8 x 240 dst tiles, two strips; not the TPU's 128 x 128
blocks).  The experiments, under the JAX file's names:

* ``copy`` (``_build_copy``) — the row-tiled copy of the frames at TY 128
  (``copy_ceiling.copy_rows_kernel``): the card's copy ceiling at this row
  length;
* ``dma`` (``_build_band_probe(with_y=False)``) — the window staging and
  the output stores only (``band_probes`` mode ``stage``);
* ``ypass`` (``_build_band_probe(with_y=True)``) — staging, the y pass and
  the stores (``stagey``);
* ``xonly`` (``_build_xonly``) — production's x pass alone, from seeded
  random batches of the y pass's output, (24, 410, 1024) (``xonly``);
* ``fulldense`` (``_build_full_dense_x``) — production's y pass, then one
  dense (1024, 410) x operator in the frame dtype in place of the 4-tap
  band, summed over all 1024 columns (``densex``);
* ``full`` — the production kernel (``cuda_apply.apply_separable_kernel``).

Each experiment makes 8 + 1 seeded batches on the device and times the
kernel with ``harness.measure`` (CUDA-graph replays, best of two).

    python -m aainterp_torch.probes.rgb1024_experiments --exp dma \\
        [--batch 8] [--dtype bfloat16|float32] [--device cuda]

prints the JAX probe's line, ``{exp}: ... Gpixel/s  (... us/frame)``.
"""

from __future__ import annotations

import sys

import torch

from . import copy_ceiling
from .band_probes import (LAUNCHES, band_probe_kernel,  # noqa: F401
                          band_probe_plain, flagship_tables, main as _main,
                          run_exp, traffic)
from ..utils.device import Device

H = W = 1024
RES = (150.0, 60.0)   # dpi: bench.py's config 2
TY = 128              # the copy's row tile (JAX's TY)
CHANNELS = 3          # frames per image: RGB flattened over channels

# experiment -> probe mode (None: the production kernel; "copy": the copy)
MODES = {"copy": "copy", "dma": "stage", "ypass": "stagey",
         "xonly": "xonly", "fulldense": "densex", "full": None}


def tables(shape=(H, W)):
    """Kernel 1's host tables at rgb1024's ratio, 150 -> 60 dpi."""
    return flagship_tables(tuple(shape), *RES)


def exp_copy(batch: int = 8, dtype=torch.bfloat16, device: Device = None,
             shape=(H, W)) -> dict:
    """copy: the row-tiled copy of batch * 3 frames at TY 128."""
    frames = batch * CHANNELS
    r = copy_ceiling.measure(shape[0], shape[1], TY, frames, dtype, device)
    ms = r["ms_per_batch"]
    return {"exp": "copy", "mode": "copy", "ms_per_batch": ms,
            "gpixel_s": frames * shape[0] * shape[1] / (ms * 1e-3) / 1e9,
            "us_per_frame": r["us_per_frame"], "batch": frames,
            "dtype": r["dtype"], "shape": list(shape),
            "bytes": r["bytes_per_batch"], "operations": 0,
            "clock": r["clock"], "device": r["device"]}


def _exp(name: str):
    def exp(batch: int = 8, dtype=torch.bfloat16, device: Device = None,
            shape=(H, W)):
        return run_exp(name, MODES[name], batch * CHANNELS, dtype, device,
                       shape, RES)
    exp.__name__ = f"exp_{name}"
    exp.__doc__ = (f"{name}: mode {MODES[name] or 'production'} on 8 "
                   "distinct batches of batch * 3 frames.")
    return exp


EXPS = {name: exp_copy if name == "copy" else _exp(name) for name in MODES}


def main(argv=None) -> int:
    return _main(EXPS, __doc__, ("bfloat16", "float32"), argv, (H, W), RES)


if __name__ == "__main__":
    sys.exit(main())
