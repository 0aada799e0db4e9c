"""Kernel 1 at the 4K flagship, decomposed: the counterpart of
``benchmarks/flagship_experiments.py``.

The flagship is 8 frames of 2160 x 3840 -> 1080 x 1920, exact (4-tap
bands), bf16 (or f32), on kernel 1's own plan (``ops/cuda_apply``: 8 x 240
dst tiles; not the TPU's 120-row tiles and 128-column blocks).  The
experiments, under the JAX file's names:

* ``stage`` (JAX's ``dma``, ``_build_band_probe(with_y=False)``) — the
  window staging and the output stores only (``band_probes`` mode
  ``stage``);
* ``ypass`` (``_build_band_probe(with_y=True)``) — staging, the y pass and
  the stores (``stagey``);
* ``full`` — the production kernel (``cuda_apply.apply_separable_kernel``);
* ``full2``, ``full3``, ``full4`` (``_build_full_nslot``) — production's
  function from blocks that walk row tiles with 1, 2 or 3 windows in
  flight (``walk2``, ``walk3``, ``walk4``).

JAX's ``u8bitcast`` and ``u8chunk2/4`` and the byte order probe
``discover_u8_pack_order`` are ``u8_experiments``'s ``u8words``,
``u8chunk2/4`` and ``band_probes.word_pixels``.  ``band_probe_kernel``,
``band_probe_plain``, ``traffic`` and ``LAUNCHES`` are ``band_probes``'s.
Each experiment makes 8 + 1 seeded frame batches on the device and times
the kernel with ``harness.measure`` (CUDA-graph replays, best of two).

    python -m aainterp_torch.probes.flagship_experiments --exp stage \\
        [--batch 8] [--dtype bfloat16|float32] [--device cuda]

prints the JAX probe's line, ``{exp}: ... Gpixel/s  (... us/frame)``.
"""

from __future__ import annotations

import sys

import torch

from .band_probes import (H, W, LAUNCHES, band_probe_kernel,  # noqa: F401
                          band_probe_plain, main as _main, run_exp, traffic)
from ..utils.device import Device

# experiment -> probe mode (None: the production kernel)
MODES = {"stage": "stage", "ypass": "stagey", "full": None,
         "full2": "walk2", "full3": "walk3", "full4": "walk4"}


def _exp(name: str):
    def exp(batch: int = 8, dtype=torch.bfloat16, device: Device = None,
            shape=(H, W)):
        return run_exp(name, MODES[name], batch, dtype, device, shape)
    exp.__name__ = f"exp_{name}"
    exp.__doc__ = (f"{name}: mode {MODES[name] or 'production'} on 8 "
                   "distinct frame batches.")
    return exp


EXPS = {name: _exp(name) for name in MODES}


def main(argv=None) -> int:
    return _main(EXPS, __doc__, ("bfloat16", "float32"), argv)


if __name__ == "__main__":
    sys.exit(main())
