"""Kernel 1 at the 4K flagship in u8, decomposed: the counterpart of
``benchmarks/u8_experiments.py`` and of the u8 probes of
``benchmarks/flagship_experiments.py``.

8 frames of 2160 x 3840 u8 -> 1080 x 1920 u8, exact (4-tap bands), on
kernel 1's own plan (``ops/cuda_apply``; not the TPU's 32-aligned u8 row
bases).  The experiments, under the JAX files' names:

* ``stage`` (JAX's ``dma``) — the window staging and the stores only
  (``band_probes`` mode ``stage``);
* ``extract`` — production's output, the window converted to f32 in
  shared memory before the y pass (``u8convert1``: the TPU's unpack as one
  step of its own);
* ``ydot`` (and JAX's ``xstore``) — staging, the y pass and the stores
  (``stagey``);
* ``u8words`` (flagship_experiments.py's ``u8bitcast``) — production's
  output, the y pass reading 4 pixels per 32-bit word (``u8words``, on
  the stage ring; its first form ``u8words_direct`` is launched by no
  experiment);
* ``u8chunk2``, ``u8chunk4`` (``_build_u8chunk``) — the conversion in 2 or
  4 column chunks, each followed by its part of the y pass
  (``u8convert2``, ``u8convert4``);
* ``xpair`` — production's output from an x pass for the exact ratio-2
  band: fixed stride-2 source columns and a (4, Wd) tap table
  (``xpair``, on the stage ring with no T: the y sums feed the x taps
  from registers; its first form ``xpair_direct`` is launched by no
  experiment);
* ``full`` — the production kernel.

JAX's ``xdot`` and ``xdot1`` isolate a TPU scratch round trip and dynamic
slicing that the card's kernel does not have (its y-pass rows are in
shared memory already): their counterpart is the production kernel, and
they run ``full`` and say so.  ``discover_u8_pack_order`` has no order to
discover on the card: a 32-bit word holds four neighbouring pixels of a
row, little-endian (``band_probes.word_pixels``).

    python -m aainterp_torch.probes.u8_experiments --exp u8words \\
        [--batch 8] [--device cuda]
"""

from __future__ import annotations

import sys

import torch

from .band_probes import (H, W, LAUNCHES, band_probe_kernel,  # noqa: F401
                          band_probe_plain, main as _main, run_exp, traffic)
from ..utils.device import Device

# experiment -> probe mode (None: the production kernel)
MODES = {"stage": "stage", "extract": "u8convert1", "ydot": "stagey",
         "u8words": "u8words", "u8chunk2": "u8convert2",
         "u8chunk4": "u8convert4", "xpair": "xpair", "full": None,
         "xdot": None, "xdot1": None}
_RUNS = {"xdot": "the production kernel: the card's y-pass rows stay in "
                 "shared memory, so it has no scratch round trip to remove",
         "xdot1": "the production kernel: its stores are one tile's rows "
                  "already"}


def _exp(name: str):
    def exp(batch: int = 8, dtype=torch.uint8, device: Device = None,
            shape=(H, W)):
        if dtype != torch.uint8:
            raise ValueError(f"{name} is a uint8 experiment (--dtype uint8)")
        extra = {"runs": _RUNS[name]} if name in _RUNS else {}
        return run_exp(name, MODES[name], batch, dtype, device, shape,
                       **extra)
    exp.__name__ = f"exp_{name}"
    exp.__doc__ = (f"{name}: mode {MODES[name] or 'production'} on 8 "
                   "distinct u8 frame batches.")
    return exp


EXPS = {name: _exp(name) for name in MODES}


def main(argv=None) -> int:
    return _main(EXPS, __doc__, ("uint8",), argv)


if __name__ == "__main__":
    sys.exit(main())
