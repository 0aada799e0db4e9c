"""The plain reference of the benchmark: plain torch, float64.

A cell's file names its family under ``reference``: the module
``perfbench/reference/<family>.py``, with ``tables(geo, device)`` (the
geometry's tables, worked out once: the interval overlaps, the overlap
areas or the shear passes) and ``apply(geo, x, dtype, tables)``.
``Reference(cfg, family, device)`` is then called on a batch of frames:
``ref(x)`` gives the float64 values before the output's rounding,
``ref(x, torch.bfloat16)`` the same computed in bf16 arithmetic, the
control.  It imports neither ``jax``, the JAX package nor anything of
the program under test.
"""

from __future__ import annotations

import importlib

import torch

from .geometry import from_config


class Reference:
    def __init__(self, cfg: dict, family: str, device):
        if not family.isidentifier():
            raise ValueError(f"no reference family {family!r}")
        self.geo = from_config(cfg)
        self.family = importlib.import_module(f"{__name__}.{family}")
        self.tables = self.family.tables(self.geo, device)

    def __call__(self, x: torch.Tensor,
                 dtype: torch.dtype = torch.float64) -> torch.Tensor:
        return self.family.apply(self.geo, x, dtype, self.tables)
