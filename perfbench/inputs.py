"""The frames of a run, made on the device from ``--seed``.

The pattern of the program's probe harness (``probes/harness.py``
``seeded`` / ``uniform``), kept here so that the yardstick does not move
with the program: one generator on the device, values uniform in [0, 1)
(uint8: every level 0..255), one batch a call in the order of the pool.
The same seed gives the same frames; every seed gives the same sizes.
"""

from __future__ import annotations

from typing import List

import torch

DTYPES = {"uint8": torch.uint8, "bfloat16": torch.bfloat16,
          "float16": torch.float16, "float32": torch.float32}


def generator(seed: int, device) -> torch.Generator:
    # any whole number: the generator takes 64 bits
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 64))


def batch(shape, dtype: torch.dtype, gen: torch.Generator,
          device) -> torch.Tensor:
    if dtype == torch.uint8:
        return torch.randint(0, 256, shape, generator=gen, device=device,
                             dtype=torch.uint8)
    return torch.rand(shape, generator=gen, device=device).to(dtype)


def pool(traffic: dict, src_shape, seed: int, device) -> List[torch.Tensor]:
    """``traffic['pool']`` distinct batches of ``traffic['frames']``."""
    gen = generator(seed, device)
    shape = (int(traffic["frames"]),) + tuple(int(n) for n in src_shape)
    dtype = DTYPES[traffic["dtype"]]
    return [batch(shape, dtype, gen, device)
            for _ in range(int(traffic["pool"]))]
