"""Where a public entry point puts its input.

The port's entry points run on the card unless the caller asks for the
CPU.  ``device=``, where given, is where the call computes: any input,
a tensor on another device too, goes there.  Without it a
``torch.Tensor`` keeps its device (the caller chose it) and any other
input (a numpy array, a list, a scalar) goes to ``cuda``.  Where CUDA is
the target and there is no CUDA device, the call raises instead of
carrying on on the CPU.  (The JAX package's ``jnp.asarray`` likewise puts
such input on its default device, the accelerator.)
"""

from __future__ import annotations

from typing import Optional, Union

import torch

Device = Optional[Union[torch.device, str]]


def _same(a: torch.device, b: torch.device) -> bool:
    """``a`` is ``b``, where ``b`` without an index means any index."""
    return a.type == b.type and (b.index is None or a.index == b.index)


def as_input(x, device: Device = None) -> torch.Tensor:
    """``x`` as a tensor on the device an entry point computes on."""
    if isinstance(x, torch.Tensor) and device is None:
        return x
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "aainterp_torch computes on the GPU, and no CUDA device is "
            "available: pass a CPU tensor or device='cpu' to compute on "
            "the CPU")
    if isinstance(x, torch.Tensor):
        return x if _same(x.device, device) else x.to(device)
    return torch.as_tensor(x, device=device)
