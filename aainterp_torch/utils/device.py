"""Where a public entry point puts its input, where a kernel wrapper
writes its output, how host tables reach a device (``upload``), and the
card's shared-memory limit the planners use.

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

import numpy as np
import torch

Device = Optional[Union[torch.device, str]]

# the H100's per-block opt-in maximum of dynamic shared memory (227 KB)
SMEM_LIMIT = 232448


def _same(a: torch.device, b: torch.device) -> bool:
    """``a`` is ``b``, where ``b`` without an index means any index."""
    return a.type == b.type and (b.index is None or a.index == b.index)


def target(device: Device = None) -> torch.device:
    """The device an entry point without a tensor input computes on:
    ``device``, or ``cuda`` where it is None; raises RuntimeError where
    that is CUDA and there is no CUDA device."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "aainterp_torch computes on the GPU, and no CUDA device is "
            "available: pass a CPU tensor or device='cpu' to compute on "
            "the CPU")
    return device


def as_input(x, device: Device = None) -> torch.Tensor:
    """``x`` as a tensor on the device an entry point computes on."""
    if isinstance(x, torch.Tensor) and device is None:
        return x
    device = target(device)
    if isinstance(x, torch.Tensor):
        return x if _same(x.device, device) else x.to(device)
    return torch.as_tensor(x, device=device)


def out_buffer(out, shape, dtype, device) -> torch.Tensor:
    """``out`` checked to be a contiguous ``dtype`` tensor of ``shape`` on
    ``device``, or a new empty one when it is None."""
    if out is None:
        return torch.empty(shape, dtype=dtype, device=device)
    if (tuple(out.shape) != tuple(shape) or out.dtype != dtype
            or out.device != torch.device(device)
            or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous {dtype} tensor of shape "
                         f"{tuple(shape)} on {device}")
    return out


def upload(a, device, dtype: Optional[torch.dtype] = None, *,
           pinned: bool = False) -> torch.Tensor:
    """A host table (numpy, possibly a read-only memory map) as a new
    tensor on ``device``, in ``dtype`` (default: the table's own).

    ``pinned=True`` on a CUDA device stages the table in pinned host
    memory and copies it with ``non_blocking=True`` on the current
    stream: the call returns before the copy lands, and work queued on
    that stream sees the table (work on another stream must wait for
    this one).  Otherwise the copy is synchronous."""
    a = np.asarray(a)
    device = torch.device(device)
    if pinned and device.type == "cuda":
        dtype = dtype or torch.from_numpy(np.empty(0, a.dtype)).dtype
        host = torch.empty(a.shape, dtype=dtype, pin_memory=True)
        np.copyto(host.numpy(), a, casting="unsafe")
        return host.to(device, non_blocking=True)
    if not a.flags.writeable or not a.flags.c_contiguous:
        a = np.array(a, order="C")          # torch.from_numpy needs both
    t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype or t.dtype)
