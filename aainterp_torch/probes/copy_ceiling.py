"""The card's copy ceiling at a frame geometry: the counterpart of
``benchmarks/copy_ceiling.py``.

``copy_rows_kernel(x, tile_y)`` computes ``_build_copy``'s function, (F, H,
W) -> (F, nt * TY, W) with nt = H // TY, on ``csrc/probes.cu``
``aainterp_copy_rows``: each (frame, row tile) split into parts of one
block's sweep, one block each (``grid_blocks``), 16-byte loads and
stores, raw bytes, so any dtype of 1, 2, 4 or 8 bytes copies bit for bit.
The same kernel is the counterpart of ``benchmarks/rgb1024_experiments.py``
``_build_copy`` (H = W = 1024, TY 128; ``rgb1024_experiments.exp_copy``
runs it at JAX's batch * 3 = 24 frames).  A CUDA tensor launches the kernel
or raises; a CPU tensor takes ``copy_rows_plain``.  ``LAUNCHES`` counts
the launches.

    python -m aainterp_torch.probes.copy_ceiling --H 2160 --W 3840 \\
        [--tile_y 120] [--batch 8] [--dtype bfloat16] [--device cuda]

prints the JAX probe's line: time per frame, and GB/s combined (read plus
write) and each way, on K = 8 distinct batches (``measure``).
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

import torch

from .. import _build
from ..utils.device import Device, out_buffer, target
from . import harness

# kernel launches so far, counted where the wrapper launches the kernel
LAUNCHES = 0
K = 8              # distinct batches measure() times (JAX's timed_scan: 8)
# probes.cu: a part is about one sweep of a block (128 threads, 4 loads of
# 16 bytes each), one block per part
PART_BYTES = 16 * 4 * 128


def grid_blocks(F: int, H: int, W: int, tile_y: int, elem: int) -> int:
    """The blocks of one launch (``launch_copy`` in probes.cu): each of the
    F * (H // tile_y) row tiles split into parts of about PART_BYTES, one
    block each."""
    return F * (H // tile_y) * max(1, tile_y * W * elem // PART_BYTES)


def _rows(x: torch.Tensor, tile_y: int) -> int:
    """nt * TY, the rows the copy keeps; checks ``x`` and ``tile_y``."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"frames must be a torch.Tensor, got {type(x)}")
    if x.ndim != 3 or 0 in x.shape:
        raise ValueError(f"frames must be (F, H, W) with none of them 0, got "
                         f"{tuple(x.shape)}")
    if not 1 <= tile_y <= x.shape[1]:
        raise ValueError(f"tile_y must be in [1, H={x.shape[1]}], got "
                         f"{tile_y}")
    return x.shape[1] // tile_y * tile_y


def copy_rows_plain(x: torch.Tensor, tile_y: int) -> torch.Tensor:
    """(F, H, W) -> (F, (H // tile_y) * tile_y, W): the first whole row
    tiles of every frame, copied."""
    return x[:, :_rows(x, tile_y)].clone()


def copy_rows_kernel(x: torch.Tensor, tile_y: int, *,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``copy_rows_plain`` on the CUDA kernel (a CPU tensor takes the
    plain version); ``out`` may be given (any contents: every element is
    written)."""
    rows = _rows(x, tile_y)
    F, H, W = x.shape
    if x.device.type == "cpu":
        y = copy_rows_plain(x, tile_y)
        return y if out is None else out_buffer(
            out, y.shape, x.dtype, x.device).copy_(y)
    out = out_buffer(out, (F, rows, W), x.dtype, x.device)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if not x.is_contiguous():
        raise ValueError("frames must be contiguous")
    if x.element_size() not in (1, 2, 4, 8):
        raise TypeError(f"no copy for elements of {x.element_size()} bytes")
    global LAUNCHES
    fn = _build.load(_build.PROBES).aainterp_copy_rows
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), out.data_ptr(), F, H, W, tile_y,
                x.element_size(), stream)
    if rc != 0:
        raise RuntimeError(f"copy_rows kernel launch failed: CUDA error {rc} "
                           f"(F={F}, H={H}, W={W}, TY={tile_y}, "
                           f"{x.element_size()}-byte elements)")
    LAUNCHES += 1
    return out


def measure(H: int = 2160, W: int = 3840, tile_y: int = 120, batch: int = 8,
            dtype: torch.dtype = torch.bfloat16,
            device: Device = None) -> dict:
    """Time the copy on ``K`` distinct seeded batches of (batch, H, W) on
    ``device`` (default: the card), warmed up on one more; bytes are the
    rows copied, read once and written once."""
    dev = target(device)
    gen = harness.seeded(dev, 0)
    frames = [harness.uniform((batch, H, W), dtype, gen, dev)
              for _ in range(K + 1)]
    t = harness.measure(lambda x: copy_rows_kernel(x, tile_y), frames[1:],
                        frames[:1])
    nbytes = _rows(frames[0], tile_y) * W * frames[0].element_size()
    s_frame = t.ms * 1e-3 / batch
    return {"H": H, "W": W, "tile_y": tile_y, "batch": batch,
            "dtype": str(dtype).split(".")[-1], "ms_per_batch": t.ms,
            "us_per_frame": s_frame * 1e6,
            "gb_s_combined": 2 * nbytes / s_frame / 1e9,
            "gb_s_each_way": nbytes / s_frame / 1e9,
            "bytes_per_batch": 2 * nbytes * batch,
            "clock": t.clock, "device": t.device}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--H", type=int, default=2160)
    ap.add_argument("--W", type=int, default=3840)
    ap.add_argument("--tile_y", type=int, default=120)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.H % args.tile_y:
        ap.error(f"--H {args.H} is not a multiple of --tile_y {args.tile_y}")
    dtype = getattr(torch, args.dtype)
    try:
        r = measure(args.H, args.W, args.tile_y, args.batch, dtype,
                    args.device)
    except RuntimeError as e:
        print(e, file=sys.stderr)
        return 2
    print(f"copy {args.H}x{args.W} {args.dtype} tile_y={args.tile_y}: "
          f"{r['us_per_frame']:.1f} us/frame, "
          f"{r['gb_s_combined']:.0f} GB/s combined "
          f"({r['gb_s_each_way']:.0f} GB/s each way)")
    if r["clock"] != "cuda_events":
        print(f"({r['device']}: the plain copy on the host's clock, not a "
              "device time)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
