"""The Mosaic watchlist on Hopper: the counterpart of
``benchmarks/mosaic_watchlist.py``.

JAX's watchlist compiles six minimal Pallas kernels, each one lowering
that a parked TPU design waits on, and reports each "LIFTED" or
"blocked".  Here each probe computes the same small function on
``csrc/watchlist.cu`` with the Hopper feature that the parked design
needs on this card, built from the primitives of ``csrc/hopper.cuh``:

* ``strided_y_bf16`` — ``out[i, j] = f32(x[0, i, 1, j])``, one parity of
  a size-2 axis of bf16 (1, 32, 2, 256): a 4-D TMA box one wide on the
  parity axis, completing on an mbarrier, one block per box of one row x
  256 columns (16 here), four values widened a thread into one 16-byte
  store;
* ``strided_load`` — ``out = x[:, ::2]`` of (120, 3840) f32: 2-D TMA
  windows of 4 rows x 256 columns, one block each (450 here), then a
  stride-2 read of shared memory, four even columns a thread into one
  16-byte store;
* ``value_slice`` — ``out = x[:, ::2] + x[:, 1::2]`` of (8, 512) f32: one
  16-byte load a thread, the pair sums in registers (the ``xpair`` form),
  launched as a programmatic dependent launch;
* ``unaligned_dma`` — ``out = x[8:24]`` of (64, 3600) f32, rows of 14,400
  bytes (not a multiple of 512): each row cut into pieces of whole
  16-byte chunks of at most 2 KB (16 x 8 here), one block a piece: a 1-D
  bulk copy into shared memory onto an mbarrier, a bulk store back;
* ``high_dot`` — ``a @ b`` at ``Precision.HIGH`` (bf16x3: ``hi·hi + hi·lo
  + lo·hi``, ``hi = bf16(a)``, ``lo = bf16(a − hi)``, f32 sums) of
  (128, 128) f32: ``wgmma`` m64n32k16 on the split in shared memory, one
  warpgroup per 64 x 32 tile (8 blocks), K through a four-stage ring of
  TMA boxes on mbarriers, each chunk split while the last one's products
  run;
* ``vpu_dyn_rows`` — ``out[r] = x[off[r]] + x[off[r] + 1]``, r < 16, of
  (64, 256) f32 at offsets the kernel reads itself (JAX's scalar
  prefetch): one block a row and 256 columns (16 here), its offset one
  uniform load, two 16-byte row loads and one 16-byte store a thread
  (scalar ones where C is not a multiple of 4 or x or out is not 16-byte
  aligned), a NaN row for an offset outside [0, rows - 2]; a
  programmatic dependent launch.

value_slice and vpu_dyn_rows launch with programmatic stream
serialization: a kernel may start while the one before it on the stream
runs, and waits for it to finish (``griddepcontrol.wait``) before its
first global read.

Each ``*_kernel`` launches its kernel for a CUDA tensor (and raises on a
failed build, encode or launch) and takes its ``*_plain`` version for a
CPU tensor; it counts its launches in ``LAUNCHES`` and writes into
``out=`` where given.  ``inputs(name, device, seed)`` draws JAX's arrays
(seed 0) or distinct ones for timing.  ``run_watchlist`` reports each
probe "available" (it builds, launches and equals its plain version:
``equal``: bit for bit, for ``high_dot`` |Δ| ≤ 1e-5 · max|ref|) or
"blocked" with the first line of the error, as JAX's ``_run`` does; with
``device="cpu"`` each probe runs its plain version ("plain").
``measure`` times a probe's kernel, plain version and library call
through ``harness``, and on the card its launch floor: ``launch_floor``,
an empty kernel launched with the probe's grid, block, dynamic shared
memory and launch attributes (``csrc/watchlist.cu``'s ``geometry``),
the least time such a launch takes.  ``programmatic_edges`` counts the
programmatic edges of a CUDA graph captured as ``harness`` captures.

    python -m aainterp_torch.probes.mosaic_watchlist [--probe NAME] \\
        [--device cpu]
"""

from __future__ import annotations

import ctypes
import sys
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as nnf

from .. import _build
from ..utils.device import Device, out_buffer, target
from . import harness

NAMES = ("strided_y_bf16", "strided_load", "value_slice", "unaligned_dma",
         "high_dot", "vpu_dyn_rows")
# kernel launches so far per probe, counted where the wrapper launches it
LAUNCHES: Dict[str, int] = {name: 0 for name in NAMES}
# launch-floor kernels launched so far, per probe whose launch they copy
FLOOR_LAUNCHES: Dict[str, int] = {name: 0 for name in NAMES}
# each probe's number in csrc/watchlist.cu (enum Probe)
PROBE_IDS = {name: i for i, name in enumerate(NAMES)}
# the probes whose launches carry the programmatic attribute
PROGRAMMATIC = ("value_slice", "vpu_dyn_rows")
# JAX's shapes: the one input of each probe (high_dot multiplies a by itself)
SHAPES = {"strided_y_bf16": (1, 32, 2, 256), "strided_load": (120, 3840),
          "value_slice": (8, 512), "unaligned_dma": (64, 3600),
          "high_dot": (128, 128), "vpu_dyn_rows": (64, 256)}
DMA_START, DMA_ROWS = 8, 16      # unaligned_dma's x[8:24]
DYN_ROWS = 16                    # vpu_dyn_rows' 16 offsets
HIGH_DOT_RTOL = 1e-5             # high_dot: |kernel - plain| <= 1e-5 max|plain|
HIGH_DOT_TILE = (64, 32)         # high_dot's block tile of out (rows, columns)
STRIDED_LOAD_WINDOW = (4, 256)   # strided_load's TMA window a block (rows, columns)
STRIDED_Y_BOX = (1, 256)         # strided_y_bf16's TMA box a block (rows, columns)
# probes whose operations (in ``traffic``) are bf16 products on the tensor
# cores: high_dot's three, not f32 multiply-adds
TENSOR_CORE_BF16 = ("high_dot",)


def inputs(name: str, device: Device = "cpu", seed: int = 0) -> tuple:
    """A probe's arguments on ``device``: at seed 0 JAX's arrays bit for bit
    (``default_rng(0).uniform(0, 1, shape)`` as float32, bf16 for
    strided_y_bf16, ``(a, a)`` for high_dot, ``arange(16)`` offsets for
    vpu_dyn_rows); other seeds give distinct values (and, for
    vpu_dyn_rows, shuffled offsets)."""
    if name not in SHAPES:
        raise ValueError(f"no probe {name!r}; the probes are {NAMES}")
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.uniform(0, 1, SHAPES[name]).astype(np.float32))
    if name == "strided_y_bf16":
        x = x.to(torch.bfloat16)
    x = x.to(device)
    if name == "high_dot":
        return (x, x)
    if name == "vpu_dyn_rows":
        off = (np.arange(DYN_ROWS) if seed == 0 else
               rng.permutation(SHAPES[name][0] - 1)[:DYN_ROWS])
        return (x, torch.from_numpy(off.astype(np.int32)).to(device))
    return (x,)


# ---- plain versions ----------------------------------------------------------

def strided_y_bf16_plain(x: torch.Tensor, frame: int = 0, parity: int = 1,
                         rows: int = 16) -> torch.Tensor:
    """``f32(x[frame, :rows, parity, :])`` of an (F, R, m, C) bf16 x."""
    return x[frame, :rows, parity, :].float()


def strided_load_plain(x: torch.Tensor) -> torch.Tensor:
    return x[:, ::2].contiguous()


def value_slice_plain(x: torch.Tensor) -> torch.Tensor:
    return x[:, 0::2] + x[:, 1::2]


def unaligned_dma_plain(x: torch.Tensor, start: int = DMA_START,
                        rows: int = DMA_ROWS) -> torch.Tensor:
    return x[start:start + rows].clone()


def bf16x3_split(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``hi = bf16(a)``, ``lo = bf16(a - hi)`` (the difference exact in f32)."""
    hi = a.to(torch.bfloat16)
    return hi, (a - hi.float()).to(torch.bfloat16)


def high_dot_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` at bf16x3: the three products of the split in float64,
    summed, rounded to f32."""
    (ah, al), (bh, bl) = bf16x3_split(a), bf16x3_split(b)
    ah, al, bh, bl = (t.double() for t in (ah, al, bh, bl))
    return (ah @ bh + ah @ bl + al @ bh).float()


def vpu_dyn_rows_plain(x: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """``x[o] + x[o + 1]`` for each offset o in [0, rows - 2], a NaN row
    for any other (the kernel's rows; JAX's probe reads out of bounds
    there)."""
    o = off.long()
    ok = (o >= 0) & (o <= x.shape[0] - 2)
    o = torch.where(ok, o, 0)
    return (x[o] + x[o + 1]).masked_fill(~ok[:, None], float("nan"))


# ---- kernels -----------------------------------------------------------------

def _cuda(name: str, *ts: torch.Tensor) -> bool:
    """True for CUDA tensors (launch), False for CPU ones (plain); raises
    for another device, a non-contiguous or mixed-device input."""
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError(f"{name}: inputs on different devices")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name}: inputs must be contiguous")
    return True


def _launch(name: str, fn, out: torch.Tensor, *args) -> torch.Tensor:
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        what = (f"tensor-map encode failed: CUresult {rc - 100000}"
                if rc >= 100000 else f"CUDA error {rc}")
        raise RuntimeError(f"{name} kernel launch failed: {what}")
    LAUNCHES[name] += 1
    return out


def _lib():
    return _build.load(_build.WATCHLIST)


def _check_dtype(name: str, x: torch.Tensor, dtype: torch.dtype,
                 ndim: int) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: x must be a torch.Tensor, got {type(x)}")
    if x.dtype != dtype or x.ndim != ndim or 0 in x.shape:
        raise ValueError(f"{name} takes a {ndim}-D {dtype} tensor with no "
                         f"empty dimension, got {x.dtype} "
                         f"{tuple(x.shape)}")


def _check_out_aligned(name: str, out: Optional[torch.Tensor]) -> None:
    """The 16-byte stores' limit: a given ``out`` starts 16-byte aligned
    (checked on any device, before any launch)."""
    if out is not None and out.data_ptr() % 16:
        raise ValueError(f"{name}: out must be 16-byte aligned (its kernel "
                         "writes 16-byte stores)")


def strided_y_bf16_kernel(x: torch.Tensor, frame: int = 0, parity: int = 1,
                          rows: int = 16, *,
                          out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``strided_y_bf16_plain`` on 4-D TMA boxes one wide on the parity
    axis, one block per box of one row x 256 columns, 16-byte stores (C a
    multiple of 8; a given ``out`` 16-byte aligned, checked on CPU tensors
    too)."""
    _check_dtype("strided_y_bf16", x, torch.bfloat16, 4)
    F, R, m, C = x.shape
    if not (0 <= frame < F and 0 <= parity < m and 1 <= rows <= R):
        raise ValueError(f"strided_y_bf16: frame {frame}, parity {parity}, "
                         f"rows {rows} outside {tuple(x.shape)}")
    _check_out_aligned("strided_y_bf16", out)
    if not _cuda("strided_y_bf16", x):
        y = strided_y_bf16_plain(x, frame, parity, rows)
        return y if out is None else out_buffer(
            out, y.shape, y.dtype, x.device).copy_(y)
    if C % 8:
        raise ValueError(f"strided_y_bf16: C={C} must be a multiple of 8 "
                         "(a tensor map's 16-byte row stride)")
    out = out_buffer(out, (rows, C), torch.float32, x.device)
    return _launch("strided_y_bf16", _lib().aainterp_strided_y_bf16, out,
                   x.data_ptr(), out.data_ptr(), F, R, m, C, frame, parity,
                   rows)


def strided_load_kernel(x: torch.Tensor, *,
                        out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x[:, ::2]`` on 2-D TMA windows of 4 rows x 256 columns, one block
    each, 16-byte stores (W a multiple of 4; a given ``out`` 16-byte
    aligned, checked on CPU tensors too)."""
    _check_dtype("strided_load", x, torch.float32, 2)
    _check_out_aligned("strided_load", out)
    if not _cuda("strided_load", x):
        y = strided_load_plain(x)
        return y if out is None else out_buffer(
            out, y.shape, y.dtype, x.device).copy_(y)
    R, W = x.shape
    if W % 4:
        raise ValueError(f"strided_load: W={W} must be a multiple of 4")
    out = out_buffer(out, (R, W // 2), torch.float32, x.device)
    return _launch("strided_load", _lib().aainterp_strided_load, out,
                   x.data_ptr(), out.data_ptr(), R, W)


def value_slice_kernel(x: torch.Tensor, *,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x[:, ::2] + x[:, 1::2]``, one 16-byte load a thread (W a multiple
    of 4)."""
    _check_dtype("value_slice", x, torch.float32, 2)
    if not _cuda("value_slice", x):
        y = value_slice_plain(x)
        return y if out is None else out_buffer(
            out, y.shape, y.dtype, x.device).copy_(y)
    R, W = x.shape
    if W % 4:
        raise ValueError(f"value_slice: W={W} must be a multiple of 4")
    out = out_buffer(out, (R, W // 2), torch.float32, x.device)
    return _launch("value_slice", _lib().aainterp_value_slice, out,
                   x.data_ptr(), out.data_ptr(), R, W)


def unaligned_dma_kernel(x: torch.Tensor, start: int = DMA_START,
                         rows: int = DMA_ROWS, *,
                         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x[start:start + rows]``, each row cut into pieces of whole
    16-byte chunks of at most 2 KB, one block a piece: a 1-D bulk copy
    onto an mbarrier, then a bulk store (JAX's 16 rows of 14,400 bytes: 128
    blocks; W a multiple of 4)."""
    _check_dtype("unaligned_dma", x, torch.float32, 2)
    H, W = x.shape
    if not (0 <= start and 1 <= rows and start + rows <= H):
        raise ValueError(f"unaligned_dma: rows [{start}, {start + rows}) "
                         f"outside {H}")
    if not _cuda("unaligned_dma", x):
        y = unaligned_dma_plain(x, start, rows)
        return y if out is None else out_buffer(
            out, y.shape, y.dtype, x.device).copy_(y)
    if W % 4:
        raise ValueError(f"unaligned_dma: W={W} must be a multiple of 4 "
                         "(rows of whole 16-byte chunks)")
    out = out_buffer(out, (rows, W), torch.float32, x.device)
    return _launch("unaligned_dma", _lib().aainterp_unaligned_dma, out,
                   x.data_ptr(), out.data_ptr(), H, W, start, rows)


def high_dot_kernel(a: torch.Tensor, b: torch.Tensor, *,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``high_dot_plain`` on wgmma m64n32k16, one block per 64 x 32 tile of
    out, K through a four-stage ring of TMA boxes (any M; K and N multiples
    of 4, the 16-byte row strides of the tensor maps, checked on CPU
    tensors too)."""
    _check_dtype("high_dot", a, torch.float32, 2)
    _check_dtype("high_dot", b, torch.float32, 2)
    (M, K), (Kb, N) = a.shape, b.shape
    if K != Kb:
        raise ValueError(f"high_dot: a {tuple(a.shape)} @ b "
                         f"{tuple(b.shape)}")
    if K % 4 or N % 4:
        raise ValueError(f"high_dot: K={K} and N={N} must be multiples of 4 "
                         "(a tensor map's 16-byte row stride)")
    if not _cuda("high_dot", a, b):
        y = high_dot_plain(a, b)
        return y if out is None else out_buffer(
            out, y.shape, y.dtype, a.device).copy_(y)
    out = out_buffer(out, (M, N), torch.float32, a.device)
    return _launch("high_dot", _lib().aainterp_high_dot, out, a.data_ptr(),
                   b.data_ptr(), out.data_ptr(), M, N, K)


def vpu_dyn_rows_kernel(x: torch.Tensor, off: torch.Tensor, *,
                        out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x[off] + x[off + 1]``, the offsets read by the kernel (int32; an
    offset outside [0, rows - 2] gives a NaN row there): one block a row
    and 256 columns, 16-byte loads and stores where C is a multiple of 4
    and x and out are 16-byte aligned, scalar ones otherwise (any ``out``
    is taken)."""
    _check_dtype("vpu_dyn_rows", x, torch.float32, 2)
    if off.dtype != torch.int32 or off.ndim != 1 or off.numel() == 0:
        raise ValueError(f"vpu_dyn_rows: off must be a non-empty 1-D int32 "
                         f"tensor, got {off.dtype} {tuple(off.shape)}")
    if x.shape[0] < 2:
        raise ValueError(f"vpu_dyn_rows: x {tuple(x.shape)} has fewer than 2 "
                         "rows")
    if not _cuda("vpu_dyn_rows", x, off):
        y = vpu_dyn_rows_plain(x, off)
        return y if out is None else out_buffer(
            out, y.shape, y.dtype, x.device).copy_(y)
    (rows, C), R = x.shape, off.numel()
    out = out_buffer(out, (R, C), torch.float32, x.device)
    return _launch("vpu_dyn_rows", _lib().aainterp_vpu_dyn_rows, out,
                   x.data_ptr(), off.data_ptr(), out.data_ptr(), rows, C, R)


# ---- library calls: one PyTorch call computing the same function ---------

def _mm_ieee(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.mm`` in IEEE f32 (TF32 off): more exact than bf16x3, the
    nearest one call."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.mm(a, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _embedding_bag(x: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    return nnf.embedding_bag(torch.stack([off, off + 1], 1), x, mode="sum")


# one PyTorch call computing each probe's function, timed beside it; where
# the plain version is one call (strided_y_bf16, strided_load,
# unaligned_dma) it is that call
LIBRARY: Dict[str, Callable] = {
    "value_slice": lambda x: x.view(x.shape[0], x.shape[1] // 2, 2).sum(-1),
    "high_dot": _mm_ieee,
    "vpu_dyn_rows": _embedding_bag,
}

# (name, kernel, plain, the Hopper feature, the parked design it serves on
# the card)
PROBES: Tuple[Tuple[str, Callable, Callable, str, str], ...] = (
    ("strided_y_bf16", strided_y_bf16_kernel, strided_y_bf16_plain,
     "TMA 4-D tile load, a box one wide on a size-2 axis, on an mbarrier",
     "exact strided y pass: kernel 1's window fetched per parity by TMA"),
    ("strided_load", strided_load_kernel, strided_load_plain,
     "TMA 2-D tile loads, then a stride-2 read of shared memory",
     "kernel 1's x pass reading pairs of columns from a TMA-staged window"),
    ("value_slice", value_slice_kernel, value_slice_plain,
     "one 16-byte load a thread, pair sums in registers (sm_80)",
     "the xpair x pass: a compile-time tap count (kernel 1's u8 probe)"),
    ("unaligned_dma", unaligned_dma_kernel, unaligned_dma_plain,
     "1-D bulk copies of 14,400-byte rows onto one mbarrier, bulk stores",
     "a producer warp staging row windows of any width (kernels 1, 7-8)"),
    ("high_dot", high_dot_kernel, high_dot_plain,
     "wgmma m64n32k16 bf16 -> f32 on a bf16x3 split, K in a TMA ring",
     "tensor-core densex and y pass of kernel 1 at f32 precision"),
    ("vpu_dyn_rows", vpu_dyn_rows_kernel, vpu_dyn_rows_plain,
     "a block a row: its offset one uniform load, 16-byte row loads",
     "exact per-row band taps (kernel 1's y pass without a dense band)"),
)
_BY_NAME = {p[0]: p for p in PROBES}


def probe(name: str):
    """The PROBES row of ``name``."""
    if name not in _BY_NAME:
        raise ValueError(f"no probe {name!r}; the probes are {NAMES}")
    return _BY_NAME[name]


def equal(name: str, got: torch.Tensor, want: torch.Tensor) -> bool:
    """The probe's check: bit for bit (``torch.equal`` on the bits, so
    vpu_dyn_rows' NaN rows count), for high_dot |Δ| ≤ 1e-5 ·
    max|want|."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return False
    if name != "high_dot":
        return torch.equal(got.view(torch.int32), want.view(torch.int32))
    d = (got.double() - want.double()).abs().max()
    return bool(d <= HIGH_DOT_RTOL * want.double().abs().max())


def run_probe(name: str, device: Device = None) -> Tuple[str, str]:
    """(status, detail) of one probe on ``device`` (the card by default):
    "available", or "blocked" with the first line of the error; "plain" on
    the CPU."""
    dev = target(device)
    _, kernel, plain, _, _ = probe(name)
    args = inputs(name, dev)
    if dev.type == "cpu":
        plain(*args)
        return "plain", "the plain version on the CPU"
    try:
        want = plain(*args)
        got = kernel(*args, out=torch.full_like(want, float("nan")))
        torch.cuda.synchronize(dev)
        if not equal(name, got, want):
            d = float((got.double() - want.double()).abs().max())
            return "blocked", (f"differs from its plain version (max |diff| "
                               f"{d:.3e})")
        return "available", ""
    except Exception as e:  # noqa: BLE001 - any build, encode or launch error
        msg = f"{type(e).__name__}: {e}"
        return "blocked", msg.splitlines()[0][:160]


def _report(name: str, status: str, detail: str) -> None:
    _, _, _, feature, design = probe(name)
    print(f"{name:16s} {status:10s} {feature}; for: {design}")
    if detail:
        print(f"{'':16s} {'':10s} {detail}")


def run_watchlist(device: Device = None,
                  verbose: bool = True) -> Dict[str, Tuple[str, str]]:
    """Run every probe; returns {name: (status, detail)}.  Without a GPU and
    without ``device`` it raises (pass ``device="cpu"`` for the plain
    versions)."""
    dev = target(device)
    if verbose:
        kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
        print(f"# device: {kind}")
    results = {}
    for name in NAMES:
        results[name] = run_probe(name, dev)
        if verbose:
            _report(name, *results[name])
    return results


def traffic(name: str, args: tuple) -> Tuple[int, int]:
    """(bytes, operations) a probe's function needs on ``args``: each input
    byte it reads once (strided_load: all of x, its 32-byte sectors hold
    both parities; vpu_dyn_rows: the distinct rows the offsets name), each
    output written once; f32 adds and multiply-adds as 1 and 2
    operations, and for high_dot its three bf16 products on the tensor
    cores, 3 · 2·M·N·K (``TENSOR_CORE_BF16``)."""
    x = args[0]
    if name == "strided_y_bf16":
        _, R, _, C = x.shape
        rows = min(16, R)
        return rows * C * (2 + 4), 0
    if name == "strided_load":
        R, W = x.shape
        return R * W * 4 + R * (W // 2) * 4, 0
    if name == "value_slice":
        R, W = x.shape
        return R * W * 4 + R * (W // 2) * 4, R * (W // 2)
    if name == "unaligned_dma":
        return 2 * DMA_ROWS * x.shape[1] * 4, 0
    if name == "high_dot":
        a, b = args
        (M, K), N = a.shape, b.shape[1]
        nbytes = a.nbytes + (0 if b.data_ptr() == a.data_ptr() else b.nbytes)
        return nbytes + M * N * 4, 3 * 2 * M * N * K
    off = args[1].long().cpu()
    live = off[(off >= 0) & (off <= x.shape[0] - 2)]   # NaN rows read nothing
    rows = torch.unique(torch.cat([live, live + 1])).numel()
    C = x.shape[1]
    return (rows * C * 4 + args[1].nbytes + off.numel() * C * 4,
            off.numel() * C)


def floor_dims(name: str, args: tuple) -> Tuple[int, int]:
    """The two sizes a probe's launch follows on ``args`` (its wrapper's
    defaults for the rest): strided_y_bf16 (rows, C), strided_load and
    value_slice (R, W), unaligned_dma (rows, W), high_dot (M, N),
    vpu_dyn_rows (R, C)."""
    x = args[0]
    if name == "strided_y_bf16":
        return (args[3] if len(args) > 3 else 16), x.shape[3]
    if name in ("strided_load", "value_slice"):
        return tuple(x.shape)
    if name == "unaligned_dma":
        return (args[2] if len(args) > 2 else DMA_ROWS), x.shape[1]
    if name == "high_dot":
        return x.shape[0], args[1].shape[1]
    if name == "vpu_dyn_rows":
        return args[1].numel(), x.shape[1]
    raise ValueError(f"no probe {name!r}; the probes are {NAMES}")


def launch_floor(name: str, *args: torch.Tensor) -> None:
    """Launch an empty kernel as ``name``'s kernel is launched on the CUDA
    tensors ``args``: the same grid, block, dynamic shared memory and
    launch attributes.  Counted in ``FLOOR_LAUNCHES``; raises on CPU
    tensors (a plain version has no launch)."""
    dev = args[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: a launch floor needs CUDA tensors, got "
                         f"{dev}")
    a, b = floor_dims(name, args)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().aainterp_watchlist_floor(PROBE_IDS[name], a, b, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: launch floor failed: CUDA error {rc}")
    FLOOR_LAUNCHES[name] += 1


def programmatic_edges(name: str, device: Device = None,
                       n: int = 8) -> Tuple[int, int]:
    """(programmatic, all) edges of a CUDA graph that runs ``name``'s
    kernel on ``n`` seeded inputs in turn, captured as ``harness.graph_ms``
    captures (``torch.cuda.graph`` on the current stream, after a warm-up
    launch); a programmatic launch after a kernel keeps its edge
    programmatic.  Launches counted in ``LAUNCHES``."""
    dev = target(device)
    if dev.type != "cuda":
        raise ValueError("programmatic_edges needs the card")
    _, kernel, _, _, _ = probe(name)
    xs = [inputs(name, dev, seed) for seed in range(1, n + 1)]
    kernel(*xs[0])
    torch.cuda.synchronize(dev)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        outs = [kernel(*x) for x in xs]   # noqa: F841 (kept alive)
    prog, total = ctypes.c_int(0), ctypes.c_int(0)
    rc = _lib().aainterp_graph_edges(graph.raw_cuda_graph(),
                                     ctypes.byref(prog), ctypes.byref(total))
    del graph, outs
    if rc != 0:
        raise RuntimeError(f"{name}: reading the graph's edges failed: "
                           f"CUDA error {rc}")
    return prog.value, total.value


def measure(name: str, device: Device = None, n: int = 8) -> dict:
    """A probe's kernel, plain version and library call (where the plain
    version is one call, the library call is it) timed by
    ``harness.measure`` on ``n`` distinct seeded inputs (seeds 1..n, warmed
    up on seed 0), and on the card its launch floor (``launch_floor`` on
    the same inputs; ``floor_ms`` None on the CPU, where nothing
    launches); ms per call, bytes, operations, clock and device."""
    dev = target(device)
    _, kernel, plain, _, _ = probe(name)
    library = LIBRARY.get(name)
    warm = [inputs(name, dev, 0)]
    xs = [inputs(name, dev, seed) for seed in range(1, n + 1)]
    res = {"probe": name}
    for what, fn in (("kernel", kernel), ("plain", plain),
                     ("library", library)):
        if fn is None:
            res["library_ms"] = res["plain_ms"]
            continue
        t = harness.measure(fn, xs, warm)
        res[f"{what}_ms"] = t.ms
    res["floor_ms"] = (harness.measure(
        lambda *a: launch_floor(name, *a), xs, warm).ms
        if dev.type == "cuda" else None)
    res["bytes"], res["operations"] = traffic(name, xs[0])
    res.update(clock=t.clock, device=t.device)
    return res


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--probe", choices=NAMES + ("all",), default="all")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None)
    args = ap.parse_args(argv)
    names = NAMES if args.probe == "all" else (args.probe,)
    try:
        dev = target(args.device)
        results = {name: run_probe(name, dev) for name in names}
        for name in names:
            _report(name, *results[name])
        for name in names:
            if results[name][0] == "blocked":
                continue
            r = measure(name, dev)
            floor = ("" if r["floor_ms"] is None
                     else f", launch floor {r['floor_ms']:.6f} ms")
            print(f"{name}: kernel {r['kernel_ms']:.6f} ms, plain "
                  f"{r['plain_ms']:.6f} ms, library {r['library_ms']:.6f} ms"
                  f"{floor} ({r['device']})")
            if r["clock"] != "cuda_events":
                print(f"({r['device']}: on the host's clock, not a device "
                      "time)")
    except (RuntimeError, ValueError) as e:
        print(e, file=sys.stderr)
        return 2
    return 1 if any(s == "blocked" for s, _ in results.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
