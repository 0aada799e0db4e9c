#!/usr/bin/env python3
"""Smoke run of the PyTorch port (aainterp_torch) on one NVIDIA GPU.

Drives the port's main path — batched 4K->1080p area-average resize,
8 frames of bf16 pixels with f32 accumulation, through
``aainterp_torch.area_average_interpolate`` — on the card.  It builds the
CUDA kernel from ``aainterp_torch/csrc`` with nvcc, holds every result
against the plain PyTorch version on the same inputs, checks a small
input against a dense float64 numpy reference, and times the kernel, the
plain version and a device-to-device copy (the bytes bound).

    python3 chip_smoke.py

Any failure (no GPU, no nvcc, a build or launch error, a mismatch)
raises and exits non-zero before any result is printed.  On success the
second-to-last line of stdout is the kernels' JSON summary and the last
line is ``{"ok": true, "device": {...}}``.

Tolerances, kernel against plain: f32 atol 1e-5 on [0, 1] inputs; bf16
output atol 1e-2 (one bf16 ulp on [0, 1]); uint8 output within one gray
level (summation order can flip a .5 rounding); uint8 -> f32 atol 1e-3
(values up to 255); gradients atol 1e-5.  TF32 is switched off for
matmul and cuDNN so the plain version's einsum runs in full f32.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

import aainterp_torch as at
from aainterp_torch import _build
from aainterp_torch.ops import cuda_apply

H, W, F = 2160, 3840, 8                 # the flagship: 4K -> 1080p, 8 frames
RATIO = (2.0, 1.0)                      # (src_resolution, dst_resolution)
ISO = (0.0, 0.0)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    check(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return float((a.detach().double() - b.detach().double()).abs().max())


class Inputs:
    """Seeded random frames made on the device."""

    def __init__(self, device):
        self.device = device
        self.gen = torch.Generator(device=device).manual_seed(0)

    def __call__(self, dtype, shape=(F, H, W)) -> torch.Tensor:
        x = torch.rand(shape, generator=self.gen, device=self.device)
        if dtype == torch.uint8:
            return (x * 255.0).round().to(torch.uint8)
        return x.to(dtype)


def folded_tables(op):
    """The kernel's host tables (quadrant-folded ys, yw, xs, xw)."""
    return at.separable_linear_for(op, torch.float32, "kernel").tables


def operator(shape, angle, ratio=RATIO, iso=ISO):
    return at.build_operator(at.make_grid_spec(shape, *ratio, iso, angle))


def _events_ms(run, n: int, reps: int) -> float:
    """Mean ms per call of ``run(r)`` for r in range(reps), on CUDA events,
    after a warm-up of two calls."""
    for r in range(2):
        run(r % n)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for r in range(reps):
        run(r % n)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def eager_ms(fn, inputs, reps: int) -> float:
    """ms per call as a Python caller sees it, host overhead included;
    distinct inputs (each larger than L2) so no call finds a warm cache."""
    return _events_ms(lambda i: fn(inputs[i]), len(inputs), reps)


def graph_ms(fn, inputs, reps: int) -> float:
    """Device ms per call: ``fn`` on each input captured in its own CUDA
    graph, then replayed back to back, so no host work between calls can
    show up in the number (compare ``eager_ms`` for the host's share)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):           # warm-up: plans, table uploads
        for x in inputs[:2]:
            fn(x)
    torch.cuda.current_stream().wait_stream(side)
    graphs, keep = [], []
    for x in inputs:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            keep.append(fn(x))
        graphs.append(g)
    return _events_ms(lambda i: graphs[i].replay(), len(graphs), reps)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on an NVIDIA GPU only", file=sys.stderr)
        return 1

    # ---- 1. device -------------------------------------------------------
    dev = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0].strip()
    print(f"[1 device] {kind}; count {torch.cuda.device_count()}; "
          f"torch {torch.__version__}; CUDA {torch.version.cuda}")
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("[1 device] TF32 off for matmul and cuDNN")
    make = Inputs(dev)

    # ---- 2. build ----------------------------------------------------------
    build_s = _build.timed_build()
    _build.load_library()
    print(f"[2 build] nvcc {' '.join(_build.NVCC_FLAGS)}: {build_s:.2f} s")

    # ---- 3. flagship through the public entry point ------------------------
    op0 = operator((H, W), 0.0)
    tabs0 = folded_tables(op0)
    requests = [make(torch.bfloat16) for _ in range(3)]
    torch.cuda.synchronize()
    cuda_apply.LAUNCHES = 0
    outs = [at.area_average_interpolate(x, *RATIO, ISO, 0.0).dst
            for x in requests]
    torch.cuda.synchronize()
    launches = cuda_apply.LAUNCHES
    check(launches == len(requests),
          f"main path launched the kernel {launches} times for "
          f"{len(requests)} requests")
    flag_err = 0.0
    for x, out in zip(requests, outs):
        check(out.dtype == torch.bfloat16 and tuple(out.shape) ==
              (F, H // 2, W // 2), f"flagship out {out.dtype} {out.shape}")
        check(bool(torch.isfinite(out).all()), "flagship output not finite")
        plain = cuda_apply.apply_separable_plain(x, *tabs0)
        flag_err = max(flag_err, max_err(out, plain))
    check(flag_err <= 1e-2, f"flagship bf16 err {flag_err} > 1e-2")
    print(f"[3 flagship] {F}x{H}x{W} bf16 -> {tuple(outs[0].shape)} bf16 via "
          f"area_average_interpolate: {launches} launches for "
          f"{len(requests)} requests, max |kernel - plain| {flag_err:.3e}")
    del outs

    # ---- 4. f32, u8 -> u8 (ops level), u8 -> f32 (api level) --------------
    x = make(torch.float32)
    cuda_apply.LAUNCHES = 0
    out = at.area_average_interpolate(x, *RATIO, ISO, 0.0).dst
    check(out.dtype == torch.float32 and cuda_apply.LAUNCHES == 1,
          "f32 flagship did not run the kernel in f32")
    e = max_err(out, cuda_apply.apply_separable_plain(x, *tabs0))
    check(e <= 1e-5, f"f32 flagship err {e} > 1e-5")
    print(f"[4 f32] max |kernel - plain| {e:.3e}")
    u8 = make(torch.uint8)
    out = cuda_apply.apply_separable_kernel(u8, *tabs0)
    check(out.dtype == torch.uint8, f"u8 -> {out.dtype}")
    e = max_err(out, cuda_apply.apply_separable_plain(u8, *tabs0))
    check(e <= 1.0, f"u8 -> u8 err {e} > 1 gray level")
    print(f"[4 u8->u8] ops level, max |kernel - plain| {e:.0f} gray level")
    out = at.area_average_interpolate(u8, *RATIO, ISO, 0.0).dst
    check(out.dtype == torch.float32, f"api u8 -> {out.dtype}")
    e = max_err(out, cuda_apply.apply_separable_plain(
        u8, *tabs0, out_dtype=torch.float32))
    check(e <= 1e-3, f"u8 -> f32 err {e} > 1e-3")
    print(f"[4 u8->f32] api level, max |kernel - plain| {e:.3e}")
    del x, u8, out

    # ---- 5. folded quadrants -----------------------------------------------
    x = requests[0]
    for angle in (90.0, 180.0):
        before = cuda_apply.LAUNCHES
        out = at.area_average_interpolate(x, *RATIO, ISO, angle).dst
        check(cuda_apply.LAUNCHES == before + 1, f"{angle} deg: no launch")
        ref = at.apply_operator(operator((H, W), angle), x, impl="banded")
        e = max_err(out, ref)
        check(e <= 1e-2, f"{angle} deg bf16 err {e} > 1e-2")
        print(f"[5 quadrant] {angle:.0f} deg -> {tuple(out.shape)}: "
              f"max |kernel - plain| {e:.3e}")
    del requests, x, out, ref

    # ---- 6. odd shape and a dense float64 reference ------------------------
    x = make(torch.float32, (3, 1000, 1900))
    op = operator((1000, 1900), 0.0, ratio=(150.0, 60.0))
    before = cuda_apply.LAUNCHES
    out = at.area_average_interpolate(x, 150.0, 60.0, ISO, 0.0).dst
    check(cuda_apply.LAUNCHES == before + 1, "odd shape: no launch")
    e = max_err(out, cuda_apply.apply_separable_plain(x, *folded_tables(op)))
    check(e <= 1e-5, f"odd shape err {e} > 1e-5")
    print(f"[6 odd shape] (3, 1000, 1900) 150->60 -> {tuple(out.shape)}: "
          f"max |kernel - plain| {e:.3e}")
    small = np.random.default_rng(0).uniform(0, 1, (2, 64, 96))
    op = operator((64, 96), 90.0, ratio=(150.0, 60.0), iso=(1.0, 2.0))
    wy, wx = op.dense()
    ref = wy @ np.rot90(small, -1, axes=(-2, -1)) @ wx.T
    out = at.area_average_interpolate(
        torch.tensor(small, dtype=torch.float32, device=dev), 150.0, 60.0,
        (1.0, 2.0), 90.0).dst
    e = float(np.abs(out.cpu().double().numpy() - ref).max())
    check(e <= 1e-5, f"dense reference err {e} > 1e-5")
    print(f"[6 dense ref] (2, 64, 96) at 90 deg vs float64 Wy @ rot90(A) @ "
          f"Wx^T: max err {e:.3e}")
    del x, out

    # ---- 7. gradient through SeparableLinear --------------------------------
    for angle in (0.0, 90.0):
        op = operator((512, 768), angle)
        x = make(torch.float32, (2, 512, 768))
        xk = x.clone().requires_grad_(True)
        yk = at.apply_operator(op, xk)                  # kernel route
        g = make(torch.float32, tuple(yk.shape))
        before = cuda_apply.LAUNCHES
        (gk,) = torch.autograd.grad(yk, xk, g)
        check(cuda_apply.LAUNCHES == before + 1,
              f"backward at {angle} deg did not launch the kernel")
        xp = x.clone().requires_grad_(True)
        yp = at.apply_operator(op, xp, impl="banded")   # plain, torch autograd
        (gp,) = torch.autograd.grad(yp, xp, g)
        ef, eg = max_err(yk, yp), max_err(gk, gp)
        check(ef <= 1e-5 and eg <= 1e-5,
              f"gradient at {angle} deg: forward err {ef}, grad err {eg}")
        print(f"[7 gradient] (2, 512, 768) f32 at {angle:.0f} deg: forward "
              f"err {ef:.3e}, grad err {eg:.3e}")
    del x, xk, xp, yk, yp, g, gk, gp

    # ---- 8. timing -----------------------------------------------------------
    batches = [make(torch.bfloat16) for _ in range(6)]
    dev_tabs = tuple(torch.as_tensor(t, device=dev) for t in tabs0)
    copy_dst = torch.empty_like(batches[0])
    fns = {
        "kernel": lambda b: cuda_apply.apply_separable_kernel(b, *tabs0),
        "plain": lambda b: cuda_apply.apply_separable_plain(b, *dev_tabs),
        "api": lambda b: at.apply_operator(op0, b),
        "copy": lambda b: copy_dst.copy_(b),
    }
    px = F * H * W
    frame_bytes = H * W * 2 + (H // 2) * (W // 2) * 2   # bf16 read + write
    timing = {"card": card, "shape": [F, H, W], "dtype": "bfloat16",
              "bytes_per_frame": frame_bytes}
    # device time (CUDA graphs) and eager per-call time, in turns
    for name in ("kernel", "plain", "copy", "api", "api", "copy", "plain",
                 "kernel"):
        reps = 10 if name == "plain" else 30
        for how, timer in (("device", graph_ms), ("eager", eager_ms)):
            ms = timer(fns[name], batches, reps)
            timing.setdefault(f"{name}_{how}_ms", []).append(ms)
    ms = {k: min(v) for k, v in timing.items() if k.endswith("_ms")}
    kernel_ms, plain_ms = ms["kernel_device_ms"], ms["plain_device_ms"]
    copy_bw = 2 * batches[0].nbytes / (ms["copy_device_ms"] * 1e-3)  # B/s
    bound_us = frame_bytes / copy_bw * 1e6
    for name in ("kernel", "plain", "api"):
        for how in ("device", "eager"):
            t = ms[f"{name}_{how}_ms"]
            timing[f"{name}_{how}_us_per_frame"] = t * 1e3 / F
            timing[f"{name}_{how}_gpixel_s"] = px / (t * 1e-3) / 1e9
    timing.update(
        kernel_device_gb_s=F * frame_bytes / (kernel_ms * 1e-3) / 1e9,
        copy_gb_s=copy_bw / 1e9,
        bound_us_per_frame=bound_us,
        bound_gpixel_s=H * W / (bound_us * 1e-6) / 1e9)
    print(f"[8 timing] {card}, {F}x{H}x{W} bf16, best of 2 turns; device "
          f"time (CUDA graph replay): kernel "
          f"{timing['kernel_device_us_per_frame']:.3f} us/frame = "
          f"{timing['kernel_device_gpixel_s']:.3f} Gpixel/s, plain "
          f"{timing['plain_device_us_per_frame']:.3f} us/frame = "
          f"{timing['plain_device_gpixel_s']:.3f} Gpixel/s; eager per call: "
          f"kernel {timing['kernel_eager_us_per_frame']:.3f}, api "
          f"{timing['api_eager_us_per_frame']:.3f}, plain "
          f"{timing['plain_eager_us_per_frame']:.3f} us/frame; copy "
          f"{timing['copy_gb_s']:.1f} GB/s -> bytes bound "
          f"{bound_us:.3f} us/frame = {timing['bound_gpixel_s']:.3f} Gpixel/s")
    print(json.dumps({"timing": timing}))

    print(json.dumps({"kernels": [{
        "name": "separable_apply",
        "route": "cuda",
        "source": "aainterp_torch/csrc/separable_apply.cu",
        "replaces": "aainterp/ops/pallas_apply.py:230",
        "launches": launches,
        "max_abs_err": flag_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    sys.exit(rc)
