"""The regrid's aligned route with its intermediate fused away: the
counterpart of ``benchmarks/aligned_fused_probe.py``.

The config-5 regrid (8 f32 fields of 1800 x 3600 at 0.1 degree -> 180 x
360 at 1 degree) has bands that partition the source into equal blocks of
m = 10 on both axes (``ops.apply.aligned_axis_plan``).  The aligned route
(``ops.apply.apply_separable_aligned``) sums the y taps into a (F, 180,
3600) f32 intermediate in device memory, then the x taps.
``aligned_fused_kernel`` computes the same function on
``csrc/aligned_fused.cu`` with the intermediate kept on chip, each source
pixel read once:

    out[f, h, w] = sum_b wkx[w, b] * (sum_a wky[h, a] * src[f, c0y + my*h + a, c0x + mx*w + b])

the y taps fused-multiply-added in order from a = 0, then the x taps from
b = 0; ``aligned_fused_plain`` repeats that arithmetic bit for bit
(``ops.apply.fma32``).  It returns (F, Hd, Wd) directly (JAX's kernel
wrote padded (F, nty * ntx, TYp, TX) blocks for ``_fused_finish`` to
crop).  Any aligned plan pair is taken, ``c0`` offsets applied.  A CUDA
tensor launches the kernel or raises; a CPU tensor takes the plain
version.  ``LAUNCHES`` counts the launches.  It is a probe, not a route:
``regrid``'s routes do not call it.

The experiments, under the JAX file's names (``kernel2`` is the port's
own: the route the card takes for this regrid today):

* ``prod`` — ``apply_separable_aligned``, the aligned route;
* ``einsum`` — one ``torch.einsum("fhawb,ha,wb->fhw")`` on the reshaped
  fields, TF32 off;
* ``pallas`` — ``aligned_fused_kernel``;
* ``kernel2`` — kernel 2 on the regrid's band tables, as the route
  ``apply_band_operators(impl='kernel')`` launches it
  (``csrc/separable_apply_2d.cu``);

each on 8 + 1 seeded batches of fields in [200, 300) timed with
``harness.measure``; ``check`` holds the fused function and the einsum to
the aligned route at rel 1e-5, JAX's bound.

    python -m aainterp_torch.probes.aligned_fused_probe [--exp all] \\
        [--batch 8] [--device cuda] [--check]

prints the JAX probe's line, ``{exp}: ... Gpixel/s (... us/frame)``.
"""

from __future__ import annotations

import functools
import sys
from typing import Optional

import numpy as np
import torch

from .. import _build
from ..ops.apply import aligned_axis_plan, apply_separable_aligned, fma32
from ..utils.device import Device, out_buffer, target, upload
from ..utils.digest import array_digest
from ..utils.lru import LruDict
from . import harness

H, W = 1800, 3600      # config 5: 0.1 degree
Hd, Wd = 180, 360      # -> 1 degree
# kernel launches so far, counted where the wrapper launches the kernel
LAUNCHES = 0
# csrc/aligned_fused.cu: a block's y sums (mx * TXc floats) within the
# default 48 KB of shared memory
CHUNK_BYTES = 48 * 1024

# (digest, device) -> the weights on the device
_WEIGHTS = LruDict(16, name="aligned_fused_probe.weights")


@functools.lru_cache(maxsize=2)
def geometry(src_shape=(H, W), dst_shape=(Hd, Wd)):
    """The aligned plans (y, x) of the conservative regrid ``src_shape`` ->
    ``dst_shape`` (config 5 by default), from its f32 band tables."""
    from ..regrid import LatLonGrid, conservative_regrid_operator

    by, bx = conservative_regrid_operator(LatLonGrid(*src_shape),
                                          LatLonGrid(*dst_shape))
    yp = aligned_axis_plan(np.asarray(by.start),
                           np.asarray(by.weights, np.float32), by.n_src)
    xp = aligned_axis_plan(np.asarray(bx.start),
                           np.asarray(bx.weights, np.float32), bx.n_src)
    if yp is None or xp is None:
        raise ValueError(f"the regrid {src_shape} -> {dst_shape} has no "
                         "aligned plan on both axes")
    return yp, xp


def _check(frames, y_plan, x_plan) -> None:
    if not isinstance(frames, torch.Tensor):
        raise TypeError(f"frames must be a torch.Tensor, got {type(frames)}")
    if frames.ndim != 3 or 0 in frames.shape:
        raise ValueError(f"frames must be (F, H, W) with none of them 0, got "
                         f"{tuple(frames.shape)}")
    if frames.dtype != torch.float32:
        raise TypeError(f"the fused aligned regrid takes float32 fields, got "
                        f"{frames.dtype}")
    for p, n, axis in ((y_plan, frames.shape[1], "y"),
                       (x_plan, frames.shape[2], "x")):
        m, c0, nd = int(p["m"]), int(p["c0"]), len(p["wk"])
        if m < 1 or c0 < 0 or c0 + m * nd > n:
            raise ValueError(f"the {axis} plan (m {m}, c0 {c0}, {nd} dst "
                             f"cells) does not fit {n} source cells")


def aligned_fused_plain(frames: torch.Tensor, y_plan,
                        x_plan) -> torch.Tensor:
    """(F, H, W) f32 -> (F, Hd, Wd): the kernel's function in plain torch on
    ``frames``' device, the y taps then the x taps each one fused
    multiply-add in order from 0 (bit for bit the kernel's)."""
    _check(frames, y_plan, x_plan)
    dev = frames.device
    my, cy = int(y_plan["m"]), int(y_plan["c0"])
    mx, cx = int(x_plan["m"]), int(x_plan["c0"])
    wy, wx = _weights(y_plan["wk"], dev), _weights(x_plan["wk"], dev)
    F, hd, wd = frames.shape[0], wy.shape[0], wx.shape[0]
    q = frames.narrow(1, cy, my * hd).narrow(2, cx, mx * wd)
    q = q.reshape(F, hd, my, mx * wd)
    t = torch.zeros((F, hd, mx * wd), dtype=torch.float32, device=dev)
    for a in range(my):
        t = fma32(wy[:, a, None], q[:, :, a], t)
    t = t.reshape(F, hd, wd, mx)
    out = torch.zeros((F, hd, wd), dtype=torch.float32, device=dev)
    for b in range(mx):
        out = fma32(wx[:, b], t[..., b], out)
    return out


def _weights(wk, device: torch.device) -> torch.Tensor:
    """A plan's (n_dst, m) weights as a contiguous f32 tensor on
    ``device``, uploaded once per content and device."""
    if isinstance(wk, torch.Tensor):
        return wk.to(device=device, dtype=torch.float32).contiguous()
    wk = np.asarray(wk, np.float32)
    key = (array_digest(wk), device)
    hit = _WEIGHTS.get(key)
    if hit is None:
        hit = upload(np.ascontiguousarray(wk), device)
        _WEIGHTS.put(key, hit)
    return hit


def chunk_cols(Wd_: int, mx: int) -> int:
    """Dst columns a block takes: all of them where their y sums fit
    ``CHUNK_BYTES``, else as many as fit."""
    return max(1, min(Wd_, CHUNK_BYTES // (4 * mx)))


def aligned_fused_kernel(frames: torch.Tensor, y_plan, x_plan, *,
                         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``aligned_fused_plain`` on the CUDA kernel (a CPU tensor takes the
    plain version); ``out`` may be given (any contents: every element is
    written)."""
    global LAUNCHES
    _check(frames, y_plan, x_plan)
    F, Hs, Ws = frames.shape
    my, cy = int(y_plan["m"]), int(y_plan["c0"])
    mx, cx = int(x_plan["m"]), int(x_plan["c0"])
    hd, wd = len(y_plan["wk"]), len(x_plan["wk"])
    if frames.device.type == "cpu":
        y = aligned_fused_plain(frames, y_plan, x_plan)
        return y if out is None else out_buffer(
            out, y.shape, y.dtype, frames.device).copy_(y)
    if frames.device.type != "cuda":
        raise ValueError(f"no kernel for device {frames.device}")
    if not frames.is_contiguous():
        raise ValueError("frames must be contiguous")
    txc = chunk_cols(wd, mx)
    if 4 * mx * txc > CHUNK_BYTES:
        raise ValueError(f"one dst column's {mx} x taps exceed the block's "
                         f"{CHUNK_BYTES} bytes")
    out = out_buffer(out, (F, hd, wd), torch.float32, frames.device)
    wy = _weights(y_plan["wk"], frames.device)
    wx = _weights(x_plan["wk"], frames.device)
    fn = _build.load(_build.ALIGNED_FUSED).aainterp_aligned_fused
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream(frames.device).cuda_stream
        rc = fn(frames.data_ptr(), out.data_ptr(), wy.data_ptr(),
                wx.data_ptr(), F, Hs, Ws, hd, wd, my, mx, cy, cx, txc, stream)
    if rc != 0:
        raise RuntimeError(f"aligned_fused kernel launch failed: CUDA error "
                           f"{rc} (F={F}, H={Hs}, W={Ws}, Hd={hd}, Wd={wd}, "
                           f"my={my}, mx={mx}, c0=({cy}, {cx}), TXc={txc})")
    LAUNCHES += 1
    return out


def traffic(y_plan, x_plan, shape) -> tuple:
    """(bytes, operations) of one batch of (F, H, W) f32 fields: the fields
    read once, the output written once, the weights; 2 operations per tap
    (the y taps over the columns the x taps read)."""
    F, Hs, Ws = shape
    my, mx = int(y_plan["m"]), int(x_plan["m"])
    hd, wd = len(y_plan["wk"]), len(x_plan["wk"])
    nbytes = 4 * (F * Hs * Ws + F * hd * wd + hd * my + wd * mx)
    return nbytes, 2 * F * hd * (mx * wd * my + wd * mx)


def _fields(batch: int, dev: torch.device, shape, seed: int = 0) -> list:
    gen = harness.seeded(dev, seed)
    return [harness.uniform((batch,) + tuple(shape), torch.float32, gen, dev)
            * 100.0 + 200.0 for _ in range(9)]


def _on(plans, dev):
    """The plans with their weights on ``dev`` (uploaded before timing)."""
    return tuple(dict(p, wk=_weights(p["wk"], dev)) for p in plans)


def einsum(frames: torch.Tensor, y_plan, x_plan) -> torch.Tensor:
    """JAX's einsum experiment: one double contraction on the (F, Hd, my,
    Wd, mx) view of the fields, in float32 (TF32 off)."""
    my, cy = int(y_plan["m"]), int(y_plan["c0"])
    mx, cx = int(x_plan["m"]), int(x_plan["c0"])
    wy = _weights(y_plan["wk"], frames.device)
    wx = _weights(x_plan["wk"], frames.device)
    hd, wd = wy.shape[0], wx.shape[0]
    q = frames.narrow(-2, cy, my * hd).narrow(-1, cx, mx * wd)
    q4 = q.reshape(frames.shape[0], hd, my, wd, mx)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.einsum("fhawb,ha,wb->fhw", q4, wy, wx)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _kernel2(src_shape, dst_shape):
    """Kernel 2 on the regrid's band tables (its plain version on the
    CPU), as the route 'kernel' launches it."""
    from ..regrid import LatLonGrid, band_tables, conservative_regrid_operator

    tabs = band_tables(*conservative_regrid_operator(LatLonGrid(*src_shape),
                                                     LatLonGrid(*dst_shape)))
    return lambda x: tabs.kernel(x, "auto")


def _exp(name: str):
    def exp(batch: int = 8, device: Device = None, src_shape=(H, W),
            dst_shape=(Hd, Wd)) -> dict:
        dev = target(device)
        yp, xp = _on(geometry(tuple(src_shape), tuple(dst_shape)), dev)
        fns = {"prod": lambda x: apply_separable_aligned(x, yp, xp),
               "einsum": lambda x: einsum(x, yp, xp),
               "pallas": lambda x: aligned_fused_kernel(x, yp, xp)}
        fn = fns.get(name) or _kernel2(tuple(src_shape), tuple(dst_shape))
        xs = _fields(batch, dev, src_shape)
        t = harness.measure(fn, xs[1:], xs[:1])
        nbytes, ops = traffic(yp, xp, (batch,) + tuple(src_shape))
        px = batch * src_shape[0] * src_shape[1]
        return {"exp": name, "ms_per_batch": t.ms,
                "gpixel_s": px / (t.ms * 1e-3) / 1e9,
                "us_per_frame": t.ms * 1e3 / batch, "batch": batch,
                "shape": list(src_shape), "dst": list(dst_shape),
                "bytes": nbytes, "operations": ops, "clock": t.clock,
                "device": t.device}
    exp.__name__ = f"exp_{name}"
    exp.__doc__ = f"{name} on 8 distinct batches of f32 fields."
    return exp


EXPS = {name: _exp(name) for name in ("prod", "einsum", "pallas", "kernel2")}


def check(device: Device = None, src_shape=(H, W),
          dst_shape=(Hd, Wd)) -> dict:
    """The fused function (the kernel on the card, its plain version on the
    CPU) and the einsum against the aligned route on one seeded field in
    [200, 300): max relative errors, each held below 1e-5 (JAX's
    ``check``)."""
    dev = target(device)
    yp, xp = _on(geometry(tuple(src_shape), tuple(dst_shape)), dev)
    rng = np.random.default_rng(3)
    f = torch.from_numpy(rng.uniform(200, 300, (1,) + tuple(src_shape))
                         .astype(np.float32)).to(dev)
    want = apply_separable_aligned(f, yp, xp)
    rel = {}
    for name, got in (("fused", aligned_fused_kernel(f, yp, xp)),
                      ("einsum", einsum(f, yp, xp))):
        rel[name] = float(((got - want).abs()
                           / want.abs().clamp_min(1e-6)).max())
        if not rel[name] < 1e-5:
            raise RuntimeError(f"check {name}: max rel err {rel[name]:.2e} "
                               ">= 1e-5")
    return rel


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--exp", default="all",
                    choices=sorted(EXPS) + ["all"])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args(argv)
    try:
        if args.check:
            rel = check(args.device)
            for name, e in rel.items():
                print(f"check {name}: max rel err {e:.2e}")
            return 0
        names = tuple(EXPS) if args.exp == "all" else (args.exp,)
        for name in names:
            r = EXPS[name](args.batch, args.device)
            print(f"{name}: {r['gpixel_s']:.2f} Gpixel/s "
                  f"({r['us_per_frame']:.1f} us/frame)")
            if r["clock"] != "cuda_events":
                print(f"({r['device']}: on the host's clock, not a device "
                      "time)")
    except (RuntimeError, ValueError) as e:
        print(e, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
