"""The exact rotated route's decomposition at the rotated flagship: the
counterpart of ``benchmarks/rot_experiments.py``.

The route is two kernels (``ops/cuda_shear.py``): the fused shear, which
writes the sheared plane T straight from the frames, and the window
contraction with its dead-pixel skip (0 outside each dst row's span of
live columns: JAX's masked contraction).  The contraction's probe modes
(``csrc/contract.cuh`` under ``csrc/probes.cu``, each the production
kernel with one thing changed) split its time between the streams it
reads; like JAX's, the share and pipelined modes skip dead pixels and
noweight does not:

* ``noweight`` — ``out = sum_ab T window``: no weight load, no multiply
  (``_build_contract_noweight``, rot_experiments.py:130);
* ``wshare`` — the weights of dst row 0, ``w2[ab, 0, dx]``, for every row:
  no weight stream from device memory (``_build_contract_share``, :247);
* ``tshare`` — T of frame 0 in dst row 0's window, ``T[0, ry0[0]+a,
  cx0[dx]+b]``, for every row and frame: no T stream (the same);
* ``bothshare`` — both;
* ``pipelined`` — the production function and sum order with tap k+1's
  operands loaded before tap k's FMAs: bit-equal to ``contract``
  (``_build_contract_pipelined``, :392).

``contract_probe_kernel(t, plan, mode)`` launches one (a CPU tensor takes
``contract_probe_plain``), counted per mode in ``LAUNCHES``; the plain
versions are ``ops.cuda_shear.contract_plain`` with those substitutions.

``EXPS`` are the JAX file's experiments under its names: ``full`` (the
route's two kernels), ``shears`` (the fused shear, with the single forms
beside it), ``contract`` (the contraction without the skip,
``contract_unmasked_kernel``), ``contract_masked`` (the route's
contraction, ``contract_kernel``), and the five probes.
Each builds the flagship's plan (``_plan``: 2048^2 at 1.0 -> 0.5, 30
degrees about the center, exact; K 6, Ka x Kb 5 x 5), makes seeded
inputs on the device and times the kernels with ``harness.measure``.
JAX's ``--tile_y`` sized its contraction's dst row tile, which the port's
plan does not have; it is not carried.

    python -m aainterp_torch.probes.rot_experiments --exp noweight \\
        [--batch 8] [--dtype bfloat16] [--device cuda]

prints the JAX probe's line, ``{exp}: ... Gpixel/s  (... us/frame)``.
"""

from __future__ import annotations

import argparse
import functools
import sys
from typing import Optional

import numpy as np
import torch

from .. import _build
from ..grids import make_grid_spec
from ..ops import cuda_shear
from ..ops.weights import ell_operator
from ..utils.device import Device, target
from . import harness

# probe mode -> the kernel's mode code (contract.cuh's Probe)
MODES = {"noweight": 1, "tshare": 2, "wshare": 3, "bothshare": 4,
         "pipelined": 5}
# kernel launches so far per mode, counted where the wrapper launches
LAUNCHES = {m: 0 for m in MODES}


def _shares(mode: str):
    """(T shared, weights shared) of a probe mode."""
    if mode not in MODES:
        raise ValueError(f"probe mode must be one of {sorted(MODES)}, got "
                         f"{mode!r}")
    return mode in ("tshare", "bothshare"), mode in ("wshare", "bothshare")


def contract_probe_plain(t: torch.Tensor, plan: cuda_shear.ShearKernelPlan,
                         mode: str, *,
                         out_dtype: Optional[torch.dtype] = None
                         ) -> torch.Tensor:
    """The probe ``mode``'s function in plain torch, f32 sums (taps
    a-major, then b) cast to ``out_dtype`` (default: T's dtype for
    bf16/f32, else f32): ``contract_plain`` with T of frame 0 in dst row
    0's window (tshare, bothshare), the weights of dst row 0 (wshare,
    bothshare), no weights (noweight), or as it is (pipelined); every mode
    but noweight is 0 outside each dst row's span, as the route's
    contraction is."""
    share_t, share_w = _shares(mode)
    if mode == "pipelined":
        return cuda_shear.contract_plain(t, plan, out_dtype=out_dtype)
    cuda_shear._check_frames(t, (plan.TH, plan.TW), "T")
    tabs = plan.tables(t.device)
    ry0 = tabs["ry0"].to(torch.int64)
    cx0 = tabs["cx0"].to(torch.int64)
    src, ry0 = (t[:1], ry0[:1]) if share_t else (t, ry0)
    acc = torch.zeros((t.shape[0], plan.Hd, plan.Wd), dtype=torch.float32,
                      device=t.device)
    for a in range(plan.Ka):
        rows = src.index_select(1, (ry0 + a).clamp(0, plan.TH - 1))
        for b in range(plan.Kb):
            vals = rows.index_select(2, (cx0 + b).clamp(0, plan.TW - 1))
            if mode == "noweight":
                acc = acc + vals.to(torch.float32)
                continue
            w = tabs["w2"][a * plan.Kb + b]
            acc = acc + (w[:1] if share_w else w) * vals.to(torch.float32)
    if mode != "noweight":
        acc = torch.where(cuda_shear.live_mask(plan, t.device), acc, 0.0)
    return acc.to(out_dtype or cuda_shear._out_dtype(t.dtype))


def contract_probe_kernel(t: torch.Tensor, plan: cuda_shear.ShearKernelPlan,
                          mode: str, *,
                          out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The probe ``mode`` on the CUDA kernel, (F, TH, TW) -> (F, Hd, Wd)
    in T's dtype (bf16 or f32); a CPU tensor takes
    ``contract_probe_plain``.  ``out`` may be given (any contents: every
    element is written)."""
    _shares(mode)
    cuda_shear._check_frames(t, (plan.TH, plan.TW), "T")
    shape = (t.shape[0], plan.Hd, plan.Wd)
    if t.device.type == "cpu":
        y = contract_probe_plain(t, plan, mode)
        return y if out is None else cuda_shear._out_buffer(
            out, shape, y).copy_(y)
    cuda_shear._cuda_frames(t, "T")
    out = cuda_shear._out_buffer(out, shape, t)
    tabs = plan.tables(t.device)
    fn = _build.load(_build.PROBES).aainterp_contract_probe
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        rc = fn(t.data_ptr(), out.data_ptr(), tabs["ry0"].data_ptr(),
                tabs["cx0"].data_ptr(), tabs["w2"].data_ptr(),
                tabs["span"].data_ptr(), t.shape[0],
                plan.TH, plan.TW, plan.Hd, plan.Wd, plan.Ka, plan.Kb,
                MODES[mode], cuda_shear._DTYPE_CODES[t.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"contract probe {mode} launch failed: CUDA error "
                           f"{rc} (F={t.shape[0]}, TH={plan.TH}, "
                           f"TW={plan.TW}, Hd={plan.Hd}, Wd={plan.Wd})")
    LAUNCHES[mode] += 1
    return out


def _live(plan: cuda_shear.ShearKernelPlan):
    """(live dst pixels, live columns, T elements their windows read) of
    the dead-pixel skip: the pixels inside their rows' spans, the columns
    inside any span, and the T elements the windows of the live pixels
    touch."""
    span = plan.span.astype(np.int64)
    width = span[:, 1] - span[:, 0]
    rows = np.nonzero(width > 0)[0]
    cols = np.zeros(plan.Wd, bool)
    touched = np.zeros((plan.TH, plan.TW), bool)
    for dy in rows:
        lo, hi = span[dy]
        cols[lo:hi] = True
        c = np.clip(plan.cx0[lo:hi, None] + np.arange(plan.Kb), 0,
                    plan.TW - 1)
        r = np.clip(plan.ry0[dy] + np.arange(plan.Ka), 0, plan.TH - 1)
        touched[np.ix_(r, np.unique(c))] = True
    return int(width.sum()), int(cols.sum()), int(touched.sum())


def traffic(plan: cuda_shear.ShearKernelPlan, batch: int, elem: int,
            what: str) -> tuple:
    """(bytes, operations) of one batch of ``what`` (an experiment, a
    probe mode, or a shear form): each input read once and each output
    written once, as far as this plan's data needs it (a shared T is
    frame 0's Ka rows; shared weights are one dst row; the dead-pixel
    skip reads the weights of the live pixels and the T elements of their
    windows, and does their taps only); 2 operations per weighted tap, 1
    per unweighted one."""
    p = plan
    n_live, c_live, t_live = _live(p)
    taps = p.Ka * p.Kb
    t_b = batch * p.TH * p.TW * elem
    t_lb = batch * t_live * elem                 # T the live windows read
    t_rows = p.Ka * p.TW * elem                  # frame 0, Ka rows of T
    q_b = batch * p.qH * p.qW * elem
    s_b = batch * p.TH * p.qW * elem
    w_b = taps * p.Hd * p.Wd * 4
    w_lb = taps * n_live * 4                     # the live pixels' weights
    w_row = taps * c_live * 4                    # one dst row, live columns
    o_b = batch * p.Hd * p.Wd * elem
    idx = (p.Hd + p.Wd) * 4                       # ry0, cx0
    sp = p.Hd * 8                                 # span
    ops = batch * p.Hd * p.Wd * taps
    ops_l = batch * n_live * taps
    masked = (t_lb + w_lb + o_b + idx + sp, 2 * ops_l)
    return {
        "vshear": (q_b + s_b + p.qW * 4, 0),
        "hshear": (s_b + t_b + p.TH * 4, 0),
        "shears": (q_b + t_b + (p.qW + p.TH) * 4, 0),
        "contract": (t_b + w_b + o_b + idx, 2 * ops),
        "contract_masked": masked,
        "pipelined": masked,
        "noweight": (t_b + o_b + idx, ops),
        "wshare": (t_lb + w_row + o_b + idx + sp, 2 * ops_l),
        "tshare": (t_rows + w_lb + o_b + idx + sp, 2 * ops_l),
        "bothshare": (t_rows + w_row + o_b + idx + sp, 2 * ops_l),
        # T written by the fused shear, its live windows read by the
        # masked contraction
        "full": (q_b + t_b + (p.qW + p.TH) * 4 + masked[0], masked[1]),
    }[what]


def _plan(shape=(2048, 2048), angle: float = 30.0):
    """(spec, operator, kernel plan) of ``shape`` at 1.0 -> 0.5, rotated
    ``angle`` degrees about the center, exact; the plan through the disk
    cache (``kernel_plan_cached``).  The last one is kept."""
    return _plan_cached(tuple(int(n) for n in shape), float(angle))


@functools.lru_cache(maxsize=1)
def _plan_cached(shape, angle: float):
    H, W = shape
    spec = make_grid_spec((H, W), 1.0, 0.5, (W / 2, H / 2), angle)
    op = ell_operator(spec, mode="exact")
    return spec, op, cuda_shear.kernel_plan_cached(op)


def _frames(K: int, batch: int, shape, dtype, dev, seed: int = 0):
    """K + 1 distinct seeded (batch, H, W) stacks: one to warm up on, K to
    measure."""
    gen = harness.seeded(dev, seed)
    return [harness.uniform((batch,) + tuple(shape), dtype, gen, dev)
            for _ in range(K + 1)]


def _contract_inputs(kp, batch: int, dtype, dev, K: int = 4):
    """K = 4 distinct random T stacks (stand-ins for the sheared plane; 23
    MB per bf16 frame at the flagship) and one to warm up on."""
    return _frames(K, batch, (kp.TH, kp.TW), dtype, dev, seed=1)


def _result(exp: str, t: harness.Timing, batch: int, dtype, shape,
            angle: float, **extra) -> dict:
    px = batch * shape[0] * shape[1]
    return {"exp": exp, "ms_per_batch": t.ms,
            "gpixel_s": px / (t.ms * 1e-3) / 1e9,
            "us_per_frame": t.ms * 1e3 / batch, "batch": batch,
            "dtype": str(dtype).split(".")[-1], "shape": list(shape),
            "angle": angle, "clock": t.clock, "device": t.device, **extra}


def _timed(exp: str, fn, inputs_of, batch, dtype, device, shape, angle,
           **extra):
    dev = target(device)
    spec, op, kp = _plan(shape, angle)
    xs = inputs_of(kp, dev)
    t = harness.measure(lambda x: fn(x, kp), xs[1:], xs[:1])
    return _result(exp, t, batch, dtype, shape, angle, **extra)


def exp_full(batch: int = 8, dtype=torch.bfloat16, device: Device = None,
             shape=(2048, 2048), angle: float = 30.0):
    """The route's two kernels (``apply_ell_shear_kernel``) on K = 8
    distinct frame batches."""
    return _timed("full", cuda_shear.apply_ell_shear_kernel,
                  lambda kp, dev: _frames(8, batch, shape, dtype, dev),
                  batch, dtype, device, shape, angle)


def exp_shears(batch: int = 8, dtype=torch.bfloat16, device: Device = None,
               shape=(2048, 2048), angle: float = 30.0):
    """T from the frames: the fused shear (the route's), with the single
    forms beside it (``vshear_ms``: S from q; ``hshear_ms``: T from S)."""
    dev = target(device)
    spec, op, kp = _plan(shape, angle)
    qs = _frames(8, batch, shape, dtype, dev)
    ss = [cuda_shear.vshear_plain(q, kp) for q in qs]
    t = harness.measure(lambda q: cuda_shear.vhshear_kernel(q, kp), qs[1:],
                        qs[:1])
    singles = {f"{form}_ms": harness.measure(
        lambda x, form=form: getattr(cuda_shear, f"{form}_kernel")(x, kp),
        xs[1:], xs[:1]).ms
        for form, xs in (("vshear", qs), ("hshear", ss))}
    return _result("shears", t, batch, dtype, shape, angle, **singles)


def exp_contract(batch: int = 8, dtype=torch.bfloat16, device: Device = None,
                 shape=(2048, 2048), angle: float = 30.0):
    """The contraction without the dead-pixel skip
    (``contract_unmasked_kernel``, JAX's ``masked=False``) on K = 4
    random T stacks."""
    return _timed("contract", cuda_shear.contract_unmasked_kernel,
                  lambda kp, dev: _contract_inputs(kp, batch, dtype, dev),
                  batch, dtype, device, shape, angle)


def exp_contract_masked(batch: int = 8, dtype=torch.bfloat16,
                        device: Device = None, shape=(2048, 2048),
                        angle: float = 30.0):
    """The route's contraction, dead pixels skipped (``contract_kernel``,
    JAX's ``masked=True``), on K = 4 random T stacks."""
    return _timed("contract_masked", cuda_shear.contract_kernel,
                  lambda kp, dev: _contract_inputs(kp, batch, dtype, dev),
                  batch, dtype, device, shape, angle)


def _probe_exp(mode: str):
    def exp(batch: int = 8, dtype=torch.bfloat16, device: Device = None,
            shape=(2048, 2048), angle: float = 30.0):
        return _timed(mode, lambda t, kp: contract_probe_kernel(t, kp, mode),
                      lambda kp, dev: _contract_inputs(kp, batch, dtype, dev),
                      batch, dtype, device, shape, angle)
    exp.__name__ = f"exp_{mode}"
    exp.__doc__ = (f"The contraction's {mode} probe "
                   "(``contract_probe_kernel``) on K = 4 random T stacks.")
    return exp


EXPS = {"full": exp_full, "shears": exp_shears, "contract": exp_contract,
        "contract_masked": exp_contract_masked,
        **{mode: _probe_exp(mode) for mode in
           ("noweight", "pipelined", "tshare", "wshare", "bothshare")}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--exp", required=True, choices=sorted(EXPS))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    try:
        r = EXPS[args.exp](args.batch, getattr(torch, args.dtype),
                           args.device)
    except RuntimeError as e:
        print(e, file=sys.stderr)
        return 2
    print(f"{args.exp}: {r['gpixel_s']:.2f} Gpixel/s  "
          f"({r['us_per_frame']:.0f} us/frame)")
    if args.exp == "shears":
        print(f"single forms: vshear {r['vshear_ms']:.4f} ms, hshear "
              f"{r['hshear_ms']:.4f} ms per batch (fused "
              f"{r['ms_per_batch']:.4f})")
    if r["clock"] != "cuda_events":
        print(f"({r['device']}: the plain versions on the host's clock, not "
              "a device time)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
