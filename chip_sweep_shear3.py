#!/usr/bin/env python3
"""Tile-shape and ablation sweep of the shear-mode stage kernels on one GPU.

Times the six stages of the shear flagship (8 frames of 2048x2048 bf16 at
30 degrees, 1.0 -> 0.5; both decompositions, as ``chip_smoke.py`` phase
23 does: device ms per batch from CUDA-graph replays on distinct inputs,
best of two) for each tile shape and each build variant of
``aainterp_torch/csrc/shear3_stage.cu``, and checks each stage against its
plain version bit for bit (the ablations skip work, so their outputs are
not checked).  Variants are built from the source with nvcc into
``aainterp_torch/_build/sweep/``:

* ``cur``        the source as it is;
* ``t256``       256 threads per block instead of 128;
* ``nostage``    no window is copied (the compute reads stale shared memory);
* ``nocompute``  no output or mid cell is computed (zeros are stored).

    python3 chip_sweep_shear3.py cur,nostage,nocompute 64x64/8x256,64x64/16x128

The second argument lists y-tile/x-tile shapes as TLxTU pairs.  Prints one
line per (variant, shapes) with the per-stage times and the per-kernel sums.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys

import torch

import aainterp_torch as at
import chip_smoke as cs
from aainterp_torch import _build
from aainterp_torch import api as t_api
from aainterp_torch.ops import shear3
from aainterp_torch.utils.lru import LruDict

VARIANTS = {
    "cur": [],
    "t256": [(r"constexpr int kThreads = 128;",
              "constexpr int kThreads = 256;")],
    "nostage": [(r"if \(off < seg_bytes\) cp_async16",
                 "if (off < -(1 << 30)) cp_async16")],
    "nocompute": [
        (r"out_cells<kForm, kVec>\([^;]*;",
         "for (int q = 0; q < kVec; ++q) r[q] = 0.0f;"),
        (r"band_rows<kVec>\(bv, t, mlo \+ mi, s\.K, r\);",
         "for (int q = 0; q < kVec; ++q) r[q] = 0.0f;")],
}


def build_variant(name: str) -> ctypes.CDLL:
    """The stage library built from the source with ``name``'s edits."""
    text = _build.SHEAR3_STAGE.source.read_text()
    for pattern, repl in VARIANTS[name]:
        text, n = re.subn(pattern, repl, text)
        cs.check(n >= 1, f"variant {name}: {pattern!r} not in the source")
    out = _build.BUILD_DIR / "sweep"
    out.mkdir(parents=True, exist_ok=True)
    src, so = out / f"{name}.cu", out / f"{name}.so"
    src.write_text(text)
    subprocess.run([_build.compiler_path("nvcc"), *_build.SHEAR3_STAGE.flags,
                    "-o", str(so), str(src)], check=True)
    cdll = ctypes.CDLL(str(so))
    for sym, argtypes, restype in _build.SHEAR3_STAGE.symbols:
        fn = getattr(cdll, sym)
        fn.argtypes = list(argtypes)
        fn.restype = restype
    return cdll


def sweep(variants, shapes) -> None:
    spec = at.make_grid_spec((cs.RH, cs.RW), *cs.ROT)
    make = cs.Inputs(torch.device("cuda:0"))
    qs = [make(torch.bfloat16, (cs.F, cs.RH, cs.RW)) for _ in range(4)]
    plans = {dec: t_api._shear3_plan(spec, dec) for dec in cs.SHEAR_DECS}
    libs = {name: build_variant(name) for name in variants}
    shear3.SMEM_BUDGET = 1 << 30            # take the given shapes
    for name in variants:
        _build._LOADED[_build.SHEAR3_STAGE.name] = libs[name]
        for y_tile, x_tile in shapes:
            shear3._Y_TILES, shear3._X_TILES = (y_tile,), (x_tile,)
            shear3._STAGE_CACHE = LruDict(16, max_bytes=1 << 30)
            ms = {}
            for dec in cs.SHEAR_DECS:
                sp = shear3.stage_plan(plans[dec])
                xs = qs
                for i, st in enumerate(sp.stages):
                    kern, plain = cs.shear3_stage_fn(st)

                    def fn(x, kern=kern, sp=sp, i=i):
                        return kern(x, sp, i, out_dtype=torch.bfloat16)
                    if name in ("cur", "t256"):
                        cs.check(torch.equal(fn(xs[0]), plain(
                            xs[0], sp, i, out_dtype=torch.bfloat16)),
                            f"{name} {dec} stage {i}: not bit-equal")
                    ms[f"{dec}_s{i}_{st.axis}{st.form}"] = round(
                        min(cs.graph_ms(fn, xs, 20) for _ in range(2)), 4)
                    xs = [fn(x) for x in xs]
            sums = {a: round(sum(v for k, v in ms.items() if k[-2] == a), 4)
                    for a in "yx"}
            print(json.dumps({"variant": name, "y_tile": y_tile,
                              "x_tile": x_tile, "ms": ms,
                              "ystage_ms": sums["y"],
                              "xstage_ms": sums["x"]}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    variants = sys.argv[1].split(",") if len(sys.argv) > 1 else ["cur"]
    pairs = sys.argv[2] if len(sys.argv) > 2 else "64x64/8x256"
    shapes = [tuple(tuple(int(v) for v in p.split("x")) for p in c.split("/"))
              for c in pairs.split(",")]
    sweep(variants, shapes)
    return 0


if __name__ == "__main__":
    sys.exit(main())
