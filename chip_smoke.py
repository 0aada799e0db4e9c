#!/usr/bin/env python3
"""Smoke run of the PyTorch port (aainterp_torch) on one NVIDIA GPU.

Drives the port's four main paths on the card, through the public entry
points (``aainterp_torch.area_average_interpolate`` for the first three):

* the separable flagship — batched 4K->1080p area-average resize, 8 frames
  of bf16 pixels with f32 accumulation, on ``csrc/separable_apply.cu``;
* the rotated flagship — 8 frames of 2048x2048 bf16 at 30 degrees (the
  JAX package's rot30 bench geometry) -> 8x1399x1399 bf16, exact mode:
  native C++ weight-gen on the host, then the two kernels of
  ``csrc/ell_shear.cu`` that the route launches (the shear kernel's fused
  form, which writes the sheared plane T straight from the frames, and the
  window contraction); the shear kernel's single-shear forms (vertical,
  horizontal) are held and timed beside them;
* the shear flagship — the same 8x2048x2048 bf16 frames at 30 degrees in
  ``mode='shear'`` (3 conservative 1-D passes), both decompositions
  ('quality' x-y-x and 'fast' y-x-y), on the two stage kernels of
  ``csrc/shear3_stage.cu``, and the ``Shear3Linear`` gradient;
* the band-operator family — the conservative lat-lon regrid of 8 fields
  at 0.1 degree (1800x3600) to 1 degree (180x360, BASELINE config 5,
  ``bench.py:469-491``) and to 0.25 degree (720x1440), through
  ``conservative_regrid``, and the area-resize front doors
  (``area_resize``, ``area_pyramid``) on 4K frames, on the 2-D
  banded-tile kernel of ``csrc/separable_apply_2d.cu`` (every dtype on
  the card, the f32 config-5 regrid too), and its gradient, whose backward
  is the same kernel on the transposed bands;
* the rest of the exact rotated family and the reference-named front doors
  (phases 31-36), on the rotated flagship's frames: ``mode='compat'`` (the
  reference's exact mode, native weight-gen, its wider window on the same
  two rotated kernels), the ELL custom gradient (``differentiable=True``,
  quadrants 0 and 1: the kernel forward, a scatter-add backward),
  ``fused=True`` (float32 weight-gen and gather on the card, no kernel),
  ``area_rotate`` (equal resolution, 2798^2 out), the transposed apply and
  variance maps at both flagships (kernel 1; the rotated kernels), and
  ``compose_separable`` of 4K -> 1080p -> 540p on kernel 1;
* serving and tooling (phases 37-41): the reference-parity command line
  (``aainterp_torch.cli``) at the reference program's own geometry — a
  910x910 film-dose CSV, 150 -> 25.4 dpi, 1.5 degrees about (455, 455) —
  in modes 2, 1, 1 with ``--compat`` and at 0 degrees, in this process
  (launches counted) and once as ``python3 -m aainterp_torch``, with
  ``--cache-dir`` reuse; the ``resize`` (area, bicubic), ``rotate`` and
  ``regrid`` subcommands; the streaming executor (``pipeline.stream_apply``,
  pinned ring on CUDA streams) at bench.py's stream geometry, 48 distinct
  4K frames 4K -> 1080p in batches of 8, bf16 and u8 at depth 1 and 3, and
  16 rotated 2048^2 frames, with the pinned copy rates beside them;
  ``stream_apply_files`` through the multi-input command on 16 film CSVs;
  and the operator and shear-plan disk caches at the rotated flagship and
  its compat operator, build against load;
* the probe kernels of ``csrc/probes.cu`` (phases 42-44), through their
  entry points ``aainterp_torch.probes.copy_ceiling.measure`` and
  ``aainterp_torch.probes.rot_experiments.EXPS``: the row-tiled copy at
  four frame geometries (8 x 2160 x 3840 bf16, TY 120; the rotated
  flagship's 8 x 2048^2 bf16 and rgb1024's 24 x 1024^2 bf16, TY 128; the
  regrid's 8 x 1800 x 3600 f32, TY 120) beside torch's ``copy_`` into a
  destination of its own per input; the
  rotated contraction's probe modes (``csrc/contract.cuh``: noweight on
  the tiled form and the live rectangle's tile table, its first form
  noweight_direct on the direct form; tshare, wshare, bothshare and
  pipelined on the route's tiled contraction and its tile table) on
  random T stacks of 8 and 11 frames per dtype at the rotated flagship's
  30.0 degrees and at 30.2 (T's rows not 16-byte aligned); and the
  flagship's decomposition (the route, its shear forms, the contraction
  with and without its dead-pixel skip, the route's tiled kernel on the
  live rectangle and each probe; the split subtracts noweight_direct
  from the unmasked direct contraction, noweight from the tiled kernel on
  the live rectangle, each share and pipelined probe from the route's
  tiled kernel), one ``probe_timing`` JSON line;
* the route's masked contraction (phase 45: the tiled kernel against
  the unmasked instance, its direct form and its plain version, at the
  rotated flagship and for compat, its tile tables, dead shares and time
  beside the direct form's), the copy's persistent grid (phase 46)
  and kernel 1's probe modes (phase 47: ``csrc/band_probes.cu`` on
  ``csrc/band_apply.cuh``) at the 4K flagship in bf16, f32 and u8,
  through ``aainterp_torch.probes.flagship_experiments.EXPS`` and
  ``u8_experiments.EXPS``, one ``flagship_probe_timing`` JSON line;
* probe group 3 (phases 48-49): rgb1024 (bench.py's config 2, 24 planes
  of 1024^2, 150 -> 60 dpi) through
  ``aainterp_torch.probes.rgb1024_experiments.EXPS`` in bf16 and f32 —
  the copy, kernel 1's staging (``dma``), its y pass (``ypass``), its x
  pass alone (``xonly``, on the stage ring; its first form timed beside
  it), its y pass with a dense x operator
  (``fulldense``) and kernel 1 — one ``rgb1024_probe_timing`` line; and
  the fused aligned regrid (``csrc/aligned_fused.cu``) at config 5 through
  ``aainterp_torch.probes.aligned_fused_probe.EXPS`` beside the aligned
  route, the einsum and kernel 2, one ``aligned_fused_timing`` line;
* probe group 4 (phase 50): the Mosaic watchlist
  (``aainterp_torch.probes.mosaic_watchlist``), six probes on
  ``csrc/watchlist.cu`` built from the Hopper primitives of
  ``csrc/hopper.cuh`` (a 4-D and a 2-D TMA tile load spread over many
  blocks, 1-D bulk copies in and out on an mbarrier, wgmma m64n32k16, a
  16-byte pair sum and rows at dynamic offsets, the last two as
  programmatic dependent launches) at JAX's shapes, the two TMA-load
  probes at ragged shapes, vpu_dyn_rows at other widths, row counts and
  offsets (NaN rows) into NaN-filled and misaligned outputs, the
  programmatic launches after a PyTorch kernel that writes their inputs
  and their edges through graph capture, then ``run_watchlist`` and
  ``measure`` (each probe beside its launch floor: an empty kernel
  launched as it is), one ``watchlist_timing`` line;
* the row-sharded applies (phases 51-52) on ``torch.distributed`` ranks
  (``aainterp_torch.parallel``): 4 gloo ranks that share the card (NCCL
  refuses two ranks on one card; gloo stages through pinned host memory)
  at meshes (1, 4) and (2, 2), each rank running kernel 1
  (``sharded_apply_separable``: the separable flagship in bf16, u8, f32
  with the conservation flux and at 90 degrees, folded) or kernel 2
  (``conservative_regrid_sharded``: config 5, with the flux and a mask)
  on its halo-extended block; then one rank over NCCL (mesh (1, 1)),
  and, with two cards or more, NCCL over ``min(4, count)`` cards, one
  rank a card.  The kernels are built here before any rank starts; a
  rank that fails fails the run.  One ``sharded_timing`` line;
* the sharded rotated flagship (phase 53) on the same ranks:
  ``sharded_apply_ell`` on the rotated flagship's 8 x 2048^2 frames at
  the first angle up from 30.0 degrees whose dst rows and qH divide 4
  (30.2: dst 1400^2, a halo of 707 rows, 2 hops at (1, 4)), each rank
  running the fused shear and the masked contraction on its plan (the
  global shear plan's rows shifted), bf16 at (1, 4) and (2, 2), f32
  with the flux, quadrant 1 folded at 120.2 degrees, and there the
  operator's tables as explicit CUDA tensors; one NCCL rank.  The
  operators and the global shear plans are built here first and the
  ranks load them from the run's disk caches.  One
  ``sharded_rotated_timing`` line;
* the 2-D (rows x cols) sharded applies (phases 54-55) on the same ranks,
  over ``("data", "rows", "cols")`` meshes (1, 2, 2) and (1, 1, 4):
  ``sharded_apply_separable_2d`` (kernel 1 per shard) on bench.py's
  sharded2d frames, 8 x 2048 x 3840 (bench.py:659-685), in bf16, u8, f32
  with the flux and folded at 90 and 180 degrees;
  ``conservative_regrid_sharded(col_axis="cols")`` (kernel 2 per shard)
  at config 5, plain, with the flux and masked; and
  ``sharded_apply_ell_2d`` (the fused shear and the masked contraction
  per shard on ``build_sharded_kernel_plan_2d``'s rank plans) at phase
  53's angle, bf16, f32 with the flux, the fold and explicit tables;
  one NCCL rank on (1, 1, 1), and four cards at (1, 2, 2) where there
  are four.  One ``sharded_2d_timing`` line;
* the sharded gradient steps (phase 56) on the same ranks: forward then
  backward with a fixed cotangent through ``make_sharded_separable_linear``
  (the 4K flagship in bf16 at (1, 4), ``_2d`` at (1, 2, 2), and f32
  folded at 90 degrees on both; the backward is kernel 1 per shard on the
  transposed bands) and ``make_sharded_ell_linear`` (phase 53's operator
  at (1, 4), f32: the fused shear and the contraction forward, the
  scatter and ``_halo_reduce`` backward); one NCCL rank.  One
  ``sharded_grad_timing`` line.

It builds every kernel from ``aainterp_torch/csrc`` with nvcc (and the
host engine ``native/aainterp_native.cpp`` with g++), all compilers at
once; holds every kernel against its plain PyTorch version on the same
inputs; checks small inputs against dense float64 references; and times
the kernels, their plain versions, one PyTorch library call per kernel
where one computes the same function (a dense ``torch.einsum``, a
``torch.gather``) and a device-to-device copy; the separable kernels in
every input dtype (phase 8: kernel 1 at bf16, f32 and u8, the dense
einsum in bf16 and f32; phase 30: kernel 2 at f32, bf16, u8, 0.25 degree
and in its direct form, with the dense einsums of f32 and bf16, 0.25
degree and the direct form's operators beside it; phase 35: kernel 1 as
the transpose beside the einsum on the transposed operators).  Each
kernel's bound is the larger of its bytes (each input read once, each
output written once) over the H100's published 3.35 TB/s and its
operations over the published 67 TFLOP/s of float32 outside the tensor
cores.

    python3 chip_smoke.py

Any failure (no GPU, no nvcc or g++, a build or launch error, a mismatch)
raises and exits non-zero before any result is printed.  On success the
second-to-last line of stdout is the kernels' JSON summary and the last
line is ``{"ok": true, "device": {...}}``.

Tolerances, kernel against plain.  Separable: f32 atol 1e-5 on [0, 1]
inputs; bf16 output atol 1e-2 (one bf16 ulp on [0, 1]); uint8 output
within one gray level (summation order can flip a .5 rounding); uint8 ->
f32 atol 1e-3 (values up to 255); gradients atol 1e-5.  Rotated: every
shear form bit-equal (the fused one also to the two plain shears);
contraction and route f32 atol 1e-6 on [0, 1] inputs
(1e-6 * 255 for uint8 input); bf16 output within one bf16 ulp of the
plain f32 result; dense float64 reference atol 1e-6.  Shear mode: each
stage kernel equal to its plain stage bit for bit, f32 and bf16, forward
and adjoint plans (both sum the same f32 products in the same order); the
route within one bf16 ulp (u8: one gray level) of the bf16-staged plain
pipeline and within 2e-2 of the f32-staged one on [0, 1] inputs (JAX's
bf16-staging contract, tests/test_shear3.py:256-259); gradient atol 1e-5;
dense float64 reference atol 2e-5.  Band-operator family, 2-D kernel
against its plain version on fields in [250, 300]: f32 rtol 1e-6, atol
1e-3 (tests/test_pallas.py:168-169); bf16 within one bf16 ulp; uint8
within one gray level; precisions 'default' and 'bf16x3' rtol 1e-6 (the
same bf16 operands summed in the same order); the aligned route against
the kernel rtol 1e-6, atol 1e-3; the kernel route's gradient against the
banded route's rtol 1e-5, atol 1e-6; masked coverage atol 1e-6; the
spherical-area mean of the regrid within 1e-6 relative of the input's,
in float64; dense float64 reference rtol 1e-6.  The rest of the rotated
family: compat on the kernel route against its 'gather' route f32 atol
1e-6 on [0, 1] inputs and bf16 within one bf16 ulp, the native compat
areas equal to the numpy replica bit for bit, dense float64 reference
atol 1e-6; the differentiable forward equal to the kernel route bit for
bit, its gradient against native autograd of the plain gather f32 atol
1e-5 (bf16: one bf16 ulp + 1e-6; the scatter's atomics sum in no fixed
order), <A u, v> = <u, A^T v> rel 1e-5 in f32 (float64 sums); fused
within 2e-4 of the host operator's gather at the JAX package's pins
(tests/test_api.py:95-122: fewer than 1 % of pixels zero on one side
only, left out) and, at the flagships, exact mode for the pixels at least
half inside the image, fast mode (float32 replica counts flip at the
footprint's edge) for all but 0.1 % of them;
area_rotate within one bf16 ulp of 'gather' and its f32 flux of
zero-bordered frames kept to rel 1e-5; the separable transpose and
variance at bf16 atol 1e-2 of their plain versions, the rotated variance
within one bf16 ulp of 'gather'; the composed operator against the two
applies f32 atol 1e-5.  Serving and tooling: the command's CSVs equal
the in-process apply written at 6 significant digits (the same kernels
on the same f32 input), the subprocess's stdout (timings masked) and CSV
bytes equal the in-process run's, every streamed frame ``torch.equal`` to
the direct apply of its batch, every multi-input CSV byte-equal to the
single-file command's, the loaded shear plan equal to the built one field
for field and its route output bit-equal.  Probes: the copy ``torch.equal``
to its plain version into 0xFF-filled outputs at every geometry (and u8
with a ragged last tile and 1023-byte rows); noweight and noweight_direct
``torch.equal`` to their plain version (JAX's function, 0 off the live
rectangle) and to each other; the tiled share modes f32 atol 1e-6 on
[0, 1] inputs and bf16 within one bf16 ulp of their plain f32 results
(the production contraction's tolerances), into NaN-filled outputs; the tiled pipelined form ``torch.equal`` to the
production contraction; one launch per probe call, the production counts
unmoved.
The masked contraction ``torch.equal`` to the unmasked instance and to
``contract_plain(fused=True)`` on finite T into NaN-filled outputs, and
exactly 0 outside every dst row's span on NaN T.  Kernel 1's probe modes
``torch.equal`` to their plain versions (which repeat the kernels' fused
multiply-adds exactly) into 0xFF-filled outputs, the modes with
production's output also to kernel 1 (``xpair`` too: its tap order is
production's for the exact ratio-2 band of the flagship).  At
rgb1024 the probe modes stage, stagey and xonly (the stage ring) and
their first forms ``torch.equal`` to their plain versions into
NaN-filled outputs, bf16 and f32, xonly also to xonly_direct; densex, a wgmma
product on a bf16 split whose sums come in the tensor cores' order, in
f32 within 1e-5 * max|plain| of its plain version (the f32 statement)
and of kernel 1, in bf16 within one bf16 ulp, with a guard that one bf16
pass lies more than 10 x the f32 tolerance from the plain version.  The
fused aligned regrid ``torch.equal`` to its plain version into a
NaN-filled output, and against kernel 2 and the aligned route rtol 1e-6,
atol 1e-3 on fields in [250, 300]; its ``check`` and the einsum's
relative error below 1e-5 (JAX's bound).  The watchlist's kernels
``torch.equal`` to their plain versions into NaN-filled outputs, high_dot
(bf16x3 on wgmma, f32 sums on the tensor cores against the three products
summed in float64) within 1e-5 of its plain output's largest magnitude.
Sharded: the gathered output of the sharded kernel route bit-equal
(``torch.equal``) to the unsharded kernel's on the same frames, bf16, u8
and f32, and to the unsharded regrid (kernel 2), masked too (each dst row
sums the same taps in the same order; only the row indices are rebased);
the 90-degree fold within 1e-5 * max|out| of the unsharded
``apply_operator`` in f32 (the folded inner apply sums in another
orientation); |flux_dst - flux_src| <= 1e-5 * |flux_src|, and flux_src
within 1e-5 relative of a float64 sum on the host.  Sharded rotated:
bf16 and f32 bit-equal to the unsharded kernel route (each live tap
reads the same T value and the contraction sums in the same order; a
zero-weight tap reads a finite value), the fold at 120.2 degrees within
1e-5 * max|out| of it (its bit equality is printed), the explicit
tables bit-equal to the call without them; the flux pair as above, with
flux_src within 1e-9 relative of the float64 host sum.  Sharded 2-D
(phases 54-55): the same rules, each dst pixel summing the same taps in
the same order with both indices rebased.  Sharded gradients (phase 56):
the separable forward and gradient at quadrant 0 bit-equal to the
unsharded ``SeparableLinear`` step (kernel 1 on each rank's rows of the
same transposed tables), the 90-degree folds within 1e-6 x the largest
value of the unsharded ones (their bit equality printed: the unsharded
fold sums in another orientation); the rotated forward bit-equal, its
gradient (the scatter's atomics) within f32 atol 1e-5.
TF32 is switched off for
matmul and cuDNN so the plain versions' and library calls' einsums run in
full f32.  Shear plans and operators go to a disk cache in a temporary
directory of the run's own, removed at its end.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch
import torch.distributed as dist

import aainterp_torch as at
from aainterp_torch import _build
from aainterp_torch import api as t_api
from aainterp_torch import autodiff as t_autodiff
from aainterp_torch import cli as t_cli
from aainterp_torch import pipeline
from aainterp_torch import regrid as t_regrid
from aainterp_torch.utils import cache as t_cache
from aainterp_torch.utils.device import upload
from aainterp_torch.utils import io as t_io
from aainterp_torch.utils import log as t_log
from aainterp_torch.ops import apply as apply_ops
from aainterp_torch.ops import compat as compat_ops
from aainterp_torch.ops import (cuda_apply, cuda_apply_2d, cuda_shear,
                                cuda_shear3, shear3)
from aainterp_torch.ops import weights as weights_ops
from aainterp_torch.parallel import conserve as t_conserve
from aainterp_torch.parallel import mesh as t_mesh
from aainterp_torch.parallel import sharding as t_sharding
from aainterp_torch.probes import (aligned_fused_probe, band_probes,
                                   copy_ceiling, flagship_experiments,
                                   mosaic_watchlist, rgb1024_experiments,
                                   rot_experiments, u8_experiments)
from aainterp_torch.probes import harness as probe_harness

H, W, F = 2160, 3840, 8                 # the flagship: 4K -> 1080p, 8 frames
RATIO = (2.0, 1.0)                      # (src_resolution, dst_resolution)
ISO = (0.0, 0.0)
# the rotated flagship (the JAX package's rot30 bench, bench.py:359-434)
RH, RW = 2048, 2048
ROT = (1.0, 0.5, (1024.0, 1024.0), 30.0)   # resolutions, isocenter, angle
ROT_DST = (1399, 1399)
ROT_Q1 = (1.0, 0.5, (1024.0, 1024.0), 120.0)    # the same frames, quadrant 1
# area_rotate's geometry: equal resolution, 30 degrees about the center
EQ = (1.0, 1.0, (1024.0, 1024.0), 30.0)
EQ_DST = (2798, 2798)
SHEAR_KERNELS = ("vshear", "hshear", "vhshear", "contract",
                 "contract_unmasked", "contract_direct")
# the rotated route's kernels: the fused shear, then the contraction
ROUTE_KERNELS = ("vhshear", "contract")
# mode='shear' on the rotated flagship: both decompositions and their passes
SHEAR3_KERNELS = ("ystage", "xstage")
SHEAR_DECS = ("quality", "fast")
SHEAR_AXES = {"quality": ("x", "y", "x"), "fast": ("y", "x", "y")}
# the conservative regrid: BASELINE config 5 (0.1 -> 1 degree) and the
# 0.1 -> 0.25 degree regrid onto the cell-centred grid of ERA5-class data
RG_F, RG_SRC, RG_DST, RG_QDEG = 8, (1800, 3600), (180, 360), (720, 1440)
# a thumbnail of the flagship's frames: 4K -> 16 x 9 through build_operator
# and apply_operator, 242-tap bands, kernel 2's direct form
THUMB, THUMB_DST = (240.0, 1.0), (9, 16)
# the reference program's own geometry (SURVEY.md §L5, Source.cpp:1528-1534):
# a 910 x 910 film-dose image at 150 dpi -> 25.4 dpi, 1.5 degrees about
# (455, 455); the legacy command's runs and the operator mode of each
FILM = (910, 910)
FILM_ARGS = ["--src-resolution", "150", "--dst-resolution", "25.4",
             "--isocenter", "455", "455"]
LEGACY_RUNS = {
    "mode2": (["--angle", "1.5", "--mode", "2"], "fast"),
    "mode1": (["--angle", "1.5", "--mode", "1"], "exact"),
    "compat": (["--angle", "1.5", "--mode", "1", "--compat"], "compat"),
    "angle0": (["--angle", "0", "--mode", "1"], "exact"),
}
# the copy ceiling's frame geometries (phase 42), each with its frame count:
# copy_ceiling.py's default, the rotated flagship's frames,
# rgb1024_experiments.py's (batch * 3 = 24 planes), the regrid's fields
COPY_GEOMS = (("4k", 2160, 3840, 120, torch.bfloat16, 8),
              ("rot2048", 2048, 2048, 128, torch.bfloat16, 8),
              ("rgb1024", 1024, 1024, 128, torch.bfloat16, 24),
              ("regrid", 1800, 3600, 120, torch.float32, 8))
PROBE_MODES = tuple(rot_experiments.MODES)
SHARE_MODES = ("tshare", "wshare", "bothshare")
# phase 43's angles: 30.2 degrees (T's rows not 16-byte aligned: TW 3,457,
# the staging's per-cell path), then the flagship's 30.0 (TW 3,448), which
# phase 44 goes on with; and its frame counts: the flagship's 8 and 11, past
# the kernels' 8 frames a group, so the tiled probes restage their windows
PROBE_ANGLES = (30.2, ROT[3])
PROBE_FRAMES = (F, 11)
# phase 44's experiments, in rot_experiments.py's names
PROBE_EXPS = ("full", "shears", "contract", "contract_masked",
              "contract_tiled_unmasked", "noweight", "noweight_direct",
              "tshare", "wshare", "bothshare", "pipelined")
# phase 47: kernel 1's probe modes per frame dtype, through the entry
# points' experiments (flagship_experiments.py / u8_experiments.py names)
BAND_EXPS = {torch.bfloat16: (flagship_experiments, ("stage", "ypass",
                                                     "full", "full2", "full3",
                                                     "full4")),
             torch.float32: (flagship_experiments, ("stage", "ypass", "full",
                                                    "full2", "full3",
                                                    "full4")),
             torch.uint8: (u8_experiments, ("stage", "extract", "ydot",
                                            "u8words", "u8chunk2", "u8chunk4",
                                            "xpair", "full"))}
# phase 48: rgb1024_experiments.py's experiments, their probe modes (the
# checks' inputs: xonly takes the y pass's output) and JAX probes
RGB_EXPS = tuple(rgb1024_experiments.EXPS)
RGB_MODES = ("stage", "stagey", "stage_direct", "stagey_direct", "xonly",
             "xonly_direct", "densex")
RGB_REPLACES = {"stage": "benchmarks/rgb1024_experiments.py:88",
                "stagey": "benchmarks/rgb1024_experiments.py:88",
                "stage_direct": "benchmarks/rgb1024_experiments.py:88",
                "stagey_direct": "benchmarks/rgb1024_experiments.py:88",
                "xonly": "benchmarks/rgb1024_experiments.py:148",
                "xonly_direct": "benchmarks/rgb1024_experiments.py:148",
                "densex": "benchmarks/rgb1024_experiments.py:181"}
# each probe mode's JAX probe, file:line
BAND_REPLACES = {
    "stage": "benchmarks/flagship_experiments.py:73,"
             "benchmarks/u8_experiments.py:86",
    "stagey": "benchmarks/flagship_experiments.py:73,"
              "benchmarks/u8_experiments.py:86",
    "stage_direct": "benchmarks/flagship_experiments.py:73,"
                    "benchmarks/u8_experiments.py:86",
    "stagey_direct": "benchmarks/flagship_experiments.py:73,"
                     "benchmarks/u8_experiments.py:86",
    "walk2": "benchmarks/flagship_experiments.py:144",
    "walk3": "benchmarks/flagship_experiments.py:144",
    "walk4": "benchmarks/flagship_experiments.py:144",
    "u8words": "benchmarks/flagship_experiments.py:341,305",
    "u8words_direct": "benchmarks/flagship_experiments.py:341,305",
    "u8convert1": "benchmarks/u8_experiments.py:86",
    "u8convert2": "benchmarks/flagship_experiments.py:497",
    "u8convert4": "benchmarks/flagship_experiments.py:497",
    "xpair": "benchmarks/u8_experiments.py:86",
    "xpair_direct": "benchmarks/u8_experiments.py:86"}
# phase 47: a geometry whose rows are not 16-byte aligned in any dtype (an
# odd W; its 962-pixel dst rows no 16-byte multiple either), for the stage
# ring's ragged row ends
STAGE_ODD_SHAPE = (3, 540, 1923)
# phase 47: the first forms of the stage-ring probes, timed beside the
# ring (launched by no experiment), as the experiments name them; u8 also
# the first forms of u8words and xpair
DIRECT_EXPS = {"stage_direct": "stage", "stagey_direct": "ypass"}
U8_DIRECT_EXPS = {"u8words_direct": "u8words", "xpair_direct": "xpair"}
# phase 47: the modes whose function is not production's output (the
# stage cuts), held to their plain versions alone
STAGE_CUTS = ("stage", "stagey", "stage_direct", "stagey_direct")
# phase 50: vpu_dyn_rows at (rows, C, offsets) beside JAX's shape: C =
# 250 and 3 take the scalar path, 4096 16 column blocks; R = 1 and 40;
# repeated offsets and out-of-range ones (NaN rows)
DYN_CASES = ((64, 250, (5, 62, 0, 5, 31, -1, 63, 64, 17)),
             (10, 3, (8, 0, 4, 4, 9, -2)),
             (64, 4096, (62, 0, 33, 33, 7, 63, -1, 200, 12, 1, 2, 3)),
             (64, 256, (40,)),
             (64, 256, tuple((7 * i) % 70 - 3 for i in range(40))))
# phase 50: launches of each programmatic probe after a PyTorch kernel
# that writes its inputs
PDL_LAUNCHES = 50
# phase 50: each watchlist probe's pallas_call in the JAX file
WATCHLIST_LINES = {"strided_y_bf16": 67, "strided_load": 87,
                   "value_slice": 103, "unaligned_dma": 122, "high_dot": 144,
                   "vpu_dyn_rows": 171}
# bench.py's stream case (bench.py:306-357): 48 distinct 4K frames, batch 8
STREAM_N, STREAM_BATCH = 48, 8
REPO = os.path.dirname(os.path.abspath(__file__))
# NVIDIA's data sheet for the H100 SXM (dense rates, 700 W)
PEAK_BYTES_S = 3.35e12           # HBM3
PEAK_F32_FLOP_S = 67e12          # float32 outside the tensor cores
PEAK_BF16_TC_FLOP_S = 989e12     # bf16 on the tensor cores, dense


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


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |x| (8 significant bits), as f64."""
    a = x.detach().double().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def within_bf16_ulp(a: torch.Tensor, ref: torch.Tensor, what: str) -> float:
    """Check |a - ref| <= one bf16 ulp of ref everywhere; return the max
    absolute difference."""
    check(a.shape == ref.shape, f"{what}: shape {tuple(a.shape)} != "
          f"{tuple(ref.shape)}")
    d = (a.detach().double() - ref.detach().double()).abs()
    bad = int((d > bf16_ulp(ref)).sum())
    check(bad == 0, f"{what}: {bad} elements differ by more than one bf16 "
          f"ulp (max |diff| {float(d.max()):.3e})")
    return float(d.max())


def reset_launches() -> None:
    cuda_apply.LAUNCHES = 0
    cuda_apply_2d.LAUNCHES = 0
    for k in SHEAR_KERNELS:
        cuda_shear.LAUNCHES[k] = 0
    for k in SHEAR3_KERNELS:
        cuda_shear3.LAUNCHES[k] = 0
    copy_ceiling.LAUNCHES = 0
    for k in rot_experiments.LAUNCHES:
        rot_experiments.LAUNCHES[k] = 0
    for k in band_probes.LAUNCHES:
        band_probes.LAUNCHES[k] = 0
    aligned_fused_probe.LAUNCHES = 0
    for k in mosaic_watchlist.LAUNCHES:
        mosaic_watchlist.LAUNCHES[k] = 0
        mosaic_watchlist.FLOOR_LAUNCHES[k] = 0


def other_paths_idle(*counters) -> bool:
    """True if no kernel of the given LAUNCHES dicts was launched."""
    return all(v == 0 for c in counters for v in c.values())


def bound(nbytes: float, flops: float,
          peak_flop_s: float = PEAK_F32_FLOP_S, tc_flops: float = 0.0) -> dict:
    """The least time the card could take for work that moves ``nbytes``
    and does ``flops`` operations at ``peak_flop_s`` (float32 outside the
    tensor cores unless given), plus ``tc_flops`` bf16 operations on the
    tensor cores: the larger of the two times at the published peaks (the
    operations' time summed over their types), and which of them bounds
    it."""
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = flops / peak_flop_s + tc_flops / PEAK_BF16_TC_FLOP_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def table_bytes(*tables) -> int:
    return int(sum(np.asarray(t).nbytes for t in tables))


def dense_band(start, weights, n_src: int) -> np.ndarray:
    """The (n_dst, n_src) float64 matrix of a band (taps outside the
    source carry zero weight and are dropped)."""
    n_dst, k = weights.shape
    m = np.zeros((n_dst, n_src))
    for a in range(k):
        cols = np.asarray(start, np.int64) + a
        ok = (cols >= 0) & (cols < n_src)
        np.add.at(m, (np.nonzero(ok)[0], cols[ok]), weights[ok, a])
    return m


def covered(start, k: int, n: int) -> int:
    """How many of the source indices [0, n) lie in some window
    [start[i], start[i] + k) of a band: the rows (or columns) a banded
    apply must read."""
    hit = np.zeros(n, bool)
    for s in np.asarray(start, np.int64):
        hit[min(max(s, 0), n):max(min(s + k, n), 0)] = True
    return int(hit.sum())


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


def graph_ms(fn, inputs, reps: int, calls: int = 1) -> float:
    """Device ms per call: ``fn`` on each input captured ``calls`` times in
    its own CUDA graph, then replayed back to back, so no host work between
    calls can show up in the number (compare ``eager_ms`` for the host's
    share); ``calls`` > 1 for work shorter than a replay's host cost."""
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
            keep.extend(fn(x) for _ in range(calls))
        graphs.append(g)
    return _events_ms(lambda i: graphs[i].replay(), len(graphs),
                      reps) / calls

def ell_operator_for(shape, res_src, res_dst, iso, angle, mode="exact"):
    """Build a rotated operator once (host, native weight-gen) and check
    that the native engine, not the numpy fallback, built it."""
    before = dict(weights_ops.WEIGHT_GEN_ENGINES)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)   # no numpy fallback
        t0 = time.perf_counter()
        op = at.build_operator(at.make_grid_spec(shape, res_src, res_dst,
                                                 iso, angle), mode=mode)
        secs = time.perf_counter() - t0
    check(isinstance(op, at.EllOperator), f"{type(op).__name__} built")
    check(weights_ops.WEIGHT_GEN_ENGINES["native"] == before["native"] + 1
          and weights_ops.WEIGHT_GEN_ENGINES["numpy"] == before["numpy"],
          f"weight-gen did not run on the native engine: "
          f"{weights_ops.WEIGHT_GEN_ENGINES} (before {before})")
    return op, secs


def rotated_phases(make, card):
    """Phases 9-16: the rotated family.  Returns the kernels' entries of
    the JSON summary, the flagship's operator and its shear plan."""
    frames_shape = (F, RH, RW)

    # ---- 9. host: native weight-gen, shear plan ----------------------------
    op, wgen_s = ell_operator_for((RH, RW), *ROT)
    t0 = time.perf_counter()
    plan = cuda_shear.kernel_plan(op)
    plan_s = time.perf_counter() - t0
    check((op.spec.quadrant, op.spec.dst_shape, op.window,
           plan.Ka, plan.Kb) == (0, ROT_DST, 6, 5, 5),
          f"rotated flagship geometry: quadrant {op.spec.quadrant}, dst "
          f"{op.spec.dst_shape}, K {op.window}, Ka x Kb {plan.Ka}x{plan.Kb}")
    print(f"[9 rotated host] {RH}x{RW} at {ROT[3]} deg -> {op.spec.dst_shape},"
          f" K {op.window}: native weight-gen {wgen_s:.3f} s (ELL table "
          f"{op.weights.nbytes / 1e6:.1f} MB f64); shear plan {plan_s:.3f} s "
          f"(Ka x Kb {plan.Ka}x{plan.Kb}, T {plan.TH}x{plan.TW}, w2 "
          f"{plan.w2.nbytes / 1e6:.1f} MB f32)")

    # ---- 10. rotated flagship through the public entry point --------------
    requests = [make(torch.bfloat16, frames_shape) for _ in range(3)]
    torch.cuda.synchronize()
    reset_launches()
    outs = [at.area_average_interpolate(x, *ROT, operator=op).dst
            for x in requests]
    torch.cuda.synchronize()
    launches = dict(cuda_shear.LAUNCHES)
    want = {k: len(requests) if k in ROUTE_KERNELS else 0
            for k in SHEAR_KERNELS}
    check(launches == want, f"rotated main path launched {launches} for "
          f"{len(requests)} requests (want {want}: the fused shear and the "
          "contraction once per request)")
    check(cuda_apply.LAUNCHES == 0 and cuda_apply_2d.LAUNCHES == 0
          and other_paths_idle(cuda_shear3.LAUNCHES),
          "rotated path launched a kernel of another path")
    route_err = {"sheared": 0.0, "gather": 0.0}
    for x, out in zip(requests, outs):
        check(out.dtype == torch.bfloat16 and tuple(out.shape) ==
              (F,) + ROT_DST, f"rotated out {out.dtype} {tuple(out.shape)}")
        check(bool(torch.isfinite(out).all()), "rotated output not finite")
        for impl in route_err:
            ref = at.apply_operator(op, x, impl=impl)
            route_err[impl] = max(route_err[impl], within_bf16_ulp(
                out, ref, f"rotated kernel route vs {impl!r}"))
    print(f"[10 rotated flagship] {F}x{RH}x{RW} bf16 -> {tuple(outs[0].shape)}"
          f" bf16 via area_average_interpolate (operator built once): "
          f"launches {launches} for {len(requests)} requests; within one "
          f"bf16 ulp of 'sheared' (max {route_err['sheared']:.3e}) and of "
          f"'gather' (max {route_err['gather']:.3e})")
    del outs

    # ---- 11. each kernel against its plain version, flagship intermediates
    kerr = {}
    for dtype in (torch.bfloat16, torch.float32):
        q = requests[0].to(dtype)
        s_k = cuda_shear.vshear_kernel(q, plan)
        t_k = cuda_shear.hshear_kernel(s_k, plan)
        f_k = cuda_shear.vhshear_kernel(q, plan)
        o_k = cuda_shear.contract_kernel(f_k, plan)
        torch.cuda.synchronize()
        s_p = cuda_shear.vshear_plain(q, plan)
        check(torch.equal(s_k, s_p),
              f"vshear {dtype} differs from its plain version")
        check(torch.equal(t_k, cuda_shear.hshear_plain(s_k, plan)),
              f"hshear {dtype} differs from its plain version")
        check(torch.equal(f_k, cuda_shear.vhshear_plain(q, plan)),
              f"fused shear {dtype} differs from its plain version")
        check(torch.equal(f_k, cuda_shear.hshear_plain(s_p, plan)),
              f"fused shear {dtype} differs from the two plain shears")
        ref = cuda_shear.contract_plain(f_k, plan, out_dtype=torch.float32)
        if dtype == torch.bfloat16:
            e = within_bf16_ulp(o_k, ref, "contract bf16 vs plain")
            kerr.update(vshear=0.0, hshear=0.0, vhshear=0.0, contract=e)
        else:
            e = max_err(o_k, ref)
            check(e <= 1e-6, f"contract f32 err {e} > 1e-6")
        print(f"[11 kernels] {dtype}: vshear, hshear and the fused shear "
              f"bit-equal to plain (the fused one also to the two plain "
              f"shears); contract max |kernel - plain| {e:.3e}")
        # every shear form overwrites every element of a NaN-filled plane
        for name, src, want in (("vshear", q, s_k), ("hshear", s_k, t_k),
                                ("vhshear", q, f_k)):
            buf = torch.full(want.shape, float("nan"), dtype=dtype,
                             device=q.device)
            getattr(cuda_shear, f"{name}_kernel")(src, plan, out=buf)
            torch.cuda.synchronize()
            check(torch.equal(buf, want),
                  f"{name} into a NaN plane left unwritten elements")
        del q, s_k, s_p, t_k, f_k, o_k, ref, buf
    print("[11 kernels] every shear form writes every element of a "
          "NaN-filled plane")

    # ---- 12. f32 and u8 -> f32 at the flagship shape ------------------------
    for dtype, atol in ((torch.float32, 1e-6), (torch.uint8, 1e-6 * 255)):
        x = make(dtype, frames_shape)
        before = dict(cuda_shear.LAUNCHES)
        out = at.area_average_interpolate(x, *ROT, operator=op).dst
        check(out.dtype == torch.float32, f"{dtype} -> {out.dtype}")
        check(all(cuda_shear.LAUNCHES[k] == before[k] + (k in ROUTE_KERNELS)
                  for k in SHEAR_KERNELS), f"{dtype}: kernels not launched")
        e = max_err(out, at.apply_operator(op, x, impl="gather"))
        check(e <= atol, f"rotated {dtype} err {e} > {atol}")
        print(f"[12 {str(dtype).split('.')[-1]}] -> f32, max |kernel - "
              f"gather| {e:.3e}")
        del x, out

    # ---- 13. quadrant 1: 1024x768 at 120 deg ---------------------------------
    qop, _ = ell_operator_for((1024, 768), 1.0, 0.5, (384.0, 512.0), 120.0)
    folded = weights_ops.fold_quadrant_ell_cached(qop)[0]
    qplan = cuda_shear.kernel_plan(folded)
    check((qop.spec.quadrant, qop.spec.dst_shape, qplan.Ka, qplan.Kb) ==
          (1, (589, 635), 5, 5), f"quadrant geometry {qop.spec.quadrant} "
          f"{qop.spec.dst_shape} {qplan.Ka}x{qplan.Kb}")
    x = make(torch.float32, (4, 1024, 768))
    before = dict(cuda_shear.LAUNCHES)
    out = at.area_average_interpolate(x, 1.0, 0.5, (384.0, 512.0), 120.0,
                                      operator=qop).dst
    check(cuda_shear.LAUNCHES["contract"] == before["contract"] + 1,
          "quadrant: no launch")
    e = max(max_err(out, at.apply_operator(qop, x, impl=impl))
            for impl in ("gather", "sheared"))
    check(e <= 1e-6, f"quadrant err {e} > 1e-6")
    print(f"[13 quadrant] (4, 1024, 768) f32 at 120 deg -> {tuple(out.shape)}"
          f" (quadrant 1 folded, Ka x Kb {qplan.Ka}x{qplan.Kb}): max |kernel"
          f" - plain| {e:.3e}")

    # ---- 14. the film geometry, fast mode (README example) -----------------
    fop, _ = ell_operator_for((910, 910), 150.0, 25.4, (455.0, 455.0), 1.5,
                              mode="fast")
    fplan = cuda_shear.kernel_plan(fop)
    check((fop.spec.dst_shape, fop.window, fplan.Ka, fplan.Kb) ==
          ((158, 158), 12, 7, 7), f"film geometry {fop.spec.dst_shape} K "
          f"{fop.window} {fplan.Ka}x{fplan.Kb}")
    x = make(torch.float32, (2, 910, 910))
    out = at.area_average_interpolate(x, 150.0, 25.4, (455.0, 455.0), 1.5,
                                      mode="fast", operator=fop).dst
    e = max(max_err(out, at.apply_operator(fop, x, impl=impl))
            for impl in ("gather", "sheared"))
    check(e <= 1e-6, f"film fast err {e} > 1e-6")
    print(f"[14 film fast] (2, 910, 910) f32, 150 -> 25.4 at 1.5 deg, fast "
          f"-> {tuple(out.shape)} (K 12, Ka x Kb {fplan.Ka}x{fplan.Kb}): max "
          f"|kernel - plain| {e:.3e}")

    # ---- 15. a dense float64 reference ------------------------------------
    small = np.random.default_rng(0).uniform(0, 1, (2, 48, 64))
    dop, _ = ell_operator_for((48, 64), 1.0, 0.5, (32.0, 24.0), 30.0)
    ref = (dop.dense() @ small.reshape(2, -1).T).T.reshape(
        (2,) + dop.spec.dst_shape)
    out = at.area_average_interpolate(
        torch.tensor(small, dtype=torch.float32, device="cuda:0"), 1.0, 0.5,
        (32.0, 24.0), 30.0, operator=dop).dst
    e = float(np.abs(out.cpu().double().numpy() - ref).max())
    check(e <= 1e-6, f"rotated dense reference err {e} > 1e-6")
    print(f"[15 dense ref] (2, 48, 64) at 30 deg vs float64 "
          f"EllOperator.dense(): max err {e:.3e}")
    del x, out

    # ---- 16. timing -------------------------------------------------------
    timing = rotated_timing(make, card, op, plan)
    return op, plan, [{
        "name": name,
        "route": "cuda",
        "source": "aainterp_torch/csrc/ell_shear.cu",
        "replaces": f"aainterp/ops/pallas_shear.py:{line}",
        "launches": launches[name],
        "max_abs_err": kerr[name],
        "ms": timing[f"{name}_kernel_device_ms"],
        "plain_ms": timing[f"{name}_plain_device_ms"],
        **timing["bounds"][name],
        # contraction: no single PyTorch call computes a K x K window
        # contraction with per-pixel weights
        "library_ms": timing.get(f"{name}_library_device_ms"),
    } for name, line in (("vshear", "59"), ("hshear", "114"),
                         ("vhshear", "59,114"), ("contract", "164"))]


def rotated_timing(make, card, op, plan) -> dict:
    """Device (CUDA-graph replay) and eager time of each rotated kernel
    (the three shear forms and the contraction), its plain version, its
    library call, and the three routes, at the rotated flagship; the
    route's bytes per batch against the measured copy bandwidth."""
    n = 4                                    # distinct batches, 67 MB each
    qs = [make(torch.bfloat16, (F, RH, RW)) for _ in range(n)]
    ss = [cuda_shear.vshear_kernel(q, plan) for q in qs]
    ts = [cuda_shear.vhshear_kernel(q, plan) for q in qs]
    copy_dst = torch.empty_like(qs[0])
    # the library calls: one torch.gather each with the clamped index
    # precomputed (the zero fill outside the source is left out, so each
    # is a lower bound of a library route); the fused shear's gathers the
    # flattened frames at r * qW + c
    dev = qs[0].device
    tab = plan.tables(dev)
    rows = (torch.arange(plan.TH, device=dev)[:, None]
            - tab["gy"][None, :].to(torch.int64)).clamp(0, plan.qH - 1)
    cols = (torch.arange(plan.TW, device=dev)[None, :]
            - tab["hx"][:, None].to(torch.int64))                # (TH, TW)
    fcols = cols.clamp(0, plan.qW - 1)
    frows = (torch.arange(plan.TH, device=dev)[:, None]
             - tab["gy"].to(torch.int64)[fcols]).clamp(0, plan.qH - 1)
    flat = (frows * plan.qW + fcols).reshape(1, -1).expand(F, -1)
    rows = rows.expand(F, -1, -1)
    cols = cols.clamp(0, plan.qW - 1).expand(F, -1, -1)
    fns = {
        "vshear_library": (lambda q: torch.gather(q, 1, rows), qs),
        "hshear_library": (lambda s: torch.gather(s, 2, cols), ss),
        "vhshear_library": (lambda q: torch.gather(
            q.reshape(F, -1), 1, flat), qs),
        "vshear_kernel": (lambda q: cuda_shear.vshear_kernel(q, plan), qs),
        "vshear_plain": (lambda q: cuda_shear.vshear_plain(q, plan), qs),
        "hshear_kernel": (lambda s: cuda_shear.hshear_kernel(s, plan), ss),
        "hshear_plain": (lambda s: cuda_shear.hshear_plain(s, plan), ss),
        "vhshear_kernel": (lambda q: cuda_shear.vhshear_kernel(q, plan), qs),
        "vhshear_plain": (lambda q: cuda_shear.vhshear_plain(q, plan), qs),
        "contract_kernel": (lambda t: cuda_shear.contract_kernel(t, plan), ts),
        "contract_plain": (lambda t: cuda_shear.contract_plain(t, plan), ts),
        "route_kernel": (lambda q: at.apply_operator(op, q), qs),
        "route_sheared": (lambda q: at.apply_operator(op, q, impl="sheared"),
                          qs),
        "route_gather": (lambda q: at.apply_operator(op, q, impl="gather"),
                         qs),
        "copy": (lambda q: copy_dst.copy_(q), qs),
    }
    timing = {"card": card, "shape": [F, RH, RW], "dtype": "bfloat16",
              "angle": ROT[3], "dst": list(ROT_DST)}
    order = list(fns) + list(reversed(fns))          # two turns, mirrored
    for name in order:
        fn, inputs = fns[name]
        reps = 20 if name.endswith(("kernel", "copy")) else 5
        for how, timer in (("device", graph_ms), ("eager", eager_ms)):
            ms = timer(fn, inputs, reps)
            timing.setdefault(f"{name}_{how}_ms", []).append(ms)
    for key in [k for k in timing if k.endswith("_ms")]:
        timing[key] = min(timing[key])
    e = 2                                             # bf16 bytes
    q_b = F * RH * RW * e
    s_b = F * plan.TH * plan.qW * e
    t_b = F * plan.TH * plan.TW * e
    w_b = plan.w2.nbytes
    o_b = F * plan.Hd * plan.Wd * e
    route_bytes = q_b + 2 * t_b + w_b + o_b   # S never leaves the chip
    fused_bytes = q_b + w_b + o_b        # a route with T kept on chip too
    copy_bw = 2 * q_b / (timing["copy_device_ms"] * 1e-3)        # B/s
    px = F * RH * RW
    for name in ("route_kernel", "route_sheared", "route_gather"):
        for how in ("device", "eager"):
            timing[f"{name}_{how}_gpixel_s"] = (
                px / (timing[f"{name}_{how}_ms"] * 1e-3) / 1e9)
    tiles = {form: plan.form_tiles(form) for form in cuda_shear.FORMS}
    timing["bounds"] = {
        "vshear": bound(q_b + s_b + table_bytes(
            plan.gy, tiles["vshear"].win), 0),
        "hshear": bound(s_b + t_b + table_bytes(
            plan.hx, tiles["hshear"].win), 0),
        "vhshear": bound(q_b + t_b + table_bytes(
            plan.gy, plan.hx, tiles["vhshear"].win), 0),
        # the dead-pixel skip: the live pixels' weights and windows
        "contract": bound(*rot_experiments.traffic(plan, F, e,
                                                   "contract_masked")),
    }
    timing.update(
        bytes_per_batch={"q": q_b, "S_single_shears": s_b,
                         "T_write_read": 2 * t_b, "w2": w_b, "out": o_b,
                         "route": route_bytes, "fused_floor": fused_bytes},
        tiles={form: {"TY": t.TY, "TX": t.TX, "rows": t.rows,
                      "cols": t.cols,
                      "empty": float((t.win[:, 1] <= t.win[:, 0]).mean())}
               for form, t in tiles.items()},
        copy_gb_s=copy_bw / 1e9,
        route_bound_ms=route_bytes / copy_bw * 1e3,
        route_bound_gpixel_s=px / (route_bytes / copy_bw) / 1e9,
        fused_bound_ms=fused_bytes / copy_bw * 1e3,
        route_kernel_device_gb_s=(route_bytes / (
            timing["route_kernel_device_ms"] * 1e-3) / 1e9))
    t = timing
    print(f"[16 rotated timing] {card}, {F}x{RH}x{RW} bf16 at 30 deg, best of"
          f" 2 turns, device ms per batch (CUDA graph replay) kernel / plain:"
          f" vshear {t['vshear_kernel_device_ms']:.4f} / "
          f"{t['vshear_plain_device_ms']:.4f}, hshear "
          f"{t['hshear_kernel_device_ms']:.4f} / "
          f"{t['hshear_plain_device_ms']:.4f}, fused shear "
          f"{t['vhshear_kernel_device_ms']:.4f} / "
          f"{t['vhshear_plain_device_ms']:.4f} (bound "
          f"{t['bounds']['vhshear']['bound_ms']:.4f}), contract "
          f"{t['contract_kernel_device_ms']:.4f} / "
          f"{t['contract_plain_device_ms']:.4f}; library gathers: vshear "
          f"{t['vshear_library_device_ms']:.4f}, hshear "
          f"{t['hshear_library_device_ms']:.4f}, fused "
          f"{t['vhshear_library_device_ms']:.4f}; route kernel "
          f"{t['route_kernel_device_ms']:.4f} ms = "
          f"{t['route_kernel_device_gpixel_s']:.3f} Gpixel/s (eager "
          f"{t['route_kernel_eager_ms']:.4f} ms), sheared "
          f"{t['route_sheared_device_ms']:.4f}, gather "
          f"{t['route_gather_device_ms']:.4f}; route moves "
          f"{route_bytes / 1e6:.1f} MB/batch, copy {t['copy_gb_s']:.1f} GB/s "
          f"-> bound {t['route_bound_ms']:.4f} ms = "
          f"{t['route_bound_gpixel_s']:.3f} Gpixel/s (T kept on chip too: "
          f"{fused_bytes / 1e6:.1f} MB -> {t['fused_bound_ms']:.4f} ms)")
    print(json.dumps({"rotated_timing": timing}))
    return timing


def shear3_stage_fn(st):
    """(kernel wrapper, plain version) of a stage's axis."""
    name = f"{st.axis}stage"
    return getattr(cuda_shear3, f"{name}_kernel"), getattr(shear3,
                                                           f"{name}_plain")


def pass_shapes(sp) -> str:
    forms = {shear3.TRANSLATE: "translate", shear3.PRE_BAND: "pre-band",
             shear3.POST_BAND: "post-band"}
    return "; ".join(
        f"{st.axis} {forms[st.form]}{f' K {st.K}' if st.K else ''} n_t "
        f"{st.n_t} crop {st.crop}: {st.in_shape[0]}x{st.in_shape[1]} -> "
        f"{st.out_shape[0]}x{st.out_shape[1]}" for st in sp.stages)


def shear3_phases(make, card):
    """Phases 17-23: mode='shear', both decompositions.  Returns the two
    stage kernels' entries of the JSON summary."""
    frames_shape = (F, RH, RW)
    spec = at.make_grid_spec((RH, RW), *ROT)
    check((spec.quadrant, spec.scale, spec.dst_side, spec.dst_shape) ==
          (0, 1, 2.0, ROT_DST), f"shear flagship geometry {spec}")

    # ---- 17. host: both plans --------------------------------------------
    plans, sps = {}, {}
    for dec in SHEAR_DECS:
        t0 = time.perf_counter()
        plans[dec] = t_api._shear3_plan(spec, dec)       # the route's cache
        plan_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        sps[dec] = shear3.stage_plan(plans[dec])
        sps[dec].tables(torch.device("cuda:0"))
        torch.cuda.synchronize()
        stage_s = time.perf_counter() - t0
        check(tuple(st.axis for st in sps[dec].stages) == SHEAR_AXES[dec],
              f"{dec}: passes {[st.axis for st in sps[dec].stages]}")
        print(f"[17 shear host] {RH}x{RW} at {ROT[3]} deg -> {ROT_DST}, "
              f"{dec}: build_shear3_plan {plan_s:.3f} s, stage plan + "
              f"upload {stage_s:.3f} s; {pass_shapes(sps[dec])}")

    # ---- 18. the shear flagship through the public entry point -----------
    requests = [make(torch.bfloat16, frames_shape) for _ in range(3)]
    launches = {k: 0 for k in SHEAR3_KERNELS}
    route_err = {"bf16_plain": 0.0, "f32_plain": 0.0}
    for dec in SHEAR_DECS:
        torch.cuda.synchronize()
        reset_launches()
        outs = [at.area_average_interpolate(x, *ROT, mode="shear",
                                            shear_decomposition=dec).dst
                for x in requests]
        torch.cuda.synchronize()
        got = dict(cuda_shear3.LAUNCHES)
        want = {f"{a}stage": len(requests) * SHEAR_AXES[dec].count(a)
                for a in "yx"}
        check(got == want, f"shear {dec} launched {got} for "
              f"{len(requests)} requests (want {want})")
        check(cuda_apply.LAUNCHES == 0 and cuda_apply_2d.LAUNCHES == 0
              and other_paths_idle(cuda_shear.LAUNCHES),
              "the shear path launched a kernel of another path")
        for k in SHEAR3_KERNELS:
            launches[k] += got[k]
        for x, out in zip(requests, outs):
            check(out.dtype == torch.bfloat16 and tuple(out.shape) ==
                  (F,) + ROT_DST, f"shear out {out.dtype} {tuple(out.shape)}")
            check(bool(torch.isfinite(out).all()), "shear output not finite")
            ref = shear3.apply_shear3_plain(x, plans[dec],
                                            mid_dtype=torch.bfloat16)
            route_err["bf16_plain"] = max(route_err["bf16_plain"],
                                          within_bf16_ulp(
                out, ref, f"shear {dec} route vs bf16-staged plain"))
            e = max_err(out, shear3.apply_shear3_plain(x, plans[dec]))
            check(e <= 2e-2, f"shear {dec} vs f32-staged plain: {e} > 2e-2")
            route_err["f32_plain"] = max(route_err["f32_plain"], e)
        print(f"[18 shear flagship] {dec}: {F}x{RH}x{RW} bf16 -> "
              f"{tuple(outs[0].shape)} bf16 via area_average_interpolate("
              f"mode='shear'): launches {got} for {len(requests)} requests; "
              f"max |route - bf16-staged plain| {route_err['bf16_plain']:.3e}"
              f" (one ulp allowed), |route - f32-staged plain| "
              f"{route_err['f32_plain']:.3e} (2e-2 allowed)")
        del outs

    # ---- 19. each stage kernel against its plain stage, bit for bit -------
    # quality: x translate, y post-band, x post-band; fast: y pre-band,
    # x pre-band, y translate + crop; their adjoints swap pre- and
    # post-bands -- every form along both axes
    kerr = {k: 0.0 for k in SHEAR3_KERNELS}
    n_stages = 0
    for dec in SHEAR_DECS:
        adjoint = shear3.stage_plan(
            cuda_shear3.make_shear3_linear(plans[dec]).plan_T)
        for name, sp, x0 in ((dec, sps[dec], requests[0]),
                             (f"{dec} adjoint", adjoint,
                              make(torch.float32, (F,) + adjoint.src_shape))):
            for dtype in (torch.float32, torch.bfloat16):
                x = x0.to(dtype)
                for i, st in enumerate(sp.stages):
                    kern, plain = shear3_stage_fn(st)
                    out = torch.full((F,) + st.out_shape, float("nan"),
                                     dtype=dtype, device=x.device)
                    got = kern(x, sp, i, out_dtype=dtype, out=out)
                    want = plain(x, sp, i, out_dtype=dtype)
                    torch.cuda.synchronize()
                    what = (f"{name} stage {i} ({st.axis}, form {st.form}) "
                            f"{dtype}")
                    check(got is out and bool(torch.isfinite(out).all()),
                          f"{what} left elements of a NaN output")
                    e = max_err(got, want)
                    check(torch.equal(got, want),
                          f"{what}: not bit-equal to its plain stage (max "
                          f"|diff| {e:.3e})")
                    kerr[f"{st.axis}stage"] = max(kerr[f"{st.axis}stage"], e)
                    n_stages += 1
                    x = got
                del x, out, got, want
    print(f"[19 shear stages] {n_stages} stage runs (every stage of both "
          f"plans and their adjoint plans, f32 and bf16) into NaN-filled "
          f"outputs: all written and bit-equal to the plain stages (max "
          f"|kernel - plain| ystage {kerr['ystage']:.3e} xstage "
          f"{kerr['xstage']:.3e})")

    # ---- 20. f32 and u8 input, quadrant 1, equal resolution ---------------
    for dtype, atol in ((torch.float32, 1e-6), (torch.uint8, 1.0)):
        x = make(dtype, frames_shape)
        before = dict(cuda_shear3.LAUNCHES)
        out = at.area_average_interpolate(x, *ROT, mode="shear").dst
        check(out.dtype == dtype, f"shear {dtype} -> {out.dtype}")
        check(sum(cuda_shear3.LAUNCHES[k] - before[k] for k in before) == 3,
              f"shear {dtype}: not 3 launches")
        e = max_err(out, shear3.apply_shear3_plain(
            x, plans["quality"], mid_dtype=torch.bfloat16))
        check(e <= atol, f"shear {dtype} err {e} > {atol}")
        print(f"[20 shear {str(dtype).split('.')[-1]}] -> "
              f"{str(out.dtype).split('.')[-1]}, max |kernel - plain| {e:.3e}"
              f" ({atol:g} allowed)")
        del x, out
    for shape, args, dtype in (
            ((4, 1024, 768), (1.0, 0.5, (384.0, 512.0), 120.0),
             torch.float32),
            ((2, 1024, 1024), (1.0, 1.0, (512.0, 512.0), 30.0),
             torch.bfloat16)):
        x = make(dtype, shape)
        qspec = at.make_grid_spec(shape[1:], *args)
        for dec in SHEAR_DECS:
            before = dict(cuda_shear3.LAUNCHES)
            out = at.area_average_interpolate(x, *args, mode="shear",
                                              shear_decomposition=dec).dst
            check(sum(cuda_shear3.LAUNCHES[k] - before[k]
                      for k in before) == 3, f"{args}: not 3 launches")
            plan = t_api._shear3_plan(qspec, dec)
            ref = shear3.apply_shear3_plain(
                apply_ops.quadrant_rotate(x, qspec.quadrant), plan,
                mid_dtype=torch.bfloat16)
            if dtype == torch.float32:
                e = max_err(out, ref)
                check(e <= 1e-6, f"{args} {dec}: err {e} > 1e-6")
            else:
                e = within_bf16_ulp(out, ref, f"{args} {dec}")
            crops = [st.crop for st in shear3.stage_plan(plan).stages]
            print(f"[20 shear geometry] {shape} {str(dtype).split('.')[-1]} "
                  f"{args[0]} -> {args[1]} at {args[3]} deg (quadrant "
                  f"{qspec.quadrant}, scale {qspec.scale}, L "
                  f"{qspec.dst_side:g}), {dec}: -> {tuple(out.shape)}, crops "
                  f"{crops}, max |kernel - plain| {e:.3e}")
        del x, out

    # ---- 21. gradient: Shear3Linear on one full-width f32 frame ----------
    x = make(torch.float32, (1, RH, RW))
    xk = x.clone().requires_grad_(True)
    yk = at.area_average_interpolate(xk, *ROT, mode="shear",
                                     differentiable=True).dst
    g = make(torch.float32, tuple(yk.shape))
    before = dict(cuda_shear3.LAUNCHES)
    (gk,) = torch.autograd.grad(yk, xk, g)
    torch.cuda.synchronize()
    check(sum(cuda_shear3.LAUNCHES[k] - before[k] for k in before) == 3,
          "Shear3Linear backward did not launch the stage kernels 3 times")
    xp = x.clone().requires_grad_(True)
    yp = at.area_average_interpolate(xp, *ROT, mode="shear",
                                     method="plain").dst
    (gp,) = torch.autograd.grad(yp, xp, g)
    # both gradients against the float64 adjoint P^T(inv_cov * g).  Torch
    # autograd of the plain pipeline scatter-adds with atomics, in no fixed
    # order, through intermediates that boundary slivers (inv_cov up to
    # 1e6) make large: it strays further from float64 than the adjoint
    # plan does, so the kernel is held to float64 at 1e-5 and to autograd
    # at 5e-5 of the gradient's scale
    plan = plans["quality"]
    g64 = g[0].double().cpu().numpy() * plan.inv_cov
    ref = torch.from_numpy(shear3.apply_shear3_np(
        shear3.transpose_shear3_plan(plan), g64, normalize=False))[None]
    ef, eg = max_err(yk, yp), max_err(gk, gp)
    ek, ep = max_err(gk.cpu(), ref), max_err(gp.cpu(), ref)
    scale = max(1.0, float(ref.abs().max()))
    check(ef <= 1e-6 and ek <= 1e-5 * scale and eg <= 5e-5 * scale,
          f"shear gradient: forward err {ef}, grad err vs float64 {ek}, vs "
          f"autograd {eg} (scale {scale})")
    print(f"[21 shear gradient] (1, {RH}, {RW}) f32, Shear3Linear (3 launches "
          f"forward, 3 backward on the adjoint plan): forward err vs plain "
          f"{ef:.3e}; grad err vs torch autograd of the plain f32 pipeline "
          f"{eg:.3e}; vs the float64 adjoint: kernel {ek:.3e}, autograd "
          f"{ep:.3e} (max |grad| {scale:.3e})")
    del x, xk, xp, yk, yp, g, gk, gp

    # ---- 22. a dense float64 reference -----------------------------------
    small = np.random.default_rng(0).uniform(0, 1, (2, 48, 64))
    sspec = at.make_grid_spec((48, 64), 1.0, 0.5, (32.0, 24.0), 30.0)
    for dec in SHEAR_DECS:
        ref = shear3.apply_shear3_np(t_api._shear3_plan(sspec, dec), small)
        out = at.area_average_interpolate(
            torch.tensor(small, dtype=torch.float32, device="cuda:0"), 1.0,
            0.5, (32.0, 24.0), 30.0, mode="shear",
            shear_decomposition=dec).dst
        e = float(np.abs(out.cpu().double().numpy() - ref).max())
        check(e <= 2e-5, f"shear {dec} dense reference err {e} > 2e-5")
        print(f"[22 shear dense ref] (2, 48, 64) at 30 deg, {dec}, vs float64 "
              f"apply_shear3_np: max err {e:.3e}")

    # ---- 23. timing -------------------------------------------------------
    timing = shear3_timing(make, card, plans, sps)
    entries = []
    for name, line in (("ystage", 230), ("xstage", 342)):
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "aainterp_torch/csrc/shear3_stage.cu",
            "replaces": f"aainterp/ops/pallas_shear3.py:{line}",
            "launches": launches[name],
            "max_abs_err": kerr[name],
            "ms": timing[f"{name}_kernel_device_ms"],
            "plain_ms": timing[f"{name}_plain_device_ms"],
            **timing["bounds"][name],
            # no single PyTorch call computes a translate-band-crop stage
            "library_ms": None,
        })
    return entries


def shear3_timing(make, card, plans, sps) -> dict:
    """Device (CUDA-graph replay) and eager ms per batch of each stage of
    both plans, kernel and plain, and of both routes, at the shear
    flagship; bytes per batch against the copy bandwidth of this run."""
    n = 4                                    # distinct batches, 67 MB each
    qs = [make(torch.bfloat16, (F, RH, RW)) for _ in range(n)]
    copy_dst = torch.empty_like(qs[0])
    fns = {"copy": (lambda q: copy_dst.copy_(q), qs)}
    stage_keys = []
    for dec in SHEAR_DECS:
        sp = sps[dec]
        xs = qs
        for i, st in enumerate(sp.stages):
            kern, plain = shear3_stage_fn(st)
            od = torch.bfloat16

            def k_fn(x, kern=kern, sp=sp, i=i, od=od):
                return kern(x, sp, i, out_dtype=od)

            def p_fn(x, plain=plain, sp=sp, i=i, od=od):
                return plain(x, sp, i, out_dtype=od)

            key = f"{dec}_s{i}"
            stage_keys.append((key, st))
            fns[f"{key}_kernel"] = (k_fn, xs)
            fns[f"{key}_plain"] = (p_fn, xs)
            xs = [k_fn(x) for x in xs]
        fns[f"{dec}_route_kernel"] = (
            lambda q, dec=dec: at.area_average_interpolate(
                q, *ROT, mode="shear", shear_decomposition=dec).dst, qs)
        fns[f"{dec}_route_plain"] = (
            lambda q, dec=dec: at.area_average_interpolate(
                q, *ROT, mode="shear", method="plain",
                shear_decomposition=dec).dst, qs)
    timing = {"card": card, "shape": [F, RH, RW], "dtype": "bfloat16",
              "angle": ROT[3], "dst": list(ROT_DST)}
    order = list(fns) + list(reversed(fns))          # two turns, mirrored
    for name in order:
        fn, inputs = fns[name]
        reps = 3 if name.endswith("plain") else 20
        hows = (("device", graph_ms), ("eager", eager_ms)) \
            if "route" in name or name == "copy" else (("device", graph_ms),)
        for how, timer in hows:
            ms = timer(fn, inputs, reps)
            timing.setdefault(f"{name}_{how}_ms", []).append(ms)
    for key in [k for k in timing if k.endswith("_ms")]:
        timing[key] = min(timing[key])
    e = 2                                             # bf16 bytes
    copy_bw = 2 * qs[0].nbytes / (timing["copy_device_ms"] * 1e-3)    # B/s
    px = F * RH * RW
    for dec in SHEAR_DECS:
        sp = sps[dec]
        stage_bytes = [F * e * (st.in_shape[0] * st.in_shape[1]
                                + st.out_shape[0] * st.out_shape[1])
                       for st in sp.stages]
        route_bytes = sum(stage_bytes) + sp.inv_cov.nbytes
        timing[f"{dec}_bytes_per_batch"] = route_bytes
        timing[f"{dec}_bound_ms"] = route_bytes / copy_bw * 1e3
        for i, b in enumerate(stage_bytes):
            timing[f"{dec}_s{i}_bytes"] = b
            timing[f"{dec}_s{i}_kernel_gb_s"] = b / (
                timing[f"{dec}_s{i}_kernel_device_ms"] * 1e-3) / 1e9
        for route in ("kernel", "plain"):
            for how in ("device", "eager"):
                t = timing[f"{dec}_route_{route}_{how}_ms"]
                timing[f"{dec}_route_{route}_{how}_gpixel_s"] = (
                    px / (t * 1e-3) / 1e9)
        t = timing[f"{dec}_route_kernel_device_ms"]
        timing[f"{dec}_route_kernel_gb_s"] = route_bytes / (t * 1e-3) / 1e9
        timing[f"{dec}_bound_share"] = timing[f"{dec}_bound_ms"] / t
    # per kernel: its stages over one quality and one fast request; the
    # bound counts each stage's input, output, tables and inv_cov once, and
    # 2 operations per tap (2 translate taps, plus K band taps)
    work = {k: [0, 0] for k in SHEAR3_KERNELS}
    for dec in SHEAR_DECS:
        sp = sps[dec]
        for i, st in enumerate(sp.stages):
            key = f"{dec}_s{i}"
            n_out = F * st.out_shape[0] * st.out_shape[1]
            nbytes = timing[f"{key}_bytes"] + table_bytes(
                st.d, st.f, st.start, st.w)
            if i == len(sp.stages) - 1 and sp.inv_cov is not None:
                nbytes += sp.inv_cov.nbytes
            ops = 2 * n_out * (2 + (st.K or 0))
            timing[f"{key}_bound_ms"] = bound(nbytes, ops)["bound_ms"]
            timing[f"{key}_bound_share"] = (
                timing[f"{key}_bound_ms"] / timing[f"{key}_kernel_device_ms"])
            w = work[f"{st.axis}stage"]
            w[0] += nbytes
            w[1] += ops
    timing["bounds"] = {k: bound(*w) for k, w in work.items()}
    for name in SHEAR3_KERNELS:
        for how in ("kernel", "plain"):
            timing[f"{name}_{how}_device_ms"] = sum(
                timing[f"{key}_{how}_device_ms"] for key, st in stage_keys
                if f"{st.axis}stage" == name)
    timing["copy_gb_s"] = copy_bw / 1e9
    t = timing
    for dec in SHEAR_DECS:
        stages = ", ".join(
            f"{st.axis}/{st.form} {t[f'{key}_kernel_device_ms']:.4f} / "
            f"{t[f'{key}_plain_device_ms']:.4f} ms "
            f"({t[f'{key}_kernel_gb_s']:.0f} GB/s, "
            f"{100 * t[f'{key}_bound_share']:.1f} % of its "
            f"{t[f'{key}_bound_ms']:.4f} ms bound)"
            for key, st in stage_keys if key.startswith(dec))
        print(f"[23 shear timing] {card}, {F}x{RH}x{RW} bf16 at 30 deg, "
              f"{dec}, best of 2 turns, device ms per batch (CUDA graph "
              f"replay) kernel / plain per stage (axis/form): {stages}; "
              f"route kernel {t[f'{dec}_route_kernel_device_ms']:.4f} ms = "
              f"{t[f'{dec}_route_kernel_device_gpixel_s']:.3f} Gpixel/s "
              f"(eager {t[f'{dec}_route_kernel_eager_ms']:.4f} ms), plain "
              f"{t[f'{dec}_route_plain_device_ms']:.4f} ms; route moves "
              f"{t[f'{dec}_bytes_per_batch'] / 1e6:.1f} MB/batch = "
              f"{t[f'{dec}_route_kernel_gb_s']:.1f} GB/s, copy "
              f"{t['copy_gb_s']:.1f} GB/s -> bound "
              f"{t[f'{dec}_bound_ms']:.4f} ms "
              f"({100 * t[f'{dec}_bound_share']:.1f} % of it reached)")
    print(json.dumps({"shear_timing": timing}))
    return timing



def regrid_tables(by, bx):
    """The 2-D kernel's host tables of a band pair."""
    return (by.start, by.weights.astype(np.float32), bx.start,
            bx.weights.astype(np.float32))


def regrid_phases(dev, card):
    """Phases 24-30: the band-operator family (conservative regrid and the
    area-resize front doors) on the 2-D banded-tile kernel.  Returns its
    entry of the JSON summary."""
    gen = torch.Generator(device=dev).manual_seed(5)

    def fields(dtype=torch.float32, shape=(RG_F,) + RG_SRC):
        """Seeded fields: uniform in [250, 300] (bench.py:479-480), or
        uniform gray levels for uint8."""
        x = torch.rand(shape, generator=gen, device=dev)
        if dtype == torch.uint8:
            return (x * 255.0).round().to(torch.uint8)
        return (x * 50.0 + 250.0).to(dtype)

    src, dst, qdeg = (at.LatLonGrid(*RG_SRC), at.LatLonGrid(*RG_DST),
                      at.LatLonGrid(*RG_QDEG))

    # ---- 24. host: the operators and the kernel's plans ---------------------
    t0 = time.perf_counter()
    by, bx = at.conservative_regrid_operator(src, dst)
    op_s = time.perf_counter() - t0
    qy, qx = at.conservative_regrid_operator(src, qdeg)
    tabs, qtabs = regrid_tables(by, bx), regrid_tables(qy, qx)
    t0 = time.perf_counter()
    plan = cuda_apply_2d.kernel_plan(*tabs)
    plan_s = time.perf_counter() - t0
    qplan = cuda_apply_2d.kernel_plan(*qtabs)
    aligned = t_regrid.band_tables(by, bx).aligned
    check(aligned is not None and t_regrid.band_tables(qy, qx).aligned is None,
          "config 5 must take the aligned route and 0.25 deg must not")
    check((by.band, bx.band, aligned[0]["m"], aligned[1]["m"], qy.band,
           qx.band) == (12, 12, 10, 10, 5, 5),
          f"regrid bands: K {by.band}x{bx.band}, 0.25 deg {qy.band}x{qx.band}")
    check(not plan["direct"] and not qplan["direct"],
          "the regrid plans must stage their blocks in shared memory")
    for name, p in (("config 5", plan), ("0.25 deg", qplan)):
        print(f"[24 regrid host] {name}: TY {p['TY']} TX {p['TX']} SY "
              f"{p['SY']} SX {p['SX']}, {p['nty']}x{p['ntx']} tiles, "
              f"{p['smem']} B of shared memory per block")
    print(f"[24 regrid host] {RG_SRC} -> {RG_DST}: conservative_regrid_operator"
          f" {op_s:.4f} s, K {by.band}x{bx.band}, aligned m 10; 2-D plan "
          f"{plan_s:.4f} s; {RG_SRC} -> {RG_QDEG}: K {qy.band}x{qx.band}")

    # ---- 25. the regrid path through the public entry points --------------
    reqs = [fields() for _ in range(2)]
    bf = [x.to(torch.bfloat16) for x in reqs]
    u8 = [fields(torch.uint8) for _ in range(2)]
    calls = (
        # (what, call, 2-D kernel launches per call)
        ("config 5 f32 auto",
         lambda i: at.conservative_regrid(reqs[i], src, dst), 1),
        ("config 5 f32 impl='aligned'",
         lambda i: at.conservative_regrid(reqs[i], src, dst, impl="aligned"),
         0),
        ("config 5 bf16 auto",
         lambda i: at.conservative_regrid(bf[i], src, dst), 1),
        ("config 5 u8 auto",
         lambda i: at.conservative_regrid(u8[i], src, dst), 1),
        ("0.25 deg f32 auto",
         lambda i: at.conservative_regrid(reqs[i], src, qdeg), 1),
    )
    torch.cuda.synchronize()
    reset_launches()
    outs = {}
    for what, fn, n in calls:
        for i in range(len(reqs)):
            before = cuda_apply_2d.LAUNCHES
            outs[what, i] = fn(i)
            check(cuda_apply_2d.LAUNCHES == before + n,
                  f"{what}: {cuda_apply_2d.LAUNCHES - before} launches, want "
                  f"{n}")
    torch.cuda.synchronize()
    launches = cuda_apply_2d.LAUNCHES
    check(launches == len(reqs) * sum(n for _, _, n in calls),
          f"regrid path launched the 2-D kernel {launches} times")
    check(cuda_apply.LAUNCHES == 0 and
          other_paths_idle(cuda_shear.LAUNCHES, cuda_shear3.LAUNCHES),
          "the regrid path launched a kernel of another path")
    errs = {}
    for i in range(len(reqs)):
        plain = cuda_apply_2d.apply_separable_2d_plain(reqs[i], *tabs)
        for what in ("config 5 f32 auto", "config 5 f32 impl='aligned'"):
            out = outs[what, i]
            check(out.dtype == torch.float32 and tuple(out.shape) ==
                  (RG_F,) + RG_DST and bool(torch.isfinite(out).all()),
                  f"{what}: {out.dtype} {tuple(out.shape)}")
            torch.testing.assert_close(out, plain, rtol=1e-6, atol=1e-3)
            errs[what] = max(errs.get(what, 0.0), max_err(out, plain))
        out = outs["config 5 bf16 auto", i]
        check(out.dtype == torch.bfloat16, f"bf16 regrid gave {out.dtype}")
        errs["bf16"] = max(errs.get("bf16", 0.0), within_bf16_ulp(
            out, cuda_apply_2d.apply_separable_2d_plain(
                bf[i], *tabs, out_dtype=torch.float32), "bf16 regrid"))
        out = outs["config 5 u8 auto", i]
        check(out.dtype == torch.uint8, f"u8 regrid gave {out.dtype}")
        e = max_err(out, cuda_apply_2d.apply_separable_2d_plain(u8[i], *tabs))
        check(e <= 1.0, f"u8 regrid err {e} > 1 gray level")
        errs["u8"] = max(errs.get("u8", 0.0), e)
        out = outs["0.25 deg f32 auto", i]
        qref = cuda_apply_2d.apply_separable_2d_plain(reqs[i], *qtabs)
        check(tuple(out.shape) == (RG_F,) + RG_QDEG,
              f"0.25 deg out {tuple(out.shape)}")
        torch.testing.assert_close(out, qref, rtol=1e-6, atol=1e-3)
        errs["0.25 deg"] = max(errs.get("0.25 deg", 0.0), max_err(out, qref))
    kernel_err = max(errs["config 5 f32 auto"], errs["0.25 deg"])
    print(f"[25 regrid path] {RG_F}x{RG_SRC[0]}x{RG_SRC[1]} fields via "
          f"conservative_regrid, {len(reqs)} requests per call: 2-D kernel "
          f"launches {launches} (f32, bf16, u8 and 0.25 deg auto: 1 each; "
          f"f32 impl='aligned': 0); max |out - plain|: "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    del outs

    # ---- 26. the kernel against its plain version, every precision -------
    perr = {}
    for name, x, t in (("config 5", reqs[0], tabs), ("0.25 deg", reqs[1],
                                                      qtabs)):
        for precision in ("auto", "default", "bf16x3"):
            for dtype in (torch.float32, torch.bfloat16):
                xd = x.to(dtype)
                Hd, Wd = t[1].shape[0], t[3].shape[0]
                buf = torch.full((RG_F, Hd, Wd), float("nan"), dtype=dtype,
                                 device=dev)
                got = cuda_apply_2d.apply_separable_kernel_2d(
                    xd, *t, precision=precision, out=buf)
                want = cuda_apply_2d.apply_separable_2d_plain(
                    xd, *t, precision=precision)
                torch.cuda.synchronize()
                what = f"{name} {precision} {dtype}"
                check(got is buf and bool(torch.isfinite(buf.float()).all()),
                      f"{what}: elements of a NaN-filled output left")
                if precision != "auto":
                    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
                elif dtype == torch.float32:
                    torch.testing.assert_close(got, want, rtol=1e-6,
                                               atol=1e-3)
                else:
                    within_bf16_ulp(got, cuda_apply_2d.apply_separable_2d_plain(
                        xd, *t, out_dtype=torch.float32), what)
                perr[what] = max_err(got, want)
    al = at.apply_band_operators(reqs[0], by, bx, impl="aligned")
    k2 = at.apply_band_operators(reqs[0], by, bx, impl="kernel")
    torch.testing.assert_close(al, k2, rtol=1e-6, atol=1e-3)
    e_al = max_err(al, k2)
    # bands whose one-pixel block exceeds shared memory: the direct form, at
    # the 480-tap cell and at the 4K -> 16 x 9 thumbnail, f32 and bf16
    wide = t_regrid.Band1D(start=np.zeros(4, np.int32),
                           weights=np.full((4, 480), 1 / 480), n_src=480,
                           n_dst=4)
    wtabs = regrid_tables(wide, wide)
    thumb = operator((H, W), 0.0, ratio=THUMB)
    ttabs = folded_tables(thumb)
    check(cuda_apply_2d.kernel_plan(*wtabs)["direct"]
          and cuda_apply_2d.kernel_plan(*ttabs)["direct"]
          and cuda_apply._plan_for(*ttabs)["kernel_2d"],
          "480-tap and thumbnail bands must take the direct form")
    xw = fields(shape=(RG_F, 480, 480))
    xt = fields(shape=(F, H, W))
    for name, x, t in (("480-tap f32", xw, wtabs), ("thumb f32", xt, ttabs),
                       ("thumb bf16", xt.to(torch.bfloat16), ttabs)):
        for precision in ("auto", "default", "bf16x3"):
            buf = torch.full((x.shape[0], t[1].shape[0], t[3].shape[0]),
                             float("nan"), device=dev).to(x.dtype)
            got = cuda_apply_2d.apply_separable_kernel_2d(
                x, *t, precision=precision, out=buf)
            want = cuda_apply_2d.apply_separable_2d_plain(
                x, *t, precision=precision)
            torch.cuda.synchronize()
            what = f"direct {name} {precision}"
            check(got is buf and bool(torch.isfinite(buf.float()).all()),
                  f"{what}: elements of a NaN-filled output left")
            if precision != "auto":
                check(torch.equal(got, want), f"{what}: not the plain "
                      f"version's bits (max {max_err(got, want):.3e})")
            elif x.dtype == torch.float32:
                torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-3)
            else:
                within_bf16_ulp(got, cuda_apply_2d.apply_separable_2d_plain(
                    x, *t, out_dtype=torch.float32), what)
            perr[what] = max_err(got, want)
        if name.startswith("thumb"):
            # the entry point a user calls: one launch, the kernel's output
            before = cuda_apply_2d.LAUNCHES
            api = at.apply_operator(thumb, x)
            check(cuda_apply_2d.LAUNCHES == before + 1
                  and torch.equal(api, cuda_apply_2d.apply_separable_kernel_2d(
                      x, *ttabs)), f"apply_operator, {name} thumbnail: not "
                  "one launch of the direct form")
    # where both forms run (config 5's 12-tap bands, the direct form forced
    # by a plan without shared memory): the same bits in every mode
    limit, cuda_apply_2d.SMEM_LIMIT = cuda_apply_2d.SMEM_LIMIT, 0
    try:
        dplan = cuda_apply_2d.make_plan(*tabs)
    finally:
        cuda_apply_2d.SMEM_LIMIT = limit
    check(dplan["direct"], "a plan without shared memory must be direct")
    for precision in ("auto", "default", "bf16x3"):
        for dtype in (torch.float32, torch.bfloat16):
            xd = reqs[0].to(dtype)
            a = cuda_apply_2d.apply_separable_kernel_2d(
                xd, *tabs, precision=precision, plan=dplan,
                out=torch.full((RG_F,) + RG_DST, float("nan"),
                               device=dev).to(dtype))
            b = cuda_apply_2d.apply_separable_kernel_2d(xd, *tabs,
                                                        precision=precision)
            check(torch.equal(a, b), f"direct form vs staged form, config 5 "
                  f"{precision} {dtype}: max {max_err(a, b):.3e}")
    del xt, api, a, b
    print(f"[26 regrid kernel] every precision, f32 and bf16, into NaN-filled"
          f" outputs: all written; max |kernel - plain| "
          + ", ".join(f"{k} {v:.3e}" for k, v in perr.items())
          + f"; aligned route vs kernel {e_al:.3e}; direct form (480-tap "
          f"cell, {F}x{H}x{W} -> {THUMB_DST} thumbnail: bit-equal to plain in "
          f"'default' and 'bf16x3', apply_operator 1 launch) and staged form "
          f"torch.equal at config 5 in every precision, f32 and bf16")

    # the kernel route's gradient: backward = the kernel on Wy^T, Wx^T
    g = torch.rand((RG_F,) + RG_DST, generator=gen, device=dev)
    xk = reqs[1].clone().requires_grad_(True)
    before = cuda_apply_2d.LAUNCHES
    (at.conservative_regrid(xk, src, dst) * g).sum().backward()
    check(cuda_apply_2d.LAUNCHES == before + 2,
          "regrid gradient: want 2 launches (forward, backward)")
    xb = reqs[1].clone().requires_grad_(True)
    (at.conservative_regrid(xb, src, dst, impl="banded") * g).sum().backward()
    torch.testing.assert_close(xk.grad, xb.grad, rtol=1e-5, atol=1e-6)
    print(f"[26 regrid gradient] config 5 f32 'auto' (kernel) backward vs "
          f"the banded route's autograd: 2 launches, max "
          f"{max_err(xk.grad, xb.grad):.3e}")
    del xk, xb, g

    # ---- 27. masked regrid, and the flux -------------------------------------
    mask = (torch.rand(RG_SRC, generator=gen, device=dev) > 0.3).float()
    x = reqs[0]
    before = cuda_apply_2d.LAUNCHES
    out_k, cov_k = at.apply_band_operators_masked(x, mask, by, bx,
                                                  impl="kernel")
    check(cuda_apply_2d.LAUNCHES == before + 2,
          "masked kernel route: want 2 launches (numerator, one shared "
          "denominator)")
    out_b, cov_b = at.apply_band_operators_masked(x, mask, by, bx,
                                                  impl="banded")
    torch.testing.assert_close(out_k, out_b, rtol=1e-6, atol=1e-3,
                               equal_nan=True)
    torch.testing.assert_close(cov_k, cov_b, rtol=0, atol=1e-6)
    w_src = torch.as_tensor(np.abs(np.diff(np.sin(np.radians(src.lat_edges)))),
                            device=dev)[:, None]
    w_dst = torch.as_tensor(np.abs(np.diff(np.sin(np.radians(dst.lat_edges)))),
                            device=dev)[:, None]

    def mean64(f, w):
        f = f.double()
        return (f * w).sum(dim=(-2, -1)) / (w.sum() * f.shape[-1])

    flux = {}
    for what, out in (("aligned", at.conservative_regrid(x, src, dst)),
                      ("kernel", at.conservative_regrid(x, src, dst,
                                                        impl="kernel"))):
        rel = ((mean64(out, w_dst) - mean64(x, w_src)).abs()
               / mean64(x, w_src).abs()).max().item()
        check(rel <= 1e-6, f"regrid flux ({what}): relative change {rel}")
        flux[what] = rel
    awm = float((at.area_weighted_mean(out, dst)
                 - at.area_weighted_mean(x, src)).abs().max())
    print(f"[27 masked regrid] 70 % valid mask, kernel route vs banded: out "
          f"max {max_err(torch.nan_to_num(out_k), torch.nan_to_num(out_b)):.3e},"
          f" coverage max {max_err(cov_k, cov_b):.3e}; spherical-area mean "
          f"kept (float64): aligned {flux['aligned']:.3e}, kernel "
          f"{flux['kernel']:.3e} relative; area_weighted_mean f32 |diff| "
          f"{awm:.3e}")
    del out_k, cov_k, out_b, cov_b

    # ---- 28. the area-resize front doors on 4K frames ----------------------
    frames = torch.rand((F, H, W), generator=gen, device=dev).to(torch.bfloat16)
    for shape in ((720, 1280), (768, 1366)):
        before = cuda_apply_2d.LAUNCHES
        out = at.area_resize(frames, shape)
        check(cuda_apply_2d.LAUNCHES == before + 1 and out.dtype ==
              torch.bfloat16 and tuple(out.shape) == (F,) + shape,
              f"area_resize to {shape}: {out.dtype} {tuple(out.shape)}")
        e = within_bf16_ulp(out, at.area_resize(frames, shape, impl="banded"),
                            f"area_resize {shape}")
        print(f"[28 area_resize] {F}x{H}x{W} bf16 -> {shape}: 1 launch, "
              f"within one bf16 ulp of 'banded' (max {e:.3e})")
    before = cuda_apply_2d.LAUNCHES
    levels = at.area_pyramid(frames[0], 4)
    check(cuda_apply_2d.LAUNCHES == before + 3, "area_pyramid: not 3 launches")
    for lo, hi in zip(levels, levels[1:]):
        within_bf16_ulp(hi, at.area_resize(lo, tuple(hi.shape), impl="banded"),
                        f"pyramid level {tuple(hi.shape)}")
    print(f"[28 area_pyramid] one 4K bf16 frame, 4 levels "
          f"{[tuple(v.shape) for v in levels]}: 3 launches, each level within"
          f" one bf16 ulp of 'banded' on the level above")
    del frames, levels, out

    # ---- 29. a dense float64 reference -------------------------------------
    rng = np.random.default_rng(0)
    small = rng.uniform(250, 300, (2, 360, 720)).astype(np.float32)
    sy, sx = at.conservative_regrid_operator(at.LatLonGrid(360, 720),
                                             at.LatLonGrid(36, 72))
    ref = (dense_band(sy.start, sy.weights, 360) @ small.astype(np.float64)
           @ dense_band(sx.start, sx.weights, 720).T)
    out = at.conservative_regrid(torch.from_numpy(small).to(dev),
                                 at.LatLonGrid(360, 720), at.LatLonGrid(36, 72),
                                 impl="kernel").cpu().double().numpy()
    rel = float(np.abs(out - ref).max() / np.abs(ref).min())
    check(rel <= 1e-6, f"regrid dense reference relative err {rel}")
    print(f"[29 regrid dense ref] (2, 360, 720) -> (36, 72) kernel route vs "
          f"float64 Wy @ A @ Wx^T: max relative err {rel:.3e}")

    # ---- 30. timing -----------------------------------------------------------
    timing = regrid_timing(card, fields, tabs, qtabs, by, bx)
    return [{
        "name": "separable_apply_2d",
        "route": "cuda",
        "source": "aainterp_torch/csrc/separable_apply_2d.cu",
        "replaces": "aainterp/ops/pallas_apply.py:849",
        "launches": launches,
        "max_abs_err": kernel_err,
        "ms": timing["k2d_f32_device_ms"],
        "plain_ms": timing["plain_f32_device_ms"],
        **timing["bounds"]["k2d_f32"],
        "library_ms": timing["library_f32_device_ms"],
    }]


def _launched(want: dict, what: str, fallbacks: int) -> None:
    """Check, after ``reset_launches()``, that the rotated kernels ran
    ``want`` times, no other kernel ran, and no geometry fell back to the
    plain gather."""
    got = dict(cuda_shear.LAUNCHES)
    check(got == want, f"{what}: rotated launches {got}, want {want}")
    check(cuda_apply.LAUNCHES == 0 and cuda_apply_2d.LAUNCHES == 0
          and other_paths_idle(cuda_shear3.LAUNCHES),
          f"{what}: launched a kernel of another path")
    check(t_api.SHEAR_PLAN_FALLBACKS == fallbacks,
          f"{what}: the plain gather took over (SHEAR_PLAN_FALLBACKS "
          f"{t_api.SHEAR_PLAN_FALLBACKS}, was {fallbacks})")


def _route(n: int) -> dict:
    """The rotated route's launches for ``n`` requests."""
    return {k: n if k in ROUTE_KERNELS else 0 for k in SHEAR_KERNELS}


def _adjoint_rel(apply, transpose, u, v) -> float:
    """|<A u, v> - <u, A^T v>| / |<A u, v>|, the sums in float64."""
    lhs = float((apply(u).double() * v.double()).sum())
    rhs = float((u.double() * transpose(v).double()).sum())
    return abs(lhs - rhs) / abs(lhs)


def rotated_rest_phases(make, card, dev):
    """Phases 31-36: the rest of the exact rotated family and the
    reference-named front doors at the flagships (compat, the ELL custom
    gradient, fused weight-gen, area_rotate, the transposed apply and
    variance maps, composition).  Returns the compat operator's shear
    plan (phase 45 holds the masked contraction on it)."""
    frames_shape = (F, RH, RW)
    timing = {"card": card}
    counts = {}

    # ---- 31. compat: native weight-gen, plan, route ------------------------
    replica_before = compat_ops.ENGINES["numpy"]
    cop, wgen_s = ell_operator_for((RH, RW), *ROT, mode="compat")
    check(compat_ops.ENGINES["numpy"] == replica_before,
          "compat cell areas took the numpy replica")
    t0 = time.perf_counter()
    cplan = cuda_shear.kernel_plan(cop)       # raises if the plan rejects it
    plan_s = time.perf_counter() - t0
    spec = cop.spec
    km = int(math.ceil(spec.dst_side * math.sqrt(2.0) + 2.0)) + 3
    check((cop.mode, spec.dst_shape, cop.window) == ("compat", ROT_DST, 10),
          f"compat flagship: {cop.mode} dst {spec.dst_shape} Kc {cop.window}")
    timing.update(compat_weight_gen_s=wgen_s, compat_plan_s=plan_s)
    print(f"[31 compat host] {RH}x{RW} at {ROT[3]} deg, compat: native "
          f"weight-gen {wgen_s:.3f} s (Km {km} mod cells, Kc {cop.window} "
          f"cells where exact has K {spec.window_cells}; table "
          f"{cop.weights.nbytes / 1e6:.1f} MB f64); shear plan {plan_s:.3f} s"
          f" accepts it: Ka x Kb {cplan.Ka}x{cplan.Kb}, T {cplan.TH}x"
          f"{cplan.TW}")
    r0 = spec.dst_shape[0] // 2
    nat = compat_ops.compat_ell_weights(spec, dy_slice=(r0, r0 + 2),
                                        prefer_native=True)
    rep = compat_ops.compat_ell_weights(spec, dy_slice=(r0, r0 + 2),
                                        prefer_native=False)
    check(all(np.array_equal(a, b) for a, b in zip(nat, rep)),
          "native compat areas differ from the numpy replica")
    check(np.array_equal(nat[1], cop.weights[r0:r0 + 2]),
          "compat rows differ from the chunked operator's")
    print(f"[31 compat host] dst rows {r0}-{r0 + 1}: native engine equal to "
          "the numpy replica bit for bit (and to the operator's rows)")
    cerr = {}
    for dtype in (torch.bfloat16, torch.float32):
        reqs = [make(dtype, frames_shape) for _ in range(2)]
        torch.cuda.synchronize()
        fb = t_api.SHEAR_PLAN_FALLBACKS
        reset_launches()
        outs = [at.area_average_interpolate(x, *ROT, mode="compat",
                                            operator=cop).dst for x in reqs]
        torch.cuda.synchronize()
        _launched(_route(len(reqs)), f"compat {dtype}", fb)
        counts[f"compat_{str(dtype)[6:]}"] = dict(cuda_shear.LAUNCHES)
        e = 0.0
        for x, out in zip(reqs, outs):
            check(out.dtype == dtype and tuple(out.shape) == (F,) + ROT_DST,
                  f"compat out {out.dtype} {tuple(out.shape)}")
            check(bool(torch.isfinite(out).all()), "compat out not finite")
            ref = at.apply_operator(cop, x, impl="gather")
            if dtype == torch.bfloat16:
                e = max(e, within_bf16_ulp(out, ref, "compat bf16 vs gather"))
            else:
                e = max(e, max_err(out, ref))
                check(e <= 1e-6, f"compat f32 err {e} > 1e-6")
        cerr[str(dtype)[6:]] = e
        del reqs, outs, ref
    print(f"[31 compat route] {F}x{RH}x{RW} -> {(F,) + ROT_DST} via "
          f"area_average_interpolate(mode='compat'): {_route(1)} per request,"
          f" no fallback; kernel vs 'gather': bf16 within one bf16 ulp (max "
          f"{cerr['bfloat16']:.3e}), f32 max {cerr['float32']:.3e}")
    small = np.random.default_rng(0).uniform(0, 1, (2, 48, 64))
    sop, _ = ell_operator_for((48, 64), 1.0, 0.5, (32.0, 24.0), 30.0,
                              mode="compat")
    ref = (sop.dense() @ small.reshape(2, -1).T).T.reshape(
        (2,) + sop.spec.dst_shape)
    out = at.area_average_interpolate(
        torch.tensor(small, dtype=torch.float32, device=dev), 1.0, 0.5,
        (32.0, 24.0), 30.0, mode="compat", operator=sop).dst
    e = float(np.abs(out.cpu().double().numpy() - ref).max())
    check(e <= 1e-6, f"compat dense reference err {e} > 1e-6")
    print(f"[31 compat dense ref] (2, 48, 64) at 30 deg vs float64 "
          f"EllOperator.dense(): max err {e:.3e}")
    # ---- 32. the ELL custom gradient (EllLinear), quadrants 0 and 1 -------
    op, _ = ell_operator_for((RH, RW), *ROT)
    # compat beside exact on the same frames, in mirrored turns
    qs = [make(torch.bfloat16, frames_shape) for _ in range(4)]
    for name in ("exact", "compat", "compat", "exact"):
        o = op if name == "exact" else cop
        timing.setdefault(f"{name}_route_device_ms", []).append(graph_ms(
            lambda q: at.apply_operator(o, q), qs, 20))
    for name in ("exact", "compat"):
        timing[f"{name}_route_device_ms"] = min(
            timing[f"{name}_route_device_ms"])
    print(f"[31 compat timing] {card}: compat route "
          f"{timing['compat_route_device_ms']:.4f} ms per batch, exact "
          f"{timing['exact_route_device_ms']:.4f} (mirrored turns, best of 2)")
    del cop, sop
    q1op, _ = ell_operator_for((RH, RW), *ROT_Q1)
    check(q1op.spec.quadrant == 1 and q1op.spec.dst_shape == ROT_DST,
          f"quadrant-1 flagship {q1op.spec.quadrant} {q1op.spec.dst_shape}")
    gerr, adj = {}, {}
    for name, o, args in (("q0", op, ROT), ("q1", q1op, ROT_Q1)):
        base, w = t_autodiff.ell_tables(o, torch.float32, dev)
        for dtype in (torch.float32, torch.bfloat16):
            x = make(dtype, frames_shape)
            plain_fwd = at.apply_operator(o, x)          # the kernel route
            xk = x.clone().requires_grad_(True)
            torch.cuda.synchronize()
            fb = t_api.SHEAR_PLAN_FALLBACKS
            reset_launches()
            y = at.area_average_interpolate(xk, *args, operator=o,
                                            differentiable=True).dst
            g = make(torch.float32, tuple(y.shape)).to(dtype)
            (gk,) = torch.autograd.grad(y, xk, g)
            torch.cuda.synchronize()
            what = f"differentiable {name} {dtype}"
            _launched(_route(1), what, fb)
            counts[f"grad_{name}_{str(dtype)[6:]}"] = dict(cuda_shear.LAUNCHES)
            check(torch.equal(y.detach(), plain_fwd),
                  f"{what}: forward differs from the kernel route's")
            check(gk.dtype == dtype and gk.device == x.device,
                  f"{what}: grad {gk.dtype} on {gk.device}")
            # native autograd of the plain gather on the unfolded tables
            xp = x.float().requires_grad_(True)
            yp = apply_ops.apply_ell(
                apply_ops.quadrant_rotate(xp, o.spec.quadrant), base, w)
            (gp,) = torch.autograd.grad(yp, xp, g.float())
            d = (gk.double() - gp.double()).abs()
            if dtype == torch.float32:
                e = float(d.max())
                check(e <= 1e-5, f"{what}: grad err {e} > 1e-5")
            else:
                bad = int((d > bf16_ulp(gp) + 1e-6).sum())
                check(bad == 0, f"{what}: {bad} grads beyond one bf16 ulp")
                e = float(d.max())
            gerr[f"{name}_{str(dtype)[6:]}"] = e
            del x, xk, y, g, gk, xp, yp, gp, d, plain_fwd
        u = make(torch.float32, frames_shape)
        v = make(torch.float32, (F,) + ROT_DST)
        adj[name] = _adjoint_rel(lambda t: at.apply_operator(o, t),
                                 lambda t: at.apply_operator_transpose(o, t),
                                 u, v)
        check(adj[name] <= 1e-5, f"{name}: adjoint identity rel "
              f"{adj[name]} > 1e-5")
        del u, v, base, w
    print(f"[32 ELL gradient] {F}x{RH}x{RW} at 30 deg (quadrant 0) and 120 "
          f"deg (quadrant 1), f32 and bf16, through area_average_interpolate("
          f"differentiable=True): forward bit-equal to the kernel route, "
          f"{_route(1)} per step, no fallback; grad vs native autograd of the "
          "plain gather: "
          + ", ".join(f"{k} {v:.3e}" for k, v in gerr.items())
          + "; <A u, v> = <u, A^T v> rel " + ", ".join(
              f"{k} {v:.3e}" for k, v in adj.items()))
    plan = cuda_shear.kernel_plan(op)
    fn = t_autodiff.ell_linear_for(op, "kernel", plan, torch.float32)
    gs = [make(torch.float32, (F,) + ROT_DST).to(torch.bfloat16)
          for _ in range(4)]
    xg = [q.clone().requires_grad_(True) for q in qs]
    timing.update(
        ell_forward_device_ms=graph_ms(fn.forward, qs, 20),
        ell_forward_eager_ms=eager_ms(fn, qs, 10),
        ell_backward_eager_ms=eager_ms(fn.backward, gs, 10),
        ell_step_eager_ms=_events_ms(
            lambda i: torch.autograd.grad(fn(xg[i]), xg[i], gs[i]), 4, 10))
    timing["ell_backward_over_forward"] = (timing["ell_backward_eager_ms"]
                                           / timing["ell_forward_device_ms"])
    del q1op, xg

    # ---- 33. fused=True: on-device weight-gen + gather ---------------------
    fop, _ = ell_operator_for((RH, RW), *EQ, mode="fast")
    ferr = {}
    for mode, args, hop in (("exact", ROT, op), ("fast", EQ, fop)):
        x = qs[0]
        host = at.apply_operator(hop, x, impl="gather")          # f32
        torch.cuda.synchronize()
        reset_launches()
        base_mem = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = at.area_average_interpolate(x, *args, mode=mode,
                                          fused=True).dst
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base_mem
        _launched(_route(0), f"fused {mode}", t_api.SHEAR_PLAN_FALLBACKS)
        check(out.dtype == torch.float32 and out.shape == host.shape,
              f"fused {mode} out {out.dtype} {tuple(out.shape)}")
        a, b = out.double(), host.double()
        edge = (a == 0) != (b == 0)
        share = float(edge.double().mean())
        check(share < 0.01, f"fused {mode}: {share:.4f} of pixels zero on "
              "one side only (>= 1 %)")
        d = (a - b).abs()
        if mode == "exact":
            # a pixel whose footprint barely meets the image normalises
            # float32 slivers into a large share of its weights: hold the
            # pixels at least half inside it (tests/test_torch_fused.py)
            keep = torch.from_numpy(
                hop.raw_row_sums >= 0.5 * hop.spec.dst_side ** 2).to(dev)
            e = float(d[keep.expand_as(a) & ~edge].max())
            check(e <= 2e-4, f"fused exact vs host err {e} > 2e-4")
            over = float((d[~edge] > 2e-4).double().mean())
        else:
            # float32 coordinates near 2048 move replica centres across the
            # footprint's edge, so a few counts differ from float64's (in
            # the JAX package's fused route too): hold their share
            e = float(d[~edge].max())
            over = float((d[~edge] > 2e-4).double().mean())
            check(over < 1e-3, f"fused fast: {over:.2e} of pixels beyond "
                  "2e-4 of the host route (>= 1e-3)")
        ferr[mode] = {"max": e, "share_beyond_2e-4": over}
        timing[f"fused_{mode}_first_s"] = secs
        timing[f"fused_{mode}_eager_ms"] = eager_ms(
            lambda q: at.area_average_interpolate(q, *args, mode=mode,
                                                  fused=True).dst, qs, 3)
        timing[f"fused_{mode}_peak_extra_bytes"] = int(peak)
        print(f"[33 fused {mode}] {F}x{RH}x{RW} bf16 at {args[3]} deg, "
              f"{args[0]} -> {args[1]} -> {tuple(out.shape)} f32 on the card "
              "(no kernel: float32 weight-gen + gather, chunked): vs the "
              f"host operator's gather max {e:.3e}, {over:.2e} of pixels "
              f"beyond 2e-4 (zero on one side only: {share:.2e}); first call "
              f"{secs:.3f} s, then "
              f"{timing[f'fused_{mode}_eager_ms']:.2f} ms per batch; peak "
              f"device memory above the call's start {peak / 1e9:.3f} GB")
        del host, out, a, b, d, edge
    counts["fused"] = _route(0)
    del fop
    # the JAX package's own fused pins at their size (tests/test_api.py:
    # 95-122): exact at 1.0 -> 0.5 and fast at equal resolution
    pin_err = {}
    for mode, res in (("exact", (1.0, 0.5)), ("fast", (1.0, 1.0))):
        src = torch.tensor(np.random.default_rng(1).uniform(0, 1, (2, 24, 24)),
                           dtype=torch.float32, device=dev)
        pop, _ = ell_operator_for((24, 24), *res, (11.5, 12.5), 30.0,
                                  mode=mode)
        a = at.area_average_interpolate(src, *res, (11.5, 12.5), 30.0,
                                        mode=mode, fused=True).dst.double()
        b = at.apply_operator(pop, src, impl="gather").double()
        edge = (a == 0) != (b == 0)
        check(float(edge.double().mean()) < 0.01, f"fused pin {mode}: edges")
        pin_err[mode] = float((a - b).abs()[~edge].max())
        check(pin_err[mode] <= 2e-4, f"fused pin {mode}: err "
              f"{pin_err[mode]} > 2e-4")
    ferr["pins"] = pin_err
    print(f"[33 fused pins] (2, 24, 24) about (11.5, 12.5) at 30 deg, the "
          f"JAX package's pins: exact 1.0 -> 0.5 max {pin_err['exact']:.3e},"
          f" fast 1.0 -> 1.0 max {pin_err['fast']:.3e} (<= 2e-4)")

    # ---- 34. area_rotate: equal resolution, dst 2798^2, K 5 ----------------
    aop, wgen_s = ell_operator_for((RH, RW), *EQ)
    t0 = time.perf_counter()
    aplan = cuda_shear.kernel_plan(aop)
    plan_s = time.perf_counter() - t0
    check((aop.spec.dst_shape, aop.window) == (EQ_DST, 5),
          f"area_rotate geometry {aop.spec.dst_shape} K {aop.window}")
    fb = t_api.SHEAR_PLAN_FALLBACKS
    reset_launches()
    outs = [at.area_rotate(x, EQ[3], operator=aop) for x in qs[:2]]
    torch.cuda.synchronize()
    _launched(_route(2), "area_rotate", fb)
    counts["area_rotate"] = _route(1)
    e = 0.0
    for x, out in zip(qs[:2], outs):
        check(out.dtype == torch.bfloat16 and tuple(out.shape) ==
              (F,) + EQ_DST, f"area_rotate out {out.dtype} {out.shape}")
        e = max(e, within_bf16_ulp(out, at.apply_operator(
            aop, x, impl="gather"), "area_rotate vs gather"))
    xf = make(torch.float32, frames_shape)
    xf[..., :2, :] = 0
    xf[..., -2:, :] = 0
    xf[..., :, :2] = 0
    xf[..., :, -2:] = 0
    out = at.area_rotate(xf, EQ[3], operator=aop)
    raw = torch.from_numpy(aop.raw_row_sums).to(dev) / aop.spec.scale ** 2
    flux_in = xf.double().sum(dim=(-2, -1))
    flux_out = (out.double() * raw).sum(dim=(-2, -1))
    rel = float(((flux_out - flux_in).abs() / flux_in).max())
    check(rel <= 1e-5, f"area_rotate flux rel err {rel} > 1e-5")
    timing.update(area_rotate_weight_gen_s=wgen_s, area_rotate_plan_s=plan_s,
                  area_rotate_device_ms=graph_ms(
                      lambda q: at.area_rotate(q, EQ[3], operator=aop),
                      qs, 20))
    print(f"[34 area_rotate] {F}x{RH}x{RW} bf16 by {EQ[3]} deg -> "
          f"{(F,) + EQ_DST} bf16 (K {aop.window}, Ka x Kb {aplan.Ka}x"
          f"{aplan.Kb}; weight-gen {wgen_s:.3f} s, plan {plan_s:.3f} s): "
          f"{_route(1)} per request; within one bf16 ulp of 'gather' (max "
          f"{e:.3e}); f32 flux of zero-bordered frames kept to rel {rel:.3e};"
          f" {timing['area_rotate_device_ms']:.4f} ms per batch")
    del aop, aplan, outs, xf, out, raw

    # ---- 35. apply_operator_transpose and propagate_variance ---------------
    op0 = operator((H, W), 0.0)
    lin0 = at.separable_linear_for(op0, torch.float32, "kernel")
    sq0 = at.separable_linear_for(at.squared_operator(op0), torch.float32,
                                  "kernel")
    cots = [make(torch.bfloat16, (F, H // 2, W // 2)) for _ in range(3)]
    reset_launches()
    tq = at.apply_operator_transpose(op0, cots[0])
    torch.cuda.synchronize()
    check(cuda_apply.LAUNCHES == 1 and cuda_apply_2d.LAUNCHES == 0 and
          other_paths_idle(cuda_shear.LAUNCHES, cuda_shear3.LAUNCHES),
          "separable transpose did not launch kernel 1 once")
    check(tq.dtype == torch.bfloat16 and tuple(tq.shape) == (F, H, W),
          f"separable transpose {tq.dtype} {tuple(tq.shape)}")
    et = max_err(tq, cuda_apply.apply_separable_plain(
        cots[0], *lin0.t_tables, out_dtype=torch.float32))
    check(et <= 1e-2, f"separable transpose bf16 err {et} > 1e-2")
    var = make(torch.bfloat16, (F, H, W))
    reset_launches()
    pv = at.propagate_variance(op0, var)
    torch.cuda.synchronize()
    check(cuda_apply.LAUNCHES == 1, "separable variance: not one launch")
    ev = max_err(pv, cuda_apply.apply_separable_plain(
        var, *sq0.tables, out_dtype=torch.float32))
    check(ev <= 1e-2, f"separable variance bf16 err {ev} > 1e-2")
    u = make(torch.float32, (F, H, W))
    v = make(torch.float32, (F, H // 2, W // 2))
    adj_sep = _adjoint_rel(lambda t: at.apply_operator(op0, t),
                           lambda t: at.apply_operator_transpose(op0, t),
                           u, v)
    check(adj_sep <= 1e-5, f"separable adjoint identity rel {adj_sep}")
    counts["separable_transpose"] = counts["separable_variance"] = 1
    del u, v, tq, pv
    vs = [make(torch.bfloat16, frames_shape) for _ in range(2)]
    fb = t_api.SHEAR_PLAN_FALLBACKS
    reset_launches()
    rv = at.propagate_variance(op, vs[0])
    torch.cuda.synchronize()
    _launched(_route(1), "rotated variance", fb)
    counts["rotated_variance"] = _route(1)
    erv = within_bf16_ulp(rv, at.apply_operator(
        at.squared_operator(op), vs[0], impl="gather"),
        "rotated variance vs gather")
    rt = at.apply_operator_transpose(op, make(torch.float32, (F,) + ROT_DST))
    check(tuple(rt.shape) == frames_shape and bool(torch.isfinite(rt).all()),
          f"rotated transpose {tuple(rt.shape)}")
    gs32 = [g.float() for g in gs]
    # kernel 1 as the transpose's library call: one einsum with the dense
    # operators transposed, bf16 like the cotangents
    wyt, wxt = (torch.as_tensor(m, dtype=torch.bfloat16, device=dev)
                for m in op0.dense())
    el = max_err(torch.einsum("hy,fhw,wx->fyx", wyt, cots[0], wxt),
                 at.apply_operator_transpose(op0, cots[0]))
    check(el <= 1e-2, f"the transpose's library einsum differs by {el}")
    timing.update(
        separable_transpose_device_ms=graph_ms(
            lambda c: at.apply_operator_transpose(op0, c), cots, 20),
        separable_transpose_library_device_ms=graph_ms(
            lambda c: torch.einsum("hy,fhw,wx->fyx", wyt, c, wxt), cots, 5),
        separable_variance_device_ms=graph_ms(
            lambda q: at.propagate_variance(op0, q),
            [make(torch.bfloat16, (F, H, W)) for _ in range(3)], 20),
        rotated_transpose_eager_ms=eager_ms(
            lambda c: at.apply_operator_transpose(op, c), gs32, 10),
        rotated_variance_device_ms=graph_ms(
            lambda q: at.propagate_variance(op, q), vs, 20),
        rotated_variance_eager_ms=eager_ms(
            lambda q: at.propagate_variance(op, q), vs, 10))
    print(f"[35 transpose/variance] separable flagship bf16: "
          f"apply_operator_transpose 1 kernel-1 launch, max |kernel - plain| "
          f"{et:.3e}, {timing['separable_transpose_device_ms']:.4f} ms "
          f"(library einsum "
          f"{timing['separable_transpose_library_device_ms']:.4f} ms); "
          f"propagate_variance 1 launch, err {ev:.3e}, "
          f"{timing['separable_variance_device_ms']:.4f} ms; f32 adjoint "
          f"identity rel {adj_sep:.3e}.  Rotated flagship: variance "
          f"{_route(1)}, within one bf16 ulp of 'gather' (max {erv:.3e}), "
          f"{timing['rotated_variance_device_ms']:.4f} ms ("
          f"{timing['rotated_variance_eager_ms']:.4f} eager; the squared "
          f"operator cached); transpose (index_add_ scatter) "
          f"{timing['rotated_transpose_eager_ms']:.3f} ms eager")
    del rv, rt, vs, gs, gs32, cots, op, plan, fn, wyt, wxt

    # ---- 36. compose: 4K -> 1080p -> 540p as one operator ------------------
    op2 = operator((H // 2, W // 2), 0.0)
    comp = at.compose_separable(op2, op0)
    x = make(torch.float32, (F, H, W))
    reset_launches()
    one = at.apply_operator(comp, x)
    torch.cuda.synchronize()
    check(cuda_apply.LAUNCHES == 1, "composed apply: not one launch")
    chained = at.apply_operator(op2, at.apply_operator(op0, x))
    ec = max_err(one, chained)
    check(ec <= 1e-5, f"composed vs chained f32 err {ec} > 1e-5")
    counts["compose"] = 1
    xb = [make(torch.bfloat16, (F, H, W)) for _ in range(3)]
    timing.update(
        compose_device_ms=graph_ms(lambda q: at.apply_operator(comp, q), xb,
                                   20),
        chained_device_ms=graph_ms(
            lambda q: at.apply_operator(op2, at.apply_operator(op0, q)), xb,
            20))
    print(f"[36 compose] compose_separable(1080p -> 540p, 4K -> 1080p): "
          f"bands {comp.wy.band}x{comp.wx.band}, 1 kernel-1 launch per batch, "
          f"vs the two applies in sequence f32 max {ec:.3e}; bf16 "
          f"{timing['compose_device_ms']:.4f} ms vs chained "
          f"{timing['chained_device_ms']:.4f} ms per batch")
    timing["launches"] = counts
    timing["errors"] = {"compat": cerr, "grad": gerr, "adjoint": adj,
                        "adjoint_separable": adj_sep, "fused": ferr}
    print(json.dumps({"rotated_rest_timing": timing}))
    return cplan


# ---------------------------------------------------------------------------
# Phases 37-41: the reference-parity CLI, the stream, the disk caches
# ---------------------------------------------------------------------------


def film_dose(seed: int, shape=FILM) -> np.ndarray:
    """A seeded film-dose image in Gy: a square field with a sigmoid
    penumbra, its centre jittered, plus 1 % noise, non-negative."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:shape[0], 0:shape[1]].astype(np.float64)
    cy = (shape[0] - 1) / 2 + rng.uniform(-20, 20)
    cx = (shape[1] - 1) / 2 + rng.uniform(-20, 20)
    half = 0.3 * min(shape)

    def edge(d):
        return 1.0 / (1.0 + np.exp((np.abs(d) - half) / 8.0))

    dose = 2.0 * edge(y - cy) * edge(x - cx)
    return np.clip(dose + rng.normal(0.0, 0.02, shape), 0.0, None)


def run_cli(argv) -> tuple:
    """``cli.main(argv)`` in this process: (return code, stdout)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = t_cli.main(list(argv))
    return rc, buf.getvalue()


_TIME_LINE = re.compile(r"Calculation time : (\S+) \[ms\]")


def mask_times(text: str) -> str:
    text = _TIME_LINE.sub("Calculation time : ? [ms]", text)
    return re.sub(r"\(\S+ ms/file\)", "(? ms/file)", text)


def at_6_digits(a) -> np.ndarray:
    """``a`` as the CLI's CSV holds it: %.6g, read back as float64."""
    a = a.detach().double().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a, np.float64)
    return np.char.mod("%.6g", a).astype(np.float64)


def _idle_but(name: str) -> bool:
    """No kernel ran since reset_launches() other than ``name``'s path
    ('separable', 'band', 'rotated' or None)."""
    return ((name == "separable" or cuda_apply.LAUNCHES == 0)
            and (name == "band" or cuda_apply_2d.LAUNCHES == 0)
            and (name == "rotated" or other_paths_idle(cuda_shear.LAUNCHES))
            and other_paths_idle(cuda_shear3.LAUNCHES))


def cli_phases(dev, work: str) -> dict:
    """Phases 37-38: the legacy command at the reference's own geometry
    and the subcommands, through ``cli.main`` (and once as
    ``python3 -m aainterp_torch``).  Returns their timing."""
    timing = {}
    src = film_dose(0)
    inp = os.path.join(work, "film.csv")
    t_io.csv_write(inp, src)
    src = t_io.csv_read(inp)                # the values the command reads
    x = torch.from_numpy(src.astype(np.float32)).to(dev)
    iso = (455.0, 455.0)
    outputs = {}

    # ---- 37. the legacy command --------------------------------------------
    for name, (extra, mode) in LEGACY_RUNS.items():
        out = os.path.join(work, f"film_{name}.csv")
        angle = float(extra[extra.index("--angle") + 1])
        fb = t_api.SHEAR_PLAN_FALLBACKS
        torch.cuda.synchronize()
        reset_launches()
        rc, text = run_cli([inp] + FILM_ARGS + extra + ["--output", out])
        torch.cuda.synchronize()
        n1, nr = cuda_apply.LAUNCHES, dict(cuda_shear.LAUNCHES)
        check(rc == 0, f"CLI {name} returned {rc}:\n{text}")
        if angle == 0.0:
            check(cuda_apply.LAUNCHES == 1 and _idle_but("separable"),
                  f"CLI {name}: kernel 1 launched {cuda_apply.LAUNCHES} "
                  "times, or another kernel ran")
        else:
            _launched(_route(1), f"CLI {name}", fb)
        fn = ("AreaAverageInterpolation::areaAverageInterpolation"
              if "1" == extra[extra.index("--mode") + 1] else
              "AreaAverageInterpolation::fastAreaAverageInterpolation")
        want = t_log.banner(fn, 150.0, 25.4, iso, angle).splitlines()
        lines = text.splitlines()
        check(lines[:-2] == want and _TIME_LINE.fullmatch(lines[-2])
              and lines[-1] == "Run terminated correctly.",
              f"CLI {name} stdout is not banner, timing, end:\n{text}")
        ref = at.area_average_interpolate(x, 150.0, 25.4, iso, angle,
                                          mode=mode).dst
        got = t_io.csv_read(out)
        check(got.shape == tuple(ref.shape)
              and np.array_equal(got, at_6_digits(ref)),
              f"CLI {name}: the CSV differs from the in-process apply at 6 "
              "significant digits")
        timing[f"cli_{name}_ms"] = float(_TIME_LINE.search(text).group(1))
        outputs[name] = (out, text)
        print(f"[37 cli] {name}: {' '.join(extra)}: rc 0, banner + timing "
              f"+ end, {n1} kernel-1 / {nr['vhshear']} fused-shear / "
              f"{nr['contract']} contraction launches, "
              f"{FILM[0]}x{FILM[1]} -> {got.shape}, CSV equal to the "
              f"in-process apply at 6 digits; "
              f"{timing[f'cli_{name}_ms']:.3f} ms")
    out = os.path.join(work, "film_sub.csv")
    env = dict(os.environ, PYTHONPATH=REPO,
               AAINTERP_CACHE_DIR=t_cache.DEFAULT_CACHE_DIR)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "aainterp_torch", inp] + FILM_ARGS
        + LEGACY_RUNS["mode2"][0] + ["--output", out], capture_output=True,
        text=True, cwd=REPO, env=env, timeout=600)
    sub_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"python3 -m aainterp_torch returned "
          f"{proc.returncode}:\n{proc.stdout}\n{proc.stderr}")
    check(mask_times(proc.stdout) == mask_times(outputs["mode2"][1]),
          "the subprocess's stdout differs from the in-process run's")
    check(open(out, "rb").read() == open(outputs["mode2"][0], "rb").read(),
          "the subprocess's CSV differs from the in-process run's")
    timing["cli_subprocess_s"] = sub_s
    print(f"[37 cli] python3 -m aainterp_torch --mode 2: rc 0, stdout and "
          f"CSV bytes equal to the in-process run's ({sub_s:.2f} s, process "
          "start included)")
    cache = os.path.join(work, "opcache")
    for i in range(2):
        before = sum(weights_ops.WEIGHT_GEN_ENGINES.values())
        out = os.path.join(work, f"film_cached{i}.csv")
        rc, text = run_cli([inp] + FILM_ARGS + LEGACY_RUNS["mode2"][0]
                           + ["--cache-dir", cache, "--output", out])
        moved = sum(weights_ops.WEIGHT_GEN_ENGINES.values()) - before
        check(rc == 0 and moved == (1 - i),
              f"--cache-dir run {i}: rc {rc}, weight-gen ran {moved} times")
        check(open(out, "rb").read() == open(outputs["mode2"][0],
                                             "rb").read(),
              f"--cache-dir run {i}: the CSV differs")
        timing[f"cli_cache_run{i}_ms"] = float(
            _TIME_LINE.search(text).group(1))
    print(f"[37 cli] --cache-dir: run 1 builds and saves the operator "
          f"({timing['cli_cache_run0_ms']:.3f} ms), run 2 loads it, weight-"
          f"gen counters unmoved ({timing['cli_cache_run1_ms']:.3f} ms); "
          "CSVs equal")

    # ---- 38. the subcommands -------------------------------------------------
    field = np.random.default_rng(38).uniform(250.0, 300.0, (180, 360))
    fpath = os.path.join(work, "field.csv")
    t_io.csv_write(fpath, field)
    f32 = torch.from_numpy(t_io.csv_read(fpath).astype(np.float32)).to(dev)
    subs = {
        "resize_area": (["resize", inp, "--shape", "455", "300"], "band",
                        lambda: at.resize(x, (455, 300))),
        "resize_bicubic": (["resize", inp, "--shape", "300", "455",
                            "--method", "bicubic"], None,
                           lambda: at.resize(x, (300, 455),
                                             method="bicubic")),
        "rotate": (["rotate", inp, "--angle", "30"], "rotated",
                   lambda: at.area_rotate(x, 30.0)),
        "regrid": (["regrid", fpath, "--dst-grid", "90", "180",
                    "--conserve-check"], "band",
                   lambda: at.conservative_regrid(
                       f32, at.LatLonGrid(180, 360), at.LatLonGrid(90, 180))),
    }
    for name, (argv, path, direct) in subs.items():
        out = os.path.join(work, f"sub_{name}.csv")
        torch.cuda.synchronize()
        reset_launches()
        rc, text = run_cli(argv + ["--output", out])
        torch.cuda.synchronize()
        check(rc == 0 and text.endswith("Run terminated correctly.\n"),
              f"{name}: rc {rc}:\n{text}")
        n = {"band": cuda_apply_2d.LAUNCHES, "rotated":
             cuda_shear.LAUNCHES["vhshear"], None: 0}[path]
        check(_idle_but(path) and (path is None or n == 1)
              and (path != "rotated" or cuda_shear.LAUNCHES["contract"] == 1),
              f"{name}: launches {cuda_apply.LAUNCHES} "
              f"{cuda_apply_2d.LAUNCHES} {cuda_shear.LAUNCHES}")
        got = t_io.csv_read(out)
        check(np.array_equal(got, at_6_digits(direct())),
              f"{name}: the CSV differs from the in-process apply")
        if name == "regrid":
            err = float(re.search(r"relative error (\S+)", text).group(1))
            check(err < 1e-6, f"regrid flux error {err}")
        timing[f"{name}_ms"] = float(_TIME_LINE.search(text).group(1))
        print(f"[38 subcommand] {' '.join(a for a in argv if a not in (inp, fpath))}"
              f": rc 0, {n} launch(es) of its kernel, CSV {got.shape} equal "
              f"to the in-process apply at 6 digits"
              + (f", flux error {err:.3e}" if name == "regrid" else ""))
    png = os.path.join(work, "frame.png")
    with open(png, "wb") as f:
        f.write(b"\x89PNG not an image")
    try:
        import PIL  # noqa: F401
        have_pil = True
    except ImportError:
        have_pil = False
    saved = sys.modules.get("PIL", "absent")
    sys.modules["PIL"] = None               # as on a machine without Pillow
    try:
        rc, text = run_cli(["resize", png, "--shape", "8", "8"])
    finally:
        if saved == "absent":
            del sys.modules["PIL"]
        else:
            sys.modules["PIL"] = saved
    check(rc == -1 and text.startswith("Failed to read image file.")
          and text.endswith("Run terminated abnormally.\n"),
          f"a .png without Pillow: rc {rc}:\n{text}")
    proc = subprocess.run(
        [sys.executable, "-m", "aainterp_torch", "resize", png, "--shape",
         "8", "8"], capture_output=True, text=True, cwd=REPO, env=env,
        timeout=600)
    check(proc.returncode == 255 and "Traceback" not in proc.stderr
          and proc.stdout.endswith("Run terminated abnormally.\n"),
          f"resize of a bad .png: rc {proc.returncode}\n{proc.stdout}\n"
          f"{proc.stderr}")
    print(f"[38 subcommand] a .png with Pillow hidden: {text.splitlines()[0]!r}"
          f", return -1; as a process (Pillow "
          f"{'present' if have_pil else 'absent'} here): exit 255, no "
          "traceback")
    return timing


def _copy_gb_s(dst, src, reps: int = 5) -> float:
    """GB/s of ``dst.copy_(src, non_blocking=True)`` on CUDA events."""
    dst.copy_(src, non_blocking=True)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        dst.copy_(src, non_blocking=True)
    end.record()
    end.synchronize()
    return reps * src.nbytes / (start.elapsed_time(end) * 1e-3) / 1e9


def stream_phases(dev, card, work: str) -> dict:
    """Phases 39-40: the stream at bench.py's stream geometry (and a
    rotated one), and stream_apply_files through the CLI's multi-input
    path.  Returns their timing."""
    timing = {"card": card, "frames": STREAM_N, "batch": STREAM_BATCH,
              "shape": [H, W]}
    op = operator((H, W), 0.0)
    yb, xb, out_t = weights_ops.fold_quadrant_separable(op)
    check(not out_t, "4K -> 1080p folded with a transpose")
    gen = torch.Generator().manual_seed(39)

    def frames(dtype, n, shape=(H, W)):
        if dtype == torch.uint8:
            return [torch.randint(0, 256, shape, dtype=torch.uint8,
                                  generator=gen) for _ in range(n)]
        return [torch.rand(shape, generator=gen).to(dtype)
                for _ in range(n)]

    # ---- 39. the stream: 48 distinct 4K frames, batch 8 -------------------
    # depths in mirrored turns (1, 3, 3, 1), each after a warm-up stream of
    # its own frames; the best of each depth's two turns is reported
    n_batches = STREAM_N // STREAM_BATCH
    for dtype in (torch.bfloat16, torch.uint8):
        name = str(dtype)[6:]
        fr = frames(dtype, STREAM_N)
        warm = frames(dtype, 2 * STREAM_BATCH)
        for depth in (1, 3, 3, 1):
            for _ in pipeline.stream_apply(op, warm, batch=STREAM_BATCH,
                                           depth=depth):
                pass
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            outs = list(pipeline.stream_apply(op, fr, batch=STREAM_BATCH,
                                              depth=depth))
            dt = time.perf_counter() - t0
            check(len(outs) == STREAM_N, f"stream gave {len(outs)} frames")
            check(cuda_apply_2d.LAUNCHES == n_batches and _idle_but("band"),
                  f"stream {name} depth {depth}: kernel 2 launched "
                  f"{cuda_apply_2d.LAUNCHES} times, want {n_batches}")
            for b in range(n_batches):
                xb_ = torch.stack(fr[b * STREAM_BATCH:(b + 1) * STREAM_BATCH])
                ref = at.apply_band_operators(xb_.to(dev), yb, xb).cpu()
                for i in range(STREAM_BATCH):
                    check(torch.equal(outs[b * STREAM_BATCH + i], ref[i]),
                          f"stream {name} depth {depth}: frame "
                          f"{b * STREAM_BATCH + i} differs from the direct "
                          "apply of its batch")
            gp = STREAM_N * H * W / dt / 1e9
            turns = timing.setdefault(f"{name}_depth{depth}_turns_s", [])
            turns.append(dt)
            timing[f"{name}_depth{depth}_gpixel_s"] = \
                STREAM_N * H * W / min(turns) / 1e9
            print(f"[39 stream] {STREAM_N} x {H}x{W} {name} -> "
                  f"{tuple(outs[0].shape)} {outs[0].dtype}, batch "
                  f"{STREAM_BATCH}, depth {depth}: {gp:.3f} Gpixel/s "
                  f"({dt:.3f} s), {n_batches} kernel-2 launches, every frame "
                  "equal to the direct apply of its batch")
            del outs
        # the copies a batch of this dtype makes, in the same run
        es = fr[0].element_size()
        host = torch.empty((STREAM_BATCH, H, W), dtype=dtype,
                           pin_memory=True)
        devb = torch.empty((STREAM_BATCH, H, W), dtype=dtype, device=dev)
        hout = torch.empty((STREAM_BATCH, H // 2, W // 2), dtype=dtype,
                           pin_memory=True)
        dout = torch.zeros((STREAM_BATCH, H // 2, W // 2), dtype=dtype,
                           device=dev)
        t0 = time.perf_counter()
        for r in range(3):
            for i in range(STREAM_BATCH):
                host[i].copy_(fr[(r * STREAM_BATCH + i) % STREAM_N])
        fill = 3 * host.nbytes / (time.perf_counter() - t0) / 1e9
        h2d, d2h = _copy_gb_s(devb, host), _copy_gb_s(hout, dout)
        in_b = STREAM_N * H * W * es
        out_b = STREAM_N * (H // 2) * (W // 2) * es
        # copy engines run both ways at once: the slower direction bounds
        t_bound = max(in_b / (h2d * 1e9), out_b / (d2h * 1e9))
        timing.update({f"{name}_h2d_gb_s": h2d, f"{name}_d2h_gb_s": d2h,
                       f"{name}_host_fill_gb_s": fill,
                       f"{name}_transfer_bound_gpixel_s":
                           STREAM_N * H * W / t_bound / 1e9,
                       f"{name}_host_fill_bound_gpixel_s": fill / es})
        print(f"[39 stream] {card}, {name}: pinned H2D {h2d:.2f} GB/s, D2H "
              f"{d2h:.2f} GB/s -> transfer bound "
              f"{timing[f'{name}_transfer_bound_gpixel_s']:.3f} Gpixel/s; "
              f"host copy into pinned memory {fill:.2f} GB/s -> "
              f"{timing[f'{name}_host_fill_bound_gpixel_s']:.3f} Gpixel/s")
        del fr, warm, host, devb, hout, dout
    rop, _ = ell_operator_for((RH, RW), *ROT)
    rfr = frames(torch.bfloat16, 16, (RH, RW))
    fb = t_api.SHEAR_PLAN_FALLBACKS
    for _ in pipeline.stream_apply(rop, frames(torch.bfloat16, 8, (RH, RW)),
                                   batch=8):
        pass
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    outs = list(pipeline.stream_apply(rop, rfr, batch=8, depth=2))
    dt = time.perf_counter() - t0
    _launched(_route(2), "rotated stream", fb)
    for b in range(2):
        xb_ = torch.stack(rfr[8 * b:8 * b + 8])
        ref = at.apply_operator(rop, xb_.to(dev)).cpu()
        for i in range(8):
            check(torch.equal(outs[8 * b + i], ref[i]),
                  f"rotated stream frame {8 * b + i} differs from the route")
    timing["rotated_bf16_gpixel_s"] = 16 * RH * RW / dt / 1e9
    print(f"[39 stream] rotated: 16 x {RH}x{RW} bf16 at {ROT[3]} deg -> "
          f"{tuple(outs[0].shape)} {outs[0].dtype}, batch 8, depth 2: "
          f"{timing['rotated_bf16_gpixel_s']:.3f} Gpixel/s, 2 + 2 launches, "
          "every frame equal to the route on its batch")
    del outs, rfr

    # ---- 40. stream_apply_files through the multi-input command ------------
    paths = []
    for i in range(16):
        p = os.path.join(work, f"film{i:02d}.csv")
        t_io.csv_write(p, film_dose(100 + i), sig_digits=6)
        paths.append(p)
    common = FILM_ARGS + LEGACY_RUNS["mode2"][0]
    fb = t_api.SHEAR_PLAN_FALLBACKS
    torch.cuda.synchronize()
    reset_launches()
    rc, text = run_cli(paths + common + ["--batch", "8", "--depth", "2"])
    torch.cuda.synchronize()
    check(rc == 0 and "Streamed 16 files" in text,
          f"multi-input command: rc {rc}:\n{text}")
    _launched(_route(2), "multi-input command", fb)
    ms_file = float(re.search(r"\((\S+) ms/file\)", text).group(1))
    for i, p in enumerate(paths):
        single = os.path.join(work, f"single{i:02d}.csv")
        rc, _ = run_cli([p] + common + ["--no-banner", "--output", single])
        check(rc == 0, f"single-file command on {p}: rc {rc}")
        check(open(single, "rb").read() == open(
            t_io.default_output_path(p), "rb").read(),
            f"file {i}: the streamed CSV differs from the single-file one")
    timing["files_ms_per_file"] = ms_file
    print(f"[40 files] 16 film CSVs {FILM[0]}x{FILM[1]} through the "
          f"multi-input command (batch 8, depth 2): {ms_file:.3g} ms/file, "
          "2 + 2 launches; every <base>_mod.csv equal byte for byte to the "
          "single-file command's")
    print(json.dumps({"stream_timing": timing}))
    return timing


def cache_phases(dev, card, work: str) -> dict:
    """Phase 41: the operator and shear-plan disk caches at the rotated
    flagship and its compat operator, in a temporary cache directory.
    Returns their timing."""
    timing = {"card": card}
    cdir = tempfile.mkdtemp(prefix="caches.", dir=work)
    default_dir = t_cache.DEFAULT_CACHE_DIR
    spec = at.make_grid_spec((RH, RW), *ROT)
    x = torch.rand((F, RH, RW), generator=torch.Generator().manual_seed(41)
                   ).to(torch.bfloat16).to(dev)
    for mode in ("exact", "compat"):
        t0 = time.perf_counter()
        op = t_cache.build_operator_cached(spec, mode=mode, cache_dir=cdir)
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        op2 = t_cache.load_operator(spec, mode, "ell", cache_dir=cdir)
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        op3 = t_cache.build_operator_cached(spec, mode=mode, cache_dir=cdir)
        cached_s = time.perf_counter() - t0
        check(all(np.array_equal(a, b) and np.array_equal(a, c) for a, b, c
                  in ((op.base, op2.base, op3.base),
                      (op.weights, op2.weights, op3.weights)))
              and op2.mode == mode, f"{mode}: the loaded operator differs")
        cuda_shear._PLAN_CACHE.clear()
        d0 = dict(cuda_shear.PLAN_DISK)
        t0 = time.perf_counter()
        built = cuda_shear.kernel_plan_cached(op, cache_dir=cdir)
        plan_build_s = time.perf_counter() - t0
        cuda_shear._PLAN_CACHE.clear()
        t0 = time.perf_counter()
        loaded = cuda_shear.kernel_plan_cached(op2, cache_dir=cdir)
        plan_load_s = time.perf_counter() - t0
        check(cuda_shear.PLAN_DISK == {"built": d0["built"] + 1,
                                       "loaded": d0["loaded"] + 1},
              f"{mode}: plan cache {cuda_shear.PLAN_DISK}, was {d0}")
        for fld in dataclasses.fields(cuda_shear.ShearKernelPlan):
            if fld.name in ("tiles", "dev"):
                continue
            a, b = getattr(built, fld.name), getattr(loaded, fld.name)
            same = (a.dtype == b.dtype and np.array_equal(a, b)) \
                if isinstance(a, np.ndarray) else a == b
            check(same, f"{mode}: the loaded plan's {fld.name} differs")
        a = cuda_shear.apply_ell_shear_kernel(x, built)
        b = cuda_shear.apply_ell_shear_kernel(x, loaded)
        check(torch.equal(a, b), f"{mode}: the loaded plan's output differs")
        # the route itself, its in-memory plans cleared, loads from disk
        cuda_shear._PLAN_CACHE.clear()
        d1 = dict(cuda_shear.PLAN_DISK)
        t_cache.DEFAULT_CACHE_DIR = cdir
        try:
            c = at.apply_operator(op2, x)
        finally:
            t_cache.DEFAULT_CACHE_DIR = default_dir
        check(cuda_shear.PLAN_DISK == {"built": d1["built"],
                                       "loaded": d1["loaded"] + 1}
              and torch.equal(c, a),
              f"{mode}: the route did not load its plan or differs")
        timing.update({f"{mode}_operator_build_s": build_s,
                       f"{mode}_operator_load_s": load_s,
                       f"{mode}_operator_cached_s": cached_s,
                       f"{mode}_plan_build_s": plan_build_s,
                       f"{mode}_plan_load_s": plan_load_s,
                       f"{mode}_operator_mb": (op.weights.nbytes
                                               + op.base.nbytes) / 1e6,
                       f"{mode}_plan_mb": os.path.getsize(
                           cuda_shear.plan_cache_path(op, cdir)) / 1e6})
        print(f"[41 caches] {card}, {RH}x{RW} at {ROT[3]} deg, {mode}: "
              f"operator build + save {build_s:.3f} s, mmap load "
              f"{load_s:.4f} s, load + validate {cached_s:.3f} s "
              f"({timing[f'{mode}_operator_mb']:.0f} MB); shear plan build + "
              f"save {plan_build_s:.3f} s, load {plan_load_s:.3f} s "
              f"({timing[f'{mode}_plan_mb']:.0f} MB); loaded plan equal field "
              "for field, route output bit-equal, the route loads it")
        del op, op2, op3, built, loaded, a, b, c
    cuda_shear._PLAN_CACHE.clear()
    print(json.dumps({"cache_timing": timing}))
    return timing


def regrid_timing(card, fields, tabs, qtabs, by, bx) -> dict:
    """Device (CUDA-graph replay) ms per batch of the 2-D kernel at config
    5 (f32 forced, bf16, u8 -> u8), at 0.25 degree and in its direct form
    (480-tap bands, 8 fields 480x480 -> 4x4), of the aligned route, the
    plain version, kernel 1 on the same tables, the dense einsum library
    calls (f32, bf16, 0.25 degree, the direct form's (4, 480) operators)
    and a copy of the f32 batch (207 MB, beyond the 50 MB L2); then the
    direct form at the 4K -> 16 x 9 thumbnail (8 frames, 242-tap bands),
    f32 and bf16, beside the einsum on its dense (9, 2160) and (16, 3840)
    operators."""
    n = 4                                    # distinct batches, 207 MB each
    xs = [fields() for _ in range(n)]
    xb = [x.to(torch.bfloat16) for x in xs]
    xu = [fields(torch.uint8) for _ in range(n)]
    wide = t_regrid.Band1D(start=np.zeros(4, np.int32),
                           weights=np.full((4, 480), 1 / 480), n_src=480,
                           n_dst=4)
    wtabs = regrid_tables(wide, wide)
    check(cuda_apply_2d.kernel_plan(*wtabs)["direct"],
          "480-tap bands must take the direct form")
    xw = [fields(shape=(RG_F, 480, 480)) for _ in range(n)]
    ttabs = folded_tables(operator((H, W), 0.0, ratio=THUMB))
    check(cuda_apply_2d.kernel_plan(*ttabs)["direct"],
          "thumbnail bands must take the direct form")
    xt = [fields(shape=(F, H, W)) for _ in range(n)]
    xtb = [x.to(torch.bfloat16) for x in xt]
    copy_dst = torch.empty_like(xs[0])
    dev = xs[0].device
    dense = {}
    for key, t, n_src in (("c5", tabs, RG_SRC), ("q", qtabs, RG_SRC),
                          ("direct", wtabs, (480, 480)),
                          ("thumb", ttabs, (H, W))):
        dense[key] = (torch.as_tensor(dense_band(t[0], t[1], n_src[0]),
                                      dtype=torch.float32, device=dev),
                      torch.as_tensor(dense_band(t[2], t[3], n_src[1]),
                                      dtype=torch.float32, device=dev))
    for key in ("c5", "thumb"):
        dense[f"{key}_bf16"] = tuple(m.to(torch.bfloat16) for m in dense[key])
    k2d = cuda_apply_2d.apply_separable_kernel_2d
    # the plain version's tables on the card already: an upload would be a
    # host copy inside the graph capture
    dtabs, dqtabs = (tuple(torch.as_tensor(a, device=dev) for a in t)
                     for t in (tabs, qtabs))
    fns = {
        "k2d_f32": (lambda x: k2d(x, *tabs), xs),
        "k2d_bf16": (lambda x: k2d(x, *tabs), xb),
        "k2d_u8": (lambda x: k2d(x, *tabs), xu),
        "k2d_q_f32": (lambda x: k2d(x, *qtabs), xs),
        "k2d_direct_f32": (lambda x: k2d(x, *wtabs), xw),
        "k2d_thumb_f32": (lambda x: k2d(x, *ttabs), xt),
        "k2d_thumb_bf16": (lambda x: k2d(x, *ttabs), xtb),
        "aligned_f32": (lambda x: at.apply_band_operators(
            x, by, bx, impl="aligned"), xs),
        "kernel1_f32": (lambda x: cuda_apply.apply_separable_kernel(x, *tabs),
                        xs),
        "plain_f32": (lambda x: cuda_apply_2d.apply_separable_2d_plain(
            x, *dtabs), xs),
        "plain_q_f32": (lambda x: cuda_apply_2d.apply_separable_2d_plain(
            x, *dqtabs), xs),
        "library_f32": (lambda x: torch.einsum("hy,fyx,wx->fhw", dense["c5"][0],
                                               x, dense["c5"][1]), xs),
        "library_q_f32": (lambda x: torch.einsum(
            "hy,fyx,wx->fhw", dense["q"][0], x, dense["q"][1]), xs),
        "library_bf16": (lambda x: torch.einsum(
            "hy,fyx,wx->fhw", dense["c5_bf16"][0], x, dense["c5_bf16"][1]),
            xb),
        "library_direct_f32": (lambda x: torch.einsum(
            "hy,fyx,wx->fhw", dense["direct"][0], x, dense["direct"][1]), xw),
        "library_thumb_f32": (lambda x: torch.einsum(
            "hy,fyx,wx->fhw", dense["thumb"][0], x, dense["thumb"][1]), xt),
        "library_thumb_bf16": (lambda x: torch.einsum(
            "hy,fyx,wx->fhw", dense["thumb_bf16"][0], x,
            dense["thumb_bf16"][1]), xtb),
        "copy": (lambda x: copy_dst.copy_(x), xs),
    }
    timing = {"card": card, "shape": [RG_F, *RG_SRC], "dst": list(RG_DST),
              "dst_0.25": list(RG_QDEG)}
    order = list(fns) + list(reversed(fns))          # two turns, mirrored
    for name in order:
        fn, inputs = fns[name]
        reps = 3 if name.startswith(("plain", "library")) else 20
        # the 480-tap cell's calls are shorter than a replay's host cost
        calls = 20 if name in ("k2d_direct_f32", "library_direct_f32") else 1
        ms = graph_ms(fn, inputs, reps, calls)
        timing.setdefault(f"{name}_device_ms", []).append(ms)
    timing["aligned_f32_eager_ms"] = eager_ms(fns["aligned_f32"][0], xs, 20)
    timing["k2d_f32_api_eager_ms"] = eager_ms(
        lambda x: at.apply_band_operators(x, by, bx), xs, 20)
    for key in [k for k in timing if k.endswith("_device_ms")]:
        timing[key] = min(timing[key])
    f32, bf = 4, 2
    px = RG_F * RG_SRC[0] * RG_SRC[1]
    n_c5 = RG_F * RG_DST[0] * RG_DST[1]
    n_q = RG_F * RG_QDEG[0] * RG_QDEG[1]
    ky, kx, qky, qkx = tabs[1].shape[1], tabs[3].shape[1], qtabs[1].shape[1], \
        qtabs[3].shape[1]

    def ops(dst, k_y, k_x):          # 2 operations per tap, y pass then x
        return 2 * RG_F * dst[0] * (RG_SRC[1] * k_y + dst[1] * k_x)

    work = {
        "k2d_f32": (px * f32 + n_c5 * f32 + table_bytes(*tabs),
                    ops(RG_DST, ky, kx)),
        "k2d_bf16": (px * bf + n_c5 * bf + table_bytes(*tabs),
                     ops(RG_DST, ky, kx)),
        "k2d_u8": (px + n_c5 + table_bytes(*tabs), ops(RG_DST, ky, kx)),
        "k2d_q_f32": (px * f32 + n_q * f32 + table_bytes(*qtabs),
                      ops(RG_QDEG, qky, qkx)),
        "k2d_direct_f32": (RG_F * (480 * 480 + 4 * 4) * f32
                           + table_bytes(*wtabs),
                           2 * RG_F * 4 * (480 * 480 + 4 * 480)),
    }
    tky, tkx = ttabs[1].shape[1], ttabs[3].shape[1]
    # the thumbnail reads only the rows and columns its windows cover
    rows, cols = covered(ttabs[0], tky, H), covered(ttabs[2], tkx, W)
    timing["thumb_read"] = [rows, cols]
    for key, size in (("k2d_thumb_f32", f32), ("k2d_thumb_bf16", bf)):
        work[key] = (F * (rows * cols + THUMB_DST[0] * THUMB_DST[1]) * size
                     + table_bytes(*ttabs),
                     2 * F * THUMB_DST[0] * (cols * tky + THUMB_DST[1] * tkx))
    work["aligned_f32"] = work["kernel1_f32"] = work["k2d_f32"]
    timing["bounds"] = {k: bound(*w) for k, w in work.items()}
    copy_bw = 2 * xs[0].nbytes / (timing["copy_device_ms"] * 1e-3)   # B/s
    timing["copy_gb_s"] = copy_bw / 1e9
    for k, (nbytes, _) in work.items():
        t = timing[f"{k}_device_ms"]
        timing[f"{k}_gb_s"] = nbytes / (t * 1e-3) / 1e9
        pixels = {"k2d_direct_f32": RG_F * 480 * 480, "k2d_thumb_f32":
                  F * H * W, "k2d_thumb_bf16": F * H * W}.get(k, px)
        timing[f"{k}_gpixel_s"] = pixels / (t * 1e-3) / 1e9
        timing[f"{k}_bytes"] = nbytes
        timing[f"{k}_copy_bound_ms"] = nbytes / copy_bw * 1e3
        timing[f"{k}_share_of_bound"] = timing["bounds"][k]["bound_ms"] / t
        timing[f"{k}_share_of_copy_bound"] = timing[f"{k}_copy_bound_ms"] / t
    t = timing
    for k, what in (("k2d_f32", "2-D kernel, config 5 f32"),
                    ("k2d_bf16", "2-D kernel, config 5 bf16"),
                    ("k2d_u8", "2-D kernel, config 5 u8 -> u8"),
                    ("k2d_q_f32", "2-D kernel, 0.25 deg f32"),
                    ("k2d_direct_f32", "2-D kernel, direct form, 480-tap "
                     "bands, 8x480x480 f32"),
                    ("k2d_thumb_f32", f"2-D kernel, direct form, {F}x{H}x{W} "
                     f"f32 -> {THUMB_DST} thumbnail, {tky}-tap bands, "
                     f"{rows}x{cols} source pixels read a frame"),
                    ("k2d_thumb_bf16", f"2-D kernel, direct form, {F}x{H}x{W}"
                     f" bf16 -> {THUMB_DST} thumbnail"),
                    ("aligned_f32", "aligned route, config 5 f32"),
                    ("kernel1_f32", "kernel 1 on the config-5 tables")):
        print(f"[30 regrid timing] {card}: {what}: "
              f"{t[f'{k}_device_ms']:.4f} ms per batch = "
              f"{t[f'{k}_gpixel_s']:.3f} Gpixel/s, {t[f'{k}_gb_s']:.1f} GB/s "
              f"of {t[f'{k}_bytes'] / 1e6:.1f} MB; bound "
              f"{t['bounds'][k]['bound_ms']:.4f} ms at 3.35 TB/s "
              f"({100 * t[f'{k}_share_of_bound']:.1f} % of it reached), "
              f"{t[f'{k}_copy_bound_ms']:.4f} ms at the measured copy rate "
              f"({100 * t[f'{k}_share_of_copy_bound']:.1f} %)")
    print(f"[30 regrid timing] plain f32 {t['plain_f32_device_ms']:.4f} ms "
          f"(0.25 deg {t['plain_q_f32_device_ms']:.4f}); library einsum f32 "
          f"{t['library_f32_device_ms']:.4f} ms (0.25 deg "
          f"{t['library_q_f32_device_ms']:.4f}, bf16 "
          f"{t['library_bf16_device_ms']:.4f}, the direct form's 480-tap "
          f"bands {t['library_direct_f32_device_ms']:.4f}, the thumbnail f32 "
          f"{t['library_thumb_f32_device_ms']:.4f}, bf16 "
          f"{t['library_thumb_bf16_device_ms']:.4f}); eager: aligned "
          f"{t['aligned_f32_eager_ms']:.4f} ms, kernel route "
          f"{t['k2d_f32_api_eager_ms']:.4f} ms; copy of the 207 MB f32 batch "
          f"{t['copy_gb_s']:.1f} GB/s")
    print(json.dumps({"regrid_timing": timing}))
    return timing


def filled(shape, dtype, device, byte: int = 0xFF) -> torch.Tensor:
    """A tensor whose every byte is ``byte`` (bf16 / f32: NaN)."""
    x = torch.empty(shape, dtype=dtype, device=device)
    x.view(torch.uint8).fill_(byte)
    return x


def copy_phases(make, card) -> dict:
    """Phase 42: the copy ceiling.  Returns the copy kernel's entry of the
    JSON summary."""
    dev = make.device
    # the entry point at each geometry, the counts read around it alone
    torch.cuda.synchronize()
    reset_launches()
    runs = {name: copy_ceiling.measure(Hc, Wc, ty, nf, dtype, dev)
            for name, Hc, Wc, ty, dtype, nf in COPY_GEOMS}
    torch.cuda.synchronize()
    launches = copy_ceiling.LAUNCHES
    want = len(COPY_GEOMS) * (copy_ceiling.K + 1)    # warm-up + capture
    check(launches == want, f"copy ceiling: {launches} copy launches, want "
          f"{want} (one warm-up and {copy_ceiling.K} captured per geometry)")
    check(cuda_apply.LAUNCHES == 0 and cuda_apply_2d.LAUNCHES == 0 and
          other_paths_idle(cuda_shear.LAUNCHES, cuda_shear3.LAUNCHES,
                           rot_experiments.LAUNCHES),
          "the copy ceiling launched another kernel")
    geoms, err = {}, 0.0
    for name, Hc, Wc, ty, dtype, nf in COPY_GEOMS:
        xs = [make(dtype, (nf, Hc, Wc)) for _ in range(copy_ceiling.K + 1)]
        rows = Hc // ty * ty
        buf = filled((nf, rows, Wc), dtype, dev)
        out = copy_ceiling.copy_rows_kernel(xs[0], ty, out=buf)
        torch.cuda.synchronize()
        plain = copy_ceiling.copy_rows_plain(xs[0], ty)
        check(out is buf and torch.equal(out, plain),
              f"copy {name}: kernel differs from its plain version")
        err = max(err, max_err(out, plain))
        # copy_ into a destination of its own per input, as the kernel and
        # the plain clone write a fresh output per call
        dst = {x.data_ptr(): torch.empty_like(plain) for x in xs}
        fns = {"kernel": lambda x: copy_ceiling.copy_rows_kernel(x, ty),
               "plain": lambda x: copy_ceiling.copy_rows_plain(x, ty),
               "library": lambda x: dst[x.data_ptr()].copy_(x[:, :rows])}
        ms = {}
        for fname in list(fns) + list(reversed(fns)):     # mirrored turns
            t = probe_harness.graph_ms(fns[fname], xs[1:], xs[:1])
            ms[fname] = min(ms.get(fname, t), t)
        nbytes = 2 * nf * rows * Wc * xs[0].element_size()
        b = bound(nbytes, 0)
        geoms[name] = {
            "shape": [nf, Hc, Wc], "tile_y": ty,
            "dtype": str(dtype).split(".")[-1], "entry_ms":
            runs[name]["ms_per_batch"], "kernel_ms": ms["kernel"],
            "plain_ms": ms["plain"], "library_ms": ms["library"], **b,
            "bytes": nbytes,
            "kernel_gb_s": nbytes / (ms["kernel"] * 1e-3) / 1e9,
            "library_gb_s": nbytes / (ms["library"] * 1e-3) / 1e9,
            "entry_gb_s_combined": runs[name]["gb_s_combined"]}
        g = geoms[name]
        print(f"[42 copy ceiling] {card}, {name} {nf}x{Hc}x{Wc} "
              f"{g['dtype']} tile_y {ty}: copy_rows {ms['kernel']:.4f} ms = "
              f"{g['kernel_gb_s']:.1f} GB/s combined (entry point "
              f"{g['entry_gb_s_combined']:.1f}), copy_ into a destination "
              f"per input {ms['library']:.4f} "
              f"ms = {g['library_gb_s']:.1f} GB/s, plain clone "
              f"{ms['plain']:.4f} ms; bound {b['bound_ms']:.4f} ms "
              f"({100 * b['bound_ms'] / ms['kernel']:.1f} % of it reached); "
              f"torch.equal to plain into a 0xFF-filled output")
        del xs, buf, out, plain, dst
    # ragged tiles, a row pitch that is no multiple of 16 bytes, u8
    x = make(torch.uint8, (3, 1001, 1023))
    buf = filled((3, 1000, 1023), torch.uint8, dev)
    check(torch.equal(copy_ceiling.copy_rows_kernel(x, 125, out=buf),
                      copy_ceiling.copy_rows_plain(x, 125)),
          "copy u8 (3, 1001, 1023) TY 125 differs from its plain version")
    # source and output 3 and 5 bytes past 16-byte boundaries: every span
    # takes the word-and-unit path, none the bulk copies
    for dtype, shape, ty in ((torch.uint8, (2, 1080, 1920), 120),
                             (torch.bfloat16, (3, 250, 1021), 64)):
        n = math.prod(shape)
        rows = shape[1] // ty * ty
        x = make(dtype, (n + 3,))[3:].view(shape)
        buf = filled((shape[0] * rows * shape[2] + 5,), dtype, dev)[5:]
        out = copy_ceiling.copy_rows_kernel(
            x, ty, out=buf.view(shape[0], rows, shape[2]))
        check(torch.equal(out, copy_ceiling.copy_rows_plain(x, ty)),
              f"copy {dtype} {shape} TY {ty} at element offsets 3 and 5 "
              "differs from its plain version")
    print("[42 copy ceiling] u8 (3, 1001, 1023), TY 125 (a ragged last "
          "tile, 1023-byte rows); u8 (2, 1080, 1920) TY 120 and bf16 (3, "
          "250, 1021) TY 64 with source and output at offsets that differ "
          "mod 16: torch.equal to plain")
    print(json.dumps({"copy_timing": {"card": card, "geometries": geoms}}))
    top = geoms["4k"]
    return {
        "name": "copy_rows",
        "route": "cuda",
        "source": "aainterp_torch/csrc/probes.cu",
        "replaces": "benchmarks/copy_ceiling.py:32,"
                    "benchmarks/rgb1024_experiments.py:67",
        "launches": launches,
        "max_abs_err": err,
        "ms": top["kernel_ms"],
        "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"],
        # torch's copy_ of the same rows
        "library_ms": top["library_ms"],
        "geometries": {k: {f: v[f] for f in ("kernel_ms", "plain_ms",
                                             "library_ms", "bound_ms")}
                       for k, v in geoms.items()},
    }


def noweight_selectors(plan, dtype, device):
    """(R (Hd, TH), C (Wd, TW)) in ``dtype``: R[dy, r] counts the taps a
    with clamp(ry0[dy] + a) = r on the live rectangle's rows (0 on the
    others), C the same for its columns and cx0, so that noweight's
    function is ``R @ T[f] @ C^T``, one einsum: JAX's own one-hot selector
    products (benchmarks/rot_experiments.py:166-172) as a library call."""
    span = rot_experiments.noweight_span(plan)
    live_r = span[:, 1] > span[:, 0]
    live_c = np.zeros(plan.Wd, bool)
    if live_r.any():
        lo, hi = span[live_r][0]
        live_c[lo:hi] = True
    sel_r = np.zeros((plan.Hd, plan.TH), np.float32)
    sel_c = np.zeros((plan.Wd, plan.TW), np.float32)
    for a in range(plan.Ka):
        np.add.at(sel_r, (np.arange(plan.Hd),
                          np.clip(plan.ry0 + a, 0, plan.TH - 1)), 1)
    for b in range(plan.Kb):
        np.add.at(sel_c, (np.arange(plan.Wd),
                          np.clip(plan.cx0 + b, 0, plan.TW - 1)), 1)
    sel_r[~live_r] = 0
    sel_c[~live_c] = 0
    return (torch.from_numpy(sel_r).to(device, dtype),
            torch.from_numpy(sel_c).to(device, dtype))


def contract_probe_phases(make, card) -> list:
    """Phases 43-44: the contraction's probe modes against their plain
    versions, then the rotated flagship's decomposition through
    rot_experiments' entry points.  Returns the probes' entries of the
    JSON summary."""
    dev = make.device

    # ---- 43. every probe mode against its plain version ----------------------
    err = {m: 0.0 for m in PROBE_MODES}
    # to plain, throughout
    bit_equal = {m: True for m in SHARE_MODES + rot_experiments.NOWEIGHT}
    geoms = {}
    for angle in PROBE_ANGLES:
        _, _, kp = rot_experiments._plan((RH, RW), angle)
        for dtype in (torch.bfloat16, torch.float32):
            tiles = kp.contract_plan(torch.empty((), dtype=dtype).element_size())
            check(tiles is not None, f"no contraction tiles at {angle} deg")
            nwt = rot_experiments.noweight_tiles(
                kp, torch.empty((), dtype=dtype).element_size())
            geoms[f"{angle}_{str(dtype).split('.')[-1]}"] = {
                "TW": kp.TW, "tiles": len(tiles.win),
                "live": int((tiles.win[:, 2] > 0).sum()),
                "shared_tile": rot_experiments.shared_tile(tiles),
                "noweight_live": int((nwt.win[:, 2] > 0).sum()),
                "noweight_smem": nwt.smem(
                    torch.empty((), dtype=dtype).element_size())}
            for nf in PROBE_FRAMES:
                t = make(dtype, (nf, kp.TH, kp.TW))
                prod = cuda_shear.contract_kernel(t, kp)
                torch.cuda.synchronize()
                shear_before = dict(cuda_shear.LAUNCHES)
                got_nw = {}
                for mode in PROBE_MODES:
                    before = rot_experiments.LAUNCHES[mode]
                    buf = torch.full((nf, kp.Hd, kp.Wd), float("nan"),
                                     dtype=dtype, device=dev)
                    got = rot_experiments.contract_probe_kernel(t, kp, mode,
                                                                out=buf)
                    torch.cuda.synchronize()
                    check(got is buf and rot_experiments.LAUNCHES[mode] ==
                          before + 1, f"{mode}: not one launch per call")
                    what = f"{mode} {dtype} F {nf} at {angle} deg"
                    if mode == "pipelined":
                        check(torch.equal(got, prod), f"{what} is not "
                              "bit-equal to the production contraction")
                        continue
                    ref = rot_experiments.contract_probe_plain(
                        t, kp, mode, out_dtype=torch.float32)
                    if mode in rot_experiments.NOWEIGHT:
                        # JAX's zeros off the live rectangle; each tap one
                        # f32 add in the plain version's order
                        e = max_err(got, ref.to(dtype))
                        check(e == 0 and torch.equal(got, ref.to(dtype)),
                              f"{what} is not bit-equal to its plain "
                              f"version (max {e})")
                        err[mode] = max(err[mode], e)
                        got_nw[mode] = got.clone()
                        continue
                    if mode in bit_equal:
                        bit_equal[mode] &= torch.equal(got, ref.to(dtype))
                    if dtype == torch.bfloat16:
                        err[mode] = max(err[mode], within_bf16_ulp(
                            got, ref, f"{what} vs plain"))
                    else:
                        e = max_err(got, ref)
                        check(e <= 1e-6, f"{what}: err {e} > 1e-6")
                check(torch.equal(got_nw["noweight"],
                                  got_nw["noweight_direct"]),
                      f"noweight {dtype} F {nf} at {angle} deg: the tiled "
                      "form differs from its first form")
                check(dict(cuda_shear.LAUNCHES) == shear_before,
                      f"the probes moved the production counts: "
                      f"{dict(cuda_shear.LAUNCHES)} (was {shear_before})")
                del t, prod, buf, got, got_nw
    spec, op, kp = rot_experiments._plan((RH, RW), ROT[3])
    check((spec.dst_shape, op.window, kp.Ka, kp.Kb) == (ROT_DST, 6, 5, 5),
          f"probe plan: dst {spec.dst_shape}, K {op.window}, Ka x Kb "
          f"{kp.Ka}x{kp.Kb}")
    print(f"[43 contraction probes] {RH}x{RW} at "
          + " and ".join(f"{a} deg" for a in PROBE_ANGLES)
          + f" (tile tables {geoms}), bf16 and f32, F "
          + " and ".join(str(n) for n in PROBE_FRAMES)
          + ", into NaN-filled outputs: noweight (tiled, on the live "
          "rectangle's table) and noweight_direct torch.equal to plain (JAX's "
          "zeros off the rectangle) and to each other; the tiled share modes "
          "within one bf16 ulp (bf16; f32 atol 1e-6) of plain, max bf16 "
          "|diff| "
          + ", ".join(f"{m} {err[m]:.3e}" for m in SHARE_MODES)
          + "; bit-equal to plain: "
          + ", ".join(f"{m} {v}" for m, v in bit_equal.items())
          + "; pipelined bit-equal to the production contraction; one "
          "launch per call, the production counts unmoved")

    # ---- 44. the decomposition through the entry points --------------------
    torch.cuda.synchronize()
    reset_launches()
    runs = {exp: rot_experiments.EXPS[exp](F, torch.bfloat16, dev,
                                           (RH, RW), ROT[3])
            for exp in PROBE_EXPS}
    torch.cuda.synchronize()
    launches = dict(rot_experiments.LAUNCHES)
    check(launches == {m: 5 for m in PROBE_MODES},
          f"decomposition: probe launches {launches}, want 5 each (one "
          "warm-up and 4 captured)")
    check(cuda_apply.LAUNCHES == 0 and cuda_apply_2d.LAUNCHES == 0 and
          copy_ceiling.LAUNCHES == 0 and other_paths_idle(
              cuda_shear3.LAUNCHES), "the decomposition launched a kernel "
          "of another path")
    # the plain versions on the same kind of inputs (seconds each: 2 reps)
    ts = [make(torch.bfloat16, (F, kp.TH, kp.TW)) for _ in range(5)]
    plain_ms = {m: probe_harness.graph_ms(
        lambda t, m=m: rot_experiments.contract_probe_plain(t, kp, m),
        ts[1:], ts[:1], reps=2) for m in PROBE_MODES
        if m != "noweight_direct"}
    # noweight's first form computes its function: one plain version
    plain_ms["noweight_direct"] = plain_ms["noweight"]
    # noweight's library call: R @ T @ C^T in T's dtype (its product R @ T
    # is rounded to bf16 before the second, so within two bf16 ulps of the
    # plain version's f32 sums, not one)
    sel_r, sel_c = noweight_selectors(kp, torch.bfloat16, dev)
    lib = torch.einsum("ya,fab,xb->fyx", sel_r, ts[0], sel_c)
    ref = rot_experiments.contract_probe_plain(ts[0], kp, "noweight",
                                               out_dtype=torch.float32)
    lib_err = max_err(lib, ref)
    bad = int(((lib.double() - ref.double()).abs()
               > 2 * bf16_ulp(ref)).sum())
    check(bad == 0, f"noweight's library einsum: {bad} elements beyond two "
          f"bf16 ulps of plain (max |diff| {lib_err:.3e})")
    library_ms = {m: probe_harness.graph_ms(
        lambda t: torch.einsum("ya,fab,xb->fyx", sel_r, t, sel_c),
        ts[1:], ts[:1], reps=2) for m in ("noweight",)}
    library_ms["noweight_direct"] = library_ms["noweight"]
    del ts, lib, ref, sel_r, sel_c
    timing = {"card": card, "shape": [F, RH, RW], "dtype": "bfloat16",
              "angle": ROT[3], "T": [kp.TH, kp.TW], "exps": {}}
    for exp, r in runs.items():
        nbytes, ops = rot_experiments.traffic(kp, F, 2, exp)
        timing["exps"][exp] = {"ms": r["ms_per_batch"],
                               "gpixel_s": r["gpixel_s"], "bytes": nbytes,
                               **bound(nbytes, ops)}
        if exp == "shears":
            for form in ("vshear", "hshear"):
                nb, _ = rot_experiments.traffic(kp, F, 2, form)
                timing["exps"][form] = {"ms": r[f"{form}_ms"], "bytes": nb,
                                        **bound(nb, 0)}
    ex = timing["exps"]
    c, cm = ex["contract"]["ms"], ex["contract_masked"]["ms"]
    # what each probe removes, in ms of the contraction it changes: the
    # unmasked direct form (noweight_direct, the direct split), the route's
    # tiled kernel on the live rectangle (noweight, the tiled split), or
    # the route's tiled masked contraction (the others, tiled too)
    timing["split_ms"] = {
        "dead_pixel_skip": c - cm,
        "weights_load_and_multiply": c - ex["noweight_direct"]["ms"],
        "weights_load_and_multiply_tiled":
            ex["contract_tiled_unmasked"]["ms"] - ex["noweight"]["ms"],
        "T_traffic": cm - ex["tshare"]["ms"],
        "weight_traffic": cm - ex["wshare"]["ms"],
        "both_streams": cm - ex["bothshare"]["ms"],
        "issue_order": cm - ex["pipelined"]["ms"]}
    timing["plain_ms"] = plain_ms
    timing["library_ms"] = {**library_ms, "library_max_abs_err": lib_err}
    print(f"[44 decomposition] {card}, {F}x{RH}x{RW} bf16 at {ROT[3]} deg, "
          "device ms per batch (CUDA-graph replays, best of 2) / bound ms: "
          + ", ".join(f"{e} {v['ms']:.4f} / {v['bound_ms']:.4f}"
                      for e, v in ex.items())
          + "; the contraction's split (contract, unmasked, minus "
          "noweight_direct; contract_tiled_unmasked, the route's tiled "
          "kernel on the live rectangle, minus noweight; contract_masked, "
          "the route's tiled kernel, minus each share and pipelined "
          "probe): "
          + ", ".join(f"{k} {v:.4f}" for k, v in timing["split_ms"].items())
          + f"; noweight's library call (einsum R @ T @ C^T, bf16) "
          f"{library_ms['noweight']:.4f} ms, max |diff| to plain "
          f"{lib_err:.3e} (within two bf16 ulps)")
    print(json.dumps({"probe_timing": timing}))

    def row(name, line, modes):
        m0 = modes[0]
        return {
            "name": name,
            "route": "cuda",
            "source": "aainterp_torch/csrc/probes.cu",
            "replaces": f"benchmarks/rot_experiments.py:{line}",
            "launches": sum(launches[m] for m in modes),
            "max_abs_err": max(err[m] for m in modes),
            "ms": ex[m0]["ms"],
            "plain_ms": plain_ms[m0],
            "bound_ms": ex[m0]["bound_ms"],
            "bound_by": ex[m0]["bound_by"],
            # noweight: one einsum of selectors; the weighted modes: no
            # single PyTorch call contracts windows with per-pixel weights
            "library_ms": library_ms.get(m0),
            "modes": {m: {"launches": launches[m], "ms": ex[m]["ms"],
                          "plain_ms": plain_ms[m], "max_abs_err": err[m],
                          "library_ms": library_ms.get(m),
                          "bound_ms": ex[m]["bound_ms"],
                          # the share modes' (pipelined: to production)
                          "bit_equal_to_plain": bit_equal.get(m)}
                      for m in modes},
        }

    return [row("contract_noweight", "130", ("noweight", "noweight_direct")),
            row("contract_share", "247", SHARE_MODES),
            row("contract_pipelined", "392", ("pipelined",))]


def direct_plan(plan):
    """``plan`` with its contraction sent to the direct form (no tile
    table at either element size), sharing its device tables."""
    return dataclasses.replace(plan, tiles={"contract2": None,
                                            "contract4": None})


def contract_tile_stats(p, elem: int) -> dict:
    """The tiled contraction's table for frames of ``elem`` bytes: tiles,
    dead share, largest window, shared bytes, and the blocks an SM that
    the SM's 228 KB of shared memory allow (1 KB reserved a block; the
    thread limit allows 8 blocks of 256)."""
    t = p.contract_plan(elem)
    win = t.win[t.win[:, 2] > 0]
    return {"TYd": t.TYd, "TXd": t.TXd, "tiles": len(t.win),
            "dead": float((t.win[:, 2] == 0).mean()),
            "rows": int(win[:, 2].max()), "cols": int(win[:, 3].max()),
            "cells": t.cells, "smem": t.smem(elem),
            "blocks_per_sm": min(8, 233472 // (t.smem(elem) + 1024))}


def masked_contract_phase(make, card, op, plan, cplan) -> list:
    """Phase 45: the route's masked contraction, tiled, against the
    unmasked instance, the masked plain version and its direct form; its
    tile tables, dead shares and time beside the direct form's.  Returns
    the unmasked instance's and the direct form's entries of the JSON
    summary."""
    dev = make.device
    # the route launches the tiled masked form, 2 launches per request,
    # never the direct form
    reqs = [make(torch.bfloat16, (F, RH, RW)) for _ in range(2)]
    torch.cuda.synchronize()
    reset_launches()
    for x in reqs:
        at.area_average_interpolate(x, *ROT, operator=op)
    torch.cuda.synchronize()
    _launched(_route(len(reqs)), "masked route", t_api.SHEAR_PLAN_FALLBACKS)
    del reqs
    err = 0.0
    stats = {}
    for name, p in (("flagship", plan), ("compat", cplan)):
        live = cuda_shear.live_mask(p, dev)
        dp = direct_plan(p)
        for dtype in (torch.bfloat16, torch.float32):
            es = torch.empty((), dtype=dtype).element_size()
            stats[f"{name}_{str(dtype).split('.')[-1]}"] = st = \
                contract_tile_stats(p, es)
            t = make(dtype, (F, p.TH, p.TW))
            before = dict(cuda_shear.LAUNCHES)
            got = cuda_shear.contract_kernel(
                t, p, out=filled((F, p.Hd, p.Wd), dtype, dev))
            direct = cuda_shear.contract_kernel(
                t, dp, out=filled((F, p.Hd, p.Wd), dtype, dev))
            un = cuda_shear.contract_unmasked_kernel(
                t, p, out=filled((F, p.Hd, p.Wd), dtype, dev))
            torch.cuda.synchronize()
            moved = {k: cuda_shear.LAUNCHES[k] - before[k] for k in before}
            check(moved == {**{k: 0 for k in SHEAR_KERNELS}, "contract": 1,
                            "contract_direct": 1, "contract_unmasked": 1},
                  f"masked {name} {dtype}: launches {moved}")
            check(torch.equal(got, un), f"masked {name} {dtype}: differs "
                  "from the unmasked instance on finite T")
            check(torch.equal(got, direct), f"masked {name} {dtype}: "
                  "differs from the direct form")
            check(torch.equal(got, cuda_shear.contract_plain(t, p,
                                                             fused=True)),
                  f"masked {name} {dtype}: differs from its plain version")
            err = max(err, max_err(got, cuda_shear.contract_plain(
                t, p, out_dtype=torch.float32, fused=True)))
            t.fill_(float("nan"))
            nan = cuda_shear.contract_kernel(t, p)
            torch.cuda.synchronize()
            check(bool((nan[:, ~live] == 0).all()), f"masked {name} "
                  f"{dtype}: a pixel outside its row's span is not 0 on NaN T")
            del t, got, direct, un, nan
            print(f"[45 masked contraction] {name} {dtype}: tiles "
                  f"{st['TYd']}x{st['TXd']}, {st['tiles']} of them, "
                  f"{100 * st['dead']:.1f} % dead, windows up to "
                  f"{st['rows']}x{st['cols']} T cells ({st['cells']} cells "
                  f"the largest), {st['smem']} bytes of shared memory, "
                  f"{st['blocks_per_sm']} blocks an SM by shared memory")
        print(f"[45 masked contraction] {name} ({p.Hd}x{p.Wd}, Ka x Kb "
              f"{p.Ka}x{p.Kb}), bf16 and f32 into NaN-filled outputs: the "
              "tiled kernel torch.equal to the unmasked instance, to the "
              "direct form and to the masked plain version (fused "
              "multiply-adds); on all-NaN T every pixel outside its row's "
              "span is 0")
    # dead shares: pixels with all-zero weights, outside their row's span,
    # and the direct form's warps (32 columns) and blocks (256) wholly
    # outside
    contract_threads = 256                  # contract.cuh's kThreads
    live_w = (plan.w2 != 0).any(axis=0)
    cols = np.arange(plan.Wd)[None, :]
    inside = (cols >= plan.span[:, :1]) & (cols < plan.span[:, 1:])
    def outside(width):        # groups of `width` columns from column 0
        pad = np.zeros((plan.Hd, -(-plan.Wd // width) * width), bool)
        pad[:, :plan.Wd] = inside
        return float(1 - pad.reshape(plan.Hd, -1, width).any(axis=2).mean())

    shares = {
        "pixels_all_zero_weights": float(1 - live_w.mean()),
        "pixels_outside_spans": float(1 - inside.mean()),
        "warps_outside": outside(32),
        "blocks_outside": outside(contract_threads),
        "tiles_dead": stats["flagship_bfloat16"]["dead"]}
    # times: the tiled kernel, its direct form, the unmasked instance and
    # the route, CUDA-graph replays on distinct inputs, mirrored turns
    ts = [make(torch.bfloat16, (F, plan.TH, plan.TW)) for _ in range(5)]
    qs = [make(torch.bfloat16, (F, RH, RW)) for _ in range(5)]
    dplan = direct_plan(plan)
    fns = {"masked": (lambda t: cuda_shear.contract_kernel(t, plan), ts),
           "direct": (lambda t: cuda_shear.contract_kernel(t, dplan), ts),
           "unmasked": (lambda t: cuda_shear.contract_unmasked_kernel(
               t, plan), ts),
           "route": (lambda q: cuda_shear.apply_ell_shear_kernel(q, plan),
                     qs)}
    ms = {}
    for name in list(fns) + list(reversed(fns)):
        fn, xs = fns[name]
        t = probe_harness.graph_ms(fn, xs[1:], xs[:1])
        ms[name] = min(ms.get(name, t), t)
    plain_ms = {m: probe_harness.graph_ms(
        lambda t, m=m: cuda_shear.contract_plain(t, plan, masked=m),
        ts[1:3], ts[:1], reps=2) for m in (False, True)}
    del ts, qs
    bounds = {m: bound(*rot_experiments.traffic(plan, F, 2, e))
              for m, e in (("masked", "contract_masked"),
                           ("unmasked", "contract"))}
    timing = {"card": card, "shape": [F, RH, RW], "dtype": "bfloat16",
              "dead_shares": shares, "tiles": stats, "ms": ms,
              "bounds": bounds, "unmasked_plain_ms": plain_ms[False],
              "masked_plain_ms": plain_ms[True]}
    print(f"[45 masked contraction] {card}, {F}x{plan.TH}x{plan.TW} bf16 -> "
          f"{F}x{plan.Hd}x{plan.Wd}, device ms per batch (CUDA-graph "
          f"replays, mirrored turns): masked, tiled {ms['masked']:.4f}, "
          f"direct form {ms['direct']:.4f} (bound "
          f"{bounds['masked']['bound_ms']:.4f}), unmasked "
          f"{ms['unmasked']:.4f} (bound {bounds['unmasked']['bound_ms']:.4f})"
          f"; the exact route {ms['route']:.4f} ms; dead shares: "
          + ", ".join(f"{k} {100 * v:.1f} %" for k, v in shares.items()))
    print(json.dumps({"masked_contract_timing": timing}))
    # no single PyTorch call contracts windows with per-pixel weights
    return [{
        "name": "contract_unmasked",
        "route": "cuda",
        "source": "aainterp_torch/csrc/ell_shear.cu",
        "replaces": "aainterp/ops/pallas_shear.py:164",
        "launches": 0,           # the route launches the masked form only
        "max_abs_err": err,
        "ms": ms["unmasked"],
        "plain_ms": plain_ms[False],
        **bounds["unmasked"],
        "library_ms": None,
    }, {
        "name": "contract_direct",
        "route": "cuda",
        "source": "aainterp_torch/csrc/ell_shear.cu",
        "replaces": "aainterp/ops/pallas_shear.py:164",
        "launches": 0,           # the route's plans all take the tiled form
        "max_abs_err": err,
        "ms": ms["direct"],
        "plain_ms": plain_ms[True],
        **bounds["masked"],
        "library_ms": None,
    }]


def copy_fill_phase(copy_row, card) -> None:
    """Phase 46: the copy's persistent grid at the four geometries of
    phase 42, and its rate beside copy_'s (phase 42's measurements)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, Hc, Wc, ty, dtype, nf in COPY_GEOMS:
        g = copy_row["geometries"][name]
        es = torch.empty((), dtype=dtype).element_size()
        pieces = copy_ceiling.pieces(nf, Hc, Wc, ty, es)
        blocks = copy_ceiling.grid_blocks(nf, Hc, Wc, ty, es, sms)
        nbytes = 2 * nf * (Hc // ty * ty) * Wc * es
        print(f"[46 copy fill] {card}, {name} {nf}x{Hc}x{Wc} tile_y {ty}: "
              f"{nf * (Hc // ty)} row tiles, {pieces} pieces of "
              f"{copy_ceiling.PIECE_BYTES} bytes on {blocks} blocks "
              f"({blocks / sms:.2f} an SM of {sms}); copy_rows "
              f"{nbytes / (g['kernel_ms'] * 1e-3) / 1e9:.1f} GB/s, copy_ "
              f"{nbytes / (g['library_ms'] * 1e-3) / 1e9:.1f} GB/s")
        # the persistent grid: BLOCKS_PER_SM blocks on every SM, each with
        # at least one piece
        check(blocks == copy_ceiling.BLOCKS_PER_SM * sms <= pieces,
              f"copy {name}: {blocks} blocks for {pieces} pieces, not "
              f"{copy_ceiling.BLOCKS_PER_SM} on each of {sms} SMs")


def column_picker(cols: torch.Tensor, width: int, dtype) -> torch.Tensor:
    """(width, len(cols)) 0/1 in ``dtype``: column j picks column cols[j],
    so that ``x @ sel`` is ``x[..., cols]`` as one library product."""
    sel = torch.zeros((width, cols.shape[0]), dtype=dtype, device=cols.device)
    sel[cols, torch.arange(cols.shape[0], device=cols.device)] = 1
    return sel


def band_probe_phase(make, card) -> list:
    """Phase 47: kernel 1's probe modes at the 4K flagship against their
    plain versions (the stage ring's also at STAGE_ODD_SHAPE), then through
    the entry points' experiments, beside the production kernel and the
    first forms of stage and stagey (kernel 1's split is read from those);
    one flagship_probe_timing line.  Returns the probes' entries of the
    JSON summary."""
    dev = make.device
    tables = band_probes.flagship_tables((H, W))
    plan = band_probes._plan(tables)
    check((plan["TY"], plan["TX"], plan["SY"], plan["SX"]) ==
          (8, 240, 18, 482), f"kernel 1's flagship plan {plan}")
    err = {}
    grids = {}      # (dtype, mode) -> the walk's and the ring's grids,
    #                 u8convert's buffers
    for dtype, (mod, _) in BAND_EXPS.items():
        modes = band_probes.modes_of(dtype)
        x = make(dtype)
        prod = cuda_apply.apply_separable_kernel(x, *tables)
        for mode in modes:
            before = band_probes.LAUNCHES[mode]
            buf = filled(tuple(prod.shape), dtype, dev)
            got = mod.band_probe_kernel(x, tables, mode, out=buf)
            torch.cuda.synchronize()
            check(got is buf and band_probes.LAUNCHES[mode] == before + 1,
                  f"{mode}: not one launch per call")
            plain = mod.band_probe_plain(x, tables, mode)
            e = max_err(got, plain)
            err[mode] = max(err.get(mode, 0.0), e)
            check(torch.equal(got, plain), f"{mode} {dtype} differs from "
                  f"its plain version (max {e})")
            if mode not in STAGE_CUTS:
                check(torch.equal(got, prod), f"{mode} {dtype} is not "
                      "production's output")
            del got, plain, buf
        check(torch.equal(prod, band_probes.band_probe_plain(
            x, tables, "u8words" if dtype == torch.uint8 else "walk2")),
              f"kernel 1 {dtype} differs from its exact plain version")
        print(f"[47 kernel-1 probes] {F}x{H}x{W} {str(dtype)[6:]} into "
              f"0xFF-filled outputs: {', '.join(modes)} torch.equal to their "
              "plain versions (the production-output modes also to kernel 1,"
              " which equals its exact plain version)")
        for mode in modes:
            if mode.startswith("walk"):
                grids[(str(dtype)[6:], mode)] = band_probes.walk_grid(
                    x, tables, mode)
            elif mode in band_probes.RING_MODES:
                grids[(str(dtype)[6:], mode)] = band_probes.stage_grid(
                    x, tables, mode)
            elif mode.startswith("u8convert"):
                n = int(mode[-1])
                grids[("uint8", mode)] = {
                    "buffer_dtype": "bfloat16", "buffers": min(n, 2),
                    "row_bytes": band_probes.convert_pitch(plan["SX"], n),
                    "smem": band_probes.smem_bytes(plan, mode, W, W // 2, 4,
                                                   1)}
        print(f"[47 kernel-1 probes] {str(dtype)[6:]} launch geometry: "
              + "; ".join(
                  f"{m} grid {g['grid']} ({g['blocks_per_sm']} blocks an SM "
                  f"x {g['sms']} SMs, {g['tiles']} tiles"
                  + (f", a ring of {g['slots']} windows" if "slots" in g
                     else "")
                  + f"), {g['smem']} bytes"
                  f" of shared memory a block, {g['registers']} registers"
                  if "grid" in g else
                  f"{m} chunk buffers {g['buffers']} x {g['row_bytes']} bytes"
                  f" a row, {g['buffer_dtype']}, {g['smem']} bytes a block"
                  for (dt, m), g in grids.items() if dt == str(dtype)[6:]))
        del x, prod
    stage_odd_check(make, dev)
    # the entry points: every experiment, the counts read around them
    torch.cuda.synchronize()
    reset_launches()
    runs = {}
    for dtype, (mod, exps) in BAND_EXPS.items():
        for exp in exps:
            runs[(str(dtype)[6:], exp)] = mod.EXPS[exp](F, dtype, dev)
    torch.cuda.synchronize()
    want = {m: 0 for m in band_probes.MODES}
    for (_, exp), r in runs.items():
        if r["mode"] != "full":
            want[r["mode"]] += 9                  # warm-up + 8 captured
    check(dict(band_probes.LAUNCHES) == want, f"kernel-1 probes launched "
          f"{dict(band_probes.LAUNCHES)}, want {want}")
    check(cuda_apply.LAUNCHES == 9 * sum(r["mode"] == "full"
                                         for r in runs.values())
          and cuda_apply_2d.LAUNCHES == 0 and copy_ceiling.LAUNCHES == 0
          and other_paths_idle(cuda_shear.LAUNCHES, cuda_shear3.LAUNCHES,
                               rot_experiments.LAUNCHES),
          "the kernel-1 probes launched a kernel of another path")
    launches = dict(band_probes.LAUNCHES)
    # the first forms of stage and stagey, timed beside the ring (after the
    # experiments' counts: no experiment launches them)
    for dtype in BAND_EXPS:
        direct = dict(DIRECT_EXPS, **(U8_DIRECT_EXPS if dtype == torch.uint8
                                      else {}))
        for m, exp in direct.items():
            runs[(str(dtype)[6:], f"{exp}_direct")] = band_probes.run_exp(
                f"{exp}_direct", m, F, dtype, dev)
    # plain versions and library calls on the same kind of inputs
    plain_ms, library_ms = {}, {}
    ys, yw, xs, xw = (torch.as_tensor(t, device=dev) for t in tables)
    rows = ys.long().clamp(0, H - 1)[:, None]
    cols = xs.long().clamp(0, W - 1)[None, :]
    op0 = operator((H, W), 0.0)
    dense = {dt: tuple(torch.as_tensor(m, dtype=dt, device=dev)
                       for m in op0.dense())
             for dt in (torch.bfloat16, torch.float32)}
    for dtype in BAND_EXPS:
        xb = [make(dtype) for _ in range(3)]
        modes = (band_probes.U8_MODES if dtype == torch.uint8
                 else band_probes.FLOAT_MODES)
        for mode in modes:
            plain_ms[(str(dtype)[6:], mode)] = probe_harness.graph_ms(
                lambda x, m=mode: band_probes.band_probe_plain(x, tables, m),
                xb[1:], xb[:1], reps=2)
        # one call for the first tap's pixels (stage); dense einsums for the
        # y pass at those columns (stagey) and for production's output in
        # bf16 / f32 (none for u8 in, u8 out)
        library_ms[(str(dtype)[6:], "stage")] = probe_harness.graph_ms(
            lambda x: x[:, rows, cols], xb[1:], xb[:1])
        if dtype != torch.uint8:
            wy0, wx0 = dense[dtype]
            sel = column_picker(cols[0], W, dtype)
            library_ms[(str(dtype)[6:], "stagey")] = probe_harness.graph_ms(
                lambda x: torch.einsum("hy,fyx,xw->fhw", wy0, x, sel),
                xb[1:], xb[:1], reps=3)
            library_ms[(str(dtype)[6:], "full")] = probe_harness.graph_ms(
                lambda x: torch.einsum("hy,fyx,wx->fhw", wy0, x, wx0),
                xb[1:], xb[:1], reps=3)
        del xb
    timing = {"card": card, "shape": [F, H, W], "plan": {
        k: plan[k] for k in ("TY", "TX", "SY", "SX")}, "exps": {},
        "geometry": {f"{dt}_{m}": g for (dt, m), g in grids.items()}}
    for (dt, exp), r in runs.items():
        key = (dt, r["mode"].removesuffix("_direct"))
        timing["exps"][f"{dt}_{exp}"] = {
            "mode": r["mode"], "ms": r["ms_per_batch"],
            "gpixel_s": r["gpixel_s"], "bytes": r["bytes"],
            "operations": r["operations"],
            **bound(r["bytes"], r["operations"]),
            "plain_ms": plain_ms.get(key),
            "library_ms": library_ms.get(
                key, library_ms.get((dt, "full"))
                if r["mode"] not in STAGE_CUTS else None)}
    ex = timing["exps"]
    by_mode = {(v["mode"], k.split("_")[0]): v for k, v in ex.items()}
    for dt in ("bfloat16", "float32", "uint8"):
        full = ex[f"{dt}_full"]["ms"]
        print(f"[47 kernel-1 probes] {card}, {F}x{H}x{W} {dt}, device ms per"
              " batch (CUDA-graph replays, best of 2) / bound ms: "
              + ", ".join(f"{k[len(dt) + 1:]} {v['ms']:.4f} / "
                          f"{v['bound_ms']:.4f}"
                          for k, v in ex.items() if k.startswith(dt))
              + f"; kernel 1 {full:.4f}")
    # kernel 1's split, read from the first forms (production's layout):
    # staging and stores, what the y pass adds, what the x pass adds
    for dt in ("bfloat16", "float32", "uint8"):
        full = ex[f"{dt}_full"]["ms"]
        st = by_mode[("stage_direct", dt)]["ms"]
        sty = by_mode[("stagey_direct", dt)]["ms"]
        timing[f"split_{dt}"] = {"staging_stores": st / full,
                                 "y_pass": (sty - st) / full,
                                 "x_pass": (full - sty) / full}
        print(f"[47 kernel-1 probes] {card}, kernel 1's split {dt} from the "
              f"first forms (kernel 1 {full:.4f} ms): staging and stores "
              f"{100 * st / full:.1f} % (stage_direct {st:.4f}), y pass "
              f"{100 * (sty - st) / full:.1f} % (stagey_direct {sty:.4f}), x "
              f"pass {100 * (full - sty) / full:.1f} %; the stage ring: stage "
              f"{by_mode[('stage', dt)]['ms']:.4f}, stagey "
              f"{by_mode[('stagey', dt)]['ms']:.4f} ms"
              + "".join(f", {m} {by_mode[(m, dt)]['ms']:.4f} (first form "
                        f"{by_mode[(m + '_direct', dt)]['ms']:.4f})"
                        for m in ("u8words", "xpair") if dt == "uint8"))
    print(json.dumps({"flagship_probe_timing": timing}))

    def row(mode, dt):
        r = by_mode[(mode, dt)]
        return {
            "name": f"band_{mode}",
            "route": "cuda",
            "source": "aainterp_torch/csrc/band_probes.cu",
            "replaces": BAND_REPLACES[mode],
            "launches": launches[mode],
            "max_abs_err": err[mode],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "dtype": dt,
        }

    return ([row(m, "bfloat16") for m in band_probes.modes_of(torch.bfloat16)]
            + [row(m, "uint8") for m in band_probes.modes_of(torch.uint8)
               if m not in STAGE_CUTS])


def stage_odd_check(make, dev) -> None:
    """Phase 47: the stage ring (stage, stagey; u8words and xpair in u8)
    and its first forms at STAGE_ODD_SHAPE, whose source and dst rows are
    not 16-byte aligned in any dtype (nor 4-byte aligned: u8words' and
    xpair's funnel-shift reads and byte stores), torch.equal to their plain
    versions into 0xFF-filled outputs, and u8words' and xpair's also to
    kernel 1."""
    shape = STAGE_ODD_SHAPE
    tables = band_probes.flagship_tables(shape[1:])
    out_shape = (shape[0], len(tables[0]), len(tables[2]))
    for dtype in BAND_EXPS:
        x = make(dtype, shape)
        prod = cuda_apply.apply_separable_kernel(x, *tables)
        modes = [m for m in band_probes.modes_of(dtype)
                 if m.removesuffix("_direct") in band_probes.RING_MODES]
        for mode in modes:
            got = band_probes.band_probe_kernel(
                x, tables, mode, out=filled(out_shape, dtype, dev))
            torch.cuda.synchronize()
            plain = band_probes.band_probe_plain(x, tables, mode)
            check(torch.equal(got, plain), f"{mode} {dtype} at {shape} "
                  f"differs from its plain version (max {max_err(got, plain)})")
            if mode not in STAGE_CUTS:
                check(torch.equal(got, prod), f"{mode} {dtype} at {shape} is "
                      "not production's output")
        print(f"[47 kernel-1 probes] {'x'.join(map(str, shape))} -> "
              f"{out_shape[1]}x{out_shape[2]} {str(dtype)[6:]} (rows of no "
              f"16-byte multiple) into 0xFF-filled outputs: "
              f"{', '.join(modes)} torch.equal to their plain versions")



def densex_check(got, plain, prod, x, tables) -> str:
    """densex (csrc/dense_x.cu, a wgmma product on a bf16 split) against
    its plain version, the f32 statement: f32 within DENSEX_RTOL *
    max|plain| of it and of kernel 1's output ``prod``; bf16 within one
    bf16 ulp of it everywhere.  The guard: on the same f32 inputs one bf16
    pass (T and the operator rounded to bf16 once) lies more than 10 x the
    f32 tolerance from the plain version, so the check would refuse a
    kernel that ignored the split.  Returns what was found, for the
    phase's line."""
    if got.dtype == torch.float32:
        tol = band_probes.DENSEX_RTOL * float(plain.abs().max())
        e, ek = max_err(got, plain), max_err(got, prod)
        check(e <= tol and ek <= band_probes.DENSEX_RTOL * float(
            prod.abs().max()), f"rgb1024 densex f32: |kernel - plain| {e:.3e}"
              f", |kernel - kernel 1| {ek:.3e}, over {tol:.3e}")
        wxd = band_probes._densex_device(tables, x.shape[2], x.dtype,
                                         x.device)
        one = band_probes.dense_x_split_plain(
            band_probes.y_sums(x, tables), wxd, 1)
        e1 = max_err(one, plain)
        check(e1 > 10 * tol, f"rgb1024 densex guard: one bf16 pass lies "
              f"{e1:.3e} from the plain version, within 10 x {tol:.3e}")
        return (f"f32 |kernel - plain| {e:.3e}, |kernel - kernel 1| {ek:.3e}"
                f" <= {band_probes.DENSEX_RTOL:g} * max|plain| = {tol:.3e}; "
                f"one bf16 pass {e1:.3e} > 10 x that (the guard)")
    e = within_bf16_ulp(got, plain, "rgb1024 densex bf16")
    n = int((got != plain).sum())
    return (f"bf16 within one bf16 ulp of the plain version, {n} of "
            f"{plain.numel()} elements differ (max |diff| {e:.3e})")


def rgb1024_phase(make, card, copy_row) -> list:
    """Phase 48: rgb1024 (bench.py's config 2: 24 planes of 1024^2, 150 ->
    60 dpi), kernel 1's probe modes against their plain versions, then
    every experiment of ``rgb1024_experiments.EXPS`` through its entry
    point in bf16 and f32, beside their plain versions and library calls;
    one rgb1024_probe_timing line.  Returns rows 13b-d of the JSON
    summary."""
    dev = make.device
    R = rgb1024_experiments.H
    nf = rgb1024_experiments.CHANNELS * F
    tables = rgb1024_experiments.tables()
    plan = band_probes._plan(tables)
    check((plan["TY"], plan["TX"], plan["SY"], plan["SX"]) ==
          (8, 240, 21, 600), f"kernel 1's rgb1024 plan {plan}")
    Hd, Wd = len(tables[0]), len(tables[2])
    dtypes = (torch.bfloat16, torch.float32)
    err = {}
    SY = band_probes.densex_plan(tables, R)["SY"]
    for dtype in dtypes:
        dt = str(dtype)[6:]
        dense_src = (f"TMA windows of {SY} rows"
                     if band_probes.dense_x_window(SY, R, dtype.itemsize)
                     else "global memory")
        x = make(dtype, (nf, R, R))
        tmp = make(dtype, (nf, Hd, R))
        prod = cuda_apply.apply_separable_kernel(x, *tables)
        outs = {}
        for mode in RGB_MODES:
            inp = tmp if mode.startswith("xonly") else x
            before = band_probes.LAUNCHES[mode]
            buf = filled((nf, Hd, Wd), dtype, dev)
            got = band_probes.band_probe_kernel(inp, tables, mode, out=buf)
            torch.cuda.synchronize()
            check(got is buf and band_probes.LAUNCHES[mode] == before + 1,
                  f"rgb1024 {mode}: not one launch per call")
            plain = band_probes.band_probe_plain(inp, tables, mode)
            err[(dt, mode)] = max_err(got, plain)
            if mode == "densex":
                dense_note = densex_check(got, plain, prod, x, tables)
            else:
                check(torch.equal(got, plain), f"rgb1024 {mode} {dt} differs "
                      f"from its plain version (max {err[(dt, mode)]})")
            if mode.startswith("xonly"):
                outs[mode] = got
            del got, plain, buf
        check(torch.equal(outs["xonly"], outs["xonly_direct"]),
              f"rgb1024 xonly {dt}: the ring differs from its first form")
        del outs
        grid = {m: band_probes.stage_grid(tmp if m == "xonly" else x, tables,
                                          m)
                for m in ("stage", "stagey", "xonly")}
        print(f"[48 rgb1024] {dt} launch geometry: " + "; ".join(
            f"{m} grid {g['grid']} ({g['blocks_per_sm']} blocks an SM x "
            f"{g['sms']} SMs, {g['tiles']} tiles, a ring of {g['slots']} "
            f"windows), {g['smem']} bytes of shared memory a block, "
            f"{g['registers']} registers" for m, g in grid.items())
            + f"; xonly's windows {band_probes.window_rows(plan, 'xonly')} "
            "rows, a lane's 4 columns reading their 16 taps a row into "
            "registers, no T")
        print(f"[48 rgb1024] {nf}x{R}x{R} {dt} -> {Hd}x{Wd}, plan TY 8 TX "
              f"240 SY 21 SX 600 into NaN-filled outputs: stage, stagey, xonly "
              f"(the stage ring), stage_direct, stagey_direct, xonly_direct "
              f"torch.equal to their plain versions (xonly also to "
              f"xonly_direct); densex (dense_x.cu, "
              f"{band_probes.DENSE_WARPGROUPS[dtype.itemsize]} warpgroup(s) "
              f"a block of 64 "
              f"rows, K in chunks of {band_probes.DENSE_K}, the y pass from "
              f"{dense_src}): {dense_note}")
        del x, tmp, prod
    # the entry points: every experiment, the counts read around them
    torch.cuda.synchronize()
    reset_launches()
    runs = {(str(dt)[6:], exp): rgb1024_experiments.EXPS[exp](F, dt, dev)
            for dt in dtypes for exp in RGB_EXPS}
    torch.cuda.synchronize()
    want = {m: 0 for m in band_probes.MODES}
    for r in runs.values():
        if r["mode"] in want:
            want[r["mode"]] += 9                  # warm-up + 8 captured
    n_dt = len(dtypes)
    check(dict(band_probes.LAUNCHES) == want, f"rgb1024 probes launched "
          f"{dict(band_probes.LAUNCHES)}, want {want}")
    check(copy_ceiling.LAUNCHES == 9 * n_dt and cuda_apply.LAUNCHES ==
          9 * n_dt and cuda_apply_2d.LAUNCHES == 0
          and aligned_fused_probe.LAUNCHES == 0
          and other_paths_idle(cuda_shear.LAUNCHES, cuda_shear3.LAUNCHES,
                               rot_experiments.LAUNCHES),
          "the rgb1024 experiments launched a kernel of another path")
    launches = dict(band_probes.LAUNCHES)
    # the first forms of dma, ypass and xonly, timed beside the ring (after
    # the experiments' counts: no experiment launches them)
    for dtype in dtypes:
        for m, exp in (("stage_direct", "dma"), ("stagey_direct", "ypass"),
                       ("xonly_direct", "xonly")):
            runs[(str(dtype)[6:], f"{exp}_direct")] = band_probes.run_exp(
                f"{exp}_direct", m, nf, dtype, dev, (R, R),
                rgb1024_experiments.RES)
    # plain versions and library calls on the same kind of inputs
    plain_ms, library_ms = {}, {}
    ys, yw, xs, xw = (torch.as_tensor(t, device=dev) for t in tables)
    rows = ys.long().clamp(0, R - 1)[:, None]
    cols = xs.long().clamp(0, R - 1)[None, :]
    dense = operator((R, R), 0.0, ratio=rgb1024_experiments.RES).dense()
    for dtype in dtypes:
        dt = str(dtype)[6:]
        xb = [make(dtype, (nf, R, R)) for _ in range(3)]
        tb = [make(dtype, (nf, Hd, R)) for _ in range(3)]
        for mode in ("stage", "stagey", "xonly"):
            ins = tb if mode == "xonly" else xb
            plain_ms[(dt, mode)] = probe_harness.graph_ms(
                lambda x, m=mode: band_probes.band_probe_plain(x, tables, m),
                ins[1:], ins[:1], reps=2)
        # 1024 fused multiply-add steps of (24, 410, 410) in float64: eager
        plain_ms[(dt, "densex")] = eager_ms(
            lambda x: band_probes.band_probe_plain(x, tables, "densex"),
            xb[1:], 1)
        wy0, wx0 = (torch.as_tensor(m, dtype=dtype, device=dev)
                    for m in dense)
        wxd = band_probes._densex_device(tables, R, dtype, dev)
        library_ms[(dt, "stage")] = probe_harness.graph_ms(
            lambda x: x[:, rows, cols], xb[1:], xb[:1])
        sel = column_picker(cols[0], R, dtype)
        library_ms[(dt, "stagey")] = probe_harness.graph_ms(
            lambda x: torch.einsum("hy,fyx,xw->fhw", wy0, x, sel),
            xb[1:], xb[:1], reps=3)
        library_ms[(dt, "xonly")] = probe_harness.graph_ms(
            lambda t: torch.matmul(t, wxd), tb[1:], tb[:1])
        library_ms[(dt, "densex")] = probe_harness.graph_ms(
            lambda x: torch.einsum("hy,fyx,wx->fhw", wy0, x, wx0),
            xb[1:], xb[:1], reps=3)
        library_ms[(dt, "full")] = library_ms[(dt, "densex")]
        if dtype == torch.bfloat16:          # phase 42's, the same geometry
            g = copy_row["geometries"]["rgb1024"]
            plain_ms[(dt, "copy")] = g["plain_ms"]
            library_ms[(dt, "copy")] = g["library_ms"]
        del xb, tb
    timing = {"card": card, "shape": [nf, R, R], "dst": [Hd, Wd],
              "plan": {k: plan[k] for k in ("TY", "TX", "SY", "SX")},
              "exps": {}}
    for (dt, exp), r in runs.items():
        key = (dt, r["mode"].removesuffix("_direct"))
        # densex: its split products at the tensor-core rate, the y pass
        # at the f32 rate; beside it the bound first stated, one dense
        # product as f32 FMAs (its passes: 4 products for f32, 2 for bf16)
        passes = 4 if dt == "float32" else 2
        tc = band_probes.tensor_core_ops(r["mode"], tables, (nf, R, R),
                                         4 if dt == "float32" else 2)
        timing["exps"][f"{dt}_{exp}"] = {
            "mode": r["mode"], "ms": r["ms_per_batch"],
            "gpixel_s": r["gpixel_s"], "us_per_frame": r["us_per_frame"],
            "bytes": r["bytes"], "operations": r["operations"],
            **bound(r["bytes"], r["operations"] - tc, tc_flops=tc),
            "plain_ms": plain_ms.get(key), "library_ms": library_ms.get(key)}
        if tc:
            timing["exps"][f"{dt}_{exp}"]["f32_fma_bound_ms"] = bound(
                r["bytes"], r["operations"] - tc + tc // passes)["bound_ms"]
    ex = timing["exps"]
    for dt in ("bfloat16", "float32"):
        print(f"[48 rgb1024] {card}, {nf}x{R}x{R} {dt}, device ms per batch "
              "(CUDA-graph replays, best of 2) / bound ms / library ms: "
              + ", ".join(f"{k[len(dt) + 1:]} {v['ms']:.4f} / "
                          f"{v['bound_ms']:.4f} ({v['bound_by']}) / "
                          + (f"{v['library_ms']:.4f}"
                             if v["library_ms"] is not None else "none")
                          for k, v in ex.items() if k.startswith(dt)))
        v = ex[f"{dt}_fulldense"]
        print(f"[48 rgb1024] {card}, densex {dt} on the tensor cores: "
              f"{v['ms']:.4f} ms; bound {v['bound_ms']:.4f} ms "
              f"({v['bound_by']}: {v['bytes'] / 1e6:.1f} MB at 3.35 TB/s, "
              f"its split products at 989 TFLOP/s, the y pass at 67), "
              f"{v['f32_fma_bound_ms']:.4f} ms as first stated (one dense "
              f"product as f32 FMAs); the dense einsum {v['library_ms']:.4f} "
              f"ms in the same call ({v['library_ms'] / v['ms']:.2f} x the "
              "kernel's time)")
    print(json.dumps({"rgb1024_probe_timing": timing}))

    def row(name, mode, exp, firsts=()):
        r = ex[f"bfloat16_{exp}"]
        modes = {m: {dt: {"launches": launches[m], "max_abs_err": err[(dt, m)],
                          **{k: ex[f"{dt}_{e}"][k] for k in (
                              "ms", "plain_ms", "bound_ms", "library_ms")}}
                     for dt in ("bfloat16", "float32")}
                 for m, e in ((mode, exp),) + tuple(firsts)}
        return {
            "name": name,
            "route": "cuda",
            "source": ("aainterp_torch/csrc/dense_x.cu" if mode == "densex"
                       else "aainterp_torch/csrc/band_probes.cu"),
            "replaces": RGB_REPLACES[mode],
            "launches": launches[mode],
            "max_abs_err": max(err[(dt, mode)] for dt in ("bfloat16",
                                                          "float32")),
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "dtype": "bfloat16",
            "float32": {k: ex[f"float32_{exp}"][k] for k in (
                "ms", "plain_ms", "bound_ms", "library_ms")},
            **({"modes": modes} if firsts else {}),
        }

    return [row("rgb1024_dma", "stage", "dma"),
            row("rgb1024_ypass", "stagey", "ypass"),
            row("rgb1024_dma_direct", "stage_direct", "dma_direct"),
            row("rgb1024_ypass_direct", "stagey_direct", "ypass_direct"),
            row("band_xonly", "xonly", "xonly",
                (("xonly_direct", "xonly_direct"),)),
            row("band_densex", "densex", "fulldense")]


def aligned_fused_phase(make, card) -> dict:
    """Phase 49: the fused aligned regrid at config 5 (8 f32 fields 1800 x
    3600 -> 180 x 360, m = 10) against its plain version, kernel 2 and the
    aligned route, then every experiment of ``aligned_fused_probe.EXPS``
    through its entry point; one aligned_fused_timing line.  Returns row
    12 of the JSON summary."""
    dev = make.device
    af = aligned_fused_probe
    src, dst = t_regrid.LatLonGrid(*RG_SRC), t_regrid.LatLonGrid(*RG_DST)
    by, bx = t_regrid.conservative_regrid_operator(src, dst)
    yp, xp = (dict(p, wk=torch.as_tensor(p["wk"], device=dev))
              for p in af.geometry(RG_SRC, RG_DST))
    check((yp["m"], yp["c0"], xp["m"], xp["c0"]) == (10, 0, 10, 0),
          f"config 5's aligned plans: m {yp['m']}, {xp['m']}")
    x = make(torch.float32, (RG_F,) + RG_SRC) * 50.0 + 250.0
    before = af.LAUNCHES
    buf = filled((RG_F,) + RG_DST, torch.float32, dev)
    got = af.aligned_fused_kernel(x, yp, xp, out=buf)
    torch.cuda.synchronize()
    check(got is buf and af.LAUNCHES == before + 1,
          "fused aligned: not one launch per call")
    plain = af.aligned_fused_plain(x, yp, xp)
    err = max_err(got, plain)
    check(torch.equal(got, plain), f"fused aligned differs from its plain "
          f"version (max {err})")
    others = {"kernel 2": t_regrid.apply_band_operators(x, by, bx,
                                                        impl="kernel"),
              "aligned route": apply_ops.apply_separable_aligned(x, yp, xp)}
    for name, ref in others.items():
        check(torch.allclose(got, ref, rtol=1e-6, atol=1e-3),
              f"fused aligned vs {name}: max |diff| {max_err(got, ref)}")
    rel = af.check(dev)
    print(f"[49 fused aligned] {RG_F}x{RG_SRC[0]}x{RG_SRC[1]} f32 -> "
          f"{RG_DST}: torch.equal to its plain version into a NaN-filled "
          f"output; vs kernel 2 {max_err(got, others['kernel 2']):.3e}, vs "
          f"the aligned route {max_err(got, others['aligned route']):.3e} "
          f"(rtol 1e-6, atol 1e-3); check: fused rel {rel['fused']:.2e}, "
          f"einsum rel {rel['einsum']:.2e} (< 1e-5)")
    del x, buf, got, plain, others
    # the entry points: every experiment, the counts read around them
    torch.cuda.synchronize()
    reset_launches()
    runs = {name: af.EXPS[name](RG_F, dev) for name in af.EXPS}
    torch.cuda.synchronize()
    check(af.LAUNCHES == 9 and cuda_apply_2d.LAUNCHES == 9
          and cuda_apply.LAUNCHES == 0 and copy_ceiling.LAUNCHES == 0
          and other_paths_idle(band_probes.LAUNCHES, cuda_shear.LAUNCHES,
                               cuda_shear3.LAUNCHES,
                               rot_experiments.LAUNCHES),
          f"fused aligned experiments: {af.LAUNCHES} fused and "
          f"{cuda_apply_2d.LAUNCHES} kernel-2 launches, want 9 and 9, no "
          "other")
    launches = af.LAUNCHES
    xb = [make(torch.float32, (RG_F,) + RG_SRC) * 50.0 + 250.0
          for _ in range(3)]
    plain_ms = probe_harness.graph_ms(
        lambda f: af.aligned_fused_plain(f, yp, xp), xb[1:], xb[:1], reps=2)
    del xb
    pal = runs["pallas"]
    b = bound(pal["bytes"], pal["operations"])
    timing = {"card": card, "shape": [RG_F, *RG_SRC], "dst": list(RG_DST),
              "m": [yp["m"], xp["m"]], "plain_ms": plain_ms, **b,
              "exps": {k: {"ms": r["ms_per_batch"], "gpixel_s":
                           r["gpixel_s"], "us_per_frame": r["us_per_frame"]}
                       for k, r in runs.items()}}
    print(f"[49 fused aligned] {card}, device ms per batch (CUDA-graph "
          "replays, best of 2): " + ", ".join(
              f"{k} {v['ms']:.4f}" for k, v in timing["exps"].items())
          + f"; plain {plain_ms:.4f}; bound {b['bound_ms']:.4f} "
          f"({b['bound_by']}, {100 * b['bound_ms'] / pal['ms_per_batch']:.1f}"
          " % of it reached by the fused kernel)")
    print(json.dumps({"aligned_fused_timing": timing}))
    return {
        "name": "aligned_fused",
        "route": "cuda",
        "source": "aainterp_torch/csrc/aligned_fused.cu",
        "replaces": "benchmarks/aligned_fused_probe.py:100",
        "launches": launches,
        "max_abs_err": err,
        "ms": pal["ms_per_batch"],
        "plain_ms": plain_ms,
        "bound_ms": b["bound_ms"],
        "bound_by": b["bound_by"],
        # JAX's einsum experiment: one double contraction, TF32 off
        "library_ms": runs["einsum"]["ms_per_batch"],
    }


def watchlist_phase(make, card) -> list:
    """Phase 50: the Mosaic watchlist's six probes (``csrc/watchlist.cu`` on
    ``csrc/hopper.cuh``: TMA, 1-D bulk copies with mbarriers, wgmma) each
    against its plain version on JAX's inputs and 8 distinct seeded inputs
    into NaN-filled outputs (``mw.equal``: bit for bit; high_dot |diff| <=
    1e-5 * max|plain|; unaligned_dma's 16 rows of 14,400 bytes in 128
    blocks of one piece each); vpu_dyn_rows at ``DYN_CASES`` into
    NaN-filled and misaligned outputs; each programmatic launch
    (value_slice, vpu_dyn_rows) ``PDL_LAUNCHES`` times right after a
    PyTorch kernel writes its inputs, and its edges through graph capture;
    then the entry points with the counts set to 0 around them:
    ``run_watchlist`` (every probe "available") and ``measure`` of each
    (kernel, plain version, library call and launch floor); one
    watchlist_timing line.  Returns the six rows of the JSON summary."""
    dev = make.device
    mw = mosaic_watchlist
    err = {}
    for name, kernel, plain, _, _ in mw.PROBES:
        for seed in range(9):                 # JAX's inputs, then 8 more
            args = mw.inputs(name, dev, seed)
            want = plain(*args)
            before = mw.LAUNCHES[name]
            got = kernel(*args, out=torch.full_like(want, float("nan")))
            torch.cuda.synchronize()
            check(mw.LAUNCHES[name] == before + 1,
                  f"watchlist {name}: not one launch per call")
            e = max_err(got, want)
            check(mw.equal(name, got, want), f"watchlist {name} (seed {seed})"
                  f" differs from its plain version: max |diff| {e}")
            err[name] = max(err.get(name, 0.0), e)
    # strided_load's windows and strided_y_bf16's boxes at ragged shapes:
    # several blocks each way, R = 1, W / 2 not a multiple of 4 (odd rows of
    # out not 16-byte aligned), W under one window; other frames, parities
    # and row counts, two column blocks
    ragged = [("strided_load", (make(torch.float32, shape),))
              for shape in ((70, 600), (1, 3840), (9, 3844), (13, 12))]
    xy = make(torch.bfloat16, (3, 20, 3, 264))
    ragged += [("strided_y_bf16", (xy, f, p, r))
               for f, p, r in ((2, 0, 20), (1, 2, 1), (0, 1, 7))]
    for name, args in ragged:
        _, kernel, plain, _, _ = mw.probe(name)
        want = plain(*args)
        got = kernel(*args, out=torch.full_like(want, float("nan")))
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"watchlist {name} at "
              f"{tuple(args[0].shape)} {args[1:]}: max |diff| "
              f"{max_err(got, want)}")
    a, b = (mw.inputs("high_dot", dev, seed)[0] for seed in (1, 2))
    got, want = mw.high_dot_kernel(a - 0.25, b), mw.high_dot_plain(a - 0.25, b)
    check(mw.equal("high_dot", got, want) and not mw.equal(
        "high_dot", got, mw.high_dot_plain(b, a - 0.25)),
          f"watchlist high_dot with a != b: max |diff| {max_err(got, want)}")
    print(f"[50 watchlist] {', '.join(mw.NAMES)}: each kernel equal to its "
          f"plain version on JAX's inputs and 8 seeded ones into NaN-filled "
          f"outputs (bit for bit; high_dot, one block per "
          f"{mw.HIGH_DOT_TILE[0]} x {mw.HIGH_DOT_TILE[1]} tile with K in a "
          f"TMA ring, max |diff| {err['high_dot']:.3e} <= 1e-5 * "
          f"max|plain|; unaligned_dma's "
          f"{mw.DMA_ROWS} rows of {mw.SHAPES['unaligned_dma'][1] * 4} bytes "
          f"in pieces of at most 2 KB, one block each; strided_load in TMA "
          f"windows of {mw.STRIDED_LOAD_WINDOW[0]} x "
          f"{mw.STRIDED_LOAD_WINDOW[1]} and strided_y_bf16 in boxes of "
          f"{mw.STRIDED_Y_BOX[0]} x {mw.STRIDED_Y_BOX[1]}, a block each, also "
          f"at {len(ragged)} ragged shapes)")
    # vpu_dyn_rows: one block a row and 256 columns; other widths, row
    # counts and offsets, into NaN-filled and misaligned (scalar) outputs
    for rows, C, offs in DYN_CASES:
        x = make(torch.float32, (rows, C))
        off = torch.tensor(offs, dtype=torch.int32, device=dev)
        want = mw.vpu_dyn_rows_plain(x, off)
        flat = torch.full((want.numel() + 4,), float("nan"), device=dev)
        for shift in (0, 1):
            before = mw.LAUNCHES["vpu_dyn_rows"]
            got = mw.vpu_dyn_rows_kernel(x, off, out=flat[
                shift:shift + want.numel()].view(want.shape))
            torch.cuda.synchronize()
            check(mw.LAUNCHES["vpu_dyn_rows"] == before + 1
                  and mw.equal("vpu_dyn_rows", got, want),
                  f"watchlist vpu_dyn_rows at ({rows}, {C}), {len(offs)} "
                  f"offsets, out shifted {4 * shift} bytes: max |diff| "
                  f"{max_err(got.nan_to_num(), want.nan_to_num())}")
    # the programmatic launches: a PyTorch kernel (a float64 or int64 copy)
    # writes the inputs right before each launch
    for name in mw.PROGRAMMATIC:
        _, kernel, plain, _, _ = mw.probe(name)
        args = mw.inputs(name, dev, 1)
        for i in range(PDL_LAUNCHES):
            src = mw.inputs(name, dev, 100 + i)
            for a, b in zip(args, src):
                a.copy_(b.double() if a.is_floating_point() else b.long())
            got = kernel(*args)
            want = plain(*src)
            torch.cuda.synchronize()
            check(mw.equal(name, got, want), f"watchlist {name}: launch {i} "
                  "after a write of its inputs differs from its plain version")
    edges = {name: mw.programmatic_edges(name, dev) for name in mw.NAMES}
    check(all(e == ((7 if n in mw.PROGRAMMATIC else 0), 7)
              for n, e in edges.items()),
          f"watchlist: programmatic / all edges of 8 captured launches "
          f"{edges}, want 7 / 7 for {mw.PROGRAMMATIC}, 0 / 7 for the rest")
    print(f"[50 watchlist] vpu_dyn_rows equal to its plain version at "
          f"{len(DYN_CASES)} more shapes (out-of-range offsets: NaN rows), "
          f"into NaN-filled and misaligned outputs; {', '.join(mw.PROGRAMMATIC)}"
          f" launched programmatically, each equal after {PDL_LAUNCHES} "
          f"writes of its inputs; programmatic / all graph edges of 8 "
          f"captured launches: {edges}")
    del got
    torch.cuda.synchronize()
    reset_launches()
    status = mw.run_watchlist(dev, verbose=True)
    runs = {name: mw.measure(name, dev) for name in mw.NAMES}
    torch.cuda.synchronize()
    launches = dict(mw.LAUNCHES)
    check(all(s == "available" for s, _ in status.values()),
          f"watchlist: not every probe available: {status}")
    check(mw.FLOOR_LAUNCHES == {name: 9 for name in mw.NAMES},
          f"watchlist launch floors: {mw.FLOOR_LAUNCHES}, want 9 each (1 "
          "warm-up, 8 captured)")
    check(launches == {name: 10 for name in mw.NAMES}
          and cuda_apply.LAUNCHES == 0 and cuda_apply_2d.LAUNCHES == 0
          and copy_ceiling.LAUNCHES == 0 and aligned_fused_probe.LAUNCHES == 0
          and other_paths_idle(band_probes.LAUNCHES, cuda_shear.LAUNCHES,
                               cuda_shear3.LAUNCHES,
                               rot_experiments.LAUNCHES),
          f"watchlist entry points: launches {launches}, want 10 each (1 "
          "check, 1 warm-up, 8 captured), no other kernel")
    timing = {"card": card, "probes": {}}
    for name, r in runs.items():
        check(r["clock"] == "cuda_events", f"{name} timed on {r['clock']}")
        timing["probes"][name] = dict(
            ms=r["kernel_ms"], plain_ms=r["plain_ms"],
            library_ms=r["library_ms"], floor_ms=r["floor_ms"],
            bytes=r["bytes"],
            operations=r["operations"], **bound(
                r["bytes"], r["operations"],
                PEAK_BF16_TC_FLOP_S if name in mw.TENSOR_CORE_BF16
                else PEAK_F32_FLOP_S))
    print(f"[50 watchlist] {card}, device ms per call (CUDA-graph replays on "
          f"8 distinct inputs, best of 2): " + "; ".join(
              f"{n} {v['ms']:.6f} (plain {v['plain_ms']:.4f}, library "
              f"{v['library_ms']:.4f}, bound {v['bound_ms']:.6f}, launch "
              f"floor {v['floor_ms']:.6f})"
              for n, v in timing["probes"].items())
          + " (high_dot's bound: its 3 bf16 products on the tensor cores)")
    print(json.dumps({"watchlist_timing": timing}))
    return [{
        "name": f"watchlist_{name}",
        "route": "cuda",
        "source": "aainterp_torch/csrc/watchlist.cu",
        "replaces": f"benchmarks/mosaic_watchlist.py:{WATCHLIST_LINES[name]}",
        "launches": launches[name],
        "max_abs_err": err[name],
        "ms": v["ms"],
        "plain_ms": v["plain_ms"],
        "bound_ms": v["bound_ms"],
        "bound_by": v["bound_by"],
        "library_ms": v["library_ms"],
    } for name, v in timing["probes"].items()]


# ---------------------------------------------------------------------------
# Phases 51-53: the row-sharded applies on torch.distributed ranks
# ---------------------------------------------------------------------------

# 4 gloo ranks share the card; each case runs on one mesh of them
SHARD_RANKS = 4
SHARD_REQUESTS = 2          # sharded calls per case on the main path
# (phase, mesh, case, timed) over the 4 gloo ranks
GLOO_CASES = (("51", (1, 4), "bf16", True), ("51", (2, 2), "bf16", True),
              ("51", (1, 4), "u8", False), ("51", (2, 2), "f32", False),
              ("51", (1, 4), "fold", False), ("52", (1, 4), "plain", True),
              ("52", (2, 2), "plain", True), ("52", (1, 4), "conserve", False),
              ("52", (1, 4), "mask", False))
SHARD_DTYPES = {"bf16": torch.bfloat16, "u8": torch.uint8,
                "f32": torch.float32, "fold": torch.float32}
# phase 53, the sharded rotated flagship: the rotated flagship's frames at
# an angle scanned up from 30.0 degrees in 0.1-degree steps until the dst
# rows and qH divide the 4 ranks (bench.py:559-566); its cases over the 4
# gloo ranks; fold and tables at the angle + 90 degrees (quadrant 1)
SHARD_ROT_FROM = 30.0
SHARD_ROT_DST = (1400, 1400)
SHARD_ROT_CASES = (("53", (1, 4), "rot_bf16", True),
                   ("53", (2, 2), "rot_bf16", True),
                   ("53", (1, 4), "rot_f32", False),
                   ("53", (1, 4), "rot_fold", False),
                   ("53", (1, 4), "rot_tables", False))
SHARD_ROT_DTYPES = {"rot_bf16": torch.bfloat16, "rot_f32": torch.float32,
                    "rot_fold": torch.float32, "rot_tables": torch.float32}
# phases 54-55, the 2-D (rows x cols) sharded applies on the same 4 gloo
# ranks: 54 the separable apply at bench.py's sharded2d geometry
# (bench.py:659-685: 8 frames of 2048 x 3840, exact 2x) and config 5
# sharded in latitude and longitude; 55 the rotated flagship's frames at
# phase 53's angle and its fold
S2_H, S2_W = 2048, 3840
SHARD2D_CASES = (("54", (1, 2, 2), "bf16", True),
                 ("54", (1, 1, 4), "bf16", True),
                 ("54", (1, 2, 2), "u8", False),
                 ("54", (1, 2, 2), "f32", False),
                 ("54", (1, 2, 2), "fold90", False),
                 ("54", (1, 2, 2), "fold180", False),
                 ("54", (1, 2, 2), "plain", True),
                 ("54", (1, 2, 2), "conserve", False),
                 ("54", (1, 2, 2), "mask", False),
                 ("55", (1, 2, 2), "rot_bf16", True),
                 ("55", (1, 1, 4), "rot_bf16", True),
                 ("55", (1, 2, 2), "rot_f32", False),
                 ("55", (1, 2, 2), "rot_fold", False),
                 ("55", (1, 2, 2), "rot_tables", False))
# one NCCL rank on one card, a case of each sharded phase
NCCL_ONE_RANK_CASES = (("51", (1, 1), "bf16", True),
                       ("52", (1, 1), "plain", True),
                       ("53", (1, 1), "rot_bf16", True),
                       ("54", (1, 1, 1), "bf16", True),
                       ("55", (1, 1, 1), "rot_bf16", True))
SHARD_DTYPES.update(fold90=torch.float32, fold180=torch.float32)
REGRID_CASES = ("plain", "conserve", "mask")      # phases 52 and 54
# phase 56, the sharded gradient steps on the same 4 gloo ranks: the
# separable makers on the 4K flagship (bf16, and f32 folded at 90
# degrees) at (1, 4) and (1, 2, 2), the rotated maker at phase 53's angle
# at (1, 4), f32 (the scatter's dtype)
SHARD_GRAD_CASES = (("56", (1, 4), "grad_bf16", True),
                    ("56", (1, 2, 2), "grad_bf16", True),
                    ("56", (1, 4), "grad_fold90", False),
                    ("56", (1, 2, 2), "grad_fold90", False),
                    ("56", (1, 4), "grad_rot", True))
NCCL_ONE_RANK_CASES += (("56", (1, 1), "grad_bf16", True),
                        ("56", (1, 1), "grad_rot", True))


@contextlib.contextmanager
def no_plain_routes():
    """Every plain route the sharded applies could take raises inside:
    the plain applies and the shear wrappers' plain versions (module
    names, and the shear forms' dispatch table)."""
    names = ((t_sharding, "apply_separable_banded"),
             (t_sharding, "apply_separable_aligned"),
             (t_sharding, "apply_ell"),
             (cuda_apply, "apply_separable_plain"),
             (cuda_apply_2d, "apply_separable_2d_plain"),
             (t_regrid, "apply_separable_banded"),
             (t_regrid, "apply_separable_aligned"),
             (cuda_shear, "vshear_plain"), (cuda_shear, "hshear_plain"),
             (cuda_shear, "vhshear_plain"), (cuda_shear, "contract_plain"),
             (cuda_shear, "contract_tiled_plain"))
    forms = cuda_shear._PLAIN
    saved = [getattr(m, n) for m, n in names]
    saved_forms = dict(forms)

    def refuse(name):
        def plain(*a, **k):
            raise RuntimeError(f"a sharded call took the plain route {name}")
        return plain

    for m, n in names:
        setattr(m, n, refuse(n))
    for form in forms:
        forms[form] = refuse(f"{form}_plain")
    try:
        yield
    finally:
        for (m, n), f in zip(names, saved):
            setattr(m, n, f)
        forms.update(saved_forms)


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit, NaN where the other has NaN."""
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.isnan(), b.isnan())
            and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0)))


def wall_ms(fn, reps: int) -> float:
    """Mean ms per call of a collective ``fn()`` on this rank: a warm-up,
    a barrier, then ``reps`` calls to a synchronised end."""
    fn()
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    dist.barrier()
    return ms


def turns_ms(fn, reps: int, graph: bool = False) -> float:
    """ms per call of a rank-local ``fn()`` on CUDA events, the ranks in
    turn, so no other rank's work shares the card meanwhile: eager calls
    (the host's share included), or with ``graph`` the device time of
    CUDA-graph replays (``graph_ms``)."""
    ms = 0.0
    for r in range(dist.get_world_size()):
        dist.barrier()
        if dist.get_rank() == r:
            ms = (graph_ms(lambda x: fn(), [None], reps) if graph
                  else _events_ms(lambda i: fn(), 1, reps))
    dist.barrier()
    return ms


def two_d(mesh) -> bool:
    """A ("data", "rows", "cols") mesh: 2-D blocks, the _2d applies."""
    return t_mesh.COLS in mesh.mesh_dim_names


def shard(x, mesh):
    return (t_mesh.shard_blocks if two_d(mesh) else t_mesh.shard_rows)(
        x, mesh)


def gather(x, mesh):
    return (t_mesh.gather_blocks if two_d(mesh) else t_mesh.gather_rows)(
        x, mesh)


def band_shard(local, y_band, x_band, mesh):
    """((halo_y, halo_x), extended block, rebased y band, x band) of a
    separable shard (the x band rebased too on a 2-D mesh)."""
    cols = two_d(mesh)
    ext, y, x = t_sharding.sharded_local_apply(
        y_band, x_band, mesh, lambda ext, y, x: (ext, y, x), local,
        cols=cols)
    halos = ((y.n_src - local.shape[-2]) // 2,
             (x.n_src - local.shape[-1]) // 2 if cols else 0)
    return halos, ext, y, x


def local_bound(ext, y, x) -> float:
    """The bound of a separable shard's local apply on its extended block
    ``ext`` with bands ``y``, ``x``: the block read once, the output
    written once, the tables; a y pass over the block's columns then an x
    pass, 2 operations a tap."""
    b, es = ext.shape[0], ext.element_size()
    nbytes = (ext.numel() * es + b * y.n_dst * x.n_dst * es
              + (y.n_dst + x.n_dst) * 4 + (y.weights.size + x.weights.size) * 4)
    flops = 2 * b * (y.n_dst * x.n_src * y.band + y.n_dst * x.n_dst * x.band)
    return bound(nbytes, flops)["bound_ms"]


def rank_halos(op, n_r: int, n_c: int) -> list:
    """Each rank's own (top, bottom, left, right) halo, rows and columns
    inside the frame that its dst block's windows reach past its source
    block.  The port keeps JAX's ``_ell_halo_2d``: one halo, the largest
    of these, on every side of every rank, zeros past the frame's
    edges."""
    (Hd, Wd), (qH, qW) = op.spec.dst_shape, op.spec.qrot_shape
    db_r, sb_r, db_c, sb_c = Hd // n_r, qH // n_r, Wd // n_c, qW // n_c
    out = []
    for i in range(n_r):
        for j in range(n_c):
            blk = op.base[i * db_r:(i + 1) * db_r, j * db_c:(j + 1) * db_c]
            lo = np.maximum(blk.reshape(-1, 2).min(axis=0), 0)
            hi = np.minimum(blk.reshape(-1, 2).max(axis=0) + op.window,
                            (qH, qW))
            out.append((max(i * sb_r - int(lo[0]), 0),
                        max(int(hi[0]) - (i + 1) * sb_r, 0),
                        max(j * sb_c - int(lo[1]), 0),
                        max(int(hi[1]) - (j + 1) * sb_c, 0)))
    return out


def shard_timing(local, halos, mesh, local_fn, call, unsharded) -> dict:
    """This rank's local-apply ms (``local_fn()`` on its extended block,
    in turns), its halo exchange's ms and bytes per axis (``halos``: rows,
    then on a 2-D mesh the columns of the row-extended block; one exchange
    each, read from the traffic count), and the whole sharded call's ms
    (all ranks at once); on a one-rank mesh also the sharded and the
    unsharded call on CUDA events, in turns (sharded, unsharded,
    unsharded, sharded; the best of each)."""
    halo_y, halo_x = halos
    blocks = {t_mesh.ROWS: local}
    blocks[t_mesh.COLS] = t_sharding._halo_extend(local, halo_y, mesh)
    res = {"local_ms": turns_ms(local_fn, 20), "halo_rows": halo_y}
    for name, h in ((t_mesh.ROWS, halo_y), (t_mesh.COLS, halo_x)):
        if name == t_mesh.COLS and not two_d(mesh):
            continue
        key = "" if name == t_mesh.ROWS else "_cols"
        before = t_mesh.TRAFFIC["p2p"]
        t_sharding._halo_extend(blocks[name], h, mesh, name)
        res["halo_bytes" + key] = t_mesh.TRAFFIC["p2p"] - before
        res["halo_ms" + key] = wall_ms(
            lambda: t_sharding._halo_extend(blocks[name], h, mesh, name), 10)
        if key:
            res["halo_cols"] = h
    res.update(call_timing(mesh, call, unsharded))
    return res


def call_timing(mesh, call, unsharded) -> dict:
    """The whole sharded call's ms (all ranks at once); on a one-rank mesh
    also the sharded and the unsharded call on CUDA events, in turns
    (sharded, unsharded, unsharded, sharded; the best of each)."""
    res = {"call_ms": wall_ms(call, 10)}
    if mesh.mesh.numel() == 1:
        for name, fn in (("call_events_ms", call), ("unsharded_ms", unsharded),
                         ("unsharded_ms", unsharded), ("call_events_ms", call)):
            ms = _events_ms(lambda i: fn(), 1, 20)
            res[name] = min(res.get(name, ms), ms)
    return res


def rank_ready(mesh) -> int:
    """A rank that has joined its process group and built its mesh."""
    return dist.get_rank()


def rank_sharded_flagship(mesh, what: str, timing: bool) -> dict:
    """Phase 51 on one rank: the 4K flagship (``what``: bf16, u8, f32 with
    the flux, or fold: f32 at 90 degrees) through
    ``sharded_apply_separable`` against the unsharded kernel route; on a
    2-D mesh phase 54: bench.py's sharded2d frames (8 x 2048 x 3840)
    through ``sharded_apply_separable_2d`` (fold90, fold180: f32 at 90
    and 180 degrees)."""
    dev = t_mesh.rank_device()
    cols = two_d(mesh)
    fold = what.startswith("fold")
    shape = (S2_H, S2_W) if cols else (H, W)
    op = operator(shape, (180.0 if what == "fold180" else 90.0) if fold
                  else 0.0)
    frames = Inputs(dev)(SHARD_DTYPES[what], (F,) + shape)  # same everywhere
    tabs = folded_tables(op)
    ref = (at.apply_operator(op, frames) if fold
           else cuda_apply.apply_separable_kernel(frames, *tabs))
    local = shard(frames, mesh)
    conserve = what == "f32"
    apply = (t_sharding.sharded_apply_separable_2d if cols
             else t_sharding.sharded_apply_separable)
    torch.cuda.synchronize()
    dist.barrier()
    reset_launches()
    with no_plain_routes():
        outs = [apply(local, op, mesh, conserve=conserve)
                for _ in range(SHARD_REQUESTS)]
        torch.cuda.synchronize()
    res = {"rank": dist.get_rank(), "device": str(dev),
           "launches": (cuda_apply.LAUNCHES, cuda_apply_2d.LAUNCHES)}
    out = outs[-1][0] if conserve else outs[-1]
    whole = gather(out, mesh)
    res.update(local_shape=tuple(out.shape), shape=tuple(whole.shape),
               dtype=str(whole.dtype), equal=same(whole, ref),
               n_diff=int((whole != ref).sum()) if whole.shape == ref.shape
               else -1, max_abs_err=max_err(whole, ref),
               ref_max=float(ref.double().abs().max()))
    if conserve:
        res["flux"] = outs[-1][1].tolist()
        if dist.get_rank() == 0:
            _, _, covy, covx = t_conserve.separable_flux_factors(
                op.wy, op.wx, raw_sums=op.raw_row_sums)
            res["host_fs"] = float(sum(
                np.einsum("yx,y,x->", f.cpu().double().numpy(), covy, covx)
                for f in frames))
    if timing:
        halos, ext, y, x = band_shard(local, op.wy, op.wx, mesh)
        res.update(shard_timing(
            local, halos, mesh,
            lambda: cuda_apply.apply_separable_kernel(
                ext, y.start, y.weights.astype(np.float32),
                np.ascontiguousarray(x.start, dtype=np.int32),
                x.weights.astype(np.float32)),
            lambda: apply(local, op, mesh),
            lambda: at.apply_operator(op, frames)))
        res["ext_shape"] = tuple(ext.shape)
        res["local_bound_ms"] = local_bound(ext, y, x)
    return res


def rank_sharded_regrid(mesh, what: str, timing: bool) -> dict:
    """Phase 52 on one rank: config 5 (8 f32 fields, 1800 x 3600 -> 180 x
    360) through ``conservative_regrid_sharded`` (``what``: plain,
    conserve, or mask) against the unsharded regrid (kernel 2); on a 2-D
    mesh phase 54's lat-and-lon sharded regrid (``col_axis="cols"``)."""
    dev = t_mesh.rank_device()
    cols = two_d(mesh)
    gen = torch.Generator(device=dev).manual_seed(5)
    fields = (torch.rand((RG_F,) + RG_SRC, generator=gen, device=dev) * 50.0
              + 250.0)
    src, dst = at.LatLonGrid(*RG_SRC), at.LatLonGrid(*RG_DST)
    mask = None
    if what == "mask":
        mask = torch.rand(RG_SRC, generator=gen, device=dev) > 0.3
        mask[:100] = False              # 10 dst rows with no valid cell
    ref = at.conservative_regrid(fields, src, dst, src_mask=mask)
    local = shard(fields, mesh)
    conserve = what == "conserve"
    col_axis = t_mesh.COLS if cols else None
    torch.cuda.synchronize()
    dist.barrier()
    reset_launches()
    with no_plain_routes():
        outs = [t_regrid.conservative_regrid_sharded(
            local, src, dst, mesh, conserve=conserve, src_mask=mask,
            col_axis=col_axis)
            for _ in range(SHARD_REQUESTS)]
        torch.cuda.synchronize()
    res = {"rank": dist.get_rank(), "device": str(dev),
           "launches": (cuda_apply.LAUNCHES, cuda_apply_2d.LAUNCHES)}
    out = outs[-1][0] if conserve else outs[-1]
    whole = gather(out, mesh)
    res.update(shape=tuple(whole.shape), equal=same(whole, ref),
               max_abs_err=float((whole - ref).nan_to_num(0.0).abs().max()),
               nan_rows=int(whole.isnan().all(dim=-1).any(dim=0).sum()))
    if conserve:
        res["flux"] = outs[-1][1].tolist()
        if dist.get_rank() == 0:
            my = np.abs(np.diff(np.sin(np.radians(src.lat_edges))))
            mx = np.diff(src.lon_edges)
            res["host_fs"] = float(np.einsum(
                "fyx,y,x->", fields.cpu().double().numpy(), my, mx))
    if timing:
        by, bx = at.conservative_regrid_operator(src, dst)
        halos, ext, y, x = band_shard(local, by, bx, mesh)
        res["local_bound_ms"] = local_bound(ext, y, x)
        res.update(shard_timing(
            local, halos, mesh,
            lambda: t_regrid.apply_band_operators(ext, y, x),
            lambda: t_regrid.conservative_regrid_sharded(
                local, src, dst, mesh, col_axis=col_axis),
            lambda: at.conservative_regrid(fields, src, dst)))
    return res


def sharded_rot_angle() -> float:
    """Phases 53 and 55's angle: up from SHARD_ROT_FROM in 0.1-degree
    steps until the dst rows and columns and the source's (qH, qW) divide
    SHARD_RANKS (bench.py:559-566, with the columns of its sharded2d
    scan, bench.py:688-698)."""
    for d in range(20):
        angle = round(SHARD_ROT_FROM + d / 10.0, 1)
        spec = at.make_grid_spec((RH, RW), *ROT[:3], angle)
        if not any(n % SHARD_RANKS
                   for n in spec.dst_shape + spec.qrot_shape):
            return angle
    raise RuntimeError("no angle within 2 degrees divides the ranks' rows "
                       "and columns")


def sharded_rot_operator(angle: float, validate: bool):
    """The sharded rotated flagship's operator at ``angle``, through the
    run's operator disk cache: built (native weight-gen) and validated by
    the parent, loaded memory-mapped by each rank."""
    return t_cache.build_operator_cached(
        at.make_grid_spec((RH, RW), *ROT[:3], angle), validate=validate)


def sharded_rot_prep() -> float:
    """Phase 53's host work, in this process before any rank starts: the
    angle, the operators at it and at it + 90 degrees and their shear
    plans, into the run's disk caches (the ranks load them).  Returns the
    angle."""
    t0 = time.perf_counter()
    angle = sharded_rot_angle()
    before = dict(weights_ops.WEIGHT_GEN_ENGINES)
    op = sharded_rot_operator(angle, True)
    qop = sharded_rot_operator(angle + 90.0, True)
    check(weights_ops.WEIGHT_GEN_ENGINES["native"] == before["native"] + 2,
          f"phase 53's weight-gen did not run on the native engine: "
          f"{weights_ops.WEIGHT_GEN_ENGINES} (before {before})")
    folded = weights_ops.fold_quadrant_ell_cached(qop)[0]
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = cuda_shear.kernel_plan_cached(op)
    cuda_shear.kernel_plan_cached(folded)
    plan_s = time.perf_counter() - t0
    kps = {n: cuda_shear.build_sharded_kernel_plan(op, n) for n in (4, 2)}
    kp2 = {m: cuda_shear.build_sharded_kernel_plan_2d(op, *m)
           for m in ((2, 2), (1, 4))}
    check((op.spec.dst_shape, op.window, plan.Ka, plan.Kb,
           folded.spec.dst_shape[0] % SHARD_RANKS,
           folded.spec.qrot_shape[0] % SHARD_RANKS) ==
          (SHARD_ROT_DST, 6, 5, 5, 0, 0),
          f"phase 53 geometry at {angle} deg: dst {op.spec.dst_shape}, K "
          f"{op.window}, Ka x Kb {plan.Ka}x{plan.Kb}; folded at "
          f"{angle + 90.0} deg dst {folded.spec.dst_shape}, qH "
          f"{folded.spec.qrot_shape[0]}")
    print(f"[53 sharded rotated host] {RH}x{RW} at {angle} deg (scanned up "
          f"from {SHARD_ROT_FROM}) -> {op.spec.dst_shape}, K {op.window}, "
          f"Ka x Kb {plan.Ka}x{plan.Kb}; folded at {angle + 90.0} deg -> "
          f"{folded.spec.dst_shape}; halo (1, 4) {kps[4].halo} rows over "
          f"blocks of {kps[4].sb} ({-(-kps[4].halo // kps[4].sb)} hops), "
          f"(2, 2) {kps[2].halo} over {kps[2].sb} "
          f"({-(-kps[2].halo // kps[2].sb)} hop); weight-gen and fold "
          f"{gen_s:.2f} s, both shear plans {plan_s:.2f} s (saved for the "
          f"ranks)")
    for m, kp in kp2.items():
        planes = [kp.rank(i, j) for i in range(kp.n_r) for j in range(kp.n_c)]
        print(f"[55 sharded 2-D rotated host] rows x cols {m}: halo "
              f"{kp.halo_y} rows x {kp.halo_x} columns over blocks of "
              f"{kp.sb_r} x {kp.sb_c} (each rank's own (top, bottom, "
              f"left, right) inside the frame: {rank_halos(op, *m)}), "
              f"extended block {kp.Hloc} x "
              f"{kp.Wloc}; each rank's T (TH x TW_loc) "
              f"{[(p.TH, p.TW) for p in planes]} against the global "
              f"{plan.TH} x {plan.TW} and (1, 4)'s {kps[4].rank(0).TH} x "
              f"{plan.TW}; bf16 rows 16-byte aligned "
              f"{[p.TW * 2 % 16 == 0 for p in planes]}")
    return angle


# each rank's operators of phase 53 by angle, loaded once
_RANK_OPS: dict = {}


def rank_sharded_ell(mesh, what: str, timing: bool, angle: float,
                     cache_dir: str) -> dict:
    """Phase 53 on one rank: 8 x 2048^2 through ``sharded_apply_ell``
    (``what``: rot_bf16; rot_f32 with the flux; rot_fold at angle + 90,
    quadrant 1 folded; rot_tables: that fold with the operator's own
    tables as explicit CUDA tensors) against the unsharded kernel route
    (rot_tables: against the same sharded call without them); on a 2-D
    mesh phase 55, the same through ``sharded_apply_ell_2d``."""
    t_cache.DEFAULT_CACHE_DIR = cache_dir       # the parent's disk caches
    dev = t_mesh.rank_device()
    cols = two_d(mesh)
    fold = what in ("rot_fold", "rot_tables")
    a = angle + (90.0 if fold else 0.0)
    if a not in _RANK_OPS:
        _RANK_OPS[a] = sharded_rot_operator(a, False)
    op = _RANK_OPS[a]
    frames = Inputs(dev)(SHARD_ROT_DTYPES[what], (F, RH, RW))
    local = shard(frames, mesh)
    conserve = what == "rot_f32"
    apply = (t_sharding.sharded_apply_ell_2d if cols
             else t_sharding.sharded_apply_ell)
    kw = {}
    if what == "rot_tables":
        kw = dict(base=upload(op.base, dev), weights=upload(op.weights, dev))
        ref = gather(apply(local, op, mesh), mesh)
    else:
        ref = at.apply_operator(op, frames, impl="kernel")
    torch.cuda.synchronize()
    dist.barrier()
    reset_launches()
    with no_plain_routes():
        outs = [apply(local, op, mesh, conserve=conserve, **kw)
                for _ in range(SHARD_REQUESTS)]
        torch.cuda.synchronize()
    ln = cuda_shear.LAUNCHES
    res = {"rank": dist.get_rank(), "device": str(dev),
           "launches": (ln["vhshear"], ln["contract"],
                        sum(ln.values()) - ln["vhshear"] - ln["contract"],
                        cuda_apply.LAUNCHES, cuda_apply_2d.LAUNCHES)}
    out = outs[-1][0] if conserve else outs[-1]
    whole = gather(out, mesh)
    res.update(local_shape=tuple(out.shape), shape=tuple(whole.shape),
               dtype=str(whole.dtype), equal=same(whole, ref),
               n_diff=int((whole != ref).sum()) if whole.shape == ref.shape
               else -1, max_abs_err=max_err(whole, ref),
               ref_max=float(ref.double().abs().max()))
    if conserve:
        res["flux"] = outs[-1][1].tolist()
        if dist.get_rank() == 0:
            cov = t_conserve.ell_flux_factors(op)[1]
            res["host_fs"] = float(sum(
                np.einsum("yx,yx->", f.cpu().double().numpy(), cov)
                for f in frames))
    if timing:
        n, i, _ = t_mesh.axis(mesh, t_mesh.ROWS)
        if cols:
            n_c, j, _ = t_mesh.axis(mesh, t_mesh.COLS)
            kp = cuda_shear.build_sharded_kernel_plan_2d(op, n, n_c)
            plan, halos = kp.rank(i, j), (kp.halo_y, kp.halo_x)
        else:
            kp = cuda_shear.build_sharded_kernel_plan(op, n)
            plan, halos = kp.rank(i), (kp.halo, 0)
        ext = t_sharding._halo_extend(
            t_sharding._halo_extend(local, halos[0], mesh), halos[1], mesh,
            t_mesh.COLS)
        t = cuda_shear.vhshear_kernel(ext, plan)
        res.update(shard_timing(
            local, halos, mesh,
            lambda: cuda_shear.apply_ell_shear_kernel(ext, plan),
            lambda: apply(local, op, mesh),
            lambda: at.apply_operator(op, frames)))
        # 200 replays: a turn starts on a card left idle by the barrier
        res.update(
            vhshear_ms=turns_ms(lambda: cuda_shear.vhshear_kernel(ext, plan),
                                200, graph=True),
            contract_ms=turns_ms(lambda: cuda_shear.contract_kernel(t, plan),
                                 200, graph=True),
            bounds={k: bound(*rot_experiments.traffic(
                plan, local.shape[0], frames.element_size(), k))["bound_ms"]
                for k in ("shears", "contract_masked", "full")},
            T_loc=(plan.TH, plan.TW), ext_shape=tuple(ext.shape[-2:]),
            T_aligned=plan.TW * frames.element_size() % 16 == 0)
    return res


def rank_sharded_grad(mesh, what: str, timing: bool, angle: float,
                      cache_dir: str) -> dict:
    """Phase 56 on one rank: a gradient step through a sharded maker,
    forward then backward with a fixed cotangent, against the unsharded
    forward and backward (``apply_operator`` on the kernel routes:
    ``SeparableLinear``, ``EllLinear``).  ``what``: grad_bf16 (the 4K
    flagship, ``make_sharded_separable_linear``, on a 2-D mesh ``_2d``),
    grad_fold90 (f32 at 90 degrees, folded), grad_rot (8 x 2048^2 f32 at
    phase 53's angle, ``make_sharded_ell_linear``).  Counts kernel 1's
    launches in the forwards and in the backwards apart."""
    t_cache.DEFAULT_CACHE_DIR = cache_dir       # the parent's disk caches
    dev = t_mesh.rank_device()
    cols = two_d(mesh)
    rot = what == "grad_rot"
    if rot:
        if angle not in _RANK_OPS:
            _RANK_OPS[angle] = sharded_rot_operator(angle, False)
        op, shape, dtype = _RANK_OPS[angle], (RH, RW), torch.float32
        maker = t_sharding.make_sharded_ell_linear
    else:
        op = operator((H, W), 90.0 if what == "grad_fold90" else 0.0)
        shape = (H, W)
        dtype = torch.bfloat16 if what == "grad_bf16" else torch.float32
        maker = (t_sharding.make_sharded_separable_2d_linear if cols
                 else t_sharding.make_sharded_separable_linear)
    make = Inputs(dev)                          # the same on every rank
    frames = make(dtype, (F,) + shape)
    xr = frames.clone().requires_grad_(True)
    ref_out = at.apply_operator(op, xr, differentiable=True)
    g = make(ref_out.dtype, tuple(ref_out.shape))
    (ref,) = torch.autograd.grad(ref_out, xr, g)
    ref_out = ref_out.detach()
    lin = maker(op, mesh)
    local, g_local = shard(frames, mesh), shard(g, mesh)
    torch.cuda.synchronize()
    dist.barrier()
    reset_launches()
    fwd_k1 = bwd_k1 = 0
    with no_plain_routes():
        for _ in range(SHARD_REQUESTS):
            x = local.clone().requires_grad_(True)
            before = cuda_apply.LAUNCHES
            out = lin(x)
            fwd_k1 += cuda_apply.LAUNCHES - before
            before = cuda_apply.LAUNCHES
            (gx,) = torch.autograd.grad(out, x, g_local)
            bwd_k1 += cuda_apply.LAUNCHES - before
        torch.cuda.synchronize()
    ln = cuda_shear.LAUNCHES
    res = {"rank": dist.get_rank(), "device": str(dev),
           "launches": (fwd_k1, bwd_k1, ln["vhshear"], ln["contract"],
                        cuda_apply_2d.LAUNCHES)}
    whole, grad = gather(out.detach(), mesh), gather(gx, mesh)
    res.update(shape=tuple(grad.shape), dtype=str(grad.dtype),
               fwd_equal=same(whole, ref_out),
               fwd_err=max_err(whole, ref_out), equal=same(grad, ref),
               n_diff=int((grad != ref).sum()) if grad.shape == ref.shape
               else -1, max_abs_err=max_err(grad, ref),
               ref_max=float(ref.double().abs().max()),
               out_max=float(ref_out.double().abs().max()))
    if timing:
        res.update(grad_timing(mesh, op, rot, local, g_local, lin, g))
    return res


def grad_timing(mesh, op, rot: bool, local, g_local, lin, g) -> dict:
    """Phase 56's times on one rank: the local transpose's device ms (in
    turns, CUDA events) against its bound, the halo's ms and bytes (the
    separable transpose extends the cotangent, ``_halo_extend``; the ELL
    one returns the halo's sums, ``_halo_reduce``), the sharded transpose
    call's and the whole gradient step's ms (all ranks at once); on one
    rank also the unsharded backward on CUDA events."""
    cols = two_d(mesh)
    if rot:
        n_r, i, _ = t_mesh.axis(mesh, t_mesh.ROWS)
        db, sb, halo = t_sharding._ell_blocks(op, n_r)[:3]
        rows = slice(i * db, (i + 1) * db)
        dev = g_local.device
        b = upload(op.base[rows], dev, torch.int64)
        b = b - b.new_tensor([i * sb - halo, 0])
        w = upload(op.weights[rows], dev, torch.float32)
        qshape = (sb + 2 * halo, op.spec.qrot_shape[1])
        scatter = lambda: apply_ops.apply_ell_transpose(g_local, b, w, qshape)
        ext = scatter()
        K = op.window
        res = {"local_ms": turns_ms(scatter, 20),
               "local_bound_ms": bound(
                   g_local.nbytes + w.nbytes + b.numel() * 4 + ext.nbytes,
                   2 * g_local.numel() * K * K)["bound_ms"],
               "halo_rows": halo}
        before = t_mesh.TRAFFIC["p2p"]
        t_sharding._halo_reduce(ext, halo, mesh)
        res["halo_bytes"] = t_mesh.TRAFFIC["p2p"] - before
        res["halo_ms"] = wall_ms(
            lambda: t_sharding._halo_reduce(ext, halo, mesh), 10)
        res.update(call_timing(
            mesh, lambda: t_sharding.sharded_apply_ell_transpose(
                g_local, op, mesh),
            lambda: at.apply_operator_transpose(op, g)))
    else:
        ty, tx = t_sharding._folded_transposes(op, cols)
        halos, ext, y, x = band_shard(g_local, ty, tx, mesh)
        transpose = (t_sharding.sharded_apply_separable_2d_transpose if cols
                     else t_sharding.sharded_apply_separable_transpose)
        res = shard_timing(
            g_local, halos, mesh,
            lambda: cuda_apply.apply_separable_kernel(
                ext, y.start, y.weights.astype(np.float32),
                np.ascontiguousarray(x.start, dtype=np.int32),
                x.weights.astype(np.float32)),
            lambda: transpose(g_local, op, mesh),
            lambda: at.apply_operator_transpose(op, g))
        res["local_bound_ms"] = local_bound(ext, y, x)
        res["ext_shape"] = tuple(ext.shape)

    def step():
        x = local.clone().requires_grad_(True)
        torch.autograd.grad(lin(x), x, g_local)

    res["step_ms"] = wall_ms(step, 10)
    return res


def _report_grad(what: str, mesh_shape, backend: str, res: list) -> None:
    """Check and print one phase-56 case's ranks: 2 kernel-1 launches a
    rank in the forwards and 2 in the backwards (separable) or 2 + 2 of
    the fused shear and the contraction (rotated); the gathered forward
    and gradient against the unsharded ones: bit-equal at quadrant 0
    (separable and rotated forward), the fold within 1e-6 x max|ref|
    (its bit equality printed), the rotated gradient (the scatter's
    atomics) within f32 atol 1e-5."""
    n = SHARD_REQUESTS
    want = (0, 0, n, n, 0) if what == "grad_rot" else (n, n, 0, 0, 0)
    for r in res:
        check(tuple(r["launches"]) == want,
              f"[56] {what} {mesh_shape} {backend}: rank {r['rank']} "
              f"launched (kernel 1 forward, kernel 1 backward, fused shear, "
              f"contraction, kernel 2) {tuple(r['launches'])}, want {want}")
    err = max(r["max_abs_err"] for r in res)
    ferr = max(r["fwd_err"] for r in res)
    exact = all(r["equal"] for r in res)
    fexact = all(r["fwd_equal"] for r in res)
    if what == "grad_bf16":
        check(exact and fexact, f"[56] {what} {mesh_shape} {backend}: not "
              f"bit-equal to the unsharded forward ({ferr:.3e}) and "
              f"backward ({err:.3e}, "
              f"{sum(r['n_diff'] for r in res)} elements differ)")
        verdict = "forward and gradient bit-equal to the unsharded ones"
    elif what == "grad_fold90":
        tol, ftol = 1e-6 * res[0]["ref_max"], 1e-6 * res[0]["out_max"]
        check(err <= tol and ferr <= ftol,
              f"[56] {what}: forward err {ferr} > {ftol} or gradient err "
              f"{err} > {tol}")
        verdict = (f"forward max err {ferr:.3e} (bit-equal {fexact}), "
                   f"gradient max err {err:.3e} <= {tol:.3e} (bit-equal "
                   f"{exact}; {sum(r['n_diff'] for r in res)} elements "
                   f"differ)")
    else:
        check(fexact and err <= 1e-5,
              f"[56] {what}: forward bit-equal {fexact}, gradient err "
              f"{err} > 1e-5")
        verdict = (f"forward bit-equal, gradient max err {err:.3e} <= 1e-5 "
                   f"(bit-equal {exact})")
    print(f"[56 sharded gradient] {what} mesh {mesh_shape} over {len(res)} "
          f"{backend} rank(s) on {sorted({r['device'] for r in res})}: "
          f"gradient {res[0]['shape']} {res[0]['dtype']}, launches per rank "
          f"{[tuple(r['launches']) for r in res]}, {verdict}")


def _grad_timing_line(card: str, what: str, mesh_shape, backend, res: list,
                      shared: bool) -> dict:
    row = {"phase": "56", "case": what, "mesh": list(mesh_shape),
           "backend": backend, "ranks_share_one_card": shared,
           **{k: [r[k] for r in res] for k in
              ("local_ms", "local_bound_ms", "halo_rows", "halo_ms",
               "halo_bytes", "halo_cols", "halo_ms_cols", "halo_bytes_cols",
               "call_ms", "step_ms", "ext_shape") if k in res[0]}}
    for k in ("unsharded_ms", "call_events_ms"):
        if k in res[0]:
            row[k] = res[0][k]
    local = "scatter (index_add_)" if what == "grad_rot" else "kernel 1"
    halo = ("_halo_reduce" if what == "grad_rot"
            else "the cotangent's _halo_extend")
    cols = (f" + {row['halo_cols'][0]} columns "
            f"{[round(v, 4) for v in row['halo_ms_cols']]} ms"
            if "halo_cols" in row else "")
    print(f"[56 timing] {card}: {what} mesh {mesh_shape} {backend}: local "
          f"transpose ({local}) ms per rank "
          f"{[round(v, 4) for v in row['local_ms']]} against bounds "
          f"{[round(v, 4) for v in row['local_bound_ms']]} (in turns, CUDA "
          f"events); {halo} of {row['halo_rows'][0]} rows "
          f"{[round(v, 4) for v in row['halo_ms']]} ms, bytes "
          f"{row['halo_bytes']}{cols}; sharded transpose call ms "
          f"{[round(v, 4) for v in row['call_ms']]}, gradient step ms "
          f"{[round(v, 4) for v in row['step_ms']]} ("
          + ("ranks that share one card" if shared else "one rank a card")
          + ")")
    if "unsharded_ms" in row:
        print(f"[56 timing] {card}: one {backend} rank, CUDA events: sharded "
              f"transpose {row['call_events_ms']:.4f} ms, unsharded "
              f"transpose {row['unsharded_ms']:.4f} ms")
    return row


def _report(phase: str, what: str, mesh_shape, backend: str, res: list,
            want: tuple, kernels: str = "kernel 1, kernel 2",
            host_rtol: float = 1e-5) -> int:
    """Check and print one case's ranks (``want``: each rank's launches
    of ``kernels``); returns their launches."""
    for r in res:
        check(tuple(r["launches"]) == want,
              f"[{phase}] {what} {mesh_shape} {backend}: rank {r['rank']} "
              f"launched ({kernels}) {tuple(r['launches'])} times, want "
              f"{want}")
    exact = all(r["equal"] for r in res)
    if what.startswith("fold") or what == "rot_fold":
        tol = 1e-5 * res[0]["ref_max"]
        err = max(r["max_abs_err"] for r in res)
        check(err <= tol, f"[{phase}] {what} err {err} > {tol}")
        verdict = (f"max |sharded - unsharded| {err:.3e} <= {tol:.3e} "
                   + ("(bit-equal)" if exact else
                      f"({sum(r['n_diff'] for r in res)} elements differ)"))
    else:
        check(exact, f"[{phase}] {what} {mesh_shape} {backend}: the gathered "
              f"output is not bit-equal to the unsharded call's: "
              + "; ".join(f"rank {r['rank']}: {r.get('n_diff', '?')} "
                          f"elements differ, max {r['max_abs_err']:.3e}"
                          for r in res))
        verdict = "bit-equal to the unsharded call"
    if "flux" in res[0]:
        fd, fs = res[0]["flux"]
        check(all(r["flux"] == res[0]["flux"] for r in res),
              f"[{phase}] the ranks' flux pairs differ")
        check(abs(fd - fs) <= 1e-5 * abs(fs),
              f"[{phase}] flux_dst {fd} vs flux_src {fs}")
        host = res[0]["host_fs"]
        check(abs(fs - host) <= host_rtol * abs(host),
              f"[{phase}] flux_src {fs} vs float64 host sum {host}")
        verdict += (f"; flux dst {fd:.9e} src {fs:.9e} (rel "
                    f"{abs(fd - fs) / abs(fs):.2e}), host float64 "
                    f"{host:.9e}")
    if "nan_rows" in res[0] and res[0]["nan_rows"]:
        verdict += f"; {res[0]['nan_rows']} dst rows without coverage (NaN)"
    print(f"[{phase} sharded] {what} mesh {mesh_shape} over {len(res)} "
          f"{backend} rank(s) on {sorted({r['device'] for r in res})}: "
          f"{res[0]['shape']} {res[0].get('dtype', 'float32')}, "
          f"launches ({kernels}) per rank "
          f"{[tuple(r['launches']) for r in res]}, {verdict}")
    return sum(sum(r["launches"]) for r in res)


def _timing_line(phase: str, card: str, what: str, mesh_shape, backend,
                 res: list, shared: bool) -> dict:
    row = {"phase": phase, "case": what, "mesh": list(mesh_shape),
           "backend": backend, "ranks_share_one_card": shared,
           **{k: [r[k] for r in res] for k in
              ("local_ms", "local_bound_ms", "halo_rows", "halo_ms",
               "halo_bytes", "halo_cols",
               "halo_ms_cols", "halo_bytes_cols", "call_ms", "vhshear_ms",
               "contract_ms", "bounds", "T_loc", "T_aligned", "ext_shape")
              if k in res[0]}}
    for k in ("unsharded_ms", "call_events_ms"):
        if k in res[0]:
            row[k] = res[0][k]
    note = ("ranks that share one card, so not a scaling figure" if shared
            else "one rank a card")
    halo = (f"halo of {row['halo_rows'][0]} rows: ms per rank "
            f"{[round(v, 4) for v in row['halo_ms']]}, bytes sent per rank "
            f"{row['halo_bytes']}")
    if "halo_cols" in row:
        halo += (f"; then {row['halo_cols'][0]} columns of the row-extended "
                 f"block: ms {[round(v, 4) for v in row['halo_ms_cols']]}, "
                 f"bytes {row['halo_bytes_cols']}")
    lb = (f" against bounds {[round(v, 4) for v in row['local_bound_ms']]}"
          if "local_bound_ms" in row else "")
    print(f"[{phase} timing] {card}: {what} mesh {mesh_shape} {backend}: "
          f"local apply ms per rank {[round(v, 4) for v in row['local_ms']]}"
          f"{lb} (in turns, CUDA events); {halo}; whole sharded call ms per rank "
          f"{[round(v, 4) for v in row['call_ms']]} ({note})")
    if "vhshear_ms" in row:
        bounds = [(round(b["shears"], 4), round(b["contract_masked"], 4))
                  for b in row["bounds"]]
        print(f"[{phase} timing] {card}: {what} mesh {mesh_shape} {backend}: "
              f"per rank, in turns, device ms (CUDA-graph replays): fused "
              f"shear "
              f"{[round(v, 4) for v in row['vhshear_ms']]}, contraction ms "
              f"{[round(v, 4) for v in row['contract_ms']]}, their bounds "
              f"{bounds}; extended block {row['ext_shape']}, local T (TH, "
              f"TW_loc) {row['T_loc']}, bf16 rows 16-byte aligned "
              f"{row['T_aligned']}")
    if "unsharded_ms" in row:
        print(f"[{phase} timing] {card}: one {backend} rank, CUDA events per call:"
              f" sharded call {row['call_events_ms']:.4f} ms, unsharded call "
              f"{row['unsharded_ms']:.4f} ms")
    return row


def sharded_phases(card: str) -> dict:
    """Phases 51-56.  Returns the launches of kernels 1 and 2, the fused
    shear and the contraction on the sharded paths, by kernel row:
    ``["rows"]`` of the row-sharded phases 51-53, ``["2d"]`` of the 2-D
    phases 54-55, ``["grad"]`` of the gradient steps of phase 56 (kernel
    1's forwards and, apart, its launches on the transposed bands)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    count = torch.cuda.device_count()
    rot_t0 = time.perf_counter()
    rot_angle = sharded_rot_prep()
    rot_s = [time.perf_counter() - rot_t0]
    launches = {mode: {k: 0 for k in ("separable_apply", "separable_apply_2d",
                                      "vhshear", "contract")}
                for mode in ("rows", "2d", "grad")}
    launches["grad"]["separable_apply_transposed"] = 0
    rows, rot_rows, rows_2d, grad_rows = [], [], [], []
    s2_s, grad_s = [], []

    def run_cases(pool, backend, cases):
        shared = count < pool.world
        for phase, mesh_shape, what, timed in cases:
            t0 = time.perf_counter()
            cols = len(mesh_shape) == 3
            counts = launches["2d" if cols else "rows"]
            if phase == "56":
                res = pool.run(rank_sharded_grad, mesh_shape, what, timed,
                               rot_angle, t_cache.DEFAULT_CACHE_DIR)
                _report_grad(what, mesh_shape, backend, res)
                g = launches["grad"]
                for k, col in (("separable_apply", 0),
                               ("separable_apply_transposed", 1),
                               ("vhshear", 2), ("contract", 3)):
                    g[k] += sum(r["launches"][col] for r in res)
                if timed:
                    grad_rows.append(_grad_timing_line(
                        card, what, mesh_shape, backend, res, shared))
                grad_s.append(time.perf_counter() - t0)
                continue
            if phase in ("53", "55"):
                res = pool.run(rank_sharded_ell, mesh_shape, what, timed,
                               rot_angle, t_cache.DEFAULT_CACHE_DIR)
                _report(phase, what, mesh_shape, backend, res,
                        (SHARD_REQUESTS, SHARD_REQUESTS, 0, 0, 0),
                        "fused shear, contraction, other shear kernels, "
                        "kernel 1, kernel 2", host_rtol=1e-9)
                counts["vhshear"] += sum(r["launches"][0] for r in res)
                counts["contract"] += sum(r["launches"][1] for r in res)
                if timed:
                    (rows_2d if cols else rot_rows).append(_timing_line(
                        phase, card, what, mesh_shape, backend, res, shared))
                (s2_s if cols else rot_s).append(time.perf_counter() - t0)
                continue
            if what in REGRID_CASES:
                per_call = 2 if what == "mask" else 1
                res = pool.run(rank_sharded_regrid, mesh_shape, what, timed)
                n = _report(phase, what, mesh_shape, backend, res,
                            (0, SHARD_REQUESTS * per_call))
                counts["separable_apply_2d"] += n
            else:
                res = pool.run(rank_sharded_flagship, mesh_shape, what, timed)
                n = _report(phase, what, mesh_shape, backend, res,
                            (SHARD_REQUESTS, 0))
                counts["separable_apply"] += n
            if timed:
                (rows_2d if cols else rows).append(_timing_line(
                    phase, card, what, mesh_shape, backend, res, shared))
            if cols:
                s2_s.append(time.perf_counter() - t0)

    def pool_of(world, backend):
        t0 = time.perf_counter()
        pool = t_mesh.RankPool(world, backend=backend, device="cuda")
        pool.run(rank_ready, (1, world))
        print(f"[51 sharded] {world} {backend} rank(s) on {count} card(s) "
              f"ready in {time.perf_counter() - t0:.1f} s"
              + (" (collectives staged through pinned host memory)"
                 if backend == "gloo" else ""))
        return pool

    with pool_of(SHARD_RANKS, "gloo") as pool:
        run_cases(pool, "gloo", GLOO_CASES + SHARD_ROT_CASES + SHARD2D_CASES
                  + SHARD_GRAD_CASES)
    if NCCL_ONE_RANK_CASES:
        with pool_of(1, "nccl") as pool:
            run_cases(pool, "nccl", NCCL_ONE_RANK_CASES)
    if count >= 2:
        k = min(4, count)
        with pool_of(k, "nccl") as pool:
            run_cases(pool, "nccl", (("51", (1, k), "bf16", True),
                                     ("52", (1, k), "plain", True),
                                     ("53", (1, k), "rot_bf16", True),
                                     ("56", (1, k), "grad_bf16", True))
                      + ((("54", (1, 2, 2), "bf16", True),
                          ("55", (1, 2, 2), "rot_bf16", True))
                         if k == 4 else ()))
    else:
        print(f"[51-55 sharded] {count} card: NCCL over several cards (one "
              f"rank a card) did not run")
    print(f"[53 sharded rotated] {sum(rot_s):.1f} s: host {rot_s[0]:.1f} s "
          f"in this process (with phase 55's 2-D plans), then "
          f"{len(rot_s) - 1} cases {[round(v, 1) for v in rot_s[1:]]} s (the "
          f"ranks' first case loads the operator and the plan)")
    print(f"[54-55 sharded 2-D] {sum(s2_s):.1f} s: {len(s2_s)} cases "
          f"{[round(v, 1) for v in s2_s]} s")
    print(json.dumps({"sharded_timing": {"card": card, "rows": rows}}))
    print(json.dumps({"sharded_rotated_timing": {
        "card": card, "angle": rot_angle, "rows": rot_rows,
        "phase_s": sum(rot_s)}}))
    print(json.dumps({"sharded_2d_timing": {
        "card": card, "angle": rot_angle, "rows": rows_2d,
        "phase_s": sum(s2_s)}}))
    print(f"[56 sharded gradient] {sum(grad_s):.1f} s: {len(grad_s)} cases "
          f"{[round(v, 1) for v in grad_s]} s")
    print(json.dumps({"sharded_grad_timing": {
        "card": card, "angle": rot_angle, "rows": grad_rows,
        "phase_s": sum(grad_s)}}))
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on an NVIDIA GPU only", file=sys.stderr)
        return 1
    work = tempfile.mkdtemp(prefix="aainterp_smoke.")
    # the shear plans and operators of every phase go to this run's own
    # disk cache, removed with the run's files at the end
    t_cache.DEFAULT_CACHE_DIR = os.path.join(work, "cache")
    try:
        return run(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def run(work: str) -> int:
    """Phases 1-56; ``work`` is a temporary directory for files."""
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

    # ---- 2. build: every library, all compilers at once ---------------------
    libs = (_build.SEPARABLE, _build.SEPARABLE_2D, _build.ELL_SHEAR,
            _build.SHEAR3_STAGE, _build.PROBES, _build.BAND_PROBES,
            _build.ALIGNED_FUSED, _build.WATCHLIST, _build.DENSE_X,
            _build.NATIVE)
    build_s = _build.timed_build(libs)
    for lib in libs:
        _build.load(lib)
    print(f"[2 build] nvcc {' '.join(_build.NVCC_FLAGS)} "
          f"(separable_apply.cu, separable_apply_2d.cu, ell_shear.cu, "
          f"shear3_stage.cu, probes.cu, band_probes.cu, aligned_fused.cu, "
          f"watchlist.cu, dense_x.cu) "
          f"and g++ "
          f"{' '.join(_build.GXX_FLAGS)} (aainterp_native.cpp), in "
          f"parallel: {build_s:.2f} s")

    # ---- 3. flagship through the public entry point ------------------------
    op0 = operator((H, W), 0.0)
    tabs0 = folded_tables(op0)
    requests = [make(torch.bfloat16) for _ in range(3)]
    torch.cuda.synchronize()
    reset_launches()
    outs = [at.area_average_interpolate(x, *RATIO, ISO, 0.0).dst
            for x in requests]
    torch.cuda.synchronize()
    launches = cuda_apply.LAUNCHES
    check(launches == len(requests),
          f"main path launched the kernel {launches} times for "
          f"{len(requests)} requests")
    check(cuda_apply_2d.LAUNCHES == 0 and
          other_paths_idle(cuda_shear.LAUNCHES, cuda_shear3.LAUNCHES),
          f"the separable path launched another path's kernels: "
          f"{cuda_apply_2d.LAUNCHES} {cuda_shear.LAUNCHES} "
          f"{cuda_shear3.LAUNCHES}")
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
    # the library call: one einsum with the dense operator matrices, bf16
    # like the frames (f32 sums inside each product)
    wy0, wx0 = (torch.as_tensor(m, dtype=torch.bfloat16, device=dev)
                for m in op0.dense())
    # and in f32 on the f32 frames (TF32 off): kernel 1's f32 library call
    wy0f, wx0f = (torch.as_tensor(m, dtype=torch.float32, device=dev)
                  for m in op0.dense())
    batches_f32 = [b.float() for b in batches[:4]]
    batches_u8 = [(b.float() * 255).round().to(torch.uint8)
                  for b in batches[:4]]
    fns = {
        "kernel": lambda b: cuda_apply.apply_separable_kernel(b, *tabs0),
        "kernel_f32": lambda b: cuda_apply.apply_separable_kernel(b, *tabs0),
        "kernel_u8": lambda b: cuda_apply.apply_separable_kernel(b, *tabs0),
        "plain": lambda b: cuda_apply.apply_separable_plain(b, *dev_tabs),
        "api": lambda b: at.apply_operator(op0, b),
        "library": lambda b: torch.einsum("hy,fyx,wx->fhw", wy0, b, wx0),
        "library_f32": lambda b: torch.einsum("hy,fyx,wx->fhw", wy0f, b,
                                              wx0f),
        "copy": lambda b: copy_dst.copy_(b),
    }
    px = F * H * W
    frame_bytes = H * W * 2 + (H // 2) * (W // 2) * 2   # bf16 read + write
    timing = {"card": card, "shape": [F, H, W], "dtype": "bfloat16",
              "bytes_per_frame": frame_bytes}
    # device time (CUDA graphs) and eager per-call time, in turns; kernel 1
    # at f32 and u8 (u8 in, u8 out) on the same frames, device time only
    inputs = {"kernel_f32": batches_f32, "kernel_u8": batches_u8,
              "library_f32": batches_f32}
    for name in ("kernel", "kernel_f32", "kernel_u8", "plain", "library",
                 "library_f32", "copy", "api", "api", "copy", "library_f32",
                 "library", "plain", "kernel_u8", "kernel_f32", "kernel"):
        reps = 10 if name in ("plain", "library", "library_f32") else 30
        for how, timer in (("device", graph_ms), ("eager", eager_ms)):
            if how == "eager" and name in inputs:
                continue
            ms = timer(fns[name], inputs.get(name, batches), reps)
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
    ky, kx = tabs0[1].shape[1], tabs0[3].shape[1]
    flagship_bound = bound(
        F * frame_bytes + table_bytes(*tabs0),
        2 * F * ((H // 2) * W * ky + (H // 2) * (W // 2) * kx))
    dtype_bounds = {
        name: bound(F * (H * W + (H // 2) * (W // 2)) * es
                    + table_bytes(*tabs0),
            2 * F * ((H // 2) * W * ky + (H // 2) * (W // 2) * kx))
        for name, es in (("kernel_f32", 4), ("kernel_u8", 1))}
    for name, b in dtype_bounds.items():
        timing[f"{name}_bound_ms"] = b["bound_ms"]
        timing[f"{name}_share_of_bound"] = b["bound_ms"] / ms[
            f"{name}_device_ms"]
    timing.update(
        library_device_ms=ms["library_device_ms"],
        library_f32_device_ms=ms["library_f32_device_ms"], **flagship_bound,
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
          f"{timing['plain_eager_us_per_frame']:.3f} us/frame; library "
          f"einsum {ms['library_device_ms']:.4f} ms/batch (f32 "
          f"{ms['library_f32_device_ms']:.4f}); bound "
          f"{flagship_bound['bound_ms']:.4f} ms/batch at the published "
          f"peaks ({flagship_bound['bound_by']}); copy "
          f"{timing['copy_gb_s']:.1f} GB/s -> bytes bound "
          f"{bound_us:.3f} us/frame = {timing['bound_gpixel_s']:.3f} Gpixel/s")
    for name, what in (("kernel", "bf16"), ("kernel_f32", "f32"),
                       ("kernel_u8", "u8 -> u8")):
        b = flagship_bound if name == "kernel" else dtype_bounds[name]
        print(f"[8 timing] {card}: kernel 1 {what}: "
              f"{ms[f'{name}_device_ms']:.4f} ms per batch, bound "
              f"{b['bound_ms']:.4f} ms at 3.35 TB/s "
              f"({100 * b['bound_ms'] / ms[f'{name}_device_ms']:.1f} % of it "
              f"reached)")
    print(json.dumps({"timing": timing}))
    del batches, batches_f32, batches_u8, copy_dst, fns, wy0f, wx0f

    rot_op, rot_plan, rotated = rotated_phases(make, card)
    sheared = shear3_phases(make, card)
    banded = regrid_phases(dev, card)
    compat_plan = rotated_rest_phases(make, card, dev)
    cli_phases(dev, work)
    stream_phases(dev, card, work)
    cache_phases(dev, card, work)
    probes = [copy_phases(make, card)] + contract_probe_phases(make, card)
    probes += masked_contract_phase(make, card, rot_op, rot_plan,
                                    compat_plan)
    copy_fill_phase(probes[0], card)
    probes += band_probe_phase(make, card)
    probes += rgb1024_phase(make, card, probes[0])
    probes.append(aligned_fused_phase(make, card))
    probes += watchlist_phase(make, card)
    sharded = sharded_phases(card)
    banded[0]["sharded_launches"] = sharded["rows"]["separable_apply_2d"]
    banded[0]["sharded_2d_launches"] = sharded["2d"]["separable_apply_2d"]
    for row in rotated:
        if row["name"] in ("vhshear", "contract"):
            row["sharded_launches"] = sharded["rows"][row["name"]]
            row["sharded_2d_launches"] = sharded["2d"][row["name"]]
            row["sharded_grad_launches"] = sharded["grad"][row["name"]]

    print(json.dumps({"kernels": [{
        "name": "separable_apply",
        "route": "cuda",
        "source": "aainterp_torch/csrc/separable_apply.cu",
        "replaces": "aainterp/ops/pallas_apply.py:230",
        "launches": launches,
        "max_abs_err": flag_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        **flagship_bound,
        "library_ms": ms["library_device_ms"],
        "sharded_launches": sharded["rows"]["separable_apply"],
        "sharded_2d_launches": sharded["2d"]["separable_apply"],
        "sharded_grad_launches": sharded["grad"]["separable_apply"],
        "sharded_grad_transposed_launches":
            sharded["grad"]["separable_apply_transposed"],
    }] + rotated + sheared + banded + probes}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    sys.exit(rc)
