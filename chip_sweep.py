#!/usr/bin/env python3
"""Timing, plan and ablation sweep of the port's hand-written kernels on one
GPU: the two separable band-apply kernels (``csrc/separable_apply.cu``,
kernel 1, and ``csrc/separable_apply_2d.cu``, kernel 2, both built on
``csrc/band_apply.cuh``), the shear-mode stage kernels
(``csrc/shear3_stage.cu``), the exact rotated route's kernels
(``csrc/ell_shear.cu``), the tensor-core probes: rgb1024's dense-x
probe (``csrc/dense_x.cu``) and the watchlist's high_dot
(``csrc/watchlist.cu``), and the watchlist's two TMA-load probes beside
their library calls.

    python3 chip_sweep.py [--repo DIR] [--cells k1,k2,s3,r]
        [--variants cur,nostage,...] [--set 'MOD.NAME=VALUE;...']...

Cells are chosen by name, or by a prefix of their names (``k1``, ``b``,
``k2``, ``s3``, ``r``, ``p``).  Each is timed as ``chip_smoke.py`` times
it: device ms per batch
from CUDA-graph replays on distinct inputs (``chip_smoke.graph_ms``), best
of two; the cells whose calls are shorter than a replay's host cost
(``k2_direct``, ``high_dot``, the strided probes) with 20 calls in each
graph (``CALLS``).

* ``k1_bf16``, ``k1_f32``, ``k1_u8``: kernel 1 at the flagship, 8 frames
  2160x3840 -> 1080x1920 (4-tap bands);
* ``b_walk2_bf16`` .. ``b_walk4_f32``, ``b_u8convert1`` ..
  ``b_u8convert4``: kernel 1's walk and u8 conversion probe modes
  (``probes/band_probes.py``) on the ``k1_*`` cells' frames, each checked
  bit for bit against its plain version (with ``--repo`` a parent
  checkout's, in the same call); ``b_stage_bf16`` .. ``b_stagey_u8``: its
  stage probes (``stage``, ``stagey``: the stage ring; a parent's first
  form) on the same frames, and ``b_rgb_stage_bf16`` ..
  ``b_rgb_stagey_f32`` at rgb1024, 24 planes of 1024^2 (variants
  ``stnoy``, stagey without its y pass, ``stynoload`` / ``stynotstore``,
  it without its pixel reads / T stores, ``stcols2``, 2 columns a y-pass
  thread for bf16 and f32, ``stnoreuse`` / ``streuse``, every tap read /
  the register shift in every dtype (not f32 alone), ``stmin1``, registers
  uncapped); ``b_u8words``, ``b_xpair``: its u8 word and ratio-2 x-pass
  probes on the stage ring (a parent's first forms), and
  ``b_direct_u8words``, ``b_direct_xpair`` their first forms in this
  checkout; ``b_rgb_xonly_bf16``, ``b_rgb_xonly_f32``: rgb1024's x-only
  probe on the stage ring on 24 planes of the y pass's output, 410 x 1024
  (a parent's first form), and ``b_rgb_direct_xonly_bf16``,
  ``b_rgb_direct_xonly_f32`` its first form in this checkout (variants
  ``xrreuse``, ``xrreuse4``, each source column of a lane's group read
  once, the taps a column shares with the one before taken from
  registers, at 3 or 4 blocks an SM, ``xrmin2``, ``xrmin4``, ``xrmin5``,
  its registers capped for that many blocks an SM (not 3), ``xrnostore``,
  no stores) (variants ``wdbytes``, u8words' y pass reading 4 bytes, not
  one word, ``wdnox`` / ``wdnoy``, without its x pass / y pass,
  ``wdmin3``, its registers capped for 3 blocks an SM (not 4);
  ``prnoy``, xpair without its y sums, ``prmin4``, ``prmin5``,
  registers capped for 4 or 5 blocks an SM (not 3));
* ``k2_f32``, ``k2_bf16``, ``k2_u8``: kernel 2 at the config-5 regrid, 8
  fields 1800x3600 -> 180x360 (12-tap bands); ``k2q_f32``: 0.1 -> 0.25
  degree (720x1440, 5-tap bands); ``k2_direct``: its direct form on 8
  fields 480x480 -> 4x4 (480-tap bands); ``k2_thumb``, ``k2_thumb_f32``:
  the direct form at the 4K -> 16x9 thumbnail, 8 frames of 2160x3840 bf16
  and f32 (242-tap bands, the tables ``apply_operator`` gives it);
* ``s3_quality_s0`` .. ``s3_fast_s2``: the six stages of the shear flagship
  (8 frames of 2048x2048 bf16 at 30 degrees, 1.0 -> 0.5, both
  decompositions), each stage on the plain output of the one before;
* ``r_vshear``, ``r_hshear``, ``r_vhshear``, ``r_contract``: the rotated
  flagship's kernels (the same frames, exact mode): the shear kernel's
  three forms (S from q, T from S, T from q) and the contraction (on the
  plain T; ``r_contract_f32`` on it in f32), at 30 degrees unless ``--set 'sweep.ROT_ANGLE=30.2'`` moves
  them (T's width, so its rows' 16-byte alignment, follows the angle).
  Their tile tables are planned anew under each ``--set``
  (for example ``--set 'cuda_shear._TILES=((32, 128),)'``, or the
  contraction's ``--set 'cuda_shear._CONTRACT_TILES=((16, 32),)'``); the
  contraction's variants ``ctnostage`` (a zeroed window staged), ``ctnoweight``,
  ``ctnostore``, ``ctscalar`` (windows staged element by element),
  ``ctgroup4``, ``ctgroup8`` (weights loaded 4 or 8 taps at a time
  instead of 16), ``ctmin1``, ``ctmin4``, ``ctmin8`` (registers for that
  many blocks an SM instead of 6); the pipelined probe's variants
  ``pipemin2``, ``pipemin4`` (registers for 2 or 4 blocks an SM
  instead of 3), ``pipestage64``, ``pipestage96`` (staging threads
  instead of 128);
* ``p_tshare``, ``p_wshare``, ``p_bothshare``, ``p_pipelined``,
  ``p_noweight``: the contraction's probe modes
  (``probes/rot_experiments.py``) on the ``r_contract`` cell's inputs,
  plan and angle, each checked against its plain version within one bf16
  ulp (noweight's two forms bit for bit, ``torch.equal``); with
  ``--repo`` a parent checkout's probes (before this repo's tiled
  probes: the direct form) in the same call; ``p_direct_noweight``
  (noweight's first form) and ``p_contract_tiled_unmasked`` (the route's
  tiled kernel on the live rectangle, noweight's yardstick): a parent has
  no such cells, leave them out with ``--repo``;
* ``c_4k``, ``c_rot2048``, ``c_rgb1024``, ``c_regrid``: the copy probe
  (``csrc/probes.cu``) at ``chip_smoke.py``'s four copy geometries, 8
  frames each but rgb1024's 24 (its ring: variants ``cstage3``,
  ``cstage4``, ``cstage8``, ``cpiece8``, ``cpiece32``, ``cbps1``,
  ``cbps4``, ``cchunk``, ``copyunits``, ``copyhint``; the parent's grid:
  ``copy*``);
* ``densex_bf16``, ``densex_f32``: the dense-x probe (``band_probes``
  mode ``densex``) at rgb1024, 24 planes of 1024^2 -> 410^2 (variants
  ``dxnoy``, ``dxnomma``, ``dxnoop``, ``dxbare``, ``dxnostore``);
* ``high_dot``: the watchlist's bf16x3 product of (128, 128) f32 at JAX's
  shape, 20 calls in each graph (variants ``hdnomma``, ``hdnosplit``,
  ``hdloads``: loads only; each matches the parent's kernel too);
* ``strided_load``, ``strided_y_bf16``: the watchlist's ``x[:, ::2]`` of
  (120, 3840) f32 and ``f32(x[0, :16, 1, :])`` of (1, 32, 2, 256) bf16 on
  8 seeded inputs, 20 calls in each graph, and ``lib_strided_load``,
  ``lib_strided_y_bf16``, their library calls (the plain versions) in the
  same turns (variants ``sltma``, ``sytma``: a TMA 2-D store of the dense
  output box; ``sl1``, ``sl2``, ``sl8``, ``sl16``: windows of that many
  rows; ``slbox1``: a window as a box a row, each on its own mbarrier; ``slc128``:
  windows of 128 columns; ``sy2``: boxes of two rows; ``slglobal``,
  ``syglobal``: plain 16-byte global loads in place of TMA; ``slnostore``,
  ``synostore``: no stores);
* ``value_slice``, ``vpu_dyn_rows``: the watchlist's ``x[:, ::2] +
  x[:, 1::2]`` of (8, 512) f32 and ``x[off] + x[off + 1]`` of (64, 256)
  f32 at 16 offsets on 8 seeded inputs, 20 calls in each graph, beside
  ``lib_value_slice``, ``lib_vpu_dyn_rows``, their library calls
  (``mosaic_watchlist.LIBRARY``), and ``floor_value_slice``,
  ``floor_vpu_dyn_rows``, their launch floors (an empty kernel launched as
  each is; this checkout's alone) (variants ``nopdl``: both launched
  without the programmatic attribute; ``dyn128``: 128 columns a
  vpu_dyn_rows block);
* ``lib_c_4k``, ``lib_c_rgb1024``: ``copy_`` into a destination of its own
  per input at the copy cells ``c_4k`` and ``c_rgb1024``.

Each cell's kernel output is checked against its plain version first
(kernel 1 and 2 and the contraction within a bf16 ulp or one grey level,
the shear stages and the rotated shear forms bit for bit), except in the build variants that skip work.

``--repo`` imports ``aainterp_torch`` and ``chip_smoke`` from another
checkout (the parent commit, for a before/after comparison in one run on
one card; a checkout whose ``chip_smoke.graph_ms`` takes ``calls``).  ``--variants`` lists build variants: edits of the sources
(``VARIANTS``, regular expression -> replacement per source file), built
with nvcc into ``aainterp_torch/_build/sweep/<variant>/``; a library whose
files a variant does not edit is used as it is.  Each ``--set`` is one
plan setting: ``;``-separated assignments to constants of
``aainterp_torch.ops`` modules, each value a Python literal, made on the
defaults; the plan caches are emptied between settings.  For example,
shear tile shapes: ``--set 'shear3._Y_TILES=((32, 64),);shear3._X_TILES=
((8, 256),);shear3.SMEM_BUDGET=1073741824'``.

Prints the card's name and power limit, then one JSON line per (variant,
setting) with each cell's ms and plan.

``--sass`` instead builds every CUDA library of ``--repo`` (the
production kernels and the probes, all at once) and prints one JSON line
with the SASS instruction count of each kernel function (``cuobjdump
-sass``, names demangled with ``cu++filt``): a source change that must
leave a kernel's code as it was shows the same counts in both checkouts.
"""

from __future__ import annotations

import argparse
import ast
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

NOT_REACHED = "if (off < -(1 << 30)) cp_async16"
# band_apply.cuh's stage ring: the blocks an SM its registers are capped for
STAGE_MIN = r"return P == kRingStage \|\| P == kRingWords \? 4 : sizeof\(Tin\) < 4 \? 3 : 2;"
STAGE_MIN_REST = "P == kRingStage || P == kRingWords ? 4 : sizeof(Tin) < 4 ? 3 : 2;"
# ... and the element sizes whose y pass shifts its registers (f32)
SHIFT_REUSE = r"return sizeof\(Tin\) == 4;"
# ... and the xonly ring's (kRingX) blocks an SM
XRING_MIN = r"if \(P == kRingX\) return 3;"
# ... and its column loop, where each column reads its kx taps; the
# variant xrreuse reads each source column of a lane's group once, a
# column taking the taps it shares with the one before from registers
# (selects), only the new ones read (the design first built: slower)
XR_TAPS = (r"    float acc\[4\];\n#pragma unroll\n    for \(int k = 0; k < 4; \+\+k\) "
           r"\{\n      float v\[n\];\n#pragma unroll\n      for \(int b = 0; b < n; "
           r"\+\+b\) \{\n        const int c = [^\n]*\n        v\[b\] = [^\n]*\n      \}\n")
XR_REUSE = """    float acc[4];
    float v[n] = {};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int dk = k > 0 ? x0[k] - x0[k - 1] : n;
      const int sk = dk >= 0 && dk < d.kx ? dk : n;
#pragma unroll
      for (int b = 0; b < n; ++b) {
        float u = v[b];
        if (b + 1 < n) u = sk == 1 ? v[b + 1] : u;
        if (b + 2 < n) u = sk == 2 ? v[b + 2] : u;
        if (b + 3 < n) u = sk == 3 ? v[b + 3] : u;
        v[b] = u;
      }
#pragma unroll
      for (int b = 0; b < n; ++b) {
        if (b < d.kx && b + sk >= d.kx) {
          const int c = min(max(x0[k] + b, t.xa), t.xb - 1) - t.xa;
          v[b] = to_f32(*reinterpret_cast<const T*>(row + c * ei));
        }
      }
"""
# the r_* cells' angle (``--set 'sweep.ROT_ANGLE=30.2'``): T's width, and
# so the alignment of its rows, moves with it
ROT_ANGLE = 30.0


# contract.cuh's pipelined probe: its blocks an SM, its staging threads
def PIPE_MIN(n):
    return (r"constexpr int kPipeMinBlocks = \d+;",
            f"constexpr int kPipeMinBlocks = {n};")


def PIPE_STAGE(n):
    return (r"constexpr int kStageThreads = \d+;",
            f"constexpr int kStageThreads = {n};")


# dense_x.cu's y-pass tap loops, its wgmma calls, its operator's copies
DX_NOY = (r"for \(int a = 0; a < ky; \+\+a\)", "for (int a = 0; a < 0; ++a)")
DX_NOMMA = (r"hopper::wgmma_bf16<kCols>\(d, [^;]*;", "")
DX_NOOP = [(r"mbar_arrive_expect_tx\((&bar\[[^\]]*\]), kBBytes\);",
            r"mbar_arrive_expect_tx(\1, 0);"),
           (r"hopper::bulk_load\([^;]*;", "")]
# high_dot's wgmma calls and split calls, in this kernel and the parent's
HD_MMA = r"hopper::wgmma_(m64n128k16_bf16|bf16<kDotCols>)\(d, [^;]*;"
HD_SPLIT = r"((hopper::)?split8\(v, )"
HD_SPLIT_OFF = r"if (v[0] == -1.0f) \1"
# strided_load and strided_y_bf16 reading x with plain 16-byte global loads
# (valid at JAX's shapes): the kernel takes x; no TMA, no mbarrier, no block
# barrier, no wait
SL_INIT = (r"  if \(threadIdx\.x == 0\) \{   // the issuing thread[^\n]*\n(?:    [^\n]*\n)*?"
           r"    hopper::tma_load_2d\([^\n]*\n  \}\n  __syncthreads\(\);[^\n]*\n")
SY_INIT = (r"  if \(threadIdx\.x == 0\) \{   // the issuing thread[^\n]*\n(?:    [^\n]*\n)*?"
           r"    hopper::tma_load_4d\([^\n]*\n  \}\n  __syncthreads\(\);[^\n]*\n")
SL_WAIT = r"(const int Wo = W / 2[^\n]*\n)  hopper::mbar_wait\(bar, 0\);\n"
SY_WAIT = r"(const int gc = bc / 4[^\n]*\n)  hopper::mbar_wait\(bar, 0\);\n"
SL_GLOBAL = [
    (r"(float\* __restrict__ out, int R, int W,)",
     r"const float* __restrict__ xg, \1"),
    (r"(static_cast<float\*>\(out\), R, W,)",
     r"static_cast<const float*>(x), \1"),
    (SL_INIT, ""), (SL_WAIT, r"\1"),
    (r"const float\* p = win \+ r \* bc \+ 8 \* g;",
     "const float* p = xg + static_cast<long long>(r0 + r) * W + c0 + 8 * g;")]
SY_GLOBAL = [
    (r"(float\* __restrict__ out, int R, int C,)",
     r"const __nv_bfloat16* __restrict__ xg, int xstride, \1"),
    (r"(static_cast<float\*>\(out\), R, C, frame)",
     r"static_cast<const __nv_bfloat16*>(x) + (static_cast<long long>(frame)"
     r" * rows * m + parity) * C, m * C, \1"),
    (SY_INIT, ""), (SY_WAIT, r"\1"),
    (r"uint2\*>\(tile \+ r \* bc \+ 4 \* q\)",
     "uint2*>(xg + static_cast<long long>(r0 + r) * xstride + c0 + 4 * q)")]
# strided_load's and strided_y_bf16's dynamic shared memory in geometry()
SL_SMEM = (r"(return \{w\.blocks, 1, kLoadThreads, 128 \+ "
           r"static_cast<size_t>\(w\.bc\) \* w\.br \* 4 \+ 8)")
SY_SMEM = (r"(return \{y\.blocks, 1, kYThreads, 128 \+ "
           r"static_cast<size_t>\(y\.bc\) \* y\.br \* 2 \+ 8)")
# strided_load's window as a box a row, each on its own mbarrier, each
# thread waiting for its row's (valid where a row of the window spans a
# multiple of 128 bytes and R of the window rows, as at JAX's shape)
SL_BOX_A_ROW = [
    (r"    hopper::mbar_init\(bar, 1\);\n    hopper::fence_mbarrier_init\(\);\n"
     r"    hopper::mbar_arrive_expect_tx\(bar, win_bytes\);\n"
     r"    hopper::tma_load_2d\(base, &xmap, c0, r0, bar\);",
     "    for (int i = 0; i < br; ++i) hopper::mbar_init(&bar[i], 1);\n"
     "    hopper::fence_mbarrier_init();\n"
     "    for (int i = 0; i < br; ++i) {\n"
     "      hopper::mbar_arrive_expect_tx(&bar[i], bc * 4);\n"
     "      hopper::tma_load_2d(base + i * bc * 4, &xmap, c0, r0 + i, &bar[i]);\n"
     "    }"),
    (SL_WAIT, r"\1"),
    (r"(    if \(oc >= Wo\) continue;\n)", r"\1    hopper::mbar_wait(&bar[r], 0);\n"),
    (r"const cuuint32_t box\[2\] = \{static_cast<cuuint32_t>\(bc\), "
     r"static_cast<cuuint32_t>\(br\)\};",
     "const cuuint32_t box[2] = {static_cast<cuuint32_t>(bc), 1};"),
    (SL_SMEM, r"\1 * w.br")]
# the other store form of both: the threads write the dense output box to
# shared memory, then fence_proxy_async, a block barrier and one TMA 2-D
# store (cp.async.bulk.tensor, added to hopper.cuh by the edit); valid where
# the output rows are whole 16-byte multiples (strided_load: W a multiple
# of 8)
TMA_STORE_2D = (r"(\n// ---- wgmma)", r"""
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, int c0, int c1, const void* src) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}
\1""")
TMA_STORE_TAIL = """
  }
  hopper::fence_proxy_async();
  __syncthreads();
  if (threadIdx.x == 0) {
    hopper::tma_store_2d(&omap, %s, r0, %s);
    hopper::bulk_commit();
    hopper::bulk_wait_all();
  }
}"""
OUT_MAP = """CUtensorMap omap;
  const cuuint64_t odims[2] = {static_cast<cuuint64_t>(%s), static_cast<cuuint64_t>(R)};
  const cuuint64_t ostrides[1] = {%s};
  const cuuint32_t obox[2] = {static_cast<cuuint32_t>(%s), static_cast<cuuint32_t>(br)};
  const int orc = hopper::encode_tiled(&omap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, out, odims,
                                       ostrides, obox);
  if (orc != 0) return orc;
  """
SL_OTILE = "reinterpret_cast<float*>(aligned<128>(base + win_bytes + 8))"
SY_OTILE = "reinterpret_cast<float*>(aligned<128>(base + box_bytes + 8))"
SL_TMA_STORE = {
    "hopper.cuh": [TMA_STORE_2D],
    "watchlist.cu": [
        (r"(float\* __restrict__ out, int R, int W,)",
         r"const __grid_constant__ CUtensorMap omap, \1"),
        (r"(static_cast<float\*>\(out\), R, W,)", r"omap, \1"),
        (r"    if \(oc \+ 4 <= Wo && [^\n]*\n(.*\n){5}  \}\n\}",
         "    *reinterpret_cast<float4*>(" + SL_OTILE + " + r * (bc / 2) + 4 * g) ="
         " make_float4(a.x, a.z, b.x, b.z);"
         + TMA_STORE_TAIL % ("c0 / 2", SL_OTILE)),
        (r"  strided_load_kernel<<<",
         "  " + OUT_MAP % ("W / 2", "2ull * W", "bc / 2") + "strided_load_kernel<<<"),
        (SL_SMEM, r"\1 + 128 + static_cast<size_t>(w.bc / 2) * w.br * 4")]}
SY_TMA_STORE = {
    "hopper.cuh": [TMA_STORE_2D],
    "watchlist.cu": [
        (r"(float\* __restrict__ out, int R, int C,)",
         r"const __grid_constant__ CUtensorMap omap, \1"),
        (r"(static_cast<float\*>\(out\), R, C, frame)", r"omap, \1"),
        (r"\*reinterpret_cast<float4\*>\(out \+ static_cast<long long>\(r0 \+ r\) "
         r"\* C \+ c0 \+ 4 \* q\) = v;\n  \}\n\}",
         "*reinterpret_cast<float4*>(" + SY_OTILE + " + r * bc + 4 * q) = v;"
         + TMA_STORE_TAIL % ("c0", SY_OTILE)),
        (r"  strided_y_kernel<<<",
         "  " + OUT_MAP % ("C", "4ull * C", "bc") + "strided_y_kernel<<<"),
        (SY_SMEM, r"\1 + 128 + static_cast<size_t>(y.bc) * y.br * 4")]}
VARIANTS = {
    "cur": {},
    # the stage ring (band_stage_kernel) without its y pass (T left as it
    # was: the time of the rest); its y pass without its pixel reads (a dependent add in their place)
    # or without its T stores; 2 columns a y-pass thread for bf16 and f32
    # (not 4); every tap read, or the register shift, in every dtype (not
    # by shift_reuse); its registers uncapped (not by stage_min_blocks)
    "stnoy": {"band_apply.cuh": [(r"for \(int it = tid; it < ng \* parts; "
                                  r"it \+= kThreads\)",
                                  "for (int it = tid; it < 0; it += kThreads)")]},
    "stynoload": {"band_apply.cuh": [
        (r"if \(a < ky && a \+ s >= ky\) load_px<Tin, kC>\(q\[a\], row\[a\], colb\);",
         "if (a < ky && a + s >= ky) q[a][0] += 1.0f;")]},
    "stynotstore": {"band_apply.cuh": [
        (r"    st_shared<kC>\(trow \+ r \* tp, acc\);\n  \}\n\}\n\n// the same for bands",
         "    if (acc[0] == -1.0f) trow[0] = acc[1];\n  }\n}\n\n// the same for bands")]},
    "stcols2": {"band_apply.cuh": [(r"constexpr int kFloatCols = 4;",
                                    "constexpr int kFloatCols = 2;")]},
    "stnoreuse": {"band_apply.cuh": [(SHIFT_REUSE, "return false;")]},
    "streuse": {"band_apply.cuh": [(SHIFT_REUSE, "return true;")]},
    "stmin1": {"band_apply.cuh": [(STAGE_MIN, "return 1;")]},
    # the ring's u8words: its y pass reading a tap row's 4 pixels as 4
    # bytes (not one word); without its x pass or its y pass; its
    # registers capped for 3 blocks an SM (not 4)
    "wdbytes": {"band_apply.cuh": [(
        r"(    uint32_t v\[n\];\n#pragma unroll\n    for \(int a = 0; a < "
        r"n; \+\+a\) )v\[a\] = a < nt \? word_at<kAligned>\(row\[a\] \+ pb\) "
        r": 0u;",
        r"extern __shared__ __align__(16) unsigned char smem[];\n\1{\n      const "
        r"unsigned char* q = smem + row[a] + pb;\n      v[a] = a < nt ? (q[0] | q[1] "
        r"<< 8 | q[2] << 16 | static_cast<uint32_t>(q[3]) << 24) : 0u;\n    }")]},
    "wdnox": {"band_apply.cuh": [
        (r"x_pass<Tout, 0>\(T, xt, dt, g, t\.rows, ot\);", "")]},
    "wdnoy": {"band_apply.cuh": [(r"words_y_pass\(T, tp, o, rowtab, [^;]*;", "")]},
    # ... T not shifted to the window's words (o = 0: the words read by
    # funnel shifts, the x pass's taps in 8-byte pairs where production's
    # are); two dst rows of a group in flight at once (not one)
    "wdfunnel": {"band_apply.cuh": [
        (r"const int o = \(window_base<Tin>\(window_src\(src, d, t\), slot\(s\)\) \+ "
         r"t\.cb - t\.xa\) & 3;", "const int o = 0;"),
        (r"const bool aligned = \(g\.pitch_in & 3\) == 0;", "const bool aligned = false;")]},
    "wdunroll2": {"band_apply.cuh": [
        (r"#pragma unroll 1\n  for \(int r = r0; r < r1; \+\+r\) \{\n    const int\* rt = "
         r"rowtab \+ r \* ky;\n    const float\* wt = wtab \+ r \* ky;\n    int row\[n\];",
         "#pragma unroll 2\n  for (int r = r0; r < r1; ++r) {\n    const int* rt = rowtab "
         "+ r * ky;\n    const float* wt = wtab + r * ky;\n    int row[n];")]},
    "wdmin3": {"band_apply.cuh": [(STAGE_MIN, "return P == kRingWords ? 3 : "
                                   + STAGE_MIN_REST)]},
    # the ring's xpair: without its y sums (the x taps on zeros); its
    # registers capped for 4 or 5 blocks an SM (not 3)
    "prnoy": {"band_apply.cuh": [(r"pair_row_sums<kAligned>\(c, [^;]*;", "")]},
    "prmin4": {"band_apply.cuh": [(STAGE_MIN, "return P == kRingPair ? 4 : "
                                   + STAGE_MIN_REST)]},
    "prmin5": {"band_apply.cuh": [(STAGE_MIN, "return P == kRingPair ? 5 : "
                                   + STAGE_MIN_REST)]},
    # the ring's xonly: each source column of a group read once (the
    # shift from the column before), at 3 or 4 blocks an SM; its
    # registers capped for 2, 4 or 5 blocks an SM (not 3); no stores
    "xrreuse": {"band_apply.cuh": [(XR_TAPS, XR_REUSE)]},
    "xrreuse4": {"band_apply.cuh": [(XR_TAPS, XR_REUSE),
                                    (XRING_MIN, "if (P == kRingX) return 4;")]},
    "xrmin2": {"band_apply.cuh": [(XRING_MIN, "if (P == kRingX) return 2;")]},
    "xrmin4": {"band_apply.cuh": [(XRING_MIN, "if (P == kRingX) return 4;")]},
    "xrmin5": {"band_apply.cuh": [(XRING_MIN, "if (P == kRingX) return 5;")]},
    "xrnostore": {"band_apply.cuh": [
        (r"ring_x_store\(out \+ [^;]*;", "if (acc[0] == -1.0f) out[0] = acc[1];")]},
    # the walk probe (band_walk_kernel) without one phase: its consumers'
    # y pass, x pass or stores, or its producer's bulk copies (the expected
    # bytes 0: the passes read stale windows)
    "wknoy": {"band_apply.cuh": [(r"y_pass<Tin, 0, true>\(T, rowtab\(s\)[^;]*;",
                                  "")]},
    "wknox": {"band_apply.cuh": [(r"x_pass<Tout, 0>\(T, x, d, g, t\.rows, ot\);",
                                  "")]},
    "wknostore": {"band_apply.cuh": [
        (r"store_tile\(orow0, ot, d, g, t\.rows, t\.cols, tid\);", "")]},
    "wknocopy": {"band_apply.cuh": [
        (r"hopper::mbar_arrive_expect_tx\(bar, total\);",
         "hopper::mbar_arrive_expect_tx(bar, 0);"),
        (r"hopper::bulk_load\(smem \+ wbase[^;]*;", "")]},
    # u8convert<n> without its conversion (the y pass reads stale chunk
    # buffers) or without its y pass
    "u8noconv": {"band_apply.cuh": [(r"if \(k\.whi <= k\.wlo\) return;",
                                     "return;")]},
    "u8noy": {"band_apply.cuh": [(r"y_pass_cols<__nv_bfloat16>\([^;]*;", "")]},
    # no source window is copied (the passes read stale shared memory)
    "nostage": {
        "band_apply.cuh": [(r"if \(off < nbytes\) cp_async16", NOT_REACHED)],
        "shear3_stage.cu": [(r"if \(off < seg_bytes\) cp_async16",
                             NOT_REACHED)],
        "ell_shear.cu": [(r"if \(off < nbytes\) cp_async16", NOT_REACHED)]},
    # band_apply.cuh: the y pass reads no tap (T = 0 sums)
    "noy": {"band_apply.cuh": [(r"for \(int a = 0; a < ky; \+\+a\)",
                                "for (int a = 0; a < 0; ++a)")]},
    # band_apply.cuh: the x pass reads no tap
    "nox": {"band_apply.cuh": [
        (r"if \(x_pairs\)", "if (false)"),
        (r"if \(b < d\.kx\) acc\.add\(wreg\[b\], tr\[b\]\);", ""),
        (r"for \(int b = 0; b < d\.kx; \+\+b\) acc\.add\(__ldg\(wxj \+ b\), "
         r"tr\[b\]\);", "")]},
    # band_apply.cuh, ell_shear.cu: the output tile is not written out
    "nostore": {"band_apply.cuh": [(r"if \(off >= obytes\) continue;",
                                    "continue;")],
                "ell_shear.cu": [(r"if \(off >= obytes\) continue;",
                                  "continue;")]},
    # ell_shear.cu: empty tiles write nothing (the cost of their zero fill)
    "noempty": {"ell_shear.cu": [(r"const int nc = w\.w - w\.z;",
                                  "const int nc = w.w - w.z;\n"
                                  "  if (nr <= 0) return;")]},
    # ell_shear.cu, block order: the frames of one tile side by side on
    # grid.x (tile-major), or each frame's tiles column by column
    "tilemajor": {"ell_shear.cu": [(
        r"const int tile = blockIdx\.x % g\.n_tiles;\n"
        r"  const long long f = blockIdx\.x / g\.n_tiles;",
        "const int n_f = gridDim.x / g.n_tiles;\n"
        "  const int tile = blockIdx.x / n_f;\n"
        "  const long long f = blockIdx.x % n_f;")]},
    "colmajor": {"ell_shear.cu": [(
        r"const int tile = blockIdx\.x % g\.n_tiles;",
        "const int n_ty = g.n_tiles / g.n_tx;\n"
        "  const int walk = blockIdx.x % g.n_tiles;\n"
        "  const int tile = (walk % n_ty) * g.n_tx + walk / n_ty;")]},
    # separable_apply_2d.cu, the direct form: groups of 4 rows in the y
    # pass's ring instead of 8, 2 groups of 32 taps in the x pass instead
    # of 4
    "group4": {"separable_apply_2d.cu": [(r"constexpr int kGroupRows = 8;",
                                          "constexpr int kGroupRows = 4;")]},
    "xgroups2": {"separable_apply_2d.cu": [(r"constexpr int kXGroups = 4;",
                                            "constexpr int kXGroups = 2;")]},
    # the direct form's ablations: no x pass, no y pass (the x pass reads
    # stale T), the y pass's ring without its weights
    "noxpass": {"separable_apply_2d.cu": [(r"  switch \(out_code\) \{\n"
                                           r"    case 0: return direct_x",
                                           "  return 0;\n  switch (out_code) "
                                           "{\n    case 0: return direct_x")]},
    "noypass": {"separable_apply_2d.cu": [(r"if \(a\.span > 0\) \{",
                                           "if (false) {")]},
    "nowload": {"separable_apply_2d.cu": [(
        r"wv\[r\] = wmine\[wget \+ r\];", "wv[r] = 1.0f;")]},
    # band_apply.cuh: 8 columns per lane in the y pass instead of 4
    "lane8": {"band_apply.cuh": [(r"constexpr int kLaneCols = 4;",
                                  "constexpr int kLaneCols = 8;")]},
    # shear3_stage.cu: 256 threads per block instead of 128; ell_shear.cu:
    # 128 instead of 256
    "t256": {"shear3_stage.cu": [(r"constexpr int kThreads = 128;",
                                  "constexpr int kThreads = 256;")]},
    "t128": {"ell_shear.cu": [(r"constexpr int kThreads = 256;",
                               "constexpr int kThreads = 128;")]},
    # probes.cu, the copy's grid: 1024 or 512 threads per block instead of
    # 128, parts of 4 sweeps instead of 1
    "copy1024": {"probes.cu": [(r"constexpr int kCopyThreads = 128;",
                                "constexpr int kCopyThreads = 1024;")]},
    "copy512": {"probes.cu": [(r"constexpr int kCopyThreads = 128;",
                               "constexpr int kCopyThreads = 512;")]},
    "copypart4": {"probes.cu": [(
        r"constexpr long long kPartBytes = 16LL \* kUnroll \* kCopyThreads;",
        "constexpr long long kPartBytes = 4 * 16LL * kUnroll * kCopyThreads;")]},
    # probes.cu, the copy's ring: 3, 4 or 8 stages instead of 2, pieces of
    # 8 or 32 KB instead of 16, 1 or 4 blocks an SM instead of 2; every
    # span on the word-and-unit path (no bulk copies); streaming loads and
    # stores on that path (on the parent's grid: every byte)
    "cstage3": {"probes.cu": [(r"constexpr int kStages = 2;",
                               "constexpr int kStages = 3;")]},
    "cstage4": {"probes.cu": [(r"constexpr int kStages = 2;",
                               "constexpr int kStages = 4;")]},
    "cstage8": {"probes.cu": [(r"constexpr int kStages = 2;",
                               "constexpr int kStages = 8;")]},
    "cpiece8": {"probes.cu": [(r"kPieceBytes = 16 \* 1024;",
                               "kPieceBytes = 8 * 1024;")]},
    "cpiece32": {"probes.cu": [(r"kPieceBytes = 16 \* 1024;",
                                "kPieceBytes = 32 * 1024;")]},
    "cbps1": {"probes.cu": [(r"constexpr int kBlocksPerSm = 2;",
                             "constexpr int kBlocksPerSm = 1;")]},
    "cbps4": {"probes.cu": [(r"constexpr int kBlocksPerSm = 2;",
                             "constexpr int kBlocksPerSm = 4;")]},
    # probes.cu: each block a contiguous range of pieces instead of every
    # G-th piece
    "cchunk": {"probes.cu": [(
        r"const long long lo = blockIdx\.x, step = gridDim\.x, hi = pieces;",
        "const long long lo = pieces * blockIdx.x / gridDim.x, step = 1, "
        "hi = pieces * (blockIdx.x + 1) / gridDim.x;")]},
    "copyunits": {"probes.cu": [
        (r"if \(\(addr\(ss\) \^ addr\(dd\)\) & 15\) continue;", "continue;"),
        (r"if \(\(mis & 15\) == 0\) \{", "if (false) {")]},
    "copyhint": {"probes.cu": [
        (r"r\[u\] = su\[i \+ u \* step\];",
         "r[u] = __ldcs(su + i + u * step);"),
        (r"du\[i \+ u \* step\] = r\[u\];",
         "__stcs(du + i + u * step, r[u]);")]},
    # contract.cuh, the tiled contraction: no T read (a zeroed window is
    # staged), no weight read (1.0), no sums stored (the dead pixels' and
    # tiles' zeros are); every window staged element by element
    "ctnostage": {"contract.cuh": [(
        r"if \(4 \* h \+ i < nf\) u = __ldg\([^;]*;", "")]},
    "ctnoweight": {"contract.cuh": [(
        r"w2\[static_cast<long long>\(k0 \+ j\) \* plane \+ wpix\]", "1.0f")]},
    # contract.cuh: weights loaded 8 or 32 taps at a time instead of 16
    "ctgroup4": {"contract.cuh": [(r"constexpr int kTapGroup = 16;",
                                   "constexpr int kTapGroup = 4;")]},
    "ctgroup8": {"contract.cuh": [(r"constexpr int kTapGroup = 16;",
                                   "constexpr int kTapGroup = 8;")]},
    # contract.cuh: registers sized for 1, 4 or 8 blocks an SM instead of 6
    # (at most 255, 64 or 32 a thread instead of 40)
    "ctmin1": {"contract.cuh": [(r"constexpr int kTiledMinBlocks = 6;",
                                 "constexpr int kTiledMinBlocks = 1;")]},
    "ctmin4": {"contract.cuh": [(r"constexpr int kTiledMinBlocks = 6;",
                                 "constexpr int kTiledMinBlocks = 4;")]},
    "ctmin8": {"contract.cuh": [(r"constexpr int kTiledMinBlocks = 6;",
                                 "constexpr int kTiledMinBlocks = 8;")]},
    "ctnostore": {"contract.cuh": [(r"if \(i < nf\) store\(o \+ i \* plane, "
                                    r"acc\[i\]\);", "")]},
    "ctscalar": {"contract.cuh": [(r"const bool chunked = vec && ",
                                   "const bool chunked = false && vec && ")]},
    # contract.cuh, the pipelined probe: registers for 2 or 4 blocks
    # an SM (80 or 40 a thread) instead of 3 (56); 64 or 96 staging threads
    # instead of 128
    "pipemin2": {"contract.cuh": [PIPE_MIN(2)]},
    "pipemin4": {"contract.cuh": [PIPE_MIN(4)]},
    "pipestage64": {"contract.cuh": [PIPE_STAGE(64)]},
    "pipestage96": {"contract.cuh": [PIPE_STAGE(96)]},
    # shear3_stage.cu: no output or mid cell is computed (zeros stored)
    "nocompute": {"shear3_stage.cu": [
        (r"out_cells<kForm, kVec>\([^;]*;",
         "for (int q = 0; q < kVec; ++q) r[q] = 0.0f;"),
        (r"band_rows<kVec>\(bv, t, mlo \+ mi, s\.K, r\);",
         "for (int q = 0; q < kVec; ++q) r[q] = 0.0f;")]},
    # dense_x.cu: the y pass reads no tap; no wgmma is issued; no output
    # is stored
    "dxnoy": {"dense_x.cu": [DX_NOY]},
    "dxnomma": {"dense_x.cu": [DX_NOMMA]},
    "dxnostore": {"dense_x.cu": [(r"if \(row >= Hd \|\| col >= Wd\) continue;",
                                  "continue;")]},
    # dense_x.cu: no operator is copied (the barriers expect no bytes)
    "dxnoop": {"dense_x.cu": DX_NOOP},
    # dense_x.cu: none of the three (the windows' loads, split, barriers
    # and stores are left)
    "dxbare": {"dense_x.cu": [DX_NOY, DX_NOMMA] + DX_NOOP},
    # watchlist.cu's high_dot, this kernel's and the parent's: no wgmma; no
    # split (the loads kept, nothing stored); loads only (neither)
    "hdnomma": {"watchlist.cu": [(HD_MMA, "")]},
    "hdnosplit": {"watchlist.cu": [(HD_SPLIT, HD_SPLIT_OFF)]},
    "hdloads": {"watchlist.cu": [(HD_MMA, ""), (HD_SPLIT, HD_SPLIT_OFF)]},
    # watchlist.cu's strided_load and strided_y_bf16: the dense output box
    # written by a TMA 2-D store instead of 16-byte stores; windows of 4 or
    # 16 rows instead of 8, boxes of 2 rows instead of 1; plain 16-byte
    # global loads in place of the TMA box (its barrier expects no bytes);
    # no stores (the box is loaded and waited for)
    "sltma": SL_TMA_STORE,
    "sytma": SY_TMA_STORE,
    "sl1": {"watchlist.cu": [(r"kLoadRows = 4,", "kLoadRows = 1,")]},
    "sl2": {"watchlist.cu": [(r"kLoadRows = 4,", "kLoadRows = 2,")]},
    "sl8": {"watchlist.cu": [(r"kLoadRows = 4,", "kLoadRows = 8,")]},
    "sl16": {"watchlist.cu": [(r"kLoadRows = 4,", "kLoadRows = 16,")]},
    "slbox1": {"watchlist.cu": SL_BOX_A_ROW},
    "slc128": {"watchlist.cu": [(r"kLoadCols = 256;", "kLoadCols = 128;")]},
    "sy2": {"watchlist.cu": [(r"kYRows = 1,", "kYRows = 2,")]},
    # tensor maps that promote their boxes' L2 fetches to 256 bytes;
    # strided_load's map prefetched by thread 0 before its barriers
    "l2promo": {"hopper.cuh": [(r"CU_TENSOR_MAP_L2_PROMOTION_NONE",
                                "CU_TENSOR_MAP_L2_PROMOTION_L2_256B")]},
    "slpf": {"watchlist.cu": [(
        r"(  if \(threadIdx\.x == 0\) \{[^\n]*\n)(    hopper::mbar_init\(bar, 1\);\n"
        r"    hopper::fence_mbarrier_init\(\);\n    hopper::mbar_arrive_expect_tx"
        r"\(bar, win_bytes\))",
        r'\1    asm volatile("prefetch.tensormap [%0];" :: "l"(reinterpret_cast<'
        r'uint64_t>(&xmap)) : "memory");\n\2')]},
    "slglobal": {"watchlist.cu": SL_GLOBAL},
    "syglobal": {"watchlist.cu": SY_GLOBAL},
    "slnostore": {"watchlist.cu": [(r"(float\* o = out \+)",
                                    r"if (oc >= 0) continue;\n    \1")]},
    "synostore": {"watchlist.cu": [(r"if \(c0 \+ 4 \* q >= C\) continue;",
                                    "continue;")]},
    # watchlist.cu's value_slice and vpu_dyn_rows (and their launch floors)
    # launched without the programmatic attribute, as <<<>>> launches; the
    # kernels' griddepcontrol instructions are then no-ops
    "nopdl": {"watchlist.cu": [(r"constexpr bool kProgrammatic = true;",
                                "constexpr bool kProgrammatic = false;")]},
    # vpu_dyn_rows with 128 columns a block (32 blocks at JAX's 16 x 256,
    # not 16)
    "dyn128": {"watchlist.cu": [(r"kDynCols = 256;", "kDynCols = 128;")]},
}
# cells timed with this many calls in each CUDA graph (their calls are
# shorter than a replay's host cost)
CALLS = {"k2_direct": 20, "high_dot": 20, "strided_load": 20,
         "strided_y_bf16": 20, "lib_strided_load": 20,
         "lib_strided_y_bf16": 20, "value_slice": 20, "vpu_dyn_rows": 20,
         "lib_value_slice": 20, "lib_vpu_dyn_rows": 20,
         "floor_value_slice": 20, "floor_vpu_dyn_rows": 20}
EXACT = ("cur", "lane8", "t256", "t128", "tilemajor",   # variants that
         "colmajor", "copy1024", "copy512",         # compute everything
         "copypart4", "group4", "xgroups2", "sltma", "sytma", "sl1", "sl2",
         "sl8", "sl16", "slbox1", "slc128", "sy2", "slglobal", "syglobal",
         "cstage3", "cstage4", "cstage8", "cpiece8", "cpiece32", "cbps1",
         "cbps4",
         "copyunits", "copyhint", "ctscalar", "ctgroup4", "ctgroup8",
         "cchunk", "ctmin1", "ctmin4", "ctmin8", "pipemin2", "stcols2", "stnoreuse", "streuse", "stmin1",
         "wdbytes", "wdmin3", "prmin4", "prmin5", "wdfunnel", "wdunroll2",
         "xrreuse", "xrreuse4", "xrmin2", "xrmin4", "xrmin5",
         "pipemin4", "pipestage64", "pipestage96", "nopdl", "dyn128")


def variant_sources(lib, name: str) -> dict:
    """{file name: text} of ``lib``'s source and headers with ``name``'s
    edits, or {} where the variant edits none of them."""
    edits = VARIANTS[name]
    if not edits:
        return {}
    files = (lib.source,) + tuple(getattr(lib, "headers", ()))
    if not any(p.name in edits for p in files):
        return {}
    texts = {}
    for path in files:
        text = path.read_text()
        for pattern, repl in edits.get(path.name, ()):
            text, n = re.subn(pattern, repl, text)
            if n == 0:
                raise RuntimeError(f"variant {name}: {pattern!r} not in "
                                   f"{path.name}")
        texts[path.name] = text
    return texts


def build_variant(_build, libs, name: str) -> dict:
    """{library name: CDLL} of ``libs`` built with ``name``'s edits (those
    it edits, compiled in parallel), loaded."""
    jobs = []
    for lib in libs:
        texts = variant_sources(lib, name)
        if not texts:
            continue
        out = _build.BUILD_DIR / "sweep" / name
        out.mkdir(parents=True, exist_ok=True)
        for fname, text in texts.items():
            (out / fname).write_text(text)
        so = out / f"{lib.name}.so"
        jobs.append((lib, so, subprocess.Popen(
            [_build.compiler_path("nvcc"), *lib.flags, "-o", str(so),
             str(out / lib.source.name)])))
    built = {}
    for lib, so, proc in jobs:
        if proc.wait() != 0:
            raise RuntimeError(f"variant {name}: {lib.name} did not build")
        cdll = ctypes.CDLL(str(so))
        for sym, argtypes, restype in lib.symbols:
            fn = getattr(cdll, sym)
            fn.argtypes = list(argtypes)
            fn.restype = restype
        built[lib.name] = cdll
    return built


def sass_counts(_build, libs) -> dict:
    """{library: {kernel function: SASS instructions}} of ``libs`` as
    built (``cuobjdump -sass``; names demangled where ``cu++filt`` is
    there)."""
    bindir = Path(_build.compiler_path("nvcc")).parent
    counts = {}
    for lib in libs:
        so = _build.build(lib)
        text = subprocess.run([str(bindir / "cuobjdump"), "-sass", str(so)],
                              capture_output=True, text=True,
                              check=True).stdout
        fns, name = {}, None
        for line in text.splitlines():
            m = re.match(r"\s*Function : (\S+)", line)
            if m:
                name = m.group(1)
                fns[name] = 0
            elif name and re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+\S", line):
                fns[name] += 1
        filt = bindir / "cu++filt"
        if filt.exists() and fns:
            names = subprocess.run([str(filt)], input="\n".join(fns),
                                   capture_output=True, text=True,
                                   check=True).stdout.splitlines()
            fns = dict(zip(names, fns.values()))
        counts[lib.name] = dict(sorted(fns.items()))
    return counts


def make_cells(dev):
    """{name: (prepare, inputs, tol)}: ``prepare()`` gives (kernel fn,
    plain fn, plan summary) under the current settings, ``inputs()`` the
    cell's distinct inputs (made once), ``tol`` the check's tolerance (0:
    bit for bit)."""
    import numpy as np
    import torch

    import aainterp_torch as at
    from aainterp_torch import api as t_api
    from aainterp_torch.ops import (cuda_apply, cuda_apply_2d, cuda_shear,
                                    cuda_shear3, shear3)

    gen = torch.Generator(device=dev).manual_seed(11)
    made = {}

    def rand(key, shape, dtype, scale=1.0, shift=0.0, n=4):
        if key not in made:
            xs = []
            for _ in range(n):
                x = torch.rand(shape, generator=gen, device=dev)
                xs.append((x * 255).round().to(torch.uint8)
                          if dtype == torch.uint8
                          else (x * scale + shift).to(dtype))
            made[key] = xs
        return made[key]

    op = at.build_operator(at.make_grid_spec((2160, 3840), 2.0, 1.0,
                                             (0.0, 0.0), 0.0))
    t1 = at.separable_linear_for(op, torch.float32, "kernel").tables
    tabs = {}
    for key, dst in (("c5", (180, 360)), ("q", (720, 1440))):
        by, bx = at.conservative_regrid_operator(at.LatLonGrid(1800, 3600),
                                                 at.LatLonGrid(*dst))
        tabs[key] = (by.start, by.weights.astype(np.float32), bx.start,
                     bx.weights.astype(np.float32))
    wide = (np.zeros(4, np.int32), np.full((4, 480), 1 / 480, np.float32))
    tabs["wide"] = wide + wide
    thumb = at.build_operator(at.make_grid_spec((2160, 3840), 240.0, 1.0,
                                                (0.0, 0.0), 0.0))
    tabs["thumb"] = at.separable_linear_for(thumb, torch.float32,
                                            "kernel").tables
    keys = ("TY", "TX", "SY", "SX", "smem", "direct")

    def k1_cell(dtype):
        def prepare():
            p = cuda_apply._plan_for(*t1)
            return (lambda x: cuda_apply.apply_separable_kernel(x, *t1),
                    lambda x: cuda_apply.apply_separable_plain(x, *t1),
                    {k: p[k] for k in keys if k in p})
        return (prepare, lambda: rand(("flag", dtype), (8, 2160, 3840), dtype),
                {torch.uint8: 1.0, torch.bfloat16: 1e-2}.get(dtype, 1e-5))

    def k2_cell(key, dtype, shape=(8, 1800, 3600)):
        t = tabs[key]

        def prepare():
            p = cuda_apply_2d.kernel_plan(*t)
            return (lambda x: cuda_apply_2d.apply_separable_kernel_2d(x, *t),
                    lambda x: cuda_apply_2d.apply_separable_2d_plain(x, *t),
                    {k: p[k] for k in keys if k in p})
        # fields of 250-300: one bf16 ulp is 2
        return (prepare, lambda: rand((shape, dtype), shape, dtype, 50.0,
                                      250.0),
                {torch.uint8: 1.0, torch.bfloat16: 2.0}.get(dtype, 1e-3))

    cells = {f"k1_{n}": k1_cell(dt) for n, dt in
             (("bf16", torch.bfloat16), ("f32", torch.float32),
              ("u8", torch.uint8))}
    cells.update({f"k2_{n}": k2_cell("c5", dt) for n, dt in
                  (("f32", torch.float32), ("bf16", torch.bfloat16),
                   ("u8", torch.uint8))})
    def b_cell(mode, dtype, t=t1, key="flag", shape=(8, 2160, 3840)):
        from aainterp_torch.probes import band_probes

        def prepare():
            p = cuda_apply._plan_for(*t)
            info = {"mode": mode, **{k: p[k] for k in keys if k in p}}
            if mode in getattr(band_probes, "RING_MODES", ()):
                # the ring's blocks an SM, registers, shared memory
                g = band_probes.stage_grid(rand((key, dtype), shape,
                                                dtype)[0], t, mode)
                info.update({k: g[k] for k in (
                    "blocks_per_sm", "registers", "smem")})
            return (lambda x: band_probes.band_probe_kernel(x, t, mode),
                    lambda x: band_probes.band_probe_plain(x, t, mode),
                    info)
        return (prepare, lambda: rand((key, dtype), shape, dtype), 0.0)

    for n in (2, 3, 4):
        for name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            cells[f"b_walk{n}_{name}"] = b_cell(f"walk{n}", dt)
    for n in (1, 2, 4):
        cells[f"b_u8convert{n}"] = b_cell(f"u8convert{n}", torch.uint8)
    t_rgb = at.separable_linear_for(at.build_operator(at.make_grid_spec(
        (1024, 1024), 150.0, 60.0, (0.0, 0.0), 0.0)), torch.float32,
        "kernel").tables
    for mode in ("stage", "stagey"):
        for name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32),
                         ("u8", torch.uint8)):
            cells[f"b_{mode}_{name}"] = b_cell(mode, dt)
            if dt != torch.uint8:
                cells[f"b_rgb_{mode}_{name}"] = b_cell(
                    mode, dt, t_rgb, "rgb", (24, 1024, 1024))
    # u8words and xpair (the stage ring; a parent's first form) and, under
    # names of their own, their first forms
    for mode in ("u8words", "xpair"):
        cells[f"b_{mode}"] = b_cell(mode, torch.uint8)
        cells[f"b_direct_{mode}"] = b_cell(f"{mode}_direct", torch.uint8)
    # xonly at rgb1024 on the y pass's output, (24, 410, 1024) (the stage
    # ring; a parent's first form), and its first form
    for name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        cells[f"b_rgb_xonly_{name}"] = b_cell("xonly", dt, t_rgb, "rgbtmp",
                                              (24, 410, 1024))
        cells[f"b_rgb_direct_xonly_{name}"] = b_cell(
            "xonly_direct", dt, t_rgb, "rgbtmp", (24, 410, 1024))
    cells["k2q_f32"] = k2_cell("q", torch.float32)
    cells["k2_direct"] = k2_cell("wide", torch.float32, (8, 480, 480))
    cells["k2_thumb"] = k2_cell("thumb", torch.bfloat16, (8, 2160, 3840))
    cells["k2_thumb_f32"] = k2_cell("thumb", torch.float32, (8, 2160, 3840))

    spec = at.make_grid_spec((2048, 2048), 1.0, 0.5, (1024.0, 1024.0), 30.0)
    bf16 = torch.bfloat16
    stage_in = {}                   # (dec, i) -> the stage's inputs

    def s3_cell(dec, i):
        plan = t_api._shear3_plan(spec, dec)

        def inputs():
            if (dec, i) not in stage_in:
                xs = rand("s3", (8, 2048, 2048), bf16)
                sp = shear3.stage_plan(plan)
                for k in range(i):
                    plain = getattr(shear3, f"{sp.stages[k].axis}stage_plain")
                    xs = [plain(x, sp, k, out_dtype=bf16) for x in xs]
                stage_in[(dec, i)] = xs
            return stage_in[(dec, i)]

        def prepare():
            sp = shear3.stage_plan(plan)
            st = sp.stages[i]
            kern = getattr(cuda_shear3, f"{st.axis}stage_kernel")
            plain = getattr(shear3, f"{st.axis}stage_plain")
            return (lambda x: kern(x, sp, i, out_dtype=bf16),
                    lambda x: plain(x, sp, i, out_dtype=bf16),
                    {"axis": st.axis, "form": st.form, "TL": st.tiles.TL,
                     "TU": st.tiles.TU,
                     "direct": getattr(st.tiles, "direct", False)})
        return prepare, inputs, 0.0

    for dec in ("quality", "fast"):
        for i in range(3):
            cells[f"s3_{dec}_s{i}"] = s3_cell(dec, i)

    rot = {}                        # the rotated flagship's plan, made once

    def rot_plan():
        if rot.get("angle") != ROT_ANGLE:
            op = at.build_operator(at.make_grid_spec(
                (2048, 2048), 1.0, 0.5, (1024.0, 1024.0), ROT_ANGLE))
            rot.update(angle=ROT_ANGLE, plan=cuda_shear.kernel_plan(op),
                       q=rand("s3", (8, 2048, 2048), bf16))
        return rot["plan"]

    def r_cell(name, dtype=bf16):
        def inputs():
            plan, qs = rot_plan(), rot["q"]
            if name in ("vshear", "vhshear"):
                return qs
            if name == "hshear":
                return [cuda_shear.vshear_plain(q, plan) for q in qs]
            return [cuda_shear.hshear_plain(cuda_shear.vshear_plain(
                q, plan), plan).to(dtype) for q in qs]

        def prepare():
            plan = rot_plan()
            summary = {"angle": ROT_ANGLE, "TW": plan.TW, "Ka": plan.Ka,
                       "Kb": plan.Kb}
            if hasattr(plan, "form_tiles"):     # not in older checkouts
                plan.tiles.clear()              # re-planned under --set
                plan.dev.clear()
                if name in cuda_shear.FORMS:
                    t = plan.form_tiles(name)
                    summary = {"TY": t.TY, "TX": t.TX, "rows": t.rows,
                               "cols": t.cols}
            if name == "contract" and hasattr(plan, "contract_plan"):
                es = dtype.itemsize              # the cell's T
                t = plan.contract_plan(es)
                summary.update(TYd=t.TYd, TXd=t.TXd, cells=t.cells,
                               smem=t.smem(es))
            kern = getattr(cuda_shear, f"{name}_kernel")
            plain = getattr(cuda_shear, f"{name}_plain")
            return (lambda x: kern(x, plan), lambda x: plain(x, plan),
                    summary)
        # the contraction's output: one bf16 ulp on [0, 1]; f32 1e-5
        if name != "contract":
            return prepare, inputs, 0.0
        return prepare, inputs, 1e-2 if dtype == bf16 else 1e-5

    for name in ("vshear", "hshear", "vhshear", "contract"):
        if hasattr(cuda_shear, f"{name}_kernel"):
            cells[f"r_{name}"] = r_cell(name)
    cells["r_contract_f32"] = r_cell("contract", torch.float32)

    def p_cell(mode):
        from aainterp_torch.probes import rot_experiments

        prepare_c, inputs, tol = r_cell("contract")

        def prepare():
            summary = prepare_c()[2]     # the plan, re-planned under --set
            plan = rot_plan()
            if mode == "contract_tiled_unmasked":
                return (lambda x: rot_experiments
                        .contract_tiled_unmasked_kernel(x, plan),
                        lambda x: rot_experiments
                        .contract_tiled_unmasked_plain(x, plan),
                        {"mode": mode, **summary})
            return (lambda x: rot_experiments.contract_probe_kernel(
                        x, plan, mode),
                    lambda x: rot_experiments.contract_probe_plain(
                        x, plan, mode), {"mode": mode, **summary})
        # this repo's noweight forms (NOWEIGHT): each tap one f32 add in
        # the plain version's order, so bit-equal (tolerance 0:
        # torch.equal); a parent's noweight, before NOWEIGHT, was held
        # within one bf16 ulp of its sums, which reach 25: 0.125
        nw = getattr(rot_experiments, "NOWEIGHT", None)
        if nw is not None and mode in nw:
            return prepare, inputs, 0.0
        return prepare, inputs, 0.125 if mode == "noweight" else tol

    for mode in ("tshare", "wshare", "bothshare", "pipelined", "noweight",
                 "contract_tiled_unmasked"):
        cells[f"p_{mode}"] = p_cell(mode)
    cells["p_direct_noweight"] = p_cell("noweight_direct")

    def c_cell(H, W, ty, dtype, nf):
        from aainterp_torch.probes import copy_ceiling

        def prepare():
            return (lambda x: copy_ceiling.copy_rows_kernel(x, ty),
                    lambda x: copy_ceiling.copy_rows_plain(x, ty),
                    {"tile_y": ty, "frames": nf,
                     "bytes": 2 * nf * (H // ty * ty) * W
                     * torch.empty((), dtype=dtype).element_size()})
        return prepare, lambda: rand(("copy", H, W, dtype), (nf, H, W),
                                     dtype), 0.0

    for name, H, W, ty, dtype, nf in (
            ("4k", 2160, 3840, 120, bf16, 8),
            ("rot2048", 2048, 2048, 128, bf16, 8),
            ("rgb1024", 1024, 1024, 128, bf16, 24),
            ("regrid", 1800, 3600, 120, torch.float32, 8)):
        cells[f"c_{name}"] = c_cell(H, W, ty, dtype, nf)

    def densex_cell(dtype):
        from aainterp_torch.probes import band_probes, rgb1024_experiments

        tables = rgb1024_experiments.tables()

        def prepare():
            return (lambda x: band_probes.band_probe_kernel(x, tables,
                                                            "densex"),
                    lambda x: band_probes.band_probe_plain(x, tables,
                                                           "densex"),
                    {"warpgroups": getattr(band_probes, "DENSE_WARPGROUPS",
                                           {}).get(dtype.itemsize)})
        # densex's checks: f32 1e-5 of max|plain| (<= 1 on [0, 1]), bf16
        # one ulp at 1
        return (prepare, lambda: rand(("rgb", dtype), (24, 1024, 1024),
                                      dtype),
                1e-5 if dtype == torch.float32 else 2.0 ** -8)

    cells["densex_bf16"] = densex_cell(bf16)
    cells["densex_f32"] = densex_cell(torch.float32)

    def high_dot_cell():
        from aainterp_torch.probes import mosaic_watchlist as mw

        def prepare():
            return (lambda ab: mw.high_dot_kernel(*ab),
                    lambda ab: mw.high_dot_plain(*ab), {})
        # 1e-5 of max|plain|, at most 128 on [0, 1] inputs
        return (prepare, lambda: [mw.inputs("high_dot", dev, seed)
                                  for seed in range(1, 9)], 128e-5)

    cells["high_dot"] = high_dot_cell()

    def watch_cell(name, what):
        from aainterp_torch.probes import mosaic_watchlist as mw

        _, kernel, plain, _, _ = mw.probe(name)

        def prepare():
            if what == "floor":   # nothing to check: it computes nothing
                return (lambda a: mw.launch_floor(name, *a), None, {})
            # the library call of strided_load and strided_y_bf16 is their
            # plain version
            fn = {"kernel": kernel,
                  "library": mw.LIBRARY.get(name, plain)}[what]
            return lambda a: fn(*a), lambda a: plain(*a), {}
        return (prepare, lambda: [mw.inputs(name, dev, seed)
                                  for seed in range(1, 9)], 0.0)

    for name in ("strided_load", "strided_y_bf16", "value_slice",
                 "vpu_dyn_rows"):
        cells[name] = watch_cell(name, "kernel")
        cells[f"lib_{name}"] = watch_cell(name, "library")
    # the launch floors (a parent before them has no such cells: leave them
    # out with --repo)
    for name in ("value_slice", "vpu_dyn_rows"):
        cells[f"floor_{name}"] = watch_cell(name, "floor")

    def c_lib_cell(H, W, ty, dtype, nf):
        from aainterp_torch.probes import copy_ceiling

        prepare_k, inputs, _ = c_cell(H, W, ty, dtype, nf)
        rows = H // ty * ty

        def prepare():
            # copy_ into a destination of its own per input, as the kernel
            # writes a fresh output per call
            dst = {x.data_ptr(): torch.empty((nf, rows, W), dtype=dtype,
                                             device=dev) for x in inputs()}
            return (lambda x: dst[x.data_ptr()].copy_(x[:, :rows]),
                    lambda x: copy_ceiling.copy_rows_plain(x, ty),
                    prepare_k()[2])
        return prepare, inputs, 0.0

    for name, H, W, ty, dtype, nf in (
            ("4k", 2160, 3840, 120, bf16, 8),
            ("rgb1024", 1024, 1024, 128, bf16, 24)):
        cells[f"lib_c_{name}"] = c_lib_cell(H, W, ty, dtype, nf)
    return cells


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=str(Path(__file__).resolve().parent))
    ap.add_argument("--cells", default="k1,k2,s3,r")
    ap.add_argument("--variants", default="cur")
    ap.add_argument("--set", action="append", default=[])
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.repo).resolve()))
    if args.sass:
        from aainterp_torch import _build
        libs = [lib for lib in vars(_build).values()
                if isinstance(lib, _build.Library) and lib.compiler == "nvcc"]
        _build.build_many(libs)
        print(json.dumps({"repo": args.repo, "sass": sass_counts(
            _build, libs)}), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from aainterp_torch import _build
    from aainterp_torch.ops import cuda_apply, cuda_apply_2d, cuda_shear, shear3

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    cells = make_cells(torch.device("cuda:0"))
    wanted = [c for c in cells
              if any(c.startswith(p) for p in args.cells.split(","))]
    mods = {"cuda_apply": cuda_apply, "cuda_apply_2d": cuda_apply_2d,
            "cuda_shear": cuda_shear, "shear3": shear3,
            "sweep": sys.modules[__name__]}
    caches = (cuda_apply._PLAN_CACHE, cuda_apply_2d._PLAN_CACHE,
              shear3._STAGE_CACHE)
    libs = tuple(getattr(_build, n) for n in (
        "SEPARABLE", "SEPARABLE_2D", "SHEAR3_STAGE", "ELL_SHEAR", "PROBES",
        "BAND_PROBES", "WATCHLIST", "DENSE_X") if hasattr(_build, n))
    defaults = {}      # (module, name) -> value before any setting
    for variant in args.variants.split(","):
        for lib in libs:
            _build._LOADED.pop(lib.name, None)
        _build._LOADED.update(build_variant(_build, libs, variant))
        for setting in args.set or [""]:
            for (mod, name), value in defaults.items():
                setattr(mods[mod], name, value)
            for assign in filter(None, setting.split(";")):
                lhs, value = assign.split("=", 1)
                mod, name = lhs.strip().split(".")
                defaults.setdefault((mod, name), getattr(mods[mod], name))
                setattr(mods[mod], name, ast.literal_eval(value.strip()))
            for c in caches:
                c.clear()
            ms, plans = {}, {}
            for name in wanted:
                prepare, inputs, tol = cells[name]
                xs = inputs()
                fn, plain, plans[name] = prepare()
                if variant in EXACT and plain is not None:
                    got, want = fn(xs[0]), plain(xs[0])
                    err = (got.double() - want.double()).abs().max().item()
                    if err > tol or (tol == 0 and not torch.equal(got, want)):
                        raise RuntimeError(f"{variant} {name}: |kernel - "
                                           f"plain| {err}")
                # calls shorter than a replay's host cost: several a graph
                ms[name] = round(min(cs.graph_ms(fn, xs, 20,
                                                 CALLS.get(name, 1))
                                     for _ in range(2)), 6)
            print(json.dumps({"repo": args.repo, "variant": variant,
                              "set": setting, "card": card, "ms": ms,
                              "plans": plans}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
