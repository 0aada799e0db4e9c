// Shared device code of the two separable band-apply kernels for Hopper
// (sm_90a): csrc/separable_apply.cu (kernel 1, clamped taps) and
// csrc/separable_apply_2d.cu (kernel 2, zero-filled taps, precision modes).
//
// Both compute, per frame f and dst cell (i, j),
//
//   out[f,i,j] = cast( sum_b wx[j,b] * ( sum_a wy[i,a] * src[f, ys[i]+a, xs[j]+b] ) )
//
// with f32 sums, each column's y sum first (taps a in order), then the x sum
// (taps b in order).  Both are bound by bytes: a few multiply-adds per
// source byte, far below the card's operations-per-byte ridge.
//
// The staged form (band_apply_kernel):
//
//   * one block per (frame, column strip, row tile).  A strip is TX dst
//     columns, whose taps lie in the source columns [cb, cb + SX) (host
//     planner, ops/cuda_apply.band_plan); a row tile is TY dst rows, whose
//     taps lie in source rows [rb, rb + SY).  All blocks of all frames go on
//     grid.x, strips fastest, so neighbouring blocks share their halo
//     columns through L2;
//   * the tile's window of source rows is copied raw, in the input's own
//     dtype, into shared memory with 16-byte cp.async: a row's aligned
//     chunks are copied whole and the shared pitch equals the global row
//     stride mod 16, so element (y, x) sits at base + (y - ya) * pitch +
//     (x - xa) * sizeof(Tin) whatever the row's alignment.  A chunk is
//     16-byte aligned and holds at least one byte of the row, so it never
//     leaves the input's memory pages.  Only rows and columns inside the
//     image are copied.  The tile's tap table is built while the copies
//     are in flight.  (The walk probe, kWalk<n> below, takes the other road:
//     a persistent grid, a producer warp filling a ring of n windows with
//     bulk copies, the copy hidden under the consumers' passes.  On the
//     H100 it beat this form by a few per cent where its ring left 3
//     blocks an SM (bf16 walk2, walk3), matched it at 2 (f32 walk2) and
//     lost at 1-2 with the larger rings: the copy is a few per cent of
//     the time, and the passes want the warps of several blocks to hide
//     their shared-memory latency: PERF.md);
//   * y pass (y_pass): each warp takes (dst row, group of 128 window
//     columns) items; a lane computes 4 columns 32 apart and neighbouring
//     lanes read neighbouring pixels.  The tile's tap row offsets and
//     weights are tabled in shared memory, so a tap costs two broadcast
//     reads for 4 columns.  The f32 sums go to T (TY x SX) in shared memory;
//   * x pass: a thread owns one dst column of the strip, its weights (up to
//     kRegTaps) and offset in registers, and walks the tile's rows; lanes
//     on neighbouring columns, taps read as float2 pairs where aligned.
//     Results are cast into an output tile in shared memory laid out like
//     the output rows, and the tile's rows leave with 16-byte stores
//     (scalar stores at the ragged ends of a row).
//
// Measured on the H100 (PERF.md, chip_sweep.py ablations): the copy of
// the windows is 2 % of kernel 1's time and 17 % of kernel 2's at f32; in
// bf16 the y pass is 30 % of both and kernel 1's x pass 28 %, and a
// block's phases (y pass, x pass, stores) do not overlap one another.
//
// Taps outside the image: kClamp (kernel 1) reads the nearest edge pixel,
// as the plain version (ops/apply.apply_separable_banded) does; otherwise
// (kernel 2) a tap reads 0: a tap row outside the image reads a zero row in
// shared memory and a column outside gives T = 0 (the value the sum of
// zero taps gives).  Such taps carry zero weight in every table the port
// builds, so the two agree for finite input.
//
// Probe modes (band_apply_kernel's P, launched by csrc/band_probes.cu, the
// H100 counterparts of benchmarks/flagship_experiments.py,
// u8_experiments.py and rgb1024_experiments.py): the production kernel is
// P = kNone; each other mode changes one thing of it (Probe, below) in an
// `if constexpr` branch and stores one value per dst element through the
// production's output tile, so a redesign of the kernel carries the probes
// with it.  The walk (band_walk_kernel) runs the same phases, as functions,
// on a persistent grid whose blocks take their windows from a ring that a
// producer warp fills with bulk copies.  The stage ring (band_stage_kernel)
// runs kStage's, kStageY's, kU8Words' and kXPair's functions on the same
// kind of grid (kRingStage .. kRingPair): stagey with a y pass of its own
// (stage_y_pass, register-blocked over a tile's rows), u8words with one
// aligned word a tap row into a T shifted to the window's words
// (words_y_pass) and production's x pass, xpair with no T at all (each
// lane's column sums feed its 4 dst columns from registers, pair_tile).
// The kStage, kStageY, kU8Words and kXPair branches of band_apply_kernel
// stay as their first forms (the modes stage_direct .. xpair_direct).
//
// Arithmetic modes (kernel 2's precision knob, pallas_apply.py:798-846):
//   0  IEEE f32 products and sums;
//   1  bf16 operands, f32 sums: weights, pixels and the y-pass intermediate
//      are rounded to bf16 (nearest even) where they are used;
//   2  'bf16x3': operands split into hi = bf16(x), lo = bf16(x - hi); per
//      contraction three sums hi.hi, hi.lo, lo.hi added as (s1 + s2) + s3
//      in _dot_bf16x3's order.
// Modes 1 and 2 multiply bf16 values, whose products are exact in f32, and
// sum taps in order from 0, so ops/cuda_apply_2d.apply_separable_2d_plain
// reproduces them bit for bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <climits>

#include "hopper.cuh"
#include "stage_common.cuh"

// internal linkage: each library that includes this header keeps its own
// kernels and its own once-per-device opt-in flags
namespace {
namespace band {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLaneCols = 4;                   // y pass: columns per lane
constexpr int kRegTaps = 16;                   // x pass: taps kept in registers

using stage::cp_async16;
using stage::seg_pitch;
using stage::up16;
using Walk = stage::Walk<kThreads>;

// a barrier of the kThreads consumer threads alone (the walk's producer
// warp, threads kThreads.., takes no part)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(uint8_t v) { return static_cast<float>(v); }

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store(uint8_t* p, float v) {
  // round half to even, then saturate (NaN saturates to 0)
  *p = static_cast<uint8_t>(fminf(fmaxf(rintf(v), 0.0f), 255.0f));
}

// One contraction sum_k w[k] * v[k] in mode MODE, taps added in order; v
// is already bf16-rounded in mode 1.  In mode 2 the middle sum is w_hi.v_lo
// when DATA_LO_FIRST (the y pass) and w_lo.v_hi otherwise (the x pass), as
// _dot_bf16x3 orders its three dots.
template <int MODE, bool DATA_LO_FIRST>
struct Acc {
  float s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
  __device__ __forceinline__ void add(float w, float v) {
    if (MODE == 0) {
      s1 = fmaf(w, v, s1);
    } else if (MODE == 1) {
      s1 = fmaf(bf16r(w), v, s1);
    } else {
      const float wh = bf16r(w);
      const float wl = bf16r(w - wh);
      const float vh = bf16r(v);
      const float vl = bf16r(v - vh);
      s1 = fmaf(wh, vh, s1);
      if (DATA_LO_FIRST) {
        s2 = fmaf(wh, vl, s2);
        s3 = fmaf(wl, vh, s3);
      } else {
        s2 = fmaf(wl, vh, s2);
        s3 = fmaf(wh, vl, s3);
      }
    }
  }
  __device__ __forceinline__ float sum() const { return MODE == 2 ? (s1 + s2) + s3 : s1; }
};

struct Dims {
  int H, W, Hd, Wd, ky, kx;
  int TY, TX, SY, SX;  // tile, spans
  int n_strip, n_rt;
};

// the block's shared-memory layout (byte offsets), from the host
struct Geo {
  int pitch_in;   // bytes per staged source row
  int zero_off;   // a row of zeros (zero fill)
  int t_off;      // (TY, SX) f32 y-pass rows
  int tab_off;    // (TY, ky) int tap row offsets, then (TY, ky) f32 weights
  int o_off;      // output tile
  int pitch_out;  // bytes per output tile row
  int smem;       // total
};

// rows [ya, yb) and columns [xa, xb) of a window that the image holds; kClamp
// keeps at least the edge pixel the clamped taps read
template <bool kClamp>
__device__ __forceinline__ void clip(int lo, int n, int size, int& a, int& b) {
  if (kClamp) {
    a = min(max(lo, 0), size - 1);
    b = min(max(lo + n - 1, 0), size - 1) + 1;
  } else {
    a = max(lo, 0);
    b = min(lo + n, size);
  }
}

// The taps of one y-pass item: acc[q] += wy[a] * pixel(tap row a, column q)
// for the lane's first nq columns, taps in order.  kAll (nq == kLaneCols)
// drops the test per column: left to itself, the compiler kept it inside
// the loop for some instantiations, and kernel 1's bf16 flagship took 13 %
// longer (PERF.md).
template <typename Tin, int MODE, bool kAll>
__device__ __forceinline__ void y_taps(Acc<MODE, true> (&acc)[kLaneCols], const int* rt_r,
                                       const float* wt_r, int ky, const int (&off)[kLaneCols],
                                       int nq) {
  extern __shared__ __align__(16) unsigned char smem[];
  for (int a = 0; a < ky; ++a) {
    const int row = rt_r[a];
    const float wa = wt_r[a];
#pragma unroll
    for (int q = 0; q < kLaneCols; ++q) {
      if (kAll || q < nq) {
        float v = to_f32(*reinterpret_cast<const Tin*>(smem + row + off[q]));
        if (MODE == 1 && sizeof(Tin) == 4) v = bf16r(v);  // bf16 and u8 pixels are exact
        acc[q].add(wa, v);
      }
    }
  }
}

// The y pass of one row tile: T[r, c] = sum_a wy[i0+r, a] * window[tap row,
// cb + c] for the tile's rows over the window's SX columns.  Items are (dst
// row, group of 32 * kLaneCols columns), one warp each; a lane takes
// kLaneCols columns 32 apart, so the row's tap offsets and weights (two
// broadcast reads per tap) serve 4 columns and neighbouring lanes read
// neighbouring pixels.  Columns outside the image's [xa, xb) read the
// clamped pixel; with zero fill they are then set to 0.  (Reading 2 bf16 or
// 4 u8 pixels per 32-bit word instead was slower on the H100: PERF.md; the
// probe mode kU8Words measures the u8 form again.)
template <typename Tin, int MODE, bool kClamp>
__device__ __forceinline__ void y_pass(float* __restrict__ T, const int* rowtab,
                                       const float* wtab, const Dims& d, int rows, int cb,
                                       int xa, int xb) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ei = sizeof(Tin);
  constexpr int kGroup = 32 * kLaneCols;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bool no_cols = xb <= xa;
  const int n_grp = (d.SX + kGroup - 1) / kGroup;
  for (int it = warp; it < rows * n_grp; it += kWarps) {
    const int r = it / n_grp;
    const int c0 = (it - r * n_grp) * kGroup + lane;
    const int nq = min(kLaneCols, (d.SX - (c0 - lane) + 31) / 32);  // warp-uniform
    int off[kLaneCols];
#pragma unroll
    for (int q = 0; q < kLaneCols; ++q) {
      off[q] = no_cols ? 0 : (min(max(cb + c0 + 32 * q, xa), xb - 1) - xa) * ei;
    }
    Acc<MODE, true> acc[kLaneCols];
    const int* rt_r = rowtab + r * d.ky;
    const float* wt_r = wtab + r * d.ky;
    if (nq == kLaneCols) {  // a whole group: no test per tap
      y_taps<Tin, MODE, true>(acc, rt_r, wt_r, d.ky, off, nq);
    } else {
      y_taps<Tin, MODE, false>(acc, rt_r, wt_r, d.ky, off, nq);
    }
#pragma unroll
    for (int q = 0; q < kLaneCols; ++q) {
      const int c = c0 + 32 * q;
      if (q < nq && c < d.SX) {
        float t = acc[q].sum();
        if (MODE == 1) t = bf16r(t);
        if (!kClamp && (cb + c < xa || cb + c >= xb)) t = 0.0f;
        T[r * d.SX + c] = t;
      }
    }
  }
}

// ---- the staged form's phases as functions, for the walk
// (band_walk_kernel): each repeats band_apply_kernel's code for one tile
// (which keeps its own, so that the production kernels' SASS is the one
// they had; the walk's output is held to production's bit for bit) ----

// one block's tile: frame f, strip (dst columns [j0, j0 + cols)), row tile
// (dst rows [i0, i0 + rows)), and its window's clipped source rows [ya, yb)
// and columns [xa, xb) from the strip's first column cb
struct Tile {
  long long f;
  int j0, cols, i0, rows, cb, xa, xb, ya, yb;
};

template <bool kClamp>
__device__ __forceinline__ Tile tile_at(const Dims& d, const int* __restrict__ row_base,
                                        const int* __restrict__ col_base, int strip, int rt,
                                        long long f) {
  Tile t;
  t.f = f;
  t.j0 = strip * d.TX;
  t.cols = min(d.TX, d.Wd - t.j0);
  t.i0 = rt * d.TY;
  t.rows = min(d.TY, d.Hd - t.i0);
  t.cb = col_base[strip];
  clip<kClamp>(t.cb, d.SX, d.W, t.xa, t.xb);
  clip<kClamp>(__ldg(row_base + rt), d.SY, d.H, t.ya, t.yb);
  return t;
}

// the first source byte of the tile's window and the shared byte wbase at
// which it lands when the window is staged at shared byte `base` (a
// multiple of 16): element (y, x) at wbase + (y - ya) * pitch_in + (x - xa)
// * sizeof(Tin)
template <typename Tin>
__device__ __forceinline__ const unsigned char* window_src(const Tin* __restrict__ src,
                                                           const Dims& d, const Tile& t) {
  const Tin* frame = src + t.f * static_cast<long long>(d.H) * d.W;
  return reinterpret_cast<const unsigned char*>(frame + static_cast<long long>(t.ya) * d.W +
                                                t.xa);
}

template <typename Tin>
__device__ __forceinline__ int window_base(const unsigned char* seg0, int base) {
  return base + 16 + static_cast<int>(reinterpret_cast<uintptr_t>(seg0) & 15);
}

// The walk's window loads (band_walk_kernel's producer warp, lane `lane`):
// each row of the tile's window [ya, yb) is one 1-D bulk copy of the
// aligned 16-byte chunks that hold it, landing where the staged form's
// cp.async chunks land (the window at shared byte `base`, a multiple of 16:
// the shared pitch equals the row stride mod 16, so each row's first chunk
// is 16-byte aligned in both spaces).  The rows' bytes are summed over the
// warp and expected on `bar` (lane 0's arrival, which also publishes what
// the warp wrote before it) before any copy is issued.  (A TMA tensor map
// would take two boxes a row, a box holding at most 256 of the SX = 482
// columns at the flagship, and would land them densely, off the layout
// that y_pass reads.)
template <typename Tin>
__device__ __forceinline__ void load_window(const Tin* __restrict__ src, const Dims& d,
                                           const Geo& g, const Tile& t, int base, uint64_t* bar,
                                           int lane) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ei = sizeof(Tin);
  const unsigned char* seg0 = window_src(src, d, t);
  const int wbase = window_base<Tin>(seg0, base);
  const long long stride = static_cast<long long>(d.W) * ei;
  const int nbytes = (t.xb - t.xa) * ei;
  const int rows = t.yb - t.ya;  // clamped taps: at least one row and column
  auto span = [&](int r, int& head) {
    const unsigned char* a = seg0 + r * stride;
    head = static_cast<int>(reinterpret_cast<uintptr_t>(a) & 15);
    return static_cast<uint32_t>(up16(head + nbytes));
  };
  uint32_t mine = 0;
  int head;
  for (int r = lane; r < rows; r += 32) mine += span(r, head);
  const uint32_t total = __reduce_add_sync(0xffffffffu, mine);
  __syncwarp();
  if (lane == 0) hopper::mbar_arrive_expect_tx(bar, total);
  __syncwarp();
  for (int r = lane; r < rows; r += 32) {
    const uint32_t bytes = span(r, head);
    hopper::bulk_load(smem + wbase + r * g.pitch_in - head, seg0 + r * stride - head, bytes, bar);
  }
}

// the tile's taps (clamped), by the lanes of one warp: the shared byte
// offset of each tap row in the window staged at wbase, and its weight
__device__ __forceinline__ void walk_taps(int* rowtab, float* wtab, const int* __restrict__ ys,
                                          const float* __restrict__ wy, const Dims& d,
                                          const Geo& g, const Tile& t, int wbase, int lane) {
  for (int e = lane; e < t.rows * d.ky; e += 32) {
    const int r = e / d.ky;
    const int y = __ldg(ys + t.i0 + r) + (e - r * d.ky);
    rowtab[e] = wbase + (min(max(y, 0), d.H - 1) - t.ya) * g.pitch_in;
    wtab[e] = __ldg(wy + static_cast<long long>(t.i0) * d.ky + e);
  }
}

// x pass: thread (xrg, xj) owns dst column j0 + xj at rows xrg, xrg + n_rg,
// ...; its tap offset into T (xo) and weights in registers
struct XCol {
  int n_rg, xj, xrg, xo;
  bool on, pairs;
  const float* w;
  float wreg[kRegTaps];
};

template <typename Tin>
__device__ __forceinline__ void x_col(XCol& x, const int* __restrict__ xs,
                                      const float* __restrict__ wx, const Dims& d,
                                      const Tile& t, int tid) {
  x.n_rg = kThreads / d.TX;
  x.xj = tid % d.TX;
  x.xrg = tid / d.TX;
  x.on = x.xj < t.cols && x.xrg < x.n_rg;
  x.w = wx + static_cast<long long>(t.j0 + x.xj) * d.kx;
  x.xo = 0;
#pragma unroll
  for (int b = 0; b < kRegTaps; ++b) x.wreg[b] = 0.0f;
  if (x.on) {
    x.xo = __ldg(xs + t.j0 + x.xj) - t.cb;
#pragma unroll
    for (int b = 0; b < kRegTaps; ++b) {
      if (b < d.kx) x.wreg[b] = __ldg(x.w + b);
    }
  }
  // an even tap count on even offsets of even rows: 8-byte aligned pairs
  x.pairs = d.kx <= kRegTaps && d.kx % 2 == 0 && d.SX % 2 == 0 && x.xo % 2 == 0;
}

// the x pass into the output tile, element (r, jj) at ot + r * pitch_out +
// jj * eo, laid out like the output rows
template <typename Tout, int MODE>
__device__ __forceinline__ void x_pass(const float* T, const XCol& x, const Dims& d,
                                       const Geo& g, int rows, unsigned char* ot) {
  constexpr int eo = sizeof(Tout);
  const bool x_pairs = x.pairs;
  const float* wxj = x.w;
  const float(&wreg)[kRegTaps] = x.wreg;
  for (int r = x.on ? x.xrg : rows; r < rows; r += x.n_rg) {
    const float* tr = T + r * d.SX + x.xo;
    Acc<MODE, false> acc;
    if (x_pairs) {  // taps read as float2: half the shared reads
#pragma unroll
      for (int b = 0; b < kRegTaps; b += 2) {
        if (b < d.kx) {
          const float2 t2 = *reinterpret_cast<const float2*>(tr + b);
          acc.add(wreg[b], t2.x);
          acc.add(wreg[b + 1], t2.y);
        }
      }
    } else if (d.kx <= kRegTaps) {
#pragma unroll
      for (int b = 0; b < kRegTaps; ++b) {
        if (b < d.kx) acc.add(wreg[b], tr[b]);
      }
    } else {
      for (int b = 0; b < d.kx; ++b) acc.add(__ldg(wxj + b), tr[b]);
    }
    store(reinterpret_cast<Tout*>(ot + r * g.pitch_out + x.xj * eo), acc.sum());
  }
}

// the tile's rows out: 16-byte stores, scalar at the ragged ends
template <typename Tout>
__device__ __forceinline__ void store_tile(Tout* orow0, const unsigned char* ot, const Dims& d,
                                           const Geo& g, int rows, int cols, int tid) {
  constexpr int eo = sizeof(Tout);
  const long long ostride = static_cast<long long>(d.Wd) * eo;
  const int obytes = cols * eo;
  const int o_chunk = (obytes + 30) / 16;
  for (Walk e(tid, o_chunk); e.r < rows; e.next()) {
    unsigned char* a = reinterpret_cast<unsigned char*>(orow0) + e.r * ostride;
    const int off = e.c * 16 - static_cast<int>(reinterpret_cast<uintptr_t>(a) & 15);
    if (off >= obytes) continue;
    const unsigned char* s = ot + e.r * g.pitch_out;
    if (off >= 0 && off + 16 <= obytes) {
      *reinterpret_cast<uint4*>(a + off) = *reinterpret_cast<const uint4*>(s + off);
    } else {
      for (int k = max(off, 0); k < min(off + 16, obytes); k += eo) {
        *reinterpret_cast<Tout*>(a + k) = *reinterpret_cast<const Tout*>(s + k);
      }
    }
  }
}

// ---- probe modes (csrc/band_probes.cu): each changes one thing of the
// production kernel (kNone) and stores one value per dst element of the
// production's tiles, through the production's output tile and stores ----
enum Probe : int {
  kNone = 0,
  kStage = 1,       // staging and stores only: the first tap's pixel
  kStageY = 2,      // staging, the y pass, stores: T at the first x tap
  kU8Words = 3,     // u8: the y pass reads 4 pixels per 32-bit word (kRingWords' first form)
  kXPair = 4,       // an exact ratio-2 x pass from a (4, Wd) table (kRingPair's first form)
  kU8Convert1 = 5,  // u8: the window converted to bf16 in shared memory ...
  kU8Convert2 = 6,  // ... in 2 column chunks, each then y-passed
  kU8Convert4 = 7,  // ... in 4
  kWalk2 = 8,       // a persistent block walks tiles, a ring of 2 windows
  kWalk3 = 9,       // ... of 3
  kWalk4 = 10,      // ... of 4 (band_walk_kernel)
  kXOnly = 11,      // the x pass alone, T staged from the y pass's output
  kRingStage = 12,  // kStage's function on a persistent ring (band_stage_kernel)
  kRingStageY = 13, // kStageY's
  kRingWords = 14,  // kU8Words' function on the ring: a word a tap row
  kRingPair = 15,   // kXPair's on the ring, its y sums fed to the x taps in registers
};

__host__ __device__ constexpr int convert_chunks(int p) {
  return p == kU8Convert1 ? 1 : p == kU8Convert2 ? 2 : p == kU8Convert4 ? 4 : 0;
}
__host__ __device__ constexpr int walk_slots(int p) {
  return p == kWalk2 ? 2 : p == kWalk3 ? 3 : p == kWalk4 ? 4 : 0;
}

// ---- kU8Convert<n>: the u8 window converted to bf16 in shared memory in
// n column chunks, each then y-passed from its converted copy ----
//
// The chunks cut the window's columns [0, xb - xa) on its 16-byte chunks:
// chunk c takes window columns [wlo, whi), wlo = 16 * (c * nk / n) with nk
// = ceil((xb - xa) / 16), the last one up to xb - xa.  A column's y sum
// does not depend on which chunk holds it, so the cut is free.  Row r's
// column w lies in the aligned shared chunk (m_r + w) / 16 of its row,
// m_r its first pixel's offset in that chunk (rows differ where the row
// stride is no multiple of 16): the chunk converts, for each row, its
// aligned chunks (m_r + wlo) / 16 = wlo / 16 .. (m_r + whi - 1) / 16, each
// by one thread (16 pixels: one 16-byte shared read, two 16-byte stores),
// to 32 bytes at buf + r * cpitch + 32 * (j - wlo / 16).  So (r, w) sits at
// buf + r * cpitch + 2 * m_r + 2 * (w - wlo): the tap table holds r * cpitch
// + 2 * m_r, and the y pass adds buf - 2 * wlo.  A u8 value is exact in
// bf16, so the sums are production's.  (An aligned chunk that holds bytes
// of two column chunks is converted for each.)
//
// Schedule: two chunk buffers.  Chunk 0 is converted, then each step c
// converts chunk c + 1 into the other buffer and y-passes chunk c, one
// block barrier a step: warps that finish converting go on to the y pass
// while others still convert.

// a row's bytes per converted chunk buffer: 32 bytes for each aligned
// chunk a column chunk may take (its share of the SX-column bound, plus
// one where a row starts inside a chunk)
__host__ __device__ constexpr int convert_pitch(int SX, int n) {
  return 32 * (((SX + 15) / 16 + n - 1) / n + 1);
}

// column chunk c of n: window columns [wlo, whi) and the T columns [c_lo,
// c_hi) whose clamped taps read them (T column ct reads window column
// clamp(ct + cb - xa, 0, xb - xa - 1))
struct ColChunk {
  int wlo, whi, c_lo, c_hi;
};

__device__ __forceinline__ int chunk_first_col(int c, int n, int nwin, int d0, int SX) {
  // T columns before the first window column > 0 that a chunk starts on
  // read window column 0 or later ones of the chunks before it
  const int wlo = 16 * (c * ((nwin + 15) / 16) / n);
  return c == 0 || wlo == 0 ? 0 : min(max(wlo - d0, 0), SX);
}

__device__ __forceinline__ ColChunk col_chunk(int c, int n, int nwin, int d0, int SX) {
  const int nk = (nwin + 15) / 16;
  ColChunk k;
  k.wlo = 16 * (c * nk / n);
  k.whi = c == n - 1 ? nwin : 16 * ((c + 1) * nk / n);
  k.c_lo = chunk_first_col(c, n, nwin, d0, SX);
  k.c_hi = c == n - 1 ? SX : chunk_first_col(c + 1, n, nwin, d0, SX);
  return k;
}

// 4 bytes to bf16 exactly, in two 32-bit words (low half: the lower
// address): byte b becomes the float 2^23 + b by prmt, then b by one
// subtraction, and its high 16 bits are b in bf16 (8 significant bits)
__device__ __forceinline__ uint2 bytes_to_bf16(uint32_t w) {
  float f[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    f[b] = __uint_as_float(__byte_perm(w, 0x4Bu, 0x4550u + b)) - 8388608.0f;
  }
  return make_uint2(__byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632u),
                    __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632u));
}

// convert column chunk k of the window (rows [0, rows), staged from shared
// byte wbase at pitch_in) into the buffer at shared byte buf
__device__ __forceinline__ void convert_chunk(int buf, int cpitch, int wbase, int pitch_in,
                                              int rows, const ColChunk& k, int tid) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (k.whi <= k.wlo) return;
  const int j0 = k.wlo / 16;
  const int per_row = (15 + k.whi - 1) / 16 - j0 + 1;  // at most, over the rows
  for (Walk e(tid, per_row); e.r < rows; e.next()) {
    const int row = wbase + e.r * pitch_in;
    if (j0 + e.c > ((row & 15) + k.whi - 1) / 16) continue;
    const uint4 v = *reinterpret_cast<const uint4*>(smem + (row & ~15) + 16 * (j0 + e.c));
    const uint2 p0 = bytes_to_bf16(v.x), p1 = bytes_to_bf16(v.y);
    const uint2 p2 = bytes_to_bf16(v.z), p3 = bytes_to_bf16(v.w);
    uint4* o = reinterpret_cast<uint4*>(smem + buf + e.r * cpitch + 32 * e.c);
    o[0] = make_uint4(p0.x, p0.y, p1.x, p1.y);
    o[1] = make_uint4(p2.x, p2.y, p3.x, p3.y);
  }
}

// The y pass over T columns [c_lo, c_hi) only (MODE 0), pixels read as Tv
// with window column w at byte buf + (w - wlo) * sizeof(Tv) of each tap
// row: the converted chunks of kU8Convert.  The items, lanes and tap order
// are y_pass's.
template <typename Tv>
__device__ __forceinline__ void y_pass_cols(float* __restrict__ T, const int* rowtab,
                                            const float* wtab, const Dims& d, int rows, int cb,
                                            int xa, int xb, int c_lo, int c_hi, int wlo,
                                            int buf) {
  constexpr int kGroup = 32 * kLaneCols;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_grp = (c_hi - c_lo + kGroup - 1) / kGroup;
  for (int it = warp; it < rows * n_grp; it += kWarps) {
    const int r = it / n_grp;
    const int c0 = c_lo + (it - r * n_grp) * kGroup + lane;
    const int nq = min(kLaneCols, (c_hi - (c0 - lane) + 31) / 32);  // warp-uniform
    int off[kLaneCols];
#pragma unroll
    for (int q = 0; q < kLaneCols; ++q) {
      // a column past the chunk (read, not stored) reads its last one:
      // only the chunk's columns are converted
      const int c = min(c0 + 32 * q, c_hi - 1);
      off[q] = buf + (min(max(cb + c, xa), xb - 1) - xa - wlo) * static_cast<int>(sizeof(Tv));
    }
    Acc<0, true> acc[kLaneCols];
    const int* rt_r = rowtab + r * d.ky;
    const float* wt_r = wtab + r * d.ky;
    if (nq == kLaneCols) {
      y_taps<Tv, 0, true>(acc, rt_r, wt_r, d.ky, off, nq);
    } else {
      y_taps<Tv, 0, false>(acc, rt_r, wt_r, d.ky, off, nq);
    }
#pragma unroll
    for (int q = 0; q < kLaneCols; ++q) {
      const int c = c0 + 32 * q;
      if (q < nq && c < c_hi) T[r * d.SX + c] = acc[q].sum();
    }
  }
}

// kU8Words' y pass (its first form; u8, MODE 0, clamped taps): a lane
// takes 4 neighbouring T columns and reads their 4 pixels of a tap row as
// one 32-bit word, funnel-shifted from the two aligned words that hold it
// (a window row starts at its global row's alignment), bytes in
// little-endian order (byte k is column x0 + k); columns clamped to the
// window's edge read pixel by pixel.  Each column sums its taps in order,
// as y_pass does.  (The stage ring's words_y_pass lines T up with the
// window's words instead.)
template <bool kClamp>
__device__ __forceinline__ void y_pass_words(float* __restrict__ T, const int* rowtab,
                                             const float* wtab, const Dims& d, int rows,
                                             int cb, int xa, int xb) {
  static_assert(kClamp, "the word pass reads clamped taps only");
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kGroup = 32 * kLaneCols;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_grp = (d.SX + kGroup - 1) / kGroup;
  for (int it = warp; it < rows * n_grp; it += kWarps) {
    const int r = it / n_grp;
    const int c = (it - r * n_grp) * kGroup + kLaneCols * lane;
    if (c >= d.SX) continue;
    const int x0 = cb + c;
    const bool whole = x0 >= xa && x0 + kLaneCols <= xb;
    const int* rt_r = rowtab + r * d.ky;
    const float* wt_r = wtab + r * d.ky;
    float acc[kLaneCols];
#pragma unroll
    for (int q = 0; q < kLaneCols; ++q) acc[q] = 0.0f;
    for (int a = 0; a < d.ky; ++a) {
      const int row = rt_r[a];
      const float wa = wt_r[a];
      if (whole) {
        const int p = row + (x0 - xa);
        const unsigned* w = reinterpret_cast<const unsigned*>(smem + (p & ~3));
        const unsigned v = __funnelshift_r(w[0], w[1], 8 * (p & 3));
#pragma unroll
        for (int q = 0; q < kLaneCols; ++q) {
          acc[q] = fmaf(wa, static_cast<float>((v >> (8 * q)) & 0xffu), acc[q]);
        }
      } else {
#pragma unroll
        for (int q = 0; q < kLaneCols; ++q) {
          const int x = min(max(x0 + q, xa), xb - 1);
          acc[q] = fmaf(wa, static_cast<float>(smem[row + x - xa]), acc[q]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kLaneCols; ++q) {
      if (c + q < d.SX) T[r * d.SX + c + q] = acc[q];
    }
  }
}

// The staged form: one block per (frame, strip, row tile).  P = kNone is
// the production kernel, and its code is the one kernels 1 and 2 had
// before the probe modes (the same SASS); each probe mode adds its change
// in an `if constexpr` branch that no other instance compiles.
template <typename Tin, typename Tout, int MODE, bool kClamp, int P = kNone>
__global__ void __launch_bounds__(kThreads) band_apply_kernel(
    const Tin* __restrict__ src, Tout* __restrict__ out, const int* __restrict__ ys,
    const float* __restrict__ wy, const int* __restrict__ xs, const float* __restrict__ wx,
    const int* __restrict__ row_base, const int* __restrict__ col_base, Dims d, Geo g) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ei = sizeof(Tin);
  constexpr int eo = sizeof(Tout);
  constexpr int kChunks = convert_chunks(P);
  const int tid = threadIdx.x;

  const int strip = blockIdx.x % d.n_strip;
  const int rest = blockIdx.x / d.n_strip;
  const int rt = rest % d.n_rt;
  const long long f = rest / d.n_rt;
  const int j0 = strip * d.TX;
  const int cols = min(d.TX, d.Wd - j0);
  const int i0 = rt * d.TY;
  const int rows = min(d.TY, d.Hd - i0);
  const int cb = col_base[strip];
  const Tin* frame = src + f * static_cast<long long>(d.H) * d.W;
  int xa, xb, ya, yb;
  clip<kClamp>(cb, d.SX, d.W, xa, xb);
  clip<kClamp>(__ldg(row_base + rt), d.SY, d.H, ya, yb);
  if constexpr (P == kXOnly) {
    // src is the y pass's output (F, Hd, W) (d.H = Hd): the window is the
    // tile's own rows of it (the host makes SY >= TY)
    ya = i0;
    yb = i0 + rows;
  }

  // ---- stage the window: rows [ya, yb), element (y, x) at shared byte
  // wbase + (y - ya) * pitch_in + (x - xa) * ei ----
  const unsigned char* seg0 =
      reinterpret_cast<const unsigned char*>(frame + static_cast<long long>(ya) * d.W + xa);
  const int wbase = 16 + static_cast<int>(reinterpret_cast<uintptr_t>(seg0) & 15);
  if (yb > ya && xb > xa) {  // zero fill only: a window may hold no pixel
    const long long stride = static_cast<long long>(d.W) * ei;
    const int nbytes = (xb - xa) * ei;
    const int n_chunk = (nbytes + 30) / 16;  // aligned chunks a row can touch
    for (Walk e(tid, n_chunk); e.r < yb - ya; e.next()) {
      const unsigned char* a = seg0 + e.r * stride;
      const int off = e.c * 16 - static_cast<int>(reinterpret_cast<uintptr_t>(a) & 15);
      if (off < nbytes) cp_async16(smem + wbase + e.r * g.pitch_in + off, a + off);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);

  // ---- while the copies land: the zero row, the tile's taps (shared byte
  // offset of each tap row, and its weight) and the x pass's registers ----
  if (!kClamp) {
    for (int e = tid * 16; e < g.t_off - g.zero_off; e += kThreads * 16) {
      *reinterpret_cast<uint4*>(smem + g.zero_off + e) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  int* rowtab = reinterpret_cast<int*>(smem + g.tab_off);
  float* wtab = reinterpret_cast<float*>(rowtab + d.TY * d.ky);
  const int zero_row = g.zero_off + 16;
  if constexpr (kChunks > 0) {
    // the y pass reads the bf16 chunk buffers (from g.smem): window row r
    // at r * cpitch + 2 * m_r of a buffer (convert_chunk)
    const int cpitch = convert_pitch(d.SX, kChunks);
    for (Walk e(tid, d.ky); e.r < rows; e.next()) {
      const int y = __ldg(ys + i0 + e.r) + e.c;
      const int r = min(max(y, 0), d.H - 1) - ya;
      rowtab[e.r * d.ky + e.c] = r * cpitch + 2 * ((wbase + r * g.pitch_in) & 15);
      wtab[e.r * d.ky + e.c] = __ldg(wy + static_cast<long long>(i0 + e.r) * d.ky + e.c);
    }
  } else
  for (Walk e(tid, d.ky); e.r < rows; e.next()) {
    const int y = __ldg(ys + i0 + e.r) + e.c;
    int row;
    if (kClamp) {
      row = wbase + (min(max(y, 0), d.H - 1) - ya) * g.pitch_in;
    } else {
      row = (y >= ya && y < yb) ? wbase + (y - ya) * g.pitch_in : zero_row;
    }
    rowtab[e.r * d.ky + e.c] = row;
    wtab[e.r * d.ky + e.c] = __ldg(wy + static_cast<long long>(i0 + e.r) * d.ky + e.c);
  }
  // x pass: thread (xrg, xj) owns dst column j0 + xj at rows xrg, xrg +
  // n_rg, ...; its tap offset and weights in registers
  const int n_rg = kThreads / d.TX;
  const int xj = tid % d.TX;
  const int xrg = tid / d.TX;
  const bool x_on = xj < cols && xrg < n_rg;
  const float* wxj = wx + static_cast<long long>(j0 + xj) * d.kx;
  int xo = 0;
  float wreg[kRegTaps];
#pragma unroll
  for (int b = 0; b < kRegTaps; ++b) wreg[b] = 0.0f;
  if (x_on) {
    xo = __ldg(xs + j0 + xj) - cb;
#pragma unroll
    for (int b = 0; b < kRegTaps; ++b) {
      if (b < d.kx) wreg[b] = __ldg(wxj + b);
    }
  }
  if constexpr (P == kXPair) {
    // the exact ratio-2 band: dst column j reads source columns 2j - 1 ..
    // 2j + 2, weights from the (4, Wd) table passed as wx; no offset table
    xo = 2 * (j0 + xj) - 1 - cb;
#pragma unroll
    for (int b = 0; b < kRegTaps; ++b) {
      wreg[b] = (x_on && b < 4) ? __ldg(wx + static_cast<long long>(b) * d.Wd + j0 + xj) : 0.0f;
    }
  }
  // an even tap count on even offsets of even rows: 8-byte aligned pairs
  const bool x_pairs = d.kx <= kRegTaps && d.kx % 2 == 0 && d.SX % 2 == 0 && xo % 2 == 0;
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  // ---- y pass: T[r, c] for the tile's rows over the window's columns ----
  float* T = reinterpret_cast<float*>(smem + g.t_off);
  if constexpr (P == kXOnly) {
    // the x pass alone: T[r, c] is the staged row i0 + r of the y pass's
    // output at column cb + c clamped to the image (as the y pass's T holds
    // it), in f32
    for (Walk e(tid, d.SX); e.r < rows; e.next()) {
      const int col = (min(max(cb + e.c, xa), xb - 1) - xa) * ei;
      T[e.r * d.SX + e.c] =
          to_f32(*reinterpret_cast<const Tin*>(smem + wbase + e.r * g.pitch_in + col));
    }
  } else if constexpr (P == kU8Words) {
    y_pass_words<kClamp>(T, rowtab, wtab, d, rows, cb, xa, xb);
  } else if constexpr (kChunks > 0) {
    // the window to bf16 chunk by chunk into two buffers, chunk c + 1
    // converted while chunk c is y-passed (convert_chunk)
    const int cpitch = convert_pitch(d.SX, kChunks);
    const int cbytes = static_cast<int>(up16(static_cast<long long>(d.SY) * cpitch));
    auto chunk = [&](int c) { return col_chunk(c, kChunks, xb - xa, cb - xa, d.SX); };
    convert_chunk(g.smem, cpitch, wbase, g.pitch_in, yb - ya, chunk(0), tid);
    __syncthreads();
    for (int c = 0; c < kChunks; ++c) {
      if (c + 1 < kChunks) {
        convert_chunk(g.smem + ((c + 1) & 1) * cbytes, cpitch, wbase, g.pitch_in, yb - ya,
                      chunk(c + 1), tid);
      }
      const ColChunk k = chunk(c);
      y_pass_cols<__nv_bfloat16>(T, rowtab, wtab, d, rows, cb, xa, xb, k.c_lo, k.c_hi, k.wlo,
                                 g.smem + (c & 1) * cbytes);
      if (c + 1 < kChunks) __syncthreads();
    }
  } else if constexpr (P != kStage) {
    y_pass<Tin, MODE, kClamp>(T, rowtab, wtab, d, rows, cb, xa, xb);
  }
  __syncthreads();

  // ---- x pass into the output tile, element (r, jj) at ot + r * pitch_out
  // + jj * eo, laid out like the output rows ----
  Tout* orow0 = out + (f * d.Hd + i0) * static_cast<long long>(d.Wd) + j0;
  unsigned char* ot =
      smem + g.o_off + 16 + static_cast<int>(reinterpret_cast<uintptr_t>(orow0) & 15);
  if constexpr (P == kStage) {
    // the first tap's pixel, (ys[i], xs[j]) clamped, from the window
    const int col = (min(max(cb + xo, xa), xb - 1) - xa) * ei;
    for (int r = x_on ? xrg : rows; r < rows; r += n_rg) {
      store(reinterpret_cast<Tout*>(ot + r * g.pitch_out + xj * eo),
            to_f32(*reinterpret_cast<const Tin*>(smem + rowtab[r * d.ky] + col)));
    }
  } else if constexpr (P == kStageY) {
    // T at the first x tap
    for (int r = x_on ? xrg : rows; r < rows; r += n_rg) {
      store(reinterpret_cast<Tout*>(ot + r * g.pitch_out + xj * eo), T[r * d.SX + xo]);
    }
  } else if constexpr (P == kXPair) {
    for (int r = x_on ? xrg : rows; r < rows; r += n_rg) {
      const float* tr = T + r * d.SX;
      Acc<MODE, false> acc;
#pragma unroll
      for (int b = 0; b < 4; ++b) acc.add(wreg[b], tr[min(max(xo + b, 0), d.SX - 1)]);
      store(reinterpret_cast<Tout*>(ot + r * g.pitch_out + xj * eo), acc.sum());
    }
  } else
  for (int r = x_on ? xrg : rows; r < rows; r += n_rg) {
    const float* tr = T + r * d.SX + xo;
    Acc<MODE, false> acc;
    if (x_pairs) {  // taps read as float2: half the shared reads
#pragma unroll
      for (int b = 0; b < kRegTaps; b += 2) {
        if (b < d.kx) {
          const float2 t2 = *reinterpret_cast<const float2*>(tr + b);
          acc.add(wreg[b], t2.x);
          acc.add(wreg[b + 1], t2.y);
        }
      }
    } else if (d.kx <= kRegTaps) {
#pragma unroll
      for (int b = 0; b < kRegTaps; ++b) {
        if (b < d.kx) acc.add(wreg[b], tr[b]);
      }
    } else {
      for (int b = 0; b < d.kx; ++b) acc.add(__ldg(wxj + b), tr[b]);
    }
    store(reinterpret_cast<Tout*>(ot + r * g.pitch_out + xj * eo), acc.sum());
  }
  __syncthreads();

  // ---- the tile's rows out: 16-byte stores, scalar at the ragged ends ----
  const long long ostride = static_cast<long long>(d.Wd) * eo;
  const int obytes = cols * eo;
  const int o_chunk = (obytes + 30) / 16;
  for (Walk e(tid, o_chunk); e.r < rows; e.next()) {
    unsigned char* a = reinterpret_cast<unsigned char*>(orow0) + e.r * ostride;
    const int off = e.c * 16 - static_cast<int>(reinterpret_cast<uintptr_t>(a) & 15);
    if (off >= obytes) continue;
    const unsigned char* s = ot + e.r * g.pitch_out;
    if (off >= 0 && off + 16 <= obytes) {
      *reinterpret_cast<uint4*>(a + off) = *reinterpret_cast<const uint4*>(s + off);
    } else {
      for (int k = max(off, 0); k < min(off + 16, obytes); k += eo) {
        *reinterpret_cast<Tout*>(a + k) = *reinterpret_cast<const Tout*>(s + k);
      }
    }
  }
}

// kWalk<n> (probe): production's function on a persistent grid, each block
// a ring of n windows in shared memory, filled by a producer warp and read
// by kThreads consumer threads (csrc/band_probes.cu sizes the grid: as many
// blocks an SM as the ring's shared memory and the registers allow, on
// every SM, fewer where there are fewer tiles).
//
//   * Items: the (frame, strip, row tile) tiles, row tiles fastest; block b
//     takes the contiguous share [b * items / G, (b + 1) * items / G), so it
//     walks the row tiles of a strip in order (a share crosses a strip or
//     frame at most a few times; the x pass's registers are set again there).
//   * The producer (the last warp) fills slot k % n for item k once the
//     consumers have released the slot's previous item on its empty
//     mbarrier: the tile's tap table (the slot's own, walk_taps), then its
//     window (laid out as production's), one 1-D bulk copy a row
//     (load_window) onto the slot's full mbarrier.  It runs up to n - 1
//     items ahead, so the tap table's global loads and the copies stay off
//     the consumers' path.
//   * The consumers wait on the full mbarrier, run the y pass and release
//     the slot right after it (the x pass reads only T), so the producer
//     refills it while the x pass and the stores run.  They synchronise
//     among themselves on a named barrier, two a tile (after the y pass,
//     after the x pass), never with the producer.
//
// The phases are production's arithmetic (y_pass, x_col, x_pass,
// store_tile): the output is production's bit for bit.  Layout (walk_geo):
// the n windows, T, the n tap tables, the output tile, the 2n mbarriers;
// the walk's taps are clamped, so it has no zero row.
template <typename Tin, typename Tout, int kSlots>
__global__ void __launch_bounds__(kThreads + 32) band_walk_kernel(
    const Tin* __restrict__ src, Tout* __restrict__ out, const int* __restrict__ ys,
    const float* __restrict__ wy, const int* __restrict__ xs, const float* __restrict__ wx,
    const int* __restrict__ row_base, const int* __restrict__ col_base, Dims d, Geo g,
    long long items) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int tab = static_cast<int>(up16(8LL * d.TY * d.ky));  // slot s's at tab_off + s * tab
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + g.smem - 16 * kSlots);
  uint64_t* empty = full + kSlots;
  if (tid == 0) {
    for (int s = 0; s < kSlots; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 1);
    }
    hopper::fence_mbarrier_init();
  }
  __syncthreads();
  // the share [lo, lo + n) (the host keeps items within an int); each side
  // walks it with its own cursor (rt, strip, f), row tiles fastest
  const int lo = static_cast<int>(blockIdx.x * items / gridDim.x);
  const int n = static_cast<int>((blockIdx.x + 1) * items / gridDim.x) - lo;
  int rt = lo % d.n_rt, strip = lo / d.n_rt % d.n_strip, f = lo / d.n_rt / d.n_strip;
  auto next = [&]() {
    if (++rt == d.n_rt) {
      rt = 0;
      if (++strip == d.n_strip) {
        strip = 0;
        ++f;
      }
    }
  };
  auto slot = [&](int s) { return s * g.zero_off; };
  auto rowtab = [&](int s) { return reinterpret_cast<int*>(smem + g.tab_off + s * tab); };
  auto wtab = [&](int s) { return reinterpret_cast<float*>(rowtab(s) + d.TY * d.ky); };
  if (tid >= kThreads) {  // the producer warp
    const int lane = tid - kThreads;
    for (int k = 0, s = 0; k < n; ++k, s = s + 1 == kSlots ? 0 : s + 1, next()) {
      if (k >= kSlots) hopper::mbar_wait(&empty[s], (k / kSlots - 1) & 1);
      const Tile t = tile_at<true>(d, row_base, col_base, strip, rt, f);
      walk_taps(rowtab(s), wtab(s), ys, wy, d, g, t,
                window_base<Tin>(window_src(src, d, t), slot(s)), lane);
      load_window(src, d, g, t, slot(s), &full[s], lane);
    }
    return;
  }
  float* T = reinterpret_cast<float*>(smem + g.t_off);
  XCol x;
  int x_strip = -1;
  for (int k = 0, s = 0; k < n; ++k, s = s + 1 == kSlots ? 0 : s + 1, next()) {
    const Tile t = tile_at<true>(d, row_base, col_base, strip, rt, f);
    if (t.j0 != x_strip) {
      x_col<Tin>(x, xs, wx, d, t, tid);
      x_strip = t.j0;
    }
    hopper::mbar_wait(&full[s], (k / kSlots) & 1);
    y_pass<Tin, 0, true>(T, rowtab(s), wtab(s), d, t.rows, t.cb, t.xa, t.xb);
    consumer_sync();  // T whole; slot s read
    if (tid == 0) hopper::mbar_arrive(&empty[s]);
    Tout* orow0 = out + (t.f * d.Hd + t.i0) * static_cast<long long>(d.Wd) + t.j0;
    unsigned char* ot =
        smem + g.o_off + 16 + static_cast<int>(reinterpret_cast<uintptr_t>(orow0) & 15);
    x_pass<Tout, 0>(T, x, d, g, t.rows, ot);
    consumer_sync();  // the output tile whole; T read
    store_tile(orow0, ot, d, g, t.rows, t.cols, tid);
  }
}

// ---- the stage ring (band_stage_kernel): kStage's, kStageY's, kU8Words'
// and kXPair's functions on a persistent grid, the counterpart of JAX's
// band probe (flagship_experiments.py:73, rgb1024_experiments.py:88),
// whose schedule starts band t + 1's copy before band t is waited on ----

constexpr int kStageRows = 8;     // TY at most: kernel 1's plans (cuda_apply.TILE_Y)
constexpr int kStageSlots = 2;    // the ring's windows (3 and 4 were no faster on the H100: PERF.md)
constexpr int kShiftTaps = 4;     // y bands up to this wide keep their pixels in registers
constexpr int kFloatCols = 4;     // window columns a y-pass thread owns, bf16 and f32

// blocks an SM the stage ring's registers are capped for, by measurement
// on the H100 (PERF.md): kRingStage 4 (its shared memory allows 4-5 in
// bf16 and u8); kRingStageY 3 in bf16 and u8 (4 spilled, none left 2 at
// 96 registers), 2 in f32, as many as its shared memory allows (none left
// 1 at 127); kRingWords 4 (u8; 3 was slower); kRingPair 3 (u8; 4
// spilled)
template <typename Tin, int P>
__host__ __device__ constexpr int stage_min_blocks() {
  return P == kRingStage || P == kRingWords ? 4 : sizeof(Tin) < 4 ? 3 : 2;
}

// what each of the ring's functions keeps in its slot and beside it: the
// (TY, ky) tap table (all but kRingStage, which reads each dst row's
// first tap row alone), T (kRingStageY, kRingWords), output tiles
// (kRingStage two, kRingPair none: its words go straight to global
// memory; it keeps its (4, Wd) x table there instead, pair_pitch)
__host__ __device__ constexpr bool ring_y_taps(int P) { return P != kRingStage; }
__host__ __device__ constexpr bool ring_t(int P) { return P == kRingStageY || P == kRingWords; }
__host__ __device__ constexpr int ring_out_tiles(int P) {
  return P == kRingStage ? 2 : P == kRingPair ? 0 : 1;
}

// window columns a y-pass thread owns (a group): u8 4, bf16 and f32
// kFloatCols
template <typename Tin>
__host__ __device__ constexpr int y_cols() {
  return sizeof(Tin) == 1 ? 4 : kFloatCols;
}

// whether the y pass takes a row's taps from the registers where they
// overlap the row before's (the shift): f32; bf16 and u8 read every tap,
// which was faster on the H100 (the selects cost more than the reads they
// save: PERF.md)
template <typename Tin>
__host__ __device__ constexpr bool shift_reuse() {
  return sizeof(Tin) == 4;
}

// T's row pitch in floats: SX rounded up to 4, so that each group's T
// columns start on a 16-byte boundary (kRingWords: SX + 3, its columns
// shifted by up to 3 to the window's word alignment, words_y_pass)
__host__ __device__ inline int stage_t_pitch(int SX) { return (SX + 3) / 4 * 4; }
__host__ __device__ inline int ring_t_pitch(int SX, int P) {
  return stage_t_pitch(P == kRingWords ? SX + 3 : SX);
}

// bytes of one slot's tap table: kStage the first tap's row offset a dst
// row; kStageY the (TY, ky) row offsets, the (TY, ky) weights and the
// shift a dst row (stage_taps)
__host__ __device__ inline int stage_tab_bytes(int TY, int ky, bool with_y) {
  return static_cast<int>(up16(with_y ? 8LL * TY * ky + 4LL * TY : 4LL * TY));
}

// The global loads of a tile's taps by one lane of the producer warp,
// issued a tile ahead (stage_taps writes them once the slot is free): the
// first tap row ys[i0 + lane] of dst row `lane`, and the row before's
// (kStageY: its shift); kStageY also entry `lane` of the (rows, ky) tap
// table, its tap row and weight
struct TapLoads {
  int y0, y1, y;
  float w;
};

template <bool kY>
__device__ __forceinline__ TapLoads tap_loads(const int* __restrict__ ys,
                                              const float* __restrict__ wy, const Dims& d,
                                              const Tile& t, int lane) {
  TapLoads p{0, 0, 0, 0.0f};
  if (lane < t.rows) {
    p.y0 = __ldg(ys + t.i0 + lane);
    if (kY && lane > 0) p.y1 = __ldg(ys + t.i0 + lane - 1);
  }
  if (kY && lane < t.rows * d.ky) {
    const int r = lane / d.ky;
    p.y = __ldg(ys + t.i0 + r) + lane - r * d.ky;
    p.w = __ldg(wy + static_cast<long long>(t.i0) * d.ky + lane);
  }
  return p;
}

// The tile's taps in a slot's table (the producer warp's lanes, from
// tap_loads): kStage the shared byte offset of each dst row's first
// (clamped) tap row in the window staged at wbase; kStageY every tap's
// (as walk_taps; entries past the warp's 32 loaded here), then each dst
// row's shift: ys[i] - ys[i - 1] where that lies in [0, ky], else ky (and
// ky for the tile's first row), the window rows its pixels move by from
// the row before (stage_y_pass)
template <bool kY>
__device__ __forceinline__ void stage_taps(int* tab, const TapLoads& p,
                                           const int* __restrict__ ys,
                                           const float* __restrict__ wy, const Dims& d,
                                           const Geo& g, const Tile& t, int wbase, int lane) {
  auto row_at = [&](int y) { return wbase + (min(max(y, 0), d.H - 1) - t.ya) * g.pitch_in; };
  if constexpr (!kY) {
    if (lane < t.rows) tab[lane] = row_at(p.y0);
  } else {
    float* wtab = reinterpret_cast<float*>(tab + d.TY * d.ky);
    for (int e = lane; e < t.rows * d.ky; e += 32) {
      int y = p.y;
      float w = p.w;
      if (e != lane) {
        const int r = e / d.ky;
        y = __ldg(ys + t.i0 + r) + e - r * d.ky;
        w = __ldg(wy + static_cast<long long>(t.i0) * d.ky + e);
      }
      tab[e] = row_at(y);
      wtab[e] = w;
    }
    if (lane < t.rows) {
      const int v = p.y0 - p.y1;
      tab[2 * d.TY * d.ky + lane] = lane > 0 && v >= 0 && v <= d.ky ? v : d.ky;
    }
  }
}

// kC pixels of the window row at shared byte `row`, columns colb[k] (bytes
// from the row's first pixel), as f32, one read each (a group's pixels in
// one read where aligned was slower on the H100: PERF.md)
template <typename Tin, int kC>
__device__ __forceinline__ void load_px(float (&p)[kC], int row, const int (&colb)[kC]) {
  extern __shared__ __align__(16) unsigned char smem[];
#pragma unroll
  for (int k = 0; k < kC; ++k) p[k] = to_f32(*reinterpret_cast<const Tin*>(smem + row + colb[k]));
}

// kC f32 to shared memory at p (aligned to their size) in one store
template <int kC>
__device__ __forceinline__ void st_shared(float* p, const float (&v)[kC]) {
  if constexpr (kC == 4) {
    asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(hopper::smem_u32(p)),
                 "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3])
                 : "memory");
  } else {
    static_assert(kC == 2, "T is stored in pairs or quads");
    asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(hopper::smem_u32(p)), "f"(v[0]),
                 "f"(v[1])
                 : "memory");
  }
}

// One group's dst rows [r0, r1) of a tile's y pass (stage_y_pass): the
// row's tap offsets read first (one broadcast each), q moved by the shift,
// the new taps' pixels read, the taps summed in order, T's kC columns
// stored at once
template <typename Tin, int kC>
__device__ __forceinline__ void y_rows(float* trow, int tp, const int* rowtab, const float* wtab,
                                       const int* shift, int ky, int r0, int r1,
                                       const int (&colb)[kC]) {
  constexpr bool kReuse = shift_reuse<Tin>();
  float q[kShiftTaps][kC] = {};
#pragma unroll 1
  for (int r = r0; r < r1; ++r) {
    const int* rt = rowtab + r * ky;
    const float* wt = wtab + r * ky;
    int row[kShiftTaps];
#pragma unroll
    for (int a = 0; a < kShiftTaps; ++a) row[a] = a < ky ? rt[a] : 0;
    // s in [0, ky]; kShiftTaps at the first row: every tap read.  q[a]
    // takes q[a + s] in place (a ascending: q[a + s] not yet moved)
    const int s = kReuse && r > r0 ? shift[r] : kShiftTaps;
#pragma unroll
    for (int a = 0; a < kShiftTaps; ++a) {
#pragma unroll
      for (int k = 0; k < kC; ++k) {
        float v = q[a][k];
        if (a + 1 < kShiftTaps) v = s == 1 ? q[a + 1][k] : v;
        if (a + 2 < kShiftTaps) v = s == 2 ? q[a + 2][k] : v;
        if (a + 3 < kShiftTaps) v = s == 3 ? q[a + 3][k] : v;
        q[a][k] = v;
      }
    }
#pragma unroll
    for (int a = 0; a < kShiftTaps; ++a) {
      if (a < ky && a + s >= ky) load_px<Tin, kC>(q[a], row[a], colb);
    }
    float acc[kC] = {};
#pragma unroll
    for (int a = 0; a < kShiftTaps; ++a) {
      if (a < ky) {
        const float w = wt[a];
#pragma unroll
        for (int k = 0; k < kC; ++k) acc[k] = fmaf(w, q[a][k], acc[k]);
      }
    }
    st_shared<kC>(trow + r * tp, acc);
  }
}

// the same for bands wider than kShiftTaps: every tap's pixels read
template <typename Tin, int kC>
__device__ __forceinline__ void y_rows_wide(float* trow, int tp, const int* rowtab,
                                            const float* wtab, int ky, int r0, int r1,
                                            const int (&colb)[kC]) {
  for (int r = r0; r < r1; ++r) {
    float acc[kC] = {};
    for (int a = 0; a < ky; ++a) {
      float p[kC];
      load_px<Tin, kC>(p, rowtab[r * ky + a], colb);
      const float w = wtab[r * ky + a];
#pragma unroll
      for (int k = 0; k < kC; ++k) acc[k] = fmaf(w, p[k], acc[k]);
    }
    st_shared<kC>(trow + r * tp, acc);
  }
}

// kStageY's y pass, register-blocked: T[r, c] = sum_a wy[i0 + r, a] *
// window[tap row, cb + c] (clamped) for the tile's rows over the window's
// SX columns, MODE 0, as y_pass computes it; T column c at T + r * tp + c
// (stage_t_pitch).
//
// A thread owns kC adjacent T columns (a group) and walks the tile's dst
// rows in order (y_rows), keeping the pixels of the current row's taps,
// q[a] = pixel(clamp(ys[i] + a)), in registers.  With shift_reuse (f32)
// the next row's taps start `shift` window rows further down, so q[a]
// takes q[a + shift] (selects, no branch) and only the last `shift` taps
// are read from shared memory: each window row of the thread's columns is
// so read once where the rows' bands overlap (twice at ratio 2 in
// y_pass); bf16 and u8 read every tap.  Each dst row sums its taps a = 0
// .. ky - 1 in order, one fmaf each, as the plain version does, so T is
// y_pass's bit for bit.  The schedule (which taps a row reads, how far q
// moves) is the same for every thread of the tile, so no branch diverges.
// Where the groups are fewer than the block's threads the rows are split
// among `parts` threads a group, each part's first row reading all its
// taps.  Bands wider than kShiftTaps read every tap's pixels
// (y_rows_wide).
template <typename Tin>
__device__ __forceinline__ void stage_y_pass(float* __restrict__ T, int tp, const int* rowtab,
                                             const float* wtab, const int* shift, const Dims& d,
                                             const Tile& t, int tid) {
  constexpr int ei = sizeof(Tin);
  constexpr int kC = y_cols<Tin>();
  const int ng = (d.SX + kC - 1) / kC;
  const int parts = max(1, min(t.rows, kThreads / ng));
  for (int it = tid; it < ng * parts; it += kThreads) {
    const int part = it / ng;
    const int gi = it - part * ng;
    const int c0 = gi * kC;
    const int r0 = part * t.rows / parts;
    const int r1 = (part + 1) * t.rows / parts;
    int colb[kC];
#pragma unroll
    for (int k = 0; k < kC; ++k) colb[k] = (min(max(t.cb + c0 + k, t.xa), t.xb - 1) - t.xa) * ei;
    float* trow = T + c0;
    if (d.ky <= kShiftTaps) {
      y_rows<Tin, kC>(trow, tp, rowtab, wtab, shift, d.ky, r0, r1, colb);
    } else {
      y_rows_wide<Tin, kC>(trow, tp, rowtab, wtab, d.ky, r0, r1, colb);
    }
  }
}

// byte k of a little-endian u8 word as f32, exactly: the float 2^23 + b
// by one prmt, then b by one subtraction (no conversion instruction)
__device__ __forceinline__ float byte_f32(uint32_t v, int k) {
  return __uint_as_float(__byte_perm(v, 0x4Bu, 0x4550u + k)) - 8388608.0f;
}

// the 32-bit shared word at byte p (a multiple of 4)
__device__ __forceinline__ uint32_t lds_u32(int p) {
  extern __shared__ __align__(16) unsigned char smem[];
  return *reinterpret_cast<const uint32_t*>(smem + p);
}

// the two 32-bit shared words at byte p (a multiple of 8), in one read
__device__ __forceinline__ uint2 lds_u64(int p) {
  extern __shared__ __align__(16) unsigned char smem[];
  return *reinterpret_cast<const uint2*>(smem + p);
}

// a dst row's n tap row offsets and weights from its (ky)-long rows of
// the tap table: n = 4 = ky in one 16-byte read each (the rows start on
// 16 bytes: stage_tab_bytes), else one read a tap under a test
template <int n, int kT>
__device__ __forceinline__ void row_taps(int (&row)[n], float (&wa)[n], const int* rt,
                                         const float* wt, int ky) {
  if constexpr (kT == 4) {
    const int4 r4 = *reinterpret_cast<const int4*>(rt);
    const float4 w4 = *reinterpret_cast<const float4*>(wt);
    row[0] = r4.x, row[1] = r4.y, row[2] = r4.z, row[3] = r4.w;
    wa[0] = w4.x, wa[1] = w4.y, wa[2] = w4.z, wa[3] = w4.w;
  } else {
    const int nt = kT > 0 ? kT : ky;
#pragma unroll
    for (int a = 0; a < n; ++a) {
      row[a] = a < nt ? rt[a] : 0;
      wa[a] = a < nt ? wt[a] : 0.0f;
    }
  }
}

// the 4 pixels from shared byte p as one word, byte k the pixel at p + k:
// one aligned read (kAligned: p a multiple of 4), else two joined by a
// funnel shift (rows whose alignment differs row by row: W mod 4 != 0)
template <bool kAligned>
__device__ __forceinline__ uint32_t word_at(int p) {
  if constexpr (kAligned) {
    return lds_u32(p);
  } else {
    const int q = p & ~3;
    return __funnelshift_r(lds_u32(q), lds_u32(q + 4), 8 * (p & 3));
  }
}

// One group's dst rows [r0, r1) of kRingWords' y pass: each row's tap
// offsets and weights read first, then each tap row's 4 pixels of the
// group (byte pb past the row's base in rowtab) as one word, all in flight
// together, then each column's taps summed in order and T's 4 columns
// stored at once.  kT taps (kT 0: ky of them, at most kShiftTaps, each
// under a test)
template <bool kAligned, int kT>
__device__ __forceinline__ void words_rows(float* trow, int tp, const int* rowtab,
                                           const float* wtab, int ky, int r0, int r1, int pb) {
  constexpr int n = kT > 0 ? kT : kShiftTaps;
  const int nt = kT > 0 ? kT : ky;
#pragma unroll 1
  for (int r = r0; r < r1; ++r) {
    const int* rt = rowtab + r * ky;
    const float* wt = wtab + r * ky;
    int row[n];
    float wa[n];
    row_taps<n, kT>(row, wa, rt, wt, ky);
    uint32_t v[n];
#pragma unroll
    for (int a = 0; a < n; ++a) v[a] = a < nt ? word_at<kAligned>(row[a] + pb) : 0u;
    float acc[4] = {};
#pragma unroll
    for (int a = 0; a < n; ++a) {
      if (a < nt) {
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[k] = fmaf(wa[a], byte_f32(v[a], k), acc[k]);
      }
    }
    st_shared<4>(trow + r * tp, acc);
  }
}

template <bool kAligned>
__device__ __forceinline__ void words_group(float* trow, int tp, const int* rowtab,
                                            const float* wtab, int ky, int r0, int r1, int pb) {
  if (ky == kShiftTaps) {
    words_rows<kAligned, kShiftTaps>(trow, tp, rowtab, wtab, ky, r0, r1, pb);
  } else {
    words_rows<kAligned, 0>(trow, tp, rowtab, wtab, ky, r0, r1, pb);
  }
}

// kRingWords' y pass (u8, clamped taps): T[r, c] = sum_a wy[i0 + r, a] *
// window[tap row, cb + c], as y_pass computes it, with T column c at T + r
// * tp + o + c.  o = (wbase + cb - xa) mod 4 lines T's columns up with the
// window's words: a group of 4 T columns starting at a multiple of 4 in T
// reads, in every tap row whose base is a multiple of 4 from the window's
// first (all of them where the row pitch is: W mod 4 == 0), one aligned
// 32-bit word, and stores its 4 sums with one st.shared.v4.  A thread owns
// a group and walks the tile's dst rows (as stage_y_pass; rows split into
// `parts` where the groups are fewer than the threads), reading every tap
// (no register shift: the word read is one instruction for 4 pixels).
// Groups with a column outside the window's [xa, xb), and bands wider
// than kShiftTaps, read pixel by pixel, clamped (y_rows_wide).
__device__ __forceinline__ void words_y_pass(float* __restrict__ T, int tp, int o,
                                             const int* rowtab, const float* wtab, const Dims& d,
                                             const Geo& g, const Tile& t, int tid) {
  const int ng = (d.SX + o + 3) / 4;
  const int parts = max(1, min(t.rows, kThreads / ng));
  const bool aligned = (g.pitch_in & 3) == 0;
  for (int it = tid; it < parts * ng; it += kThreads) {
    const int part = it / ng;
    const int gi = it - part * ng;
    const int x0 = t.cb + 4 * gi - o;  // the group's first source column
    const int r0 = part * t.rows / parts;
    const int r1 = (part + 1) * t.rows / parts;
    float* trow = T + 4 * gi;
    if (x0 >= t.xa && x0 + 4 <= t.xb && d.ky <= kShiftTaps) {
      if (aligned) {
        words_group<true>(trow, tp, rowtab, wtab, d.ky, r0, r1, x0 - t.xa);
      } else {
        words_group<false>(trow, tp, rowtab, wtab, d.ky, r0, r1, x0 - t.xa);
      }
    } else {
      int colb[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) colb[k] = min(max(x0 + k, t.xa), t.xb - 1) - t.xa;
      y_rows_wide<uint8_t, 4>(trow, tp, rowtab, wtab, d.ky, r0, r1, colb);
    }
  }
}

// kRingPair's warps (xpair, u8 in and out; the exact ratio-2 band, dst
// column j on source columns 2j - 1 .. 2j + 2): a lane owns the 4 dst
// columns J .. J + 3 (J = j0 + 4 gi) of a part of the tile's rows.  Warp
// w takes chunk w % n_chunk of 32 groups and part w / n_chunk of the rows,
// a split fixed by TX and TY (at the flagship 2 chunks x 4 parts of 2
// rows).
struct PairLane {
  int gi, r0, r1;  // group; rows [r0, r1) of a whole tile
  int lane;
  bool busy;       // the warp has a (chunk, part)
};

__device__ __forceinline__ PairLane pair_lane(const Dims& d, int tid) {
  const int n_chunk = ((d.TX + 3) / 4 + 31) / 32;
  const int parts = max(1, min(d.TY, kWarps / n_chunk));
  const int warp = tid / 32;
  const int part = warp / n_chunk;
  PairLane p;
  p.lane = tid % 32;
  p.gi = (warp - part * n_chunk) * 32 + p.lane;
  p.busy = warp < n_chunk * parts;
  p.r0 = part * d.TY / parts;
  p.r1 = (part + 1) * d.TY / parts;
  return p;
}

// the (4, Wd) x table's rows in shared memory (kRingPair): row b at
// b * pair_pitch(Wd) floats, so each lane's 4 weights of a tap are one
// 16-byte read where the strip starts on a multiple of 4
__host__ __device__ inline int pair_pitch(int Wd) { return (Wd + 3) / 4 * 4; }

// a lane's x weights: w[b][k] = table row b (the taps o_prev, e, o,
// e_next) at dst column J + k (J = j0 + jj), from the shared table
__device__ __forceinline__ void pair_weights(float (&w)[4][4], const float* tab, int wp, int J,
                                             bool vec) {
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const float* r = tab + b * wp + J;
    if (vec) {
      const float4 v = *reinterpret_cast<const float4*>(r);
      w[b][0] = v.x, w[b][1] = v.y, w[b][2] = v.z, w[b][3] = v.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) w[b][k] = r[k];
    }
  }
}

// One dst row of a pair lane, c[m] += the y sums of source columns x0 - 1
// + m (m = 0 .. 9, x0 = 2J; pb = x0 - xa): each tap row's 10 pixels from
// four words, the lane's own 8 columns (kAligned: pb + the row's base a
// multiple of 8, one 8-byte read; else each word funnel-shifted from two)
// and the last byte of the word before and the first of the word after
// (the neighbouring lanes' columns: read again, not shuffled, which was
// slower on the H100: PERF.md); the row's tap offsets, weights and words
// all read before the sums.  kT taps (kT 0: ky of them, at most
// kShiftTaps, each under a test)
template <bool kAligned, int kT>
__device__ __forceinline__ void pair_sums(float (&c)[10], const int* rt, const float* wt, int ky,
                                          int pb) {
  constexpr int n = kT > 0 ? kT : kShiftTaps;
  const int nt = kT > 0 ? kT : ky;
  int row[n];
  float wa[n];
  row_taps<n, kT>(row, wa, rt, wt, ky);
  uint32_t vm[n], v0[n], v1[n], vp[n];
#pragma unroll
  for (int a = 0; a < n; ++a) {
    if (a < nt) {
      const int p = row[a] + pb;
      if constexpr (kAligned) {
        const uint2 v = lds_u64(p);
        v0[a] = v.x;
        v1[a] = v.y;
        vm[a] = lds_u32(p - 4);
        vp[a] = lds_u32(p + 8);
      } else {
        vm[a] = word_at<false>(p - 4);
        v0[a] = word_at<false>(p);
        v1[a] = word_at<false>(p + 4);
        vp[a] = word_at<false>(p + 8);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < n; ++a) {
    if (a < nt) {
      c[0] = fmaf(wa[a], byte_f32(vm[a], 3), c[0]);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        c[1 + k] = fmaf(wa[a], byte_f32(v0[a], k), c[1 + k]);
        c[5 + k] = fmaf(wa[a], byte_f32(v1[a], k), c[5 + k]);
      }
      c[9] = fmaf(wa[a], byte_f32(vp[a], 0), c[9]);
    }
  }
}

// The same sums pixel by pixel, each column clamped to the window's [xa,
// xb): lanes astride the window's edges, and bands wider than kShiftTaps
__device__ __forceinline__ void pair_sums_clamped(float (&c)[10], const int* rt, const float* wt,
                                                  int ky, int x0, const Tile& t) {
  extern __shared__ __align__(16) unsigned char smem[];
  for (int a = 0; a < ky; ++a) {
    const int row = rt[a];
    const float w = wt[a];
#pragma unroll
    for (int m = 0; m < 10; ++m) {
      const int col = min(max(x0 - 1 + m, t.xa), t.xb - 1) - t.xa;
      c[m] = fmaf(w, static_cast<float>(smem[row + col]), c[m]);
    }
  }
}

// dst row r's 10 column sums of a pair lane (pair_sums, or
// pair_sums_clamped where `whole` is false)
template <bool kAligned>
__device__ __forceinline__ void pair_row_sums(float (&c)[10], const int* rt, const float* wt,
                                              int ky, int x0, const Tile& t, bool whole) {
  if (!whole) {
    pair_sums_clamped(c, rt, wt, ky, x0, t);
  } else if (ky == kShiftTaps) {
    pair_sums<kAligned, kShiftTaps>(c, rt, wt, ky, x0 - t.xa);
  } else {
    pair_sums<kAligned, 0>(c, rt, wt, ky, x0 - t.xa);
  }
}

// kRingPair's work on one tile: each of the lane's rows' 10 column y sums
// in registers (pair_row_sums), then its 4 dst values, taps b = 0 .. 3 in
// the table's order, rounded half to even and saturated as store() does,
// packed into one word and stored straight to the output row (one 32-bit
// store; bytes where the row's 4 columns are not 4-byte aligned or run
// past the strip)
template <bool kAligned>
__device__ __forceinline__ void pair_tile(uint8_t* __restrict__ out, const int* rowtab,
                                          const float* wtab, const float* xtab, const Dims& d,
                                          const Tile& t, const PairLane& p) {
  const int jj = 4 * p.gi;  // the lane's first column in the strip
  if (jj >= t.cols) return;
  const int r1 = min(p.r1, t.rows);
  const int x0 = 2 * (t.j0 + jj);
  const bool whole = x0 - 1 >= t.xa && x0 + 9 <= t.xb && d.ky <= kShiftTaps;
  const int wp = pair_pitch(d.Wd);
  const bool vec = (t.j0 & 3) == 0;  // the lane's weights 16-byte aligned
  for (int r = p.r0; r < r1; ++r) {
    float c[10] = {};
    pair_row_sums<kAligned>(c, rowtab + r * d.ky, wtab + r * d.ky, d.ky, x0, t, whole);
    float w[4][4];  // read a row at a time: held across rows, they spilled
    pair_weights(w, xtab, wp, t.j0 + jj, vec);
    uint32_t word = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float acc = 0.0f;
#pragma unroll
      for (int b = 0; b < 4; ++b) acc = fmaf(w[b][k], c[2 * k + b], acc);
      word |= static_cast<uint32_t>(fminf(fmaxf(rintf(acc), 0.0f), 255.0f)) << (8 * k);
    }
    uint8_t* o = out + (t.f * d.Hd + t.i0 + r) * static_cast<long long>(d.Wd) + t.j0 + jj;
    if (jj + 4 <= t.cols && (reinterpret_cast<uintptr_t>(o) & 3) == 0) {
      *reinterpret_cast<uint32_t*>(o) = word;
    } else {
      for (int k = 0; k < min(4, t.cols - jj); ++k) o[k] = static_cast<uint8_t>(word >> (8 * k));
    }
  }
}

// The stage ring (probes): kStage's, kStageY's, kU8Words' and kXPair's
// functions (P = kRingStage, kRingStageY, kRingWords, kRingPair: the first
// tap's pixel; T at the first x tap; production's output with the y pass
// reading a word a tap row; production's output from the exact ratio-2 x
// taps) on a persistent grid, each block a ring of kStageSlots windows
// filled by a producer warp and read by kThreads consumer threads
// (csrc/band_probes.cu sizes the grid as the walk's: as many blocks an SM
// as the ring's shared memory and the registers allow).
//
//   * Items: the (frame, strip, row tile) tiles.  Block b of G takes items
//     b, b + G, ... in production's order, strips fastest, so the blocks
//     at work at any moment read neighbouring windows, as production's
//     grid does (band_probes.stage_shares states it; the walk's contiguous
//     shares were slower on the H100: PERF.md).
//   * The producer (the last warp) fills slot k % n for item k once it is
//     released (its empty mbarrier): the tap table first (stage_taps, from
//     global loads issued a tile ahead), then the window, one 1-D bulk
//     copy a row (load_window) onto the slot's full mbarrier, up to n - 1
//     items ahead.
//   * kRingStage, kRingStageY: the consumers load each tile's bases and
//     each dst column's first x tap (xo, the only x table they read) a
//     tile ahead.  kRingStageY runs stage_y_pass into T and releases the
//     slot; kRingStage releases it after the tile's elements are picked.
//     Each element is cast into an output tile laid out like the output
//     rows, whose rows leave by store_tile's 16-byte stores (scalar stores
//     at the ragged ends; bulk stores of the rows' whole 16-byte chunks
//     were slower on the H100: PERF.md).  One consumer barrier a tile for
//     kRingStage, two for kRingStageY.
//   * kRingWords: words_y_pass into T (its columns offset to the window's
//     word alignment), the slot released, then production's x pass
//     (x_col, loaded where the strip changes, before the slot is waited
//     on; x_pass at T's offset origin) into the output tile and
//     store_tile; two consumer barriers a tile.
//   * kRingPair: no T, no output tile, no consumer barrier.  The block
//     stages the (4, Wd) x table in shared memory once.  Each warp takes
//     its (chunk, part) of every tile (pair_lane), sums its rows' columns
//     in registers, reads its lanes' x weights a row at a time and stores
//     its words (pair_tile), and releases the slot by one arrival of its
//     own (the empty mbarrier counts kWarps).
//
// Layout (stage_geo): the n windows, T (kRingStageY, kRingWords), the n
// tap tables, the output tiles (ring_out_tiles: kRingStage two, written
// in turn, as its one barrier a tile lets a tile's writes meet the last
// tile's stores; kRingStageY and kRingWords one; kRingPair none, its x
// table in their place), the 2n mbarriers; no zero row (the taps are
// clamped).
template <typename Tin, typename Tout, int P>
__global__ void __launch_bounds__(kThreads + 32, stage_min_blocks<Tin, P>()) band_stage_kernel(
    const Tin* __restrict__ src, Tout* __restrict__ out, const int* __restrict__ ys,
    const float* __restrict__ wy, const int* __restrict__ xs, const float* __restrict__ wx,
    const int* __restrict__ row_base, const int* __restrict__ col_base, Dims d, Geo g,
    long long items) {
  static_assert(P == kRingStage || P == kRingStageY || sizeof(Tin) == 1,
                "the word and pair functions are u8 probes");
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ei = sizeof(Tin);
  constexpr int n_slots = kStageSlots;
  constexpr bool kY = ring_y_taps(P);
  const int tid = threadIdx.x;
  const int tab = stage_tab_bytes(d.TY, d.ky, kY);  // slot s's at tab_off + s * tab
  const int otile = static_cast<int>(up16(32 + static_cast<long long>(d.TY) * g.pitch_out));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + g.smem - 16 * n_slots);
  uint64_t* empty = full + n_slots;
  if (tid == 0) {
    for (int s = 0; s < n_slots; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], P == kRingPair ? kWarps : 1);
    }
    hopper::fence_mbarrier_init();
  }
  if constexpr (P == kRingPair) {  // the (4, Wd) x table, once a block
    const int wp = pair_pitch(d.Wd);
    float* xtab = reinterpret_cast<float*>(smem + g.o_off);
    for (int e = tid; e < 4 * d.Wd; e += kThreads + 32) {
      const int b = e / d.Wd;
      xtab[b * wp + e - b * d.Wd] = __ldg(wx + e);
    }
  }
  __syncthreads();
  // the block's items: n of them, item k at blockIdx.x + k * G
  const long long G = gridDim.x;
  const int n = static_cast<int>((items - blockIdx.x + G - 1) / G);
  auto tile_k = [&](int k) {
    const long long i = blockIdx.x + k * G;
    const int strip = static_cast<int>(i % d.n_strip);  // strips fastest
    long long rest = i / d.n_strip;
    const int rt = static_cast<int>(rest % d.n_rt);
    rest /= d.n_rt;
    return tile_at<true>(d, row_base, col_base, strip, rt, rest);
  };
  auto slot = [&](int s) { return s * g.zero_off; };
  auto taps = [&](int s) { return reinterpret_cast<int*>(smem + g.tab_off + s * tab); };
  if (n <= 0) return;
  if (tid >= kThreads) {  // the producer warp
    const int lane = tid - kThreads;
    Tile tn = tile_k(0);
    TapLoads pn = tap_loads<kY>(ys, wy, d, tn, lane);
    for (int k = 0, s = 0; k < n; ++k, s = s + 1 == n_slots ? 0 : s + 1) {
      const Tile t = tn;
      const TapLoads p = pn;
      if (k + 1 < n) {  // the next tile's loads in flight while this one waits
        tn = tile_k(k + 1);
        pn = tap_loads<kY>(ys, wy, d, tn, lane);
      }
      if (k >= n_slots) hopper::mbar_wait(&empty[s], (k / n_slots - 1) & 1);
      stage_taps<kY>(taps(s), p, ys, wy, d, g, t,
                     window_base<Tin>(window_src(src, d, t), slot(s)), lane);
      load_window(src, d, g, t, slot(s), &full[s], lane);
    }
    return;
  }
  if constexpr (P == kRingPair) {
    const PairLane pl = pair_lane(d, tid);
    const float* xtab = reinterpret_cast<const float*>(smem + g.o_off);
    for (int k = 0, s = 0; k < n; ++k, s = s + 1 == n_slots ? 0 : s + 1) {
      const Tile t = tile_k(k);
      const int* rowtab = taps(s);
      const float* wtab = reinterpret_cast<const float*>(rowtab + d.TY * d.ky);
      // the lanes' 8 own columns one 8-byte word in every tap row: the row
      // pitch and the strip's first even column 2 j0 on multiples of 8 (x0
      // = 2 j0 + 8 gi)
      const int wb = window_base<Tin>(window_src(src, d, t), slot(s));
      const bool aligned = ((g.pitch_in | (wb + 2 * t.j0 - t.xa)) & 7) == 0;
      hopper::mbar_wait(&full[s], (k / n_slots) & 1);
      if (pl.busy) {
        if (aligned) {
          pair_tile<true>(out, rowtab, wtab, xtab, d, t, pl);
        } else {
          pair_tile<false>(out, rowtab, wtab, xtab, d, t, pl);
        }
      }
      __syncwarp();  // the warp's reads of slot s done
      if (pl.lane == 0) hopper::mbar_arrive(&empty[s]);
    }
  } else if constexpr (P == kRingWords) {
    float* T = reinterpret_cast<float*>(smem + g.t_off);
    const int tp = ring_t_pitch(d.SX, P);
    XCol x;
    int x_strip = -1;
    for (int k = 0, s = 0; k < n; ++k, s = s + 1 == n_slots ? 0 : s + 1) {
      const Tile t = tile_k(k);
      if (t.j0 != x_strip) {  // loads in flight through the y pass
        x_col<Tin>(x, xs, wx, d, t, tid);
        x_strip = t.j0;
      }
      const int* rowtab = taps(s);
      const int o = (window_base<Tin>(window_src(src, d, t), slot(s)) + t.cb - t.xa) & 3;
      Tout* orow0 = out + (t.f * d.Hd + t.i0) * static_cast<long long>(d.Wd) + t.j0;
      unsigned char* ot =
          smem + g.o_off + 16 + static_cast<int>(reinterpret_cast<uintptr_t>(orow0) & 15);
      hopper::mbar_wait(&full[s], (k / n_slots) & 1);
      words_y_pass(T, tp, o, rowtab, reinterpret_cast<const float*>(rowtab + d.TY * d.ky), d,
                   g, t, tid);
      consumer_sync();  // T whole; slot s read; the output tile's last stores done
      if (tid == 0) hopper::mbar_arrive(&empty[s]);
      // production's x pass on T's rows at pitch tp, column c at c + o
      XCol xt = x;
      xt.xo += o;
      xt.pairs = d.kx <= kRegTaps && d.kx % 2 == 0 && xt.xo % 2 == 0;
      Dims dt = d;
      dt.SX = tp;
      x_pass<Tout, 0>(T, xt, dt, g, t.rows, ot);
      consumer_sync();  // the output tile whole; T read
      store_tile(orow0, ot, d, g, t.rows, t.cols, tid);
    }
  } else {
    float* T = reinterpret_cast<float*>(smem + g.t_off);
    const int tp = stage_t_pitch(d.SX);
    // thread (xrg, xj) owns dst column j0 + xj at rows xrg, xrg + n_rg, ...
    const int n_rg = kThreads / d.TX;
    const int xj = tid % d.TX;
    const int xrg = tid / d.TX;
    auto x_first = [&](const Tile& t) {
      return xj < t.cols && xrg < n_rg ? __ldg(xs + t.j0 + xj) - t.cb : 0;
    };
    Tile tn = tile_k(0);
    int xon = x_first(tn);
    for (int k = 0, s = 0; k < n; ++k, s = s + 1 == n_slots ? 0 : s + 1) {
      const Tile t = tn;
      const int xo = xon;
      if (k + 1 < n) {  // the next tile's bases and first x taps in flight
        tn = tile_k(k + 1);
        xon = x_first(tn);
      }
      const bool on = xj < t.cols && xrg < n_rg;
      const int* rowtab = taps(s);
      Tout* orow0 = out + (t.f * d.Hd + t.i0) * static_cast<long long>(d.Wd) + t.j0;
      unsigned char* ot = smem + g.o_off + (kY ? 0 : (k & 1) * otile) + 16 +
                          static_cast<int>(reinterpret_cast<uintptr_t>(orow0) & 15);
      hopper::mbar_wait(&full[s], (k / n_slots) & 1);
      if constexpr (kY) {
        stage_y_pass<Tin>(T, tp, rowtab, reinterpret_cast<const float*>(rowtab + d.TY * d.ky),
                          rowtab + 2 * d.TY * d.ky, d, t, tid);
        consumer_sync();  // T whole; slot s read; the output tile's last stores done
        if (tid == 0) hopper::mbar_arrive(&empty[s]);
      }
      // the tile's elements: kRingStage the first tap's pixel, (ys[i],
      // xs[j]) clamped, from the window; kRingStageY T at the first x tap
      const int colx = (min(max(t.cb + xo, t.xa), t.xb - 1) - t.xa) * ei;
      for (int r = on ? xrg : t.rows; r < t.rows; r += n_rg) {
        float v;
        if constexpr (kY) {
          v = T[r * tp + xo];
        } else {
          v = to_f32(*reinterpret_cast<const Tin*>(smem + rowtab[r] + colx));
        }
        store(reinterpret_cast<Tout*>(ot + r * g.pitch_out + xj * static_cast<int>(sizeof(Tout))),
              v);
      }
      consumer_sync();  // the output tile whole (kRingStage: slot s read)
      if constexpr (!kY) {
        if (tid == 0) hopper::mbar_arrive(&empty[s]);
      }
      store_tile(orow0, ot, d, g, t.rows, t.cols, tid);
    }
  }
}

// the staged form's shared-memory layout for elements of ei (in) and eo
// (out) bytes; ops/cuda_apply.band_smem bounds it from above
inline Geo make_geo(const Dims& d, int ei, int eo) {
  Geo g;
  const long long pitch_in = seg_pitch(static_cast<long long>(d.SX) * ei,
                                       static_cast<long long>(d.W) * ei);
  const long long zero_off = up16(32 + d.SY * pitch_in);
  const long long t_off = zero_off + up16(pitch_in + 32);
  const long long tab_off = t_off + up16(4LL * d.TY * d.SX);
  const long long o_off = tab_off + up16(8LL * d.TY * d.ky);
  const long long pitch_out = seg_pitch(static_cast<long long>(d.TX) * eo,
                                        static_cast<long long>(d.Wd) * eo);
  const long long total = o_off + up16(32 + d.TY * pitch_out);
  g.pitch_in = static_cast<int>(pitch_in);
  g.zero_off = static_cast<int>(zero_off);
  g.t_off = static_cast<int>(t_off);
  g.tab_off = static_cast<int>(tab_off);
  g.o_off = static_cast<int>(o_off);
  g.pitch_out = static_cast<int>(pitch_out);
  g.smem = total > INT_MAX ? INT_MAX : static_cast<int>(total);
  return g;
}

// the walk's shared-memory layout for `slots` windows (band_walk_kernel):
// window s at s * zero_off (each laid out as production's), T at t_off,
// the slots' tap tables from tab_off, the output tile at o_off, the 2n
// mbarriers in the last 16n bytes of smem
inline Geo walk_geo(const Dims& d, int ei, int eo, int slots) {
  Geo g = make_geo(d, ei, eo);
  const long long t_off = static_cast<long long>(slots) * g.zero_off;
  const long long tab_off = t_off + up16(4LL * d.TY * d.SX);
  const long long o_off = tab_off + slots * up16(8LL * d.TY * d.ky);
  const long long total = o_off + up16(32 + static_cast<long long>(d.TY) * g.pitch_out) +
                          16LL * slots;
  g.t_off = static_cast<int>(t_off);
  g.tab_off = static_cast<int>(tab_off);
  g.o_off = static_cast<int>(o_off);
  g.smem = total > INT_MAX ? INT_MAX : static_cast<int>(total);
  return g;
}

// the stage ring's layout (band_stage_kernel) for function P:
// kStageSlots = n windows, window s at s * zero_off (each laid out as
// production's), T at t_off (ring_t only; ring_t_pitch floats a row), the
// n tap tables (stage_tab_bytes) from tab_off, the ring_out_tiles output
// tiles (kRingPair: its x table) from o_off, the 2n mbarriers in the last
// 16n bytes of smem
inline Geo stage_geo(const Dims& d, int ei, int eo, int P) {
  Geo g = make_geo(d, ei, eo);
  const long long t_off = static_cast<long long>(kStageSlots) * g.zero_off;
  const long long tab_off =
      t_off + (ring_t(P) ? up16(4LL * d.TY * ring_t_pitch(d.SX, P)) : 0);
  const long long o_off = tab_off + static_cast<long long>(kStageSlots) *
                                        stage_tab_bytes(d.TY, d.ky, ring_y_taps(P));
  const long long total =
      o_off + ring_out_tiles(P) * up16(32 + static_cast<long long>(d.TY) * g.pitch_out) +
      (P == kRingPair ? up16(16LL * pair_pitch(d.Wd)) : 0) + 16LL * kStageSlots;
  if (total > INT_MAX) {
    g.smem = INT_MAX;
    return g;
  }
  g.t_off = static_cast<int>(t_off);
  g.tab_off = static_cast<int>(tab_off);
  g.o_off = static_cast<int>(o_off);
  g.smem = static_cast<int>(total);
  return g;
}

// launch the staged form; the opt-in above 48 KB is set once per device and
// kernel (to the device's maximum), so a launch inside CUDA-graph capture
// after a warm-up launch makes no such call
template <typename Tin, typename Tout, int MODE, bool kClamp>
int launch_staged(const void* src, void* out, const void* ys, const void* wy, const void* xs,
                  const void* wx, const void* row_base, const void* col_base, int F, Dims d,
                  cudaStream_t stream) {
  d.n_strip = (d.Wd + d.TX - 1) / d.TX;
  d.n_rt = (d.Hd + d.TY - 1) / d.TY;
  const long long blocks = static_cast<long long>(F) * d.n_strip * d.n_rt;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const Geo g = make_geo(d, sizeof(Tin), sizeof(Tout));
  auto kern = band_apply_kernel<Tin, Tout, MODE, kClamp>;
  static std::atomic<int> opted_in[stage::kMaxDevices];  // kern's limit per device
  if (const int e = stage::opt_in(reinterpret_cast<const void*>(kern), g.smem, opted_in)) return e;
  kern<<<static_cast<unsigned>(blocks), kThreads, static_cast<size_t>(g.smem), stream>>>(
      static_cast<const Tin*>(src), static_cast<Tout*>(out), static_cast<const int*>(ys),
      static_cast<const float*>(wy), static_cast<const int*>(xs), static_cast<const float*>(wx),
      static_cast<const int*>(row_base), static_cast<const int*>(col_base), d, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace band
}  // namespace
