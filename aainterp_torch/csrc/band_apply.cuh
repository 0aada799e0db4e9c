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
//     are in flight.  (A block that walked several row tiles with the next
//     window in flight was slower at every cell timed on the H100: the
//     second window costs blocks per SM, and the copy is a small part of
//     the time: PERF.md);
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
// with it.  The walk (band_walk_kernel: a form the kernel once had, kept as
// a probe) runs the same phases, as functions, over several row tiles per
// block.
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

// stage the window: rows [ya, yb) copied raw with cp.async (not committed)
template <typename Tin>
__device__ __forceinline__ int stage_window(const Tin* __restrict__ src, const Dims& d,
                                            const Geo& g, const Tile& t, int base, int tid) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ei = sizeof(Tin);
  const unsigned char* seg0 = window_src(src, d, t);
  const int wbase = window_base<Tin>(seg0, base);
  if (t.yb > t.ya && t.xb > t.xa) {  // zero fill only: a window may hold no pixel
    const long long stride = static_cast<long long>(d.W) * ei;
    const int nbytes = (t.xb - t.xa) * ei;
    const int n_chunk = (nbytes + 30) / 16;  // aligned chunks a row can touch
    for (Walk e(tid, n_chunk); e.r < t.yb - t.ya; e.next()) {
      const unsigned char* a = seg0 + e.r * stride;
      const int off = e.c * 16 - static_cast<int>(reinterpret_cast<uintptr_t>(a) & 15);
      if (off < nbytes) cp_async16(smem + wbase + e.r * g.pitch_in + off, a + off);
    }
  }
  return wbase;
}

// the tile's taps: the shared byte offset of each tap row (in the window
// staged at wbase, or a zero row), and its weight.  pitch and origin give
// the rows' layout: row y at origin + (y - ya) * pitch
template <bool kClamp>
__device__ __forceinline__ void tap_table(int* rowtab, float* wtab, const int* __restrict__ ys,
                                          const float* __restrict__ wy, const Dims& d,
                                          const Geo& g, const Tile& t, int origin, int pitch,
                                          int tid) {
  const int zero_row = g.zero_off + 16;
  for (Walk e(tid, d.ky); e.r < t.rows; e.next()) {
    const int y = __ldg(ys + t.i0 + e.r) + e.c;
    int row;
    if (kClamp) {
      row = origin + (min(max(y, 0), d.H - 1) - t.ya) * pitch;
    } else {
      row = (y >= t.ya && y < t.yb) ? origin + (y - t.ya) * pitch : zero_row;
    }
    rowtab[e.r * d.ky + e.c] = row;
    wtab[e.r * d.ky + e.c] = __ldg(wy + static_cast<long long>(t.i0 + e.r) * d.ky + e.c);
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
  kU8Words = 3,     // u8: the y pass reads 4 pixels per 32-bit word
  kXPair = 4,       // an exact ratio-2 x pass from a (4, Wd) table
  kU8Convert1 = 5,  // u8: the window converted to f32 in shared memory ...
  kU8Convert2 = 6,  // ... in 2 column chunks, each then y-passed
  kU8Convert4 = 7,  // ... in 4
  kWalk2 = 8,       // one block walks row tiles, 1 window in flight
  kWalk3 = 9,       // ... 2 in flight
  kWalk4 = 10,      // ... 3 in flight (band_walk_kernel)
  kXOnly = 11,      // the x pass alone, T staged from the y pass's output
};

__host__ __device__ constexpr int convert_chunks(int p) {
  return p == kU8Convert1 ? 1 : p == kU8Convert2 ? 2 : p == kU8Convert4 ? 4 : 0;
}
__host__ __device__ constexpr int walk_slots(int p) {
  return p == kWalk2 ? 2 : p == kWalk3 ? 3 : p == kWalk4 ? 4 : 0;
}

// The y pass over T columns [c_lo, c_hi) only (MODE 0), pixels read as Tv
// with column x at byte (x - x_org) * sizeof(Tv) of each tap row: the
// converted f32 chunks of kU8Convert.  The items, lanes and tap order are
// y_pass's.
template <typename Tv>
__device__ __forceinline__ void y_pass_cols(float* __restrict__ T, const int* rowtab,
                                            const float* wtab, const Dims& d, int rows, int cb,
                                            int xa, int xb, int c_lo, int c_hi, int x_org) {
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
      off[q] = (min(max(cb + c, xa), xb - 1) - x_org) * static_cast<int>(sizeof(Tv));
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

// kU8Words' y pass (u8, MODE 0, clamped taps): a lane takes 4 neighbouring
// T columns and reads their 4 pixels of a tap row as one 32-bit word,
// funnel-shifted from the two aligned words that hold it (a window row
// starts at its global row's alignment), bytes in little-endian order
// (byte k is column x0 + k); columns clamped to the window's edge read
// pixel by pixel.  Each column sums its taps in order, as y_pass does.
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
    // the y pass reads the f32 chunk buffer at g.smem: window row y - ya
    // at g.smem + (y - ya) * (SX / kChunks) * 4
    const int fpitch = (d.SX + kChunks - 1) / kChunks * 4;
    for (Walk e(tid, d.ky); e.r < rows; e.next()) {
      const int y = __ldg(ys + i0 + e.r) + e.c;
      rowtab[e.r * d.ky + e.c] = g.smem + (min(max(y, 0), d.H - 1) - ya) * fpitch;
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
    // the window to f32 in shared memory, chunk by chunk of T's columns,
    // each chunk then y-passed from it
    float* fb = reinterpret_cast<float*>(smem + g.smem);
    const int cpitch = (d.SX + kChunks - 1) / kChunks;
    for (int c_lo = 0; c_lo < d.SX; c_lo += cpitch) {
      const int c_hi = min(d.SX, c_lo + cpitch);
      const int wlo = min(max(cb + c_lo, xa), xb - 1) - xa;
      const int nw = min(max(cb + c_hi - 1, xa), xb - 1) - xa + 1 - wlo;
      for (Walk e(tid, nw); e.r < yb - ya; e.next()) {
        fb[e.r * cpitch + e.c] = to_f32(
            *reinterpret_cast<const Tin*>(smem + wbase + e.r * g.pitch_in + (wlo + e.c) * ei));
      }
      __syncthreads();
      y_pass_cols<float>(T, rowtab, wtab, d, rows, cb, xa, xb, c_lo, c_hi, xa + wlo);
      __syncthreads();
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

// kWalk<n> (probe): one block per (frame, strip, run of `steps` row tiles),
// walking its run with n - 1 windows in flight: tile k + n - 1's window is
// staged (slot (k + n - 1) % n) before tile k is computed.  Each tile goes
// through the production kernel's phases (the functions above, the same
// arithmetic): its output is production's bit for bit.  Slot 0 is the
// production window's place, slots 1.. follow the production layout
// (from g.smem).
template <typename Tin, typename Tout, int kSlots>
__global__ void __launch_bounds__(kThreads) band_walk_kernel(
    const Tin* __restrict__ src, Tout* __restrict__ out, const int* __restrict__ ys,
    const float* __restrict__ wy, const int* __restrict__ xs, const float* __restrict__ wx,
    const int* __restrict__ row_base, const int* __restrict__ col_base, Dims d, Geo g,
    int steps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int n_run = (d.n_rt + steps - 1) / steps;
  const int strip = blockIdx.x % d.n_strip;
  const int rest = blockIdx.x / d.n_strip;
  const long long f = rest / n_run;
  const int first = (rest % n_run) * steps;
  const int n = min(steps, d.n_rt - first);
  auto slot = [&](int k) { return k % kSlots == 0 ? 0 : g.smem + (k % kSlots - 1) * g.zero_off; };
  for (int k = 0; k < kSlots - 1; ++k) {
    if (k < n) {
      stage_window(src, d, g, tile_at<true>(d, row_base, col_base, strip, first + k, f),
                   slot(k), tid);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }
  int* rowtab = reinterpret_cast<int*>(smem + g.tab_off);
  float* wtab = reinterpret_cast<float*>(rowtab + d.TY * d.ky);
  float* T = reinterpret_cast<float*>(smem + g.t_off);
  XCol x;
  x_col<Tin>(x, xs, wx, d, tile_at<true>(d, row_base, col_base, strip, first, f), tid);
  for (int k = 0; k < n; ++k) {
    const int ahead = k + kSlots - 1;
    if (ahead < n) {
      stage_window(src, d, g, tile_at<true>(d, row_base, col_base, strip, first + ahead, f),
                   slot(ahead), tid);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    const Tile t = tile_at<true>(d, row_base, col_base, strip, first + k, f);
    tap_table<true>(rowtab, wtab, ys, wy, d, g, t, window_base<Tin>(window_src(src, d, t), slot(k)),
                    g.pitch_in, tid);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kSlots - 1));
    __syncthreads();
    y_pass<Tin, 0, true>(T, rowtab, wtab, d, t.rows, t.cb, t.xa, t.xb);
    __syncthreads();
    Tout* orow0 = out + (t.f * d.Hd + t.i0) * static_cast<long long>(d.Wd) + t.j0;
    unsigned char* ot =
        smem + g.o_off + 16 + static_cast<int>(reinterpret_cast<uintptr_t>(orow0) & 15);
    x_pass<Tout, 0>(T, x, d, g, t.rows, ot);
    __syncthreads();
    store_tile(orow0, ot, d, g, t.rows, t.cols, tid);
    __syncthreads();  // the tap table and output tile are the next tile's
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
