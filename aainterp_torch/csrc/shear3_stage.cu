// 3-pass conservative shear (mode='shear') for Hopper (sm_90a): the two
// stage kernels.
//
// Replaces the two TPU Pallas kernels of aainterp/ops/pallas_shear3.py:
//
//   aainterp_shear3_ystage <- _build_y_stage (:230, pallas_call at :334)
//   aainterp_shear3_xstage <- _build_x_stage (:342, pallas_call at :443)
//
// Each launch runs one whole pass of a Shear3Plan (ops/shear3.py, laid out
// by shear3.stage_plan) on F frames.  Along the pass axis, for each line l
// (a column for the y-stage, a row for the x-stage) with shift d = d[l] and
// fraction f = f[l], the translate of a line v at grid cell t is
//
//   tr(v, t) = (1-f) v[t-d] + f v[t-d-1]           taps outside v read 0
//
// and band row i is  sum_k w[i,k] v[start[i]+k]    taps outside v read 0.
// The three forms of a pass:
//
//   form 0, translate:  out[u] = tr(in, u + crop)
//   form 1, pre-band:   out[u] = tr(mid, u + crop),   mid = band(in), n_mid cells
//   form 2, post-band:  out[u] = band(T)[u],          T[t] = tr(in, t), t < n_t
//
// then, on the plan's last stage only, out *= inv_cov[pixel], and the cast
// to the output type (bf16: round to nearest even; uint8: round half to
// even, saturate to [0, 255]).
//
// Arithmetic: f32, in the order of the plain torch stages (ops/shear3.py:
// translate tap (1-f) first, band taps k = 0..K-1), every product rounded
// before its add (__fmul_rn / __fadd_rn, so nvcc contracts nothing into an
// FMA).  A stage therefore equals its plain version bit for bit.
//
// What the TPU kernels did that is not carried over: the Pallas plan
// (build_shear3_kernel_plan) pads lines to 128 lanes and 16 sublanes,
// lifts d so that crops land on aligned offsets, densifies the bands into
// MXU blocks at static bases, and realises the per-line shift as log2 bit
// rolls of a VMEM strip, because Mosaic rotates 32-bit values only and the
// TPU has no gather.  Here each output reads its taps at the plan's own d,
// f, crop, n_t, band start and weights, from shared memory.
//
// What bounds them: bytes, in principle.  A stage does 2 (translate),
// 2K+2 (pre-band) or 3K+2 (post-band) operations per output element
// against 2 to 6 bytes of input and output, far below the card's ridge;
// the floor is one read of the input and one write of the output.  The
// design:
//
//   * one block per tile of TL lines by TU output cells (shear3.plan_tiles),
//     whose input window [lo, hi) along the pass axis -- the union of the
//     taps of all its outputs, clipped to the input -- comes from a host
//     table (shear3.tile_windows).  The block copies the window into shared
//     memory as raw input bytes with 16-byte cp.async, coalesced: in the
//     y-stage one segment per input row (TL neighbouring columns), in the
//     x-stage one segment per line (hi - lo neighbouring cells).  Rows are
//     not 16-byte aligned (1399 bf16 cells are 2798 bytes), so each
//     segment's aligned chunks are copied whole and the segment's shared
//     pitch equals its global stride mod 16; element e of segment s then
//     sits at base + s * pitch + e * sizeof(In) with no per-row offset.  A
//     chunk is 16-byte aligned and holds at least one byte of the input,
//     so it never leaves the input's memory pages;
//   * the taps then come from shared memory, so neighbouring lanes of a
//     y-stage warp, which read along the shear (d steps by up to one cell
//     per column), no longer each pull their own 32-byte sector;
//   * a pre-band tile computes each of its mid cells [mlo, mhi) once into
//     shared memory (f32), then translates from them;
//   * each thread computes 4 lines at one output cell at a time, so a
//     band row's start and weights, and the test that every tap lies in
//     the window (taken per output row, not per tap), serve 4 outputs;
//     neighbouring lanes read neighbouring cells (no bank conflicts).  A
//     transpose through shared memory then hands each thread 4
//     neighbouring outputs of one output row, stored with one 16-, 8- or
//     4-byte store where the address allows (scalar stores at ragged row
//     ends); inv_cov is read the same way;
//   * the stage's form is a template parameter, so each kernel holds one
//     form's code;
//   * a tile whose window is empty (the rotated image's corners) stages
//     nothing and writes zeros: its outputs are exactly 0 whatever the
//     input (decided by the host table, not by the data);
//   * EVERY output element is written, zeros included, so a torch.empty
//     output holds no stale NaN where a later zero weight reads it;
//   * a stage whose smallest tile needs more shared memory than the card's
//     opt-in limit (a heavy downscale: one y pre-band tile of 8192^2 ->
//     4x4 spans its whole input) takes the direct form, one thread per
//     output element reading its taps from device memory with the same
//     arithmetic.
//
// Measured on the H100 (PERF.md, chip_sweep.py): with the compute
// removed a stage still takes 73 % (y) and 89 % (x) of its time, with the
// staging removed 88-90 %: the two phases overlap across blocks but not
// within one, and each alone runs at about the same rate.
//
// Plain C interface for ctypes; each launch goes on the caller's stream and
// does not synchronise.  The return value is cudaGetLastError() after the
// launch (0 on success).  The opt-in to more than 48 KB of shared memory is
// made once per device and kernel, at the first launch that needs it, so a
// launch inside CUDA-graph capture after a warm-up launch makes no such call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <climits>

#include "stage_common.cuh"

// the block's dynamic shared memory: the staged window, the mid cells
// (form 1), then the output transpose
extern __shared__ __align__(16) unsigned char smem[];

namespace {

constexpr int kThreads = 128;
constexpr int kVec = 4;  // lines a thread computes at once; outputs per store

using stage::cp_async16;
using stage::seg_pitch;
using Walk = stage::Walk<kThreads>;

enum Form { kTranslate = 0, kPreBand = 1, kPostBand = 2 };

struct StageDims {
  int n_lines;  // lines: the other axis
  int n_in;     // input cells along the pass axis
  int n_mid;    // pre-band output cells (form 1)
  int n_t;      // translate grid cells
  int crop;
  int n_out;    // output cells along the pass axis
  int K;        // band width (forms 1, 2)
  int form;
  int TL, TU;   // tile: lines by output cells
  int max_win;  // largest window, cells (hi - lo)
  int max_mid;  // largest mid range, cells (mhi - mlo; form 1)
};

struct StageTables {
  const int* d;          // (n_lines,) integer shift
  const float* f;        // (n_lines,) fraction
  const int* start;      // (band rows,) first tap
  const float* w;        // (band rows, K) weights
  const float* inv_cov;  // (out rows, out cols), or null
  const int4* win;       // (n_out tiles, n_lines tiles): lo, hi, mlo, mhi
};

// launch geometry, derived on the host from StageDims and the element size
struct Geo {
  int n_tl, n_tu;        // line tiles, output tiles
  int pitch;             // shared bytes per staged segment
  int mid_off;           // shared byte offset of the f32 mid cells
  int xch_off;           // shared byte offset of the output transpose
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(uint8_t v) { return static_cast<float>(v); }

__device__ __forceinline__ uint8_t to_u8(float v) {
  return static_cast<uint8_t>(fminf(fmaxf(rintf(v), 0.0f), 255.0f));
}

// v[0..n) to p[0..n), n <= 4: one vector store when all 4 land on an
// aligned address, else one store per element
__device__ __forceinline__ void store4(float* p, int n, const float* v) {
  if (n == kVec && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    for (int q = 0; q < n; ++q) p[q] = v[q];
  }
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, int n, const float* v) {
  if (n == kVec && (reinterpret_cast<uintptr_t>(p) & 7) == 0) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(p) = make_uint2(
        *reinterpret_cast<const unsigned*>(&a), *reinterpret_cast<const unsigned*>(&b));
  } else {
    for (int q = 0; q < n; ++q) p[q] = __float2bfloat16_rn(v[q]);
  }
}
__device__ __forceinline__ void store4(uint8_t* p, int n, const float* v) {
  if (n == kVec && (reinterpret_cast<uintptr_t>(p) & 3) == 0) {
    *reinterpret_cast<unsigned*>(p) =
        static_cast<unsigned>(to_u8(v[0])) | (static_cast<unsigned>(to_u8(v[1])) << 8) |
        (static_cast<unsigned>(to_u8(v[2])) << 16) | (static_cast<unsigned>(to_u8(v[3])) << 24);
  } else {
    for (int q = 0; q < n; ++q) p[q] = to_u8(v[q]);
  }
}

// v[q] *= p[q] for q < n, p read as one float4 where aligned
__device__ __forceinline__ void scale4(const float* __restrict__ p, int n, float* v) {
  if (n == kVec && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const float4 c = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = __fmul_rn(v[0], c.x);
    v[1] = __fmul_rn(v[1], c.y);
    v[2] = __fmul_rn(v[2], c.z);
    v[3] = __fmul_rn(v[3], c.w);
  } else {
    for (int q = 0; q < n; ++q) v[q] = __fmul_rn(v[q], __ldg(p + q));
  }
}

// acc + a * b, the product rounded before the add
__device__ __forceinline__ float madd(float acc, float a, float b) {
  return __fadd_rn(acc, __fmul_rn(a, b));
}

// One line of the staged window: cell j along the pass axis, 0 outside
// [lo, lo + n) (which holds every tap inside the input).  get<false>
// skips the test, for taps known to lie inside.
template <typename In>
struct Line {
  int base;  // shared byte offset of cell 0 (negative when lo > 0)
  int step;  // shared bytes between cells
  int lo, n;
  __device__ __forceinline__ bool holds(int a, int b) const {  // [a, b] inside
    return a >= lo && b < lo + n;
  }
  template <bool kCheck>
  __device__ __forceinline__ float get(int j) const {
    if (kCheck && static_cast<unsigned>(j - lo) >= static_cast<unsigned>(n)) return 0.0f;
    return to_f32(*reinterpret_cast<const In*>(smem + (base + j * step)));
  }
};

// One line of the tile's mid cells: mid cell m, 0 outside [lo, lo + n)
// (which holds every mid cell inside [0, n_mid) that the tile reads).
struct MidLine {
  int base;  // shared byte offset of mid cell 0
  int step;  // shared bytes between mid cells
  int lo, n;
  __device__ __forceinline__ bool holds(int a, int b) const { return a >= lo && b < lo + n; }
  template <bool kCheck>
  __device__ __forceinline__ float get(int m) const {
    if (kCheck && static_cast<unsigned>(m - lo) >= static_cast<unsigned>(n)) return 0.0f;
    return *reinterpret_cast<const float*>(smem + (base + m * step));
  }
};

// One line of the input read straight from device memory (the direct
// form): cell j of n, 0 outside; get<false> skips the test.
template <typename In>
struct GLine {
  const In* p;     // cell 0
  long long step;  // elements between cells
  int n;
  __device__ __forceinline__ bool holds(int a, int b) const { return a >= 0 && b < n; }
  template <bool kCheck>
  __device__ __forceinline__ float get(int j) const {
    if (kCheck && static_cast<unsigned>(j) >= static_cast<unsigned>(n)) return 0.0f;
    return to_f32(p[j * step]);
  }
};

// sum_k w[i,k] v(start[i] + k) for kN lines, taps in order; the band's
// start and weights are read once for all kN lines
template <int kN, typename L>
__device__ __forceinline__ void band_rows(const L* v, const StageTables& t, int i, int K,
                                          float* r) {
  const int s = __ldg(t.start + i);
  const float* wr = t.w + static_cast<long long>(i) * K;
#pragma unroll
  for (int q = 0; q < kN; ++q) r[q] = 0.0f;
  if (v[0].holds(s, s + K - 1)) {
    for (int k = 0; k < K; ++k) {
      const float w = __ldg(wr + k);
#pragma unroll
      for (int q = 0; q < kN; ++q) r[q] = madd(r[q], v[q].template get<false>(s + k), w);
    }
  } else {
    for (int k = 0; k < K; ++k) {
      const float w = __ldg(wr + k);
#pragma unroll
      for (int q = 0; q < kN; ++q) r[q] = madd(r[q], v[q].template get<true>(s + k), w);
    }
  }
}

// (1-f) v(t-d) + f v(t-d-1) for kN lines at one grid cell t; the first
// add of the plain version is 0 + x
template <int kN, typename V>
__device__ __forceinline__ void translate(const V* v, int t, const int* d, const float* f,
                                          int dmin, int dmax, float* r) {
  if (v[0].holds(t - dmax - 1, t - dmin)) {  // every line's window is the tile's
#pragma unroll
    for (int q = 0; q < kN; ++q) {
      r[q] = madd(__fmul_rn(v[q].template get<false>(t - d[q]), 1.0f - f[q]),
                  v[q].template get<false>(t - d[q] - 1), f[q]);
    }
  } else {
#pragma unroll
    for (int q = 0; q < kN; ++q) {
      r[q] = madd(__fmul_rn(v[q].template get<true>(t - d[q]), 1.0f - f[q]),
                  v[q].template get<true>(t - d[q] - 1), f[q]);
    }
  }
}

// the mid cells of one line computed where they are read (the direct
// form's pre-band): mid cell m = band row m of the input line, 0 outside
// [0, n)
template <typename In>
struct GMid {
  GLine<In> v;
  const StageTables* t;
  int K, n;
  __device__ __forceinline__ bool holds(int a, int b) const { return a >= 0 && b < n; }
  template <bool kCheck>
  __device__ __forceinline__ float get(int m) const {
    if (kCheck && static_cast<unsigned>(m) >= static_cast<unsigned>(n)) return 0.0f;
    float r;
    band_rows<1>(&v, *t, m, K, &r);
    return r;
  }
};

// band row u over the translate grid T[t] = tr(v, t), t in [0, n_t), for
// kN lines: each line's K+1 input cells v(s-d-1 .. s+K-1-d) are read once,
// and the band's start, weights and grid test once for all kN lines
template <bool kCheck, int kN, typename L>
__device__ __forceinline__ void post_band_taps(const L* v, int s, const float* wr,
                                               int K, int n_t, const int* d, const float* f,
                                               float* r) {
  float prev[kN], g[kN];
#pragma unroll
  for (int q = 0; q < kN; ++q) {
    g[q] = 1.0f - f[q];
    prev[q] = v[q].template get<kCheck>(s - d[q] - 1);
    r[q] = 0.0f;
  }
  for (int k = 0; k < K; ++k) {
    const int c = s + k;
    const bool in_grid = c >= 0 && c < n_t;
    const float w = __ldg(wr + k);
#pragma unroll
    for (int q = 0; q < kN; ++q) {
      const float cur = v[q].template get<kCheck>(c - d[q]);
      const float tr = in_grid ? madd(__fmul_rn(cur, g[q]), prev[q], f[q]) : 0.0f;
      r[q] = madd(r[q], tr, w);
      prev[q] = cur;
    }
  }
}

template <int kN, typename L>
__device__ __forceinline__ void post_band(const L* v, const StageTables& t, int u, int K,
                                          int n_t, const int* d, const float* f, int dmin,
                                          int dmax, float* r) {
  const int s = __ldg(t.start + u);
  const float* wr = t.w + static_cast<long long>(u) * K;
  if (v[0].holds(s - dmax - 1, s + K - 1 - dmin)) {
    post_band_taps<false, kN>(v, s, wr, K, n_t, d, f, r);
  } else {
    post_band_taps<true, kN>(v, s, wr, K, n_t, d, f, r);
  }
}

// output cell u of kN lines (shifts d, fractions f, between dmin and dmax),
// from their staged cells and (form 1) mid cells
template <int kForm, int kN, typename In>
__device__ __forceinline__ void out_cells(const StageDims& s, const StageTables& t,
                                          const Line<In>* v, const MidLine* mid, int u,
                                          const int* d, const float* f, int dmin, int dmax,
                                          float* r) {
  if (kForm == kPostBand) {
    post_band<kN>(v, t, u, s.K, s.n_t, d, f, dmin, dmax, r);
  } else if (kForm == kPreBand) {
    translate<kN>(mid, u + s.crop, d, f, dmin, dmax, r);
  } else {
    translate<kN>(v, u + s.crop, d, f, dmin, dmax, r);
  }
}

// One block per tile: output tile tu by line tile tl of frame fr (line
// tile fastest).  y-stage: in (F, n_in, n_lines), out (F, n_out,
// n_lines); x-stage: in (F, n_lines, n_in), out (F, n_lines, n_out).
template <bool kY, int kForm, typename In, typename Out>
__global__ void __launch_bounds__(kThreads) stage_kernel(
    const In* __restrict__ x, Out* __restrict__ out, StageTables t, StageDims s, Geo g) {
  constexpr int es = sizeof(In);
  const int tl = blockIdx.x % g.n_tl;
  const int rest = blockIdx.x / g.n_tl;
  const int tu = rest % g.n_tu;
  const long long fr = rest / g.n_tu;
  const int l0 = tl * s.TL;
  const int u0 = tu * s.TU;
  const int nl = min(s.TL, s.n_lines - l0);  // lines of this tile
  const int nu = min(s.TU, s.n_out - u0);    // output cells of this tile
  const int4 win = t.win[tu * g.n_tl + tl];
  const int lo = win.x, n_win = win.y - win.x;
  const int mlo = win.z, n_mid = win.w - win.z;
  const int lane = threadIdx.x % 32;

  if (n_win <= 0) {  // an empty tile: its outputs are 0
    // G threads per output row, 4 neighbouring outputs each
    const int G = (kY ? s.TL : s.TU) / kVec;
    const int s0 = (threadIdx.x % G) * kVec;
    const int n_store = kY ? nl : nu;
    const int n_other = kY ? nu : nl;
    const float z[kVec] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int o = threadIdx.x / G; s0 < n_store && o < n_other; o += kThreads / G) {
      Out* row = out + (kY ? (fr * s.n_out + u0 + o) * s.n_lines + l0
                           : (fr * s.n_lines + l0 + o) * s.n_out + u0);
      store4(row + s0, min(kVec, n_store - s0), z);
    }
    return;
  }

  // ---- stage the window: segments of raw input bytes, 16-byte chunks ----
  // y: one segment per input row lo.., nl columns wide; x: one per line,
  // n_win cells long.  Segment s, element e at shared byte base + s *
  // pitch + e * es.
  const long long stride = static_cast<long long>(kY ? s.n_lines : s.n_in) * es;
  const unsigned char* seg0 = reinterpret_cast<const unsigned char*>(x) +
      (kY ? ((fr * s.n_in + lo) * s.n_lines + l0) : ((fr * s.n_lines + l0) * s.n_in + lo)) * es;
  const int n_seg = kY ? n_win : nl;
  const int seg_bytes = (kY ? nl : n_win) * es;
  const int base = 16 + static_cast<int>(reinterpret_cast<uintptr_t>(seg0) & 15);
  const int n_chunk = (seg_bytes + 30) / 16;  // aligned chunks a segment can touch
  for (Walk e(threadIdx.x, n_chunk); e.r < n_seg; e.next()) {
    const unsigned char* a = seg0 + e.r * stride;
    const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(a) & 15);
    const int off = e.c * 16 - mis;  // chunk start relative to the segment
    if (off < seg_bytes) cp_async16(smem + base + e.r * g.pitch + off, a + off);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  // staged cell j of tile line c (clamped to the tile's lines)
  auto line = [&](int c) {
    c = min(c, nl - 1);
    Line<In> v;
    v.base = kY ? base + c * es - lo * g.pitch : base + c * g.pitch - lo * es;
    v.step = kY ? g.pitch : es;
    v.lo = lo;
    v.n = n_win;
    return v;
  };
  // mid cell m of tile line c: y mid[(m - mlo) * TL + c], x mid[c * max_mid
  // + m - mlo], f32
  auto mid_line = [&](int c) {
    c = min(c, nl - 1);
    MidLine m;
    m.base = g.mid_off + 4 * (kY ? c - mlo * s.TL : c * s.max_mid - mlo);
    m.step = 4 * (kY ? s.TL : 1);
    m.lo = mlo;
    m.n = n_mid;
    return m;
  };

  // Each thread computes 4 lines at one output cell u at a time, so the
  // band's start and weights and the window tests are shared by 4 outputs;
  // neighbouring lanes read neighbouring taps (no bank conflicts).  y: the
  // 4 lines are G apart, lanes on neighbouring lines; x: 4 neighbouring
  // lines, lanes on neighbouring u.  A transpose through shared memory then
  // gives each thread 4 neighbouring outputs of one output row for one
  // wide store.  Every loop runs the same trips in all lanes of a warp.
  const int G = kY ? s.TL / kVec : kThreads / (s.TL / kVec);  // lanes per line group
  const int gi = threadIdx.x % G;
  const int o0 = threadIdx.x / G;  // y: first row; x: line group
  Line<In> v[kVec];
  MidLine mv[kVec];
  int d[kVec];
  float f[kVec];
  int dmin = INT_MAX, dmax = INT_MIN;
#pragma unroll
  for (int q = 0; q < kVec; ++q) {
    const int c = kY ? gi + G * q : o0 * kVec + q;
    v[q] = line(c);
    mv[q] = mid_line(c);
    d[q] = __ldg(t.d + l0 + min(c, nl - 1));
    f[q] = __ldg(t.f + l0 + min(c, nl - 1));
    dmin = min(dmin, d[q]);
    dmax = max(dmax, d[q]);
  }

  // ---- pre-band: each mid cell of the tile once, into shared memory -----
  if (kForm == kPreBand) {
    float* mid = reinterpret_cast<float*>(smem + g.mid_off);
    // y: (mid cell, line group) with line groups fastest, lines c0 + G q;
    // x: (line group, mid cell) with mid cells fastest, lines 4 lg + q
    const int ng = kY ? G : (nl + kVec - 1) / kVec;
    for (Walk e(threadIdx.x, kY ? ng : n_mid); e.r < (kY ? n_mid : ng); e.next()) {
      const int mi = kY ? e.r : e.c;
      Line<In> bv[kVec];
      int c[kVec];
#pragma unroll
      for (int q = 0; q < kVec; ++q) {
        c[q] = kY ? e.c + G * q : e.r * kVec + q;
        bv[q] = line(c[q]);
      }
      float r[kVec];
      band_rows<kVec>(bv, t, mlo + mi, s.K, r);
#pragma unroll
      for (int q = 0; q < kVec; ++q) mid[kY ? mi * s.TL + c[q] : c[q] * s.max_mid + mi] = r[q];
    }
    __syncthreads();
  }

  float* xch = reinterpret_cast<float*>(smem + g.xch_off) + (threadIdx.x - lane) * kVec;
  if (kY) {
    // rows o0, o0 + ostep, ...; the transpose within each group of G <= 32
    // lanes gives lane gi the lines 4 gi .. 4 gi + 3
    const int ostep = kThreads / G;
    float* xw = xch + (lane - gi) * kVec;
    const int c0 = gi * kVec;  // first stored line
    for (int ob = 0; ob < nu; ob += ostep) {
      const int o = ob + o0;
      const int u = u0 + min(o, nu - 1);
      float r[kVec];
      out_cells<kForm, kVec>(s, t, v, mv, u, d, f, dmin, dmax, r);
#pragma unroll
      for (int q = 0; q < kVec; ++q) xw[q * G + gi] = r[q];
      __syncwarp();
      const float4 w4 = *reinterpret_cast<const float4*>(xw + kVec * gi);
      __syncwarp();
      r[0] = w4.x; r[1] = w4.y; r[2] = w4.z; r[3] = w4.w;
      if (o < nu && c0 < nl) {
        const int n = min(kVec, nl - c0);
        if (t.inv_cov != nullptr) scale4(t.inv_cov + static_cast<long long>(u) * s.n_lines + l0 + c0, n, r);
        store4(out + (fr * s.n_out + u) * s.n_lines + l0 + c0, n, r);
      }
    }
  } else {
    // u = u0 + ub + gi; the transpose within each warp gives lane the
    // line 4 o0 + lane / 8 at u0 + ub + (gi - lane) + 4 (lane % 8) .. + 3
    const int cs = o0 * kVec + lane / 8;           // stored line
    const int us = gi - lane + kVec * (lane % 8);  // stored u, less ub
    for (int ub = 0; ub < nu; ub += G) {
      const int u = u0 + min(ub + gi, nu - 1);
      float r[kVec];
      out_cells<kForm, kVec>(s, t, v, mv, u, d, f, dmin, dmax, r);
#pragma unroll
      for (int q = 0; q < kVec; ++q) xch[q * 32 + lane] = r[q];
      __syncwarp();
      const float4 w4 = *reinterpret_cast<const float4*>(xch + (lane / 8) * 32 + kVec * (lane % 8));
      __syncwarp();
      r[0] = w4.x; r[1] = w4.y; r[2] = w4.z; r[3] = w4.w;
      if (cs < nl && ub + us < nu) {
        const int n = min(kVec, nu - ub - us);
        const long long row = static_cast<long long>(l0 + cs) * s.n_out + u0 + ub + us;
        if (t.inv_cov != nullptr) scale4(t.inv_cov + row, n, r);
        store4(out + fr * s.n_lines * s.n_out + row, n, r);
      }
    }
  }
}

// The direct form, for stages whose smallest tile needs more shared memory
// than the card has (shear3.plan_tiles): one thread per output element,
// taps read from device memory, in the staged form's order with the same
// roundings (a pre-band's mid cells computed where they are read), so the
// same bits.  e runs over the output (F, n_out, n_lines) for y and (F,
// n_lines, n_out) for x.
template <bool kY, int kForm, typename In, typename Out>
__global__ void __launch_bounds__(kThreads) stage_direct_kernel(
    const In* __restrict__ x, Out* __restrict__ out, StageTables t, StageDims s,
    long long total) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= total) return;
  const int n_a = kY ? s.n_lines : s.n_out;  // the output's fastest axis
  const int n_b = kY ? s.n_out : s.n_lines;
  const int ia = static_cast<int>(e % n_a);
  const long long q = e / n_a;
  const int ib = static_cast<int>(q % n_b);
  const long long fr = q / n_b;
  const int l = kY ? ia : ib;
  const int u = kY ? ib : ia;
  GLine<In> v;
  v.p = kY ? x + fr * s.n_in * static_cast<long long>(s.n_lines) + l
           : x + (fr * s.n_lines + l) * static_cast<long long>(s.n_in);
  v.step = kY ? s.n_lines : 1;
  v.n = s.n_in;
  const int d = __ldg(t.d + l);
  const float f = __ldg(t.f + l);
  float r;
  if (kForm == kPostBand) {
    post_band<1>(&v, t, u, s.K, s.n_t, &d, &f, d, d, &r);
  } else if (kForm == kPreBand) {
    const GMid<In> mid{v, &t, s.K, s.n_mid};
    translate<1>(&mid, u + s.crop, &d, &f, d, d, &r);
  } else {
    translate<1>(&v, u + s.crop, &d, &f, d, d, &r);
  }
  if (t.inv_cov != nullptr) {
    r = __fmul_rn(r, __ldg(t.inv_cov + (kY ? static_cast<long long>(u) * s.n_lines + l
                                           : static_cast<long long>(l) * s.n_out + u)));
  }
  store4(out + e, 1, &r);
}

template <bool kY, int kForm, typename In, typename Out>
int launch(const void* x, void* out, const StageTables& t, const StageDims& s, int F,
           cudaStream_t st) {
  constexpr int es = sizeof(In);
  if (s.TL == 0) {  // the direct form
    const long long total = static_cast<long long>(F) * s.n_lines * s.n_out;
    const long long blocks = (total + kThreads - 1) / kThreads;
    if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    stage_direct_kernel<kY, kForm, In, Out><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        static_cast<const In*>(x), static_cast<Out*>(out), t, s, total);
    return static_cast<int>(cudaGetLastError());
  }
  Geo g;
  g.n_tl = (s.n_lines + s.TL - 1) / s.TL;
  g.n_tu = (s.n_out + s.TU - 1) / s.TU;
  // shared memory: shear3.stage_smem
  const long long segs = kY ? s.max_win : s.TL;
  const long long pitch = kY ? seg_pitch(static_cast<long long>(s.TL) * es, static_cast<long long>(s.n_lines) * es)
                             : seg_pitch(static_cast<long long>(s.max_win) * es, static_cast<long long>(s.n_in) * es);
  const long long head = (32 + segs * pitch + 15) / 16 * 16;
  const long long xch = head + (4LL * s.TL * (kForm == kPreBand ? s.max_mid : 0) + 15) / 16 * 16;
  const long long smem = xch + 4LL * kThreads * kVec;
  const long long blocks = static_cast<long long>(F) * g.n_tl * g.n_tu;
  if (blocks > INT_MAX || smem > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  g.pitch = static_cast<int>(pitch);
  g.mid_off = static_cast<int>(head);
  g.xch_off = static_cast<int>(xch);
  auto kern = stage_kernel<kY, kForm, In, Out>;
  static std::atomic<int> opted_in[stage::kMaxDevices];  // kern's limit per device
  if (const int e = stage::opt_in(reinterpret_cast<const void*>(kern), smem, opted_in)) return e;
  kern<<<static_cast<unsigned>(blocks), kThreads, static_cast<size_t>(smem), st>>>(
      static_cast<const In*>(x), static_cast<Out*>(out), t, s, g);
  return static_cast<int>(cudaGetLastError());
}

template <bool kY, typename In, typename Out>
int launch_form(const void* x, void* out, const StageTables& t, const StageDims& s, int F,
                cudaStream_t st) {
  switch (s.form) {
    case kTranslate: return launch<kY, kTranslate, In, Out>(x, out, t, s, F, st);
    case kPreBand: return launch<kY, kPreBand, In, Out>(x, out, t, s, F, st);
    case kPostBand: return launch<kY, kPostBand, In, Out>(x, out, t, s, F, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// type codes: 0 = float32, 1 = bfloat16, 2 = uint8
template <bool kY, typename In>
int launch_out(int out_code, const void* x, void* out, const StageTables& t, const StageDims& s,
               int F, cudaStream_t st) {
  switch (out_code) {
    case 0: return launch_form<kY, In, float>(x, out, t, s, F, st);
    case 1: return launch_form<kY, In, __nv_bfloat16>(x, out, t, s, F, st);
    case 2: return launch_form<kY, In, uint8_t>(x, out, t, s, F, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool pow2_in(int v, int lo, int hi) { return v >= lo && v <= hi && (v & (v - 1)) == 0; }

template <bool kY>
int run_stage(const void* x, void* out, const void* d, const void* f, const void* start,
              const void* w, const void* inv_cov, const void* win, int F, const StageDims& s,
              int in_code, int out_code, void* stream) {
  const bool banded = s.form == kPreBand || s.form == kPostBand;
  // y: TL/4 <= 32 lanes per line group; x: TL/4 line groups of at least a
  // warp each, TU/4 threads per output row of an empty tile
  // TL = TU = 0: the direct form
  const bool tiles_ok = (s.TL == 0 && s.TU == 0) ||
                        (kY ? pow2_in(s.TL, kVec, 32 * kVec) && s.TU > 0
                            : pow2_in(s.TL, kVec, kVec * kThreads / 32) &&
                                  pow2_in(s.TU, kVec, kVec * kThreads));
  if (x == nullptr || out == nullptr || d == nullptr || f == nullptr || win == nullptr ||
      F <= 0 || s.n_lines <= 0 || s.n_in <= 0 || s.n_out <= 0 || s.n_t <= 0 || s.crop < 0 ||
      s.form < kTranslate || s.form > kPostBand ||
      (banded && (s.K <= 0 || start == nullptr || w == nullptr)) ||
      (s.form == kPreBand && (s.n_mid <= 0 || s.max_mid < 0)) ||
      (s.form != kPostBand && s.crop + s.n_out > s.n_t) ||
      !tiles_ok || s.max_win < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const StageTables t{static_cast<const int*>(d), static_cast<const float*>(f),
                      static_cast<const int*>(start), static_cast<const float*>(w),
                      static_cast<const float*>(inv_cov), static_cast<const int4*>(win)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (in_code) {
    case 0: return launch_out<kY, float>(out_code, x, out, t, s, F, st);
    case 1: return launch_out<kY, __nv_bfloat16>(out_code, x, out, t, s, F, st);
    case 2: return launch_out<kY, uint8_t>(out_code, x, out, t, s, F, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// win: the stage's tile windows (shear3.StageTiles.win, int32 (n_out tiles,
// n_lines tiles, 4)), for tiles of TL lines by TU output cells; max_win and
// max_mid their largest window and mid range.  TL = TU = 0 selects the
// direct form (win, max_win and max_mid unused).
extern "C" int aainterp_shear3_ystage(const void* x, void* out, const void* d, const void* f,
                                      const void* start, const void* w, const void* inv_cov,
                                      const void* win, int F, int n_lines, int n_in, int n_mid,
                                      int n_t, int crop, int n_out, int K, int form, int TL,
                                      int TU, int max_win, int max_mid, int in_code,
                                      int out_code, void* stream) {
  const StageDims s{n_lines, n_in, n_mid, n_t, crop, n_out, K, form, TL, TU, max_win, max_mid};
  return run_stage<true>(x, out, d, f, start, w, inv_cov, win, F, s, in_code, out_code, stream);
}

extern "C" int aainterp_shear3_xstage(const void* x, void* out, const void* d, const void* f,
                                      const void* start, const void* w, const void* inv_cov,
                                      const void* win, int F, int n_lines, int n_in, int n_mid,
                                      int n_t, int crop, int n_out, int K, int form, int TL,
                                      int TU, int max_win, int max_mid, int in_code,
                                      int out_code, void* stream) {
  const StageDims s{n_lines, n_in, n_mid, n_t, crop, n_out, K, form, TL, TU, max_win, max_mid};
  return run_stage<false>(x, out, d, f, start, w, inv_cov, win, F, s, in_code, out_code, stream);
}
