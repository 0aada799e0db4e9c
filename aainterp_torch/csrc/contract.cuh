// The exact rotated route's window contraction (TPU kernel 6,
// aainterp/ops/pallas_shear.py:164 _build_contract), in two designs.
//
//   out[f,dy,dx] = sum_{a<Ka, b<Kb} w2[a*Kb+b, dy, dx]
//                  * T[f, clamp(ry0[dy]+a, 0, TH-1), clamp(cx0[dx]+b, 0, TW-1)]
//
// with f32 accumulation (fmaf, taps a-major then b), the output in T's
// dtype.  Both designs give one thread one (dy, dx) at a time and loop over
// the frames inside, up to kFrames at a time with the sums in registers, so
// each weight tap is read from device memory once per kFrames frames; both
// have the same arithmetic in the same order, so their outputs are equal
// bit for bit.
//
// The dead-pixel skip (kMasked, the counterpart of the TPU kernel's
// masked=True, pallas_shear.py:164-240, tile_masks :307): span[dy] =
// (lo, hi) is the half-open range of dst columns of row dy whose Ka*Kb
// weights are not all 0 (host table, ops/cuda_shear.py; lo == hi for a row
// with none).  A pixel outside it gets 0 in its F outputs and reads
// neither T nor w2.  Inside the span every output is bit-equal to the
// unmasked sum for finite T (a dead pixel sums zero weights).  With NaN or
// Inf in T a pixel outside its row's span gives 0 where the unmasked sum
// can give NaN: the area average over no source area is 0.  The rotated
// flagship (2048^2 at 30 degrees) has 46 % of its dst pixels outside their
// spans.
//
// * The tiled form (contract_tiled_kernel, the route's masked contraction:
//   ell_shear.cu's aainterp_contract).  One block per dst tile of TYd x TXd
//   pixels.  A host table (ops/cuda_shear.contract_tiles) gives each tile's
//   T window (r0, c0, rows, cols): the rows and columns that the Ka x Kb
//   windows of its in-span pixels touch, and no others (rows and columns
//   outside the footprint carry ry0 = cx0 = 0, which would stretch a
//   window over the whole plane), with c0 a multiple of 8; rows == 0 marks
//   a dead tile, which writes its zeros and reads nothing.  A live tile
//   stages its window for up to kFrames frames at once into shared memory,
//   frame-interleaved ([row][col][frame]), so one tap is one 16-byte shared
//   read for 8 bf16 frames (two for f32) where the direct form makes
//   kFrames two- or four-byte global gathers, each T element fetched about
//   4.4 times by neighbouring pixels at the flagship.  The staging reads
//   each frame's row in 16-byte loads of 8 (bf16) or 4 (f32) columns, 4
//   frames at a time, and transposes them in registers; where T's rows are not all 16-byte
//   aligned (the base address, or a row pitch that is no multiple of 16
//   bytes) it reads a cell's frames one element each.  The 16-byte units
//   are XOR-swizzled within each 128-byte line (unit u at u ^ ((u >> 3) &
//   7)), so the staging's stores, 128 bytes a thread, do not all fall on
//   the same banks.  Frames beyond kFrames restage the window.  Several
//   blocks on an SM overlap one block's staging with another's sums.
// * The direct form (body(), the earlier design): one thread per (dy, dx),
//   each tap kFrames gathers from T in device memory through clamped
//   indices.  It stays for the unmasked instance (contract_unmasked_kernel,
//   aainterp_contract_unmasked), the noweight probe below, and, masked
//   (contract_kernel, aainterp_contract_direct), for a geometry whose
//   smallest tile window does not fit in shared memory: the host planner
//   sends such a plan there, a named and counted route.
//
// csrc/probes.cu launches the probe forms, the H100 counterparts of the
// TPU contraction probes of benchmarks/rot_experiments.py.  Like the TPU
// probes, each changes one thing in the production kernel it splits: the
// share and pipelined probes change the tiled form (the route's masked
// contraction: the same tile table, the same swizzled frame-interleaved
// windows, the same a-major sums) and, like it, write 0 and read nothing
// for dead tiles and for pixels outside their row's span; noweight
// changes the direct form, unmasked, as its yardstick
// contract_unmasked_kernel is:
//
//   kNoWeight  (_build_contract_noweight, :130)  out = sum_ab T window: no
//              weight load, no multiply (acc += v);
//   kTShare    (_build_contract_share, :247, tshare)  every live tile stages
//              frame 0's cells at T's origin, T[0, 0:rows, 0:cols], in its
//              own window's shape, into every frame slot of every frame
//              group, and sums that window as production sums its own: the
//              T stream from device memory shrinks to one corner that stays
//              in L2 (JAX's one T block fetched at step 0 for every (tile,
//              frame)).  The frame stride is a runtime 0, so the staging
//              keeps its loads, transposes and stores; the corner's anchor
//              (0, 0) keeps the window's 16-byte chunks aligned wherever
//              production's are;
//   kWShare    (the same, wshare)  every tile reads the weights of tile
//              wtile at the pixel's position within it (clamped to the dst
//              plane): the weight stream shrinks to one tile's Ka*Kb*TYd*TXd
//              floats (JAX's w2t block pinned to block 0).  The host passes
//              the first live tile: tile 0 is a dead corner, all of whose
//              weights are 0, and a probe whose output is all zeros checks
//              nothing;
//   kBothShare both of the above;
//   kPipelined (_build_contract_pipelined, :392)  production's function
//              and sum order, bit-equal to contract_tiled_kernel, with the
//              staging overlapped with the sums: a persistent grid (blocks
//              an SM from the occupancy of two windows), each block walking
//              the frame groups of its share of the live tiles (a host
//              order, the fullest tiles first, dealt in turn) through two
//              window buffers.  kStageThreads staging threads stage step
//              s + 1 into one buffer while kThreads summing threads sum
//              step s from the other; the summing threads write the dead
//              tiles' zeros first.
//              The frame-interleaved window is a
//              transpose, which a raw bulk copy cannot give, so the staging
//              threads stage through registers as production does.
//
// Why these are the H100 meanings: the TPU contraction gathered each dst
// tile's T block by one-hot MXU matmuls, and its probes pinned "tile 0's T
// block" and "weight block 0" of that tiling, or reordered the production
// kernel's issue; the tiled form has the same tiles, so each probe pins
// the same stream of it: the T windows (tshare), the weights (wshare),
// both, or the issue order (pipelined).
//
// What bounds the contraction: bytes (T, the f32 weight table w2 and the
// output); but the direct form's time followed the per-tap gathers'
// instruction stream, not those streams (PERF.md), which is what the
// tiled form's shared-memory windows take away.


#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace contract {

constexpr int kThreads = 256;
constexpr int kFrames = 8;
constexpr long long kMaxGridY = 65535;

enum Probe : int {
  kNone = 0,
  kNoWeight = 1,
  kTShare = 2,
  kWShare = 3,
  kBothShare = 4,
  kPipelined = 5,
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// one block per (dst row, kThreads columns); false if the grid does not fit
inline bool row_grid(long long rows, int cols, dim3* grid) {
  const long long ny = (cols + kThreads - 1) / kThreads;
  if (rows <= 0 || rows > 0x7fffffffLL || ny <= 0 || ny > kMaxGridY) return false;
  *grid = dim3(static_cast<unsigned>(rows), static_cast<unsigned>(ny));
  return true;
}

// The direct form's body: production (kNone) or the noweight probe.
// kMasked: the dead-pixel skip on span (Hd, 2).
template <typename T, Probe P, bool kMasked>
__device__ __forceinline__ void body(
    const T* __restrict__ t, T* __restrict__ out,
    const int* __restrict__ ry0, const int* __restrict__ cx0,
    const float* __restrict__ w2, const int* __restrict__ span,
    int F, int TH, int TW, int Hd, int Wd, int Ka, int Kb) {
  static_assert(P == kNone || P == kNoWeight, "the direct form's probe is noweight");
  const int dx = blockIdx.y * blockDim.x + threadIdx.x;
  if (dx >= Wd) return;
  const int dy = blockIdx.x;
  const long long plane = static_cast<long long>(Hd) * Wd;
  const long long pix = static_cast<long long>(dy) * Wd + dx;
  const long long fstride = static_cast<long long>(TH) * TW;
  if constexpr (kMasked) {
    const int2 s = __ldg(reinterpret_cast<const int2*>(span) + dy);
    if (dx < s.x || dx >= s.y) {
      for (int f = 0; f < F; ++f) store(out + f * plane + pix, 0.0f);
      return;
    }
  }
  const int r0 = ry0[dy];
  const int c0 = cx0[dx];
  for (int f0 = 0; f0 < F; f0 += kFrames) {
    const int nf = min(kFrames, F - f0);
    const T* tf = t + f0 * fstride;
    float acc[kFrames];
#pragma unroll
    for (int i = 0; i < kFrames; ++i) acc[i] = 0.0f;
    for (int a = 0; a < Ka; ++a) {
      const T* trow = tf + static_cast<long long>(min(max(r0 + a, 0), TH - 1)) * TW;
      for (int b = 0; b < Kb; ++b) {
        const int c = min(max(c0 + b, 0), TW - 1);
        if constexpr (P == kNoWeight) {
#pragma unroll
          for (int i = 0; i < kFrames; ++i) {
            if (i < nf) acc[i] += to_f32(trow[i * fstride + c]);
          }
        } else {
          const float w = w2[static_cast<long long>(a * Kb + b) * plane + pix];
#pragma unroll
          for (int i = 0; i < kFrames; ++i) {
            if (i < nf) acc[i] = fmaf(w, to_f32(trow[i * fstride + c]), acc[i]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kFrames; ++i) {
      if (i < nf) store(out + (f0 + i) * plane + pix, acc[i]);
    }
  }
}

// The production contraction's direct form, masked (ell_shear.cu's
// aainterp_contract_direct).
template <typename T>
__global__ void __launch_bounds__(kThreads) contract_kernel(
    const T* __restrict__ t, T* __restrict__ out,
    const int* __restrict__ ry0, const int* __restrict__ cx0,
    const float* __restrict__ w2, const int* __restrict__ span,
    int F, int TH, int TW, int Hd, int Wd, int Ka, int Kb) {
  body<T, kNone, true>(t, out, ry0, cx0, w2, span, F, TH, TW, Hd, Wd, Ka, Kb);
}

// The same without the skip (ell_shear.cu's aainterp_contract_unmasked).
template <typename T>
__global__ void __launch_bounds__(kThreads) contract_unmasked_kernel(
    const T* __restrict__ t, T* __restrict__ out,
    const int* __restrict__ ry0, const int* __restrict__ cx0,
    const float* __restrict__ w2,
    int F, int TH, int TW, int Hd, int Wd, int Ka, int Kb) {
  body<T, kNone, false>(t, out, ry0, cx0, w2, nullptr, F, TH, TW, Hd, Wd, Ka, Kb);
}

// The noweight probe: the unmasked direct form without weights.
template <typename T>
__global__ void __launch_bounds__(kThreads) contract_noweight_kernel(
    const T* __restrict__ t, T* __restrict__ out,
    const int* __restrict__ ry0, const int* __restrict__ cx0,
    int F, int TH, int TW, int Hd, int Wd, int Ka, int Kb) {
  body<T, kNoWeight, false>(t, out, ry0, cx0, nullptr, nullptr, F, TH, TW, Hd, Wd, Ka, Kb);
}

// ---- the tiled form --------------------------------------------------------

// weights the tiled form loads at once, ahead of their taps' sums, and
// the blocks an SM its registers are sized for (40 a thread: at its first
// 80 the card held 2 blocks an SM, and the sums waited on device memory)
constexpr int kTapGroup = 16;
constexpr int kTiledMinBlocks = 6;

// the 16-byte unit u of a window, XOR-swizzled within its 128-byte line
__device__ __forceinline__ int swz(int u) { return u ^ ((u >> 3) & 7); }

// 16-byte units of a cell of kFrames frames: 1 (bf16) or 2 (f32)
// the cell's kFrames values as f32 (exact: bf16 -> f32 is a shift)
template <typename T>
__device__ __forceinline__ void load_cell(const uint4* win, int cell, float (&v)[kFrames]) {
  if constexpr (sizeof(T) == 2) {
    const uint4 u = win[swz(cell)];
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      v[2 * m] = __uint_as_float(w[m] << 16);
      v[2 * m + 1] = __uint_as_float(w[m] & 0xffff0000u);
    }
  } else {
    const uint4 lo = win[swz(2 * cell)];
    const uint4 hi = win[swz(2 * cell + 1)];
    const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int i = 0; i < kFrames; ++i) v[i] = __uint_as_float(w[i]);
  }
}

// Stage window row r, 16-byte chunk k (kVec columns) of the nf frames at
// src (frame stride fstride elements) as kVec cells from cell `cell`, in
// two halves of 4 frames (fewer registers than 8 loads at once): 4 16-byte
// loads, a transpose in registers, 8 bytes of each cell stored (frames past
// nf are 0).
__device__ __forceinline__ void stage_chunk(uint4* win, int cell, const __nv_bfloat16* src,
                                            long long fstride, int nf) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t v[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint4 u = make_uint4(0, 0, 0, 0);
      if (4 * h + i < nf) u = __ldg(reinterpret_cast<const uint4*>(src + (4 * h + i) * fstride));
      v[i][0] = u.x;
      v[i][1] = u.y;
      v[i][2] = u.z;
      v[i][3] = u.w;
    }
    // column j of the chunk: word m of its cell holds frames 2m (low half)
    // and 2m + 1 (high half); this half writes words 2h and 2h + 1
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const unsigned sel = (j & 1) ? 0x7632u : 0x5410u;
      reinterpret_cast<uint2*>(win + swz(cell + j))[h] =
          make_uint2(__byte_perm(v[0][j / 2], v[1][j / 2], sel),
                     __byte_perm(v[2][j / 2], v[3][j / 2], sel));
    }
  }
}
__device__ __forceinline__ void stage_chunk(uint4* win, int cell, const float* src,
                                            long long fstride, int nf) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t v[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint4 u = make_uint4(0, 0, 0, 0);
      if (4 * h + i < nf) u = __ldg(reinterpret_cast<const uint4*>(src + (4 * h + i) * fstride));
      v[i][0] = u.x;
      v[i][1] = u.y;
      v[i][2] = u.z;
      v[i][3] = u.w;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      win[swz(2 * (cell + j) + h)] = make_uint4(v[0][j], v[1][j], v[2][j], v[3][j]);
    }
  }
}

// one cell, its nf frames read one element each (rows not 16-byte aligned)
__device__ __forceinline__ void stage_cell(uint4* win, int cell, const __nv_bfloat16* src,
                                           long long fstride, int nf) {
  const uint16_t* s = reinterpret_cast<const uint16_t*>(src);
  uint32_t h[kFrames];
#pragma unroll
  for (int i = 0; i < kFrames; ++i) h[i] = i < nf ? s[i * fstride] : 0u;
  win[swz(cell)] = make_uint4(h[0] | (h[1] << 16), h[2] | (h[3] << 16), h[4] | (h[5] << 16),
                              h[6] | (h[7] << 16));
}
__device__ __forceinline__ void stage_cell(uint4* win, int cell, const float* src,
                                           long long fstride, int nf) {
  const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
  uint32_t h[kFrames];
#pragma unroll
  for (int i = 0; i < kFrames; ++i) h[i] = i < nf ? s[i * fstride] : 0u;
  win[swz(2 * cell)] = make_uint4(h[0], h[1], h[2], h[3]);
  win[swz(2 * cell + 1)] = make_uint4(h[4], h[5], h[6], h[7]);
}

// Stage nf frames of window w = (r0, c0, rows, cols) into win, by thread
// tid of nthreads: src is the window's first element in its first frame,
// fstride the frame stride in elements (a runtime 0 under tshare: every
// frame slot gets the first frame's value); whole 16-byte chunks where
// `chunked`, else a cell at a time.
template <typename T>
__device__ __forceinline__ void stage_window(uint4* win, const T* src, int4 w, int TW,
                                             long long fstride, int nf, bool chunked, int tid,
                                             int nthreads) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  if (chunked) {
    const int chunks = w.w / kVec;
    for (int it = tid; it < w.z * chunks; it += nthreads) {
      const int r = it / chunks;
      const int k = it - r * chunks;
      stage_chunk(win, r * w.w + k * kVec, src + static_cast<long long>(r) * TW + k * kVec,
                  fstride, nf);
    }
  } else {
    for (int it = tid; it < w.z * w.w; it += nthreads) {
      const int r = it / w.w;
      const int c = it - r * w.w;
      stage_cell(win, it, src + static_cast<long long>(r) * TW + c, fstride, nf);
    }
  }
}

// the first weights of taps k0 .. k0 + kTapGroup - 1 at wpix (0 past the
// last tap)
__device__ __forceinline__ void load_weights(float (&wt)[kTapGroup], const float* __restrict__ w2,
                                             long long plane, long long wpix, int k0, int taps) {
#pragma unroll
  for (int j = 0; j < kTapGroup; ++j) {
    wt[j] = k0 + j < taps ? w2[static_cast<long long>(k0 + j) * plane + wpix] : 0.0f;
  }
}

// One in-span pixel's sums over its Ka x Kb taps in the staged window win
// of tile window w: taps k = a * Kb + b in order, their weights (tap k at
// w2[k * plane + wpix]) loaded kTapGroup at a time, since one tap's load
// at a time would leave the sums waiting on device memory's latency at
// every tap.
template <typename T>
__device__ __forceinline__ void sum_taps(const uint4* win, int4 w, const float* __restrict__ w2,
                                         long long plane, long long wpix, int r0, int c0, int TH,
                                         int TW, int Ka, int Kb, int nf, float (&acc)[kFrames]) {
#pragma unroll
  for (int i = 0; i < kFrames; ++i) acc[i] = 0.0f;
  float wt[kTapGroup];
  const int taps = Ka * Kb;
  int b = 0;
  int row = (min(max(r0, 0), TH - 1) - w.x) * w.w;
  for (int k0 = 0, a = 0; k0 < taps; k0 += kTapGroup) {
    load_weights(wt, w2, plane, wpix, k0, taps);
#pragma unroll
    for (int j = 0; j < kTapGroup; ++j) {
      if (k0 + j < taps) {
        float v[kFrames];
        load_cell<T>(win, row + min(max(c0 + b, 0), TW - 1) - w.y, v);
#pragma unroll
        for (int i = 0; i < kFrames; ++i) {
          if (i < nf) acc[i] = fmaf(wt[j], v[i], acc[i]);
        }
        if (++b == Kb) {
          b = 0;
          row = (min(max(r0 + ++a, 0), TH - 1) - w.x) * w.w;
        }
      }
    }
  }
}

// The tiled masked contraction's body (P == kNone) and its share probes
// (kTShare, kWShare, kBothShare): block b is dst tile b (row-major, n_tx
// tiles a row of TYd x TXd pixels); tiles[b] = (r0, c0, rows, cols) is its
// window, rows == 0 for a dead tile.  vec: T's rows are 16-byte aligned,
// so a tile whose c0 and cols are whole chunks stages in 16-byte loads
// (the host starts every window at a multiple of 8 columns, COL_ALIGN).
// win: dynamic shared memory for the largest window, rows * cols cells of
// kFrames * sizeof(T) bytes (the host's ContractTiles.smem).  wtile: the
// tile whose weights wshare reads; zero: 0 at run time, T's frame stride
// under tshare.
template <typename T, Probe P>
__device__ __forceinline__ void tiled_body(
    uint4* win, const T* __restrict__ t, T* __restrict__ out, const int* __restrict__ ry0,
    const int* __restrict__ cx0, const float* __restrict__ w2, const int* __restrict__ span,
    const int4* __restrict__ tiles, int F, int TH, int TW, int Hd, int Wd, int Ka, int Kb,
    int TYd, int TXd, int n_tx, int vec, int wtile, int zero) {
  static_assert(P == kNone || P == kTShare || P == kWShare || P == kBothShare,
                "the tiled body's probes are the shares");
  constexpr bool kShareT = P == kTShare || P == kBothShare;
  constexpr bool kShareW = P == kWShare || P == kBothShare;
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  const int ty = blockIdx.x / n_tx;
  const int y0 = ty * TYd;
  const int x0 = (blockIdx.x - ty * n_tx) * TXd;
  const int4 w = __ldg(tiles + blockIdx.x);
  const long long plane = static_cast<long long>(Hd) * Wd;
  const long long fstride = static_cast<long long>(TH) * TW;
  const int npix = TYd * TXd;
  if (w.z == 0) {                  // a dead tile: zeros, nothing read
    for (int p = threadIdx.x; p < npix; p += kThreads) {
      const int py = p / TXd;
      const int dy = y0 + py;
      const int dx = x0 + p - py * TXd;
      if (dy >= Hd || dx >= Wd) continue;
      const long long pix = static_cast<long long>(dy) * Wd + dx;
      for (int f = 0; f < F; ++f) store(out + f * plane + pix, 0.0f);
    }
    return;
  }
  const bool chunked = vec && w.y % kVec == 0 && w.w % kVec == 0;
  for (int f0 = 0; f0 < F; f0 += kFrames) {
    const int nf = min(kFrames, F - f0);
    // the window's first element in frame f0 (tshare: frame 0's corner)
    const T* tf = kShareT ? t : t + f0 * fstride + static_cast<long long>(w.x) * TW + w.y;
    if (f0 > 0) __syncthreads();   // every sum of the last group has read the window
    stage_window(win, tf, w, TW, kShareT ? static_cast<long long>(zero) : fstride, nf, chunked,
                 threadIdx.x, kThreads);
    __syncthreads();
    for (int p = threadIdx.x; p < npix; p += kThreads) {
      const int py = p / TXd;
      const int dy = y0 + py;
      const int dx = x0 + p - py * TXd;
      if (dy >= Hd || dx >= Wd) continue;
      const long long pix = static_cast<long long>(dy) * Wd + dx;
      const int2 s = __ldg(reinterpret_cast<const int2*>(span) + dy);
      if (dx < s.x || dx >= s.y) {
        for (int i = 0; i < nf; ++i) store(out + (f0 + i) * plane + pix, 0.0f);
        continue;
      }
      long long wpix = pix;
      if constexpr (kShareW) {
        const int wy = wtile / n_tx;
        wpix = static_cast<long long>(min(wy * TYd + py, Hd - 1)) * Wd +
               min((wtile - wy * n_tx) * TXd + p - py * TXd, Wd - 1);
      }
      float acc[kFrames];
      sum_taps<T>(win, w, w2, plane, wpix, __ldg(ry0 + dy), __ldg(cx0 + dx), TH, TW, Ka, Kb, nf,
                  acc);
      T* o = out + f0 * plane + pix;
#pragma unroll
      for (int i = 0; i < kFrames; ++i) {
        if (i < nf) store(o + i * plane, acc[i]);
      }
    }
  }
}

// The route's masked contraction, tiled (ell_shear.cu's aainterp_contract).
template <typename T>
__global__ void __launch_bounds__(kThreads, kTiledMinBlocks) contract_tiled_kernel(
    const T* __restrict__ t, T* __restrict__ out, const int* __restrict__ ry0,
    const int* __restrict__ cx0, const float* __restrict__ w2, const int* __restrict__ span,
    const int4* __restrict__ tiles, int F, int TH, int TW, int Hd, int Wd, int Ka, int Kb,
    int TYd, int TXd, int n_tx, int vec) {
  extern __shared__ __align__(128) uint4 win[];
  tiled_body<T, kNone>(win, t, out, ry0, cx0, w2, span, tiles, F, TH, TW, Hd, Wd, Ka, Kb, TYd,
                       TXd, n_tx, vec, 0, 0);
}

// A share probe (P: kTShare, kWShare or kBothShare) on the tiled form.
template <typename T, Probe P>
__global__ void __launch_bounds__(kThreads, kTiledMinBlocks) contract_share_kernel(
    const T* __restrict__ t, T* __restrict__ out, const int* __restrict__ ry0,
    const int* __restrict__ cx0, const float* __restrict__ w2, const int* __restrict__ span,
    const int4* __restrict__ tiles, int F, int TH, int TW, int Hd, int Wd, int Ka, int Kb,
    int TYd, int TXd, int n_tx, int vec, int wtile, int zero) {
  extern __shared__ __align__(128) uint4 win[];
  tiled_body<T, P>(win, t, out, ry0, cx0, w2, span, tiles, F, TH, TW, Hd, Wd, Ka, Kb, TYd, TXd,
                   n_tx, vec, wtile, zero);
}

// ---- the pipelined probe ---------------------------------------------------

// the pipelined form's staging threads (the warps after the kThreads
// summing threads) and the blocks an SM its registers are sized for (56 a
// thread: at 40, 4 blocks an SM, it spilled over 300 bytes a thread and
// was slower; chip_sweep.py variants pipe*, PERF.md)
constexpr int kStageThreads = 128;
constexpr int kPipeMinBlocks = 3;

// Summing thread p's dst pixel (dy, dx) in tile `tile`: false if p lies
// past the tile or its pixel off the plane.
__device__ __forceinline__ bool tile_pixel(int tile, int p, int n_tx, int TYd, int TXd, int Hd,
                                           int Wd, int& dy, int& dx) {
  if (p >= TYd * TXd) return false;
  const int ty = tile / n_tx;
  const int py = p / TXd;
  dy = ty * TYd + py;
  dx = (tile - ty * n_tx) * TXd + p - py * TXd;
  return dy < Hd && dx < Wd;
}

// The pipelined probe: the tiled form's function (the host checks TYd *
// TXd <= kThreads, a pixel a summing thread) on a persistent grid.
// order: the tiles, the n_live live ones first (the host puts those with
// the most in-span pixels first, so that the blocks' shares of the sums
// come out even), then the dead ones.  Block b takes live tiles order[b],
// order[b + gridDim.x], ...; its steps are their frame groups in turn.
// Step s + 1 is staged into buffer (s + 1) & 1 (buf_units 16-byte units
// each, 128-byte aligned) while step s is summed from buffer s & 1.  The
// summing threads write the zeros of dead tiles order[n_live + b], ...
// while step 0 is staged.
template <typename T>
__global__ void __launch_bounds__(kThreads + kStageThreads, kPipeMinBlocks)
    contract_pipelined_kernel(const T* __restrict__ t, T* __restrict__ out,
                              const int* __restrict__ ry0, const int* __restrict__ cx0,
                              const float* __restrict__ w2, const int* __restrict__ span,
                              const int4* __restrict__ tiles, const int* __restrict__ order,
                              int F, int TH, int TW, int Hd, int Wd, int Ka, int Kb, int TYd,
                              int TXd, int n_tx, int vec, int n_tiles, int n_live,
                              int buf_units) {
  extern __shared__ __align__(128) uint4 bufs[];
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  const int grid = gridDim.x;
  const long long plane = static_cast<long long>(Hd) * Wd;
  const long long fstride = static_cast<long long>(TH) * TW;
  const bool stager = threadIdx.x >= kThreads;
  const int p = threadIdx.x;
  // step s: live tile order[i], frames from f0
  int i = blockIdx.x;
  int f0 = 0;
  int tile = i < n_live ? __ldg(order + i) : 0;
  int4 w = i < n_live ? __ldg(tiles + tile) : make_int4(0, 0, 0, 0);
  if (stager) {
    if (i < n_live) {
      stage_window(bufs, t + static_cast<long long>(w.x) * TW + w.y, w, TW, fstride,
                   min(kFrames, F), vec && w.y % kVec == 0 && w.w % kVec == 0, p - kThreads,
                   kStageThreads);
    }
  } else {
    int dy, dx;
    for (int k = n_live + blockIdx.x; k < n_tiles; k += grid) {
      if (!tile_pixel(__ldg(order + k), p, n_tx, TYd, TXd, Hd, Wd, dy, dx)) continue;
      const long long pix = static_cast<long long>(dy) * Wd + dx;
      for (int f = 0; f < F; ++f) store(out + f * plane + pix, 0.0f);
    }
  }
  __syncthreads();
  for (int s = 0; i < n_live; ++s) {
    int i_n = i, f0_n = f0 + kFrames;
    if (f0_n >= F) {
      f0_n = 0;
      i_n += grid;
    }
    const bool more = i_n < n_live;
    const int tile_n = more ? __ldg(order + i_n) : 0;
    const int4 w_n = more ? __ldg(tiles + tile_n) : make_int4(0, 0, 0, 0);
    if (stager) {
      if (more) {
        stage_window(bufs + ((s + 1) & 1) * buf_units,
                     t + f0_n * fstride + static_cast<long long>(w_n.x) * TW + w_n.y, w_n, TW,
                     fstride, min(kFrames, F - f0_n),
                     vec && w_n.y % kVec == 0 && w_n.w % kVec == 0, p - kThreads,
                     kStageThreads);
      }
    } else {
      int dy, dx;
      if (tile_pixel(tile, p, n_tx, TYd, TXd, Hd, Wd, dy, dx)) {
        const int nf = min(kFrames, F - f0);
        const long long pix = static_cast<long long>(dy) * Wd + dx;
        T* o = out + f0 * plane + pix;
        const int2 sp = __ldg(reinterpret_cast<const int2*>(span) + dy);
        if (dx < sp.x || dx >= sp.y) {
          for (int k = 0; k < nf; ++k) store(o + k * plane, 0.0f);
        } else {
          float acc[kFrames];
          sum_taps<T>(bufs + (s & 1) * buf_units, w, w2, plane, pix, __ldg(ry0 + dy),
                      __ldg(cx0 + dx), TH, TW, Ka, Kb, nf, acc);
#pragma unroll
          for (int k = 0; k < kFrames; ++k) {
            if (k < nf) store(o + k * plane, acc[k]);
          }
        }
      }
    }
    i = i_n;
    tile = tile_n;
    f0 = f0_n;
    w = w_n;
    __syncthreads();   // step s + 1 staged; every sum of step s has read its buffer
  }
}

}  // namespace contract
