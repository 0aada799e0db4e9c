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
//   aainterp_contract_unmasked), the probes below, and, masked
//   (contract_kernel, aainterp_contract_direct), for a geometry whose
//   smallest tile window does not fit in shared memory: the host planner
//   sends such a plan there, a named and counted route.
//
// csrc/probes.cu launches the probe modes (contract_probe_kernel), the H100
// counterparts of the TPU contraction probes of
// benchmarks/rot_experiments.py.  Each probe is the direct form with one
// thing changed; like the TPU probes, the share and pipelined modes skip
// dead pixels and noweight does not:
//
//   kNoWeight  (_build_contract_noweight, :130)  out = sum_ab T window: no
//              weight load, no multiply (acc += v);
//   kWShare    (_build_contract_share, :247, wshare)  the weights of dst
//              row 0, w2[ab, 0, dx], for every row: the weight stream from
//              device memory (196 MB per batch at the 2048^2 / 30 degree
//              flagship) shrinks to one row that stays in L2;
//   kTShare    (the same, tshare)  T of frame 0 in dst row 0's window,
//              T[0, ry0[0]+a, cx0[dx]+b], for every row and frame: the T
//              reads from device memory go away.  The frame stride is a
//              runtime 0, so the compiler cannot fold the kFrames loads
//              into one;
//   kBothShare both of the above;
//   kPipelined (_build_contract_pipelined, :392)  the same function and
//              sum order as production, with tap k+1's T values and weight
//              loaded into registers before tap k's FMAs: bit-equal to
//              production, only the issue order differs.
//
// Why these are the H100 meanings: the TPU contraction gathered each dst
// tile's T block by one-hot MXU matmuls, and its share probes pinned "tile
// 0's T block" and "weight block 0" of that tiling, which the direct form
// does not have (a thread reads any address).  What carries over is what
// each probe removes: the weight multiply (noweight), the T traffic
// (tshare), the weight traffic (wshare), or the issue order (pipelined).
//
// What bounds the contraction: bytes (T, the f32 weight table w2 and the
// output); but the probes showed that the direct form's time follows the
// per-tap gathers' instruction stream, not those streams (PERF.md), which
// is what the tiled form's shared-memory windows take away.

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

// The body.  fstride is T's frame stride in elements: TH * TW, or 0 (a
// runtime value) for the T-sharing probes.
// kMasked: the dead-pixel skip on span (Hd, 2).
template <typename T, Probe P, bool kMasked>
__device__ __forceinline__ void body(
    const T* __restrict__ t, T* __restrict__ out,
    const int* __restrict__ ry0, const int* __restrict__ cx0,
    const float* __restrict__ w2, const int* __restrict__ span,
    int F, int TH, int TW, int Hd, int Wd, int Ka, int Kb, long long fstride) {
  constexpr bool kShareT = P == kTShare || P == kBothShare;
  constexpr bool kShareW = P == kWShare || P == kBothShare;
  const int dx = blockIdx.y * blockDim.x + threadIdx.x;
  if (dx >= Wd) return;
  const int dy = blockIdx.x;
  const long long plane = static_cast<long long>(Hd) * Wd;
  const long long pix = static_cast<long long>(dy) * Wd + dx;
  if constexpr (kMasked) {
    const int2 s = __ldg(reinterpret_cast<const int2*>(span) + dy);
    if (dx < s.x || dx >= s.y) {
      for (int f = 0; f < F; ++f) store(out + f * plane + pix, 0.0f);
      return;
    }
  }
  const long long wpix = kShareW ? static_cast<long long>(dx) : pix;
  const int r0 = ry0[kShareT ? 0 : dy];
  const int c0 = cx0[dx];
  for (int f0 = 0; f0 < F; f0 += kFrames) {
    const int nf = min(kFrames, F - f0);
    const T* tf = t + f0 * fstride;
    float acc[kFrames];
#pragma unroll
    for (int i = 0; i < kFrames; ++i) acc[i] = 0.0f;
    if constexpr (P == kPipelined) {
      // tap (a, b)'s operands in registers one tap ahead of its FMAs
      const int taps = Ka * Kb;
      int a = 0, b = 0;
      const T* trow = tf + static_cast<long long>(min(max(r0, 0), TH - 1)) * TW;
      float w = w2[wpix];
      T v[kFrames];
      {
        const int c = min(max(c0, 0), TW - 1);
#pragma unroll
        for (int i = 0; i < kFrames; ++i) v[i] = i < nf ? trow[i * fstride + c] : T(0.0f);
      }
      for (int k = 0; k < taps; ++k) {
        float wn = 0.0f;
        T vn[kFrames];
        if (++b == Kb) {
          b = 0;
          ++a;
          trow = tf + static_cast<long long>(min(max(r0 + a, 0), TH - 1)) * TW;
        }
        if (k + 1 < taps) {
          const int c = min(max(c0 + b, 0), TW - 1);
          wn = w2[static_cast<long long>(k + 1) * plane + wpix];
#pragma unroll
          for (int i = 0; i < kFrames; ++i) vn[i] = i < nf ? trow[i * fstride + c] : T(0.0f);
        } else {
#pragma unroll
          for (int i = 0; i < kFrames; ++i) vn[i] = T(0.0f);
        }
#pragma unroll
        for (int i = 0; i < kFrames; ++i) {
          if (i < nf) acc[i] = fmaf(w, to_f32(v[i]), acc[i]);
        }
        w = wn;
#pragma unroll
        for (int i = 0; i < kFrames; ++i) v[i] = vn[i];
      }
    } else {
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
            const float w = w2[static_cast<long long>(a * Kb + b) * plane + wpix];
#pragma unroll
            for (int i = 0; i < kFrames; ++i) {
              if (i < nf) acc[i] = fmaf(w, to_f32(trow[i * fstride + c]), acc[i]);
            }
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

// The production contraction, masked (ell_shear.cu's aainterp_contract).
template <typename T>
__global__ void __launch_bounds__(kThreads) contract_kernel(
    const T* __restrict__ t, T* __restrict__ out,
    const int* __restrict__ ry0, const int* __restrict__ cx0,
    const float* __restrict__ w2, const int* __restrict__ span,
    int F, int TH, int TW, int Hd, int Wd, int Ka, int Kb) {
  body<T, kNone, true>(t, out, ry0, cx0, w2, span, F, TH, TW, Hd, Wd, Ka, Kb,
                       static_cast<long long>(TH) * TW);
}

// The same without the skip (ell_shear.cu's aainterp_contract_unmasked).
template <typename T>
__global__ void __launch_bounds__(kThreads) contract_unmasked_kernel(
    const T* __restrict__ t, T* __restrict__ out,
    const int* __restrict__ ry0, const int* __restrict__ cx0,
    const float* __restrict__ w2,
    int F, int TH, int TW, int Hd, int Wd, int Ka, int Kb) {
  body<T, kNone, false>(t, out, ry0, cx0, w2, nullptr, F, TH, TW, Hd, Wd, Ka, Kb,
                        static_cast<long long>(TH) * TW);
}

// A probe (P != kNone), masked but for kNoWeight; zero is 0 at run time.
template <typename T, Probe P>
__global__ void __launch_bounds__(kThreads) contract_probe_kernel(
    const T* __restrict__ t, T* __restrict__ out,
    const int* __restrict__ ry0, const int* __restrict__ cx0,
    const float* __restrict__ w2, const int* __restrict__ span,
    int F, int TH, int TW, int Hd, int Wd, int Ka, int Kb, int zero) {
  constexpr bool kShareT = P == kTShare || P == kBothShare;
  body<T, P, P != kNoWeight>(
      t, out, ry0, cx0, w2, span, F, TH, TW, Hd, Wd, Ka, Kb,
      kShareT ? static_cast<long long>(zero) : static_cast<long long>(TH) * TW);
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

// The tiled masked contraction: block b is dst tile b (row-major, n_tx
// tiles a row of TYd x TXd pixels); tiles[b] = (r0, c0, rows, cols) is its
// window, rows == 0 for a dead tile.  vec: T's rows are 16-byte aligned,
// so a tile whose c0 and cols are whole chunks stages in 16-byte loads
// (the host starts every window at a multiple of 8 columns, COL_ALIGN).
// Dynamic shared memory: the largest window, rows * cols cells of
// kFrames * sizeof(T) bytes (the host's ContractTiles.smem).
template <typename T>
__global__ void __launch_bounds__(kThreads, kTiledMinBlocks) contract_tiled_kernel(
    const T* __restrict__ t, T* __restrict__ out, const int* __restrict__ ry0,
    const int* __restrict__ cx0, const float* __restrict__ w2, const int* __restrict__ span,
    const int4* __restrict__ tiles, int F, int TH, int TW, int Hd, int Wd, int Ka, int Kb,
    int TYd, int TXd, int n_tx, int vec) {
  extern __shared__ __align__(128) uint4 win[];
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
    const T* tf = t + f0 * fstride + static_cast<long long>(w.x) * TW + w.y;
    if (f0 > 0) __syncthreads();   // every sum of the last group has read the window
    if (chunked) {
      const int chunks = w.w / kVec;
      for (int it = threadIdx.x; it < w.z * chunks; it += kThreads) {
        const int r = it / chunks;
        const int k = it - r * chunks;
        stage_chunk(win, r * w.w + k * kVec, tf + static_cast<long long>(r) * TW + k * kVec,
                    fstride, nf);
      }
    } else {
      for (int it = threadIdx.x; it < w.z * w.w; it += kThreads) {
        const int r = it / w.w;
        const int c = it - r * w.w;
        stage_cell(win, it, tf + static_cast<long long>(r) * TW + c, fstride, nf);
      }
    }
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
      const int r0 = __ldg(ry0 + dy);
      const int c0 = __ldg(cx0 + dx);
      float acc[kFrames];
#pragma unroll
      for (int i = 0; i < kFrames; ++i) acc[i] = 0.0f;
      // taps k = a * Kb + b in order, their weights loaded kTapGroup at a
      // time: one tap's load at a time would leave the sums waiting on
      // device memory's latency at every tap
      const int taps = Ka * Kb;
      int b = 0;
      int row = (min(max(r0, 0), TH - 1) - w.x) * w.w;
      for (int k0 = 0, a = 0; k0 < taps; k0 += kTapGroup) {
        float wt[kTapGroup];
#pragma unroll
        for (int j = 0; j < kTapGroup; ++j) {
          wt[j] = k0 + j < taps ? w2[static_cast<long long>(k0 + j) * plane + pix] : 0.0f;
        }
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
      T* o = out + f0 * plane + pix;
#pragma unroll
      for (int i = 0; i < kFrames; ++i) {
        if (i < nf) store(o + i * plane, acc[i]);
      }
    }
  }
}

}  // namespace contract
