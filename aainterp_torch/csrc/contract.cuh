// The exact rotated route's window contraction (TPU kernel 6,
// aainterp/ops/pallas_shear.py:164 _build_contract), as one body under a
// compile-time probe mode.
//
//   out[f,dy,dx] = sum_{a<Ka, b<Kb} w2[a*Kb+b, dy, dx]
//                  * T[f, clamp(ry0[dy]+a, 0, TH-1), clamp(cx0[dx]+b, 0, TW-1)]
//
// with f32 accumulation (fmaf, taps a-major then b).  One thread per
// (dy, dx), frames looped inside, up to kFrames at a time with the sums in
// registers, so each weight tap is read from device memory once per
// kFrames frames.
//
// The dead-pixel skip (kMasked, the counterpart of the TPU kernel's
// masked=True, pallas_shear.py:164-240, tile_masks :307): span[dy] =
// (lo, hi) is the half-open range of dst columns of row dy whose Ka*Kb
// weights are not all 0 (host table, ops/cuda_shear.py; lo == hi for a row
// with none).  A thread whose dx lies outside it writes 0 to its F outputs
// and reads neither T nor w2; a block wholly outside does only that.
// Inside the span the arithmetic and the sum order are the unmasked
// kernel's, so every output is bit-equal to it for finite T (a dead pixel
// sums zero weights).  With NaN or Inf in T a pixel outside its row's span
// gives 0 where the unmasked kernel can give NaN: the area average over no
// source area is 0.  The rotated flagship (2048^2 at 30 degrees) has 46 %
// of its dst pixels outside their spans.
//
// csrc/ell_shear.cu launches the production form (contract_kernel: Probe
// kNone, masked) and the unmasked instance (contract_unmasked_kernel);
// csrc/probes.cu launches the others (contract_probe_kernel), the H100
// counterparts of the TPU contraction probes of
// benchmarks/rot_experiments.py.  Each probe is the production kernel with
// one thing changed, so a later redesign of this body carries the probes
// with it; like the TPU probes, the share and pipelined modes skip dead
// pixels and noweight does not:
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
// 0's T block" and "weight block 0" of that tiling, which the port does not
// have (a thread reads any address).  What carries over is what each probe
// removes: the weight multiply (noweight), the T traffic (tshare), the
// weight traffic (wshare), or the issue order (pipelined).
//
// What bounds the contraction: bytes (T, the f32 weight table w2 and the
// output); but the probes show that its time follows the per-tap gathers'
// instruction stream, not those streams (PERF.md), so the skipped pixels'
// work is time.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

}  // namespace contract
