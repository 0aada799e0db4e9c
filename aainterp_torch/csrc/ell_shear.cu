// Exact rotated (ELL) apply for Hopper (sm_90a): two integer shears and a
// window contraction.
//
// Replaces the three TPU Pallas kernels of aainterp/ops/pallas_shear.py:
//
//   aainterp_vshear   <- _build_vshear   (:59, pallas_call at :100)
//   aainterp_hshear   <- _build_hshear   (:114, pallas_call at :150)
//   aainterp_contract <- _build_contract (:164, pallas_call at :291)
//
// With the host plan of ops/shear_apply.build_shear_plan (gy, hx, ry0, cx0
// and the re-indexed weights w2, laid out by ops/cuda_shear.py) they
// compute, per frame f,
//
//   S[f,y,x]     = q[f, y - gy[x], x]     or 0 when y - gy[x] is outside [0, qH)
//   T[f,y,x]     = S[f, y, x - hx[y]]     or 0 when x - hx[y] is outside [0, qW)
//   out[f,dy,dx] = sum_{a<Ka, b<Kb} w2[a*Kb+b, dy, dx]
//                  * T[f, clamp(ry0[dy]+a, 0, TH-1), clamp(cx0[dx]+b, 0, TW-1)]
//
// with f32 accumulation (fmaf, taps a-major then b), as the plain torch
// versions in ops/cuda_shear.py do.
//
// What the TPU kernels did that is not carried over: Mosaic rotates 32-bit
// values only and the TPU has no gather, so the Pallas shears are log2
// passes of static rolls plus selects, the contraction gathers through
// one-hot MXU matmuls, and every table is padded to 8/16/128-aligned
// widths.  A GPU thread reads any address, so here each output element is
// one indexed load.
//
// What bounds them: bytes.  The shears are pure data movement (read q or S,
// write S or T, element type moved as raw 16- or 32-bit words, so they are
// bit-exact).  The contraction does Ka*Kb FMAs per output pixel and frame
// (25 at the 2048^2/30 degree flagship) against the largest stream of the
// route, the f32 weight table w2 (Ka*Kb*Hd*Wd*4 bytes, 196 MB at the
// flagship against 31 MB of bf16 output for 8 frames).  So:
//
//   * the shears give one thread to one output element: a block covers
//     kThreads neighbouring columns of one row, so writes are coalesced and
//     reads nearly so (gy varies slowly along a row; S rows are read
//     contiguously);
//   * BOTH shears write EVERY element of their output, zeros included, so
//     a contraction tap whose weight is 0 never meets an uninitialised
//     value (NaN * 0 = NaN);
//   * the contraction gives one thread to one (dy, dx) and loops over the
//     frames inside, up to kFrames at a time with the sums in registers, so
//     each weight tap is read from device memory once per kFrames frames
//     (once per batch at the flagship's 8), not once per frame — the
//     reason the TPU grid runs frames innermost (pallas_shear.py:197-199).
//     Weights are tap-major, so neighbouring threads read neighbouring
//     words; T rows shared by neighbouring dst rows come from L2.
//
// The S and T planes cost a write and a read each (8 * (13.2 + 22.3) MB per
// batch at the flagship).  Reading q once through
// T[y,x] = q[y - gy[x-hx[y]], x - hx[y]] inside the contraction would save
// them; that fused design is a later change (ROADMAP.md).
//
// Plain C interface for ctypes; each launch goes on the caller's stream and
// does not synchronise.  The return value is cudaGetLastError() after the
// launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFrames = 8;
constexpr long long kMaxGridY = 65535;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// S[f, y, x] = q[f, y - gy[x], x], zero outside; one thread per element.
// blockIdx.x = f * TH + y, blockIdx.y * blockDim.x + threadIdx.x = x.
template <typename W>
__global__ void __launch_bounds__(kThreads) vshear_kernel(
    const W* __restrict__ q, W* __restrict__ s, const int* __restrict__ gy,
    int qH, int qW, int TH) {
  const int x = blockIdx.y * blockDim.x + threadIdx.x;
  if (x >= qW) return;
  const long long row = blockIdx.x;
  const long long f = row / TH;
  const int r = static_cast<int>(row - f * TH) - gy[x];
  s[row * qW + x] = (r >= 0 && r < qH) ? q[(f * qH + r) * qW + x] : W(0);
}

// T[f, y, x] = S[f, y, x - hx[y]], zero outside; one thread per element.
template <typename W>
__global__ void __launch_bounds__(kThreads) hshear_kernel(
    const W* __restrict__ s, W* __restrict__ t, const int* __restrict__ hx,
    int TH, int qW, int TW) {
  const int x = blockIdx.y * blockDim.x + threadIdx.x;
  if (x >= TW) return;
  const long long row = blockIdx.x;
  const int c = x - hx[row % TH];
  t[row * TW + x] = (c >= 0 && c < qW) ? s[row * qW + c] : W(0);
}

// out[f, dy, dx] = sum_ab w2[a*Kb+b, dy, dx] * T[f, ry0[dy]+a, cx0[dx]+b];
// one thread per (dy, dx), frames looped inside, kFrames sums in registers.
template <typename T>
__global__ void __launch_bounds__(kThreads) contract_kernel(
    const T* __restrict__ t, T* __restrict__ out,
    const int* __restrict__ ry0, const int* __restrict__ cx0,
    const float* __restrict__ w2,
    int F, int TH, int TW, int Hd, int Wd, int Ka, int Kb) {
  const int dx = blockIdx.y * blockDim.x + threadIdx.x;
  if (dx >= Wd) return;
  const int dy = blockIdx.x;
  const long long plane = static_cast<long long>(Hd) * Wd;
  const long long tplane = static_cast<long long>(TH) * TW;
  const long long pix = static_cast<long long>(dy) * Wd + dx;
  const int r0 = ry0[dy];
  const int c0 = cx0[dx];
  for (int f0 = 0; f0 < F; f0 += kFrames) {
    const int nf = min(kFrames, F - f0);
    const T* tf = t + f0 * tplane;
    float acc[kFrames];
#pragma unroll
    for (int i = 0; i < kFrames; ++i) acc[i] = 0.0f;
    for (int a = 0; a < Ka; ++a) {
      const T* trow = tf + static_cast<long long>(min(max(r0 + a, 0), TH - 1)) * TW;
      for (int b = 0; b < Kb; ++b) {
        const int c = min(max(c0 + b, 0), TW - 1);
        const float w = w2[static_cast<long long>(a * Kb + b) * plane + pix];
#pragma unroll
        for (int i = 0; i < kFrames; ++i) {
          if (i < nf) acc[i] = fmaf(w, to_f32(trow[i * tplane + c]), acc[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kFrames; ++i) {
      if (i < nf) store(out + (f0 + i) * plane + pix, acc[i]);
    }
  }
}

// one block per (row, kThreads columns); false if the grid does not fit
bool row_grid(long long rows, int cols, dim3* grid) {
  const long long ny = (cols + kThreads - 1) / kThreads;
  if (rows <= 0 || rows > 0x7fffffffLL || ny <= 0 || ny > kMaxGridY) return false;
  *grid = dim3(static_cast<unsigned>(rows), static_cast<unsigned>(ny));
  return true;
}

}  // namespace

// elem_bytes: 2 (bf16) or 4 (f32); the shears move raw words
extern "C" int aainterp_vshear(const void* q, void* s, const void* gy,
                               int F, int qH, int qW, int TH, int elem_bytes,
                               void* stream) {
  dim3 grid;
  if (F <= 0 || qH <= 0 || qW <= 0 || TH < qH ||
      !row_grid(static_cast<long long>(F) * TH, qW, &grid)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* g = static_cast<const int*>(gy);
  if (elem_bytes == 2) {
    vshear_kernel<uint16_t><<<grid, kThreads, 0, st>>>(
        static_cast<const uint16_t*>(q), static_cast<uint16_t*>(s), g, qH, qW, TH);
  } else if (elem_bytes == 4) {
    vshear_kernel<uint32_t><<<grid, kThreads, 0, st>>>(
        static_cast<const uint32_t*>(q), static_cast<uint32_t*>(s), g, qH, qW, TH);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int aainterp_hshear(const void* s, void* t, const void* hx,
                               int F, int TH, int qW, int TW, int elem_bytes,
                               void* stream) {
  dim3 grid;
  if (F <= 0 || TH <= 0 || qW <= 0 || TW < qW ||
      !row_grid(static_cast<long long>(F) * TH, TW, &grid)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* h = static_cast<const int*>(hx);
  if (elem_bytes == 2) {
    hshear_kernel<uint16_t><<<grid, kThreads, 0, st>>>(
        static_cast<const uint16_t*>(s), static_cast<uint16_t*>(t), h, TH, qW, TW);
  } else if (elem_bytes == 4) {
    hshear_kernel<uint32_t><<<grid, kThreads, 0, st>>>(
        static_cast<const uint32_t*>(s), static_cast<uint32_t*>(t), h, TH, qW, TW);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// dtype_code: 0 = float32, 1 = bfloat16 (T and out share it)
extern "C" int aainterp_contract(const void* t, void* out, const void* ry0,
                                 const void* cx0, const void* w2,
                                 int F, int TH, int TW, int Hd, int Wd,
                                 int Ka, int Kb, int dtype_code, void* stream) {
  dim3 grid;
  if (F <= 0 || TH <= 0 || TW <= 0 || Ka <= 0 || Kb <= 0 ||
      !row_grid(Hd, Wd, &grid)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* r = static_cast<const int*>(ry0);
  const int* c = static_cast<const int*>(cx0);
  const float* w = static_cast<const float*>(w2);
  if (dtype_code == 0) {
    contract_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(t), static_cast<float*>(out), r, c, w,
        F, TH, TW, Hd, Wd, Ka, Kb);
  } else if (dtype_code == 1) {
    contract_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(t), static_cast<__nv_bfloat16*>(out), r, c, w,
        F, TH, TW, Hd, Wd, Ka, Kb);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
