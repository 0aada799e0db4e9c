// Separable banded area-average apply for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel aainterp/ops/pallas_apply.py
// ::_build_separable_kernel (pallas_call at :438).  It computes, per frame f,
//
//   out[f,i,j] = sum_a sum_b wy[i,a] * wx[j,b]
//                * src[f, clamp(ys[i]+a, 0, H-1), clamp(xs[j]+b, 0, W-1)]
//
// with f32 accumulation.  Out-of-range taps are clamped, as the plain
// version (ops/apply.py) and jnp.take do; they carry zero weight.
//
// What bounds it: bytes, not FLOPs.  At the 4K->1080p flagship a frame moves
// 16.6 MB in and 4.1 MB out (bf16) for about 8 FMAs per output pixel, far
// below the H100's operations-per-byte ridge.  So there are no tensor cores
// here (the TPU kernel's densified MXU blocks and 128-lane alignment exist
// for the TPU's matrix unit) and the design aims to read each source pixel
// from device memory about once:
//
//   * one block per (frame, TY dst rows, TX dst cols); the host planner
//     (ops/cuda_apply.py) gives each column tile its first source column c0
//     and the common span S = max(xs) + kx - c0 over the tiles;
//   * y-pass: T[r, c] = sum_a wy[i,a] * src[ys[i]+a, c0+c] for the tile's
//     TY rows over the span, kept in shared memory as f32.  Neighbouring
//     threads read neighbouring source columns (coalesced); the rows that
//     overlapping dst rows share are re-read from L1/L2, not device memory;
//   * x-pass: after __syncthreads, out[r, j] = sum_b wx[j,b] * T[r, xs[j]+b-c0]
//     from shared memory, with neighbouring threads writing neighbouring
//     output columns.
//
// The planner halves TX (then TY) until TY*S*4 bytes of shared memory fit,
// so every shape runs: odd widths, bands wider than the image, heavy
// downscales.  ky and kx are runtime ints.  Output: f32, bf16 (round to
// nearest even via __float2bfloat16_rn) or u8 (rintf = round half to even,
// then saturate to [0, 255], as jnp.round/clip do at pallas_apply.py:250-256).
//
// Plain C interface for ctypes; the launch goes on the caller's stream and
// does not synchronise.  The return value is cudaGetLastError() after the
// launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(uint8_t v) { return static_cast<float>(v); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store(uint8_t* p, float v) {
  // round half to even, then saturate (NaN saturates to 0)
  const float r = fminf(fmaxf(rintf(v), 0.0f), 255.0f);
  *p = static_cast<uint8_t>(r);
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads) separable_apply_kernel(
    const Tin* __restrict__ src, Tout* __restrict__ out,
    const int* __restrict__ ys, const float* __restrict__ wy,
    const int* __restrict__ xs, const float* __restrict__ wx,
    const int* __restrict__ col_base,
    int H, int W, int Hd, int Wd, int ky, int kx,
    int TY, int TX, int S, int nty, int ntx) {
  extern __shared__ float tmp[];  // (TY, S) f32

  long long b = blockIdx.x;
  const int tx_i = static_cast<int>(b % ntx);
  b /= ntx;
  const int ty_i = static_cast<int>(b % nty);
  const long long f = b / nty;

  const int i0 = ty_i * TY;
  const int j0 = tx_i * TX;
  const int rows = min(TY, Hd - i0);
  const int cols = min(TX, Wd - j0);
  const int c0 = col_base[tx_i];
  const Tin* frame = src + f * static_cast<long long>(H) * W;

  // y-pass over the tile's source-column span
  for (int e = threadIdx.x; e < rows * S; e += blockDim.x) {
    const int r = e / S;
    const int c = e - r * S;
    const int i = i0 + r;
    const int col = min(max(c0 + c, 0), W - 1);
    const int y0 = ys[i];
    const float* w = wy + static_cast<long long>(i) * ky;
    float acc = 0.0f;
    for (int a = 0; a < ky; ++a) {
      const int y = min(max(y0 + a, 0), H - 1);
      acc = fmaf(w[a], to_f32(frame[static_cast<long long>(y) * W + col]), acc);
    }
    tmp[e] = acc;  // e == r * S + c
  }
  __syncthreads();

  // x-pass from shared memory
  Tout* o = out + (f * Hd + i0) * static_cast<long long>(Wd) + j0;
  for (int e = threadIdx.x; e < rows * cols; e += blockDim.x) {
    const int r = e / cols;
    const int jj = e - r * cols;
    const int j = j0 + jj;
    const float* t = tmp + r * S + (xs[j] - c0);
    const float* w = wx + static_cast<long long>(j) * kx;
    float acc = 0.0f;
    for (int k = 0; k < kx; ++k) acc = fmaf(w[k], t[k], acc);
    store(o + static_cast<long long>(r) * Wd + jj, acc);
  }
}

template <typename Tin, typename Tout>
int launch(const void* src, void* out, const void* ys, const void* wy,
           const void* xs, const void* wx, const void* col_base,
           int F, int H, int W, int Hd, int Wd, int ky, int kx,
           int TY, int TX, int S, cudaStream_t stream) {
  const int nty = (Hd + TY - 1) / TY;
  const int ntx = (Wd + TX - 1) / TX;
  const long long nblocks = static_cast<long long>(F) * nty * ntx;
  if (nblocks <= 0 || nblocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = static_cast<size_t>(TY) * S * sizeof(float);
  auto kern = separable_apply_kernel<Tin, Tout>;
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<static_cast<unsigned>(nblocks), kThreads, smem, stream>>>(
      static_cast<const Tin*>(src), static_cast<Tout*>(out),
      static_cast<const int*>(ys), static_cast<const float*>(wy),
      static_cast<const int*>(xs), static_cast<const float*>(wx),
      static_cast<const int*>(col_base), H, W, Hd, Wd, ky, kx, TY, TX, S, nty, ntx);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tin>
int launch_out(int out_code, const void* src, void* out, const void* ys, const void* wy,
               const void* xs, const void* wx, const void* col_base,
               int F, int H, int W, int Hd, int Wd, int ky, int kx,
               int TY, int TX, int S, cudaStream_t stream) {
  switch (out_code) {
    case 0: return launch<Tin, float>(src, out, ys, wy, xs, wx, col_base, F, H, W, Hd, Wd, ky, kx, TY, TX, S, stream);
    case 1: return launch<Tin, __nv_bfloat16>(src, out, ys, wy, xs, wx, col_base, F, H, W, Hd, Wd, ky, kx, TY, TX, S, stream);
    case 2: return launch<Tin, uint8_t>(src, out, ys, wy, xs, wx, col_base, F, H, W, Hd, Wd, ky, kx, TY, TX, S, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = uint8
extern "C" int aainterp_separable_apply(
    const void* src, void* out, const void* ys, const void* wy,
    const void* xs, const void* wx, const void* col_base,
    int F, int H, int W, int Hd, int Wd, int ky, int kx,
    int TY, int TX, int S, int in_code, int out_code, void* stream) {
  if (F <= 0 || H <= 0 || W <= 0 || Hd <= 0 || Wd <= 0 || ky <= 0 || kx <= 0 ||
      TY <= 0 || TX <= 0 || S <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (in_code) {
    case 0: return launch_out<float>(out_code, src, out, ys, wy, xs, wx, col_base, F, H, W, Hd, Wd, ky, kx, TY, TX, S, s);
    case 1: return launch_out<__nv_bfloat16>(out_code, src, out, ys, wy, xs, wx, col_base, F, H, W, Hd, Wd, ky, kx, TY, TX, S, s);
    case 2: return launch_out<uint8_t>(out_code, src, out, ys, wy, xs, wx, col_base, F, H, W, Hd, Wd, ky, kx, TY, TX, S, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
