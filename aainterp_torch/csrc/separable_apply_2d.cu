// 2-D banded-tile separable area-average apply for Hopper (sm_90a): kernel 2.
//
// Replaces the TPU Pallas kernel aainterp/ops/pallas_apply.py
// ::_build_separable_kernel_2d (pallas_call at :968).  Per frame f and dst
// cell (i, j):
//
//   out[f,i,j] = cast( sum_b wx[j,b] * ( sum_a wy[i,a] * src[f, ys[i]+a, xs[j]+b] ) )
//
// with f32 sums, the y pass first, as the TPU kernel does per block.  Taps
// outside the image read 0 (they carry zero weight).
//
// What bounds it: bytes.  At the config-5 regrid (8 f32 fields 1800x3600 ->
// 180x360, 12-tap bands at a 10x ratio) a batch reads 207.4 MB and writes
// 2.1 MB for 2 * 12 multiply-adds per source pixel and dst column pass,
// far below the card's operations-per-byte ridge.  The TPU kernel densifies
// the bands into (TY x SY) and (SX x TX) matrix-unit blocks and DMAs
// 128-aligned source blocks; on Hopper the direct-tap form needs neither.
// The staged form is csrc/band_apply.cuh with zero-filled taps: one block
// takes TY dst rows of a strip of TX dst columns (the host planner,
// ops/cuda_apply_2d.py, gives each row tile its source row base, each strip
// its source column base, and a common span SY x SX that holds every tap);
// the tile's source window is copied raw, in the input's dtype, with
// 16-byte cp.async, so bf16 and u8 fields stage in half and a quarter of
// f32's shared memory and bytes; the y pass reads 4 columns per lane from
// shared memory and the x pass writes a shared output tile that leaves with
// 16-byte stores.  (The
// design before staged every pixel as f32 through 2-byte loads with a bounds
// test each, and bf16 then took longer than f32: PERF.md.)
//
// Bands so wide that one dst pixel's window exceeds the card's shared memory
// take the direct form instead: one thread per output element sums its
// ky x kx taps straight from device memory, in the same order (the y sum of
// each column, then the x sum), so both forms give the same bits.  The
// planner never rejects a band pair.
//
// Arithmetic modes (the precision knob, pallas_apply.py:798-846): 0 IEEE
// f32 ('auto', 'high', 'highest'), 1 bf16 operands with f32 sums
// ('default'), 2 'bf16x3' (band_apply.cuh).  Modes 1 and 2 multiply bf16
// values, whose products are exact in f32, and sum taps in order from 0, so
// ops/cuda_apply_2d.apply_separable_2d_plain reproduces them bit for bit; a
// pixel is rounded to bf16 where it is used, not where it is staged (the
// same value).
//
// Output: f32, bf16 (__float2bfloat16_rn) or u8 (rintf = round half to
// even, then saturate to [0, 255]).  Frame offsets are 64-bit.  Plain C
// interface for ctypes; the launch goes on the caller's stream and does not
// synchronise.  The return value is cudaGetLastError() after the launch.

#include "band_apply.cuh"

namespace {

using band::Acc;
using band::bf16r;
using band::kThreads;
using band::store;

// one pixel as f32, read through the read-only cache; a bf16 pixel is read
// as its 16 bits and widened exactly (bf16 is the top half of an f32)
__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  const unsigned short bits = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned>(bits) << 16);
}
__device__ __forceinline__ float load_f32(const uint8_t* p) {
  return static_cast<float>(__ldg(p));
}

// the direct form: one thread per output element, taps read from device
// memory in the staged form's order (each column's y sum, then the x sum)
template <typename Tin, typename Tout, int MODE>
__global__ void __launch_bounds__(kThreads) separable_apply_2d_direct_kernel(
    const Tin* __restrict__ src, Tout* __restrict__ out,
    const int* __restrict__ ys, const float* __restrict__ wy,
    const int* __restrict__ xs, const float* __restrict__ wx,
    long long total, int H, int W, int Hd, int Wd, int ky, int kx) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= total) return;
  const int j = static_cast<int>(e % Wd);
  const long long fi = e / Wd;
  const int i = static_cast<int>(fi % Hd);
  const long long f = fi / Hd;
  const Tin* frame = src + f * static_cast<long long>(H) * W;
  const float* wyi = wy + static_cast<long long>(i) * ky;
  const float* wxj = wx + static_cast<long long>(j) * kx;
  const int y0 = ys[i];
  const int x0 = xs[j];
  Acc<MODE, false> acc;
  for (int b = 0; b < kx; ++b) {
    const int x = x0 + b;
    Acc<MODE, true> col;
    for (int a = 0; a < ky; ++a) {
      const int y = y0 + a;
      float v = (y >= 0 && y < H && x >= 0 && x < W)
                    ? load_f32(frame + static_cast<long long>(y) * W + x)
                    : 0.0f;
      if (MODE == 1) v = bf16r(v);
      col.add(wyi[a], v);
    }
    const float t = col.sum();
    acc.add(wxj[b], (MODE == 1) ? bf16r(t) : t);
  }
  store(out + e, acc.sum());
}

template <typename Tin, typename Tout, int MODE>
int launch(const void* src, void* out, const void* ys, const void* wy,
           const void* xs, const void* wx, const void* row_base,
           const void* col_base, int F, const band::Dims& d, cudaStream_t stream) {
  if (d.SY == 0) {  // the direct form
    const long long total = static_cast<long long>(F) * d.Hd * d.Wd;
    const long long blocks = (total + kThreads - 1) / kThreads;
    if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
    separable_apply_2d_direct_kernel<Tin, Tout, MODE>
        <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
            static_cast<const Tin*>(src), static_cast<Tout*>(out),
            static_cast<const int*>(ys), static_cast<const float*>(wy),
            static_cast<const int*>(xs), static_cast<const float*>(wx),
            total, d.H, d.W, d.Hd, d.Wd, d.ky, d.kx);
    return static_cast<int>(cudaGetLastError());
  }
  return band::launch_staged<Tin, Tout, MODE, false>(src, out, ys, wy, xs, wx, row_base,
                                                     col_base, F, d, stream);
}

template <typename Tin, typename Tout>
int launch_mode(int mode, const void* src, void* out, const void* ys, const void* wy,
                const void* xs, const void* wx, const void* row_base, const void* col_base,
                int F, const band::Dims& d, cudaStream_t stream) {
  switch (mode) {
    case 0: return launch<Tin, Tout, 0>(src, out, ys, wy, xs, wx, row_base, col_base, F, d, stream);
    case 1: return launch<Tin, Tout, 1>(src, out, ys, wy, xs, wx, row_base, col_base, F, d, stream);
    case 2: return launch<Tin, Tout, 2>(src, out, ys, wy, xs, wx, row_base, col_base, F, d, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename Tin>
int launch_out(int out_code, int mode, const void* src, void* out, const void* ys,
               const void* wy, const void* xs, const void* wx, const void* row_base,
               const void* col_base, int F, const band::Dims& d, cudaStream_t stream) {
  switch (out_code) {
    case 0: return launch_mode<Tin, float>(mode, src, out, ys, wy, xs, wx, row_base, col_base, F, d, stream);
    case 1: return launch_mode<Tin, __nv_bfloat16>(mode, src, out, ys, wy, xs, wx, row_base, col_base, F, d, stream);
    case 2: return launch_mode<Tin, uint8_t>(mode, src, out, ys, wy, xs, wx, row_base, col_base, F, d, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = uint8; mode: 0 f32, 1 bf16
// operands ('default'), 2 bf16x3.  row_base / col_base: the first source
// row of each row tile of TY dst rows and the first source column of each
// strip of TX dst columns.
// SY = SX = 0 selects the direct form (TY, TX, row_base and col_base
// unused)
extern "C" int aainterp_separable_apply_2d(
    const void* src, void* out, const void* ys, const void* wy,
    const void* xs, const void* wx, const void* row_base, const void* col_base,
    int F, int H, int W, int Hd, int Wd, int ky, int kx,
    int TY, int TX, int SY, int SX, int mode, int in_code, int out_code,
    void* stream) {
  const bool direct = SY == 0 && SX == 0;
  if (F <= 0 || H <= 0 || W <= 0 || Hd <= 0 || Wd <= 0 || ky <= 0 || kx <= 0 ||
      (!direct && (TY <= 0 || TX <= 0 || TX > band::kThreads || SY < ky || SX < kx))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  band::Dims d{H, W, Hd, Wd, ky, kx, TY, TX, SY, SX, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (in_code) {
    case 0: return launch_out<float>(out_code, mode, src, out, ys, wy, xs, wx, row_base, col_base, F, d, s);
    case 1: return launch_out<__nv_bfloat16>(out_code, mode, src, out, ys, wy, xs, wx, row_base, col_base, F, d, s);
    case 2: return launch_out<uint8_t>(out_code, mode, src, out, ys, wy, xs, wx, row_base, col_base, F, d, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
