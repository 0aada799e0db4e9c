// 2-D banded-tile separable area-average apply for Hopper (sm_90a).
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
// 128-aligned source blocks; on Hopper the direct-tap form needs neither:
//
//   * one block per (frame, dst row tile, dst col tile).  The host planner
//     (ops/cuda_apply_2d.py) gives each row tile its source row base, each
//     column tile its source column base, and a common span SY x SX that
//     holds every tap of every tile;
//   * the source block [rb, rb+SY) x [cb, cb+SX) is staged into shared
//     memory once, as f32, with coalesced row-major loads (8 in flight per
//     thread; a running (row, column) walk instead of a division per
//     element), so each source pixel is read from device memory about once
//     (the halo between tiles is ky - m rows and kx - m columns);
//   * the y pass writes T[r, c] = sum_a wy[i,a] * blk[ys[i]-rb+a, c] for
//     the tile's rows into shared memory, neighbouring threads on
//     neighbouring columns;
//   * after a barrier the x pass computes each output element from T, one
//     thread per element, and writes every element of the tile.
//
// Bands so wide that one dst pixel's block (ky x kx + kx floats) exceeds the
// card's shared memory take the direct form instead: one thread per output
// element sums its ky x kx taps straight from device memory, in the same
// order (the y sum of each column, then the x sum), so both forms give the
// same bits.  The planner never rejects a band pair.
//
// Measured on the H100 (PERF.md), the staging loop's per-element work, not
// the bytes, sets the time: bf16 fields, at half the bytes, take longer
// than f32.  Wider staging loads and overlapping the staging of one block
// with the passes of another are the next steps.
//
// Arithmetic modes (the precision knob, pallas_apply.py:798-846):
//   0  IEEE f32 products and sums ('auto', 'high', 'highest');
//   1  bf16 operands, f32 sums ('default'): weights, pixels and the y-pass
//      intermediate are rounded to bf16 (nearest even) before each product;
//   2  'bf16x3': operands split into hi = bf16(x), lo = bf16(x - hi); per
//      contraction three sums hi.hi, hi.lo, lo.hi added as
//      (s1 + s2) + s3 in _dot_bf16x3's order.
// Modes 1 and 2 multiply bf16 values, whose products are exact in f32, and
// sum taps in order from 0, so ops/cuda_apply_2d.apply_separable_2d_plain
// reproduces them bit for bit.
//
// Output: f32, bf16 (__float2bfloat16_rn) or u8 (rintf = round half to
// even, then saturate to [0, 255]).  Frame offsets are 64-bit.  Plain C
// interface for ctypes; the launch goes on the caller's stream and does not
// synchronise.  The return value is cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = 8;  // staging loads in flight per thread
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr int kMaxDevices = 64;

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

// (r, c) of a row-major index e over rows of width sx, advanced by
// kThreads at a time without a division per step
struct Walk {
  int r, c, dr, dc, sx;
  __device__ Walk(int e, int sx_) : sx(sx_) {
    r = e / sx; c = e - r * sx;
    dr = kThreads / sx; dc = kThreads - dr * sx;
  }
  __device__ __forceinline__ void next() {
    r += dr; c += dc;
    if (c >= sx) { c -= sx; ++r; }
  }
};

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store(uint8_t* p, float v) {
  // round half to even, then saturate (NaN saturates to 0)
  const float r = fminf(fmaxf(rintf(v), 0.0f), 255.0f);
  *p = static_cast<uint8_t>(r);
}

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
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
  __device__ __forceinline__ float sum() const {
    return MODE == 2 ? (s1 + s2) + s3 : s1;
  }
};

// sum_k w[k] * v[k * stride] over shared memory
template <int MODE, bool DATA_LO_FIRST>
__device__ __forceinline__ float tap_sum(const float* __restrict__ w,
                                         const float* v, int stride, int k) {
  Acc<MODE, DATA_LO_FIRST> acc;
  for (int a = 0; a < k; ++a) acc.add(w[a], v[a * stride]);
  return acc.sum();
}

// the staged form: one block per (frame, dst row tile, dst col tile), all
// tiles of all frames on grid.x (col tile fastest)
template <typename Tin, typename Tout, int MODE>
__global__ void __launch_bounds__(kThreads) separable_apply_2d_kernel(
    const Tin* __restrict__ src, Tout* __restrict__ out,
    const int* __restrict__ ys, const float* __restrict__ wy,
    const int* __restrict__ xs, const float* __restrict__ wx,
    const int* __restrict__ row_base, const int* __restrict__ col_base,
    int H, int W, int Hd, int Wd, int ky, int kx,
    int TY, int TX, int SY, int SX, int nty, int ntx) {
  extern __shared__ float smem[];
  float* blk = smem;              // (SY, SX) source block, f32
  float* tmp = smem + SY * SX;    // (TY, SX) y-pass rows, f32

  const int tx_i = blockIdx.x % ntx;
  const int rest = blockIdx.x / ntx;
  const int ty_i = rest % nty;
  const long long f = rest / nty;
  const int i0 = ty_i * TY;
  const int j0 = tx_i * TX;
  const int rows = min(TY, Hd - i0);
  const int cols = min(TX, Wd - j0);
  const int rb = row_base[ty_i];
  const int cb = col_base[tx_i];
  const Tin* frame = src + f * static_cast<long long>(H) * W;

  // stage the source block, kBatch loads in flight per thread
  const int n = SY * SX;
  Walk at(threadIdx.x, SX);
  for (int e0 = threadIdx.x; e0 < n; e0 += kBatch * kThreads) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int y = rb + at.r;
      const int x = cb + at.c;
      v[u] = (e0 + u * kThreads < n && y >= 0 && y < H && x >= 0 && x < W)
                 ? load_f32(frame + static_cast<long long>(y) * W + x)
                 : 0.0f;
      at.next();
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kThreads;
      if (e < n) blk[e] = (MODE == 1) ? bf16r(v[u]) : v[u];
    }
  }
  __syncthreads();

  // y pass over the block's columns
  Walk yp(threadIdx.x, SX);
  for (int e = threadIdx.x; e < rows * SX; e += kThreads, yp.next()) {
    const int i = i0 + yp.r;
    const float t = tap_sum<MODE, true>(wy + static_cast<long long>(i) * ky,
                                        blk + (ys[i] - rb) * SX + yp.c, SX, ky);
    tmp[e] = (MODE == 1) ? bf16r(t) : t;  // e == r * SX + c
  }
  __syncthreads();

  // x pass: every output element of the tile
  Tout* o = out + (f * Hd + i0) * static_cast<long long>(Wd) + j0;
  for (int e = threadIdx.x; e < rows * cols; e += kThreads) {
    const int r = e / cols;
    const int jj = e - r * cols;
    const int j = j0 + jj;
    const float acc = tap_sum<MODE, false>(wx + static_cast<long long>(j) * kx,
                                           tmp + r * SX + (xs[j] - cb), 1, kx);
    store(o + static_cast<long long>(r) * Wd + jj, acc);
  }
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
           const void* col_base, int F, int H, int W, int Hd, int Wd, int ky,
           int kx, int TY, int TX, int SY, int SX, cudaStream_t stream) {
  if (SY == 0) {  // the direct form
    const long long total = static_cast<long long>(F) * Hd * Wd;
    const long long blocks = (total + kThreads - 1) / kThreads;
    if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
    separable_apply_2d_direct_kernel<Tin, Tout, MODE>
        <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
            static_cast<const Tin*>(src), static_cast<Tout*>(out),
            static_cast<const int*>(ys), static_cast<const float*>(wy),
            static_cast<const int*>(xs), static_cast<const float*>(wx),
            total, H, W, Hd, Wd, ky, kx);
    return static_cast<int>(cudaGetLastError());
  }
  const int nty = (Hd + TY - 1) / TY;
  const int ntx = (Wd + TX - 1) / TX;
  const long long blocks = static_cast<long long>(F) * nty * ntx;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = (static_cast<size_t>(SY) * SX + static_cast<size_t>(TY) * SX) * sizeof(float);
  auto kern = separable_apply_2d_kernel<Tin, Tout, MODE>;
  if (smem > kDefaultSmem) {
    // the opt-in above 48 KB is a per-device attribute: set it once per
    // device (to the device's maximum) so that a launch inside CUDA-graph
    // capture makes no call here after a warm-up launch
    static std::atomic<int> opted_in[kMaxDevices];
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
    if (!opted_in[dev].load()) {
      int limit = 0;
      e = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      if (e == cudaSuccess) {
        e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
      }
      if (e != cudaSuccess) return static_cast<int>(e);
      opted_in[dev].store(1);
    }
  }
  kern<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const Tin*>(src), static_cast<Tout*>(out),
      static_cast<const int*>(ys), static_cast<const float*>(wy),
      static_cast<const int*>(xs), static_cast<const float*>(wx),
      static_cast<const int*>(row_base), static_cast<const int*>(col_base),
      H, W, Hd, Wd, ky, kx, TY, TX, SY, SX, nty, ntx);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tin, typename Tout>
int launch_mode(int mode, const void* src, void* out, const void* ys, const void* wy,
                const void* xs, const void* wx, const void* row_base,
                const void* col_base, int F, int H, int W, int Hd, int Wd, int ky,
                int kx, int TY, int TX, int SY, int SX, cudaStream_t stream) {
  switch (mode) {
    case 0: return launch<Tin, Tout, 0>(src, out, ys, wy, xs, wx, row_base, col_base, F, H, W, Hd, Wd, ky, kx, TY, TX, SY, SX, stream);
    case 1: return launch<Tin, Tout, 1>(src, out, ys, wy, xs, wx, row_base, col_base, F, H, W, Hd, Wd, ky, kx, TY, TX, SY, SX, stream);
    case 2: return launch<Tin, Tout, 2>(src, out, ys, wy, xs, wx, row_base, col_base, F, H, W, Hd, Wd, ky, kx, TY, TX, SY, SX, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename Tin>
int launch_out(int out_code, int mode, const void* src, void* out, const void* ys,
               const void* wy, const void* xs, const void* wx, const void* row_base,
               const void* col_base, int F, int H, int W, int Hd, int Wd, int ky,
               int kx, int TY, int TX, int SY, int SX, cudaStream_t stream) {
  switch (out_code) {
    case 0: return launch_mode<Tin, float>(mode, src, out, ys, wy, xs, wx, row_base, col_base, F, H, W, Hd, Wd, ky, kx, TY, TX, SY, SX, stream);
    case 1: return launch_mode<Tin, __nv_bfloat16>(mode, src, out, ys, wy, xs, wx, row_base, col_base, F, H, W, Hd, Wd, ky, kx, TY, TX, SY, SX, stream);
    case 2: return launch_mode<Tin, uint8_t>(mode, src, out, ys, wy, xs, wx, row_base, col_base, F, H, W, Hd, Wd, ky, kx, TY, TX, SY, SX, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = uint8; mode: 0 f32, 1 bf16
// operands ('default'), 2 bf16x3
// SY = SX = 0 selects the direct form (row_base and col_base unused)
extern "C" int aainterp_separable_apply_2d(
    const void* src, void* out, const void* ys, const void* wy,
    const void* xs, const void* wx, const void* row_base, const void* col_base,
    int F, int H, int W, int Hd, int Wd, int ky, int kx,
    int TY, int TX, int SY, int SX, int mode, int in_code, int out_code,
    void* stream) {
  const bool direct = SY == 0 && SX == 0;
  if (F <= 0 || H <= 0 || W <= 0 || Hd <= 0 || Wd <= 0 || ky <= 0 || kx <= 0 ||
      (!direct && (TY <= 0 || TX <= 0 || SY <= 0 || SX <= 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (in_code) {
    case 0: return launch_out<float>(out_code, mode, src, out, ys, wy, xs, wx, row_base, col_base, F, H, W, Hd, Wd, ky, kx, TY, TX, SY, SX, s);
    case 1: return launch_out<__nv_bfloat16>(out_code, mode, src, out, ys, wy, xs, wx, row_base, col_base, F, H, W, Hd, Wd, ky, kx, TY, TX, SY, SX, s);
    case 2: return launch_out<uint8_t>(out_code, mode, src, out, ys, wy, xs, wx, row_base, col_base, F, H, W, Hd, Wd, ky, kx, TY, TX, SY, SX, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
