// The fused aligned regrid for Hopper (sm_90a): both passes of an aligned
// integer-ratio separable apply in one kernel, the y -> x intermediate kept
// on chip.
//
// Replaces the TPU Pallas probe benchmarks/aligned_fused_probe.py:100
// _build_fused (pallas_call at :173), which on v5e could not be built for
// W = 3600 (every row-sliced copy wants a 128-aligned last dimension).
//
// For aligned plans (ops/apply.aligned_axis_plan: dst cell h reads the my
// source rows c0y + my*h .. + my - 1, dst column w the mx source columns
// c0x + mx*w .. + mx - 1), per frame f:
//
//   out[f, h, w] = sum_b wkx[w, b] * ( sum_a wky[h, a] * src[f, c0y + my*h + a, c0x + mx*w + b] )
//
// each sum one f32 fused multiply-add per tap, the y taps in order from a =
// 0, then the x taps in order from b = 0, so that the plain version
// (probes/aligned_fused_probe.aligned_fused_plain, ops.apply.fma32)
// repeats it bit for bit.
//
// What bounds it: bytes.  At the config-5 regrid (8 fields of 1800 x 3600
// f32 -> 180 x 360, m = 10) the source is 207.4 MB and the output 2.1 MB;
// 11 operations per source pixel are far below the card's ridge.  So the
// design reads every source pixel once, in 16-byte loads along x, and
// writes nothing but the output: one block per (frame, dst row, chunk of
// dst columns).  Its threads take the chunk's source columns 4 at a time
// (one at a time where rows or the chunk are not 16-byte aligned), sum the
// my rows into registers, and put the chunk's y sums in shared memory
// (mx * TXc floats); then a thread per dst column sums its mx neighbouring
// y sums.  A block's my source rows are the only ones that dst row reads,
// so nothing is read twice.  (The TPU kernel staged a (360, 1280) f32
// block, 1.8 MB: no SM holds that, and no block here needs more than its
// own dst row's rows.)
//
// Plain C interface for ctypes; the launch goes on the caller's stream and
// does not synchronise.  The return value is cudaGetLastError() after the
// launch (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
// the chunk's y sums within the default 48 KB of shared memory a block may
// have without an opt-in
constexpr long long kChunkBytes = 48 * 1024;

struct Dims {
  int H, W, Hd, Wd, my, mx, c0y, c0x, TXc, n_chunk;
};

__device__ __forceinline__ float lane(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}
__device__ __forceinline__ float lane(float v, int) { return v; }

// the y sums of source columns [x0 + V*g, + V) for this block's dst row,
// into t[V*g ..]; V = 4: 16-byte loads (x0 and the row stride aligned).
// The row's y weights wy are read warp-uniformly: one L1 broadcast each.
template <int V>
__device__ __forceinline__ void y_sums(const float* __restrict__ rows0, float* t,
                                       const float* __restrict__ wy, const Dims& d, int n) {
  using Vec = typename std::conditional<V == 4, float4, float>::type;
  for (int g = threadIdx.x; g < n / V; g += kThreads) {
    float acc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = 0.0f;
#pragma unroll 5
    for (int a = 0; a < d.my; ++a) {
      const Vec v = *reinterpret_cast<const Vec*>(rows0 + static_cast<long long>(a) * d.W + V * g);
      const float w = __ldg(wy + a);
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] = fmaf(w, lane(v, k), acc[k]);
    }
#pragma unroll
    for (int k = 0; k < V; ++k) t[V * g + k] = acc[k];
  }
}

__global__ void __launch_bounds__(kThreads)
    aligned_fused_kernel(const float* __restrict__ src, float* __restrict__ out,
                         const float* __restrict__ wky, const float* __restrict__ wkx, Dims d) {
  extern __shared__ __align__(16) float t[];   // mx * TXc y sums
  const int chunk = blockIdx.x % d.n_chunk;
  const long long fh = blockIdx.x / d.n_chunk;   // f * Hd + h
  const int h = static_cast<int>(fh % d.Hd);
  const long long f = fh / d.Hd;
  const int w0 = chunk * d.TXc;
  const int cols = min(d.TXc, d.Wd - w0);
  const int n = d.mx * cols;                      // source columns of the chunk
  const float* wy = wky + static_cast<long long>(h) * d.my;
  const float* rows0 = src + (f * d.H + d.c0y + static_cast<long long>(d.my) * h) * d.W + d.c0x +
                       static_cast<long long>(d.mx) * w0;
  // 16-byte loads where every row of the chunk starts 16-byte aligned
  if ((reinterpret_cast<uintptr_t>(rows0) & 15) == 0 && d.W % 4 == 0 && n % 4 == 0) {
    y_sums<4>(rows0, t, wy, d, n);
  } else {
    y_sums<1>(rows0, t, wy, d, n);
  }
  __syncthreads();
  float* orow = out + fh * d.Wd + w0;
  for (int w = threadIdx.x; w < cols; w += kThreads) {
    const float* wx = wkx + static_cast<long long>(w0 + w) * d.mx;
    const float* tw = t + w * d.mx;
    float acc = 0.0f;
    for (int b = 0; b < d.mx; ++b) acc = fmaf(__ldg(wx + b), tw[b], acc);
    orow[w] = acc;
  }
}

}  // namespace

// src (F, H, W) f32, out (F, Hd, Wd) f32, wky (Hd, my) and wkx (Wd, mx)
// f32; the plans' first source row and column c0y, c0x; TXc dst columns
// per block (the block's shared memory is mx * TXc floats).  Returns
// cudaErrorInvalidValue where the plans do not fit the frames (c0y + my *
// Hd > H, c0x + mx * Wd > W) or the chunk's y sums exceed kChunkBytes.
extern "C" int aainterp_aligned_fused(const void* src, void* out, const void* wky,
                                      const void* wkx, int F, int H, int W, int Hd, int Wd,
                                      int my, int mx, int c0y, int c0x, int TXc, void* stream) {
  if (F <= 0 || H <= 0 || W <= 0 || Hd <= 0 || Wd <= 0 || my <= 0 || mx <= 0 || c0y < 0 ||
      c0x < 0 || TXc <= 0 ||
      static_cast<long long>(c0y) + static_cast<long long>(my) * Hd > H ||
      static_cast<long long>(c0x) + static_cast<long long>(mx) * Wd > W ||
      static_cast<long long>(mx) * TXc * 4 > kChunkBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Dims d{H, W, Hd, Wd, my, mx, c0y, c0x, TXc, (Wd + TXc - 1) / TXc};
  const long long blocks = static_cast<long long>(F) * Hd * d.n_chunk;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = static_cast<size_t>(mx) * TXc * sizeof(float);
  aligned_fused_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<float*>(out), static_cast<const float*>(wky),
      static_cast<const float*>(wkx), d);
  return static_cast<int>(cudaGetLastError());
}
