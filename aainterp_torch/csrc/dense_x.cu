// Kernel 1's dense-x probe for Hopper (sm_90a) on the tensor cores:
// production's y pass, then every output summed over all W source columns
// with a dense (W, Wd) x operator, as one wgmma product on a bf16 split.
//
// Replaces benchmarks/rgb1024_experiments.py:181 _build_full_dense_x
// (pallas_call at :238): the y pass, then one dense (TY, W) @ (W, Wd_pad)
// product on the TPU's matrix unit, the operator in the frame dtype.
//
//   out[f, i, j] = sum over x of T[f, i, x] * Wxd[x, j],
//   T[f, i, x]   = the taps wy[i, a] * frames[f, clamp(ys[i] + a), x],
//                  fused-multiply-added in f32 in order from a = 0
//                  (production's y pass, bit for bit).
//
// The product runs on wgmma m64n208k16 (bf16 in, f32 sums) on a split of T
// into hi = bf16(T) and lo = bf16(T - hi): bf16 frames, whose operator is
// exact in bf16, take lo * W + hi * W (T keeps 16 bits, far below the bf16
// output's rounding); f32 frames split the operator on the host too and
// take all four products, lo * Wlo + lo * Whi + hi * Wlo + hi * Whi: bf16x3
// (high_dot's three) leaves lo * Wlo, up to 2^-18 of each term, and with
// T's and the operator's own split residuals its worst case passes the
// check's 1e-5 of max|out| at rgb1024; the fourth leaves 2^-17.  The sums
// come in the tensor cores' order, not the f32 statement's.
//
// What bounds it: at rgb1024 (24 x 1024^2 -> 410^2) the split's products
// are 16.5 GFLOP (bf16; f32 33.1) on the tensor cores, about as long as
// the frames' bytes at 3.35 TB/s.  Every block also reads the whole
// operator (~0.8 MB bf16) from L2, and each 32-column chunk is a chain of
// its own in every block (window, y pass, split, barriers, products), so
// the design keeps loads off that chain and runs one chunk's products
// under the next chunk's y pass:
//
//   * a block takes one frame, 64 dst rows (one wgmma M tile) and NW x 208
//     dst columns (NW warpgroups, each one m64n208 slice): bf16 frames NW
//     = 1, rgb1024's 410 columns in two blocks, up to three an SM; f32
//     frames, whose operator and source rows weigh twice as much, NW = 2,
//     all 410 in one block, so the y pass runs once a tile;
//   * it walks K = W in chunks of 32 source columns.  For each chunk the
//     threads run the y pass of the tile's rows, split T and write it in
//     K-major core matrices; the chunk's operator arrives as one 1-D bulk
//     copy onto an mbarrier from an image the host packed once in that
//     layout (the stage's exact shared-memory bytes); then the warpgroups
//     issue the chunk's wgmma and go on to the next chunk's y pass while
//     they run, through a ring of two stages (wgmma_wait<1> before a stage
//     is written again);
//   * the y pass reads the tile's source window (the SY rows its taps
//     reach, 32 columns) from shared memory, where one TMA box brought it
//     a chunk ahead, through a ring of two windows: its loads' latency is
//     off the chain.  Where no box can take it (rows not a whole number of
//     16-byte chunks, SY over 256 rows or over the shared memory), the y
//     pass reads global memory instead (16-byte loads where rows allow);
//   * columns past W are zeros in T and the operator, rows past Hd are
//     computed and not stored, so any H, W, Hd, Wd work: shared memory
//     holds two chunks, not a row.
//
// Plain C interface for ctypes; the launch goes on the caller's stream and
// does not synchronise.  Returns cudaGetLastError() after the launch (0 on
// success), or cudaErrorInvalidValue for arguments it does not take.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <climits>
#include <type_traits>

#include "hopper.cuh"
#include "stage_common.cuh"

namespace {

constexpr int kRows = 64;    // dst rows a block: one wgmma M tile
constexpr int kChunk = 32;   // source columns (K) a stage: two k16 steps
constexpr int kCols = 208;   // dst columns a warpgroup: one m64n208k16
constexpr int kWarpgroup = 128;
constexpr int kKg = kChunk / 8;                  // core matrices along K
constexpr uint32_t kLbo = 128, kSbo = 128 * kKg;  // bytes along K, along M / N
constexpr int kMaxWindowRows = 256;              // a TMA box's rows at most
constexpr int kBars = 128;                       // bytes for the four mbarriers

// bf16 elements of a stage: the operator's parts (f32 frames: hi and lo),
// NW x 208 columns each, then T's hi and lo, 64 rows each
template <typename T, int NW>
struct Stage {
  static constexpr int kParts = std::is_same<T, float>::value ? 2 : 1;
  static constexpr int kB = kParts * NW * kCols * kChunk;
  static constexpr int kA = kRows * kChunk;
  static constexpr int kElems = kB + 2 * kA;
  // alignment slack, the barriers, two stages; the windows come after them
  static constexpr size_t kSmem = 128 + kBars + 2 * 2 * static_cast<size_t>(kElems);
};

// bytes of one window (SY rows of 32 columns), whole 128-byte lines
template <typename T>
__host__ __device__ constexpr size_t window_bytes(int SY) {
  return (static_cast<size_t>(SY) * kChunk * sizeof(T) + 127) / 128 * 128;
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p), b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&a);
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = __bfloat162float(h[j]);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store2(float* p, float a, float b, bool pair) {
  if (pair) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    p[0] = a;
    p[1] = b;
  }
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b, bool pair) {
  if (pair) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  } else {
    p[0] = __float2bfloat16_rn(a);
    p[1] = __float2bfloat16_rn(b);
  }
}

__device__ __forceinline__ void store1(float* p, float a) { *p = a; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float a) { *p = __float2bfloat16_rn(a); }

// T[i[q], x0[q] .. x0[q] + 7] of frame `src` for the thread's G groups:
// production's y pass (taps in order from 0, one fused multiply-add each,
// rows clamped), the groups' loads of a tap issued together; zeros for
// columns past W.  A row past Hd is computed as row Hd - 1: it feeds only
// an output row that is not stored.  `vec`: 16-byte loads (rows of a whole
// number of 16-byte chunks, a 16-byte aligned frame).
template <typename T, int G>
__device__ __forceinline__ void y_pass(const T* __restrict__ src, const int* __restrict__ ys,
                                       const float* __restrict__ wy, int H, int W, int Hd, int ky,
                                       const int (&i)[G], const int (&x0)[G], bool vec,
                                       float (&t)[G][8]) {
  int base[G];
  const float* w_i[G];
  bool whole = vec;
#pragma unroll
  for (int q = 0; q < G; ++q) {
    const int r = min(i[q], Hd - 1);
    base[q] = __ldg(ys + r);
    w_i[q] = wy + static_cast<long long>(r) * ky;
    whole = whole && x0[q] + 8 <= W;
#pragma unroll
    for (int j = 0; j < 8; ++j) t[q][j] = 0.0f;
  }
  if (whole) {
#pragma unroll 4
    for (int a = 0; a < ky; ++a) {
      float v[G][8], w[G];
#pragma unroll
      for (int q = 0; q < G; ++q) {
        const int y = min(max(base[q] + a, 0), H - 1);
        w[q] = __ldg(w_i[q] + a);
        load8(src + static_cast<long long>(y) * W + x0[q], v[q]);
      }
#pragma unroll
      for (int q = 0; q < G; ++q) {
#pragma unroll
        for (int j = 0; j < 8; ++j) t[q][j] = fmaf(w[q], v[q][j], t[q][j]);
      }
    }
    return;
  }
#pragma unroll
  for (int q = 0; q < G; ++q) {
    const int n = min(8, W - x0[q]);
    for (int a = 0; a < ky; ++a) {
      const int y = min(max(base[q] + a, 0), H - 1);
      const float w = __ldg(w_i[q] + a);
      const T* row = src + static_cast<long long>(y) * W + x0[q];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < n) t[q][j] = fmaf(w, to_f32(row[j]), t[q][j]);
      }
    }
  }
}

// The same y pass from the tile's window in shared memory: window row
// y - y0 holds source row y's 32 columns of the chunk (zeros past W, as
// the box loads them); every clamped tap row of the tile lies in it.
template <typename T, int G>
__device__ __forceinline__ void y_pass_window(const T* win, int y0, const int* __restrict__ ys,
                                              const float* __restrict__ wy, int H, int Hd, int ky,
                                              const int (&i)[G], const int (&k)[G],
                                              float (&t)[G][8]) {
  int base[G];
  const float* w_i[G];
#pragma unroll
  for (int q = 0; q < G; ++q) {
    const int r = min(i[q], Hd - 1);
    base[q] = __ldg(ys + r);
    w_i[q] = wy + static_cast<long long>(r) * ky;
#pragma unroll
    for (int j = 0; j < 8; ++j) t[q][j] = 0.0f;
  }
#pragma unroll 4
  for (int a = 0; a < ky; ++a) {
    float v[G][8], w[G];
#pragma unroll
    for (int q = 0; q < G; ++q) {
      const int y = min(max(base[q] + a, 0), H - 1);
      w[q] = __ldg(w_i[q] + a);
      load8(win + (y - y0) * kChunk + k[q], v[q]);
    }
#pragma unroll
    for (int q = 0; q < G; ++q) {
#pragma unroll
      for (int j = 0; j < 8; ++j) t[q][j] = fmaf(w[q], v[q][j], t[q][j]);
    }
  }
}

// One block: frame f, dst rows [64 rt, 64 rt + 64), dst columns [NB cb,
// NB cb + NB) with NB = NW x 208.  `ops` is the packed operator: for each
// column block and chunk, one stage's operator bytes ((cb * nc + c) * kB
// elements on), part p's column n, source column k at p * NB * 32 +
// core_offset(n, k, 4).  kWindow: the y pass reads TMA boxes of `fmap`
// (the frames as a (F, H, W) map, box {32, SY, 1}) at row max(row_base[rt],
// 0); otherwise it reads `frames`.
template <typename T, int NW, bool kWindow>
__global__ void __launch_bounds__(NW* kWarpgroup) dense_x_kernel(
    const __grid_constant__ CUtensorMap fmap, const T* __restrict__ frames, T* __restrict__ out,
    const int* __restrict__ ys, const float* __restrict__ wy, const int* __restrict__ row_base,
    const __nv_bfloat16* __restrict__ ops, int H, int W, int Hd, int Wd, int ky, int SY, int n_rt,
    int n_cb, int nc, int vec, int pairs) {
  using S = Stage<T, NW>;
  constexpr int kThreads = NW * kWarpgroup;
  constexpr int kNB = NW * kCols;
  constexpr int kGroups = kRows * kKg / kThreads;  // 8-column groups a thread a chunk
  extern __shared__ unsigned char raw[];
  unsigned char* base = raw + ((128 - (hopper::smem_u32(raw) & 127)) & 127);
  uint64_t* bar = reinterpret_cast<uint64_t*>(base);   // operator 0, 1; window 0, 1
  __nv_bfloat16* stage0 = reinterpret_cast<__nv_bfloat16*>(base + kBars);
  T* win0 = reinterpret_cast<T*>(base + kBars + 2 * 2 * static_cast<size_t>(S::kElems));
  const size_t win_elems = window_bytes<T>(SY) / sizeof(T);
  const uint32_t win_tx = static_cast<uint32_t>(SY) * kChunk * sizeof(T);
  const int tid = threadIdx.x;
  const int cb = blockIdx.x % n_cb;
  const int rest = blockIdx.x / n_cb;
  const int rt = rest % n_rt;
  const long long f = rest / n_rt;
  const int i0 = rt * kRows;
  const T* src = frames + f * H * static_cast<long long>(W);
  const __nv_bfloat16* op_cb = ops + static_cast<long long>(cb) * nc * S::kB;
  constexpr uint32_t kBBytes = 2u * S::kB;
  const int y0 = kWindow ? max(__ldg(row_base + rt), 0) : 0;

  if (tid == 0) {
#pragma unroll
    for (int b = 0; b < 4; ++b) hopper::mbar_init(&bar[b], 1);
    hopper::fence_mbarrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_arrive_expect_tx(&bar[0], kBBytes);
    hopper::bulk_load(stage0, op_cb, kBBytes, &bar[0]);
    if constexpr (kWindow) {
      hopper::mbar_arrive_expect_tx(&bar[2], win_tx);
      hopper::tma_load_3d(win0, &fmap, 0, y0, static_cast<int>(f), &bar[2]);
    }
  }

  // warpgroup: its 208 columns; read from lane 0 so the compiler sees it uniform
  const int g = __shfl_sync(0xffffffffu, tid / kWarpgroup, 0);
  float d[kCols / 2];
#pragma unroll
  for (int i = 0; i < kCols / 2; ++i) d[i] = 0.0f;

  for (int c = 0; c < nc; ++c) {
    const int s = c & 1;
    __nv_bfloat16* B = stage0 + s * S::kElems;
    __nv_bfloat16* Ahi = B + S::kB;
    __nv_bfloat16* Alo = Ahi + S::kA;
    // the y pass of chunk c, split: group e is row r = 8 (e / 32) + (e %
    // 32) / 4, columns 8 (e % 4) .. + 7 (four lanes read a row's 32
    // columns), at core_offset(r, 8 (e % 4), 4) of the stage's A
    int rows[kGroups], ks[kGroups];
#pragma unroll
    for (int q = 0; q < kGroups; ++q) {
      const int e = tid + q * kThreads;
      rows[q] = i0 + 8 * (e / 32) + (e % 32) / 4;
      ks[q] = 8 * (e % 4);
    }
    float t[kGroups][8];
    if constexpr (kWindow) {
      if (tid == 0 && c + 1 < nc) {   // the next window: its buffer's y pass (c - 1) is done
        hopper::mbar_arrive_expect_tx(&bar[2 + (s ^ 1)], win_tx);
        hopper::tma_load_3d(win0 + (s ^ 1) * win_elems, &fmap, (c + 1) * kChunk, y0,
                            static_cast<int>(f), &bar[2 + (s ^ 1)]);
      }
      hopper::mbar_wait(&bar[2 + s], (c >> 1) & 1);
      y_pass_window(win0 + s * win_elems, y0, ys, wy, H, Hd, ky, rows, ks, t);
    } else {
      int cols[kGroups];
#pragma unroll
      for (int q = 0; q < kGroups; ++q) cols[q] = c * kChunk + ks[q];
      y_pass(src, ys, wy, H, W, Hd, ky, rows, cols, vec != 0, t);
    }
#pragma unroll
    for (int q = 0; q < kGroups; ++q) {
      const int o = hopper::core_offset(rows[q] - i0, ks[q], kKg);
      hopper::split8(t[q], Ahi + o, Alo + o);
    }
    hopper::fence_proxy_async();
    __syncthreads();
    hopper::mbar_wait(&bar[s], (c >> 1) & 1);
    // the chunk's two k16 steps, small terms first
    hopper::fence_operands(d);
    hopper::wgmma_fence();
#pragma unroll
    for (int k = 0; k < kChunk / 16; ++k) {
      const int ka = 128 * k;                        // two core matrices along K
      const int kb = g * kCols * kChunk + 128 * k;   // the warpgroup's columns
      const uint64_t ahi = hopper::wgmma_desc(Ahi + ka, kLbo, kSbo);
      const uint64_t alo = hopper::wgmma_desc(Alo + ka, kLbo, kSbo);
      const uint64_t bhi = hopper::wgmma_desc(B + kb, kLbo, kSbo);
      if constexpr (S::kParts == 2) {
        const uint64_t blo = hopper::wgmma_desc(B + kNB * kChunk + kb, kLbo, kSbo);
        hopper::wgmma_bf16<kCols>(d, alo, blo, 1);
        hopper::wgmma_bf16<kCols>(d, alo, bhi, 1);
        hopper::wgmma_bf16<kCols>(d, ahi, blo, 1);
      } else {
        hopper::wgmma_bf16<kCols>(d, alo, bhi, 1);
      }
      hopper::wgmma_bf16<kCols>(d, ahi, bhi, 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();   // chunk c - 1's products are done: its stage is free
    hopper::fence_operands(d);
    __syncthreads();
    if (tid == 0 && c + 1 < nc) {
      hopper::mbar_arrive_expect_tx(&bar[s ^ 1], kBBytes);
      hopper::bulk_load(stage0 + (s ^ 1) * S::kElems, op_cb + static_cast<long long>(c + 1) * S::kB,
                        kBBytes, &bar[s ^ 1]);
    }
  }
  hopper::wgmma_wait<0>();
  hopper::fence_operands(d);

  const int t = tid % kWarpgroup, w = t / 32, l = t % 32;
  const int j0 = cb * kNB + g * kCols + 2 * (l % 4);
#pragma unroll
  for (int i = 0; i < kCols / 2; i += 2) {
    const int row = i0 + 16 * w + l / 4 + 8 * ((i / 2) % 2);
    const int col = j0 + 8 * (i / 4);
    if (row >= Hd || col >= Wd) continue;
    T* o = out + (f * Hd + row) * static_cast<long long>(Wd) + col;
    if (col + 1 < Wd) {
      store2(o, d[i], d[i + 1], pairs != 0);
    } else {
      store1(o, d[i]);
    }
  }
}

struct Args {
  const void *frames, *ys, *wy, *row_base, *ops;
  void* out;
  int F, H, W, Hd, Wd, ky, SY;
};

// the instance <T, NW, kWindow> on `fmap` (kWindow) or `frames`
template <typename T, int NW, bool kWindow>
int launch(const Args& a, const CUtensorMap& fmap, int vec, cudaStream_t stream) {
  using S = Stage<T, NW>;
  const int n_rt = (a.Hd + kRows - 1) / kRows;
  const int n_cb = (a.Wd + NW * kCols - 1) / (NW * kCols);
  const int nc = (a.W + kChunk - 1) / kChunk;
  const long long blocks = static_cast<long long>(a.F) * n_rt * n_cb;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int pairs = a.Wd % 2 == 0 && reinterpret_cast<uintptr_t>(a.out) % (2 * sizeof(T)) == 0;
  const size_t smem = S::kSmem + (kWindow ? 2 * window_bytes<T>(a.SY) : 0);
  static std::atomic<int> opted_in[stage::kMaxDevices];   // this instance's limit per device
  auto kern = dense_x_kernel<T, NW, kWindow>;
  if (const int e = stage::opt_in(reinterpret_cast<const void*>(kern), static_cast<long long>(smem),
                                  opted_in)) {
    return e;
  }
  kern<<<static_cast<unsigned>(blocks), NW * kWarpgroup, smem, stream>>>(
      fmap, static_cast<const T*>(a.frames), static_cast<T*>(a.out), static_cast<const int*>(a.ys),
      static_cast<const float*>(a.wy), static_cast<const int*>(a.row_base),
      static_cast<const __nv_bfloat16*>(a.ops), a.H, a.W, a.Hd, a.Wd, a.ky, a.SY, n_rt, n_cb, nc,
      vec, pairs);
  return static_cast<int>(cudaGetLastError());
}

// the window instance where a box can take the tile's rows and both
// windows fit beside the stages; the global-memory one otherwise
template <typename T, int NW>
int launch_either(const Args& a, int window_budget, cudaStream_t s) {
  const int vec = (static_cast<long long>(a.W) * sizeof(T)) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(a.frames) % 16 == 0;
  CUtensorMap fmap{};
  if (vec && a.SY <= kMaxWindowRows &&
      static_cast<long long>(2 * window_bytes<T>(a.SY)) <= window_budget) {
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(a.W), static_cast<cuuint64_t>(a.H),
                                static_cast<cuuint64_t>(a.F)};
    const cuuint64_t strides[2] = {sizeof(T) * static_cast<cuuint64_t>(a.W),
                                   sizeof(T) * static_cast<cuuint64_t>(a.W) * a.H};
    const cuuint32_t box[3] = {kChunk, static_cast<cuuint32_t>(a.SY), 1};
    const int rc = hopper::encode_tiled(
        &fmap, std::is_same<T, float>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                             : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
        3, a.frames, dims, strides, box);
    if (rc != 0) return rc;
    return launch<T, NW, true>(a, fmap, vec, s);
  }
  return launch<T, NW, false>(a, fmap, vec, s);
}



}  // namespace

// frames (F, H, W) and out (F, Hd, Wd) in the frame dtype (dtype_code 0 =
// float32, 1 = bfloat16), contiguous; ys (Hd,) int32 and wy (Hd, ky) f32,
// kernel 1's y tables; row_base (ceil(Hd / 64),) int32 and SY: each
// 64-row tile's first tap row and the rows every tile's taps span
// (cuda_apply._tiles); ops the packed operator of (Wd + 208 NW - 1) /
// (208 NW) column blocks x (W + 31) / 32 chunks, each 2 parts (f32) or 1
// (bf16) of 208 NW x 32 bf16 in core matrices (band_probes.pack_dense_x),
// 16-byte aligned; warpgroups NW: 2 for float32, 1 for bfloat16 (the
// instances built; band_probes.DENSE_WARPGROUPS); window_budget: the bytes of
// shared memory the two windows may take (0: the y pass reads global
// memory).
extern "C" int aainterp_dense_x(const void* frames, void* out, const void* ys, const void* wy,
                                const void* row_base, const void* ops, int F, int H, int W,
                                int Hd, int Wd, int ky, int SY, int warpgroups, int window_budget,
                                int dtype_code, void* stream) {
  if (F <= 0 || H <= 0 || W <= 0 || Hd <= 0 || Wd <= 0 || ky <= 0 || SY < ky ||
      window_budget < 0 || reinterpret_cast<uintptr_t>(ops) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{frames, ys, wy, row_base, ops, out, F, H, W, Hd, Wd, ky, SY};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case 0:
      if (warpgroups == 2) return launch_either<float, 2>(a, window_budget, s);
      break;
    case 1:
      if (warpgroups == 1) return launch_either<__nv_bfloat16, 1>(a, window_budget, s);
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
