// The Mosaic watchlist's probes for Hopper (sm_90a): six small kernels, each
// computing the function of one probe of benchmarks/mosaic_watchlist.py with
// the Hopper feature that the probe's parked design needs on this card, from
// the primitives of csrc/hopper.cuh.
//
// Replaces (benchmarks/mosaic_watchlist.py, pallas_call at the line given):
//   strided_y_bf16  probe_strided_y_bf16 (:67)  out[i, j] = f32(x[f, i, p, j]): one
//                   parity p of a size-m axis; a 4-D TMA box 1 wide on that axis
//   strided_load    probe_strided_load (:87)    out = x[:, ::2]; 2-D TMA tiles, then a
//                   stride-2 read of shared memory
//   value_slice     probe_value_slice (:103)    out = x[:, ::2] + x[:, 1::2]; a 16-byte
//                   load per thread, the pair sums in registers (sm_80 is enough)
//   unaligned_dma   probe_unaligned_dma (:122)  out = x[r0:r0 + n, :] for rows of any
//                   16-byte multiple; rows cut into pieces of whole 16-byte chunks,
//                   one block a piece: a 1-D bulk copy onto an mbarrier, a bulk
//                   store back
//   high_dot        probe_high_dot (:144)       a @ b at bf16x3 (Precision.HIGH):
//                   hi*hi + hi*lo + lo*hi with hi = bf16(a), lo = bf16(a - hi), f32
//                   sums, on wgmma m64n128k16
//   vpu_dyn_rows    probe_vpu_dyn_rows (:171)   out[r] = x[off[r]] + x[off[r] + 1] at
//                   offsets the block reads itself
//
// What bounds them: launch cost.  At JAX's shapes each moves at most 2.8 MB
// (a bytes bound under 1 us) and high_dot's three bf16 products are 12.6
// MFLOP on the tensor cores; so each is one launch, spread over enough
// blocks that latency and not one SM sets its time, and what it tests is
// that the feature builds, launches and gives its plain version's result
// (probes/mosaic_watchlist.py holds each against it).
//
// Plain C interface for ctypes; each launch goes on the caller's stream and
// does not synchronise.  Each entry returns cudaGetLastError() after the
// launch (0 on success), cudaErrorInvalidValue for arguments it does not
// take, or hopper::kEncodeError + the CUresult where a tensor map fails to
// encode.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <climits>
#include <utility>

#include "hopper.cuh"
#include "stage_common.cuh"

namespace {

constexpr int kThreads = 256;

// `p` advanced to the next multiple of `align` bytes of the shared window
template <int align>
__device__ __forceinline__ unsigned char* aligned(unsigned char* p) {
  return p + ((align - (hopper::smem_u32(p) & (align - 1))) & (align - 1));
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// ---- strided_y_bf16 ------------------------------------------------------------
// x (frames, rows, m, C) bf16 as a 4-D map (C, m, rows, frames); each block
// loads one box {bc, 1, br, 1} at (c0, parity, r0, frame): br rows of bc
// values of one parity, landing densely, then converts them to f32.

__global__ void __launch_bounds__(kThreads)
    strided_y_kernel(const __grid_constant__ CUtensorMap xmap, float* __restrict__ out, int R,
                     int C, int frame, int parity, int bc, int br) {
  extern __shared__ unsigned char raw[];
  unsigned char* base = aligned<128>(raw);
  const __nv_bfloat16* tile = reinterpret_cast<const __nv_bfloat16*>(base);
  const uint32_t box_bytes = static_cast<uint32_t>(bc) * br * 2;
  uint64_t* bar = reinterpret_cast<uint64_t*>(base + box_bytes);
  const int c0 = blockIdx.x * bc, r0 = blockIdx.y * br;
  if (threadIdx.x == 0) {
    hopper::mbar_init(bar, 1);
    hopper::fence_mbarrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    hopper::mbar_arrive_expect_tx(bar, box_bytes);
    hopper::tma_load_4d(const_cast<__nv_bfloat16*>(tile), &xmap, c0, parity, r0, frame, bar);
  }
  hopper::mbar_wait(bar, 0);
  const int rows = min(br, R - r0), cols = min(bc, C - c0);
  for (int e = threadIdx.x; e < rows * bc; e += kThreads) {
    const int r = e / bc, c = e - r * bc;
    if (c < cols) out[static_cast<long long>(r0 + r) * C + c0 + c] = __bfloat162float(tile[e]);
  }
}

// ---- strided_load ----------------------------------------------------------------
// x (R, W) f32 as a 2-D map; each block loads a box of br rows x bc columns
// and writes the box's even columns.

__global__ void __launch_bounds__(kThreads)
    strided_load_kernel(const __grid_constant__ CUtensorMap xmap, float* __restrict__ out, int R,
                        int W, int bc, int br) {
  extern __shared__ unsigned char raw[];
  unsigned char* base = aligned<128>(raw);
  const float* tile = reinterpret_cast<const float*>(base);
  const uint32_t box_bytes = static_cast<uint32_t>(bc) * br * 4;
  uint64_t* bar = reinterpret_cast<uint64_t*>(base + box_bytes);
  const int c0 = blockIdx.x * bc, r0 = blockIdx.y * br;
  if (threadIdx.x == 0) {
    hopper::mbar_init(bar, 1);
    hopper::fence_mbarrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    hopper::mbar_arrive_expect_tx(bar, box_bytes);
    hopper::tma_load_2d(const_cast<float*>(tile), &xmap, c0, r0, bar);
  }
  hopper::mbar_wait(bar, 0);
  const int Wo = W / 2, half = bc / 2;
  const int rows = min(br, R - r0), cols = min(half, Wo - c0 / 2);
  for (int e = threadIdx.x; e < rows * half; e += kThreads) {
    const int r = e / half, c = e - r * half;
    if (c < cols) out[static_cast<long long>(r0 + r) * Wo + c0 / 2 + c] = tile[r * bc + 2 * c];
  }
}

// ---- value_slice -----------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
    value_slice_kernel(const float4* __restrict__ x, float2* __restrict__ out, long long n4) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n4) {
    const float4 v = x[i];
    out[i] = make_float2(v.x + v.y, v.z + v.w);
  }
}

// ---- unaligned_dma ---------------------------------------------------------------
// Each row of W floats is cut into pieces of whole 16-byte chunks, at most
// kPieceBytes each (the last piece of a row may be shorter), and each block,
// one warp, moves one piece: one 1-D bulk copy into shared memory that
// completes on an mbarrier, then one bulk store.  JAX's 16 rows of 14,400
// bytes are 16 x 8 pieces (7 of 1,808 bytes and one of 1,744), 128 blocks
// spread over the card, so the time is one piece's load latency and not
// one SM's chain of 230,400 bytes.  A piece is far below the 48 KB of
// dynamic shared memory a block has without an opt-in.

constexpr int kPieceBytes = 2048;

__global__ void __launch_bounds__(32)
    row_dma_kernel(const float* __restrict__ x, float* __restrict__ out, int r0, int W,
                   int pieces, int piece_floats) {
  extern __shared__ unsigned char raw[];
  unsigned char* base = aligned<16>(raw);
  const int row = blockIdx.x / pieces;
  const int first = (blockIdx.x % pieces) * piece_floats;
  const uint32_t bytes = 4u * static_cast<uint32_t>(min(piece_floats, W - first));
  uint64_t* bar = reinterpret_cast<uint64_t*>(base + 4 * piece_floats);
  if (threadIdx.x == 0) {
    hopper::mbar_init(bar, 1);
    hopper::fence_mbarrier_init();
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  hopper::mbar_arrive_expect_tx(bar, bytes);
  hopper::bulk_load(base, x + static_cast<long long>(r0 + row) * W + first, bytes, bar);
  hopper::mbar_wait(bar, 0);
  hopper::fence_proxy_async();
  hopper::bulk_store(out + static_cast<long long>(row) * W + first, base, bytes);
  hopper::bulk_commit();
  hopper::bulk_wait_all();
}

// ---- high_dot --------------------------------------------------------------------
// One block of two warpgroups per 128 x 128 tile of out: the block splits its
// 128 rows of a and 128 columns of b into hi and lo bf16 in shared memory, in
// K-major core matrices (b stored as b^T: row n holds column n of b), core
// matrix (r / 8, k / 8) at ((r / 8) * (K / 8) + k / 8) * 128 bytes; then
// warpgroup g takes rows 64 g .. 64 g + 63 through K / 16 steps of three
// wgmma each, lo*hi, hi*lo, hi*hi, into one f32 accumulator.  K is a
// template argument: around a loop of a runtime trip count ptxas serialises
// the wgmma (warning C7520), so the steps are unrolled at compile time, one
// instance per K that fits the opt-in.

constexpr int kTile = 128;
constexpr int kMaxKSteps = 14;    // K <= 224: 4 * 128 * 224 bf16 = 229,376 B

// the element offset of (row r, column k) in the core-matrix layout
__device__ __forceinline__ int core_offset(int r, int k, int kg) {
  return ((r >> 3) * kg + (k >> 3)) * 64 + (r & 7) * 8 + (k & 7);
}

// 8 values along K split into hi and lo, one 16-byte store each
__device__ __forceinline__ void split8(const float (&v)[8], __nv_bfloat16* hi, __nv_bfloat16* lo) {
  __align__(16) __nv_bfloat16 h[8], l[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    h[j] = __float2bfloat16_rn(v[j]);
    l[j] = __float2bfloat16_rn(v[j] - __bfloat162float(h[j]));
  }
  *reinterpret_cast<uint4*>(hi) = *reinterpret_cast<const uint4*>(h);
  *reinterpret_cast<uint4*>(lo) = *reinterpret_cast<const uint4*>(l);
}

template <int K>
__global__ void __launch_bounds__(2 * kTile)
    high_dot_kernel(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ out,
                    int N) {
  extern __shared__ unsigned char raw[];
  __nv_bfloat16* ops = reinterpret_cast<__nv_bfloat16*>(aligned<128>(raw));
  const int tile = kTile * K;                      // elements of one operand
  __nv_bfloat16 *ahi = ops, *alo = ops + tile, *bhi = ops + 2 * tile, *blo = ops + 3 * tile;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  constexpr int kg = K / 8;
  for (int e = threadIdx.x; e < kTile * kg; e += 2 * kTile) {   // a: k groups fastest
    const int r = e / kg, k = 8 * (e - r * kg);
    const float4* src = reinterpret_cast<const float4*>(a + static_cast<long long>(m0 + r) * K + k);
    const float4 p = src[0], q = src[1];
    const float v[8] = {p.x, p.y, p.z, p.w, q.x, q.y, q.z, q.w};
    split8(v, ahi + core_offset(r, k, kg), alo + core_offset(r, k, kg));
  }
  for (int e = threadIdx.x; e < kg * kTile; e += 2 * kTile) {   // b: columns fastest
    const int k = 8 * (e / kTile), n = e % kTile;
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = b[static_cast<long long>(k + j) * N + n0 + n];
    split8(v, bhi + core_offset(n, k, kg), blo + core_offset(n, k, kg));
  }
  hopper::fence_proxy_async();
  __syncthreads();

  // warpgroup: rows 64 g ..; read from lane 0 so the compiler sees it uniform
  const int g = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / kTile, 0);
  constexpr uint32_t lbo = 128, sbo = 128u * kg;   // bytes along K, along M / N
  const int a_rows = g * 64 * K;                   // element offset of its 64 rows
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.0f;
  hopper::fence_operands(d);
  hopper::wgmma_fence();
#pragma unroll
  for (int s = 0; s < K / 16; ++s) {
    const int ka = a_rows + 128 * s, kb = 128 * s;  // 16 K = two core matrices = 256 B
    hopper::wgmma_m64n128k16_bf16(d, hopper::wgmma_desc(alo + ka, lbo, sbo),
                                  hopper::wgmma_desc(bhi + kb, lbo, sbo), 1);
    hopper::wgmma_m64n128k16_bf16(d, hopper::wgmma_desc(ahi + ka, lbo, sbo),
                                  hopper::wgmma_desc(blo + kb, lbo, sbo), 1);
    hopper::wgmma_m64n128k16_bf16(d, hopper::wgmma_desc(ahi + ka, lbo, sbo),
                                  hopper::wgmma_desc(bhi + kb, lbo, sbo), 1);
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_operands(d);
  const int t = threadIdx.x % kTile, w = t / 32, l = t % 32;
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int row = m0 + 64 * g + 16 * w + l / 4 + 8 * ((i / 2) % 2);
    const int col = n0 + 8 * (i / 4) + 2 * (l % 4);
    *reinterpret_cast<float2*>(out + static_cast<long long>(row) * N + col) = make_float2(d[i], d[i + 1]);
  }
}

// ---- vpu_dyn_rows ----------------------------------------------------------------
// One thread per column; the block reads the R offsets into shared memory
// once.  An offset outside [0, rows - 2] gives a NaN row.

__global__ void __launch_bounds__(kThreads)
    dyn_rows_kernel(const float* __restrict__ x, const int* __restrict__ off, float* __restrict__ out,
                    int rows, int C, int R) {
  extern __shared__ int soff[];
  for (int r = threadIdx.x; r < R; r += kThreads) soff[r] = off[r];
  __syncthreads();
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  for (int r = 0; r < R; ++r) {
    const int o = soff[r];
    float v = __int_as_float(0x7fc00000);
    if (o >= 0 && o < rows - 1) {
      v = x[static_cast<long long>(o) * C + c] + x[static_cast<long long>(o + 1) * C + c];
    }
    out[static_cast<long long>(r) * C + c] = v;
  }
}

inline int launched() { return static_cast<int>(cudaGetLastError()); }

template <int K>
int launch_high_dot(const float* a, const float* b, float* out, int M, int N, cudaStream_t stream) {
  static std::atomic<int> opted_in[stage::kMaxDevices];   // this instance's limit per device
  const long long smem = 128 + 4ll * kTile * K * 2;
  const int rc = stage::opt_in(reinterpret_cast<const void*>(high_dot_kernel<K>), smem, opted_in);
  if (rc != 0) return rc;
  high_dot_kernel<K><<<dim3(N / kTile, M / kTile), 2 * kTile, static_cast<size_t>(smem), stream>>>(
      a, b, out, N);
  return launched();
}

// the instance of K = 16 (s + 1), s < kMaxKSteps
template <int... S>
int dispatch_high_dot(std::integer_sequence<int, S...>, int K, const float* a, const float* b,
                      float* out, int M, int N, cudaStream_t stream) {
  int rc = static_cast<int>(cudaErrorInvalidValue);
  (void)((K == 16 * (S + 1) && (rc = launch_high_dot<16 * (S + 1)>(a, b, out, M, N, stream), true)) ||
         ...);
  return rc;
}

}  // namespace

// x (frames, rows, m, C) bf16, out (R, C) f32 = x[frame, :R, parity, :];
// C a multiple of 8 (the 16-byte stride a tensor map needs), x 16-byte aligned.
extern "C" int aainterp_strided_y_bf16(const void* x, void* out, int frames, int rows, int m, int C,
                                       int frame, int parity, int R, void* stream) {
  if (frames <= 0 || rows <= 0 || m <= 0 || C <= 0 || C % 8 != 0 || frame < 0 ||
      frame >= frames || parity < 0 || parity >= m || R <= 0 || R > rows || !aligned16(x)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int bc = C < 256 ? C : 256, br = R < 64 ? R : 64;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(m),
                              static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(frames)};
  const cuuint64_t strides[3] = {2ull * C, 2ull * C * m, 2ull * C * m * rows};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(bc), 1, static_cast<cuuint32_t>(br), 1};
  CUtensorMap map;
  const int rc = hopper::encode_tiled(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, x, dims, strides, box);
  if (rc != 0) return rc;
  const dim3 grid((C + bc - 1) / bc, (R + br - 1) / br);
  const size_t smem = 128 + static_cast<size_t>(bc) * br * 2 + 8;
  strided_y_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      map, static_cast<float*>(out), R, C, frame, parity, bc, br);
  return launched();
}

// x (R, W) f32, out (R, W / 2) = x[:, ::2]; W a multiple of 4, x 16-byte aligned.
extern "C" int aainterp_strided_load(const void* x, void* out, int R, int W, void* stream) {
  if (R <= 0 || W <= 0 || W % 4 != 0 || !aligned16(x)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int bc = W < 256 ? W : 256, br = R < 32 ? R : 32;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(W), static_cast<cuuint64_t>(R)};
  const cuuint64_t strides[1] = {4ull * W};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(bc), static_cast<cuuint32_t>(br)};
  CUtensorMap map;
  const int rc = hopper::encode_tiled(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, x, dims, strides, box);
  if (rc != 0) return rc;
  const dim3 grid((W + bc - 1) / bc, (R + br - 1) / br);
  const size_t smem = 128 + static_cast<size_t>(bc) * br * 4 + 8;
  strided_load_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      map, static_cast<float*>(out), R, W, bc, br);
  return launched();
}

// x (R, W) f32, out (R, W / 2) = x[:, ::2] + x[:, 1::2]; W a multiple of 4,
// both 16-byte aligned.
extern "C" int aainterp_value_slice(const void* x, void* out, int R, int W, void* stream) {
  if (R <= 0 || W <= 0 || W % 4 != 0 || !aligned16(x) || !aligned16(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n4 = static_cast<long long>(R) * W / 4;
  const long long blocks = (n4 + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  value_slice_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<float2*>(out), n4);
  return launched();
}

// x (H, W) f32, out (n, W) = x[r0:r0 + n, :]; W a multiple of 4 (rows of
// whole 16-byte chunks), both 16-byte aligned; one block per piece of a row
// (row_dma_kernel), n x ceil(4 W / kPieceBytes) blocks.
extern "C" int aainterp_unaligned_dma(const void* x, void* out, int H, int W, int r0, int n,
                                      void* stream) {
  if (H <= 0 || W <= 0 || W % 4 != 0 || r0 < 0 || n <= 0 || r0 + n > H || !aligned16(x) ||
      !aligned16(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int chunks = W / 4;                                   // 16-byte chunks a row
  const int per = (4 * W + kPieceBytes - 1) / kPieceBytes;    // pieces a row at most
  const int piece_chunks = (chunks + per - 1) / per;
  const int pieces = (chunks + piece_chunks - 1) / piece_chunks;  // none empty
  const long long blocks = static_cast<long long>(n) * pieces;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = 16 * static_cast<size_t>(piece_chunks) + 16 + 8;  // slack, mbarrier
  row_dma_kernel<<<static_cast<unsigned>(blocks), 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), r0, W, pieces, 4 * piece_chunks);
  return launched();
}

// a (M, K), b (K, N), out (M, N) f32, row-major: out = a @ b at bf16x3; M and
// N multiples of 128, K a multiple of 16 up to 224; a and out 16-byte
// aligned.
extern "C" int aainterp_high_dot(const void* a, const void* b, void* out, int M, int N, int K,
                                 void* stream) {
  if (M <= 0 || N <= 0 || M % kTile != 0 || N % kTile != 0 || !aligned16(a) || !aligned16(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dispatch_high_dot(std::make_integer_sequence<int, kMaxKSteps>(), K,
                           static_cast<const float*>(a), static_cast<const float*>(b),
                           static_cast<float*>(out), M, N, static_cast<cudaStream_t>(stream));
}

// x (rows, C) f32, off (R,) int32, out (R, C) = x[off] + x[off + 1].
extern "C" int aainterp_vpu_dyn_rows(const void* x, const void* off, void* out, int rows, int C, int R,
                                     void* stream) {
  if (rows < 2 || C <= 0 || R <= 0 || static_cast<long long>(R) * 4 > static_cast<long long>(stage::kDefaultSmem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (C + kThreads - 1) / kThreads;
  dyn_rows_kernel<<<blocks, kThreads, static_cast<size_t>(R) * 4, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(off), static_cast<float*>(out), rows, C, R);
  return launched();
}
