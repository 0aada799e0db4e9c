// The Mosaic watchlist's probes for Hopper (sm_90a): six small kernels, each
// computing the function of one probe of benchmarks/mosaic_watchlist.py with
// the Hopper feature that the probe's parked design needs on this card, from
// the primitives of csrc/hopper.cuh.
//
// Replaces (benchmarks/mosaic_watchlist.py, pallas_call at the line given):
//   strided_y_bf16  probe_strided_y_bf16 (:67)  out[i, j] = f32(x[f, i, p, j]): one
//                   parity p of a size-m axis; a 4-D TMA box 1 wide on that axis,
//                   one block per box of one row x 256 columns, 16-byte stores
//   strided_load    probe_strided_load (:87)    out = x[:, ::2]; 2-D TMA windows of 4
//                   rows x 256 columns, one block each, then a stride-2 read of
//                   shared memory into 16-byte stores
//   value_slice     probe_value_slice (:103)    out = x[:, ::2] + x[:, 1::2]; a 16-byte
//                   load per thread, the pair sums in registers (sm_80 is enough)
//   unaligned_dma   probe_unaligned_dma (:122)  out = x[r0:r0 + n, :] for rows of any
//                   16-byte multiple; rows cut into pieces of whole 16-byte chunks,
//                   one block a piece: a 1-D bulk copy onto an mbarrier, a bulk
//                   store back
//   high_dot        probe_high_dot (:144)       a @ b at bf16x3 (Precision.HIGH):
//                   hi*hi + hi*lo + lo*hi with hi = bf16(a), lo = bf16(a - hi), f32
//                   sums, on wgmma m64n32k16: 64 x 32 tiles, K through a
//                   four-stage ring of TMA boxes
//   vpu_dyn_rows    probe_vpu_dyn_rows (:171)   out[r] = x[off[r]] + x[off[r] + 1] at
//                   offsets the block reads itself
//
// What bounds them: launch cost and one load's latency.  At JAX's shapes
// each moves at most 2.8 MB (a bytes bound under 1 us) and high_dot's three
// bf16 products are 12.6 MFLOP on the tensor cores; so each is one launch,
// spread over enough blocks that each block waits for one small load and no
// SM runs a chain of them (strided_load: 450 windows of 4 KB, where 60 of
// 32 KB left 72 SMs idle; strided_y_bf16: 16 boxes of 512 bytes, where one
// block loaded all 8 KB and stored 4,096 values one at a time), and what it
// tests is that the feature builds, launches and gives its plain version's
// result (probes/mosaic_watchlist.py holds each against it).
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
// x (frames, rows, m, C) bf16 as a 4-D map (C, m, rows, frames).  The output
// is cut into boxes of kYRows rows x at most kYCols columns, one block each
// (JAX's 16 x 256: 16 blocks, where one block waited for the whole box on one
// SM): thread 0 loads the block's box {bc, 1, br, 1} at (c0, parity, r0,
// frame), br rows of bc values of one parity landing densely, onto an
// mbarrier; then each thread widens four bf16 values of it (one 8-byte shared
// read) to f32 and writes them with one 16-byte store.

constexpr int kYRows = 1, kYCols = 256;
constexpr int kYThreads = kYRows * kYCols / 4;   // a group of 4 values a thread

__global__ void __launch_bounds__(kYThreads)
    strided_y_kernel(const __grid_constant__ CUtensorMap xmap, float* __restrict__ out, int R, int C,
                     int frame, int parity, int bc, int br, int col_blocks) {
  extern __shared__ unsigned char raw[];
  unsigned char* base = aligned<128>(raw);
  const __nv_bfloat16* tile = reinterpret_cast<const __nv_bfloat16*>(base);
  const uint32_t box_bytes = static_cast<uint32_t>(bc) * br * 2;
  uint64_t* bar = reinterpret_cast<uint64_t*>(base + box_bytes);
  const int c0 = (blockIdx.x % col_blocks) * bc, r0 = (blockIdx.x / col_blocks) * br;
  if (threadIdx.x == 0) {   // the issuing thread itself orders its init before the copy
    hopper::mbar_init(bar, 1);
    hopper::fence_mbarrier_init();
    hopper::mbar_arrive_expect_tx(bar, box_bytes);
    hopper::tma_load_4d(const_cast<__nv_bfloat16*>(tile), &xmap, c0, parity, r0, frame, bar);
  }
  __syncthreads();   // the barrier is initialised before any thread waits on it
  const int gc = bc / 4, rows = min(br, R - r0);   // groups a box row
  hopper::mbar_wait(bar, 0);
  for (int e = threadIdx.x; e < rows * gc; e += kYThreads) {
    const int r = e / gc, q = e - r * gc;
    if (c0 + 4 * q >= C) continue;
    // bf16 -> f32 is exact: the 16 bits move to the top of the word
    const uint2 u = *reinterpret_cast<const uint2*>(tile + r * bc + 4 * q);
    const float4 v = make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xFFFF0000u),
                                 __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xFFFF0000u));
    *reinterpret_cast<float4*>(out + static_cast<long long>(r0 + r) * C + c0 + 4 * q) = v;
  }
}

// ---- strided_load ----------------------------------------------------------------
// x (R, W) f32 as a 2-D map; the output is cut into windows of kLoadRows rows
// x at most kLoadCols input columns, one block each (JAX's (120, 3840): 30 x
// 15 = 450 blocks, where windows of 32 rows left 72 SMs idle).  Thread 0
// loads the window as one box onto an mbarrier (a box a row, each on its own
// mbarrier so that the first rows could be stored while the last ones land,
// was slower: each further TMA issue costs more than it overlaps); then each
// thread reads a group of 8 columns (two 16-byte shared reads) and writes
// its 4 even ones with one 16-byte store.  Where W / 2 is not a multiple of
// 4, odd rows of out are not 16-byte aligned and a row's last group holds 2
// columns: 8-byte stores there, and no shared read past the window's row.

constexpr int kLoadRows = 4, kLoadCols = 256;
constexpr int kLoadThreads = kLoadRows * kLoadCols / 8;   // a group of 8 columns a thread

__global__ void __launch_bounds__(kLoadThreads)
    strided_load_kernel(const __grid_constant__ CUtensorMap xmap, float* __restrict__ out, int R, int W,
                        int bc, int br, int col_blocks) {
  extern __shared__ unsigned char raw[];
  unsigned char* base = aligned<128>(raw);
  const float* win = reinterpret_cast<const float*>(base);
  const uint32_t win_bytes = static_cast<uint32_t>(bc) * br * 4;
  uint64_t* bar = reinterpret_cast<uint64_t*>(base + win_bytes);
  const int c0 = (blockIdx.x % col_blocks) * bc, r0 = (blockIdx.x / col_blocks) * br;
  if (threadIdx.x == 0) {   // the issuing thread itself orders its init before the copy
    hopper::mbar_init(bar, 1);
    hopper::fence_mbarrier_init();
    hopper::mbar_arrive_expect_tx(bar, win_bytes);
    hopper::tma_load_2d(base, &xmap, c0, r0, bar);
  }
  __syncthreads();   // the barrier is initialised before any thread waits on it
  const int Wo = W / 2, gc = (bc + 7) / 8, rows = min(br, R - r0);   // groups a window row
  hopper::mbar_wait(bar, 0);
  for (int e = threadIdx.x; e < rows * gc; e += kLoadThreads) {
    const int r = e / gc, g = e - r * gc;
    const int oc = c0 / 2 + 4 * g;   // the group's first output column
    if (oc >= Wo) continue;
    const float* p = win + r * bc + 8 * g;
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = 8 * g + 8 <= bc ? *reinterpret_cast<const float4*>(p + 4) : a;
    float* o = out + static_cast<long long>(r0 + r) * Wo + oc;
    if (oc + 4 <= Wo && (reinterpret_cast<uintptr_t>(o) & 15) == 0) {
      *reinterpret_cast<float4*>(o) = make_float4(a.x, a.z, b.x, b.z);
    } else {
      *reinterpret_cast<float2*>(o) = make_float2(a.x, a.z);
      if (oc + 4 <= Wo) *reinterpret_cast<float2*>(o + 2) = make_float2(b.x, b.z);
    }
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
// One warpgroup per 64 x 32 tile of out (JAX's 128 x 128: 8 blocks, where
// one block of the whole tile ran its loads, split and products one after
// another on one SM).  K comes in chunks of 32 through a ring of four
// stages: thread 0 issues a chunk's two TMA boxes onto the stage's
// mbarrier (a: 64 rows x 32 K, b: 32 K rows x 32 columns, f32, zeros out
// of bounds); the threads split the chunk into hi and lo bf16 in K-major
// core matrices (b^T: column n of b as row n, transposed as it is
// written), issue its wgmma m64n32k16, lo*hi, hi*lo, hi*hi per 16 K, into
// one f32 accumulator, and split the next chunk while they run;
// wgmma_wait<1> before a stage's bf16 is written again.  Four stages: at
// JAX's K = 128 every box is in flight from the start.  The chunk loop's
// trip count is K's, at run time; the accumulator is never zeroed by other
// instructions (the first product scales it by 0), so ptxas keeps the
// products asynchronous.


constexpr int kDotRows = 64, kDotCols = 32, kDotK = 32, kDotStages = 4;
constexpr int kDotKg = kDotK / 8;                            // core matrices along K
constexpr uint32_t kDotAF = 4 * kDotRows * kDotK;            // a's f32 box, bytes
constexpr uint32_t kDotBF = 4 * kDotK * kDotCols;            // b's f32 box
constexpr int kDotAH = kDotRows * kDotK, kDotBH = kDotCols * kDotK;  // bf16 elements
constexpr uint32_t kDotStage = kDotAF + kDotBF + 2 * 2 * (kDotAH + kDotBH);
constexpr size_t kDotSmem = 128 + kDotStages * static_cast<size_t>(kDotStage) + 8 * kDotStages;

__global__ void __launch_bounds__(128)
    high_dot_kernel(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap,
                    float* __restrict__ out, int M, int N, int K) {
  extern __shared__ unsigned char raw[];
  unsigned char* base = aligned<128>(raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(base + kDotStages * kDotStage);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kDotRows, n0 = blockIdx.x * kDotCols;
  const int nc = (K + kDotK - 1) / kDotK;
  if (tid == 0) {
    for (int s = 0; s < kDotStages; ++s) hopper::mbar_init(&bar[s], 1);
    hopper::fence_mbarrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    for (int c = 0; c < kDotStages && c < nc; ++c) {
      unsigned char* st = base + c * kDotStage;
      hopper::mbar_arrive_expect_tx(&bar[c], kDotAF + kDotBF);
      hopper::tma_load_2d(st, &amap, c * kDotK, m0, &bar[c]);
      hopper::tma_load_2d(st + kDotAF, &bmap, n0, c * kDotK, &bar[c]);
    }
  }
  float d[kDotCols / 2];   // set by the first product (scale_d 0)
  for (int c = 0; c < nc; ++c) {
    const int s = c % kDotStages;
    unsigned char* st = base + s * kDotStage;
    const float* af = reinterpret_cast<const float*>(st);             // (64, 32) row-major
    const float* bf = reinterpret_cast<const float*>(st + kDotAF);    // (32 K, 32) row-major
    __nv_bfloat16* ahi = reinterpret_cast<__nv_bfloat16*>(st + kDotAF + kDotBF);
    __nv_bfloat16 *alo = ahi + kDotAH, *bhi = alo + kDotAH, *blo = bhi + kDotBH;
    hopper::mbar_wait(&bar[s], (c / kDotStages) & 1);
    // a: group e is row 8 (e / 32) + (e % 32) / 4, K 8 (e % 4) .. + 7:
    // four lanes read a row's 128 bytes, a warp 1 KB without bank conflicts
#pragma unroll
    for (int e = tid; e < kDotRows * kDotKg; e += 128) {
      const int r = 8 * (e / 32) + (e % 32) / 4, k = 8 * (e % 4);
      const float4 p = *reinterpret_cast<const float4*>(af + r * kDotK + k);
      const float4 q = *reinterpret_cast<const float4*>(af + r * kDotK + k + 4);
      const float v[8] = {p.x, p.y, p.z, p.w, q.x, q.y, q.z, q.w};
      const int o = hopper::core_offset(r, k, kDotKg);
      hopper::split8(v, ahi + o, alo + o);
    }
    // b^T: group tid is column n = tid % 32, K 8 (tid / 32) .. + 7: a
    // warp's 32 columns of one K row in each read
    {
      const int n = tid % 32, k = 8 * (tid / 32);
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = bf[(k + j) * kDotCols + n];
      const int o = hopper::core_offset(n, k, kDotKg);
      hopper::split8(v, bhi + o, blo + o);
    }
    hopper::fence_proxy_async();
    __syncthreads();   // the f32 stage is consumed, the bf16 one written
    if (tid == 0 && c + kDotStages < nc) {
      hopper::mbar_arrive_expect_tx(&bar[s], kDotAF + kDotBF);
      hopper::tma_load_2d(st, &amap, (c + kDotStages) * kDotK, m0, &bar[s]);
      hopper::tma_load_2d(st + kDotAF, &bmap, n0, (c + kDotStages) * kDotK, &bar[s]);
    }
    constexpr uint32_t lbo = 128, sbo = 128 * kDotKg;   // bytes along K, along M / N
    hopper::fence_operands(d);
    hopper::wgmma_fence();
#pragma unroll
    for (int k = 0; k < kDotK / 16; ++k) {   // 16 K = two core matrices
      hopper::wgmma_bf16<kDotCols>(d, hopper::wgmma_desc(alo + 128 * k, lbo, sbo),
                                   hopper::wgmma_desc(bhi + 128 * k, lbo, sbo), (c | k) != 0);
      hopper::wgmma_bf16<kDotCols>(d, hopper::wgmma_desc(ahi + 128 * k, lbo, sbo),
                                   hopper::wgmma_desc(blo + 128 * k, lbo, sbo), 1);
      hopper::wgmma_bf16<kDotCols>(d, hopper::wgmma_desc(ahi + 128 * k, lbo, sbo),
                                   hopper::wgmma_desc(bhi + 128 * k, lbo, sbo), 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();   // chunk c - 1's products are done: its bf16 may be rewritten
    hopper::fence_operands(d);
    __syncthreads();
  }
  hopper::wgmma_wait<0>();
  hopper::fence_operands(d);
  const int w = tid / 32, l = tid % 32;
#pragma unroll
  for (int i = 0; i < kDotCols / 2; i += 2) {
    const int row = m0 + 16 * w + l / 4 + 8 * ((i / 2) % 2);
    const int col = n0 + 8 * (i / 4) + 2 * (l % 4);
    if (row < M && col < N) {   // N a multiple of 4: col + 1 < N too
      *reinterpret_cast<float2*>(out + static_cast<long long>(row) * N + col) = make_float2(d[i], d[i + 1]);
    }
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

}  // namespace

// x (frames, rows, m, C) bf16, out (R, C) f32 = x[frame, :R, parity, :];
// C a multiple of 8 (the 16-byte stride a tensor map needs), x and out
// 16-byte aligned; one block per box of kYRows rows x kYCols columns.
extern "C" int aainterp_strided_y_bf16(const void* x, void* out, int frames, int rows, int m, int C,
                                       int frame, int parity, int R, void* stream) {
  if (frames <= 0 || rows <= 0 || m <= 0 || C <= 0 || C % 8 != 0 || frame < 0 ||
      frame >= frames || parity < 0 || parity >= m || R <= 0 || R > rows || !aligned16(x) ||
      !aligned16(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int bc = C < kYCols ? C : kYCols, br = R < kYRows ? R : kYRows;
  const int col_blocks = (C + bc - 1) / bc;
  const long long blocks = static_cast<long long>(col_blocks) * ((R + br - 1) / br);
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(m),
                              static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(frames)};
  const cuuint64_t strides[3] = {2ull * C, 2ull * C * m, 2ull * C * m * rows};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(bc), 1, static_cast<cuuint32_t>(br), 1};
  CUtensorMap map;
  const int rc = hopper::encode_tiled(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, x, dims, strides, box);
  if (rc != 0) return rc;
  const size_t smem = 128 + static_cast<size_t>(bc) * br * 2 + 8;
  strided_y_kernel<<<static_cast<unsigned>(blocks), kYThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      map, static_cast<float*>(out), R, C, frame, parity, bc, br, col_blocks);
  return launched();
}

// x (R, W) f32, out (R, W / 2) = x[:, ::2]; W a multiple of 4, x and out
// 16-byte aligned; one block per window of kLoadRows rows x kLoadCols
// columns.
extern "C" int aainterp_strided_load(const void* x, void* out, int R, int W, void* stream) {
  if (R <= 0 || W <= 0 || W % 4 != 0 || !aligned16(x) || !aligned16(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int bc = W < kLoadCols ? W : kLoadCols, br = R < kLoadRows ? R : kLoadRows;
  const int col_blocks = (W + bc - 1) / bc;
  const long long blocks = static_cast<long long>(col_blocks) * ((R + br - 1) / br);
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(W), static_cast<cuuint64_t>(R)};
  const cuuint64_t strides[1] = {4ull * W};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(bc), static_cast<cuuint32_t>(br)};
  CUtensorMap map;
  const int rc = hopper::encode_tiled(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, x, dims, strides, box);
  if (rc != 0) return rc;
  const size_t smem = 128 + static_cast<size_t>(bc) * br * 4 + 8;
  strided_load_kernel<<<static_cast<unsigned>(blocks), kLoadThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(map, static_cast<float*>(out), R, W, bc, br,
                                                             col_blocks);
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

// a (M, K), b (K, N), out (M, N) f32, row-major: out = a @ b at bf16x3; K
// and N multiples of 4 (the 16-byte row strides a tensor map needs), a, b
// and out 16-byte aligned; one block per 64 x 32 tile of out.
extern "C" int aainterp_high_dot(const void* a, const void* b, void* out, int M, int N, int K,
                                 void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 4 != 0 || K % 4 != 0 || !aligned16(a) || !aligned16(b) ||
      !aligned16(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cuuint64_t adims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(M)};
  const cuuint64_t astrides[1] = {4ull * K};
  const cuuint32_t abox[2] = {kDotK, kDotRows};
  const cuuint64_t bdims[2] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(K)};
  const cuuint64_t bstrides[1] = {4ull * N};
  const cuuint32_t bbox[2] = {kDotCols, kDotK};
  CUtensorMap amap, bmap;
  int rc = hopper::encode_tiled(&amap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, a, adims, astrides, abox);
  if (rc == 0) {
    rc = hopper::encode_tiled(&bmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, b, bdims, bstrides, bbox);
  }
  if (rc != 0) return rc;
  static std::atomic<int> opted_in[stage::kMaxDevices];   // the kernel's limit per device
  rc = stage::opt_in(reinterpret_cast<const void*>(high_dot_kernel), static_cast<long long>(kDotSmem),
                     opted_in);
  if (rc != 0) return rc;
  const dim3 grid((N + kDotCols - 1) / kDotCols, (M + kDotRows - 1) / kDotRows);
  high_dot_kernel<<<grid, 128, kDotSmem, static_cast<cudaStream_t>(stream)>>>(
      amap, bmap, static_cast<float*>(out), M, N, K);
  return launched();
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
