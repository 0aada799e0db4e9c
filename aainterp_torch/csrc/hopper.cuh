// Hopper primitives (sm_90a) as inline PTX, for the port's kernels to share:
// mbarriers, the async-proxy fences, 1-D bulk copies (cp.async.bulk) in both
// directions, TMA tile loads (cp.async.bulk.tensor) from a CUtensorMap, the
// wgmma shared-memory matrix descriptor and the wgmma shapes the kernels use,
// the bf16 hi / lo split of f32 values into that layout, and a host helper
// that encodes a tiled tensor map.
//
// First used by csrc/watchlist.cu, whose six probes hold each primitive
// against a plain PyTorch version on the card; csrc/dense_x.cu runs a
// product of a bf16 split on the same wgmma path, and csrc/probes.cu's copy
// a ring of bulk loads and stores.
//
// mbarrier protocol: one thread calls mbar_init, then fence_mbarrier_init,
// then the block synchronises before any copy names the barrier.  The thread
// that issues the copies first calls mbar_arrive_expect_tx with the bytes that
// will land (a TMA box's whole size, or the sum of the bulk copies); every
// thread that reads the data waits with mbar_wait on the barrier's phase
// parity, 0 for the first use, flipped at each reuse.
//
// wgmma operands here are K-major, without swizzle: a core matrix is 8 rows
// of 16 bytes stored contiguously (128 bytes); wgmma_desc takes the byte
// distance between core matrices adjacent along K (the leading byte offset)
// and along M or N (the stride byte offset).  Data written to shared memory
// by threads (the generic proxy) needs fence_proxy_async and a barrier
// before wgmma or a bulk store reads it.
//
// The tensor-map encoder is looked up through the CUDA runtime
// (cudaGetDriverEntryPointByVersion, CUDA 12.5 or later), so no library that
// includes this header links against libcuda.

#pragma once

#include <cuda.h>            // CUtensorMap and its enums
#include <cuda_bf16.h>
#include <cudaTypedefs.h>    // PFN_cuTensorMapEncodeTiled
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#if CUDART_VERSION < 12050
#error "hopper.cuh needs CUDA 12.5 or later (cudaGetDriverEntryPointByVersion)"
#endif

// internal linkage: each library that includes this header keeps its own
// copy of these helpers
namespace {
namespace hopper {

// a failed cuTensorMapEncodeTiled is returned as kEncodeError + its CUresult,
// apart from every cudaError_t
constexpr int kEncodeError = 100000;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier ----------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// makes an mbar_init visible to the async proxy (the copies that complete on it)
__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// orders the generic proxy's shared-memory writes before async-proxy reads
// (wgmma, bulk stores) of the same bytes
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// waits until the phase of parity `parity` has completed; a phase that has
// not completed after ~2^33 clock cycles (seconds) is a fault (an expected
// byte count that never lands), so the kernel traps instead of hanging
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > (1ll << 33)) __trap();
  }
}

// ---- 1-D bulk copies ---------------------------------------------------------

// global -> shared, `bytes` a multiple of 16, both addresses 16-byte aligned;
// completes `bytes` of the barrier's expected transaction count
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// shared -> global, in the issuing thread's current bulk group
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
                   reinterpret_cast<uint64_t>(dst)),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// waits until every committed bulk group of this thread has completed
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// waits until at most N of this thread's committed bulk groups are still
// reading their source: the shared memory of the older ones may be written
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// ---- TMA tile loads ----------------------------------------------------------
// `map` is the address of a __grid_constant__ kernel parameter; the
// coordinates are in elements, innermost dimension first; the box lands
// densely at `dst` (128-byte aligned), out-of-bounds elements as zeros, and
// completes the box's whole size on `bar`.

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// ---- wgmma -------------------------------------------------------------------

// the shared-memory matrix descriptor: start address >> 4 (bits 0-13), the
// leading byte offset >> 4 (bits 16-29), the stride byte offset >> 4 (bits
// 32-45), base offset 0 (bits 49-51), no swizzle (bits 62-63 = 0)
__device__ __forceinline__ uint64_t wgmma_desc(const void* smem, uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  return static_cast<uint64_t>((smem_u32(smem) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo_bytes & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo_bytes & 0x3FFFF) >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// waits until at most N committed wgmma groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses of an accumulator register across
// a wgmma fence or wait (the hardware writes it asynchronously)
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N f32, the warpgroup's fragment) += A (64 x 16 bf16) * B (16 x N
// bf16), both K-major in shared memory; scale_d 0 discards d's old value.
// Thread t of the warpgroup holds d[i] at row 16 * (t / 32) + (t % 32) / 4 +
// 8 * ((i / 2) % 2), column 8 * (i / 4) + 2 * (t % 4) + i % 2.  One
// instance per N the kernels use: N = 32 (high_dot's 64 x 32 tiles) and
// 208 (dense_x.cu's column slice of a warpgroup).
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b,
                                           int scale_d);

template <>
__device__ __forceinline__ void wgmma_bf16<32>(float (&d)[16], uint64_t desc_a, uint64_t desc_b,
                                               int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_bf16<208>(float (&d)[104], uint64_t desc_a, uint64_t desc_b,
                                               int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %106, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n208k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103"
      "}, %104, %105, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// ---- the split and the core-matrix layout -------------------------------------

// the element offset of (row r, column k) of a K-major operand of kg core
// matrices along K (K / 8), unswizzled: core matrix (r / 8, k / 8) at
// ((r / 8) * kg + k / 8) * 64 elements, row r % 8 of it 16 bytes at (r % 8) * 8
__host__ __device__ __forceinline__ int core_offset(int r, int k, int kg) {
  return ((r >> 3) * kg + (k >> 3)) * 64 + (r & 7) * 8 + (k & 7);
}

// 8 values along K split into hi = bf16(v) and lo = bf16(v - hi) (the
// difference exact in f32), one 16-byte store each
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

// ---- host: tiled tensor maps -------------------------------------------------

// cuTensorMapEncodeTiled, looked up through the CUDA runtime once per
// process; 0 or a cudaError_t in *err
inline PFN_cuTensorMapEncodeTiled encode_tiled_fn(int* err) {
  static std::atomic<void*> cached{nullptr};
  void* fn = cached.load();
  if (fn == nullptr) {
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
    if (e != cudaSuccess) {
      *err = static_cast<int>(e);
      return nullptr;
    }
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) {
      *err = static_cast<int>(cudaErrorSymbolNotFound);
      return nullptr;
    }
    cached.store(fn);
  }
  *err = 0;
  return reinterpret_cast<PFN_cuTensorMapEncodeTiled>(fn);
}

// A tiled, unswizzled map of a row-major tensor at `base` (16-byte aligned):
// dims[i] elements along dimension i, innermost first; strides[i] the bytes
// between neighbours along dimension i + 1 (multiples of 16); box[i] elements
// per box along dimension i (each at most 256, box[0] spanning a multiple of
// 16 bytes).  Out-of-bounds elements load as zeros.  Returns 0, a cudaError_t
// from the entry-point lookup, or kEncodeError + the CUresult.
inline int encode_tiled(CUtensorMap* map, CUtensorMapDataType dtype, int rank, const void* base,
                        const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box) {
  int err = 0;
  const PFN_cuTensorMapEncodeTiled encode = encode_tiled_fn(&err);
  if (encode == nullptr) return err;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const CUresult r =
      encode(map, dtype, static_cast<cuuint32_t>(rank), const_cast<void*>(base), dims, strides, box,
             ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + static_cast<int>(r);
}

}  // namespace hopper
}  // namespace
