// Staging helpers shared by the port's staged kernels for Hopper (sm_90a):
// csrc/band_apply.cuh (kernels 1 and 2), csrc/shear3_stage.cu and
// csrc/ell_shear.cu.
//
// A staged window copies each source row's aligned 16-byte chunks whole
// into shared memory with cp.async, at a shared pitch equal to the source
// row stride mod 16 (seg_pitch), so element (r, c) sits at base + r * pitch
// + c * sizeof(element) whatever the row's alignment.  A chunk is 16-byte
// aligned and holds at least one byte of the row, so it never leaves the
// source's memory pages.  Walk spreads such (row, chunk) items over a
// block's threads; opt_in lets a kernel use more than 48 KB of dynamic
// shared memory.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

// internal linkage: each library that includes this header keeps its own
// copy of these helpers
namespace {
namespace stage {

constexpr size_t kDefaultSmem = 48 * 1024;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

// (r, c) of a row-major index over rows of width w, advanced by kStep (the
// block's thread count) at a time without a division per step
template <int kStep>
struct Walk {
  int r, c, dr, dc, w;
  __device__ Walk(int e, int w_) : w(w_) {
    r = e / w;
    c = e - r * w;
    dr = kStep / w;
    dc = kStep - dr * w;
  }
  __device__ __forceinline__ void next() {
    r += dr;
    c += dc;
    if (c >= w) {
      c -= w;
      ++r;
    }
  }
};

// the least p >= bytes + 32 with p = stride (mod 16)
__host__ __device__ inline long long seg_pitch(long long bytes, long long stride) {
  const long long p = bytes + 32;
  return p + (((stride - p) % 16) + 16) % 16;
}

__host__ __device__ inline long long up16(long long n) { return (n + 15) / 16 * 16; }

// Let `kern` launch with `smem` bytes of dynamic shared memory.  Above the
// default 48 KB its limit is raised to the device's opt-in maximum once per
// device: `opted_in` holds that limit per device (0 until set) and belongs
// to `kern` alone, so a launch inside CUDA-graph capture after a warm-up
// launch makes no such call.  Returns 0, or a cudaError_t
// (cudaErrorInvalidValue where smem exceeds the opt-in).
inline int opt_in(const void* kern, long long smem, std::atomic<int> (&opted_in)[kMaxDevices]) {
  if (smem <= static_cast<long long>(kDefaultSmem)) return 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  int limit = opted_in[dev].load();
  if (limit == 0) {
    e = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in[dev].store(limit);
  }
  return smem > limit ? static_cast<int>(cudaErrorInvalidValue) : 0;
}

}  // namespace stage
}  // namespace
