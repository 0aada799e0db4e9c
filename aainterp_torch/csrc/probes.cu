// Probe kernels for Hopper (sm_90a): the copy ceiling at a frame geometry
// and the rotated contraction's ablations.
//
// Replaces the TPU Pallas probe kernels of benchmarks/:
//
//   aainterp_copy_rows      <- copy_ceiling.py:32 _build_copy (pallas_call at
//                              :39) and rgb1024_experiments.py:67 _build_copy
//                              (:74), the same row-tiled copy at H = W = 1024,
//                              TY 128
//   aainterp_contract_probe <- rot_experiments.py:130 _build_contract_noweight
//                              (:199), :247 _build_contract_share (:349) and
//                              :392 _build_contract_pipelined (:469)
//
// The copy computes _build_copy's function, (F, H, W) -> (F, nt*TY, W) with
// nt = H / TY (rows past nt*TY are not copied): the TPU grid's steps, one
// (frame, row tile) each.  A row tile of a frame is TY full rows, so it is
// one contiguous span of TY*W elements in the source and in the output.
// What bounds it: bytes, each read once and written once, nothing else.
// So each span is split into parts of about kPartBytes, one sweep of a
// block (kCopyThreads threads with kUnroll 16-byte loads in flight each),
// one block per part.  One 1024-thread block per span left half the SMs
// idle at 8 x 1024^2 with TY 128 (64 spans); of the grids timed on the
// H100 (chip_sweep.py cells c_*, variants copy*: 128 to 1024 threads, one
// to four sweeps per part, one block per part or one wave of blocks
// taking parts in turn), small blocks of one sweep each were the fastest
// at every geometry (PERF.md).  A block copies its part in 16-byte loads
// and stores, each thread keeping kUnroll loads in flight before it
// stores them; the ragged ends of the span (its start not 16-byte
// aligned, a tail of under 16 bytes) are copied word by word by its first
// and last parts.  The parts split the span's 16-byte units, so a split
// never breaks a unit.  Where the source and output
// spans differ in their alignment mod 16 (an odd row pitch, say), the
// widest unit both share (8 or 4 bytes) takes the 16-byte unit's place.
// The kernel moves raw bytes, so any element type of 1, 2, 4 or 8 bytes
// copies bit for bit.
//
// The contraction probes are csrc/contract.cuh's body under one probe mode
// each (noweight, tshare, wshare, bothshare, pipelined); that header says
// what each removes and why these are the H100 meanings of the TPU probes.
// What bounds them: bytes, the streams each mode still reads (PERF.md).
//
// Plain C interface for ctypes; each launch goes on the caller's stream and
// does not synchronise.  The return value is cudaGetLastError() after the
// launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <climits>

#include "contract.cuh"

namespace {

constexpr int kCopyThreads = 128;
constexpr int kUnroll = 4;
constexpr long long kPartBytes = 16LL * kUnroll * kCopyThreads;   // 8 KB

__device__ __forceinline__ uintptr_t addr(const void* p) {
  return reinterpret_cast<uintptr_t>(p);
}

// units [lo, hi) of U from s to d (s and d aligned to U)
template <typename U>
__device__ __forceinline__ void copy_units(const unsigned char* s, unsigned char* d,
                                           long long lo, long long hi) {
  const U* su = reinterpret_cast<const U*>(s);
  U* du = reinterpret_cast<U*>(d);
  const long long step = blockDim.x;
  long long i = lo + threadIdx.x;
  for (; i + (kUnroll - 1) * step < hi; i += kUnroll * step) {
    U r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) r[u] = su[i + u * step];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) du[i + u * step] = r[u];
  }
  for (; i < hi; i += step) du[i] = su[i];
}

// part `part` of `parts` of an n-byte span: words up to the first
// U-aligned source byte (part 0), units U (split evenly over the parts),
// then words for the tail (the last part); s and d agree mod sizeof(U)
template <typename U, typename Word>
__device__ __forceinline__ void copy_span(const unsigned char* s, unsigned char* d,
                                          long long n, int part, int parts) {
  constexpr long long u = sizeof(U);
  constexpr long long w = sizeof(Word);
  const long long head = min(n, static_cast<long long>((u - (addr(s) & (u - 1))) & (u - 1)));
  const long long units = (n - head) / u;
  const long long end = head + units * u;
  if (part == 0) copy_units<Word>(s, d, 0, head / w);
  copy_units<U>(s + head, d + head, units * part / parts, units * (part + 1) / parts);
  if (part == parts - 1) copy_units<Word>(s + end, d + end, 0, (n - end) / w);
}

// block b copies part b % parts of row tile (b / parts) % nt of frame
// b / parts / nt: tile bytes from src + f * src_frame + r * tile to
// dst + (b / parts) * tile
template <typename Word>
__global__ void __launch_bounds__(kCopyThreads) copy_rows_kernel(
    const unsigned char* __restrict__ src, unsigned char* __restrict__ dst, int nt,
    int parts, long long src_frame, long long tile) {
  const long long span = blockIdx.x / parts;
  const int part = static_cast<int>(blockIdx.x - span * parts);
  const long long f = span / nt;
  const long long r = span - f * nt;
  const unsigned char* s = src + f * src_frame + r * tile;
  unsigned char* d = dst + span * tile;
  const uintptr_t mis = addr(s) ^ addr(d);
  if ((mis & 15) == 0) {
    copy_span<uint4, Word>(s, d, tile, part, parts);
  } else if ((mis & 7) == 0) {
    copy_span<uint2, Word>(s, d, tile, part, parts);
  } else if ((mis & 3) == 0) {
    copy_span<uint32_t, Word>(s, d, tile, part, parts);
  } else {
    copy_span<Word, Word>(s, d, tile, part, parts);
  }
}

template <typename Word>
int launch_copy(const void* src, void* dst, int F, int H, int W, int TY, cudaStream_t st) {
  const int nt = H / TY;
  const long long spans = static_cast<long long>(F) * nt;
  const long long row = static_cast<long long>(W) * sizeof(Word);
  const long long tile = static_cast<long long>(TY) * row;
  // parts of about one sweep each, one block per part
  const long long parts = std::max(1LL, tile / kPartBytes);
  const long long blocks = spans * parts;
  if (nt <= 0 || blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  copy_rows_kernel<Word><<<static_cast<unsigned>(blocks), kCopyThreads, 0, st>>>(
      static_cast<const unsigned char*>(src), static_cast<unsigned char*>(dst), nt,
      static_cast<int>(parts), static_cast<long long>(H) * row, tile);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, contract::Probe P>
int launch_probe(const void* t, void* out, const int* r, const int* c, const float* w,
                 const int* sp, int F, int TH, int TW, int Hd, int Wd, int Ka, int Kb,
                 dim3 grid, cudaStream_t st) {
  contract::contract_probe_kernel<T, P><<<grid, contract::kThreads, 0, st>>>(
      static_cast<const T*>(t), static_cast<T*>(out), r, c, w, sp, F, TH, TW, Hd, Wd, Ka, Kb,
      0);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int probe(int mode, const void* t, void* out, const int* r, const int* c, const float* w,
          const int* sp, int F, int TH, int TW, int Hd, int Wd, int Ka, int Kb, dim3 grid,
          cudaStream_t st) {
  switch (mode) {
    case contract::kNoWeight:
      return launch_probe<T, contract::kNoWeight>(t, out, r, c, w, sp, F, TH, TW, Hd, Wd, Ka,
                                                  Kb, grid, st);
    case contract::kTShare:
      return launch_probe<T, contract::kTShare>(t, out, r, c, w, sp, F, TH, TW, Hd, Wd, Ka, Kb,
                                                grid, st);
    case contract::kWShare:
      return launch_probe<T, contract::kWShare>(t, out, r, c, w, sp, F, TH, TW, Hd, Wd, Ka, Kb,
                                                grid, st);
    case contract::kBothShare:
      return launch_probe<T, contract::kBothShare>(t, out, r, c, w, sp, F, TH, TW, Hd, Wd, Ka,
                                                   Kb, grid, st);
    case contract::kPipelined:
      return launch_probe<T, contract::kPipelined>(t, out, r, c, w, sp, F, TH, TW, Hd, Wd, Ka,
                                                   Kb, grid, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// (F, H, W) -> (F, (H / TY) * TY, W), elements of elem_bytes (1, 2, 4 or 8)
// moved as raw bytes; src and dst contiguous.
extern "C" int aainterp_copy_rows(const void* src, void* dst, int F, int H, int W, int TY,
                                  int elem_bytes, void* stream) {
  if (F <= 0 || H <= 0 || W <= 0 || TY <= 0 || TY > H) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 1: return launch_copy<uint8_t>(src, dst, F, H, W, TY, st);
    case 2: return launch_copy<uint16_t>(src, dst, F, H, W, TY, st);
    case 4: return launch_copy<uint32_t>(src, dst, F, H, W, TY, st);
    case 8: return launch_copy<uint64_t>(src, dst, F, H, W, TY, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// mode: contract::Probe, 1 = noweight, 2 = tshare, 3 = wshare, 4 = bothshare,
// 5 = pipelined; dtype_code: 0 = float32, 1 = bfloat16 (T and out share it).
// The arguments are aainterp_contract's (csrc/ell_shear.cu): every mode but
// noweight skips the dead pixels outside span.
extern "C" int aainterp_contract_probe(const void* t, void* out, const void* ry0,
                                       const void* cx0, const void* w2, const void* span,
                                       int F, int TH, int TW, int Hd, int Wd, int Ka, int Kb,
                                       int mode, int dtype_code, void* stream) {
  dim3 grid;
  if (F <= 0 || TH <= 0 || TW <= 0 || Ka <= 0 || Kb <= 0 ||
      (span == nullptr && mode != contract::kNoWeight) ||
      !contract::row_grid(Hd, Wd, &grid)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* r = static_cast<const int*>(ry0);
  const int* c = static_cast<const int*>(cx0);
  const float* w = static_cast<const float*>(w2);
  const int* sp = static_cast<const int*>(span);
  if (dtype_code == 0) {
    return probe<float>(mode, t, out, r, c, w, sp, F, TH, TW, Hd, Wd, Ka, Kb, grid, st);
  }
  if (dtype_code == 1) {
    return probe<__nv_bfloat16>(mode, t, out, r, c, w, sp, F, TH, TW, Hd, Wd, Ka, Kb, grid,
                                st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
