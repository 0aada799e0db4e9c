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
// take the direct form instead (thumbnails of 4K frames, 242-tap bands; a
// global mean, one band over the whole image).  It is two grids launched by
// one entry point call, each sum kept whole:
//
//   * y pass: T[f,i,x] = sum_a wy[i,a] * src[f, ys[i]+a, x] for every column
//     x of the image inside the union of the x windows, [c0, c0 + span),
//     into an f32 scratch (F, Hd, span) that the wrapper takes from
//     PyTorch's caching allocator.  A thread sums its columns of one (frame,
//     dst row) over the taps in order, neighbouring threads on neighbouring
//     pixels (coalesced, raw in the input's dtype).  Two shapes of thread,
//     chosen by the wrapper: where the columns are few (15,360 at the
//     480-tap cell, each a serial chain of 480 taps) a thread owns one
//     column; where they are many (the 4K thumbnail's 268k) a thread owns
//     the columns of one 16-byte chunk of each row (4 f32, 8 bf16, 16 u8
//     pixels), one copy a row.  The rows, and each row's weight, reach a
//     thread through cp.async copies into rings in shared memory, 56 rows
//     of an f32 column or 8 of a chunk in flight, whatever registers the
//     compiler gives the sum.  T is shared by every dst column whose
//     window holds x, as the staged form's T is by every column of its
//     strip;
//   * x pass: one warp per output element walks its kx taps of T in order:
//     the lanes load kXStep taps' weights and T side by side into shared
//     memory (the next step's in flight meanwhile) and sum them there,
//     four taps a read; lane 0 stores.
//
// Each column's y sum runs over its taps from 0, then the x sum over its
// taps from 0, as in the staged form, so both forms and the plain version
// give the same bits in modes 1 and 2; taps outside the image add 0.  The
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

// one bf16 or u8 pixel as f32, read through the read-only cache; a bf16
// pixel is read as its 16 bits and widened exactly (bf16 is the top half of
// an f32)
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  const unsigned short bits = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned>(bits) << 16);
}
__device__ __forceinline__ float load_f32(const uint8_t* p) {
  return static_cast<float>(__ldg(p));
}

// ---- the direct form ----------------------------------------------------------

constexpr int kYThreads = 128;  // y pass: threads per block
constexpr int kYRows = 32;      // y pass, 2- and 1-byte columns: rows of loads in flight
constexpr int kRingBytes = 32 * 1024;  // y pass, 4- and 16-byte chunks: the pixels' ring
constexpr int kGroupRows = 8;   // rows a group of copies carries
constexpr int kXGroups = 4;     // x pass: groups of 32 taps a warp has in flight
constexpr int kXStep = 32 * kXGroups;

// the direct form's arguments; T is the (F * Hd, span) f32 scratch whose
// column x - c0 holds image column x; vec: the y pass's columns a thread
struct Direct {
  const void* src;
  void* out;
  float* T;
  const int* ys;
  const float* wy;
  const int* xs;
  const float* wx;
  int F, H, W, Hd, Wd, ky, kx, c0, span, vec;
};

__device__ __forceinline__ unsigned word(const uint4& c, int k) {
  return k == 0 ? c.x : k == 1 ? c.y : k == 2 ? c.z : c.w;
}

// pixel q of a 16-byte chunk, widened exactly
template <typename Tin>
__device__ __forceinline__ float unpack(const uint4& c, int q);
template <>
__device__ __forceinline__ float unpack<float>(const uint4& c, int q) {
  return __uint_as_float(word(c, q));
}
template <>
__device__ __forceinline__ float unpack<__nv_bfloat16>(const uint4& c, int q) {
  const unsigned w = word(c, q >> 1);
  return __uint_as_float((q & 1) ? (w & 0xffff0000u) : (w << 16));
}
template <>
__device__ __forceinline__ float unpack<uint8_t>(const uint4& c, int q) {
  return static_cast<float>((word(c, q >> 2) >> (8 * (q & 3))) & 0xffu);
}

// copies `bytes` (4 or 16) from device memory into shared memory, in flight
// until a cp.async.wait_group; "memory" keeps the compiler from moving
// shared-memory reads across it
template <int bytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(bytes)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int pending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

// a pixel as the y pass multiplies it (mode 1 rounds f32 pixels to bf16;
// bf16 and u8 pixels are exact)
template <int MODE>
__device__ __forceinline__ float operand(float v) { return MODE == 1 ? bf16r(v) : v; }

// y pass: one block per (frame, dst row, kYThreads * kVec columns), columns
// fastest; a thread sums its kVec columns over the taps in order.  kVec 1:
// one column; kVec 16 / sizeof(Tin) (every row's chunk 16-byte aligned, for
// many columns): the columns of one 16-byte chunk of each row.  Where a
// thread's chunk of a row is 4 or 16 bytes (f32 columns, 16-byte chunks)
// it goes through a ring in shared memory: cp.async copies in groups of
// kGroupRows rows, all groups but the one being read in flight (56 rows of
// 4 bytes, 8 of 16), read back by the same thread, so the copies in flight
// do not depend on how the compiler schedules registers.
// A bf16 or u8 column (rows not 16-byte chunks) is loaded into registers,
// kYRows rows a batch.
template <typename Tin, int MODE, int kVec>
__global__ void __launch_bounds__(kYThreads) direct_y_kernel(
    const Tin* __restrict__ src, float* __restrict__ T, const int* __restrict__ ys,
    const float* __restrict__ wy, int H, int W, int Hd, int ky, int c0, int span, int n_chunk) {
  constexpr int kChunk = kVec * static_cast<int>(sizeof(Tin));  // bytes a row
  constexpr bool kRing = kChunk == 4 || kChunk == 16;
  const long long fi = blockIdx.x / n_chunk;  // f * Hd + i
  const int xo = ((blockIdx.x % n_chunk) * kYThreads + threadIdx.x) * kVec;
  const bool active = xo < span;  // ring threads past the span still copy weights
  if (!kRing && !active) return;
  if (kRing && !__any_sync(0xffffffffu, active)) return;  // a whole warp past it
  const int i = static_cast<int>(fi % Hd);
  const long long f = fi / Hd;
  const float* w = wy + static_cast<long long>(i) * ky;
  const int y0 = ys[i];
  const int a_lo = min(max(-y0, 0), ky);        // taps [0, a_lo) above the image
  const int a_hi = max(min(H - y0, ky), a_lo);  // [a_lo, a_hi) inside, the rest below
  Acc<MODE, true> acc[kVec];
  int a = 0;
  for (; a < a_lo; ++a) {
    const float wa = __ldg(w + a);
#pragma unroll
    for (int q = 0; q < kVec; ++q) acc[q].add(wa, 0.0f);
  }
  const Tin* p = src + (f * H + y0 + a) * W + c0 + xo;
  if constexpr (kRing) {
    constexpr int kRows = kRingBytes / (kYThreads * kChunk);  // 64 or 16
    constexpr int kGroups = kRows / kGroupRows;               // 8 or 2
    static_assert(kRows % kGroupRows == 0 && kGroups >= 2, "the ring holds whole groups");
    __shared__ __align__(16) unsigned char ring[kRingBytes];
    __shared__ float wring[kYThreads / 32][kRows];
    // The thread's column of the ring: row r of it at first + (r % kRows) *
    // kRowBytes.  Its warp's weights ride along in wring (lane r < 8 copies
    // row r's of each group, all lanes read them after a warp barrier): read
    // from device memory beside the pixels' stream, they missed L1 and held
    // the 480-tap cell up (PERF.md).  Groups are issued and read in order,
    // so pointers walk both rings and wrap; a whole group is straight-line
    // code whose copies and reads issue back to back.
    constexpr int kRowBytes = kYThreads * kChunk;
    constexpr int kGroupBytes = kGroupRows * kRowBytes;
    const int lane = threadIdx.x & 31;
    unsigned char* const first = ring + threadIdx.x * kChunk;
    unsigned char* const wrap = first + kRows * kRowBytes;
    float* const wmine = wring[threadIdx.x / 32];
    unsigned char* put = first;
    const unsigned char* get = first;
    int wput = 0, wget = 0;
    const long long row_bytes = static_cast<long long>(W) * sizeof(Tin);
    const char* from = reinterpret_cast<const char*>(p);
    const float* wfrom = w + a;
    const int n = a_hi - a_lo;
    int left = n;  // rows not yet issued
    // the next group's copies, then a commit, also of an empty group, so
    // that the wait below counts groups
    auto issue = [&]() {
      __syncwarp();  // every lane has read the weights about to be replaced
      if (active) {
        if (left >= kGroupRows) {
#pragma unroll
          for (int r = 0; r < kGroupRows; ++r) cp_async<kChunk>(put + r * kRowBytes, from + r * row_bytes);
        } else {
          for (int r = 0; r < left; ++r) cp_async<kChunk>(put + r * kRowBytes, from + r * row_bytes);
        }
      }
      if (lane < kGroupRows && lane < left) cp_async<4>(wmine + wput + lane, wfrom + lane);
      cp_commit();
      left -= kGroupRows;
      from += kGroupRows * row_bytes;
      wfrom += kGroupRows;
      put = put + kGroupBytes == wrap ? first : put + kGroupBytes;
      wput = wput + kGroupRows == kRows ? 0 : wput + kGroupRows;
    };
    // the next group's m taps, in order
    auto sum = [&](int m) {
      float wv[kGroupRows];
      uint4 cv[kGroupRows];
#pragma unroll
      for (int r = 0; r < kGroupRows; ++r) {
        if (r < m) {
          wv[r] = wmine[wget + r];
          if constexpr (kVec == 1) {
            cv[r].x = *reinterpret_cast<const unsigned*>(get + r * kRowBytes);
          } else {
            cv[r] = *reinterpret_cast<const uint4*>(get + r * kRowBytes);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kGroupRows; ++r) {
        if (r < m) {
#pragma unroll
          for (int q = 0; q < kVec; ++q) acc[q].add(wv[r], operand<MODE>(unpack<Tin>(cv[r], q)));
        }
      }
      get = get + kGroupBytes == wrap ? first : get + kGroupBytes;
      wget = wget + kGroupRows == kRows ? 0 : wget + kGroupRows;
    };
    for (int g = 0; g < kGroups - 1; ++g) issue();
    for (int done = 0; done < n; done += kGroupRows) {
      issue();                 // into the slots of the group read last
      cp_wait<kGroups - 1>();  // the next group to read has landed
      __syncwarp();            // and so have its weights, copied by other lanes
      if (n - done >= kGroupRows) {
        sum(kGroupRows);
      } else {
        sum(n - done);
      }
    }
    a = a_hi;
  } else {  // a bf16 or u8 column
    for (; a + kYRows <= a_hi; a += kYRows, p += static_cast<long long>(kYRows) * W) {
      float v[kYRows];
#pragma unroll
      for (int r = 0; r < kYRows; ++r) v[r] = load_f32(p + static_cast<long long>(r) * W);
#pragma unroll
      for (int r = 0; r < kYRows; ++r) acc[0].add(__ldg(w + a + r), operand<MODE>(v[r]));
    }
    for (; a < a_hi; ++a, p += W) acc[0].add(__ldg(w + a), operand<MODE>(load_f32(p)));
  }
  for (; a < ky; ++a) {
    const float wa = __ldg(w + a);
#pragma unroll
    for (int q = 0; q < kVec; ++q) acc[q].add(wa, 0.0f);
  }
  if (!active) return;
  float* t = T + fi * span + xo;
#pragma unroll
  for (int q = 0; q < kVec; ++q) {
    const float s = acc[q].sum();
    t[q] = MODE == 1 ? bf16r(s) : s;
  }
}

// the lane's taps b0 + 32 g + lane of one x window: the weight, and T (0
// outside [0, span), which holds every tap inside the image)
__device__ __forceinline__ void x_group(float (&wv)[kXGroups], float (&tv)[kXGroups],
                                        const float* w, const float* trow, int x0, int kx,
                                        int span, int b0, int lane) {
#pragma unroll
  for (int g = 0; g < kXGroups; ++g) {
    const int b = b0 + 32 * g + lane;
    const int x = x0 + b;
    wv[g] = b < kx ? __ldg(w + b) : 0.0f;
    tv[g] = (b < kx && x >= 0 && x < span) ? __ldg(trow + x) : 0.0f;
  }
}

// x pass: one warp per output element (f, i, j).  Step by step of kXStep
// taps, the lanes load the taps' weights and T side by side (the next
// step's in flight while this one is summed) into the warp's slice of
// shared memory, and each lane sums them there in order (broadcast reads,
// four taps a read); lane 0 stores.
template <typename Tout, int MODE>
__global__ void __launch_bounds__(kThreads) direct_x_kernel(
    const float* __restrict__ T, Tout* __restrict__ out, const int* __restrict__ xs,
    const float* __restrict__ wx, long long total, int Wd, int kx, int c0, int span) {
  __shared__ __align__(16) float sw[band::kWarps][kXStep];
  __shared__ __align__(16) float st[band::kWarps][kXStep];
  const int warp = threadIdx.x / 32;
  const long long e = static_cast<long long>(blockIdx.x) * band::kWarps + warp;
  if (e >= total) return;  // whole warps; no block barrier follows
  const int lane = threadIdx.x & 31;
  const int j = static_cast<int>(e % Wd);
  const float* trow = T + (e / Wd) * span;
  const float* w = wx + static_cast<long long>(j) * kx;
  const int x0 = xs[j] - c0;
  Acc<MODE, false> acc;
  float wn[kXGroups], tn[kXGroups];
  x_group(wn, tn, w, trow, x0, kx, span, 0, lane);
  for (int b0 = 0; b0 < kx; b0 += kXStep) {
#pragma unroll
    for (int g = 0; g < kXGroups; ++g) {
      sw[warp][32 * g + lane] = wn[g];
      st[warp][32 * g + lane] = tn[g];
    }
    __syncwarp();
    if (b0 + kXStep < kx) x_group(wn, tn, w, trow, x0, kx, span, b0 + kXStep, lane);
    const int m = kx - b0;  // taps left
    if (m >= kXStep) {
      const float4* w4 = reinterpret_cast<const float4*>(sw[warp]);
      const float4* t4 = reinterpret_cast<const float4*>(st[warp]);
#pragma unroll
      for (int q = 0; q < kXStep / 4; ++q) {
        const float4 wq = w4[q], tq = t4[q];
        acc.add(wq.x, tq.x);
        acc.add(wq.y, tq.y);
        acc.add(wq.z, tq.z);
        acc.add(wq.w, tq.w);
      }
    } else {
      for (int q = 0; q < m; ++q) acc.add(sw[warp][q], st[warp][q]);
    }
    __syncwarp();
  }
  if (lane == 0) store(out + e, acc.sum());
}

template <typename Tin, int MODE, int kVec>
int direct_y(const Direct& a, cudaStream_t stream) {
  const int cols = kYThreads * kVec;
  const int n_chunk = (a.span + cols - 1) / cols;
  const long long blocks = static_cast<long long>(a.F) * a.Hd * n_chunk;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  direct_y_kernel<Tin, MODE, kVec><<<static_cast<unsigned>(blocks), kYThreads, 0, stream>>>(
      static_cast<const Tin*>(a.src), a.T, a.ys, a.wy, a.H, a.W, a.Hd, a.ky, a.c0, a.span,
      n_chunk);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tin, int MODE>
int direct_y_vec(const Direct& a, cudaStream_t stream) {
  return a.vec == 1 ? direct_y<Tin, MODE, 1>(a, stream)
                    : direct_y<Tin, MODE, static_cast<int>(16 / sizeof(Tin))>(a, stream);
}

template <typename Tout, int MODE>
int direct_x(const Direct& a, cudaStream_t stream) {
  const long long total = static_cast<long long>(a.F) * a.Hd * a.Wd;
  const long long blocks = (total + band::kWarps - 1) / band::kWarps;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  direct_x_kernel<Tout, MODE><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      a.T, static_cast<Tout*>(a.out), a.xs, a.wx, total, a.Wd, a.kx, a.c0, a.span);
  return static_cast<int>(cudaGetLastError());
}

// both passes in mode MODE (codes checked by the caller)
template <int MODE>
int direct(const Direct& a, int in_code, int out_code, cudaStream_t stream) {
  if (a.span > 0) {  // else no tap lies inside the image and T is not read
    int rc;
    switch (in_code) {
      case 0: rc = direct_y_vec<float, MODE>(a, stream); break;
      case 1: rc = direct_y_vec<__nv_bfloat16, MODE>(a, stream); break;
      default: rc = direct_y_vec<uint8_t, MODE>(a, stream); break;
    }
    if (rc != 0) return rc;
  }
  switch (out_code) {
    case 0: return direct_x<float, MODE>(a, stream);
    case 1: return direct_x<__nv_bfloat16, MODE>(a, stream);
    default: return direct_x<uint8_t, MODE>(a, stream);
  }
}

template <typename Tin, typename Tout>
int launch_mode(int mode, const void* src, void* out, const void* ys, const void* wy,
                const void* xs, const void* wx, const void* row_base, const void* col_base,
                int F, const band::Dims& d, cudaStream_t stream) {
  switch (mode) {
    case 0: return band::launch_staged<Tin, Tout, 0, false>(src, out, ys, wy, xs, wx, row_base, col_base, F, d, stream);
    case 1: return band::launch_staged<Tin, Tout, 1, false>(src, out, ys, wy, xs, wx, row_base, col_base, F, d, stream);
    case 2: return band::launch_staged<Tin, Tout, 2, false>(src, out, ys, wy, xs, wx, row_base, col_base, F, d, stream);
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
// operands ('default'), 2 bf16x3.  The staged form: row_base / col_base
// hold the first source row of each row tile of TY dst rows and the first
// source column of each strip of TX dst columns, and every tap lies inside
// spans of SY x SX from them.
extern "C" int aainterp_separable_apply_2d(
    const void* src, void* out, const void* ys, const void* wy,
    const void* xs, const void* wx, const void* row_base, const void* col_base,
    int F, int H, int W, int Hd, int Wd, int ky, int kx,
    int TY, int TX, int SY, int SX, int mode, int in_code, int out_code,
    void* stream) {
  if (F <= 0 || H <= 0 || W <= 0 || Hd <= 0 || Wd <= 0 || ky <= 0 || kx <= 0 ||
      TY <= 0 || TX <= 0 || TX > band::kThreads || SY < ky || SX < kx) {
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

// The direct form: the y pass (none when span is 0), then the x pass, both
// on the caller's stream.  T: an f32 scratch of F * Hd * span elements;
// columns [c0, c0 + span) hold every tap of every dst column that lies
// inside the image.  vec: the y pass's columns a thread, 1 or 16 bytes of
// pixels (then c0, span and W multiples of it and src 16-byte aligned).
extern "C" int aainterp_separable_apply_2d_direct(
    const void* src, void* out, void* T, const void* ys, const void* wy,
    const void* xs, const void* wx, int F, int H, int W, int Hd, int Wd, int ky,
    int kx, int c0, int span, int vec, int mode, int in_code, int out_code,
    void* stream) {
  static const int kElem[3] = {4, 2, 1};
  if (F <= 0 || H <= 0 || W <= 0 || Hd <= 0 || Wd <= 0 || ky <= 0 || kx <= 0 ||
      c0 < 0 || span < 0 || c0 + span > W || (span > 0 && T == nullptr) ||
      in_code < 0 || in_code > 2 || out_code < 0 || out_code > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (vec != 1 && (vec != 16 / kElem[in_code] || c0 % vec != 0 || span % vec != 0 ||
                   W % vec != 0 || (reinterpret_cast<uintptr_t>(src) & 15) != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Direct a{src, out, static_cast<float*>(T), static_cast<const int*>(ys),
                 static_cast<const float*>(wy), static_cast<const int*>(xs),
                 static_cast<const float*>(wx), F, H, W, Hd, Wd, ky, kx, c0, span, vec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return direct<0>(a, in_code, out_code, s);
    case 1: return direct<1>(a, in_code, out_code, s);
    case 2: return direct<2>(a, in_code, out_code, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
