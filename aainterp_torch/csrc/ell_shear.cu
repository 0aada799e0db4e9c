// Exact rotated (ELL) apply for Hopper (sm_90a): one staged integer-shear
// kernel in three forms and a window contraction.
//
// Replaces the three TPU Pallas kernels of aainterp/ops/pallas_shear.py:
//
//   aainterp_vshear   <- _build_vshear   (:59, pallas_call at :100)
//   aainterp_hshear   <- _build_hshear   (:114, pallas_call at :150)
//   aainterp_vhshear  <- both at once: the rotated route's shear
//   aainterp_contract <- _build_contract (:164, pallas_call at :291),
//                        masked=True as the route launches it (:802);
//                        aainterp_contract_direct is the same function in
//                        the direct form, aainterp_contract_unmasked the
//                        direct form with masked=False
//
// With the host plan of ops/shear_apply.build_shear_plan (gy, hx, ry0, cx0
// and the re-indexed weights w2, laid out by ops/cuda_shear.py, which also
// tables each shear tile's source window) they compute, per frame f,
//
//   S[f,y,x]     = q[f, y - gy[x], x]     or 0 when y - gy[x] is outside [0, qH)
//   T[f,y,x]     = S[f, y, x - hx[y]]     or 0 when x - hx[y] is outside [0, qW)
//                = q[f, y - gy[c], c]     with c = x - hx[y] (the fused form)
//   out[f,dy,dx] = sum_{a<Ka, b<Kb} w2[a*Kb+b, dy, dx]
//                  * T[f, clamp(ry0[dy]+a, 0, TH-1), clamp(cx0[dx]+b, 0, TW-1)]
//
// with f32 accumulation (fmaf, taps a-major then b), as the plain torch
// versions in ops/cuda_shear.py do.  The route launches the fused shear and
// the contraction: S never reaches device memory.
//
// What the TPU kernels did that is not carried over: Mosaic rotates 32-bit
// values only and the TPU has no gather, so the Pallas shears are log2
// passes of static rolls plus selects, the contraction gathers through
// one-hot MXU matmuls, and every table is padded to 8/16/128-aligned
// widths.  A GPU thread reads any shared-memory address, so here each
// output element is one indexed load from a staged window.
//
// What bounds them: bytes.  The shears are pure data movement (element type
// moved as raw 16- or 32-bit words, so every form is bit-exact).  The
// contraction does Ka*Kb FMAs per output pixel and frame (25 at the
// 2048^2/30 degree flagship) against the largest stream of the route, the
// f32 weight table w2 (196 MB at the flagship against 31 MB of bf16 output
// for 8 frames).  So:
//
//   * the shear kernel (shear_kernel) gives one block to one output tile
//     of TY rows by TX columns of one frame (all tiles of all frames on
//     grid.x, frames outermost, each frame's tiles row by row: on the H100
//     a tile's frames side by side made the fused form 11 % slower, and
//     each frame's tiles column by column 21 %; chip_sweep.py variants
//     tilemajor and colmajor, PERF.md).  A host table gives
//     the tile's source window, rows [r_lo, r_hi) and columns [c_lo, c_hi),
//     clipped to the source; the window is copied raw into shared memory
//     with 16-byte cp.async (csrc/stage_common.cuh: shared pitch = the
//     source row stride mod 16, so every aligned 16-byte chunk lands on an
//     aligned shared address, at any row alignment);
//   * each thread then builds 16 bytes of one output row (8 bf16 or 4 f32
//     words) from shared memory and stores them with one 16-byte store;
//     the ragged ends of a row (tile edges, rows not 16-byte aligned) are
//     stored word by word.  EVERY element of the output is written, zeros
//     included, so a contraction tap whose weight is 0 never meets an
//     uninitialised value (NaN * 0 = NaN);
//   * a tile whose window is empty (the table's row all 0: nothing of the
//     source lands in it, 60 % of the fused form's tiles at the flagship)
//     stages nothing, and its words fail the window test, so it stores
//     zeros.  (A separate path for such tiles, without the word tests, was
//     no faster on the H100, and 7 % slower on the fused form: PERF.md);
//   * the forms differ only in which shift table they read (kGy: vertical,
//     kHx: horizontal; vshear = fused with hx = 0, hshear = fused with
//     gy = 0); the tile's slice of each table is staged in shared memory;
//   * the contraction (csrc/contract.cuh, which says more) gives one
//     thread to one (dy, dx) and loops over the frames inside, up to
//     kFrames at a time with the sums in registers, so each weight tap is
//     read from device memory once per kFrames frames (once per batch at
//     the flagship's 8), not once per frame — the reason the TPU grid runs
//     frames innermost (pallas_shear.py:197-199).  Weights are tap-major,
//     so neighbouring threads read neighbouring words.  A per-row span of
//     live dst columns (host table) lets a pixel outside it store zeros
//     and read nothing: 46 % of the flagship's dst pixels.  The route's
//     masked form is tiled: one block per dst tile stages the tile's T
//     window (a host table) for 8 frames into shared memory,
//     frame-interleaved, so a tap is one 16-byte shared read.  The direct
//     form (each tap's T values gathered from device memory) stays for
//     the unmasked instance and for plans whose windows do not fit in
//     shared memory (aainterp_contract_direct).
//
// Plain C interface for ctypes; each launch goes on the caller's stream and
// does not synchronise.  The return value is cudaGetLastError() after the
// launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <climits>

#include "contract.cuh"
#include "stage_common.cuh"

namespace {

constexpr int kThreads = 256;

using stage::cp_async16;
using stage::seg_pitch;
using stage::up16;
using Walk = stage::Walk<kThreads>;

// 16 bytes of words, first word at the lowest address
__device__ __forceinline__ uint4 pack(const uint16_t (&v)[8]) {
  return make_uint4(v[0] | (static_cast<uint32_t>(v[1]) << 16),
                    v[2] | (static_cast<uint32_t>(v[3]) << 16),
                    v[4] | (static_cast<uint32_t>(v[5]) << 16),
                    v[6] | (static_cast<uint32_t>(v[7]) << 16));
}
__device__ __forceinline__ uint4 pack(const uint32_t (&v)[4]) {
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// aligned 16-byte chunks a row segment of `bytes` can touch, the first row
// starting at p and the next ones `stride` bytes apart: exact where the
// stride keeps the alignment, else the most any row needs
__device__ __forceinline__ int chunks(const void* p, long long stride, int bytes) {
  const int lead = static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15);
  return (stride & 15) == 0 ? (lead + bytes + 15) / 16 : (bytes + 30) / 16;
}

// one shear launch: source (F, sH, sW), output (F, dH, dW), tiles of TY x
// TX output cells, n_tx per tile row, n_tiles per frame; tab: bytes of the
// shift tables at the front of shared memory
struct Geo {
  int sH, sW, dH, dW, TY, TX, n_tx, n_tiles, tab;
};

// T[f, y, x] = src[f, y - gy[c], c] with c = x - hx[y] (gy = 0 unless kGy,
// hx = 0 unless kHx), 0 where the index leaves the source.  win[tile] =
// (r_lo, r_hi, c_lo, c_hi): every source element the tile reads lies in it,
// and a source element in it that the formula names is one it reads.
template <typename W, bool kGy, bool kHx>
__global__ void __launch_bounds__(kThreads) shear_kernel(
    const W* __restrict__ src, W* __restrict__ dst, const int* __restrict__ gy,
    const int* __restrict__ hx, const int4* __restrict__ win, Geo g) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int e = sizeof(W);
  constexpr int kVec = 16 / e;
  const int tid = threadIdx.x;

  const int tile = blockIdx.x % g.n_tiles;
  const long long f = blockIdx.x / g.n_tiles;
  const int ty = tile / g.n_tx;
  const int y0 = ty * g.TY;
  const int x0 = (tile - ty * g.n_tx) * g.TX;
  const int rows = min(g.TY, g.dH - y0);
  const int cols = min(g.TX, g.dW - x0);
  const int4 w = __ldg(win + tile);
  const int nr = w.y - w.x;
  const int nc = w.w - w.z;

  // shared memory: hx of the tile's rows (kHx), then gy of the window's
  // columns (kGy), each offset into the window's frame; then the window,
  // element (r, c) at wbase + (r - r_lo) * pitch + (c - c_lo) * e
  int* hxs = reinterpret_cast<int*>(smem);
  int* gys = hxs + (kHx ? g.TY : 0);
  const unsigned char* seg0 = reinterpret_cast<const unsigned char*>(
      src + (f * g.sH + w.x) * static_cast<long long>(g.sW) + w.z);
  const int wbase = g.tab + 16 + static_cast<int>(reinterpret_cast<uintptr_t>(seg0) & 15);
  const long long stride = static_cast<long long>(g.sW) * e;
  const int nbytes = nc * e;
  const int pitch = static_cast<int>(seg_pitch(nbytes, stride));
  // an empty tile (nr = nc = 0) stages nothing, and every word of it
  // fails the window test below
  if (nc > 0) {
    const int n_chunk = chunks(seg0, stride, nbytes);
    for (Walk it(tid, n_chunk); it.r < nr; it.next()) {
      const unsigned char* a = seg0 + it.r * stride;
      const int off = it.c * 16 - static_cast<int>(reinterpret_cast<uintptr_t>(a) & 15);
      if (off < nbytes) cp_async16(smem + wbase + it.r * pitch + off, a + off);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  if (kHx) {  // c - c_lo = x - hxs[y - y0]
    for (int i = tid; i < rows; i += kThreads) hxs[i] = __ldg(hx + y0 + i) + w.z;
  }
  if (kGy) {  // r - r_lo = y - gys[c - c_lo]
    for (int k = tid; k < nc; k += kThreads) gys[k] = __ldg(gy + w.z + k) + w.x;
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  // ---- the tile's rows out: 16-byte stores, word by word at the ragged
  // ends ----
  W* orow0 = dst + (f * g.dH + y0) * static_cast<long long>(g.dW) + x0;
  const long long ostride = static_cast<long long>(g.dW) * e;
  const int obytes = cols * e;
  const int o_chunk = chunks(orow0, ostride, obytes);
  for (Walk it(tid, o_chunk); it.r < rows; it.next()) {
    unsigned char* a = reinterpret_cast<unsigned char*>(orow0) + it.r * ostride;
    const int off = it.c * 16 - static_cast<int>(reinterpret_cast<uintptr_t>(a) & 15);
    if (off >= obytes) continue;
    const int y = y0 + it.r;
    const int c0 = off / e + (kHx ? x0 - hxs[it.r] : x0 - w.z);  // c - c_lo of word 0
    const int r_row = y - w.x;                                   // r - r_lo without kGy
    W v[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int c = c0 + j;
      v[j] = W(0);
      if (static_cast<unsigned>(c) < static_cast<unsigned>(nc)) {
        const int r = kGy ? y - gys[c] : r_row;
        if (static_cast<unsigned>(r) < static_cast<unsigned>(nr)) {
          v[j] = *reinterpret_cast<const W*>(smem + wbase + r * pitch + c * e);
        }
      }
    }
    if (off >= 0 && off + 16 <= obytes) {
      *reinterpret_cast<uint4*>(a + off) = pack(v);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const int k = off + j * e;
        if (k >= 0 && k < obytes) *reinterpret_cast<W*>(a + k) = v[j];
      }
    }
  }
}

// Dynamic shared memory of a shear block with windows of at most win_rows x
// win_cols words of e bytes (ops/cuda_shear.shear_smem is the same sum):
// the shift tables, then 16 bytes of lead, the rows at their pitch (a row's
// aligned chunks reach 15 bytes before it and 16 past it), 32 bytes of tail.
long long shear_smem(bool use_gy, bool use_hx, int TY, int win_rows, int win_cols, int e) {
  const long long tab = up16(4LL * ((use_hx ? TY : 0) + (use_gy ? win_cols : 0)));
  return tab + 48 + static_cast<long long>(win_rows) * (static_cast<long long>(win_cols) * e + 47);
}

// launch one shear form (above 48 KB of shared memory, stage::opt_in)
template <typename W, bool kGy, bool kHx>
int launch_shear(const void* src, void* dst, const void* gy, const void* hx, const void* win,
                 int F, int sH, int sW, int dH, int dW, int TY, int TX, int win_rows,
                 int win_cols, cudaStream_t stream) {
  Geo g;
  g.sH = sH;
  g.sW = sW;
  g.dH = dH;
  g.dW = dW;
  g.TY = TY;
  g.TX = TX;
  g.n_tx = (dW + TX - 1) / TX;
  g.n_tiles = ((dH + TY - 1) / TY) * g.n_tx;
  g.tab = static_cast<int>(up16(4LL * ((kHx ? TY : 0) + (kGy ? win_cols : 0))));
  const long long blocks = static_cast<long long>(F) * g.n_tiles;
  const long long smem = shear_smem(kGy, kHx, TY, win_rows, win_cols, sizeof(W));
  if (blocks > INT_MAX || smem > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  auto kern = shear_kernel<W, kGy, kHx>;
  static std::atomic<int> opted_in[stage::kMaxDevices];  // kern's limit per device
  if (const int e = stage::opt_in(reinterpret_cast<const void*>(kern), smem, opted_in)) return e;
  kern<<<static_cast<unsigned>(blocks), kThreads, static_cast<size_t>(smem), stream>>>(
      static_cast<const W*>(src), static_cast<W*>(dst), static_cast<const int*>(gy),
      static_cast<const int*>(hx), static_cast<const int4*>(win), g);
  return static_cast<int>(cudaGetLastError());
}

template <bool kGy, bool kHx>
int shear(const void* src, void* dst, const void* gy, const void* hx, const void* win, int F,
          int sH, int sW, int dH, int dW, int TY, int TX, int win_rows, int win_cols,
          int elem_bytes, void* stream) {
  if (F <= 0 || sH <= 0 || sW <= 0 || dH <= 0 || dW <= 0 || TY <= 0 || TX <= 0 ||
      win_rows < 0 || win_cols < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 2) {
    return launch_shear<uint16_t, kGy, kHx>(src, dst, gy, hx, win, F, sH, sW, dH, dW, TY, TX,
                                            win_rows, win_cols, st);
  }
  if (elem_bytes == 4) {
    return launch_shear<uint32_t, kGy, kHx>(src, dst, gy, hx, win, F, sH, sW, dH, dW, TY, TX,
                                            win_rows, win_cols, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// elem_bytes: 2 (bf16) or 4 (f32); the shears move raw words.  win: the
// form's tile table, (tiles, 4) int32 (ops/cuda_shear.shear_tiles), for
// tiles of TY x TX output cells; win_rows x win_cols bounds every window.
extern "C" int aainterp_vshear(const void* q, void* s, const void* gy, const void* win, int F,
                               int qH, int qW, int TH, int TY, int TX, int win_rows,
                               int win_cols, int elem_bytes, void* stream) {
  if (TH < qH) return static_cast<int>(cudaErrorInvalidValue);
  return shear<true, false>(q, s, gy, nullptr, win, F, qH, qW, TH, qW, TY, TX, win_rows,
                            win_cols, elem_bytes, stream);
}

extern "C" int aainterp_hshear(const void* s, void* t, const void* hx, const void* win, int F,
                               int TH, int qW, int TW, int TY, int TX, int win_rows,
                               int win_cols, int elem_bytes, void* stream) {
  if (TW < qW) return static_cast<int>(cudaErrorInvalidValue);
  return shear<false, true>(s, t, nullptr, hx, win, F, TH, qW, TH, TW, TY, TX, win_rows,
                            win_cols, elem_bytes, stream);
}

extern "C" int aainterp_vhshear(const void* q, void* t, const void* gy, const void* hx,
                                const void* win, int F, int qH, int qW, int TH, int TW,
                                int TY, int TX, int win_rows, int win_cols, int elem_bytes,
                                void* stream) {
  if (TH < qH || TW < qW) return static_cast<int>(cudaErrorInvalidValue);
  return shear<true, true>(q, t, gy, hx, win, F, qH, qW, TH, TW, TY, TX, win_rows, win_cols,
                           elem_bytes, stream);
}

namespace {

// the direct form, masked (span is (Hd, 2) int32) or, with span null, its
// unmasked instance
int contract_launch(const void* t, void* out, const void* ry0, const void* cx0,
                    const void* w2, const void* span, int F, int TH, int TW, int Hd,
                    int Wd, int Ka, int Kb, int dtype_code, void* stream) {
  dim3 grid;
  if (F <= 0 || TH <= 0 || TW <= 0 || Ka <= 0 || Kb <= 0 ||
      !contract::row_grid(Hd, Wd, &grid)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* r = static_cast<const int*>(ry0);
  const int* c = static_cast<const int*>(cx0);
  const float* w = static_cast<const float*>(w2);
  const int* sp = static_cast<const int*>(span);
  if (dtype_code == 0) {
    const float* tt = static_cast<const float*>(t);
    float* o = static_cast<float*>(out);
    if (sp) {
      contract::contract_kernel<float><<<grid, contract::kThreads, 0, st>>>(
          tt, o, r, c, w, sp, F, TH, TW, Hd, Wd, Ka, Kb);
    } else {
      contract::contract_unmasked_kernel<float><<<grid, contract::kThreads, 0, st>>>(
          tt, o, r, c, w, F, TH, TW, Hd, Wd, Ka, Kb);
    }
  } else if (dtype_code == 1) {
    const __nv_bfloat16* tt = static_cast<const __nv_bfloat16*>(t);
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
    if (sp) {
      contract::contract_kernel<__nv_bfloat16><<<grid, contract::kThreads, 0, st>>>(
          tt, o, r, c, w, sp, F, TH, TW, Hd, Wd, Ka, Kb);
    } else {
      contract::contract_unmasked_kernel<__nv_bfloat16>
          <<<grid, contract::kThreads, 0, st>>>(tt, o, r, c, w, F, TH, TW, Hd, Wd, Ka, Kb);
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// the tiled form on n_tx x n_ty tiles of TYd x TXd with smem bytes of
// dynamic shared memory (above 48 KB, stage::opt_in)
template <typename T>
int launch_tiled(const void* t, void* out, const int* r, const int* c, const float* w,
                 const int* sp, const int4* tiles, int F, int TH, int TW, int Hd, int Wd,
                 int Ka, int Kb, int TYd, int TXd, int smem, cudaStream_t st) {
  const long long n_tx = (Wd + TXd - 1) / TXd;
  const long long blocks = n_tx * ((Hd + TYd - 1) / TYd);
  if (blocks > INT_MAX || static_cast<long long>(TYd) * TXd > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  // 16-byte loads where every row of every frame starts 16-byte aligned
  const int vec = reinterpret_cast<uintptr_t>(t) % 16 == 0 &&
                  (static_cast<long long>(TW) * sizeof(T)) % 16 == 0;
  auto kern = contract::contract_tiled_kernel<T>;
  static std::atomic<int> opted_in[stage::kMaxDevices];  // kern's limit per device
  if (const int e = stage::opt_in(reinterpret_cast<const void*>(kern), smem, opted_in)) return e;
  kern<<<static_cast<unsigned>(blocks), contract::kThreads, static_cast<size_t>(smem), st>>>(
      static_cast<const T*>(t), static_cast<T*>(out), r, c, w, sp, tiles, F, TH, TW, Hd, Wd,
      Ka, Kb, TYd, TXd, static_cast<int>(n_tx), vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The route's masked contraction, tiled.  dtype_code: 0 = float32, 1 =
// bfloat16 (T and out share it); span: (Hd, 2) int32, each dst row's live
// columns [lo, hi) (outside them out is 0); tiles: (n_ty * n_tx, 4) int32,
// each TYd x TXd dst tile's T window (r0, c0, rows, cols), rows 0 for a dead
// tile (ops/cuda_shear.contract_tiles); smem: bytes of the largest window.
extern "C" int aainterp_contract(const void* t, void* out, const void* ry0,
                                 const void* cx0, const void* w2, const void* span,
                                 const void* tiles, int F, int TH, int TW, int Hd, int Wd,
                                 int Ka, int Kb, int TYd, int TXd, int smem, int dtype_code,
                                 void* stream) {
  if (span == nullptr || tiles == nullptr || F <= 0 || TH <= 0 || TW <= 0 || Hd <= 0 ||
      Wd <= 0 || Ka <= 0 || Kb <= 0 || TYd <= 0 || TXd <= 0 || smem < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* r = static_cast<const int*>(ry0);
  const int* c = static_cast<const int*>(cx0);
  const float* w = static_cast<const float*>(w2);
  const int* sp = static_cast<const int*>(span);
  const int4* tb = static_cast<const int4*>(tiles);
  if (dtype_code == 0) {
    return launch_tiled<float>(t, out, r, c, w, sp, tb, F, TH, TW, Hd, Wd, Ka, Kb, TYd, TXd,
                               smem, st);
  }
  if (dtype_code == 1) {
    return launch_tiled<__nv_bfloat16>(t, out, r, c, w, sp, tb, F, TH, TW, Hd, Wd, Ka, Kb, TYd,
                                       TXd, smem, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// the same function in the direct form (the route of a plan whose windows
// do not fit in shared memory)
extern "C" int aainterp_contract_direct(const void* t, void* out, const void* ry0,
                                        const void* cx0, const void* w2, const void* span,
                                        int F, int TH, int TW, int Hd, int Wd, int Ka, int Kb,
                                        int dtype_code, void* stream) {
  if (span == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return contract_launch(t, out, ry0, cx0, w2, span, F, TH, TW, Hd, Wd, Ka, Kb,
                         dtype_code, stream);
}

// the direct form without the dead-pixel skip: every dst pixel sums its taps
extern "C" int aainterp_contract_unmasked(const void* t, void* out, const void* ry0,
                                          const void* cx0, const void* w2, int F, int TH,
                                          int TW, int Hd, int Wd, int Ka, int Kb,
                                          int dtype_code, void* stream) {
  return contract_launch(t, out, ry0, cx0, w2, nullptr, F, TH, TW, Hd, Wd, Ka, Kb,
                         dtype_code, stream);
}
