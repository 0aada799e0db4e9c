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
// The kernel moves raw bytes, so any element type of 1, 2, 4 or 8 bytes
// copies bit for bit.
//
// Design: a persistent grid of kBlocksPerSm blocks an SM (fewer where there
// are fewer pieces), each a ring of kStages buffers of kPieceBytes in
// shared memory.  Each span is cut into pieces of kPieceBytes (the last
// one shorter); the pieces of all spans, span-major, are dealt to the
// blocks in turn, so the blocks sweep the frames side by side.  Where a
// span's source and output agree mod 16, its 16-byte aligned body moves
// by 1-D bulk copies (cp.async.bulk, csrc/hopper.cuh): one thread of the
// block loads piece after piece into the ring, each on its stage's
// mbarrier, kStages - 1 loads ahead, stores each piece from its stage as
// soon as it has landed, and reuses a stage once the store from it has
// read its bytes (bulk_wait_read).  No register or issue slot is spent
// per 16 bytes.  The span's unaligned head and its tail of under 16 bytes
// are copied word by word by the block's other warps, which also copy
// every span whose source and output differ mod 16 (an odd row pitch,
// say) on the unit path: the widest unit both share (8 or 4 bytes, else
// the element), each thread keeping kUnroll loads in flight.  Of the
// rings timed on the H100 (chip_sweep.py variants cstage*, cpiece*,
// cbps*), 2 stages of 16 KB and 2 blocks an SM were the fastest; none
// reached the earlier grid's time (PERF.md).
// The earlier form launched one 128-thread block per 8 KB part, 7.6 waves
// at 4K, every byte through registers (chip_sweep.py cells c_*, PERF.md).
//
// The contraction probes are csrc/contract.cuh's forms under one probe
// mode each: noweight on the tiled form (contract_noweight_tiled_kernel,
// a block a dst tile of the live rectangle's table), its first form
// noweight_direct on the direct form; tshare, wshare and bothshare on the
// tiled form (contract_share_kernel); pipelined on a persistent grid of
// the tiled form (contract_pipelined_kernel).  The share and pipelined
// ones read the route's tile table as ell_shear.cu's aainterp_contract
// does.  That header says what each removes and why
// these are the H100 meanings of the TPU probes.
// What bounds them: bytes, the streams each mode still reads (PERF.md).
//
// Plain C interface for ctypes; each launch goes on the caller's stream and
// does not synchronise.  The return value is cudaGetLastError() after the
// launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <climits>

#include "contract.cuh"
#include "hopper.cuh"
#include "stage_common.cuh"

namespace {

constexpr int kCopyThreads = 128;
constexpr int kUnroll = 4;
// the ring: a piece of each span's aligned body per bulk copy, kStages
// stages in shared memory, kBlocksPerSm blocks an SM
constexpr long long kPieceBytes = 16 * 1024;
constexpr int kStages = 2;
constexpr int kBlocksPerSm = 2;
// the threads that copy words and units: warps 1 and up (warp 0 issues the
// bulk copies)
constexpr int kWordThreads = kCopyThreads - 32;

__device__ __forceinline__ uintptr_t addr(const void* p) {
  return reinterpret_cast<uintptr_t>(p);
}

// units [lo, hi) of U from s to d (s and d aligned to U), by thread tid of
// the step threads that share the range
template <typename U>
__device__ __forceinline__ void copy_units(const unsigned char* s, unsigned char* d,
                                           long long lo, long long hi, int tid, int step) {
  const U* su = reinterpret_cast<const U*>(s);
  U* du = reinterpret_cast<U*>(d);
  long long i = lo + tid;
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
                                          long long n, int part, int parts, int tid,
                                          int step) {
  constexpr long long u = sizeof(U);
  constexpr long long w = sizeof(Word);
  const long long head = min(n, static_cast<long long>((u - (addr(s) & (u - 1))) & (u - 1)));
  const long long units = (n - head) / u;
  const long long end = head + units * u;
  if (part == 0) copy_units<Word>(s, d, 0, head / w, tid, step);
  copy_units<U>(s + head, d + head, units * part / parts, units * (part + 1) / parts, tid,
                step);
  if (part == parts - 1) copy_units<Word>(s + end, d + end, 0, (n - end) / w, tid, step);
}

// the copy's geometry: row tiles of `tile` bytes, nt a frame `src_frame`
// bytes apart in the source, packed in the output; pps pieces a span
struct CopyGeo {
  const unsigned char* src;
  unsigned char* dst;
  long long src_frame, tile;
  int nt, pps;

  // span `span`'s source and output
  __device__ __forceinline__ const unsigned char* s(long long span) const {
    const long long f = span / nt;
    return src + f * src_frame + (span - f * nt) * tile;
  }
  __device__ __forceinline__ unsigned char* d(long long span) const { return dst + span * tile; }
  // bytes of the head of a span whose source agrees with its output mod
  // 16: up to its first 16-byte aligned byte
  __device__ __forceinline__ long long head(const unsigned char* s) const {
    return min(tile, static_cast<long long>((16 - (addr(s) & 15)) & 15));
  }
};

// The next piece g, g + step, ... (below hi) that moves by bulk copies:
// its span agrees mod 16 and the piece holds bytes of the body; false if
// none.
__device__ __forceinline__ bool next_bulk(const CopyGeo& c, long long& g, long long step,
                                          long long hi, const unsigned char*& s,
                                          unsigned char*& d, uint32_t& bytes) {
  for (; g < hi; g += step) {
    const long long span = g / c.pps;
    const long long off = (g - span * c.pps) * kPieceBytes;
    const unsigned char* ss = c.s(span);
    unsigned char* dd = c.d(span);
    if ((addr(ss) ^ addr(dd)) & 15) continue;
    const long long head = c.head(ss);
    const long long body = (c.tile - head) / 16 * 16;
    if (off >= body) continue;
    s = ss + head + off;
    d = dd + head + off;
    bytes = static_cast<uint32_t>(min(kPieceBytes, body - off));
    return true;
  }
  return false;
}

// block b copies pieces b, b + G, b + 2G, ... of the spans' pieces
// (span-major, pps a span), so the blocks sweep the frames side by side:
// thread 0 their bulk bodies through the ring, warps 1 and up their words
// and unit-path spans
template <typename Word>
__global__ void __launch_bounds__(kCopyThreads) copy_rows_kernel(CopyGeo c, long long pieces) {
  // the ring's stages, then their mbarriers (all dynamic: a kernel with
  // static shared memory cannot opt in to the whole limit)
  extern __shared__ __align__(128) unsigned char ring[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(ring + kStages * kPieceBytes);
  const long long lo = blockIdx.x, step = gridDim.x, hi = pieces;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) hopper::mbar_init(&bar[i], 1);
    hopper::fence_mbarrier_init();
    long long gl = lo, gs = lo;      // the next piece to load, to store
    int nl = 0;                      // loads issued
    const unsigned char* s;
    unsigned char* d;
    uint32_t bytes;
    for (; nl < kStages - 1 && next_bulk(c, gl, step, hi, s, d, bytes); ++nl, gl += step) {
      hopper::mbar_arrive_expect_tx(&bar[nl], bytes);
      hopper::bulk_load(ring + nl * kPieceBytes, s, bytes, &bar[nl]);
    }
    for (int i = 0; next_bulk(c, gs, step, hi, s, d, bytes); ++i, gs += step) {
      const int st = i % kStages;
      hopper::mbar_wait(&bar[st], (i / kStages) & 1);
      hopper::bulk_store(d, ring + st * kPieceBytes, bytes);
      hopper::bulk_commit();
      // piece i + kStages - 1 into stage (i - 1) % kStages, once the store
      // of piece i - 1 from it has read its bytes
      if (next_bulk(c, gl, step, hi, s, d, bytes)) {
        hopper::bulk_wait_read<1>();
        const int sl = nl % kStages;
        hopper::mbar_arrive_expect_tx(&bar[sl], bytes);
        hopper::bulk_load(ring + sl * kPieceBytes, s, bytes, &bar[sl]);
        ++nl;
        gl += step;
      }
    }
    hopper::bulk_wait_all();
    return;
  }
  if (threadIdx.x < 32) return;
  const int tid = threadIdx.x - 32;
  constexpr long long w = sizeof(Word);
  for (long long g = lo; g < hi; g += step) {
    const long long span = g / c.pps;
    const int part = static_cast<int>(g - span * c.pps);
    const unsigned char* s = c.s(span);
    unsigned char* d = c.d(span);
    const uintptr_t mis = addr(s) ^ addr(d);
    if ((mis & 15) == 0) {
      const long long head = c.head(s);
      const long long end = head + (c.tile - head) / 16 * 16;
      if (part == 0) copy_units<Word>(s, d, 0, head / w, tid, kWordThreads);
      if (part == c.pps - 1) {
        copy_units<Word>(s + end, d + end, 0, (c.tile - end) / w, tid, kWordThreads);
      }
    } else if ((mis & 7) == 0) {
      copy_span<uint2, Word>(s, d, c.tile, part, c.pps, tid, kWordThreads);
    } else if ((mis & 3) == 0) {
      copy_span<uint32_t, Word>(s, d, c.tile, part, c.pps, tid, kWordThreads);
    } else {
      copy_span<Word, Word>(s, d, c.tile, part, c.pps, tid, kWordThreads);
    }
  }
}

template <typename Word>
int launch_copy(const void* src, void* dst, int F, int H, int W, int TY, cudaStream_t st) {
  const int nt = H / TY;
  const long long row = static_cast<long long>(W) * sizeof(Word);
  CopyGeo c;
  c.src = static_cast<const unsigned char*>(src);
  c.dst = static_cast<unsigned char*>(dst);
  c.src_frame = static_cast<long long>(H) * row;
  c.tile = static_cast<long long>(TY) * row;
  c.nt = nt;
  const long long pps = (c.tile + kPieceBytes - 1) / kPieceBytes;
  const long long pieces = static_cast<long long>(F) * nt * pps;
  if (nt <= 0 || pps > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  c.pps = static_cast<int>(pps);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long blocks = std::min(pieces, static_cast<long long>(sms) * kBlocksPerSm);
  const long long smem = kStages * (kPieceBytes + 8);
  auto kern = copy_rows_kernel<Word>;
  static std::atomic<int> opted_in[stage::kMaxDevices];  // kern's limit per device
  if (const int r = stage::opt_in(reinterpret_cast<const void*>(kern), smem, opted_in)) return r;
  kern<<<static_cast<unsigned>(blocks), kCopyThreads, static_cast<size_t>(smem), st>>>(c, pieces);
  return static_cast<int>(cudaGetLastError());
}

// the contraction probes' arguments: aainterp_contract's, plus the tile
// whose weights wshare reads and the pipelined form's tile order
struct ProbeArgs {
  const void* t;
  void* out;
  const int* ry0;
  const int* cx0;
  const float* w2;
  const int* span;
  const int4* tiles;
  const int* order;
  int F, TH, TW, Hd, Wd, Ka, Kb, TYd, TXd, smem, wtile, n_live;
};

// noweight's first form: the direct form, a thread a dst pixel, 0 outside
// the live rectangle's span
template <typename T>
int launch_noweight_direct(const ProbeArgs& a, cudaStream_t st) {
  dim3 grid;
  if (!contract::row_grid(a.Hd, a.Wd, &grid)) return static_cast<int>(cudaErrorInvalidValue);
  contract::contract_noweight_kernel<T><<<grid, contract::kThreads, 0, st>>>(
      static_cast<const T*>(a.t), static_cast<T*>(a.out), a.ry0, a.cx0, a.span, a.F, a.TH, a.TW,
      a.Hd, a.Wd, a.Ka, a.Kb);
  return static_cast<int>(cudaGetLastError());
}

// dst tiles of TYd x TXd (n_tx a row); false if they overflow an int
inline bool tile_count(const ProbeArgs& a, int* n_tx, int* n_tiles) {
  const long long nx = (a.Wd + a.TXd - 1) / a.TXd;
  const long long n = nx * ((a.Hd + a.TYd - 1) / a.TYd);
  if (n > INT_MAX || static_cast<long long>(a.TYd) * a.TXd > INT_MAX) return false;
  *n_tx = static_cast<int>(nx);
  *n_tiles = static_cast<int>(n);
  return true;
}

// 16-byte loads where every row of every frame starts 16-byte aligned
template <typename T>
int aligned_rows(const ProbeArgs& a) {
  return reinterpret_cast<uintptr_t>(a.t) % 16 == 0 &&
         (static_cast<long long>(a.TW) * sizeof(T)) % 16 == 0;
}

// a share probe: a block a dst tile, a.smem bytes of dynamic shared memory
template <typename T, contract::Probe P>
int launch_share(const ProbeArgs& a, cudaStream_t st) {
  int n_tx, n_tiles;
  if (!tile_count(a, &n_tx, &n_tiles) || a.wtile < 0 || a.wtile >= n_tiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kern = contract::contract_share_kernel<T, P>;
  static std::atomic<int> opted_in[stage::kMaxDevices];  // kern's limit per device
  if (const int e = stage::opt_in(reinterpret_cast<const void*>(kern), a.smem, opted_in)) return e;
  kern<<<static_cast<unsigned>(n_tiles), contract::kThreads, static_cast<size_t>(a.smem), st>>>(
      static_cast<const T*>(a.t), static_cast<T*>(a.out), a.ry0, a.cx0, a.w2, a.span, a.tiles,
      a.F, a.TH, a.TW, a.Hd, a.Wd, a.Ka, a.Kb, a.TYd, a.TXd, n_tx, aligned_rows<T>(a), a.wtile,
      0);
  return static_cast<int>(cudaGetLastError());
}

// noweight on the tiled form: a block a dst tile of the live rectangle's
// table, a.smem bytes of dynamic shared memory
template <typename T>
int launch_noweight(const ProbeArgs& a, cudaStream_t st) {
  int n_tx, n_tiles;
  if (!tile_count(a, &n_tx, &n_tiles)) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = contract::contract_noweight_tiled_kernel<T>;
  static std::atomic<int> opted_in[stage::kMaxDevices];  // kern's limit per device
  if (const int e = stage::opt_in(reinterpret_cast<const void*>(kern), a.smem, opted_in)) return e;
  kern<<<static_cast<unsigned>(n_tiles), contract::kThreads, static_cast<size_t>(a.smem), st>>>(
      static_cast<const T*>(a.t), static_cast<T*>(a.out), a.ry0, a.cx0, a.span, a.tiles, a.F,
      a.TH, a.TW, a.Hd, a.Wd, a.Ka, a.Kb, a.TYd, a.TXd, n_tx, aligned_rows<T>(a));
  return static_cast<int>(cudaGetLastError());
}

// the pipelined probe: two windows of a.smem bytes a block, as many blocks
// an SM as they and the registers allow, on every SM (fewer where there are
// fewer tiles)
template <typename T>
int launch_pipelined(const ProbeArgs& a, cudaStream_t st) {
  int n_tx, n_tiles;
  if (!tile_count(a, &n_tx, &n_tiles) || a.TYd * a.TXd > contract::kThreads || a.smem % 128 ||
      a.order == nullptr || a.n_live < 0 || a.n_live > n_tiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int threads = contract::kThreads + contract::kStageThreads;
  const long long smem = 2LL * a.smem;
  auto kern = contract::contract_pipelined_kernel<T>;
  static std::atomic<int> opted_in[stage::kMaxDevices];  // kern's limit per device
  if (const int e = stage::opt_in(reinterpret_cast<const void*>(kern), smem, opted_in)) return e;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                      static_cast<size_t>(smem));
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long blocks = std::min(static_cast<long long>(n_tiles),
                                    static_cast<long long>(sms) * per_sm);
  kern<<<static_cast<unsigned>(blocks), threads, static_cast<size_t>(smem), st>>>(
      static_cast<const T*>(a.t), static_cast<T*>(a.out), a.ry0, a.cx0, a.w2, a.span, a.tiles,
      a.order, a.F, a.TH, a.TW, a.Hd, a.Wd, a.Ka, a.Kb, a.TYd, a.TXd, n_tx, aligned_rows<T>(a),
      n_tiles, a.n_live, a.smem / 16);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int probe(int mode, const ProbeArgs& a, cudaStream_t st) {
  switch (mode) {
    case contract::kNoWeight:
      return launch_noweight<T>(a, st);
    case contract::kTShare:
      return launch_share<T, contract::kTShare>(a, st);
    case contract::kWShare:
      return launch_share<T, contract::kWShare>(a, st);
    case contract::kBothShare:
      return launch_share<T, contract::kBothShare>(a, st);
    case contract::kPipelined:
      return launch_pipelined<T>(a, st);
    case contract::kNoWeightDirect:
      return launch_noweight_direct<T>(a, st);
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
// 5 = pipelined, 6 = noweight_direct; dtype_code: 0 = float32, 1 = bfloat16
// (T and out share it).  The arguments are aainterp_contract's
// (csrc/ell_shear.cu): span (Hd, 2) int32, each dst row's live columns;
// tiles (n_ty * n_tx, 4) int32, each TYd x TXd dst tile's T window, rows 0
// for a dead tile; smem the bytes of the largest window; wtile the tile
// whose weights wshare and bothshare read; order (n_ty * n_tx,) int32, the
// tiles in the order the pipelined form deals them out, its n_live live
// tiles first (the other modes do not read it: it may be null).  noweight
// and noweight_direct take the live rectangle's span
// (rot_experiments.noweight_span) and noweight its tiles; neither reads
// w2 (it may be null).  noweight_direct (the direct form) reads no tiles:
// they may be null, and TYd, TXd, smem and wtile are not read.
extern "C" int aainterp_contract_probe(const void* t, void* out, const void* ry0,
                                       const void* cx0, const void* w2, const void* span,
                                       const void* tiles, const void* order, int F, int TH,
                                       int TW, int Hd, int Wd, int Ka, int Kb, int TYd, int TXd,
                                       int smem, int wtile, int n_live, int mode,
                                       int dtype_code, void* stream) {
  const bool tiled = mode != contract::kNoWeightDirect;
  if (F <= 0 || TH <= 0 || TW <= 0 || Hd <= 0 || Wd <= 0 || Ka <= 0 || Kb <= 0 ||
      span == nullptr ||
      (tiled && (tiles == nullptr || TYd <= 0 || TXd <= 0 || smem < 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ProbeArgs a{t, out, static_cast<const int*>(ry0), static_cast<const int*>(cx0),
                    static_cast<const float*>(w2), static_cast<const int*>(span),
                    static_cast<const int4*>(tiles), static_cast<const int*>(order), F, TH,
                    TW, Hd, Wd, Ka, Kb, TYd, TXd, smem, wtile, n_live};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype_code == 0) return probe<float>(mode, a, st);
  if (dtype_code == 1) return probe<__nv_bfloat16>(mode, a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
