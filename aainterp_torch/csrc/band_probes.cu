// Kernel 1's probe modes for Hopper (sm_90a): the production separable
// kernel (csrc/band_apply.cuh, band_apply_kernel, clamped taps, IEEE f32)
// with one thing changed per mode, at kernel 1's own plan
// (ops/cuda_apply.band_plan: 8 x 240 dst tiles at the 4K flagship).
//
// Replaces the TPU Pallas probes of benchmarks/:
//
//   kRingStage,          <- flagship_experiments.py:73 _build_band_probe
//   kRingStageY             (pallas_call at :137; with_y False "dma", True
//                           "ypass") and u8_experiments.py:86
//                           _build_stage_probe (:226) stages dma, ydot,
//                           xstore (band_stage_kernel, aainterp_band_stage);
//                           kStage, kStageY, their first form (one block a
//                           tile), stay as the modes stage_direct and
//                           stagey_direct
//   kWalk2/3/4           <- flagship_experiments.py:144 _build_full_nslot
//                           (:218): full2, full3, full4
//   kRingWords           <- flagship_experiments.py:341 _build_u8bitcast
//                           (:428), in the byte order that :305
//                           discover_u8_pack_order asks the TPU for (on the
//                           card a 32-bit word holds 4 neighbouring pixels of
//                           a row, little-endian), on the stage ring; its
//                           first form kU8Words stays as u8words_direct
//   kU8Convert1/2/4      <- u8_experiments.py stage extract (n = 1) and
//                           flagship_experiments.py:497 _build_u8chunk
//                           (:591; n = 2, 4)
//   kRingPair            <- u8_experiments.py:86 stage xpair (:150-169), on
//                           the stage ring; its first form kXPair stays as
//                           xpair_direct
//   kRingStage,          <- rgb1024_experiments.py:88 _build_band_probe
//   kRingStageY             (pallas_call at :141; "dma", "ypass"), at 1024^2
//                           150 -> 60 dpi
//   kXOnly               <- rgb1024_experiments.py:148 _build_xonly (:174)
//
// (rgb1024_experiments.py:181 _build_full_dense_x, the dense x probe, is
// csrc/dense_x.cu's, on the tensor cores.)
//
// What each keeps and stores (band_apply.cuh's Probe): kStage the window
// staging and the output stores (the first tap's pixel); kStageY those and
// the y pass (T at the first x tap); kRingStage and kRingStageY the same
// from a persistent grid whose blocks walk their shares of the tiles
// through a ring of 2 windows filled by a producer warp with bulk copies,
// the y pass register-blocked over the tile's rows; kRingWords and
// kRingPair production's output on the same ring, the y pass reading one
// aligned 32-bit word of 4 u8 pixels a tap row into T, or no T at all and
// an x pass for an exact ratio-2 band from a (4, Wd) table fed from each
// lane's y sums in registers, 4 dst pixels stored as one word; kWalk<n>
// production's output from a persistent grid whose blocks walk their
// shares of the tiles through a ring of n windows, filled by a producer
// warp with bulk copies; kU8Words, kU8Convert<n> and kXPair (the first
// forms) production's output with the y pass reading 4 u8 pixels per
// 32-bit word, the window converted to bf16 in shared memory in n column
// chunks (chunk c + 1 converted while chunk c is y-passed), or an x pass
// for an exact ratio-2 band from a (4, Wd) table through T; kXOnly
// production's x pass alone, its T
// converted from the tile's rows of an input that holds the y pass's
// output, (F, Hd, W) in the frame dtype (H passed as Hd), staged as the
// window is.  What bounds them: bytes, as kernel 1; a mode
// whose shared memory exceeds the card's opt-in returns
// cudaErrorInvalidValue before any launch (the host checks it first).
//
// Plain C interface for ctypes; the launch goes on the caller's stream and
// does not synchronise.  The return value is cudaGetLastError() after the
// launch (0 on success).

#include <algorithm>

#include "band_apply.cuh"

namespace {

using band::Dims;
using band::Geo;

// the probe's dynamic shared memory: the walk's layout (g from walk_geo),
// or production's plus the two bf16 chunk buffers (one for a single chunk)
template <int P>
long long probe_smem(const Geo& g, const Dims& d) {
  constexpr int kChunks = band::convert_chunks(P);
  if constexpr (kChunks > 0) {
    return g.smem + (kChunks > 1 ? 2 : 1) *
                        band::up16(static_cast<long long>(d.SY) *
                                   band::convert_pitch(d.SX, kChunks));
  }
  return g.smem;
}

// a persistent grid's geometry for `kern` at `smem` bytes a block (kThreads
// consumers and a producer warp): SMs, blocks an SM from its occupancy,
// registers a thread (0 or a cudaError_t; cudaErrorInvalidValue where smem
// exceeds the opt-in)
int grid_occupancy(const void* kern, long long smem, std::atomic<int> (&opted_in)[stage::kMaxDevices],
                   int* sms, int* per_sm, int* regs) {
  if (const int e = stage::opt_in(kern, smem, opted_in)) return e;
  int dev = 0;
  cudaFuncAttributes attr;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kern, band::kThreads + 32,
                                                      static_cast<size_t>(smem));
  }
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kern);
  if (e != cudaSuccess) return static_cast<int>(e);
  *regs = attr.numRegs;
  return *per_sm > 0 ? 0 : static_cast<int>(cudaErrorInvalidConfiguration);
}

// the walk's persistent grid (band_walk_kernel)
template <typename Tin, typename Tout, int kSlots>
int walk_occupancy(long long smem, int* sms, int* per_sm, int* regs) {
  static std::atomic<int> opted_in[stage::kMaxDevices];  // the kernel's limit per device
  return grid_occupancy(reinterpret_cast<const void*>(band::band_walk_kernel<Tin, Tout, kSlots>),
                        smem, opted_in, sms, per_sm, regs);
}

// the stage ring's persistent grid (band_stage_kernel)
template <typename Tin, typename Tout, int P>
int stage_occupancy(long long smem, int* sms, int* per_sm, int* regs) {
  static std::atomic<int> opted_in[stage::kMaxDevices];  // the kernel's limit per device
  return grid_occupancy(reinterpret_cast<const void*>(band::band_stage_kernel<Tin, Tout, P>),
                        smem, opted_in, sms, per_sm, regs);
}

template <typename Tin, typename Tout, int P>
int launch_probe(const void* src, void* out, const void* ys, const void* wy, const void* xs,
                 const void* wx, const void* row_base, const void* col_base, int F, Dims d,
                 cudaStream_t stream) {
  constexpr int kSlots = band::walk_slots(P);
  d.n_strip = (d.Wd + d.TX - 1) / d.TX;
  d.n_rt = (d.Hd + d.TY - 1) / d.TY;
  const Geo g = kSlots > 0 ? band::walk_geo(d, sizeof(Tin), sizeof(Tout), kSlots)
                           : band::make_geo(d, sizeof(Tin), sizeof(Tout));
  const long long smem = probe_smem<P>(g, d);
  if (smem > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const long long items = static_cast<long long>(F) * d.n_strip * d.n_rt;
  if (items > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const Tin* s = static_cast<const Tin*>(src);
  Tout* o = static_cast<Tout*>(out);
  const int* y = static_cast<const int*>(ys);
  const float* a = static_cast<const float*>(wy);
  const int* x = static_cast<const int*>(xs);
  const float* b = static_cast<const float*>(wx);
  const int* rb = static_cast<const int*>(row_base);
  const int* cb = static_cast<const int*>(col_base);
  const size_t bytes = static_cast<size_t>(smem);
  if constexpr (kSlots > 0) {
    int sms = 0, per_sm = 0, regs = 0;
    if (const int e = walk_occupancy<Tin, Tout, kSlots>(smem, &sms, &per_sm, &regs)) return e;
    const long long blocks = std::min(items, static_cast<long long>(sms) * per_sm);
    band::band_walk_kernel<Tin, Tout, kSlots>
        <<<static_cast<unsigned>(blocks), band::kThreads + 32, bytes, stream>>>(
            s, o, y, a, x, b, rb, cb, d, g, items);
  } else {
    auto kern = band::band_apply_kernel<Tin, Tout, 0, true, P>;
    static std::atomic<int> opted_in[stage::kMaxDevices];  // kern's limit per device
    if (const int e = stage::opt_in(reinterpret_cast<const void*>(kern), smem, opted_in)) {
      return e;
    }
    kern<<<static_cast<unsigned>(items), band::kThreads, bytes, stream>>>(s, o, y, a, x, b, rb,
                                                                          cb, d, g);
  }
  return static_cast<int>(cudaGetLastError());
}

// the stage ring (function P: kRingStage, kRingStageY, kRingWords,
// kRingPair): its grid, min(tiles, SMs x blocks an SM); `geo` (SMs, blocks
// an SM, registers, shared memory) is filled and nothing launched where it
// is given
template <typename Tin, typename Tout, int P>
int launch_stage(const void* src, void* out, const void* ys, const void* wy, const void* xs,
                 const void* wx, const void* row_base, const void* col_base, int F, Dims d,
                 cudaStream_t stream, int* geo) {
  d.n_strip = (d.Wd + d.TX - 1) / d.TX;
  d.n_rt = (d.Hd + d.TY - 1) / d.TY;
  const Geo g = band::stage_geo(d, sizeof(Tin), sizeof(Tout), P);
  if (g.smem == INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const long long items = static_cast<long long>(F) * d.n_strip * d.n_rt;
  if (items > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  int sms = 0, per_sm = 0, regs = 0;
  if (const int e = stage_occupancy<Tin, Tout, P>(g.smem, &sms, &per_sm, &regs)) return e;
  if (geo != nullptr) {
    geo[0] = sms;
    geo[1] = per_sm;
    geo[2] = regs;
    geo[3] = g.smem;
    return 0;
  }
  const long long blocks = std::min(items, static_cast<long long>(sms) * per_sm);
  band::band_stage_kernel<Tin, Tout, P>
      <<<static_cast<unsigned>(blocks), band::kThreads + 32, static_cast<size_t>(g.smem),
         stream>>>(static_cast<const Tin*>(src), static_cast<Tout*>(out),
                   static_cast<const int*>(ys), static_cast<const float*>(wy),
                   static_cast<const int*>(xs), static_cast<const float*>(wx),
                   static_cast<const int*>(row_base), static_cast<const int*>(col_base), d, g,
                   items);
  return static_cast<int>(cudaGetLastError());
}

// the stage ring's arguments, checked: 0 or cudaErrorInvalidValue.  The
// word and pair functions take u8 alone, the pair's table 4 taps at most
int stage_args(int H, int W, int Hd, int Wd, int ky, int kx, int TY, int TX, int SY, int SX,
               int mode, int dtype_code) {
  const bool u8_fn = mode == band::kRingWords || mode == band::kRingPair;
  const bool ok = H > 0 && W > 0 && Hd > 0 && Wd > 0 && ky > 0 && kx > 0 && TY > 0 &&
                  TY <= band::kStageRows && TX > 0 && TX <= band::kThreads && SY >= ky &&
                  SX >= kx && mode >= band::kRingStage && mode <= band::kRingPair &&
                  dtype_code >= 0 && dtype_code <= 2 && (!u8_fn || dtype_code == 2) &&
                  (mode != band::kRingPair || kx <= 4);
  return ok ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// the stage ring's instance for mode (kRingStage .. kRingPair, checked by
// stage_args) and element type T, in = out
template <typename T>
int stage_modes(int mode, const void* src, void* out, const void* ys, const void* wy,
                const void* xs, const void* wx, const void* rb, const void* cb, int F,
                const Dims& d, cudaStream_t st, int* geo) {
  if constexpr (sizeof(T) == 1) {
    if (mode == band::kRingWords) {
      return launch_stage<T, T, band::kRingWords>(src, out, ys, wy, xs, wx, rb, cb, F, d, st,
                                                  geo);
    }
    if (mode == band::kRingPair) {
      return launch_stage<T, T, band::kRingPair>(src, out, ys, wy, xs, wx, rb, cb, F, d, st,
                                                 geo);
    }
  }
  return mode == band::kRingStageY
             ? launch_stage<T, T, band::kRingStageY>(src, out, ys, wy, xs, wx, rb, cb, F, d, st,
                                                     geo)
             : launch_stage<T, T, band::kRingStage>(src, out, ys, wy, xs, wx, rb, cb, F, d, st,
                                                    geo);
}

int stage_dispatch(int mode, int dtype_code, const void* src, void* out, const void* ys,
                   const void* wy, const void* xs, const void* wx, const void* rb,
                   const void* cb, int F, const Dims& d, cudaStream_t st, int* geo) {
  switch (dtype_code) {
    case 0: return stage_modes<float>(mode, src, out, ys, wy, xs, wx, rb, cb, F, d, st, geo);
    case 1:
      return stage_modes<__nv_bfloat16>(mode, src, out, ys, wy, xs, wx, rb, cb, F, d, st, geo);
    default: return stage_modes<uint8_t>(mode, src, out, ys, wy, xs, wx, rb, cb, F, d, st, geo);
  }
}

// the walk's launch geometry (aainterp_band_walk_grid)
template <typename T>
int walk_grid(int mode, const Dims& d, int* out) {
  const int smem = band::walk_geo(d, sizeof(T), sizeof(T), band::walk_slots(mode)).smem;
  out[3] = smem;
  switch (mode) {
    case band::kWalk2: return walk_occupancy<T, T, 2>(smem, &out[0], &out[1], &out[2]);
    case band::kWalk3: return walk_occupancy<T, T, 3>(smem, &out[0], &out[1], &out[2]);
    case band::kWalk4: return walk_occupancy<T, T, 4>(smem, &out[0], &out[1], &out[2]);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the flagship module's modes, in = out = float32 or bfloat16
template <typename T>
int float_modes(int mode, const void* src, void* out, const void* ys, const void* wy,
                const void* xs, const void* wx, const void* rb, const void* cb, int F,
                const Dims& d, cudaStream_t st) {
  switch (mode) {
    case band::kStage: return launch_probe<T, T, band::kStage>(src, out, ys, wy, xs, wx, rb, cb, F, d, st);
    case band::kStageY: return launch_probe<T, T, band::kStageY>(src, out, ys, wy, xs, wx, rb, cb, F, d, st);
    case band::kWalk2: return launch_probe<T, T, band::kWalk2>(src, out, ys, wy, xs, wx, rb, cb, F, d, st);
    case band::kWalk3: return launch_probe<T, T, band::kWalk3>(src, out, ys, wy, xs, wx, rb, cb, F, d, st);
    case band::kWalk4: return launch_probe<T, T, band::kWalk4>(src, out, ys, wy, xs, wx, rb, cb, F, d, st);
    case band::kXOnly: return launch_probe<T, T, band::kXOnly>(src, out, ys, wy, xs, wx, rb, cb, F, d, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the u8 module's modes, uint8 in and out
int u8_modes(int mode, const void* src, void* out, const void* ys, const void* wy,
             const void* xs, const void* wx, const void* rb, const void* cb, int F,
             const Dims& d, cudaStream_t st) {
  using U = uint8_t;
  switch (mode) {
    case band::kStage: return launch_probe<U, U, band::kStage>(src, out, ys, wy, xs, wx, rb, cb, F, d, st);
    case band::kStageY: return launch_probe<U, U, band::kStageY>(src, out, ys, wy, xs, wx, rb, cb, F, d, st);
    case band::kU8Words: return launch_probe<U, U, band::kU8Words>(src, out, ys, wy, xs, wx, rb, cb, F, d, st);
    case band::kXPair: return launch_probe<U, U, band::kXPair>(src, out, ys, wy, xs, wx, rb, cb, F, d, st);
    case band::kU8Convert1: return launch_probe<U, U, band::kU8Convert1>(src, out, ys, wy, xs, wx, rb, cb, F, d, st);
    case band::kU8Convert2: return launch_probe<U, U, band::kU8Convert2>(src, out, ys, wy, xs, wx, rb, cb, F, d, st);
    case band::kU8Convert4: return launch_probe<U, U, band::kU8Convert4>(src, out, ys, wy, xs, wx, rb, cb, F, d, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// mode: band_apply.cuh's Probe (1 stage, 2 stagey, 3 u8words, 4 xpair:
// the stage ring's first forms; 5-7 u8 convert in 1/2/4 chunks, 8-10 walk
// with 2/3/4 slots, 11 xonly); dtype_code (input and output): 0 =
// float32, 1 = bfloat16 (stage, stagey, walk, xonly), 2 = uint8 (stage,
// stagey, u8words, xpair, u8 convert).  The other arguments are
// aainterp_separable_apply's (csrc/separable_apply.cu); for xpair wx is
// the (4, Wd) table of source
// columns 2j - 1 .. 2j + 2 and xs is not read; for xonly src is (F, Hd,
// W), H = Hd and SY >= TY (the window holds the tile's rows).  The walk
// takes no count of row tiles a block: its grid is persistent, min(tiles,
// SMs x blocks an SM), and each block's share follows from the grid
// (aainterp_band_walk_grid).
extern "C" int aainterp_band_probe(
    const void* src, void* out, const void* ys, const void* wy, const void* xs,
    const void* wx, const void* row_base, const void* col_base, int F, int H, int W,
    int Hd, int Wd, int ky, int kx, int TY, int TX, int SY, int SX, int mode, int dtype_code,
    void* stream) {
  if (F <= 0 || H <= 0 || W <= 0 || Hd <= 0 || Wd <= 0 || ky <= 0 || kx <= 0 || TY <= 0 ||
      TX <= 0 || TX > band::kThreads || SY < ky || SX < kx ||
      (mode == band::kXOnly && (H != Hd || SY < TY)) ||
      (mode == band::kXPair && kx > 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Dims d{H, W, Hd, Wd, ky, kx, TY, TX, SY, SX, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case 0: return float_modes<float>(mode, src, out, ys, wy, xs, wx, row_base, col_base, F, d, s);
    case 1: return float_modes<__nv_bfloat16>(mode, src, out, ys, wy, xs, wx, row_base, col_base, F, d, s);
    case 2: return u8_modes(mode, src, out, ys, wy, xs, wx, row_base, col_base, F, d, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The walk's launch geometry for a walk mode (8-10) and dtype_code (0, 1)
// at these dims (aainterp_band_probe's): out[0] the SMs, out[1] blocks an
// SM, out[2] the kernel's registers a thread, out[3] its shared memory a
// block.  Returns 0 or a cudaError_t (cudaErrorInvalidValue where the
// ring exceeds the card's opt-in).
extern "C" int aainterp_band_walk_grid(int H, int W, int Hd, int Wd, int ky, int kx, int TY,
                                       int TX, int SY, int SX, int mode, int dtype_code,
                                       int* out) {
  if (H <= 0 || W <= 0 || Hd <= 0 || Wd <= 0 || ky <= 0 || kx <= 0 || TY <= 0 || TX <= 0 ||
      TX > band::kThreads || SY < ky || SX < kx || band::walk_slots(mode) == 0 ||
      dtype_code < 0 || dtype_code > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Dims d{H, W, Hd, Wd, ky, kx, TY, TX, SY, SX, 0, 0};
  return dtype_code == 0 ? walk_grid<float>(mode, d, out)
                         : walk_grid<__nv_bfloat16>(mode, d, out);
}

// The stage ring (band_apply.cuh's band_stage_kernel): mode 12 (kStage's
// function), 13 (kStageY's), 14 (kU8Words') or 15 (kXPair's) on a
// persistent grid whose blocks walk their shares of the tiles through a
// ring of 2 windows; dtype_code 0 = float32, 1 = bfloat16, 2 = uint8 (in
// and out; modes 14 and 15 uint8 alone).  The other arguments are
// aainterp_band_probe's: wx is read by mode 14 (production's x weights)
// and 15 (the (4, Wd) table of source columns 2j - 1 .. 2j + 2; kx at most
// 4), xs by 12-14; TY at most 8.  Returns 0 or a cudaError_t
// (cudaErrorInvalidValue where the ring exceeds the card's opt-in, before
// any launch).
extern "C" int aainterp_band_stage(const void* src, void* out, const void* ys, const void* wy,
                                   const void* xs, const void* wx, const void* row_base,
                                   const void* col_base, int F, int H, int W, int Hd, int Wd,
                                   int ky, int kx, int TY, int TX, int SY, int SX, int mode,
                                   int dtype_code, void* stream) {
  if (F <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (const int e = stage_args(H, W, Hd, Wd, ky, kx, TY, TX, SY, SX, mode, dtype_code)) {
    return e;
  }
  Dims d{H, W, Hd, Wd, ky, kx, TY, TX, SY, SX, 0, 0};
  return stage_dispatch(mode, dtype_code, src, out, ys, wy, xs, wx, row_base, col_base, F, d,
                        static_cast<cudaStream_t>(stream), nullptr);
}

// The stage ring's launch geometry at these dims (aainterp_band_stage's):
// out[0] the SMs, out[1] blocks an SM, out[2] the kernel's registers a
// thread, out[3] its shared memory a block.  Returns 0 or a cudaError_t.
extern "C" int aainterp_band_stage_grid(int H, int W, int Hd, int Wd, int ky, int kx, int TY,
                                        int TX, int SY, int SX, int mode, int dtype_code,
                                        int* out) {
  if (const int e = stage_args(H, W, Hd, Wd, ky, kx, TY, TX, SY, SX, mode, dtype_code)) {
    return e;
  }
  Dims d{H, W, Hd, Wd, ky, kx, TY, TX, SY, SX, 0, 0};
  return stage_dispatch(mode, dtype_code, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                        nullptr, nullptr, 1, d, nullptr, out);
}
