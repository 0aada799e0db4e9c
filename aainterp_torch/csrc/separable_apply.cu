// Separable banded area-average apply for Hopper (sm_90a): kernel 1, the
// main path.
//
// Replaces the TPU Pallas kernel aainterp/ops/pallas_apply.py
// ::_build_separable_kernel (pallas_call at :438).  It computes, per frame f,
//
//   out[f,i,j] = sum_b wx[j,b] * sum_a wy[i,a]
//                * src[f, clamp(ys[i]+a, 0, H-1), clamp(xs[j]+b, 0, W-1)]
//
// with f32 accumulation.  Out-of-range taps are clamped, as the plain
// version (ops/apply.py) and jnp.take do; they carry zero weight.
//
// What bounds it: bytes, not FLOPs.  At the 4K->1080p flagship a frame moves
// 16.6 MB in and 4.1 MB out (bf16) for about 8 FMAs per output pixel, far
// below the H100's operations-per-byte ridge.  So there are no tensor cores
// here (the TPU kernel's densified MXU blocks and 128-lane alignment exist
// for the TPU's matrix unit); the design reads each source pixel from device
// memory about once, with few instructions per byte: the staged form of
// csrc/band_apply.cuh with clamped taps.  A block takes TY dst rows of a
// strip of TX dst columns; the tile's window of source rows is copied raw with 16-byte cp.async; the
// y pass reads 4 columns per lane from shared memory, the x pass keeps each
// thread's column weights in registers and writes a shared output tile
// that leaves with 16-byte stores.  At the flagship a tile is 8 x 240, its
// window 18 source rows of 482 columns, and the 2-row halo between row
// tiles is re-read from L2.
//
// The host planner (ops/cuda_apply.py) halves the tile until its shared
// memory fits; bands whose one-pixel window exceeds the card's opt-in limit
// go to kernel 2 (csrc/separable_apply_2d.cu), decided on the host before
// any launch.  Output: f32, bf16 (round to nearest even) or u8 (rintf =
// round half to even, then saturate to [0, 255], as jnp.round/clip do at
// pallas_apply.py:250-256).
//
// Plain C interface for ctypes; the launch goes on the caller's stream and
// does not synchronise.  The return value is cudaGetLastError() after the
// launch (0 on success).

#include "band_apply.cuh"

namespace {

template <typename Tin>
int launch_out(int out_code, const void* src, void* out, const void* ys, const void* wy,
               const void* xs, const void* wx, const void* row_base, const void* col_base,
               int F, const band::Dims& d, cudaStream_t stream) {
  switch (out_code) {
    case 0: return band::launch_staged<Tin, float, 0, true>(src, out, ys, wy, xs, wx, row_base, col_base, F, d, stream);
    case 1: return band::launch_staged<Tin, __nv_bfloat16, 0, true>(src, out, ys, wy, xs, wx, row_base, col_base, F, d, stream);
    case 2: return band::launch_staged<Tin, uint8_t, 0, true>(src, out, ys, wy, xs, wx, row_base, col_base, F, d, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = uint8.  row_base / col_base:
// the first source row of each row tile of TY dst rows and the first source
// column of each strip of TX dst columns (every tap inside [base, base + SY)
// and [base, base + SX)).
extern "C" int aainterp_separable_apply(
    const void* src, void* out, const void* ys, const void* wy, const void* xs,
    const void* wx, const void* row_base, const void* col_base, int F, int H, int W,
    int Hd, int Wd, int ky, int kx, int TY, int TX, int SY, int SX, int in_code,
    int out_code, void* stream) {
  if (F <= 0 || H <= 0 || W <= 0 || Hd <= 0 || Wd <= 0 || ky <= 0 || kx <= 0 || TY <= 0 ||
      TX <= 0 || TX > band::kThreads || SY < ky || SX < kx) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  band::Dims d{H, W, Hd, Wd, ky, kx, TY, TX, SY, SX, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (in_code) {
    case 0: return launch_out<float>(out_code, src, out, ys, wy, xs, wx, row_base, col_base, F, d, s);
    case 1: return launch_out<__nv_bfloat16>(out_code, src, out, ys, wy, xs, wx, row_base, col_base, F, d, s);
    case 2: return launch_out<uint8_t>(out_code, src, out, ys, wy, xs, wx, row_base, col_base, F, d, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
