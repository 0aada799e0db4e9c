// 3-pass conservative shear (mode='shear') for Hopper (sm_90a): the two
// stage kernels.
//
// Replaces the two TPU Pallas kernels of aainterp/ops/pallas_shear3.py:
//
//   aainterp_shear3_ystage <- _build_y_stage (:230, pallas_call at :334)
//   aainterp_shear3_xstage <- _build_x_stage (:342, pallas_call at :443)
//
// Each launch runs one whole pass of a Shear3Plan (ops/shear3.py, laid out
// by shear3.stage_plan) on F frames.  Along the pass axis, for each line l
// (a column for the y-stage, a row for the x-stage) with shift d = d[l] and
// fraction f = f[l], the translate of a line v at grid cell t is
//
//   tr(v, t) = (1-f) v[t-d] + f v[t-d-1]           taps outside v read 0
//
// and band row i is  sum_k w[i,k] v[start[i]+k]    taps outside v read 0.
// The three forms of a pass:
//
//   form 0, translate:  out[u] = tr(in, u + crop)
//   form 1, pre-band:   out[u] = tr(mid, u + crop),   mid = band(in), n_mid cells
//   form 2, post-band:  out[u] = band(T)[u],          T[t] = tr(in, t), t < n_t
//
// then, on the plan's last stage only, out *= inv_cov[pixel], and the cast
// to the output type (bf16: round to nearest even; uint8: round half to
// even, saturate to [0, 255]).
//
// Arithmetic: f32, in the order of the plain torch stages (ops/shear3.py:
// translate tap (1-f) first, band taps k = 0..K-1), every product rounded
// before its add (__fmul_rn / __fadd_rn, so nvcc contracts nothing into an
// FMA).  A stage therefore equals its plain version bit for bit.
//
// What the TPU kernels did that is not carried over: the Pallas plan
// (build_shear3_kernel_plan) pads lines to 128 lanes and 16 sublanes,
// lifts d so that crops land on aligned offsets, densifies the bands into
// MXU blocks at static bases, and realises the per-line shift as log2 bit
// rolls of a VMEM strip, because Mosaic rotates 32-bit values only and the
// TPU has no gather.  A GPU thread reads any address, so here each output
// element reads its taps directly at the plan's own d, f, crop, n_t, band
// start and weights.
//
// What bounds them: bytes.  A stage does 2 (translate), 2K+2 (pre-band) or
// 3K+2 (post-band) multiply-adds per output element against 2 to 6 bytes
// of input and output, far below the card's ridge.  The floor is one read
// of the input and one write of the output; neighbouring outputs share
// input taps (a post-band row reads K+1 input cells, a pre-band output 2K),
// and those re-reads must come from L1/L2, not device memory.  So:
//
//   * one thread per output element, a block covering kThreads neighbouring
//     elements of one output row, so writes are coalesced.  In the x-stage
//     neighbouring threads are neighbouring cells u of one line; in the
//     y-stage they are neighbouring lines (columns) at one u, so their taps
//     lie on neighbouring columns of a few input rows (d moves by at most
//     one cell per column);
//   * a post-band output loads its K+1 distinct input cells once and forms
//     its K translate values from them;
//   * EVERY output element is written, zeros included, so a torch.empty
//     output holds no stale NaN where a later zero weight reads it.
//
// Plain C interface for ctypes; each launch goes on the caller's stream and
// does not synchronise.  The return value is cudaGetLastError() after the
// launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxGridY = 65535;

enum Form { kTranslate = 0, kPreBand = 1, kPostBand = 2 };

struct StageDims {
  int n_lines;  // lines: the other axis
  int n_in;     // input cells along the pass axis
  int n_mid;    // pre-band output cells (form 1)
  int n_t;      // translate grid cells
  int crop;
  int n_out;    // output cells along the pass axis
  int K;        // band width (forms 1, 2)
  int form;
};

struct StageTables {
  const int* d;        // (n_lines,) integer shift
  const float* f;      // (n_lines,) fraction
  const int* start;    // (band rows,) first tap
  const float* w;      // (band rows, K) weights
  const float* inv_cov;  // (out rows, out cols), or null
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(uint8_t v) { return static_cast<float>(v); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store(uint8_t* p, float v) {
  *p = static_cast<uint8_t>(fminf(fmaxf(rintf(v), 0.0f), 255.0f));
}

// acc + a * b, the product rounded before the add
__device__ __forceinline__ float madd(float acc, float a, float b) {
  return __fadd_rn(acc, __fmul_rn(a, b));
}

// One input line: cell j along the pass axis, or 0 outside [0, n).
template <typename In>
struct Line {
  const In* p;
  long long stride;
  int n;
  __device__ __forceinline__ float operator()(int j) const {
    return (j >= 0 && j < n) ? to_f32(p[j * stride]) : 0.0f;
  }
};

// sum_k w[i,k] v(start[i] + k), taps in order
template <typename V>
__device__ __forceinline__ float band_row(const V& v, const StageTables& t,
                                          int i, int K) {
  const int s = t.start[i];
  const float* wr = t.w + static_cast<long long>(i) * K;
  float acc = 0.0f;
  for (int k = 0; k < K; ++k) acc = madd(acc, v(s + k), wr[k]);
  return acc;
}

// The pre-band's output line: band row m for m in [0, n_mid), else 0.
template <typename In>
struct Mid {
  Line<In> in;
  StageTables t;
  int K;
  int n_mid;
  __device__ __forceinline__ float operator()(int m) const {
    return (m >= 0 && m < n_mid) ? band_row(in, t, m, K) : 0.0f;
  }
};

// (1-f) v(t-d) + f v(t-d-1); the first add of the plain version is 0 + x
template <typename V>
__device__ __forceinline__ float translate(const V& v, int t, int d, float f) {
  return madd(__fmul_rn(v(t - d), 1.0f - f), v(t - d - 1), f);
}

// band row u over the translate grid T[t] = tr(v, t), t in [0, n_t): the
// K+1 input cells v(s-d-1 .. s+K-1-d) are loaded once
template <typename In>
__device__ __forceinline__ float post_band(const Line<In>& v,
                                           const StageTables& t, int u,
                                           int K, int n_t, int d, float f) {
  const int s = t.start[u];
  const float* wr = t.w + static_cast<long long>(u) * K;
  const float g = 1.0f - f;
  float prev = v(s - d - 1);
  float acc = 0.0f;
  for (int k = 0; k < K; ++k) {
    const int c = s + k;
    const float cur = v(c - d);
    const float tr = (c >= 0 && c < n_t) ? madd(__fmul_rn(cur, g), prev, f) : 0.0f;
    acc = madd(acc, tr, wr[k]);
    prev = cur;
  }
  return acc;
}

// One output element per thread.  y-stage: out (F, n_out, n_lines), block
// row = f*n_out + u, column = line.  x-stage: out (F, n_lines, n_out),
// block row = f*n_lines + line, column = u.
template <bool kY, typename In, typename Out>
__global__ void __launch_bounds__(kThreads) stage_kernel(
    const In* __restrict__ x, Out* __restrict__ out, StageTables t,
    StageDims s) {
  const int col = blockIdx.y * blockDim.x + threadIdx.x;
  const long long row = blockIdx.x;
  const int n_cols = kY ? s.n_lines : s.n_out;
  if (col >= n_cols) return;
  const int rows_per_frame = kY ? s.n_out : s.n_lines;
  const long long fr = row / rows_per_frame;
  const int r = static_cast<int>(row - fr * rows_per_frame);
  const int l = kY ? col : r;
  const int u = kY ? r : col;
  Line<In> v;
  if (kY) {
    v.p = x + fr * s.n_in * s.n_lines + l;
    v.stride = s.n_lines;
  } else {
    v.p = x + row * s.n_in;
    v.stride = 1;
  }
  v.n = s.n_in;
  const int d = t.d[l];
  const float f = t.f[l];
  float acc;
  if (s.form == kPostBand) {
    acc = post_band(v, t, u, s.K, s.n_t, d, f);
  } else if (s.form == kPreBand) {
    const Mid<In> mid{v, t, s.K, s.n_mid};
    acc = translate(mid, u + s.crop, d, f);
  } else {
    acc = translate(v, u + s.crop, d, f);
  }
  if (t.inv_cov != nullptr) {
    acc = __fmul_rn(acc, t.inv_cov[static_cast<long long>(r) * n_cols + col]);
  }
  store(out + row * n_cols + col, acc);
}

template <bool kY, typename In, typename Out>
int launch(const void* x, void* out, const StageTables& t, const StageDims& s,
           dim3 grid, cudaStream_t st) {
  stage_kernel<kY, In, Out><<<grid, kThreads, 0, st>>>(
      static_cast<const In*>(x), static_cast<Out*>(out), t, s);
  return static_cast<int>(cudaGetLastError());
}

// type codes: 0 = float32, 1 = bfloat16, 2 = uint8
template <bool kY, typename In>
int launch_out(int out_code, const void* x, void* out, const StageTables& t,
               const StageDims& s, dim3 grid, cudaStream_t st) {
  switch (out_code) {
    case 0: return launch<kY, In, float>(x, out, t, s, grid, st);
    case 1: return launch<kY, In, __nv_bfloat16>(x, out, t, s, grid, st);
    case 2: return launch<kY, In, uint8_t>(x, out, t, s, grid, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool kY>
int run_stage(const void* x, void* out, const void* d, const void* f,
              const void* start, const void* w, const void* inv_cov, int F,
              const StageDims& s, int in_code, int out_code, void* stream) {
  const bool banded = s.form == kPreBand || s.form == kPostBand;
  if (x == nullptr || out == nullptr || d == nullptr || f == nullptr ||
      F <= 0 || s.n_lines <= 0 || s.n_in <= 0 || s.n_out <= 0 ||
      s.n_t <= 0 || s.crop < 0 || s.form < kTranslate || s.form > kPostBand ||
      (banded && (s.K <= 0 || start == nullptr || w == nullptr)) ||
      (s.form == kPreBand && s.n_mid <= 0) ||
      (s.form != kPostBand && s.crop + s.n_out > s.n_t)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long rows = static_cast<long long>(F) * (kY ? s.n_out : s.n_lines);
  const long long ny = ((kY ? s.n_lines : s.n_out) + kThreads - 1) / kThreads;
  if (rows > 0x7fffffffLL || ny > kMaxGridY) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(rows), static_cast<unsigned>(ny));
  const StageTables t{static_cast<const int*>(d), static_cast<const float*>(f),
                      static_cast<const int*>(start), static_cast<const float*>(w),
                      static_cast<const float*>(inv_cov)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (in_code) {
    case 0: return launch_out<kY, float>(out_code, x, out, t, s, grid, st);
    case 1: return launch_out<kY, __nv_bfloat16>(out_code, x, out, t, s, grid, st);
    case 2: return launch_out<kY, uint8_t>(out_code, x, out, t, s, grid, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int aainterp_shear3_ystage(const void* x, void* out, const void* d,
                                      const void* f, const void* start,
                                      const void* w, const void* inv_cov, int F,
                                      int n_lines, int n_in, int n_mid, int n_t,
                                      int crop, int n_out, int K, int form,
                                      int in_code, int out_code, void* stream) {
  const StageDims s{n_lines, n_in, n_mid, n_t, crop, n_out, K, form};
  return run_stage<true>(x, out, d, f, start, w, inv_cov, F, s, in_code,
                         out_code, stream);
}

extern "C" int aainterp_shear3_xstage(const void* x, void* out, const void* d,
                                      const void* f, const void* start,
                                      const void* w, const void* inv_cov, int F,
                                      int n_lines, int n_in, int n_mid, int n_t,
                                      int crop, int n_out, int K, int form,
                                      int in_code, int out_code, void* stream) {
  const StageDims s{n_lines, n_in, n_mid, n_t, crop, n_out, K, form};
  return run_stage<false>(x, out, d, f, start, w, inv_cov, F, s, in_code,
                          out_code, stream);
}
