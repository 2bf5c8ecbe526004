// The device warp for NVIDIA Hopper: the counterpart of
// proteus_tpu/geo/warp.py::_device_resample_impl (:521-800), which the
// reference runs as one jax.jit program a geometry (_device_resample_fn,
// :474-491). It is jnp code, not a Pallas kernel; XLA fuses it, so none of
// its intermediates reaches device memory. The port's plain twin,
// geo/warp.py::device_resample_plain, is eager PyTorch: every
// double-float32 step, int64 index plane and bool mask of it is a full-size
// tensor (81 B an output pixel for nearest, 376 for cubic). This kernel
// computes the same function and writes only `out` and `amb`.
//
// For each output pixel (i, j):
//   1. i0, j0, wi, wj from i / spacing and j / spacing (exact: spacing is a
//      power of two);
//   2. the double-float32 lattice (u_hi, u_lo, v_hi, v_lo; gh x gw) lerped
//      over rows i0, i0 + 1 at wi, then over columns j0, j0 + 1 at wj;
//   3. nearest: the exact dd floor of v and u, the ambiguity band of each,
//      the gather with its bounds and validity, `fill` elsewhere;
//      bilinear and cubic: the dd floor of u - 0.5 and v - 0.5, the dd tap
//      weights, the taps rows outermost and columns innermost in one of
//      three accumulation modes (fast: no validity, no wrap; unmasked-wrap:
//      no validity, wrapping columns, with the weight sum; masked), the dd
//      division with its Newton step, and the f32 rounding-boundary band.
// The arithmetic is the plain twin's, op for op and in the same order, so
// the two agree bit for bit (chip_smoke.py phase 3e).
//
// Design: one block an output row. It stages the row-lerped lattice row
// (u and v, hi and lo: 4 x gw floats) in shared memory once; then each
// thread takes every blockDim-th pixel of the row and does only the column
// lerp and the resampler. nearest copies the element as raw bits, one body
// for element sizes 1, 2, 4 and 8 (uint8 CGLS and WorldCover, int16,
// float32, ...). A simple, correct kernel: no vector stores, TMA or tuning.
//
// Bound (chip_smoke.py::WARP_OPS counts the operations line by line):
// nearest moves out + amb + the source bytes it reads, about 2-2.3 B a
// pixel, but does ~140 float operations a pixel, so at 67 TFLOP/s the
// operations bound it; cubic does ~2,500 (16 taps of dd products and sums,
// 8 dd cubic polynomials) and is bound by operations by far.
//
// Hazards to bit-exactness, each named where the code meets it:
//   [FMA]   nvcc contracts a * b + c into one fused multiply-add unless told
//           not to; that breaks the Veltkamp split, the TwoProduct error
//           term and every dd sum. Every add, subtract and multiply of the
//           error-free transforms is __fadd_rn / __fsub_rn / __fmul_rn,
//           which are never contracted (Dekker's TwoProduct with the split,
//           as the plain twin has it, with no __fmaf_rn).
//   [NAN]   torch.minimum / torch.maximum propagate NaN, fminf / fmaxf do
//           not: torch_min / torch_max below are PyTorch's CUDA functor.
//           nan_to_num maps NaN and +-inf to 0.
//   [WRAP]  torch.remainder takes the divisor's sign, C's % the dividend's.
//   [INDEX] the flat index row * w + col is int64 (a WorldCover window can
//           pass 2^31 elements); i0 + dr wraps in int32 as torch's int32
//           add does.
//   [DIV]   tensor-by-tensor divisions are __fdiv_rn (IEEE whatever
//           -prec-div says); no -ftz; torch.nextafter is nextafterf.
//   [CVT]   .to(torch.int32) of a float is (int32_t)x, cvt.rzi: truncation
//           toward zero, saturating, NaN -> 0, as PyTorch's CUDA cast.
//   [CONST] f32(value) rounds a Python float to float32: the constants are
//           (float) of the same double, or exact powers of two.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

enum Algorithm { kNearest = 0, kBilinear = 1, kCubic = 2 };
// accumulation modes of bilinear and cubic (geo/warp.py, "accumulation
// modes mirroring _resample_block")
enum Mode { kFast = 0, kUnmaskedWrap = 1, kMasked = 2 };

constexpr int kThreads = 256;
// [CONST] exact powers of two
constexpr float kTwoM8 = 1.0f / (float)(1ull << 8);
constexpr float kTwoM16 = 1.0f / (float)(1ull << 16);
constexpr float kTwoM22 = 1.0f / (float)(1ull << 22);
constexpr float kTwoM38 = 1.0f / (float)(1ull << 38);
constexpr float kTwoM40 = 1.0f / (float)(1ull << 40);
constexpr float kTwoM42 = 1.0f / (float)(1ull << 42);
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 227 * 1024;

struct Lattice {
  const float* u_hi;
  const float* u_lo;
  const float* v_hi;
  const float* v_lo;
};

struct Geom {
  int64_t h, w;          // the source window
  int64_t gh, gw;        // the lattice
  float inv;             // 1 / spacing, exact
  int64_t out_h, out_w;
  int wraps;
  int64_t full_width;    // the period of a wrapping source's columns
};

struct DD {
  float hi, lo;
};

// [FMA] never contracted
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}

// core/eft.py::two_sum: s + e == a + b exactly
__device__ __forceinline__ DD two_sum(float a, float b) {
  const float s = add(a, b);
  const float bb = sub(s, a);
  return {s, add(sub(a, sub(s, bb)), sub(b, bb))};
}

// core/eft.py::split (Veltkamp, 2^12 + 1)
__device__ __forceinline__ DD split(float a) {
  const float c = mul(a, 4097.0f);
  const float hi = sub(c, sub(c, a));
  return {hi, sub(a, hi)};
}

// core/eft.py::two_prod (Dekker): p + e == a * b exactly
__device__ __forceinline__ DD two_prod(float a, float b) {
  const float p = mul(a, b);
  const DD as = split(a);
  const DD bs = split(b);
  const float e = add(add(add(sub(mul(as.hi, bs.hi), p), mul(as.hi, bs.lo)),
                          mul(as.lo, bs.hi)),
                      mul(as.lo, bs.lo));
  return {p, e};
}

// geo/warp.py::_dd_norm .. _dd_lerp
__device__ __forceinline__ DD dd_norm(float hi, float lo) {
  const float s = add(hi, lo);
  return {s, sub(lo, sub(s, hi))};
}

__device__ __forceinline__ DD dd_add(float ah, float al, float bh, float bl) {
  const DD t = two_sum(ah, bh);
  return dd_norm(t.hi, add(t.lo, add(al, bl)));
}

__device__ __forceinline__ DD dd_mul_f32(float ah, float al, float f) {
  const DD t = two_prod(ah, f);
  return dd_norm(t.hi, add(t.lo, mul(al, f)));
}

__device__ __forceinline__ DD dd_mul(DD x, DD y) {
  const DD t = two_prod(x.hi, y.hi);
  return dd_norm(t.hi, add(t.lo, add(mul(x.hi, y.lo), mul(x.lo, y.hi))));
}

__device__ __forceinline__ DD dd_lerp(DD g0, DD g1, float f) {
  const DD d = dd_add(g1.hi, g1.lo, -g0.hi, -g0.lo);
  const DD m = dd_mul_f32(d.hi, d.lo, f);
  return dd_add(g0.hi, g0.lo, m.hi, m.lo);
}

struct Floor {
  int32_t n;
  float cf, cl;
};

// geo/warp.py::_dd_floor: the exact floor of hi + err and its fraction
__device__ __forceinline__ Floor dd_floor(float hi, float err) {
  const float base = floorf(hi);
  const DD frac = two_sum(hi, -base);
  const DD c = two_sum(frac.hi, add(frac.lo, err));
  const float shift = c.hi < 0.0f ? 1.0f : (c.hi >= 1.0f ? -1.0f : 0.0f);
  const DD f = dd_add(c.hi, c.lo, shift, 0.0f);
  // [CVT] (base - shift).to(torch.int32)
  return {(int32_t)sub(base, shift), f.hi, f.lo};
}

// geo/warp.py::_near_edge
__device__ __forceinline__ bool near_edge(float hi, float cf) {
  const float eps =
      add(kTwoM22, mul(add(fabsf(hi), 16.0f), kTwoM38));
  return cf < eps || cf > sub(1.0f, eps);
}

// [NAN] PyTorch's CUDA minimum / maximum (NaN in either operand wins)
__device__ __forceinline__ float torch_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

__device__ __forceinline__ float torch_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

__device__ __forceinline__ int64_t clamp64(int64_t x, int64_t lo, int64_t hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// [WRAP] torch.remainder of int64: the result takes the divisor's sign
__device__ __forceinline__ int64_t remainder64(int64_t a, int64_t n) {
  int64_t r = a % n;
  if (r != 0 && ((r < 0) != (n < 0))) r += n;
  return r;
}

// [INDEX] i0 + dr in int32 as torch's int32 add: two's-complement wrap
__device__ __forceinline__ int32_t add_i32(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}

struct Tap {
  int64_t flat;  // clamped into the window
  bool inb;
};

// geo/warp.py::device_resample_plain.gather for one pixel
__device__ __forceinline__ Tap gather(const Geom& g, int32_t row32,
                                      int32_t col32) {
  const int64_t row = row32;
  int64_t col = col32;
  if (g.wraps) col = remainder64(col, g.full_width);
  const bool inb = row >= 0 && row < g.h && col >= 0 && col < g.w;
  // [INDEX] int64
  return {clamp64(row, 0, g.h - 1) * g.w + clamp64(col, 0, g.w - 1), inb};
}

// The row lerp of the lattice for output row i, over every lattice column,
// into shared memory: stage[0..gw) u_hi, [gw..2gw) u_lo, [2gw..3gw) v_hi,
// [3gw..4gw) v_lo.
__device__ __forceinline__ void stage_row(const Lattice& lat, const Geom& g,
                                          int64_t i, float* stage) {
  const float fi = mul((float)i, g.inv);
  const int64_t i0 = clamp64((int64_t)floorf(fi), 0, g.gh - 2);
  const float wi = sub(fi, (float)i0);
  const int64_t a = i0 * g.gw;
  const int64_t b = a + g.gw;
  for (int64_t k = threadIdx.x; k < g.gw; k += blockDim.x) {
    const DD u = dd_lerp({lat.u_hi[a + k], lat.u_lo[a + k]},
                         {lat.u_hi[b + k], lat.u_lo[b + k]}, wi);
    const DD v = dd_lerp({lat.v_hi[a + k], lat.v_lo[a + k]},
                         {lat.v_hi[b + k], lat.v_lo[b + k]}, wi);
    stage[k] = u.hi;
    stage[g.gw + k] = u.lo;
    stage[2 * g.gw + k] = v.hi;
    stage[3 * g.gw + k] = v.lo;
  }
}

// The column lerp of the staged row at output column j: (u, v) as dd.
__device__ __forceinline__ void interp(const float* stage, const Geom& g,
                                       int64_t j, DD* u, DD* v) {
  const float fj = mul((float)j, g.inv);
  const int64_t j0 = clamp64((int64_t)floorf(fj), 0, g.gw - 2);
  const float wj = sub(fj, (float)j0);
  const int64_t n = g.gw;
  *u = dd_lerp({stage[j0], stage[n + j0]}, {stage[j0 + 1], stage[n + j0 + 1]},
               wj);
  *v = dd_lerp({stage[2 * n + j0], stage[3 * n + j0]},
               {stage[2 * n + j0 + 1], stage[3 * n + j0 + 1]}, wj);
}

// nearest: T is an unsigned integer of the element's size, copied as bits
template <typename T>
__global__ void __launch_bounds__(kThreads)
    warp_nearest_kernel(const T* __restrict__ data,
                        const uint8_t* __restrict__ valid, Lattice lat,
                        Geom g, T fill, T* __restrict__ out,
                        uint8_t* __restrict__ amb) {
  extern __shared__ float stage[];
  const int64_t i = blockIdx.x;
  stage_row(lat, g, i, stage);
  __syncthreads();
  const float h1 = (float)(g.h + 1);
  const float w1 = (float)(g.w + 1);
  for (int64_t j = threadIdx.x; j < g.out_w; j += blockDim.x) {
    DD u, v;
    interp(stage, g, j, &u, &v);
    const Floor fr = dd_floor(v.hi, v.lo);
    const Floor fc = dd_floor(u.hi, u.lo);
    const bool a = near_edge(u.hi, fc.cf) || near_edge(v.hi, fr.cf);
    // a floor flip far outside the window cannot change the (fill) result
    bool in_range = v.hi >= -1.0f && v.hi <= h1;
    if (!g.wraps) in_range = in_range && u.hi >= -1.0f && u.hi <= w1;
    const Tap t = gather(g, fr.n, fc.n);
    const bool ok = t.inb && (valid == nullptr || valid[t.flat] != 0);
    const int64_t o = i * g.out_w + j;
    out[o] = ok ? data[t.flat] : fill;
    amb[o] = (a && in_range) ? 1 : 0;
  }
}

// geo/warp.py::device_resample_plain's kernel resamplers (dd_addc, dd_mulc,
// const_minus, poly_inner, poly_outer)
__device__ __forceinline__ DD dd_addc(DD x, float c) {
  return dd_add(x.hi, x.lo, c, 0.0f);
}

__device__ __forceinline__ DD dd_mulc(DD x, float c) {
  return dd_mul_f32(x.hi, x.lo, c);
}

__device__ __forceinline__ DD const_minus(float c, DD x) {
  return dd_add(c, 0.0f, -x.hi, -x.lo);
}

// GDAL cubic (a = -0.5), |x| <= 1: 1.5x^3 - 2.5x^2 + 1
__device__ __forceinline__ DD poly_inner(DD x) {
  DD t = dd_addc(dd_mulc(x, 1.5f), -2.5f);
  t = dd_mul(t, x);
  t = dd_mul(t, x);
  return dd_addc(t, 1.0f);
}

// 1 < |x| < 2: -0.5x^3 + 2.5x^2 - 4x + 2
__device__ __forceinline__ DD poly_outer(DD x) {
  DD t = dd_addc(dd_mulc(x, -0.5f), 2.5f);
  t = dd_mul(t, x);
  t = dd_addc(t, -4.0f);
  t = dd_mul(t, x);
  return dd_addc(t, 2.0f);
}

// the tap weights of fraction f, taps at offsets kOffset[k]
template <int kTaps>
__device__ __forceinline__ void tap_weights(DD f, DD (&wt)[kTaps]);

template <>
__device__ __forceinline__ void tap_weights<2>(DD f, DD (&wt)[2]) {
  wt[0] = const_minus(1.0f, f);
  wt[1] = f;
}

template <>
__device__ __forceinline__ void tap_weights<4>(DD f, DD (&wt)[4]) {
  wt[0] = poly_outer(dd_addc(f, 1.0f));
  wt[1] = poly_inner(f);
  wt[2] = poly_inner(const_minus(1.0f, f));
  wt[3] = poly_outer(const_minus(2.0f, f));
}

// bilinear (kTaps = 2, offsets 0, 1) and cubic (kTaps = 4, offsets -1 .. 2)
template <int kTaps, int kMode>
__global__ void __launch_bounds__(kThreads)
    warp_kernel_kernel(const float* __restrict__ data,
                       const uint8_t* __restrict__ valid, Lattice lat, Geom g,
                       float fill, float* __restrict__ out,
                       uint8_t* __restrict__ amb) {
  extern __shared__ float stage[];
  const int64_t i = blockIdx.x;
  stage_row(lat, g, i, stage);
  __syncthreads();
  const int32_t first = kTaps == 2 ? 0 : -1;
  const float hf = (float)g.h;
  const float wf = (float)g.w;
  const float inf = __int_as_float(0x7f800000);
  // [CONST] f32(1e-9), f32(1e-12), f32(1e-30): the double rounded to float
  const float eps9 = (float)1e-9;
  const float eps12 = (float)1e-12;
  const float tiny = (float)1e-30;
  for (int64_t j = threadIdx.x; j < g.out_w; j += blockDim.x) {
    DD u, v;
    interp(stage, g, j, &u, &v);
    const DD uc = dd_add(u.hi, u.lo, -0.5f, 0.0f);
    const DD vc = dd_add(v.hi, v.lo, -0.5f, 0.0f);
    const Floor fu = dd_floor(uc.hi, uc.lo);
    const Floor fv = dd_floor(vc.hi, vc.lo);
    bool a = near_edge(uc.hi, fu.cf) || near_edge(vc.hi, fv.cf);
    DD wr[kTaps], wc[kTaps];
    tap_weights<kTaps>(DD{fv.cf, fv.cl}, wr);
    tap_weights<kTaps>(DD{fu.cf, fu.cl}, wc);
    bool center_in;
    if (g.wraps)
      center_in = v.hi >= 0.0f && v.hi <= hf;
    else
      center_in = u.hi >= 0.0f && u.hi <= wf && v.hi >= 0.0f && v.hi <= hf;
    DD acc = {0.0f, 0.0f};
    DD wacc = {0.0f, 0.0f};
    float macc = 0.0f;  // magnitude accumulator
    float vmin = inf;
    float vmax = -inf;
#pragma unroll
    for (int r = 0; r < kTaps; ++r) {
#pragma unroll
      for (int c = 0; c < kTaps; ++c) {
        const Tap t = gather(g, add_i32(fv.n, first + r),
                             add_i32(fu.n, first + c));
        const float vf = data[t.flat];
        const DD w2 = dd_mul(wr[r], wc[c]);
        const DD term = dd_mul_f32(w2.hi, w2.lo, vf);
        if (kMode != kMasked) {
          macc = add(macc, fabsf(term.hi));
          vmin = torch_min(vmin, vf);
          vmax = torch_max(vmax, vf);
          acc = dd_add(acc.hi, acc.lo, term.hi, term.lo);
          if (kMode != kFast) wacc = dd_add(wacc.hi, wacc.lo, w2.hi, w2.lo);
        } else {
          const bool ok = t.inb && valid[t.flat] != 0;
          macc = add(macc, ok ? fabsf(term.hi) : 0.0f);
          vmin = torch_min(vmin, ok ? vf : inf);
          vmax = torch_max(vmax, ok ? vf : -inf);
          acc = dd_add(acc.hi, acc.lo, ok ? term.hi : 0.0f,
                       ok ? term.lo : 0.0f);
          wacc = dd_add(wacc.hi, wacc.lo, ok ? w2.hi : 0.0f,
                        ok ? w2.lo : 0.0f);
        }
      }
    }
    DD res;
    bool good;
    float err_scale;
    if (kMode == kFast) {
      res = acc;
      good = center_in;
      err_scale = 1.0f;
    } else {
      // the dd division: one Newton correction on the f32 quotient; [DIV]
      const float denom = wacc.hi > eps9 ? wacc.hi : 1.0f;
      const float q0 = __fdiv_rn(acc.hi, denom);
      const DD p = dd_mul_f32(wacc.hi, wacc.lo, q0);
      const DD rr = dd_add(acc.hi, acc.lo, -p.hi, -p.lo);
      const DD q = two_sum(q0, __fdiv_rn(rr.hi, denom));
      res = dd_norm(q.hi, q.lo);
      good = center_in && wacc.hi > eps9;
      a = a || fabsf(sub(wacc.hi, eps9)) < eps12;
      err_scale = __fdiv_rn(1.0f, torch_max(fabsf(denom), kTwoM8));
      a = a || (good && fabsf(wacc.hi) < kTwoM8);
    }
    // the f32 rounding-boundary band; [DIV] nextafterf
    const float absh = add(fabsf(res.hi), tiny);
    const float half_ulp = mul(sub(nextafterf(absh, inf), absh), 0.5f);
    const float coord_mag = add(add(fabsf(uc.hi), fabsf(vc.hi)), 32.0f);
    float spread = sub(vmax, vmin);
    // [NAN] nan_to_num(nan=0, posinf=0, neginf=0)
    if (spread != spread || spread == inf || spread == -inf) spread = 0.0f;
    const float delta =
        add(mul(half_ulp, kTwoM16),
            mul(err_scale, add(mul(macc, kTwoM40),
                               mul(mul(spread, coord_mag), kTwoM42))));
    a = a || fabsf(sub(fabsf(res.lo), half_ulp)) < delta;
    const int64_t o = i * g.out_w + j;
    out[o] = good ? res.hi : fill;
    amb[o] = (a && center_in) ? 1 : 0;
  }
}

int check_device(const void* p) {
  cudaPointerAttributes attr;
  cudaError_t e = cudaPointerGetAttributes(&attr, p);
  if (e != cudaSuccess) return (int)e;
  int current = -1;
  e = cudaGetDevice(&current);
  if (e != cudaSuccess) return (int)e;
  return attr.device == current ? 0 : (int)cudaErrorInvalidDevice;
}

// Raise a kernel's dynamic shared memory limit above the default 48 KB.
template <typename K>
int shared_bytes(K kernel, size_t bytes) {
  if (bytes <= (size_t)kDefaultSmem) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T>
int launch_nearest(const void* data, const uint8_t* valid, Lattice lat,
                   Geom g, unsigned long long fill_bits, void* out,
                   uint8_t* amb, size_t smem, cudaStream_t s) {
  if (const int err = shared_bytes(warp_nearest_kernel<T>, smem)) return err;
  warp_nearest_kernel<T><<<(unsigned)g.out_h, kThreads, smem, s>>>(
      (const T*)data, valid, lat, g, (T)fill_bits, (T*)out, amb);
  return 0;
}

template <int kTaps, int kMode>
int launch_kernel(const void* data, const uint8_t* valid, Lattice lat, Geom g,
                  float fill, void* out, uint8_t* amb, size_t smem,
                  cudaStream_t s) {
  if (const int err = shared_bytes(warp_kernel_kernel<kTaps, kMode>, smem))
    return err;
  warp_kernel_kernel<kTaps, kMode><<<(unsigned)g.out_h, kThreads, smem, s>>>(
      (const float*)data, valid, lat, g, fill, (float*)out, amb);
  return 0;
}

}  // namespace

// Warp `data` (h x w elements of elem_size bytes; float32 for bilinear and
// cubic) onto the out_h x out_w grid: `out` (data's type) and `amb` (bool,
// one byte a pixel). `valid` is null or h x w bools; lat holds four gh x gw
// float32 planes; inv = 1 / spacing. `fill_bits` is the fill's bits in
// data's type (little-endian, the low elem_size bytes; float32 bits for
// bilinear and cubic). Runs on `stream` (PyTorch's current stream of the
// current device) and does not synchronise. Returns cudaGetLastError()
// after the launch, cudaErrorInvalidValue for bad arguments, and
// cudaErrorInvalidDevice for a pointer of another card than the current one.
extern "C" int warp_launch(const void* data, const void* valid,
                           const float* u_hi, const float* u_lo,
                           const float* v_hi, const float* v_lo, long long h,
                           long long w, long long gh, long long gw, float inv,
                           long long out_h, long long out_w, int algorithm,
                           int elem_size, unsigned long long fill_bits,
                           int wraps, long long full_width, void* out,
                           void* amb, void* stream) {
  if (data == nullptr || out == nullptr || amb == nullptr || u_hi == nullptr ||
      u_lo == nullptr || v_hi == nullptr || v_lo == nullptr || h < 1 ||
      w < 1 || gh < 2 || gw < 2 || out_h < 1 || out_w < 1 ||
      out_h > 0x7fffffffLL || (wraps && full_width < 1))
    return (int)cudaErrorInvalidValue;
  const size_t smem = 4 * sizeof(float) * (size_t)gw;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const void* pointers[] = {data, u_hi, u_lo, v_hi, v_lo, out, amb};
  for (const void* p : pointers)
    if (const int err = check_device(p)) return err;
  if (valid != nullptr)
    if (const int err = check_device(valid)) return err;
  const Lattice lat = {u_hi, u_lo, v_hi, v_lo};
  const Geom g = {h, w, gh, gw, inv, out_h, out_w, wraps ? 1 : 0, full_width};
  const uint8_t* vp = (const uint8_t*)valid;
  uint8_t* ap = (uint8_t*)amb;
  const cudaStream_t s = (cudaStream_t)stream;
  int err = 0;
  if (algorithm == kNearest) {
#define WARP_NEAREST(T) \
  err = launch_nearest<T>(data, vp, lat, g, fill_bits, out, ap, smem, s)
    switch (elem_size) {
      case 1: WARP_NEAREST(uint8_t); break;
      case 2: WARP_NEAREST(uint16_t); break;
      case 4: WARP_NEAREST(uint32_t); break;
      case 8: WARP_NEAREST(uint64_t); break;
      default: return (int)cudaErrorInvalidValue;
    }
#undef WARP_NEAREST
  } else if (algorithm == kBilinear || algorithm == kCubic) {
    if (elem_size != 4) return (int)cudaErrorInvalidValue;
    uint32_t bits = (uint32_t)fill_bits;
    float fill;
    memcpy(&fill, &bits, sizeof(fill));
    const int mode = vp != nullptr ? kMasked : (wraps ? kUnmaskedWrap : kFast);
#define WARP_KERNEL(TAPS, MODE) \
  err = launch_kernel<TAPS, MODE>(data, vp, lat, g, fill, out, ap, smem, s)
    if (algorithm == kBilinear) {
      if (mode == kFast) WARP_KERNEL(2, kFast);
      else if (mode == kUnmaskedWrap) WARP_KERNEL(2, kUnmaskedWrap);
      else WARP_KERNEL(2, kMasked);
    } else {
      if (mode == kFast) WARP_KERNEL(4, kFast);
      else if (mode == kUnmaskedWrap) WARP_KERNEL(4, kUnmaskedWrap);
      else WARP_KERNEL(4, kMasked);
    }
#undef WARP_KERNEL
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  return (int)cudaGetLastError();
}

extern "C" const char* warp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
