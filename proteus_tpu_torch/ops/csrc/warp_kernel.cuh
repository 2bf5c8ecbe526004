// The device warp's arithmetic and kernel bodies, included by
// warp_kernel.cu (nvcc, for the card) and by tests/warp_host/warp_host.cpp
// (g++, for the CPU, behind a cuda_runtime.h stand-in that runs a block as
// one thread; tests/test_torch_warp_host.py). It is the counterpart of
// proteus_tpu/geo/warp.py::_device_resample_impl (:521-800), which the
// reference runs as one jax.jit program a geometry (_device_resample_fn,
// :474-491). That is jnp code, not a Pallas kernel; XLA fuses it, so none
// of its intermediates reaches device memory. The port's plain twin,
// geo/warp.py::device_resample_plain, is eager PyTorch: every
// double-float32 step, int64 index plane and bool mask of it is a full-size
// tensor (81 B an output pixel for nearest, 376 for cubic). These kernels
// compute the same function and write only `out` and `amb`.
//
// For each output pixel (i, j):
//   1. i0, j0, wi, wj from i and j with a shift and a mask (spacing is a
//      power of two), or in a column chunk from the twin's float32 row and
//      column numbers (exact up to 2^24, rounded past it);
//   2. the double-float32 lattice (u_hi, u_lo, v_hi, v_lo; gh x gw) lerped
//      over rows i0, i0 + 1 at wi, then over columns j0, j0 + 1 at wj;
//   3. nearest: the exact dd floor of v and u, the ambiguity band of each,
//      the gather with its bounds and validity, `fill` elsewhere;
//      bilinear and cubic: the dd floor of u - 0.5 and v - 0.5, the dd tap
//      weights, the taps rows outermost and columns innermost in one of
//      three accumulation modes (fast: no validity, no wrap; unmasked-wrap:
//      no validity, wrapping columns, with the weight sum; masked), the dd
//      division with its Newton step, and the f32 rounding-boundary band.
// The arithmetic is the plain twin's in the same order, so the two agree
// bit for bit (chip_smoke.py phase 3e on the card,
// tests/test_torch_warp_host.py on the CPU).
//
// Design: one block an output row (Layout kRows, every main path), or a
// chunk of one where the lattice row does not fit in shared memory (more
// than kStageColumns columns) or a side passes 2^24 (kChunks; the blocks
// of a grid stay on blockIdx.x, which takes 2^31 - 1 of them). It stages
// the row-lerped lattice columns its pixels fall between and the
// differences of neighbouring columns (u and v, hi and lo: 8 floats a
// column) in shared memory once; then each thread takes
// every blockDim-th pixel of the row or chunk and does only the column
// lerp and the resampler. kRows knows at compile time that a block starts
// at column 0 and stages the whole lattice row: on the card a runtime
// chunk cost its nearest kernel 7 registers (39, against 32) and the
// main paths 2.7-3.2% (PERF.md §6). nearest copies the element as raw
// bits, one body for element sizes 1, 2, 4 and 8 (uint8 CGLS and
// WorldCover, int16, float32, ...). The index type I is int32_t wherever
// the window, the output and the lattice each hold fewer than 2^31
// elements (every call of the main paths but a WorldCover window that
// passes 2^31), else int64_t.
//
// Bound: nearest moves out + amb + the source bytes it reads, about
// 2-2.3 B a pixel, but does ~170 float and integer operations a pixel;
// cubic does ~1,700 (16 taps of dd products and sums, 8 dd cubic
// polynomials): both are bound by instruction issue, far above their
// bytes (chip_smoke.py::_W counts them line by line). So the design cuts
// instructions: the exact TwoProduct with one fused multiply-add in place
// of Dekker's 17 operations where the operands allow it, tested without a
// branch a product; 32-bit indices; the column index from a shift; the
// lattice's column differences staged once a block; and the bounds and
// clamps of the taps' rows and columns computed once a row and once a
// column.
//
// Hazards to bit-exactness, each named where the code meets it:
//   [FMA]   nvcc contracts a * b + c into one fused multiply-add unless told
//           not to; that breaks the Veltkamp split, Dekker's error term
//           and every dd sum. Every add, subtract and multiply is
//           __fadd_rn / __fsub_rn / __fmul_rn, which are never contracted.
//           The one fused multiply-add is two_prod's __fmaf_rn, on
//           purpose, behind its guard.
//   [NAN]   torch.minimum / torch.maximum propagate NaN, fminf / fmaxf do
//           not; nan_to_num maps NaN and +-inf to 0.
//   [WRAP]  torch.remainder takes the divisor's sign, C's % the dividend's.
//   [INDEX] i0 + dr wraps in int32 as torch's int32 add does; the flat
//           index row * w + col is I.
//   [DIV]   tensor-by-tensor divisions are __fdiv_rn (IEEE whatever
//           -prec-div says); no -ftz; torch.nextafter(x, inf) of a
//           positive x is next_up.
//   [CVT]   .to(torch.int32) of a float is (int32_t)x, cvt.rzi: truncation
//           toward zero, saturating, NaN -> 0, as PyTorch's CUDA cast.
//   [CONST] f32(value) rounds a Python float to float32: the constants are
//           (float) of the same double, or exact powers of two.

#pragma once

#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

enum Algorithm { kNearest = 0, kBilinear = 1, kCubic = 2 };
// accumulation modes of bilinear and cubic (geo/warp.py, "accumulation
// modes mirroring _resample_block")
enum Mode { kFast = 0, kUnmaskedWrap = 1, kMasked = 2 };
// How a block finds its pixels and their cells: kRows, an output row, its
// cells from a shift, where the lattice row fits in shared memory and no
// side passes 2^24 (every main path); kChunks, a chunk of an output row (a
// wider lattice row; the whole row where it fits and a side passes 2^24),
// its cells from the twin's float32 row and column numbers.
enum Layout { kRows = 0, kChunks = 1 };

constexpr int kThreads = 256;
// bilinear and cubic: at least 3 blocks of kThreads an SM, so at most 80
// registers a thread. Unbounded, the masked cubic kernel takes 156 and one
// block an SM, and 4 blocks (64 registers) spill up to 288 bytes a thread
// to local memory; 3 won on the card against both (PERF.md §6).
constexpr int kTapsMinBlocks = 3;
// [CONST] exact powers of two
constexpr float kTwoM8 = 1.0f / (float)(1ull << 8);
constexpr float kTwoM16 = 1.0f / (float)(1ull << 16);
constexpr float kTwoM22 = 1.0f / (float)(1ull << 22);
constexpr float kTwoM38 = 1.0f / (float)(1ull << 38);
constexpr float kTwoM40 = 1.0f / (float)(1ull << 40);
constexpr float kTwoM42 = 1.0f / (float)(1ull << 42);
constexpr float kTwoM50 = 1.0f / (float)(1ull << 50);
// two_prod's limits: 2^-100 and 2^100
constexpr float kFmaMinProduct = kTwoM50 * kTwoM50;
constexpr float kFmaMaxOperand = (float)(1ull << 50) * (float)(1ull << 50);
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 227 * 1024;
// the lattice columns a block stages: u, v and their differences to the
// next column, dd float32 each (32 B a column)
constexpr int kStageColumns = kMaxSmem / (8 * sizeof(float));
// the largest side of the output and of the lattice, and the most blocks:
// row and column numbers, cells and blockIdx.x are int32
constexpr long long kMaxSide = (1ll << 31) - 1;
// sides up to 2^24 have exact float32 row and column numbers, as the plain
// twin's torch.arange; past it they are rounded to nearest
constexpr long long kExactSide = 1ll << 24;
// how far the roundings of two float32 column numbers below 2^31 can widen
// their distance: half an ulp of 2^30 each
constexpr long long kRoundingSlack = 128;
// a cell weight below 2^24 is a bounded operand of the FMA TwoProduct
constexpr float kBoundedWeight = (float)(1 << 24);
constexpr long long kInt32Elements = 1ll << 31;

struct Lattice {
  const float* u_hi;
  const float* u_lo;
  const float* v_hi;
  const float* v_lo;
};

template <typename I>
struct Geom {
  I h, w;           // the source window
  I gh, gw;         // the lattice
  float inv;        // 1 / spacing, exact
  int shift;        // log2(spacing)
  I out_h, out_w;
  int wraps;
  I full_width;     // the period of a wrapping source's columns
  int32_t chunks;   // blocks an output row
  int32_t chunk_w;  // output columns a block (the last of a row: the rest)
  int layout;       // the Layout of the instantiations that take it
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

// core/eft.py::two_prod's error term (Dekker), p = a * b
__device__ __forceinline__ float dekker_error(float a, float b, float p) {
  const DD as = split(a);
  const DD bs = split(b);
  return add(add(add(sub(mul(as.hi, bs.hi), p), mul(as.hi, bs.lo)),
                 mul(as.lo, bs.hi)),
             mul(as.lo, bs.lo));
}

// What a TwoProduct's call site knows of its operands: both bounded, the
// first or the second any float (tested), or nothing (Dekker's split).
enum Operands { kBounded = 0, kAnyA = 1, kAnyB = 2, kUnknown = 3 };

// core/eft.py::two_prod: p + e == a * b, e as Dekker's bit for bit.
// [FMA] __fmaf_rn(a, b, -p) is the exact a * b - p. Dekker's e is that
// same value wherever no partial product of it underflows and nothing
// overflows: ulp(a) ulp(b) >= 2^-149 (Boldo 2006), i.e. an exponent sum of
// -103 or more for normal operands, and 4097 a, 4097 b and p finite. A zero
// error comes out +0 from both (Dekker's first partial is never -0, and an
// exact cancellation rounds to +0), a zero operand's too; and where p is
// inf or NaN, or an operand is, both give NaN. So the FMA's e is Dekker's
// where
//   |p| >= 2^-100 or p is NaN (normal operands: an exponent sum of -101 or
//   more; a subnormal one meets a factor of at least 2^26), or a or b is
//   +-0,
// and an operand x that its call site does not bound is not finite above
// 2^100 (kAnyB: a source value or a quotient, NaN where the source has
// holes) or is at most 2^100 (kAnyA: a lattice difference, inf and NaN
// to Dekker's split). A bounded operand is below 2^24 in magnitude, or
// NaN, by construction (each site says why), so a finite p is below 2^124
// and every finite split is finite. A pixel runs with the FMA in every
// product and `exact` notes whether each met those conditions; where one
// did not, the pixel runs again with Dekker's split in every product
// (kUnknown), the plain twin's 17 operations. So the test is three to five
// compares folded into one predicate, and a pixel has one branch, which
// the lanes of a warp nearly always take together.
template <int kOps>
__device__ __forceinline__ DD two_prod(float a, float b, bool& exact) {
  const float p = mul(a, b);
  if (kOps == kUnknown) return {p, dekker_error(a, b, p)};
  const float inf = __int_as_float(0x7f800000);
  bool ok = !(fabsf(p) < kFmaMinProduct) || a == 0.0f || b == 0.0f;
  if (kOps == kAnyA) ok = ok && fabsf(a) <= kFmaMaxOperand;
  if (kOps == kAnyB)
    ok = ok && !(fabsf(b) > kFmaMaxOperand && fabsf(b) < inf);
  exact = exact && ok;
  return {p, __fmaf_rn(a, b, -p)};
}

// geo/warp.py::_dd_norm .. _dd_mul
__device__ __forceinline__ DD dd_norm(float hi, float lo) {
  const float s = add(hi, lo);
  return {s, sub(lo, sub(s, hi))};
}

__device__ __forceinline__ DD dd_add(float ah, float al, float bh, float bl) {
  const DD t = two_sum(ah, bh);
  return dd_norm(t.hi, add(t.lo, add(al, bl)));
}

template <int kOps>
__device__ __forceinline__ DD dd_mul_f32(float ah, float al, float f,
                                         bool& exact) {
  const DD t = two_prod<kOps>(ah, f, exact);
  return dd_norm(t.hi, add(t.lo, mul(al, f)));
}

template <int kOps>
__device__ __forceinline__ DD dd_mul(DD x, DD y, bool& exact) {
  const DD t = two_prod<kOps>(x.hi, y.hi, exact);
  return dd_norm(t.hi, add(t.lo, add(mul(x.hi, y.lo), mul(x.lo, y.hi))));
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

template <typename I>
__device__ __forceinline__ I clamp_index(I x, I hi) {
  return x < 0 ? 0 : (x > hi ? hi : x);
}

// [WRAP] torch.remainder by a positive period: the result is in [0, n)
template <typename I>
__device__ __forceinline__ I remainder(I a, I n) {
  const I r = a % n;
  return r < 0 ? r + n : r;
}

// [INDEX] i0 + dr in int32 as torch's int32 add: two's-complement wrap
__device__ __forceinline__ int32_t add_i32(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}

// 0 <= x < n, for x of int32 and n > 0 of I
template <typename I>
__device__ __forceinline__ bool in_window(I x, I n) {
  return x >= 0 && x < n;
}

// geo/warp.py::device_resample_plain.gather, its row and column apart:
// the flat index is row_offset + col, the bounds test row_in && col_in
template <typename I>
__device__ __forceinline__ void gather_row(const Geom<I>& g, int32_t row,
                                           I* offset, bool* in) {
  *in = in_window<I>(row, g.h);
  *offset = clamp_index<I>(row, g.h - 1) * g.w;
}

template <typename I>
__device__ __forceinline__ void gather_col(const Geom<I>& g, int32_t col32,
                                           I* col, bool* in) {
  I c = col32;
  if (g.wraps) c = remainder<I>(c, g.full_width);
  *in = in_window<I>(c, g.w);
  *col = clamp_index<I>(c, g.w - 1);
}

// k0, the cell of output row or column k clamped to the lattice's last
// (n - 2), and its weight, as the plain twin computes them from
// f = float32(k) / spacing: floor(f), clamped, and f - float32(k0)
// (kFloat, the chunks). Up to 2^24 k and the weight's numerator are exact
// in float32, so k0 = k >> shift and (k - k0 spacing) / spacing are the
// same bits (kRows). Past it float32(k) is k rounded to nearest, so
// neighbouring k share a coordinate, as in the twin; k0 stays monotone in
// k, and a clamped weight may pass 2^24.
struct Cell {
  int32_t k0;
  float weight;
};

template <bool kFloat, typename I>
__device__ __forceinline__ Cell cell(const Geom<I>& g, int32_t k, I n) {
  if (kFloat) {
    const float f = mul(__int2float_rn(k), g.inv);
    // [CVT] the twin's floor(f).to(torch.int64); f <= 2^31, n - 2 < 2^31
    const long long below = (long long)floorf(f);
    const int32_t k0 = below < (long long)n - 2 ? (int32_t)below
                                                : (int32_t)(n - 2);
    return {k0, sub(f, __int2float_rn(k0))};
  }
  const int32_t k0 =
      (k >> g.shift) < n - 2 ? (k >> g.shift) : (int32_t)(n - 2);
  return {k0, mul((float)(k - (k0 << g.shift)), g.inv)};
}

// g0 + d f with d = g1 - g0 staged: the lattice's differences are any
// float (kAnyA); the weight f is the bounded operand, below 2^24: up to
// 2^24 every weight is (k is), and past it a caller whose weight may be
// clamped past 2^24 clears `exact` first (bounded_weight)
template <bool kExact>
__device__ __forceinline__ DD dd_lerp_staged(DD g0, DD d, float f,
                                             bool& exact) {
  const DD m = dd_mul_f32<kExact ? kAnyA : kUnknown>(d.hi, d.lo, f, exact);
  return dd_add(g0.hi, g0.lo, m.hi, m.lo);
}

// geo/warp.py::_dd_lerp: g0 + (g1 - g0) f
template <bool kExact>
__device__ __forceinline__ DD dd_lerp(DD g0, DD g1, float f, bool& exact) {
  return dd_lerp_staged<kExact>(
      g0, dd_add(g1.hi, g1.lo, -g0.hi, -g0.lo), f, exact);
}

// Whether a cell weight is a bounded operand of the FMA TwoProduct: below
// 2^24, as every weight of a side up to 2^24 is; past it a clamped weight
// (a lattice shorter than the output) may not be, and takes Dekker's split.
template <bool kFloat>
__device__ __forceinline__ bool bounded_weight(float f) {
  return !kFloat || f < kBoundedWeight;
}

// A chunk's block (kChunks): its output row i and columns
// j_a .. j_a + width - 1 (chunk_w of them, the rest in a row's last), and
// the lattice columns it stages, ka .. ka + n - 1 = k0(j_a) ..
// k0(j_a + width - 1) + 1, which hold every pixel's k0 and k0 + 1 (k0 is
// monotone in j, also past 2^24).
template <bool kFloat, typename I>
__device__ __forceinline__ void chunk_of(const Geom<I>& g, int32_t* i,
                                         int32_t* j_a, int32_t* width,
                                         int32_t* ka, int32_t* n) {
  const int32_t b = blockIdx.x;
  *i = b / g.chunks;
  *j_a = (b - *i * g.chunks) * g.chunk_w;
  const int32_t rest = (int32_t)g.out_w - *j_a;
  *width = rest < g.chunk_w ? rest : g.chunk_w;
  *ka = cell<kFloat>(g, *j_a, g.gw).k0;
  *n = cell<kFloat>(g, *j_a + *width - 1, g.gw).k0 + 2 - *ka;
}

// The row lerp of the lattice for output row i, over lattice columns
// ka .. ka + n - 1 (an output row's whole lattice row, or a chunk's), into
// shared memory, and the differences of neighbouring columns: the plain
// twin's column lerp computes g(k0 + 1) - g(k0) at every pixel, the same
// dd sum of the same operands as here, whatever the chunk. stage holds 8
// planes of n floats: u(k) hi and lo, u(k + 1) - u(k) hi and lo, then v's
// four.
template <bool kFloat, typename I>
__device__ __forceinline__ void stage_row(const Lattice& lat,
                                          const Geom<I>& g, int32_t i,
                                          int32_t ka, int32_t n,
                                          float* stage) {
  const Cell r = cell<kFloat>(g, i, g.gh);
  const I a = (I)r.k0 * g.gw + ka;
  const I b = a + g.gw;
  for (int32_t k = threadIdx.x; k < n; k += blockDim.x) {
    const DD u0 = {lat.u_hi[a + k], lat.u_lo[a + k]};
    const DD u1 = {lat.u_hi[b + k], lat.u_lo[b + k]};
    const DD v0 = {lat.v_hi[a + k], lat.v_lo[a + k]};
    const DD v1 = {lat.v_hi[b + k], lat.v_lo[b + k]};
    bool exact = bounded_weight<kFloat>(r.weight);
    DD u = dd_lerp<true>(u0, u1, r.weight, exact);
    DD v = dd_lerp<true>(v0, v1, r.weight, exact);
    if (!exact) {
      u = dd_lerp<false>(u0, u1, r.weight, exact);
      v = dd_lerp<false>(v0, v1, r.weight, exact);
    }
    stage[k] = u.hi;
    stage[n + k] = u.lo;
    stage[4 * n + k] = v.hi;
    stage[5 * n + k] = v.lo;
  }
  __syncthreads();
  for (int32_t k = threadIdx.x; k < n - 1; k += blockDim.x) {
    for (int32_t p = 0; p < 8 * n; p += 4 * n) {
      const DD d = dd_add(stage[p + k + 1], stage[p + n + k + 1],
                          -stage[p + k], -stage[p + n + k]);
      stage[p + 2 * n + k] = d.hi;
      stage[p + 3 * n + k] = d.lo;
    }
  }
}

// The column lerp at output column j of the staged lattice columns
// ka .. ka + n - 1: (u, v) as dd.
template <bool kFloat, typename I>
__device__ __forceinline__ void interp(const float* stage, int32_t n,
                                       int32_t ka, const Geom<I>& g,
                                       int32_t j, DD* u, DD* v) {
  const Cell c = cell<kFloat>(g, j, g.gw);
  const float* const s = stage + (c.k0 - ka);
  const DD u0 = {s[0], s[n]}, du = {s[2 * n], s[3 * n]};
  const DD v0 = {s[4 * n], s[5 * n]}, dv = {s[6 * n], s[7 * n]};
  bool exact = bounded_weight<kFloat>(c.weight);
  *u = dd_lerp_staged<true>(u0, du, c.weight, exact);
  *v = dd_lerp_staged<true>(v0, dv, c.weight, exact);
  if (!exact) {
    *u = dd_lerp_staged<false>(u0, du, c.weight, exact);
    *v = dd_lerp_staged<false>(v0, dv, c.weight, exact);
  }
}

// The type that steps a block's pixels, m = t, t + blockDim.x, ... <
// width, pixel j = j_a + m: kRows steps j itself (j_a = 0; no side passes
// 2^24), as int32; chunks step m as a uint32, since j + blockDim.x may
// pass 2^31 - 1.
template <int kLayout>
using Step = typename std::conditional<kLayout == kRows, int32_t,
                                       uint32_t>::type;

// nearest: T is an unsigned integer of the element's size, copied as bits
template <typename T, typename I, int kLayout>
__global__ void __launch_bounds__(kThreads)
    warp_nearest_kernel(const T* __restrict__ data,
                        const uint8_t* __restrict__ valid, Lattice lat,
                        Geom<I> g, T fill, T* __restrict__ out,
                        uint8_t* __restrict__ amb) {
  constexpr bool kFloat = kLayout == kChunks;
  extern __shared__ float stage[];
  int32_t i = blockIdx.x, j_a = 0, ka = 0, n = (int32_t)g.gw;
  int32_t width = (int32_t)g.out_w;
  if (kLayout != kRows) chunk_of<kFloat>(g, &i, &j_a, &width, &ka, &n);
  stage_row<kFloat>(lat, g, i, ka, n, stage);
  __syncthreads();
  T* const out_row = out + ((I)i * g.out_w + j_a);
  uint8_t* const amb_row = amb + ((I)i * g.out_w + j_a);
  const float h1 = (float)(g.h + 1);
  const float w1 = (float)(g.w + 1);
  for (Step<kLayout> m = threadIdx.x; m < (Step<kLayout>)width;
       m += blockDim.x) {
    DD u, v;
    interp<kFloat>(stage, n, ka, g, j_a + (int32_t)m, &u, &v);
    const Floor fr = dd_floor(v.hi, v.lo);
    const Floor fc = dd_floor(u.hi, u.lo);
    const bool a = near_edge(u.hi, fc.cf) || near_edge(v.hi, fr.cf);
    // a floor flip far outside the window cannot change the (fill) result
    bool in_range = v.hi >= -1.0f && v.hi <= h1;
    if (!g.wraps) in_range = in_range && u.hi >= -1.0f && u.hi <= w1;
    I offset, col;
    bool row_in, col_in;
    gather_row(g, fr.n, &offset, &row_in);
    gather_col(g, fc.n, &col, &col_in);
    const I flat = offset + col;
    const bool ok = row_in && col_in && (valid == nullptr || valid[flat] != 0);
    out_row[m] = ok ? data[flat] : fill;
    amb_row[m] = (a && in_range) ? 1 : 0;
  }
}

// geo/warp.py::device_resample_plain's kernel resamplers (dd_addc, dd_mulc,
// const_minus, poly_inner, poly_outer). Their products are kBounded on a
// regular pixel (|u - 0.5|, |v - 0.5| below 2^24, so the dd floor's error
// term is at most 1/2): the fractions are in [0, 1] and 1 + f, 1 - f,
// 2 - f of them in [0, 2], so every operand of the polynomials' products
// is below 2^4, a weight too, a product of two weights below 2^8 and the
// sum of 16 below 2^12. Elsewhere (a wrapping source's far columns, a NaN
// coordinate) nothing bounds them: kUnknown.
__device__ __forceinline__ DD dd_addc(DD x, float c) {
  return dd_add(x.hi, x.lo, c, 0.0f);
}

__device__ __forceinline__ DD const_minus(float c, DD x) {
  return dd_add(c, 0.0f, -x.hi, -x.lo);
}

// GDAL cubic (a = -0.5), |x| <= 1: 1.5x^3 - 2.5x^2 + 1
template <int kOps>
__device__ __forceinline__ DD poly_inner(DD x, bool& exact) {
  DD t = dd_addc(dd_mul_f32<kOps>(x.hi, x.lo, 1.5f, exact), -2.5f);
  t = dd_mul<kOps>(t, x, exact);
  t = dd_mul<kOps>(t, x, exact);
  return dd_addc(t, 1.0f);
}

// 1 < |x| < 2: -0.5x^3 + 2.5x^2 - 4x + 2
template <int kOps>
__device__ __forceinline__ DD poly_outer(DD x, bool& exact) {
  DD t = dd_addc(dd_mul_f32<kOps>(x.hi, x.lo, -0.5f, exact), 2.5f);
  t = dd_mul<kOps>(t, x, exact);
  t = dd_addc(t, -4.0f);
  t = dd_mul<kOps>(t, x, exact);
  return dd_addc(t, 2.0f);
}

// the tap weights of fraction f: bilinear at offsets 0, 1, cubic at
// -1 .. 2
template <int kTaps, int kOps>
__device__ __forceinline__ void tap_weights(DD f, DD (&wt)[kTaps],
                                            bool& exact) {
  if (kTaps == 2) {
    wt[0] = const_minus(1.0f, f);
    wt[1] = f;
  } else {
    wt[0] = poly_outer<kOps>(dd_addc(f, 1.0f), exact);
    wt[1] = poly_inner<kOps>(f, exact);
    wt[2] = poly_inner<kOps>(const_minus(1.0f, f), exact);
    wt[3] = poly_outer<kOps>(const_minus(2.0f, f), exact);
  }
}

// nextafterf(x, inf) for x > 0 or NaN: the next float up (inf after the
// largest finite one), x itself for inf and NaN
__device__ __forceinline__ float next_up(float x) {
  return x < __int_as_float(0x7f800000)
             ? __int_as_float(__float_as_int(x) + 1)
             : x;
}

// The taps' rows and columns of one pixel: flat index row_offset[r] +
// col[c], in the window where row_in[r] && col_in[c].
template <int kTaps, typename I>
struct Taps {
  I row_offset[kTaps], col[kTaps];
  bool row_in[kTaps], col_in[kTaps];
};

// What the taps of one pixel sum to.
struct Sums {
  DD res;           // the value: acc, or acc / wacc
  float wacc_hi;    // the weight sum's hi (0 in fast mode)
  float err_scale;  // 1, or 1 / max(|denominator|, 2^-8)
  float macc;       // the magnitude accumulator
  float spread;     // nan_to_num(vmax - vmin)
};

// The weights, the taps and the division of one pixel, with the FMA in
// every product (kExact; `exact` is cleared where a product fails its
// test) or Dekker's split.
template <int kTaps, int kMode, bool kExact, typename I>
__device__ __forceinline__ Sums sum_taps(const float* __restrict__ data,
                                         const uint8_t* __restrict__ valid,
                                         const Taps<kTaps, I>& t,
                                         const Floor& fu, const Floor& fv,
                                         bool& exact) {
  constexpr int kWeight = kExact ? kBounded : kUnknown;
  // the weights' products as bounded as they are, a source value or the
  // quotient any float
  constexpr int kValue = kExact ? kAnyB : kUnknown;
  const float inf = __int_as_float(0x7f800000);
  // [CONST] f32(1e-9): the double rounded to float
  const float eps9 = (float)1e-9;
  DD wr[kTaps], wc[kTaps];
  tap_weights<kTaps, kWeight>(DD{fv.cf, fv.cl}, wr, exact);
  tap_weights<kTaps, kWeight>(DD{fu.cf, fu.cl}, wc, exact);
  DD acc = {0.0f, 0.0f};
  DD wacc = {0.0f, 0.0f};
  float macc = 0.0f;
  // [NAN] torch.minimum / maximum propagate a NaN value, fminf / fmaxf
  // skip it, so the spread may differ from the twin's there; but a NaN
  // value the taps take makes acc and res NaN, and then the band's test is
  // false whatever the spread
  float vmin = inf;
  float vmax = -inf;
#pragma unroll
  for (int r = 0; r < kTaps; ++r) {
#pragma unroll
    for (int c = 0; c < kTaps; ++c) {
      const I flat = t.row_offset[r] + t.col[c];
      const float vf = data[flat];
      const DD w2 = dd_mul<kWeight>(wr[r], wc[c], exact);
      const DD term = dd_mul_f32<kValue>(w2.hi, w2.lo, vf, exact);
      if (kMode != kMasked) {
        macc = add(macc, fabsf(term.hi));
        vmin = fminf(vmin, vf);
        vmax = fmaxf(vmax, vf);
        acc = dd_add(acc.hi, acc.lo, term.hi, term.lo);
        if (kMode != kFast) wacc = dd_add(wacc.hi, wacc.lo, w2.hi, w2.lo);
      } else {
        const bool ok = t.row_in[r] && t.col_in[c] && valid[flat] != 0;
        macc = add(macc, ok ? fabsf(term.hi) : 0.0f);
        vmin = fminf(vmin, ok ? vf : inf);
        vmax = fmaxf(vmax, ok ? vf : -inf);
        acc = dd_add(acc.hi, acc.lo, ok ? term.hi : 0.0f,
                     ok ? term.lo : 0.0f);
        wacc = dd_add(wacc.hi, wacc.lo, ok ? w2.hi : 0.0f,
                      ok ? w2.lo : 0.0f);
      }
    }
  }
  float spread = sub(vmax, vmin);
  // [NAN] nan_to_num(nan=0, posinf=0, neginf=0)
  if (spread != spread || fabsf(spread) == inf) spread = 0.0f;
  if (kMode == kFast) return {acc, 0.0f, 1.0f, macc, spread};
  // the dd division: one Newton correction on the f32 quotient; [DIV]
  const float denom = wacc.hi > eps9 ? wacc.hi : 1.0f;
  const float q0 = __fdiv_rn(acc.hi, denom);
  const DD p = dd_mul_f32<kValue>(wacc.hi, wacc.lo, q0, exact);
  const DD rr = dd_add(acc.hi, acc.lo, -p.hi, -p.lo);
  const DD q = two_sum(q0, __fdiv_rn(rr.hi, denom));
  // [NAN] denom is positive: torch.maximum(|denom|, 2^-8) is fmaxf
  return {dd_norm(q.hi, q.lo), wacc.hi,
          __fdiv_rn(1.0f, fmaxf(fabsf(denom), kTwoM8)), macc, spread};
}

// bilinear (kTaps = 2, offsets 0, 1) and cubic (kTaps = 4, offsets -1 .. 2)
template <int kTaps, int kMode, typename I, int kLayout>
__global__ void __launch_bounds__(kThreads, kTapsMinBlocks)
    warp_kernel_kernel(const float* __restrict__ data,
                       const uint8_t* __restrict__ valid, Lattice lat,
                       Geom<I> g, float fill, float* __restrict__ out,
                       uint8_t* __restrict__ amb) {
  constexpr bool kFloat = kLayout == kChunks;
  extern __shared__ float stage[];
  int32_t i = blockIdx.x, j_a = 0, ka = 0, n = (int32_t)g.gw;
  int32_t width = (int32_t)g.out_w;
  if (kLayout != kRows) chunk_of<kFloat>(g, &i, &j_a, &width, &ka, &n);
  stage_row<kFloat>(lat, g, i, ka, n, stage);
  __syncthreads();
  float* const out_row = out + ((I)i * g.out_w + j_a);
  uint8_t* const amb_row = amb + ((I)i * g.out_w + j_a);
  const int32_t first = kTaps == 2 ? 0 : -1;
  const float hf = (float)g.h;
  const float wf = (float)g.w;
  // [CONST] f32(1e-9), f32(1e-12), f32(1e-30): the double rounded to float
  const float eps9 = (float)1e-9;
  const float eps12 = (float)1e-12;
  const float tiny = (float)1e-30;
  const float regular = (float)(1 << 24);
  for (Step<kLayout> m = threadIdx.x; m < (Step<kLayout>)width;
       m += blockDim.x) {
    DD u, v;
    interp<kFloat>(stage, n, ka, g, j_a + (int32_t)m, &u, &v);
    const DD uc = dd_add(u.hi, u.lo, -0.5f, 0.0f);
    const DD vc = dd_add(v.hi, v.lo, -0.5f, 0.0f);
    const Floor fu = dd_floor(uc.hi, uc.lo);
    const Floor fv = dd_floor(vc.hi, vc.lo);
    bool a = near_edge(uc.hi, fu.cf) || near_edge(vc.hi, fv.cf);
    bool center_in;
    if (g.wraps)
      center_in = v.hi >= 0.0f && v.hi <= hf;
    else
      center_in = u.hi >= 0.0f && u.hi <= wf && v.hi >= 0.0f && v.hi <= hf;
    // the taps' rows and columns: bounds, clamps and wraps once each
    Taps<kTaps, I> t;
#pragma unroll
    for (int k = 0; k < kTaps; ++k) {
      gather_row(g, add_i32(fv.n, first + k), &t.row_offset[k], &t.row_in[k]);
      gather_col(g, add_i32(fu.n, first + k), &t.col[k], &t.col_in[k]);
    }
    bool exact = fabsf(uc.hi) < regular && fabsf(vc.hi) < regular;
    Sums s = sum_taps<kTaps, kMode, true>(data, valid, t, fu, fv, exact);
    if (!exact)
      s = sum_taps<kTaps, kMode, false>(data, valid, t, fu, fv, exact);
    bool good = center_in;
    if (kMode != kFast) {
      good = good && s.wacc_hi > eps9;
      a = a || fabsf(sub(s.wacc_hi, eps9)) < eps12;
      // below the clamp the 1/wacc amplification outruns any band
      a = a || (good && fabsf(s.wacc_hi) < kTwoM8);
    }
    // the f32 rounding-boundary band; absh > 0 or NaN: [DIV]
    const float absh = add(fabsf(s.res.hi), tiny);
    const float half_ulp = mul(sub(next_up(absh), absh), 0.5f);
    const float coord_mag = add(add(fabsf(uc.hi), fabsf(vc.hi)), 32.0f);
    const float delta =
        add(mul(half_ulp, kTwoM16),
            mul(s.err_scale, add(mul(s.macc, kTwoM40),
                                 mul(mul(s.spread, coord_mag), kTwoM42))));
    a = a || fabsf(sub(fabsf(s.res.lo), half_ulp)) < delta;
    out_row[m] = good ? s.res.hi : fill;
    amb_row[m] = (a && center_in) ? 1 : 0;
  }
}

// The arguments of one warp, as warp_launch takes them.
struct WarpArgs {
  const void* data;
  const uint8_t* valid;
  Lattice lat;
  long long h, w, gh, gw;
  int shift;  // log2(spacing)
  long long out_h, out_w;
  int algorithm, elem_size;
  unsigned long long fill_bits;
  int wraps;
  long long full_width;
  void* out;
  uint8_t* amb;
};

// Whether an output side passes 2^24, where the row and column numbers are
// float32 roundings.
inline bool rounded(const WarpArgs& a) {
  return a.out_h > kExactSide || a.out_w > kExactSide;
}

// The output columns of a block. Where the lattice row fits in shared
// memory (kStageColumns), a block takes a whole output row, as on every
// main path. Else a chunk of W columns j_a .. j_b stages
// k0(j_b) + 2 - k0(j_a) lattice columns, at most
// floor((W - 1 + slack) / spacing) + 3 (the roundings of float32(j) widen
// the distance by up to kRoundingSlack past 2^24, by 0 below), and
// W = (kStageColumns - 3) spacing + 1 - slack fits.
inline long long chunk_columns(const WarpArgs& a) {
  if (a.gw <= kStageColumns) return a.out_w;
  const long long w = ((long long)(kStageColumns - 3) << a.shift) + 1 -
                      (rounded(a) ? kRoundingSlack : 0);
  return w < a.out_w ? w : a.out_w;
}

// The blocks of a warp: out_h rows of chunks.
inline long long blocks(const WarpArgs& a) {
  const long long w = chunk_columns(a);
  return a.out_h * ((a.out_w + w - 1) / w);
}

// The shared memory of a block: its staged lattice columns and their
// differences.
inline size_t stage_bytes(const WarpArgs& a) {
  const long long n = a.gw < kStageColumns ? a.gw : kStageColumns;
  return 8 * sizeof(float) * (size_t)n;
}

// 0 if the kernels take these arguments, else 1.
inline int bad_args(const WarpArgs& a) {
  if (a.data == nullptr || a.out == nullptr || a.amb == nullptr ||
      a.lat.u_hi == nullptr || a.lat.u_lo == nullptr ||
      a.lat.v_hi == nullptr || a.lat.v_lo == nullptr || a.h < 1 ||
      a.w < 1 || a.gh < 2 || a.gw < 2 || a.gh > kMaxSide ||
      a.gw > kMaxSide || a.out_h < 1 || a.out_w < 1 ||
      a.out_h > kMaxSide || a.out_w > kMaxSide || a.shift < 0 ||
      a.shift > 30 || (a.wraps && a.full_width < 1) || blocks(a) > kMaxSide)
    return 1;
  if (a.algorithm != kNearest && a.elem_size != 4) return 1;
  return 0;
}

// Whether a warp needs 64-bit flat indices: the window, the lattice or the
// output holds 2^31 elements or more, or a wrapping source's period is as
// wide (of the main paths, only a WorldCover window of a 10980^2 grid).
// 32-bit indices take the rest; on the card they are 15-30% faster (PERF.md
// §6).
inline bool index64(const WarpArgs& a) {
  return a.h * a.w >= kInt32Elements || a.gh * a.gw >= kInt32Elements ||
         a.out_h * a.out_w >= kInt32Elements ||
         (a.wraps && a.full_width >= kInt32Elements);
}

// The kernels' geometry, every field derived from `a` here.
template <typename I>
Geom<I> geom(const WarpArgs& a) {
  const float inv = 1.0f / (float)(1ll << a.shift);  // exact
  const long long w = chunk_columns(a);
  const int layout = rounded(a) || a.gw > kStageColumns ? kChunks : kRows;
  return {(I)a.h, (I)a.w, (I)a.gh, (I)a.gw, inv, a.shift, (I)a.out_h,
          (I)a.out_w, a.wraps ? 1 : 0, (I)(a.wraps ? a.full_width : 1),
          (int32_t)((a.out_w + w - 1) / w), (int32_t)w, layout};
}

template <typename T, int kLayout, typename I, typename Launch>
int launch_nearest(const Launch& launch, const WarpArgs& a,
                   const Geom<I>& g) {
  return launch(warp_nearest_kernel<T, I, kLayout>, (const T*)a.data,
                a.valid, a.lat, g, (T)a.fill_bits, (T*)a.out, a.amb);
}

template <int kTaps, int kLayout, typename I, typename Launch>
int launch_taps(const Launch& launch, const WarpArgs& a, const Geom<I>& g) {
  const uint32_t bits = (uint32_t)a.fill_bits;
  float fill;
  memcpy(&fill, &bits, sizeof(fill));
  const float* data = (const float*)a.data;
  float* out = (float*)a.out;
  if (a.valid != nullptr)
    return launch(warp_kernel_kernel<kTaps, kMasked, I, kLayout>, data,
                  a.valid, a.lat, g, fill, out, a.amb);
  if (a.wraps)
    return launch(warp_kernel_kernel<kTaps, kUnmaskedWrap, I, kLayout>, data,
                  a.valid, a.lat, g, fill, out, a.amb);
  return launch(warp_kernel_kernel<kTaps, kFast, I, kLayout>, data, a.valid,
                a.lat, g, fill, out, a.amb);
}

template <int kLayout, typename I, typename Launch>
int launch_with(const Launch& launch, const WarpArgs& a, const Geom<I>& g) {
  if (a.algorithm == kNearest) {
    switch (a.elem_size) {
      case 1: return launch_nearest<uint8_t, kLayout>(launch, a, g);
      case 2: return launch_nearest<uint16_t, kLayout>(launch, a, g);
      case 4: return launch_nearest<uint32_t, kLayout>(launch, a, g);
      case 8: return launch_nearest<uint64_t, kLayout>(launch, a, g);
      default: return -1;
    }
  }
  if (a.algorithm == kBilinear) return launch_taps<2, kLayout>(launch, a, g);
  if (a.algorithm == kCubic) return launch_taps<4, kLayout>(launch, a, g);
  return -1;
}

// The instantiations of g.layout.
template <typename I, typename Launch>
int launch_layout(const Launch& launch, const WarpArgs& a, const Geom<I>& g) {
  return g.layout == kRows ? launch_with<kRows>(launch, a, g)
                           : launch_with<kChunks>(launch, a, g);
}

// Run the instantiation that `a` selects (bad_args(a) == 0), with 32-bit
// indices unless index64(a) and the layout geom(a) takes:
// `launch` is called as launch(kernel, kernel's arguments...) and runs the
// kernel over blocks(a) blocks of kThreads with stage_bytes(a) of shared
// memory. Returns launch's result, or -1 for an element size or algorithm
// no kernel takes.
template <typename Launch>
int warp_dispatch(const Launch& launch, const WarpArgs& a) {
  return index64(a) ? launch_layout(launch, a, geom<int64_t>(a))
                    : launch_layout(launch, a, geom<int32_t>(a));
}

}  // namespace

// The output columns of a block and the blocks of a warp of these sizes
// (chunk_columns, blocks), for the wrapper's check (ops/warp_kernel.py::
// chunking); every library that includes this header exports it.
extern "C" void warp_chunking(long long gw, int shift, long long out_h,
                              long long out_w, long long* chunk_w,
                              long long* n_blocks) {
  WarpArgs a = {};
  a.gw = gw;
  a.shift = shift;
  a.out_h = out_h;
  a.out_w = out_w;
  *chunk_w = chunk_columns(a);
  *n_blocks = blocks(a);
}
