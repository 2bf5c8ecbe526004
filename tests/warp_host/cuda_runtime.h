// A stand-in for CUDA's runtime header, enough to compile
// proteus_tpu_torch/ops/csrc/warp_kernel.cuh with g++ for the CPU: a block
// is one thread (threadIdx.x 0, blockDim.x 1, its loops stride by 1), the
// launch is a loop over blockIdx.x, shared memory is a static array, and
// the _rn intrinsics are the IEEE operations they are on the card
// (compile with -ffp-contract=off, so that no a * b + c is fused but the
// one std::fmaf stands for).
#pragma once

#include <math.h>  // fabsf, floorf, fminf, fmaxf, fmaf

#include <cmath>
#include <cstdint>
#include <cstring>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__
#define __launch_bounds__(...)

struct HostIndex {
  unsigned x;
};

inline HostIndex threadIdx = {0};
inline HostIndex blockDim = {1};
inline HostIndex blockIdx = {0};

inline void __syncthreads() {}

inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fmaf_rn(float a, float b, float c) { return std::fmaf(a, b, c); }
inline float __int2float_rn(int x) { return (float)x; }

inline float __int_as_float(int x) {
  float f;
  std::memcpy(&f, &x, sizeof(f));
  return f;
}

inline int __float_as_int(float f) {
  int x;
  std::memcpy(&x, &f, sizeof(x));
  return x;
}
