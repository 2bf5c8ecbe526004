// A stand-in for CUDA's runtime header, enough to compile
// proteus_tpu_torch/ops/csrc/warp_kernel.cuh and tile_counts.cuh with g++
// for the CPU: a block is one thread (threadIdx.x 0, blockDim.x 1, its
// loops stride by 1), the launch is a loop over blockIdx.x (and .y),
// shared memory is a static array, and the _rn intrinsics are the IEEE
// operations they are on the card (compile with -ffp-contract=off, so that
// no a * b + c is fused but the one std::fmaf stands for). A warp is that
// one thread too: its reductions and votes return the thread's own value,
// and atomicAdd is an addition.
// A block may also run as blockDim.x host threads, one a lane
// (tests/warp_host/counts_host.cpp sets host_block while it does, and
// makes __shared__ storage static, one for the block): threadIdx is then
// each thread's own, __syncthreads waits for the block's threads, a warp's
// reductions and votes take its 32 lanes' values, and atomicAdd holds a
// lock.
#pragma once

#include <math.h>  // fabsf, floorf, fminf, fmaxf, fmaf

#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__
#define __launch_bounds__(...)

struct HostIndex {
  unsigned x, y;
};

inline thread_local HostIndex threadIdx = {0, 0};
inline HostIndex blockDim = {1, 1};
inline HostIndex blockIdx = {0, 0};
inline HostIndex gridDim = {1, 1};

// A barrier of n host threads
struct HostBarrier {
  std::mutex m;
  std::condition_variable cv;
  int n = 0, waiting = 0;
  unsigned long generation = 0;

  void wait() {
    std::unique_lock<std::mutex> lock(m);
    const unsigned long g = generation;
    if (++waiting == n) {
      waiting = 0;
      ++generation;
      cv.notify_all();
    } else {
      cv.wait(lock, [&] { return generation != g; });
    }
  }
};

// A block run as host threads: its barrier, and each warp's barrier and
// its lanes' values
struct HostBlock {
  HostBarrier block, warp[32];
  long long lanes[32][32];
  std::mutex atomic;
};

inline HostBlock* host_block = nullptr;

inline void __syncthreads() {
  if (host_block) host_block->block.wait();
}

// f over the values of the calling thread's warp's lanes (its own alone
// without host_block)
template <typename T, typename F>
inline T host_warp_fold(T v, F f) {
  if (!host_block) return v;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  HostBarrier& bar = host_block->warp[w];
  host_block->lanes[w][lane] = (long long)v;
  bar.wait();
  T r = (T)host_block->lanes[w][0];
  for (int k = 1; k < bar.n; ++k) r = f(r, (T)host_block->lanes[w][k]);
  bar.wait();  // every lane has read before any writes again
  return r;
}

inline int __popcll(unsigned long long x) { return __builtin_popcountll(x); }
inline int __reduce_max_sync(unsigned, int v) {
  return host_warp_fold(v, [](int a, int b) { return a > b ? a : b; });
}
inline unsigned __reduce_add_sync(unsigned, unsigned v) {
  return host_warp_fold(v, [](unsigned a, unsigned b) { return a + b; });
}
inline bool __all_sync(unsigned, bool p) {
  return host_warp_fold((int)p, [](int a, int b) { return a & b; }) != 0;
}

inline unsigned long long atomicAdd(unsigned long long* p,
                                    unsigned long long v) {
  std::unique_lock<std::mutex> lock;
  if (host_block) lock = std::unique_lock<std::mutex>(host_block->atomic);
  const unsigned long long old = *p;
  *p = old + v;
  return old;
}

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
