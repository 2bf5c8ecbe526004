// The device warp's kernels on the CPU: warp_kernel.cuh compiled with g++
// behind the cuda_runtime.h stand-in beside this file, each block run as
// one thread. warp_launch has the signature of the CUDA entry point, so
// ops/warp_kernel.py binds and feeds it as it does the card's.
//
// g++ -std=c++17 -O2 -ffp-contract=off -shared -fPIC -I tests/warp_host
//     -I proteus_tpu_torch/ops/csrc tests/warp_host/warp_host.cpp -o lib.so

#include <cuda_runtime.h>

#include "warp_kernel.cuh"

#if defined(__x86_64__) || defined(__i386__)
#include <xmmintrin.h>
#endif

namespace {

float stage[kMaxSmem / sizeof(float)];  // the kernels' extern __shared__

struct HostLaunch {
  unsigned blocks;

  template <typename... P, typename... A>
  int operator()(void (*kernel)(P...), A... args) const {
    for (unsigned b = 0; b < blocks; ++b) {
      blockIdx.x = b;
      kernel(args...);
    }
    return 0;
  }
};

template <int kOps>
void two_prods(const float* a, const float* b, long long n, float* p,
               float* e) {
  for (long long k = 0; k < n; ++k) {
    // as a pixel does: the FMA, and Dekker's split where it fails its test
    bool exact = true;
    DD t = two_prod<kOps>(a[k], b[k], exact);
    if (!exact) t = two_prod<kUnknown>(a[k], b[k], exact);
    p[k] = t.hi;
    e[k] = t.lo;
  }
}

WarpArgs warp_args(const void* data, const void* valid, const float* u_hi,
                   const float* u_lo, const float* v_hi, const float* v_lo,
                   long long h, long long w, long long gh, long long gw,
                   int shift, long long out_h, long long out_w, int algorithm,
                   int elem_size, unsigned long long fill_bits, int wraps,
                   long long full_width, void* out, void* amb) {
  return {data, (const uint8_t*)valid, {u_hi, u_lo, v_hi, v_lo}, h, w, gh,
          gw, shift, out_h, out_w, algorithm, elem_size, fill_bits, wraps,
          full_width, out, (uint8_t*)amb};
}

}  // namespace

// 0 after the warp, 1 for arguments the kernels do not take (the stream is
// not read).
extern "C" int warp_launch(const void* data, const void* valid,
                           const float* u_hi, const float* u_lo,
                           const float* v_hi, const float* v_lo, long long h,
                           long long w, long long gh, long long gw, int shift,
                           long long out_h, long long out_w, int algorithm,
                           int elem_size, unsigned long long fill_bits,
                           int wraps, long long full_width, void* out,
                           void* amb, void*) {
  const WarpArgs a = warp_args(data, valid, u_hi, u_lo, v_hi, v_lo, h, w, gh,
                               gw, shift, out_h, out_w, algorithm, elem_size,
                               fill_bits, wraps, full_width, out, amb);
  if (bad_args(a)) return 1;
  return warp_dispatch(HostLaunch{(unsigned)out_h}, a) < 0 ? 1 : 0;
}

// warp_launch with the 64-bit index instantiations whatever the sizes, so
// that small warps hold them too.
extern "C" int warp_launch_int64(const void* data, const void* valid,
                                 const float* u_hi, const float* u_lo,
                                 const float* v_hi, const float* v_lo,
                                 long long h, long long w, long long gh,
                                 long long gw, int shift, long long out_h,
                                 long long out_w, int algorithm, int elem_size,
                                 unsigned long long fill_bits, int wraps,
                                 long long full_width, void* out, void* amb,
                                 void*) {
  const WarpArgs a = warp_args(data, valid, u_hi, u_lo, v_hi, v_lo, h, w, gh,
                               gw, shift, out_h, out_w, algorithm, elem_size,
                               fill_bits, wraps, full_width, out, amb);
  if (bad_args(a)) return 1;
  return launch_as<int64_t>(HostLaunch{(unsigned)out_h}, a) < 0 ? 1 : 0;
}

// 1 where warp_launch takes the 64-bit index instantiations for these
// sizes, else 0.
extern "C" int warp_index64(long long h, long long w, long long gh,
                            long long gw, long long out_h, long long out_w,
                            int wraps, long long full_width) {
  return index64(warp_args(nullptr, nullptr, nullptr, nullptr, nullptr,
                           nullptr, h, w, gh, gw, 0, out_h, out_w, 0, 1, 0,
                           wraps, full_width, nullptr, nullptr))
             ? 1
             : 0;
}

extern "C" const char* warp_error_string(int err) {
  return err ? "invalid argument" : "no error";
}

// two_prod<ops>(a[k], b[k]) -> (p[k], e[k]) for k < n, with Dekker's
// split where the FMA fails its test
extern "C" void warp_two_prod(const float* a, const float* b, long long n,
                              int ops, float* p, float* e) {
  switch (ops) {
    case kBounded: two_prods<kBounded>(a, b, n, p, e); break;
    case kAnyA: two_prods<kAnyA>(a, b, n, p, e); break;
    case kAnyB: two_prods<kAnyB>(a, b, n, p, e); break;
    default: two_prods<kUnknown>(a, b, n, p, e); break;
  }
}

// The calling thread's MXCSR (flush-to-zero is bit 15, denormals-are-zero
// bit 6), or 0xffffffff where there is none.
extern "C" unsigned warp_mxcsr() {
#if defined(__x86_64__) || defined(__i386__)
  return _mm_getcsr();
#else
  return 0xffffffffu;
#endif
}
