// The device warp for NVIDIA Hopper: the launch of the kernels in
// warp_kernel.cuh (which says what they compute, what bounds them and how
// they stay bit for bit the plain twin's), and its plain C entry point.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_kernel.cuh"

namespace {

int check_device(const void* p) {
  cudaPointerAttributes attr;
  cudaError_t e = cudaPointerGetAttributes(&attr, p);
  if (e != cudaSuccess) return (int)e;
  int current = -1;
  e = cudaGetDevice(&current);
  if (e != cudaSuccess) return (int)e;
  return attr.device == current ? 0 : (int)cudaErrorInvalidDevice;
}

// Launches a kernel over `blocks` output rows on `stream`, raising its
// dynamic shared memory limit above the default 48 KB where needed.
struct CudaLaunch {
  unsigned blocks;
  size_t smem;
  cudaStream_t stream;

  template <typename... P, typename... A>
  int operator()(void (*kernel)(P...), A... args) const {
    if (smem > (size_t)kDefaultSmem) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    kernel<<<blocks, kThreads, smem, stream>>>(args...);
    return (int)cudaGetLastError();
  }
};

}  // namespace

// Warp `data` (h x w elements of elem_size bytes; float32 for bilinear and
// cubic) onto the out_h x out_w grid: `out` (data's type) and `amb` (bool,
// one byte a pixel). `valid` is null or h x w bools; lat holds four gh x gw
// float32 planes; the lattice spacing is 2^shift. `fill_bits` is the fill's
// bits in data's type (little-endian, the low elem_size bytes; float32 bits
// for bilinear and cubic). The flat indices are 64-bit where h * w,
// gh * gw, out_h * out_w or a wrap's full_width reaches 2^31, else 32-bit
// (index64 in warp_kernel.cuh). Runs on `stream` (PyTorch's current stream
// of the current device) and does not synchronise. Returns cudaGetLastError() after the launch,
// cudaErrorInvalidValue for bad arguments, and cudaErrorInvalidDevice for a
// pointer of another card than the current one.
extern "C" int warp_launch(const void* data, const void* valid,
                           const float* u_hi, const float* u_lo,
                           const float* v_hi, const float* v_lo, long long h,
                           long long w, long long gh, long long gw, int shift,
                           long long out_h, long long out_w, int algorithm,
                           int elem_size, unsigned long long fill_bits,
                           int wraps, long long full_width, void* out,
                           void* amb, void* stream) {
  const WarpArgs a = {data, (const uint8_t*)valid, {u_hi, u_lo, v_hi, v_lo},
                      h, w, gh, gw, shift, out_h, out_w, algorithm,
                      elem_size, fill_bits, wraps, full_width, out,
                      (uint8_t*)amb};
  if (bad_args(a)) return (int)cudaErrorInvalidValue;
  const void* pointers[] = {data, u_hi, u_lo, v_hi, v_lo, out, amb};
  for (const void* p : pointers)
    if (const int err = check_device(p)) return err;
  if (valid != nullptr)
    if (const int err = check_device(valid)) return err;
  const CudaLaunch launch = {(unsigned)out_h, stage_bytes(a),
                             (cudaStream_t)stream};
  const int err = warp_dispatch(launch, a);
  return err < 0 ? (int)cudaErrorInvalidValue : err;
}

extern "C" const char* warp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
