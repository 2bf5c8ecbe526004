// The traffic-floor null kernel for NVIDIA Hopper: the counterpart of
// tools/kernel_profile.py::_null_kernel (the Pallas TPU kernel that loads
// every input block of the production footprint, folds each into one int32
// and stores one uint8 block).
//
// It computes the same function, not the TPU kernel's blocks: one pass over
// n = H*W pixels,
//
//     acc = 0;  for each input k: acc ^= (int32) in_k[i];  out[i] = (uint8) acc
//
// with each input read exactly once and the output written once. Inputs are
// uint8, int16 or float32 planes, mixed within one call (the profile tool
// passes 6 bands + fmask + invalid), so the entry point takes an array of
// pointers and an array of type codes. int16 sign-extends, uint8
// zero-extends, float32 truncates toward zero ((int)x, cvt.rzi: what XLA's
// convert does for in-range values); the store keeps the low 8 bits. Its
// plain PyTorch twin is ops/null_kernel.py::null_fold_plain. The Pallas
// kernel's block_rows and VMEM limit are TPU tiling and have no counterpart.
//
// Bound: HBM bytes, nothing else (one convert and one XOR an input). With
// the tool's inputs a pixel moves 6 x 2 + 1 + 1 + 1 = 15 B (int16 bands) or
// 6 x 4 + 1 + 1 + 1 = 27 B (float32 bands): 200.9 MB and 361.7 MB a
// 3660 x 3660 tile, 0.0600 ms and 0.1080 ms at 3.35 TB/s. What the design
// does about it: a thread takes 8 consecutive pixels, so a uint8 plane is
// one 8-byte load, an int16 plane one 16-byte load, a float32 plane two
// 16-byte loads and the output one 8-byte store, neighbouring threads on
// neighbouring addresses; for the production footprint of 8 inputs the loop
// over the inputs is unrolled (a template parameter) so that all of a
// thread's loads are in flight before the first XOR, and any other count
// takes the same kernel with a runtime loop. The vector path needs every pointer aligned
// to its vector (checked at launch, never assumed: a row slice of a
// [B, H, W] stack may start anywhere); otherwise, and for the last n % 8
// pixels, a scalar kernel of the same body runs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxInputs = 8;
constexpr int kVec = 8;  // pixels a thread of the vector kernel takes

enum NullType { kU8 = 0, kI16 = 1, kF32 = 2 };

struct NullArgs {
  const void* in[kMaxInputs];
  int type[kMaxInputs];
};

__device__ __forceinline__ int32_t f2i(float x) { return (int32_t)x; }

// One pixel of input k.
__device__ __forceinline__ int32_t load1(const void* p, int type, int64_t i) {
  switch (type) {
    case kU8:
      return (int32_t)((const uint8_t*)p)[i];
    case kI16:
      return (int32_t)((const int16_t*)p)[i];
    default:
      return f2i(((const float*)p)[i]);
  }
}

// kVec pixels of input k from pixel i (a multiple of kVec), XORed into acc.
__device__ __forceinline__ void fold8(const void* p, int type, int64_t i,
                                      int32_t (&acc)[kVec]) {
  switch (type) {
    case kU8: {
      const uint2 v = *(const uint2*)((const uint8_t*)p + i);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[j] ^= (int32_t)((v.x >> (8 * j)) & 0xFFu);
        acc[4 + j] ^= (int32_t)((v.y >> (8 * j)) & 0xFFu);
      }
      break;
    }
    case kI16: {
      const uint4 v = *(const uint4*)((const int16_t*)p + i);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[2 * j] ^= (int32_t)(int16_t)(w[j] & 0xFFFFu);
        acc[2 * j + 1] ^= (int32_t)(int16_t)(w[j] >> 16);
      }
      break;
    }
    default: {
      const float4 a = *(const float4*)((const float*)p + i);
      const float4 b = *(const float4*)((const float*)p + i + 4);
      acc[0] ^= f2i(a.x);
      acc[1] ^= f2i(a.y);
      acc[2] ^= f2i(a.z);
      acc[3] ^= f2i(a.w);
      acc[4] ^= f2i(b.x);
      acc[5] ^= f2i(b.y);
      acc[6] ^= f2i(b.z);
      acc[7] ^= f2i(b.w);
    }
  }
}

// n_vec groups of kVec pixels; kInputs = 0 loops over a runtime count.
template <int kInputs>
__global__ void null_fold_vec_kernel(NullArgs args, int n_inputs,
                                     uint8_t* __restrict__ out,
                                     int64_t n_vec) {
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n_vec) return;
  const int64_t i = g * kVec;
  int32_t acc[kVec] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (kInputs > 0) {
#pragma unroll
    for (int k = 0; k < kInputs; ++k) fold8(args.in[k], args.type[k], i, acc);
  } else {
    for (int k = 0; k < n_inputs; ++k) fold8(args.in[k], args.type[k], i, acc);
  }
  uint2 o;
  o.x = (uint32_t)(acc[0] & 0xFF) | ((uint32_t)(acc[1] & 0xFF) << 8) |
        ((uint32_t)(acc[2] & 0xFF) << 16) | ((uint32_t)(acc[3] & 0xFF) << 24);
  o.y = (uint32_t)(acc[4] & 0xFF) | ((uint32_t)(acc[5] & 0xFF) << 8) |
        ((uint32_t)(acc[6] & 0xFF) << 16) | ((uint32_t)(acc[7] & 0xFF) << 24);
  *(uint2*)(out + i) = o;
}

// Pixels [first, n), one a thread: the unaligned case and the tail.
__global__ void null_fold_scalar_kernel(NullArgs args, int n_inputs,
                                        uint8_t* __restrict__ out,
                                        int64_t first, int64_t n) {
  const int64_t i = first + (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int32_t acc = 0;
  for (int k = 0; k < n_inputs; ++k)
    acc ^= load1(args.in[k], args.type[k], i);
  out[i] = (uint8_t)(acc & 0xFF);
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

bool aligned(const void* p, int bytes) {
  return ((uintptr_t)p % (uintptr_t)bytes) == 0;
}

}  // namespace

// XOR-fold n_inputs planes of n pixels (types[k]: 0 uint8, 1 int16, 2
// float32) into the uint8 plane `out`, on `stream` (PyTorch's current stream
// of the current device); does not synchronise. Returns cudaGetLastError()
// after the launch, cudaErrorInvalidValue for bad arguments, and
// cudaErrorInvalidDevice for a pointer of another card than the current
// one. `vectorized`, if not null, is set to 1 when the 8-pixel kernel ran.
extern "C" int null_fold_launch(const void* const* inputs, const int* types,
                                int n_inputs, void* out, long long n,
                                int* vectorized, void* stream) {
  if (n_inputs < 1 || n_inputs > kMaxInputs || n < 1 || out == nullptr)
    return (int)cudaErrorInvalidValue;
  NullArgs args;
  bool vec = aligned(out, 8);
  for (int k = 0; k < kMaxInputs; ++k) {
    args.in[k] = nullptr;
    args.type[k] = kU8;
  }
  for (int k = 0; k < n_inputs; ++k) {
    if (inputs[k] == nullptr || types[k] < kU8 || types[k] > kF32)
      return (int)cudaErrorInvalidValue;
    if (const int err = check_device(inputs[k])) return err;
    args.in[k] = inputs[k];
    args.type[k] = types[k];
    // a group of 8 pixels: 8 B of uint8, 16 B of int16 or float32 vectors
    vec = vec && aligned(inputs[k], types[k] == kU8 ? 8 : 16);
  }
  if (const int err = check_device(out)) return err;
  const cudaStream_t s = (cudaStream_t)stream;
  const int threads = 256;
  const int64_t n_vec = vec ? n / kVec : 0;
  if (vectorized) *vectorized = n_vec > 0;
  if (n_vec > 0) {
    const unsigned blocks = (unsigned)((n_vec + threads - 1) / threads);
#define NULL_VEC(K)                                            \
  null_fold_vec_kernel<K><<<blocks, threads, 0, s>>>(          \
      args, n_inputs, (uint8_t*)out, n_vec)
    switch (n_inputs) {
      case 8: NULL_VEC(8); break;
      default: NULL_VEC(0); break;
    }
#undef NULL_VEC
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t first = n_vec * kVec;
  if (first < n) {
    const unsigned blocks = (unsigned)((n - first + threads - 1) / threads);
    null_fold_scalar_kernel<<<blocks, threads, 0, s>>>(
        args, n_inputs, (uint8_t*)out, first, (int64_t)n);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* null_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
