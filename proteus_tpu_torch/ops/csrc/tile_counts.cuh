// The coverage counts of the per-pixel pass, a tile at a time, and the
// walk over a launch's groups of pixels that they are segmented by.
//
// wtr_kernel.cu's wtr_pixel_kernel (K1, K3, K4, K5, K6, K6 spatial and pass
// A of K2) adds up three counters a tile, [B, 3] uint64 in device memory:
//   n_valid            invalid == 0 and, with ocean_in_valid, ocean != 0
//   n_cloud_and_valid  valid and preliminary CLOUD != 0: Fmask bit 1 or 3,
//                      or bit 2 in 'mask' mode, read before the aerosol
//                      remap (masking.py::compute_preliminary_cloud_layer)
//   n_not_ocean        ocean != 0 (every pixel without an ocean plane)
// over the pixels whose layers the launch writes: the whole stack, or a
// windowed launch's rows row0 .. row0 + rows_out - 1, never its halo. The
// reference computes them beside its kernel in the same compiled program
// (proteus_tpu/runtime/orchestrator.py:477-495, parallel/campaign.py:
// 218-231 and 441-452); the port's plain twin is models/dswx/chain.py::
// coverage_counts. A group's loads already hold its Fmask, invalid and
// ocean bytes, so counting moves no byte: word operations on those bytes
// (0x80 a nonzero byte, three masks, six popcounts a group of 8), a run of
// one tile in registers, warp reductions and one atomicAdd a counter and a
// tile a block. Integer atomics only: the result is exact and does not
// depend on the order of the blocks. (An atomicAdd a warp instead of a
// block is 8 times as many on the same three addresses, which the card
// serialises: K1 took 0.2283 ms against 0.1430 on an H100; PERF.md, PR
// 13.)
//
// Segmentation. An unwindowed launch walks the flattened B * H * W stack,
// kVec pixels a thread and a group, so a group (when H * W is no multiple
// of kVec), a warp, a block or a thread's grid-stride loop can span tile
// ends: every group finds its tile and the pixels left in it (tile_at), a
// group that straddles ends splits at each of them (count_group), a thread
// keeps one run of counts of one tile in registers and adds a run to the
// counters when its next pixel lies in another tile (add_to_run), and at
// the end a warp whose threads' runs are of one tile sums them, a warp
// that straddles lets each thread add its own (warp_run), and warp 0 does
// the same with the warps' sums (flush_block). A windowed launch takes a
// tile a grid row (blockIdx.y), and a group of its 4-pixel body lies in
// one row, so in or out of the window whole.
//
// The header compiles for the card (included by wtr_kernel.cu) and with
// g++ on the host behind tests/warp_host/cuda_runtime.h, where a block is
// one thread or a host thread a lane: tests/test_torch_counts.py runs the
// groups and the counts of both launches of an unwindowed stack and of
// windows there against numpy, the warps' votes and the block's flush
// with 32 lanes a warp.

#pragma once

#include <cstdint>

constexpr int kCounts = 3;  // n_valid, n_cloud_and_valid, n_not_ocean
constexpr int kMaxWarps = 32;  // a block of at most 1024 threads

// What a launch counts, as masks of a group's 8 bytes
struct CountRule {
  uint64_t cloud_bits;  // the Fmask bits of a non-zero preliminary CLOUD
  uint64_t land_fill;   // 0x80 a byte without an ocean plane: all land
  uint64_t valid_fill;  // 0x80 a byte where ocean does not enter valid
};

// cloud_bits: Fmask bits 1 (cloud) and 3 (cloud shadow), and 2 (adjacent)
// in 'mask' mode (masking.py::compute_preliminary_cloud_layer)
__host__ __device__ inline CountRule count_rule(bool mask_adjacent,
                                                bool with_ocean,
                                                bool ocean_in_valid) {
  constexpr uint64_t kBytes = 0x0101010101010101ull;
  return {(mask_adjacent ? 0x0Eu : 0x0Au) * kBytes,
          with_ocean ? 0 : 0x80 * kBytes, ocean_in_valid ? 0 : 0x80 * kBytes};
}

// 0x80 in each byte of w that is not zero
__host__ __device__ __forceinline__ uint32_t nonzero_bytes(uint32_t w) {
  return (((w & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | w) & 0x80808080u;
}

__host__ __device__ __forceinline__ uint64_t nonzero_bytes(uint64_t w) {
  return (uint64_t)nonzero_bytes((uint32_t)w)
      | (uint64_t)nonzero_bytes((uint32_t)(w >> 32)) << 32;
}

// A group's counts as masks of its pixels, 0x80 in byte j for pixel j:
// valid, cloud and valid, not ocean
struct GroupMasks {
  uint64_t valid, cloud, land;
};

// The masks of a group of kVec pixels from its Fmask, invalid and ocean
// bytes as loaded (pixel j in byte j of the 8, zeros beyond the group; the
// ocean's zeros without an ocean plane): a few word operations for the
// group, on the bytes its loads already hold in registers.
template <int kVec>
__host__ __device__ __forceinline__ GroupMasks group_masks(
    uint64_t fm, uint64_t inv, uint64_t oc, const CountRule& c) {
  static_assert(kVec <= 8, "a group's pixels are the bytes of 64 bits");
  constexpr uint64_t kGroup = 0x8080808080808080ull
      >> (8 * (8 - kVec));  // the group's bytes
  const uint64_t land = nonzero_bytes(oc) | (c.land_fill & kGroup);
  const uint64_t valid = ~nonzero_bytes(inv) & (land | c.valid_fill)
      & kGroup;
  return {valid, valid & nonzero_bytes(fm & c.cloud_bits), land};
}

// Stack pixel i's tile, t = floor(i / hw), and `rest`, the pixels from i
// to the tile's end, (t + 1) hw - i, without a 64-bit division a group:
// below 2^32, a 32-bit multiply-high and shifts (TileDiv); up to 2^53, the
// float64 product with the reciprocal 1 / hw, within one of t (both
// roundings are relative errors of 2^-53, and i / hw lies 1 / hw from an
// integer it is not), and one test either way.
struct TileAt {
  int tile;
  int64_t rest;
};

// A launch's division by hw: with every stack index below 2^32, 32-bit
// (the branch-free round-up method of Granlund and Montgomery: q =
// (t + ((i - t) >> s1)) >> s2 with t = umulhi(i, mul)); else the float64
// reciprocal.
struct TileDiv {
  double inv_hw;
  uint32_t mul;
  int32_t s1, s2;
  int32_t small;  // every stack index is below 2^32
};

__host__ __device__ inline TileDiv tile_div(int64_t hw, int64_t n) {
  TileDiv d = {1.0 / (double)hw, 0, 0, 0, n <= (int64_t)UINT32_MAX};
  if (d.small) {
    int l = 0;  // ceil(log2(hw))
    while (((int64_t)1 << l) < hw) ++l;
    d.mul = (uint32_t)((((uint64_t)1 << 32) * (((uint64_t)1 << l)
                                                - (uint64_t)hw))
                       / (uint64_t)hw + 1);
    d.s1 = l < 1 ? l : 1;
    d.s2 = l > 1 ? l - 1 : 0;
  }
  return d;
}

__host__ __device__ __forceinline__ uint32_t umulhi32(uint32_t a,
                                                      uint32_t b) {
#ifdef __CUDA_ARCH__
  return __umulhi(a, b);
#else
  return (uint32_t)(((uint64_t)a * b) >> 32);
#endif
}

__host__ __device__ __forceinline__ TileAt tile_at(int64_t i, int64_t hw,
                                                   const TileDiv& d) {
  if (d.small) {
    const uint32_t i32 = (uint32_t)i, t = umulhi32(i32, d.mul);
    const uint32_t q = (t + ((i32 - t) >> d.s1)) >> d.s2;
    return {(int)q, (int64_t)((q + 1) * (uint32_t)hw - i32)};
  }
  int64_t t = (int64_t)((double)i * d.inv_hw);
  int64_t start = t * hw;
  if (start > i) {
    --t;
    start -= hw;
  } else if (start + hw <= i) {
    ++t;
    start += hw;
  }
  return {(int)t, start + hw - i};
}

// A group of kVec pixels of a launch: i, its first pixel in the [B, H, W]
// stack; o, its index in the output window (-1 outside it); its tile and
// the pixels from i to the tile's end (unwindowed).
struct Group {
  int64_t i, o;
  int tile;
  int64_t rest;
};

// Group g of a thread's grid-stride loop (g, g + gridDim.x * blockDim.x,
// ...). Unwindowed: the groups from stack pixel `first`, o == i.
// kWindowed: the groups of tile blockIdx.y (hw < 2^31; kVec divides the
// width unless it is 1, so a group lies in one row), the outputs the [B,
// rows_out, width] window from block row row0.
template <int kVec, bool kWindowed>
__device__ __forceinline__ Group group_at(int64_t g, int64_t first,
                                          int64_t hw, const TileDiv& div,
                                          int width, int row0,
                                          int rows_out) {
  if constexpr (kWindowed) {
    // p, the group's first pixel in its tile, and its row: 32-bit; the
    // group's pixels share the row. The window index its tile's block row
    // 0 would have: ((int64_t)tile * rows_out - row0) * width.
    const int tile = (int)blockIdx.y;
    const int p = (int)g * kVec;
    const int64_t o = (unsigned)(p / width - row0) < (unsigned)rows_out
        ? ((int64_t)tile * rows_out - row0) * width + p : -1;
    return {(int64_t)tile * hw + p, o, tile, hw - p};
  } else {
    const int64_t i = first + g * kVec;
    const TileAt t = tile_at(i, hw, div);
    return {i, i, t.tile, t.rest};
  }
}

// A thread's counts of one tile so far, in registers
struct TileRun {
  int tile;  // -1: no pixel yet
  uint32_t n[kCounts];
};

__device__ __forceinline__ TileRun empty_run() {
  return {-1, {0, 0, 0}};
}

// A thread's run before its first group: of no tile yet, or kWindowed of
// its grid row's tile, the only one its groups lie in
template <bool kWindowed>
__device__ __forceinline__ TileRun thread_run() {
  return kWindowed ? TileRun{(int)blockIdx.y, {0, 0, 0}} : empty_run();
}

// The run to the counters of its tile: one atomicAdd a nonzero counter
__device__ __forceinline__ void flush_run(
    const TileRun& run, unsigned long long* counts) {
  if (run.tile < 0) return;
#pragma unroll
  for (int k = 0; k < kCounts; ++k)
    if (run.n[k])
      atomicAdd(counts + (int64_t)kCounts * run.tile + k,
                (unsigned long long)run.n[k]);
}

// The counts of the pixels `sel` picks (0x80 in their bytes) of a group's
// masks, to the run
__device__ __forceinline__ void add_masks(TileRun& run, const GroupMasks& m,
                                          uint64_t sel) {
  run.n[0] += __popcll(m.valid & sel);
  run.n[1] += __popcll(m.cloud & sel);
  run.n[2] += __popcll(m.land & sel);
}

// ... to the run of `tile`: a run of another tile goes to the counters
// first
__device__ __forceinline__ void add_to_run(
    TileRun& run, int tile, const GroupMasks& m, uint64_t sel,
    unsigned long long* counts) {
  if (tile != run.tile) {
    flush_run(run, counts);
    run = {tile, {0, 0, 0}};
  }
  add_masks(run, m, sel);
}

// A group, its counts in `m` (group_masks), to the runs: one add where
// the group lies in its tile, else one a stretch of its pixels in one
// tile, split at each tile end (hw % kVec != 0 puts a tile end inside some
// groups, hw < kVec more than one). kWindowed: the group lies in the run's
// tile.
template <int kVec, bool kWindowed>
__device__ __forceinline__ void count_group(
    TileRun& run, const Group& grp, const GroupMasks& m, int64_t hw,
    unsigned long long* counts) {
  constexpr uint64_t kAll = ~0ull;
  if constexpr (kWindowed) {
    add_masks(run, m, kAll);
    return;
  }
  // the group's pixels before its tile's end
  int tile = grp.tile;
  int64_t end = grp.rest;
  if (kVec == 1 || end >= kVec) {
    add_to_run(run, tile, m, kAll, counts);
    return;
  }
  int j0 = 0;
#pragma unroll 1
  while (j0 < kVec) {
    const int j1 = end < kVec ? (int)end : kVec;
    // the bytes of pixels j0 .. j1 - 1 (j1 <= 8)
    const uint64_t sel = (j1 == 8 ? kAll : (1ull << 8 * j1) - 1)
        & ~((1ull << 8 * j0) - 1);
    add_to_run(run, tile, m, sel, counts);
    j0 = j1;
    ++tile;
    end += hw;
  }
}

// The runs of a warp's threads as one run, of their tile, where they are
// of one tile (or empty); else each thread's run goes to the counters and
// the warp's is empty. Every lane of the warp calls it. (The sums are
// taken before the vote, beside the maximum, so that the reductions
// overlap.)
__device__ __forceinline__ TileRun warp_run(const TileRun& run,
                                            unsigned long long* counts) {
  constexpr unsigned kAll = 0xFFFFFFFFu;
  TileRun sum = {__reduce_max_sync(kAll, run.tile), {0, 0, 0}};
#pragma unroll
  for (int k = 0; k < kCounts; ++k)
    sum.n[k] = __reduce_add_sync(kAll, run.n[k]);
  if (__all_sync(kAll, run.tile == sum.tile || run.tile < 0)) return sum;
  // a warp across a tile end
  flush_run(run, counts);
  return empty_run();
}

// Every thread's last run to the counters, after its last group: each
// warp's runs as one (warp_run), then warp 0 takes the warps' runs as one
// lane each and adds their sum, one atomicAdd a counter where they are of
// one tile. Every thread of the block calls it: it synchronises the block.
__device__ __forceinline__ void flush_block(
    const TileRun& run, unsigned long long* counts) {
  __shared__ TileRun warps[kMaxWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const TileRun w = warp_run(run, counts);
  if (lane == 0) warps[warp] = w;
  __syncthreads();
  if (warp == 0) {
    const TileRun b = warp_run(
        lane < (int)(blockDim.x + 31) / 32 ? warps[lane] : empty_run(),
        counts);
    if (lane == 0) flush_run(b, counts);
  }
}
