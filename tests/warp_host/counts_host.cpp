// The per-pixel pass's coverage counts on the CPU: tile_counts.cuh compiled
// with g++ behind the cuda_runtime.h stand-in beside this file. The
// kernel's group loop and its counting (wtr_kernel.cu::wtr_pixel_kernel,
// the bands and layers left out), each block run as one thread or as a
// host thread a lane (the warps' reductions and votes, flush_block's
// shared array and barrier as on the card); the launches as
// wtr_pixel_launch makes them: an unwindowed stack's 8-pixel body and its
// one-pixel tail, or a window a grid row a tile.
//
// g++ -std=c++17 -O2 -shared -fPIC -pthread -I tests/warp_host
//     -I proteus_tpu_torch/ops/csrc tests/warp_host/counts_host.cpp -o lib.so

#include <cuda_runtime.h>

#include <algorithm>
#include <cstring>
#include <thread>
#include <vector>

// one block runs at a time: a static array is the block's shared memory
#undef __shared__
#define __shared__ static
#include "tile_counts.cuh"

namespace {

struct Planes {
  const uint8_t *fmask, *invalid, *ocean;
};

// wtr_pixel_kernel's loop and counts on the thread of block (blockIdx.x,
// blockIdx.y), its loads element by element
template <int kVec, bool kWindowed>
void count_kernel(const Planes& in, const CountRule& rule, int64_t first,
                  int64_t groups, int64_t hw, const TileDiv& div, int width,
                  int row0, int rows_out, unsigned long long* counts) {
  TileRun run = thread_run<kWindowed>();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       g < groups; g += stride) {
    const Group grp = group_at<kVec, kWindowed>(g, first, hw, div, width,
                                                row0, rows_out);
    if (grp.o < 0) continue;
    // the group's bytes as the kernel's vector loads hold them
    uint64_t fm = 0, inv = 0, oc = 0;
    for (int j = 0; j < kVec; ++j) {
      fm |= (uint64_t)in.fmask[grp.i + j] << 8 * j;
      inv |= (uint64_t)in.invalid[grp.i + j] << 8 * j;
      if (in.ocean) oc |= (uint64_t)in.ocean[grp.i + j] << 8 * j;
    }
    count_group<kVec, kWindowed>(
        run, grp, group_masks<kVec>(fm, inv, oc, rule), hw, counts);
  }
  flush_block(run, counts);
}

// one launch of blocks of `lanes` threads, about `threads` in all (at
// most a block's more than one a group), `rows` grid rows; a block of one
// thread runs on the calling thread, a larger one as `lanes` host threads
template <int kVec, bool kWindowed>
void launch(long long threads, int lanes, int rows, const Planes& in,
            const CountRule& rule, int64_t first, int64_t groups, int64_t hw,
            const TileDiv& div, int width, int row0, int rows_out,
            unsigned long long* counts) {
  const unsigned blocks = (unsigned)std::max<long long>(
      1, std::min<long long>((threads + lanes - 1) / lanes,
                             (groups + lanes - 1) / lanes));
  gridDim = {blocks, (unsigned)rows};
  blockDim = {(unsigned)lanes, 1};
  for (int y = 0; y < rows; ++y)
    for (unsigned b = 0; b < blocks; ++b) {
      blockIdx = {b, (unsigned)y};
      auto run = [&](unsigned t) {
        threadIdx = {t, 0};
        count_kernel<kVec, kWindowed>(in, rule, first, groups, hw, div,
                                      width, row0, rows_out, counts);
      };
      if (lanes == 1) {
        run(0);
        continue;
      }
      HostBlock block;
      block.block.n = lanes;
      for (int w = 0; w * 32 < lanes; ++w)
        block.warp[w].n = std::min(32, lanes - 32 * w);
      host_block = &block;
      std::vector<std::thread> lane_threads;
      for (int t = 0; t < lanes; ++t) lane_threads.emplace_back(run, t);
      for (std::thread& t : lane_threads) t.join();
      host_block = nullptr;
    }
  blockDim = {1, 1};
  threadIdx = {0, 0};
}

}  // namespace

// The counts of a [batch, height, width] stack into counts [batch, 3]:
// unwindowed (rows_out == height), the 8-pixel body over the first n - n %
// 8 pixels and the one-pixel tail (vec 8) or the one-pixel body alone (vec
// 1); windowed, the rows row0 .. row0 + rows_out - 1 of each tile with 4
// (vec 4, width % 4 == 0) or 1 pixels a group. `threads`: the grid's
// threads (the card's launch takes one a group, up to 2^28), fewer to make
// each thread's loop take several groups; `lanes`: a block's threads (the
// card's 256; 1, or a multiple of 32 up to 1024). 0, or 1 for arguments
// the launcher refuses.
extern "C" int count_launch(const uint8_t* fmask, const uint8_t* invalid,
                            const uint8_t* ocean, int batch, int height,
                            int width, int row0, int rows_out, int vec,
                            int mask_adjacent, int ocean_in_valid,
                            long long threads, int lanes,
                            unsigned long long* counts) {
  if (batch < 1 || height < 1 || width < 1 || row0 < 0 || rows_out < 1
      || row0 + rows_out > height || lanes < 1 || lanes > 1024
      || (lanes > 1 && lanes % 32))
    return 1;
  const Planes in = {fmask, invalid, ocean};
  const CountRule rule = count_rule(mask_adjacent, ocean != nullptr,
                                    ocean_in_valid);
  std::memset(counts, 0, sizeof(unsigned long long) * kCounts * batch);
  const int64_t hw = (int64_t)height * width, n = batch * hw;
  const TileDiv div = tile_div(hw, n);
  if (rows_out != height) {
    if (vec == 4 && width % 4 == 0)
      launch<4, true>(threads, lanes, batch, in, rule, 0, hw / 4, hw, div,
                      width, row0, rows_out, counts);
    else if (vec == 1)
      launch<1, true>(threads, lanes, batch, in, rule, 0, hw, hw, div,
                      width, row0, rows_out, counts);
    else
      return 1;
    return 0;
  }
  if (vec != 8 && vec != 1) return 1;
  const int64_t n_vec = vec == 8 ? n / 8 : 0;
  if (n_vec > 0)
    launch<8, false>(threads, lanes, 1, in, rule, 0, n_vec, hw, div, width,
                     0, height, counts);
  if (n - n_vec * 8 > 0)
    launch<1, false>(threads, lanes, 1, in, rule, n_vec * 8, n - n_vec * 8,
                     hw, div, width, 0, height, counts);
  return 0;
}

// tile_at for each of i[0 .. n) in a stack of `stack` pixels (below 2^32
// the 32-bit division): the tiles and the pixels to their ends; returns
// whether the 32-bit division took them
extern "C" int count_tile_at(const long long* i, long long n, long long hw,
                             long long stack, int* tile, long long* rest) {
  const TileDiv div = tile_div(hw, stack);
  for (long long k = 0; k < n; ++k) {
    const TileAt t = tile_at(i[k], hw, div);
    tile[k] = t.tile;
    rest[k] = t.rest;
  }
  return div.small;
}
