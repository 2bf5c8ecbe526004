// Fused DSWx-HLS per-pixel chain for NVIDIA Hopper: kernel slices K1 to
// K6 of proteus_tpu/ops/pallas/wtr_kernel.py::make_wtr_kernel.
//
// From the six bands, the fmask, the invalid mask and the optional ocean /
// shadow / landcover planes they write DIAG (uint16 pseudo-binary) and
// WTR-1, WTR-2, WTR, BWTR, CONF, CLOUD and BROWSE (uint8), or, with the
// minimal outputs, the two packed planes PACKED_A and PACKED_B. Their
// plain PyTorch twins are proteus_tpu_torch/models/dswx/chain.py::dswx_chain
// and ops/wtr_kernel.py::wtr_layers_batched_plain.
//
//   K1  int16 bands, 'mask'/'ignore': wtr_pixel_kernel<int16_t, false, *>.
//   K3  float32 (offset-and-scaled) bands: wtr_pixel_kernel<float, false,
//       *>.
//   K2  'cover': wtr_pixel_kernel (K1's or K3's body) stops before snow
//       and writes one state byte a pixel; wtr_k2_kernel then runs the two
//       masked dilations on 2-D tiles with their halo and finishes CLOUD,
//       WTR, BWTR, CONF and BROWSE.
//   K4  device scale: wtr_pixel_kernel<int16_t, true, *> reads raw int16
//       bands and casts scale * (float32(band) - offset) per tile in
//       registers, in the reference's order (io/hls.py:176), before K3's
//       body; the block stages the batch's [B, 6] scales and offsets in
//       shared memory once.
//   K5  minimal outputs: the epilogue packs DIAG6, CLOUD, WTR-1 and WTR-2
//       into PACKED_A = diag6 | (cloud & 3) << 6 and PACKED_B =
//       (cloud >> 2) & 3 | widx(WTR-1) << 2 | widx(WTR-2) << 5 (CLOUD 0
//       where it is fill; the inverse is host_derive.unpack_minimal) and
//       writes none of the nine full-output bytes. In 'cover' mode pass A
//       writes DIAG6 and the two index fields, and wtr_k2_kernel ORs the
//       final CLOUD's four bits in.
//   K6  batched launch: one launch for a [B, H, W] stack. The per-pixel
//       pass strides over B*H*W (tile index i / (H*W)); wtr_k2_kernel
//       takes the tile from blockIdx.z.
//       Spatial launch (proteus_tpu/parallel/campaign.py:384-439, the
//       Pallas kernel on a shard's halo-padded rows, then cropped): the
//       inputs are a [B, Hb, W] block of tile rows, the outputs the
//       [B, rows_out, W] window of block rows [row0, row0 + rows_out).
//       The per-pixel pass (wtr_pixel_kernel<*, *, true>) walks the
//       block; a pixel outside the window writes only its 'cover' state
//       byte (and nothing outside 'cover', where a shard's block is its
//       window). wtr_k2_kernel's grid covers the window's rows; it stages
//       the block's state with zeros beyond the block, reads WTR-2 and
//       writes its layers in the window. No ghost rows and no copy-out
//       crop: at the tile's true edges the block simply stops, which is
//       the single-device border. row0 = 0 and rows_out = Hb is the plain
//       K6 launch, through wtr_pixel_kernel<*, *, false>, the kernel as
//       it was before the spatial launch (a runtime window branch in
//       every launch made the unwindowed ones 15-21% slower; PERF.md,
//       Findings).
//
// Bound: HBM bytes; the work is a few dozen operations a pixel. Per pixel
// of a 3660 x 3660 tile (13,395,600 px), main-path planes (shadow,
// landcover, browse; +1 B/px in with ocean):
//   K1  reads 16 B (6 x 2 B bands, fmask, invalid, shadow, landcover) and
//       writes 9 B (DIAG 2 B + 7 x 1 B): 25 B/px, 334.9 MB/tile.
//   K3  reads 28 B (6 x 4 B bands + 4 planes), writes 9 B: 37 B/px,
//       495.6 MB/tile.
//   K2  pass A (int16) reads 16 B and writes 5 B (DIAG, WTR-1, WTR-2,
//       state); pass B reads 2 B (state, WTR-2) and writes 5 B: 28 B/px,
//       375.1 MB/tile, plus the halo's re-reads of the state, 128^2/94^2 =
//       1.85 loads a pixel, which mostly hit L2.
//   K4+K5+K6, the campaign's default (int16 bands with or without device
//       scale, shadow and landcover): reads 16 B (the 48 B of scales and
//       offsets a tile are nothing) and writes 2 B: 18 B/px, 241.1
//       MB/tile. K4 against K3 halves the band bytes, K5 against full
//       outputs cuts 9 B out to 2 B. With 'cover' pass A writes 3 B (the
//       packed planes and the state) and pass B reads 3 B and writes 2 B.
//   K6 spatial: as K1/K2/K3 with full outputs, the reads of a shard's
//       block ((Hl + 34) / Hl of its rows in 'cover' within the tile,
//       949 / 915 at 4 shards of 3660 rows; 1.0 in the other modes).
//
// Design.
//   The per-pixel pass (wtr_pixel_kernel, one template for K1, K3, K4, K5,
//   K6 and pass A of K2) moves 18 to 37 B a pixel and runs some hundred
//   integer operations on it, and the card issues integer operations at
//   half its float rate: the pass is bound by both, bytes first.
//   Bytes: a thread takes 8 consecutive pixels of the flattened B*H*W. Each
//   int16 band is one 16-byte load, each float32 band two, each uint8 plane
//   one 8-byte load, all issued before the first use; the chain runs on the
//   8 pixels in registers (96 to 108 a thread, no spill, two blocks of 256
//   threads a multiprocessor); DIAG leaves as one 16-byte store and every
//   uint8 layer (or PACKED_A/B, or the state byte) as one 8-byte store,
//   neighbouring threads on neighbouring addresses, the bytes gathered with
//   byte permutes (CLOUD, WTR, BWTR and CONF by a 4 x 4 byte transpose of
//   the pixels' table words). The vector body needs every pointer aligned
//   to its vector and, with K4's per-tile scales, H*W a multiple of 8 so
//   that a thread's 8 pixels lie in one tile; the launcher checks both,
//   never assumes them. Otherwise, and for the last n % 8 pixels, the same
//   template runs with one pixel a thread (kVec = 1). The windowed launch
//   (K6 spatial) always takes the one-pixel body: a window's first row is
//   not 8-aligned in general (915 * 3660 = 4 mod 8).
//   Operations: each scalar threshold reaches the kernel as an integer
//   bound (WtrBounds: one compare a test), a ratio test is the sign of
//   q * num - p * den under the sign of den, and the chain's small
//   functions (the interpretation of the five tests, DIAG's pseudo-binary,
//   the aerosol class test, finish_layers) are tables in shared memory that
//   a block fills from those very functions before its first pixel
//   (ChainTables, 1376 B; indexed by data they diverge within a warp, which
//   the constant bank would serialise and shared memory does not). The
//   one-pixel body keeps only the aerosol table and calls the functions: its
//   blocks take 256 pixels, too few to pay for filling the rest.
//   wtr_k2_kernel (pass B) was bound by instruction issue, not bytes: its
//   dilations run on bit-planes. A block of 128 threads owns a tile of
//   94 x 94 output pixels and the 128 x 128 span around it (a 17 px halo,
//   the influence radius 10 + 7, so bits that enter from beyond the span
//   never reach the tile). Warps read the span's state bytes, 32
//   consecutive bytes a load, and __ballot_sync packs four planes of one
//   bit a pixel (snow; areas; areas & water; clear), zeros outside the
//   block's rows and the image's columns (scipy's border), 4 x 2 KB of
//   shared memory. Thread r then holds row r of a plane as 128 bits in
//   registers, and one masked cross step is
//       cur |= M & (up | down | cur << 1 | cur >> 1)
//   with the two neighbouring rows read from a double-buffered 2 KB of
//   shared memory, one __syncthreads() a step: 10 steps of snow over the
//   areas, then 7 of the clear not-snow set over the areas WTR-2 calls
//   water. A span without a snow bit skips all 17. The epilogue walks the
//   tile's pixels a row a warp, lanes on neighbouring addresses, reads the
//   pixel's state byte (an L2 hit) and WTR-2, takes its snow bit from the
//   plane and looks CLOUD, WTR, BWTR, CONF and BROWSE up in the finish
//   table. 13.4 KB of static shared memory a block; 1.85 span cells an
//   output pixel. (tests/test_torch_cover.py holds a numpy model of this
//   tile arithmetic against the plain dilation where no card is at hand.)
//
// Exactness.
//   int16 bands: int32 arithmetic throughout, as in wtr_kernel.py:351-389.
//   NumPy's int16 wrap-around of the band sums is reproduced by wrap16.
//   The rational thresholds p/q (q >= 1) come from ExactThresholds, whose
//   bounds (thresholds.py:89-100) keep every product in int31:
//     ratio tests  |num|, |den| <= 32768, q <= 10,000, |p| <= 30,000
//                  -> |q*num| <= 3.3e8, |p*den| <= 9.9e8, and their
//                  difference d, whose sign decides, |d| <= 1.32e9;
//     AWEsh and the band tests compare with integer bounds that the
//                  wrapper derives on the host (x*q < p is
//                  x <= floor((p-1)/q), x*q > p is x >= floor(p/q) + 1) and
//                  clamps to int32, past every value a band or awesh4
//                  (|.| <= 688,114) can take.
//   A threshold that is no such rational (a user's 1/3) is decided as the
//   reference decides it, in float64 on the integer operands. A band, AWEsh
//   or lcmask test still is one integer compare: i < t is i <= B and i > t is
//   i >= B for the integer B next to the float64 t (core/f32exact.py, on the
//   host; INT32_MIN or INT32_MAX where the test never holds). The ratio
//   tests then run in the kF64Ratio instantiations, which divide:
//   __ddiv_rn((double)num, (double)den) OP t64 is NumPy's float64
//   num / den OP t bit for bit (both conversions are exact, the quotient is
//   correctly rounded, 0/0 -> NaN -> false, x/0 -> +-inf). Those
//   instantiations take every ratio test that way, the exact rationals too:
//   for them the two forms decide alike (core/thresholds.py).
//   float32 bands: the reference evaluates the chain in NumPy float32, one
//   rounding per operation. __fdiv_rn is the correctly rounded IEEE
//   quotient, so __fdiv_rn(num, den) OP t32 is NumPy's float32
//   num/den OP t bit for bit, 0/0 -> NaN -> false and x/0 -> +-inf
//   included. The Pallas kernel decides these tests without dividing
//   (error-free expansions of num - m*den, core/f32exact.py) only because
//   TPU float32 division is not correctly rounded; that machinery is not
//   ported. The intrinsics are explicit so that no FMA contraction (nvcc
//   fuses a*b+c by default) and no --use_fast_math can change a rounding;
//   the build keeps the IEEE defaults (-prec-div=true, no -ftz).

#include <cstdint>
#include <initializer_list>
#include <cuda_runtime.h>

// The ratio tests' thresholds and the aerosol bitmask LUT of the int16 pass,
// passed to the kernel by value: the exact rationals (p, q) or, with
// ratio_f64 (one of the four is no exact rational), the thresholds as
// float64. The layout matches WtrParams in ops/wtr_kernel.py. The float pass
// reads only the LUT.
struct WtrParams {
  double wigt_t, p1_mndwi_t, p1_ndvi_t, p2_mndwi_t;
  int32_t wigt_p, wigt_q;
  int32_t p1_mndwi_p, p1_mndwi_q;
  int32_t p1_ndvi_p, p1_ndvi_q;
  int32_t p2_mndwi_p, p2_mndwi_q;
  int32_t ratio_f64;
  // bit k of aerosol_lut[fmask]: fmask remaps WTR-1 class list k
  // (k = not-water, moderate-conf, psw-conservative, psw-aggressive);
  // masking.build_aerosol_fmask_lut
  uint8_t aerosol_lut[256];
};

// Thresholds of the float pass: np.float32(t) of each HlsThresholds field,
// as NumPy compares them with float32 bands. Mirrors WtrParamsF32 in
// ops/wtr_kernel.py.
struct WtrParamsF32 {
  float wigt, awgt, p1_mndwi, p1_swir1, p1_nir, p1_ndvi, p2_mndwi, p2_blue,
      p2_nir, p2_swir1, p2_swir2, lcmask;
};

// Static flags of a launch. Mirrors WtrFlags in ops/wtr_kernel.py.
struct WtrFlags {
  int32_t with_ocean, with_shadow, with_landcover, compute_browse;
  int32_t mask_adjacent, apply_aerosol, cover;
  int32_t exclude_psw_aggressive, collapse, not_water_nodata, cloud_nodata,
      snow_nodata;
  int32_t minimal;  // K5: PACKED_A/B instead of the full outputs
};

// product class values (proteus_tpu/core/constants.py)
constexpr int kFill = 255;         // UINT8_FILL_VALUE
constexpr int kOcean = 254;        // WTR_OCEAN_MASKED
constexpr int kCloudMasked = 253;  // WTR_CLOUD_MASKED
constexpr int kSnowMasked = 252;   // WTR_SNOW_MASKED
constexpr int kAerosolMaxNir = 1000;  // AEROSOL_REMAPPING_MAX_NIR
constexpr int kDiagFill6 = 32;     // DIAGNOSTIC_LAYER_NO_DATA_DECIMAL
constexpr int kLcWater = 200;      // LAND water
constexpr int kLcEvergreen = 201;  // LAND evergreen forest

// 'cover' state byte, written by the per-pixel pass for wtr_k2_kernel:
// bits 0, 2, 3 hold the CLOUD value before snow (shadow 1, cloud 4,
// aerosol 8; bit 1 is the snow bit, still 0), and three more bits
constexpr int kStCloud = 0x0D;
constexpr int kStSnow = 0x02;    // fmask bit 4 (snow/ice)
constexpr int kStAreas = 0x10;   // fmask bit 2 (adjacent) and CLOUD == 0
constexpr int kStWater = 0x20;   // final WTR-2 in 1..4
constexpr int kStInside = 0x40;  // set by wtr_k2_kernel: inside the image

constexpr int kMaxBatch = 1024;  // K4 stages 48 B a tile in shared memory

constexpr int kVecPx = 8;  // pixels a thread of the vector per-pixel body

constexpr int kSnowSteps = 10, kUnmaskSteps = 7;
constexpr int kHalo = kSnowSteps + kUnmaskSteps;  // 17
constexpr int kSpan = 128;                 // span side: one bit a column
constexpr int kTile = kSpan - 2 * kHalo;   // 94 output pixels a block side

// The scalar tests of the int16 pass as integer bounds, derived on the host
// (ops/wtr_kernel.py::kernel_params) from the threshold's exact rational
// (band * q < p is band <= ceil(p / q) - 1, and x * q > p is
// x >= floor(p / q) + 1) or, where it has none, from the float64 threshold.
// One compare a test. Mirrors WtrBounds in ops/wtr_kernel.py.
struct WtrBounds {
  int32_t p1_swir1_le, p1_nir_le, p2_blue_le, p2_nir_le, p2_swir1_le,
      p2_swir2_le;
  int32_t awesh4_ge;  // awesh4 * q > 4 p
  int32_t lcmask_ge;  // nir * q > p
};

// The five diagnostic tests as the 6-bit decimal's low five bits (bit k:
// test k + 1), and the two NIR tests of the masking stages.
struct Tests {
  int diag5;
  bool nir_ok_aerosol;  // nir <= AEROSOL_REMAPPING_MAX_NIR
  bool nir_bright;      // nir > lcmask_nir
};

__device__ __forceinline__ int wrap16(int x) {
  return ((x + 32768) & 0xFFFF) - 32768;
}

// num/den > p/q and num/den < p/q with float64-division semantics, from
// d = q * num - p * den (|d| < 2^31, see Exactness): the sign of d decides
// for den > 0, its opposite for den < 0, and for den == 0, where num/0 is
// +-inf and 0/0 is NaN and compares false, d = q * num has num's sign
// (q >= 1).
__device__ __forceinline__ bool ratio_gt(int num, int den, int p, int q) {
  const int d = q * num - p * den;
  return den >= 0 ? d > 0 : d < 0;
}

__device__ __forceinline__ bool ratio_lt(int num, int den, int p, int q) {
  const int d = q * num - p * den;
  return den >= 0 ? d < 0 : d > 0;
}

__device__ __forceinline__ int diag5_of(bool t1, bool t2, bool t3, bool t4,
                                        bool t5) {
  return (int)t1 | (int)t2 << 1 | (int)t3 << 2 | (int)t4 << 3 | (int)t5 << 4;
}

// int16 bands: exact int32 rationals or, with kF64Ratio, the float64
// quotients (K1)
template <bool kF64Ratio>
__device__ __forceinline__ Tests diag_tests(
    int16_t b16, int16_t g16, int16_t r16, int16_t n16, int16_t s1_16,
    int16_t s2_16, const WtrParams& P, const WtrBounds& B,
    const WtrParamsF32&) {
  const int b = b16, g = g16, r = r16, nr = n16, s1 = s1_16, s2 = s2_16;
  const int mndwi_num = wrap16(g - s1), mndwi_den = wrap16(g + s1);
  const int mbsrv = wrap16(g + r), mbsrn = wrap16(nr + s1);
  const int ndvi_num = wrap16(nr - r), ndvi_den = wrap16(nr + r);
  const int awesh4 = 4 * b + 10 * g - 6 * mbsrn - s2;
  const bool t2 = mbsrv > mbsrn;
  const bool t3 = awesh4 >= B.awesh4_ge;
  bool t1, t4, t5;
  if constexpr (kF64Ratio) {
    const double mndwi = __ddiv_rn((double)mndwi_num, (double)mndwi_den);
    const double ndvi = __ddiv_rn((double)ndvi_num, (double)ndvi_den);
    t1 = mndwi > P.wigt_t;
    t4 = mndwi > P.p1_mndwi_t && s1 <= B.p1_swir1_le && nr <= B.p1_nir_le
        && ndvi < P.p1_ndvi_t;
    t5 = mndwi > P.p2_mndwi_t && b <= B.p2_blue_le && s1 <= B.p2_swir1_le
        && s2 <= B.p2_swir2_le && nr <= B.p2_nir_le;
  } else {
    t1 = ratio_gt(mndwi_num, mndwi_den, P.wigt_p, P.wigt_q);
    t4 = ratio_gt(mndwi_num, mndwi_den, P.p1_mndwi_p, P.p1_mndwi_q)
        && s1 <= B.p1_swir1_le && nr <= B.p1_nir_le
        && ratio_lt(ndvi_num, ndvi_den, P.p1_ndvi_p, P.p1_ndvi_q);
    t5 = ratio_gt(mndwi_num, mndwi_den, P.p2_mndwi_p, P.p2_mndwi_q)
        && b <= B.p2_blue_le && s1 <= B.p2_swir1_le && s2 <= B.p2_swir2_le
        && nr <= B.p2_nir_le;
  }
  Tests t;
  t.diag5 = diag5_of(t1, t2, t3, t4, t5);
  t.nir_ok_aerosol = nr <= kAerosolMaxNir;
  t.nir_bright = nr >= B.lcmask_ge;
  return t;
}

// float32 bands: NumPy's float32 evaluation, one rounding per operation
// in its order (K3; kF64Ratio is the int16 pass's)
template <bool kF64Ratio>
__device__ __forceinline__ Tests diag_tests(
    float b, float g, float r, float nr, float s1, float s2,
    const WtrParams&, const WtrBounds&, const WtrParamsF32& Q) {
  const float mndwi = __fdiv_rn(__fsub_rn(g, s1), __fadd_rn(g, s1));
  const float ndvi = __fdiv_rn(__fsub_rn(nr, r), __fadd_rn(nr, r));
  const float mbsrv = __fadd_rn(g, r), mbsrn = __fadd_rn(nr, s1);
  // ((blue + 2.5*green) - 1.5*mbsrn) - 0.25*swir2
  const float awesh = __fsub_rn(
      __fsub_rn(__fadd_rn(b, __fmul_rn(2.5f, g)), __fmul_rn(1.5f, mbsrn)),
      __fmul_rn(0.25f, s2));
  const bool t4 = mndwi > Q.p1_mndwi && s1 < Q.p1_swir1 && nr < Q.p1_nir
      && ndvi < Q.p1_ndvi;
  const bool t5 = mndwi > Q.p2_mndwi && b < Q.p2_blue && s1 < Q.p2_swir1
      && s2 < Q.p2_swir2 && nr < Q.p2_nir;
  Tests t;
  t.diag5 = diag5_of(mndwi > Q.wigt, mbsrv > mbsrn, awesh > Q.awgt, t4, t5);
  t.nir_ok_aerosol = nr <= (float)kAerosolMaxNir;
  t.nir_bright = nr > Q.lcmask;
  return t;
}

// K4: the reference's cast of a raw int16 band, one rounding a step
__device__ __forceinline__ float scale_band(int16_t x, float scale,
                                            float offset) {
  return __fmul_rn(scale, __fsub_rn(__int2float_rn(x), offset));
}

// K5: the 3-bit class index of a WTR-1 / WTR-2 value (0..4, ocean 254 -> 5,
// fill 255 -> 6)
__device__ __forceinline__ int widx(int w) {
  return w < 5 ? w : w - 249;
}

// WTR-1 of the five tests: closed-form popcount interpretation
// (wtr_kernel.py:54-66)
__device__ __forceinline__ int interpret_diag5(int d) {
  const bool t4 = d & 8, t5 = d & 16;
  const int pc = __popc(d & 31);
  int wtr1 = pc >= 4 ? 1 : pc == 3 ? 2 : pc == 2 ? 4 : 0;
  if (t4 && t5 && pc == 2) wtr1 = 3;
  if (t5 && pc == 1) wtr1 = 4;
  return wtr1;
}

// DIAG's pseudo-binary of the five tests
__device__ __forceinline__ int pseudo_binary(int d) {
  return (d & 1) + 10 * ((d >> 1) & 1) + 100 * ((d >> 2) & 1)
      + 1000 * ((d >> 3) & 1) + 10000 * ((d >> 4) & 1);
}

// CLOUD (with its snow bit) + WTR-2 -> CLOUD, WTR, BWTR, CONF, BROWSE
struct Finished {
  int cloud, wtr, bwtr, conf, browse;
};

__device__ __forceinline__ Finished finish_layers(int cloud, int wtr2,
                                                  const WtrFlags& F) {
  Finished o;
  if (wtr2 == kFill) cloud = 255;
  o.cloud = cloud;

  // WTR
  const bool cloudy = cloud != 0 && cloud != 8;
  const bool snowy = cloud == 2 || cloud == 10;
  int wtr = cloudy ? kCloudMasked : wtr2;
  if (snowy) wtr = kSnowMasked;
  if (wtr2 == kOcean) wtr = kOcean;
  if (wtr2 == kFill) wtr = kFill;
  o.wtr = wtr;

  // BWTR
  o.bwtr = (wtr >= 1 && wtr <= 4) ? 1 : wtr;

  // CONF: +10 under cloud, +20 under snow, clear classes only
  int conf = wtr2;
  const bool clear_class = wtr2 <= 4;
  if (cloudy && !snowy && clear_class) conf += 10;
  if (cloud == 2 && clear_class) conf += 20;
  o.conf = conf;

  // BROWSE
  int br = wtr;
  if (F.compute_browse) {
    if (F.exclude_psw_aggressive && br == 4) br = 0;
    if (F.collapse) br = (br == 1 || br == 2) ? 1 : (br == 3 || br == 4) ? 2 : br;
    if (F.not_water_nodata && br == 0) br = kFill;
    if (F.cloud_nodata && br == kCloudMasked) br = kFill;
    if (F.snow_nodata && br == kSnowMasked) br = kFill;
    if (br == kOcean) br = kFill;
  }
  o.browse = br;
  return o;
}

// The chain's small functions as tables in shared memory, filled once a
// block from the functions above, so that a pixel pays one load for each
// instead of their two dozen compares and selects: with vector loads and
// stores the per-pixel pass is bound by instruction issue. The vector body
// reads all four (a block's fill is spread over its 2048 pixels); the
// one-pixel body, whose blocks take 256 pixels, fills and reads only the
// aerosol table and calls the functions (kTables of pixel_chain).
struct ChainTables {
  // finish_layers of (CLOUD's four bits, widx(WTR-2)) at 16 * widx + cloud:
  // x = CLOUD | WTR << 8 | BWTR << 16 | CONF << 24, y = BROWSE
  uint2 fin[128];
  uint16_t diag[32];    // pseudo_binary of the five tests
  uint8_t wtr1[32];     // interpret_diag5 of the five tests
  // the aerosol LUT of the fmask byte, bit k moved to bit (0, 2, 3, 4)[k],
  // the WTR-1 class it remaps: hit = (aerosol[fmask] >> (wtr1 & 7)) & 1
  // (classes 1, 254 & 7 = 6 and 255 & 7 = 7 find a zero bit)
  uint8_t aerosol[256];
};

// finish_layers as ChainTables::fin's two words
__device__ __forceinline__ uint2 finish_words(int cloud, int wtr2,
                                              const WtrFlags& F) {
  const Finished f = finish_layers(cloud, wtr2, F);
  return make_uint2((uint32_t)f.cloud | (uint32_t)f.wtr << 8
                        | (uint32_t)f.bwtr << 16 | (uint32_t)f.conf << 24,
                    (uint32_t)f.browse);
}

__device__ __forceinline__ void fill_finish_table(uint2* fin,
                                                  const WtrFlags& F) {
  for (int k = threadIdx.x; k < 128; k += blockDim.x) {
    const int w = k >> 4;
    fin[k] = finish_words(k & 15, w < 5 ? w : w == 5 ? kOcean : kFill, F);
  }
}

template <bool kTables>
__device__ __forceinline__ void fill_chain_tables(ChainTables& T,
                                                  const WtrParams& P,
                                                  const WtrFlags& F) {
  for (int k = threadIdx.x; k < 256; k += blockDim.x) {
    const int bits = P.aerosol_lut[k];
    T.aerosol[k] = (uint8_t)((bits & 1) | (bits & 14) << 1);
  }
  if constexpr (!kTables) return;
  fill_finish_table(T.fin, F);
  for (int k = threadIdx.x; k < 32; k += blockDim.x) {
    T.diag[k] = (uint16_t)pseudo_binary(k);
    T.wtr1[k] = (uint8_t)interpret_diag5(k);
  }
}

// One pixel's outputs of the per-pixel pass, in registers. Which of them a
// launch stores follows its flags (full outputs, K5's packed planes, the
// 'cover' state). fin and browse are ChainTables::fin's words.
struct Pixel {
  int diag, wtr1, wtr2, pa, pb, state;
  uint32_t fin, browse;
};

// The chain of one pixel from its five tests to its outputs
template <bool kTables>
__device__ __forceinline__ Pixel pixel_chain(
    const Tests& t, int fm, bool inv, int ocean, int shadow, int lc,
    const ChainTables& T, const WtrFlags& F) {
  Pixel px = {};

  int wtr1 = kTables ? T.wtr1[t.diag5] : interpret_diag5(t.diag5);
  if (F.with_ocean && ocean == 0) wtr1 = kOcean;
  if (inv) wtr1 = kFill;
  px.wtr1 = wtr1;

  // DIAG: the 6-bit decimal for K5, else the pseudo-binary (fill ->
  // 65535)
  const int diag6 = inv ? kDiagFill6 : t.diag5;
  px.diag = inv ? 65535
      : kTables ? T.diag[t.diag5] : pseudo_binary(t.diag5);

  // preliminary CLOUD: shadow (and adjacent, in 'mask' mode) -> 1,
  // cloud -> +4
  const bool shadow_bit = (fm & 8) || (F.mask_adjacent && (fm & 4));
  int cloud = (shadow_bit ? 1 : 0) + ((fm & 2) ? 4 : 0);

  // aerosol remapping of classes 0, 2, 3, 4 to high-confidence water
  int wtr1a = wtr1;
  if (F.apply_aerosol && t.nir_ok_aerosol
      && ((T.aerosol[fm] >> (wtr1 & 7)) & 1)) {
    wtr1a = 1;
    cloud |= 8;
  }

  // landcover + shadow -> WTR-2 (the tests read the remapped WTR-1)
  int wtr2 = wtr1a;
  const bool water = wtr1a >= 1 && wtr1a <= 4;
  if (F.with_shadow) {
    bool shadowed = shadow == 0 && water;  // SHAD_MASKED == 0
    if (F.with_landcover) shadowed = shadowed && lc != kLcWater;
    if (shadowed) wtr2 = 0;
  }
  if (F.with_landcover) {
    const bool psw = wtr1a == 3 || wtr1a == 4;
    const bool demote = (lc == kLcEvergreen && t.nir_bright && psw)
        || (lc < 100 && t.nir_bright && psw)    // low-intensity developed
        || (lc >= 100 && lc < 200 && water);    // high-intensity developed
    if (demote) wtr2 = 0;
  }
  px.wtr2 = wtr2;
  const int w2 = widx(wtr2);
  const int wtr_idx = widx(wtr1) << 2 | w2 << 5;

  if (F.cover) {
    // the snow dilations need the neighbours: wtr_k2_kernel finishes
    const bool water2 = wtr2 >= 1 && wtr2 <= 4;  // on the final WTR-2
    px.state = cloud | ((fm & 16) ? kStSnow : 0)
        | (((fm & 4) && cloud == 0) ? kStAreas : 0)
        | (water2 ? kStWater : 0);
    px.pa = diag6;
    px.pb = wtr_idx;
    return px;
  }
  if (fm & 16) cloud += 2;
  if (F.minimal) {
    // CLOUD's fill (255) is WTR-2's: only its four payload bits ship
    const int cloudp = wtr2 == kFill ? 0 : cloud;
    px.pa = diag6 | (cloudp & 3) << 6;
    px.pb = ((cloudp >> 2) & 3) | wtr_idx;
    return px;
  }
  const uint2 f = kTables ? T.fin[cloud | w2 << 4]
                          : finish_words(cloud, wtr2, F);
  px.fin = f.x;
  px.browse = f.y;
  return px;
}

// kVec consecutive pixels of a plane from pixel i: one vector load (kVec ==
// 8; i a multiple of 8 and the plane aligned to the vector, which the
// launcher checks) or one element (kVec == 1).
template <int kVec>
__device__ __forceinline__ void load_px(const int16_t* __restrict__ p,
                                        int64_t i, int16_t (&v)[kVec]) {
  if constexpr (kVec == kVecPx) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p + i));
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[2 * j] = (int16_t)(w[j] & 0xFFFFu);
      v[2 * j + 1] = (int16_t)(w[j] >> 16);
    }
  } else {
    v[0] = p[i];
  }
}

template <int kVec>
__device__ __forceinline__ void load_px(const float* __restrict__ p,
                                        int64_t i, float (&v)[kVec]) {
  if constexpr (kVec == kVecPx) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p + i));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p + i + 4));
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
    v[0] = p[i];
  }
}

template <int kVec>
__device__ __forceinline__ void load_px(const uint8_t* __restrict__ p,
                                        int64_t i, int (&v)[kVec]) {
  if constexpr (kVec == kVecPx) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p + i));
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = (int)((q.x >> (8 * j)) & 0xFFu);
      v[4 + j] = (int)((q.y >> (8 * j)) & 0xFFu);
    }
  } else {
    v[0] = p[i];
  }
}

// The low bytes of four words as one word, a's lowest (three byte
// permutes; every value here is below 256)
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// One field of kVec pixels to a uint8 plane (every value is below 256) or
// to DIAG's uint16 plane (below 65536): one vector store or one element.
template <int kVec, typename Field>
__device__ __forceinline__ void store_u8(uint8_t* __restrict__ p, int64_t i,
                                         const Pixel (&px)[kVec],
                                         Field Pixel::*field) {
  if constexpr (kVec == kVecPx) {
    uint2 o;
    o.x = pack4(px[0].*field, px[1].*field, px[2].*field, px[3].*field);
    o.y = pack4(px[4].*field, px[5].*field, px[6].*field, px[7].*field);
    *reinterpret_cast<uint2*>(p + i) = o;
  } else {
    p[i] = (uint8_t)(px[0].*field);
  }
}

template <int kVec>
__device__ __forceinline__ void store_diag(uint16_t* __restrict__ p,
                                           int64_t i,
                                           const Pixel (&px)[kVec]) {
  if constexpr (kVec == kVecPx) {
    uint4 o;
    o.x = __byte_perm(px[0].diag, px[1].diag, 0x5410);
    o.y = __byte_perm(px[2].diag, px[3].diag, 0x5410);
    o.z = __byte_perm(px[4].diag, px[5].diag, 0x5410);
    o.w = __byte_perm(px[6].diag, px[7].diag, 0x5410);
    *reinterpret_cast<uint4*>(p + i) = o;
  } else {
    p[i] = (uint16_t)px[0].diag;
  }
}

// CLOUD, WTR, BWTR and CONF of kVec pixels from their Pixel::fin words
// (byte k of a word is layer k): a 4 x 4 byte transpose a half of the
// group, eight permutes for sixteen bytes.
template <int kVec>
__device__ __forceinline__ void store_fin(
    uint8_t* __restrict__ cloud_o, uint8_t* __restrict__ wtr_o,
    uint8_t* __restrict__ bwtr_o, uint8_t* __restrict__ conf_o, int64_t i,
    const Pixel (&px)[kVec]) {
  if constexpr (kVec == kVecPx) {
    uint32_t layer[4][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t a = px[4 * h].fin, b = px[4 * h + 1].fin,
                     c = px[4 * h + 2].fin, d = px[4 * h + 3].fin;
      const uint32_t ab01 = __byte_perm(a, b, 0x5140);  // a0 b0 a1 b1
      const uint32_t cd01 = __byte_perm(c, d, 0x5140);
      const uint32_t ab23 = __byte_perm(a, b, 0x7362);  // a2 b2 a3 b3
      const uint32_t cd23 = __byte_perm(c, d, 0x7362);
      layer[0][h] = __byte_perm(ab01, cd01, 0x5410);
      layer[1][h] = __byte_perm(ab01, cd01, 0x7632);
      layer[2][h] = __byte_perm(ab23, cd23, 0x5410);
      layer[3][h] = __byte_perm(ab23, cd23, 0x7632);
    }
    *reinterpret_cast<uint2*>(cloud_o + i) = make_uint2(layer[0][0],
                                                        layer[0][1]);
    *reinterpret_cast<uint2*>(wtr_o + i) = make_uint2(layer[1][0],
                                                      layer[1][1]);
    *reinterpret_cast<uint2*>(bwtr_o + i) = make_uint2(layer[2][0],
                                                       layer[2][1]);
    *reinterpret_cast<uint2*>(conf_o + i) = make_uint2(layer[3][0],
                                                       layer[3][1]);
  } else {
    const uint32_t f = px[0].fin;
    cloud_o[i] = (uint8_t)f;
    wtr_o[i] = (uint8_t)(f >> 8);
    bwtr_o[i] = (uint8_t)(f >> 16);
    conf_o[i] = (uint8_t)(f >> 24);
  }
}

// K1 (Band = int16_t) and K3 (Band = float); K4 (Band = int16_t, kScaled:
// raw bands cast per tile before K3's body); with F.cover, pass A of K2;
// with F.minimal, K5's packed outputs. Each input plane (and the state) is
// a [B, H, W] stack (K6), hw = H * W; the outputs are the [B, rows_out, W]
// window from row row0 (kWindowed; else the whole stack, rows_out == H).
// A thread takes kVec consecutive pixels: `groups` groups of kVec from
// pixel `first` of the flattened stack (kVec == 8: first == 0, every plane
// aligned to its vector and, with kScaled, hw a multiple of 8). kF64Ratio
// (int16 bands only): the ratio tests as float64 quotients.
template <typename Band, bool kScaled, bool kWindowed, int kVec,
          bool kF64Ratio>
__global__ void __launch_bounds__(256, kVec == kVecPx ? 2 : 1)
wtr_pixel_kernel(
    const Band* __restrict__ blue, const Band* __restrict__ green,
    const Band* __restrict__ red, const Band* __restrict__ nir,
    const Band* __restrict__ swir1, const Band* __restrict__ swir2,
    const float* __restrict__ scales, const float* __restrict__ offsets,
    const uint8_t* __restrict__ fmask, const uint8_t* __restrict__ invalid,
    const uint8_t* __restrict__ ocean, const uint8_t* __restrict__ shadow,
    const uint8_t* __restrict__ landcover,
    uint16_t* __restrict__ diag_o, uint8_t* __restrict__ wtr1_o,
    uint8_t* __restrict__ wtr2_o, uint8_t* __restrict__ wtr_o,
    uint8_t* __restrict__ bwtr_o, uint8_t* __restrict__ conf_o,
    uint8_t* __restrict__ cloud_o, uint8_t* __restrict__ browse_o,
    uint8_t* __restrict__ pa_o, uint8_t* __restrict__ pb_o,
    uint8_t* __restrict__ state_o, int64_t first, int64_t groups,
    int64_t hw, int width, int row0, int rows_out, int batch, WtrParams P,
    WtrBounds Bd, WtrParamsF32 Q, WtrFlags F) {
  static_assert(kVec == 1 || (kVec == kVecPx && !kWindowed),
                "the windowed launch takes the one-pixel body");
  // K4: the batch's scales (sv[6 t + j]) and offsets (sv[6 B + 6 t + j])
  extern __shared__ float sv[];
  constexpr bool kTables = kVec == kVecPx;
  __shared__ ChainTables T;
  fill_chain_tables<kTables>(T, P, F);
  if (kScaled) {
    for (int k = threadIdx.x; k < 6 * batch; k += blockDim.x) {
      sv[k] = scales[k];
      sv[6 * batch + k] = offsets[k];
    }
  }
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       g < groups; g += stride) {
    const int64_t i = first + g * kVec;
    // o: the group's index in the output window, -1 outside it
    int64_t o = i;
    if constexpr (kWindowed) {
      const int64_t tile = i / hw, p = i - tile * hw;
      const int y = (int)(p / width);
      o = (y >= row0 && y < row0 + rows_out)
          ? tile * rows_out * (int64_t)width + p - (int64_t)row0 * width
          : -1;
      if (o < 0 && !F.cover) continue;
    }
    // every load of the group before the first use
    Band b[kVec], gr[kVec], r[kVec], nr[kVec], s1[kVec], s2[kVec];
    load_px<kVec>(blue, i, b);
    load_px<kVec>(green, i, gr);
    load_px<kVec>(red, i, r);
    load_px<kVec>(nir, i, nr);
    load_px<kVec>(swir1, i, s1);
    load_px<kVec>(swir2, i, s2);
    int fm[kVec], inv[kVec], oc[kVec] = {}, sh[kVec] = {}, lc[kVec] = {};
    load_px<kVec>(fmask, i, fm);
    load_px<kVec>(invalid, i, inv);
    if (F.with_ocean) load_px<kVec>(ocean, i, oc);
    if (F.with_shadow) load_px<kVec>(shadow, i, sh);
    if (F.with_landcover) load_px<kVec>(landcover, i, lc);

    Pixel px[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      Tests t;
      if constexpr (kScaled) {
        // the group lies in one tile (hw is a multiple of kVec)
        const float* sc = sv + 6 * (i / hw);
        const float* of = sc + 6 * batch;
        t = diag_tests<false>(scale_band(b[j], sc[0], of[0]),
                              scale_band(gr[j], sc[1], of[1]),
                              scale_band(r[j], sc[2], of[2]),
                              scale_band(nr[j], sc[3], of[3]),
                              scale_band(s1[j], sc[4], of[4]),
                              scale_band(s2[j], sc[5], of[5]), P, Bd, Q);
      } else {
        t = diag_tests<kF64Ratio>(b[j], gr[j], r[j], nr[j], s1[j], s2[j], P,
                                  Bd, Q);
      }
      px[j] = pixel_chain<kTables>(t, fm[j], inv[j] != 0, oc[j], sh[j],
                                   lc[j], T, F);
    }

    if (F.cover) store_u8<kVec>(state_o, i, px, &Pixel::state);
    if (o < 0) continue;  // (a windowed 'cover' launch: outside the window)
    if (F.minimal) {
      store_u8<kVec>(pa_o, o, px, &Pixel::pa);
      store_u8<kVec>(pb_o, o, px, &Pixel::pb);
      continue;
    }
    store_diag<kVec>(diag_o, o, px);
    store_u8<kVec>(wtr1_o, o, px, &Pixel::wtr1);
    store_u8<kVec>(wtr2_o, o, px, &Pixel::wtr2);
    if (F.cover) continue;  // wtr_k2_kernel writes the other layers
    store_fin<kVec>(cloud_o, wtr_o, bwtr_o, conf_o, o, px);
    if (F.compute_browse) store_u8<kVec>(browse_o, o, px, &Pixel::browse);
  }
}

// A span row of a bit-plane: bit c of (hi:lo) is span column c.
struct Row128 {
  uint64_t lo, hi;
};

__device__ __forceinline__ Row128 row_from(const uint4& w) {
  return {(uint64_t)w.x | (uint64_t)w.y << 32,
          (uint64_t)w.z | (uint64_t)w.w << 32};
}

__device__ __forceinline__ uint4 row_words(const Row128& r) {
  return make_uint4((uint32_t)r.lo, (uint32_t)(r.lo >> 32), (uint32_t)r.hi,
                    (uint32_t)(r.hi >> 32));
}

// K2 pass B: the 'cover' snow dilations (masking.py:178-204) on a
// 94 x 94 tile of image blockIdx.z of the stack (K6), then CLOUD, WTR,
// BWTR, CONF and BROWSE of the tile, or with F.minimal CLOUD's four bits
// ORed into PACKED_A/B (K5). The state is the [B, height, width] block;
// WTR-2 and the layers are the [B, rows_out, width] window from block row
// row0, whose rows the grid covers (K6 spatial). One thread a span row.
__global__ void __launch_bounds__(kSpan) wtr_k2_kernel(
    const uint8_t* __restrict__ state, const uint8_t* __restrict__ wtr2_in,
    uint8_t* __restrict__ cloud_o, uint8_t* __restrict__ wtr_o,
    uint8_t* __restrict__ bwtr_o, uint8_t* __restrict__ conf_o,
    uint8_t* __restrict__ browse_o, uint8_t* __restrict__ pa,
    uint8_t* __restrict__ pb, int height, int width, int row0,
    int rows_out, WtrFlags F) {
  // the four bit-planes of the span: snow, areas, areas & water, clear
  __shared__ uint4 planes[4][kSpan];
  // the dilating set, double-buffered, between two rows of zeros (the
  // neighbours beyond the span count as 0)
  __shared__ uint4 rows[2][kSpan + 2];
  __shared__ uint2 fin[128];  // ChainTables::fin, for the epilogue
  if (!F.minimal) fill_finish_table(fin, F);
  state += (int64_t)blockIdx.z * height * width;
  const int64_t plane = (int64_t)blockIdx.z * rows_out * width;
  if (F.minimal) {
    pa += plane;
    pb += plane;
  } else {
    wtr2_in += plane;
    cloud_o += plane;
    wtr_o += plane;
    bwtr_o += plane;
    conf_o += plane;
    if (F.compute_browse) browse_o += plane;
  }
  const int y0 = row0 + blockIdx.y * kTile - kHalo;
  const int x0 = blockIdx.x * kTile - kHalo;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int kWarps = kSpan / 32;
  constexpr unsigned kAll = 0xFFFFFFFFu;

  // pack the planes: a warp a span row, a lane a column of each 32-column
  // word; zeros outside the block's rows and the image's columns
  if (threadIdx.x < 4) {
    const uint4 zero = make_uint4(0, 0, 0, 0);
    rows[threadIdx.x & 1][(threadIdx.x >> 1) * (kSpan + 1)] = zero;
  }
  for (int r = warp; r < kSpan; r += kWarps) {
    const int y = y0 + r;
    const bool row_in = y >= 0 && y < height;
    uint32_t snow[4], areas[4], aw[4], clear[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int x = x0 + 32 * k + lane;
      const int s = (row_in && x >= 0 && x < width)
          ? state[(int64_t)y * width + x] | kStInside : 0;
      snow[k] = __ballot_sync(kAll, (s & kStSnow) != 0);
      areas[k] = __ballot_sync(kAll, (s & kStAreas) != 0);
      aw[k] = __ballot_sync(
          kAll, (s & (kStAreas | kStWater)) == (kStAreas | kStWater));
      clear[k] = __ballot_sync(
          kAll, (s & (kStCloud | kStInside)) == kStInside);
    }
    if (lane == 0) {
      planes[0][r] = make_uint4(snow[0], snow[1], snow[2], snow[3]);
      planes[1][r] = make_uint4(areas[0], areas[1], areas[2], areas[3]);
      planes[2][r] = make_uint4(aw[0], aw[1], aw[2], aw[3]);
      planes[3][r] = make_uint4(clear[0], clear[1], clear[2], clear[3]);
    }
  }
  __syncthreads();

  const int r = threadIdx.x;
  Row128 snow = row_from(planes[0][r]);
  int buf = 0;
  // one masked cross step a __syncthreads(): a set pixel stays, a pixel of
  // the mask turns on when one of its four neighbours is on
  auto dilate = [&](Row128& cur, const Row128& mask, int steps) {
    for (int k = 0; k < steps; ++k) {
      rows[buf][r + 1] = row_words(cur);
      __syncthreads();
      const Row128 up = row_from(rows[buf][r]);
      const Row128 down = row_from(rows[buf][r + 2]);
      const uint64_t near_lo = up.lo | down.lo | cur.lo << 1
          | (cur.lo >> 1 | cur.hi << 63);
      const uint64_t near_hi = up.hi | down.hi
          | (cur.hi << 1 | cur.lo >> 63) | cur.hi >> 1;
      cur.lo |= mask.lo & near_lo;
      cur.hi |= mask.hi & near_hi;
      buf ^= 1;
    }
  };
  Row128 snowed = {0, 0};
  // a span without snow has nothing to grow (the same for every thread)
  if (__syncthreads_or((snow.lo | snow.hi) != 0)) {
    // snow grows 10 steps into the clear adjacent areas
    dilate(snow, row_from(planes[1][r]), kSnowSteps);
    // the clear not-snow set grows 7 steps over the adjacent areas that
    // WTR-2 calls water, and takes back the snow it reaches
    const Row128 clear = row_from(planes[3][r]);
    Row128 unmask = {~snow.lo & clear.lo, ~snow.hi & clear.hi};
    dilate(unmask, row_from(planes[2][r]), kUnmaskSteps);
    snowed = {snow.lo & ~unmask.lo, snow.hi & ~unmask.hi};
  }
  // (the last step read rows[buf ^ 1]: rows[buf] is free)
  rows[buf][r + 1] = row_words(snowed);
  __syncthreads();

  // the tile's own pixels: a warp a row, lanes on neighbouring addresses
  const uint32_t* snow_bits = reinterpret_cast<const uint32_t*>(rows[buf]);
  for (int tr = warp; tr < kTile; tr += kWarps) {
    const int y = y0 + kHalo + tr;
    if (y >= row0 + rows_out) break;
    for (int tc = lane; tc < kTile; tc += 32) {
      const int x = x0 + kHalo + tc;
      if (x >= width) break;
      const int c = tc + kHalo;
      const bool snow_on =
          (snow_bits[4 * (tr + kHalo + 1) + (c >> 5)] >> (c & 31)) & 1u;
      const int cloud = (state[(int64_t)y * width + x] & kStCloud)
          + (snow_on ? 2 : 0);
      const int64_t i = (int64_t)(y - row0) * width + x;
      if (F.minimal) {
        const uint8_t b = pb[i];
        const int cloudp = ((b >> 5) & 7) == 6 ? 0 : cloud;  // WTR-2 fill
        pa[i] |= (uint8_t)((cloudp & 3) << 6);
        pb[i] = (uint8_t)(b | ((cloudp >> 2) & 3));
        continue;
      }
      const uint2 f = fin[cloud | widx(wtr2_in[i]) << 4];
      cloud_o[i] = (uint8_t)f.x;
      wtr_o[i] = (uint8_t)(f.x >> 8);
      bwtr_o[i] = (uint8_t)(f.x >> 16);
      conf_o[i] = (uint8_t)(f.x >> 24);
      if (F.compute_browse) browse_o[i] = (uint8_t)f.y;
    }
  }
}

// A launch runs on the calling thread's current device, and stream 0 is
// that device's: refuse data that another device holds (the wrapper makes
// the tensors' device current) rather than launch against foreign pointers.
static int check_device(const void* p) {
  cudaPointerAttributes attr;
  cudaError_t e = cudaPointerGetAttributes(&attr, p);
  if (e != cudaSuccess) return (int)e;
  int current = -1;
  e = cudaGetDevice(&current);
  if (e != cudaSuccess) return (int)e;
  return attr.device == current ? 0 : (int)cudaErrorInvalidDevice;
}

// Launch on `stream` (PyTorch's current stream of the current device);
// does not synchronise. Each returns cudaGetLastError() after its launch:
// nonzero means the launch was refused or an earlier asynchronous error is
// pending.
// band_kind: 0 int16 (K1), 1 float32 (K3), 2 raw int16 with the [batch, 6]
// float32 scales and offsets (K4). Every input plane and the state are a
// [batch, height, width] stack; the outputs are [batch, rows_out, width],
// the window of rows [row0, row0 + rows_out).
static bool bad_window(int batch, int height, int width, int row0,
                       int rows_out) {
  return batch < 1 || height < 1 || width < 1 || row0 < 0 || rows_out < 1
      || row0 + rows_out > height;
}

static bool aligned(const void* p, int bytes) {
  return ((uintptr_t)p % (uintptr_t)bytes) == 0;  // (a null plane passes)
}

// `bounds` are read for int16 bands (band_kind 0) only. `vectorized`, if
// not null, is set to 1 when the 8-pixel body ran (on all but the last
// n % 8 pixels), to 0 when the one-pixel body took everything.
extern "C" int wtr_pixel_launch(
    int band_kind, const void* blue, const void* green, const void* red,
    const void* nir, const void* swir1, const void* swir2,
    const void* scales, const void* offsets, const void* fmask,
    const void* invalid, const void* ocean, const void* shadow,
    const void* landcover, void* diag, void* wtr1, void* wtr2, void* wtr,
    void* bwtr, void* conf, void* cloud, void* browse, void* packed_a,
    void* packed_b, void* state, int batch, int height, int width, int row0,
    int rows_out, const WtrParams* params, const WtrBounds* bounds_in,
    const WtrParamsF32* params_f32, const WtrFlags* flags, int* vectorized,
    void* stream) {
  if (batch > kMaxBatch || bad_window(batch, height, width, row0, rows_out))
    return (int)cudaErrorInvalidValue;
  if (const int err = check_device(blue)) return err;
  const WtrParams& P = *params;
  const bool f64_ratio = band_kind == 0 && P.ratio_f64 != 0;
  if (band_kind == 0 && !f64_ratio) {
    // ratio_gt and ratio_lt read q >= 1
    for (const int32_t q : {P.wigt_q, P.p1_mndwi_q, P.p1_ndvi_q,
                            P.p2_mndwi_q})
      if (q < 1) return (int)cudaErrorInvalidValue;
  }
  const WtrBounds bounds = band_kind == 0 ? *bounds_in : WtrBounds{};
  const int64_t hw = (int64_t)height * width;
  const int64_t n = batch * hw;
  const int threads = 256;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool windowed = rows_out != height;
  // the 8-pixel body: the whole stack (no window), every plane aligned to
  // its vector (8 pixels: 16 B of int16, float32 or DIAG, 8 B of uint8)
  // and, with per-tile scales, a group of 8 inside one tile
  bool vec = !windowed && (band_kind != 2 || hw % kVecPx == 0);
  for (const void* p : {blue, green, red, nir, swir1, swir2,
                        (const void*)diag})
    vec = vec && aligned(p, 16);
  for (const void* p : {fmask, invalid, ocean, shadow, landcover,
                        (const void*)wtr1, (const void*)wtr2,
                        (const void*)wtr, (const void*)bwtr,
                        (const void*)conf, (const void*)cloud,
                        (const void*)browse, (const void*)packed_a,
                        (const void*)packed_b, (const void*)state})
    vec = vec && aligned(p, 8);
  const int64_t n_vec = vec ? n / kVecPx : 0;
  if (vectorized) *vectorized = n_vec > 0;
  // K4 stages 48 B a tile beside the chain's tables
  const size_t smem = band_kind == 2 ? 12 * sizeof(float) * (size_t)batch
                                     : 0;
#define WTR_PIXEL_ARGS(T)                                                   \
  (const T*)blue, (const T*)green, (const T*)red, (const T*)nir,            \
      (const T*)swir1, (const T*)swir2, (const float*)scales,               \
      (const float*)offsets, (const uint8_t*)fmask,                         \
      (const uint8_t*)invalid, (const uint8_t*)ocean,                       \
      (const uint8_t*)shadow, (const uint8_t*)landcover, (uint16_t*)diag,   \
      (uint8_t*)wtr1, (uint8_t*)wtr2, (uint8_t*)wtr, (uint8_t*)bwtr,        \
      (uint8_t*)conf, (uint8_t*)cloud, (uint8_t*)browse,                    \
      (uint8_t*)packed_a, (uint8_t*)packed_b, (uint8_t*)state, first,       \
      groups, hw, width, row0, rows_out, batch, P, bounds, *params_f32,     \
      *flags
#define WTR_PIXEL_LAUNCH(T, SCALED, WINDOWED, VEC, F64)                      \
  do {                                                                      \
    auto kernel = wtr_pixel_kernel<T, SCALED, WINDOWED, VEC, F64>;          \
    if (smem + sizeof(ChainTables) > 48 * 1024) {                           \
      const cudaError_t e = cudaFuncSetAttribute(                           \
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);  \
      if (e != cudaSuccess) return (int)e;                                  \
    }                                                                       \
    int64_t blocks = (groups + threads - 1) / threads;                      \
    if (blocks > (1 << 20)) blocks = 1 << 20; /* the loop covers the rest */\
    kernel<<<(unsigned)blocks, threads, smem, s>>>(WTR_PIXEL_ARGS(T));      \
  } while (0)
#define WTR_PIXEL_KIND(WINDOWED, VEC)                                        \
  do {                                                                      \
    if (band_kind == 1)                                                     \
      WTR_PIXEL_LAUNCH(float, false, WINDOWED, VEC, false);                 \
    else if (band_kind == 2)                                                \
      WTR_PIXEL_LAUNCH(int16_t, true, WINDOWED, VEC, false);                \
    else if (f64_ratio)                                                     \
      WTR_PIXEL_LAUNCH(int16_t, false, WINDOWED, VEC, true);                \
    else                                                                    \
      WTR_PIXEL_LAUNCH(int16_t, false, WINDOWED, VEC, false);               \
  } while (0)
  if (n_vec > 0) {
    const int64_t first = 0, groups = n_vec;
    WTR_PIXEL_KIND(false, kVecPx);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t first = n_vec * kVecPx, groups = n - first;
  if (groups > 0) {
    if (windowed) WTR_PIXEL_KIND(true, 1);
    else WTR_PIXEL_KIND(false, 1);
  }
#undef WTR_PIXEL_KIND
#undef WTR_PIXEL_LAUNCH
#undef WTR_PIXEL_ARGS
  return (int)cudaGetLastError();
}

extern "C" int wtr_k2_launch(
    const void* state, const void* wtr2, void* cloud, void* wtr, void* bwtr,
    void* conf, void* browse, void* packed_a, void* packed_b, int batch,
    int height, int width, int row0, int rows_out, const WtrFlags* flags,
    void* stream) {
  if (batch > 65535 || bad_window(batch, height, width, row0, rows_out))
    return (int)cudaErrorInvalidValue;
  if (const int err = check_device(state)) return err;
  const dim3 blocks((width + kTile - 1) / kTile,
                    (rows_out + kTile - 1) / kTile, batch);
  wtr_k2_kernel<<<blocks, kSpan, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)state, (const uint8_t*)wtr2, (uint8_t*)cloud,
      (uint8_t*)wtr, (uint8_t*)bwtr, (uint8_t*)conf, (uint8_t*)browse,
      (uint8_t*)packed_a, (uint8_t*)packed_b, height, width, row0, rows_out,
      *flags);
  return (int)cudaGetLastError();
}

extern "C" const char* wtr_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
