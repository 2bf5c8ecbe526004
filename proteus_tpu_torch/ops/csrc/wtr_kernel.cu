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
//       375.1 MB/tile, plus the halo's re-reads of the state, 66^2/32^2 =
//       4.25 loads a pixel, which mostly hit L2.
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
// Design: the per-pixel kernels run one thread per pixel over the
// flattened H*W with a grid-stride loop, so that neighbouring threads load
// neighbouring addresses and every intermediate stays in registers.
// wtr_k2_kernel gives each block a 32 x 32 tile of output pixels and loads
// the state of the tile plus a 17 px halo on every side (66 x 66 bytes)
// into shared memory, with zeros outside the image (scipy's border); one
// masked cross step a __syncthreads() apart, 10 for snow, then 7 for the
// clear not-snow set, ping-ponging between byte buffers: 4 x 4,356 B =
// 17,424 B of static shared memory a block, 256 threads. 17 px is exactly
// the influence radius (10 + 7), so halo pixels whose own neighbourhood is
// cut off never reach the tile. Fusing the two passes and a wider tile are
// later work.
//
// Exactness.
//   int16 bands: int32 arithmetic throughout, as in wtr_kernel.py:351-389.
//   NumPy's int16 wrap-around of the band sums is reproduced by wrap16.
//   The rational thresholds p/q come from ExactThresholds, whose bounds
//   (thresholds.py:89-100) keep every product in int31:
//     ratio tests  |num|, |den| <= 32768, q <= 10,000, |p| <= 30,000
//                  -> |q*num| <= 3.3e8, |p*den| <= 9.9e8;
//     AWEsh        |awesh4| <= 688,114, q <= 3,000 -> |awesh4*q| <= 2.07e9;
//     band tests   |band| <= 32768, q <= 60,000 -> |band*q| <= 1.97e9.
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
#include <cuda_runtime.h>

// Rational thresholds (p, q) and the aerosol bitmask LUT, passed to the
// kernel by value. The layout matches WtrParams in ops/wtr_kernel.py. The
// float pass reads only the LUT.
struct WtrParams {
  int32_t wigt_p, wigt_q;
  int32_t awgt_p, awgt_q;
  int32_t p1_mndwi_p, p1_mndwi_q;
  int32_t p1_swir1_p, p1_swir1_q;
  int32_t p1_nir_p, p1_nir_q;
  int32_t p1_ndvi_p, p1_ndvi_q;
  int32_t p2_mndwi_p, p2_mndwi_q;
  int32_t p2_blue_p, p2_blue_q;
  int32_t p2_nir_p, p2_nir_q;
  int32_t p2_swir1_p, p2_swir1_q;
  int32_t p2_swir2_p, p2_swir2_q;
  int32_t lcmask_p, lcmask_q;
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

constexpr int kTile = 32;                   // output pixels a block side
constexpr int kSnowSteps = 10, kUnmaskSteps = 7;
constexpr int kHalo = kSnowSteps + kUnmaskSteps;  // 17
constexpr int kSpan = kTile + 2 * kHalo;          // 66

// The five diagnostic tests and the two NIR tests of the masking stages.
struct Tests {
  bool t1, t2, t3, t4, t5;
  bool nir_ok_aerosol;  // nir <= AEROSOL_REMAPPING_MAX_NIR
  bool nir_bright;      // nir > lcmask_nir
};

__device__ __forceinline__ int wrap16(int x) {
  return ((x + 32768) & 0xFFFF) - 32768;
}

// num/den > p/q with float64-division semantics (den == 0: num/0 is
// +-inf, 0/0 is NaN and compares false)
__device__ __forceinline__ bool ratio_gt(int num, int den, int p, int q) {
  const int qn = q * num, pd = p * den;
  return (den > 0 && qn > pd) || (den < 0 && qn < pd) || (den == 0 && num > 0);
}

__device__ __forceinline__ bool ratio_lt(int num, int den, int p, int q) {
  const int qn = q * num, pd = p * den;
  return (den > 0 && qn < pd) || (den < 0 && qn > pd) || (den == 0 && num < 0);
}

// int16 bands: exact int32 rationals (K1)
__device__ __forceinline__ Tests diag_tests(
    int16_t b16, int16_t g16, int16_t r16, int16_t n16, int16_t s1_16,
    int16_t s2_16, const WtrParams& P, const WtrParamsF32&) {
  const int b = b16, g = g16, r = r16, nr = n16, s1 = s1_16, s2 = s2_16;
  const int mndwi_num = wrap16(g - s1), mndwi_den = wrap16(g + s1);
  const int mbsrv = wrap16(g + r), mbsrn = wrap16(nr + s1);
  const int ndvi_num = wrap16(nr - r), ndvi_den = wrap16(nr + r);
  const int awesh4 = 4 * b + 10 * g - 6 * mbsrn - s2;
  Tests t;
  t.t1 = ratio_gt(mndwi_num, mndwi_den, P.wigt_p, P.wigt_q);
  t.t2 = mbsrv > mbsrn;
  t.t3 = awesh4 * P.awgt_q > 4 * P.awgt_p;
  t.t4 = ratio_gt(mndwi_num, mndwi_den, P.p1_mndwi_p, P.p1_mndwi_q)
      && s1 * P.p1_swir1_q < P.p1_swir1_p && nr * P.p1_nir_q < P.p1_nir_p
      && ratio_lt(ndvi_num, ndvi_den, P.p1_ndvi_p, P.p1_ndvi_q);
  t.t5 = ratio_gt(mndwi_num, mndwi_den, P.p2_mndwi_p, P.p2_mndwi_q)
      && b * P.p2_blue_q < P.p2_blue_p && s1 * P.p2_swir1_q < P.p2_swir1_p
      && s2 * P.p2_swir2_q < P.p2_swir2_p && nr * P.p2_nir_q < P.p2_nir_p;
  t.nir_ok_aerosol = nr <= kAerosolMaxNir;
  t.nir_bright = nr * P.lcmask_q > P.lcmask_p;
  return t;
}

// float32 bands: NumPy's float32 evaluation, one rounding per operation
// in its order (K3)
__device__ __forceinline__ Tests diag_tests(
    float b, float g, float r, float nr, float s1, float s2,
    const WtrParams&, const WtrParamsF32& Q) {
  const float mndwi = __fdiv_rn(__fsub_rn(g, s1), __fadd_rn(g, s1));
  const float ndvi = __fdiv_rn(__fsub_rn(nr, r), __fadd_rn(nr, r));
  const float mbsrv = __fadd_rn(g, r), mbsrn = __fadd_rn(nr, s1);
  // ((blue + 2.5*green) - 1.5*mbsrn) - 0.25*swir2
  const float awesh = __fsub_rn(
      __fsub_rn(__fadd_rn(b, __fmul_rn(2.5f, g)), __fmul_rn(1.5f, mbsrn)),
      __fmul_rn(0.25f, s2));
  Tests t;
  t.t1 = mndwi > Q.wigt;
  t.t2 = mbsrv > mbsrn;
  t.t3 = awesh > Q.awgt;
  t.t4 = mndwi > Q.p1_mndwi && s1 < Q.p1_swir1 && nr < Q.p1_nir
      && ndvi < Q.p1_ndvi;
  t.t5 = mndwi > Q.p2_mndwi && b < Q.p2_blue && s1 < Q.p2_swir1
      && s2 < Q.p2_swir2 && nr < Q.p2_nir;
  t.nir_ok_aerosol = nr <= (float)kAerosolMaxNir;
  t.nir_bright = nr > Q.lcmask;
  return t;
}

// K4: the reference's cast of a raw int16 band, one rounding a step
__device__ __forceinline__ float scale_band(int16_t x, float scale,
                                            float offset) {
  return __fmul_rn(scale, __fsub_rn(__int2float_rn(x), offset));
}

// K5: the 3-bit class index of a WTR-1 / WTR-2 value (0..4, ocean, fill)
__device__ __forceinline__ int widx(int w) {
  return w == kOcean ? 5 : w == kFill ? 6 : w;
}

// CLOUD (with its snow bit) + WTR-2 -> CLOUD, WTR, BWTR, CONF, BROWSE
__device__ __forceinline__ void finish_pixel(
    int64_t i, int cloud, int wtr2, const WtrFlags& F,
    uint8_t* __restrict__ cloud_o, uint8_t* __restrict__ wtr_o,
    uint8_t* __restrict__ bwtr_o, uint8_t* __restrict__ conf_o,
    uint8_t* __restrict__ browse_o) {
  if (wtr2 == kFill) cloud = 255;
  cloud_o[i] = (uint8_t)cloud;

  // WTR
  const bool cloudy = cloud != 0 && cloud != 8;
  const bool snowy = cloud == 2 || cloud == 10;
  int wtr = cloudy ? kCloudMasked : wtr2;
  if (snowy) wtr = kSnowMasked;
  if (wtr2 == kOcean) wtr = kOcean;
  if (wtr2 == kFill) wtr = kFill;
  wtr_o[i] = (uint8_t)wtr;

  // BWTR
  bwtr_o[i] = (uint8_t)((wtr >= 1 && wtr <= 4) ? 1 : wtr);

  // CONF: +10 under cloud, +20 under snow, clear classes only
  int conf = wtr2;
  const bool clear_class = wtr2 <= 4;
  if (cloudy && !snowy && clear_class) conf += 10;
  if (cloud == 2 && clear_class) conf += 20;
  conf_o[i] = (uint8_t)conf;

  // BROWSE
  if (F.compute_browse) {
    int br = wtr;
    if (F.exclude_psw_aggressive && br == 4) br = 0;
    if (F.collapse) br = (br == 1 || br == 2) ? 1 : (br == 3 || br == 4) ? 2 : br;
    if (F.not_water_nodata && br == 0) br = kFill;
    if (F.cloud_nodata && br == kCloudMasked) br = kFill;
    if (F.snow_nodata && br == kSnowMasked) br = kFill;
    if (br == kOcean) br = kFill;
    browse_o[i] = (uint8_t)br;
  }
}

// K1 (Band = int16_t) and K3 (Band = float); K4 (Band = int16_t, kScaled:
// raw bands cast per tile before K3's body); with F.cover, pass A of K2;
// with F.minimal, K5's packed outputs. Each input plane (and the state) is
// a [B, H, W] stack (K6), hw = H * W; the outputs are the [B, rows_out, W]
// window from row row0 (kWindowed; else the whole stack, rows_out == H, and
// the kernel is K1-K6's as before the spatial launch).
template <typename Band, bool kScaled, bool kWindowed>
__global__ void wtr_pixel_kernel(
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
    uint8_t* __restrict__ state_o, int64_t n, int64_t hw, int width,
    int row0, int rows_out, int batch, WtrParams P, WtrParamsF32 Q,
    WtrFlags F) {
  // K4: the batch's scales (sv[6 t + j]) and offsets (sv[6 B + 6 t + j])
  extern __shared__ float sv[];
  if (kScaled) {
    for (int k = threadIdx.x; k < 6 * batch; k += blockDim.x) {
      sv[k] = scales[k];
      sv[6 * batch + k] = offsets[k];
    }
    __syncthreads();
  }
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    // o: the pixel's index in the output window, -1 outside it
    int64_t o = i;
    if constexpr (kWindowed) {
      const int64_t tile = i / hw, p = i - tile * hw;
      const int y = (int)(p / width);
      o = (y >= row0 && y < row0 + rows_out)
          ? tile * rows_out * (int64_t)width + p - (int64_t)row0 * width
          : -1;
      if (o < 0 && !F.cover) continue;
    }
    Tests t;
    if constexpr (kScaled) {
      const float* s = sv + 6 * (i / hw);
      const float* o = s + 6 * batch;
      t = diag_tests(scale_band(blue[i], s[0], o[0]),
                     scale_band(green[i], s[1], o[1]),
                     scale_band(red[i], s[2], o[2]),
                     scale_band(nir[i], s[3], o[3]),
                     scale_band(swir1[i], s[4], o[4]),
                     scale_band(swir2[i], s[5], o[5]), P, Q);
    } else {
      t = diag_tests(blue[i], green[i], red[i], nir[i], swir1[i], swir2[i],
                     P, Q);
    }
    const int fm = fmask[i];
    const bool inv = invalid[i] != 0;

    // WTR-1: closed-form popcount interpretation (wtr_kernel.py:54-66)
    const int pc = t.t1 + t.t2 + t.t3 + t.t4 + t.t5;
    int wtr1 = pc >= 4 ? 1 : pc == 3 ? 2 : pc == 2 ? 4 : 0;
    if (t.t4 && t.t5 && pc == 2) wtr1 = 3;
    if (t.t5 && pc == 1) wtr1 = 4;
    if (F.with_ocean && ocean[i] == 0) wtr1 = kOcean;
    if (inv) wtr1 = kFill;

    // DIAG: the 6-bit decimal for K5, else the pseudo-binary (fill ->
    // 65535)
    const int diag6 = inv ? kDiagFill6
        : t.t1 | t.t2 << 1 | t.t3 << 2 | t.t4 << 3 | t.t5 << 4;
    if (!F.minimal && o >= 0) {
      diag_o[o] = (uint16_t)(inv ? 65535
          : t.t1 + 10 * t.t2 + 100 * t.t3 + 1000 * t.t4 + 10000 * t.t5);
      wtr1_o[o] = (uint8_t)wtr1;
    }

    // preliminary CLOUD: shadow (and adjacent, in 'mask' mode) -> 1,
    // cloud -> +4
    const bool shadow_bit = (fm & 8) || (F.mask_adjacent && (fm & 4));
    int cloud = (shadow_bit ? 1 : 0) + ((fm & 2) ? 4 : 0);

    // aerosol remapping of classes 0, 2, 3, 4 to high-confidence water
    int wtr1a = wtr1;
    if (F.apply_aerosol && t.nir_ok_aerosol) {
      const int lut = P.aerosol_lut[fm];
      const bool hit = ((lut & 1) && wtr1 == 0) || ((lut & 2) && wtr1 == 2)
          || ((lut & 4) && wtr1 == 3) || ((lut & 8) && wtr1 == 4);
      if (hit) {
        wtr1a = 1;
        cloud |= 8;
      }
    }

    // landcover + shadow -> WTR-2 (the tests read the remapped WTR-1)
    int wtr2 = wtr1a;
    const bool water = wtr1a >= 1 && wtr1a <= 4;
    if (F.with_shadow) {
      bool shadowed = shadow[i] == 0 && water;  // SHAD_MASKED == 0
      if (F.with_landcover) shadowed = shadowed && landcover[i] != kLcWater;
      if (shadowed) wtr2 = 0;
    }
    if (F.with_landcover) {
      const int lc = landcover[i];
      const bool psw = wtr1a == 3 || wtr1a == 4;
      const bool demote = (lc == kLcEvergreen && t.nir_bright && psw)
          || (lc < 100 && t.nir_bright && psw)    // low-intensity developed
          || (lc >= 100 && lc < 200 && water);    // high-intensity developed
      if (demote) wtr2 = 0;
    }
    if (!F.minimal && o >= 0) wtr2_o[o] = (uint8_t)wtr2;
    const int wtr_idx = widx(wtr1) << 2 | widx(wtr2) << 5;

    if (F.cover) {
      // the snow dilations need the neighbours: wtr_k2_kernel finishes
      const bool water2 = wtr2 >= 1 && wtr2 <= 4;  // on the final WTR-2
      state_o[i] = (uint8_t)(cloud | ((fm & 16) ? kStSnow : 0)
                             | (((fm & 4) && cloud == 0) ? kStAreas : 0)
                             | (water2 ? kStWater : 0));
      if (F.minimal && o >= 0) {
        pa_o[o] = (uint8_t)diag6;
        pb_o[o] = (uint8_t)wtr_idx;
      }
      continue;
    }
    // (outside 'cover', o >= 0 here)
    if (fm & 16) cloud += 2;
    if (F.minimal) {
      // CLOUD's fill (255) is WTR-2's: only its four payload bits ship
      const int cloudp = wtr2 == kFill ? 0 : cloud;
      pa_o[o] = (uint8_t)(diag6 | (cloudp & 3) << 6);
      pb_o[o] = (uint8_t)(((cloudp >> 2) & 3) | wtr_idx);
      continue;
    }
    finish_pixel(o, cloud, wtr2, F, cloud_o, wtr_o, bwtr_o, conf_o,
                 browse_o);
  }
}

// One masked cross step over the staged span: a pixel of `mask` turns on
// when one of its four neighbours is on. Neighbours beyond the span count
// as 0; their effect never reaches the tile (see kHalo).
__device__ __forceinline__ void dilate_step(
    const uint8_t (*cur)[kSpan], uint8_t (*nxt)[kSpan],
    const uint8_t (*st)[kSpan], int mask_bits) {
  for (int r = threadIdx.y; r < kSpan; r += blockDim.y) {
    for (int c = threadIdx.x; c < kSpan; c += blockDim.x) {
      uint8_t v = cur[r][c];
      if (!v && (st[r][c] & mask_bits) == mask_bits) {
        v = (r > 0 && cur[r - 1][c]) || (r < kSpan - 1 && cur[r + 1][c])
            || (c > 0 && cur[r][c - 1]) || (c < kSpan - 1 && cur[r][c + 1]);
      }
      nxt[r][c] = v;
    }
  }
}

// K2 pass B: the 'cover' snow dilations (masking.py:178-204) on a
// 32 x 32 tile of image blockIdx.z of the stack (K6), then CLOUD, WTR,
// BWTR, CONF and BROWSE of the tile, or with F.minimal CLOUD's four bits
// ORed into PACKED_A/B (K5). The state is the [B, height, width] block;
// WTR-2 and the layers are the [B, rows_out, width] window from block row
// row0, whose rows the grid covers (K6 spatial).
__global__ void __launch_bounds__(256) wtr_k2_kernel(
    const uint8_t* __restrict__ state, const uint8_t* __restrict__ wtr2_in,
    uint8_t* __restrict__ cloud_o, uint8_t* __restrict__ wtr_o,
    uint8_t* __restrict__ bwtr_o, uint8_t* __restrict__ conf_o,
    uint8_t* __restrict__ browse_o, uint8_t* __restrict__ pa,
    uint8_t* __restrict__ pb, int height, int width, int row0,
    int rows_out, WtrFlags F) {
  __shared__ uint8_t st[kSpan][kSpan];
  __shared__ uint8_t buf[3][kSpan][kSpan];
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

  // stage the state with zeros outside the block; snow_0 into buf[0]
  for (int r = threadIdx.y; r < kSpan; r += blockDim.y) {
    const int y = y0 + r;
    for (int c = threadIdx.x; c < kSpan; c += blockDim.x) {
      const int x = x0 + c;
      const uint8_t s = (y >= 0 && y < height && x >= 0 && x < width)
          ? state[(int64_t)y * width + x] | kStInside : 0;
      st[r][c] = s;
      buf[0][r][c] = (s & kStSnow) != 0;
    }
  }
  __syncthreads();

  // snow grows 10 steps into the clear adjacent areas
  int a = 0, b = 1;
  for (int k = 0; k < kSnowSteps; ++k) {
    dilate_step(buf[a], buf[b], st, kStAreas);
    __syncthreads();
    a ^= 1;
    b ^= 1;
  }
  // buf[a] holds the snow; the clear not-snow set grows 7 steps over the
  // adjacent areas that WTR-2 calls water, in the other two buffers
  uint8_t (*snow)[kSpan] = buf[a];
  int u = b, v = 2;
  for (int r = threadIdx.y; r < kSpan; r += blockDim.y)
    for (int c = threadIdx.x; c < kSpan; c += blockDim.x)
      buf[u][r][c] = !snow[r][c]
          && (st[r][c] & (kStCloud | kStInside)) == kStInside;
  __syncthreads();
  for (int k = 0; k < kUnmaskSteps; ++k) {
    dilate_step(buf[u], buf[v], st, kStAreas | kStWater);
    __syncthreads();
    const int w = u;
    u = v;
    v = w;
  }

  for (int r = threadIdx.y; r < kTile; r += blockDim.y) {
    const int y = y0 + kHalo + r;
    const int x = x0 + kHalo + threadIdx.x;
    if (y >= row0 + rows_out || x >= width) continue;
    const int64_t i = (int64_t)(y - row0) * width + x;
    const int sr = r + kHalo, sc = threadIdx.x + kHalo;
    const bool snowed = snow[sr][sc] && !buf[u][sr][sc];
    const int cloud = (st[sr][sc] & kStCloud) + (snowed ? 2 : 0);
    if (F.minimal) {
      const uint8_t b = pb[i];
      const int cloudp = ((b >> 5) & 7) == 6 ? 0 : cloud;  // WTR-2 fill
      pa[i] |= (uint8_t)((cloudp & 3) << 6);
      pb[i] = (uint8_t)(b | ((cloudp >> 2) & 3));
      continue;
    }
    finish_pixel(i, cloud, wtr2_in[i], F, cloud_o, wtr_o, bwtr_o, conf_o,
                 browse_o);
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

extern "C" int wtr_pixel_launch(
    int band_kind, const void* blue, const void* green, const void* red,
    const void* nir, const void* swir1, const void* swir2,
    const void* scales, const void* offsets, const void* fmask,
    const void* invalid, const void* ocean, const void* shadow,
    const void* landcover, void* diag, void* wtr1, void* wtr2, void* wtr,
    void* bwtr, void* conf, void* cloud, void* browse, void* packed_a,
    void* packed_b, void* state, int batch, int height, int width, int row0,
    int rows_out, const WtrParams* params, const WtrParamsF32* params_f32,
    const WtrFlags* flags, void* stream) {
  if (batch > kMaxBatch || bad_window(batch, height, width, row0, rows_out))
    return (int)cudaErrorInvalidValue;
  if (const int err = check_device(blue)) return err;
  const int64_t hw = (int64_t)height * width;
  const int64_t n = batch * hw;
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > (1 << 20)) blocks = 1 << 20;  // the loop covers the rest
  const cudaStream_t s = (cudaStream_t)stream;
#define WTR_PIXEL_ARGS(T)                                                   \
  (const T*)blue, (const T*)green, (const T*)red, (const T*)nir,            \
      (const T*)swir1, (const T*)swir2, (const float*)scales,               \
      (const float*)offsets, (const uint8_t*)fmask,                         \
      (const uint8_t*)invalid, (const uint8_t*)ocean,                       \
      (const uint8_t*)shadow, (const uint8_t*)landcover, (uint16_t*)diag,   \
      (uint8_t*)wtr1, (uint8_t*)wtr2, (uint8_t*)wtr, (uint8_t*)bwtr,        \
      (uint8_t*)conf, (uint8_t*)cloud, (uint8_t*)browse,                    \
      (uint8_t*)packed_a, (uint8_t*)packed_b, (uint8_t*)state, n, hw,       \
      width, row0, rows_out, batch, *params, *params_f32, *flags
  const size_t smem = band_kind == 2 ? 12 * sizeof(float) * (size_t)batch
                                     : 0;
#define WTR_PIXEL_LAUNCH(T, SCALED, WINDOWED)                                \
  wtr_pixel_kernel<T, SCALED, WINDOWED>                                     \
      <<<(unsigned)blocks, threads, smem, s>>>(WTR_PIXEL_ARGS(T))
  if (rows_out == height) {
    if (band_kind == 1) WTR_PIXEL_LAUNCH(float, false, false);
    else if (band_kind == 2) WTR_PIXEL_LAUNCH(int16_t, true, false);
    else WTR_PIXEL_LAUNCH(int16_t, false, false);
  } else {
    if (band_kind == 1) WTR_PIXEL_LAUNCH(float, false, true);
    else if (band_kind == 2) WTR_PIXEL_LAUNCH(int16_t, true, true);
    else WTR_PIXEL_LAUNCH(int16_t, false, true);
  }
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
  const dim3 threads(kTile, 8);
  const dim3 blocks((width + kTile - 1) / kTile,
                    (rows_out + kTile - 1) / kTile, batch);
  wtr_k2_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)state, (const uint8_t*)wtr2, (uint8_t*)cloud,
      (uint8_t*)wtr, (uint8_t*)bwtr, (uint8_t*)conf, (uint8_t*)browse,
      (uint8_t*)packed_a, (uint8_t*)packed_b, height, width, row0, rows_out,
      *flags);
  return (int)cudaGetLastError();
}

extern "C" const char* wtr_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
