// Fused DSWx-HLS per-pixel chain (kernel slice K1) for NVIDIA Hopper.
//
// Replaces proteus_tpu/ops/pallas/wtr_kernel.py::make_wtr_kernel in its
// integer, full-output mode with mask_adjacent_to_cloud_mode 'mask' or
// 'ignore': from the six int16 bands, the fmask, the invalid mask and the
// optional ocean / shadow / landcover planes it writes DIAG (uint16
// pseudo-binary) and WTR-1, WTR-2, WTR, BWTR, CONF, CLOUD and BROWSE
// (uint8) in one pass. Its plain PyTorch twin is
// proteus_tpu_torch/models/dswx/chain.py::dswx_chain.
//
// Bound: HBM bytes. The work is a few dozen int32 operations a pixel. On
// the main path each pixel reads 16 B (6 x 2 B bands, fmask, invalid,
// shadow, landcover) and writes 9 B (DIAG 2 B + 7 x 1 B): 25 B/px, or
// 334.9 MB for a 3660 x 3660 tile (13,395,600 px).
//
// Design: one thread per pixel over the flattened H*W with a grid-stride
// loop, so that neighbouring threads load neighbouring addresses
// (coalesced) and every intermediate stays in registers. That is the whole
// design for now; wider loads (several pixels a thread) come later.
//
// Arithmetic is int32 throughout, as in wtr_kernel.py:351-389. NumPy's
// int16 wrap-around of the band sums is reproduced by wrap16. The rational
// thresholds p/q come from proteus_tpu.core.thresholds.ExactThresholds,
// whose bounds (thresholds.py:89-100) keep every product in int31:
//   ratio tests  |num|, |den| <= 32768, q <= 10,000, |p| <= 30,000
//                -> |q*num| <= 3.3e8, |p*den| <= 9.9e8;
//   AWEsh        |awesh4| <= 688,114, q <= 3,000 -> |awesh4*q| <= 2.07e9;
//   band tests   |band| <= 32768, q <= 60,000 -> |band*q| <= 1.97e9.

#include <cstdint>
#include <cuda_runtime.h>

// Rational thresholds (p, q) and the aerosol bitmask LUT, passed to the
// kernel by value. The layout matches WtrParams in ops/wtr_kernel.py.
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

// Static flags of the launch (plain ints from the wrapper).
struct WtrFlags {
  int with_ocean, with_shadow, with_landcover, compute_browse;
  int mask_adjacent, apply_aerosol;
  int exclude_psw_aggressive, collapse, not_water_nodata, cloud_nodata,
      snow_nodata;
};

// product class values (proteus_tpu/core/constants.py)
constexpr int kFill = 255;         // UINT8_FILL_VALUE
constexpr int kOcean = 254;        // WTR_OCEAN_MASKED
constexpr int kCloudMasked = 253;  // WTR_CLOUD_MASKED
constexpr int kSnowMasked = 252;   // WTR_SNOW_MASKED
constexpr int kAerosolMaxNir = 1000;  // AEROSOL_REMAPPING_MAX_NIR
constexpr int kLcWater = 200;      // LAND water
constexpr int kLcEvergreen = 201;  // LAND evergreen forest

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

__global__ void wtr_k1_kernel(
    const int16_t* __restrict__ blue, const int16_t* __restrict__ green,
    const int16_t* __restrict__ red, const int16_t* __restrict__ nir,
    const int16_t* __restrict__ swir1, const int16_t* __restrict__ swir2,
    const uint8_t* __restrict__ fmask, const uint8_t* __restrict__ invalid,
    const uint8_t* __restrict__ ocean, const uint8_t* __restrict__ shadow,
    const uint8_t* __restrict__ landcover,
    uint16_t* __restrict__ diag_o, uint8_t* __restrict__ wtr1_o,
    uint8_t* __restrict__ wtr2_o, uint8_t* __restrict__ wtr_o,
    uint8_t* __restrict__ bwtr_o, uint8_t* __restrict__ conf_o,
    uint8_t* __restrict__ cloud_o, uint8_t* __restrict__ browse_o,
    int64_t n, WtrParams P, WtrFlags F) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int b = blue[i], g = green[i], r = red[i], nr = nir[i];
    const int s1 = swir1[i], s2 = swir2[i];
    const int fm = fmask[i];
    const bool inv = invalid[i] != 0;

    // --- diagnostics (exact int32 rationals; int16 sums wrap) ---
    const int mndwi_num = wrap16(g - s1), mndwi_den = wrap16(g + s1);
    const int mbsrv = wrap16(g + r), mbsrn = wrap16(nr + s1);
    const int ndvi_num = wrap16(nr - r), ndvi_den = wrap16(nr + r);
    const int awesh4 = 4 * b + 10 * g - 6 * mbsrn - s2;

    const bool t1 = ratio_gt(mndwi_num, mndwi_den, P.wigt_p, P.wigt_q);
    const bool t2 = mbsrv > mbsrn;
    const bool t3 = awesh4 * P.awgt_q > 4 * P.awgt_p;
    const bool t4 = ratio_gt(mndwi_num, mndwi_den, P.p1_mndwi_p, P.p1_mndwi_q)
        && s1 * P.p1_swir1_q < P.p1_swir1_p && nr * P.p1_nir_q < P.p1_nir_p
        && ratio_lt(ndvi_num, ndvi_den, P.p1_ndvi_p, P.p1_ndvi_q);
    const bool t5 = ratio_gt(mndwi_num, mndwi_den, P.p2_mndwi_p, P.p2_mndwi_q)
        && b * P.p2_blue_q < P.p2_blue_p && s1 * P.p2_swir1_q < P.p2_swir1_p
        && s2 * P.p2_swir2_q < P.p2_swir2_p && nr * P.p2_nir_q < P.p2_nir_p;

    // DIAG pseudo-binary (fill -> 65535)
    const int diag = inv ? 65535
        : t1 + 10 * t2 + 100 * t3 + 1000 * t4 + 10000 * t5;
    diag_o[i] = (uint16_t)diag;

    // WTR-1: closed-form popcount interpretation (wtr_kernel.py:54-66)
    const int pc = t1 + t2 + t3 + t4 + t5;
    int wtr1 = pc >= 4 ? 1 : pc == 3 ? 2 : pc == 2 ? 4 : 0;
    if (t4 && t5 && pc == 2) wtr1 = 3;
    if (t5 && pc == 1) wtr1 = 4;
    if (F.with_ocean && ocean[i] == 0) wtr1 = kOcean;
    if (inv) wtr1 = kFill;
    wtr1_o[i] = (uint8_t)wtr1;

    // preliminary CLOUD: shadow (and adjacent, in 'mask' mode) -> 1,
    // cloud -> +4
    const bool shadow_bit = (fm & 8) || (F.mask_adjacent && (fm & 4));
    int cloud = (shadow_bit ? 1 : 0) + ((fm & 2) ? 4 : 0);

    // aerosol remapping of classes 0, 2, 3, 4 to high-confidence water
    int wtr1a = wtr1;
    if (F.apply_aerosol && nr <= kAerosolMaxNir) {
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
      const bool nir_bright = nr * P.lcmask_q > P.lcmask_p;
      const bool psw = wtr1a == 3 || wtr1a == 4;
      const bool demote = (lc == kLcEvergreen && nir_bright && psw)
          || (lc < 100 && nir_bright && psw)      // low-intensity developed
          || (lc >= 100 && lc < 200 && water);    // high-intensity developed
      if (demote) wtr2 = 0;
    }
    wtr2_o[i] = (uint8_t)wtr2;

    // snow + fill -> final CLOUD
    if (fm & 16) cloud += 2;
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
}

// Launch on `stream` (PyTorch's current stream); does not synchronise.
// Returns cudaGetLastError() after the launch: nonzero means the launch was
// refused or an earlier asynchronous error is pending.
extern "C" int wtr_k1_launch(
    const void* blue, const void* green, const void* red, const void* nir,
    const void* swir1, const void* swir2, const void* fmask,
    const void* invalid, const void* ocean, const void* shadow,
    const void* landcover, void* diag, void* wtr1, void* wtr2, void* wtr,
    void* bwtr, void* conf, void* cloud, void* browse, int64_t n,
    const WtrParams* params, int with_ocean, int with_shadow,
    int with_landcover, int compute_browse, int mask_adjacent,
    int apply_aerosol, int exclude_psw_aggressive, int collapse,
    int not_water_nodata, int cloud_nodata, int snow_nodata, void* stream) {
  const WtrFlags flags = {with_ocean, with_shadow, with_landcover,
                          compute_browse, mask_adjacent, apply_aerosol,
                          exclude_psw_aggressive, collapse, not_water_nodata,
                          cloud_nodata, snow_nodata};
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > (1 << 20)) blocks = 1 << 20;  // the loop covers the rest
  if (blocks < 1) blocks = 1;
  wtr_k1_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int16_t*)blue, (const int16_t*)green, (const int16_t*)red,
      (const int16_t*)nir, (const int16_t*)swir1, (const int16_t*)swir2,
      (const uint8_t*)fmask, (const uint8_t*)invalid, (const uint8_t*)ocean,
      (const uint8_t*)shadow, (const uint8_t*)landcover, (uint16_t*)diag,
      (uint8_t*)wtr1, (uint8_t*)wtr2, (uint8_t*)wtr, (uint8_t*)bwtr,
      (uint8_t*)conf, (uint8_t*)cloud, (uint8_t*)browse, n, *params, flags);
  return (int)cudaGetLastError();
}

extern "C" const char* wtr_k1_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
