"""Frozen byte and operation counts of the per-pixel kernel's function.

A copy of ``chip_smoke.py``'s ``FUNCTION_BYTES_PER_PX`` and ``_OPS``: the
campaign's launch (K5/K6: int16 bands, 'mask', shadow and landcover
planes, the packed minimal outputs) reads each input once and writes each
output once, 18 B a pixel (six int16 bands, Fmask, invalid, shadow,
landcover in; PACKED_A and PACKED_B out), plus 24 B a tile of coverage
counts. The operations are counted line by line in
``ops/csrc/wtr_kernel.cu``, one for each add, multiply, divide, convert,
compare, logical operation, shift and select.
"""

from dswx_bench.counts.peaks import PEAK_BYTES_PER_S, PEAK_OPS_PER_S

CAMPAIGN_BYTES_PER_PX = 18
CAMPAIGN_BYTES_PER_TILE = 24

_OPS = {
    # diag_tests<int16>: 6 wrapped sums (an add and wrap16's add, and,
    # subtract: 24), AWEsh (3 multiplies, 3 adds: 6), 4 ratio tests (2
    # multiplies, 6 compares, 5 logical: 52), t2 (1), t3 (3), t4's and
    # t5's 6 band tests (a multiply and a compare each) with their 7 ANDs
    # (19), the two NIR tests (3)
    'tests_int16': 24 + 6 + 52 + 1 + 3 + 19 + 3,
    # diag_tests<float>: MNDWI and NDVI (a subtract, an add, a divide
    # each: 6), MBSRV and MBSRN (2), AWEsh (3 multiplies, 3 adds: 6), the
    # 12 compares of t1 ... t5 with their 7 ANDs (19), the two NIR
    # compares (2)
    'tests_float': 6 + 2 + 6 + 19 + 2,
    # K4: scale_band on 6 bands (convert, subtract, multiply: 18), the
    # tile index i / (H*W) and its row (2)
    'cast': 18 + 2,
    # wtr_pixel_kernel from the invalid test to WTR-2 at shadow +
    # landcover: invalid (1), WTR-1 (4 adds, 13 compares and selects, the
    # fill select: 18), preliminary CLOUD (8), the aerosol remap (19), the
    # shadow test (8), the landcover demotions (16); the coverage counts
    # (tile_counts.cuh: not ocean 2, valid 3, cloud and valid 3, their
    # bits into the group's word 3, a share of the popcounts and adds 1)
    'body': 1 + 18 + 8 + 19 + 8 + 16 + 12,
    'snow_bit': 3,                     # fmask bit 4 -> CLOUD + 2
    # the DIAG pseudo-binary (4 multiplies, 4 adds, a select: 9) and
    # finish_pixel with browse (CLOUD 2, WTR 12, BWTR 4, CONF 10, BROWSE
    # 18)
    'full_outputs': 9 + 46,
    # K5: diag6 (4 shifts, 4 ORs, a select: 9), the two class indices
    # (8) and their shifts and OR (3), CLOUD's fill (2), PACKED_A (3) and
    # PACKED_B (3)
    'packed': 9 + 8 + 3 + 2 + 3 + 3,
    'cover_state': 12,                 # the 'cover' state byte
    # K2's pass B: 17 masked cross steps of 7 (three ORs of the four
    # neighbours, the mask's AND and compare, the pixel's test and
    # select), the two seed sets (6), the final snow bit and CLOUD (5)
    'dilations': 17 * 7 + 6 + 5,
}

CAMPAIGN_OPS_PER_PX = (_OPS['tests_int16'] + _OPS['body'] + _OPS['snow_bit']
                       + _OPS['packed'])


def campaign_bound_s(tiles, pixels_per_tile):
    """The least seconds of the campaign launch over ``tiles`` tiles: the
    larger of the bytes over the memory rate and the operations over the
    float32 rate."""
    nbytes = tiles * (pixels_per_tile * CAMPAIGN_BYTES_PER_PX
                      + CAMPAIGN_BYTES_PER_TILE)
    ops = tiles * pixels_per_tile * CAMPAIGN_OPS_PER_PX
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_OPS_PER_S)
