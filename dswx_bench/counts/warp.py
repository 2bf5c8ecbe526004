"""Frozen operation and byte counts of the device warp's function.

A copy of ``chip_smoke.py``'s ``_W``, ``_warp_ops`` and ``_warp_bound``
(operations counted line by line in ``ops/csrc/warp_kernel.cuh`` on the
path the product's data takes), with the bound taken from a warp's shapes
rather than from its arguments: the source window read once (a nearest
warp reads one element a pixel at most), the four float32 lattice planes,
and the output and its one-byte ambiguity flag written once. The counts
stay here, so that a later implementation is judged against the same
work.
"""

from dswx_bench.counts.peaks import PEAK_BYTES_PER_S, PEAK_OPS_PER_S

# operations of the warp kernel's steps, counted line by line in
# csrc/warp_kernel.cuh on the path this run's data takes (regular pixels
# whose products all pass the FMA's test; no pixel runs again with
# Dekker's split): one for each add, subtract, multiply, divide,
# compare, select, logical operation, shift, convert, floor, abs, min and
# max, two for a fused multiply-add, as the 67 TFLOP/s float32 rate counts
# one (a negation folds into its add; loads and stores are the bytes
# side). The kernel fuses nothing else, by design: an unfused add or
# multiply issues at half the rate that convention assumes, so an unfused
# mix cannot pass about 50% of this bound.
_W = {'two_sum': 6,
      'dd_norm': 3,
      'near_edge': 8,             # abs, add, multiply, add, subtract, 2
                                  # compares, or
      # the shift, clamp (compare, select), the shift back, subtract,
      # convert, multiply of a row's or a column's cell
      'cell': 7,
      # in_window (2 compares, and), the clamp (2 compares, 2 selects), the
      # row's multiply; a wrapping column's remainder (%, compare, add,
      # select)
      'gather_row': 3 + 4 + 1, 'gather_col': 3 + 4, 'wrap': 4,
      # f32 boundary band: |hi| + 1e-30 (2), next_up (compare, add,
      # select), half ulp (2), coord_mag (4), spread (a subtract,
      # nan_to_num's compare, abs, compare, or and select), delta (5
      # multiplies, 2 adds), the test (2 abs, subtract, compare, or)
      'band': 2 + 3 + 2 + 4 + 6 + 7 + 5}
# two_prod's FMA: p, the fused multiply-add, and the test of its operands
# folded into the pixel's flag: |p| against 2^-100, a == 0, b == 0, 2 ors
# and the flag's and (one compare and or fewer where b is a constant);
# a lattice difference's bound (compare, and), a source value's or a
# quotient's (2 compares, 2 ands)
_W['two_prod'] = {'bounded': 1 + 2 + 3 + 2 + 1, 'constant': 1 + 2 + 2 + 1 + 1,
                  'any_a': 1 + 2 + 3 + 2 + 1 + 2,
                  'any_b': 1 + 2 + 3 + 2 + 1 + 4}
_W['dd_add'] = _W['two_sum'] + 2 + _W['dd_norm']
_W['dd_mul_f32'] = {k: n + 2 + _W['dd_norm']
                    for k, n in _W['two_prod'].items()}
_W['dd_mul'] = _W['two_prod']['bounded'] + 4 + _W['dd_norm']
# the row lerp of a staged column (the difference, its product, the sum)
# and its difference to the next column; a pixel's column lerp
_W['dd_lerp'] = 2 * _W['dd_add'] + _W['dd_mul_f32']['any_a']
_W['stage'] = _W['dd_lerp'] + _W['dd_add']
_W['column_lerp'] = _W['dd_mul_f32']['any_a'] + _W['dd_add']
# floor, the two TwoSums and the add between, the shift (2 compares, 2
# selects), the fraction's dd_add, the index (subtract, convert)
_W['dd_floor'] = 1 + 2 * _W['two_sum'] + 1 + 4 + _W['dd_add'] + 2
# the column's cell, the column lerps of u and v and the flag's branch
_W['interp'] = _W['cell'] + 2 * _W['column_lerp'] + 1
_W['poly_inner'] = _W['dd_mul_f32']['constant'] + 2 * _W['dd_add'] \
    + 2 * _W['dd_mul']
_W['poly_outer'] = _W['dd_mul_f32']['constant'] + 3 * _W['dd_add'] \
    + 2 * _W['dd_mul']
# the four cubic weights of one axis: f + 1, 1 - f, 2 - f and the polynomials
_W['cubic_weights'] = 3 * _W['dd_add'] + 2 * _W['poly_inner'] \
    + 2 * _W['poly_outer']
# a tap's accumulation: fast (|term| and its add, fminf, fmaxf, the dd
# sum), unmasked-wrap (+ the weight sum), masked (ok: 2 ands and the
# validity's compare; the selects of |term|, vmin, vmax and the 4 dd
# operands, and both dd sums)
_W['accumulate'] = {0: 2 + 2 + _W['dd_add'],
                    1: 2 + 2 + 2 * _W['dd_add'],
                    2: 3 + 2 + 1 + 2 + 2 + 4 + 2 * _W['dd_add']}
# the dd division (compare and select, 2 divides, the Newton step's
# products and sums), good (compare, and), the two ambiguity tests and
# err_scale (abs, max, divide)
_W['divide'] = 2 + 2 + _W['dd_mul_f32']['any_b'] + _W['dd_add'] \
    + _W['two_sum'] + _W['dd_norm'] + 2 + 4 + 4 + 3


def _warp_ops(algorithm, mode, wraps, out_h, out_w, gw):
    """The operations of one warp: each pixel's and each staged lattice
    column's (the row lerps of u and v)."""
    px = _W['interp'] + 2 * _W['dd_floor'] + 2 * _W['near_edge'] + 1
    col = _W['gather_col'] + (_W['wrap'] if wraps else 0)
    if algorithm == 'nearest':
        # in_range (3, 4 more without a wrap), the row and column, the flat
        # index's add, ok (2 ands, the validity's compare), the select,
        # amb's and
        px += (3 if wraps else 7) + _W['gather_row'] + col + 1 + 3 + 1 + 1
    else:
        taps = 2 if algorithm == 'bilinear' else 4
        weights = 2 * (_W['dd_add'] if taps == 2 else _W['cubic_weights'])
        # the flat index's add, the weights' product, the term
        tap = 1 + _W['dd_mul'] + _W['dd_mul_f32']['any_b'] \
            + _W['accumulate'][mode]
        # the dd u - 0.5 and v - 0.5, center_in, each tap row's and
        # column's gather, the regular test (2 abs, 2 compares, and) and
        # the flag's branch, the taps, the division, the band, amb's and
        # and good's select
        px += 2 * _W['dd_add'] + weights + (3 if wraps else 7) \
            + taps * (_W['gather_row'] + col) + 6 + taps * taps * tap \
            + (_W['divide'] if mode else 0) + _W['band'] + 2
    return px * out_h * out_w + 2 * _W['stage'] * out_h * gw


def warp_bound_s(algorithm, src_rows, src_cols, src_itemsize, out_h, out_w,
                 out_itemsize, spacing, masked=False, wraps=False):
    """The least seconds of one warp on the card: the larger of its bytes
    over the memory rate and its operations over the float32 rate."""
    mode = 2 if masked else (1 if wraps else 0)
    gh = len(range(0, out_h + 2 * spacing, spacing))
    gw = len(range(0, out_w + 2 * spacing, spacing))
    read = src_rows * src_cols if algorithm != 'nearest' \
        else min(src_rows * src_cols, out_h * out_w)
    itemsize = 4 if algorithm != 'nearest' else src_itemsize
    nbytes = read * itemsize + out_h * out_w * (out_itemsize + 1) \
        + (src_rows * src_cols if masked else 0) + 4 * gh * gw * 4
    ops = _warp_ops(algorithm, mode, wraps, out_h, out_w, gw)
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_OPS_PER_S)
