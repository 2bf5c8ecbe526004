"""Diagnostic surface-water tests (DIAG layer).

Port of ``proteus_tpu/models/dswx/diagnostics.py:48-248``.

int16 bands (the product default): every threshold comparison runs in
int32 as ``q*num OP p*den`` (see ``proteus_tpu.core.thresholds``), which is
bit-identical to the reference's float64 evaluation, including the int16
wrap-around of the band sums. The sums are formed in int32 and wrapped
explicitly, exactly as the CUDA kernel does. A threshold that is not an
exact rational (a user-set 1/3) is decided with the reference's float64
semantics instead: a ratio test divides in float64, tensor by tensor (the
correctly rounded IEEE quotient on the CPU and on CUDA, so it is NumPy's
``float64(num) / float64(den) OP t`` bit for bit, 0/0 -> NaN -> False and
x/0 -> +-inf included), and a band or AWEsh test compares with the integer
bound of ``core/f32exact.py``. The JAX package reaches the same decisions
without dividing (``ratio_boundary`` and ``ratio_cmp``); for the degenerate
thresholds outside that machinery's domain (finite |t| below about 1e-30
or beyond float32's range) it falls back to a float32 division it calls
approximate, where the port keeps the float64 division, which is NumPy's
decision for every threshold. The CUDA kernels decide such a threshold the
same way: the integer bound from the host, and ``__ddiv_rn`` on the
operands as float64 (``ops/wtr_kernel.py::kernel_params``).

float32 bands (offset-and-scaled inputs): the reference evaluates the
chain in NumPy float32, one rounding per operation, so this path does the
same. The MNDWI and NDVI tests divide: tensor division is the correctly
rounded IEEE quotient on the CPU and on CUDA, so ``num / den OP t32`` is
NumPy's decision bit for bit, including 0/0 -> NaN -> False and x/0 ->
+-inf. The JAX package decides them without dividing (``core/f32exact.py``)
only because TPU float32 division is not correctly rounded.
"""

import numpy as np
import torch

from proteus_tpu_torch.core.f32exact import int_gt_bound, int_lt_bound
from proteus_tpu_torch.core.thresholds import ExactThresholds, HlsThresholds

_I32 = torch.int32


def wrap16(x):
    """int32 -> the value NumPy's int16 arithmetic would have kept."""
    return ((x + 32768) & 0xFFFF) - 32768


def _ratio_gt_exact(num, den, p, q):
    """num/den > p/q with float64-division semantics (num, den: int32)."""
    qnum = q * num
    pden = p * den
    return torch.where(den > 0, qnum > pden,
                       torch.where(den < 0, qnum < pden, num > 0))


def _ratio_lt_exact(num, den, p, q):
    """num/den < p/q with float64-division semantics."""
    qnum = q * num
    pden = p * den
    return torch.where(den > 0, qnum < pden,
                       torch.where(den < 0, qnum > pden, num < 0))


def _clip_i32(bound):
    return int(np.clip(bound, -2 ** 31 + 1, 2 ** 31 - 1))


def _int_ratio_test(num, den, field, tval, op):
    """num/den OP tval (op 'gt' or 'lt') in float64 semantics for any
    threshold: the int32 rational rewrite where it is exact, else the
    float64 quotient of the two tensors against ``float64(tval)``."""
    if field[2]:
        fn = _ratio_gt_exact if op == 'gt' else _ratio_lt_exact
        return fn(num, den, *field[:2])
    quotient = num.to(torch.float64) / den.to(torch.float64)
    t = float(tval)
    return quotient > t if op == 'gt' else quotient < t


def _int_scalar_lt(band, field, tval):
    """band < tval (float64 semantics) for int32 band values."""
    if field[2]:
        return band * field[1] < field[0]
    bound = int_lt_bound(tval)
    if bound is None:
        return torch.zeros_like(band, dtype=torch.bool)
    return band <= _clip_i32(bound)


def _diag_tests_int(blue, green, red, nir, swir1, swir2,
                    et: ExactThresholds):
    b, g, r, n, s1, s2 = (x.to(_I32) for x in
                          (blue, green, red, nir, swir1, swir2))
    mndwi_num = wrap16(g - s1)
    mndwi_den = wrap16(g + s1)
    mbsrv = wrap16(g + r)
    mbsrn = wrap16(n + s1)
    ndvi_num = wrap16(n - r)
    ndvi_den = wrap16(n + r)
    # AWEsh * 4 is an exact integer: blue + 2.5g - 1.5*mbsrn - 0.25*s2
    awesh4 = 4 * b + 10 * g - 6 * mbsrn - s2

    tv = et.float_values

    def mndwi_gt(name):
        return _int_ratio_test(mndwi_num, mndwi_den, getattr(et, name),
                               getattr(tv, name), 'gt')

    def lt(band, name):
        return _int_scalar_lt(band, getattr(et, name), getattr(tv, name))

    t1 = mndwi_gt('wigt')
    t2 = mbsrv > mbsrn
    if et.awgt[2]:
        p, q = et.awgt[:2]
        t3 = awesh4 * q > 4 * p
    else:
        # awesh = awesh4 / 4 exactly in float64: awesh > t <=> awesh4 > 4t
        bound = int_gt_bound(np.float64(tv.awgt) * 4)
        t3 = (torch.zeros_like(awesh4, dtype=torch.bool) if bound is None
              else awesh4 >= _clip_i32(bound))
    t4 = (mndwi_gt('pswt_1_mndwi') & lt(s1, 'pswt_1_swir1')
          & lt(n, 'pswt_1_nir')
          & _int_ratio_test(ndvi_num, ndvi_den, et.pswt_1_ndvi,
                            tv.pswt_1_ndvi, 'lt'))
    t5 = (mndwi_gt('pswt_2_mndwi') & lt(b, 'pswt_2_blue')
          & lt(s1, 'pswt_2_swir1') & lt(s2, 'pswt_2_swir2')
          & lt(n, 'pswt_2_nir'))
    return t1, t2, t3, t4, t5


def f32(value):
    """A threshold as NumPy float32 compares it with float32 bands."""
    return float(np.float32(value))


def _diag_tests_float(blue, green, red, nir, swir1, swir2,
                      t: HlsThresholds):
    """float32 tests in NumPy's order, one rounding per operation (no
    ``alpha=`` adds, which fuse a multiply into the add)."""
    mndwi = (green - swir1) / (green + swir1)
    ndvi = (nir - red) / (nir + red)
    mbsrv = green + red
    mbsrn = nir + swir1
    awesh = blue + 2.5 * green - 1.5 * mbsrn - 0.25 * swir2
    t1 = mndwi > f32(t.wigt)
    t2 = mbsrv > mbsrn
    t3 = awesh > f32(t.awgt)
    t4 = ((mndwi > f32(t.pswt_1_mndwi)) & (swir1 < f32(t.pswt_1_swir1))
          & (nir < f32(t.pswt_1_nir)) & (ndvi < f32(t.pswt_1_ndvi)))
    t5 = ((mndwi > f32(t.pswt_2_mndwi)) & (blue < f32(t.pswt_2_blue))
          & (swir1 < f32(t.pswt_2_swir1)) & (swir2 < f32(t.pswt_2_swir2))
          & (nir < f32(t.pswt_2_nir)))
    return t1, t2, t3, t4, t5


def compute_diagnostic_tests(blue, green, red, nir, swir1, swir2,
                             hls_thresholds: HlsThresholds):
    """The 5-bit diagnostic layer (decimal representation), as int32.

    The counterpart returns uint16; the values are the same. int16 bands
    take the exact int32 path, float32 bands the float32 one.
    """
    if blue.dtype == torch.int16:
        et = ExactThresholds.from_thresholds(hls_thresholds)
        tests = _diag_tests_int(blue, green, red, nir, swir1, swir2, et)
    elif blue.dtype == torch.float32:
        tests = _diag_tests_float(blue, green, red, nir, swir1, swir2,
                                  hls_thresholds)
    else:
        raise ValueError(f'bands must be int16 or float32, not {blue.dtype}')
    t1, t2, t3, t4, t5 = tests
    return (t1.to(_I32) + (t2.to(_I32) << 1) + (t3.to(_I32) << 2)
            + (t4.to(_I32) << 3) + (t5.to(_I32) << 4))


def get_binary_representation(diagnostic_layer_decimal, nbits=6):
    """DIAG decimal (0..32) -> pseudo-binary decimal-digit representation,
    uint16 (e.g. 0b10110 -> 10110; the fill bit 32 -> 65535)."""
    d = diagnostic_layer_decimal.to(_I32)
    out = torch.zeros_like(d)
    for i in range(min(nbits, 5)):
        out = out + ((d >> i) & 1) * (10 ** i)
    if nbits > 5:
        out = torch.where(((d >> 5) & 1) != 0, 65535, out)
    return out.to(torch.uint16)


# copied from proteus_tpu/models/dswx/diagnostics.py:242-248 (numpy only)
def binary_representation_lut():
    """33-entry uint16 LUT equivalent of get_binary_representation."""
    lut = np.zeros(33, dtype=np.uint16)
    for v in range(32):
        lut[v] = sum(((v >> i) & 1) * 10 ** i for i in range(5))
    lut[32] = 65535
    return lut
