"""Window-sum decimation and block resampling.

Port of ``proteus_tpu/ops/resample.py``: ``decimate_by_summation``
(``:15-27``), the 3x3 summed decimation of the supersampled WorldCover
masks in the LAND stage, and ``resample_to_30m`` (``:30-61``), the
area-weighted 10 m / 20 m -> 30 m resampling of raw Sentinel-2 band grids
for ``io/hls.py``.
"""

import torch


def decimate_by_summation(image, size_y: int, size_x: int):
    """Sum-decimate a 2-D tensor by (size_y, size_x) windows; the shape
    must be an exact multiple of the window. Sums are int64."""
    h, w = image.shape
    if h % size_y or w % size_x:
        raise ValueError(
            f'decimate_by_summation requires exact multiples, got '
            f'{tuple(image.shape)} with window ({size_y}, {size_x})')
    r = image.reshape(h // size_y, size_y, w // size_x, size_x)
    return r.sum(dim=(1, 3))


def _block_mean(image, size):
    """The float32 mean of each size x size block as XLA evaluates
    ``mean``: the exact sum (int16-range values sum exactly in float32, in
    any order) times the float32 reciprocal of the count, written out as a
    tensor-by-tensor multiply so that the CPU and CUDA give the same
    values. (A division, which both devices round correctly, differs from
    JAX's mean in the last bit for a count of 9; ``np.rint`` of either is
    the same integer, since a sum of integers over 9 is never within 1/18
    of a half.)"""
    h, w = image.shape
    total = image.reshape(h // size, size, w // size, size).sum(dim=(1, 3))
    return total * total.new_tensor(1.0 / (size * size))


def resample_to_30m(band, src_resolution_m: int):
    """Area-weighted resample of a 10 m or 20 m band grid (a 2-D tensor)
    to 30 m, float32; a 30 m band comes back as it is.

    10 m -> 30 m is the 3x3 mean of the whole blocks (trailing rows and
    columns beyond a multiple of 3 are dropped). 20 m -> 30 m: 3 target
    cells cover exactly 2 source cells an axis, so each source pixel is
    repeated 3x and windows of 2 are averaged."""
    if src_resolution_m == 30:
        return band
    if src_resolution_m == 10:
        h, w = band.shape
        h3, w3 = (h // 3) * 3, (w // 3) * 3
        return _block_mean(band[:h3, :w3].to(torch.float32), 3)
    if src_resolution_m == 20:
        rep = band.to(torch.float32).repeat_interleave(3, dim=0) \
            .repeat_interleave(3, dim=1)
        h, w = rep.shape
        h2, w2 = (h // 2) * 2, (w // 2) * 2
        return _block_mean(rep[:h2, :w2], 2)
    raise ValueError(f'unsupported source resolution: {src_resolution_m}')
