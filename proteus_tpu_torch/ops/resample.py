"""Window-sum decimation.

Port of ``proteus_tpu/ops/resample.py:15-27`` (``decimate_by_summation``),
the 3x3 summed decimation of the supersampled WorldCover masks in the LAND
stage. ``resample_to_30m`` (raw Sentinel-2 ingest) is not ported yet.
"""


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
