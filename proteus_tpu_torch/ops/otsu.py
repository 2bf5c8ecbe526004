"""Otsu thresholding on the input tensor's device.

Port of ``proteus_tpu/ops/otsu.py:15-41``, which matches the reference
implementation (dswx_hls.py:1638-1684): a 256-bin histogram over [min,
max] (NumPy ``np.histogram`` binning: half-open bins, the last one
closed), the cumulative class weights and means, and the threshold at the
argmax of the inter-class variance, evaluated at the bin midpoints, all in
float32.

Every division is tensor by tensor on the input's device: on CUDA a
Python-scalar (or CPU 0-d tensor) divisor is a multiply by its reciprocal,
which is not IEEE division.
"""

import torch

BINS = 256


def otsu_binarize(image):
    """Return ``image > otsu_threshold(image)`` as a bool tensor.

    The histogram is counted in integers (``torch.bincount``) and cast to
    float32. That equals the reference's float32 scatter-add of ones while
    no bin holds more than 2^24 pixels (a 3760^2 DEM tile has 1.4 x 10^7 in
    all). Past 2^24 a float32 sum of ones no longer counts each pixel, and
    what it reaches depends on its order of summation; the count here is
    exact and rounded once to float32 instead.
    """
    k, bin_mids, _ = threshold_bin(image)
    threshold = bin_mids.index_select(0, k.reshape(1)).reshape(())
    # the comparison's type as JAX promotes it: float32 against any image
    # type but float64
    return image.to(torch.promote_types(image.dtype, torch.float32)) \
        > threshold


def threshold_bin(image):
    """The Otsu threshold's bin of ``image``, as tensors on its device: k
    (0-d int64), the 256 float32 bin midpoints and the float32 histogram;
    the threshold is ``bin_mids[k]``."""
    x = image.to(torch.float32).reshape(-1)
    lo = x.min()
    hi = x.max()
    span = hi - lo
    bins = torch.full((), BINS, dtype=torch.float32, device=x.device)
    # NumPy histogram: idx = (x - lo) / span * bins, last edge inclusive
    idx = torch.floor((x - lo) / torch.where(span == 0, span.new_ones(()),
                                             span) * bins)
    idx = idx.clamp(0, BINS - 1).to(torch.int64)
    hist = torch.bincount(idx, minlength=BINS).to(torch.float32)

    edges = lo + span * torch.arange(BINS + 1, dtype=torch.float32,
                                     device=x.device) / bins
    bin_mids = 0.5 * (edges[:-1] + edges[1:])

    def rev(t):
        return torch.flip(t, (0,))

    weight1 = torch.cumsum(hist, 0)
    weight2 = rev(torch.cumsum(rev(hist), 0))
    mean1 = torch.cumsum(hist * bin_mids, 0) / weight1
    mean2 = rev(torch.cumsum(rev(hist * bin_mids), 0) / rev(weight2))

    diff = mean1[:-1] - mean2[1:]
    inter_class_variance = weight1[:-1] * weight2[1:] * (diff * diff)
    # NaNs (empty classes) lose the argmax; the first maximum wins
    icv = torch.nan_to_num(inter_class_variance, nan=-1.0)
    return torch.argmax(icv), bin_mids, hist
