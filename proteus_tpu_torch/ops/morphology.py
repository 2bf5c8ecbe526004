"""Binary morphology as plain PyTorch stencils.

Port of ``proteus_tpu/ops/morphology.py``: the scipy-compatible masked
cross dilation of the 'cover' cloud-adjacent mode (reference
``scipy.ndimage.binary_dilation`` with ``iterations`` and ``mask``,
dswx_hls.py:2060-2076), the metric-radius ellipse dilation that buffers
the ocean mask's land seaward, and the 3 x 3 square and Euclidean disk
dilations. Values outside the image are 0, as with scipy's
``border_value=0``.
"""

import numpy as np
import torch
import torch.nn.functional as F


def dilate_cross(x):
    """One binary dilation of a bool tensor by the 4-connected cross."""
    out = x.clone()
    out[1:] |= x[:-1]
    out[:-1] |= x[1:]
    out[:, 1:] |= x[:, :-1]
    out[:, :-1] |= x[:, 1:]
    return out


def dilate_square(x):
    """One binary dilation by the 8-connected 3 x 3 square
    (morphology.py:26-36): the row's three neighbours ORed, then the
    column's. Like the reference it ORs in ``x``'s own dtype (bitwise for
    integers)."""
    rows = x.clone()
    rows[:, 1:] |= x[:, :-1]
    rows[:, :-1] |= x[:, 1:]
    out = rows.clone()
    out[1:] |= rows[:-1]
    out[:-1] |= rows[1:]
    return out


def binary_dilation_masked(x, iterations: int, mask=None):
    """``scipy.ndimage.binary_dilation(x, iterations=..., mask=...)``.

    Dilation only grows the foreground, so each step is
    ``cur | (dilate(cur) & mask)``. Returns a bool tensor.
    """
    cur = x.to(torch.bool)
    if mask is not None:
        mask = mask.to(torch.bool)
    for _ in range(max(iterations, 0)):
        grown = dilate_cross(cur)
        cur = grown if mask is None else cur | (grown & mask)
    return cur


def ellipse_spans(margin_m, dy_m, dx_m):
    """{row offset k: horizontal half-span in pixels} of the ellipse
    (k*dy)^2 + (j*dx)^2 <= margin^2, in float64 as the distance transform
    thresholds it (morphology.py:76-87)."""
    dy = abs(float(dy_m))
    dx = abs(float(dx_m))
    r_y = int(np.floor(margin_m / dy))
    spans = {}
    for k in range(-r_y, r_y + 1):
        rem = margin_m ** 2 - (k * dy) ** 2
        spans[k] = int(np.floor(np.sqrt(max(rem, 0.0)) / dx))
    return spans


def dilate_ellipse(land_u8, margin_m: float, dy_m: float, dx_m: float):
    """Dilate a uint8 land mask by a metric-radius ellipse on its device.

    A pixel turns on iff some land pixel lies within
    (k*dy)^2 + (j*dx)^2 <= margin^2: the threshold of scipy's Euclidean
    distance transform with sampling (|dy|, |dx|) at ``margin_m``. One
    horizontal max-pool per distinct span, then one shifted OR per row
    offset. Returns uint8.
    """
    x = land_u8.to(torch.uint8)
    if margin_m <= 0:
        return x
    spans = ellipse_spans(margin_m, dy_m, dx_m)
    h = x.shape[0]
    xf = x.to(torch.float32)[:, None, :]
    hmax = {}
    for s in sorted(set(spans.values())):
        pooled = xf if s == 0 else F.max_pool1d(xf, 2 * s + 1, stride=1,
                                                 padding=s)
        hmax[s] = pooled[:, 0, :] != 0
    out = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    for k, s in spans.items():
        if abs(k) >= h:
            continue
        if k >= 0:
            out[k:] |= hmax[s][:h - k]
        else:
            out[:h + k] |= hmax[s][-k:]
    return out.to(torch.uint8)


def dilate_disk(x, radius_px: float):
    """Binary dilation of a 2-D tensor by a Euclidean disk of
    ``radius_px`` pixels (morphology.py:129-165), as a bool tensor.

    The radius resolves on the host in float64 as the reference does: r =
    floor(radius_px) rows either side, and on row offset dy the half-span
    floor(sqrt(max(radius_px^2 - dy^2, 0))). Where the reference ORs
    2 * span + 1 shifted copies of a row, the run's OR here is the
    difference of two running counts of set pixels along the row, one per
    distinct span, then one shifted OR per row offset.
    """
    r = int(np.floor(radius_px))
    x = x.to(torch.bool)
    if r <= 0:
        return x
    h, w = x.shape
    r2 = radius_px * radius_px
    spans = {dy: int(np.floor(np.sqrt(max(r2 - dy * dy, 0.0))))
             for dy in range(-r, r + 1)}
    # counts[:, big + 1 + j] = the set pixels of x[:, :j + 1]: x sits between
    # columns of zeros, so that both ends of every run are slices
    big = max(spans.values())
    padded = torch.zeros((h, w + 2 * big + 1), dtype=torch.int32,
                         device=x.device)
    padded[:, big + 1:big + 1 + w] = x
    counts = torch.cumsum(padded, 1, dtype=torch.int32)
    out = torch.zeros_like(x)
    for s in sorted(set(spans.values())):
        # the set pixels of x[:, j - s:j + s + 1] are counted
        run = (counts[:, big + 1 + s:big + 1 + s + w]
               > counts[:, big - s:big - s + w])
        for dy in (d for d, span in spans.items() if span == s):
            # output row i ORs the run of input row i + dy
            if abs(dy) >= h:
                continue
            if dy >= 0:
                out[:h - dy] |= run[dy:]
            else:
                out[-dy:] |= run[:h + dy]
    return out
