"""Binary morphology as plain PyTorch stencils.

Port of ``proteus_tpu/ops/morphology.py:19-126``: the scipy-compatible
masked cross dilation of the 'cover' cloud-adjacent mode (reference
``scipy.ndimage.binary_dilation`` with ``iterations`` and ``mask``,
dswx_hls.py:2060-2076), and the metric-radius ellipse dilation that buffers
the ocean mask's land seaward. Values outside the image are 0, as with
scipy's ``border_value=0``.
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
