"""Browse-image PNG generation.

Replaces the reference's gdal.Translate GeoTIFF->PNG path
(dswx_hls.py:2719-2783): reads the palette GeoTIFF browse layer, applies
the RGBA palette (alpha -> PNG transparency), resizes with NEAREST for
integer data, and writes the PNG via PIL.
"""

import logging

import numpy as np
from PIL import Image

from proteus_tpu_torch.io.tiff import TiffReader

logger = logging.getLogger('dswx_hls')


def geotiff2png(src_geotiff_filename, dest_png_filename,
                output_height=None, output_width=None, logger_=None,
                rgba_ctable=None):
    """Convert a (palette) GeoTIFF into a resized PNG browse image."""
    with TiffReader(src_geotiff_filename) as r:
        arr = r.read()
        cmap = r.color_map()
        h, w = arr.shape[:2]

    output_height = output_height or h
    output_width = output_width or w

    if arr.dtype.kind in 'ui' and arr.ndim == 2:
        im = Image.fromarray(arr.astype(np.uint8), mode='P')
        palette = np.zeros((256, 3), dtype=np.uint8)
        alpha = np.full(256, 255, dtype=np.uint8)
        if rgba_ctable:
            for v, rgba in rgba_ctable.items():
                palette[v] = rgba[:3]
                if len(rgba) == 4:
                    alpha[v] = rgba[3]
        elif cmap:
            for v, rgb in cmap.items():
                palette[v] = rgb
        im.putpalette(palette.ravel().tolist())
        im = im.resize((output_width, output_height), Image.NEAREST)
        im.save(dest_png_filename, transparency=bytes(alpha))
    else:
        im = Image.fromarray(arr)
        im = im.resize((output_width, output_height), Image.BICUBIC)
        im.save(dest_png_filename)

    (logger_ or logger).info(
        f'Browse Image PNG created: {dest_png_filename}')
