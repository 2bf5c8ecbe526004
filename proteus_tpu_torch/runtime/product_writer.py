"""DSWx-HLS product writers: per-layer COGs and the combined product.

Matches the reference save family (save_dswx_product/_save_array/
save_cloud_layer/_save_binary_water/_save_output_rgb_file at
dswx_hls.py:2601-3055) — but writes cloud-optimized GeoTIFFs in a single
pass instead of the write-then-rewrite GDAL flow, and validates the COG
structure on write (reference core.py:76-90).
"""

import logging
import os

import numpy as np

from proteus_tpu_torch.core import constants as C
from proteus_tpu_torch.geo.crs import CRS
from proteus_tpu_torch.io.cog import build_payload, write_cog
from proteus_tpu_torch.io.validate_cog import validate_cog
from proteus_tpu_torch.runtime import ctables

logger = logging.getLogger('dswx_hls')


def _makedirs(output_file):
    d = os.path.dirname(output_file)
    if d:
        os.makedirs(d, exist_ok=True)


def _epsg(projection):
    if projection in (None, ''):
        return None
    return CRS.from_any(projection).epsg


def _str_metadata(md):
    return {k: str(v) for k, v in (md or {}).items()}


def _finish(output_file, output_files_list):
    # write-time validation effort: 'full' re-decompresses every tile
    # (reference behavior: --full-check=yes), 'fast' checks structure
    # only, 'off' skips
    mode = os.environ.get('PROTEUS_TPU_COG_VALIDATE', 'full').lower()
    if mode == 'off':
        if output_files_list is not None:
            output_files_list.append(output_file)
        logger.info(f'file saved: {output_file}')
        return
    errors = validate_cog(output_file, full_check=(mode != 'fast'))
    if errors:
        logger.warning(f'    file "{output_file}" is NOT a valid cloud'
                       f' optimized GeoTIFF! ({errors[0]})')
    else:
        logger.info(f'    file "{output_file}" is a valid cloud optimized'
                    ' GeoTIFF')
    if output_files_list is not None:
        output_files_list.append(output_file)
    logger.info(f'file saved: {output_file}')


def collapse_wtr_classes_host(layer):
    """Host-side WTR class collapse (uint8 LUT; native when built)."""
    from proteus_tpu_torch import native
    lut = C.build_collapse_lut()
    layer = np.asarray(layer)
    if layer.dtype == np.uint8:
        out = native.lut8(layer, lut)
        if out is not None:
            return out
    return lut[layer]


def layer_payload(input_array):
    """The COG pixel payload of a layer (``io.cog.build_payload``: the
    overview pyramid and the tiles after the predictor and DEFLATE),
    which ``save_array(..., payload=)`` then lays out with its tags. A
    strided array (a crop) is made contiguous once, not by each level of
    the pyramid."""
    return build_payload(np.ascontiguousarray(input_array))


def save_array(input_array, output_file, dswx_metadata_dict, geotransform,
               projection, description=None, scratch_dir='.',
               output_files_list=None, ctable=None, no_data_value=None,
               payload=None):
    """Save one generic DSWx-HLS layer as a COG.

    payload: ``layer_payload(input_array)``, built beforehand; then
    ``input_array`` may be None."""
    del scratch_dir  # single-pass writer needs no scratch space
    _makedirs(output_file)
    band_desc = {0: description} if description else None
    write_cog(output_file, input_array,
              geotransform=geotransform, epsg=_epsg(projection),
              nodata=no_data_value,
              metadata=_str_metadata(dswx_metadata_dict),
              band_descriptions=band_desc,
              color_map=ctables.to_rgb_map(ctable) if ctable else None,
              payload=payload)
    _finish(output_file, output_files_list)


def save_dswx_product(layer_image, layer_name, output_file,
                      dswx_metadata_dict, geotransform, projection,
                      scratch_dir='.', output_files_list=None,
                      description=None,
                      flag_collapse_wtr_classes=C.FLAG_COLLAPSE_WTR_CLASSES,
                      **dswx_processed_bands):
    """Save an interpreted layer (single band) or the full multi-band
    product, collapsing WTR classes on save."""
    del scratch_dir
    _makedirs(output_file)
    dswx_processed_bands[layer_name.replace('-', '_').lower()] = layer_image

    available = {}
    for key, arr in dswx_processed_bands.items():
        name = key.upper().replace('_', '-')
        if name in C.BAND_DESCRIPTION_DICT and arr is not None:
            available[name] = np.asarray(arr)

    if len(available) == 1:
        name, arr = next(iter(available.items()))
        if name in C.COLLAPSABLE_LAYERS_LIST and flag_collapse_wtr_classes:
            arr = collapse_wtr_classes_host(arr)
        ctable = ctables.get_interpreted_dswx_ctable(
            flag_collapse_wtr_classes, layer_name=name)
        save_array(arr, output_file, dswx_metadata_dict, geotransform,
                   projection,
                   description=description or C.BAND_DESCRIPTION_DICT[name],
                   output_files_list=output_files_list,
                   ctable=ctable, no_data_value=C.UINT8_FILL_VALUE)
        return

    # combined multi-band product: every band as uint8 in canonical order
    # (the reference creates all bands GDT_Byte; dswx_hls.py:2666)
    planes = []
    band_descriptions = {}
    for i, (name, desc) in enumerate(C.BAND_DESCRIPTION_DICT.items()):
        arr = available.get(name)
        if arr is None:
            arr = np.full(layer_image.shape, C.UINT8_FILL_VALUE, np.uint8)
        if name in C.COLLAPSABLE_LAYERS_LIST and flag_collapse_wtr_classes:
            arr = collapse_wtr_classes_host(arr)
        if arr.dtype != np.uint8:
            arr = np.clip(np.nan_to_num(
                arr.astype(np.float64), nan=0.0), 0, 255).astype(np.uint8)
        planes.append(arr)
        band_descriptions[i] = desc
    stack = np.stack(planes, axis=-1)
    write_cog(output_file, stack, geotransform=geotransform,
              epsg=_epsg(projection), nodata=C.UINT8_FILL_VALUE,
              metadata=_str_metadata(dswx_metadata_dict),
              band_descriptions=band_descriptions)
    _finish(output_file, output_files_list)


def save_cloud_layer(mask, output_file, dswx_metadata_dict, geotransform,
                     projection, description=None, scratch_dir='.',
                     output_files_list=None):
    save_array(mask, output_file, dswx_metadata_dict, geotransform,
               projection, description=description,
               output_files_list=output_files_list,
               ctable=ctables.get_cloud_layer_ctable(),
               no_data_value=C.UINT8_FILL_VALUE)


def save_binary_water(binary_water_layer, output_file, dswx_metadata_dict,
                      geotransform, projection, description=None,
                      scratch_dir='.', output_files_list=None):
    save_array(binary_water_layer, output_file, dswx_metadata_dict,
               geotransform, projection, description=description,
               output_files_list=output_files_list,
               ctable=ctables.get_binary_water_ctable(),
               no_data_value=C.UINT8_FILL_VALUE)


# the layers ``save_array`` writes: each one's colour table (a ``ctables``
# getter) and no-data value
_SAVE_ARRAY_LAYERS = {
    'CONF': (ctables.get_confidence_layer_ctable, C.UINT8_FILL_VALUE),
    'DIAG': (None, C.DIAGNOSTIC_LAYER_NO_DATA_BINARY_REPR),
    'LAND': (ctables.get_landcover_mask_ctable,
             C.DSWX_HLS_LANDCOVER_CLASSES_DICT['fill_value']),
    'SHAD': (ctables.get_binary_mask_ctable, None),
    'DEM': (None, np.nan),
}


def save_layer(layer, array, output_file, dswx_metadata_dict, geotransform,
               projection, **kwargs):
    """Save the product layer ``layer`` (a name of
    ``C.BAND_DESCRIPTION_DICT``) as its own COG: WTR, WTR-1 and WTR-2 by
    ``save_dswx_product``, CLOUD by ``save_cloud_layer``, BWTR by
    ``save_binary_water``, the others by ``save_array`` with their colour
    table and no-data value. The save is looked up in this module when it
    is called; ``kwargs`` (``payload=``,
    ``output_files_list=``) pass through."""
    if layer in ('WTR', 'WTR-1', 'WTR-2'):
        save_dswx_product(array, layer, output_file, dswx_metadata_dict,
                          geotransform, projection, **kwargs)
        return
    if layer not in C.BAND_DESCRIPTION_DICT:
        raise ValueError(f'unknown product layer: {layer!r}')
    description = C.BAND_DESCRIPTION_DICT[layer]
    if layer == 'CLOUD':
        save_cloud_layer(array, output_file, dswx_metadata_dict,
                         geotransform, projection, description=description,
                         **kwargs)
    elif layer == 'BWTR':
        save_binary_water(array, output_file, dswx_metadata_dict,
                          geotransform, projection, description=description,
                          **kwargs)
    else:
        ctable, no_data_value = _SAVE_ARRAY_LAYERS[layer]
        save_array(array, output_file, dswx_metadata_dict, geotransform,
                   projection, description=description,
                   ctable=ctable() if ctable else None,
                   no_data_value=no_data_value, **kwargs)


def save_output_rgb_file(red, green, blue, output_file, offset_dict,
                         scale_dict, flag_offset_and_scale_inputs,
                         dswx_metadata_dict, geotransform, projection,
                         invalid_ind=None, scratch_dir='.',
                         output_files_list=None, flag_infrared=False):
    """Save a 3-band float32 reflectance composition (RGB or infrared)."""
    del scratch_dir
    _makedirs(output_file)
    if not flag_offset_and_scale_inputs:
        if not flag_infrared:
            keys = ('red', 'green', 'blue')
        else:
            keys = ('swir1', 'nir', 'red')
        red = scale_dict[keys[0]] * (np.asarray(red, np.float32)
                                     - offset_dict[keys[0]])
        green = scale_dict[keys[1]] * (np.asarray(green, np.float32)
                                       - offset_dict[keys[1]])
        blue = scale_dict[keys[2]] * (np.asarray(blue, np.float32)
                                      - offset_dict[keys[2]])
    else:
        red = np.asarray(red, np.float32).copy()
        green = np.asarray(green, np.float32).copy()
        blue = np.asarray(blue, np.float32).copy()
    if invalid_ind is not None:
        for band in (red, green, blue):
            band[invalid_ind] = np.nan
    stack = np.stack([red, green, blue], axis=-1)
    write_cog(output_file, stack, geotransform=geotransform,
              epsg=_epsg(projection),
              metadata=_str_metadata(dswx_metadata_dict))
    _finish(output_file, output_files_list)
