"""Host-side derivation of the dependent product layers.

A copy of ``proteus_tpu/models/dswx/host_derive.py`` (numpy only). WTR,
BWTR, CONF, BROWSE, and the DIAG pseudo-binary representation are pure
elementwise functions of (WTR-2, CLOUD, DIAG-decimal). In the campaign's
minimal-transfer mode (kernel slice K5) the device ships only those
independent layers and WTR-1, packed into 2 bytes/px, and the writer pool
derives the rest here: one fused pass of the native codec
(``proteus_tpu_torch.native.unpack_derive``) where it is built, else
vectorized NumPy LUT maps.

Semantics match the reference exactly:
- WTR:   _apply_cloud_masking        dswx_hls.py:2089-2133
- BWTR:  _get_binary_water_layer     dswx_hls.py:1710-1730
- CONF:  _get_confidence_layer       dswx_hls.py:1733-1837
- DIAG:  _get_binary_representation  dswx_hls.py:4286-4317
- BROWSE:_compute_browse_array       dswx_hls.py:3057-3129

These maps duplicate logic that also lives in models/dswx/{masking,
interpretation,browse}.py (torch) and in the CUDA kernel; the campaign
tests (tests/test_torch_campaign.py) hold the three against each other
and against the JAX package.
"""

import numpy as np

from proteus_tpu_torch.core import constants as C
from proteus_tpu_torch.models.dswx.diagnostics import \
    binary_representation_lut


def apply_cloud_masking(wtr2, cloud):
    wtr = wtr2.copy()
    cloudy = (cloud != 0) & (cloud != 8)
    snowy = (cloud == 2) | (cloud == 10)
    wtr[cloudy] = C.WTR_CLOUD_MASKED
    wtr[snowy] = C.WTR_SNOW_MASKED
    wtr[wtr2 == C.WTR_OCEAN_MASKED] = C.WTR_OCEAN_MASKED
    wtr[wtr2 == C.UINT8_FILL_VALUE] = C.UINT8_FILL_VALUE
    return wtr


def binary_water(wtr):
    out = wtr.copy()
    out[(wtr >= 1) & (wtr <= 4)] = C.BWTR_WATER
    return out


def confidence(wtr2, cloud):
    conf = wtr2.copy()
    cloudy = (cloud != 0) & (cloud != 8) & (cloud != 2) & (cloud != 10)
    clear = conf <= 4
    conf[cloudy & clear] += 10
    conf[(cloud == 2) & clear] += 20
    return conf


def diag_binary_representation(diag_decimal_u8):
    """6-bit DIAG decimal (0..31, 32=fill) -> uint16 pseudo-binary."""
    return binary_representation_lut()[diag_decimal_u8]


def browse(wtr, flag_collapse_wtr_classes=True,
           exclude_psw_aggressive=False, set_not_water_to_nodata=False,
           set_cloud_to_nodata=False, set_snow_to_nodata=False,
           set_ocean_masked_to_nodata=True):
    arr = wtr.copy()
    if exclude_psw_aggressive:
        arr[arr == C.WATER_UNCOLLAPSED_PARTIAL_SURFACE_WATER_AGGRESSIVE_CLEAR] = 0
    if flag_collapse_wtr_classes:
        lut = np.arange(256, dtype=np.uint8)
        for k, v in C.COLLAPSE_WTR_CLASSES_DICT.items():
            lut[k] = v
        arr = lut[arr]
    if set_not_water_to_nodata:
        arr[arr == 0] = C.UINT8_FILL_VALUE
    if set_cloud_to_nodata:
        arr[arr == C.WTR_CLOUD_MASKED] = C.UINT8_FILL_VALUE
    if set_snow_to_nodata:
        arr[arr == C.WTR_SNOW_MASKED] = C.UINT8_FILL_VALUE
    if set_ocean_masked_to_nodata:
        arr[arr == C.WTR_OCEAN_MASKED] = C.UINT8_FILL_VALUE
    return arr


# packed-transfer decode: wtr class index (3 bits) -> class value.
# Index 7 is unused by the device packer; map it to fill.
_WTR_IDX_TO_CLASS = np.array([0, 1, 2, 3, 4, C.WTR_OCEAN_MASKED,
                              C.UINT8_FILL_VALUE, C.UINT8_FILL_VALUE],
                             np.uint8)


def unpack_minimal(packed_a, packed_b):
    """Invert the device-side 2-byte/px packing of the minimal layers.

    packed_a = diag6 | (cloud[1:0] << 6)
    packed_b = cloud[3:2] | (wtr1_idx << 2) | (wtr2_idx << 5)

    The CLOUD fill value (255) is reconstructed from the invariant
    cloud == 255 <=> wtr2 == 255 (the kernel sets both from the same
    invalid mask). See parallel/campaign.py::_pack_minimal_device.
    """
    packed_a = np.asarray(packed_a)
    packed_b = np.asarray(packed_b)
    diag6 = (packed_a & 0x3F).astype(np.uint8)
    wtr1 = _WTR_IDX_TO_CLASS[(packed_b >> 2) & 7]
    wtr2 = _WTR_IDX_TO_CLASS[(packed_b >> 5) & 7]
    cloud = ((packed_a >> 6) | ((packed_b & 3) << 2)).astype(np.uint8)
    cloud[wtr2 == C.UINT8_FILL_VALUE] = C.UINT8_FILL_VALUE
    return {'DIAG6': diag6, 'WTR-1': wtr1, 'WTR-2': wtr2, 'CLOUD': cloud}


def unpack_bits(packed, width):
    """Invert pack_bits_device: (h, ceil(w/8)) uint8 -> (h, w) 0/1."""
    return np.unpackbits(np.asarray(packed), axis=1,
                         bitorder='little')[:, :width]


from functools import lru_cache


@lru_cache(maxsize=4)
def _wtr_conf_luts():
    """(wtr2, cloud) -> (WTR, CONF) as 256x256 uint8 tables.

    Built by running the definitional implementations above over the
    full value grid, so the fast path cannot diverge from them; the
    per-tile work collapses from ~15 boolean-mask passes to two 2-D
    gathers.
    """
    g_w2, g_cl = np.meshgrid(np.arange(256, dtype=np.uint8),
                             np.arange(256, dtype=np.uint8),
                             indexing='ij')
    return apply_cloud_masking(g_w2, g_cl), confidence(g_w2, g_cl)


@lru_cache(maxsize=16)
def _derived_256_luts(compute_browse, browse_key):
    """Single-byte LUTs: wtr -> BWTR, and (optionally) wtr -> BROWSE."""
    wtr_vals = np.arange(256, dtype=np.uint8)
    bwtr = binary_water(wtr_vals)
    br = browse(wtr_vals, **dict(browse_key)) if compute_browse else None
    return bwtr, br


def derive_dependent_layers(layers, compute_browse=False,
                            browse_options=None):
    """Fill WTR/BWTR/CONF/DIAG(+BROWSE) from minimal device outputs.

    ``layers`` must contain 'DIAG6' (uint8 decimal), 'WTR-1', 'WTR-2',
    'CLOUD' (or their 2-byte packing 'PACKED_A'/'PACKED_B'); it is
    updated in place and returned. Every derivation is a value-table
    gather; the tables are built from the definitional functions above.
    """
    if 'PACKED_A' in layers:
        from proteus_tpu_torch import native
        if native.has_unpack_derive():
            # fused native pass: one streaming loop over the 2-byte/px
            # transfer emits every layer; the tables are built from the
            # definitional implementations above, so semantics cannot
            # diverge (cross-checked by tests/test_host_derive.py)
            wtr_lut, conf_lut = _wtr_conf_luts()
            bwtr_lut, browse_lut = _derived_256_luts(
                compute_browse,
                tuple(sorted((browse_options or {}).items())))
            layers.update(native.unpack_derive(
                layers.pop('PACKED_A'), layers.pop('PACKED_B'),
                wtr_lut, conf_lut, bwtr_lut,
                browse_lut if compute_browse else None,
                binary_representation_lut(), _WTR_IDX_TO_CLASS))
            return layers
        layers.update(unpack_minimal(layers.pop('PACKED_A'),
                                     layers.pop('PACKED_B')))
    wtr2 = layers['WTR-2']
    cloud = layers['CLOUD']
    wtr_lut, conf_lut = _wtr_conf_luts()
    idx = wtr2.astype(np.int32) << 8
    idx |= cloud
    wtr = wtr_lut.reshape(-1)[idx]
    layers['WTR'] = wtr
    layers['CONF'] = conf_lut.reshape(-1)[idx]
    bwtr_lut, browse_lut = _derived_256_luts(
        compute_browse,
        tuple(sorted((browse_options or {}).items())))
    layers['BWTR'] = bwtr_lut[wtr]
    layers['DIAG'] = diag_binary_representation(layers.pop('DIAG6'))
    if compute_browse:
        layers['BROWSE'] = browse_lut[wtr]
    return layers
