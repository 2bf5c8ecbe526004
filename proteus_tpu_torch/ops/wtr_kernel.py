"""The fused per-pixel DSWx-HLS chain: CUDA kernel K1 and its plain twin.

``wtr_layers`` computes DIAG, WTR-1, WTR-2, WTR, BWTR, CONF, CLOUD and
(optionally) BROWSE in one pass. It replaces the Pallas TPU kernel
``proteus_tpu/ops/pallas/wtr_kernel.py::make_wtr_kernel`` in its integer,
full-output, 'mask'/'ignore' mode (kernel slice K1; the source is
``csrc/wtr_kernel.cu``).

Dispatch follows the tensors' device and nothing else: CUDA tensors launch
the kernel (or raise), CPU tensors run ``wtr_layers_plain``, the plain
PyTorch chain of ``proteus_tpu_torch.models.dswx.chain``. There is no
fallback from the kernel to the plain chain.
"""

import ctypes

import torch

from proteus_tpu_torch.core.unported import COVER_MODE, not_ported
from proteus_tpu_torch.host import ExactThresholds
from proteus_tpu_torch.models.dswx.chain import dswx_chain
from proteus_tpu_torch.models.dswx.diagnostics import exact_pq
from proteus_tpu_torch.models.dswx.masking import lcmask_nir_pq

# kernel launches since the count was last reset (set it to 0 to reset)
LAUNCHES = 0

LAYERS = ('DIAG', 'WTR-1', 'WTR-2', 'WTR', 'BWTR', 'CONF', 'CLOUD')

_PQ_FIELDS = ('wigt', 'awgt', 'pswt_1_mndwi', 'pswt_1_swir1', 'pswt_1_nir',
              'pswt_1_ndvi', 'pswt_2_mndwi', 'pswt_2_blue', 'pswt_2_nir',
              'pswt_2_swir1', 'pswt_2_swir2')


class WtrParams(ctypes.Structure):
    """Mirror of ``struct WtrParams`` in csrc/wtr_kernel.cu."""
    _fields_ = ([(f'{name}_{pq}', ctypes.c_int32)
                 for name in ('wigt', 'awgt', 'p1_mndwi', 'p1_swir1',
                              'p1_nir', 'p1_ndvi', 'p2_mndwi', 'p2_blue',
                              'p2_nir', 'p2_swir1', 'p2_swir2', 'lcmask')
                 for pq in ('p', 'q')]
                + [('aerosol_lut', ctypes.c_uint8 * 256)])


def kernel_params(config):
    """The kernel's thresholds and aerosol LUT for ``config``; raises if a
    threshold is not an exact rational."""
    et = ExactThresholds.from_thresholds(config.thresholds)
    values = []
    for field in _PQ_FIELDS:
        values.extend(exact_pq(getattr(et, field)))
    values.extend(lcmask_nir_pq(config.thresholds.lcmask_nir))
    params = WtrParams(*values)
    params.aerosol_lut[:] = [int(v) for v in config.aerosol_lut()]
    return params


def wtr_layers_plain(blue, green, red, nir, swir1, swir2, fmask, invalid,
                     config, ocean=None, shadow=None, landcover=None,
                     compute_browse=True):
    """The kernel's layers from the plain PyTorch chain (any device)."""
    return dswx_chain(blue, green, red, nir, swir1, swir2, fmask, invalid,
                      config, ocean_mask=ocean, shadow_layer=shadow,
                      landcover_mask=landcover,
                      compute_browse=compute_browse, compute_stats=False)


def wtr_layers(blue, green, red, nir, swir1, swir2, fmask, invalid, config,
               ocean=None, shadow=None, landcover=None, compute_browse=True):
    """DIAG (uint16) and WTR-1, WTR-2, WTR, BWTR, CONF, CLOUD, BROWSE
    (uint8) as a dict; the CUDA kernel for CUDA tensors, the plain chain
    for CPU tensors."""
    device = blue.device
    if device.type == 'cpu':
        return wtr_layers_plain(blue, green, red, nir, swir1, swir2, fmask,
                                invalid, config, ocean, shadow, landcover,
                                compute_browse)
    if device.type != 'cuda':
        raise ValueError(f'wtr_layers: unsupported device {device}')
    return _launch(blue, green, red, nir, swir1, swir2, fmask, invalid,
                   config, ocean, shadow, landcover, compute_browse)


def _check(name, t, dtypes, shape, device):
    if t.device != device:
        raise ValueError(f'wtr_layers: {name} is on {t.device}, not {device}')
    if t.dtype not in dtypes:
        raise ValueError(f'wtr_layers: {name} has dtype {t.dtype}; '
                         f'expected one of {dtypes}')
    if tuple(t.shape) != shape:
        raise ValueError(f'wtr_layers: {name} has shape {tuple(t.shape)}; '
                         f'expected {shape}')
    if not t.is_contiguous():
        raise ValueError(f'wtr_layers: {name} is not contiguous')


def _bind(lib):
    fn = lib.wtr_k1_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([p] * 19 + [ctypes.c_int64, ctypes.POINTER(WtrParams)]
                       + [i] * 11 + [p])
        fn.restype = ctypes.c_int
        lib.wtr_k1_error_string.argtypes = [ctypes.c_int]
        lib.wtr_k1_error_string.restype = ctypes.c_char_p
    return fn


def _launch(blue, green, red, nir, swir1, swir2, fmask, invalid, config,
            ocean, shadow, landcover, compute_browse):
    global LAUNCHES
    from proteus_tpu_torch.ops.build import build

    mode = config.mask_adjacent_to_cloud_mode
    if mode == 'cover':
        raise not_ported(COVER_MODE)
    if mode not in ('mask', 'ignore'):
        raise ValueError(f'ERROR mask adjacent to cloud/cloud-shadow mode:'
                         f' {mode}')
    device = blue.device
    shape = tuple(blue.shape)
    if len(shape) != 2:
        raise ValueError(f'wtr_layers: bands must be (H, W), got {shape}')
    bands = (blue, green, red, nir, swir1, swir2)
    for name, t in zip(('blue', 'green', 'red', 'nir', 'swir1', 'swir2'),
                       bands):
        _check(name, t, (torch.int16,), shape, device)
    _check('fmask', fmask, (torch.uint8,), shape, device)
    _check('invalid', invalid, (torch.bool, torch.uint8), shape, device)
    extras = {'ocean': ocean, 'shadow': shadow, 'landcover': landcover}
    for name, t in extras.items():
        if t is not None:
            _check(name, t, (torch.uint8,), shape, device)
    params = kernel_params(config)

    out = {'DIAG': torch.empty(shape, dtype=torch.uint16, device=device)}
    names = LAYERS[1:] + (('BROWSE',) if compute_browse else ())
    for name in names:
        out[name] = torch.empty(shape, dtype=torch.uint8, device=device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    fn = _bind(build('wtr_kernel').lib)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = fn(*[ptr(t) for t in bands], ptr(fmask), ptr(invalid),
             ptr(ocean), ptr(shadow), ptr(landcover),
             *[ptr(out[k]) for k in LAYERS], ptr(out.get('BROWSE')),
             blue.numel(), ctypes.byref(params),
             int(ocean is not None), int(shadow is not None),
             int(landcover is not None), int(compute_browse),
             int(mode == 'mask'), int(config.apply_aerosol_class_remapping),
             int(config.exclude_psw_aggressive_in_browse),
             int(config.flag_collapse_wtr_classes),
             int(config.not_water_in_browse == 'nodata'),
             int(config.cloud_in_browse == 'nodata'),
             int(config.snow_in_browse == 'nodata'), stream)
    if err:
        msg = build('wtr_kernel').lib.wtr_k1_error_string(err).decode()
        raise RuntimeError(f'wtr_k1_launch failed: CUDA error {err} ({msg})')
    LAUNCHES += 1
    return out
