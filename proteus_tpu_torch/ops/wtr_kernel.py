"""The fused per-pixel DSWx-HLS chain: CUDA kernels K1, K2, K3 and their
plain twin.

``wtr_layers`` computes DIAG, WTR-1, WTR-2, WTR, BWTR, CONF, CLOUD and
(optionally) BROWSE. It replaces the Pallas TPU kernel
``proteus_tpu/ops/pallas/wtr_kernel.py::make_wtr_kernel`` with full outputs
(the source is ``csrc/wtr_kernel.cu``):

- K1: int16 bands, 'mask'/'ignore', one per-pixel pass;
- K3: float32 (offset-and-scaled) bands, one per-pixel pass;
- K2: 'cover' mode, K1's or K3's pass up to WTR-2 followed by the tiled
  halo pass of the two masked snow dilations.

Dispatch follows the tensors' device and nothing else: CUDA tensors launch
the kernels (or raise), CPU tensors run ``wtr_layers_plain``, the plain
PyTorch chain of ``proteus_tpu_torch.models.dswx.chain``. There is no
fallback from a kernel to the plain chain.
"""

import ctypes
import functools

import torch

from proteus_tpu_torch.host import ExactThresholds
from proteus_tpu_torch.models.dswx.chain import dswx_chain
from proteus_tpu_torch.models.dswx.diagnostics import exact_pq, f32
from proteus_tpu_torch.models.dswx.masking import lcmask_nir_pq

# launches of each kernel slice since the counts were last reset (set a
# count to 0 to reset it)
LAUNCHES = {'wtr_k1': 0, 'wtr_k2': 0, 'wtr_k3': 0}

LAYERS = ('DIAG', 'WTR-1', 'WTR-2', 'WTR', 'BWTR', 'CONF', 'CLOUD')
MODES = ('mask', 'ignore', 'cover')

_PQ_FIELDS = ('wigt', 'awgt', 'pswt_1_mndwi', 'pswt_1_swir1', 'pswt_1_nir',
              'pswt_1_ndvi', 'pswt_2_mndwi', 'pswt_2_blue', 'pswt_2_nir',
              'pswt_2_swir1', 'pswt_2_swir2', 'lcmask_nir')
_PARAM_NAMES = ('wigt', 'awgt', 'p1_mndwi', 'p1_swir1', 'p1_nir', 'p1_ndvi',
                'p2_mndwi', 'p2_blue', 'p2_nir', 'p2_swir1', 'p2_swir2',
                'lcmask')


class WtrParams(ctypes.Structure):
    """Mirror of ``struct WtrParams`` in csrc/wtr_kernel.cu."""
    _fields_ = ([(f'{name}_{pq}', ctypes.c_int32)
                 for name in _PARAM_NAMES for pq in ('p', 'q')]
                + [('aerosol_lut', ctypes.c_uint8 * 256)])


class WtrParamsF32(ctypes.Structure):
    """Mirror of ``struct WtrParamsF32`` in csrc/wtr_kernel.cu."""
    _fields_ = [(name, ctypes.c_float) for name in _PARAM_NAMES]


class WtrFlags(ctypes.Structure):
    """Mirror of ``struct WtrFlags`` in csrc/wtr_kernel.cu."""
    _fields_ = [(name, ctypes.c_int32) for name in (
        'with_ocean', 'with_shadow', 'with_landcover', 'compute_browse',
        'mask_adjacent', 'apply_aerosol', 'cover', 'exclude_psw_aggressive',
        'collapse', 'not_water_nodata', 'cloud_nodata', 'snow_nodata')]


@functools.lru_cache(maxsize=16)
def kernel_params(config, float_bands=False):
    """The kernels' thresholds for ``config``: ``WtrParams`` (the aerosol
    LUT and, for int16 bands, the exact (p, q) pairs; raises if one is not
    an exact rational) and ``WtrParamsF32`` (for float32 bands, each
    threshold as NumPy's float32). Cached per config: building them takes
    about as long on the host as K1 takes on the card; the launches only
    read them."""
    params = WtrParams()
    params_f32 = WtrParamsF32()
    params.aerosol_lut[:] = [int(v) for v in config.aerosol_lut()]
    t = config.thresholds
    if float_bands:
        for name, field in zip(_PARAM_NAMES, _PQ_FIELDS):
            setattr(params_f32, name, f32(getattr(t, field)))
        return params, params_f32
    et = ExactThresholds.from_thresholds(t)
    for name, field in zip(_PARAM_NAMES, _PQ_FIELDS):
        p, q = (lcmask_nir_pq(t.lcmask_nir) if field == 'lcmask_nir'
                else exact_pq(getattr(et, field)))
        setattr(params, f'{name}_p', p)
        setattr(params, f'{name}_q', q)
    return params, params_f32


def kernel_flags(config, with_ocean, with_shadow, with_landcover,
                 compute_browse):
    mode = config.mask_adjacent_to_cloud_mode
    return WtrFlags(
        int(with_ocean), int(with_shadow), int(with_landcover),
        int(compute_browse), int(mode == 'mask'),
        int(config.apply_aerosol_class_remapping), int(mode == 'cover'),
        int(config.exclude_psw_aggressive_in_browse),
        int(config.flag_collapse_wtr_classes),
        int(config.not_water_in_browse == 'nodata'),
        int(config.cloud_in_browse == 'nodata'),
        int(config.snow_in_browse == 'nodata'))


def kernel_slices(float_bands, mode):
    """The kernel slices a CUDA call launches for int16 or float32
    (``float_bands``) bands in this mode."""
    first = 'wtr_k3' if float_bands else 'wtr_k1'
    return (first, 'wtr_k2') if mode == 'cover' else (first,)


def wtr_layers_plain(blue, green, red, nir, swir1, swir2, fmask, invalid,
                     config, ocean=None, shadow=None, landcover=None,
                     compute_browse=True):
    """The kernels' layers from the plain PyTorch chain (any device)."""
    return dswx_chain(blue, green, red, nir, swir1, swir2, fmask, invalid,
                      config, ocean_mask=ocean, shadow_layer=shadow,
                      landcover_mask=landcover,
                      compute_browse=compute_browse, compute_stats=False)


def wtr_layers(blue, green, red, nir, swir1, swir2, fmask, invalid, config,
               ocean=None, shadow=None, landcover=None, compute_browse=True):
    """DIAG (uint16) and WTR-1, WTR-2, WTR, BWTR, CONF, CLOUD, BROWSE
    (uint8) as a dict; the CUDA kernels for CUDA tensors, the plain chain
    for CPU tensors. Bands are all int16 or all float32."""
    device = blue.device
    if device.type == 'cpu':
        return wtr_layers_plain(blue, green, red, nir, swir1, swir2, fmask,
                                invalid, config, ocean, shadow, landcover,
                                compute_browse)
    if device.type != 'cuda':
        raise ValueError(f'wtr_layers: unsupported device {device}')
    out, state, flags = pixel_pass(blue, green, red, nir, swir1, swir2,
                                   fmask, invalid, config, ocean, shadow,
                                   landcover, compute_browse)
    if state is not None:
        launch_k2(state, out, flags)
    return out


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
    if lib.wtr_pixel_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.wtr_pixel_launch.argtypes = (
            [i] + [p] * 20 + [ctypes.c_int64, ctypes.POINTER(WtrParams),
                              ctypes.POINTER(WtrParamsF32),
                              ctypes.POINTER(WtrFlags), p])
        lib.wtr_pixel_launch.restype = i
        lib.wtr_k2_launch.argtypes = [p] * 7 + [i, i,
                                                ctypes.POINTER(WtrFlags), p]
        lib.wtr_k2_launch.restype = i
        lib.wtr_error_string.argtypes = [i]
        lib.wtr_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, err, what):
    if err:
        msg = lib.wtr_error_string(err).decode()
        raise RuntimeError(f'{what} failed: CUDA error {err} ({msg})')


def _ptr(t):
    return None if t is None else t.data_ptr()


def pixel_pass(blue, green, red, nir, swir1, swir2, fmask, invalid, config,
               ocean=None, shadow=None, landcover=None, compute_browse=True):
    """Launch the per-pixel kernel on CUDA tensors: K1 or K3, or in
    'cover' mode pass A of K2. Returns the layers, the 'cover' state bytes
    (None in the other modes; ``launch_k2`` finishes the layers from them)
    and the launch flags."""
    from proteus_tpu_torch.ops.build import build

    mode = config.mask_adjacent_to_cloud_mode
    if mode not in MODES:
        raise ValueError(f'ERROR mask adjacent to cloud/cloud-shadow mode:'
                         f' {mode}')
    device = blue.device
    shape = tuple(blue.shape)
    if len(shape) != 2:
        raise ValueError(f'wtr_layers: bands must be (H, W), got {shape}')
    if blue.dtype not in (torch.int16, torch.float32):
        raise ValueError(f'wtr_layers: bands must be int16 or float32, '
                         f'not {blue.dtype}')
    bands = (blue, green, red, nir, swir1, swir2)
    for name, t in zip(('blue', 'green', 'red', 'nir', 'swir1', 'swir2'),
                       bands):
        _check(name, t, (blue.dtype,), shape, device)
    _check('fmask', fmask, (torch.uint8,), shape, device)
    _check('invalid', invalid, (torch.bool, torch.uint8), shape, device)
    extras = {'ocean': ocean, 'shadow': shadow, 'landcover': landcover}
    for name, t in extras.items():
        if t is not None:
            _check(name, t, (torch.uint8,), shape, device)
    float_bands = blue.dtype == torch.float32
    params, params_f32 = kernel_params(config, float_bands)
    flags = kernel_flags(config, ocean is not None, shadow is not None,
                         landcover is not None, compute_browse)

    out = {'DIAG': torch.empty(shape, dtype=torch.uint16, device=device)}
    names = LAYERS[1:] + (('BROWSE',) if compute_browse else ())
    for name in names:
        out[name] = torch.empty(shape, dtype=torch.uint8, device=device)
    state = torch.empty(shape, dtype=torch.uint8, device=device) \
        if mode == 'cover' else None

    lib = _bind(build('wtr_kernel').lib)
    stream = torch.cuda.current_stream(device).cuda_stream
    first = kernel_slices(float_bands, mode)[0]
    err = lib.wtr_pixel_launch(
        int(float_bands), *[_ptr(t) for t in bands], _ptr(fmask),
        _ptr(invalid), _ptr(ocean), _ptr(shadow), _ptr(landcover),
        *[_ptr(out[k]) for k in LAYERS], _ptr(out.get('BROWSE')),
        _ptr(state), blue.numel(), ctypes.byref(params),
        ctypes.byref(params_f32), ctypes.byref(flags), stream)
    _raise_on(lib, err, f'{first} launch')
    LAUNCHES[first] += 1
    return out, state, flags


def launch_k2(state, out, flags):
    """Pass B of 'cover' mode (kernel K2): from the per-pixel pass's state
    bytes and WTR-2, write CLOUD, WTR, BWTR, CONF and BROWSE into ``out``
    (CUDA tensors)."""
    from proteus_tpu_torch.ops.build import build
    lib = _bind(build('wtr_kernel').lib)
    height, width = state.shape
    stream = torch.cuda.current_stream(state.device).cuda_stream
    err = lib.wtr_k2_launch(
        _ptr(state), _ptr(out['WTR-2']), _ptr(out['CLOUD']),
        _ptr(out['WTR']), _ptr(out['BWTR']), _ptr(out['CONF']),
        _ptr(out.get('BROWSE')), height, width, ctypes.byref(flags), stream)
    _raise_on(lib, err, 'wtr_k2 launch')
    LAUNCHES['wtr_k2'] += 1
