"""The fused per-pixel DSWx-HLS chain: CUDA kernels K1 to K6 and their
plain twins.

It replaces the Pallas TPU kernel
``proteus_tpu/ops/pallas/wtr_kernel.py::make_wtr_kernel`` (the source is
``csrc/wtr_kernel.cu``). ``wtr_layers`` computes one tile's DIAG, WTR-1,
WTR-2, WTR, BWTR, CONF, CLOUD and (optionally) BROWSE:

- K1: int16 bands, 'mask'/'ignore', one per-pixel pass;
- K3: float32 (offset-and-scaled) bands, one per-pixel pass;
- K2: 'cover' mode, K1's or K3's pass up to WTR-2 followed by the tiled
  halo pass of the two masked snow dilations.

``wtr_layers_batched`` runs a [B, H, W] stack of tiles, the campaign's
step, with the other three slices:

- K4: raw int16 bands with per-tile scales and offsets; the reference's
  cast ``scale * (float32(band) - offset)`` runs inside the kernel before
  K3's body;
- K5: minimal outputs, DIAG6, CLOUD, WTR-1 and WTR-2 packed into the two
  planes PACKED_A and PACKED_B (2 B/px; ``pack_minimal``);
- K6: one launch for the whole stack (and one for K2's pass); with
  ``window``, the spatial launch of a shard (``wtr_k6_spatial``): the
  inputs are a block of tile rows with its halo, the outputs the block's
  window of the shard's own rows.

Every entry point also returns each tile's coverage counts (``COUNTS``:
int64, 0-dim from ``wtr_layers``, [B] from ``wtr_layers_batched``), which
the per-pixel kernel adds up as it goes (``csrc/tile_counts.cuh``); their
plain twin is ``models/dswx/chain.py::coverage_counts``.

Dispatch: CPU tensors run ``wtr_layers_plain`` or
``wtr_layers_batched_plain``, built on the plain PyTorch chain of
``proteus_tpu_torch.models.dswx.chain``; CUDA tensors launch the kernels or
raise, whatever the config: an int16-band threshold that is no exact
rational (which the reference keeps away from its Pallas kernel) reaches
them as an integer bound or, for the ratio tests, as its float64
(``kernel_params``). There is no opt-out on a card: the reference's
``PROTEUS_TPU_USE_PALLAS`` is not read, and the plain chain is what
``device='cpu'`` runs.
"""

import ctypes
import functools

import numpy as np
import torch

from proteus_tpu_torch.core import constants as C
from proteus_tpu_torch.core.f32exact import int_gt_bound, int_lt_bound
from proteus_tpu_torch.core.thresholds import ExactThresholds
from proteus_tpu_torch.models.dswx.chain import coverage_counts, dswx_chain
from proteus_tpu_torch.models.dswx.masking import \
    compute_preliminary_cloud_layer
from proteus_tpu_torch.models.dswx.diagnostics import f32

# launches of each kernel slice since the counts were last reset (set a
# count to 0 to reset it)
LAUNCHES = {f'wtr_k{k}': 0 for k in range(1, 7)}
LAUNCHES['wtr_k6_spatial'] = 0

LAYERS = ('DIAG', 'WTR-1', 'WTR-2', 'WTR', 'BWTR', 'CONF', 'CLOUD')
PACKED = ('PACKED_A', 'PACKED_B')
# the coverage counts of a tile, in the order of the kernel's [B, 3] rows
COUNTS = ('n_valid', 'n_cloud_and_valid', 'n_not_ocean')
MODES = ('mask', 'ignore', 'cover')
BANDS = ('blue', 'green', 'red', 'nir', 'swir1', 'swir2')
MAX_SCALED_BATCH = 1024  # K4 stages 48 B a tile in 48 KB of shared memory
WINDOW_VEC = 4  # pixels a thread of the windowed vector body (kWindowVec)

# HlsThresholds field -> the kernels' name of its test
_RATIO_FIELDS = {'wigt': 'wigt', 'pswt_1_mndwi': 'p1_mndwi',
                 'pswt_1_ndvi': 'p1_ndvi', 'pswt_2_mndwi': 'p2_mndwi'}
_BAND_LT_FIELDS = {'pswt_1_swir1': 'p1_swir1', 'pswt_1_nir': 'p1_nir',
                   'pswt_2_blue': 'p2_blue', 'pswt_2_nir': 'p2_nir',
                   'pswt_2_swir1': 'p2_swir1', 'pswt_2_swir2': 'p2_swir2'}
_F32_FIELDS = dict(_RATIO_FIELDS, awgt='awgt', lcmask_nir='lcmask',
                   **_BAND_LT_FIELDS)
_I32_MIN, _I32_MAX = -2 ** 31, 2 ** 31 - 1


class WtrParams(ctypes.Structure):
    """Mirror of ``struct WtrParams`` in csrc/wtr_kernel.cu."""
    _fields_ = ([(f'{name}_t', ctypes.c_double)
                 for name in _RATIO_FIELDS.values()]
                + [(f'{name}_{pq}', ctypes.c_int32)
                   for name in _RATIO_FIELDS.values() for pq in ('p', 'q')]
                + [('ratio_f64', ctypes.c_int32),
                   ('aerosol_lut', ctypes.c_uint8 * 256)])


class WtrBounds(ctypes.Structure):
    """Mirror of ``struct WtrBounds`` in csrc/wtr_kernel.cu."""
    _fields_ = [(name, ctypes.c_int32) for name in (
        'p1_swir1_le', 'p1_nir_le', 'p2_blue_le', 'p2_nir_le', 'p2_swir1_le',
        'p2_swir2_le', 'awesh4_ge', 'lcmask_ge')]


class WtrParamsF32(ctypes.Structure):
    """Mirror of ``struct WtrParamsF32`` in csrc/wtr_kernel.cu."""
    _fields_ = [(name, ctypes.c_float) for name in (
        'wigt', 'awgt', 'p1_mndwi', 'p1_swir1', 'p1_nir', 'p1_ndvi',
        'p2_mndwi', 'p2_blue', 'p2_nir', 'p2_swir1', 'p2_swir2', 'lcmask')]


class WtrFlags(ctypes.Structure):
    """Mirror of ``struct WtrFlags`` in csrc/wtr_kernel.cu."""
    _fields_ = [(name, ctypes.c_int32) for name in (
        'with_ocean', 'with_shadow', 'with_landcover', 'compute_browse',
        'mask_adjacent', 'apply_aerosol', 'cover', 'exclude_psw_aggressive',
        'collapse', 'not_water_nodata', 'cloud_nodata', 'snow_nodata',
        'minimal', 'ocean_in_valid')]


def _le_bound(field, tval):
    """The int32 B with ``x < t`` == ``x <= B`` for every integer x a band
    can hold: from the exact rational ``field`` = (p, q, exact) of the
    threshold ``tval``, else from its float64; INT32_MIN where the test
    never holds."""
    p, q, exact = field
    bound = (p - 1) // q if exact else int_lt_bound(tval)
    return _I32_MIN if bound is None else max(_I32_MIN, min(_I32_MAX, bound))


def _ge_bound(field, tval, scale=1):
    """The int32 B with ``x > scale * t`` == ``x >= B`` for every integer x
    of the chain (|x| < 2^31 - 1); INT32_MAX where the test never holds."""
    p, q, exact = field
    bound = scale * p // q + 1 if exact \
        else int_gt_bound(np.float64(tval) * scale)
    return _I32_MAX if bound is None else max(_I32_MIN, min(_I32_MAX, bound))


@functools.lru_cache(maxsize=16)
def kernel_params(config, float_bands=False):
    """The kernels' thresholds for ``config``: ``WtrParams`` (the aerosol
    LUT and, for int16 bands, the ratio tests' exact (p, q) pairs or, where
    one of them is no exact rational, ``ratio_f64`` and the four thresholds
    as float64), ``WtrBounds`` (for int16 bands, the band, AWEsh and lcmask
    tests as integer bounds, from the exact rational or the float64
    threshold) and ``WtrParamsF32`` (for float32 bands, each threshold as
    NumPy's float32). Cached per config: building them takes about as long
    on the host as K1 takes on the card; the launches only read them."""
    params = WtrParams()
    bounds = WtrBounds()
    params_f32 = WtrParamsF32()
    params.aerosol_lut[:] = [int(v) for v in config.aerosol_lut()]
    t = config.thresholds
    if float_bands:
        for field, name in _F32_FIELDS.items():
            setattr(params_f32, name, f32(getattr(t, field)))
        return params, bounds, params_f32
    et = ExactThresholds.from_thresholds(t)
    params.ratio_f64 = int(not all(getattr(et, field)[2]
                                   for field in _RATIO_FIELDS))
    for field, name in _RATIO_FIELDS.items():
        p, q, _ = getattr(et, field)
        setattr(params, f'{name}_p', p)
        setattr(params, f'{name}_q', q)
        setattr(params, f'{name}_t', float(getattr(t, field)))
    for field, name in _BAND_LT_FIELDS.items():
        setattr(bounds, f'{name}_le',
                _le_bound(getattr(et, field), getattr(t, field)))
    # awesh = awesh4 / 4 exactly: awesh > t <=> awesh4 > 4 t
    bounds.awesh4_ge = _ge_bound(et.awgt, t.awgt, scale=4)
    bounds.lcmask_ge = _ge_bound(et.lcmask_nir, t.lcmask_nir)
    return params, bounds, params_f32


def _on_cpu(device):
    """Whether a call on ``device`` runs the plain chain: on the CPU, and
    nowhere else."""
    if device.type == 'cpu':
        return True
    if device.type != 'cuda':
        raise ValueError(f'wtr_layers: unsupported device {device}')
    return False


def kernel_flags(config, with_ocean, with_shadow, with_landcover,
                 compute_browse, minimal=False, ocean_in_valid=True):
    mode = config.mask_adjacent_to_cloud_mode
    return WtrFlags(
        int(with_ocean), int(with_shadow), int(with_landcover),
        int(compute_browse and not minimal), int(mode == 'mask'),
        int(config.apply_aerosol_class_remapping), int(mode == 'cover'),
        int(config.exclude_psw_aggressive_in_browse),
        int(config.flag_collapse_wtr_classes),
        int(config.not_water_in_browse == 'nodata'),
        int(config.cloud_in_browse == 'nodata'),
        int(config.snow_in_browse == 'nodata'), int(minimal),
        int(ocean_in_valid))


def kernel_slices(float_bands, mode, device_scale=False, minimal=False,
                  batched=False, windowed=False):
    """The kernel slices a CUDA call launches: float32 (``float_bands``) or
    int16 bands, the mode, and for ``wtr_layers_batched`` (``batched``)
    the device scale, the minimal outputs and a window (``windowed``)."""
    slices = ['wtr_k3' if float_bands or device_scale else 'wtr_k1']
    if mode == 'cover':
        slices.append('wtr_k2')
    if device_scale:
        slices.append('wtr_k4')
    if minimal:
        slices.append('wtr_k5')
    if batched:
        slices.append('wtr_k6')
    if windowed:
        slices.append('wtr_k6_spatial')
    return tuple(slices)


def _diag6(diag):
    """The DIAG pseudo-binary (uint16) as its 6-bit decimal (fill 65535 ->
    32), the field of PACKED_A."""
    d = diag.to(torch.int32)
    bits = sum(((d // 10 ** k) % 10) << k for k in range(5))
    return torch.where(d == 65535, C.DIAGNOSTIC_LAYER_NO_DATA_DECIMAL, bits)


def pack_minimal(out):
    """The plain twin of K5's epilogue (``proteus_tpu/parallel/
    campaign.py::_pack_minimal_device``): a chain's DIAG, CLOUD, WTR-1 and
    WTR-2 packed into two uint8 planes, 2 B/px,

        PACKED_A = diag6 | (cloud & 3) << 6
        PACKED_B = (cloud >> 2) & 3 | widx(WTR-1) << 2 | widx(WTR-2) << 5

    with CLOUD 0 where it is fill (its fill is WTR-2's) and the class index
    widx 0..4, 5 for ocean, 6 for fill. The inverse is
    ``models.dswx.host_derive.unpack_minimal``."""
    cloud = out['CLOUD'].to(torch.int32)
    cloud = torch.where(cloud == C.UINT8_FILL_VALUE, 0, cloud)

    def idx(w):
        w = w.to(torch.int32)
        return torch.where(w == C.WTR_OCEAN_MASKED, 5,
                           torch.where(w == C.UINT8_FILL_VALUE, 6, w))

    pa = _diag6(out['DIAG']) | ((cloud & 3) << 6)
    pb = ((cloud >> 2) & 3) | (idx(out['WTR-1']) << 2) \
        | (idx(out['WTR-2']) << 5)
    return {'PACKED_A': pa.to(torch.uint8), 'PACKED_B': pb.to(torch.uint8)}


def wtr_layers_plain(blue, green, red, nir, swir1, swir2, fmask, invalid,
                     config, ocean=None, shadow=None, landcover=None,
                     compute_browse=True):
    """The kernels' layers and coverage counts from the plain PyTorch
    chain (any device)."""
    return dswx_chain(blue, green, red, nir, swir1, swir2, fmask, invalid,
                      config, ocean_mask=ocean, shadow_layer=shadow,
                      landcover_mask=landcover,
                      compute_browse=compute_browse, compute_stats=True)


def wtr_layers_batched_plain(blue, green, red, nir, swir1, swir2, fmask,
                             invalid, config, scales=None, offsets=None,
                             ocean=None, shadow=None, landcover=None,
                             compute_browse=True, minimal=False,
                             window=None, ocean_in_valid=True):
    """``wtr_layers_batched`` from the plain PyTorch chain (any device):
    per tile, the cast ``scales[j] * (band.float() - offsets[j])`` in
    float32 tensors (with ``scales``), then ``dswx_chain``, then
    ``pack_minimal`` (with ``minimal``); the layers stacked, and with
    ``window`` cropped to its rows. The coverage counts of each tile's
    rows of the window by ``coverage_counts``."""
    row0, rows = _check_window(window or (0, blue.shape[1]), blue.shape[1])
    own = slice(row0, row0 + rows)
    bands = (blue, green, red, nir, swir1, swir2)
    tiles = []
    for k in range(blue.shape[0]):
        tile = [b[k] for b in bands]
        if scales is not None:
            tile = [scales[k, j] * (b.to(torch.float32) - offsets[k, j])
                    for j, b in enumerate(tile)]
        out = dswx_chain(*tile, fmask[k], invalid[k], config,
                         *[None if a is None else a[k] for a in (
                             ocean, shadow, landcover)],
                         compute_browse=compute_browse and not minimal,
                         compute_stats=False)
        if minimal:
            out = pack_minimal(out)
        out = {name: t[own] for name, t in out.items()}
        out.update(coverage_counts(
            invalid[k, own], compute_preliminary_cloud_layer(
                fmask[k, own], config.mask_adjacent_to_cloud_mode),
            None if ocean is None else ocean[k, own], ocean_in_valid))
        tiles.append(out)
    return {name: torch.stack([t[name] for t in tiles])
            for name in tiles[0]}


def wtr_layers(blue, green, red, nir, swir1, swir2, fmask, invalid, config,
               ocean=None, shadow=None, landcover=None, compute_browse=True):
    """DIAG (uint16) and WTR-1, WTR-2, WTR, BWTR, CONF, CLOUD, BROWSE
    (uint8) of one (H, W) tile as a dict, with its coverage counts
    (``COUNTS``, 0-dim int64; valid pixels are not invalid and, with
    ``ocean``, not ocean); the plain chain for CPU tensors, the CUDA
    kernels for CUDA tensors. Bands are all int16 or all float32."""
    if _on_cpu(blue.device):
        return wtr_layers_plain(blue, green, red, nir, swir1, swir2, fmask,
                                invalid, config, ocean, shadow, landcover,
                                compute_browse)
    if blue.dim() != 2:
        raise ValueError(f'wtr_layers: bands must be (H, W), got '
                         f'{tuple(blue.shape)}')

    def one(t):
        return None if t is None else t.unsqueeze(0)
    out, _ = _launch([one(b) for b in (blue, green, red, nir, swir1, swir2)],
                     one(fmask), one(invalid), config, None, None,
                     one(ocean), one(shadow), one(landcover), compute_browse,
                     False, batched=False)
    return {name: t[0] for name, t in out.items()}


def wtr_layers_batched(blue, green, red, nir, swir1, swir2, fmask, invalid,
                       config, scales=None, offsets=None, ocean=None,
                       shadow=None, landcover=None, compute_browse=True,
                       minimal=False, window=None, ocean_in_valid=True):
    """The layers of a [B, H, W] stack of tiles in one launch (K6): full
    outputs as ``wtr_layers`` gives them, stacked, or with ``minimal``
    PACKED_A and PACKED_B (K5). Bands are all int16 or all float32; with
    ``scales`` and ``offsets`` ([B, 6] float32, one row a tile, bands in
    the order blue, green, red, nir, swir1, swir2) they are raw int16 and
    the float32 chain runs on ``scales * (float32(band) - offsets)`` (K4).

    ``window = (row0, rows)``: the inputs are a block of tile rows (a
    shard's rows with their halo) and the outputs are [B, rows, W], the
    layers of block rows row0 .. row0 + rows - 1 (the spatial launch,
    ``wtr_k6_spatial``). Rows beyond the block count as outside the image.

    With the layers, each tile's coverage counts (``COUNTS``, [B] int64)
    over the rows of the window: valid pixels are not invalid and, with
    ``ocean`` and ``ocean_in_valid``, not ocean.

    CPU tensors run ``wtr_layers_batched_plain``; CUDA tensors launch the
    kernels."""
    if _on_cpu(blue.device):
        return wtr_layers_batched_plain(
            blue, green, red, nir, swir1, swir2, fmask, invalid, config,
            scales, offsets, ocean, shadow, landcover, compute_browse,
            minimal, window, ocean_in_valid)
    if blue.dim() != 3:
        raise ValueError(f'wtr_layers_batched: bands must be (B, H, W), '
                         f'got {tuple(blue.shape)}')
    return _launch([blue, green, red, nir, swir1, swir2], fmask, invalid,
                   config, scales, offsets, ocean, shadow, landcover,
                   compute_browse, minimal, batched=True, window=window,
                   ocean_in_valid=ocean_in_valid)[0]


def _check_window(window, height):
    row0, rows = (int(v) for v in window)
    if row0 < 0 or rows < 1 or row0 + rows > height:
        raise ValueError(f'wtr_layers: window of rows {row0} .. '
                         f'{row0 + rows - 1} does not fit a block of '
                         f'{height} rows')
    return row0, rows


def window_body(width, planes):
    """The pixels a thread of the windowed per-pixel launch takes, as
    ``wtr_pixel_launch`` in csrc/wtr_kernel.cu chooses them: 4 where the
    width is a multiple of 4 (a group of 4 then lies in one row, so in one
    tile and on one side of the window's edges) and every plane is aligned
    to its vector of 4 pixels, else 1 (the one-pixel body). ``planes``: the
    (address, itemsize) of every plane the launch reads or writes (int16 or
    float32 bands, DIAG's uint16, the uint8 planes)."""
    if width % WINDOW_VEC:
        return 1
    return WINDOW_VEC if all(address % (WINDOW_VEC * size) == 0
                             for address, size in planes) else 1


def _launch(bands, fmask, invalid, config, scales, offsets, ocean, shadow,
            landcover, compute_browse, minimal, batched, window=None,
            ocean_in_valid=True):
    """The layers and counts of a [B, H, W] stack of CUDA tensors, and the
    pixels a thread of the per-pixel launch took (``pixel_pass``)."""
    out, state, flags, slices, vectorized = pixel_pass(
        *bands, fmask, invalid, config, scales, offsets, ocean, shadow,
        landcover, compute_browse, minimal, batched, window, ocean_in_valid)
    if state is not None:
        launch_k2(state, out, flags, slices,
                  row0=0 if window is None else int(window[0]))
    return out, vectorized


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
            [i] + [p] * 25 + [i] * 5 + [ctypes.POINTER(WtrParams),
                                        ctypes.POINTER(WtrBounds),
                                        ctypes.POINTER(WtrParamsF32),
                                        ctypes.POINTER(WtrFlags),
                                        ctypes.POINTER(i), p])
        lib.wtr_pixel_launch.restype = i
        lib.wtr_k2_launch.argtypes = [p] * 9 + [i] * 5 + [
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


def _count(slices):
    for name in slices:
        LAUNCHES[name] += 1


def pixel_pass(blue, green, red, nir, swir1, swir2, fmask, invalid, config,
               scales=None, offsets=None, ocean=None, shadow=None,
               landcover=None, compute_browse=True, minimal=False,
               batched=True, window=None, ocean_in_valid=True):
    """Launch the per-pixel kernel on a [B, H, W] stack of CUDA tensors:
    K1, K3 or K4, with K5's packed outputs if ``minimal``, or in 'cover'
    mode pass A of K2; with ``window = (row0, rows)`` the layers are the
    [B, rows, W] window of the stack's rows (the state stays [B, H, W]).
    Returns the layers with each tile's coverage counts (``COUNTS``, views
    of the kernel's [B, 3] int64 counters, of the window's rows), the
    'cover' state bytes (None in the other modes;
    ``launch_k2`` finishes the layers from them), the launch flags, the
    slices of the call (``kernel_slices``; K6 with ``batched``, K6 spatial
    with a window) and the pixels a thread of the body that took the launch:
    8 (no window, every plane aligned to its vector), 4 (a window, the
    width a multiple of 4 and every plane aligned: ``window_body``) or 1
    (the one-pixel body alone)."""
    from proteus_tpu_torch.ops.build import build

    mode = config.mask_adjacent_to_cloud_mode
    if mode not in MODES:
        raise ValueError(f'ERROR mask adjacent to cloud/cloud-shadow mode:'
                         f' {mode}')
    device = blue.device
    shape = tuple(blue.shape)
    if len(shape) != 3:
        raise ValueError(f'wtr_layers: bands must be (B, H, W), got {shape}')
    batch = shape[0]
    device_scale = scales is not None
    band_dtypes = (torch.int16,) if device_scale \
        else (torch.int16, torch.float32)
    if blue.dtype not in band_dtypes:
        raise ValueError(f'wtr_layers: bands must be one of {band_dtypes}, '
                         f'not {blue.dtype}')
    for name, t in zip(BANDS, (blue, green, red, nir, swir1, swir2)):
        _check(name, t, (blue.dtype,), shape, device)
    _check('fmask', fmask, (torch.uint8,), shape, device)
    _check('invalid', invalid, (torch.bool, torch.uint8), shape, device)
    if device_scale:
        if batch > MAX_SCALED_BATCH:
            raise ValueError(f'wtr_layers: device scale takes at most '
                             f'{MAX_SCALED_BATCH} tiles a launch, not '
                             f'{batch}')
        for name, t in (('scales', scales), ('offsets', offsets)):
            _check(name, t, (torch.float32,), (batch, 6), device)
    extras = {'ocean': ocean, 'shadow': shadow, 'landcover': landcover}
    for name, t in extras.items():
        if t is not None:
            _check(name, t, (torch.uint8,), shape, device)
    float_bands = blue.dtype == torch.float32 or device_scale
    params, bounds, params_f32 = kernel_params(config, float_bands)
    flags = kernel_flags(config, ocean is not None, shadow is not None,
                         landcover is not None, compute_browse, minimal,
                         ocean_in_valid)

    row0, rows = _check_window(window or (0, shape[1]), shape[1])

    def plane(dtype=torch.uint8, height=rows):
        return torch.empty((batch, height, shape[2]), dtype=dtype,
                           device=device)
    if minimal:
        out = {name: plane() for name in PACKED}
    else:
        out = {'DIAG': plane(torch.uint16)}
        names = LAYERS[1:] + (('BROWSE',) if compute_browse else ())
        out.update({name: plane() for name in names})
    state = plane(height=shape[1]) if mode == 'cover' else None
    # the launch zeroes them on its stream, then adds to them
    counts = torch.empty((batch, len(COUNTS)), dtype=torch.int64,
                         device=device)

    lib = _bind(build('wtr_kernel').lib)
    slices = kernel_slices(float_bands, mode, device_scale, minimal,
                           batched, window is not None)
    band_kind = 2 if device_scale else int(float_bands)
    # the launch goes to the current device and the stream handle is that
    # device's: make the tensors' device current (a campaign spreads its
    # batch over every visible card)
    vectorized = ctypes.c_int(0)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.wtr_pixel_launch(
            band_kind,
            *[_ptr(t) for t in (blue, green, red, nir, swir1, swir2)],
            _ptr(scales), _ptr(offsets), _ptr(fmask), _ptr(invalid),
            _ptr(ocean), _ptr(shadow), _ptr(landcover),
            *[_ptr(out.get(k)) for k in LAYERS + ('BROWSE',) + PACKED],
            _ptr(state), _ptr(counts), batch, shape[1], shape[2], row0, rows,
            ctypes.byref(params), ctypes.byref(bounds),
            ctypes.byref(params_f32),
            ctypes.byref(flags), ctypes.byref(vectorized), stream)
    _raise_on(lib, err, f'{"+".join(slices)} launch')
    _count(s for s in slices if s != 'wtr_k2')
    out.update(zip(COUNTS, counts.unbind(1)))
    return out, state, flags, slices, vectorized.value


def launch_k2(state, out, flags, slices=('wtr_k2',), row0=0):
    """Pass B of 'cover' mode (kernel K2) on a [B, H, W] stack: from the
    per-pixel pass's state bytes and WTR-2, write CLOUD, WTR, BWTR, CONF
    and BROWSE into ``out`` (CUDA tensors), or with the minimal flag OR
    CLOUD into PACKED_A/B; ``out``'s planes are the window of the stack's
    rows from ``row0``. Counts one launch of each of ``slices`` but K1, K3
    and K4 (pass A's)."""
    from proteus_tpu_torch.ops.build import build
    lib = _bind(build('wtr_kernel').lib)
    batch, height, width = state.shape
    rows = out['PACKED_A' if flags.minimal else 'DIAG'].shape[1]
    with torch.cuda.device(state.device):
        stream = torch.cuda.current_stream(state.device).cuda_stream
        err = lib.wtr_k2_launch(
            _ptr(state), *[_ptr(out.get(k)) for k in (
                'WTR-2', 'CLOUD', 'WTR', 'BWTR', 'CONF', 'BROWSE') + PACKED],
            batch, height, width, row0, rows, ctypes.byref(flags), stream)
    _raise_on(lib, err, 'wtr_k2 launch')
    _count(s for s in slices if s not in ('wtr_k1', 'wtr_k3', 'wtr_k4'))
