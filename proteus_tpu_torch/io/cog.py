"""Single-pass cloud-optimized GeoTIFF writer.

The reference produces COGs in three steps — write a plain GTiff, build
overviews, and rewrite through gdal.Translate with COPY_SRC_OVERVIEWS
(reference core.py:7-90). This writer produces the final COG layout
directly:

  header | IFD_main IFD_ovr1..ovrN (+ tag values) | data: ovrN ... ovr1 main

with 512x512 DEFLATE tiles, PREDICTOR 2 for integer / 3 for float data, and
overview decimation factors [4, 16, 64, 128] (NEAREST for integer,
CUBICSPLINE — a cubic B-spline convolution matching GDAL's overview
resampler — for floats, like the reference's core.py:36-45).
Tile compression runs in the native codec (libdeflate) when built, else a
thread pool over the Python codecs.
"""

import copy
import os
import struct
import threading
import xml.sax.saxutils
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from proteus_tpu_torch.io import codecs, tiff
from proteus_tpu_torch.runtime.profiling import COUNTERS, TRACER
from proteus_tpu_torch.version import VERSION

DEFAULT_OVERVIEW_LEVELS = (4, 16, 64, 128)
DEFAULT_TILE_SIZE = 512


def _deflate_level():
    """DEFLATE effort (1=fastest..9/12=smallest); default 1.

    GDAL (and therefore the reference) defaults to 6, but post-predictor
    raster tiles are high-entropy: measured on DSWx layers, level 1 is
    10-25x faster to encode with <=20% size growth (and on the noisy
    uint16 DIAG layer it is *smaller*). Products remain standard DEFLATE
    COGs either way; set PROTEUS_TPU_DEFLATE_LEVEL=6 for GDAL-equivalent
    effort.
    """
    try:
        return int(os.environ.get('PROTEUS_TPU_DEFLATE_LEVEL', '1'))
    except ValueError:
        return 1
SOFTWARE_TAG = f'proteus_tpu {VERSION}'

_DTYPE_TO_SAMPLEFORMAT = {
    'u': tiff.SAMPLEFORMAT_UINT,
    'i': tiff.SAMPLEFORMAT_INT,
    'f': tiff.SAMPLEFORMAT_IEEEFP,
}


def _gdal_metadata_xml(metadata, band_descriptions):
    items = []
    for k, v in (metadata or {}).items():
        items.append('  <Item name="{}">{}</Item>'.format(
            xml.sax.saxutils.escape(str(k), {'"': '&quot;'}),
            xml.sax.saxutils.escape(str(v))))
    for sample, desc in (band_descriptions or {}).items():
        items.append(
            '  <Item name="DESCRIPTION" sample="{}" role="description">{}'
            '</Item>'.format(int(sample),
                             xml.sax.saxutils.escape(str(desc))))
    if not items:
        return None
    return '<GDALMetadata>\n' + '\n'.join(items) + '\n</GDALMetadata>\n'


def _geokey_directory(crs_or_epsg):
    """(GeoKeyDirectory shorts, GeoDoubleParams or None) for an
    EPSG-coded CRS, or a USER-DEFINED one (a `geo.crs.CRS` with
    ``custom`` set: PCS 32767 + projection parameter geokeys, the way
    GDAL encodes non-EPSG SRS)."""
    if crs_or_epsg is None:
        return None, None
    custom = getattr(crs_or_epsg, 'custom', None)
    if custom is None:
        epsg = int(getattr(crs_or_epsg, 'epsg', crs_or_epsg))
        keys = []
        if epsg == 4326 or (4000 <= epsg < 5000):
            keys.append((1024, 0, 1, 2))    # GTModelType: geographic
            keys.append((1025, 0, 1, 1))    # GTRasterType: PixelIsArea
            keys.append((2048, 0, 1, epsg))  # GeographicType
        else:
            keys.append((1024, 0, 1, 1))    # GTModelType: projected
            keys.append((1025, 0, 1, 1))
            keys.append((3072, 0, 1, epsg))  # ProjectedCSType
        doubles = None
    else:
        from proteus_tpu_torch.geo.crs import _ELLIPSOIDS
        fam = custom[0]
        towgs84 = getattr(crs_or_epsg, 'towgs84', None)
        if fam == 'geog':
            # geographic on a classical ellipsoid: user-defined GCS
            a, invf = _ELLIPSOIDS[custom[1]]
            doubles = [float(a), float(invf)]
            keys = [(1024, 0, 1, 2), (1025, 0, 1, 1),
                    (2048, 0, 1, 32767), (2054, 0, 1, 9102),
                    (2057, 34736, 1, 0), (2059, 34736, 1, 1)]
            if towgs84 is not None:
                keys.append((2062, 34736, len(towgs84), 2))
                doubles.extend(float(v) for v in towgs84)
            header = (1, 1, 0, len(keys))
            flat = list(header)
            for k in keys:
                flat.extend(k)
            return tuple(flat), tuple(doubles)
        if fam == 'ps':
            lat_ts, lon0, fe, fn, north, k0, ell = custom[1:]
            params = {3081: (lat_ts if lat_ts is not None
                             else (90.0 if north else -90.0)),
                      3095: lon0, 3082: fe, 3083: fn}
            if k0 is not None:
                params[3092] = k0
            ct = 15
        elif fam == 'tm':
            ell, lat0, lon0, k0, fe, fn = custom[1:]
            params = {3081: lat0, 3080: lon0, 3092: k0,
                      3082: fe, 3083: fn}
            ct = 1
        elif fam == 'aea':
            ell, lat0, lon0, sp1, sp2, fe, fn = custom[1:]
            params = {3078: sp1, 3079: sp2, 3080: lon0, 3081: lat0,
                      3082: fe, 3083: fn}
            ct = 11
        elif fam == 'laea':
            ell, lat0, lon0, fe, fn = custom[1:]
            params = {3080: lon0, 3081: lat0, 3082: fe, 3083: fn}
            ct = 10
        elif fam == 'lcc':
            ell, lat0, lon0, sp1, sp2, fe, fn = custom[1:8]
            params = {3078: sp1, 3079: sp2, 3080: lon0, 3081: lat0,
                      3082: fe, 3083: fn}
            if len(custom) > 8:
                params[3092] = custom[8]
            ct = 8
        elif fam == 'merc':
            ell, lon0, k0, fe, fn = custom[1:]
            params = {3080: lon0, 3092: k0, 3082: fe, 3083: fn}
            ct = 7
        elif fam == 'sinu':
            ell, lon0, fe, fn = custom[1:]
            params = {3088: lon0, 3082: fe, 3083: fn}
            ct = 24
        elif fam == 'cea':
            ell, lat_ts, lon0, fe, fn = custom[1:]
            params = {3078: lat_ts, 3080: lon0, 3082: fe, 3083: fn}
            ct = 28
        elif fam == 'omerc':
            ell, latc, lonc, alpha, gamma, k0, fe, fn, vb = custom[1:]
            params = {3089: latc, 3088: lonc, 3094: alpha,
                      3096: gamma, 3093: k0}
            # azimuth-center variant: false coords at the projection
            # center (3090/3091); variant A at the natural origin
            if vb:
                params[3090], params[3091] = fe, fn
            else:
                params[3082], params[3083] = fe, fn
            ct = 3
        elif fam == 'somerc':
            ell, lat0, lon0, k0, fe, fn = custom[1:]
            params = {3089: lat0, 3088: lon0, 3093: k0,
                      3082: fe, 3083: fn}
            ct = 5   # CT_ObliqueMercator_Rosenmund (Swiss)
        elif fam == 'sterea':
            ell, lat0, lon0, k0, fe, fn = custom[1:]
            params = {3081: lat0, 3080: lon0, 3092: k0,
                      3082: fe, 3083: fn}
            ct = 16  # CT_ObliqueStereographic (double stereographic)
        elif fam == 'eqc':
            ell, lat_ts, lat0, lon0, fe, fn = custom[1:]
            params = {3078: lat_ts, 3089: lat0, 3088: lon0,
                      3082: fe, 3083: fn}
            ct = 17  # CT_Equirectangular
        else:
            raise ValueError(f'unsupported custom CRS family: {fam}')
        from proteus_tpu_torch.geo.crs import _UNIT_GEOKEY
        if isinstance(ell, str):
            a, invf = _ELLIPSOIDS[ell]
        else:               # sphere radius (MODIS sinusoidal)
            a, invf = float(ell), 0.0
        unit = float(getattr(crs_or_epsg, 'unit', 1.0))
        unit_code = next((code for code, factor in _UNIT_GEOKEY.items()
                          if factor == unit), 32767)
        doubles = []
        keys = [(1024, 0, 1, 1), (1025, 0, 1, 1),
                (2048, 0, 1, 32767), (2054, 0, 1, 9102),
                (3072, 0, 1, 32767), (3074, 0, 1, 32767),
                (3075, 0, 1, ct), (3076, 0, 1, unit_code)]
        if unit_code == 32767:  # user-defined: size geokey in metres
            params = dict(params)
            params[3077] = unit
        for key_id, value in sorted({2057: a, 2059: invf,
                                     **params}.items()):
            keys.append((key_id, 34736, 1, len(doubles)))
            doubles.append(float(value))
        if towgs84 is not None:   # GeogTOWGS84GeoKey (GeoTIFF 1.1)
            keys.append((2062, 34736, len(towgs84), len(doubles)))
            doubles.extend(float(v) for v in towgs84)
        keys.sort()
        doubles = tuple(doubles)
    header = (1, 1, 0, len(keys))
    flat = list(header)
    for k in keys:
        flat.extend(k)
    return tuple(flat), doubles


def _nearest_decimate(arr, factor):
    """NEAREST overview: sample the center pixel of each factor x factor
    cell (GDAL picks a representative source pixel per output pixel)."""
    h, w = arr.shape[:2]
    oh = (h + factor - 1) // factor
    ow = (w + factor - 1) // factor
    ri = np.minimum(np.arange(oh) * factor + factor // 2, h - 1)
    ci = np.minimum(np.arange(ow) * factor + factor // 2, w - 1)
    return arr[np.ix_(ri, ci)]


def _bspline_taps(factor):
    """Cubic B-spline kernel taps for decimation by ``factor``.

    Matches GDAL's CUBICSPLINE overview resampler (convolution with the
    cubic B-spline, support |x| < 2 in destination-pixel units, weights
    renormalized by the sum actually used): output pixel j draws from
    source samples i = j*factor + r with x = (r + 0.5 - factor/2)/factor.
    """
    r_lo = int(np.floor(-1.5 * factor - 0.5)) + 1
    r_hi = int(np.ceil(2.5 * factor - 0.5)) - 1
    r = np.arange(r_lo, r_hi + 1)
    x = (r + 0.5 - 0.5 * factor) / factor
    ax = np.abs(x)
    w = np.where(ax < 1, 2.0 / 3.0 - ax ** 2 + ax ** 3 / 2.0,
                 np.where(ax < 2, (2.0 - ax) ** 3 / 6.0, 0.0))
    keep = w > 0
    return r[keep], w[keep]


def _bspline_decimate_axis0(a, factor):
    """Decimate axis 0 by ``factor`` with the cubic B-spline kernel.

    Edge windows are truncated to the valid range and renormalized by the
    participating weight sum (GDAL convolution-resampler behavior).
    """
    n = a.shape[0]
    on = (n + factor - 1) // factor
    taps, weights = _bspline_taps(factor)
    num = np.zeros((on,) + a.shape[1:], dtype=np.float64)
    den = np.zeros((on,) + (1,) * (a.ndim - 1), dtype=np.float64)
    for r, w in zip(taps, weights):
        j0 = max(0, (-r + factor - 1) // factor) if r < 0 else 0
        j1 = min(on - 1, (n - 1 - r) // factor)
        if j1 < j0:
            continue
        src = a[j0 * factor + r: j1 * factor + r + 1: factor]
        num[j0:j1 + 1] += w * src
        den[j0:j1 + 1] += w
    return num / den


def _cubicspline_decimate(arr, factor):
    """CUBICSPLINE overview for float data, separable along both axes
    (reference builds these through GDAL BuildOverviews; core.py:36-45).

    float32 inputs route through the native decimator (tiffturbo) when
    built — bit-identical to the NumPy path below (same float64 tap
    order/renormalization; asserted by tests/test_native.py) and ~5x
    faster, which matters because overview building dominates the float
    COG encode."""
    if arr.dtype == np.float32:
        from proteus_tpu_torch import native
        if native.available():
            try:
                taps, weights = _bspline_taps(factor)
                return native.bspline_decimate_f32(arr, factor, taps,
                                                   weights)
            except RuntimeError:
                pass  # stale library without the symbol: NumPy path
    out = _bspline_decimate_axis0(arr, factor)
    out = np.swapaxes(_bspline_decimate_axis0(
        np.swapaxes(out, 0, 1), factor), 0, 1)
    return np.ascontiguousarray(out).astype(arr.dtype)


class _IfdPlan:
    def __init__(self, array, tile_size, compress, predictor, is_overview):
        self.array = array
        self.tile_size = tile_size
        self.compress = compress
        self.predictor = predictor
        self.is_overview = is_overview
        self.dtype = array.dtype
        self.height, self.width = array.shape[:2]
        self.samples = 1 if array.ndim == 2 else array.shape[2]
        self.tiles_across = (self.width + tile_size - 1) // tile_size
        self.tiles_down = (self.height + tile_size - 1) // tile_size
        self.tile_blobs = None
        self.tile_offsets = None

    def build_tiles(self, pool):
        ts = self.tile_size
        arr = self.array if self.array.ndim == 3 else \
            self.array[:, :, None]
        dtype = arr.dtype

        from proteus_tpu_torch import native
        if (self.compress and native.available()
                and self.predictor in (codecs.PREDICTOR_HORIZONTAL,
                                       codecs.PREDICTOR_FLOAT)
                and dtype.itemsize in (1, 2, 4)):
            # native path: pad into a (n_tiles, ts, ts, s) block and hand
            # the whole pyramid level to the threaded C++ compressor
            n_tiles = self.tiles_down * self.tiles_across
            block = np.zeros((n_tiles, ts, ts, self.samples), dtype=dtype)
            for ty in range(self.tiles_down):
                for tx in range(self.tiles_across):
                    src = arr[ty * ts:(ty + 1) * ts,
                              tx * ts:(tx + 1) * ts, :]
                    block[ty * self.tiles_across + tx, :src.shape[0],
                          :src.shape[1], :] = src
            if self.predictor == codecs.PREDICTOR_FLOAT:
                # the native float predictor splits bytes big-endian;
                # feed native-endian data (it handles the reordering)
                pass
            self.tile_blobs = native.deflate_tiles(
                block, self.predictor, level=_deflate_level())
            return

        def make_tile(ty, tx):
            r0, c0 = ty * ts, tx * ts
            block = np.zeros((ts, ts, self.samples), dtype=dtype)
            src = arr[r0:r0 + ts, c0:c0 + ts, :]
            block[:src.shape[0], :src.shape[1], :] = src
            if self.predictor == codecs.PREDICTOR_HORIZONTAL:
                raw = codecs.predict_horizontal(block).tobytes()
            elif self.predictor == codecs.PREDICTOR_FLOAT:
                be = np.ascontiguousarray(
                    block.astype(dtype.newbyteorder('>'))).tobytes()
                raw = codecs.predict_float(be, ts, ts, self.samples,
                                           dtype.itemsize)
            else:
                raw = block.tobytes()
            return codecs.deflate_encode(raw, _deflate_level()) \
                if self.compress else raw

        jobs = [(ty, tx) for ty in range(self.tiles_down)
                for tx in range(self.tiles_across)]
        self.tile_blobs = list(pool.map(lambda j: make_tile(*j), jobs))


class _PayloadCache:
    """Small LRU of built COG tile payloads (compressed blobs + pyramid
    shapes), keyed by ``payload_cache_key``: a caller-supplied identity
    key plus the shape, dtype and DEFLATE level.

    A campaign writes an IDENTICAL pixel payload for the DEM and LAND
    layers of every revisit of a product grid — the warped DEM and LAND
    are pure functions of (ancillary file signatures, grid), the keys
    parallel/campaign._AncillaryCache uses — while only the per-product
    metadata tags differ between files. Decimation + DEFLATE of the
    float32 DEM is the largest single host encode stage
    (~0.97 core-s/tile at 3660^2, HOST_BUDGET.json); reusing the blobs
    makes it a once-per-grid cost. Entries hold compressed bytes only
    (~10-30 MB per grid). PROTEUS_TPU_COG_PAYLOAD_CACHE caps entries
    (0 keeps none; default 4, matching the ancillary cache).

    Single flight: ``claim`` hands a key's first writer the build (a
    miss); writers that come while it builds wait for it, later ones
    take it (hits). ``COUNTERS`` counts ``cog_payload.miss``, ``.wait``
    and ``.hit``. A build that fails raises in its waiters and leaves
    no entry. With no room every claim builds, and nothing is kept or
    shared."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries = {}
        self._order = []

    @staticmethod
    def max_entries():
        try:
            return int(os.environ.get('PROTEUS_TPU_COG_PAYLOAD_CACHE',
                                      '4'))
        except ValueError:
            return 4

    def claim(self, key):
        """A writer's ``_Claim`` of ``key``'s payload, to be used as a
        context manager; a hit or a wait moves the key to the back of
        the eviction order."""
        cap = self.max_entries()
        with self._lock:
            flight = self._entries.get(key)
            builds = flight is None
            if builds:
                flight = {'done': threading.Event(), 'plans': None,
                          'error': None}
                if cap > 0:
                    self._entries[key] = flight
                    self._order.append(key)
                    while len(self._order) > cap:
                        self._entries.pop(self._order.pop(0))
            else:
                self._order.remove(key)
                self._order.append(key)
            COUNTERS.add('cog_payload.miss' if builds else
                         'cog_payload.hit' if flight['done'].is_set()
                         else 'cog_payload.wait')
        return _Claim(self, key, flight, builds)

    def _fail(self, key, flight, error):
        """End ``flight`` with ``error``: its entry goes and its waiters
        raise it."""
        with self._lock:
            if self._entries.get(key) is flight:
                del self._entries[key]
                self._order.remove(key)
        flight['error'] = error
        flight['done'].set()

    def clear(self):
        with self._lock:
            self._entries.clear()
            self._order.clear()


class _Claim:
    """One writer's hold on a payload of ``_PayloadCache``. ``builds`` is
    True for the writer that makes it: only that writer needs the pixels
    (``plans(make)`` runs ``make()``); any other's ``plans`` waits for
    the builder. Leaving the ``with`` block before the builder's
    ``plans`` has returned, by an exception or otherwise, fails the build
    for its waiters."""

    def __init__(self, cache, key, flight, builds):
        self._cache = cache
        self._key = key
        self._flight = flight
        self.builds = builds

    def __enter__(self):
        return self

    def __exit__(self, kind, error, tb):
        if self.builds and not self._flight['done'].is_set():
            self._cache._fail(self._key, self._flight, error or RuntimeError(
                'the writer that claimed the payload did not build it'))

    def plans(self, make):
        """The payload, as shallow copies of its plans (a write assigns
        its own tile offsets): ``make()``'s where this writer builds it,
        else the builder's, raising the builder's error."""
        flight = self._flight
        if self.builds:
            flight['plans'] = make()
            flight['done'].set()
        else:
            flight['done'].wait()
            if flight['error'] is not None:
                raise flight['error']
        return [copy.copy(p) for p in flight['plans']]


PAYLOAD_CACHE = _PayloadCache()


def payload_cache_key(payload_key, shape, dtype):
    """``PAYLOAD_CACHE``'s key of the payload that ``build_payload``'s
    defaults make of a layer of ``shape`` and numpy ``dtype``, under the
    identity key ``payload_key``. It is formed as ``_samples`` sees the
    array (a plane as one sample, bool as uint8), without its pixels. The
    caller owns key correctness: the same key MUST imply the same array
    bytes."""
    shape = tuple(shape)
    dtype = np.dtype(np.uint8 if np.dtype(dtype) == np.bool_ else dtype)
    return (payload_key, shape + (1,) if len(shape) == 2 else shape,
            dtype.str, _deflate_level())


def _pack_tag(tag, typ, values, extra_area, extra_base):
    """Encode one classic-TIFF IFD entry; long values go to the extra
    area."""
    if typ == tiff.TYPE_ASCII:
        data = values.encode('latin-1') + b'\0'
        n = len(data)
    elif typ == tiff.TYPE_UNDEFINED:
        data = bytes(values)
        n = len(data)
    else:
        fmt = {tiff.TYPE_BYTE: 'B', tiff.TYPE_SHORT: 'H',
               tiff.TYPE_LONG: 'I', tiff.TYPE_DOUBLE: 'd',
               tiff.TYPE_SSHORT: 'h', tiff.TYPE_SLONG: 'i',
               tiff.TYPE_FLOAT: 'f'}[typ]
        vals = tuple(values) if isinstance(values, (tuple, list)) \
            else (values,)
        n = len(vals)
        data = struct.pack('<' + fmt * n, *vals)
    if len(data) <= 4:
        return struct.pack('<HHI', tag, typ, n) + data.ljust(4, b'\0')
    offset = extra_base + len(extra_area)
    extra_area += data
    if len(extra_area) % 2:
        extra_area += b'\0'
    return struct.pack('<HHII', tag, typ, n, offset)


def _samples(array):
    """``array`` as (H, W, S), bool as uint8."""
    array = np.asarray(array)
    arr3 = array[:, :, None] if array.ndim == 2 else array
    if arr3.dtype == np.bool_:
        arr3 = arr3.astype(np.uint8)
    return arr3


@TRACER.traced('cog.payload')
def build_payload(array, overview_levels=DEFAULT_OVERVIEW_LEVELS,
                  tile_size=DEFAULT_TILE_SIZE, compress=True,
                  num_threads=8):
    """The pixel payload of a COG of ``array`` ((H, W) or (H, W, S)): the
    main level and its overview pyramid, each as its tiles after the
    predictor and DEFLATE, and no tag; ``write_payload`` lays it out in a
    file. The build is the tracer's span ``cog.payload``."""
    arr3 = _samples(array)
    h, w = arr3.shape[:2]
    is_float = arr3.dtype.kind == 'f'
    predictor = (codecs.PREDICTOR_FLOAT if is_float
                 else codecs.PREDICTOR_HORIZONTAL) if compress \
        else codecs.PREDICTOR_NONE
    plans = [_IfdPlan(arr3, tile_size, compress, predictor, False)]
    for f in (overview_levels or ()):
        if w // f < 1 or h // f < 1:
            continue
        dec = _cubicspline_decimate(arr3, f) if is_float \
            else _nearest_decimate(arr3, f)
        plans.append(_IfdPlan(dec, tile_size, compress, predictor, True))
    with ThreadPoolExecutor(max_workers=num_threads) as pool:
        for p in plans:
            p.build_tiles(pool)
    for p in plans:
        p.array = None  # layout never reads it; free the pixels
    return plans


@TRACER.traced('cog.encode')
def write_cog(path, array, geotransform=None, epsg=None, nodata=None,
              metadata=None, band_descriptions=None, color_map=None,
              overview_levels=DEFAULT_OVERVIEW_LEVELS,
              tile_size=DEFAULT_TILE_SIZE, compress=True,
              num_threads=8, payload=None):
    """Write ``array`` ((H, W) or (H, W, S)) as a cloud-optimized GeoTIFF.

    color_map: {value: (r, g, b)} for single-band uint8 palette output.
    nodata: numeric or NaN; written as the GDAL_NODATA ASCII tag.
    payload: ``build_payload(array, ...)``, built beforehand (or taken
    from ``PAYLOAD_CACHE``; the tags are this file's); the write
    then only lays it out (its levels, tile size and compression hold),
    and ``array`` may be None.

    The write is the tracer's span ``cog.encode``.
    """
    if payload is None:
        plans = build_payload(array, overview_levels, tile_size, compress,
                              num_threads)
    else:
        if array is not None:
            main, arr3 = payload[0], _samples(array)
            if (main.height, main.width, main.samples, main.dtype) != \
                    (*arr3.shape, arr3.dtype):
                raise ValueError(
                    'write_cog: the payload is not of this array')
        plans = payload
    return write_payload(path, plans, geotransform=geotransform, epsg=epsg,
                         nodata=nodata, metadata=metadata,
                         band_descriptions=band_descriptions,
                         color_map=color_map)


def write_payload(path, plans, geotransform=None, epsg=None, nodata=None,
                  metadata=None, band_descriptions=None, color_map=None):
    """Lay out ``plans`` (a payload: ``build_payload``'s) with their tags
    and write the COG to ``path``; the tags' arguments are
    ``write_cog``'s."""
    dtype = plans[0].dtype
    compress = plans[0].compress

    gdal_meta_xml = _gdal_metadata_xml(metadata, band_descriptions)
    geokeys, geo_doubles = _geokey_directory(epsg)

    # ---- two-pass layout: first compute IFD sizes, then data offsets ----
    def build_ifd(plan, tile_offsets, ifd_offset, next_ifd_offset):
        entries = []
        extra = bytearray()

        def est_extra_base():
            # extra area begins right after the entry table + next pointer
            return ifd_offset + 2 + 12 * n_entries + 4

        # assemble tag list (must be ascending by tag id)
        tags = []
        if plan.is_overview:
            tags.append((tiff.TAG_NEW_SUBFILE_TYPE, tiff.TYPE_LONG, 1))
        tags.append((tiff.TAG_IMAGE_WIDTH, tiff.TYPE_LONG, plan.width))
        tags.append((tiff.TAG_IMAGE_LENGTH, tiff.TYPE_LONG, plan.height))
        tags.append((tiff.TAG_BITS_PER_SAMPLE, tiff.TYPE_SHORT,
                     tuple([dtype.itemsize * 8] * plan.samples)))
        tags.append((tiff.TAG_COMPRESSION, tiff.TYPE_SHORT,
                     tiff_compression))
        tags.append((tiff.TAG_PHOTOMETRIC, tiff.TYPE_SHORT, photometric))
        tags.append((tiff.TAG_SAMPLES_PER_PIXEL, tiff.TYPE_SHORT,
                     plan.samples))
        tags.append((tiff.TAG_PLANAR_CONFIG, tiff.TYPE_SHORT, 1))
        if not plan.is_overview:
            tags.append((tiff.TAG_SOFTWARE, tiff.TYPE_ASCII, SOFTWARE_TAG))
        if compress:
            tags.append((tiff.TAG_PREDICTOR, tiff.TYPE_SHORT,
                         plan.predictor))
        if color_map is not None and not plan.is_overview:
            cm = np.zeros(3 * 256, dtype=np.uint16)
            for v, rgb in color_map.items():
                cm[v], cm[256 + v], cm[512 + v] = \
                    rgb[0] * 257, rgb[1] * 257, rgb[2] * 257
            tags.append((tiff.TAG_COLOR_MAP, tiff.TYPE_SHORT, tuple(cm)))
        tags.append((tiff.TAG_TILE_WIDTH, tiff.TYPE_SHORT, plan.tile_size))
        tags.append((tiff.TAG_TILE_LENGTH, tiff.TYPE_SHORT, plan.tile_size))
        tags.append((tiff.TAG_TILE_OFFSETS, tiff.TYPE_LONG,
                     tuple(tile_offsets)))
        tags.append((tiff.TAG_TILE_BYTE_COUNTS, tiff.TYPE_LONG,
                     tuple(len(b) for b in plan.tile_blobs)))
        tags.append((tiff.TAG_SAMPLE_FORMAT, tiff.TYPE_SHORT,
                     tuple([_DTYPE_TO_SAMPLEFORMAT[dtype.kind]]
                           * plan.samples)))
        if not plan.is_overview:
            if geotransform is not None:
                x0, dx, _, y0, _, dy = geotransform
                tags.append((tiff.TAG_MODEL_PIXEL_SCALE, tiff.TYPE_DOUBLE,
                             (float(dx), float(abs(dy)), 0.0)))
                tags.append((tiff.TAG_MODEL_TIEPOINT, tiff.TYPE_DOUBLE,
                             (0.0, 0.0, 0.0, float(x0), float(y0), 0.0)))
            if geokeys is not None:
                tags.append((tiff.TAG_GEO_KEY_DIRECTORY, tiff.TYPE_SHORT,
                             geokeys))
                if geo_doubles:
                    tags.append((tiff.TAG_GEO_DOUBLE_PARAMS,
                                 tiff.TYPE_DOUBLE, geo_doubles))
            if gdal_meta_xml is not None:
                tags.append((tiff.TAG_GDAL_METADATA, tiff.TYPE_ASCII,
                             gdal_meta_xml))
            if nodata is not None:
                nd = 'nan' if (isinstance(nodata, float)
                               and np.isnan(nodata)) else repr(nodata)
                if isinstance(nodata, (int, np.integer)):
                    nd = str(int(nodata))
                tags.append((tiff.TAG_GDAL_NODATA, tiff.TYPE_ASCII, nd))
        tags.sort(key=lambda t: t[0])
        n_entries = len(tags)
        base = est_extra_base()
        for tag, typ, values in tags:
            entries.append(_pack_tag(tag, typ, values, extra, base))
        body = (struct.pack('<H', n_entries) + b''.join(entries)
                + struct.pack('<I', next_ifd_offset) + bytes(extra))
        return body

    tiff_compression = codecs.COMPRESSION_DEFLATE_ADOBE if compress \
        else codecs.COMPRESSION_NONE
    photometric = tiff.PHOTOMETRIC_PALETTE if color_map is not None \
        else tiff.PHOTOMETRIC_MINISBLACK

    # GDAL "ghost area": hidden structural metadata right after the 8-byte
    # header declaring the cloud-optimized layout, plus per-tile leader
    # (size as uint32 before the data) and trailer (last 4 data bytes
    # repeated after it) ghost bytes. GDAL and the reference's validator
    # (extern/validate_cloud_optimized_geotiff.py:82-95,196-203) recognize
    # and verify these.
    ghost_items = ('LAYOUT=IFDS_BEFORE_DATA\n'
                   'BLOCK_ORDER=ROW_MAJOR\n'
                   'BLOCK_LEADER=SIZE_AS_UINT4\n'
                   'BLOCK_TRAILER=LAST_4_BYTES_REPEATED\n'
                   'KNOWN_INCOMPATIBLE_EDITION=NO\n ')
    ghost = ('GDAL_STRUCTURAL_METADATA_SIZE=%06d bytes\n'
             % len(ghost_items)) + ghost_items
    ghost = ghost.encode('latin1')

    # sizing pass with dummy offsets
    header_size = 8 + len(ghost)
    header_size += header_size % 2  # IFDs start on a 2-byte boundary
    ifd_offsets = []
    pos = header_size
    sizes = []
    for i, p in enumerate(plans):
        dummy = [0] * len(p.tile_blobs)
        body = build_ifd(p, dummy, pos, 0)
        sizes.append(len(body))
        ifd_offsets.append(pos)
        pos += len(body)

    data_start = pos
    # data layout: overviews (smallest first) then main resolution last,
    # row-major within each level; every tile is leader + data + trailer
    data_order = list(range(len(plans) - 1, 0, -1)) + [0]
    offset = data_start
    for i in data_order:
        p = plans[i]
        p.tile_offsets = []
        for blob in p.tile_blobs:
            p.tile_offsets.append(offset + 4)      # points at the data
            offset += 4 + len(blob) + 4            # leader + data + trailer

    # final pass with real offsets
    bodies = []
    for i, p in enumerate(plans):
        next_off = ifd_offsets[i + 1] if i + 1 < len(plans) else 0
        body = build_ifd(p, p.tile_offsets, ifd_offsets[i], next_off)
        assert len(body) == sizes[i], 'IFD size changed between passes'
        bodies.append(body)

    with open(path, 'wb') as fh:
        fh.write(struct.pack('<2sHI', b'II', 42, ifd_offsets[0]))
        fh.write(ghost)
        fh.seek(header_size)
        for body in bodies:
            fh.write(body)
        for i in data_order:
            p = plans[i]
            for off, blob in zip(p.tile_offsets, p.tile_blobs):
                fh.seek(off - 4)
                trailer = blob[-4:] if len(blob) >= 4 \
                    else blob + b'\0' * (4 - len(blob))
                fh.write(struct.pack('<I', len(blob)) + blob + trailer)
    return path


def save_as_cog(filename, scratch_dir='.', logger=None,
                flag_compress=True, ovr_resamp_algorithm=None):
    """Rewrite an existing GeoTIFF in place as a cloud-optimized GeoTIFF.

    Public API matching the reference save_as_cog (core.py:7-90): builds
    overviews [4, 16, 64, 128] (NEAREST for integer data; area-average
    stands in for CUBICSPLINE on floats), 512x512 DEFLATE tiles with the
    dtype-matched predictor, then validates the result.
    """
    import logging as _logging

    from proteus_tpu_torch.io.tiff import TiffReader
    from proteus_tpu_torch.io.validate_cog import validate_cog

    log = logger or _logging.getLogger('proteus')
    log.info(f'saving file as COG: {filename}')
    with TiffReader(filename) as r:
        arr = r.read()
        gt = r.geotransform()
        epsg = r.crs()
        nodata = r.nodata()
        metadata = r.metadata()
        band_desc = r.band_descriptions()
        cmap = r.color_map()
    del scratch_dir, ovr_resamp_algorithm  # single-pass writer
    tmp = filename + '.cog.tmp'
    write_cog(tmp, arr, geotransform=gt, epsg=epsg, nodata=nodata,
              metadata=metadata, band_descriptions=band_desc,
              color_map=cmap, compress=flag_compress)
    import os
    os.replace(tmp, filename)
    errors = validate_cog(filename)
    if errors:
        log.warning(f'    file "{filename}" is NOT a valid cloud'
                    f' optimized GeoTIFF! ({errors[0]})')
    else:
        log.info(f'    file "{filename}" is a valid cloud optimized'
                 ' GeoTIFF')
    return filename
