"""GeoTIFF container: reader (classic + BigTIFF) and COG writer.

This module replaces the GDAL raster I/O the reference is built on
(gdal.Open/ReadAsArray for ingest at dswx_hls.py:2172-2192, driver.Create +
WriteArray for outputs at :2601-3055, and the COG rewrite in core.py:7-90).
It is self-contained: strips and tiles, DEFLATE/LZW/PackBits, predictors
2/3, chunky multi-band interleave, GDAL metadata/nodata/color-table tags,
and GeoTIFF geokeys.

The writer produces cloud-optimized GeoTIFFs directly in one pass — IFDs at
the head of the file, overview data before main-resolution data, 512x512
DEFLATE tiles with the predictor matched to the dtype — i.e. the layout the
reference reaches only by writing a plain GTiff and rewriting it through
gdal.Translate(COPY_SRC_OVERVIEWS=YES).
"""

import struct
import xml.etree.ElementTree as ET

import numpy as np

from proteus_tpu_torch.io import codecs

# --- TIFF tag ids -----------------------------------------------------------
TAG_NEW_SUBFILE_TYPE = 254
TAG_IMAGE_WIDTH = 256
TAG_IMAGE_LENGTH = 257
TAG_BITS_PER_SAMPLE = 258
TAG_COMPRESSION = 259
TAG_PHOTOMETRIC = 262
TAG_IMAGE_DESCRIPTION = 270
TAG_STRIP_OFFSETS = 273
TAG_SAMPLES_PER_PIXEL = 277
TAG_ROWS_PER_STRIP = 278
TAG_STRIP_BYTE_COUNTS = 279
TAG_PLANAR_CONFIG = 284
TAG_SOFTWARE = 305
TAG_PREDICTOR = 317
TAG_COLOR_MAP = 320
TAG_TILE_WIDTH = 322
TAG_TILE_LENGTH = 323
TAG_TILE_OFFSETS = 324
TAG_TILE_BYTE_COUNTS = 325
TAG_SAMPLE_FORMAT = 339
TAG_MODEL_PIXEL_SCALE = 33550
TAG_MODEL_TIEPOINT = 33922
TAG_MODEL_TRANSFORMATION = 34264
TAG_GEO_KEY_DIRECTORY = 34735
TAG_GEO_DOUBLE_PARAMS = 34736
TAG_GEO_ASCII_PARAMS = 34737
TAG_GDAL_METADATA = 42112
TAG_GDAL_NODATA = 42113

# TIFF data types: id -> (struct fmt, size)
_TYPE_FMT = {1: ('B', 1), 2: ('s', 1), 3: ('H', 2), 4: ('I', 4),
             5: ('II', 8), 6: ('b', 1), 7: ('B', 1), 8: ('h', 2),
             9: ('i', 4), 10: ('ii', 8), 11: ('f', 4), 12: ('d', 8),
             16: ('Q', 8), 17: ('q', 8)}

TYPE_BYTE, TYPE_ASCII, TYPE_SHORT, TYPE_LONG = 1, 2, 3, 4
TYPE_RATIONAL, TYPE_SBYTE, TYPE_UNDEFINED, TYPE_SSHORT = 5, 6, 7, 8
TYPE_SLONG, TYPE_SRATIONAL, TYPE_FLOAT, TYPE_DOUBLE = 9, 10, 11, 12
TYPE_LONG8, TYPE_SLONG8 = 16, 17

PHOTOMETRIC_MINISBLACK = 1
PHOTOMETRIC_RGB = 2
PHOTOMETRIC_PALETTE = 3

SAMPLEFORMAT_UINT = 1
SAMPLEFORMAT_INT = 2
SAMPLEFORMAT_IEEEFP = 3


def _np_dtype(bits, sample_format):
    key = (int(bits), int(sample_format))
    table = {(8, 1): np.uint8, (16, 1): np.uint16, (32, 1): np.uint32,
             (8, 2): np.int8, (16, 2): np.int16, (32, 2): np.int32,
             (32, 3): np.float32, (64, 3): np.float64,
             (64, 1): np.uint64, (64, 2): np.int64}
    if key not in table:
        raise ValueError(f'unsupported TIFF sample: {bits} bits '
                         f'format {sample_format}')
    return np.dtype(table[key])


class TiffIFD:
    """One parsed image file directory."""

    def __init__(self, tags, endian):
        self.tags = tags            # tag id -> tuple of values (or bytes)
        self.endian = endian
        self.file_offset = None     # byte position of this IFD (set by
        # the reader; GDAL exposes it as the 'IFD_OFFSET' TIFF item)

    def get(self, tag, default=None):
        return self.tags.get(tag, default)

    def scalar(self, tag, default=None):
        v = self.tags.get(tag)
        if v is None:
            return default
        if isinstance(v, (bytes, str)):
            return v
        return v[0]

    @property
    def width(self):
        return int(self.scalar(TAG_IMAGE_WIDTH))

    @property
    def length(self):
        return int(self.scalar(TAG_IMAGE_LENGTH))

    @property
    def samples_per_pixel(self):
        return int(self.scalar(TAG_SAMPLES_PER_PIXEL, 1))

    @property
    def dtype(self):
        bits = self.scalar(TAG_BITS_PER_SAMPLE, 1)
        fmt = self.scalar(TAG_SAMPLE_FORMAT, SAMPLEFORMAT_UINT)
        return _np_dtype(bits, fmt)

    @property
    def is_tiled(self):
        return TAG_TILE_OFFSETS in self.tags

    @property
    def is_reduced_image(self):
        return bool(int(self.scalar(TAG_NEW_SUBFILE_TYPE, 0)) & 1)

    @property
    def compression(self):
        return int(self.scalar(TAG_COMPRESSION, 1))

    @property
    def predictor(self):
        return int(self.scalar(TAG_PREDICTOR, 1))


def _parse_gdal_metadata(xml_text):
    """Parse the GDAL_METADATA XML tag into (dataset metadata dict,
    per-band role dicts)."""
    meta = {}
    band_meta = {}
    try:
        root = ET.fromstring(xml_text)
    except ET.ParseError:
        return meta, band_meta
    for item in root.findall('Item'):
        name = item.get('name')
        value = item.text or ''
        sample = item.get('sample')
        role = item.get('role')
        if sample is not None:
            band_meta.setdefault(int(sample), {})[role or name] = value
        elif name:
            meta[name] = value
    return meta, band_meta


class TiffReader:
    """Random-access GeoTIFF reader with window support.

    API intentionally mirrors the subset of the GDAL Dataset/Band API the
    reference relies on (GetGeoTransform/GetMetadata/ReadAsArray/
    GetNoDataValue).
    """

    def __init__(self, path):
        self.path = path
        self._fh = open(path, 'rb')
        header = self._fh.read(16)
        if header[:2] == b'II':
            self.endian = '<'
        elif header[:2] == b'MM':
            self.endian = '>'
        else:
            raise ValueError(f'not a TIFF file: {path}')
        magic = struct.unpack(self.endian + 'H', header[2:4])[0]
        if magic == 42:
            self.bigtiff = False
            first_ifd = struct.unpack(self.endian + 'I', header[4:8])[0]
        elif magic == 43:
            self.bigtiff = True
            offsize, zero = struct.unpack(self.endian + 'HH', header[4:8])
            if offsize != 8 or zero != 0:
                raise ValueError('malformed BigTIFF header')
            first_ifd = struct.unpack(self.endian + 'Q', header[8:16])[0]
        else:
            raise ValueError(f'bad TIFF magic: {magic}')

        self.ifds = []
        offset = first_ifd
        seen = set()
        while offset and offset not in seen:
            seen.add(offset)
            this_offset = offset
            ifd, offset = self._read_ifd(offset)
            ifd.file_offset = this_offset
            self.ifds.append(ifd)

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- IFD parsing --------------------------------------------------------

    def _read_ifd(self, offset):
        e = self.endian
        fh = self._fh
        fh.seek(offset)
        if self.bigtiff:
            count = struct.unpack(e + 'Q', fh.read(8))[0]
            entry_size, entry_fmt = 20, e + 'HHQ'
            inline_size = 8
        else:
            count = struct.unpack(e + 'H', fh.read(2))[0]
            entry_size, entry_fmt = 12, e + 'HHI'
            inline_size = 4
        raw = fh.read(count * entry_size)
        tags = {}
        deferred = []
        for i in range(count):
            ent = raw[i * entry_size:(i + 1) * entry_size]
            tag, typ, n = struct.unpack(entry_fmt, ent[:entry_size -
                                                       inline_size])
            value_bytes = ent[entry_size - inline_size:]
            if typ not in _TYPE_FMT:
                continue
            fmt, size = _TYPE_FMT[typ]
            total = size * n
            if total <= inline_size:
                tags[tag] = self._decode_values(typ, n, value_bytes[:total])
            else:
                off_fmt = 'Q' if self.bigtiff else 'I'
                data_offset = struct.unpack(e + off_fmt, value_bytes)[0]
                deferred.append((tag, typ, n, data_offset, total))
        for tag, typ, n, data_offset, total in deferred:
            fh.seek(data_offset)
            tags[tag] = self._decode_values(typ, n, fh.read(total))
        next_fmt = 'Q' if self.bigtiff else 'I'
        fh.seek(offset + (8 if self.bigtiff else 2) + count * entry_size)
        next_off = struct.unpack(e + next_fmt, fh.read(8 if self.bigtiff
                                                       else 4))[0]
        return TiffIFD(tags, e), next_off

    def _decode_values(self, typ, n, data):
        e = self.endian
        if typ == TYPE_ASCII:
            return data.rstrip(b'\0').decode('latin-1')
        if typ == TYPE_UNDEFINED:
            return data
        fmt, size = _TYPE_FMT[typ]
        if typ in (TYPE_RATIONAL, TYPE_SRATIONAL):
            sub = 'I' if typ == TYPE_RATIONAL else 'i'
            vals = struct.unpack(e + sub * (2 * n), data)
            return tuple(vals[2 * i] / (vals[2 * i + 1] or 1)
                         for i in range(n))
        return struct.unpack(e + fmt * n, data)

    # -- dataset-level accessors --------------------------------------------

    @property
    def main(self):
        return self.ifds[0]

    @property
    def overviews(self):
        return [i for i in self.ifds[1:] if i.is_reduced_image]

    @property
    def width(self):
        return self.main.width

    @property
    def length(self):
        return self.main.length

    @property
    def count(self):
        return self.main.samples_per_pixel

    @property
    def dtype(self):
        return self.main.dtype

    def geotransform(self):
        """GDAL-style geotransform (x0, dx, 0, y0, 0, dy)."""
        ifd = self.main
        xf = ifd.get(TAG_MODEL_TRANSFORMATION)
        if xf is not None and len(xf) >= 16:
            return (xf[3], xf[0], xf[1], xf[7], xf[4], xf[5])
        scale = ifd.get(TAG_MODEL_PIXEL_SCALE)
        tie = ifd.get(TAG_MODEL_TIEPOINT)
        if scale is None or tie is None:
            return (0.0, 1.0, 0.0, 0.0, 0.0, 1.0)
        i, j, _, x, y, _ = tie[:6]
        sx, sy = scale[0], scale[1]
        return (x - i * sx, sx, 0.0, y + j * sy, 0.0, -sy)

    def nodata(self):
        v = self.main.get(TAG_GDAL_NODATA)
        if v is None:
            return None
        try:
            return float(str(v).strip())
        except ValueError:
            return None

    def metadata(self):
        xml_text = self.main.get(TAG_GDAL_METADATA)
        if not xml_text:
            return {}
        return _parse_gdal_metadata(xml_text)[0]

    def band_descriptions(self):
        xml_text = self.main.get(TAG_GDAL_METADATA)
        if not xml_text:
            return {}
        band = _parse_gdal_metadata(xml_text)[1]
        return {s: d.get('description') for s, d in band.items()
                if 'description' in d}

    def color_map(self):
        """Return {value: (r, g, b)} with 8-bit components, or None."""
        cm = self.main.get(TAG_COLOR_MAP)
        if cm is None:
            return None
        n = len(cm) // 3
        out = {}
        for i in range(n):
            r, g, b = cm[i], cm[n + i], cm[2 * n + i]
            out[i] = (r // 257, g // 257, b // 257)
        return out

    def geokeys(self):
        """Parse the GeoKeyDirectory into {key_id: value}."""
        kd = self.main.get(TAG_GEO_KEY_DIRECTORY)
        if not kd:
            return {}
        doubles = self.main.get(TAG_GEO_DOUBLE_PARAMS, ())
        asciis = self.main.get(TAG_GEO_ASCII_PARAMS, '')
        nkeys = kd[3]
        out = {}
        for i in range(nkeys):
            key_id, loc, cnt, val = kd[4 + 4 * i: 8 + 4 * i]
            if loc == 0:
                out[key_id] = val
            elif loc == TAG_GEO_DOUBLE_PARAMS:
                out[key_id] = doubles[val] if cnt == 1 else \
                    tuple(doubles[val:val + cnt])
            elif loc == TAG_GEO_ASCII_PARAMS:
                out[key_id] = asciis[val:val + cnt].rstrip('|')
        return out

    def epsg(self):
        """EPSG code from geokeys (projected CS preferred)."""
        keys = self.geokeys()
        pcs = keys.get(3072)
        if pcs and pcs not in (32767,):
            return int(pcs)
        gcs = keys.get(2048)
        if gcs and gcs not in (32767,):
            return int(gcs)
        return None

    def crs(self):
        """CRS from geokeys — EPSG-coded, or USER-DEFINED (PCS 32767
        with projection parameter geokeys, the GDAL encoding of a
        non-EPSG SRS). Returns None when the file carries no geokeys."""
        from proteus_tpu_torch.geo.crs import CRS
        keys = self.geokeys()
        if not keys:
            return None
        # a user-defined PROJECTED CS (PCS 32767) must go through the
        # parameter geokeys even when the base GCS is a known EPSG code
        # (GDAL writes e.g. 2048=4269 for a NAD83-based custom LCC) —
        # epsg()'s GCS fallback would misread the file as geographic
        if keys.get(3072) == 32767:
            return CRS.from_geokeys(keys)
        code = self.epsg()
        if code:
            return CRS.from_epsg(code)
        return CRS.from_geokeys(keys)

    # -- pixel access --------------------------------------------------------

    def read(self, ifd_index=0, window=None, band=None):
        """Read pixels. window=(row0, col0, height, width). Returns (H, W)
        for single-band files (or when ``band`` is given), else (H, W, S)."""
        ifd = self.ifds[ifd_index]
        h, w = ifd.length, ifd.width
        spp = ifd.samples_per_pixel
        dtype = ifd.dtype
        if window is None:
            window = (0, 0, h, w)
        r0, c0, wh, ww = window
        r0 = max(0, r0)
        c0 = max(0, c0)
        wh = min(wh, h - r0)
        ww = min(ww, w - c0)
        out = np.zeros((wh, ww, spp), dtype=dtype)

        planar = int(ifd.scalar(TAG_PLANAR_CONFIG, 1))
        if ifd.is_tiled:
            tw = int(ifd.scalar(TAG_TILE_WIDTH))
            tl = int(ifd.scalar(TAG_TILE_LENGTH))
            offsets = ifd.get(TAG_TILE_OFFSETS)
            counts = ifd.get(TAG_TILE_BYTE_COUNTS)
            tiles_across = (w + tw - 1) // tw
            tiles_down = (h + tl - 1) // tl
            planes = spp if planar == 2 else 1
            spp_block = 1 if planar == 2 else spp
            jobs = []
            for plane in range(planes):
                for ty in range(r0 // tl, (r0 + wh - 1) // tl + 1):
                    if ty >= tiles_down:
                        continue
                    for tx in range(c0 // tw, (c0 + ww - 1) // tw + 1):
                        if tx >= tiles_across:
                            continue
                        idx = (plane * tiles_down * tiles_across
                               + ty * tiles_across + tx)
                        jobs.append((idx, ty, tx, plane))
            # raw bytes serially (one file handle), decode in parallel
            # (zlib / the native codec release the GIL)
            raws = []
            for idx, ty, tx, plane in jobs:
                self._fh.seek(offsets[idx])
                raws.append(self._fh.read(counts[idx]))

            if planar == 1 and self._native_decode_ok(ifd, dtype):
                # one native call: threaded inflate + predictor
                # inversion + scatter straight into `out`
                self._native_decode(
                    ifd, raws, [tl] * len(jobs), tw,
                    [j[1] * tl for j in jobs], [j[2] * tw for j in jobs],
                    spp, dtype, out, r0, c0)
                if band is not None:
                    return out[:, :, band]
                return out[:, :, 0] if spp == 1 else out

            def decode(raw):
                return self._decode_block(ifd, raw, tl, tw, spp_block,
                                          dtype)

            if len(jobs) >= 8:
                from concurrent.futures import ThreadPoolExecutor
                import os as _os
                workers = min(8, _os.cpu_count() or 1)
                if workers > 1:
                    with ThreadPoolExecutor(workers) as pool:
                        blocks = list(pool.map(decode, raws))
                else:
                    blocks = [decode(r) for r in raws]
            else:
                blocks = [decode(r) for r in raws]
            for (idx, ty, tx, plane), block in zip(jobs, blocks):
                self._blit(out, block, ty * tl, tx * tw, r0, c0, wh, ww,
                           plane if planar == 2 else None)
        else:
            rps = int(ifd.scalar(TAG_ROWS_PER_STRIP, h))
            offsets = ifd.get(TAG_STRIP_OFFSETS)
            counts = ifd.get(TAG_STRIP_BYTE_COUNTS)
            strips_down = (h + rps - 1) // rps
            planes = spp if planar == 2 else 1
            spp_block = 1 if planar == 2 else spp
            if planar == 1 and self._native_decode_ok(ifd, dtype):
                jobs = [sy for sy in range(r0 // rps,
                                           (r0 + wh - 1) // rps + 1)
                        if sy < strips_down]
                raws = []
                for sy in jobs:
                    self._fh.seek(offsets[sy])
                    raws.append(self._fh.read(counts[sy]))
                self._native_decode(
                    ifd, raws, [min(rps, h - sy * rps) for sy in jobs],
                    w, [sy * rps for sy in jobs], [0] * len(jobs),
                    spp, dtype, out, r0, c0)
                if band is not None:
                    return out[:, :, band]
                return out[:, :, 0] if spp == 1 else out
            for plane in range(planes):
                for sy in range(r0 // rps, (r0 + wh - 1) // rps + 1):
                    if sy >= strips_down:
                        continue
                    rows = min(rps, h - sy * rps)
                    idx = plane * strips_down + sy
                    block = self._read_block(ifd, offsets[idx], counts[idx],
                                             rows, w, spp_block, dtype)
                    self._blit(out, block, sy * rps, 0, r0, c0, wh, ww,
                               plane if planar == 2 else None)

        if band is not None:
            return out[:, :, band]
        if spp == 1:
            return out[:, :, 0]
        return out

    def _native_decode_ok(self, ifd, dtype):
        """Whether tt_decode_blocks can serve this read: native-LE file,
        supported compression, predictor expressible natively (the
        horizontal predictor kernel handles 1/2/4-byte samples)."""
        from proteus_tpu_torch import native
        if self.endian != '<' or not native.has_decode_blocks():
            return False
        if ifd.compression not in (codecs.COMPRESSION_NONE,
                                   codecs.COMPRESSION_LZW,
                                   codecs.COMPRESSION_DEFLATE,
                                   codecs.COMPRESSION_DEFLATE_ADOBE):
            return False
        pred = ifd.predictor
        if pred == codecs.PREDICTOR_HORIZONTAL:
            return dtype.itemsize in (1, 2, 4)
        return pred in (codecs.PREDICTOR_NONE, codecs.PREDICTOR_FLOAT)

    def _native_decode(self, ifd, raws, blk_rows, block_cols, blk_row0,
                       blk_col0, spp, dtype, out, r0, c0):
        """Decode all blocks of one read in a single native call
        (threaded inflate + unpredict + scatter into ``out``)."""
        from proteus_tpu_torch import native
        offs = np.zeros(len(raws), np.int64)
        sizes = np.asarray([len(r) for r in raws], np.int64)
        if len(raws) > 1:
            np.cumsum(sizes[:-1], out=offs[1:])
        native.decode_blocks(
            b''.join(raws), offs, sizes, blk_rows, block_cols,
            blk_row0, blk_col0, spp, dtype.itemsize, ifd.compression,
            ifd.predictor, out, r0, c0)

    def _read_block(self, ifd, offset, count, rows, cols, spp, dtype):
        self._fh.seek(offset)
        raw = self._fh.read(count)
        return self._decode_block(ifd, raw, rows, cols, spp, dtype)

    def _decode_block(self, ifd, raw, rows, cols, spp, dtype):
        pred = ifd.predictor
        itemsize = dtype.itemsize
        expected = rows * cols * spp * itemsize
        if not raw:
            # sparse block (offset/count 0): implicit zeros (GDAL
            # SPARSE_OK convention)
            return np.zeros((rows, cols, spp), dtype=dtype)
        raw = codecs.decode_block(ifd.compression, raw, expected)
        if len(raw) < expected:
            raw = raw + b'\0' * (expected - len(raw))
        if pred == codecs.PREDICTOR_FLOAT:
            raw = codecs.unpredict_float(raw[:expected], rows, cols, spp,
                                         itemsize)
            arr = np.frombuffer(raw, dtype=dtype.newbyteorder('>')) \
                .astype(dtype)
            return arr.reshape(rows, cols, spp)
        arr = np.frombuffer(raw[:expected],
                            dtype=dtype.newbyteorder(self.endian))
        arr = arr.reshape(rows, cols, spp)
        if pred == codecs.PREDICTOR_HORIZONTAL:
            from proteus_tpu_torch import native
            if (self.endian == '<' and native.available()
                    and itemsize in (1, 2, 4)):
                import ctypes
                arr = arr.copy()  # frombuffer views are read-only
                native._load().tt_unpredict_h(
                    arr.ctypes.data_as(ctypes.c_void_p),
                    rows, cols, spp, itemsize)
            else:
                arr = codecs.unpredict_horizontal(arr, spp)
        if self.endian == '>':
            arr = arr.astype(dtype)
        return arr

    @staticmethod
    def _blit(out, block, block_r, block_c, r0, c0, wh, ww, plane):
        br0 = max(r0, block_r)
        bc0 = max(c0, block_c)
        br1 = min(r0 + wh, block_r + block.shape[0])
        bc1 = min(c0 + ww, block_c + block.shape[1])
        if br1 <= br0 or bc1 <= bc0:
            return
        src = block[br0 - block_r:br1 - block_r, bc0 - block_c:bc1 - block_c]
        if plane is None:
            out[br0 - r0:br1 - r0, bc0 - c0:bc1 - c0, :] = src
        else:
            out[br0 - r0:br1 - r0, bc0 - c0:bc1 - c0, plane] = src[:, :, 0]
