"""The benchmark's own GeoTIFF writer and reader, and a PNG reader.

The inputs are written, and the products read back, by this file alone,
so that no change to the program's ``io/`` moves the yardstick. The
writer makes what an HLS v2 band or an ancillary product is: a tiled
(512 x 512) DEFLATE GeoTIFF with the predictor matched to the dtype
(horizontal differencing for integers, the floating-point predictor for
float32), GeoKeys for an EPSG code, and the GDAL metadata and nodata tags.
It has no overviews. The reader reads the first image of a tiled or
stripped, DEFLATE or uncompressed TIFF with predictor 1, 2 or 3: what the
program's COG writer makes. The PNG reader takes 8-bit greyscale or
palette images with any of the five row filters.
"""

import struct
import xml.sax.saxutils
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

TILE = 512
_SAMPLE_FORMAT = {'u': 1, 'i': 2, 'f': 3}


def _gdal_metadata(metadata):
    items = ''.join(
        '  <Item name="{}">{}</Item>\n'.format(
            xml.sax.saxutils.escape(str(k), {'"': '&quot;'}),
            xml.sax.saxutils.escape(str(v)))
        for k, v in metadata.items())
    return '<GDALMetadata>\n' + items + '</GDALMetadata>\n'


def _geokeys(epsg):
    if epsg == 4326:
        keys = [(1024, 0, 1, 2), (1025, 0, 1, 1), (2048, 0, 1, epsg)]
    else:
        keys = [(1024, 0, 1, 1), (1025, 0, 1, 1), (3072, 0, 1, epsg)]
    flat = [1, 1, 0, len(keys)]
    for k in keys:
        flat.extend(k)
    return flat


def _encode_tile(tile, level):
    """Predictor, then DEFLATE, of one full-size tile."""
    if tile.dtype.kind == 'f':
        th, tw = tile.shape
        planes = tile.astype('>f4').view(np.uint8).reshape(th, tw, 4) \
            .transpose(0, 2, 1).reshape(th, 4 * tw)
        diff = planes.copy()
        diff[:, 1:] = planes[:, 1:] - planes[:, :-1]
    else:
        diff = tile.copy()
        diff[:, 1:] = tile[:, 1:] - tile[:, :-1]
        diff = diff.astype(diff.dtype.newbyteorder('<'), copy=False)
    return zlib.compress(diff.tobytes(), level)


def write_geotiff(path, array, geotransform, epsg, nodata=None,
                  metadata=None, level=1, pool=None):
    """Write a 2-D uint8, int16 or float32 ``array`` as a tiled DEFLATE
    GeoTIFF (``pool``: an executor that compresses the tiles)."""
    array = np.ascontiguousarray(array)
    h, w = array.shape
    dtype = array.dtype
    ty, tx = -(-h // TILE), -(-w // TILE)
    padded = np.zeros((ty * TILE, tx * TILE), dtype)
    padded[:h, :w] = array
    tiles = [padded[r * TILE:(r + 1) * TILE, c * TILE:(c + 1) * TILE]
             for r in range(ty) for c in range(tx)]
    if pool is None:
        with ThreadPoolExecutor(8) as own:
            blobs = list(own.map(lambda t: _encode_tile(t, level), tiles))
    else:
        blobs = list(pool.map(lambda t: _encode_tile(t, level), tiles))

    x0, dx, _, y0, _, dy = geotransform
    tags = [(256, 4, [w]), (257, 4, [h]), (258, 3, [dtype.itemsize * 8]),
            (259, 3, [8]), (262, 3, [1]), (277, 3, [1]), (284, 3, [1]),
            (317, 3, [3 if dtype.kind == 'f' else 2]),
            (322, 3, [TILE]), (323, 3, [TILE]),
            (324, 4, [0] * len(blobs)), (325, 4, [len(b) for b in blobs]),
            (339, 3, [_SAMPLE_FORMAT[dtype.kind]]),
            (33550, 12, [float(dx), float(abs(dy)), 0.0]),
            (33922, 12, [0.0, 0.0, 0.0, float(x0), float(y0), 0.0]),
            (34735, 3, _geokeys(epsg))]
    if metadata:
        tags.append((42112, 2, _gdal_metadata(metadata)))
    if nodata is not None:
        if isinstance(nodata, float) and np.isnan(nodata):
            text = 'nan'
        elif float(nodata).is_integer():
            text = str(int(nodata))
        else:
            text = repr(float(nodata))
        tags.append((42113, 2, text))
    tags.sort(key=lambda t: t[0])

    fmt = {3: 'H', 4: 'I', 12: 'd'}
    ifd_at = 8
    extra_at = ifd_at + 2 + 12 * len(tags) + 4

    def encode(values, typ):
        if typ == 2:
            return values.encode('latin-1') + b'\0'
        return struct.pack('<' + fmt[typ] * len(values), *values)

    sizes = [len(encode(v, t)) for _, t, v in tags]
    extra_len = sum(s + (s & 1) for s in sizes if s > 4)
    data_at = extra_at + extra_len
    offsets, pos = [], data_at
    for b in blobs:
        offsets.append(pos)
        pos += len(b)
    tags = [(tag, t, offsets if tag == 324 else v) for tag, t, v in tags]

    entries, extra = [], bytearray()
    for tag, typ, values in tags:
        data = encode(values, typ)
        count = len(data) if typ == 2 else len(values)
        if len(data) <= 4:
            entries.append(struct.pack('<HHI', tag, typ, count)
                           + data.ljust(4, b'\0'))
        else:
            entries.append(struct.pack('<HHII', tag, typ, count,
                                       extra_at + len(extra)))
            extra += data + b'\0' * (len(data) & 1)
    with open(path, 'wb') as fh:
        fh.write(b'II*\0' + struct.pack('<I', ifd_at))
        fh.write(struct.pack('<H', len(tags)) + b''.join(entries)
                 + struct.pack('<I', 0) + bytes(extra))
        for b in blobs:
            fh.write(b)


_TYPES = {1: ('B', 1), 2: ('s', 1), 3: ('H', 2), 4: ('I', 4), 6: ('b', 1),
          7: ('B', 1), 8: ('h', 2), 9: ('i', 4), 11: ('f', 4), 12: ('d', 8),
          16: ('Q', 8)}
_DTYPES = {(8, 1): np.uint8, (16, 1): np.uint16, (16, 2): np.int16,
           (32, 1): np.uint32, (32, 2): np.int32, (32, 3): np.float32,
           (64, 3): np.float64, (8, 2): np.int8}


def _ifd(buf):
    """The first IFD's tags of a little- or big-endian classic TIFF."""
    end = {b'II': '<', b'MM': '>'}[bytes(buf[:2])]
    if struct.unpack(end + 'H', buf[2:4])[0] != 42:
        raise ValueError('not a classic TIFF')
    at = struct.unpack(end + 'I', buf[4:8])[0]
    n = struct.unpack(end + 'H', buf[at:at + 2])[0]
    tags = {}
    for k in range(n):
        e = at + 2 + 12 * k
        tag, typ, count = struct.unpack(end + 'HHI', buf[e:e + 8])
        code, size = _TYPES[typ]
        nbytes = size * count
        where = e + 8 if nbytes <= 4 else \
            struct.unpack(end + 'I', buf[e + 8:e + 12])[0]
        raw = bytes(buf[where:where + nbytes])
        if typ == 2:
            tags[tag] = raw.rstrip(b'\0').decode('latin-1')
        else:
            tags[tag] = list(struct.unpack(end + code * count, raw))
    return end, tags


def _undo_predictor(block, predictor, dtype, end):
    """``block``: the decompressed bytes of one tile or strip as
    (rows, cols * itemsize) uint8."""
    size = np.dtype(dtype).itemsize
    rows = block.shape[0]
    if predictor == 3:
        planes = np.cumsum(block, axis=1, dtype=np.uint8)
        cols = block.shape[1] // size
        return planes.reshape(rows, size, cols).transpose(0, 2, 1) \
            .copy().view(np.dtype(dtype).newbyteorder('>')) \
            .reshape(rows, cols).astype(dtype)
    values = block.view(np.dtype(dtype).newbyteorder(end)).astype(dtype)
    if predictor == 2:
        udt = np.dtype(f'u{size}')
        values = np.cumsum(values.view(udt), axis=1, dtype=udt).view(dtype)
    return values


def read_geotiff(path):
    """The first image of a single-band TIFF as a 2-D numpy array."""
    with open(path, 'rb') as fh:
        buf = fh.read()
    end, tags = _ifd(buf)
    w, h = tags[256][0], tags[257][0]
    bits = tags[258][0]
    fmt = tags.get(339, [1])[0]
    dtype = np.dtype(_DTYPES[(bits, fmt)])
    if tags.get(277, [1])[0] != 1:
        raise ValueError(f'{path}: more than one sample a pixel')
    compression = tags.get(259, [1])[0]
    predictor = tags.get(317, [1])[0]
    if 322 in tags:
        bw, bh = tags[322][0], tags[323][0]
        offsets, counts = tags[324], tags[325]
        across = -(-w // bw)
    else:
        bw, bh = w, tags.get(278, [h])[0]
        offsets, counts = tags[273], tags[279]
        across = 1
    out = np.empty((h, w), dtype)
    for k, (off, n) in enumerate(zip(offsets, counts)):
        raw = buf[off:off + n]
        if compression in (8, 32946):
            raw = zlib.decompress(raw)
        elif compression != 1:
            raise ValueError(f'{path}: compression {compression}')
        rows = len(raw) // (bw * dtype.itemsize)
        block = np.frombuffer(raw, np.uint8)[:rows * bw * dtype.itemsize] \
            .reshape(rows, bw * dtype.itemsize)
        values = _undo_predictor(block, predictor, dtype, end)
        r0, c0 = (k // across) * bh, (k % across) * bw
        r1, c1 = min(r0 + rows, h), min(c0 + bw, w)
        out[r0:r1, c0:c1] = values[:r1 - r0, :c1 - c0]
    return out


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def read_png(path):
    """An 8-bit greyscale or palette PNG's samples as a (h, w) uint8
    array."""
    with open(path, 'rb') as fh:
        buf = fh.read()
    if buf[:8] != b'\x89PNG\r\n\x1a\n':
        raise ValueError(f'{path}: not a PNG')
    at, idat, header = 8, [], None
    while at < len(buf):
        n, kind = struct.unpack('>I4s', buf[at:at + 8])
        body = buf[at + 8:at + 8 + n]
        if kind == b'IHDR':
            header = struct.unpack('>IIBBBBB', body)
        elif kind == b'IDAT':
            idat.append(body)
        at += 12 + n
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in (0, 3) or interlace:
        raise ValueError(f'{path}: depth {depth}, color type {color}, '
                         f'interlace {interlace}')
    raw = np.frombuffer(zlib.decompress(b''.join(idat)), np.uint8) \
        .reshape(h, w + 1)
    out = np.zeros((h, w), np.uint8)
    prev = np.zeros(w, np.int32)
    for r in range(h):
        f, line = raw[r, 0], raw[r, 1:].astype(np.int32)
        if f == 0:
            row = line
        elif f == 1:
            row = np.cumsum(line) & 255
        elif f == 2:
            row = (line + prev) & 255
        else:
            row = np.zeros(w, np.int32)
            left = 0
            for c in range(w):
                up = int(prev[c])
                if f == 3:
                    v = line[c] + ((left + up) >> 1)
                else:
                    v = line[c] + _paeth(left, up,
                                         int(prev[c - 1]) if c else 0)
                left = int(v) & 255
                row[c] = left
        out[r] = row
        prev = row.astype(np.int32)
    return out
