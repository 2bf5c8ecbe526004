"""ESRI Shapefile reader (polygons).

Replaces the OGR shapefile access the reference uses for the GSHHS
shoreline (ogr.Open at dswx_hls.py:3511). Reads the .shp geometry records
(Polygon/PolygonZ/PolygonM) and the .prj CRS; attributes (.dbf) are not
needed by the ocean-mask builder.
"""

import os
import struct

import numpy as np

SHAPE_NULL = 0
SHAPE_POLYGON = 5
SHAPE_POLYGON_Z = 15
SHAPE_POLYGON_M = 25

_POLYGON_TYPES = (SHAPE_POLYGON, SHAPE_POLYGON_Z, SHAPE_POLYGON_M)


class Polygon:
    """One polygon record: rings[0] is the outer ring, the rest holes
    (ESRI convention: outer rings clockwise, holes counter-clockwise; we
    keep all rings and rasterize even-odd so orientation is irrelevant)."""

    __slots__ = ('rings', 'bbox')

    def __init__(self, rings):
        self.rings = rings  # list of (n, 2) float64 arrays
        xs = np.concatenate([r[:, 0] for r in rings])
        ys = np.concatenate([r[:, 1] for r in rings])
        self.bbox = (xs.min(), ys.min(), xs.max(), ys.max())


def read_shapefile(path):
    """Read polygons from a .shp file. Returns (polygons, crs_wkt)."""
    with open(path, 'rb') as fh:
        header = fh.read(100)
        if struct.unpack('>i', header[:4])[0] != 9994:
            raise ValueError(f'not a shapefile: {path}')
        file_length_words = struct.unpack('>i', header[24:28])[0]
        file_length = file_length_words * 2
        polygons = []
        pos = 100
        while pos < file_length:
            fh.seek(pos)
            rec_header = fh.read(8)
            if len(rec_header) < 8:
                break
            _, content_words = struct.unpack('>ii', rec_header)
            content = fh.read(content_words * 2)
            pos += 8 + content_words * 2
            if len(content) < 4:
                break
            shape_type = struct.unpack('<i', content[:4])[0]
            if shape_type == SHAPE_NULL:
                continue
            if shape_type not in _POLYGON_TYPES:
                continue
            num_parts, num_points = struct.unpack('<ii', content[36:44])
            parts = struct.unpack('<' + 'i' * num_parts,
                                  content[44:44 + 4 * num_parts])
            pts_off = 44 + 4 * num_parts
            pts = np.frombuffer(content, dtype='<f8',
                                count=2 * num_points,
                                offset=pts_off).reshape(num_points, 2)
            rings = []
            for i in range(num_parts):
                start = parts[i]
                end = parts[i + 1] if i + 1 < num_parts else num_points
                ring = np.array(pts[start:end], dtype=np.float64)
                if len(ring) >= 3:
                    rings.append(ring)
            if rings:
                polygons.append(Polygon(rings))

    crs_wkt = None
    prj = os.path.splitext(path)[0] + '.prj'
    if os.path.isfile(prj):
        with open(prj) as fh:
            crs_wkt = fh.read().strip()
    return polygons, crs_wkt


def write_shapefile(path, polygons, crs_wkt=None):
    """Write polygons to a .shp (+ .shx, .prj). Minimal writer used by
    tests and the synthetic-data generator."""
    records = []
    for poly in polygons:
        rings = poly.rings if isinstance(poly, Polygon) else poly
        rings = [np.asarray(r, dtype=np.float64) for r in rings]
        num_points = sum(len(r) for r in rings)
        parts = []
        acc = 0
        for r in rings:
            parts.append(acc)
            acc += len(r)
        xs = np.concatenate([r[:, 0] for r in rings])
        ys = np.concatenate([r[:, 1] for r in rings])
        content = struct.pack('<i', SHAPE_POLYGON)
        content += struct.pack('<4d', xs.min(), ys.min(), xs.max(),
                               ys.max())
        content += struct.pack('<ii', len(rings), num_points)
        content += struct.pack('<' + 'i' * len(parts), *parts)
        for r in rings:
            content += np.ascontiguousarray(r, dtype='<f8').tobytes()
        records.append(content)

    def file_header(total_bytes, bbox):
        h = struct.pack('>i', 9994) + b'\0' * 20
        h += struct.pack('>i', total_bytes // 2)
        h += struct.pack('<ii', 1000, SHAPE_POLYGON)
        h += struct.pack('<4d', *bbox)
        h += struct.pack('<4d', 0, 0, 0, 0)
        return h

    all_x = np.concatenate([np.asarray(r)[:, 0]
                            for p in polygons
                            for r in (p.rings if isinstance(p, Polygon)
                                      else p)])
    all_y = np.concatenate([np.asarray(r)[:, 1]
                            for p in polygons
                            for r in (p.rings if isinstance(p, Polygon)
                                      else p)])
    bbox = (all_x.min(), all_y.min(), all_x.max(), all_y.max())

    total = 100 + sum(8 + len(c) for c in records)
    with open(path, 'wb') as fh:
        fh.write(file_header(total, bbox))
        for i, content in enumerate(records):
            fh.write(struct.pack('>ii', i + 1, len(content) // 2))
            fh.write(content)

    # .shx index
    shx = os.path.splitext(path)[0] + '.shx'
    with open(shx, 'wb') as fh:
        fh.write(file_header(100 + 8 * len(records), bbox))
        offset = 100
        for content in records:
            fh.write(struct.pack('>ii', offset // 2, len(content) // 2))
            offset += 8 + len(content)

    if crs_wkt:
        with open(os.path.splitext(path)[0] + '.prj', 'w') as fh:
            fh.write(crs_wkt)
