"""Structural cloud-optimized GeoTIFF validation.

Our own implementation of the checks the reference performs through
extern/validate_cloud_optimized_geotiff.py (invoked from core.py:76-90):

  1. the file is a valid TIFF whose IFDs (and their out-of-line tag values)
     all precede the first byte of image data;
  2. the main image is tiled;
  3. overview IFDs follow the main IFD, largest first;
  4. image data for each overview precedes the main-resolution data, and
     the smallest overview's data comes first;
  5. within each IFD, tile offsets are increasing (full check);
  6. every tile decompresses to the expected size (full check);
  7. when the GDAL structural ghost area declares them
     (reference :196-203), per-tile ghost bytes hold: the 4 bytes before
     each tile are its byte count (BLOCK_LEADER=SIZE_AS_UINT4,
     reference :82-87) and the 4 bytes after repeat its last 4 data bytes
     (BLOCK_TRAILER=LAST_4_BYTES_REPEATED, reference :89-95), and the main
     IFD sits exactly where the ghost area says it should
     (reference :205-214).

Returns a list of error strings (empty = valid COG).
"""

import struct

from proteus_tpu_torch.io import codecs
from proteus_tpu_torch.io.tiff import (TiffReader, TAG_TILE_OFFSETS,
                                 TAG_TILE_BYTE_COUNTS)


def _read_ghost_flags(path, errors):
    """Parse the GDAL structural-metadata ghost area (if present)."""
    flags = {'leader': False, 'trailer': False, 'row_major': False,
             'expected_ifd': None}
    with open(path, 'rb') as fh:
        header = fh.read(8)
        if header[:2] not in (b'II', b'MM'):
            return flags
        endian = '<' if header[:2] == b'II' else '>'
        ifd_off = struct.unpack(endian + 'I', header[4:8])[0]
        if ifd_off == 8:
            return flags
        pattern_len = len('GDAL_STRUCTURAL_METADATA_SIZE=000000 bytes\n')
        got = fh.read(pattern_len).decode('latin1', 'replace')
        if not got.startswith('GDAL_STRUCTURAL_METADATA_SIZE='):
            return flags
        size = int(got[len('GDAL_STRUCTURAL_METADATA_SIZE='):][:6])
        extra = fh.read(size).decode('latin1', 'replace')
        flags['leader'] = 'BLOCK_LEADER=SIZE_AS_UINT4' in extra
        flags['trailer'] = 'BLOCK_TRAILER=LAST_4_BYTES_REPEATED' in extra
        flags['row_major'] = 'BLOCK_ORDER=ROW_MAJOR' in extra
        if 'KNOWN_INCOMPATIBLE_EDITION=YES' in extra:
            errors.append(
                'KNOWN_INCOMPATIBLE_EDITION=YES is declared in the file')
        expected = 8 + pattern_len + size
        expected += expected % 2
        flags['expected_ifd'] = expected
        if ifd_off != expected:
            errors.append(
                f'main IFD offset should be {expected} per the structural '
                f'metadata; it is {ifd_off}')
    return flags


def validate_cog(path, full_check=True):
    errors = []
    try:
        reader = TiffReader(path)
    except Exception as e:  # noqa: BLE001 - report as validation failure
        return [f'not a readable TIFF: {e}']

    with reader:
        main = reader.main
        if not main.is_tiled:
            errors.append('main resolution image is not tiled')
            return errors

        # first data byte across all IFDs
        all_offsets = []
        for i, ifd in enumerate(reader.ifds):
            offs = ifd.get(TAG_TILE_OFFSETS) or ifd.get(273) or ()
            counts = ifd.get(TAG_TILE_BYTE_COUNTS) or ifd.get(279) or ()
            nonempty = [(o, c) for o, c in zip(offs, counts) if c > 0]
            if not nonempty:
                errors.append(f'IFD {i} has no image data')
                continue
            all_offsets.append((i, nonempty))
            if sorted(o for o, _ in nonempty) != [o for o, _ in nonempty]:
                errors.append(f'IFD {i}: tile offsets are not increasing')

        if not all_offsets:
            return errors
        first_data = min(o for _, ne in all_offsets for o, _ in ne)

        # IFDs (parsed eagerly by TiffReader) must precede data; we verify
        # by re-walking the IFD chain offsets
        import struct
        with open(path, 'rb') as fh:
            header = fh.read(8)
            endian = '<' if header[:2] == b'II' else '>'
            ifd_off = struct.unpack(endian + 'I', header[4:8])[0]
            while ifd_off:
                if ifd_off >= first_data:
                    errors.append(
                        f'IFD at offset {ifd_off} is located after image '
                        f'data (offset {first_data})')
                    break
                fh.seek(ifd_off)
                n = struct.unpack(endian + 'H', fh.read(2))[0]
                fh.seek(ifd_off + 2 + 12 * n)
                ifd_off = struct.unpack(endian + 'I', fh.read(4))[0]

        # overview sizes decreasing; overview data before main data
        main_first = all_offsets[0][1][0][0]
        prev_w = main.width
        for ifd in reader.overviews:
            if ifd.width >= prev_w:
                errors.append('overviews are not sorted largest-first')
            prev_w = ifd.width
        for i, nonempty in all_offsets[1:]:
            if nonempty[0][0] > main_first:
                errors.append(
                    f'overview IFD {i} data begins after the main-'
                    'resolution data (main image should be last)')

        ghost = _read_ghost_flags(path, errors)

        if full_check:
            for i, nonempty in all_offsets:
                ifd = reader.ifds[i]
                codecs.get_decoder(ifd.compression)  # reject unknown
                # decoded capacity from the tile geometry: lets the
                # fast block decoder (libdeflate/native) serve the
                # decode instead of plain zlib, and makes check 6 a
                # real size check
                from proteus_tpu_torch.io.tiff import (TAG_TILE_LENGTH,
                                                 TAG_TILE_WIDTH)
                tl = int(ifd.scalar(TAG_TILE_LENGTH, ifd.length))
                tw = int(ifd.scalar(TAG_TILE_WIDTH, ifd.width))
                expected = (tl * tw * ifd.samples_per_pixel
                            * ifd.dtype.itemsize)
                with open(path, 'rb') as fh:
                    for off, cnt in nonempty:
                        if ghost['leader']:
                            fh.seek(off - 4)
                            leader = struct.unpack('<I', fh.read(4))[0]
                            if leader != cnt:
                                errors.append(
                                    f'IFD {i}: tile at {off} leader size '
                                    f'is {leader} instead of {cnt}')
                        fh.seek(off)
                        blob = fh.read(cnt)
                        if len(blob) != cnt:
                            errors.append(
                                f'IFD {i}: truncated tile at {off}')
                            continue
                        if ghost['trailer'] and cnt >= 4:
                            trailer = fh.read(4)
                            if trailer != blob[-4:]:
                                errors.append(
                                    f'IFD {i}: tile at {off} trailer '
                                    'bytes are invalid')
                        try:
                            decoded = codecs.decode_block(
                                ifd.compression, blob, expected)
                            if len(decoded) > expected:
                                errors.append(
                                    f'IFD {i}: tile at {off} decodes to '
                                    f'{len(decoded)} bytes; expected at '
                                    f'most {expected}')
                        except Exception as e:  # noqa: BLE001
                            errors.append(
                                f'IFD {i}: tile at {off} fails to '
                                f'decompress: {e}')
    return errors


def is_valid_cog(path, full_check=True):
    return not validate_cog(path, full_check=full_check)
