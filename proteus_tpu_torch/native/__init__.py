"""ctypes bindings for the native tiffturbo codec.

Loads the library that ``proteus_tpu_torch.native.build`` builds from
``tiffturbo.cpp`` into ``build/torch_native/`` (``python -m
proteus_tpu_torch.native.build``); builds it on first use when a compiler
is available. All entry points have pure-Python/NumPy fallbacks in
proteus_tpu_torch.io.codecs, so the package works without the native
library — just slower on the LZW/predictor paths. ``codec()`` says which
of the two writes and reads.
"""

import ctypes
import os

import numpy as np

_LIB = None
_TRIED = False


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get('PROTEUS_TPU_NO_NATIVE'):
        return None
    from proteus_tpu_torch.native import build as _build
    try:
        if not _build.lib_is_fresh():
            _build.build(verbose=False)
        lib = ctypes.CDLL(_build.lib_path())
    except Exception:  # noqa: BLE001 - fall back to pure Python
        return None

    lib.tt_inflate.restype = ctypes.c_long
    lib.tt_inflate.argtypes = [ctypes.c_char_p, ctypes.c_long,
                               ctypes.c_void_p, ctypes.c_long]
    lib.tt_lzw_decode.restype = ctypes.c_long
    lib.tt_lzw_decode.argtypes = [ctypes.c_char_p, ctypes.c_long,
                                  ctypes.c_void_p, ctypes.c_long]
    lib.tt_deflate.restype = ctypes.c_long
    lib.tt_deflate.argtypes = [ctypes.c_void_p, ctypes.c_long,
                               ctypes.c_int, ctypes.c_void_p,
                               ctypes.c_long]
    lib.tt_deflate_tiles.restype = ctypes.c_int
    lib.tt_deflate_tiles.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p]
    lib.tt_unpredict_h.restype = None
    lib.tt_unpredict_h.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int]
    lib.tt_unpredict_float.restype = None
    lib.tt_unpredict_float.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_int]
    if hasattr(lib, 'tt_decode_blocks'):
        lib.tt_decode_blocks.restype = ctypes.c_int
        lib.tt_decode_blocks.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
    if hasattr(lib, 'tt_band_finalize_i16'):
        lib.tt_band_finalize_i16.restype = None
        lib.tt_band_finalize_i16.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int16,
            ctypes.c_int, ctypes.c_void_p]
    if hasattr(lib, 'tt_lut8'):
        lib.tt_lut8.restype = None
        lib.tt_lut8.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_int64, ctypes.c_void_p,
                                ctypes.c_int]
    if hasattr(lib, 'tt_unpack_derive'):
        lib.tt_unpack_derive.restype = ctypes.c_int
        lib.tt_unpack_derive.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    if hasattr(lib, 'tt_bspline_decimate_f32'):
        lib.tt_bspline_decimate_f32.restype = ctypes.c_int
        lib.tt_bspline_decimate_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_long, ctypes.c_long,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int]
    _LIB = lib
    return _LIB


def available():
    return _load() is not None


def codec():
    """The codec in use: 'native (libdeflate)', 'native (zlib)' or
    'pure-Python'."""
    if _load() is None:
        return 'pure-Python'
    from proteus_tpu_torch.native import build as _build
    return f'native ({_build.linked()})'


def lzw_decode(data: bytes, expected_size: int) -> bytes:
    """Native LZW decode; raises ValueError on corrupt streams."""
    lib = _load()
    if lib is None:
        raise RuntimeError('native codec unavailable')
    out = ctypes.create_string_buffer(expected_size)
    n = lib.tt_lzw_decode(data, len(data), out, expected_size)
    if n < 0:
        raise ValueError('corrupt LZW stream')
    return out.raw[:n]


def inflate(data: bytes, expected_size: int) -> bytes:
    lib = _load()
    if lib is None:
        raise RuntimeError('native codec unavailable')
    out = ctypes.create_string_buffer(expected_size)
    n = lib.tt_inflate(data, len(data), out, expected_size)
    if n < 0:
        raise ValueError('corrupt DEFLATE stream')
    return out.raw[:n]


def bspline_decimate_f32(arr: np.ndarray, factor: int, taps: np.ndarray,
                         weights: np.ndarray,
                         n_threads: int = None) -> np.ndarray:
    """Cubic-B-spline decimation of a float32 (h, w[, s]) array.

    Bit-identical to io/cog.py's NumPy implementation (same float64
    tap order, renormalization, and final float32 rounding).
    """
    lib = _load()
    if lib is None or not hasattr(lib, 'tt_bspline_decimate_f32'):
        raise RuntimeError('native codec unavailable')
    squeeze = arr.ndim == 2
    a3 = arr[:, :, None] if squeeze else arr
    a3 = np.ascontiguousarray(a3, dtype=np.float32)
    h, w, s = a3.shape
    oh = (h + factor - 1) // factor
    ow = (w + factor - 1) // factor
    taps = np.ascontiguousarray(taps, dtype=np.int64)
    weights = np.ascontiguousarray(weights, dtype=np.float64)
    out = np.empty((oh, ow, s), dtype=np.float32)
    if n_threads is None:
        n_threads = min(8, os.cpu_count() or 1)
    rc = lib.tt_bspline_decimate_f32(
        a3.ctypes.data_as(ctypes.c_void_p), h, w, s, int(factor),
        taps.ctypes.data_as(ctypes.c_void_p),
        weights.ctypes.data_as(ctypes.c_void_p), len(taps),
        out.ctypes.data_as(ctypes.c_void_p), n_threads)
    if rc != 0:
        raise RuntimeError('native bspline decimation failed')
    return out[:, :, 0] if squeeze else out


def has_decode_blocks():
    lib = _load()
    return lib is not None and hasattr(lib, 'tt_decode_blocks')


def decode_blocks(raw: bytes, offs, sizes, blk_rows, block_cols,
                  blk_row0, blk_col0, samples, itemsize, compression,
                  predictor, dst: np.ndarray, win_r0: int, win_c0: int,
                  n_threads: int = None):
    """Decode + unpredict + scatter all blocks of one band read into
    ``dst`` (a (dst_rows, dst_cols, samples) C-contiguous native-LE
    array covering the window at (win_r0, win_c0)) in one native call.

    ``offs``/``sizes``/``blk_row0``/``blk_col0`` are int64 arrays;
    ``blk_rows`` is int32 (per-block decoded rows; strips' last block is
    short). Raises ValueError on a corrupt block.
    """
    lib = _load()
    if lib is None or not hasattr(lib, 'tt_decode_blocks'):
        raise RuntimeError('native codec unavailable')
    offs = np.ascontiguousarray(offs, dtype=np.int64)
    sizes = np.ascontiguousarray(sizes, dtype=np.int64)
    blk_rows = np.ascontiguousarray(blk_rows, dtype=np.int32)
    blk_row0 = np.ascontiguousarray(blk_row0, dtype=np.int64)
    blk_col0 = np.ascontiguousarray(blk_col0, dtype=np.int64)
    n_blocks = len(offs)
    if n_threads is None:
        n_threads = min(8, os.cpu_count() or 1)
    rc = lib.tt_decode_blocks(
        raw, offs.ctypes.data_as(ctypes.c_void_p),
        sizes.ctypes.data_as(ctypes.c_void_p), n_blocks,
        blk_rows.ctypes.data_as(ctypes.c_void_p), int(block_cols),
        blk_row0.ctypes.data_as(ctypes.c_void_p),
        blk_col0.ctypes.data_as(ctypes.c_void_p),
        int(samples), int(itemsize), int(compression), int(predictor),
        int(n_threads), dst.ctypes.data_as(ctypes.c_void_p),
        dst.shape[0], dst.shape[1], int(win_r0), int(win_c0))
    if rc != 0:
        raise ValueError('corrupt compressed block')


def has_band_finalize():
    lib = _load()
    return lib is not None and hasattr(lib, 'tt_band_finalize_i16')


def band_finalize_i16(band: np.ndarray, fill: int, do_clip: bool,
                      invalid: np.ndarray):
    """In place: invalid |= (band == fill); optionally clip band to
    >= 1 — the ingest fill-mask + negative-reflectance pass fused into
    one sweep. ``band`` must be C-contiguous int16; ``invalid`` a bool
    array of the same shape."""
    lib = _load()
    assert band.dtype == np.int16 and band.flags.c_contiguous
    assert invalid.dtype == np.bool_ and invalid.flags.c_contiguous
    assert invalid.shape == band.shape, \
        f'invalid {invalid.shape} != band {band.shape}'
    lib.tt_band_finalize_i16(
        band.ctypes.data_as(ctypes.c_void_p), band.size,
        np.int16(fill), int(bool(do_clip)),
        invalid.ctypes.data_as(ctypes.c_void_p))


def lut8(arr: np.ndarray, lut: np.ndarray,
         n_threads: int = None) -> np.ndarray:
    """out[i] = lut[arr[i]] over a uint8 array (threaded), or None when
    the native library is unavailable (caller falls back to NumPy)."""
    lib = _load()
    if lib is None or not hasattr(lib, 'tt_lut8'):
        return None
    a = np.ascontiguousarray(arr, dtype=np.uint8)
    lut = np.ascontiguousarray(lut, dtype=np.uint8)
    out = np.empty_like(a)
    if n_threads is None:
        n_threads = min(8, os.cpu_count() or 1)
    lib.tt_lut8(a.ctypes.data_as(ctypes.c_void_p),
                out.ctypes.data_as(ctypes.c_void_p), a.size,
                lut.ctypes.data_as(ctypes.c_void_p), int(n_threads))
    return out


def has_unpack_derive():
    lib = _load()
    return lib is not None and hasattr(lib, 'tt_unpack_derive')


def unpack_derive(packed_a: np.ndarray, packed_b: np.ndarray,
                  wtr_lut: np.ndarray, conf_lut: np.ndarray,
                  bwtr_lut: np.ndarray, browse_lut, diag_lut: np.ndarray,
                  idx_lut: np.ndarray, n_threads: int = None):
    """Fused unpack of the 2-byte/px device transfer + derivation of all
    dependent layers in one streaming native pass (the semantics live in
    the lookup tables, built by models/dswx/host_derive.py from its
    definitional implementations). Returns the layer dict."""
    lib = _load()
    if lib is None or not hasattr(lib, 'tt_unpack_derive'):
        raise RuntimeError('native codec unavailable')
    pa = np.ascontiguousarray(packed_a, dtype=np.uint8)
    pb = np.ascontiguousarray(packed_b, dtype=np.uint8)
    shape = pa.shape
    n = pa.size
    wtr_lut = np.ascontiguousarray(wtr_lut, dtype=np.uint8)
    conf_lut = np.ascontiguousarray(conf_lut, dtype=np.uint8)
    bwtr_lut = np.ascontiguousarray(bwtr_lut, dtype=np.uint8)
    diag64 = np.zeros(64, np.uint16)
    diag_lut = np.asarray(diag_lut, dtype=np.uint16)
    diag64[:len(diag_lut)] = diag_lut
    idx_lut = np.ascontiguousarray(idx_lut, dtype=np.uint8)
    outs = {k: np.empty(shape, np.uint8)
            for k in ('WTR-1', 'WTR-2', 'CLOUD', 'WTR', 'CONF', 'BWTR')}
    outs['DIAG'] = np.empty(shape, np.uint16)
    if browse_lut is not None:
        browse_lut = np.ascontiguousarray(browse_lut, dtype=np.uint8)
        outs['BROWSE'] = np.empty(shape, np.uint8)
    if n_threads is None:
        n_threads = min(8, os.cpu_count() or 1)

    def ptr(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    rc = lib.tt_unpack_derive(
        ptr(pa), ptr(pb), n, ptr(wtr_lut), ptr(conf_lut), ptr(bwtr_lut),
        ptr(browse_lut) if browse_lut is not None else None,
        ptr(diag64), ptr(idx_lut),
        ptr(outs['WTR-1']), ptr(outs['WTR-2']), ptr(outs['CLOUD']),
        ptr(outs['WTR']), ptr(outs['CONF']), ptr(outs['BWTR']),
        ptr(outs['BROWSE']) if browse_lut is not None else None,
        ptr(outs['DIAG']), int(n_threads))
    if rc != 0:
        raise RuntimeError('native unpack_derive failed')
    return outs


def deflate_tiles(tiles: np.ndarray, predictor: int, level: int = 6,
                  n_threads: int = None) -> list:
    """Compress (n_tiles, rows, cols, samples) array -> list of bytes.

    Applies the TIFF predictor inside the native code and fans tiles out
    over a thread pool.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError('native codec unavailable')
    tiles = np.ascontiguousarray(tiles)
    n_tiles, rows, cols, samples = tiles.shape
    itemsize = tiles.dtype.itemsize
    tile_bytes = rows * cols * samples * itemsize
    bound = tile_bytes + (tile_bytes >> 10) + 128
    out_buf = np.empty(n_tiles * bound, dtype=np.uint8)
    out_sizes = np.zeros(n_tiles, dtype=np.int64)
    if n_threads is None:
        n_threads = min(8, os.cpu_count() or 1)
    rc = lib.tt_deflate_tiles(
        tiles.ctypes.data_as(ctypes.c_void_p), n_tiles, rows, cols,
        samples, itemsize, predictor, level, n_threads,
        out_buf.ctypes.data_as(ctypes.c_void_p), bound,
        out_sizes.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise RuntimeError('native tile compression failed')
    return [out_buf[i * bound:i * bound + out_sizes[i]].tobytes()
            for i in range(n_tiles)]
