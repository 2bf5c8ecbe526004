"""The benchmark's own GeoTIFF writer and reader, and its PNG reader,
against each other and against the program's reader and writer."""

import numpy as np
import pytest

from dswx_bench.geotiff import read_geotiff, read_png, write_geotiff

GT = (600000.0, 30.0, 0.0, 3300000.0, 0.0, -30.0)


def _arrays(rng):
    yield rng.integers(0, 256, (37, 1030), dtype=np.uint8)
    yield rng.integers(-9999, 15000, (600, 513), dtype=np.int16)
    dem = rng.normal(100, 50, (515, 47)).astype(np.float32)
    dem[3, 4] = np.nan
    dem[5, 6] = -0.0
    yield dem


@pytest.mark.parametrize('k', range(3))
def test_round_trip_and_the_programs_reader(tmp_path, k):
    from proteus_tpu_torch.io.tiff import TiffReader
    array = list(_arrays(np.random.default_rng(k)))[k]
    path = str(tmp_path / 'a.tif')
    md = {'MEAN_SUN_AZIMUTH_ANGLE': '152.595427', 'note': 'a <b> & "c"'}
    nodata = float('nan') if array.dtype.kind == 'f' else 0
    write_geotiff(path, array, GT, 32615, nodata=nodata, metadata=md)
    got = read_geotiff(path)
    assert got.dtype == array.dtype
    assert np.array_equal(got.view(f'u{got.itemsize}'),
                          array.view(f'u{array.itemsize}'))
    with TiffReader(path) as r:
        theirs = r.read()
        assert r.metadata()['MEAN_SUN_AZIMUTH_ANGLE'] == '152.595427'
        assert r.metadata()['note'] == 'a <b> & "c"'
        assert tuple(r.geotransform()) == GT
        assert r.epsg() == 32615
        assert (np.isnan(r.nodata()) if array.dtype.kind == 'f'
                else r.nodata() == 0)
    assert np.array_equal(theirs.view(f'u{theirs.itemsize}'),
                          array.view(f'u{array.itemsize}'))


@pytest.mark.parametrize('dtype', [np.uint8, np.uint16, np.float32])
def test_reads_the_programs_cogs(tmp_path, dtype):
    from proteus_tpu_torch.io.cog import write_cog
    rng = np.random.default_rng(3)
    array = (rng.normal(0, 1000, (700, 1100)) % 60000).astype(dtype)
    path = str(tmp_path / 'p.tif')
    write_cog(path, array, geotransform=GT, epsg=32615)
    assert np.array_equal(read_geotiff(path), array)


def test_png_reader_against_pil(tmp_path):
    from PIL import Image
    rng = np.random.default_rng(4)
    idx = rng.integers(0, 6, (70, 90)).astype(np.uint8)
    im = Image.fromarray(idx, mode='P')
    im.putpalette(list(range(256)) * 3)
    path = str(tmp_path / 'a.png')
    im.save(path, transparency=bytes(range(256)))
    assert np.array_equal(read_png(path), idx)
    grey = rng.integers(0, 256, (33, 17)).astype(np.uint8)
    Image.fromarray(grey, mode='L').save(path, optimize=True)
    assert np.array_equal(read_png(path), grey)
