"""Synthetic HLS tiles and ancillaries, written through the port's own
``io`` and ``geo``.

A copy of the writers of ``tests/synthetic.py`` that the port's chip check
uses (:18-155, :185-285): a deterministic fake HLS v2 tile (per-band
GeoTIFFs with real HLS metadata fields), a Copernicus-DEM-style float32
DEM, CGLS/WorldCover-style landcover rasters in EPSG:4326, a GSHHS-style
shoreline shapefile and a runconfig. The same seed and size write the same
files byte for byte as the original (``tests/test_torch_host.py``).
"""

import os

import numpy as np

from proteus_tpu_torch.geo.crs import CRS, utm_inverse
from proteus_tpu_torch.io.cog import write_cog
from proteus_tpu_torch.io.shapefile import write_shapefile


EPSG = 32615           # UTM zone 15N
ZONE, NORTH = 15, True
X0, Y0 = 600000.0, 3300000.0   # upper-left corner
DX, DY = 30.0, -30.0

HLS_METADATA = {
    'MEAN_SUN_AZIMUTH_ANGLE': '152.595427',
    'MEAN_SUN_ZENITH_ANGLE': '27.085305',
    'MEAN_VIEW_AZIMUTH_ANGLE': '109.397723',
    'MEAN_VIEW_ZENITH_ANGLE': '3.186504',
    'NBAR_SOLAR_ZENITH': '26.2309469',
    'ACCODE': 'LaSRC v3.5.5',
    'SPATIAL_COVERAGE': '92',
    'CLOUD_COVERAGE': '11',
    'SPACECRAFT_NAME': 'Sentinel-2A',
    'SENSING_TIME': '2021-07-29T16:38:19.024Z',
    'PRODUCT_URI': 'S2A_MSIL1C_20210729T163901_N0301_R126_T15RYP.SAFE',
    'scale_factor': '0.0001',
    'add_offset': '0.0',
    '_FillValue': '-9999',
}


def geotransform():
    return (X0, DX, 0.0, Y0, 0.0, DY)


def make_bands(size, seed=11):
    """Deterministic synthetic reflectance bands with water/cloud/snow
    structure."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    water = ((xx - size * 0.3) ** 2 + (yy - size * 0.6) ** 2
             < (size * 0.18) ** 2)
    wetland = ((xx - size * 0.7) ** 2 + (yy - size * 0.25) ** 2
               < (size * 0.12) ** 2)

    def band(base, water_val, noise=120):
        b = np.full((size, size), base, np.float64)
        b[water] = water_val
        b[wetland] = (base + water_val) / 2
        b += rng.normal(0, noise, (size, size))
        return np.clip(b, -1000, 15000).astype(np.int16)

    bands = {
        'B02': band(900, 450),     # blue
        'B03': band(1100, 600),    # green
        'B04': band(1000, 350),    # red
        'B8A': band(2800, 150),    # nir
        'B11': band(2300, 80),     # swir1
        'B12': band(1700, 60),     # swir2
    }
    fmask = np.zeros((size, size), np.uint8)
    cloud = ((xx - size * 0.8) ** 2 + (yy - size * 0.8) ** 2
             < (size * 0.1) ** 2)
    fmask[cloud] |= 2                     # cloud bit
    adj = ((xx - size * 0.8) ** 2 + (yy - size * 0.8) ** 2
           < (size * 0.15) ** 2) & ~cloud
    fmask[adj] |= 4                       # adjacent-to-cloud bit
    shadow = ((xx - size * 0.63) ** 2 + (yy - size * 0.85) ** 2
              < (size * 0.05) ** 2)
    fmask[shadow] |= 8                    # cloud-shadow bit
    snow = yy < size * 0.06
    fmask[snow] |= 16                     # snow bit
    fmask[water] |= 32                    # water bit
    aerosol = (xx > size * 0.9) & (yy > size * 0.4) & (yy < size * 0.6)
    fmask[aerosol] |= 192                 # high aerosol
    bands['Fmask'] = fmask

    # fill pixels in a corner wedge (becomes the invalid mask)
    invalid = (xx + yy) > (2 * size - size * 0.08)
    for k in bands:
        if k != 'Fmask':
            bands[k][invalid] = -9999
    return bands


def make_hls_v2_dataset(out_dir, size=360, seed=11, product='S30'):
    """Write per-band HLS v2-style GeoTIFFs (S30 or L30 naming and
    metadata); returns the file list."""
    os.makedirs(out_dir, exist_ok=True)
    bands = make_bands(size, seed)
    if product == 'L30':
        # Landsat band names + Landsat-style metadata (no SPACECRAFT_NAME;
        # platform detected from SENSOR + LANDSAT_PRODUCT_ID)
        rename = {'B8A': 'B05', 'B11': 'B06', 'B12': 'B07'}
        bands = {rename.get(k, k): v for k, v in bands.items()}
        base = 'HLS.L30.T15RYP.2021210T163819.v2.0'
    else:
        base = 'HLS.S30.T15RYP.2021210T163819.v2.0'
    files = []
    for name, arr in bands.items():
        path = os.path.join(out_dir, f'{base}.{name}.tif')
        md = dict(HLS_METADATA)
        if product == 'L30':
            md.pop('SPACECRAFT_NAME')
            md.pop('PRODUCT_URI')
            md['SENSOR'] = 'OLI_TIRS; OLI_TIRS'
            md['LANDSAT_PRODUCT_ID'] =                 'LC08_L1TP_022039_20210729_20210804_02_T1'
        if name == 'Fmask':
            md.pop('scale_factor')
            md.pop('add_offset')
            md['_FillValue'] = '255'
        write_cog(path, arr, geotransform=geotransform(), epsg=EPSG,
                  nodata=(255 if name == 'Fmask' else -9999),
                  metadata=md, overview_levels=())
        files.append(path)
    return files, bands


def _tile_latlon_bounds(size, margin_deg=0.3):
    xs = np.array([X0, X0 + size * DX])
    ys = np.array([Y0, Y0 + size * DY])
    lat, lon = utm_inverse(np.array([xs[0], xs[1], xs[0], xs[1]]),
                           np.array([ys[0], ys[0], ys[1], ys[1]]),
                           ZONE, NORTH)
    return (lat.min() - margin_deg, lat.max() + margin_deg,
            lon.min() - margin_deg, lon.max() + margin_deg)


def make_dem(out_dir, size=360, seed=5, resolution_arcsec=3.0):
    """Copernicus-DEM-style float32 raster (EPSG:4326) covering the
    tile."""
    lat_min, lat_max, lon_min, lon_max = _tile_latlon_bounds(size)
    step = resolution_arcsec / 3600.0
    w = int(np.ceil((lon_max - lon_min) / step))
    h = int(np.ceil((lat_max - lat_min) / step))
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    dem = (120 * np.sin(xx / 37.0) * np.cos(yy / 29.0)
           + 0.08 * xx + 25 * rng.standard_normal((h, w))).astype(
               np.float32)
    gt = (lon_min, step, 0.0, lat_max, 0.0, -step)
    path = os.path.join(out_dir, 'dem.tif')
    write_cog(path, dem, geotransform=gt, epsg=4326, nodata=float('nan'),
              metadata={'AREA_OR_POINT': 'Point'},
              overview_levels=())
    return path


def make_landcover(out_dir, size=360, seed=6, resolution_arcsec=10.0):
    """CGLS-style uint8 classification (EPSG:4326)."""
    lat_min, lat_max, lon_min, lon_max = _tile_latlon_bounds(size)
    step = resolution_arcsec / 3600.0
    w = int(np.ceil((lon_max - lon_min) / step))
    h = int(np.ceil((lat_max - lat_min) / step))
    rng = np.random.default_rng(seed)
    classes = np.array([20, 30, 40, 50, 111, 113, 80, 0], np.uint8)
    lc = rng.choice(classes, (h, w))
    gt = (lon_min, step, 0.0, lat_max, 0.0, -step)
    path = os.path.join(out_dir, 'landcover.tif')
    write_cog(path, lc, geotransform=gt, epsg=4326, nodata=255,
              overview_levels=())
    return path


def make_worldcover(out_dir, size=360, seed=7, resolution_arcsec=0.6):
    """ESA-WorldCover-style uint8 classification (EPSG:4326, ~18 m)."""
    lat_min, lat_max, lon_min, lon_max = _tile_latlon_bounds(size)
    step = resolution_arcsec / 3600.0
    w = int(np.ceil((lon_max - lon_min) / step))
    h = int(np.ceil((lat_max - lat_min) / step))
    rng = np.random.default_rng(seed)
    classes = np.array([10, 20, 30, 40, 50, 60, 80, 90, 95], np.uint8)
    wc = rng.choice(classes, (h, w))
    gt = (lon_min, step, 0.0, lat_max, 0.0, -step)
    path = os.path.join(out_dir, 'worldcover.tif')
    write_cog(path, wc, geotransform=gt, epsg=4326, nodata=0,
              metadata={'time_start': '2021-01-01T00:00:00Z',
                        'time_end': '2021-12-31T23:59:59Z'},
              overview_levels=())
    return path


def make_shoreline(out_dir, size=360):
    """GSHHS-style land polygon shapefile (EPSG:4326): land covers the
    west 60% of the tile; the east 40% is ocean."""
    t_lat_min, t_lat_max, t_lon_min, t_lon_max = _tile_latlon_bounds(
        size, margin_deg=0.0)
    lat_min, lat_max, lon_min, lon_max = _tile_latlon_bounds(size,
                                                             margin_deg=1.0)
    # coastline at 60% across the *tile*; land extends west with margin
    lon_split = t_lon_min + 0.6 * (t_lon_max - t_lon_min)
    ring = np.array([[lon_min, lat_max], [lon_split, lat_max],
                     [lon_split, lat_min], [lon_min, lat_min],
                     [lon_min, lat_max]])
    path = os.path.join(out_dir, 'shoreline.shp')
    write_shapefile(path, [[ring]], crs_wkt=CRS.from_epsg(4326).to_wkt())
    return path


def write_runconfig(path, input_dir, output_dir, scratch_dir,
                    dem_file=None, landcover_file=None,
                    worldcover_file=None, shoreline_shapefile=None,
                    check_coverage=False, apply_ocean_masking=False,
                    extra_processing=None, thresholds=None):
    anc = ''
    if dem_file:
        anc += f'            dem_file: {dem_file}\n'
        anc += ('            dem_file_description: Copernicus DEM GLO-30'
                ' 2021 WGS84\n')
    if landcover_file:
        anc += f'            landcover_file: {landcover_file}\n'
    if worldcover_file:
        anc += f'            worldcover_file: {worldcover_file}\n'
        anc += ('            worldcover_file_description: ESA WorldCover'
                ' 10m 2021\n')
    if shoreline_shapefile:
        anc += (f'            shoreline_shapefile:'
                f' {shoreline_shapefile}\n')
    extra = ''
    for k, v in (extra_processing or {}).items():
        extra += f'            {k}: {v}\n'
    text = f"""runconfig:
    name: dswx_hls_workflow_test
    groups:
        pge_name_group:
            pge_name: DSWX_HLS_PGE
        input_file_group:
            input_file_path:
               - {input_dir}
        dynamic_ancillary_file_group:
{anc if anc else '            dem_file:'}
        primary_executable:
            product_type: DSWX_HLS
        product_path_group:
            product_path: {output_dir}
            scratch_path: {scratch_dir}
            output_dir: {output_dir}
            product_id: dswx_hls_test
            product_version: 0.1
        processing:
            check_ancillary_inputs_coverage: {check_coverage}
            apply_ocean_masking: {apply_ocean_masking}
{extra}"""
    if thresholds:
        text += '        hls_thresholds:\n' + ''.join(
            f'            {k}: {v}\n' for k, v in thresholds.items())
    with open(path, 'w') as fh:
        fh.write(text)
    return path
