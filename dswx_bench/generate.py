"""The one generator of the benchmark's inputs, from ``--seed``.

It reads a configuration (the tile grid, the ancillaries' resolutions,
margin and terrain, the science settings) and a traffic mix (how many
acquisitions, their dates, the range of sun angles, the scene), and writes
what a run needs: per acquisition an HLS v2 S30 granule (six int16 bands
and Fmask, one GeoTIFF each, with the metadata the reader harvests), and
once a run the DEM, the CGLS and the WorldCover of the grid, all through
the benchmark's own GeoTIFF writer. Every array is drawn on ``device``
from one ``torch.Generator`` in a few large calls, so the same seed gives
the same inputs; the arrays stay on the host for the reference.

The scene is the repository's synthetic tile (a lake, a wetland, a cloud
with its adjacent ring and shadow, a snow strip, an aerosol box and a fill
wedge in one corner), each feature moved by up to a twentieth of the tile
per acquisition, on reflectances with a smooth surface texture and a
little sensor noise. The terrain is its DEM's ridges with smooth relief
at a few scales on top and sub-metre noise; the landcover is patches of
its classes, a few hundred metres across. Smooth fields are Gaussian
noise on a coarse lattice, interpolated linearly, so the inputs compress
as real rasters do and not as white noise. A mix may put each
acquisition on a grid of its own (``grid_offsets_px``); the ancillaries
then cover every grid. Sizes never depend on the seed: only positions,
values and sun angles do.
"""

import math
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from dswx_bench.geotiff import write_geotiff
from dswx_bench.reference.warp import utm_inverse

BANDS = (('blue', 'B02'), ('green', 'B03'), ('red', 'B04'), ('nir', 'B8A'),
         ('swir1', 'B11'), ('swir2', 'B12'))
# (base, water) reflectance of each band, in BANDS' order
_LEVELS = ((900, 450), (1100, 600), (1000, 350), (2800, 150), (2300, 80),
           (1700, 60))
_CGLS_CLASSES = (20, 30, 40, 50, 111, 113, 80, 0)
_WORLDCOVER_CLASSES = (10, 20, 30, 40, 50, 60, 80, 90, 95)
_HLS_METADATA = {
    'MEAN_VIEW_AZIMUTH_ANGLE': '109.397723',
    'MEAN_VIEW_ZENITH_ANGLE': '3.186504',
    'NBAR_SOLAR_ZENITH': '26.2309469',
    'ACCODE': 'LaSRC v3.5.5',
    'SPATIAL_COVERAGE': '92',
    'CLOUD_COVERAGE': '11',
    'SPACECRAFT_NAME': 'Sentinel-2A',
    'scale_factor': '0.0001',
    'add_offset': '0.0',
    '_FillValue': '-9999',
}


class Acquisition:
    """One granule: its product grid, band files and, for the reference,
    its arrays and sun angles as the metadata states them."""

    def __init__(self, name, grid, files, bands, fmask, azimuth, zenith):
        self.name = name
        self.grid = grid            # the tile dict with its geotransform
        self.files = files
        self.bands = bands          # {'blue': int16 array, ...}
        self.fmask = fmask
        self.azimuth = azimuth      # the metadata's strings
        self.zenith = zenith


class Inputs:
    """What one run reads: the first acquisition's grid, the acquisitions
    and the ancillaries."""

    def __init__(self, grid, acquisitions, ancillaries):
        self.grid = grid
        self.acquisitions = acquisitions
        # {'dem': (path, array, gt), 'cgls': ..., 'worldcover': ...}
        self.ancillaries = ancillaries


def tile_geotransform(tile):
    return (float(tile['x0']), float(tile['pixel_m']), 0.0,
            float(tile['y0']), 0.0, -float(tile['pixel_m']))


def grids(tile, mix):
    """The product grid of each acquisition of ``mix``: the configuration's
    tile, its origin moved by the mix's ``grid_offsets_px`` ([columns,
    rows] of the tile's pixels, one an acquisition, taken in turn; none:
    every acquisition on the tile itself)."""
    offsets = mix.get('grid_offsets_px') or [[0, 0]]
    out = []
    for k in range(mix['acquisitions']):
        dc, dr = offsets[k % len(offsets)]
        grid = dict(tile, x0=tile['x0'] + dc * tile['pixel_m'],
                    y0=tile['y0'] - dr * tile['pixel_m'])
        out.append(dict(grid, geotransform=tile_geotransform(grid)))
    return out


def latlon_bounds(tiles, margin_deg):
    """The corners of ``tiles`` (a tile or a list of them) in latitude and
    longitude, widened by ``margin_deg``: (lat_min, lat_max, lon_min,
    lon_max)."""
    lats, lons = [], []
    for tile in tiles if isinstance(tiles, list) else [tiles]:
        x0, dx, _, y0, _, dy = tile_geotransform(tile)
        n = tile['size']
        xs = np.array([x0, x0 + n * dx, x0, x0 + n * dx])
        ys = np.array([y0, y0, y0 + n * dy, y0 + n * dy])
        lat, lon = utm_inverse(xs, ys, tile['utm_zone'])
        lats.append(lat)
        lons.append(lon)
    lat, lon = np.concatenate(lats), np.concatenate(lons)
    return (lat.min() - margin_deg, lat.max() + margin_deg,
            lon.min() - margin_deg, lon.max() + margin_deg)


def ancillary_grid(tiles, margin_deg, step):
    """(rows, cols, geotransform) of an EPSG:4326 raster of pixel ``step``
    degrees that covers ``tiles`` with the margin."""
    lat_min, lat_max, lon_min, lon_max = latlon_bounds(tiles, margin_deg)
    cols = int(np.ceil((lon_max - lon_min) / step))
    rows = int(np.ceil((lat_max - lat_min) / step))
    return rows, cols, (lon_min, step, 0.0, lat_max, 0.0, -step)


def _uniform(g, lo, hi):
    return lo + (hi - lo) * float(torch.rand((), generator=g,
                                             device=g.device))


def _lerp(coarse, n, cell, dim):
    """``coarse`` interpolated linearly along ``dim`` onto ``n`` pixels,
    ``cell`` pixels to a lattice step (the lattice's first point half a
    pixel before the first pixel's centre)."""
    pos = (torch.arange(n, device=coarse.device, dtype=torch.float32)
           + 0.5) / cell
    i0 = pos.floor().long()
    shape = [1] * coarse.dim()
    shape[dim] = n
    w = (pos - i0).reshape(shape)
    a = coarse.index_select(dim, i0)
    return a + (coarse.index_select(dim, i0 + 1) - a) * w


def _smooth(g, channels, rows, cols, cell, device, block=2048):
    """Yields (row0, field) blocks of ``channels`` smooth fields of unit
    variance at the lattice points, ``cell`` pixels to a lattice step:
    (channels, block rows, cols) float32 on ``device``."""
    cell = max(float(cell), 1.0)
    lattice = torch.randn((channels, int(rows // cell) + 2,
                           int(cols // cell) + 2), generator=g,
                          device=device)
    across = _lerp(lattice, cols, cell, 2)
    for r0 in range(0, rows, block):
        r1 = min(rows, r0 + block)
        pos = (torch.arange(r0, r1, device=device, dtype=torch.float32)
               + 0.5) / cell
        i0 = pos.floor().long()
        w = (pos - i0)[None, :, None]
        a = across.index_select(1, i0)
        yield r0, a + (across.index_select(1, i0 + 1) - a) * w


def _scene(g, n, scene, device):
    """One acquisition's bands (6, n, n) int16 and Fmask (n, n) uint8."""
    jitter = scene['jitter']
    shift = ((torch.rand((7, 2), generator=g, device=device) * 2 - 1)
             * jitter * n)
    yy = torch.arange(n, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(n, device=device, dtype=torch.float32)[None, :]

    def disc(k, cx, cy, r):
        dx = xx - (cx * n + shift[k, 0])
        dy = yy - (cy * n + shift[k, 1])
        return dx * dx + dy * dy < (r * n) ** 2

    water = disc(0, 0.3, 0.6, 0.18)
    wetland = disc(1, 0.7, 0.25, 0.12)
    cloud = disc(2, 0.8, 0.8, 0.1)
    adjacent = disc(2, 0.8, 0.8, 0.15) & ~cloud
    shadow = disc(3, 0.63, 0.85, 0.05)
    snow = yy < n * 0.06 + shift[4, 1]
    aerosol = ((xx > n * 0.9 + shift[5, 0]) & (yy > n * 0.4 + shift[5, 1])
               & (yy < n * 0.6 + shift[5, 1]))
    invalid = (xx + yy) > (2 * n - n * 0.08) + shift[6, 0]

    (_, texture), = _smooth(g, 1, n, n, scene['texture_px'], device,
                            block=n)
    noise = (torch.randn((6, n, n), generator=g, device=device)
             * scene['noise'] + texture * scene['texture'])
    levels = torch.tensor(_LEVELS, dtype=torch.float32, device=device)
    base, wat = levels[:, 0, None, None], levels[:, 1, None, None]
    value = torch.where(water, wat, torch.where(wetland, (base + wat) / 2,
                                                base))
    bands = (value + noise).clamp(-1000, 15000).to(torch.int16)
    bands[:, invalid] = -9999
    fmask = (cloud.to(torch.uint8) * 2 | adjacent.to(torch.uint8) * 4
             | shadow.to(torch.uint8) * 8 | snow.to(torch.uint8) * 16
             | water.to(torch.uint8) * 32 | aerosol.to(torch.uint8) * 192)
    return bands.cpu().numpy(), fmask.cpu().numpy()


def _dem(g, rows, cols, dem, device):
    """Ridges, a slope, smooth relief and noise (metres, float32): the
    repository's synthetic DEM at 3", drawn at the configuration's
    resolution with the ridges at the same size on the ground; on top,
    for each of ``relief_octaves`` ([step in degrees, metres]), a smooth
    field of that step and size, and ``noise_m`` of random error a
    pixel."""
    step = dem['resolution_deg']
    s = step * 3600.0 / 3.0
    phase = torch.rand(2, generator=g, device=device) * (2 * math.pi)
    yy = torch.arange(rows, device=device, dtype=torch.float32)[:, None] * s
    xx = torch.arange(cols, device=device, dtype=torch.float32)[None, :] * s
    out = (dem['relief_m'] * torch.sin(xx / 37.0 + phase[0])
           * torch.cos(yy / 29.0 + phase[1]) + dem['gradient_m_per_px3'] * xx)
    for octave_deg, metres in dem['relief_octaves']:
        (_, field), = _smooth(g, 1, rows, cols, octave_deg / step, device,
                              block=rows)
        out += metres * field[0]
    out += dem['noise_m'] * torch.randn((rows, cols), generator=g,
                                        device=device)
    return out.cpu().numpy()


def _classes(g, rows, cols, classes, patch_px, device):
    """Patches of ``classes`` about ``patch_px`` pixels across: at each
    pixel the class whose smooth field is highest there."""
    table = torch.tensor(classes, dtype=torch.uint8, device=device)
    out = np.empty((rows, cols), np.uint8)
    for r0, fields in _smooth(g, len(classes), rows, cols, patch_px,
                              device):
        out[r0:r0 + fields.shape[1]] = table[fields.argmax(0)].cpu().numpy()
    return out


def _date(day_of_year, k):
    """(the granule's day and time, its ISO sensing time) of a day of 2021,
    ``k`` seconds after 16:38:19 (no two acquisitions of one day share a
    name)."""
    import datetime
    t = (datetime.datetime(2021, 1, 1, 16, 38, 19)
         + datetime.timedelta(days=day_of_year - 1, seconds=k))
    return (f'{t.year}{day_of_year:03d}T{t:%H%M%S}',
            f'{t:%Y-%m-%dT%H:%M:%S}.024Z')


def _fsync(paths, pool):
    """Put ``paths`` on the disk: their writes are set-up's, and a flush
    of these files alone does not wait on other processes' writes."""
    def one(path):
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    list(pool.map(one, paths))


def make_inputs(config, mix, seed, root, device, write=True):
    """Write a run's inputs under ``root`` and return them (``Inputs``);
    ``write=False`` makes the arrays alone (the control's)."""
    tile = config['tile']
    n = tile['size']
    anc = config['ancillaries']
    year = config['processing']['worldcover_year']
    root = root or ''
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    epsg = tile['epsg']
    product_grids = grids(tile, mix)
    acquisitions = []
    written = []
    with ThreadPoolExecutor(8) as pool:
        def save(path, array, *args, **kwargs):
            if write:
                os.makedirs(os.path.dirname(path), exist_ok=True)
                write_geotiff(path, array, *args, pool=pool, **kwargs)
                written.append(path)
            return path

        for k, grid in enumerate(product_grids):
            azimuth = f'{_uniform(g, *mix["sun_azimuth_deg"]):.6f}'
            zenith = f'{_uniform(g, *mix["sun_zenith_deg"]):.6f}'
            doy = mix['first_day'] + k * mix['revisit_days']
            day, sensing = _date(doy, k)
            name = f'HLS.S30.{tile["mgrs"]}.{day}.v2.0'
            bands, fmask = _scene(g, n, mix['scene'], device)
            directory = os.path.join(root, 'granules', name)
            md = dict(_HLS_METADATA, MEAN_SUN_AZIMUTH_ANGLE=azimuth,
                      MEAN_SUN_ZENITH_ANGLE=zenith, SENSING_TIME=sensing,
                      PRODUCT_URI=f'S2A_MSIL1C_{sensing[:10].replace("-", "")}'
                                  f'T163901_N0301_R126_{tile["mgrs"]}.SAFE')
            gt = grid['geotransform']
            files = []
            for (_, suffix), band in zip(BANDS, bands):
                files.append(save(
                    os.path.join(directory, f'{name}.{suffix}.tif'), band,
                    gt, epsg, nodata=-9999, metadata=md))
            fmd = {key: value for key, value in md.items()
                   if key not in ('scale_factor', 'add_offset')}
            fmd['_FillValue'] = '255'
            files.append(save(os.path.join(directory, f'{name}.Fmask.tif'),
                              fmask, gt, epsg, nodata=255, metadata=fmd))
            acquisitions.append(Acquisition(
                name, grid, files, dict(zip((k for k, _ in BANDS), bands)),
                fmask, azimuth, zenith))

        ancillaries = {}
        margin = anc['margin_deg']
        for key in ('dem', 'cgls', 'worldcover'):
            step = anc[key]['resolution_deg']
            rows, cols, agt = ancillary_grid(product_grids, margin, step)
            path = os.path.join(root, f'{key}.tif')
            if key == 'dem':
                arr = _dem(g, rows, cols, anc['dem'], device)
                save(path, arr, agt, 4326, nodata=float('nan'),
                     metadata={'AREA_OR_POINT': 'Point'})
            elif key == 'cgls':
                arr = _classes(g, rows, cols, _CGLS_CLASSES,
                               anc[key]['patch_deg'] / step, device)
                save(path, arr, agt, 4326, nodata=255)
            else:
                arr = _classes(g, rows, cols, _WORLDCOVER_CLASSES,
                               anc[key]['patch_deg'] / step, device)
                save(path, arr, agt, 4326, nodata=0,
                     metadata={'time_start': f'{year}-01-01T00:00:00Z',
                               'time_end': f'{year}-12-31T23:59:59Z'})
            ancillaries[key] = (path, arr, agt)
        _fsync(written, pool)
    return Inputs(product_grids[0], acquisitions, ancillaries)


# the runconfig's aerosol lists, by the WTR-1 class each remaps
_AEROSOL_KEYS = {
    '0': 'aerosol_not_water_to_high_conf_water_fmask_values',
    '2': 'aerosol_water_moderate_conf_to_high_conf_water_fmask_values',
    '3': 'aerosol_partial_surface_water_conservative_to_high_conf_water'
         '_fmask_values',
    '4': 'aerosol_partial_surface_aggressive_to_high_conf_water'
         '_fmask_values'}
# the runconfig's keys of the processing group, under the same name in a
# configuration's ``processing``
_PROCESSING_KEYS = (
    'check_ancillary_inputs_coverage', 'apply_ocean_masking',
    'apply_aerosol_class_remapping', 'shadow_masking_algorithm',
    'min_slope_angle', 'max_sun_local_inc_angle',
    'mask_adjacent_to_cloud_mode', 'forest_mask_landcover_classes',
    'ocean_masking_shoreline_distance_km')
_BROWSE_KEYS = {'browse': 'save_browse',
                'browse_height': 'browse_image_height',
                'browse_width': 'browse_image_width',
                'exclude_psw_aggressive_in_browse':
                    'exclude_psw_aggressive_in_browse',
                'not_water_in_browse': 'not_water_in_browse',
                'cloud_in_browse': 'cloud_in_browse',
                'snow_in_browse': 'snow_in_browse'}


def write_runconfig(path, input_dir, output_dir, scratch_dir, ancillaries,
                    processing):
    """A runconfig of the SAS (``cli/dswx_hls.py``) with this run's files
    and every science setting of the configuration's ``processing``."""
    import yaml
    proc = {k: processing[k] for k in _PROCESSING_KEYS if k in processing}
    proc.update({_AEROSOL_KEYS[k]: list(v)
                 for k, v in processing['aerosol_lists'].items()})
    files = {'dem_file': ancillaries['dem'][0],
             'dem_file_description': 'Copernicus DEM GLO-30 2021 WGS84',
             'landcover_file': ancillaries['cgls'][0],
             'worldcover_file': ancillaries['worldcover'][0],
             'worldcover_file_description': 'ESA WorldCover 10m 2021'}
    doc = {'runconfig': {'name': 'dswx_hls_workflow_bench', 'groups': {
        'pge_name_group': {'pge_name': 'DSWX_HLS_PGE'},
        'input_file_group': {'input_file_path': [input_dir]},
        'dynamic_ancillary_file_group': files,
        'primary_executable': {'product_type': 'DSWX_HLS'},
        'product_path_group': {
            'product_path': output_dir, 'scratch_path': scratch_dir,
            'output_dir': output_dir,
            'product_id': processing['product_id'],
            # as the runconfig's unquoted text reads it (a number)
            'product_version': yaml.safe_load(
                str(processing['product_version']))},
        'processing': proc,
        'browse_image_group': {v: processing[k]
                               for k, v in _BROWSE_KEYS.items()},
        'hls_thresholds': dict(processing['hls_thresholds'])}}}
    with open(path, 'w') as fh:
        yaml.safe_dump(doc, fh, sort_keys=False)
    return path
