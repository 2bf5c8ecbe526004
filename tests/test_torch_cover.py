"""'cover' mode and the ocean mask of the port against proteus_tpu (JAX on
the CPU) and scipy, tolerance 0.

The same numpy inputs, made from a seed, go through the morphology
(masked cross dilation, ellipse dilation), the 'cover' masking stage, the
chain in every (band dtype x mode) pair, the kernel module's plain version
against the Pallas kernel in interpret mode, and a whole product run with
'cover', an Fmask where snow meets clear cloud-adjacent pixels, and ocean
masking. Every layer is an integer array, so equality is exact.
"""

import itertools
import os

import numpy as np
import pytest
import torch
from scipy.ndimage import binary_dilation, distance_transform_edt

import jax.numpy as jnp

import synthetic
from chip_smoke import cover_tile_fmask, scaled_bands, structured_cover_fmask
from proteus_tpu.core.thresholds import HlsThresholds
from proteus_tpu.geo.crs import CRS
from proteus_tpu.geo.polygon import create_ocean_mask as jax_ocean_mask
from proteus_tpu.io.cog import write_cog
from proteus_tpu.io.tiff import TiffReader
from proteus_tpu.models.dswx import chain as jchain
from proteus_tpu.models.dswx import masking as jmasking
from proteus_tpu.ops import morphology as jmorph
from proteus_tpu.ops.pallas.wtr_kernel import make_wtr_kernel
from proteus_tpu.runtime.orchestrator import \
    generate_dswx_layers as jax_generate
from proteus_tpu_torch.geo.polygon import create_ocean_mask
from proteus_tpu_torch.models.dswx import chain as tchain
from proteus_tpu_torch.models.dswx import masking as tmasking
from proteus_tpu_torch.ops import morphology as tmorph
from proteus_tpu_torch.ops import wtr_kernel
from proteus_tpu_torch.runtime.compare import compare_dswx_hls_products
from proteus_tpu_torch.runtime.orchestrator import generate_dswx_layers
from test_torch_chain import T, assert_same, make_inputs
from test_torch_e2e import LAYERS, _inputs, _outputs

torch.set_num_threads(1)

SHAPE = (160, 128)


def blobs(seed, shape=SHAPE, density=0.02):
    """Random blobs, some touching the edges."""
    rng = np.random.default_rng(seed)
    x = rng.random(shape) < density
    x = binary_dilation(x, iterations=2)
    x[0, 5:9] = x[-3:, 0] = x[7, -1] = True
    return x


# ---- morphology ----------------------------------------------------------

@pytest.mark.parametrize('iterations,masked',
                         list(itertools.product((0, 1, 7, 10),
                                                (False, True))))
def test_binary_dilation_masked(iterations, masked):
    x = blobs(1)
    mask = ~blobs(2, density=0.05) if masked else None
    want = binary_dilation(x, iterations=iterations, mask=mask) \
        if iterations else x
    got = tmorph.binary_dilation_masked(
        T(x), iterations, None if mask is None else T(mask))
    assert got.dtype == torch.bool
    assert_same(got, want)
    assert_same(got, jmorph.binary_dilation_masked(x, iterations, mask))


@pytest.mark.parametrize('margin_m,dy,dx', [(1000, -30.0, 30.0),
                                             (500, -30.0, 30.0),
                                             (2000, -30.0, 30.0),
                                             (1000, -20.0, 30.0)])
def test_dilate_ellipse(margin_m, dy, dx):
    """The ellipse dilation against JAX's and against the threshold of the
    host's Euclidean distance transform (geo/polygon.py:237-242)."""
    land = blobs(3, (200, 180), density=0.0005).astype(np.uint8)
    got = tmorph.dilate_ellipse(T(land), margin_m, dy, dx)
    assert got.dtype == torch.uint8
    assert_same(got, jmorph.dilate_ellipse_device(land, margin_m, dy, dx))
    dist = distance_transform_edt(land == 0, sampling=(abs(dy), abs(dx)))
    assert_same(got, (dist <= margin_m).astype(np.uint8))
    assert 0 < int(got.sum()) < got.numel()


@pytest.mark.parametrize('size,margin_km', [(160, 1), (400, 1), (400, 2)])
def test_ocean_mask_matches_host(tmp_path, size, margin_km):
    """Host rasterization + device ellipse against the reference's host
    path (rasterization + distance transform). At 400 px a land raster
    clipped to the zero-margin box differs in 3 px, so the clip box must be
    the reference's."""
    shp = synthetic.make_shoreline(str(tmp_path), size=size)
    gt = synthetic.geotransform()
    proj = CRS.from_epsg(synthetic.EPSG).to_wkt()
    want = jax_ocean_mask(shp, margin_km, str(tmp_path), gt, proj, size,
                          size)
    got = create_ocean_mask(shp, margin_km, str(tmp_path), gt, proj, size,
                            size, device=torch.device('cpu'))
    assert_same(got, want)
    assert 0.1 < 1 - want.mean() < 0.4


# ---- masking -------------------------------------------------------------

@pytest.mark.parametrize('fmask_kind', ['random', 'structured'])
def test_add_snow_cover(fmask_kind):
    rng = np.random.default_rng(4)
    fmask = (rng.integers(0, 256, SHAPE).astype(np.uint8)
             if fmask_kind == 'random' else structured_cover_fmask(SHAPE))
    wtr2 = rng.choice(np.array([0, 1, 2, 3, 4, 254, 255], np.uint8), SHAPE)
    cloud = jmasking.compute_preliminary_cloud_layer(fmask, 'cover')
    cloud = np.where(rng.random(SHAPE) < 0.05, np.asarray(cloud) | 8, cloud)
    want = jmasking.add_snow_to_cloud_layer(wtr2, cloud, fmask, 'cover')
    got = tmasking.add_snow_to_cloud_layer(T(wtr2), T(cloud), T(fmask),
                                           'cover')
    assert_same(got, want)
    # the dilations are load-bearing: 'cover' differs from 'ignore'
    ignore = tmasking.add_snow_to_cloud_layer(T(wtr2), T(cloud), T(fmask),
                                              'ignore')
    assert not torch.equal(got, ignore)


# ---- a plain model of K2's bit-packed tile ----------------------------------
# wtr_k2_kernel (ops/csrc/wtr_kernel.cu) cannot run here. This is its tile
# arithmetic in numpy integer operations: a block owns 94 x 94 output pixels
# and the 128 x 128 span around them (a 17 px halo), holds each span row of a
# plane as 128 bits (two uint64), and steps cur |= M & (up | down | left |
# right) with the carry across the word boundary.

K2_SPAN, K2_HALO, K2_TILE = 128, 17, 94
ST_CLOUD, ST_SNOW, ST_AREAS, ST_WATER, ST_INSIDE = 0x0D, 0x02, 0x10, 0x20, 0x40
_U64 = np.uint64


def _pack_rows(bits):
    """[128, 128] bool -> (lo, hi), bit c of a row is span column c."""
    weights = _U64(1) << np.arange(64, dtype=_U64)
    return ((bits[:, :64] * weights).sum(1, dtype=_U64),
            (bits[:, 64:] * weights).sum(1, dtype=_U64))


def _unpack_rows(lo, hi):
    shifts = np.arange(64, dtype=_U64)
    return np.concatenate([(lo[:, None] >> shifts) & _U64(1),
                           (hi[:, None] >> shifts) & _U64(1)], 1).astype(bool)


def _dilate_packed(cur, mask, steps):
    lo, hi = cur
    zero = np.zeros(1, _U64)
    for _ in range(steps):
        up_lo, up_hi = (np.concatenate([zero, w[:-1]]) for w in (lo, hi))
        dn_lo, dn_hi = (np.concatenate([w[1:], zero]) for w in (lo, hi))
        near_lo = up_lo | dn_lo | (lo << _U64(1)) \
            | (lo >> _U64(1)) | (hi << _U64(63))
        near_hi = up_hi | dn_hi | (hi << _U64(1)) | (lo >> _U64(63)) \
            | (hi >> _U64(1))
        lo, hi = lo | (mask[0] & near_lo), hi | (mask[1] & near_hi)
    return lo, hi


def cover_state(cloud, fmask, wtr2):
    """The state byte the per-pixel pass leaves for wtr_k2_kernel."""
    f = fmask.astype(np.int32)
    return ((cloud & ST_CLOUD)
            | np.where(f & 16, ST_SNOW, 0)
            | np.where(((f & 4) != 0) & (cloud == 0), ST_AREAS, 0)
            | np.where((wtr2 >= 1) & (wtr2 <= 4), ST_WATER, 0)
            ).astype(np.uint8)


def k2_tile_model(state, row0=0, rows_out=None, halo=K2_HALO):
    """The snow bit of rows row0 .. row0 + rows_out - 1 of a [H, W] block of
    state bytes, tile by tile as wtr_k2_kernel computes it (zeros beyond the
    block's rows and the image's columns)."""
    height, width = state.shape
    rows_out = height - row0 if rows_out is None else rows_out
    tile = K2_SPAN - 2 * halo
    snowed = np.zeros((rows_out, width), bool)
    for by in range(-(-rows_out // tile)):
        for bx in range(-(-width // tile)):
            y0 = row0 + by * tile - halo
            x0 = bx * tile - halo
            span = np.zeros((K2_SPAN, K2_SPAN), np.uint8)
            ys = slice(max(y0, 0), min(y0 + K2_SPAN, height))
            xs = slice(max(x0, 0), min(x0 + K2_SPAN, width))
            span[ys.start - y0:ys.stop - y0, xs.start - x0:xs.stop - x0] = \
                state[ys, xs] | ST_INSIDE
            snow = _pack_rows((span & ST_SNOW) != 0)
            areas = _pack_rows((span & ST_AREAS) != 0)
            both = ST_AREAS | ST_WATER
            areas_water = _pack_rows((span & both) == both)
            clear = _pack_rows((span & (ST_CLOUD | ST_INSIDE)) == ST_INSIDE)
            snow = _dilate_packed(snow, areas, 10)
            unmask = _dilate_packed((~snow[0] & clear[0], ~snow[1] & clear[1]),
                                    areas_water, 7)
            bits = _unpack_rows(snow[0] & ~unmask[0], snow[1] & ~unmask[1])
            # the tile's own pixels, inside the window and the image
            n_rows = min(tile, row0 + rows_out - (y0 + halo))
            n_cols = min(tile, width - (x0 + halo))
            oy, ox = by * tile, bx * tile
            snowed[oy:oy + n_rows, ox:ox + n_cols] = \
                bits[halo:halo + n_rows, halo:halo + n_cols]
    return snowed


@pytest.mark.parametrize('steps', [1, 7, 10, 17])
def test_packed_dilation_matches_morphology(steps):
    """One span: the packed recurrence == the masked cross dilation of
    ops/morphology.py (and scipy's) on the unpacked bits."""
    cur = blobs(11, (K2_SPAN, K2_SPAN), density=0.01)
    cur[:, 63] |= blobs(12, (K2_SPAN, K2_SPAN))[:, 0]   # at the word seam
    mask = ~blobs(13, (K2_SPAN, K2_SPAN), density=0.05)
    got = _unpack_rows(*_dilate_packed(_pack_rows(cur), _pack_rows(mask),
                                       steps))
    assert_same(got, tmorph.binary_dilation_masked(T(cur), steps, T(mask)))
    assert_same(got, binary_dilation(cur, iterations=steps, mask=mask))
    assert_same(_unpack_rows(*_pack_rows(cur)), cur)


def _cover_inputs(seed, shape, fmask_kind):
    rng = np.random.default_rng(seed)
    fmask = (rng.integers(0, 256, shape).astype(np.uint8)
             if fmask_kind == 'random' else structured_cover_fmask(shape))
    wtr2 = rng.choice(np.array([0, 1, 2, 3, 4, 254, 255], np.uint8), shape)
    cloud = np.asarray(jmasking.compute_preliminary_cloud_layer(fmask,
                                                                'cover'))
    cloud = np.where(rng.random(shape) < 0.05, cloud | 8, cloud)
    return fmask, wtr2, cloud.astype(np.uint8)


@pytest.mark.parametrize('fmask_kind', ['random', 'structured'])
@pytest.mark.parametrize('shape', [(200, 150), (95, 189), (94, 94), (1, 300),
                                   (283, 17)])
def test_k2_tile_model_matches_cover_masking(shape, fmask_kind):
    """Sizes that are no multiple of the 94 px tile: the tiled bit-plane
    model == the reference's 'cover' masking and the port's."""
    fmask, wtr2, cloud = _cover_inputs(14, shape, fmask_kind)
    snowed = k2_tile_model(cover_state(cloud, fmask, wtr2))
    got = np.where(wtr2 == 255, 255, cloud + 2 * snowed).astype(np.uint8)
    assert_same(got, jmasking.add_snow_to_cloud_layer(wtr2, cloud, fmask,
                                                      'cover'))
    assert_same(got, tmasking.add_snow_to_cloud_layer(
        T(wtr2), T(cloud), T(fmask), 'cover'))
    if shape[0] > 90:
        assert snowed.any() and not snowed.all()


@pytest.mark.parametrize('window', [(0, 60), (17, 100), (106, 94), (95, 105),
                                    (199, 1), (53, 147)])
def test_k2_tile_model_row_windows(window):
    """A window whose first row is no multiple of the tile: the rows of the
    whole block's result."""
    fmask, wtr2, cloud = _cover_inputs(15, (200, 150), 'structured')
    state = cover_state(cloud, fmask, wtr2)
    whole = k2_tile_model(state)
    row0, rows = window
    assert_same(k2_tile_model(state, row0, rows), whole[row0:row0 + rows])
    # a shard's block: its own rows and a 17 px halo are enough
    lo, hi = max(row0 - K2_HALO, 0), min(row0 + rows + K2_HALO, 200)
    assert_same(k2_tile_model(state[lo:hi], row0 - lo, rows),
                whole[row0:row0 + rows])


@pytest.mark.parametrize('transpose', [False, True], ids=['row', 'column'])
def test_k2_halo_is_load_bearing(transpose):
    """Snow next to a tile seam, with a clear pixel that un-masks it from
    the far side of the seam: the 17 px halo sees that pixel and agrees
    with the reference; a 3 px halo does not, and keeps snow the reference
    takes back."""
    fmask = np.full((1, 230), 4, np.uint8)          # adjacent, clear
    seam = K2_SPAN - 2 * 3                           # of the 3 px halo's tiles
    fmask[0, seam - 14:seam + 4] |= 16               # snow across the seam
    fmask[0, seam + 4] = 0                           # clear, not adjacent
    wtr2 = np.ones_like(fmask)                       # all water
    if transpose:
        fmask, wtr2 = fmask.T.copy(), wtr2.T.copy()
    cloud = np.zeros_like(fmask)
    state = cover_state(cloud, fmask, wtr2)
    want = np.asarray(jmasking.add_snow_to_cloud_layer(wtr2, cloud, fmask,
                                                       'cover')) == 2
    assert_same(k2_tile_model(state), want)
    assert want.ravel()[seam - 17:seam - 3].all() and want.sum() == 14
    short = k2_tile_model(state, halo=3)
    assert short.ravel()[seam - 3:seam].all()
    assert not want.ravel()[seam - 3:seam].any()


# ---- the chain -----------------------------------------------------------

def _bands(dtype, seed, shape=SHAPE):
    inp = make_inputs(seed, shape)
    if dtype == 'float32':
        inp['bands'] = scaled_bands(np.random.default_rng(seed), shape,
                                    HlsThresholds())
    return inp


@pytest.mark.parametrize('dtype,mode', list(itertools.product(
    ('int16', 'float32'), ('mask', 'ignore', 'cover'))))
def test_chain_dtype_mode(dtype, mode):
    jcfg = jchain.DswxChainConfig(mask_adjacent_to_cloud_mode=mode)
    tcfg = tchain.DswxChainConfig.from_reference(jcfg)
    inp = _bands(dtype, 31)
    inp['fmask'][:, :64] = structured_cover_fmask((SHAPE[0], 64))
    extras = {'ocean_mask': inp['ocean'], 'shadow_layer': inp['shadow'],
              'landcover_mask': inp['landcover']}
    want = jchain.dswx_chain(*inp['bands'], inp['fmask'], inp['invalid'],
                             jcfg, **extras)
    got = tchain.dswx_chain(*[T(b) for b in inp['bands']], T(inp['fmask']),
                            T(inp['invalid']), tcfg,
                            **{k: T(v) for k, v in extras.items()})
    assert sorted(got) == sorted(want)
    for name in want:
        if name.startswith('n_'):
            assert int(got[name]) == int(want[name]), name
        else:
            assert_same(got[name], want[name], name)


# ---- the kernel module ---------------------------------------------------

# the float32 Pallas kernel is slow in interpret mode: two of its cases
COVER_KERNEL_CASES = (
    list(itertools.product(('int16',), ('random', 'structured'),
                           (True, False), (True, False)))
    + [('float32', 'structured', True, True),
       ('float32', 'random', False, False)])


@pytest.mark.parametrize('dtype,fmask_kind,with_ancillaries,browse',
                         COVER_KERNEL_CASES)
def test_cover_kernel_plain_matches_pallas_interpret(dtype, fmask_kind,
                                                     with_ancillaries,
                                                     browse):
    """K2's plain version (the CPU path of ``wtr_layers``) against the
    Pallas kernel's 'cover' mode, whose halo blocks of 32 rows the snow
    stripes cross."""
    jcfg = jchain.DswxChainConfig(
        mask_adjacent_to_cloud_mode='cover',
        not_water_in_browse='nodata' if with_ancillaries else 'white')
    tcfg = tchain.DswxChainConfig.from_reference(jcfg)
    inp = _bands(dtype, 41, (96, 128))
    if fmask_kind == 'structured':
        inp['fmask'] = structured_cover_fmask((96, 128))
    extras = ('ocean', 'shadow', 'landcover') if with_ancillaries else ()
    kernel = make_wtr_kernel(jcfg, with_ocean=with_ancillaries,
                             with_shadow=with_ancillaries,
                             with_landcover=with_ancillaries,
                             compute_browse=browse, block_rows=32,
                             interpret=True,
                             float_inputs=dtype == 'float32')
    want = kernel(*[jnp.asarray(b) for b in inp['bands']],
                  jnp.asarray(inp['fmask']), jnp.asarray(inp['invalid']),
                  *[jnp.asarray(inp[k]) for k in extras])
    got = wtr_kernel.wtr_layers(*[T(b) for b in inp['bands']],
                                T(inp['fmask']), T(inp['invalid']), tcfg,
                                compute_browse=browse,
                                **{k: T(inp[k]) for k in extras})
    assert sorted(got) == sorted([*want, *wtr_kernel.COUNTS])
    for name in want:
        assert_same(got[name], want[name], name)


# ---- a whole product run: 'cover' + ocean masking ------------------------

SIZE = 160


@pytest.fixture(scope='module')
def cover_products(tmp_path_factory):
    """One tile through both packages: 'cover' mode, the Fmask of
    ``cover_tile_fmask`` and ocean masking with the synthetic shoreline."""
    root = tmp_path_factory.mktemp('cover_e2e')
    inputs = _inputs(root)
    fmask_file = [f for f in inputs['input_list'] if f.endswith('Fmask.tif')]
    with TiffReader(fmask_file[0]) as r:
        fmask = cover_tile_fmask(r.read())
        md = r.metadata()
    write_cog(fmask_file[0], fmask, geotransform=synthetic.geotransform(),
              epsg=synthetic.EPSG, nodata=255, metadata=md,
              overview_levels=())
    inputs.update(
        mask_adjacent_to_cloud_mode='cover', apply_ocean_masking=True,
        shoreline_shapefile=synthetic.make_shoreline(str(root), size=SIZE))
    dirs = {}
    for name, fn, extra in (('jax', jax_generate, {}),
                            ('torch', generate_dswx_layers,
                             {'device': torch.device('cpu')})):
        out_dir = str(root / name)
        os.makedirs(out_dir)
        assert fn(**inputs, **_outputs(out_dir), **extra) is True
        dirs[name] = out_dir
    return fmask, dirs


@pytest.mark.parametrize('name', [f'B{nn:02}_{layer}.tif' for nn, layer in
                                  enumerate(LAYERS, start=1)]
                         + ['BROWSE.tif'])
def test_cover_ocean_product_matches_jax(cover_products, name):
    _, dirs = cover_products
    want_path = os.path.join(dirs['jax'], name)
    got_path = os.path.join(dirs['torch'], name)
    with TiffReader(want_path) as r:
        want = r.read()
        want_md = r.metadata()
    with TiffReader(got_path) as r:
        got = r.read()
        got_md = r.metadata()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert compare_dswx_hls_products(want_path, got_path)
    for key in ('SPATIAL_COVERAGE', 'SPATIAL_COVERAGE_EXCLUDING_MASKED_OCEAN',
                'CLOUD_COVERAGE'):
        assert got_md.get(key) == want_md.get(key), key


def test_cover_ocean_product_is_not_trivial(cover_products):
    """Snow grew into clear adjacent pixels, and the east of the tile is
    ocean."""
    fmask, dirs = cover_products
    with TiffReader(os.path.join(dirs['torch'], 'B09_CLOUD.tif')) as r:
        cloud = r.read()
    with TiffReader(os.path.join(dirs['torch'], 'B05_WTR-1.tif')) as r:
        wtr1 = r.read()
    grown = (cloud != 255) & ((cloud & 2) != 0) & ((fmask & 16) == 0)
    assert int(grown.sum()) > 0
    ocean = wtr1 == 254
    assert 0.1 < ocean.mean() < 0.4
    assert not ocean[:, :int(0.6 * SIZE)].any()
