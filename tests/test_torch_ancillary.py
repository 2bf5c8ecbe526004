"""The SAS and the campaign share one definition of a tile's ancillary
layers (``models/dswx/ancillary.py``) and of its layer files
(``core/constants.py::layer_file_name``,
``runtime/product_writer.py::save_layer``), tolerance 0:

- one synthetic tile through ``generate_dswx_layers`` and through
  ``CampaignRunner`` writes the same pixels in each of the ten layers,
  and the same SHAD with 'otsu';
- the file name the runconfig derives for each layer is the campaign
  writer's;
- ``save_layer`` refuses a layer it does not know.
"""

import argparse
import glob
import os

import numpy as np
import pytest
import torch

import synthetic
from proteus_tpu_torch.config.runconfig import parse_runconfig_file
from proteus_tpu_torch.core import constants as C
from proteus_tpu_torch.io.tiff import TiffReader
from proteus_tpu_torch.models.dswx.chain import DswxChainConfig
from proteus_tpu_torch.parallel import campaign
from proteus_tpu_torch.runtime import product_writer as pw
from proteus_tpu_torch.runtime.orchestrator import generate_dswx_layers

SIZE = 64
CPU = torch.device('cpu')
# the ten layers of a product, each the keyword of generate_dswx_layers
# that names its file
LAYERS = {name: arg for name, arg in C.LAYER_NAMES_TO_ARGS_DICT.items()
          if name in C.BAND_DESCRIPTION_DICT}
# the campaign's product; the synthetic runconfig names the same
PRODUCT_ID, VERSION = 'dswx_hls_test', '0.1'


@pytest.fixture(scope='module')
def tile(tmp_path_factory):
    root = tmp_path_factory.mktemp('ancillary_tile')
    hls = str(root / 'hls')
    synthetic.make_hls_v2_dataset(hls, size=SIZE, seed=404)
    anc = dict(dem_file=synthetic.make_dem(str(root), size=SIZE),
               landcover_file=synthetic.make_landcover(str(root), size=SIZE),
               worldcover_file=synthetic.make_worldcover(str(root),
                                                         size=SIZE))
    return root, hls, sorted(glob.glob(os.path.join(hls, '*.tif'))), anc


def _sas(tile, out, algorithm):
    _, _, inputs, anc = tile
    outputs = {arg: os.path.join(out, f'{name}.tif')
               for name, arg in LAYERS.items()}
    assert generate_dswx_layers(
        inputs, **anc, **outputs, scratch_dir=os.path.join(out, 'scratch'),
        product_id='sas', check_ancillary_inputs_coverage=False,
        shadow_masking_algorithm=algorithm, device=CPU) is True
    return {name: outputs[arg] for name, arg in LAYERS.items()}


def _campaign(tile, out, algorithm):
    """The campaign's files of the tile, by layer, in the order it wrote
    them."""
    _, _, inputs, anc = tile
    campaign.ANCILLARY_CACHE.clear()
    runner = campaign.CampaignRunner(
        config=DswxChainConfig(shadow_masking_algorithm=algorithm),
        mesh=[CPU], manifest_path=os.path.join(out, 'm.json'))
    job = campaign.TileJob('t', inputs, out, product_id=PRODUCT_ID,
                           product_version=VERSION, **anc)
    stats = runner.run([job])
    campaign.ANCILLARY_CACHE.clear()
    assert stats['tiles_done'] == 1 and stats['tiles_failed'] == 0
    saved = runner.manifest.state['t']['outputs']
    return {name: next(p for p in saved if p.endswith(f'_{name}.tif'))
            for name in LAYERS}


@pytest.fixture(scope='module')
def products(tile, tmp_path_factory):
    """The SAS's and the campaign's files of the tile, by algorithm, made
    on first use."""
    made = {}

    def get(algorithm):
        if algorithm not in made:
            out = tmp_path_factory.mktemp(f'products_{algorithm}')
            made[algorithm] = (
                _sas(tile, str(out / 'sas'), algorithm),
                _campaign(tile, str(out / 'campaign'), algorithm))
        return made[algorithm]
    return get


def _pixels(path):
    with TiffReader(path) as r:
        return r.read()


@pytest.mark.parametrize('layer, algorithm',
                         [(name, 'sun_local_inc_angle') for name in LAYERS]
                         + [('SHAD', 'otsu')])
def test_sas_and_campaign_write_the_same_layer(products, layer, algorithm):
    sas, camp = products(algorithm)
    want = _pixels(sas[layer])
    got = _pixels(camp[layer])
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want, err_msg=layer)


@pytest.mark.parametrize('layer', list(LAYERS))
def test_runconfig_names_each_layer_file_as_the_campaign(tile, products,
                                                         layer):
    """The runconfig's derived file of ``layer`` in the campaign's output
    directory is the file the campaign wrote."""
    root, hls, _, anc = tile
    _, camp = products('sun_local_inc_angle')
    out = os.path.dirname(camp[layer])
    rc = synthetic.write_runconfig(str(root / f'rc_{layer}.yaml'), hls, out,
                                   str(root / 'scratch'), **anc)
    args = argparse.Namespace()
    parse_runconfig_file(rc, args)
    assert getattr(args, LAYERS[layer]) == camp[layer]
    assert os.path.basename(camp[layer]) == C.layer_file_name(
        PRODUCT_ID, VERSION, layer)


@pytest.mark.parametrize('layer', ['BROWSE', 'RGB', 'wtr', ''])
def test_save_layer_refuses_an_unknown_layer(tmp_path, layer):
    with pytest.raises(ValueError, match='unknown product layer'):
        pw.save_layer(layer, np.zeros((4, 4), np.uint8),
                      str(tmp_path / 'x.tif'), {}, (0, 30, 0, 0, 0, -30),
                      'EPSG:32615')
    assert not os.path.exists(tmp_path / 'x.tif')
