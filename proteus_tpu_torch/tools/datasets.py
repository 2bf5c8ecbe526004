"""Synthetic inputs of the port's campaign tools, written once.

A tool's tiles and ancillaries are made by the writers of
``proteus_tpu_torch/testing/synthetic.py`` into directories under the tool's
``--root``. Each directory is written behind a stamp file: a later run on
the same root finds the stamp and writes nothing, and a directory without
it (a write that was cut short) is cleared and written anew.
"""

import os
import shutil

from proteus_tpu_torch.testing import synthetic

# TileJob's ancillary keywords and the file names the writers give them
ANCILLARY_FILES = (('dem_file', 'dem.tif'),
                   ('landcover_file', 'landcover.tif'),
                   ('worldcover_file', 'worldcover.tif'),
                   ('shoreline_shapefile', 'shoreline.shp'))


def write_once(directory, stamp, write):
    """Run ``write()`` into a cleared ``directory`` unless the file
    ``stamp`` in it says that an earlier call finished; then write the
    stamp."""
    path = os.path.join(directory, stamp)
    if os.path.isfile(path):
        return
    shutil.rmtree(directory, ignore_errors=True)
    os.makedirs(directory)
    write()
    open(path, 'w').close()


def write_tile(directory, size, seed=None):
    """A synthetic HLS v2 tile's band files in ``directory`` (``seed`` None:
    the writer's default)."""
    kw = {} if seed is None else {'seed': seed}
    synthetic.make_hls_v2_dataset(directory, size=size, **kw)


def write_ancillaries(directory, size, seeds=(None, None, None)):
    """A DEM, CGLS, WorldCover (``seeds`` in that order, None the writer's
    default) and shoreline of the current synthetic grid in
    ``directory``."""
    for make, seed in zip((synthetic.make_dem, synthetic.make_landcover,
                           synthetic.make_worldcover), seeds):
        make(directory, size=size, **({} if seed is None else {'seed': seed}))
    synthetic.make_shoreline(directory, size=size)


def band_files(directory):
    """The HLS band files of a tile directory, sorted."""
    return sorted(os.path.join(directory, f) for f in os.listdir(directory)
                  if f.startswith('HLS.') and f.endswith('.tif'))


def ancillary_files(directory):
    """``TileJob``'s ancillary keywords for the files of
    ``write_ancillaries(directory, ...)``."""
    return {key: os.path.join(directory, name)
            for key, name in ANCILLARY_FILES}
