"""The host code of ``proteus_tpu`` that the port reuses, in one place.

Every import of the reference package by ``proteus_tpu_torch`` (and by
``chip_smoke.py``) goes through this module: HLS ingest, TIFF/COG, PNG,
VRT and shapefiles, CRS, the host half of the warp, polygon clipping and
rasterization, the runconfig and the CLI
arguments, thresholds and constants, metadata, colour tables, the product
writer and the stage timers. None of these modules imports ``jax``
(``tests/test_torch_e2e.py`` checks that in a fresh interpreter). The
reference modules that do import ``jax`` (``models``, ``ops``,
``core.f32exact``, ``runtime.orchestrator``, ``parallel``) are never
imported: the numpy helpers the port needs from them are copied next to
their port, each naming its source lines.
"""

from proteus_tpu.cli.args import get_dswx_hls_cli_parser  # noqa: F401
from proteus_tpu.config.runconfig import parse_runconfig_file  # noqa: F401
from proteus_tpu.core import constants  # noqa: F401
from proteus_tpu.core.thresholds import (  # noqa: F401
    SCALAR_MAX_DEN, SCALAR_MAX_NUM, ExactThresholds, HlsThresholds,
    to_exact_fraction)
from proteus_tpu.geo.coverage import check_ancillary_inputs  # noqa: F401
from proteus_tpu.geo.crs import CRS, transform_points  # noqa: F401
from proteus_tpu.geo.polygon import (  # noqa: F401
    clip_ring_to_rect, create_ocean_mask, rasterize_rings)
from proteus_tpu.geo.warp import (  # noqa: F401
    _KERNEL_RADIUS, GridTransformer, SourceRaster, _auto_grid_spacing,
    _dd_split, _resample_block, _resolve_window, warp_to_grid,
    worldcover_year_of)
from proteus_tpu.io import hls as hls_io  # noqa: F401
from proteus_tpu.io.cog import write_cog  # noqa: F401
from proteus_tpu.io.png import geotiff2png  # noqa: F401
from proteus_tpu.io.shapefile import read_shapefile  # noqa: F401
from proteus_tpu.io.tiff import TiffReader  # noqa: F401
from proteus_tpu.io.vrt import build_vrt  # noqa: F401
from proteus_tpu.runtime import ctables, metadata  # noqa: F401
from proteus_tpu.runtime import product_writer  # noqa: F401
from proteus_tpu.runtime.logging_util import create_logger  # noqa: F401
from proteus_tpu.runtime.profiling import StageTimers  # noqa: F401
from proteus_tpu.version import VERSION  # noqa: F401
