"""proteus_tpu_torch — the DSWx-HLS product chain in PyTorch, with CUDA
kernels written by hand for NVIDIA Hopper (sm_90a).

The package mirrors the layout of ``proteus_tpu`` so that every module has
an obvious counterpart there, and it is held bit for bit against that
package by the ``tests/test_torch_*.py`` parity tests. It imports neither
``jax`` nor anything of ``proteus_tpu``: the host code it needs (GeoTIFF/COG
I/O and the native codec, CRS math, the host half of the warp, polygons,
runconfig, metadata and the product writer) is copied from there into the
same place here, with only the JAX branches routed to the port's own device
code.

- ``proteus_tpu_torch.device``   explicit device resolution (no fallback)
- ``proteus_tpu_torch.core``     constants, thresholds, error-free transforms
- ``proteus_tpu_torch.config``   runconfig defaults, schema and validation
- ``proteus_tpu_torch.io``       HLS ingest, GeoTIFF/COG, PNG, VRT, shapefiles
- ``proteus_tpu_torch.native``   the native TIFF codec, built at first use
- ``proteus_tpu_torch.geo``      CRS, coverage, warp-as-gather, polygons
- ``proteus_tpu_torch.models``   the per-pixel chain, LAND, SHAD, host derive
- ``proteus_tpu_torch.ops``      the fused CUDA kernels and the null kernel,
  their build
- ``proteus_tpu_torch.parallel`` the campaign over the local GPUs
- ``proteus_tpu_torch.runtime``  the product orchestrator and writer, the
  product comparator, stage timers and ``torch.profiler`` tracing
- ``proteus_tpu_torch.cli``      the ``dswx_hls``, ``dswx_compare`` and
  ``dswx_campaign`` entry points
- ``proteus_tpu_torch.tools``    the kernel-profile tool and the two benches
- ``proteus_tpu_torch.testing``  the synthetic tile writers
"""

from proteus_tpu_torch.version import VERSION

__version__ = VERSION


def generate_dswx_layers(*args, **kwargs):
    """Library API (reference-compatible, plus ``device=``); see
    proteus_tpu_torch.runtime.orchestrator.generate_dswx_layers."""
    from proteus_tpu_torch.runtime.orchestrator import \
        generate_dswx_layers as f
    return f(*args, **kwargs)


def compare_dswx_hls_products(*args, **kwargs):
    from proteus_tpu_torch.runtime.compare import \
        compare_dswx_hls_products as f
    return f(*args, **kwargs)


def save_as_cog(*args, **kwargs):
    from proteus_tpu_torch.io.cog import save_as_cog as f
    return f(*args, **kwargs)
