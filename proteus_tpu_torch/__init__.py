"""proteus_tpu_torch — the DSWx-HLS product chain in PyTorch, with CUDA
kernels written by hand for NVIDIA Hopper (sm_90a).

The package mirrors the layout of ``proteus_tpu`` so that every module has
an obvious counterpart there, and it is held bit for bit against that
package by the ``tests/test_torch_*.py`` parity tests. It never imports
``jax``: the host-only modules of ``proteus_tpu`` (GeoTIFF/COG I/O, CRS
math, the host half of the warp, runconfig, metadata and the product
writer) are imported as they are, all through ``proteus_tpu_torch.host``;
the numpy helpers that live in modules which do import ``jax`` are copied,
each copy naming its source lines.

- ``proteus_tpu_torch.device``   explicit device resolution (no fallback)
- ``proteus_tpu_torch.host``     the host code shared with ``proteus_tpu``
- ``proteus_tpu_torch.core``     error-free float32 transforms
- ``proteus_tpu_torch.models``   the per-pixel chain, LAND and SHAD
- ``proteus_tpu_torch.ops``      the fused CUDA kernel, its build, resampling
- ``proteus_tpu_torch.geo``      the device half of warp-as-gather
- ``proteus_tpu_torch.runtime``  the product orchestrator
- ``proteus_tpu_torch.cli``      the ``dswx_hls`` entry point
"""
