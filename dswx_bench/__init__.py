"""The benchmark of the PyTorch and CUDA port of DSWx-HLS
(``proteus_tpu_torch``): ``python -m dswx_bench --help``."""
