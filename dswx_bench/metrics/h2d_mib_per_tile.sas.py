"""The SAS's host-to-device MiB a product: ``h2d_mib_per_tile.py``'s
reading."""

from dswx_bench.registry import reader

read = reader('h2d_mib_per_tile')
