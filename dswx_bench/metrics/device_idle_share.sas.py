"""The SAS's device idle share: ``device_idle_share.py``'s reading."""

from dswx_bench.registry import reader

read = reader('device_idle_share')
