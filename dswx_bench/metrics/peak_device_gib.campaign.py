"""The device memory the campaign's window reached at its peak, in GiB:
``peak_device_gib.py``'s reading. The readers' warps and shadows overlap
as the threads happen to run, so it spreads from run to run by more than
an end-to-end bound may (PERF.md); it is recorded here, unbounded."""

from dswx_bench.registry import reader

read = reader('peak_device_gib')
