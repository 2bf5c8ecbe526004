"""The devices a campaign spreads its tile batches over.

Counterpart of ``proteus_tpu/parallel/mesh.py::make_tile_mesh``: a
campaign batch of whole tiles is split over a list of devices in order,
each device running the same fused chain on its share. The JAX package's
``Mesh`` and shardings have no counterpart; the only cross-device step is
the sum of the campaign totals, which the runner takes in Python integers.
"""

import torch


def make_tile_mesh(devices=None):
    """The campaign's devices, a list of ``torch.device``: the given ones,
    or every visible CUDA device. Raises when none is visible (the port
    never picks the CPU on its own)."""
    if devices is not None:
        devices = [torch.device(d) for d in devices]
        if not devices:
            raise ValueError('make_tile_mesh: the device list is empty')
        return devices
    if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
        raise RuntimeError('make_tile_mesh: no CUDA device is visible '
                           '(pass devices=[torch.device("cpu")] * n for '
                           'the CPU)')
    return [torch.device('cuda', k) for k in range(torch.cuda.device_count())]
