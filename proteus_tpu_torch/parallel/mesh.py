"""The devices a campaign spreads its tile batches over.

Counterparts of ``proteus_tpu/parallel/mesh.py``: ``make_tile_mesh``
gives a list of devices, over which a campaign batch of whole tiles is
split in order, each device running the same fused chain on its share;
``make_tile_space_mesh`` gives rows of devices, one row a group of tiles,
each tile's rows cut over the devices of its row. The JAX package's
``Mesh`` and shardings have no counterpart; the only cross-device steps are
the sum of the campaign totals, which the runner takes in Python integers,
and, for the spatial step, the copies of each shard's halo rows.
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


def make_tile_space_mesh(n_tile, n_space, devices=None):
    """The spatial campaign's mesh: ``n_tile`` rows of ``n_space``
    ``torch.device``s, filled in order from ``devices`` (default: every
    visible CUDA device; never the CPU on its own). Raises when
    ``n_tile * n_space`` differs from the number of devices.

    A list may name one device more than once (``[cpu] * 8``,
    ``[cuda:0] * 4``): the shards then run one after the other on it.
    That is for tests, which check the spatial path on one device, not a
    way to speed anything up."""
    devices = make_tile_mesh(devices)
    if n_tile * n_space != len(devices):
        raise ValueError(f'{n_tile}x{n_space} mesh needs '
                         f'{n_tile * n_space} devices, have {len(devices)}')
    return [devices[t * n_space:(t + 1) * n_space] for t in range(n_tile)]
