"""Explicit device selection for the PyTorch port.

Counterpart of the ``PROTEUS_TPU_PLATFORM`` switch in
``proteus_tpu/cli/dswx_hls.py:33-36``. Nothing in the port picks a device
on its own: a CUDA device that is asked for and absent is an error, never
a silent run on the CPU.
"""

import torch


def resolve_device(name):
    """``torch.device(name)``; raises if a CUDA device is asked for and
    PyTorch sees none."""
    device = torch.device(name)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            f'device {name!r} was requested but torch.cuda.is_available()'
            ' is False')
    return device


def synchronize(device):
    """Wait for the work queued on ``device`` (a no-op on the CPU)."""
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
