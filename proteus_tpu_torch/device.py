"""Explicit device selection for the PyTorch port.

Counterpart of the ``PROTEUS_TPU_PLATFORM`` switch in
``proteus_tpu/cli/dswx_hls.py:33-36``. Nothing in the port picks a device
on its own: a CUDA device that is asked for and absent is an error, never
a silent run on the CPU. ``to_device`` and ``to_host`` make the
product paths' copies between the host and a device, and count their
bytes by call site.
"""

import torch

from proteus_tpu_torch.runtime.profiling import COUNTERS


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


def _same_device(a, b):
    """Whether tensors on ``a`` are on ``b`` (a CUDA device without an
    index is the current one)."""
    if a.type != b.type:
        return False
    if a.type != 'cuda' or a.index == b.index:
        return True
    current = torch.cuda.current_device()
    return (a.index if a.index is not None else current) == \
        (b.index if b.index is not None else current)


def to_device(x, device, site):
    """``x`` (a tensor, or an array ``torch.as_tensor`` takes) on
    ``device``. A copy that crosses devices is counted in
    ``runtime.profiling.COUNTERS``: its bytes under ``h2d_bytes.<site>``
    from the host, ``d2d_bytes.<site>`` from another device."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
    device = torch.device(device)
    if _same_device(t.device, device):
        return t
    kind = 'h2d' if t.device.type == 'cpu' else 'd2d'
    COUNTERS.add(f'{kind}_bytes.{site}', t.numel() * t.element_size())
    return t.to(device)


def to_host(t, site):
    """A tensor's copy on the host as a numpy array; a copy from a device
    is counted under ``d2h_bytes.<site>``."""
    if t.device.type != 'cpu':
        COUNTERS.add(f'd2h_bytes.{site}', t.numel() * t.element_size())
    return t.cpu().numpy()
