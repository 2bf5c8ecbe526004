"""The device warp's CUDA kernel: checks, launch and launch counts.

It replaces ``proteus_tpu/geo/warp.py::_device_resample_impl``, the jnp
function the reference runs as one ``jax.jit`` program a geometry (the
source is ``csrc/warp_kernel.cu``). ``resample`` warps a source window
onto the output grid from the double-float32 lattice and returns
``(out, amb)``, bit for bit what ``geo/warp.py::device_resample_plain``
computes, without that eager chain's full-size intermediates.

``geo/warp.py::device_resample`` dispatches on the tensors' device: it
runs ``check`` on any device, then the plain twin for CPU tensors and
``resample`` for CUDA tensors, which launches the kernel or raises. There
is no fallback from the kernel to the plain twin.
"""

import ctypes
import threading

import torch

# launches of each resampler since the counts were last reset (set a count
# to 0 to reset it); the campaign's prep threads launch concurrently
LAUNCHES = {'warp_nearest': 0, 'warp_bilinear': 0, 'warp_cubic': 0}
_LOCK = threading.Lock()

# algorithm -> (kernel code, launch count); 'cubicspline' is cubic
# convolution, as in the plain twin
_ALGORITHMS = {'nearest': (0, 'warp_nearest'),
               'bilinear': (1, 'warp_bilinear'),
               'cubic': (2, 'warp_cubic'),
               'cubicspline': (2, 'warp_cubic')}
# the lattice columns a block stages in shared memory (u, v and their
# differences to the next column, dd float32 each): a block takes an output
# row where the lattice row fits, else a chunk of one (``chunking``)
MAX_STAGED_COLUMNS = 227 * 1024 // 32
# the largest side of the output and of the lattice, and the most blocks:
# the kernel's row and column numbers and blockIdx.x are int32
MAX_SIDE = 2 ** 31 - 1


def check(data, valid, lat, spacing, algorithm):
    """Raise ValueError unless the arguments are what the kernel takes:
    a non-empty 2-D contiguous ``data`` (any type of 1, 2, 4 or 8 bytes for
    nearest, float32 for bilinear and cubic), ``valid`` None or a bool
    tensor of data's shape, four contiguous float32 lattice planes of one
    2-D shape of at least 2 x 2, a power-of-two spacing, and every tensor
    on one device."""
    if algorithm not in _ALGORITHMS:
        raise ValueError(f'device warp: unsupported algorithm {algorithm!r}')
    if spacing < 1 or spacing & (spacing - 1):
        raise ValueError(f'device warp: grid_spacing must be a power of two '
                         f'(got {spacing})')
    if data.dim() != 2 or data.numel() == 0:
        raise ValueError(f'device warp: data must be a non-empty 2-D tensor, '
                         f'not of shape {tuple(data.shape)}')
    if algorithm == 'nearest':
        if data.element_size() not in (1, 2, 4, 8):
            raise ValueError(f'device warp: nearest takes elements of 1, 2, '
                             f'4 or 8 bytes, not {data.dtype}')
    elif data.dtype != torch.float32:
        raise ValueError(f'device warp: {algorithm} takes float32 data, not '
                         f'{data.dtype}')
    if len(lat) != 4:
        raise ValueError(f'device warp: the lattice is (u_hi, u_lo, v_hi, '
                         f'v_lo), not {len(lat)} tensors')
    shape = lat[0].shape
    if len(shape) != 2 or shape[0] < 2 or shape[1] < 2:
        raise ValueError(f'device warp: a lattice plane must be 2-D and at '
                         f'least 2 x 2, not {tuple(shape)}')
    tensors = [('data', data)] + [(f'lattice plane {k}', t)
                                  for k, t in enumerate(lat)]
    if valid is not None:
        if valid.dtype != torch.bool or valid.shape != data.shape:
            raise ValueError(f'device warp: valid must be a bool tensor of '
                             f'shape {tuple(data.shape)}, not {valid.dtype} '
                             f'{tuple(valid.shape)}')
        tensors.append(('valid', valid))
    for k, t in enumerate(lat):
        if t.dtype != torch.float32 or t.shape != shape:
            raise ValueError(f'device warp: lattice plane {k} is {t.dtype} '
                             f'{tuple(t.shape)}; expected float32 '
                             f'{tuple(shape)}')
    for name, t in tensors:
        if t.device != data.device:
            raise ValueError(f'device warp: {name} is on {t.device}, data on '
                             f'{data.device}')
        if not t.is_contiguous():
            raise ValueError(f'device warp: {name} is not contiguous')


def _bind(lib):
    if lib.warp_launch.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.warp_launch.argtypes = [
            p, p, p, p, p, p, ll, ll, ll, ll, i, ll, ll, i, i,
            ctypes.c_ulonglong, i, ll, p, p, p]
        lib.warp_launch.restype = i
        lib.warp_error_string.argtypes = [i]
        lib.warp_error_string.restype = ctypes.c_char_p
    return lib


def fill_bits(fill, dtype):
    """The bits of ``fill`` in ``dtype`` as the plain twin makes it
    (``torch.tensor(fill, dtype=dtype)``), as an unsigned integer."""
    raw = torch.tensor(fill, dtype=dtype).reshape(1).view(torch.uint8)
    return int.from_bytes(bytes(raw.tolist()), 'little')


def chunking(lib, gw, spacing, out_h, out_w):
    """``(chunk, blocks)``: the output columns a block of the kernel takes
    and the blocks of the warp, as ``lib`` (a library that includes
    ``csrc/warp_kernel.cuh``) launches them (``chunk_columns``,
    ``blocks``): a block an output row where the lattice row fits in
    shared memory, else a chunk of one."""
    chunk, blocks = ctypes.c_longlong(), ctypes.c_longlong()
    fn = lib.warp_chunking
    fn.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = None
    fn(gw, spacing.bit_length() - 1, out_h, out_w, ctypes.byref(chunk),
       ctypes.byref(blocks))
    return chunk.value, blocks.value


def check_launch(lib, lat, spacing, out_h, out_w, wraps, full_width):
    """Raise ValueError unless the kernel in ``lib`` can launch this
    geometry: every side of the output and the lattice in [1, 2^31 - 1]
    (the lattice's at least 2), at most 2^31 - 1 blocks (``chunking``),
    and a wrapping source with its period."""
    gh, gw = lat[0].shape
    if not (1 <= out_h <= MAX_SIDE and 1 <= out_w <= MAX_SIDE):
        raise ValueError(f'device warp: cannot launch an output of '
                         f'{out_h} x {out_w}')
    if gh > MAX_SIDE or gw > MAX_SIDE:
        raise ValueError(f'device warp: cannot launch a lattice of '
                         f'{gh} x {gw}')
    if chunking(lib, gw, spacing, out_h, out_w)[1] > MAX_SIDE:
        raise ValueError(f'device warp: an output of {out_h} x {out_w} '
                         f'takes more than {MAX_SIDE} blocks')
    if wraps and (full_width is None or full_width < 1):
        raise ValueError('device warp: a wrapping source needs full_width')


def launch_args(data, valid, lat, spacing, out_h, out_w, algorithm, fill,
                wraps, full_width, out, amb):
    """``warp_launch``'s arguments but the stream, for tensors that
    ``check`` and ``check_launch`` passed and the outputs ``out`` and
    ``amb``."""
    gh, gw = lat[0].shape
    h, w = data.shape
    width = full_width if wraps else 0
    return (data.data_ptr(), None if valid is None else valid.data_ptr(),
            *[t.data_ptr() for t in lat], h, w, gh, gw,
            spacing.bit_length() - 1, out_h, out_w,
            _ALGORITHMS[algorithm][0], data.element_size(),
            fill_bits(fill, out.dtype), int(bool(wraps)), width,
            out.data_ptr(), amb.data_ptr())


def resample(data, valid, lat, spacing, out_h, out_w, algorithm, fill,
             wraps=False, full_width=None):
    """Launch the kernel on checked CUDA tensors (``check``); returns
    ``(out, amb)`` as ``device_resample_plain`` does."""
    from proteus_tpu_torch.ops.build import build

    device = data.device
    if device.type != 'cuda':
        raise ValueError(f'device warp: the kernel takes CUDA tensors, not '
                         f'{device}')
    lib = _bind(build('warp_kernel').lib)
    check_launch(lib, lat, spacing, out_h, out_w, wraps, full_width)
    out_dtype = data.dtype if algorithm == 'nearest' else torch.float32
    out = torch.empty((out_h, out_w), dtype=out_dtype, device=device)
    amb = torch.empty((out_h, out_w), dtype=torch.bool, device=device)
    args = launch_args(data, valid, lat, spacing, out_h, out_w, algorithm,
                       fill, wraps, full_width, out, amb)
    # the launch goes to the current device and the stream handle is that
    # device's: make the tensors' device current
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.warp_launch(*args, stream)
    if err:
        msg = lib.warp_error_string(err).decode()
        raise RuntimeError(f'warp kernel launch failed: CUDA error {err} '
                           f'({msg})')
    count(_ALGORITHMS[algorithm][1])
    return out, amb


def count(counter):
    """Add one launch to ``LAUNCHES[counter]`` (under a lock: the campaign's
    prep threads launch concurrently)."""
    with _LOCK:
        LAUNCHES[counter] += 1
