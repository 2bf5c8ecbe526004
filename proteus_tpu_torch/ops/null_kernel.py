"""The traffic-floor null kernel and its plain twin.

It replaces the Pallas TPU kernel ``tools/kernel_profile.py::_null_kernel``
(the source is ``csrc/null_kernel.cu``): every input plane of the
production footprint is read once, cast to int32, XOR-folded, and the low
byte stored as one uint8 plane. It is the least work a kernel with the
product kernels' inputs can do, so its time is the floor that K1 to K6 are
read against (``proteus_tpu_torch.tools.kernel_profile``).

Dispatch follows the tensors' device and nothing else: CUDA tensors launch
the kernel (or raise), CPU tensors run ``null_fold_plain``. There is no
fallback from the kernel to the plain twin.
"""

import ctypes

import torch

# launches of the kernel since the count was last reset (set it to 0 to
# reset it)
LAUNCHES = {'null': 0}

MAX_INPUTS = 8  # kMaxInputs in csrc/null_kernel.cu
_TYPE_CODES = {torch.uint8: 0, torch.bool: 0, torch.int16: 1,
               torch.float32: 2}


def null_fold_plain(*inputs):
    """The kernel's function in plain PyTorch (any device): each input
    cast to int32 (float32 truncates toward zero), XOR-folded, the low 8
    bits as uint8."""
    acc = torch.zeros_like(inputs[0], dtype=torch.int32)
    for t in inputs:
        acc = acc ^ t.to(torch.int32)
    return (acc & 0xFF).to(torch.uint8)


def _check(inputs):
    if not 1 <= len(inputs) <= MAX_INPUTS:
        raise ValueError(f'null_fold: takes 1 to {MAX_INPUTS} inputs, not '
                         f'{len(inputs)}')
    first = inputs[0]
    for k, t in enumerate(inputs):
        if t.device != first.device:
            raise ValueError(f'null_fold: input {k} is on {t.device}, not '
                             f'{first.device}')
        if t.dtype not in _TYPE_CODES:
            raise ValueError(f'null_fold: input {k} has dtype {t.dtype}; '
                             f'expected one of {tuple(_TYPE_CODES)}')
        if t.shape != first.shape:
            raise ValueError(f'null_fold: input {k} has shape '
                             f'{tuple(t.shape)}; expected '
                             f'{tuple(first.shape)}')
        if not t.is_contiguous():
            raise ValueError(f'null_fold: input {k} is not contiguous')
    if first.numel() == 0:
        raise ValueError('null_fold: the inputs are empty')


def _bind(lib):
    if lib.null_fold_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.null_fold_launch.argtypes = [
            ctypes.POINTER(p), ctypes.POINTER(i), i, p, ctypes.c_longlong,
            ctypes.POINTER(i), p]
        lib.null_fold_launch.restype = i
        lib.null_error_string.argtypes = [i]
        lib.null_error_string.restype = ctypes.c_char_p
    return lib


def null_fold(*inputs):
    """XOR-fold the inputs (uint8, bool, int16 or float32 tensors of one
    shape on one device, the types mixed freely) into one uint8 tensor of
    that shape: the CUDA kernel for CUDA tensors, ``null_fold_plain`` for
    CPU tensors."""
    _check(inputs)
    device = inputs[0].device
    if device.type == 'cpu':
        return null_fold_plain(*inputs)
    if device.type != 'cuda':
        raise ValueError(f'null_fold: unsupported device {device}')
    return _launch(inputs)[0]


def _launch(inputs):
    """Launch the kernel on checked CUDA tensors. Returns the output and
    whether the 8-pixel vector kernel ran (every pointer aligned to its
    vector) rather than the scalar one alone."""
    from proteus_tpu_torch.ops.build import build

    device = inputs[0].device
    lib = _bind(build('null_kernel').lib)
    out = torch.empty(inputs[0].shape, dtype=torch.uint8, device=device)
    n = len(inputs)
    pointers = (ctypes.c_void_p * n)(*[t.data_ptr() for t in inputs])
    types = (ctypes.c_int * n)(*[_TYPE_CODES[t.dtype] for t in inputs])
    vectorized = ctypes.c_int(0)
    # the launch goes to the current device and the stream handle is that
    # device's: make the tensors' device current
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.null_fold_launch(pointers, types, n, out.data_ptr(),
                                   out.numel(), ctypes.byref(vectorized),
                                   stream)
    if err:
        msg = lib.null_error_string(err).decode()
        raise RuntimeError(f'null kernel launch failed: CUDA error {err} '
                           f'({msg})')
    LAUNCHES['null'] += 1
    return out, bool(vectorized.value)
