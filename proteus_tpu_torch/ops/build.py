"""Build the port's CUDA kernels with nvcc into a shared library.

Each ``csrc/*.cu`` file has a plain C entry point and is compiled on its
own (with the ``csrc/*.cuh`` headers it includes) for Hopper
(``sm_90a``) into ``build/torch_kernels/`` at the root of the checkout (an
installed copy, which has no checkout around it, builds into
``~/.cache/proteus_tpu_torch/kernels/``), under a name keyed by a hash of
the source, the headers and the flags, so a changed source is rebuilt and
an unchanged one is reused. The library is loaded with ``ctypes``; it
includes no PyTorch header, so a build takes seconds. Nothing here runs at
import time. ``runtime.profiling.COUNTERS`` counts the libraries loaded
(``kernels.loaded``) and built (``kernels.built``, with
``kernels.build_ms``), so a build inside a measured window shows; each
load is the tracer's span ``kernel.build``.

Usage (on a machine with nvcc): python -m proteus_tpu_torch.ops.build
"""

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import sys
import time

from proteus_tpu_torch.runtime.profiling import COUNTERS, TRACER

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'csrc')
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if os.path.isfile(os.path.join(_CHECKOUT, 'setup.py')):
    BUILD_DIR = os.path.join(_CHECKOUT, 'build', 'torch_kernels')
else:
    BUILD_DIR = os.path.join(os.path.expanduser('~'), '.cache',
                             'proteus_tpu_torch', 'kernels')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')


@dataclasses.dataclass
class Built:
    """A compiled kernel library: its path, the build's wall time (0 when
    an earlier build was reused) and nvcc's output (register use)."""
    path: str
    seconds: float
    log: str
    lib: ctypes.CDLL


_LOADED = {}  # source name -> Built, one load per process


def nvcc_path():
    found = shutil.which('nvcc')
    if found:
        return found
    home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH') \
        or '/usr/local/cuda'
    path = os.path.join(home, 'bin', 'nvcc')
    if not os.path.isfile(path):
        raise RuntimeError('nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)')
    return path


def build(name):
    """Compile ``csrc/<name>.cu`` (if not built yet) and load it."""
    if name in _LOADED:
        return _LOADED[name]
    with TRACER.span('kernel.build'):
        built = _build(name)
    COUNTERS.add('kernels.loaded')
    if built.seconds:
        COUNTERS.add('kernels.built')
        COUNTERS.add('kernels.build_ms', round(built.seconds * 1e3))
    _LOADED[name] = built
    return built


def _build(name):
    src = os.path.join(CSRC, f'{name}.cu')
    digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    # the source and the headers beside it that it may include
    for path in [src] + sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                               if f.endswith('.cuh')):
        with open(path, 'rb') as fh:
            digest.update(fh.read())
    stem = os.path.join(BUILD_DIR, f'{name}_{digest.hexdigest()[:16]}')
    lib_path, log_path = stem + '.so', stem + '.log'
    seconds = 0.0
    if not os.path.isfile(lib_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f'{stem}.{os.getpid()}.tmp.so'
        cmd = [nvcc_path(), *NVCC_FLAGS, '-o', tmp, src]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = ' '.join(cmd) + '\n' + proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed for {src}:\n{log}')
        with open(log_path, 'w') as fh:
            fh.write(log)
        os.replace(tmp, lib_path)
    with open(log_path) as fh:
        log = fh.read()
    return Built(lib_path, seconds, log, ctypes.CDLL(lib_path))


if __name__ == '__main__':
    for fname in sorted(os.listdir(CSRC)):
        if fname.endswith('.cu'):
            b = build(fname[:-3])
            print(f'{b.path} ({b.seconds:.1f} s)\n{b.log}')
    sys.exit(0)
