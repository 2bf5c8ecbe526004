"""Build the native tiffturbo codec (g++ -O3 -shared).

Prefers libdeflate for the DEFLATE paths (5-25x faster than zlib on raster
tiles); falls back to a zlib-only build when libdeflate headers are absent.
The library is built from ``tiffturbo.cpp`` beside this file into
``build/torch_native/`` at the root of the checkout (an installed copy,
which has no checkout around it, builds into
``~/.cache/proteus_tpu_torch/native/``), under a name keyed by a hash of
the source, and a text file beside it names the DEFLATE library it linked
(``libdeflate`` or ``zlib``).

Usage: python -m proteus_tpu_torch.native.build
"""

import hashlib
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, 'tiffturbo.cpp')
_CHECKOUT = os.path.dirname(os.path.dirname(HERE))
if os.path.isfile(os.path.join(_CHECKOUT, 'setup.py')):
    BUILD_DIR = os.path.join(_CHECKOUT, 'build', 'torch_native')
else:
    BUILD_DIR = os.path.join(os.path.expanduser('~'), '.cache',
                             'proteus_tpu_torch', 'native')


def _stem():
    with open(SRC, 'rb') as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f'libtiffturbo_{digest}')


def lib_path():
    """Where the library for the current source lives (built or not)."""
    return _stem() + '.so'


def linked():
    """'libdeflate' or 'zlib' for a built library, else None."""
    path = _stem() + '.linked'
    if not os.path.isfile(path):
        return None
    with open(path) as fh:
        return fh.read().strip()


def build(verbose=True):
    lib = lib_path()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f'{_stem()}.{os.getpid()}.tmp.so'
    base = ['g++', '-O3', '-march=native', '-shared', '-fPIC',
            '-std=c++17', SRC, '-o', tmp]
    attempts = [
        ('libdeflate', base + ['-DTT_USE_LIBDEFLATE', '-ldeflate',
                               '-lpthread']),
        ('zlib', base + ['-lz', '-lpthread']),
    ]
    last_err = None
    for name, cmd in attempts:
        if verbose:
            print(' '.join(cmd))
        try:
            subprocess.run(cmd, check=True, capture_output=not verbose)
        except subprocess.CalledProcessError as exc:
            last_err = exc
            continue
        with open(_stem() + '.linked', 'w') as fh:
            fh.write(name + '\n')
        os.replace(tmp, lib)
        return lib
    raise last_err


def lib_is_fresh():
    return os.path.isfile(lib_path()) and linked() is not None


if __name__ == '__main__':
    build()
    print(f'built {lib_path()} ({linked()})')
    sys.exit(0)
