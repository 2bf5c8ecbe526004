"""The suspects of the intermittent CPU shadow mismatch, each in a fresh
process: ``compute_opera_shadow_layer_exact`` against ``_host_shadow_exact``
on the synthetic DEM warped onto its grid with its 50 px margin on the CPU
(``warp_to_grid_device``), under

- ``ftz``: flush-to-zero and denormals-are-zero set
  (``torch.set_flush_denormal(True)``) on the calling thread before torch
  starts its intra-op threads, which inherit the flags;
- ``codec-ftz``: the same after the native codec's library is loaded;
- ``threads``: ``torch.set_num_threads(n)`` for every n from 1 to the
  cores, on the same DEM;
- ``strided``: ``_host_decide_f64`` of the whole DEM's terrain normals as
  contiguous arrays (NumPy's SIMD loops) against the same values in
  strided views (its scalar loops), and each against the device path;
- ``first-sqrt``: the first square root of the comparison space's
  ``1 + tn_x^2 + tn_y^2`` after the warp, by ``shadow._sqrt`` and then by
  ``torch.sqrt``, against NumPy's float64 square root: the largest
  relative error of each (1 ULP is 1.2e-7 there), and the rows where
  ``torch.sqrt`` is off by more than 1e-6.

Each run prints one JSON line: the pixels in which each pair differs, and
whether the flags took (a float32 subnormal product flushed on the calling
thread and in an intra-op reduction). Run it by hand, also on a machine
without jax (it imports no jax):

    python tests/shadow_suspects.py --sizes 1000 1001 --runs 3

The sizes are the synthetic tile's; a size with an odd width (1001) puts
every row's tail off the vector width. It exits 1 if any pair differs.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUSPECTS = ('ftz', 'codec-ftz', 'threads', 'strided', 'first-sqrt')

SCRIPT = r'''
import json, os, sys
dem_file, size, suspect = sys.argv[1], int(sys.argv[2]), sys.argv[3]
import numpy as np, torch
flags = {}
if suspect == 'codec-ftz':
    from proteus_tpu_torch import native
    flags['codec'] = native.codec()
if suspect in ('ftz', 'codec-ftz'):
    torch.set_flush_denormal(True)


def flushed():
    # a float32 subnormal product on the calling thread, and the sum of a
    # large tensor of them split over the intra-op threads
    one = torch.tensor(1e-30) * torch.tensor(1e-10)
    many = (torch.full((1 << 22,), 1e-30) * 1e-10).sum()
    return {'calling_thread': bool(one == 0), 'intra_op': bool(many == 0)}


flags.update(flushed())
from proteus_tpu_torch.geo.crs import CRS
from proteus_tpu_torch.geo.warp import warp_to_grid_device
from proteus_tpu_torch.models.dswx import shadow
from proteus_tpu_torch.testing import synthetic
md = synthetic.HLS_METADATA
angles = (float(md['MEAN_SUN_AZIMUTH_ANGLE']),
          90 - float(md['MEAN_SUN_ZENITH_ANGLE']), -5, 40)
dev = warp_to_grid_device(dem_file, synthetic.geotransform(),
                          CRS.from_epsg(synthetic.EPSG).to_wkt(), size, size,
                          resample_algorithm='cubic', margin_in_pixels=50,
                          device=torch.device('cpu'))
d = dev.numpy()
rows = []
if suspect == 'first-sqrt':
    gy, gx = (shadow._np_gradient_axis(dev, a) for a in (0, 1))
    sq = (gx / 30) ** 2 + (gy / 30) ** 2 + 1.0
    exact = np.sqrt(sq.numpy().astype(np.float64))
    for label, fn in (('shadow._sqrt', shadow._sqrt),
                      ('torch.sqrt', torch.sqrt)):
        rel = np.abs(fn(sq).numpy() - exact) / exact
        off = np.flatnonzero((rel > 1e-6).any(1))
        rows.append({'case': label, 'max_rel': float(rel.max()),
                     'rows_off': [int(off.min()), int(off.max())]
                     if off.size else None, 'differ': 0})
want = shadow._host_shadow_exact(d, *angles)


def compare(label):
    got = shadow.compute_opera_shadow_layer_exact(dev, *angles).numpy()
    rows.append({'case': label, 'threads': torch.get_num_threads(),
                 'differ': int((got != want).sum())})


if suspect == 'threads':
    for n in range(1, os.cpu_count() + 1):
        torch.set_num_threads(n)
        compare(f'threads {n}')
elif suspect == 'strided':
    compare('device path')
    g = np.gradient(d)
    tn_x, tn_y = -g[1] / 30, -g[0] / -30
    contiguous = shadow._host_decide_f64(tn_x, tn_y, *angles)

    def strided(a):
        s = np.empty((a.shape[0], 2 * a.shape[1]), a.dtype)
        s[:, ::2] = a
        return s[:, ::2]

    s = shadow._host_decide_f64(strided(tn_x), strided(tn_y), *angles)
    rows.append({'case': 'strided vs contiguous',
                 'differ': int((s != contiguous).sum())})
    rows.append({'case': 'contiguous vs host shadow',
                 'differ': int((contiguous != want).sum())})
elif suspect != 'first-sqrt':
    compare(suspect)
print(json.dumps({'size': size, 'suspect': suspect, 'width': d.shape[1],
                  'flags': flags, 'flushed_after': flushed(),
                  'rows': rows}))
'''


def run(dem_file, size, suspect, timeout=600):
    """One fresh process of ``suspect`` on the DEM file of the synthetic
    tile of ``size``: its JSON line as a dict."""
    proc = subprocess.run(
        [sys.executable, '-c', SCRIPT, dem_file, str(size), suspect],
        env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO,
        capture_output=True, text=True, timeout=timeout)
    if proc.returncode:
        raise RuntimeError(f'{suspect} at {size}: {proc.stderr[-3000:]}')
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--sizes', type=int, nargs='+', default=[1000, 1001])
    parser.add_argument('--runs', type=int, default=1,
                        help='fresh processes a suspect and size')
    parser.add_argument('--suspects', nargs='+', default=list(SUSPECTS),
                        choices=SUSPECTS)
    args = parser.parse_args(argv)
    sys.path.insert(0, REPO)
    from proteus_tpu_torch.testing import synthetic
    differ = 0
    with tempfile.TemporaryDirectory() as tmp:
        for size in args.sizes:
            os.makedirs(os.path.join(tmp, str(size)))
            dem = synthetic.make_dem(os.path.join(tmp, str(size)), size=size)
            for suspect in args.suspects:
                for _ in range(args.runs):
                    got = run(dem, size, suspect)
                    print(json.dumps(got), flush=True)
                    differ += sum(r['differ'] for r in got['rows'])
    print(f'pixels that differ over every run: {differ}')
    return 1 if differ else 0


if __name__ == '__main__':
    sys.exit(main())
