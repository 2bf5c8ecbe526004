"""Parity of the PyTorch exact terrain shadow (SHAD, 'sun_local_inc_angle')
with proteus_tpu's (JAX on the CPU) and with the host float64 decision,
tolerance 0.

Besides random terrain, the cases include DEMs built so that pixels land
in the epsilon band around the decision boundaries (where the host
re-decides them in float64): a noisy plane at the boundary, and a plane so
flat at the boundary that nearly every pixel lies in the band (the JAX
package caps its band and decides such a tile wholly on the host; the
port decides any band size pixel by pixel).
"""

import numpy as np
import pytest
import torch

import shadow_suspects
from proteus_tpu.models.dswx.shadow import \
    compute_opera_shadow_layer_exact as jax_shadow
from proteus_tpu_torch.models.dswx import shadow as tshadow

torch.set_num_threads(1)

SUN_AZ, SUN_ELEV = 152.595427, 90 - 27.085305
MIN_SLOPE, MAX_INC = -5.0, 40.0
ANGLES = (SUN_AZ, SUN_ELEV, MIN_SLOPE, MAX_INC)


def _ramp_at_boundary(n, noise, seed):
    """A plane whose terrain normal sits on the x_crit (cos incidence)
    boundary, plus float32 noise of ``noise`` metres."""
    x_crit, _ = tshadow._decision_boundaries(*ANGLES)
    tsv_x, _, tsv_z, _, _ = tshadow._sun_vector_f64(SUN_AZ, SUN_ELEV)
    lo, hi = -5.0, 0.0  # x(tn_x) is monotone on this bracket
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        x = (mid * tsv_x + tsv_z) / np.sqrt(mid * mid + 1)
        lo, hi = (mid, hi) if x < x_crit else (lo, mid)
    tn_x = 0.5 * (lo + hi)
    # tn_x = -gx / 30 with gx the column gradient of h = a * col
    a = -tn_x * 30.0
    rng = np.random.default_rng(seed)
    cols = np.arange(n, dtype=np.float64)[None, :].repeat(n, 0)
    dem = a * cols + noise * rng.standard_normal((n, n))
    return dem.astype(np.float32)


def _terrain(n, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:n, 0:n]
    dem = (120 * np.sin(xx / 7.0) * np.cos(yy / 5.0) + 0.08 * xx
           + 25 * rng.standard_normal((n, n)))
    return dem.astype(np.float32)


def _band_size(dem):
    x_crit, t_crit = tshadow._decision_boundaries(*ANGLES)
    f32 = (lambda v: torch.tensor(np.float32(v)))
    tsv = tuple(f32(v) for v in tshadow._sun_vector_f64(SUN_AZ, SUN_ELEV))
    eps_t = np.float32(tshadow._EPS_T_REL * (1.0 + min(abs(t_crit), 1e30)))
    *_, uncertain = tshadow._shadow_comparison_space(
        torch.from_numpy(dem), tsv, f32(x_crit), f32(t_crit),
        f32(tshadow._EPS_X), f32(eps_t))
    return int(uncertain.sum())


DEMS = {
    'terrain': lambda: _terrain(96, 3),
    'epsilon-band': lambda: _ramp_at_boundary(96, 2e-3, 4),
    'flat-boundary': lambda: _ramp_at_boundary(140, 0.0, 5),
}


@pytest.mark.parametrize('name', list(DEMS))
def test_shadow_matches_jax_and_host(name):
    dem = DEMS[name]()
    band = _band_size(dem)
    if name == 'epsilon-band':
        assert 0 < band < dem.size // 2
    if name == 'flat-boundary':
        assert band > dem.size // 2
    got = tshadow.compute_opera_shadow_layer_exact(torch.from_numpy(dem),
                                                   *ANGLES)
    assert got.dtype == torch.bool
    want_jax = jax_shadow(dem, *ANGLES)
    want_host = tshadow._host_shadow_exact(dem, *ANGLES)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_jax))
    np.testing.assert_array_equal(got.numpy(), want_host)
    if name != 'terrain':
        assert got.numpy().any() and not got.numpy().all()


def test_float64_dem_is_decided_on_the_host():
    dem = _terrain(64, 8).astype(np.float64)
    got = tshadow.compute_opera_shadow_layer_exact(torch.from_numpy(dem),
                                                   *ANGLES)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jax_shadow(dem, *ANGLES)))


def test_gradient_matches_numpy():
    dem = _terrain(33, 9)
    gy, gx = np.gradient(dem)
    t = torch.from_numpy(dem)
    np.testing.assert_array_equal(tshadow._np_gradient_axis(t, 0).numpy(),
                                  gy)
    np.testing.assert_array_equal(tshadow._np_gradient_axis(t, 1).numpy(),
                                  gx)


# The exact shadow of a warped DEM against the host's, in a process of its
# own: argv is the DEM file, the torch thread count ('default' or a
# number) and whether to import jax first. It warps the DEM onto the
# synthetic grid with its margin on the CPU (warp_to_grid_device) and on
# the host (warp_to_grid), and prints the pixels in which the two warped
# DEMs differ, in which compute_opera_shadow_layer_exact differs from
# _host_shadow_exact on the device-warped DEM and on the host-warped DEM
# (the whole margin DEM), and on the crop.
_FRESH_SCRIPT = r'''
import json, sys
dem_file, threads, with_jax = sys.argv[1], sys.argv[2], sys.argv[3] == '1'
if with_jax:
    import jax.numpy as jnp
    jnp.zeros(3).block_until_ready()
import numpy as np, torch
if threads != 'default':
    torch.set_num_threads(int(threads))
from proteus_tpu_torch.geo.crs import CRS
from proteus_tpu_torch.geo.warp import warp_to_grid, warp_to_grid_device
from proteus_tpu_torch.models.dswx.shadow import (
    _host_shadow_exact, compute_opera_shadow_layer_exact)
from proteus_tpu_torch.testing import synthetic
size, m = int(sys.argv[4]), 50
args = (dem_file, synthetic.geotransform(),
        CRS.from_epsg(synthetic.EPSG).to_wkt(), size, size)
dev = warp_to_grid_device(*args, resample_algorithm='cubic',
                          margin_in_pixels=m, device=torch.device('cpu'))
host = warp_to_grid(*args, resample_algorithm='cubic', margin_in_pixels=m)
md = synthetic.HLS_METADATA
angles = (float(md['MEAN_SUN_AZIMUTH_ANGLE']),
          90 - float(md['MEAN_SUN_ZENITH_ANGLE']), -5, 40)
got = compute_opera_shadow_layer_exact(dev, *angles).numpy()
d = dev.numpy()
want_dev, want_host = (_host_shadow_exact(a, *angles) for a in (d, host))
print(json.dumps({
    'threads': torch.get_num_threads(), 'jax': with_jax,
    'dem': int((~((d == host) | (np.isnan(d) & np.isnan(host)))).sum()),
    'shadow_on_device_dem': int((got != want_dev).sum()),
    'shadow_on_host_dem': int((got != want_host).sum()),
    'crop': int((got[m:-m, m:-m] != want_host[m:-m, m:-m]).sum())}))
'''


def test_shadow_matches_host_in_a_fresh_process(tmp_path):
    """Guard for a mismatch seen once in a CPU rehearsal (18-22 of
    1,210,000 px in one of several fresh processes): the synthetic 1000^2
    DEM warped with its 50 px margin, shadow against host shadow over the
    whole margin DEM, in a process of its own with one torch thread."""
    import json
    import os
    import subprocess
    import sys
    from proteus_tpu_torch.testing import synthetic
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    dem = synthetic.make_dem(str(tmp_path), size=1000)
    proc = subprocess.run(
        [sys.executable, '-c', _FRESH_SCRIPT, dem, '1', '0', '1000'],
        env=dict(os.environ, PYTHONPATH=repo), cwd=repo,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got == {'threads': 1, 'jax': False, 'dem': 0,
                   'shadow_on_device_dem': 0, 'shadow_on_host_dem': 0,
                   'crop': 0}


def test_square_roots_are_within_two_ulp():
    """``shadow._sqrt`` (the comparison spaces' square root, in place of
    ``torch.sqrt``) against NumPy's float64 square root: within 2 ULP of
    the float32 result on normal and subnormal values, 0, -0, inf and NaN
    passed through."""
    rng = np.random.default_rng(11)
    x = np.concatenate([
        rng.uniform(1.0, 2.0, 100_000), np.exp2(rng.uniform(-140, 127, 10_000)),
        [0.0, -0.0, np.inf, np.nan, 1.0, 4.0, 2.0 ** -149]]).astype(np.float32)
    got = tshadow._sqrt(torch.from_numpy(x)).numpy()
    want = np.sqrt(x.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    assert np.array_equal(np.signbit(got[ok]), np.signbit(want[ok]))
    ulps = np.abs(got[ok].view(np.int32).astype(np.int64)
                  - want[ok].view(np.int32).astype(np.int64))
    assert ulps.max() <= 2


def test_comparison_spaces_take_no_torch_sqrt(monkeypatch):
    """Neither the shadow's nor the hillshade's comparison space calls
    ``torch.sqrt``, whose CPU kernel computes one intra-op thread's share
    of its first call to about 11 bits in some processes
    (``tests/shadow_suspects.py``)."""
    def no_sqrt(*args, **kw):
        raise AssertionError('torch.sqrt called')
    dem = torch.from_numpy(_terrain(64, 12))
    monkeypatch.setattr(torch, 'sqrt', no_sqrt)
    got = tshadow.compute_opera_shadow_layer_exact(dem, *ANGLES)
    hillshade = tshadow.compute_hillshade_exact(dem, SUN_AZ, SUN_ELEV)
    monkeypatch.undo()
    np.testing.assert_array_equal(
        got.numpy(), tshadow._host_shadow_exact(dem.numpy(), *ANGLES))
    np.testing.assert_array_equal(
        hillshade.numpy(), tshadow._host_hillshade_gdal(
            dem.numpy(), SUN_AZ, SUN_ELEV, 30.0, -30.0))


@pytest.mark.parametrize('suspect', shadow_suspects.SUSPECTS)
def test_shadow_suspects_in_a_fresh_process(tmp_path, suspect):
    """Each suspect of the CPU shadow mismatch (``tests/shadow_suspects.
    py``) in a fresh process with the default threads on the synthetic
    1001^2 DEM (rows of 1,101 px, off the vector width): the shadow
    equals the host shadow, and the comparison space's first square root
    is within 2 ULP wherever ``torch.sqrt`` lands."""
    from proteus_tpu_torch.testing import synthetic
    dem = synthetic.make_dem(str(tmp_path), size=1001)
    got = shadow_suspects.run(dem, 1001, suspect)
    assert got['width'] == 1101
    assert [r['differ'] for r in got['rows']] == [0] * len(got['rows'])
    if suspect in ('ftz', 'codec-ftz'):
        assert got['flags']['calling_thread'] and got['flags']['intra_op']
    if suspect == 'first-sqrt':
        assert got['rows'][0]['case'] == 'shadow._sqrt'
        assert got['rows'][0]['max_rel'] < 2.5 * 2.0 ** -23
