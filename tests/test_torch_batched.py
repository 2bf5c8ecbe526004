"""The batched entry point of the fused kernel (kernel slices K4, K5 and K6)
against proteus_tpu, tolerance 0: its plain version with packed outputs,
device scale and float32 bands against the Pallas kernel in interpret
mode, tile by tile, and its full outputs against the single-tile entry
point; the packing against JAX's.
"""

import jax
import numpy as np
import pytest
import torch

from proteus_tpu.models.dswx.chain import DswxChainConfig as JaxConfig
from proteus_tpu.ops.pallas.wtr_kernel import make_wtr_kernel
from proteus_tpu.parallel import campaign as jcampaign
from proteus_tpu_torch.models.dswx import host_derive as tderive
from proteus_tpu_torch.models.dswx.chain import DswxChainConfig
from proteus_tpu_torch.ops import wtr_kernel

torch.set_num_threads(1)

KINDS = ('int16', 'float32', 'device_scale')


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def batch_inputs(seed, kind, b, h, w):
    """[B, H, W] bands of one kind (int16 with the int16 extremes, scaled
    float32, or raw int16 with per-tile [B, 6] scales and offsets that
    differ between tiles), fmask, invalid and ancillary planes."""
    rng = np.random.default_rng(seed)
    shape = (b, h, w)
    if kind == 'int16':
        bands = []
        for _ in range(6):
            x = rng.integers(-2000, 18000, shape)
            extreme = rng.random(shape) < 0.1
            x = np.where(extreme, rng.integers(-32768, 32768, shape), x)
            bands.append(x.astype(np.int16))
    elif kind == 'float32':
        bands = [np.float32(1e-4) * np.clip(rng.integers(
            -2000, 15000, shape), 1, None).astype(np.float32)
            for _ in range(6)]
    else:
        bands = [rng.integers(-2000, 15000, shape).astype(np.int16)
                 for _ in range(6)]
    scales = offsets = None
    if kind == 'device_scale':
        scales = (np.float32(1e-4) * rng.uniform(0.5, 2.0, (b, 6))).astype(
            np.float32)
        offsets = rng.choice(np.asarray([0.0, -0.1, 0.25], np.float32),
                             (b, 6))
    return dict(
        bands=bands, scales=scales, offsets=offsets,
        fmask=rng.integers(0, 256, shape).astype(np.uint8),
        invalid=rng.random(shape) < 0.05,
        ocean=(rng.random(shape) < 0.9).astype(np.uint8),
        shadow=(rng.random(shape) < 0.8).astype(np.uint8),
        landcover=rng.choice(np.array([0, 21, 100, 121, 200, 201, 255],
                                      np.uint8), shape))


# ---- the batched kernel entry point (K4, K5, K6) --------------------------

@pytest.mark.parametrize('kind', KINDS)
@pytest.mark.parametrize('ancillaries', [False, True])
@pytest.mark.parametrize('mode', wtr_kernel.MODES)
def test_batched_plain_matches_pallas_interpret(mode, ancillaries, kind):
    """wtr_layers_batched on CPU tensors (its plain version) with minimal
    outputs at B = 3 against make_wtr_kernel(minimal_outputs=True) in
    interpret mode, tile by tile, with the same per-tile scales and
    offsets for device scale."""
    b, h, w = 3, 16, 32
    x = batch_inputs(11, kind, b, h, w)
    cfg = DswxChainConfig(mask_adjacent_to_cloud_mode=mode)
    names = ('ocean', 'shadow', 'landcover') if ancillaries else ()
    extras = {k: x[k] for k in names}
    scaled = kind == 'device_scale'
    got = wtr_kernel.wtr_layers_batched(
        *[T(a) for a in x['bands']], T(x['fmask']), T(x['invalid']), cfg,
        scales=T(x['scales']) if scaled else None,
        offsets=T(x['offsets']) if scaled else None,
        **{k: T(v) for k, v in extras.items()}, compute_browse=True,
        minimal=True)
    assert sorted(got) == sorted(wtr_kernel.PACKED + wtr_kernel.COUNTS)
    # jit: the B tiles share one trace and compile of the interpreted
    # kernel
    kernel = jax.jit(make_wtr_kernel(
        JaxConfig(mask_adjacent_to_cloud_mode=mode),
        with_ocean=ancillaries, with_shadow=ancillaries,
        with_landcover=ancillaries, interpret=True, block_rows=8,
        minimal_outputs=True, float_inputs=kind != 'int16',
        device_scale=scaled))
    for k in range(b):
        lead = [x['scales'][k], x['offsets'][k]] if scaled else []
        want = kernel(*[a[k] for a in x['bands']], x['fmask'][k],
                      x['invalid'][k], *lead, *[v[k] for v in
                                                extras.values()])
        for name in ('PACKED_A', 'PACKED_B'):
            np.testing.assert_array_equal(got[name][k].numpy(),
                                          np.asarray(want[name]),
                                          err_msg=f'tile {k} {name}')


@pytest.mark.parametrize('kind', KINDS)
def test_batched_full_outputs_match_single_tile(kind):
    """Full outputs of the batched entry point == wtr_layers tile by tile
    on the host-cast bands, browse included."""
    b, h, w = 3, 16, 24
    x = batch_inputs(12, kind, b, h, w)
    cfg = DswxChainConfig(mask_adjacent_to_cloud_mode='cover')
    scaled = kind == 'device_scale'
    got = wtr_kernel.wtr_layers_batched(
        *[T(a) for a in x['bands']], T(x['fmask']), T(x['invalid']), cfg,
        scales=T(x['scales']) if scaled else None,
        offsets=T(x['offsets']) if scaled else None, shadow=T(x['shadow']))
    for k in range(b):
        bands = [a[k] for a in x['bands']]
        if scaled:
            bands = [x['scales'][k, j] * (a.astype(np.float32)
                                          - x['offsets'][k, j])
                     for j, a in enumerate(bands)]
        want = wtr_kernel.wtr_layers(
            *[T(a) for a in bands], T(x['fmask'][k]), T(x['invalid'][k]),
            cfg, shadow=T(x['shadow'][k]))
        assert sorted(got) == sorted(want)
        for name in want:
            np.testing.assert_array_equal(got[name][k].numpy(),
                                          want[name].numpy(),
                                          err_msg=f'tile {k} {name}')


def test_kernel_slices_and_flags():
    assert wtr_kernel.kernel_slices(False, 'mask', minimal=True,
                                    batched=True) == \
        ('wtr_k1', 'wtr_k5', 'wtr_k6')
    assert wtr_kernel.kernel_slices(True, 'mask', device_scale=True,
                                    minimal=True, batched=True) == \
        ('wtr_k3', 'wtr_k4', 'wtr_k5', 'wtr_k6')
    assert wtr_kernel.kernel_slices(False, 'cover', minimal=True,
                                    batched=True) == \
        ('wtr_k1', 'wtr_k2', 'wtr_k5', 'wtr_k6')
    assert wtr_kernel.kernel_slices(True, 'cover') == ('wtr_k3', 'wtr_k2')
    flags = wtr_kernel.kernel_flags(DswxChainConfig(), False, True, True,
                                    True, minimal=True)
    assert flags.minimal == 1 and flags.compute_browse == 0
    assert wtr_kernel.kernel_slices(False, 'cover', batched=True,
                                    windowed=True) == \
        ('wtr_k1', 'wtr_k2', 'wtr_k6', 'wtr_k6_spatial')
    assert sorted(wtr_kernel.LAUNCHES) == \
        [f'wtr_k{k}' for k in range(1, 7)] + ['wtr_k6_spatial']


def test_pack_minimal_matches_jax():
    """pack_minimal (the plain twin of K5's epilogue) == JAX's
    _pack_minimal_device on one chain's layers."""
    x = batch_inputs(13, 'int16', 1, 32, 48)
    cfg = DswxChainConfig(mask_adjacent_to_cloud_mode='cover')
    out = wtr_kernel.wtr_layers(*[T(a[0]) for a in x['bands']],
                                T(x['fmask'][0]), T(x['invalid'][0]), cfg,
                                ocean=T(x['ocean'][0]))
    got = wtr_kernel.pack_minimal(out)
    diag6 = tderive.binary_representation_lut()
    decimal = np.searchsorted(diag6[:32], out['DIAG'].numpy())
    decimal[out['DIAG'].numpy() == 65535] = 32
    want = jcampaign._pack_minimal_device({
        'DIAG6': decimal.astype(np.uint8), 'CLOUD': out['CLOUD'].numpy(),
        'WTR-1': out['WTR-1'].numpy(), 'WTR-2': out['WTR-2'].numpy()})
    for name in ('PACKED_A', 'PACKED_B'):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))


def test_unpack_minimal_inverts_pack_minimal():
    x = batch_inputs(32, 'int16', 1, 24, 24)
    out = wtr_kernel.wtr_layers(*[T(a[0]) for a in x['bands']],
                                T(x['fmask'][0]), T(x['invalid'][0]),
                                DswxChainConfig(), ocean=T(x['ocean'][0]))
    packed = wtr_kernel.pack_minimal(out)
    back = tderive.unpack_minimal(packed['PACKED_A'].numpy(),
                                  packed['PACKED_B'].numpy())
    for name in ('WTR-1', 'WTR-2', 'CLOUD'):
        np.testing.assert_array_equal(back[name], out[name].numpy())
    np.testing.assert_array_equal(
        tderive.diag_binary_representation(back['DIAG6']),
        out['DIAG'].numpy())
