"""A CPU model of the windowed per-pixel launch (K6 spatial, pass A of K2 on
a shard's halo-padded block): ``ops/wtr_kernel.py::window_body``, the
launcher's choice of body, and ``window_groups`` here, the kernel's mapping
of a group to its tile, row, block index and window index, restated in
numpy.
At the cuts of ``make_spatial_campaign_step`` (tiles of 3660 and 1024 rows
in 2 and 4 shards, halo 17 and 0; a width that is no multiple of 4) it
shows that every block pixel is visited once, every window pixel is written
once at its ``[tile, y - row0, x]``, no group straddles a row and every
group's bytes are aligned to its vector in every plane type. The card holds
the launcher's report against ``window_body`` (``chip_smoke.py`` phase 3c).
"""

import os
import re

import numpy as np
import pytest

from proteus_tpu_torch.ops import wtr_kernel
from proteus_tpu_torch.parallel.campaign import SPATIAL_HALO

# a base address aligned to every vector, as the caching allocator's
# 512-byte blocks are
ADDRESS = 1 << 20
# itemsizes of the planes a launch touches: int16 and float32 bands, DIAG
# (uint16), the uint8 planes (fmask, invalid, ancillaries, layers, state)
ITEMSIZES = (2, 4, 2, 1)


def _cut(height, shards, halo):
    """(a0, a1, r0, r1) of each row shard, as make_spatial_campaign_step
    cuts a tile: its padded block [a0, a1) and its own rows [r0, r1)."""
    hl = height // shards
    return [(max(0, j * hl - halo), min(height, (j + 1) * hl + halo),
             j * hl, (j + 1) * hl) for j in range(shards)]


def window_groups(batch, height, width, row0, rows, vec):
    """The groups of a windowed per-pixel launch as the kernel walks them:
    tile t is the grid row, group g of it starts at pixel p = g * vec of
    the tile (32-bit: height * width < 2^31), in row y = p // width, at
    index i = t * height * width + p of the [batch, height, width] block
    and, where row0 <= y < row0 + rows (one unsigned compare), at index
    o = (t * rows - row0) * width + p of the [batch, rows, width] window;
    o = -1 outside it. Returns int64 arrays tile, y, i, o of shape
    [batch, height * width // vec] (``vec`` from ``window_body``)."""
    hw = height * width
    if hw >= 2 ** 31 or width % vec:
        raise ValueError(f'no windowed body of {vec} px a thread for a '
                         f'{height} x {width} block')
    p = np.arange(hw // vec, dtype=np.int32) * np.int32(vec)
    y = p // np.int32(width)
    tile = np.arange(batch, dtype=np.int64)[:, None]
    inside = (y - np.int32(row0)).astype(np.uint32) < np.uint32(rows)
    i = tile * hw + p
    o = np.where(inside, (tile * rows - row0) * width + p, -1)
    return np.broadcast_to(tile, i.shape), np.broadcast_to(y, i.shape), i, o


CUTS = [(3660, 3660, shards, halo) for shards in (2, 4)
        for halo in (SPATIAL_HALO, 0)] \
    + [(1024, 1024, shards, SPATIAL_HALO) for shards in (2, 4)] \
    + [(1000, 1001, shards, SPATIAL_HALO) for shards in (2, 4)]


@pytest.mark.parametrize('batch', (1, 2, 4))
@pytest.mark.parametrize('height,width,shards,halo', CUTS)
def test_window_groups_visit_the_block_and_write_the_window_once(
        batch, height, width, shards, halo):
    for a0, a1, r0, r1 in _cut(height, shards, halo):
        block, row0, rows = a1 - a0, r0 - a0, r1 - r0
        # with halo 0 ('mask', 'ignore') the block is its window: the
        # unwindowed launch; the model holds for it all the same
        assert (rows != block) == (halo > 0)
        vec = wtr_kernel.window_body(
            width, [(ADDRESS, size) for size in ITEMSIZES])
        assert vec == (4 if width % 4 == 0 else 1)
        tile, y, i, o = window_groups(batch, block, width, row0, rows,
                                      vec)
        assert i.shape == (batch, block * width // vec)
        x = i - tile * block * width - y.astype(np.int64) * width
        # a group lies in one row of one tile
        assert ((x >= 0) & (x + vec <= width)).all()
        assert ((y >= 0) & (y < block)).all()
        # every block pixel once: groups of vec consecutive pixels, in order
        assert np.array_equal(i.ravel(),
                              np.arange(0, batch * block * width, vec))
        # the window test and every window pixel once, at [t, y - row0, x]
        inside = o >= 0
        assert np.array_equal(inside, (y >= row0) & (y < row0 + rows))
        assert np.array_equal(
            o[inside],
            (tile * rows * width + (y.astype(np.int64) - row0) * width
             + x)[inside])
        assert np.array_equal(o[inside],
                              np.arange(0, batch * rows * width, vec))
        # each group's first byte aligned to its vector in every plane type
        for size in sorted(set(ITEMSIZES)):
            assert ((ADDRESS + i * size) % (vec * size) == 0).all()
            assert ((ADDRESS + o[inside] * size) % (vec * size) == 0).all()


@pytest.mark.parametrize('width,shift,itemsize,vec', [
    (3660, 0, 2, 4),      # aligned int16 band
    (3660, 2, 2, 1),      # int16 band one element into its buffer
    (3660, 8, 4, 1),      # float32 band 8 B in: not its 16 B vector
    (3660, 16, 4, 4),     # ... 16 B in: aligned
    (3660, 1, 1, 1),      # uint8 plane one byte in
    (3660, 4, 1, 4),      # uint8 plane 4 B in: aligned
    (3660, 4, 2, 1),      # DIAG 2 elements in: not its 8 B vector
    (1001, 0, 2, 1),      # a width that is no multiple of 4
    (1002, 0, 1, 1),
    (1024, 0, 4, 4),
])
def test_window_body_takes_one_pixel_off_its_vector(width, shift, itemsize,
                                                     vec):
    planes = [(ADDRESS, size) for size in ITEMSIZES]
    planes.append((ADDRESS + shift, itemsize))
    assert wtr_kernel.window_body(width, planes) == vec


def test_window_groups_refuse_what_the_launcher_refuses():
    with pytest.raises(ValueError):
        window_groups(1, 1000, 1001, 17, 500, 4)
    with pytest.raises(ValueError):
        window_groups(1, 2 ** 16, 2 ** 15, 0, 10, 4)


def test_window_vector_is_the_kernels():
    """WINDOW_VEC is the kernel source's kWindowVec."""
    src = os.path.join(os.path.dirname(wtr_kernel.__file__), 'csrc',
                       'wtr_kernel.cu')
    with open(src) as fh:
        found = re.search(r'constexpr int kWindowVec = (\d+);', fh.read())
    assert int(found.group(1)) == wtr_kernel.WINDOW_VEC
