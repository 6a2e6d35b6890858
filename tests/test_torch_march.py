"""The plan of the 3-D fused stages K6, K7, K14 and K15, which march in z
(``ops/mg_kernels.py`` ``march_chunk``, csrc/mg.cu ``march_chunk``,
``march_post_chunk`` and ``march_bytes``): the chunks a launch cuts a row's
column into write every fine plane of x once (and, in the pre-stages,
every coarse plane of r_c once), the post-stages' reach in z lies in the
grid or its zero ghost, and a block's shared memory fits the H100's limit,
at every (ν, dtype) the 3-D fused level takes."""

import math

import pytest
import torch

from spacetime_tpu_torch.ops.mg_kernels import (MARCH_LEAST, MARCH_TILE,
                                                march_chunk)

SMEM_PER_BLOCK = 232_448  # the most dynamic shared memory an H100 block takes
SMS = 132  # the H100's SMs

# (T, grid, lead offset, coarse planes): the serial levels of the 3-D
# solves (65³×32 and 129³×64 at K_X's and K_Y's rows, 33³×16, 17³×16),
# ragged and one-plane levels, and sharded slabs (own + 2h planes, the
# coarse pairs from plane h)
LEVELS = [(65, (63,) * 3, 0, 31), (64, (127,) * 3, 0, 63),
          (33, (31,) * 3, 0, 15), (33, (63,) * 3, 0, 31),
          (17, (15,) * 3, 0, 7), (5, (7, 9, 15), 0, 3),
          (5, (3, 17, 33), 0, 1), (1, (1, 5, 5), 0, 0),
          (17, (38, 63, 63), 3, 16), (5, (12, 9, 33), 4, 2),
          (5, (22, 9, 33), 5, 6)]


def chunk_planes(nz: int, off: int, nc: int, chunk: int):
    """Each block's fine planes of x and coarse planes of r_c, as
    csrc/mg.cu ``march_chunk`` cuts them (``march_blocks``: one chunk at
    least)."""
    for c in range(max(1, -(-nc // chunk))):
        k_lo, k_hi = c * chunk, min(c * chunk + chunk, nc)
        f_lo = 0 if c == 0 else off + 2 * k_lo
        f_hi = nz if k_lo + chunk >= nc else off + 2 * k_hi
        yield range(f_lo, f_hi), range(k_lo, k_hi)


def post_chunk_planes(nz: int, chunk: int):
    """Each block's fine planes of x in the post-stages, as csrc/mg.cu
    ``march_post_chunk`` cuts them (one chunk at least)."""
    for c in range(max(1, -(-nz // chunk))):
        yield range(c * chunk, min(c * chunk + chunk, nz))


def smem_bytes(rings: int, halo: int, dtype) -> int:
    """3·rings window planes of the tile grown by ``halo`` a side."""
    return (3 * rings * (MARCH_TILE[0] + 2 * halo) * (MARCH_TILE[1] + 2 * halo)
            * (torch.finfo(dtype).bits // 8))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nu", [2, 3])
def test_march_plan_covers_each_plane_once(nu, dtype):
    # 3(ν + 1) window planes of the tile grown by H = ν + 1 a side
    assert smem_bytes(nu + 1, nu + 1, dtype) <= SMEM_PER_BLOCK
    for T, gs, off, nc in LEVELS:
        chunk = march_chunk(T, gs, nc, SMS)
        assert chunk >= 1
        fine, coarse = [], []
        for f, k in chunk_planes(gs[0], off, nc, chunk):
            fine += f
            coarse += k
            # the residual planes a block restricts lie in the grid
            assert not k or off + 2 * k[-1] + 2 < gs[0]
        assert fine == list(range(gs[0])), (gs, off, chunk)
        assert coarse == list(range(nc)), (gs, off, chunk)
        # whole columns where they fill the card; else chunks of at least
        # two coarse planes, as many as it takes to fill it
        tiles = math.ceil(gs[1] / MARCH_TILE[0]) * math.ceil(gs[2] / MARCH_TILE[1])
        blocks = T * tiles * max(1, -(-nc // chunk))
        assert chunk == max(nc, 1) or chunk == 2 or blocks >= 2 * SMS


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nu", [2, 3])
def test_post_march_plan_covers_each_plane_once(nu, dtype):
    # 3ν window planes of the tile grown by H = ν a side
    assert smem_bytes(nu, nu, dtype) <= SMEM_PER_BLOCK
    least = MARCH_LEAST["post"]
    for T, gs, off, nc in LEVELS:
        nz = gs[0]
        chunk = march_chunk(T, gs, nz, SMS, least)
        assert chunk >= 1
        # the slabs' transfers (own + 2h planes, h = off): e_c carries the
        # mesh's hc = (h + 2) // 2 coarse halo planes and the fine plane l
        # reads its planes ⌊(l + s)/2⌋, ⌊(l + s − 1)/2⌋, s = 2hc − h; a
        # serial grid's s is 0 and its e_c has nz // 2 planes
        if off:
            hc = (off + 2) // 2
            s, nce = 2 * hc - off, nc + 2 * hc
        else:
            s, nce = 0, nz // 2
        fine = []
        for f in post_chunk_planes(nz, chunk):
            fine += f
            assert f and len(f) <= chunk
            # stage 0 reaches ν planes past each end: grid planes, or the
            # zero ghost just beyond the grid
            for z in range(f[0] - nu, f[-1] + nu + 1):
                assert -nu <= z < nz + nu
                if 0 <= z < nz:
                    for cz in ((z + s) // 2, (z + s - 1) // 2):
                        # inside e_c, or (serial) the zero beyond it
                        assert (0 <= cz < nce) if off else (-1 <= cz <= nce)
        assert fine == list(range(nz)), (gs, chunk)
        tiles = math.ceil(gs[1] / MARCH_TILE[0]) * math.ceil(gs[2] / MARCH_TILE[1])
        blocks = T * tiles * -(-nz // chunk)
        assert chunk == max(nz, 1) or chunk == least or blocks >= 2 * SMS


def test_march_chunks_of_the_solves():
    """The chunks of the timed and solved levels: whole columns at 63³×65
    and 127³, two blocks per SM at 31³×33; the post-stages' in fine
    planes."""
    assert march_chunk(65, (63,) * 3, 31, SMS) == 31
    assert march_chunk(33, (63,) * 3, 31, SMS) == 31
    assert march_chunk(33, (127,) * 3, 63, SMS) == 63
    assert march_chunk(33, (31,) * 3, 15, SMS) == 4
    assert march_chunk(5, (7, 9, 15), 3, SMS) == 2
    post = MARCH_LEAST["post"]
    assert march_chunk(65, (63,) * 3, 63, SMS, post) == 63
    assert march_chunk(64, (127,) * 3, 127, SMS, post) == 127
    assert march_chunk(33, (127,) * 3, 127, SMS, post) == 127
    assert march_chunk(33, (31,) * 3, 31, SMS, post) == 8
    assert march_chunk(17, (15,) * 3, 15, SMS, post) == 4
    assert march_chunk(17, (38, 63, 63), 38, SMS, post) == 19
    assert march_chunk(5, (12, 9, 33), 12, SMS, post) == 4
