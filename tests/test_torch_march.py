"""The plan of the fused stages that march: the 3-D K6, K7, K14 and K15 in
z (``ops/mg_kernels.py`` ``march_chunk``, csrc/mg.cu ``march_chunk``,
``march_post_chunk`` and ``march_bytes``) and the 2-D K6, K7, K14 and K15
in y (csrc/mg.cu ``row_plan``, ``ops/mg_kernels.py`` ``march2_chunk``): the chunks a launch cuts a row's column
into write every fine plane (row) of x once (and, in the pre-stages,
every coarse one of r_c once), the post-stages' reach lies in the grid or
its zero ghost, the 2-D segments cover a row once, and a block's shared
memory fits the H100's limit, at every (ν, dtype) the fused level
takes."""

import ctypes
import itertools
import math

import pytest
import torch

from spacetime_tpu_torch.ops.mg_kernels import (MARCH_LEAST, MARCH_TILE,
                                                march2_chunk, march_chunk)

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


# The 2-D fused stages K6 and K7 march in y (``ops/mg_kernels.py``
# ``march2_chunk``, csrc/mg.cu ``row_plan``, ``row_segment``,
# ``row_pre_chunk``, ``row_post_chunk`` and ``march2_bytes``).
# (T, grid, lead offset, coarse rows): the 2-D flagship's levels at K_X's
# rows (129×511², 129×255², 65×127², 129×63²), singular2d 513² J7+6's
# finest (135 rows), cfg2's (65 and 64 × 127²,
# 65×63²), a ragged grid, one row (no coarse row), one coarse row, a row
# wider than one segment, and sharded slabs (own + 2h rows, the coarse
# pairs from row h): the (2 × 2) flagship's finest (own 256, h 3) and small
# ones at h ∈ {3, 4, 5}
LEVELS_2D = [(129, (511, 511), 0, 255), (135, (511, 511), 0, 255),
             (129, (255, 255), 0, 127),
             (65, (127, 127), 0, 63), (129, (63, 63), 0, 31),
             (64, (127, 127), 0, 63), (65, (63, 63), 0, 31),
             (5, (15, 31), 0, 7), (1, (1, 9), 0, 0), (5, (3, 17), 0, 1),
             (5, (7, 1055), 0, 3), (5, (7, 1985), 0, 3),
             (65, (262, 511), 3, 128), (5, (10, 15), 3, 2),
             (5, (20, 33), 4, 6), (5, (16, 1055), 5, 3),
             (5, (16, 1985), 5, 3)]
# csrc/mg.cu's row plan, as this file models it (held to the library's on
# the card by ``test_row_plan_is_the_librarys``): a block computes at most
# MARCH2_POINTS points of a window row, MARCH2_SLOTS a thread
# (``march2_slots``)
MARCH2_POINTS = 1024
MARCH2_SLOTS = {torch.float32: 4, torch.float64: 2}


def row_plan(nx: int, halo: int) -> tuple[int, int, int, int]:
    """(seg, nseg, wrow, points) of the 2-D march on rows of ``nx`` columns
    with halo H: the columns a block owns (the last segment takes the rest
    of the row, and a rest of fewer than H columns joins the segment before
    it), the segments of a row, the points of a window row (the ring's row
    stride) and the most points a block computes."""
    if nx <= MARCH2_POINTS:
        return nx, 1, nx + 2, nx
    seg = (MARCH2_POINTS - 2 * halo) // 32 * 32
    return seg, nx // seg + (nx % seg >= halo), seg + 2 * halo, seg + 2 * halo


def block_threads(nx: int, halo: int, dtype) -> int:
    """The threads of a 2-D march block (csrc/mg.cu ``row_plan``)."""
    return -(-row_plan(nx, halo)[3] // MARCH2_SLOTS[dtype] // 32) * 32


def row_chunk(T: int, gs, n: int, nu: int, dtype, pre: bool) -> int:
    """The 2-D march's chunk as the wrappers pick it (``_chunk``), with
    the blocks an SM holds as the H100's occupancy gives them (512
    threads, by registers; ``chip_smoke.py`` phase 2 prints them)."""
    halo = nu + pre
    resident = min(512 // block_threads(gs[1], halo, dtype), 32)
    return march2_chunk(T * row_plan(gs[1], halo)[1], n,
                        MARCH_LEAST["pre" if pre else "post"], resident, SMS,
                        2 if pre else 1, 2 * nu + pre)


def row_smem_bytes(rings: int, nx: int, halo: int, dtype) -> int:
    """3·rings window rows of the march's row plan."""
    return 3 * rings * row_plan(nx, halo)[2] * (torch.finfo(dtype).bits // 8)


def check_segments(nx: int, halo: int) -> int:
    """The segments of a row cover its columns once, start at even columns
    (multiples of 32 where the row is cut) and fit a block's window and
    points; returns the segments."""
    seg, nseg, wrow, points = row_plan(nx, halo)
    cols = []
    for s in range(nseg):
        x0 = s * seg
        x1 = nx if s == nseg - 1 else x0 + seg  # csrc/mg.cu row_segment
        assert x0 % (32 if nseg > 1 else 2) == 0
        # the window: the segment with a halo of H where it is cut, the
        # ghost column at the grid's edges; the block computes all but
        # the ghosts, and its halo columns lie in the grid
        hl, hr = (halo if x0 > 0 else 1), (halo if x1 < nx else 1)
        assert hl == 1 or x0 - halo >= 0
        assert hr == 1 or x1 + halo <= nx, (nx, halo, x0, x1)
        assert x1 - x0 + hl + hr <= wrow
        assert x1 - x0 + (hl if hl == halo else 0) + (
            hr if hr == halo else 0) <= points <= MARCH2_POINTS
        cols += range(x0, x1)
    assert cols == list(range(nx))
    # the whole row wherever it fits a block's points
    assert (nseg == 1) == (nx <= MARCH2_POINTS)
    return nseg


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nu", [2, 3])
def test_row_march_plan_covers_each_row_once(nu, dtype):
    halo, least = nu + 1, MARCH_LEAST["pre"]
    # ν + 1 rings at H = ν + 1, at the widest window a block takes
    assert row_smem_bytes(nu + 1, MARCH2_POINTS, halo,
                          dtype) <= SMEM_PER_BLOCK
    for T, gs, off, nc in LEVELS_2D:
        ny, nx = gs
        assert row_smem_bytes(nu + 1, nx, halo, dtype) <= SMEM_PER_BLOCK
        nseg = check_segments(nx, halo)
        chunk = row_chunk(T, gs, nc, nu, dtype, True)
        assert chunk >= 1
        fine, coarse = [], []
        for f, k in chunk_planes(ny, off, nc, chunk):
            fine += f
            coarse += k
            # the residual rows a block restricts lie in the grid
            assert not k or off + 2 * k[-1] + 2 < ny
        assert fine == list(range(ny)), (gs, off, chunk)
        assert coarse == list(range(nc)), (gs, off, chunk)
        # the whole column or chunks of at least the least rows; two
        # blocks an SM wherever the rows allow it
        blocks = T * nseg * max(1, -(-nc // chunk))
        most = T * nseg * max(1, -(-nc // least))
        assert chunk == max(nc, 1) or chunk >= least, (gs, chunk)
        assert blocks >= min(2 * SMS, most), (gs, chunk, blocks)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nu", [2, 3])
def test_row_post_march_plan_covers_each_row_once(nu, dtype):
    halo, least = nu, MARCH_LEAST["post"]
    assert row_smem_bytes(nu, MARCH2_POINTS, halo, dtype) <= SMEM_PER_BLOCK
    for T, gs, off, nc in LEVELS_2D:
        ny, nx = gs
        assert row_smem_bytes(nu, nx, halo, dtype) <= SMEM_PER_BLOCK
        nseg = check_segments(nx, halo)
        chunk = row_chunk(T, gs, ny, nu, dtype, False)
        assert chunk >= 1
        # the slabs' e_c carries hc = (h + 2) // 2 coarse halo rows and
        # the fine row l reads its rows ⌊(l + s)/2⌋, ⌊(l + s − 1)/2⌋, s =
        # 2hc − h; a serial grid's s is 0 and its e_c has ny // 2 rows
        if off:
            hc = (off + 2) // 2
            s, nce = 2 * hc - off, nc + 2 * hc
        else:
            s, nce = 0, ny // 2
        fine = []
        for f in post_chunk_planes(ny, chunk):
            fine += f
            assert f and len(f) <= chunk
            # stage 0 reaches ν rows past each end: grid rows, or the
            # zero ghost just beyond the grid
            for y in range(f[0] - nu, f[-1] + nu + 1):
                assert -nu <= y < ny + nu
                if 0 <= y < ny:
                    for cy in ((y + s) // 2, (y + s - 1) // 2):
                        assert (0 <= cy < nce) if off else (-1 <= cy <= nce)
        assert fine == list(range(ny)), (gs, chunk)
        blocks = T * nseg * -(-ny // chunk)
        most = T * nseg * -(-ny // least)
        assert chunk == max(ny, 1) or chunk >= least, (gs, chunk)
        assert blocks >= min(2 * SMS, most), (gs, chunk, blocks)


def test_row_march_chunks_of_the_solves():
    """The 2-D march's blocks at the solves' levels and the slabs: at
    least two blocks per SM wherever the rows allow it (chunks of the
    least rows do not reach it on the ragged and one-row grids); the whole
    row a segment up to 1,024 columns."""
    for (T, gs, off, nc), dtype in itertools.product(LEVELS_2D, MARCH2_SLOTS):
        for stage, n in (("pre", nc), ("post", gs[0])):
            for nu in (2, 3):
                halo = nu + 1 if stage == "pre" else nu
                chunk = row_chunk(T, gs, n, nu, dtype, stage == "pre")
                nseg = row_plan(gs[1], halo)[1]
                blocks = T * nseg * max(1, -(-n // chunk))
                most = T * nseg * max(1, -(-n // MARCH_LEAST[stage]))
                assert blocks >= min(2 * SMS, most), (gs, stage, nu, chunk)
    assert row_plan(511, 3) == (511, 1, 513, 511)
    assert row_plan(1023, 4)[:2] == (1023, 1)
    assert row_plan(1055, 3) == (992, 2, 998, 998)
    # a rest of fewer than H columns joins the last segment
    assert row_plan(1985, 3) == (992, 2, 998, 998)
    assert row_plan(1986, 2)[:2] == (992, 3)
    assert row_plan(1986, 3)[:2] == (992, 2)
    assert row_plan(1984, 4)[:2] == (992, 2)
    # the flagship's levels (K6 in coarse rows, K7 in fine ones): one
    # wave of blocks (4 an SM of 128 threads at 511 columns, 8 of 64 at
    # 255, 16 of 32 at 127 in f32; f64 blocks of twice the threads), 2
    # blocks an SM at the least; singular2d's 135 rows, whose chunks of 64
    # would spill 12 blocks into a second wave; the (2 × 2) flagship's slab
    f32, f64 = torch.float32, torch.float64
    assert row_chunk(129, (511, 511), 255, 2, f32, True) == 64
    assert row_chunk(129, (511, 511), 511, 2, f32, False) == 128
    assert row_chunk(129, (255, 255), 127, 2, f32, True) == 16
    assert row_chunk(65, (127, 127), 63, 2, f32, True) == 2
    assert row_chunk(129, (511, 511), 255, 2, f64, True) == 64
    assert row_chunk(129, (255, 255), 127, 2, f64, True) == 32
    assert row_chunk(135, (511, 511), 255, 2, f32, True) == 17
    assert row_chunk(135, (511, 511), 511, 2, f32, False) == 47
    assert row_chunk(65, (262, 511), 128, 2, f32, True) == 16


@pytest.mark.cuda
def test_row_plan_is_the_librarys():
    """This file's row plan is the library's (csrc/mg.cu
    ``mg_march2_occupancy``): segments a row, threads a block and shared
    bytes a block of the 2-D K6 and K7 at every width checked here."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from spacetime_tpu_torch.ops import native

    lib = native.LIB.get()
    widths = {gs[1] for _, gs, _, _ in LEVELS_2D} | {1024, 1984, 1986, 2015}
    for nx, post, nu, dtype in itertools.product(sorted(widths), (0, 1),
                                                 (2, 3), MARCH2_SLOTS):
        out = [ctypes.c_int() for _ in range(4)]  # blocks, bytes, threads, nseg
        native.check(lib, "mg_march2_occupancy", lib.mg_march2_occupancy(
            post, 0, nu, int(dtype == torch.float64), nx,
            *map(ctypes.byref, out)))
        halo = nu if post else nu + 1  # and the rings
        want = (row_smem_bytes(halo, nx, halo, dtype),
                block_threads(nx, halo, dtype), row_plan(nx, halo)[1])
        assert tuple(o.value for o in out[1:]) == want, (nx, post, nu, dtype)
        assert out[0].value >= 1


# The 2-D K14 and K15 march in y with K6 and K7's plan (csrc/mg.cu
# ``row_plan``, ``march2_slots``). (T, grid, lead offset, coarse rows):
# varcoef2d 513²×128's four levels at K_X's (129) and K_Y's (128) rows, a
# ragged grid, one row, one coarse row and rows wider than one segment
VAR_LEVELS_2D = ([(T, (n, n), 0, (n - 1) // 2) for T in (129, 128)
                  for n in (511, 255, 127, 63)]
                 + [(5, (15, 31), 0, 7), (1, (1, 9), 0, 0),
                    (5, (3, 17), 0, 1), (5, (7, 1055), 0, 3),
                    (5, (7, 1985), 0, 3)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nu", [2, 3])
@pytest.mark.parametrize("pre", [True, False], ids=["K14", "K15"])
def test_var_row_march_plan_covers_each_row_once(pre, nu, dtype):
    """K14 writes every fine row of x and every coarse row of r_c once,
    K15 every fine row once with its reach in the grid or its ghost; the
    segments cover a row once (two at 1,985 columns, the last 993 wide);
    ν + 1 (K14) or ν (K15) rings fit a block's shared memory."""
    halo = nu + 1 if pre else nu
    least = MARCH_LEAST["pre" if pre else "post"]
    assert row_smem_bytes(halo, MARCH2_POINTS, halo, dtype) <= SMEM_PER_BLOCK
    assert row_plan(1985, halo)[:2] == (992, 2)
    for T, (ny, nx), off, nc in VAR_LEVELS_2D:
        nseg = check_segments(nx, halo)
        n = nc if pre else ny
        chunk = row_chunk(T, (ny, nx), n, nu, dtype, pre)
        assert chunk >= 1
        fine, coarse = [], []
        if pre:
            for f, k in chunk_planes(ny, off, nc, chunk):
                fine += f
                coarse += k
                assert not k or 2 * k[-1] + 2 < ny
        else:
            for f in post_chunk_planes(ny, chunk):
                fine += f
                assert f and len(f) <= chunk
                # stage 0 reaches ν rows past each end, and the coarse rows
                # ⌊y/2⌋, ⌊(y − 1)/2⌋ of the rows in the grid lie in e_c or
                # its zero ghost
                assert -nu <= f[0] - nu and f[-1] + nu < ny + nu
                assert all(-1 <= c <= ny // 2 for y in f
                           for c in (y // 2, (y - 1) // 2))
            coarse = list(range(nc))
        assert fine == list(range(ny)), (ny, nx, chunk)
        assert coarse == list(range(nc)), (ny, nx, chunk)
        blocks = T * nseg * max(1, -(-n // chunk))
        most = T * nseg * max(1, -(-n // least))
        assert chunk == max(n, 1) or chunk >= least, (ny, chunk)
        assert blocks >= min(2 * SMS, most), (ny, chunk, blocks)


def test_var_row_march_chunks_of_varcoef2d():
    """The chunks K14 (coarse rows) and K15 (fine rows) take at varcoef2d
    513²×128's four levels, K_X's 129 rows and K_Y's 128, f32 and f64."""
    f32, f64 = torch.float32, torch.float64
    want = {  # (T, n): (K14, K15) in f32; f64
        (129, 511): ((64, 128), (64, 128)),
        (129, 255): ((16, 32), (32, 64)),
        (129, 127): ((4, 8), (8, 16)),
        (129, 63): ((2, 4), (2, 4)),
        (128, 511): ((64, 128), (64, 128)),
        (128, 255): ((16, 32), (32, 64)),
        (128, 127): ((4, 8), (8, 16)),
        (128, 63): ((2, 4), (2, 4)),
    }
    for (T, n), (w32, w64) in want.items():
        for dtype, w in ((f32, w32), (f64, w64)):
            got = tuple(row_chunk(T, (n, n), m, 2, dtype, pre)
                        for pre, m in ((True, (n - 1) // 2), (False, n)))
            assert got == w, (T, n, dtype, got)


@pytest.mark.cuda
def test_var_row_plan_is_the_librarys():
    """The plan of the 2-D K14 and K15 (csrc/mg.cu ``mg_march2_occupancy``
    with var) is K6 and K7's, as this file models it: segments, threads
    and shared bytes a block at every width checked here, and at 511
    columns the blocks an SM that ``row_chunk`` takes (512 threads)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from spacetime_tpu_torch.ops import native

    lib = native.LIB.get()
    widths = {gs[1] for _, gs, _, _ in VAR_LEVELS_2D} | {1024, 1986, 2015}
    for nx, post, nu, dtype in itertools.product(sorted(widths), (0, 1),
                                                 (2, 3), MARCH2_SLOTS):
        out = [ctypes.c_int() for _ in range(4)]  # blocks, bytes, threads, nseg
        native.check(lib, "mg_march2_occupancy", lib.mg_march2_occupancy(
            post, 1, nu, int(dtype == torch.float64), nx,
            *map(ctypes.byref, out)))
        halo = nu if post else nu + 1  # and the rings
        threads = block_threads(nx, halo, dtype)
        want = (row_smem_bytes(halo, nx, halo, dtype), threads,
                row_plan(nx, halo)[1])
        assert tuple(o.value for o in out[1:]) == want, (nx, post, nu, dtype)
        if nx == 511:
            assert out[0].value == min(512 // threads, 32), (
                post, nu, dtype, out[0].value)
