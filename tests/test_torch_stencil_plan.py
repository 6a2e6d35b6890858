"""The launch plan of K4 (the residual) and K5 (the stencil apply), which
march along the leading grid axis (csrc/mg.cu ``stencil_plan``,
``mg_stencil_kernel``; ``ops/mg_kernels.py`` ``stencil_chunk``): the
blocks of a launch (segments of a row or tiles of a plane, chunks of the
leading axis, time rows) write every output point once, every tap of a
block's points reads its window, whose points hold the grid's values
where they lie in the grid and 0 (the Dirichlet ghost) past it, and a
block's shared memory fits the H100's limit in float32 and float64 at
every width. The kernels' logic itself runs on the CPU in
``tools.cpu_emulate`` (g++), held here to the twins at a few shapes."""

import ctypes
import itertools
import shutil

import numpy as np
import pytest
import torch

from spacetime_tpu_torch.ops.mg_kernels import stencil_chunk

SMEM_PER_BLOCK = 232_448  # the most dynamic shared memory an H100 block takes
DEFAULT_SMEM = 47 * 1024  # csrc/mg.cu ``kDefaultSmem``: no limit to raise
SMS = 132  # the H100's SMs
RING = 4  # csrc/mg.cu ``kStencilRing``: window planes of x in shared memory
MARCH2_POINTS = 1024  # the most points of a row a 2-D block takes
SLOTS = {torch.float32: 4, torch.float64: 2}  # a 2-D thread's points
TILE = (16, 32)  # the 3-D block's (y, x) tile, a frame of one around it
THREADS_3D = 256

# (T, grid): the solves' levels at K_X's and K_Y's rows (the 2-D flagship
# and singular2d's 134 steps, cfg2, smooth3d 129³×64 and 65³×32), the
# (2 × 2) meshes' halo-extended slabs (own 256 and 32, kw = 3), ragged
# ones (T = 1, one row or plane, even rows), rows wider than one segment
SHAPES = [(129, (511, 511)), (135, (511, 511)), (129, (255, 255)),
          (65, (127, 127)), (64, (127, 127)), (129, (63, 63)),
          (65, (127,) * 3), (64, (127,) * 3), (65, (63,) * 3),
          (33, (63,) * 3), (33, (31,) * 3), (65, (262, 511)),
          (17, (38, 63, 63)), (1, (1, 9)), (5, (10, 15)), (2, (9, 1985)),
          (1, (5, 1055)), (3, (4, 1024)), (2, (1, 5, 7)), (1, (6, 35, 67)),
          (5, (3, 17, 33))]


def plan(gs, dtype) -> dict:
    """csrc/mg.cu ``stencil_plan``: blocks a chunk (``tiles``: segments of
    a row in 2-D, ``TILE``s of a plane in 3-D), threads a block, window
    points a ring plane; in 2-D the segment's columns and the points a
    thread takes (``row_plan`` with a halo of 1)."""
    if len(gs) == 2:
        nx, S = gs[1], SLOTS[dtype]
        if nx <= MARCH2_POINTS:
            seg, nseg, wrow, points = nx, 1, nx + 2, nx
        else:
            seg = (MARCH2_POINTS - 2) // 32 * 32
            nseg = nx // seg + (nx % seg >= 1)
            wrow = points = seg + 2
        return dict(tiles=nseg, threads=-(-points // S // 32) * 32,
                    plane=wrow, seg=seg, slots=S)
    ny, nx = gs[1:]
    return dict(tiles=-(-ny // TILE[0]) * -(-nx // TILE[1]),
                threads=THREADS_3D,
                plane=(TILE[0] + 2) * (TILE[1] + 2), slots=2)


def smem_bytes(gs, dtype) -> int:
    return RING * plan(gs, dtype)["plane"] * (torch.finfo(dtype).bits // 8)


def window(gs, dtype, tile: int):
    """One block's window plane, as csrc/mg.cu ``mg_stencil_kernel`` maps
    it: {window offset: grid (y, x)} of the points its threads load (y = 0
    in 2-D), the offsets of the window's other points, and {window offset:
    grid (y, x)} of its output points; and the window's row stride."""
    p = plan(gs, dtype)
    loads, outs = {}, {}
    if len(gs) == 2:
        nx = gs[1]
        x0 = tile * p["seg"]
        x1 = nx if tile + 1 == p["tiles"] else x0 + p["seg"]
        w, hl, hr = x1 - x0, x0 > 0, x1 < nx
        for q in range(p["threads"] * p["slots"]):
            if q < w:
                loads[q + 1] = (0, x0 + q)
                outs[q + 1] = (0, x0 + q)
            elif hl and q == w:
                loads[0] = (0, x0 - 1)
            elif hr and q == w + hl:
                loads[w + 1] = (0, x1)
        others = {o for o in range(w + 2) if o not in loads}
        return loads, others, outs, p["plane"]
    ny, nx = gs[1:]
    ntx = -(-nx // TILE[1])
    y0, x0 = tile // ntx * TILE[0], tile % ntx * TILE[1]
    wx = TILE[1] + 2
    others = set()
    for q in range(3 * THREADS_3D):
        if q >= p["plane"]:
            continue
        gy, gx = y0 - 1 + q // wx, x0 - 1 + q % wx
        if 0 <= gy < ny and 0 <= gx < nx:
            loads[q] = (gy, gx)
        else:
            others.add(q)
    for q in range(2 * THREADS_3D):
        ly, lx = divmod(q, TILE[1])
        if y0 + ly < ny and x0 + lx < nx:
            outs[(ly + 1) * wx + lx + 1] = (y0 + ly, x0 + lx)
    return loads, others, outs, wx


def chunk_of(T: int, gs, dtype, resident: int) -> int:
    """``MSKernelLevel._stencil_chunk`` with ``resident`` blocks an SM (the
    card's occupancy; ``chip_smoke.py`` phase 2 prints it)."""
    return stencil_chunk(T, gs[0], resident, plan(gs, dtype)["tiles"], SMS)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_stencil_plan_covers_each_point_once(dtype):
    for T, gs in SHAPES:
        p = plan(gs, dtype)
        seen = np.zeros(gs[-2:] if len(gs) == 3 else (1, gs[1]), dtype=int)
        for tile in range(p["tiles"]):
            _, _, outs, _ = window(gs, dtype, tile)
            for y, x in outs.values():
                seen[y, x] += 1
        assert (seen == 1).all(), (gs, dtype)
        n = gs[0]
        for resident in (1, 3, 6, 24):
            chunk = chunk_of(T, gs, dtype, resident)
            assert 1 <= chunk <= n
            rows = [r for c in range(-(-n // chunk))
                    for r in range(c * chunk, min(c * chunk + chunk, n))]
            assert rows == list(range(n)), (gs, chunk)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_stencil_windows_lie_in_the_grid_or_its_ghost(dtype):
    """Every tap (±1 on each axis) of a block's output points lies in its
    window; a window point a thread loads lies in the grid, once, and every
    other one lies past the grid (it holds 0 in every ring slot). On the
    leading axis the block loads the planes its chunk's taps reach that
    lie in the grid, and a step's store of the plane two ahead goes to the
    slot whose plane the step before read last."""
    for _, gs in SHAPES:
        p = plan(gs, dtype)
        ny, nx = (gs[1], gs[2]) if len(gs) == 3 else (1, gs[1])
        wy = TILE[0] + 2 if len(gs) == 3 else 1
        for tile in sorted({0, p["tiles"] // 2, p["tiles"] - 1}):
            loads, others, outs, wx = window(gs, dtype, tile)
            assert max([*loads, *others]) < p["plane"]
            assert len(set(loads.values())) == len(loads)
            for o, (gy, gx) in loads.items():
                assert 0 <= gy < ny and 0 <= gx < nx
            for o, (gy, gx) in outs.items():
                oy, ox = divmod(o, wx)
                for dy, dx in itertools.product(
                        (-1, 0, 1) if len(gs) == 3 else (0,), (-1, 0, 1)):
                    q = (oy + dy) * wx + ox + dx
                    assert 0 <= oy + dy < wy and 0 <= ox + dx < wx
                    if q in loads:
                        assert loads[q] == (gy + dy, gx + dx)
                    else:
                        assert q in others
                        assert not (0 <= gy + dy < ny and 0 <= gx + dx < nx)
        n = gs[0]
        for chunk in sorted({1, 2, n}):
            for f_lo in range(0, n, chunk):
                f_hi = min(f_lo + chunk, n)
                # the kernel's `load`s: planes f_lo − 1 … f_hi + 1 + D (D ≤
                # 2 steps ahead), in the grid and not past f_hi
                loaded = {q for q in range(f_lo - 1, f_hi + 4)
                          if 0 <= q < n and q <= f_hi}
                reached = {q for p_ in range(f_lo, f_hi)
                           for q in (p_ - 1, p_, p_ + 1) if 0 <= q < n}
                assert loaded == reached, (gs, chunk, f_lo)
                for p_ in range(f_lo, f_hi):
                    reads = {(p_ + d) % RING for d in (-1, 0, 1)}
                    assert (p_ + 2) % RING not in reads
                    assert (p_ + 2) % RING == (p_ - 2) % RING


def test_stencil_smem_fits_at_every_width():
    for dtype in SLOTS:
        for _, gs in SHAPES:
            assert smem_bytes(gs, dtype) <= DEFAULT_SMEM, gs
        # the widest window a 2-D block takes: a whole row of 1,024
        assert smem_bytes((1, MARCH2_POINTS), dtype) <= DEFAULT_SMEM
        assert plan((1, MARCH2_POINTS + 1), dtype)["tiles"] == 2
    assert plan((1, 511), torch.float32)["threads"] == 128
    assert plan((1, 511), torch.float64)["threads"] == 256
    assert plan((9, 1985), torch.float32) == dict(
        tiles=3, threads=256, plane=994, seg=992, slots=4)
    assert plan((1, 127, 127), torch.float32)["tiles"] == 32


def test_stencil_chunks_of_the_solves():
    """The chunks at the solves' levels, with the blocks an SM the H100
    held in PERF.md's runs: two blocks an SM at least where the rows allow
    it, in one wave at the 2-D flagship's finest level."""
    f32, f64 = torch.float32, torch.float64
    for (T, gs), dtype, resident in itertools.product(SHAPES, SLOTS,
                                                      (2, 4, 6)):
        chunk = chunk_of(T, gs, dtype, resident)
        tiles = plan(gs, dtype)["tiles"]
        blocks = T * tiles * -(-gs[0] // chunk)
        assert blocks >= min(2 * SMS, T * tiles * gs[0]), (gs, chunk)
    # 129 x 511²: f32 at 6 blocks an SM, f64 (K4) at 2
    assert chunk_of(129, (511, 511), f32, 6) == 86
    assert chunk_of(129, (511, 511), f64, 2) == 128
    # 65 x 127³ at 4 blocks an SM: whole columns (2,080 blocks)
    assert chunk_of(65, (127,) * 3, f32, 4) == 127
    assert chunk_of(65, (262, 511), f32, 6) == 22


@pytest.mark.cuda
def test_stencil_plan_is_the_librarys():
    """This file's plan is the library's (csrc/mg.cu
    ``mg_stencil_occupancy``): shared bytes, threads and blocks a chunk of
    K4 and K5 at every shape checked here."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from spacetime_tpu_torch.ops import native

    lib = native.LIB.get()
    for (_, gs), res, dtype in itertools.product(SHAPES, (0, 1), SLOTS):
        out = [ctypes.c_int() for _ in range(4)]
        native.check(lib, "mg_stencil_occupancy", lib.mg_stencil_occupancy(
            res, len(gs), int(dtype == torch.float64), *gs[-2:],
            *map(ctypes.byref, out)))
        p = plan(gs, dtype)
        assert tuple(o.value for o in out[1:]) == (
            smem_bytes(gs, dtype), p["threads"], p["tiles"]), (gs, res)
        assert out[0].value >= 1


def test_stencil_emulated_against_the_twins():
    """csrc/mg.cu compiled for the CPU (``tools.cpu_emulate``): K4 and K5
    in float32 and float64 on a row of three segments and a ragged 3-D grid
    of four tiles, every chunk, against their twins."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the emulated kernels")
    from spacetime_tpu_torch.tools import cpu_emulate

    n = cpu_emulate.check_stencil(
        cpu_emulate.build_stencil("test_stencil"), None,
        shapes=[(2, (3, 1985)), (1, (3, 17, 35))])
    # per dtype: 3 chunks of each grid, K4 and K5
    assert n == 2 * 2 * (3 + 3)
