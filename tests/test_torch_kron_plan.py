"""The launch plan of K1 (B) and K2 (Bᵀ), which march in time
(csrc/kron.cu ``kron_plan``, ``column``, ``march_bytes``;
``ops/kron.py`` ``kron_plan``): the blocks of a launch write every output
time row and spatial point once, every tap of a block's points reads its
window, which holds the grid's values and 0 (the Dirichlet ghost) past the
grid, and a block's shared memory fits the H100's limit in float32 and
float64 at every pencil. The kernels' logic itself runs on the CPU in
``tools.cpu_emulate`` (g++), held here to the twins at a few shapes."""

import ctypes
import itertools
import shutil

import numpy as np
import pytest
import torch

from spacetime_tpu_torch.ops.mg_kernels import march2_chunk

SMEM_PER_BLOCK = 232_448  # the most dynamic shared memory an H100 block takes
SMS = 132  # the H100's SMs
MAX_SEG = 574  # the widest 2-D segment (576 window columns)
TILE = (8, 32)  # the 3-D brick's plane (y, x)
PENCILS = (4, 8)
MAX_THREADS = {2: 576, 3: 352}

# (T, grid): the solves' (cfg2, the 2-D flagship and singular2d's 134
# steps, a rank's halo-extended slab on the (2 × 2) flagship mesh,
# smooth3d 129³×64, 65³×32 and 17³×16, singular3d 65³'s 36 steps) and
# ragged ones (T = 1, one row or plane, rows wider than one segment)
SHAPES = [(64, (127, 127)), (128, (511, 511)), (134, (511, 511)),
          (64, (258, 511)), (64, (127,) * 3), (32, (63,) * 3),
          (16, (15,) * 3), (36, (63,) * 3), (1, (9, 13)), (5, (1, 9)),
          (7, (5, 1985)), (3, (10, 575)), (2, (1, 5, 7)), (5, (9, 17, 35)),
          (3, (7, 9, 15))]


def plan(gs, pencil: int) -> dict:
    """csrc/kron.cu ``kron_plan``: the owned plane tile (ix, iy), the
    window's row stride wx and plane points wyx, the plane tiles (xt, yt),
    the pencil axis's points np and pencils pt, threads a block."""
    if len(gs) == 2:
        ny, nx = gs
        xt = -(-nx // MAX_SEG)
        p = dict(ix=-(-nx // xt), iy=1, xt=xt, yt=1, np=ny)
        p["wx"] = p["wyx"] = p["ix"] + 2
    else:
        nz, ny, nx = gs
        p = dict(ix=TILE[1], iy=TILE[0], xt=-(-nx // TILE[1]),
                 yt=-(-ny // TILE[0]), np=nz, wx=TILE[1] + 2,
                 wyx=(TILE[0] + 2) * (TILE[1] + 2))
    p["pt"] = -(-p["np"] // pencil)
    p["threads"] = -(-p["wyx"] // 32) * 32
    return p


# csrc/kron.cu ``kron_stride``: the shared window's constant stride along
# the pencil (the widest 2-D window row, the 3-D window plane)
STRIDE = {2: MAX_SEG + 2, 3: (TILE[0] + 2) * (TILE[1] + 2)}


def smem_bytes(bt: bool, pencil: int, dim: int, dtype) -> int:
    """csrc/kron.cu ``march_bytes``: two buffers of D and S (B) or of V
    (Bᵀ), pencil + 2 window planes (rows in 2-D) each."""
    return (2 * (1 if bt else 2) * (pencil + 2) * STRIDE[dim]
            * (torch.finfo(dtype).bits // 8))


def chunk_of(bt: bool, T: int, gs, pencil: int, resident: int) -> int:
    """``ops/kron.py`` ``kron_plan``'s chunk, with ``resident`` blocks an
    SM (the card's occupancy; ``chip_smoke.py`` prints it)."""
    p = plan(gs, pencil)
    return march2_chunk(p["xt"] * p["yt"] * p["pt"], T + bt, 1, resident,
                        SMS, 1, 1)


def columns(gs, p, bx: int, by: int, p0: int, pencil: int):
    """csrc/kron.cu ``column`` for every thread of the block of plane tile
    (by, bx) and first pencil point p0: per thread, as a loader, its
    window plane position (py, px), its grid column (gy, gx) and whether
    it loads; as a computer, whether it owns a column, the column's window
    plane position (oy, ox) and grid column (cy, cx); and the block's
    [klo, khi) and kown."""
    t = np.arange(p["threads"])
    if len(gs) == 2:
        ny, nx = gs
        py, px, x0, y0 = np.zeros_like(t), t, bx * p["ix"], 0
        gy, ylim = np.zeros_like(t), 1
        qy, qx = np.zeros_like(t), t
    else:
        nz, ny, nx = gs
        py, px = t // p["wx"], t % p["wx"]
        x0, y0 = bx * TILE[1], by * TILE[0]
        gy, ylim = y0 - 1 + py, ny
        qy, qx = t // TILE[1], t % TILE[1]
    gx = x0 - 1 + px
    load = (t < p["wyx"]) & (gy >= 0) & (gy < ylim) & (gx >= 0) & (gx < nx)
    own = (t < p["iy"] * p["ix"]) & (y0 + qy < ylim) & (x0 + qx < nx)
    oy, ox = (qy + 1 if len(gs) == 3 else qy), qx + 1
    cy, cx = y0 + qy, x0 + qx
    klo = 1 if p0 == 0 else 0
    khi = min(pencil + 2, p["np"] - p0 + 1)
    kown = min(pencil, p["np"] - p0)
    return (py, px, gy, gx, load), (own, oy, ox, cy, cx), (klo, khi, kown)


def check_cover(T: int, gs, pencil: int, chunk: int, bt: bool) -> None:
    """The blocks (chunk, pencil, plane tile) own each output point once:
    the launch is their product, so each axis's cut covers it once."""
    p = plan(gs, pencil)
    rows = T + bt
    owned_rows = [j for c in range(-(-rows // chunk))
                  for j in range(c * chunk, min(c * chunk + chunk, rows))]
    assert owned_rows == list(range(rows))
    owned_pencil = [q for b in range(p["pt"])
                    for q in range(b * pencil, min(b * pencil + pencil,
                                                   p["np"]))]
    assert owned_pencil == list(range(p["np"]))
    ny, nx = gs[-2:]
    seen = np.zeros((ny if len(gs) == 3 else 1, nx), dtype=int)
    for by, bx in itertools.product(range(p["yt"]), range(p["xt"])):
        _, (own, _, _, cy, cx), _ = columns(gs, p, bx, by, 0, pencil)
        np.add.at(seen, (cy[own], cx[own]), 1)
    assert (seen == 1).all(), (gs, pencil)


def check_windows(gs, pencil: int) -> None:
    """Every tap (±1 on each axis) of a block's owned points lies in its
    window; a window point the block stores is the grid's value where it
    lies in the grid (``load``) and 0 elsewhere; a tap of an owned point
    leaves the grid by one step at most (the zero ghost). Checked on the
    first, a middle and the last tiles and pencils."""
    p = plan(gs, pencil)
    ny, nx = gs[-2:]
    nyg = ny if len(gs) == 3 else 1
    for by, bx, b in itertools.product(
            sorted({0, p["yt"] // 2, p["yt"] - 1}),
            sorted({0, p["xt"] // 2, p["xt"] - 1}),
            sorted({0, p["pt"] // 2, p["pt"] - 1})):
        p0 = b * pencil
        (py, px, gy, gx, load), (own, oy, ox, cy, cx), (klo, khi, kown) = \
            columns(gs, p, bx, by, p0, pencil)
        assert (p["threads"] <= MAX_THREADS[len(gs)])
        win = p["wyx"]
        # the window plane: one loader per point, in row order
        assert (py[:win] * p["wx"] + px[:win] == np.arange(win)).all()
        in_grid = (gy >= 0) & (gy < nyg) & (gx >= 0) & (gx < nx)
        assert (load[:win] == in_grid[:win]).all()
        wy = (TILE[0] + 2) if len(gs) == 3 else 1
        for t in np.flatnonzero(own):
            # the computed column is the loaded one at its window position
            q0 = oy[t] * p["wx"] + ox[t]
            assert (gy[q0], gx[q0]) == (cy[t], cx[t]) and load[q0]
            for dy, dx in itertools.product((-1, 0, 1) if len(gs) == 3
                                            else (0,), (-1, 0, 1)):
                qy, qx = oy[t] + dy, ox[t] + dx
                assert 0 <= qy < wy and 0 <= qx < p["wx"]
                q = qy * p["wx"] + qx
                assert -1 <= gy[q] <= nyg and -1 <= gx[q] <= nx
        # the pencil: window points 0 … pencil + 1, those in the grid
        # loaded; an owned point's ±1 reaches the ghost at most
        assert klo == (1 if p0 == 0 else 0)
        assert khi == min(pencil + 2, p["np"] - p0 + 1) and khi >= 2
        assert 1 <= kown <= pencil and p0 + kown <= p["np"]
        for k in range(1, kown + 1):
            assert -1 <= p0 - 1 + k - 1 and p0 - 1 + k + 1 <= p["np"]


@pytest.mark.parametrize("bt", [False, True], ids=["B", "BT"])
def test_kron_plan_covers_each_point_once(bt):
    for (T, gs), pencil in itertools.product(SHAPES, PENCILS):
        # at the wrapper's chunk with 1, 2 and 4 blocks an SM
        for resident in (1, 2, 4):
            chunk = chunk_of(bt, T, gs, pencil, resident)
            assert 1 <= chunk <= T + bt
            check_cover(T, gs, pencil, chunk, bt)
        # chunks that do not divide the rows, one row, all of them
        for chunk in sorted({1, 3, T + bt}):
            check_cover(T, gs, pencil, chunk, bt)


@pytest.mark.parametrize("pencil", PENCILS)
def test_kron_windows_lie_in_the_grid_or_its_ghost(pencil):
    for _, gs in SHAPES:
        check_windows(gs, pencil)


def test_kron_smem_fits_at_every_width():
    for bt, pencil, dtype in itertools.product(
            (False, True), PENCILS, (torch.float32, torch.float64)):
        for dim in (2, 3):
            assert smem_bytes(bt, pencil, dim, dtype) <= SMEM_PER_BLOCK
    # a window row (plane) fits the stride
    for _, gs in SHAPES:
        assert plan(gs, 2)["wyx"] <= STRIDE[len(gs)]
    # the segments of the widest rows the checks run
    assert plan((5, 1985), 4)["xt"] == 4 and plan((5, 1985), 4)["ix"] == 497
    assert plan((5, 574), 4)["xt"] == 1 and plan((5, 575), 4)["ix"] == 288
    assert plan((511, 511), 8)["threads"] == 544
    assert plan((127,) * 3, 4)["threads"] == 352


def test_kron_chunks_of_the_solves():
    """The flagship's K1/K2 launches give every SM two blocks at least, in
    two waves or fewer, at 2 blocks an SM."""
    for bt, pencil in itertools.product((False, True), PENCILS):
        for T, gs in ((128, (511, 511)), (64, (127,) * 3)):
            p = plan(gs, pencil)
            chunk = chunk_of(bt, T, gs, pencil, 2)
            blocks = p["xt"] * p["yt"] * p["pt"] * -(-(T + bt) // chunk)
            assert blocks >= 2 * SMS, (bt, gs, pencil, chunk, blocks)
    assert chunk_of(False, 128, (511, 511), 4, 2) == 32
    assert chunk_of(True, 128, (511, 511), 4, 2) == 33


@pytest.mark.cuda
def test_kron_plan_is_the_librarys():
    """This file's plan is the library's (csrc/kron.cu ``kron_occupancy``):
    shared bytes, threads and blocks a chunk of every instantiation at the
    shapes checked here."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from spacetime_tpu_torch.ops import native

    lib = native.LIB.get()
    for (T, gs), bt, stab, pencil, dtype in itertools.product(
            SHAPES, (0, 1), (0, 1), PENCILS, (torch.float32, torch.float64)):
        out = [ctypes.c_int() for _ in range(4)]
        zyx = (1,) * (3 - len(gs)) + tuple(gs)
        native.check(lib, "kron_occupancy", lib.kron_occupancy(
            bt, stab, int(dtype == torch.float64), len(gs), pencil, *zyx,
            *map(ctypes.byref, out)))
        p = plan(gs, pencil)
        want = (smem_bytes(bt, pencil, len(gs), dtype), p["threads"],
                p["xt"] * p["yt"] * p["pt"])
        assert tuple(o.value for o in out[1:]) == want, (gs, bt, pencil)
        assert out[0].value >= 1


def test_kron_emulated_against_the_twins():
    """csrc/kron.cu compiled for the CPU (``tools.cpu_emulate``): K1 and K2
    in every form and dtype on a ragged 2-D and 3-D grid, T = 1 and 3,
    pencils 4 and 8, chunks of one row and all of them, against their
    twins."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the emulated kernels")
    from spacetime_tpu_torch.tools import cpu_emulate

    n = cpu_emulate.check_kron(
        cpu_emulate.build_kron(name="test_kron"), None,
        shapes=[(3, (5, 13)), (1, (3, 5, 35))], pencils=(4, 8), chunks=(1,))
    # per dtype and pencil: T = 3, the 4 forms at 2 chunks; T = 1, B at 1
    # and Bᵀ (2 rows) at 2
    assert n == 2 * 2 * (4 * 2 + (2 + 2 * 2))
