"""The launch plan of K11 (the weighted residual), K12 (the weighted
apply) and the steps of K10 (the weighted sweep), which march in time
(csrc/mg.cu ``var_plan``, ``mg_var_stencil_kernel``; ``ops/mg_kernels.py``
``var_stencil_chunk``): a block owns a tile (2-D: pencil rows by a segment
of the row; 3-D: pencil planes by 8 × 32) and a chunk of the time rows.
The blocks of a launch write every output point of every time row once,
every tap of a block's points reads its window, whose points hold the
grid's values where they lie in the grid and 0 (the Dirichlet ghost) past
it, and a block's shared memory (the field's two buffers and, past seven A
taps, the weights' tile; none in K10's first step from 0) fits the H100's
limit in float32 and float64 at every width. The kernels' logic itself
runs on the CPU in ``tools.cpu_emulate`` (g++), held here to the twins at
two shapes with the weights in both homes."""

import ctypes
import itertools
import shutil

import numpy as np
import pytest
import torch

from spacetime_tpu_torch.ops.mg_kernels import VAR_MODES, var_stencil_chunk

SMEM_PER_BLOCK = 232_448  # the most dynamic shared memory an H100 block takes
SMS = 132  # the H100's SMs
TILE = (8, 32)  # the 3-D block's (y, x) tile
PLANE = (TILE[0] + 2) * (TILE[1] + 2)  # the 3-D window plane
# the march's modes (csrc/mg.cu ``VarMode``): K11, K12 and K10's steps
# (K10's three take K11's tiles: the tile tests take its later step)
RES = ("residual", "apply", "first", "first_zero", "step", "first_two")
TILED = ("residual", "apply", "step")
TILED_IDS = ["K11", "K12", "K10"]
REG_TAPS = 7  # ``kVarRowTaps``: the most A taps held in registers
CAP = {2: 9, 3: 16}  # ``var_taps``: the most A (and mass) taps a table has
DTYPES = (torch.float32, torch.float64)

# (T, grid): the weighted solves' levels at K_X's and K_Y's rows (varcoef2d
# 513² and 129², varcoef3d 65³ and 129³×32), ragged ones (one row or
# plane, rows of one pencil and past it), rows wider than one segment
SHAPES = [(129, (511, 511)), (128, (255, 255)), (65, (127, 127)),
          (33, (255, 1985)), (33, (63,) * 3), (32, (31,) * 3),
          (33, (127,) * 3), (1, (1, 9)), (5, (10, 15)), (2, (5, 1055)),
          (1, (3, 575)), (2, (1, 5, 7)), (5, (3, 9, 15)), (1, (5, 17, 35))]


def seg(res: str) -> int:
    """csrc/mg.cu ``var_seg``: the widest 2-D segment, K12's 574 columns,
    K11's and K10's 254."""
    return 574 if res == "apply" else 254


def pencil(dim: int, dtype, res: str) -> int:
    """csrc/mg.cu ``var_pencil``: 2 planes in 3-D; 4 rows in 2-D, 2 for
    K11 and K10 in float64."""
    return 2 if dim == 3 or (res != "apply" and dtype == torch.float64) else 4


def stride(dim: int, res: str) -> int:
    """csrc/mg.cu ``var_stride``: the widest 2-D window row, the 3-D window
    plane."""
    return seg(res) + 2 if dim == 2 else PLANE


def plan(gs, dtype, res: str) -> dict:
    """csrc/mg.cu ``var_plan`` of the march in mode ``res``: the owned tile ix ×
    iy, its window's row stride wx and plane points wyx, xt × yt plane
    tiles, the pencil axis of np points at stride pstride in pt pencils of
    P, threads a block."""
    P = pencil(len(gs), dtype, res)
    if len(gs) == 2:
        ny, nx = gs
        xt = -(-nx // seg(res))
        ix = -(-nx // xt)
        p = dict(ix=ix, iy=1, wx=ix + 2, wyx=ix + 2, xt=xt, yt=1, np=ny,
                 pstride=nx)
    else:
        nz, ny, nx = gs
        p = dict(ix=TILE[1], iy=TILE[0], wx=TILE[1] + 2,
                 wyx=PLANE, xt=-(-nx // TILE[1]), yt=-(-ny // TILE[0]),
                 np=nz, pstride=ny * nx)
    p.update(P=P, pt=-(-p["np"] // P), threads=-(-p["wyx"] // 32) * 32)
    return p


def smem_bytes(gs, dtype, res: str, ntaps: int) -> int:
    """csrc/mg.cu ``var_stencil_bytes``: the field's two window buffers of
    P + 2 points along the pencil at the constant stride, and the weights'
    tile of P × iy × ix points a tap where they are not in registers; K10's
    first step from 0 (no Op) none."""
    if res == "first_zero":
        return 0
    p = plan(gs, dtype, res)
    tile = 0 if ntaps <= REG_TAPS else ntaps
    return (2 * (p["P"] + 2) * stride(len(gs), res)
            + tile * p["P"] * p["iy"] * p["ix"]) * (torch.finfo(dtype).bits
                                                    // 8)


def columns(gs, dtype, res: str, tile: int, pen: int):
    """csrc/mg.cu ``var_column`` for every thread of block (tile, pencil
    ``pen``):
    {thread: (window plane position, plane grid (y, x), loaded rows (pencil
    points in the grid))} of its loads and {thread: (window plane
    position, plane grid (y, x), owned pencil points)} of its outputs."""
    p = plan(gs, dtype, res)
    P = p["P"]
    dim = len(gs)
    ny, nx = (gs[1], gs[2]) if dim == 3 else (1, gs[1])
    if dim == 3:
        y0, x0 = tile // p["xt"] * TILE[0], tile % p["xt"] * TILE[1]
    else:
        y0, x0 = 0, tile * p["ix"]
    p0 = pen * P
    klo, khi = (1 if p0 == 0 else 0), min(P + 2, p["np"] - p0 + 1)
    loads, outs = {}, {}
    for t in range(p["threads"]):
        py, px = divmod(t, p["wx"]) if dim == 3 else (0, t)
        gy, gx = (y0 - 1 + py if dim == 3 else 0), x0 - 1 + px
        if t < p["wyx"] and 0 <= gy < ny and 0 <= gx < nx:
            loads[t] = (t, (gy, gx), range(p0 - 1 + klo, p0 - 1 + khi))
        qy, qx = divmod(t, TILE[1]) if dim == 3 else (0, t)
        if t < p["iy"] * p["ix"] and y0 + qy < ny and x0 + qx < nx:
            oc = ((qy + 1) * p["wx"] if dim == 3 else 0) + qx + 1
            outs[t] = (oc, (y0 + qy, x0 + qx),
                       range(p0, p0 + min(P, p["np"] - p0)))
    return loads, outs, p0


def chunk_of(T: int, gs, dtype, res: str, ntaps: int, resident: int,
             last: bool = False) -> int:
    """``VarMSKernelLevel._var_stencil_chunk`` with ``resident`` blocks an
    SM (the card's occupancy; ``tools.fused_ab --var-stencil`` prints
    it)."""
    p = plan(gs, dtype, res)
    return var_stencil_chunk(T, res, ntaps, resident,
                             p["xt"] * p["yt"] * p["pt"], SMS, last)


@pytest.mark.parametrize("res", TILED, ids=TILED_IDS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_var_plan_covers_each_point_once(dtype, res):
    for T, gs in SHAPES:
        p = plan(gs, dtype, res)
        seen = np.zeros(gs, dtype=int)
        for tile, pen in itertools.product(range(p["xt"] * p["yt"]),
                                           range(p["pt"])):
            _, outs, _ = columns(gs, dtype, res, tile, pen)
            for _, (gy, gx), points in outs.values():
                for q in points:
                    if len(gs) == 3:
                        seen[q, gy, gx] += 1
                    else:
                        seen[q, gx] += 1
        assert (seen == 1).all(), (gs, dtype)
        modes = (("first", "first_zero", "step", "first_two")
                 if res == "step" else (res,))
        for mode, ntaps, resident, last in itertools.product(
                modes, (7, 15), (1, 2, 4), (False, True)):
            chunk = chunk_of(T, gs, dtype, mode, ntaps, resident, last)
            assert 1 <= chunk <= T
            rows = [t for c in range(-(-T // chunk))
                    for t in range(c * chunk, min(c * chunk + chunk, T))]
            assert rows == list(range(T)), (gs, chunk)


@pytest.mark.parametrize("res", TILED, ids=TILED_IDS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_var_windows_lie_in_the_grid_or_its_ghost(dtype, res):
    """Every tap (±1 on each axis) of a block's output points reads its
    window (P + 2 points along the pencil at the stride, wyx a plane): a
    point that a thread loads from the grid point the tap names where that
    lies in the grid, else a point that no thread loads (it holds 0)."""
    for _, gs in SHAPES:
        dim = len(gs)
        p = plan(gs, dtype, res)
        P, ST = p["P"], stride(dim, res)
        ny, nx = (gs[1], gs[2]) if dim == 3 else (1, gs[1])
        for tile, pen in itertools.product(
                sorted({0, p["xt"] * p["yt"] // 2, p["xt"] * p["yt"] - 1}),
                sorted({0, p["pt"] - 1})):
            loads, outs, p0 = columns(gs, dtype, res, tile, pen)
            # window point (k, plane position) -> the grid point it holds
            held = {(q - p0 + 1, pos): (q,) + yx for pos, yx, rows in
                    loads.values() for q in rows}
            assert all(0 <= k < P + 2 for k, _ in held)
            for oc, (gy, gx), points in outs.values():
                for q, d in itertools.product(
                        points, itertools.product((-1, 0, 1), repeat=3)):
                    if dim == 2 and d[0]:
                        continue
                    dq, dy, dx = (d[0], d[1], d[2]) if dim == 3 else (
                        d[1], 0, d[2])
                    k = q - p0 + 1 + dq
                    pos = oc + dy * p["wx"] + dx
                    assert 0 <= k < P + 2 and 0 <= pos < p["wyx"] <= ST
                    assert pos % p["wx"] == oc % p["wx"] + dx  # no wrap
                    target = (q + dq, gy + dy, gx + dx)
                    inside = (0 <= target[0] < p["np"]
                              and 0 <= target[1] < ny and 0 <= target[2] < nx)
                    if inside:
                        assert held.get((k, pos)) == target, (gs, target)
                    else:
                        assert (k, pos) not in held, (gs, target)


def test_var_smem_fits_at_every_width():
    """The field's buffers and, past seven A taps, the weights' tile at the
    most taps a table may have fit a block at every row width (every
    segment count) in every mode, and the solves' 3-D levels hold two
    blocks an SM (the shared tile of 15 taps) by shared memory."""
    for dtype, res in itertools.product(DTYPES, RES):
        for nx in range(1, 4 * seg(res) + 2):
            for ntaps in (REG_TAPS, CAP[2]):
                assert smem_bytes((1, nx), dtype, res, ntaps) <= (
                    SMEM_PER_BLOCK)
        for ntaps in (REG_TAPS, 15, CAP[3]):
            assert smem_bytes((1, 9, 33), dtype, res, ntaps) <= (
                SMEM_PER_BLOCK)
        assert 2 * smem_bytes((33, 63, 63), dtype, res, 15) <= 228 * 1024
    f32, f64 = DTYPES
    assert smem_bytes((511, 511), f32, "residual", 7) == 12_288
    assert smem_bytes((511, 511), f32, "apply", 7) == 27_648
    assert smem_bytes((511, 511), f64, "apply", 9) == 202_464
    assert smem_bytes((63, 63, 63), f32, "residual", 15) == 41_600
    assert smem_bytes((63, 63, 63), f64, "residual", 15) == 83_200
    assert plan((1, 511), f32, "residual")["threads"] == 192
    assert plan((1, 511), f32, "apply")["threads"] == 544
    assert plan((1, 1985), f32, "residual")["xt"] == 8
    assert plan((1, 575), f64, "apply")["ix"] == 288
    # K10's steps take K11's tiles; the first from 0 no shared memory
    for mode in ("first", "step", "first_two"):
        assert smem_bytes((511, 511), f32, mode, 7) == 12_288
        assert smem_bytes((63, 63, 63), f64, mode, 15) == 83_200
    assert smem_bytes((511, 511), f64, "first_zero", 7) == 0


def test_var_chunks_of_the_solves():
    """The chunks at the solves' levels: two blocks an SM at least where the
    rows allow it; at 129 × 511² f32, K11's 384 tiles (three segments by
    128 pencils of 4 rows) walk a quarter of the rows at the four blocks
    an SM the H100 held, and the whole column at 127³."""
    for (T, gs), dtype, resident, res in itertools.product(
            SHAPES, DTYPES, (1, 2, 4), RES):
        ntaps = 7 if len(gs) == 2 else 15
        chunk = chunk_of(T, gs, dtype, res, ntaps, resident)
        p = plan(gs, dtype, res)
        tiles = p["xt"] * p["yt"] * p["pt"]
        assert tiles * -(-T // chunk) >= min(2 * SMS, T * tiles), (gs, chunk)
    assert chunk_of(129, (511, 511), torch.float32, "residual", 7, 4) == 33
    assert chunk_of(33, (127,) * 3, torch.float32, "residual", 15, 2) == 33
    assert chunk_of(33, (63,) * 3, torch.float32, "residual", 15, 2) == 33


@pytest.mark.cuda
def test_var_plan_is_the_librarys():
    """This file's plan is the library's (csrc/mg.cu
    ``mg_var_stencil_occupancy``): shared bytes, threads and blocks a chunk
    of K11, K12 and K10's steps at every shape checked here, in both homes
    of the weights; a table past the cap is refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from spacetime_tpu_torch.ops import native

    lib = native.LIB.get()
    for (_, gs), res, dtype in itertools.product(SHAPES, RES, DTYPES):
        zyx = (1,) * (3 - len(gs)) + gs
        for ntaps in (REG_TAPS, CAP[len(gs)], CAP[len(gs)] + 1):
            out = [ctypes.c_int() for _ in range(4)]
            err = lib.mg_var_stencil_occupancy(
                VAR_MODES[res], len(gs), int(dtype == torch.float64), ntaps,
                *zyx,
                *map(ctypes.byref, out))
            if ntaps > CAP[len(gs)]:
                assert err != 0
                continue
            native.check(lib, "mg_var_stencil_occupancy", err)
            p = plan(gs, dtype, res)
            assert tuple(o.value for o in out[1:]) == (
                smem_bytes(gs, dtype, res, ntaps), p["threads"],
                p["xt"] * p["yt"] * p["pt"]), (gs, res, ntaps)
            assert out[0].value >= 1


@pytest.fixture(scope="module")
def emulated():
    """csrc/mg.cu compiled for the CPU by ``tools.cpu_emulate``."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the emulated kernels")
    from spacetime_tpu_torch.tools import cpu_emulate

    return cpu_emulate.build_var_stencil("test_var_stencil")


def test_var_stencil_emulated_against_the_twins(emulated):
    """csrc/mg.cu compiled for the CPU (``tools.cpu_emulate``): K11 and K12
    in float32 and float64 on a row of two segments and a ragged 3-D grid
    of several tiles and pencils, the weights in both homes (the varcoef
    tables and ``OTHER_TAPS``), every chunk, against their twins."""
    from spacetime_tpu_torch.tools import cpu_emulate

    n = cpu_emulate.check_var_stencil(
        emulated, None, shapes=[(2, (9, 1055)), (3, (5, 17, 35))])
    # per dtype and table: 2 + 3 chunks, K11 and K12
    assert n == 2 * 2 * 2 * (2 + 3)


def test_var_sweep_emulated_against_the_twins(emulated):
    """The steps of K10 (csrc/mg.cu ``mg_smooth_var``, emulated) as the
    wrapper launches them (``chebyshev_launches``): sweeps of ν = 1 and 3
    from x and from 0, float32 and float64, on a row of two segments and a
    ragged 3-D grid, the weights in both homes, every chunk, against the
    twin ``smooth_plain``."""
    from spacetime_tpu_torch.tools import cpu_emulate

    n = cpu_emulate.check_var_sweep(
        emulated, None, shapes=[(2, (9, 1055)), (3, (5, 17, 35))],
        nus={2: (1, 3), 3: (1, 3)})
    # per dtype and table at 2 + 3 chunks: from x ν = 1 and 3 (4 launches),
    # from 0 1 and 2 (the first two steps one launch)
    assert n == 2 * 2 * (4 + 3) * (2 + 3)


def test_var_sweep_refuses_a_far_table(emulated):
    """A table the march cannot take (a tap two cells out) returns
    cudaErrorInvalidValue from every step mode, as from K11 (the wrapper's
    ``native.check`` raises on any non-zero return)."""
    import types

    from spacetime_tpu_torch.ops.mg_kernels import VarMSKernelLevel
    from spacetime_tpu_torch.ops.stencil import VarStencilOperator
    from spacetime_tpu_torch.tools import cpu_emulate

    lev, _, _ = cpu_emulate.var_levels(2, (5, 9))[0]
    disps = ((0, 0), (0, 2))
    far = types.SimpleNamespace(
        A_vs=VarStencilOperator(disps, (5, 9)), gs=(5, 9), kc=0, cM=lev.cM,
        M_st=lev.M_st)
    kl = VarMSKernelLevel(far, 2)
    x = torch.zeros((2, 5, 9))
    W = torch.ones((2, 5, 9))
    cols = {k: torch.ones(2) for k in kl._COLS}
    cp = [cols[k].data_ptr() for k in kl._COLS]
    for first, xp, din in ((1, x.data_ptr(), None), (1, None, None),
                           (0, None, x.data_ptr())):
        err = emulated.mg_smooth_var_f32(
            xp, x.data_ptr(), W.data_ptr(), *cp, x.data_ptr(), din,
            x.data_ptr(), x.data_ptr(), 2, *kl._zyx(), *kl._tables(), first,
            0.5, 0.5, 0, 1, None)
        assert err == 1, (first, xp, din)  # cudaErrorInvalidValue
