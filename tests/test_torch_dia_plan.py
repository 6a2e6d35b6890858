"""The launch plan of K16 (the DIA Chebyshev sweep's steps), K17 (the DIA
residual) and K18 (A x), which march in time (csrc/dia.cu
``dia_march_kernel``,
``by_form``; ``ops/dia_kernels.py`` ``dia_chunk``, ``dia_plan``): the
blocks of a launch (segments of the dofs by chunks of the time rows) write
every (row, dof) once, at every chunk from one row to all of them; the
library holds the level's values in registers up to 16 offsets and in a
shared tile that fits the H100 past them; the chunks at the repo's levels
fill the card. The library's logic itself runs on the CPU in
``tools.cpu_emulate`` (g++), held here to the twins at a few shapes."""

import ctypes
import itertools
import shutil

import numpy as np
import pytest
import torch

from spacetime_tpu_torch.ops import dia_kernels as dk

SMEM_PER_BLOCK = 232_448  # the most dynamic shared memory an H100 block takes
SMS = 132  # the H100's SMs
# dofs a segment where csrc/dia.cu holds the values in its shared tile
# (TILE) or in registers (REGS, up to MAX_REG_TAPS offsets)
TILE, REGS = 0, 1
SEG = {TILE: 128, REGS: 256}
MAX_REG_TAPS = 16
MAX_DIAG = 64
MODES = tuple(dk.MODES)

# (m, offsets) of the repo's DIA levels: the nested lshape2d 32 cells
# refined 4× (195,585 / 48,641 / 12,033 / 2,945; 11 offsets), the AMG n =
# 256 fine level (48,641), the nested tetrahedra of FLAT_F64 (29,791; 15),
# the small levels of the tests (705, 343, 161), a synthetic one (300; 20)
LEVELS = [(195_585, 11), (48_641, 11), (12_033, 11), (2_945, 11),
          (29_791, 15), (705, 11), (343, 15), (161, 11), (300, 20)]
TS = (129, 128, 65, 64, 1, 2, 5)


def held(nd: int) -> int:
    """Where the library holds ``nd`` offsets' values."""
    return REGS if nd <= MAX_REG_TAPS else TILE


def want_occupancy(mode: int, f64: int, nd: int) -> tuple[int, int]:
    """(dynamic shared bytes, threads a block) of the march in ``mode`` on
    ``nd`` offsets: the first step from 0 holds no values, K18 A's alone
    (half K17's tile)."""
    if mode == dk.MODES["first_zero"] or held(nd) == REGS:
        return 0, SEG[REGS]
    arrays = 1 if mode == dk.MODES["apply"] else 2
    return arrays * nd * SEG[TILE] * (8 if f64 else 4), SEG[TILE]


@pytest.fixture(scope="module")
def emulated():
    """csrc/dia.cu compiled for the CPU by ``tools.cpu_emulate``."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the emulated kernels")
    from spacetime_tpu_torch.tools import cpu_emulate

    return cpu_emulate.build_dia(name="test_dia")


def blocks(m: int, T: int, form: int, chunk: int):
    """csrc/dia.cu ``launch_march``'s grid and ``dia_march_kernel``'s map:
    block (bx, by) writes the dofs bx·S … bx·S + S − 1 below m and the rows
    by·chunk … by·chunk + chunk − 1 below T, as (dof range, row range)."""
    S = SEG[form]
    for bx, by in itertools.product(range(-(-m // S)), range(-(-T // chunk))):
        yield (range(bx * S, min(bx * S + S, m)),
               range(by * chunk, min(by * chunk + chunk, T)))


@pytest.mark.parametrize("form", sorted(SEG))
def test_march_writes_each_row_and_dof_once(form):
    """A grid of segments by chunks is a product of the two axes' covers:
    each dof in one segment (the last ragged), each row in one chunk, at
    every chunk of 1 to T rows."""
    for m, _ in LEVELS:
        seen = np.zeros(m, dtype=int)
        for dofs, _ in blocks(m, 1, form, 1):
            seen[dofs.start:dofs.stop] += 1
        assert (seen == 1).all(), (m, form)
    assert any(m % SEG[form] for m, _ in LEVELS)  # ragged last segments
    for T in TS:
        for chunk in range(1, T + 1):
            rows = np.zeros(T, dtype=int)
            for _, r in blocks(1, T, form, chunk):
                rows[r.start:r.stop] += 1
            assert (rows == 1).all(), (T, chunk)


def test_form_by_offsets(emulated):
    """The library (csrc/dia.cu ``dia_march_occupancy``, emulated) holds
    the values in registers up to 16 offsets (every level of the repo's
    solves) and in a shared tile [k][dof] past them, which fits an H100
    block at 64 in f64; it refuses no offsets and more than 64. K18 takes
    the same forms, its tile half K17's."""
    for mode, f64 in itertools.product(range(len(MODES)), (0, 1)):
        for nd in range(MAX_DIAG + 2):
            out = [ctypes.c_int() for _ in range(3)]
            err = emulated.dia_march_occupancy(mode, f64, nd,
                                               *map(ctypes.byref, out))
            if not 1 <= nd <= MAX_DIAG:
                assert err != 0, (mode, nd)
                continue
            assert err == 0, (mode, f64, nd)
            assert (out[1].value, out[2].value) == want_occupancy(mode, f64,
                                                                  nd)
            assert out[1].value <= SMEM_PER_BLOCK
    assert all(held(nd) == REGS for m, nd in LEVELS if m != 300)


@pytest.mark.parametrize("mode", MODES)
def test_chunks_at_the_repos_levels(mode):
    """The chunk rule (``dia_chunk``) at the repo's levels and T = 129, 65
    and 1, with 1 to 8 blocks an SM: a chunk of 1 to T rows, two blocks an
    SM at least where the level allows it, and the held values' load
    weighed as rows."""
    for (m, nd), T, resident in itertools.product(LEVELS, (129, 65, 1),
                                                  (1, 2, 4, 8)):
        seg = -(-m // SEG[held(nd)])
        chunk = dk.dia_chunk(mode, T, seg, nd, resident, SMS)
        assert 1 <= chunk <= T, (m, T, chunk)
        if seg * T >= 2 * SMS:
            assert seg * -(-T // chunk) >= 2 * SMS, (m, T, resident, chunk)
    # the nested fine level at 4 blocks an SM: K16's steps in 2 chunks of
    # 65 rows (1,528 blocks, 3 waves), one wave of 764 at T = 1
    assert dk.dia_chunk("step", 129, 764, 11, 4, SMS) == 65
    assert dk.dia_chunk("step", 1, 764, 11, 4, SMS) == 1
    # the coarsest nested level (12 segments) walks few rows a block
    assert dk.dia_chunk("step", 129, 12, 11, 4, SMS) <= 8
    # the first step from 0 holds no values: nothing weighs against chunks
    # of one row
    assert dk.dia_chunk("first_zero", 129, 764, 11, 4, SMS) <= dk.dia_chunk(
        "step", 129, 764, 11, 4, SMS)
    # K18 holds nd values a dof and moves 2 fields a row: its values weigh
    # as 6 rows, K16's later step's (2·nd + 2) as 4
    assert dk.dia_chunk("apply", 129, 764, 11, 4, SMS) >= dk.dia_chunk(
        "step", 129, 764, 11, 4, SMS)


def test_dia_emulated_against_the_twins(emulated):
    """csrc/dia.cu compiled for the CPU (``tools.cpu_emulate``): K18, K17
    and K16 from 0 and from x at ν = 2, float32 and float64, T = 3 at
    every chunk (K18 also at T = 7), on the nested L-shape's level of 705
    dofs (11 offsets in registers, three segments) and a synthetic level
    of 20 offsets (the shared tile), against their twins."""
    from spacetime_tpu_torch.tools import cpu_emulate

    levels = cpu_emulate.dia_levels()
    n = cpu_emulate.check_dia(emulated, None, levels=[levels[0], levels[2]],
                              Ts=(3,), nus=(2,), apply_Ts=(7,))
    # per dtype and level: 3 chunks, each a K18 and a K17 launch and two
    # sweeps of 2; K18's 7 chunks at T = 7
    assert n == 2 * 2 * (3 * 6 + 7)


@pytest.mark.cuda
def test_dia_plan_is_the_librarys():
    """This file's plan is the library's (csrc/dia.cu
    ``dia_march_occupancy``): threads a block and shared bytes of every
    mode and dtype at 1 to 64 offsets, and ``dia_plan``'s; no offsets and
    more than 64 are refused (``cudaErrorInvalidValue``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from spacetime_tpu_torch.ops import native

    lib = native.LIB.get()
    for mode, f64, nd in itertools.product(
            range(len(MODES)), (0, 1),
            (0, 1, 11, 12, 13, 15, 16, 17, 20, 64, 65)):
        out = [ctypes.c_int() for _ in range(3)]
        err = lib.dia_march_occupancy(mode, f64, nd, *map(ctypes.byref, out))
        if not 1 <= nd <= MAX_DIAG:
            assert err != 0, (mode, nd)
            continue
        assert err == 0, (mode, f64, nd)
        want = want_occupancy(mode, f64, nd)
        assert (out[1].value, out[2].value) == want
        assert out[0].value >= 1
        dtype = torch.float64 if f64 else torch.float32
        plan = dk.dia_plan(MODES[mode], dtype, nd, 129, 195_585, 0)
        assert plan["threads"] == want[1]
        assert plan["segments"] == -(-195_585 // want[1])
        assert plan["held"] == ("none" if MODES[mode] == "first_zero"
                                else "shared" if want[0] else "registers")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dia_march_matches_twins_at_every_chunk(dtype):
    """K18, K17 and K16 (from 0 and from x, ν = 2 and 3) on the card at
    every chunk of 1 to T = 5 rows, on the nested L-shape of 8 cells
    refined three times (m = 2,945, 11 offsets: registers) and a synthetic
    level of 20 offsets (the shared tile), against their twins; the
    wrappers at their own plan, too."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from spacetime_tpu_torch.fem import (P1System, l_shape_mesh,
                                         refine_hierarchy)
    from spacetime_tpu_torch.ops import native
    from spacetime_tpu_torch.ops.multigrid import NestedMultiShiftMultigrid
    from spacetime_tpu_torch.tools.cpu_emulate import synthetic_level
    from spacetime_tpu_torch.tools.fused_ab import (_call, dia_columns,
                                                    dia_lib_apply,
                                                    dia_lib_residual,
                                                    dia_lib_smooth)

    mesh = refine_hierarchy(l_shape_mesh(8), 3)
    s = P1System.from_mesh(mesh)
    nested, _ = NestedMultiShiftMultigrid.build(mesh, s.A, s.M, m_coarse=64)
    lib = native.LIB.get()
    tol = 1e-5 if dtype == torch.float32 else 1e-13
    rng = np.random.default_rng(5)
    T = 5
    for lev in (nested.levels[0], synthetic_level(20, 300)):
        cols = dia_columns(lev, T, dtype, "cuda", rng)
        x, b = (torch.as_tensor(rng.standard_normal((T, lev.m)), dtype=dtype,
                                device="cuda") for _ in range(2))
        for nu in (2, 3):
            kl = dk.DiaKernelLevel(lev, nu)
            vals = kl.values(lev, dtype, "cuda")
            runs = [(kl.residual_plain(x, b, cols, vals),
                     lambda c: dia_lib_residual(_call, lib, kl, x, b, cols,
                                                vals, c),
                     lambda: kl.residual(x, b, cols, vals)),
                    (kl.apply_A_plain(x, vals),
                     lambda c: dia_lib_apply(_call, lib, kl, x, vals, c),
                     lambda: kl.apply_A(x, vals))]
            for zero in (True, False):
                runs.append((
                    kl.smooth_plain(x, b, cols, vals, zero_init=zero),
                    lambda c, z=zero: dia_lib_smooth(_call, lib, kl, x, b,
                                                     cols, vals, nu, z, c),
                    lambda z=zero: kl.smooth(x, b, cols, vals, zero_init=z)))
            for want, run, wrapper in runs:
                scale = float(want.abs().max())
                for chunk in range(1, T + 1):
                    err = float((run(chunk) - want).abs().max())
                    assert err <= tol * scale, (lev.m, nu, chunk, err)
                assert float((wrapper() - want).abs().max()) <= tol * scale
