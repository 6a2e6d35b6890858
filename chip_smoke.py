#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``spacetime_tpu_torch``) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (every check asserts; any failure exits non-zero):

1. device   — CUDA is required; prints the card's name and power limit.
2. build    — compiles csrc/*.cu with nvcc into build/ (at first use);
              prints each kernel's registers and shared memory (ptxas), the
              blocks per SM of the 3-D K6/K7/K14/K15 march instantiations
              and those of the 2-D K6/K7 ones (and their threads) on rows
              of 511, 255, 127 and 63 columns.
3. setup    — the 129²×64 ("cfg2") f32 solver: smooth2d, multigrid inner.
4. kernels  — K1 (B) and K2 (Bᵀ), plain and stab-fused, float32 and float64,
              against their plain PyTorch twins at the cfg2 shape (T=64,
              127×127), the 2-D flagship's (T=128, 511×511), those of the
              129³×64, 65³×32 and 17³×16 solves (T=64, 127³; T=32, 63³;
              T=16, 15³) and ragged ones (T=5, 9×13 and 7×9×15); median
              device times of 20 runs at cfg2, 511², 127³ and 63³.
5. mg kernels — K3 (sweep from x and from 0), K4, K5, K6, K7, K8 and K9
              against their twins in float32 and float64 with ν ∈ {2, 3}, at
              511² and 255² (T=129), 127² (T=65) and a ragged 15×31 (T=5);
              median device times (ν = 2) at 511²×129 and 127²×65, and of
              the y-marching K6 and K7 (with their semi-fused pairs) at
              every one of these shapes, ν = 2 and 3.
6. mg kernels 3-D — K3 (from x and from 0), K4, K5, K6, K7, K8 and K9 at
              63³ (T=65) and 31³ (T=33: the smooth3d 65³×32 solve's levels
              at K_X's rows; the 129³ flagship's finest level, 127³, is
              solved by ``run.py`` only) and a
              ragged 7×9×15 (T=5), float32 and float64, ν ∈ {2, 3} (K6 and
              K7 on the z-marching kernels); median device times (ν =
              2) at 63³×65, and ν = 3 for K6/K7 there. K5 is also timed
              against ``F.conv2d`` / ``F.conv3d`` with its stencil (the
              library call). Beside each timed fused stage, in 2-D and 3-D,
              the semi-fused pair it replaces: K3 from 0 + K8 for K6, K9 + K3
              from x for K7 (``semi_pair_ms``). K6 and K7 alone, with their
              pairs, are also held to their twins and timed at 127³×65 (the
              129³ solve's finest level), ν ∈ {2, 3}, float32 and float64
              (``FUSED_BIG``; the fields made on the card).
7. solve    — cfg2 ``solve(tol=1e-6)``: 16 ± 1 PCG iterations, L2 within 1%
              of 5.748e-05.
8. refined  — cfg2 ``solve_refined(tol=1e-8)`` twice: converged in 2 inner
              rounds and 25 ± 2 inner iterations, L2 within 1% of
              5.7525e-05; the second call's seconds are the steady time.
9. flagship — smooth2d at 513²×128 (33.8 MDoF), f32: setup, loads and L2
              seconds; ``solve(tol=1e-6)`` twice, 17 ± 2 iterations and L2
              within 20% of 3.812e-06 (f32 rounding, see REF_FLAGSHIP); one
              ``solve_refined(tol=1e-8)``, converged, L2 within 1% of the
              float64 solve's 3.5877e-06.
10. V(2,1)  — cfg2 with ``mg_nu_post=1`` (the semi-fused stages K3 → K8 →
              K9 → K3 in place of K6/K7): ``solve(tol=1e-6)`` within ±1 of
              the JAX package's 17 iterations, then ``solve_refined``.
11. f64     — cfg2 in float64, ``solve(tol=1e-8)``: the JAX package's 21
              iterations ± 1, L2 within 1e-6 of 5.7525369e-05.
12. smooth3d — 65³×32 (8.3 MDoF), f32, inner mg: ``solve(tol=1e-6)`` twice,
              the JAX package's 14 iterations ± 1, L2 within 1% of its
              2.5223e-04; every level runs the fused K6/K7, none K3/K8/K9.
13. smooth3d f64 — 17³×16, ``solve(tol=1e-8)``: the JAX package's 18
              iterations exactly, L2 within 1e-6 of 3.999081e-03; K6/K7 on
              every level, no K3/K8/K9.
14. weighted mg kernels — K10 (sweep from x and from 0), K11, K12, K13,
              K14 and K15 against their twins in float32 and float64 with
              ν ∈ {1, 2, 3} (K14/K15 at ν ∈ {2, 3}), at 511² and 255²
              (T=129), 127² (T=65) and a ragged 15×31 (T=5), W the weights
              of the varcoef2d assembly at that size; median device times
              (ν = 2) at 511²×129 and 127²×65.
15. varcoef2d 129²×64 f32 — ``solve(tol=1e-6)`` within ±1 of the JAX
              package's 16 iterations, L2 within 1% of its value;
              ``solve_refined(tol=1e-8)``: rounds and inner iterations within
              ±2 of its 2 and 25.
16. varcoef2d 513²×128 f32 — setup, loads and L2 seconds; ``solve(tol=1e-6)``
              twice, 16 ± 2 iterations, L2 within 20% of the port's float64
              solve (3.564768e-06, see REF_VAR_FLAGSHIP); one
              ``solve_refined(tol=1e-8)``, L2 within 1% of it.
17. varcoef2d f64 — 33²×16, ``inner="mg"``, ``mg_coarse=8``,
              ``solve(tol=1e-8)``: the JAX package's 18 iterations exactly,
              L2 within 1e-6 of its value.
18. weighted mg kernels 3-D — the varcoef3d 65³×32 f32 solver's setup;
              K10 (from x and from 0), K11, K12, K13, K14 and K15 (ν ∈ {2,
              3}) against their twins in float32 and float64 with ν ∈ {1, 2,
              3}, at 63³ and 31³
              (T=33, the weights of that solver's two Galerkin levels), a
              ragged 7×9×15 (T=5, the 63³ weights cut to it) and 127³
              (T=33, the 63³ weights tiled to it: W outside the L2, the
              row-first order); median device times (ν = 2, and ν = 3 for
              K14/K15, beside their semi-fused pairs K10 from 0 + K13 and K9
              + K10 from x) at 63³×33 and 127³×33.
19. varcoef3d 65³×32 f32 — ``solve(tol=1e-6)`` twice, within ±1 of the
              JAX package's 14 iterations, L2 within 1% of its value;
              ``solve_refined(tol=1e-8)`` converges. Every level runs the
              fused K14/K15, none K10/K13/K9.
20. varcoef3d f64 — 17³×16, ``solve(tol=1e-8)``: the JAX package's 18
              iterations exactly, L2 within 1e-6 of its value; K14/K15.
21. weighted V(2,1) — varcoef2d 129²×64 f32 with ``mg_nu_post=1`` (the
              semi-fused K10 → K13 → K9 → K10 in place of K14/K15):
              ``solve(tol=1e-6)`` within ±1 of the JAX package's 17
              iterations, L2 within 1% of its value; ``solve_refined``.
22. K20 — the lshape2d n=256, J=6 solver's setup (``ell``, ``cheb``, f32);
              the blocked-ELL SpMM against its twin in float32 and float64
              on that solver's A (T ∈ {1, 2, 4, 8, 16, 32, 64, 65}: every
              row count of its SpMVs and every tile variant of the kernel)
              and M (T=64), the n=32 A (T=33) and a ragged random matrix
              (m=300, T=5), within 1e-5·max|twin| (f32) and 1e-13 (f64);
              median times at T ∈ {1, 2, 4, 8, 16, 32, 64} beside
              ``torch.sparse.mm`` (cuSPARSE CSR), the bound from the
              nonzeros and the bound of the stored blocks.
23. chained sweeps — K3 and K10 above the tiled ν (ν = 9 in 2-D at
              127²×65 and 15×31×5; ν = 4, 5 in 3-D at 63³×33, 15³×17 and
              7×9×15×5), from x and from 0, against their twins.
24. ν paths — smooth3d 17³×16 f64 ``mg_nu=4``: the JAX package's 17
              iterations exactly, L2 within 1e-6; f32 ``solve_refined`` with
              ν = 4 (smooth3d, varcoef3d 17³×16) and ν = 9 (smooth2d,
              varcoef2d 33²×16): each launches the chained sweep in both
              dtypes and never the tiled one.
25. oracle rows — cfg1, ladder-32, cfg3, cfg4 (singular2d, graded J4+4),
              singular3d-8 (graded J2+3), moving-peak-32, lshape-32-J5 (on
              ``ell``) and varcoef-32-J5 in float64 with dense inner
              solves: the iterations of ``baseline_oracle.json`` and its
              7-digit residual histories.
26. L-shape — lshape2d n=256, J=6 (3.16 MDoF), ``ell`` + ``cheb``, f32:
              ``solve(tol=1e-6)`` twice, 15 ± 1 iterations, exactly
              ``k20_per_solve`` K20 launches and no other kernel, L2 within
              1% of the JAX package's on the CPU (``dia``, f32).
27. K16–K19 — the setup of lshape2d on 32 cells red-refined 4 times, J=7
              (25.2 MDoF, nested multigrid) and of the AMG solver on phase
              26's n=256 system; K16 (from 0, from x), K17 and K18 against
              their twins on the nested fine level (T=129, 128), its second
              level (T=129) and the AMG DIA fine level (m=48641, T=65, 64),
              K19 and the K20 transfers on the AMG ELL level (m=8191, T=65,
              64), f32 and f64, within 1e-5 (f32)
              and 1e-13 (f64) of max|twin|; times at the fine level (T=129)
              and the ELL level beside ``torch.sparse.mm`` (K18, and two of
              them for K19) and their bounds.
28. nested  — the 25.2 MDoF solve, f32, ``solve(tol=1e-6)`` twice: 15 ± 1
              iterations (the JAX package's on the TPU), L2 within 1% of
              its 1.2846e-05, exactly ``flat_per_solve`` launches of K16–K18
              and no other kernel; steady seconds and launches per solve.
29. AMG     — the n=256 solve, f32, twice: the JAX package's 16 iterations
              on the CPU ± 1, L2 within 1% of its value, ``flat_per_solve``
              launches of K16–K20; then float64 solves of ``FLAT_F64``
              (nested L-shape, AMG with an ELL level, nested tetrahedra) to
              the JAX package's iterations and L2 (1e-6), and an f32
              ``solve_refined`` with ν = 4 on the tetrahedra, K16 at ν = 4
              in both dtypes.
30. 3-D V(2,1) — smooth3d and varcoef3d 33³×16 with ``mg_nu_post=1``
              (the semi-fused K3 → K8 → K9 → K3, K10 → K13 → K9 → K10 in
              place of the fused stages), f32 ``solve(tol=1e-6)`` and f64
              ``solve(tol=1e-8)``: the JAX package's CPU iterations ± 1, L2
              within 1% (f32) and 1e-6 (f64) of its values; no fused
              launch.
31. singular3d — 65³ on a graded grid, J5+4 (36 steps, 9.25 MDoF), f32,
              inner mg: ``solve(tol=1e-6)`` twice, the JAX package's CPU
              iterations ± 1, L2 within 1% of its value; K6/K7 on every
              level.
32. singular2d — 513² on a graded grid, J7+6 (134 steps, 35.2 MDoF), f32,
              inner mg: ``solve(tol=1e-6)`` twice, 17 ± 1 iterations (the
              TPU's), L2 within 20% of the TPU's 1.17e-05 (f32 rounding, as
              REF_FLAGSHIP); K6/K7 on every level.

33. sharded-slab forms — K3 with its validity field (from x and from 0),
              K6, K7, K8 and K9 with ``lead`` against their twins at the
              (time 2 × space 2) mesh's finest slabs, f32 and f64: the 2-D
              flagship's (T 65 and 64, own 256, h 3, 511 columns) and
              smooth3d 65³×32's (T 17, own 32, 63² planes); each timed
              (ν = 2) beside the serial form at the owned shape (one plane
              more: the serial transfers take odd extents) and its bound,
              the halo planes and the field counted; the 2-D K6 and K7
              also at ν = 3 (h 4).
34. time mesh — four ranks on the card over gloo (halos through host
              memory): cfg2 f64, the serial port's 21 iterations, history
              within rtol 1e-9 of its; cfg4 (singular2d graded J4+4, f64)
              on three ranks, the general layout: the oracle's 13
              iterations, 7-digit history and L2.
35. time × space mesh (2 × 2) — cfg2 f64 (the serial port's 21 and its
              history), cfg2 V(2,1) f32 (the semi-fused sharded stages,
              within ±1 of the serial port's iterations), smooth2d 33²×16
              f64 V(2,1), and the 513²×128 flagship f32 ``solve(tol=1e-6)``
              twice: 17 ± 2 iterations, L2 within 20% of 3.812e-06, K6/K7
              lead on every sharded level (4 launches per rank and
              V-cycle), steady seconds beside the serial port's; every
              rank prints its launches, exchanges and bytes staged per
              iteration.
36. 3-D on (2 × 2) — smooth3d 65³×32 f32: 14 ± 1 iterations, L2 within 1%
              of 2.5223e-04, the 3-D lead forms launched; smooth3d 17³×16
              f64 V(2,2) and V(2,1) and f32 V(2,1) (the remaining 3-D
              forms).

Launch counters are zeroed just before each path (phases 7–8, 9, 10, 11,
12, 13, 15, 16, 17, 19, 20, 21, each solve of 24, 25 and 29, 26, 28, the
f32 AMG solves of 29, each solve of 30, 31 and 32, and on every rank each
solve of 34–36, summed over the ranks) and read just after it;
each path asserts the kernels it must have launched, and a path that it
ran only the kernels of its branch (K9 the one constant kernel of the
weighted semi-fused stages). The last two lines are a JSON object
describing the kernels and ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
SPACE_N, TIME_LEVELS = 128, 6
FLAGSHIP_N, FLAGSHIP_LEVELS = 512, 7
FLAGSHIP_KRON = (2 ** FLAGSHIP_LEVELS, (FLAGSHIP_N - 1,) * 2)
# (T, grid, timed) of the K1/K2 checks besides cfg2's own: the 2-D
# flagship's, a ragged 2-D grid, the 129³×64, 65³×32 and 17³×16 solves' and
# a ragged 3-D grid.
KRON_SHAPES = [FLAGSHIP_KRON + (True,), (5, (9, 13), False),
               (64, (127,) * 3, True), (32, (63,) * 3, True),
               (16, (15,) * 3, False), (5, (7, 9, 15), False)]
REF_SOLVE = {"iterations": 16, "l2": 5.748e-05}
REF_REFINED = {"iterations": 25, "rounds": 2, "l2": 5.7525e-05}
# The JAX package at 513²×128, f32, device loads (results_tpu/
# r2_2d_presets.log:2). An f32 solve's L2 at this size carries the rounding
# of the f32 operator (K_Y enters S): loads perturbed by 1e-7 relative moved
# the port's L2 between 3.79e-06 and 4.38e-06 on an H100, so the f32 band is
# 20%. The f64-leg refinement is free of it and is held to 1% of the port's
# float64 solve at this size (21 iterations, L2 3.5877e-06, on an H100); the
# float64 path is held to the JAX package at cfg2 in phase 11.
REF_FLAGSHIP = {"iterations": 17, "l2": 3.812e-06, "l2_band": 0.2,
                "l2_f64": 3.5877e-06}
# The JAX package on the CPU at cfg2, f32, inner="mg", host loads,
# mg_nu_post=1, tol 1e-6 (pallas_kron=False: no level reaches its kernels).
REF_V21 = {"iterations": 17}
# The JAX package on the CPU at cfg2, f64, inner="mg", host loads, tol 1e-8.
REF_F64 = {"iterations": 21, "l2": 5.752536865509208e-05}
# The JAX package on the CPU, smooth3d, inner="mg" (coarse 16), host loads:
# 65³×32 f32 at tol 1e-6 (the cfg3 preset, 8.3 MDoF), and 17³×16 f64 at tol
# 1e-8. At 65³ the discretization error (2.5e-04) dwarfs f32 rounding, so
# the f32 band is 1%.
REF_3D = {"n": 64, "levels": 5, "iterations": 14, "l2": 2.522348342273894e-04,
          "l2_band": 0.01}
REF_3D_F64 = {"n": 16, "levels": 4, "iterations": 18,
              "l2": 3.999081235687421e-03}
# varcoef2d (κ = 1 + ½·Πsin(πx), c = 1 + x₀; the weighted Galerkin V-cycle).
# The JAX package on the CPU at 129²×64 f32: ``JAX_ENABLE_X64=1 python -m
# spacetime_tpu.run --backend jax --device cpu --problem varcoef2d
# --space-n 128 --time-levels 6 --dtype f32 --inner mg --rhs host`` (and
# ``--refined --tol 1e-8``). At 33²×16 f64 with mg_coarse=8, tol 1e-8: its
# HeatSolver, which tests/test_torch_varcoef.py holds the port's CPU run to
# (iterations exactly, L2 to 1e-9).
REF_VAR = {"n": 128, "levels": 6, "iterations": 16,
           "l2": 5.6389958396755104e-05, "refined_iterations": 25,
           "refined_rounds": 2}
REF_VAR_F64 = {"n": 32, "levels": 4, "iterations": 18,
               "l2": 9.14383890518168e-04}
# The port at 513²×128 on an H100 (``python -m spacetime_tpu_torch.run
# --problem varcoef2d --device cuda --dtype f64 --space-n 512
# --time-levels 7 --tol 1e-8``): the float64 solve took 21 iterations to
# L2 3.564768e-06. The f32 solve's L2 carries f32 rounding of the
# operator (as REF_FLAGSHIP), hence the 20% band on it; the f64-leg
# refinement is held to 1%.
REF_VAR_FLAGSHIP = {"n": 512, "levels": 7, "iterations": 16,
                    "l2_f64": 3.564768e-06, "l2_band": 0.2}
# varcoef3d and the weighted V(2,1), the JAX package on the CPU
# (``JAX_ENABLE_X64=1 python -m spacetime_tpu.run --backend jax --device cpu
# --inner mg --rhs host``): ``--problem varcoef3d --space-n 64
# --time-levels 5 --dtype f32`` (tol 1e-6); ``--space-n 16 --time-levels 4
# --dtype f64 --tol 1e-8``; ``--problem varcoef2d --space-n 128
# --time-levels 6 --dtype f32 --mg-nu-post 1``. At 65³ the discretization
# error dwarfs f32 rounding, so the f32 band is 1%.
REF_VAR3D = {"n": 64, "levels": 5, "iterations": 14,
             "l2": 2.455036945354092e-04, "l2_band": 0.01}
REF_VAR3D_F64 = {"n": 16, "levels": 4, "iterations": 18,
                 "l2": 3.8913328499968662e-03}
REF_VAR_V21 = {"n": 128, "levels": 6, "iterations": 17,
               "l2": 5.631016437524917e-05}
# smooth3d 17³×16 f64 with mg_nu=4 (every sweep above the tiled ν ≤ 3, so
# the chained sweep): the JAX package on the CPU (``HeatSolver(..., inner=
# "mg", mg_nu=4, rhs="host").solve(tol=1e-8)``).
REF_3D_NU4 = {"n": 16, "levels": 4, "iterations": 17,
              "l2": 3.9991208990437874e-03}
# lshape2d at n = 256, J = 6 (m = 48,641, 65 time nodes, 3.16 MDoF), f32,
# Chebyshev inner solves, tol 1e-6: the JAX package on the CPU on the "dia"
# format, which computes the operator that "ell" does (``JAX_ENABLE_X64=1
# python -m spacetime_tpu.run --backend jax --device cpu --problem lshape2d
# --space-n 256 --time-levels 6 --dtype f32 --spatial dia --inner cheb
# --rhs host``): 15 iterations to rel 8.003e-07, the count of its TPU run
# (results_tpu/lshape_scale.log). The discretization error (5.1e-05)
# dwarfs f32 rounding, so the band is 1%. "blocked_steady_s": the steady
# solve of this script's phase 26 on an NVIDIA H100 80GB HBM3 (700 W) when
# K20 read the 128 × 128 blocks, printed beside the current one.
REF_LSHAPE = {"n": 256, "levels": 6, "iterations": 15,
              "l2": 5.147463862566411e-05, "l2_band": 0.01,
              "blocked_steady_s": 15.7110}
# lshape2d on the base mesh of 32 cells red-refined 4 times (m = 195,585,
# 128 steps, 25.2 MDoF), f32, nested multigrid (levels 195,585 / 48,641 /
# 12,033 / 2,945, coarse 705): the JAX package on the TPU took 15
# iterations to L2 1.2846e-05 (results_tpu/r3_lshape_dia2.log; 15 and
# 1.2832e-05 in results_tpu/lshape_nested_mg.log). The discretization
# error dwarfs f32 rounding, so the band is 1%.
REF_NESTED = {"n": 32, "refine": 4, "levels": 7, "iterations": 15,
              "l2": 1.284616544786488e-05, "l2_band": 0.01}
# lshape2d n = 256, J = 6, f32, smoothed-aggregation multigrid (levels
# 48,641 DIA / 8,191 ELL): the JAX package on the CPU (``JAX_ENABLE_X64=1
# python -m spacetime_tpu.run --backend jax --device cpu --problem lshape2d
# --space-n 256 --time-levels 6 --dtype f32 --inner amg --rhs host``): 16
# iterations to rel 9.213e-07, the count of its TPU run
# (results_tpu/lshape_amg.log). "blocked_steady_s" as REF_LSHAPE's, with
# the blocked K19 and K20 (phase 29).
REF_AMG = {"n": 256, "levels": 6, "iterations": 16,
           "l2": 5.150423435807143e-05, "l2_band": 0.01,
           "blocked_steady_s": 0.2835}
# Small float64 solves of the flat hierarchies (every kernel's f64 form in
# a solve, 2-D and 3-D): (label, problem, cells, refinements, time levels, solver options,
# the JAX package's iterations and L2 on the CPU: ``HeatSolver(problem,
# P1System.from_problem(problem, refine_hierarchy(mesh, refinements)),
# uniform_time_grid(levels), rhs="host", **options).solve(tol=1e-8)``)
FLAT_F64 = [
    ("nested lshape2d", "lshape2d", 8, 3, 4, {"inner": "mg"}, 15,
     0.0008227597063555218),
    ("amg lshape2d", "lshape2d", 64, 0, 3,
     {"inner": "amg", "mg_coarse": 300}, 19, 0.0008201615145908035),
    ("nested smooth3d", "smooth3d", 8, 2, 3, {"inner": "mg"}, 18,
     0.001007288869638708),
]
# 3-D V(2,1) cycles (mg_nu_post=1) at 33³×16, the JAX package on the CPU
# (``JAX_ENABLE_X64=1 python -m spacetime_tpu.run --backend jax --device cpu
# --rhs host --inner mg --mg-nu-post 1 --space-n 32 --time-levels 4``, with
# ``--problem smooth3d`` / ``varcoef3d`` and ``--dtype f32`` (tol 1e-6) or
# ``--dtype f64 --tol 1e-8``)
REF_V21_3D = {
    "n": 32, "levels": 4,
    ("smooth3d", "float32"): {"iterations": 14, "l2": 0.0010079629696780642},
    ("smooth3d", "float64"): {"iterations": 19, "l2": 0.0010079707661571947},
    ("varcoef3d", "float32"): {"iterations": 14, "l2": 0.0009808898473296574},
    ("varcoef3d", "float64"): {"iterations": 19, "l2": 0.0009809012450097626},
}
# singular3d (u = t^¾ Πsin(πx)) at 65³ on the graded grid J5+4 (36 steps,
# 9.25 MDoF), f32, inner mg (coarse 16), tol 1e-6: the JAX package on the
# CPU (``JAX_ENABLE_X64=1 python -m spacetime_tpu.run --backend jax --device
# cpu --rhs host --inner mg --problem singular3d --space-n 64 --time-levels
# 5 --extra-levels 4 --dtype f32``): 15 iterations; its TPU run took 14 to
# L2 2.40e-04 (BASELINE.md), and the port is held within ±1 of both. At 65³
# the discretization error dwarfs f32 rounding, so the band is 1%.
REF_SINGULAR3D = {"problem": "singular3d", "n": 64, "levels": 5, "extra": 4,
                  "iterations": 15, "tpu_iterations": 14,
                  "l2": 0.00023987905864560177, "l2_band": 0.01,
                  "source": "JAX CPU"}
# singular2d at 513² on the graded grid J7+6 (134 steps, 35.2 MDoF), f32,
# inner mg: the JAX package's TPU run (BASELINE.md, "cfg4 at scale": 17
# iterations, L2 1.17e-05). Its CPU run at this size was not made; an f32
# solve's L2 at 513² carries the rounding of the f32 operator, so the band
# is 20% (as REF_FLAGSHIP's).
REF_SINGULAR2D = {"problem": "singular2d", "n": 512, "levels": 7, "extra": 6,
                  "iterations": 17, "l2": 1.17e-05, "l2_band": 0.2,
                  "source": "TPU"}
# T of the K16–K18 checks at the nested fine level (K_X's 129 rows and
# K_Y's 128) and of the K16–K18 and K19 checks at the AMG n = 256 levels
# (K_X's 65 and K_Y's 64 at its DIA fine level and its ELL level)
DIA_T = (129, 128)
PAIR_T = (65, 64)
# The oracle's rows solved in float64 on the card (dense inner solves;
# cfg1b, the other ladders and varcoef3d-8-J3 are held on the CPU,
# tests/test_torch_oracle.py): (config, problem, cells, levels, extra
# levels toward t = 0, tol, spatial format)
ORACLE_ROWS = [
    ("cfg1-2d-65x65x64-tol1e-6", "smooth2d", 64, 6, 0, 1e-6, "auto"),
    ("2d-ladder-32x32x32", "smooth2d", 32, 5, 0, 1e-6, "auto"),
    ("cfg3-3d-17x17x17x16", "smooth3d", 16, 4, 0, 1e-6, "auto"),
    ("cfg4-singular-graded-32-J4+4", "singular2d", 32, 4, 4, 1e-6, "auto"),
    ("singular3d-graded-8-J2+3", "singular3d", 8, 2, 3, 1e-6, "auto"),
    ("moving-peak-32x32x32", "moving_peak2d", 32, 5, 0, 1e-6, "auto"),
    ("lshape-32-J5", "lshape2d", 32, 5, 0, 1e-6, "ell"),
    ("varcoef-32-J5", "varcoef2d", 32, 5, 0, 1e-6, "auto"),
]
# K20's checks: T rows of the n = 256 L-shape's A (K_X's wavelet levels
# take 1, 2, 4, ..., 32 rows, K_Y's 64, B and the rhs 65; every tile
# variant of csrc/ell.cu, 1, 2, 4 and 8 rows per thread, is among them)
# and M, the n = 32 A (the oracle row) and a ragged random matrix
# (m = 300); the timed T at n = 256: every row count of the solve's SpMVs
ELL_T = (1, 2, 4, 8, 16, 32, 64, 65)
ELL_TIMED = (1, 2, 4, 8, 16, 32, 64)
# The chained sweeps (ν above the tiled kernels' 8 in 2-D and 3 in 3-D):
# (T, grid, ν, timed); the timed shapes are K_X's row count at the 2-D
# cfg2 fine level and at 63³, the 3-D paths' shapes (17³×16: 15³, T=17)
CHAIN_SHAPES = {2: [(65, (127, 127), 9, True), (5, (15, 31), 9, False)],
                3: [(33, (63,) * 3, 4, True), (33, (63,) * 3, 5, False),
                    (17, (15,) * 3, 4, False), (5, (7, 9, 15), 5, False)]}
CHAIN_MAIN = {2: (65, (127, 127)), 3: (33, (63,) * 3)}
# (T, grid) of the multigrid kernel checks: the 2-D flagship's fine and
# first coarse level, cfg2's fine level at K_X's row count, the 3-D
# flagship's two finest levels, and ragged shapes.
MG_SHAPES = [(129, (511, 511)), (129, (255, 255)), (65, (127, 127)),
             (5, (15, 31))]
MG_SHAPES_3D = [(65, (63, 63, 63)), (33, (31, 31, 31)), (5, (7, 9, 15))]
# (T, grid) where phase 6 holds and times the fused stages K6 and K7 alone,
# beside their pairs: the 129³×64 solve's finest level at K_X's rows
FUSED_BIG = (65, (127, 127, 127))
# (T, grid, cells of the assembly its weights come from) of the weighted
# kernels' checks: the varcoef2d flagship's two finest levels, its 129²
# run's finest level at K_X's row count, and a ragged grid (the 127²
# weights cut to it)
VAR_SHAPES = [(129, (511, 511), 512), (129, (255, 255), 256),
              (65, (127, 127), 128), (5, (15, 31), 128)]
# (T, grid, Galerkin level of the varcoef3d 65³×32 solver whose weights it
# takes) of the 3-D weighted kernels' checks: that solver's two levels at
# K_X's row count, a ragged grid (the 63³ weights cut to it), and the
# 129³×32 solver's finest level, whose W (123 MB in f32) does not fit in
# the L2, so the kernels take the row fastest there (the 63³ weights tiled
# to it)
VAR_SHAPES_3D = [(33, (63, 63, 63), 0), (33, (31, 31, 31), 1),
                 (5, (7, 9, 15), 0), (33, (127, 127, 127), 0)]
MG_TIMED = [(129, (511, 511)), (65, (127, 127)), (65, (63, 63, 63)),
            (33, (63, 63, 63)), (33, (127, 127, 127))]
# where the 3-D fused stages are also timed at ν = 3: the shapes of the
# kernel table's 3-D rows (K6/K7 at 63³×65, K14/K15 at 63³ and 127³ ×33);
# the 2-D K6/K7 are timed at ν = 2 and 3 at every MG_SHAPES
FUSED_NU3_TIMED = [(65, (63, 63, 63)), (33, (63, 63, 63)),
                   (33, (127, 127, 127))]
# the shape of each kernel's headline numbers in the JSON line, by family
# (constant or weighted) and dimension
MG_MAIN = {("const", 2): (129, (511, 511)), ("const", 3): (65, (63,) * 3),
           ("var", 2): (129, (511, 511)), ("var", 3): (33, (63,) * 3)}
# max|kernel − twin| ≤ tol · max|twin|. f32: FMA contraction and the order
# of the tap sums differ from PyTorch's; f64: the same, at f64 rounding.
TOL = {torch.float32: 1e-5, torch.float64: 1e-13}
# The least time of a kernel's work on an H100 SXM (NVIDIA's data sheet):
# HBM3 at 3.35 TB/s; 67 TFLOP/s float32 and 34 TFLOP/s float64 outside the
# tensor cores (the kernels use no tensor core).
HBM_BYTES_PER_S = 3.35e12
DEVICE = "cuda"  # where the checks' tensors live
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}


_PHASE = {"name": None, "t0": 0.0}


def phase(name: str | None) -> None:
    """Start phase ``name`` (None ends the last), printing the seconds of
    the phase before."""
    now = time.perf_counter()
    if _PHASE["name"] is not None:
        print(f"-- {_PHASE['name']}: {now - _PHASE['t0']:.2f} s", flush=True)
    _PHASE.update(name=name, t0=now)
    if name is not None:
        print(f"\n== {name}", flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def shape_key(T, gs) -> str:
    return "x".join(str(n) for n in (T,) + tuple(gs))


def bound(nbytes: float, flops: float, dtype) -> dict:
    """The least time of the work: bytes over the HBM rate or operations
    over the peak rate, whichever is larger, in ms."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[dtype] * 1e3
    if by_bytes >= by_ops:
        return {"bound_ms": by_bytes, "bound_by": "bytes"}
    return {"bound_ms": by_ops, "bound_by": "operations"}


def stencil_ops(groups) -> int:
    """Operations per point of a grouped stencil: the tap sums, one multiply
    and one add per group."""
    return sum(len(ds) + 2 for _, ds in groups)


def kron_bound(form, taps, T, dtype) -> dict:
    """Bytes (each input read once, each output written once) and
    operations of one K1/K2 form at T time rows."""
    m = int(np.prod(taps.gs))
    s = torch.finfo(dtype).bits // 8
    sM, sA = stencil_ops(taps.groups_M), stencil_ops(taps.groups_A)
    if form.startswith("B_") or form == "B":
        stab = form == "B_stab"
        nbytes = s * ((T + 1) * m + (2 if stab else 1) * T * m + (2 if stab else 1) * T)
        flops = T * m * (4 + sM + sA + (sA + 1 if stab else 0))
    else:
        stab = form == "BT_stab"
        nbytes = s * ((2 if stab else 1) * T * m + (T + 1) * m + T)
        flops = T * m * (sM + sA + 1) + (T + 1) * m * (3 + (2 if stab else 0))
    return bound(nbytes, flops, dtype)


def mg_bound(form, kl, T, dtype) -> dict:
    """Bytes (each input read once, each output written once) and
    operations of one multigrid kernel form at T time rows."""
    m = int(np.prod(kl.gs))
    mc = int(np.prod(kl.coarse_gs))
    s = torch.finfo(dtype).bits // 8
    op = stencil_ops(kl.pairs)
    nu = kl.nu
    sweep = op * nu + 4 + 6 * (nu - 1)  # from x: r, d, x; then ν−1 steps
    sweep0 = 2 + (op + 6) * (nu - 1)  # from 0: r = b/D, d = x
    restrict = 2 ** (kl.dim + 1)  # per coarse point
    cols = 4 * T
    nbytes, flops = {
        "smooth": (s * (3 * T * m + cols), T * m * sweep),
        "smooth_zero": (s * (2 * T * m + cols), T * m * sweep0),
        "residual": (s * (3 * T * m + T), T * m * (op + 1)),
        "apply_A": (s * 2 * T * m, T * m * stencil_ops(kl.groups_A)),
        "fused_pre": (s * (2 * T * m + T * mc + cols),
                      T * m * (sweep0 + op + 1) + T * mc * restrict),
        "fused_post": (s * (3 * T * m + T * mc + cols), T * m * (sweep + 3)),
        "residual_restrict": (s * (2 * T * m + T * mc + T),
                              T * m * (op + 1) + T * mc * restrict),
        "prolong_correct": (s * (2 * T * m + T * mc), T * m * 3),
    }[form]
    return bound(nbytes, flops, dtype)


def var_bound(form, kl, T, dtype) -> dict:
    """Bytes (each input read once, the weights W once, each output written
    once) and operations of one weighted kernel at T time rows; the 1/D of
    a node costs two operations."""
    m = int(np.prod(kl.gs))
    mc = int(np.prod(kl.coarse_gs))
    s = torch.finfo(dtype).bits // 8
    nt = len(kl.A_vs.disps)
    a_ops = 2 * nt - 1
    op = a_ops + stencil_ops(kl.groups_M) + 2  # + ω·M x and the add
    nu = kl.nu
    sweep = op * nu + 4 + 6 * (nu - 1)
    sweep0 = 2 + (op + 6) * (nu - 1)
    restrict = 2 ** (kl.dim + 1)  # per coarse point
    cols = 3 * T
    nbytes, flops = {
        "smooth": (s * (3 * T * m + nt * m + cols), T * m * (2 + sweep)),
        "smooth_zero": (s * (2 * T * m + nt * m + cols),
                        T * m * (2 + sweep0)),
        "residual": (s * (3 * T * m + nt * m + T), T * m * (op + 1)),
        "apply_A": (s * (2 * T * m + nt * m), T * m * a_ops),
        "residual_restrict": (s * (2 * T * m + T * mc + nt * m + T),
                              T * m * (op + 1) + T * mc * restrict),
        "fused_pre": (s * (2 * T * m + T * mc + nt * m + cols),
                      T * m * (2 + sweep0 + op + 1) + T * mc * restrict),
        "fused_post": (s * (3 * T * m + T * mc + nt * m + cols),
                       T * m * (2 + sweep + 3)),
    }[form]
    return bound(nbytes, flops, dtype)


def var_forms(kl, x) -> dict:
    """{form: (kernel op, kernel_fn, twin_fn)} of one VarMSKernelLevel.
    K14/K15 (fused) where the level takes them."""
    X, B, EC, c, W = x["x"], x["b"], x["ec"], x["cols"], x["W"]
    forms = {
        "smooth": ("smooth_var", lambda: (kl.smooth(X, B, c, W),),
                   lambda: (kl.smooth_plain(X, B, c, W),)),
        "smooth_zero": (
            "smooth_var", lambda: (kl.smooth(None, B, c, W, zero_init=True),),
            lambda: (kl.smooth_plain(None, B, c, W, zero_init=True),)),
        "residual": ("residual_var", lambda: (kl.residual(X, B, c, W),),
                     lambda: (kl.residual_plain(X, B, c, W),)),
        "apply_A": ("apply_var", lambda: (kl.apply_A(X, W),),
                    lambda: (kl.apply_A_plain(X, W),)),
        "residual_restrict": (
            "residual_restrict_var",
            lambda: (kl.residual_restrict(X, B, c, W),),
            lambda: (kl.residual_restrict_plain(X, B, c, W),)),
    }
    if kl.fused_ok:
        forms["fused_pre"] = ("fused_pre_var", lambda: kl.fused_pre(B, c, W),
                              lambda: kl.fused_pre_plain(B, c, W))
        forms["fused_post"] = ("fused_post_var",
                               lambda: (kl.fused_post(X, B, EC, c, W),),
                               lambda: (kl.fused_post_plain(X, B, EC, c, W),))
    return forms


def var_hierarchy(n: int):
    """The one-level varcoef2d Galerkin hierarchy at ``n`` cells: its level
    holds the weights ``VarStencilOperator.from_dia`` reads off the
    assembly there."""
    from spacetime_tpu_torch.fem import P1System, unit_square_mesh
    from spacetime_tpu_torch.models import get_problem
    from spacetime_tpu_torch.ops.multigrid import GalerkinMultiShiftMultigrid

    system = P1System.from_problem(get_problem("varcoef2d"),
                                   unit_square_mesh(n))
    return GalerkinMultiShiftMultigrid.build(2, n, system.A, system.M,
                                             n_coarse=n // 2)[0]


def var_inputs(msmg, kl, T, dtype, rng, lvl=0) -> dict:
    """x, b (T, *gs), e_c, the weights of level ``lvl`` cut (or tiled) to
    the grid and that level's columns of random shifts, on the card."""
    from spacetime_tpu_torch.ops.multigrid import var_row_params

    mk = lambda a: torch.as_tensor(a, dtype=dtype, device=DEVICE)
    omega = np.abs(rng.standard_normal(T)) * 20
    lp = var_row_params(msmg, omega, dtype, DEVICE)[lvl]
    Aw = msmg.levels[lvl].Aw
    grow = [(0, 0)] + [(0, max(n - m, 0)) for n, m in zip(kl.gs, Aw.shape[1:])]
    cut = (slice(None),) + tuple(slice(0, n) for n in kl.gs)
    return {
        "x": mk(rng.standard_normal((T,) + kl.gs)),
        "b": mk(rng.standard_normal((T,) + kl.gs)),
        "ec": mk(rng.standard_normal((T,) + kl.coarse_gs)),
        "W": mk(np.ascontiguousarray(np.pad(Aw, grow, mode="wrap")[cut])),
        "cols": kl.columns(lp),
    }


def check_forms(kl, forms, bound_fn, T, dtype, results, library=None,
                timed=None, pairs=None) -> None:
    """Every form of one kernel level against its twin; device times of
    the timed shapes (ν = 2 and a shape of MG_TIMED, unless ``timed`` says;
    the fused forms at ν = 3 too at FUSED_NU3_TIMED, under "nu=3") into
    ``results[(op, dtype, dim)]["forms"]``. ``library``: (form, fn), one
    library call computing that form, timed beside it and held to its twin.
    ``pairs``: {form: fn}, the semi-fused stages a fused form replaces,
    timed beside it (``semi_pair_ms``)."""
    gs, nu = kl.gs, kl.nu
    auto = timed is None
    if auto:
        timed = nu == 2 and (T, gs) in MG_TIMED
    for form, (op, kfn, tfn) in forms.items():
        # the fused stages also at ν = 3, and the 2-D K6/K7 at every
        # MG_SHAPES
        fused3 = (auto and form.startswith("fused")
                  and ((nu == 3 and (T, gs) in FUSED_NU3_TIMED)
                       or (op in ("fused_pre", "fused_post")
                           and (T, gs) in MG_SHAPES)))
        got, want = kfn(), tfn()
        torch.cuda.synchronize()
        rec = results.setdefault(
            (op, dtype, kl.dim), {"max_abs_err": 0.0, "forms": {}})
        for g, w in zip(got, want):
            err = float((g - w).abs().max())
            scale = float(w.abs().max())
            assert err <= TOL[dtype] * scale, (
                form, dtype, T, gs, nu, err, scale)
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
        del got, want
        line = (f"  {form:17s} {str(dtype)[6:]:8s} nu={nu} T={T:3d} "
                f"gs={gs}: max|kernel-twin| {err:.3e} (max|twin| {scale:.3e})")
        if timed or fused3:
            ms, plain_ms = device_ms(kfn), device_ms(tfn)
            entry = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
                     **bound_fn(form, kl, T, dtype)}
            line += (f"; kernel {ms:.4f} ms, twin {plain_ms:.4f} ms, bound "
                     f"{entry['bound_ms']:.4f} ms ({entry['bound_by']})")
            if pairs is not None and form in pairs:
                entry["semi_pair_ms"] = device_ms(pairs[form])
                line += f", semi-fused pair {entry['semi_pair_ms']:.4f} ms"
            if library is not None and library[0] == form:
                lib = library[1]
                lerr = float((lib() - tfn()[0]).abs().max())
                entry["library_ms"] = device_ms(lib)
                line += (f", conv{kl.dim}d {entry['library_ms']:.4f} ms "
                         f"(max|conv-twin| {lerr:.3e})")
                assert lerr <= TOL[dtype] * scale, (lerr, scale)
            tag = " nu=3" if form.startswith("fused") and nu == 3 else ""
            rec["forms"][f"{form}{tag} {shape_key(T, gs)}"] = entry
        print(line, flush=True)


def semi_pairs(kl, x, var: bool) -> dict:
    """{fused form: fn}: the semi-fused stages each fused stage replaces,
    launched back to back: K3 (K10) from 0 then K8 (K13) for ``fused_pre``,
    K9 then K3 (K10) from x for ``fused_post``."""
    X, B, EC = x["x"], x["b"], x["ec"]
    a = (x["cols"], x["W"]) if var else (x["cols"],)

    def pre():
        x0 = kl.smooth(None, B, *a, zero_init=True)
        return x0, kl.residual_restrict(x0, B, *a)

    return {"fused_pre": pre,
            "fused_post": lambda: kl.smooth(kl.prolong_correct(X, EC), B, *a,
                                            post=True)}


def fused_path(counts, dtypes, dim) -> None:
    """A constant-stencil multigrid path on the fused stages: K1, K2, K4,
    K5, K6 and K7 of ``dim`` launched in each of ``dtypes``, as many K6 as
    K7; no K3, K8, K9 or weighted kernel, no V-cycle kernel of the other
    dimension and no flat-format kernel."""
    for dt in dtypes:
        assert counts[("B", dt)] > 0 and counts[("BT", dt)] > 0, (dt, counts)
        got = {op: counts[(op, dt, dim)]
               for op in ("fused_pre", "fused_post", "residual", "apply")}
        assert all(got.values()), (dt, got)
        assert got["fused_pre"] == got["fused_post"], (dt, got)
    for key, n in counts.items():
        ran = (len(key) == 2 and key[0] in ("B", "BT") and key[1] in dtypes) or (
            len(key) == 3 and key[1] in dtypes and key[2] == dim
            and key[0] in ("fused_pre", "fused_post", "residual", "apply"))
        assert ran or n == 0, (key, n, counts)


def seeded_inputs(taps, T, dtype, rng) -> dict:
    """U (T+1, *gs), V and W (T, *gs), and the h/2, h/16 columns of a random
    positive h, on the card."""
    mk = lambda a: torch.as_tensor(a, dtype=dtype, device="cuda")
    gs = taps.gs
    h = rng.uniform(0.5, 1.5, T) / T
    return {
        "U": mk(rng.standard_normal((T + 1,) + gs)),
        "V": mk(rng.standard_normal((T,) + gs)),
        "W": mk(rng.standard_normal((T,) + gs)),
        "hh": mk(0.5 * h),
        "hs": mk(h / 16.0),
    }


def kernel_forms(kron, taps, x) -> dict:
    """{form: (kernel_fn, twin_fn)}; each fn returns a tuple of tensors."""
    U, V, W, hh, hs = x["U"], x["V"], x["W"], x["hh"], x["hs"]
    return {
        "B": (lambda: (kron.apply_B(U, hh, taps),),
              lambda: (kron.apply_B_plain(U, hh, taps),)),
        "B_stab": (lambda: kron.apply_B_stab(U, hh, hs, taps),
                   lambda: kron.apply_B_stab_plain(U, hh, hs, taps)),
        "BT": (lambda: (kron.apply_BT(V, hh, taps),),
               lambda: (kron.apply_BT_plain(V, hh, taps),)),
        "BT_stab": (lambda: (kron.apply_BT_stab(V, W, hh, taps),),
                    lambda: (kron.apply_BT_stab_plain(V, W, hh, taps),)),
    }


def mg_forms(kl, x) -> dict:
    """{form: (kernel op, kernel_fn, twin_fn)} of one MSKernelLevel; each fn
    returns a tuple of tensors. K6/K7 (fused) where the level takes them
    (ν = ν_post ∈ {2, 3}, 2-D and 3-D)."""
    X, B, EC, c = x["x"], x["b"], x["ec"], x["cols"]
    forms = {
        "smooth": ("smooth", lambda: (kl.smooth(X, B, c),),
                   lambda: (kl.smooth_plain(X, B, c),)),
        "smooth_zero": ("smooth",
                        lambda: (kl.smooth(None, B, c, zero_init=True),),
                        lambda: (kl.smooth_plain(None, B, c, zero_init=True),)),
        "residual": ("residual", lambda: (kl.residual(X, B, c),),
                     lambda: (kl.residual_plain(X, B, c),)),
        "apply_A": ("apply", lambda: (kl.apply_A(X),),
                    lambda: (kl.apply_A_plain(X),)),
        "residual_restrict": (
            "residual_restrict", lambda: (kl.residual_restrict(X, B, c),),
            lambda: (kl.residual_restrict_plain(X, B, c),)),
        "prolong_correct": (
            "prolong_correct", lambda: (kl.prolong_correct(X, EC),),
            lambda: (kl.prolong_correct_plain(X, EC),)),
    }
    if kl.fused_ok:
        forms["fused_pre"] = ("fused_pre", lambda: kl.fused_pre(B, c),
                              lambda: kl.fused_pre_plain(B, c))
        forms["fused_post"] = ("fused_post",
                               lambda: (kl.fused_post(X, B, EC, c),),
                               lambda: (kl.fused_post_plain(X, B, EC, c),))
    return forms


def stencil_conv(kl, X):
    """A x as one library call: ``F.conv2d`` / ``F.conv3d`` with the A
    stencil as a 3^d kernel and zero padding 1 (TF32 is off)."""
    import torch.nn.functional as F

    w = X.new_zeros((3,) * kl.dim)
    for wt, ds in kl.groups_A:
        for d in ds:
            w[tuple(di + 1 for di in d)] = wt
    conv = F.conv3d if kl.dim == 3 else F.conv2d
    Xc, wc = X.unsqueeze(1), w[None, None]
    return lambda: conv(Xc, wc, padding=1).squeeze(1)


def mg_inputs(msmg, kl, T, dtype, rng) -> dict:
    """x, b (T, *gs), e_c on the coarse grid, and level-0 columns of random
    shifts, on the card."""
    from spacetime_tpu_torch.ops.multigrid import row_params

    mk = lambda a: torch.as_tensor(a, dtype=dtype, device=DEVICE)
    omega = np.abs(rng.standard_normal(T)) * 20
    lp = row_params(msmg, omega, dtype, DEVICE)[0]
    return {
        "x": mk(rng.standard_normal((T,) + kl.gs)),
        "b": mk(rng.standard_normal((T,) + kl.gs)),
        "ec": mk(rng.standard_normal((T,) + kl.coarse_gs)),
        "cols": kl.columns(lp),
    }


def chain_forms(kl, x, var: bool) -> dict:
    """{form: (kernel op, kernel_fn, twin_fn)}: the K3 / K10 sweep of a
    level whose ν is above the tiled kernels', from x and from 0 (the
    wrappers chain ``cheb_step`` launches)."""
    X, B = x["x"], x["b"]
    args = (x["cols"], x["W"]) if var else (x["cols"],)
    op = "cheb_step_var" if var else "cheb_step"
    return {
        "smooth": (op, lambda: (kl.smooth(X, B, *args),),
                   lambda: (kl.smooth_plain(X, B, *args),)),
        "smooth_zero": (
            op, lambda: (kl.smooth(None, B, *args, zero_init=True),),
            lambda: (kl.smooth_plain(None, B, *args, zero_init=True),)),
    }


def ell_bound(csr, T, dtype) -> dict:
    """The least time of A·X for T rows, from the matrix's nonzeros (what
    the data needs; the L-shape's stiffness CSR also stores the zeros of
    its diagonal edges, which are not counted): values, int32 column
    indices and row pointers of the CSR, X and Y once each; 2·nnz·T
    operations."""
    s = torch.finfo(dtype).bits // 8
    m, nnz = csr.shape[0], np.count_nonzero(csr.data)
    return bound(nnz * (s + 4) + (m + 1) * 4 + 2 * T * m * s,
                 2 * nnz * T, dtype)


def packed_bound(pk, T, n_in, n_out, dtype) -> dict:
    """The least time of K19/K20 on the layout they read: every packed
    entry (pads included) once, its column and one value per matrix, the
    slice offsets, X (T, n_in) once and each Y (T, n_out); 2 operations
    per entry, matrix and time row."""
    s = torch.finfo(dtype).bits // 8
    nmat, nent = pk.vals.shape
    return bound(nent * (4 + nmat * s) + pk.slice_ptr.size * 4
                 + T * (n_in + nmat * n_out) * s, 2 * nmat * nent * T, dtype)


def layout_line(label, pk) -> str:
    """The packed layout's entries, nonzeros, padding share and bytes."""
    nmat, nent = pk.vals.shape
    nz = int(np.any(pk.vals != 0, axis=0).sum())
    w = np.diff(pk.slice_ptr) // 32
    return (f"  layout {label}: {nent:,} entries for {nz:,} nonzeros "
            f"(padding {1 - nz / max(nent, 1):.3f}), slice widths "
            f"{int(w.min())}-{int(w.max())}, {nent * (4 + 4 * nmat):,} bytes "
            f"f32, {nent * (4 + 8 * nmat):,} f64 ({nmat} value arrays)")


def csr_on_card(csr, dtype):
    """The matrix as a torch CSR tensor on the card (cuSPARSE's input)."""
    return torch.sparse_csr_tensor(
        torch.as_tensor(csr.indptr, dtype=torch.int64),
        torch.as_tensor(csr.indices, dtype=torch.int64),
        torch.as_tensor(csr.data, dtype=dtype), size=csr.shape,
        device=DEVICE, check_invariants=False)


def seven_digits(rel) -> list:
    """The oracle table's rounding (scripts/record_baseline.py)."""
    return [float(f"{x:.6e}") for x in rel]


def k20_per_solve(solver, iterations: int) -> int:
    """K20 launches of one ``solve`` on the "ell" format with Chebyshev
    inner solves: one per SpMV of A or M. S = B (2) + K_Y (dA − 1) + Bᵀ (2)
    + stab (1) + trace row (dM + 1); K_X = Σ_j 4(d_j − 1) + 1 over the
    wavelet levels' shifted solves; the rhs = Bᵀ K_Y + M K_H; PCG applies
    S and K_X once before its loop and once per iteration."""
    dA, dM = solver._cheb_spec["A"][2], solver._cheb_spec["M"][2]
    per_S = dA + dM + 5
    per_KX = sum(4 * (d - 1) + 1 for *_, d in solver._cheb_spec["shift"])
    return (dA + 1) + dM + (iterations + 1) * (per_S + per_KX)



def phase_k20(build_solver, spmv):
    """Phase 22: the L-shape solver's setup, and K20 against its twin at
    the shapes of its path (``ELL_T``), the oracle row's n = 32 and a
    ragged matrix, in float32 and float64; median times at n = 256 (T of
    ``ELL_TIMED``) beside its bounds and ``torch.sparse.mm``. Returns the
    solver and the records ({dtype: {"max_abs_err", "forms"}})."""
    import scipy.sparse as sp

    from spacetime_tpu_torch.fem import P1System, l_shape_mesh
    from spacetime_tpu_torch.ops.blocked_ell import BlockedEll

    f32, f64 = torch.float32, torch.float64
    n, J = REF_LSHAPE["n"], REF_LSHAPE["levels"]
    phase(f"22 K20 (packed blocked-ELL SpMM) against its twins; the lshape2d "
          f"n={n}, J={J} solver's setup (ell, inner cheb, f32)")
    t0 = time.perf_counter()
    lsh = build_solver("lshape2d", n, J, dtype=f32, device=DEVICE,
                       spatial_format="ell", inner="cheb")
    spec = lsh._cheb_spec
    print(f"setup {time.perf_counter() - t0:.2f} s (m={lsh.m}, N={lsh.N}, "
          f"{(lsh.N + 1) * lsh.m:,} DoF; blocks "
          f"{lsh._ell['A'].ell.blocks.shape}"
          f"; Chebyshev degrees A {spec['A'][2]}, M {spec['M'][2]}, shifts "
          f"{[d for *_, d in spec['shift']]})", flush=True)
    small = P1System.from_mesh(l_shape_mesh(32))
    rnd = sp.random(300, 300, density=0.02, random_state=3, format="csr")
    ell_mats = [("A n=256", lsh._ell["A"], lsh.system.A, ELL_T),
                ("M n=256", lsh._ell["M"], lsh.system.M, (64,)),
                ("A n=32", spmv.EllOperator(BlockedEll.from_csr(small.A)),
                 small.A, (33,)),
                ("random m=300", spmv.EllOperator(BlockedEll.from_csr(rnd)),
                 rnd, (5,))]
    for label, op, csr, _ in ell_mats:
        print(layout_line(label, op.packed), flush=True)
    rng = np.random.default_rng(SEED + 6)
    results = {}
    for dtype in (f32, f64):
        rec = results.setdefault(dtype, {"max_abs_err": 0.0, "forms": {}})
        for label, op, csr, Ts in ell_mats:
            p = spmv.packed_params(op.packed, dtype, DEVICE)
            # the blocks only for the blocked twin: the kernel reads p
            blocks = torch.as_tensor(op.ell.blocks, dtype=dtype,
                                     device=DEVICE)
            colidx = torch.as_tensor(op.ell.colidx, device=DEVICE)
            m = op.m
            for T in Ts:
                X = torch.as_tensor(rng.standard_normal((T, m)), dtype=dtype,
                                    device=DEVICE)
                kfn = lambda: spmv.spmm(X, p, m)
                tfn = lambda: spmv.spmm_packed_plain(X, p, m)
                bfn = lambda: spmv.spmm_plain(X, blocks, colidx, m)
                got, want, wblk = kfn(), tfn(), bfn()
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                berr = float((got - wblk).abs().max())
                scale = float(wblk.abs().max())
                assert max(err, berr) <= TOL[dtype] * scale, (
                    label, dtype, T, err, berr, scale)
                rec["max_abs_err"] = max(rec["max_abs_err"], err, berr)
                line = (f"  {label:12s} {str(dtype)[6:]:8s} T={T:3d}: "
                        f"max|kernel-twin| packed {err:.3e}, blocked "
                        f"{berr:.3e} (max|twin| {scale:.3e})")
                if label == "A n=256" and T in ELL_TIMED:
                    A_sp, Xt = csr_on_card(csr, dtype), X.t().contiguous()
                    lib = lambda: torch.sparse.mm(A_sp, Xt)
                    lerr = float((lib().t() - wblk).abs().max())
                    assert lerr <= TOL[dtype] * scale, (lerr, scale)
                    entry = {"ms": device_ms(kfn), "plain_ms": device_ms(tfn),
                             "blocked_plain_ms": device_ms(bfn),
                             "library_ms": device_ms(lib),
                             **ell_bound(csr, T, dtype)}
                    lay = packed_bound(op.packed, T, m, m, dtype)
                    entry["layout_bound_ms"] = lay["bound_ms"]
                    rec["forms"][f"A n=256 T={T}"] = entry
                    line += (f"; kernel {entry['ms']:.4f} ms, packed twin "
                             f"{entry['plain_ms']:.4f} ms, blocked twin "
                             f"{entry['blocked_plain_ms']:.4f} ms, "
                             f"torch.sparse.mm (cuSPARSE CSR) "
                             f"{entry['library_ms']:.4f} ms (max|lib-twin| "
                             f"{lerr:.3e}); bound {entry['bound_ms']:.4f} ms "
                             f"({entry['bound_by']}, nnz), layout's bound "
                             f"{lay['bound_ms']:.4f} ms ({lay['bound_by']})")
                print(line, flush=True)
                del X, got, want, wblk
            del p, blocks
        torch.cuda.empty_cache()
    return lsh, results


def phase_chains(build_solver, mg_results):
    """Phase 23: the K3 / K10 sweeps above the tiled ν (chained one-step
    launches) against their twins at ``CHAIN_SHAPES``, constant and
    weighted, float32 and float64; median times at the timed shapes."""
    from spacetime_tpu_torch.fem import P1System, unit_cube_mesh
    from spacetime_tpu_torch.models import get_problem
    from spacetime_tpu_torch.ops.mg_kernels import (MSKernelLevel,
                                                    VarMSKernelLevel)
    from spacetime_tpu_torch.ops.multigrid import GalerkinMultiShiftMultigrid

    phase("23 the chained sweeps (K3, K10 above the tiled nu) against their "
          "twins")
    rng = np.random.default_rng(SEED + 7)
    const = {d: build_solver(f"smooth{d}d", 8, 1, dtype=torch.float32,
                             device=DEVICE, inner="mg").msmg for d in (2, 3)}
    system3 = P1System.from_problem(get_problem("varcoef3d"),
                                    unit_cube_mesh(32))
    varh = {2: var_hierarchy(128),
            3: GalerkinMultiShiftMultigrid.build(
                3, 32, system3.A, system3.M, n_coarse=16)[0]}
    for dtype in (torch.float32, torch.float64):
        for dim, shapes in CHAIN_SHAPES.items():
            for T, gs, nu, timed in shapes:
                lev = const[dim].levels[0]
                kl = MSKernelLevel(lev.A_st, lev.M_st, nu, gs=gs)
                x = mg_inputs(const[dim], kl, T, dtype, rng)
                check_forms(kl, chain_forms(kl, x, False), mg_bound, T, dtype,
                            mg_results, timed=timed)
                vk = VarMSKernelLevel(varh[dim].levels[0], nu, gs=gs)
                x = var_inputs(varh[dim], vk, T, dtype, rng)
                check_forms(vk, chain_forms(vk, x, True), var_bound, T, dtype,
                            mg_results, timed=timed)
                del x
                torch.cuda.empty_cache()


def phase_nu_paths(build_solver, paths):
    """Phase 24: ν above the tiled kernels on the main path: smooth3d
    17³×16 f64 with mg_nu=4 to the JAX package's count and L2, then f32
    ``solve_refined`` (f32 inner, f64 legs) with ν = 4 in 3-D and 9 in 2-D,
    constant and weighted: each launches the chained sweep in both dtypes
    and never the tiled one."""
    f32, f64 = torch.float32, torch.float64
    n3, J3 = REF_3D_NU4["n"], REF_3D_NU4["levels"]
    phase(f"24 sweeps above the tiled nu on the main path: smooth3d "
          f"{n3 + 1}^3 x {2 ** J3} f64 mg_nu=4; f32 solve_refined with nu 4 "
          "(3-D) and 9 (2-D), constant and weighted")
    s = build_solver("smooth3d", n3, J3, dtype=f64, device=DEVICE, inner="mg",
                     mg_nu=4)
    s.assemble_rhs_host()
    paths.start()
    r = s.solve(tol=1e-8)
    rel = r.residuals[-1] / r.residuals[0]
    print(f"smooth3d mg_nu=4 f64: iterations {r.iterations} (JAX CPU "
          f"{REF_3D_NU4['iterations']}), converged {r.converged}, rel "
          f"{rel:.3e}, L2 {r.l2_error:.10e} (JAX CPU {REF_3D_NU4['l2']:.10e}),"
          f" solve {r.solve_seconds:.4f} s")
    assert r.converged and rel <= 1e-8, rel
    assert r.iterations == REF_3D_NU4["iterations"], r.iterations
    assert abs(r.l2_error / REF_3D_NU4["l2"] - 1.0) <= 1e-6, r.l2_error
    counts = paths.stop("smooth3d mg_nu=4 f64", per=r.iterations)
    assert counts[("cheb_step", f64, 3)] > 0, counts
    assert counts[("smooth", f64, 3)] == 0, counts
    del s
    for name, n, J, nu, kw in (("smooth3d", 16, 4, 4, {}),
                               ("varcoef3d", 16, 4, 4, {}),
                               ("smooth2d", 32, 4, 9, {"mg_coarse": 8}),
                               ("varcoef2d", 32, 4, 9, {"mg_coarse": 8})):
        s = build_solver(name, n, J, dtype=f32, device=DEVICE, inner="mg",
                         mg_nu=nu, **kw)
        for dt in (f32, f64):
            s.assemble_rhs_host(dt)
        paths.start()
        r = s.solve_refined(tol=1e-8, compute_error=False)
        rel = r.residuals[-1] / r.residuals[0]
        print(f"{name} {n + 1}^{s.problem.dim} x {2 ** J} mg_nu={nu} f32 "
              f"solve_refined: inner iterations {r.iterations} in "
              f"{len(r.residuals) - 1} rounds, converged {r.converged}, rel "
              f"{rel:.3e}, solve {r.solve_seconds:.4f} s")
        assert r.converged and rel <= 1e-8, rel
        counts = paths.stop(f"{name} mg_nu={nu}")
        var = name.startswith("varcoef")
        dim = s.problem.dim
        for dt in (f32, f64):
            assert counts[("cheb_step_var" if var else "cheb_step", dt,
                           dim)] > 0, (dt, counts)
            assert counts[("smooth_var" if var else "smooth", dt, dim)] == 0
        del s
    torch.cuda.empty_cache()


def phase_oracle_rows(build_solver, paths):
    """Phase 25: the oracle's rows of ``ORACLE_ROWS`` in float64 on the
    card: its iteration counts, its 7-digit histories and its L2."""
    f64 = torch.float64
    phase("25 the oracle's rows in float64 on the card (dense inner solves; "
          "the singular rows on graded time grids)")
    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, "baseline_oracle.json")) as f:
        oracle = {row["config"]: row for row in json.load(f)}
    for label, problem, n, J, extra, tol, fmt in ORACLE_ROWS:
        row = oracle[label]
        t0 = time.perf_counter()
        s = build_solver(problem, n, J, dtype=f64, device=DEVICE,
                         spatial_format=fmt, extra_time_levels=extra)
        s.assemble_rhs_host()
        setup_s = time.perf_counter() - t0
        assert s.inner == "dense", s.inner
        paths.start()
        r = s.solve(tol=tol)
        counts = paths.stop(f"oracle {label}")
        rel = r.residuals / r.residuals[0]
        print(f"{label} ({s.spatial_format}, m={s.m}): iterations "
              f"{r.iterations} (oracle {row['iters']}), L2 {r.l2_error:.10e} "
              f"(oracle {row['l2_error']:.10e}); setup and loads {setup_s:.2f}"
              f" s, solve {r.solve_seconds:.4f} s")
        assert r.converged and r.iterations == row["iters"], r.iterations
        assert seven_digits(rel) == row["rel_residuals"], (
            seven_digits(rel), row["rel_residuals"])
        assert abs(r.l2_error / row["l2_error"] - 1.0) <= 1e-9, r.l2_error
        if fmt == "ell":
            assert counts[("spmm", f64)] > 0, counts
        elif s.spatial_format == "stencil":
            assert counts[("B", f64)] > 0 and counts[("BT", f64)] > 0, counts
        else:
            assert counts[("apply_var", f64, s.problem.dim)] > 0, counts
        del s
    torch.cuda.empty_cache()


def phase_lshape(lsh, paths):
    """Phase 26: the L-shape at n = 256 (``lsh``, ell + cheb, f32):
    ``solve(tol=1e-6)`` twice, iterations within ±1 of the JAX package's,
    exactly ``k20_per_solve`` K20 launches and no other kernel, L2 within
    1% of the JAX package's."""
    f32 = torch.float32
    phase(f"26 lshape2d n={REF_LSHAPE['n']}, J={REF_LSHAPE['levels']} "
          f"({(lsh.N + 1) * lsh.m:,} DoF), ell + cheb, f32: solve(tol=1e-6) "
          "twice")
    t0 = time.perf_counter()
    lsh.assemble_rhs_host()
    print(f"loads {time.perf_counter() - t0:.2f} s", flush=True)
    paths.start()
    runs = []
    for call in (1, 2):
        r = lsh.solve(tol=1e-6, compute_error=False)
        rel = r.residuals[-1] / r.residuals[0]
        print(f"solve call {call}: iterations {r.iterations} (JAX CPU "
              f"{REF_LSHAPE['iterations']}), converged {r.converged}, "
              f"rel {rel:.3e}, solve {r.solve_seconds:.4f} s", flush=True)
        assert r.converged and rel <= 1e-6, rel
        assert abs(r.iterations - REF_LSHAPE["iterations"]) <= 1, r.iterations
        runs.append(r)
    counts = paths.stop("lshape n=256 ell cheb f32",
                        per=sum(x.iterations for x in runs))
    want = sum(k20_per_solve(lsh, x.iterations) for x in runs)
    print(f"K20 launches {counts[('spmm', f32)]} (expected {want}: "
          f"{k20_per_solve(lsh, 1) - k20_per_solve(lsh, 0)} per PCG "
          "iteration)")
    assert counts[("spmm", f32)] == want, (counts[("spmm", f32)], want)
    assert all(c == 0 for key, c in counts.items() if key != ("spmm", f32)), (
        counts)
    t0 = time.perf_counter()
    l2 = lsh._l2_error(runs[0].U)
    print(f"L2(IxOmega) {l2:.6e} (JAX CPU {REF_LSHAPE['l2']:.6e}), host "
          f"error loop {time.perf_counter() - t0:.2f}"
          f" s; steady solve {runs[1].solve_seconds:.4f} s (with the blocked "
          f"K20: {REF_LSHAPE['blocked_steady_s']} s)")
    assert abs(l2 / REF_LSHAPE["l2"] - 1.0) <= REF_LSHAPE["l2_band"], l2




def semi_path(counts, dtype, dim, var: bool) -> None:
    """A multigrid path on the semi-fused stages in ``dtype``: K3 (K10) =
    2·K8 (K13) = 2·K9 launched, and no fused stage in any dtype."""
    sm, rr = ("smooth_var", "residual_restrict_var") if var else (
        "smooth", "residual_restrict")
    got = {op: counts[(op, dtype, dim)] for op in (sm, rr, "prolong_correct")}
    assert all(got.values()), got
    assert got[sm] == 2 * got[rr] == 2 * got["prolong_correct"], got
    assert all(n == 0 for key, n in counts.items()
               if key[0].startswith("fused")), counts


def phase_v21_3d(build_solver, paths):
    """Phase 30: 3-D V(2,1) cycles (``mg_nu_post=1``), where the fused
    stages do not apply: smooth3d and varcoef3d 33³×16, f32 to tol 1e-6 and
    f64 to 1e-8, held to the JAX package's CPU iterations (± 1 in f32,
    exactly in f64) and L2; every level on the semi-fused stages."""
    n, J = REF_V21_3D["n"], REF_V21_3D["levels"]
    phase(f"30 3-D V(2,1): smooth3d and varcoef3d {n + 1}^3 x {2 ** J} with "
          "mg_nu_post=1, f32 and f64")
    for name in ("smooth3d", "varcoef3d"):
        for dtype, tol in ((torch.float32, 1e-6), (torch.float64, 1e-8)):
            ref = REF_V21_3D[(name, str(dtype)[6:])]
            s = build_solver(name, n, J, dtype=dtype, device=DEVICE,
                             inner="mg", mg_nu_post=1)
            s.assemble_rhs_host()
            assert not any(k.fused_ok for k in s._kl_ky + s._kl_kx)
            paths.start()
            r = s.solve(tol=tol)
            counts = paths.stop(f"{name} V(2,1) {str(dtype)[6:]}",
                                per=r.iterations)
            rel = r.residuals[-1] / r.residuals[0]
            print(f"{name} V(2,1) {str(dtype)[6:]}: iterations "
                  f"{r.iterations} (JAX CPU {ref['iterations']}), converged "
                  f"{r.converged}, rel {rel:.3e}, L2 {r.l2_error:.10e} (JAX "
                  f"CPU {ref['l2']:.10e}), solve {r.solve_seconds:.4f} s")
            assert r.converged and rel <= tol, rel
            f64 = dtype == torch.float64
            assert abs(r.iterations - ref["iterations"]) <= (0 if f64 else 1)
            assert abs(r.l2_error / ref["l2"] - 1.0) <= (1e-6 if f64
                                                         else 0.01), r.l2_error
            semi_path(counts, dtype, 3, name == "varcoef3d")
            del s
    torch.cuda.empty_cache()


def run_singular(s, paths, label, ref, dim):
    """Two ``solve(tol=1e-6)`` calls of a singular solver on its graded
    grid: the iterations within ±1 of ``ref``'s (and of its TPU count),
    the fused stages on every
    level, L2 within ``ref['l2_band']`` of ``ref['l2']``; prints the steady
    time and the launches per PCG iteration."""
    f32 = torch.float32
    t0 = time.perf_counter()
    s.assemble_rhs_host()
    print(f"setup {s.setup_seconds:.2f} s ({(s.N + 1) * s.m:,} DoF, "
          f"{s.N} graded steps, smallest {s.grid.h.min():.3e}, levels "
          f"{[lev.n for lev in s.msmg.levels]}, coarse {s.msmg.n_coarse}); "
          f"loads {time.perf_counter() - t0:.2f} s", flush=True)
    assert not s.wt.is_uniform and s.inner == "mg"
    torch.cuda.reset_peak_memory_stats()
    paths.start()
    runs = []
    for call in (1, 2):
        r = s.solve(tol=1e-6, compute_error=False)
        rel = r.residuals[-1] / r.residuals[0]
        print(f"solve call {call}: iterations {r.iterations} "
              f"({ref['source']} {ref['iterations']}), converged "
              f"{r.converged}, rel {rel:.3e}, solve {r.solve_seconds:.4f} s",
              flush=True)
        assert r.converged and rel <= 1e-6, rel
        for want in (ref["iterations"], ref.get("tpu_iterations",
                                                ref["iterations"])):
            assert abs(r.iterations - want) <= 1, (r.iterations, want)
        runs.append(r)
    counts = paths.stop(label, per=sum(x.iterations for x in runs))
    fused_path(counts, (f32,), dim)
    print(f"steady solve: {runs[1].solve_seconds:.4f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    t0 = time.perf_counter()
    l2 = s._l2_error(runs[0].U)
    print(f"L2(IxOmega) {l2:.6e} ({ref['source']} {ref['l2']:.6e}, band "
          f"{ref['l2_band']:.0%}), host error loop "
          f"{time.perf_counter() - t0:.2f} s")
    assert abs(l2 / ref["l2"] - 1.0) <= ref["l2_band"], l2


def phase_singular(build_solver, paths):
    """Phases 31–32: the singular problems on time grids graded toward
    t = 0 at scale, f32, inner mg: singular3d 65³ J5+4 against the JAX
    package's CPU run, singular2d 513² J7+6 against the TPU's count and
    L2."""
    for num, ref in ((31, REF_SINGULAR3D), (32, REF_SINGULAR2D)):
        dim = 3 if ref["problem"] == "singular3d" else 2
        t0 = time.perf_counter()
        phase(f"{num} {ref['problem']} {ref['n'] + 1}^{dim}, graded J"
              f"{ref['levels']}+{ref['extra']}, f32, inner mg")
        s = build_solver(ref["problem"], ref["n"], ref["levels"],
                         extra_time_levels=ref["extra"], dtype=torch.float32,
                         device=DEVICE, inner="mg")
        print(f"built in {time.perf_counter() - t0:.2f} s")
        run_singular(s, paths, f"{ref['problem']} graded f32", ref, dim)
        del s
        torch.cuda.empty_cache()


def dia_bound(form, kl, T, dtype) -> dict:
    """Bytes (fields, the union-offset values and diagonals each once) and
    operations of one K16–K18 form at T rows: an application of Op is
    4·ndu + 2 operations per point, a recurrence step ~8 more."""
    sz = torch.finfo(dtype).bits // 8
    m, nd, nu = kl.m, len(kl.offsets), kl.nu
    op = 4 * nd + 2
    if form.startswith("apply"):
        return bound(sz * (2 * T * m + nd * m), 2 * nd * T * m, dtype)
    if form.startswith("residual"):
        return bound(sz * (3 * T * m + 2 * nd * m), (op + 1) * T * m, dtype)
    zero = "from 0" in form
    nops = nu - 1 if zero else nu
    nbytes = sz * ((2 if zero else 3) * T * m + 2 * nd * m + 2 * m)
    return bound(nbytes, T * m * (nops * op + 8 * nu + 3), dtype)


def pair_bound(csrs, T, dtype) -> dict:
    """The least time of (A·X, M·X) from the two matrices' nonzeros on their
    one union pattern: its column indices and row pointers once, each
    matrix's nonzero values, X once and both outputs; 2·nnz operations per
    row of X."""
    sz = torch.finfo(dtype).bits // 8
    m = csrs[0].shape[0]
    nnz = sum(np.count_nonzero(c.data) for c in csrs)
    union = abs(csrs[0]) + abs(csrs[1])
    union.eliminate_zeros()
    return bound(union.nnz * 4 + nnz * sz + (m + 1) * 4 + 3 * T * m * sz,
                 2 * nnz * T, dtype)


def flat_per_solve(solver, iterations: int) -> dict:
    """K16–K20 launches of one ``solve`` with a nested or SA hierarchy
    (``ops.multigrid.NestedMultiShiftMG`` / ``SAMultiShiftMG``), every level
    on its kernels: per V-cycle a DIA level takes ν + ν_post K16 launches
    (one per step of its two sweeps), one K17 and, with factored transfers
    (the SA DIA levels), two K18; an ELL level (ν−1) + 1 + ν_post
    K19 pair products and two K20 transfers. K_Y is ``mg_cycles`` V-cycles
    and ``mg_cycles``−1 residuals (K17) at the fine level; K_X two such
    solves of ``mg_cycles_kx`` cycles around one K18. The rhs takes one
    K_Y; PCG one S (one K_Y) and one K_X before its loop and per
    iteration."""
    ms = solver.msmg
    per_v = dict.fromkeys(("smooth", "residual", "apply", "spmm_pair",
                           "spmm"), 0)
    nu_post = ms.nu_post or solver.mg_nu
    for kl, lev in zip(solver._kl_ky, ms.levels):
        if kl.kind == "dia":
            per_v["smooth"] += kl.nu + kl.nu_post
            per_v["residual"] += 1
            if getattr(lev, "agg", None) is not None:
                per_v["apply"] += 2
        else:
            per_v["spmm_pair"] += (solver.mg_nu - 1) + 1 + nu_post
            per_v["spmm"] += 2
    n_ky, n_kx = 1 + (iterations + 1), iterations + 1
    cycles = solver.mg_cycles * n_ky + 2 * solver.mg_cycles_kx * n_kx
    out = {k: v * cycles for k, v in per_v.items()}
    out["residual"] += ((solver.mg_cycles - 1) * n_ky
                        + 2 * (solver.mg_cycles_kx - 1) * n_kx)
    out["apply"] += n_kx
    return out


def check_dia_forms(kl, lev, T, dtype, rng, results, label, timed, A_csr):
    """K16 (from 0 and from x), K17 and K18 of ``kl`` against their twins
    at T rows; times and bounds where ``timed``, K18 beside
    ``torch.sparse.mm`` (A in CSR)."""
    mk = lambda a: torch.as_tensor(a, dtype=dtype, device=DEVICE)
    omega = np.abs(rng.standard_normal(T)) * 100.0
    omega[:: 2] = 0.0
    lam = 1.1 * np.array([((lev.rsA + w * lev.rsM) / (lev.dA + w * lev.dM))
                          .max() for w in omega])
    cols = {"omega": mk(omega), "invT": mk(1.0 / (0.625 * lam)),
            "invDel": mk(1.0 / (0.375 * lam))}
    x, b = (mk(rng.standard_normal((T, lev.m))) for _ in range(2))
    vals = kl.values(lev, dtype, DEVICE)
    forms = {
        ("smooth", "smooth from 0"): (
            lambda: kl.smooth(None, b, cols, vals, zero_init=True),
            lambda: kl.smooth_plain(None, b, cols, vals, zero_init=True)),
        ("smooth", "smooth from x"): (
            lambda: kl.smooth(x, b, cols, vals),
            lambda: kl.smooth_plain(x, b, cols, vals)),
        ("residual", "residual"): (
            lambda: kl.residual(x, b, cols, vals),
            lambda: kl.residual_plain(x, b, cols, vals)),
        ("apply", "apply"): (lambda: kl.apply_A(x, vals),
                             lambda: kl.apply_A_plain(x, vals)),
    }
    for (op, form), (kfn, tfn) in forms.items():
        got, want = kfn(), tfn()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        del got, want
        assert err <= TOL[dtype] * scale, (label, form, dtype, T, err, scale)
        rec = results.setdefault((op, dtype), {"max_abs_err": 0.0,
                                               "forms": {}})
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        line = (f"  {form:15s} {str(dtype)[6:]:8s} {label} T={T}: "
                f"max|kernel-twin| {err:.3e} (max|twin| {scale:.3e})")
        if timed:
            entry = {"ms": device_ms(kfn), "plain_ms": device_ms(tfn),
                     "max_abs_err": err, "library_ms": None,
                     **dia_bound(form, kl, T, dtype)}
            if op == "apply":
                A_sp, xt = csr_on_card(A_csr, dtype), x.t().contiguous()
                lib = lambda: torch.sparse.mm(A_sp, xt)
                lerr = float((lib().t() - tfn()).abs().max())
                assert lerr <= TOL[dtype] * scale, (lerr, scale)
                entry["library_ms"] = device_ms(lib)
                line += f"; torch.sparse.mm {entry['library_ms']:.4f} ms"
            rec["forms"][f"{form} T={T} m={lev.m}"] = entry
            line += (f"; kernel {entry['ms']:.4f} ms, twin "
                     f"{entry['plain_ms']:.4f} ms, bound "
                     f"{entry['bound_ms']:.4f} ms ({entry['bound_by']})")
        print(line, flush=True)
    del x, b, vals
    torch.cuda.empty_cache()


def phase_flat_kernels(build_solver, lsh, spmv):
    """Phase 27: the nested 25.2 MDoF solver's and the AMG n = 256
    solver's setup (the latter on phase 26's system and loads); K16–K18
    against their twins on the nested fine level (T = 129, 128), its
    second level (T = 129) and the AMG DIA fine level (T = 65, 64), K19
    and the K20 transfers on the AMG ELL level (T = 65, 64), float32 and
    float64, with times, bounds and
    ``torch.sparse.mm`` beside K18 and K19. Returns the two solvers and
    the records ({(op, dtype): {"max_abs_err", "forms"}})."""
    from spacetime_tpu_torch.solver import HeatSolver

    f32, f64 = torch.float32, torch.float64
    n, r, J = REF_NESTED["n"], REF_NESTED["refine"], REF_NESTED["levels"]
    phase(f"27 K16-K19 against their twins; the nested lshape2d {n} cells "
          f"refined {r}x, J={J} solver and the AMG n={REF_AMG['n']} solver")
    t0 = time.perf_counter()
    nst = build_solver("lshape2d", n, J, dtype=f32, device=DEVICE, refine=r,
                       inner="mg")
    assert nst.mg_flavor == "NestedMultiShiftMultigrid", nst.mg_flavor
    print(f"nested setup {time.perf_counter() - t0:.2f} s (m={nst.m}, "
          f"N={nst.N}, {(nst.N + 1) * nst.m:,} DoF; levels "
          f"{[lev.m for lev in nst.msmg.levels]}, offsets "
          f"{[len(k.offsets) for k in nst._kl_ky]}, bandwidths "
          f"{[max(map(abs, k.offsets)) for k in nst._kl_ky]})", flush=True)
    t0 = time.perf_counter()
    amg = HeatSolver(lsh.problem, lsh.system, lsh.grid, dtype=f32,
                     device=DEVICE, inner="amg")
    amg._rhs_host = lsh._rhs_host_arrays()
    print(f"AMG setup {time.perf_counter() - t0:.2f} s (levels "
          f"{[(lev.m, lev.fmt) for lev in amg.msmg.levels]})", flush=True)
    rng = np.random.default_rng(SEED + 8)
    results = {}
    levs = nst.msmg.levels
    for dtype in (f32, f64):
        for li, Ts in ((0, DIA_T), (1, DIA_T[:1])):
            lev = levs[li]
            A = _dia_to_csr(lev.offA, lev.Av)
            for T in Ts:
                check_dia_forms(nst._kl_ky[li], lev, T, dtype, rng, results,
                                f"nested L{li} m={lev.m}",
                                li == 0 and T == DIA_T[0], A)
        lev = amg.msmg.levels[0]
        assert lev.fmt == "dia" and amg._kl_ky[0].kind == "dia", lev.fmt
        for T in PAIR_T:
            check_dia_forms(amg._kl_ky[0], lev, T, dtype, rng, results,
                            f"AMG L0 m={lev.m}", False, None)
        lev = [lv for lv in amg.msmg.levels if lv.fmt == "ell"][0]
        ek = [k for k in amg._kl_ky if k.kind == "ell"][0]
        if dtype == f32:
            for name, pk in ek.packed.items():
                print(layout_line(f"AMG L1 {name}", pk), flush=True)
        v = ek.values(lev, dtype, DEVICE)
        # the blocks only for the blocked twins: the kernels read v
        blk = {k: (torch.as_tensor(c, device=DEVICE),
                   [torch.as_tensor(b, dtype=dtype, device=DEVICE)
                    for b in bs]) for k, (c, bs) in spmv.level_blocks(lev).items()}
        csrs = [_ell_to_csr(lev.eidx, w, lev.m) for w in (lev.ewA, lev.ewM)]
        (cop, (bA, bM)), (cP, (bP,)), (cR, (bR,)) = (
            blk["op"], blk["P"], blk["R"])
        for T in PAIR_T:
            X = torch.as_tensor(rng.standard_normal((T, ek.m)), dtype=dtype,
                                device=DEVICE)
            E = torch.as_tensor(rng.standard_normal((T, ek.mc)), dtype=dtype,
                                device=DEVICE)
            forms = {  # the kernel, its packed twin, its blocked twin
                ("spmm_pair", "pair"): (
                    lambda: ek.op_pair(X, v),
                    lambda: spmv.spmm_pair_packed_plain(X, v["op"], ek.m),
                    lambda: spmv.spmm_pair_plain(X, bA, bM, cop, ek.m)),
                ("spmm", "interp"): (
                    lambda: (ek.interp(E, v),),
                    lambda: (spmv.spmm_packed_plain(E, v["P"], ek.m),),
                    lambda: (spmv.spmm_plain(E, bP, cP, ek.m),)),
                ("spmm", "restrict"): (
                    lambda: (ek.restrict(X, v),),
                    lambda: (spmv.spmm_packed_plain(X, v["R"], ek.mc),),
                    lambda: (spmv.spmm_plain(X, bR, cR, ek.mc),)),
            }
            for (op, form), (kfn, tfn, bfn) in forms.items():
                got, want, wblk = kfn(), tfn(), bfn()
                torch.cuda.synchronize()
                err = max(float((g - w).abs().max()) for g, w in
                          zip(got, want))
                berr = max(float((g - w).abs().max()) for g, w in
                           zip(got, wblk))
                scale = max(float(w.abs().max()) for w in wblk)
                assert max(err, berr) <= TOL[dtype] * scale, (
                    form, dtype, T, err, berr)
                line = (f"  {form:9s} {str(dtype)[6:]:8s} AMG L1 m={ek.m} "
                        f"T={T}: max|kernel-twin| packed {err:.3e}, blocked "
                        f"{berr:.3e} (max|twin| {scale:.3e})")
                if op == "spmm_pair":
                    rec = results.setdefault((op, dtype), {
                        "max_abs_err": 0.0, "forms": {}})
                    rec["max_abs_err"] = max(rec["max_abs_err"], err, berr)
                    sps = [csr_on_card(c, dtype) for c in csrs]
                    Xt = X.t().contiguous()
                    lib = lambda: tuple(torch.sparse.mm(a, Xt) for a in sps)
                    lerr = max(float((g.t() - w).abs().max())
                               for g, w in zip(lib(), wblk))
                    assert lerr <= TOL[dtype] * scale, (lerr, scale)
                    entry = {"ms": device_ms(kfn), "plain_ms": device_ms(tfn),
                             "blocked_plain_ms": device_ms(bfn),
                             "library_ms": device_ms(lib),
                             "max_abs_err": max(err, berr),
                             **pair_bound(csrs, T, dtype)}
                    lay = packed_bound(ek.packed["op"], T, ek.m, ek.m, dtype)
                    entry["layout_bound_ms"] = lay["bound_ms"]
                    rec["forms"][f"pair T={T} m={ek.m}"] = entry
                    line += (f"; kernel {entry['ms']:.4f} ms, packed twin "
                             f"{entry['plain_ms']:.4f} ms, blocked twin "
                             f"{entry['blocked_plain_ms']:.4f} ms, 2x "
                             f"torch.sparse.mm {entry['library_ms']:.4f} ms "
                             f"(max|lib-twin| {lerr:.3e}); bound "
                             f"{entry['bound_ms']:.4f} ms ({entry['bound_by']}"
                             f", nnz), layout's bound {lay['bound_ms']:.4f} ms"
                             f" ({lay['bound_by']})")
                else:
                    pk, n_in, n_out = (
                        (ek.packed["P"], ek.mc, ek.m) if form == "interp"
                        else (ek.packed["R"], ek.m, ek.mc))
                    lay = packed_bound(pk, T, n_in, n_out, dtype)
                    line += (f"; kernel {device_ms(kfn):.4f} ms, packed twin "
                             f"{device_ms(tfn):.4f} ms, layout's bound "
                             f"{lay['bound_ms']:.4f} ms ({lay['bound_by']})")
                print(line, flush=True)
                del got, want, wblk
            del X, E
        del v, blk
        torch.cuda.empty_cache()
    return nst, amg, results


def _dia_to_csr(offsets, vals):
    """A DIA level's (m, ndiag) values as CSR (for ``torch.sparse.mm``)."""
    import scipy.sparse as sp

    m = vals.shape[0]
    rows = np.repeat(np.arange(m), len(offsets))
    cols = rows + np.tile(np.asarray(offsets), m)
    keep = (cols >= 0) & (cols < m) & (vals.ravel() != 0)
    return sp.csr_matrix((vals.ravel()[keep], (rows[keep], cols[keep])),
                         shape=(m, m))


def _ell_to_csr(eidx, w, m):
    """An ELL level's gather rows as CSR (pad slots carry weight 0)."""
    import scipy.sparse as sp

    rows = np.repeat(np.arange(eidx.shape[0]), eidx.shape[1])
    keep = w.ravel() != 0
    return sp.csr_matrix((w.ravel()[keep], (rows[keep],
                                            eidx.ravel()[keep])),
                         shape=(eidx.shape[0], m))


def run_flat_solve(solver, paths, label, ref, calls=2):
    """``solve(tol=1e-6)`` ``calls`` times on ``solver`` (loads assembled),
    iterations within ±1 of ``ref``, exactly ``flat_per_solve`` launches of
    K16–K20 per solve and no other kernel; L2 of the first within the
    band of ``ref``. Returns the runs and the path's counts."""
    f32 = torch.float32
    paths.start()
    runs = []
    for call in range(1, calls + 1):
        r = solver.solve(tol=1e-6, compute_error=False)
        rel = r.residuals[-1] / r.residuals[0]
        print(f"solve call {call}: iterations {r.iterations} (reference "
              f"{ref['iterations']}), converged {r.converged}, rel "
              f"{rel:.3e}, solve {r.solve_seconds:.4f} s", flush=True)
        assert r.converged and rel <= 1e-6, rel
        assert abs(r.iterations - ref["iterations"]) <= 1, r.iterations
        runs.append(r)
    counts = paths.stop(label, per=sum(x.iterations for x in runs))
    want = {}
    for x in runs:
        for op, c in flat_per_solve(solver, x.iterations).items():
            want[op] = want.get(op, 0) + c
    per_it = {op: flat_per_solve(solver, 1)[op] - flat_per_solve(solver, 0)[op]
              for op in want}
    print(f"expected launches {want}; per solve "
          f"{[flat_per_solve(solver, x.iterations) for x in runs]}; per PCG "
          f"iteration {per_it}")
    for op, c in want.items():
        assert counts[(op, f32)] == c, (op, counts[(op, f32)], c)
    flat_keys = {(op, f32) for op in want}
    assert all(c == 0 for key, c in counts.items() if key not in flat_keys), (
        counts)
    t0 = time.perf_counter()
    l2 = solver._l2_error(runs[0].U)
    blocked = (f" (with the blocked K19/K20: {ref['blocked_steady_s']} s)"
               if "blocked_steady_s" in ref else "")
    print(f"L2(IxOmega) {l2:.6e} (reference {ref['l2']:.6e}), host error "
          f"loop {time.perf_counter() - t0:.2f} s; steady solve "
          f"{runs[-1].solve_seconds:.4f} s{blocked}")
    assert abs(l2 / ref["l2"] - 1.0) <= ref["l2_band"], l2
    return runs, counts


def phase_flat_solves(build_solver, nst, amg, paths):
    """Phases 28 and 29: the nested 25.2 MDoF solve and the AMG n = 256
    solve, f32, twice each; then the small float64 solves of ``FLAT_F64``
    (the JAX package's iterations and L2), which run every kernel's f64
    form, and an f32 ``solve_refined`` with ν = 4 on the 3-D nested mesh,
    which runs K16 at ν = 4 in both dtypes."""
    f64 = torch.float64
    phase(f"28 nested lshape2d, {(nst.N + 1) * nst.m:,} DoF, f32: "
          "solve(tol=1e-6) twice")
    t0 = time.perf_counter()
    nst.assemble_rhs_host()
    print(f"loads {time.perf_counter() - t0:.2f} s", flush=True)
    run_flat_solve(nst, paths, "nested lshape2d 25.2 MDoF f32", REF_NESTED)
    phase(f"29 AMG lshape2d n={REF_AMG['n']}, {(amg.N + 1) * amg.m:,} DoF, "
          "f32: solve(tol=1e-6) twice; small float64 nested and AMG solves")
    run_flat_solve(amg, paths, "AMG lshape2d n=256 f32", REF_AMG)
    for label, problem, n, r, J, kw, its, l2 in FLAT_F64:
        s = build_solver(problem, n, J, dtype=f64, device=DEVICE, refine=r,
                         **kw)
        s.assemble_rhs_host()
        paths.start()
        res = s.solve(tol=1e-8)
        counts = paths.stop(f"{label} f64")
        rel = res.residuals[-1] / res.residuals[0]
        print(f"{label} {n} cells refined {r}x, J={J} (levels "
              f"{[(lev.m, getattr(lev, 'fmt', 'dia')) for lev in s.msmg.levels]}"
              f"): iterations {res.iterations} (JAX CPU {its}), rel "
              f"{rel:.3e}, L2 {res.l2_error:.10e} (JAX CPU {l2}), solve "
              f"{res.solve_seconds:.4f} s", flush=True)
        assert res.converged and rel <= 1e-8, rel
        if its is not None:
            assert res.iterations == its, res.iterations
            assert abs(res.l2_error / l2 - 1.0) <= 1e-6, res.l2_error
        want = flat_per_solve(s, res.iterations)
        for op, c in want.items():
            assert counts[(op, f64)] == c, (label, op, counts[(op, f64)], c)
        del s
    # ν = 4 on the 3-D nested levels, K16 in both dtypes of the refinement
    label, problem, n, r, J, kw, *_ = FLAT_F64[2]
    s = build_solver(problem, n, J, dtype=torch.float32, device=DEVICE,
                     refine=r, mg_nu=4, **kw)
    for dt in (torch.float32, f64):
        s.assemble_rhs_host(dt)
    paths.start()
    res = s.solve_refined(tol=1e-8, compute_error=False)
    counts = paths.stop(f"{label} mg_nu=4 solve_refined")
    rel = res.residuals[-1] / res.residuals[0]
    print(f"{label} mg_nu=4 f32 solve_refined: inner iterations "
          f"{res.iterations} in {len(res.residuals) - 1} rounds, rel "
          f"{rel:.3e}, solve {res.solve_seconds:.4f} s", flush=True)
    assert res.converged and rel <= 1e-8, rel
    for dt in (torch.float32, f64):
        assert counts[("smooth", dt)] > 0, (dt, counts)
    del s
    torch.cuda.empty_cache()


# ------------------------------------------------ the meshes (phases 33-36)

# The sharded-slab forms' checks at the finest slab of the (time 2 × space
# 2) mesh: the 2-D flagship's (513²×128: R = 64 test rows, R + 1 = 65 trial
# rows per time rank; 511 planes over 2 space ranks, Rs = 256 owned planes,
# halo kw = ν + 1 = 3, 511 columns) and smooth3d 65³×32's (R + 1 = 17, Rs =
# 32, 63² planes). The validity field is space rank 1's (its last planes
# are grid padding and halo past the domain).
SH_SLABS = {2: {"T": (65, 64), "own": 256, "rest": (511,)},
            3: {"T": (17,), "own": 32, "rest": (63, 63)}}
SH_H = 3


def sh_inputs(msmg, kl, T, own, h, hc, dtype, rng) -> dict:
    """x, b on the slab, x on the owned planes, e_c with hc and with 1
    coarse halo planes, the slab's validity field and random columns."""
    from spacetime_tpu_torch.ops.multigrid import row_params

    mk = lambda a: torch.as_tensor(a, dtype=dtype, device=DEVICE)
    E, rest = kl.gs[0], kl.gs[1:]
    crest = kl.coarse_gs[1:]
    gid = own - h + np.arange(E)
    e0 = 2 * own - 1  # the real planes of a 2-rank axis (511, 63)
    vm = ((gid >= 0) & (gid < e0)).astype(np.float64)
    omega = np.abs(rng.standard_normal(T)) * 20
    lp = row_params(msmg, omega, dtype, DEVICE)[0]
    return {
        "x": mk(rng.standard_normal((T,) + kl.gs)),
        "b": mk(rng.standard_normal((T,) + kl.gs)),
        "x_own": mk(rng.standard_normal((T, own) + rest)),
        "ec": mk(rng.standard_normal((T, own // 2 + 2 * hc) + crest)),
        "ec1": mk(rng.standard_normal((T, own // 2 + 2) + crest)),
        "vm": mk(np.broadcast_to(vm.reshape((1, E) + (1,) * len(rest)),
                                 (1, E) + rest).copy()),
        "cols": kl.columns(lp),
    }


def sh_forms(kl, x, own, h, hc) -> dict:
    """{form: (kernel op, kernel_fn, twin_fn)} of the sharded-slab forms."""
    X, B, XO, EC, EC1, VM, c = (x[k] for k in (
        "x", "b", "x_own", "ec", "ec1", "vm", "cols"))
    return {
        "smooth": ("sh_smooth", lambda: (kl.smooth(X, B, c, vmask=VM),),
                   lambda: (kl.smooth_plain(X, B, c, vmask=VM),)),
        "smooth_zero": (
            "sh_smooth",
            lambda: (kl.smooth(None, B, c, zero_init=True, vmask=VM),),
            lambda: (kl.smooth_plain(None, B, c, zero_init=True, vmask=VM),)),
        "fused_pre": ("sh_fused_pre",
                      lambda: kl.sh_fused_pre(B, c, VM, own, h),
                      lambda: kl.sh_fused_pre_plain(B, c, VM, own, h)),
        "fused_post": (
            "sh_fused_post",
            lambda: (kl.sh_fused_post(X, B, EC, c, VM, own, h, hc),),
            lambda: (kl.sh_fused_post_plain(X, B, EC, c, VM, own, h, hc),)),
        "residual_restrict": (
            "sh_residual_restrict",
            lambda: (kl.sh_residual_restrict(X, B, c, own, h),),
            lambda: (kl.sh_residual_restrict_plain(X, B, c, own, h),)),
        "prolong_correct": (
            "sh_prolong_correct",
            lambda: (kl.sh_prolong_correct(XO, EC1, own, 1),),
            lambda: (kl.sh_prolong_correct_plain(XO, EC1, own, 1),)),
    }


def sh_bound(form, kl, T, own, hc, dtype) -> dict:
    """Bytes (each input read once, the halo planes and the validity field
    included; each output written once) and operations of one sharded
    form at T rows on the slab."""
    m = int(np.prod(kl.gs))  # the slab, halo planes included
    mo = own * int(np.prod(kl.gs[1:]))  # the owned planes
    crest = int(np.prod(kl.coarse_gs[1:]))
    mc = own // 2 * crest  # the owned coarse planes
    s = torch.finfo(dtype).bits // 8
    op = stencil_ops(kl.pairs)
    nu = kl.nu
    sweep = op * nu + 5 + 7 * (nu - 1)  # mg_bound's, one more multiply per r
    sweep0 = 3 + (op + 7) * (nu - 1)
    restrict = 2 ** (kl.dim + 1)
    cols = 4 * T
    nbytes, flops = {
        "smooth": (s * (3 * T * m + m + cols), T * m * sweep),
        "smooth_zero": (s * (2 * T * m + m + cols), T * m * sweep0),
        "fused_pre": (s * (2 * T * m + m + T * mc + cols),
                      T * m * (sweep0 + op + 1) + T * mc * restrict),
        "fused_post": (s * (3 * T * m + m + T * (mc + 2 * hc * crest)
                            + cols), T * m * (sweep + 3)),
        "residual_restrict": (s * (2 * T * m + T * mc + T),
                              T * m * (op + 1) + T * mc * restrict),
        "prolong_correct": (s * (2 * T * mo + T * (mc + 2 * crest)),
                            T * mo * 3),
    }[form]
    return bound(nbytes, flops, dtype)


def phase_sharded_kernels(msmg2, msmg3) -> dict:
    """Phase 33: the five sharded-slab forms against their twins at the
    meshes' finest slabs, f32 and f64, and timed (ν = 2, h = 3) beside the
    serial form at the owned shape and the bound; the 2-D K6 and K7 also
    at ν = 3 with the mesh's halo there, h = 4."""
    from spacetime_tpu_torch.ops.mg_kernels import MSKernelLevel

    phase("33 sharded-slab kernel forms (K3 vmask, K6/K7/K8/K9 lead) against "
          "their twins at the (2 x 2) mesh's finest slabs")
    rng = np.random.default_rng(SEED + 33)
    results = {}  # (op, dtype, dim) -> {"max_abs_err", "forms": {...}}
    for dim, msmg in ((2, msmg2), (3, msmg3)):
        sl = SH_SLABS[dim]
        own, rest = sl["own"], sl["rest"]
        lev = msmg.levels[0]
        for dtype in (torch.float32, torch.float64):
            nus = ((2, SH_H), (3, SH_H + 1)) if dim == 2 else ((2, SH_H),)
            for T, (nu, h) in itertools.product(sl["T"], nus):
                hc = (h + 2) // 2
                kl = MSKernelLevel(lev.A_st, lev.M_st, nu,
                                   gs=(own + 2 * h,) + rest)
                ser = MSKernelLevel(lev.A_st, lev.M_st, nu,
                                    gs=(own + 1,) + rest)
                x = sh_inputs(msmg, kl, T, own, h, hc, dtype, rng)
                xs = mg_inputs(msmg, ser, T, dtype, rng)
                serial = mg_forms(ser, xs)
                for form, (op, kfn, tfn) in sh_forms(kl, x, own, h,
                                                     hc).items():
                    if nu == 3 and not form.startswith("fused"):
                        continue
                    got, want = kfn(), tfn()
                    torch.cuda.synchronize()
                    rec = results.setdefault(
                        (op, dtype, dim), {"max_abs_err": 0.0, "forms": {}})
                    for g, w in zip(got, want):
                        err = float((g - w).abs().max())
                        scale = float(w.abs().max())
                        assert err <= TOL[dtype] * scale, (
                            form, dtype, T, kl.gs, err, scale)
                        rec["max_abs_err"] = max(rec["max_abs_err"], err)
                    del got, want
                    ms, plain_ms = device_ms(kfn), device_ms(tfn)
                    # the serial form at the owned shape, one plane more
                    # (the serial transfers take odd extents)
                    serial_ms = device_ms(serial[form][1])
                    entry = {"ms": ms, "plain_ms": plain_ms,
                             "library_ms": None, "serial_ms": serial_ms,
                             "serial_shape": shape_key(T, ser.gs),
                             **sh_bound(form, kl, T, own, hc, dtype)}
                    tag = " nu=3" if nu == 3 else ""
                    rec["forms"][f"{form}{tag} {shape_key(T, kl.gs)}"] = entry
                    print(f"  {form:17s} {str(dtype)[6:]:8s} nu={nu} T={T:3d} "
                          f"slab={kl.gs} own={own} h={h}: max|kernel-twin| "
                          f"{err:.3e} (max|twin| {scale:.3e}); kernel "
                          f"{ms:.4f} ms, twin {plain_ms:.4f} ms, serial form "
                          f"at {ser.gs} {serial_ms:.4f} ms, bound "
                          f"{entry['bound_ms']:.4f} ms ({entry['bound_by']})",
                          flush=True)
                del x, xs, serial
                torch.cuda.empty_cache()
    return results


def mesh_run(mesh, specs, label):
    """The specs on the mesh's ranks (one process each, gloo: the ranks
    share the card); rank 0's results."""
    from spacetime_tpu_torch.parallel.launch import solve_specs, spawn_ranks

    print(f"mesh {dict(mesh.shape)} ({label}), gloo:")
    for line in mesh.describe():
        print(" ", line)
    t0 = time.perf_counter()
    out = spawn_ranks(solve_specs, mesh, "gloo", (specs,), timeout=600)
    print(f"  ranks done in {time.perf_counter() - t0:.2f} s", flush=True)
    for o in out:
        assert not o["info"]["foreign"], o["info"]["foreign"]
    return out


def mesh_spec(problem, n, J, dtype, tol, extra=0, kw=None, calls=1,
              error=False):
    return {"problem": problem, "space_n": n, "time_levels": J,
            "extra_time_levels": extra, "dtype": dtype, "kw": kw or {},
            "loads": True, "print": True,
            "runs": [("solve", {"tol": tol, "compute_error": error})] * calls}


def add_launches(total: dict, launches: dict) -> None:
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def vcycles_per_solve(iterations: int, kw: dict) -> int:
    """V-cycles of one mg ``solve``: the rhs's K_Y, PCG's S and K_X before
    its loop and once per iteration; K_Y takes mg_cycles, K_X 2·mg_cycles_kx
    (the two solves around A)."""
    ky, kx = kw.get("mg_cycles", 3), 2 * kw.get("mg_cycles_kx", 2)
    return 2 * ky + kx + iterations * (ky + kx)


def check_mesh_history(r, ref, label) -> None:
    """Iterations equal to the serial port's on the card, residual history
    within rtol 1e-9."""
    print(f"{label}: iterations {r['iterations']} (serial port "
          f"{ref.iterations}), solve {r['solve_seconds']:.4f} s")
    assert r["converged"] and r["iterations"] == ref.iterations, (
        r["iterations"], ref.iterations)
    np.testing.assert_allclose(r["residuals"], ref.residuals, rtol=1e-9)


def phase_meshes(serial: dict, mesh_launches: dict) -> dict:
    """Phases 34-36: the time mesh and the time × space mesh, four ranks
    on the card (three for the general layout), over gloo."""
    from spacetime_tpu_torch.parallel import (make_spacetime_mesh,
                                              make_time_mesh)

    f64 = "f64"
    flag = {}
    phase("34 the time mesh: cfg2 f64 on 4 ranks, cfg4 (graded, the "
          "general layout) on 3")
    out = mesh_run(make_time_mesh(4), [mesh_spec("smooth2d", SPACE_N,
                                                 TIME_LEVELS, f64, 1e-8)],
                   "cfg2 f64")
    r = out[0]["runs"][0]
    print(f"  layout {out[0]['info']}")
    assert out[0]["info"]["aligned"]
    check_mesh_history(r, serial["cfg2 f64"], "cfg2 f64 on the time mesh")
    add_launches(mesh_launches, r["launches"])
    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, "baseline_oracle.json")) as f:
        row = {x["config"]: x for x in json.load(f)}[
            "cfg4-singular-graded-32-J4+4"]
    out = mesh_run(make_time_mesh(3), [mesh_spec(
        "singular2d", 32, 4, f64, 1e-6, extra=4, error=True)], "cfg4 f64")
    r = out[0]["runs"][0]
    print(f"  layout {out[0]['info']}")
    print(f"cfg4 on 3 ranks: iterations {r['iterations']} (oracle "
          f"{row['iters']}), L2 {r['l2_error']:.10e} (oracle "
          f"{row['l2_error']:.10e})")
    assert not out[0]["info"]["aligned"]
    assert r["converged"] and r["iterations"] == row["iters"], r["iterations"]
    assert seven_digits(r["residuals"] / r["residuals"][0]) == \
        row["rel_residuals"]
    assert abs(r["l2_error"] / row["l2_error"] - 1.0) <= 1e-9, r["l2_error"]

    phase("35 the time x space mesh (2 x 2): cfg2 f64, cfg2 V(2,1) f32, the "
          f"flagship {FLAGSHIP_N + 1}^2 x {2 ** FLAGSHIP_LEVELS} f32 (twice), "
          "and the small f64 / V(2,1) runs of the remaining forms")
    v21 = {"inner": "mg", "mg_nu_post": 1}
    specs = [
        mesh_spec("smooth2d", SPACE_N, TIME_LEVELS, f64, 1e-8),
        mesh_spec("smooth2d", SPACE_N, TIME_LEVELS, "f32", 1e-6, kw=v21),
        mesh_spec("smooth2d", 32, 4, f64, 1e-8, kw=v21),
        mesh_spec("smooth2d", FLAGSHIP_N, FLAGSHIP_LEVELS, "f32", 1e-6,
                  calls=2),
    ]
    out = mesh_run(make_spacetime_mesh(2, 2), specs, "time 2 x space 2")
    info = [o["info"] for o in out]
    for i in info:
        print(f"  layout {i}")
    check_mesh_history(out[0]["runs"][0], serial["cfg2 f64"],
                       "cfg2 f64 on the (2 x 2) mesh")
    r = out[1]["runs"][0]
    print(f"cfg2 V(2,1) f32: iterations {r['iterations']} (serial port "
          f"{serial['V(2,1)'].iterations})")
    assert r["converged"] and abs(
        r["iterations"] - serial["V(2,1)"].iterations) <= 1, r["iterations"]
    for o in out[:3]:
        for run in o["runs"]:
            add_launches(mesh_launches, run["launches"])
    for k in ("K3 mg_sh_smooth", "K8 mg_sh_residual_restrict",
              "K9 mg_sh_prolong_correct"):
        for dt in ("f32", "f64"):
            assert mesh_launches.get(f"{k} {dt}", 0) > 0, (k, dt)
    runs = out[3]["runs"]
    fi = info[3]
    assert fi["Rs"] == 256 and fi["sp_depth"] == 4, fi
    assert all(fi["kernel_levels"]["ky"]) and all(fi["kernel_levels"]["kx"])
    for call, r in enumerate(runs, 1):
        print(f"flagship on the mesh, call {call}: iterations "
              f"{r['iterations']}, solve {r['solve_seconds']:.4f} s; rank 0: "
              f"{r['exchanges'] / r['iterations']:.1f} exchanges and "
              f"{r['bytes_staged'] / r['iterations'] / 2**20:.2f} MiB "
              "staged through host memory per PCG iteration, "
              f"{r['comm_seconds']:.4f} s in its collectives (of "
              f"{r['solve_seconds'] + r['transfer_seconds']:.4f} s with "
              "the iterate's gather)")
        assert r["converged"], r["residuals"]
        assert abs(r["iterations"] - REF_FLAGSHIP["iterations"]) <= 2
        vc = vcycles_per_solve(r["iterations"], {})
        for k in ("K6 mg_sh_fused_pre f32", "K7 mg_sh_fused_post f32"):
            per = r["launches"].get(k, 0) / (4 * vc)  # 4 ranks
            print(f"  {k}: {r['launches'].get(k, 0)} launches on the 4 "
                  f"ranks, {per:.2f} per rank and V-cycle (the sharded "
                  f"levels: {fi['sp_depth']})")
            assert per == fi["sp_depth"], (k, per)
        add_launches(mesh_launches, r["launches"])
    t0 = time.perf_counter()
    l2 = serial["flagship l2"](runs[0]["U"])
    print(f"flagship on the mesh: L2(IxOmega) {l2:.6e} (band "
          f"{REF_FLAGSHIP['l2']:.4e} +- 20%), host error loop "
          f"{time.perf_counter() - t0:.2f} s; steady solve "
          f"{runs[1]['solve_seconds']:.4f} s against the serial port's "
          f"{serial['flagship steady s']:.4f} s (four ranks on one card, "
          "halos through host memory: a bring-up record, not a scaling "
          "result)")
    assert abs(l2 / REF_FLAGSHIP["l2"] - 1.0) <= REF_FLAGSHIP["l2_band"], l2
    flag.update(iterations=runs[1]["iterations"],
                steady_s=runs[1]["solve_seconds"],
                exchanges=runs[1]["exchanges"],
                bytes_staged=runs[1]["bytes_staged"], l2=l2)

    n3, J3 = REF_3D["n"], REF_3D["levels"]
    phase(f"36 3-D on the (2 x 2) mesh: smooth3d {n3 + 1}^3 x {2 ** J3} f32, "
          "and 17^3 x 16 f64 V(2,2) / V(2,1) runs of the remaining forms")
    specs = [mesh_spec("smooth3d", n3, J3, "f32", 1e-6),
             mesh_spec("smooth3d", 16, 4, f64, 1e-8, kw={"inner": "mg"}),
             mesh_spec("smooth3d", 16, 4, f64, 1e-8, kw=v21),
             mesh_spec("smooth3d", 16, 4, "f32", 1e-6, kw=v21)]
    out = mesh_run(make_spacetime_mesh(2, 2), specs, "time 2 x space 2")
    r = out[0]["runs"][0]
    l2 = serial["3d l2"](r["U"])
    print(f"  layout {out[0]['info']}")
    print(f"smooth3d {n3 + 1}^3 x {2 ** J3} on the mesh: iterations "
          f"{r['iterations']} (JAX CPU {REF_3D['iterations']}), L2 "
          f"{l2:.6e} (JAX CPU {REF_3D['l2']:.6e}), solve "
          f"{r['solve_seconds']:.4f} s")
    assert r["converged"] and abs(r["iterations"] - REF_3D["iterations"]) <= 1
    assert abs(l2 / REF_3D["l2"] - 1.0) <= REF_3D["l2_band"], l2
    for k in ("K6 mg_sh_fused_pre_3d f32", "K7 mg_sh_fused_post_3d f32"):
        assert r["launches"].get(k, 0) > 0, (k, r["launches"])
    for o in out:
        for run in o["runs"]:
            assert run["converged"], o["info"]
            add_launches(mesh_launches, run["launches"])
    return flag


def device_ms(fn) -> float:
    """Median device ms of ``fn()`` (``utils.profiling.device_ms``, imported
    once ``main`` has put the repository on the path)."""
    from spacetime_tpu_torch.utils.profiling import device_ms as median_ms

    return median_ms(fn)


class Paths:
    """Launch counts of every kernel per main path: zeroed just before a
    path, read just after it."""

    def __init__(self, *modules):
        self.modules = modules
        self.counts = {}  # path -> {kernel key: launches}

    def start(self) -> None:
        for m in self.modules:
            m.reset_launch_counts()

    def stop(self, path: str, per: int | None = None) -> dict:
        """The path's counts; with ``per``, also printed per PCG
        application (``per`` operator applications in the path)."""
        c = {key: k.launches for m in self.modules for key, k in m.KERNELS.items()}
        self.counts[path] = c
        print(f"launches in path {path}:",
              {k.name: k.launches for m in self.modules
               for k in m.KERNELS.values() if k.launches})
        if per:
            print(f"  per PCG iteration ({per}):",
                  {k.name: round(k.launches / per, 2) for m in self.modules
                   for k in m.KERNELS.values() if k.launches})
        return c

    def total(self, key) -> int:
        return sum(c[key] for c in self.counts.values())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from spacetime_tpu_torch.ops import (dia_kernels, kron, mg_kernels, native,
                                         spmv)
    from spacetime_tpu_torch.ops.mg_kernels import (MSKernelLevel,
                                                    VarMSKernelLevel)
    from spacetime_tpu_torch.solver import build_solver

    phase("1 device")
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}; {torch.cuda.device_count()} device(s)")
    print(smi, flush=True)

    phase("2 build")
    native.LIB.get()
    print(f"library {native.LIB.path}, built in "
          f"{native.LIB.build_seconds:.2f} s")
    for line in native.LIB.build_log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())
    lib = native.LIB.get()
    # var 2: K15's instantiation that takes the row first (W beyond the L2)
    for (post, var), nu, f64 in itertools.product(
            ((0, 0), (0, 1), (1, 0), (1, 1), (1, 2)), (2, 3), (0, 1)):
        blocks, nbytes = ctypes.c_int(), ctypes.c_int()
        native.check(lib, "mg_march_occupancy", lib.mg_march_occupancy(
            post, var, nu, f64, ctypes.byref(blocks), ctypes.byref(nbytes)))
        name = (("K7", "K15", "K15 row-first")[var] if post
                else ("K14" if var else "K6"))
        print(f"  3-D {name} march, nu={nu}, "
              f"{'float64' if f64 else 'float32'}: {blocks.value} blocks "
              f"of 256 threads per SM, {nbytes.value} bytes of shared "
              "memory a block")
    # the 2-D march's blocks take as many threads as their row needs
    for post, nu, f64, nx in itertools.product((0, 1), (2, 3), (0, 1),
                                               (511, 255, 127, 63)):
        blocks, nbytes, threads, nseg = (ctypes.c_int() for _ in range(4))
        native.check(lib, "mg_march2_occupancy", lib.mg_march2_occupancy(
            post, nu, f64, nx, ctypes.byref(blocks), ctypes.byref(nbytes),
            ctypes.byref(threads), ctypes.byref(nseg)))
        print(f"  2-D {'K7' if post else 'K6'} march, nu={nu}, "
              f"{'float64' if f64 else 'float32'}, {nx} columns: "
              f"{blocks.value} blocks of {threads.value} threads per SM, "
              f"{nbytes.value} bytes of shared memory a block")

    from spacetime_tpu_torch.fem import l2_error_spacetime

    def l2_of(s):
        """The host L2 error of solver ``s``'s problem, mesh and grid,
        without the solver (its device memory)."""
        problem, mesh, grid = s.problem, s.system.mesh, s.grid
        return lambda U: l2_error_spacetime(problem, mesh, grid,
                                            np.asarray(U, np.float64))

    serial = {}  # the serial port's results the meshes are held to

    phase("3 setup (cfg2: smooth2d 129x129 x 64 steps, f32, inner mg)")
    t0 = time.perf_counter()
    solver = build_solver("smooth2d", SPACE_N, TIME_LEVELS,
                          dtype=torch.float32, device="cuda")
    print(f"setup {time.perf_counter() - t0:.2f} s (m={solver.m}, "
          f"N={solver.N}, inner={solver.inner}, levels="
          f"{[lev.n for lev in solver.msmg.levels]})")
    # the 3-D stencils (taps and a level's pair table) of a small solver
    small3 = build_solver("smooth3d", 8, 1, dtype=torch.float32, device="cuda",
                          inner="mg")

    phase("4 kernels against their plain twins")
    rng = np.random.default_rng(SEED)
    cfg2_taps = solver.taps
    shapes = [(solver.N, cfg2_taps, True)] + [
        (T, dataclasses.replace(small3.taps if len(gs) == 3 else cfg2_taps,
                                gs=gs), timed)
        for T, gs, timed in KRON_SHAPES
    ]
    results = {}  # (op, dtype) -> {"max_abs_err", "forms": {form: {...}}}
    for dtype in (torch.float32, torch.float64):
        for T, taps, timed in shapes:
            forms = kernel_forms(kron, taps, seeded_inputs(taps, T, dtype, rng))
            for form, (kfn, tfn) in forms.items():
                got, want = kfn(), tfn()
                torch.cuda.synchronize()
                err = max(float((g - w).abs().max()) for g, w in zip(got, want))
                scale = max(float(w.abs().max()) for w in want)
                del got, want
                print(f"  {form:8s} {str(dtype)[6:]:8s} T={T:3d} gs={taps.gs}: "
                      f"max|kernel-twin| {err:.3e} (max|twin| {scale:.3e})")
                assert err <= TOL[dtype] * scale, (form, dtype, T, err, scale)
                op = form.split("_")[0]
                rec = results.setdefault(
                    (op, dtype), {"max_abs_err": 0.0, "forms": {}})
                rec["max_abs_err"] = max(rec["max_abs_err"], err)
                if timed:
                    ms = device_ms(kfn)
                    plain_ms = device_ms(tfn)
                    variant = "stab" if "stab" in form else "plain"
                    entry = {"ms": ms, "plain_ms": plain_ms,
                             "max_abs_err": err, "library_ms": None,
                             **kron_bound(form, taps, T, dtype)}
                    rec["forms"][f"{variant} {shape_key(T, taps.gs)}"] = entry
                    print(f"  {'':8s} {'':8s} kernel {ms:.4f} ms, "
                          f"twin {plain_ms:.4f} ms (median of 20, device), "
                          f"bound {entry['bound_ms']:.4f} ms "
                          f"({entry['bound_by']})")
            torch.cuda.empty_cache()
        # B -> Bᵀ pair throughput at cfg2 (one output DoF per row of B).
        x = seeded_inputs(cfg2_taps, solver.N, dtype, rng)
        U, hh, taps = x["U"], x["hh"], cfg2_taps
        pair_k = device_ms(
            lambda: kron.apply_BT(kron.apply_B(U, hh, taps), hh, taps))
        pair_t = device_ms(
            lambda: kron.apply_BT_plain(kron.apply_B_plain(U, hh, taps), hh, taps))
        dofs = solver.N * solver.m
        print(f"  B->BT pair {str(dtype)[6:]}: kernels {pair_k:.4f} ms "
              f"({dofs / (pair_k / 2e3) / 1e9:.2f} GDoF/s), twins "
              f"{pair_t:.4f} ms ({dofs / (pair_t / 2e3) / 1e9:.2f} GDoF/s)")
        results[("pair", dtype)] = {"ms": pair_k, "plain_ms": pair_t}

    mg_results = {}  # (op, dtype, dim) -> {"max_abs_err", "forms": {...}}
    for title, msmg, mg_shapes, seed in (
        ("5 mg kernels K3-K9 (2-D) against their plain twins",
         solver.msmg, MG_SHAPES, SEED + 1),
        ("6 mg kernels K3-K9 (3-D) against their plain twins",
         small3.msmg, MG_SHAPES_3D, SEED + 2),
    ):
        phase(title)
        rng = np.random.default_rng(seed)
        lev0 = msmg.levels[0]
        for dtype in (torch.float32, torch.float64):
            for T, gs in mg_shapes:
                for nu in (2, 3):
                    kl = MSKernelLevel(lev0.A_st, lev0.M_st, nu, gs=gs)
                    x = mg_inputs(msmg, kl, T, dtype, rng)
                    check_forms(kl, mg_forms(kl, x), mg_bound, T, dtype,
                                mg_results,
                                library=("apply_A", stencil_conv(kl, x["x"])),
                                pairs=semi_pairs(kl, x, False))
                    del x
                    torch.cuda.empty_cache()
    # K6, K7 and their pairs at the 129³ solve's finest level: x, b and
    # e_c made on the card from the seed (the host's random fields of this
    # size took most of this check's time), one set a dtype for both ν
    from spacetime_tpu_torch.ops.multigrid import row_params

    t0 = time.perf_counter()
    lev0 = small3.msmg.levels[0]
    T, gs = FUSED_BIG
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    for dtype in (torch.float32, torch.float64):
        big = {key: torch.randn((T,) + shape, generator=gen, device=DEVICE,
                                dtype=dtype)
               for key, shape in (("x", gs), ("b", gs),
                                  ("ec", tuple((n - 1) // 2 for n in gs)))}
        for nu in (2, 3):
            kl = MSKernelLevel(lev0.A_st, lev0.M_st, nu, gs=gs)
            x = dict(big, cols=kl.columns(row_params(
                small3.msmg, np.abs(rng.standard_normal(T)) * 20, dtype,
                DEVICE)[0]))
            forms = mg_forms(kl, x)
            check_forms(kl, {f: forms[f] for f in ("fused_pre", "fused_post")},
                        mg_bound, T, dtype, mg_results, timed=True,
                        pairs=semi_pairs(kl, x, False))
        del big, x, forms
        torch.cuda.empty_cache()
    print(f"K6, K7 at {shape_key(T, gs)}: {time.perf_counter() - t0:.2f} s")
    # the host hierarchies of the sharded forms' checks (phase 33)
    msmg2, msmg3 = solver.msmg, small3.msmg
    del small3

    paths = Paths(kron, mg_kernels, spmv, dia_kernels)
    f32, f64 = torch.float32, torch.float64
    phase("7 solve(tol=1e-6), f32")
    paths.start()
    res = solver.solve(tol=1e-6)
    rel = res.residuals[-1] / res.residuals[0]
    print(f"iterations {res.iterations}, converged {res.converged}, rel "
          f"{rel:.3e}, L2 {res.l2_error:.6e}; solve {res.solve_seconds:.4f} s, "
          f"rhs quadrature {res.rhs_seconds:.2f} s")
    assert res.converged and rel <= 1e-6
    assert abs(res.iterations - REF_SOLVE["iterations"]) <= 1, res.iterations
    assert abs(res.l2_error / REF_SOLVE["l2"] - 1.0) <= 0.01, res.l2_error

    phase("8 solve_refined(tol=1e-8), f32 inner / f64 legs, twice")
    for call in (1, 2):
        r = solver.solve_refined(tol=1e-8)
        rel = r.residuals[-1] / r.residuals[0]
        rounds = len(r.residuals) - 1
        print(f"call {call}: inner iterations {r.iterations} in {rounds} "
              f"rounds, converged {r.converged}, rel {rel:.3e}, L2 "
              f"{r.l2_error:.6e}, solve {r.solve_seconds:.4f} s")
        assert r.converged and rel <= 1e-8, rel
        assert rounds == REF_REFINED["rounds"], rounds
        assert abs(r.iterations - REF_REFINED["iterations"]) <= 2, r.iterations
        assert abs(r.l2_error / REF_REFINED["l2"] - 1.0) <= 0.01, r.l2_error
    print(f"steady solve_refined: {r.solve_seconds:.4f} s, "
          f"{r.iterations} inner iterations")
    counts = paths.stop("cfg2 solve + solve_refined")
    must = [(op, dt) for op in ("B", "BT") for dt in (f32, f64)]
    must += [(op, f32, 2) for op in ("residual", "apply", "fused_pre",
                                     "fused_post")]
    must += [(op, f64, 2) for op in ("residual", "fused_pre", "fused_post")]
    assert all(counts[key] > 0 for key in must), counts
    del solver
    torch.cuda.empty_cache()

    phase(f"9 flagship: smooth2d {FLAGSHIP_N + 1}^2 x {2 ** FLAGSHIP_LEVELS} "
          "steps, f32, inner mg")
    t0 = time.perf_counter()
    flag = build_solver("smooth2d", FLAGSHIP_N, FLAGSHIP_LEVELS,
                        dtype=torch.float32, device="cuda")
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    flag.assemble_rhs_host()
    loads_s = time.perf_counter() - t0
    dofs = (flag.N + 1) * flag.m
    print(f"setup {setup_s:.2f} s (m={flag.m}, N={flag.N}, {dofs:,} DoF, "
          f"levels={[lev.n for lev in flag.msmg.levels]}); loads "
          f"{loads_s:.2f} s (host quadrature {flag.rhs_seconds:.2f} s)")
    paths.start()
    runs = []
    for call in (1, 2):
        r = flag.solve(tol=1e-6, compute_error=False)
        rel = r.residuals[-1] / r.residuals[0]
        print(f"solve call {call}: iterations {r.iterations}, converged "
              f"{r.converged}, rel {rel:.3e}, solve {r.solve_seconds:.4f} s, "
              f"iterate to host {r.transfer_seconds:.4f} s")
        assert r.converged and rel <= 1e-6, rel
        assert abs(r.iterations - REF_FLAGSHIP["iterations"]) <= 2, r.iterations
        runs.append(r)
    t0 = time.perf_counter()
    l2 = flag._l2_error(runs[0].U)
    l2_s = time.perf_counter() - t0
    print(f"L2(IxOmega) {l2:.6e} (JAX reference {REF_FLAGSHIP['l2']:.4e}), "
          f"host error loop {l2_s:.2f} s")
    assert abs(l2 / REF_FLAGSHIP["l2"] - 1.0) <= REF_FLAGSHIP["l2_band"], l2
    print(f"steady solve: {runs[1].solve_seconds:.4f} s, "
          f"{runs[1].iterations} iterations")
    serial["flagship steady s"] = runs[1].solve_seconds
    serial["flagship l2"] = l2_of(flag)
    r = flag.solve_refined(tol=1e-8, compute_error=False)
    rel = r.residuals[-1] / r.residuals[0]
    l2 = flag._l2_error(r.U)
    print(f"solve_refined: inner iterations {r.iterations} in "
          f"{len(r.residuals) - 1} rounds, converged {r.converged}, rel "
          f"{rel:.3e}, L2 {l2:.6e} (float64 solve {REF_FLAGSHIP['l2_f64']:.4e}), "
          f"solve {r.solve_seconds:.4f} s")
    assert r.converged and rel <= 1e-8, rel
    assert abs(l2 / REF_FLAGSHIP["l2_f64"] - 1.0) <= 0.01, l2
    counts = paths.stop("flagship")
    must = [(op, dt) for op in ("B", "BT") for dt in (f32, f64)]
    must += [(op, dt, 2) for op in ("residual", "fused_pre", "fused_post")
             for dt in (f32, f64)]
    must += [("apply", f32, 2)]
    assert all(counts[key] > 0 for key in must), counts
    del flag, runs, r
    torch.cuda.empty_cache()

    phase("10 V(2,1): cfg2 with mg_nu_post=1, f32")
    v21 = build_solver("smooth2d", SPACE_N, TIME_LEVELS, dtype=torch.float32,
                       device="cuda", mg_nu_post=1)
    v21.assemble_rhs_host()
    paths.start()
    r = v21.solve(tol=1e-6, compute_error=False)
    rel = r.residuals[-1] / r.residuals[0]
    print(f"solve: iterations {r.iterations} (JAX CPU {REF_V21['iterations']}), "
          f"converged {r.converged}, rel {rel:.3e}, solve {r.solve_seconds:.4f} s")
    assert r.converged and rel <= 1e-6, rel
    assert abs(r.iterations - REF_V21["iterations"]) <= 1, r.iterations
    serial["V(2,1)"] = r
    r = v21.solve_refined(tol=1e-8, compute_error=False)
    print(f"solve_refined: inner iterations {r.iterations} in "
          f"{len(r.residuals) - 1} rounds, converged {r.converged}")
    assert r.converged, r.residuals
    counts = paths.stop("V(2,1)")
    assert all(counts[(op, dt, 2)] > 0 for op in (
        "smooth", "residual", "residual_restrict", "prolong_correct")
        for dt in (f32, f64)), counts
    assert all(counts[(op, dt, 2)] == 0 for op in ("fused_pre", "fused_post")
               for dt in (f32, f64)), counts
    del v21

    phase("11 f64: cfg2 solve(tol=1e-8) in float64")
    s64 = build_solver("smooth2d", SPACE_N, TIME_LEVELS, dtype=torch.float64,
                       device="cuda")
    s64.assemble_rhs_host()
    paths.start()
    r = s64.solve(tol=1e-8)
    rel = r.residuals[-1] / r.residuals[0]
    print(f"iterations {r.iterations} (JAX CPU {REF_F64['iterations']}), "
          f"converged {r.converged}, rel {rel:.3e}, L2 {r.l2_error:.10e}, "
          f"solve {r.solve_seconds:.4f} s")
    assert r.converged and rel <= 1e-8, rel
    assert abs(r.iterations - REF_F64["iterations"]) <= 1, r.iterations
    assert abs(r.l2_error / REF_F64["l2"] - 1.0) <= 1e-6, r.l2_error
    serial["cfg2 f64"] = r
    counts = paths.stop("f64")
    assert all(counts[(op, f64)] > 0 for op in ("B", "BT")), counts
    assert all(counts[(op, f64, 2)] > 0 for op in (
        "residual", "apply", "fused_pre", "fused_post")), counts
    del s64
    torch.cuda.empty_cache()

    n3, J3 = REF_3D["n"], REF_3D["levels"]
    phase(f"12 smooth3d {n3 + 1}^3 x {2 ** J3} steps, f32, inner mg")
    t0 = time.perf_counter()
    s3 = build_solver("smooth3d", n3, J3, dtype=torch.float32, device="cuda",
                      inner="mg")
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    s3.assemble_rhs_host()
    loads_s = time.perf_counter() - t0
    print(f"setup {setup_s:.2f} s (m={s3.m}, N={s3.N}, "
          f"{(s3.N + 1) * s3.m:,} DoF, levels="
          f"{[lev.n for lev in s3.msmg.levels]}, coarse "
          f"{s3.msmg.n_coarse}); loads {loads_s:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    paths.start()
    runs = []
    for call in (1, 2):
        r = s3.solve(tol=1e-6, compute_error=False)
        rel = r.residuals[-1] / r.residuals[0]
        print(f"solve call {call}: iterations {r.iterations} (JAX CPU "
              f"{REF_3D['iterations']}), converged {r.converged}, rel "
              f"{rel:.3e}, solve {r.solve_seconds:.4f} s", flush=True)
        assert r.converged and rel <= 1e-6, rel
        assert abs(r.iterations - REF_3D["iterations"]) <= 1, r.iterations
        runs.append(r)
    counts = paths.stop("smooth3d f32", per=sum(r.iterations for r in runs))
    print(f"steady solve: {runs[1].solve_seconds:.4f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    t0 = time.perf_counter()
    l2 = s3._l2_error(runs[0].U)
    print(f"L2(IxOmega) {l2:.6e} (JAX CPU {REF_3D['l2']:.6e}), host error "
          f"loop {time.perf_counter() - t0:.2f} s")
    assert abs(l2 / REF_3D["l2"] - 1.0) <= REF_3D["l2_band"], l2
    fused_path(counts, (f32,), 3)
    serial["3d l2"] = l2_of(s3)
    del s3, runs, r
    torch.cuda.empty_cache()

    n3, J3 = REF_3D_F64["n"], REF_3D_F64["levels"]
    phase(f"13 smooth3d {n3 + 1}^3 x {2 ** J3} steps, f64, solve(tol=1e-8)")
    s3 = build_solver("smooth3d", n3, J3, dtype=torch.float64, device="cuda",
                      inner="mg")
    s3.assemble_rhs_host()
    paths.start()
    r = s3.solve(tol=1e-8)
    rel = r.residuals[-1] / r.residuals[0]
    print(f"iterations {r.iterations} (JAX CPU {REF_3D_F64['iterations']}), "
          f"converged {r.converged}, rel {rel:.3e}, L2 {r.l2_error:.10e} "
          f"(JAX CPU {REF_3D_F64['l2']:.10e}), solve {r.solve_seconds:.4f} s")
    assert r.converged and rel <= 1e-8, rel
    assert r.iterations == REF_3D_F64["iterations"], r.iterations
    assert abs(r.l2_error / REF_3D_F64["l2"] - 1.0) <= 1e-6, r.l2_error
    fused_path(paths.stop("smooth3d f64"), (f64,), 3)
    del s3
    torch.cuda.empty_cache()

    phase("14 weighted mg kernels K10-K15 (2-D) against their twins")
    rng = np.random.default_rng(SEED + 3)
    for n in sorted({n for _, _, n in VAR_SHAPES}, reverse=True):
        t0 = time.perf_counter()
        msmg = var_hierarchy(n)
        print(f"varcoef2d weights at {n} cells: {time.perf_counter() - t0:.2f} "
              f"s, taps {msmg.levels[0].A_vs.disps}", flush=True)
        for dtype in (f32, f64):
            for T, gs in ((T, gs) for T, gs, nw in VAR_SHAPES if nw == n):
                for nu in (1, 2, 3):
                    kl = VarMSKernelLevel(msmg.levels[0], nu, gs=gs)
                    x = var_inputs(msmg, kl, T, dtype, rng)
                    check_forms(kl, var_forms(kl, x), var_bound, T, dtype,
                                mg_results, pairs=semi_pairs(kl, x, True))
                    del x
                    torch.cuda.empty_cache()
        del msmg

    def var_path(name, iterations, levels, dtype, legs=None, dim=2,
                 semi=False):
        """The weighted path's counts in ``dtype`` (and in the refinement
        legs' dtype ``legs``): K11, K12 and the V-cycle stages of the
        path's branch launched, the fused K14 = K15 or (``semi``) the
        semi-fused K10 = 2·K13 = 2·K9, a whole number of V-cycles over the
        ``levels`` kernel levels, at least 7 per PCG iteration in ``dtype``
        (3 for K_Y, 2 × 2 for K_X); no other kernel, and none of another
        dimension."""
        counts = paths.stop(name, per=iterations)
        ops = {"residual_var", "apply_var"} | (
            {"smooth_var", "residual_restrict_var", "prolong_correct"} if semi
            else {"fused_pre_var", "fused_post_var"})
        for dt in (dtype,) if legs is None else (dtype, legs):
            got = {op: counts[(op, dt, dim)] for op in ops}
            assert all(got.values()), (dt, got)
            if semi:
                pre = got["residual_restrict_var"]
                assert got["smooth_var"] == 2 * pre == 2 * got[
                    "prolong_correct"], got
            else:
                pre = got["fused_pre_var"]
                assert pre == got["fused_post_var"], got
            assert pre % levels == 0, (pre, levels)
        pre = counts[("residual_restrict_var" if semi else "fused_pre_var",
                      dtype, dim)]
        assert pre >= 7 * levels * iterations, (pre, iterations)
        assert all(n == 0 for key, n in counts.items()
                   if key[0] not in ops or key[-1] != dim), counts

    n, J = REF_VAR["n"], REF_VAR["levels"]
    phase(f"15 varcoef2d {n + 1}^2 x {2 ** J} steps, f32, inner mg")
    t0 = time.perf_counter()
    var = build_solver("varcoef2d", n, J, dtype=f32, device="cuda")
    assert var.spatial_format == "vstencil" and var.inner == "mg"
    var.assemble_rhs_host()
    L = len(var.msmg.levels)
    print(f"setup {var.setup_seconds:.2f} s, loads {var.rhs_seconds:.2f} s "
          f"(levels {[lev.n for lev in var.msmg.levels]}, coarse "
          f"{var.msmg.n_coarse})")
    paths.start()
    r = var.solve(tol=1e-6)
    rel = r.residuals[-1] / r.residuals[0]
    print(f"solve: iterations {r.iterations} (JAX CPU {REF_VAR['iterations']}),"
          f" converged {r.converged}, rel {rel:.3e}, L2 {r.l2_error:.6e} (JAX "
          f"CPU {REF_VAR['l2']:.6e}), solve {r.solve_seconds:.4f} s")
    assert r.converged and rel <= 1e-6, rel
    assert abs(r.iterations - REF_VAR["iterations"]) <= 1, r.iterations
    assert abs(r.l2_error / REF_VAR["l2"] - 1.0) <= 0.01, r.l2_error
    its = r.iterations
    r = var.solve_refined(tol=1e-8)
    rel = r.residuals[-1] / r.residuals[0]
    rounds = len(r.residuals) - 1
    print(f"solve_refined: inner iterations {r.iterations} in {rounds} rounds "
          f"(JAX CPU {REF_VAR['refined_iterations']} in "
          f"{REF_VAR['refined_rounds']}), converged {r.converged}, rel "
          f"{rel:.3e}, L2 {r.l2_error:.6e}, solve {r.solve_seconds:.4f} s")
    assert r.converged and rel <= 1e-8, rel
    assert abs(rounds - REF_VAR["refined_rounds"]) <= 2, rounds
    assert abs(r.iterations - REF_VAR["refined_iterations"]) <= 2, r.iterations
    var_path("varcoef2d 129^2 f32", its + r.iterations, L, f32, legs=f64)
    print(f"  total time of the phase {time.perf_counter() - t0:.2f} s")
    del var

    n, J = REF_VAR_FLAGSHIP["n"], REF_VAR_FLAGSHIP["levels"]
    phase(f"16 varcoef2d {n + 1}^2 x {2 ** J} steps, f32, inner mg")
    t0 = time.perf_counter()
    flag = build_solver("varcoef2d", n, J, dtype=f32, device="cuda")
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    flag.assemble_rhs_host()
    loads_s = time.perf_counter() - t0
    L = len(flag.msmg.levels)
    print(f"setup {setup_s:.2f} s ({(flag.N + 1) * flag.m:,} DoF, levels "
          f"{[lev.n for lev in flag.msmg.levels]}); loads {loads_s:.2f} s")
    # B, Bᵀ and the stab term on the weighted format: K12 for A_w, M in
    # plain PyTorch, against the same with A_w's twin
    p, kl0 = flag.params, flag._kl_ky[0]
    U = torch.as_tensor(np.random.default_rng(SEED + 4).standard_normal(
        (flag.N + 1,) + flag.gs), dtype=f32, device="cuda")
    V = U[:-1].contiguous()
    hh, Aw = p["h_half"], p["Aw"]
    plain_B = lambda: (flag._spmv_M(U[1:] - U[:-1], p)
                       + hh * kl0.apply_A_plain(U[1:] + U[:-1], Aw))
    plain_BT = lambda: kl0.apply_A_plain(V, Aw)
    b_ms = {"B": (device_ms(lambda: flag.apply_B(U, p)), device_ms(plain_B)),
            "BT": (device_ms(lambda: flag.apply_BT(V, p)), None),
            "stab": (device_ms(lambda: flag.apply_stab(U, p)), None),
            "A_w of BT": (device_ms(lambda: kl0.apply_A(V, Aw)),
                          device_ms(plain_BT))}
    for k, (ms, plain) in b_ms.items():
        print(f"  {k}: {ms:.4f} ms" + (f" (with A_w's twin {plain:.4f} ms)"
                                       if plain is not None else ""))
    del U, V
    paths.start()
    runs = []
    for call in (1, 2):
        r = flag.solve(tol=1e-6, compute_error=False)
        rel = r.residuals[-1] / r.residuals[0]
        print(f"solve call {call}: iterations {r.iterations}, converged "
              f"{r.converged}, rel {rel:.3e}, solve {r.solve_seconds:.4f} s",
              flush=True)
        assert r.converged and rel <= 1e-6, rel
        assert abs(r.iterations - REF_VAR_FLAGSHIP["iterations"]) <= 2, (
            r.iterations)
        runs.append(r)
    t0 = time.perf_counter()
    l2 = flag._l2_error(runs[0].U)
    print(f"L2(IxOmega) {l2:.6e} (the port's f64 "
          f"{REF_VAR_FLAGSHIP['l2_f64']:.6e}), host error loop "
          f"{time.perf_counter() - t0:.2f} s; steady solve "
          f"{runs[1].solve_seconds:.4f} s, {runs[1].iterations} iterations")
    assert abs(l2 / REF_VAR_FLAGSHIP["l2_f64"] - 1.0) <= (
        REF_VAR_FLAGSHIP["l2_band"]), l2
    r = flag.solve_refined(tol=1e-8, compute_error=False)
    rel = r.residuals[-1] / r.residuals[0]
    l2 = flag._l2_error(r.U)
    print(f"solve_refined: inner iterations {r.iterations} in "
          f"{len(r.residuals) - 1} rounds, converged {r.converged}, rel "
          f"{rel:.3e}, L2 {l2:.6e}, solve {r.solve_seconds:.4f} s")
    assert r.converged and rel <= 1e-8, rel
    assert abs(l2 / REF_VAR_FLAGSHIP["l2_f64"] - 1.0) <= 0.01, l2
    var_path("varcoef2d 513^2 f32",
             sum(x.iterations for x in runs) + r.iterations, L, f32, legs=f64)
    del flag, runs, r
    torch.cuda.empty_cache()

    n, J = REF_VAR_F64["n"], REF_VAR_F64["levels"]
    phase(f"17 varcoef2d {n + 1}^2 x {2 ** J} steps, f64, solve(tol=1e-8)")
    s = build_solver("varcoef2d", n, J, dtype=f64, device="cuda", inner="mg",
                     mg_coarse=8)
    s.assemble_rhs_host()
    paths.start()
    r = s.solve(tol=1e-8)
    rel = r.residuals[-1] / r.residuals[0]
    print(f"iterations {r.iterations} (JAX CPU {REF_VAR_F64['iterations']}), "
          f"converged {r.converged}, rel {rel:.3e}, L2 {r.l2_error:.10e} "
          f"(JAX CPU {REF_VAR_F64['l2']:.10e}), solve {r.solve_seconds:.4f} s")
    assert r.converged and rel <= 1e-8, rel
    assert r.iterations == REF_VAR_F64["iterations"], r.iterations
    assert abs(r.l2_error / REF_VAR_F64["l2"] - 1.0) <= 1e-6, r.l2_error
    var_path("varcoef2d f64", r.iterations, len(s.msmg.levels), f64)
    del s

    n, J = REF_VAR3D["n"], REF_VAR3D["levels"]
    phase(f"18 weighted mg kernels K10-K15 (3-D) against their twins; the "
          f"varcoef3d {n + 1}^3 x {2 ** J} solver's setup")
    t0 = time.perf_counter()
    var3 = build_solver("varcoef3d", n, J, dtype=f32, device="cuda")
    assert var3.spatial_format == "vstencil" and var3.inner == "mg"
    msmg = var3.msmg
    print(f"setup {time.perf_counter() - t0:.2f} s ({(var3.N + 1) * var3.m:,} "
          f"DoF, levels {[lev.n for lev in msmg.levels]}, grids "
          f"{[lev.gs for lev in msmg.levels]}, coarse {msmg.n_coarse}; "
          f"taps {msmg.levels[0].A_vs.disps})", flush=True)
    rng = np.random.default_rng(SEED + 5)
    for dtype in (f32, f64):
        for T, gs, lvl in VAR_SHAPES_3D:
            for nu in (1, 2, 3):
                kl = VarMSKernelLevel(msmg.levels[lvl], nu, gs=gs)
                x = var_inputs(msmg, kl, T, dtype, rng, lvl)
                check_forms(kl, var_forms(kl, x), var_bound, T, dtype,
                            mg_results, pairs=semi_pairs(kl, x, True))
                del x
                torch.cuda.empty_cache()

    phase(f"19 varcoef3d {n + 1}^3 x {2 ** J} steps, f32, inner mg")
    t0 = time.perf_counter()
    var3.assemble_rhs_host()
    L = len(msmg.levels)
    print(f"loads {time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    paths.start()
    runs = []
    for call in (1, 2):
        r = var3.solve(tol=1e-6, compute_error=False)
        rel = r.residuals[-1] / r.residuals[0]
        print(f"solve call {call}: iterations {r.iterations} (JAX CPU "
              f"{REF_VAR3D['iterations']}), converged {r.converged}, rel "
              f"{rel:.3e}, solve {r.solve_seconds:.4f} s", flush=True)
        assert r.converged and rel <= 1e-6, rel
        assert abs(r.iterations - REF_VAR3D["iterations"]) <= 1, r.iterations
        runs.append(r)
    print(f"steady solve: {runs[1].solve_seconds:.4f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    t0 = time.perf_counter()
    l2 = var3._l2_error(runs[0].U)
    print(f"L2(IxOmega) {l2:.6e} (JAX CPU {REF_VAR3D['l2']:.6e}), host error "
          f"loop {time.perf_counter() - t0:.2f} s")
    assert abs(l2 / REF_VAR3D["l2"] - 1.0) <= REF_VAR3D["l2_band"], l2
    r = var3.solve_refined(tol=1e-8, compute_error=False)
    rel = r.residuals[-1] / r.residuals[0]
    print(f"solve_refined: inner iterations {r.iterations} in "
          f"{len(r.residuals) - 1} rounds, converged {r.converged}, rel "
          f"{rel:.3e}, solve {r.solve_seconds:.4f} s")
    assert r.converged and rel <= 1e-8, rel
    var_path("varcoef3d 65^3 f32",
             sum(x.iterations for x in runs) + r.iterations, L, f32,
             legs=f64, dim=3)
    del var3, runs, r
    torch.cuda.empty_cache()

    n, J = REF_VAR3D_F64["n"], REF_VAR3D_F64["levels"]
    phase(f"20 varcoef3d {n + 1}^3 x {2 ** J} steps, f64, solve(tol=1e-8)")
    s = build_solver("varcoef3d", n, J, dtype=f64, device="cuda", inner="mg")
    s.assemble_rhs_host()
    paths.start()
    r = s.solve(tol=1e-8)
    rel = r.residuals[-1] / r.residuals[0]
    print(f"iterations {r.iterations} (JAX CPU {REF_VAR3D_F64['iterations']}),"
          f" converged {r.converged}, rel {rel:.3e}, L2 {r.l2_error:.10e} "
          f"(JAX CPU {REF_VAR3D_F64['l2']:.10e}), solve {r.solve_seconds:.4f} s")
    assert r.converged and rel <= 1e-8, rel
    assert r.iterations == REF_VAR3D_F64["iterations"], r.iterations
    assert abs(r.l2_error / REF_VAR3D_F64["l2"] - 1.0) <= 1e-6, r.l2_error
    var_path("varcoef3d f64", r.iterations, len(s.msmg.levels), f64, dim=3)
    del s

    n, J = REF_VAR_V21["n"], REF_VAR_V21["levels"]
    phase(f"21 weighted V(2,1): varcoef2d {n + 1}^2 x {2 ** J} steps with "
          "mg_nu_post=1, f32")
    v21 = build_solver("varcoef2d", n, J, dtype=f32, device="cuda",
                       mg_nu_post=1)
    v21.assemble_rhs_host()
    paths.start()
    r = v21.solve(tol=1e-6)
    rel = r.residuals[-1] / r.residuals[0]
    print(f"solve: iterations {r.iterations} (JAX CPU "
          f"{REF_VAR_V21['iterations']}), converged {r.converged}, rel "
          f"{rel:.3e}, L2 {r.l2_error:.6e} (JAX CPU {REF_VAR_V21['l2']:.6e}),"
          f" solve {r.solve_seconds:.4f} s")
    assert r.converged and rel <= 1e-6, rel
    assert abs(r.iterations - REF_VAR_V21["iterations"]) <= 1, r.iterations
    assert abs(r.l2_error / REF_VAR_V21["l2"] - 1.0) <= 0.01, r.l2_error
    its = r.iterations
    r = v21.solve_refined(tol=1e-8, compute_error=False)
    print(f"solve_refined: inner iterations {r.iterations} in "
          f"{len(r.residuals) - 1} rounds, converged {r.converged}")
    assert r.converged, r.residuals
    var_path("weighted V(2,1)", its + r.iterations, len(v21.msmg.levels),
             f32, legs=f64, semi=True)
    del v21

    lsh, ell_results = phase_k20(build_solver, spmv)
    phase_chains(build_solver, mg_results)
    phase_nu_paths(build_solver, paths)
    phase_oracle_rows(build_solver, paths)
    phase_lshape(lsh, paths)
    nst, amg, flat_results = phase_flat_kernels(build_solver, lsh, spmv)
    del lsh
    phase_flat_solves(build_solver, nst, amg, paths)
    del nst, amg
    phase_v21_3d(build_solver, paths)
    phase_singular(build_solver, paths)
    sh_results = phase_sharded_kernels(msmg2, msmg3)
    mesh_launches = {}  # kernel name -> launches on the meshes' ranks
    phase_meshes(serial, mesh_launches)
    phase(None)

    kernels = []
    for (op, dtype), k in kron.KERNELS.items():
        rec = results[(op, dtype)]
        at = f"stab {shape_key(*FLAGSHIP_KRON)}"
        kernels.append({
            "name": k.name,
            "route": "cuda",
            "source": kron.SOURCE,
            "replaces": k.replaces,
            "launches": paths.total((op, dtype)),
            "max_abs_err": rec["max_abs_err"],
            **{key: rec["forms"][at][key] for key in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "form": f"stab (apply_S) at T={FLAGSHIP_KRON[0]}, "
                    f"{FLAGSHIP_KRON[1][0]}x{FLAGSHIP_KRON[1][1]}; "
                    "the other forms under forms",
            "forms": rec["forms"],
        })
    main_form = {"smooth": "smooth", "residual": "residual", "apply": "apply_A",
                 "fused_pre": "fused_pre", "fused_post": "fused_post",
                 "residual_restrict": "residual_restrict",
                 "prolong_correct": "prolong_correct",
                 "smooth_var": "smooth", "residual_var": "residual",
                 "apply_var": "apply_A",
                 "residual_restrict_var": "residual_restrict",
                 "fused_pre_var": "fused_pre", "fused_post_var": "fused_post",
                 "cheb_step": "smooth", "cheb_step_var": "smooth"}
    sh_main = {"sh_smooth": "smooth", "sh_fused_pre": "fused_pre",
               "sh_fused_post": "fused_post",
               "sh_residual_restrict": "residual_restrict",
               "sh_prolong_correct": "prolong_correct"}
    for (op, dtype, dim), k in mg_kernels.KERNELS.items():
        if op in mg_kernels.SHARDED_OPS:
            rec = sh_results[(op, dtype, dim)]
            sl = SH_SLABS[dim]
            T, gs = sl["T"][0], (sl["own"] + 2 * SH_H,) + sl["rest"]
            at = rec["forms"][f"{sh_main[op]} {shape_key(T, gs)}"]
            kernels.append({
                "name": k.name,
                "route": "cuda",
                "source": mg_kernels.SOURCE,
                "replaces": k.replaces,
                "launches": mesh_launches.get(k.name, 0),
                "max_abs_err": rec["max_abs_err"],
                **{key: at[key] for key in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
                "form": f"{sh_main[op]}, nu=2, on the (2 x 2) mesh's finest "
                        f"slab: own={sl['own']}, h={SH_H}, T={T}, "
                        f"{'x'.join(map(str, gs))}; launches on the mesh "
                        "ranks of phases 34-36",
                "forms": rec["forms"],
            })
            continue
        rec = mg_results[(op, dtype, dim)]
        chained = op.startswith("cheb_step")
        T, gs = (CHAIN_MAIN[dim] if chained else
                 MG_MAIN[("var" if op.endswith("_var") else "const", dim)])
        nu = CHAIN_SHAPES[dim][0][2] if chained else 2
        at = rec["forms"][f"{main_form[op]} {shape_key(T, gs)}"]
        kernels.append({
            "name": k.name,
            "route": "cuda",
            "source": mg_kernels.SOURCE,
            "replaces": k.replaces,
            "launches": paths.total((op, dtype, dim)),
            "max_abs_err": rec["max_abs_err"],
            **{key: at[key] for key in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "form": f"{main_form[op]}, nu={nu}, at T={T}, "
                    f"{'x'.join(map(str, gs))}",
            "forms": rec["forms"],
        })
    m_fine = {"smooth": "smooth from x", "residual": "residual",
              "apply": "apply"}
    flat_forms = {
        ("spmm", "ell"): ("A n=256 T=64", spmv.SOURCE,
                          "A of the lshape2d n=256 solve (m=48641) at T=64; "
                          "library_ms is torch.sparse.mm (cuSPARSE CSR), "
                          "bound_ms from the nonzeros"),
        ("spmm_pair", "ell"): (f"pair T={PAIR_T[0]} m=8191", spmv.SOURCE,
                               f"the AMG n=256 ELL level (m=8191) at "
                               f"T={PAIR_T[0]}; library_ms is two "
                               "torch.sparse.mm (cuSPARSE CSR), bound_ms "
                               "from the nonzeros"),
        **{(op, "dia"): (f"{form} T={DIA_T[0]} m=", dia_kernels.SOURCE,
                         f"{form}, nu=2, at the nested fine level at "
                         f"T={DIA_T[0]}")
           for op, form in m_fine.items()},
    }
    for module, fam in ((spmv, "ell"), (dia_kernels, "dia")):
        for (op, dtype), k in module.KERNELS.items():
            at_key, source, form = flat_forms[(op, fam)]
            rec = (ell_results[dtype] if op == "spmm"
                   else flat_results[(op, dtype)])
            # the one timed shape of the key's prefix
            at = next(v for f, v in rec["forms"].items()
                      if f.startswith(at_key))
            kernels.append({
                "name": k.name,
                "route": "cuda",
                "source": source,
                "replaces": k.replaces,
                "launches": paths.total((op, dtype)),
                "max_abs_err": rec["max_abs_err"],
                **{key: at[key] for key in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
                "form": form,
                "forms": rec["forms"],
            })
    assert all(k["launches"] > 0 for k in kernels), [
        k["name"] for k in kernels if not k["launches"]]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
