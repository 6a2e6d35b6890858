"""The fused stages K6, K7, K14 and K15, or K1 and K2, or K4 and K5, or
K16 and K17, or K11 and K12, against an earlier tree's, on one GPU; the
solves against the earlier tree's; the callers of the solves' copies.

    python -m spacetime_tpu_torch.tools.fused_ab --parent DIR [--dims 2,3]
        [--family const,var] [--chunks] [--kron [--pencils]] [--stencil]
        [--dia] [--var-stencil] [--solves [2d|3d|flat|all|NAME][,...]
        [--solves-only] [--traces TDIR]] [--copies]

DIR is the root of another checkout of the repository (an unpacked
``git archive`` of an earlier commit, say). Its ``csrc/mg.cu`` and
``csrc/common.cu`` are built with nvcc into ``DIR/build/parent_mg/`` as one
library and loaded beside this tree's kernels, which load as every caller
loads them (``ops.native``). Of DIR's library the tool binds the fused
entry points ``mg_fused_pre``, ``mg_fused_pre_var``, ``mg_fused_post``,
``mg_fused_post_var``, ``mg_sh_fused_pre`` and ``mg_sh_fused_post`` (f32
and f64) with the signatures of a tree whose fused stages all take the
march's chunk (the 2-D K6/K7/K14/K15 ignoring it), and its K4/K5
``mg_residual`` and ``mg_apply`` with those before their march (no
chunk), and its K11/K12 ``mg_residual_var`` and ``mg_apply_var`` with
those before their time march (no chunk) or, where DIR's library has
``mg_var_stencil_occupancy``, with the chunk; each fused stage gets the
chunk this tree's wrapper picks.

- ``kernels`` (always), ν ∈ {2, 3}, float32 and float64: in 2-D (``--dims``
  2) K6 and K7 at 129×511², 129×255² and 65×127² (the 2-D flagship's
  levels at K_X's rows), the sharded K6 and K7 at the (2 × 2) flagship's
  finest slab 65×(256 + 2h)×511 (own 256, h = ν + 1, the mesh's halo), K14
  and K15 at 129×511², 129×255² and 65×127² (varcoef2d weights tiled to
  them); in 3-D (``--dims``
  3) K6 and K7 at 65×63³ and 65×127³, K14 and K15 at 33×63³ and 33×127³
  (the varcoef3d 65³ solver's finest weights, tiled to 127³), the sharded
  K7 at the (2 × 2) smooth3d 65³ mesh's finest slab 17×38×63² (own 32, h
  3); ``--family`` const (K6, K7 and the sharded forms) or var (K14,
  K15) alone. Each launch of this tree and of DIR on the same inputs, max|new −
  old| and both held to the plain twin within 1e-5·max|twin| (f32) and
  1e-13 (f64); median device times of new, old and the semi-fused pair (K3
  from 0 + K8, K9 + K3 from x, K10 from 0 + K13, K9 + K10 from x; none for
  the sharded forms, whose mesh path runs K8/K9 on the own planes only)
  in the order old, new, pair, new, old. Also the blocks per SM of each
  march instantiation (the 2-D ones on rows of 511 columns) and ptxas's
  registers and spills of the 2-D march kernels.
- ``--chunks``: the 2-D K6, K7, K14 and K15 of this tree at the chunk of
  rows the wrapper picks (``ops.mg_kernels.march2_chunk``) and at half and
  twice it, at the 2-D shapes, f32 and f64, ν ∈ {2, 3}.
- ``--kron`` (in place of ``kernels``): DIR's ``csrc/kron.cu`` and
  ``csrc/common.cu`` built into ``DIR/build/parent_kron/``, its K1/K2
  bound with the signatures before the time march; every form (B, B
  stab, Bᵀ, Bᵀ stab), f32 and f64, at ``KRON_AB_SHAPES`` (the 2-D
  flagship, the (2 × 2) mesh's halo-extended slab, cfg2, 129³×64 and
  65³×32): max|new − old|, both held to the twin, median device times
  old, new, new, old, the plan (pencil, chunk) and ptxas's registers;
  with ``--pencils`` this tree's time at each pencil too.
- ``--stencil`` (in place of ``kernels``): K4 and K5 against DIR's
  (bound with the signatures before their march, ``bind_parent``) at
  ``STENCIL_AB_SHAPES``, float32 and float64: max|new − old|, both held
  to the twin, median device times old, new, twin, new, old, the HBM
  bound, the chunk and blocks an SM, and ptxas's registers.
- ``--dia`` (in place of ``kernels``): K16 (from 0 and from x, ν ∈ {2,
  3}) and K17 against DIR's ``csrc/dia.cu`` (built into
  ``DIR/build/parent_dia/``, bound with the signatures before the time
  march, ``bind_parent_dia``) at ``DIA_AB``: the nested lshape2d 25.2 MDoF
  solve's fine level at T = 129 and 128 and its second level at 129, the
  AMG n = 256 DIA level at T = 65 and 64; float32 and float64. max|new −
  old|, both held to the twin, median device times old, new, twin, new,
  old, the HBM bound, the plan (where the values are held, chunk,
  threads, blocks an SM) and ptxas's registers; with ``--chunks`` this
  tree's time at half and twice the chunk too.
- ``--var-stencil`` (in place of ``kernels``): K11 and K12 against DIR's
  at ``VAR_STENCIL_AB_SHAPES`` (varcoef2d 513²'s two finest levels and
  129²'s at K_X's rows, a row of four segments, varcoef3d 65³'s finest at
  33 and 65 rows and 127³, W past the L2), float32 and float64: max|new −
  old|, both held to the twin, median device times old, new, twin, new,
  old, the HBM bound, the plan (chunk, blocks an SM, blocks a chunk,
  shared bytes) and ptxas's registers; with ``--chunks`` this
  tree's time at half and twice the chunk too.
- ``--solves``: steady ``solve`` seconds, f32, ``inner="mg"`` unless the
  solve names another, by ``run.py --repeat 3`` in DIR, this tree, this
  tree, DIR (one process each; see ``run_solves``): 2d (the default)
  varcoef2d 513²×128 (its K14/K15 march in y since the 2-D weighted
  redesign), the controls smooth2d 513²×128 and singular2d 513² J7+6
  (they launch no weighted kernel), and cfg2 (129²×64); 3d smooth3d,
  varcoef3d and singular3d 65³ J5+4 and smooth3d 129³×64 (``--repeat
  2``); flat the nested lshape2d 32 cells refined 4×, J = 7 (25.2 MDoF,
  K16–K18) and AMG lshape2d n = 256, J = 6; v21 the weighted V(2,1)
  cycles (``--mg-nu-post 1``: K10 → K13 → K9 → K10) of varcoef2d
  129²×64 and 513²×128; or solves by name, and these, comma-separated. ``--solves-only`` skips the fused stages; ``--traces
  TDIR`` traces varcoef2d 513², smooth2d 513², smooth3d 129³ and the
  nested lshape2d in their second run of this tree.
- ``--copies``: the steady f32 ``solve`` of smooth2d 513²×128 and
  singular2d 513² J7+6 traced by ``torch.profiler``, the solver's
  functions labelled (``record_function``) for the trace alone; prints
  the calls and device time of ``aten::copy_`` by its innermost labelled
  caller and the op that issued it, and the busy device time of the
  solve.

Prints one JSON line per measurement and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import functools
import inspect
import itertools
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..ops import native
from ..ops.mg_kernels import MSKernelLevel, VarMSKernelLevel
from ..ops.multigrid import row_params, var_row_params
from ..utils.profiling import device_ms

REPO = Path(__file__).resolve().parents[2]
TOL = {torch.float32: 1e-5, torch.float64: 1e-13}
HBM_BYTES_PER_MS = 3.35e9  # the H100 SXM's HBM3, 3.35 TB/s (data sheet)
# (T, grid) of K6/K7 and of K14/K15, by dimension
CONST_SHAPES = {2: [(129, (511, 511)), (129, (255, 255)), (65, (127, 127))],
                3: [(65, (63,) * 3), (65, (127,) * 3)]}
VAR_SHAPES = {2: [(129, (511, 511)), (129, (255, 255)), (65, (127, 127))],
              3: [(33, (63,) * 3), (33, (127,) * 3)]}
# (T, own, h, the other extents) of the sharded stages' slab (h 0: ν + 1)
SLABS = {2: (65, 256, 0, (511,)), 3: (17, 32, 3, (63, 63))}
SOLVES = {
    "2d": [
        ("varcoef2d", ["--problem", "varcoef2d", "--space-n", "512",
                       "--time-levels", "7"]),
        ("smooth2d", ["--space-n", "512", "--time-levels", "7"]),
        ("singular2d", ["--problem", "singular2d", "--space-n", "512",
                        "--time-levels", "7", "--extra-levels", "6"]),
        ("cfg2", ["--space-n", "128", "--time-levels", "6"]),
    ],
    "3d": [
        ("smooth3d", ["--problem", "smooth3d", "--space-n", "64",
                      "--time-levels", "5"]),
        ("varcoef3d", ["--problem", "varcoef3d", "--space-n", "64",
                       "--time-levels", "5"]),
        ("singular3d", ["--problem", "singular3d", "--space-n", "64",
                        "--time-levels", "5", "--extra-levels", "4"]),
        # the 3-D flagship, 129³×64: two solves a run (its loads take
        # minutes)
        ("smooth3d-129", ["--problem", "smooth3d", "--space-n", "128",
                          "--time-levels", "6", "--repeat", "2"]),
    ],
    # the weighted V(2,1) cycles, K10 → K13 → K9 → K10 on every level
    "v21": [
        ("varcoef2d-v21", ["--problem", "varcoef2d", "--space-n", "128",
                           "--time-levels", "6", "--mg-nu-post", "1"]),
        ("varcoef2d-513-v21", ["--problem", "varcoef2d", "--space-n", "512",
                               "--time-levels", "7", "--mg-nu-post", "1"]),
    ],
    "flat": [
        ("nested-lshape2d", ["--problem", "lshape2d", "--space-n", "32",
                             "--refine", "4", "--time-levels", "7"]),
        ("amg-lshape2d", ["--problem", "lshape2d", "--space-n", "256",
                          "--time-levels", "6", "--inner", "amg"]),
    ],
}
# the solves --copies traces: (problem, cells, time levels, extra levels)
COPY_TRACES = [("smooth2d", 512, 7, 0), ("singular2d", 512, 7, 6)]
# (T, grid) of the K1/K2 A/B: the 2-D flagship, a rank's halo-extended
# slab on its (2 × 2) mesh (256 + 2 rows), cfg2, the 129³×64 and 65³×32
# solves (chip_smoke.py phase 4's timed shapes)
KRON_AB_SHAPES = [(128, (511, 511)), (64, (258, 511)), (64, (127, 127)),
                  (64, (127,) * 3), (32, (63,) * 3)]
KRON_FORMS = ("B", "B_stab", "BT", "BT_stab")
# (T, grid) of the K4/K5 A/B: the 2-D flagship's two finest levels and
# cfg2's at K_X's rows, a rank's halo-extended slab on the (2 × 2)
# flagship mesh (own 256, kw = ν + 1 = 3; parallel/explicit2d.py), rows
# wider than one segment (three, the last ragged), the 129³×64 solve's
# finest level and the 65³×32 solve's at K_X's and K_Y's rows
STENCIL_AB_SHAPES = [(129, (511, 511)), (129, (255, 255)), (65, (127, 127)),
                     (65, (262, 511)), (33, (255, 1985)), (65, (127,) * 3),
                     (65, (63,) * 3), (33, (63,) * 3)]


def build_parent(parent: Path) -> ctypes.CDLL:
    """DIR's csrc/mg.cu and csrc/common.cu as one library, its fused entry
    points bound with their signatures of that tree (see the module's
    docstring)."""
    out = parent / "build" / "parent_mg"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libparent_mg.so"
    csrc = parent / "spacetime_tpu_torch" / "csrc"
    cmd = [native._nvcc(), *native.ARCH_FLAGS, "-std=c++17", "-O3",
           "-Xcompiler", "-fPIC", "-shared", "-o", str(lib),
           str(csrc / "mg.cu"), str(csrc / "common.cu")]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    return bind_parent(ctypes.CDLL(str(lib)))


def bind_parent(so: ctypes.CDLL) -> ctypes.CDLL:
    """The parent's fused entry points, its K4/K5 and its K11/K12 of
    library ``so``, bound with that tree's signatures."""
    P, I64, I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    grid = [I64, I64, I64, I64, I]
    signatures = {
        "mg_fused_pre": [P] * 7 + grid + [P, I, I, P],
        "mg_fused_pre_var": [P] * 7 + grid + [P, P, I, I, P],
        "mg_fused_post": [P] * 8 + grid + [P, I, I, P],
        "mg_fused_post_var": [P] * 8 + grid + [P, P, I, I, P],
        "mg_sh_fused_pre": [P] * 8 + grid + [P, I, I, I, I, P],
        "mg_sh_fused_post": [P] * 9 + grid + [P, I, I, I, I, I, P],
        # K4 and K5 before their march: no chunk
        "mg_residual": [P] * 4 + grid + [P, P],
        "mg_apply": [P] * 2 + grid + [P, P],
    }
    # K11 and K12: before their time march no chunk; a tree with the march
    # has its occupancy entry point
    chunk = [I] if hasattr(so, "mg_var_stencil_occupancy") else []
    signatures["mg_residual_var"] = [P] * 5 + grid + [P, P] + chunk + [P]
    signatures["mg_apply_var"] = [P] * 3 + grid + [P] + chunk + [P]
    # K10 before its time march: the tiled sweep (x, b, W, the columns,
    # out, the grid, the tables, ν, zero_init) and the chained step
    if hasattr(so, "mg_cheb_step_var_f32"):
        D = ctypes.c_double
        signatures["mg_smooth_var"] = [P] * 7 + grid + [P, P, I, I, P]
        signatures["mg_cheb_step_var"] = [P] * 10 + grid + [P, P, I, D, D,
                                                             P]
    for sfx in ("f32", "f64"):
        for name, argtypes in signatures.items():
            fn = getattr(so, f"{name}_{sfx}")
            fn.argtypes, fn.restype = argtypes, I
    return so


def bind_parent_kron(so: ctypes.CDLL) -> ctypes.CDLL:
    """The parent's K1/K2 entry points ``kron_B`` and ``kron_BT`` (f32 and
    f64) of library ``so``, bound with the signatures of a tree whose
    kernels take no plan (csrc/kron.cu before the time march)."""
    P, I64, I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    signatures = {"kron_B": [P] * 5 + [I64] * 4 + [P, P, I, P],
                  "kron_BT": [P] * 4 + [I64] * 4 + [P, P, I, P]}
    for sfx in ("f32", "f64"):
        for name, argtypes in signatures.items():
            fn = getattr(so, f"{name}_{sfx}")
            fn.argtypes, fn.restype = argtypes, I
    return so


def build_parent_kron(parent: Path) -> ctypes.CDLL:
    """DIR's csrc/kron.cu and csrc/common.cu as one library, its K1/K2
    bound with that tree's signatures (``bind_parent_kron``)."""
    out = parent / "build" / "parent_kron"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libparent_kron.so"
    csrc = parent / "spacetime_tpu_torch" / "csrc"
    cmd = [native._nvcc(), *native.ARCH_FLAGS, "-std=c++17", "-O3",
           "-Xcompiler", "-fPIC", "-shared", "-o", str(lib),
           str(csrc / "kron.cu"), str(csrc / "common.cu")]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    return bind_parent_kron(ctypes.CDLL(str(lib)))


def kron_forms(kron, taps, x, so) -> dict:
    """{form: (this tree's launch, the twin, the parent's launch)} of K1
    and K2 on the inputs ``x``, the parent's from library ``so``; each
    returns a tuple of tensors."""
    U, V, W, hh, hs = x["U"], x["V"], x["W"], x["hh"], x["hs"]
    T, gs = V.shape[0], taps.gs
    tM, tA = (ctypes.addressof(t) for t in taps.structs)
    sfx = "f32" if V.dtype == torch.float32 else "f64"
    out = {"B": V.new_empty(V.shape), "W": V.new_empty(V.shape),
           "BT": V.new_empty((T + 1,) + gs)}

    def old_B(stab):
        _call(so, f"kron_B_{sfx}", U.data_ptr(), hh.data_ptr(),
              hs.data_ptr() if stab else None, out["B"].data_ptr(),
              out["W"].data_ptr() if stab else None, T, *taps.zyx(), tM, tA,
              stab)
        return (out["B"], out["W"]) if stab else (out["B"],)

    def old_BT(stab):
        _call(so, f"kron_BT_{sfx}", V.data_ptr(), hh.data_ptr(),
              W.data_ptr() if stab else None, out["BT"].data_ptr(), T,
              *taps.zyx(), tM, tA, stab)
        return (out["BT"],)

    return {
        "B": (lambda: (kron.apply_B(U, hh, taps),),
              lambda: (kron.apply_B_plain(U, hh, taps),),
              lambda: old_B(0)),
        "B_stab": (lambda: kron.apply_B_stab(U, hh, hs, taps),
                   lambda: kron.apply_B_stab_plain(U, hh, hs, taps),
                   lambda: old_B(1)),
        "BT": (lambda: (kron.apply_BT(V, hh, taps),),
               lambda: (kron.apply_BT_plain(V, hh, taps),),
               lambda: old_BT(0)),
        "BT_stab": (lambda: (kron.apply_BT_stab(V, W, hh, taps),),
                    lambda: (kron.apply_BT_stab_plain(V, W, hh, taps),),
                    lambda: old_BT(1)),
    }


def kron_inputs(taps, T, dtype, rng) -> dict:
    """U (T+1, *gs), V and W (T, *gs) and the h/2, h/16 columns of a random
    positive h, on the card."""
    mk = _fields(rng, dtype)
    h = torch.as_tensor(rng.uniform(0.5, 1.5, T) / T, dtype=dtype,
                        device="cuda")
    gs = taps.gs
    return {"U": mk((T + 1,) + gs), "V": mk((T,) + gs), "W": mk((T,) + gs),
            "hh": 0.5 * h, "hs": h / 16.0}


def run_kron(parent: Path, pencils: bool) -> None:
    """K1 and K2 of this tree against DIR's at ``KRON_AB_SHAPES``, every
    form, f32 and f64: max|new − old|, both held to the twin, the median
    device times old, new, new, old; with ``pencils``, this tree's time at
    each pencil (4, 8) beside the one the wrapper picks."""
    import dataclasses

    from ..ops import kron
    from ..solver import build_solver

    so = build_parent_kron(parent)
    native.LIB.get()
    entry = None  # ptxas's registers and spills of each K1/K2 kernel
    for line in native.LIB.build_log.splitlines():
        if "Compiling entry" in line:
            m = re.search(r"(kron_BT?_kernel\w*?E[fd])E", line)
            entry = m.group(1) if m else None
        elif entry and ("Used" in line or "spill" in line):
            print("ptxas:", entry, line.split(":", 1)[-1].strip(), flush=True)
    taps_of = {dim: build_solver("smooth3d" if dim == 3 else "smooth2d", 8, 1,
                                 dtype=torch.float32, device="cuda",
                                 inner="mg").taps for dim in (2, 3)}
    rng = np.random.default_rng(14)
    for dtype, (T, gs) in itertools.product((torch.float32, torch.float64),
                                            KRON_AB_SHAPES):
        taps = dataclasses.replace(taps_of[len(gs)], gs=gs)
        x = kron_inputs(taps, T, dtype, rng)
        for form, (new_fn, twin_fn, old_fn) in kron_forms(kron, taps, x,
                                                          so).items():
            bt, stab = form.startswith("BT"), form.endswith("stab")
            new, twin = tuple(t.clone() for t in new_fn()), twin_fn()
            old = old_fn()
            torch.cuda.synchronize()
            rec = {"kernel": "K2" if bt else "K1", "form": form, "T": T,
                   "gs": list(gs), "dtype": str(dtype)[6:],
                   "plan": list(kron.kron_plan(bt, stab, dtype, gs, T, 0)),
                   "max_abs_new_old": max(_err(a, b)
                                          for a, b in zip(new, old))}
            for name, got in (("new", new), ("old", old)):
                errs = [(_err(g, w), float(w.abs().max()))
                        for g, w in zip(got, twin)]
                rec[f"max_abs_{name}_twin"] = max(e for e, _ in errs)
                assert all(e <= TOL[dtype] * sc for e, sc in errs), (
                    form, name, errs)
            del new, old, twin
            times = {"old": [], "new": []}
            for which in ("old", "new", "new", "old"):
                times[which].append(device_ms(new_fn if which == "new"
                                              else old_fn))
            rec.update({f"{k}_ms": float(np.mean(v)) for k, v in
                        times.items()})
            rec["new_ms_runs"], rec["old_ms_runs"] = times["new"], times["old"]
            if pencils:
                key = (bt, len(gs), dtype)
                picked = kron.PENCIL[key]
                rec["pencil_ms"] = {}
                for pencil in (4, 8):
                    kron.PENCIL[key] = pencil
                    rec["pencil_ms"][pencil] = [
                        device_ms(new_fn),
                        list(kron.kron_plan(bt, stab, dtype, gs, T, 0)),
                        kron.kron_occupancy(bt, stab, dtype, gs, pencil, 0)]
                kron.PENCIL[key] = picked
            _emit(rec)
        del x
        torch.cuda.empty_cache()


def run_stencil(parent: Path) -> None:
    """K4 and K5 of this tree against DIR's (before their march: no chunk)
    at ``STENCIL_AB_SHAPES``, float32 and float64: max|new − old|, both
    held to the twin, median device times old, new, twin, new, old, the
    HBM bound (each input read once, the output written once), the chunk
    and blocks an SM; ptxas's registers of each K4/K5 kernel."""
    from ..ops import mg_kernels
    from ..solver import build_solver

    so = build_parent(parent)
    native.LIB.get()
    entry = None
    for line in native.LIB.build_log.splitlines():
        if "Compiling entry" in line:
            m = re.search(r"(mg_stencil_kernel\w*?Lb[01]E)", line)
            entry = m.group(1) if m else None
        elif entry and ("Used" in line or "spill" in line):
            print("ptxas:", entry, line.split(":", 1)[-1].strip(), flush=True)
    msmg = {dim: build_solver("smooth3d" if dim == 3 else "smooth2d", 8, 1,
                              dtype=torch.float32, device="cuda",
                              inner="mg").msmg for dim in (2, 3)}
    rng = np.random.default_rng(15)
    for dtype, (T, gs) in itertools.product((torch.float32, torch.float64),
                                            STENCIL_AB_SHAPES):
        sfx = "f32" if dtype == torch.float32 else "f64"
        s = torch.finfo(dtype).bits // 8
        lev = msmg[len(gs)].levels[0]
        kl = MSKernelLevel(lev.A_st, lev.M_st, 2, gs=gs)
        mk = _fields(rng, dtype)
        x, b = mk((T,) + gs), mk((T,) + gs)
        cols = kl.columns(row_params(
            msmg[len(gs)], np.abs(rng.standard_normal(T)) * 20, dtype,
            "cuda")[0])
        out = torch.empty_like(x)
        m = T * int(np.prod(gs))

        def old_res():
            _call(so, f"mg_residual_{sfx}", x.data_ptr(), b.data_ptr(),
                  cols["omega"].data_ptr(), out.data_ptr(), T, *kl._zyx(),
                  kl._op_table())
            return (out,)

        def old_apply():
            _call(so, f"mg_apply_{sfx}", x.data_ptr(), out.data_ptr(), T,
                  *kl._zyx(), ctypes.addressof(kl.structs[1]))
            return (out,)

        for label, res, new_fn, old_fn, twin_fn, nbytes in (
                ("K4", True, lambda: (kl.residual(x, b, cols),), old_res,
                 lambda: (kl.residual_plain(x, b, cols),), s * (3 * m + T)),
                ("K5", False, lambda: (kl.apply_A(x),), old_apply,
                 lambda: (kl.apply_A_plain(x),), s * 2 * m)):
            resident, tiles = mg_kernels.stencil_plan(
                res, kl.dim, dtype, gs[-2:], x.device.index)
            compare(label, kl, T, dtype, new_fn, old_fn, twin_fn,
                    extra={"chunk": kl._stencil_chunk(x, res),
                           "blocks_per_sm": resident, "tiles": tiles,
                           "bound_ms": nbytes / HBM_BYTES_PER_MS},
                    time_twin=True)
        del x, b, out
        torch.cuda.empty_cache()


# (T, grid) of the K11/K12 A/B: the varcoef2d 513² solve's two finest
# levels and its 129² run's finest at K_X's rows, a row of four segments,
# the varcoef3d 65³ solve's finest level at K_X's and at 65 rows, and the
# 129³×32 solve's finest (W, 123 MB in float32, past the L2)
VAR_STENCIL_AB_SHAPES = [(129, (511, 511)), (129, (255, 255)),
                         (65, (127, 127)), (33, (255, 1985)),
                         (33, (63,) * 3), (65, (63,) * 3), (33, (127,) * 3)]


def run_var_stencil(parent: Path, chunks: bool) -> None:
    """K11 and K12 of this tree against DIR's (bound by ``bind_parent``)
    at ``VAR_STENCIL_AB_SHAPES``, float32 and float64, W of the varcoef
    solvers' finest level tiled to each: max|new − old|, both held to the
    twin, median device times old, new, twin, new, old, the HBM bound
    (x, b and the output once, W once), the plan (chunk, blocks an SM,
    blocks a chunk, threads, shared bytes: past 7 taps the weights' tile);
    with ``chunks`` this tree's time at
    half and twice its chunk too; ptxas's registers of each kernel."""
    from ..ops import mg_kernels

    so = build_parent(parent)
    native.LIB.get()
    entry = None
    for line in native.LIB.build_log.splitlines():
        if "Compiling entry" in line:
            m = re.search(r"(mg_var_stencil_kernel\w*?Li\d+ELb[01]E)", line)
            entry = m.group(1) if m else None
        elif entry and ("Used" in line or "spill" in line):
            print("ptxas:", entry, line.split(":", 1)[-1].strip(), flush=True)
    var = {dim: var_hierarchy(dim) for dim in (2, 3)}
    rng = np.random.default_rng(11)
    for dtype, (T, gs) in itertools.product((torch.float32, torch.float64),
                                            VAR_STENCIL_AB_SHAPES):
        sfx = "f32" if dtype == torch.float32 else "f64"
        s = torch.finfo(dtype).bits // 8
        ms = var[len(gs)]
        kl = VarMSKernelLevel(ms.levels[0], 2, gs=gs)
        W = tiled_weights(ms, gs, dtype)
        mk = _fields(rng, dtype)
        x, b = mk((T,) + gs), mk((T,) + gs)
        cols = kl.columns(var_row_params(
            ms, np.abs(rng.standard_normal(T)) * 20, dtype, "cuda")[0])
        out = torch.empty_like(x)
        m, nw = T * int(np.prod(gs)), W.numel()
        tables = kl._tables()

        def old_res(chunk=()):
            _call(so, f"mg_residual_var_{sfx}", x.data_ptr(), b.data_ptr(),
                  W.data_ptr(), cols["omega"].data_ptr(), out.data_ptr(), T,
                  *kl._zyx(), *tables, *chunk)
            return (out,)

        def old_apply(chunk=()):
            _call(so, f"mg_apply_var_{sfx}", x.data_ptr(), W.data_ptr(),
                  out.data_ptr(), T, *kl._zyx(), tables[0], *chunk)
            return (out,)

        ntaps = len(kl.A_vs.disps)
        for label, res, new_fn, old_fn, twin_fn, nbytes in (
                ("K11", "residual", lambda: (kl.residual(x, b, cols, W),),
                 old_res, lambda: (kl.residual_plain(x, b, cols, W),),
                 s * (3 * m + nw + T)),
                ("K12", "apply", lambda: (kl.apply_A(x, W),), old_apply,
                 lambda: (kl.apply_A_plain(x, W),), s * (2 * m + nw))):
            resident, tiles, smem, threads = mg_kernels.var_stencil_plan(
                res, kl.dim, dtype, ntaps, gs, x.device.index)
            chunk = kl._var_stencil_chunk(x, res)
            # a parent with the march takes the chunk too
            old_chunk = ((chunk,) if hasattr(so, "mg_var_stencil_occupancy")
                         else ())
            extra = {"chunk": chunk, "blocks_per_sm": resident,
                     "tiles": tiles, "threads": threads, "smem_bytes": smem,
                     "bound_ms": nbytes / HBM_BYTES_PER_MS}
            if chunks:
                extra["chunk_ms"] = {}
                for c in sorted({max(chunk // 2, 1), chunk, min(2 * chunk, T)}):
                    kl._var_stencil_chunk = lambda *_, c=c: c
                    extra["chunk_ms"][c] = device_ms(new_fn)
                del kl._var_stencil_chunk
            compare(label, kl, T, dtype, new_fn,
                    lambda f=old_fn: f(old_chunk), twin_fn, extra=extra,
                    time_twin=True)
        del x, b, out, W
        torch.cuda.empty_cache()


# (label, level of the solver, T) of the K16–K18 A/B: the nested 25.2 MDoF
# solve's fine level at K_X's 129 rows and K_Y's 128 and its second level
# at 129 (nested), the AMG n = 256 solve's DIA fine level at 65 and 64
# (amg), the nested tetrahedra's fine level (smooth3d 8 cells refined 2×,
# 15 offsets) and a synthetic level of 20 offsets (the shared tile) on as
# many dofs as the nested fine level, at 129
DIA_AB = [("nested", 0, 129), ("nested", 0, 128), ("nested", 1, 129),
          ("amg", 0, 65), ("amg", 0, 64), ("tet", 0, 129),
          ("synthetic", 0, 129)]


def bind_parent_dia(so: ctypes.CDLL) -> ctypes.CDLL:
    """The parent's K16, K17 and K18 entry points ``dia_smooth``,
    ``dia_residual`` and ``dia_apply`` (f32 and f64) of library ``so``,
    bound with that tree's signatures: K16 and K17 with the march's last
    and chunk where the library has ``dia_march_occupancy``, else without;
    K18 with the chunk where its march takes the apply mode (4)."""
    P, I64, I, D = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_double
    march = hasattr(so, "dia_march_occupancy")
    signatures = {"dia_smooth": [P] * 13 + [I64, I64, P, I, D, D]
                  + ([I, I] if march else []) + [P],
                  "dia_residual": [P] * 6 + [I64, I64, P]
                  + ([I] if march else []) + [P],
                  "dia_apply": [P] * 3 + [I64, I64, P]
                  + ([I] if parent_dia_apply_marches(so) else []) + [P]}
    for sfx in ("f32", "f64"):
        for name, argtypes in signatures.items():
            fn = getattr(so, f"{name}_{sfx}")
            fn.argtypes, fn.restype = argtypes, I
    return so


def parent_dia_apply_marches(so) -> bool:
    """Whether library ``so``'s K18 is a mode of the DIA march (it takes a
    chunk): its ``dia_march_occupancy`` knows mode 4."""
    if not hasattr(so, "dia_march_occupancy"):
        return False
    out = [ctypes.c_int() for _ in range(3)]
    fn = so.dia_march_occupancy
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    return fn(4, 0, 11, *map(ctypes.byref, out)) == 0


def build_parent_dia(parent: Path) -> ctypes.CDLL:
    """DIR's csrc/dia.cu and csrc/common.cu as one library, its K16/K17
    bound with that tree's signatures (``bind_parent_dia``)."""
    out = parent / "build" / "parent_dia"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libparent_dia.so"
    csrc = parent / "spacetime_tpu_torch" / "csrc"
    cmd = [native._nvcc(), *native.ARCH_FLAGS, "-std=c++17", "-O3",
           "-Xcompiler", "-fPIC", "-shared", "-o", str(lib),
           str(csrc / "dia.cu"), str(csrc / "common.cu")]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    return bind_parent_dia(ctypes.CDLL(str(lib)))


def dia_columns(lev, T, dtype, device, rng) -> dict:
    """ω (every other row 0, the rest up to ~300), 1/θ and 1/δ of a DIA
    level's Chebyshev bounds at each ω, as (T,) tensors."""
    mk = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    omega = np.abs(rng.standard_normal(T)) * 100.0
    omega[::2] = 0.0
    lam = 1.1 * np.array([((lev.rsA + w * lev.rsM) / (lev.dA + w * lev.dM))
                          .max() for w in omega])
    return {"omega": mk(omega), "invT": mk(1.0 / (0.625 * lam)),
            "invDel": mk(1.0 / (0.375 * lam))}


def dia_lib_smooth(call, so, kl, x, b, cols, vals, nu, zero_init,
                   chunk=None):
    """K16's sweep by library ``so``'s ``dia_smooth`` entry point (``call``
    passes the stream): with ``chunk`` this tree's, at that chunk of rows;
    without, a parent's from before the march."""
    T = b.shape[0]
    sfx = "f32" if b.dtype == torch.float32 else "f64"
    out, r = torch.empty_like(b), torch.empty_like(b)
    d = (torch.empty_like(b), torch.empty_like(b))
    fields = (b.data_ptr(), vals["vA"].data_ptr(), vals["vM"].data_ptr(),
              vals["dA"].data_ptr(), vals["dM"].data_ptr(),
              *(cols[n].data_ptr() for n in ("omega", "invT", "invDel")))

    def step(mode, d_in, d_out, c1, c2, last):
        tail = [] if chunk is None else [int(last), chunk]
        call(so, f"dia_smooth_{sfx}",
             x.data_ptr() if mode == "first" else None, *fields, r.data_ptr(),
             None if d_in is None else d[d_in].data_ptr(),
             d[d_out].data_ptr(), out.data_ptr(), T, kl.m,
             ctypes.addressof(kl.struct), int(mode != "step"), c1, c2, *tail)

    kl.sweep(step, nu, zero_init)
    return out


def dia_lib_apply(call, so, kl, x, vals, chunk=None):
    """K18 by library ``so``'s ``dia_apply`` (as ``dia_lib_smooth``: with
    ``chunk`` a march's, at that chunk of rows; without, one from before
    the march)."""
    sfx = "f32" if x.dtype == torch.float32 else "f64"
    out = torch.empty_like(x)
    call(so, f"dia_apply_{sfx}", x.data_ptr(), vals["vA"].data_ptr(),
         out.data_ptr(), x.shape[0], kl.m, ctypes.addressof(kl.struct),
         *(() if chunk is None else (chunk,)))
    return out


def var_lib_smooth(call, so, kl, x, b, W, cols, nu, zero_init, chunk=None):
    """K10's sweep of ``nu`` steps by library ``so`` (``call`` passes the
    stream): with ``chunk`` (time rows, or a function of a launch's mode
    and ``last`` giving them) this tree's launches (``mg_smooth_var``, from
    0 the first two steps in one); without, an earlier tree's chained steps
    (``mg_cheb_step_var``, one thread a point)."""
    from ..ops.mg_kernels import _VAR_FIRST, chebyshev_launches

    T = b.shape[0]
    sfx = "f32" if b.dtype == torch.float32 else "f64"
    out, r = torch.empty_like(b), torch.empty_like(b)
    d = (torch.empty_like(b), torch.empty_like(b))
    cp = [cols[k].data_ptr() for k in kl._COLS]

    def step(mode, d_in, d_out, c1, c2, last):
        args = (x.data_ptr() if mode == "first" else None, b.data_ptr(),
                W.data_ptr(), *cp, r.data_ptr(),
                None if d_in is None else d[d_in].data_ptr(),
                d[d_out].data_ptr(), out.data_ptr(), T, *kl._zyx(),
                *kl._tables(), _VAR_FIRST[mode], c1, c2)
        if chunk is None:
            call(so, f"mg_cheb_step_var_{sfx}", *args)
        else:
            call(so, f"mg_smooth_var_{sfx}", *args, int(last),
                 chunk(mode, last) if callable(chunk) else chunk)

    chebyshev_launches(step, nu, zero_init, first_two=chunk is not None)
    return out


def dia_lib_residual(call, so, kl, x, b, cols, vals, chunk=None):
    """K17 by library ``so``'s ``dia_residual`` (as ``dia_lib_smooth``)."""
    sfx = "f32" if b.dtype == torch.float32 else "f64"
    out = torch.empty_like(b)
    call(so, f"dia_residual_{sfx}", x.data_ptr(), b.data_ptr(),
         vals["vA"].data_ptr(), vals["vM"].data_ptr(),
         cols["omega"].data_ptr(), out.data_ptr(), b.shape[0], kl.m,
         ctypes.addressof(kl.struct), *(() if chunk is None else (chunk,)))
    return out


def dia_bound_ms(form: str, kl, T: int, dtype) -> float:
    """The HBM bound of K16 (ν = kl.nu, from x or from 0), K17 or K18 at T
    rows: each field read once and the output written once, the values
    (and K16's diagonals) once, at 3.35 TB/s."""
    sz, m, nd = torch.finfo(dtype).bits // 8, kl.m, len(kl.offsets)
    if form == "apply":
        return sz * (2 * T * m + nd * m) / HBM_BYTES_PER_MS
    if form == "residual":
        return sz * (3 * T * m + 2 * nd * m + T) / HBM_BYTES_PER_MS
    fields = 2 if form == "smooth from 0" else 3
    return sz * (fields * T * m + (2 * nd + 2) * m + 3 * T) / HBM_BYTES_PER_MS


def run_dia(parent: Path, chunks: bool) -> None:
    """K16, K17 and K18 of this tree against DIR's at ``DIA_AB``, float32
    and float64, K16 at ν ∈ {2, 3}: max|new − old|, both held to the twin,
    median device times old, new, twin, new, old, the bound, the plan and,
    with ``chunks``, this tree's time at half and twice its chunk; K18
    beside ``torch.sparse.mm`` (A in CSR) at the nested fine level;
    ptxas's registers of each march kernel. DIR's K16/K17 take the chunk
    this tree picks where they march (``bind_parent_dia``)."""
    import types

    from ..ops import dia_kernels as dk
    from ..solver import build_solver
    from .cpu_emulate import synthetic_level

    so = build_parent_dia(parent)
    old_march = hasattr(so, "dia_march_occupancy")
    old_apply_march = parent_dia_apply_marches(so)
    lib = native.LIB.get()
    entry = None
    for line in native.LIB.build_log.splitlines():
        if "Compiling entry" in line:
            m = re.search(r"(dia_march_kernelI[fd]Li\d+ELi\d+E)", line)
            entry = m.group(1) if m else None
        elif entry and ("Used" in line or "spill" in line):
            print("ptxas:", entry, line.split(":", 1)[-1].strip(), flush=True)
    t0 = time.perf_counter()
    solvers = {
        "nested": build_solver("lshape2d", 32, 7, dtype=torch.float32,
                               device="cuda", refine=4, inner="mg"),
        "amg": build_solver("lshape2d", 256, 6, dtype=torch.float32,
                            device="cuda", inner="amg"),
        "tet": build_solver("smooth3d", 8, 3, dtype=torch.float32,
                            device="cuda", refine=2, inner="mg"),
    }
    m_fine = solvers["nested"].m
    synth = synthetic_level(20, m_fine)
    solvers["synthetic"] = types.SimpleNamespace(
        msmg=types.SimpleNamespace(levels=[synth]),
        _kl_ky=[dk.DiaKernelLevel(synth, 2)])
    print(f"setup {time.perf_counter() - t0:.2f} s", flush=True)
    rng = np.random.default_rng(17)
    for dtype, (name, li, T) in itertools.product(
            (torch.float32, torch.float64), DIA_AB):
        lev = solvers[name].msmg.levels[li]
        base = solvers[name]._kl_ky[li]
        assert base.kind == "dia", (name, li)
        vals = base.values(lev, dtype, "cuda")
        cols = dia_columns(lev, T, dtype, "cuda", rng)
        mk = _fields(rng, dtype)
        x, b = mk((T, lev.m)), mk((T, lev.m))
        nd = len(base.offsets)
        old_c = lambda kl, mode, on: kl.plan(mode, b)["chunk"] if on else None
        cases = [("apply", 2, "apply", lambda kl: (
            lambda: (kl.apply_A(x, vals),),
            lambda: (dia_lib_apply(_call, so, kl, x, vals,
                                   old_c(kl, "apply", old_apply_march)),),
            lambda: (kl.apply_A_plain(x, vals),),
            lambda c: (dia_lib_apply(_call, lib, kl, x, vals, c),)))]
        cases.append(("residual", 2, "residual", lambda kl: (
            lambda: (kl.residual(x, b, cols, vals),),
            lambda: (dia_lib_residual(_call, so, kl, x, b, cols, vals,
                                      old_c(kl, "residual", old_march)),),
            lambda: (kl.residual_plain(x, b, cols, vals),),
            lambda c: (dia_lib_residual(_call, lib, kl, x, b, cols, vals,
                                        c),))))
        for nu, zero in itertools.product((2, 3), (True, False)):
            cases.append(("step", nu,
                          "smooth from 0" if zero else "smooth from x",
                          lambda kl, z=zero: (
                lambda: (kl.smooth(x, b, cols, vals, zero_init=z),),
                lambda: (dia_lib_smooth(_call, so, kl, x, b, cols, vals,
                                        kl.nu, z,
                                        old_c(kl, "step", old_march)),),
                lambda: (kl.smooth_plain(x, b, cols, vals, zero_init=z),),
                lambda c: (dia_lib_smooth(_call, lib, kl, x, b, cols, vals,
                                          kl.nu, z, c),))))
        for mode, nu, form, fns in cases:
            kl = dk.DiaKernelLevel(lev, nu)
            new_fn, old_fn, twin_fn, plan_fn = fns(kl)
            plan = kl.plan(mode, b)
            extra = {"level": f"{name} L{li} m={lev.m}", "form": form,
                     "nd": nd, "plan": plan,
                     "bound_ms": dia_bound_ms(form, kl, T, dtype)}
            if chunks:
                # every launch at the chunk of ``mode`` (a sweep's later
                # steps, K17 or K18), halved and doubled; K18 also at 1 to
                # 8 rows (its rows are latency-bound where a level has few
                # segments)
                c = plan["chunk"]
                ks = {max(c // 2, 1), c, min(2 * c, T)}
                if mode == "apply":
                    ks |= {k for k in (1, 2, 4, 8) if k < T}
                extra["chunk_ms"] = {k: device_ms(lambda k=k: plan_fn(k))
                                     for k in sorted(ks)}
            if mode == "apply" and name == "nested" and li == 0:
                extra["library_ms"] = device_ms(
                    sparse_apply(lev, dtype, x))
            label = {"apply": "K18", "residual": "K17"}.get(mode, "K16")
            compare(label, kl, T, dtype, new_fn, old_fn, twin_fn,
                    extra=extra, time_twin=True)
        del x, b, vals
        torch.cuda.empty_cache()


def sparse_apply(lev, dtype, x):
    """K18's library call: ``torch.sparse.mm`` with the level's A in CSR
    on the card, on x's rows as columns."""
    import scipy.sparse as sp

    m = lev.Av.shape[0]
    rows = np.repeat(np.arange(m), len(lev.offA))
    cols = rows + np.tile(np.asarray(lev.offA), m)
    keep = (cols >= 0) & (cols < m) & (lev.Av.ravel() != 0)
    A = sp.csr_matrix((lev.Av.ravel()[keep], (rows[keep], cols[keep])),
                      shape=(m, m))
    A_sp = torch.sparse_csr_tensor(
        torch.as_tensor(A.indptr, dtype=torch.int64),
        torch.as_tensor(A.indices, dtype=torch.int64),
        torch.as_tensor(A.data, dtype=dtype), size=A.shape).to("cuda")
    xt = x.t().contiguous()
    return lambda: (torch.sparse.mm(A_sp, xt),)


# (T, grid) of the K10 A/B: the varcoef2d 513² solve's two finest levels and
# its 129² run's finest at K_X's rows, a row of eight segments, the
# varcoef3d 65³ solve's finest level and the 129³×32 solve's (W past the
# L2); ν 1, 2, 3 from x and from 0, and the ν above the old tiled kernel
VAR_SWEEP_AB_SHAPES = [(129, (511, 511)), (129, (255, 255)), (65, (127, 127)),
                       (33, (255, 1985)), (33, (63,) * 3), (33, (127,) * 3)]
VAR_SWEEP_CHAINED = {2: 9, 3: 4}
# where the K15 march stands in for K10 from x at ν = 2 (e_c = 0)
MARCH_AS_K10 = [(129, (511, 511)), (33, (127,) * 3)]
# (T, grid) where K10 is held to DIR's chain bit for bit on both tables of
# ``cpu_emulate.sweep_levels`` (the varcoef weights and the other home's),
# ν 1–5 from x and from 0, at chunks of 1, 3 and T rows: ragged 2-D and 3-D
# grids, a row of five segments
VAR_SWEEP_EXACT = [(9, (15, 31)), (5, (33, 1055)), (5, (7, 9, 15)),
                   (9, (17, 33, 65))]


def var_sweep_exact(so, lib) -> None:
    """K10 of library ``lib`` (this tree's, launched as its wrapper does)
    against DIR's chained steps (``so``) bit for bit at
    ``VAR_SWEEP_EXACT``, float32 and float64; prints one JSON line a case
    and a summary of the cases that differ."""
    from .cpu_emulate import sweep_levels

    rng = np.random.default_rng(1)
    cases = differ = 0
    for dtype, (T, gs) in itertools.product((torch.float32, torch.float64),
                                            VAR_SWEEP_EXACT):
        mk = _fields(rng, dtype)
        x, b = mk((T,) + gs), mk((T,) + gs)
        for (lev, Wn, var), nu, zero in itertools.product(
                sweep_levels(len(gs), gs), range(1, 6), (False, True)):
            kl = VarMSKernelLevel(lev, nu, gs=gs)
            W = torch.as_tensor(Wn, dtype=dtype, device="cuda")
            cols = kl.columns(var_row_params(
                var, np.abs(rng.standard_normal(T)) * 20, dtype, "cuda")[0])
            old = var_lib_smooth(_call, so, kl, x, b, W, cols, nu, zero)
            errs = {c: _err(var_lib_smooth(_call, lib, kl, x, b, W, cols, nu,
                                           zero, c), old)
                    for c in sorted({1, 3, T})}
            cases += 1
            differ += any(errs.values())
            _emit({"kernel": "K10 exact", "T": T, "gs": list(gs),
                   "taps": len(lev.A_vs.disps), "nu": nu,
                   "form": "from 0" if zero else "from x",
                   "dtype": str(dtype)[6:], "max_abs_new_old": errs})
    _emit({"kernel": "K10 exact", "cases": cases, "differ": differ})


def run_var_sweep(parent: Path, chunks: bool) -> None:
    """K10 of this tree (its step launches on the time march) against DIR's
    chained steps (``mg_cheb_step_var``: bit for bit, max|new − old|; first
    at the small ragged ``VAR_SWEEP_EXACT`` on both homes of the weights,
    every chunk kind, ``var_sweep_exact``) and
    DIR's tiled sweep (``mg_smooth_var`` within its ν: max|new − tiled|),
    both held to the twin, at ``VAR_SWEEP_AB_SHAPES``, float32 and float64,
    ν = 1, 2, 3 from x and from 0 and ν = 9 (2-D) / 4 (3-D): median device
    times old (the chain), new, tiled (as "pair"), twin, new, old, the
    HBM bound (x, b and the output once, W once), each launch's plan; with
    ``chunks`` this tree's time with every step at half and twice the
    later step's chunk. At ``MARCH_AS_K10``, ν = 2 from x, the time of
    this tree's K15 with e_c = 0 (its march computing a K10 from x, less
    the prolongation's arithmetic but reading e_c) beside K10's."""
    from ..ops import mg_kernels

    so = build_parent(parent)
    lib = native.LIB.get()
    entry = None
    for line in native.LIB.build_log.splitlines():
        if "Compiling entry" in line:
            m = re.search(r"(mg_var_stencil_kernel\w*?Li\d+ELb[01]E)", line)
            entry = m.group(1) if m else None
        elif entry and ("Used" in line or "spill" in line):
            print("ptxas:", entry, line.split(":", 1)[-1].strip(), flush=True)
    var_sweep_exact(so, lib)
    var = {dim: var_hierarchy(dim) for dim in (2, 3)}
    rng = np.random.default_rng(10)
    for dtype, (T, gs) in itertools.product((torch.float32, torch.float64),
                                            VAR_SWEEP_AB_SHAPES):
        sfx = "f32" if dtype == torch.float32 else "f64"
        sz = torch.finfo(dtype).bits // 8
        dim = len(gs)
        ms = var[dim]
        W = tiled_weights(ms, gs, dtype)
        mk = _fields(rng, dtype)
        x, b = mk((T,) + gs), mk((T,) + gs)
        omega = np.abs(rng.standard_normal(T)) * 20
        m, nw = T * int(np.prod(gs)), W.numel()
        for nu, zero in itertools.chain(
                itertools.product((1, 2, 3), (False, True)),
                ((VAR_SWEEP_CHAINED[dim], False),
                 (VAR_SWEEP_CHAINED[dim], True))):
            kl = VarMSKernelLevel(ms.levels[0], nu, gs=gs)
            cols = kl.columns(var_row_params(ms, omega, dtype, "cuda")[0])
            cp = [cols[k].data_ptr() for k in kl._COLS]
            tiled_out = torch.empty_like(b)

            def tiled():
                _call(so, f"mg_smooth_var_{sfx}",
                      None if zero else x.data_ptr(), b.data_ptr(),
                      W.data_ptr(), *cp, tiled_out.data_ptr(), T,
                      *kl._zyx(), *kl._tables(), nu, int(zero))
                return (tiled_out,)

            new_fn = lambda: (kl.smooth(x, b, cols, W, zero_init=zero),)
            old_fn = lambda: (var_lib_smooth(_call, so, kl, x, b, W, cols, nu,
                                             zero),)
            twin_fn = lambda: (kl.smooth_plain(x, b, cols, W,
                                               zero_init=zero),)
            in_tile = nu <= mg_kernels.MAX_NU[dim]
            launches = []
            mg_kernels.chebyshev_launches(
                lambda mode, d_in, d_out, c1, c2, last: launches.append(
                    (mode, last)), nu, zero, first_two=True)
            plans = []
            for mode, last in launches:
                resident, tiles, smem, _ = mg_kernels.var_stencil_plan(
                    mode, dim, dtype, len(kl.A_vs.disps), gs, 0)
                plans.append({"mode": mode, "last": last,
                              "chunk": kl._var_stencil_chunk(x, mode, last),
                              "blocks_per_sm": resident, "tiles": tiles,
                              "smem_bytes": smem})
            extra = {"form": "from 0" if zero else "from x", "plans": plans,
                     "bound_ms": sz * ((2 if zero else 3) * m + nw + 3 * T)
                     / HBM_BYTES_PER_MS}
            if in_tile:
                torch.cuda.synchronize()
                extra["max_abs_new_tiled"] = _err(new_fn()[0], tiled()[0])
            if chunks:
                c = plans[-1]["chunk"]
                extra["chunk_ms"] = {}
                for k in sorted({max(c // 2, 1), c, min(2 * c, T)}):
                    extra["chunk_ms"][k] = device_ms(
                        lambda k=k: (var_lib_smooth(_call, lib, kl, x, b, W,
                                                    cols, nu, zero, k),))
            compare("K10", kl, T, dtype, new_fn, old_fn, twin_fn,
                    pair_fn=tiled if in_tile else None, extra=extra,
                    time_twin=True)
            if (T, gs) in MARCH_AS_K10 and nu == 2 and not zero:
                ec = torch.zeros((T,) + kl.coarse_gs, dtype=dtype,
                                 device="cuda")
                march = lambda: (kl.fused_post(x, b, ec, cols, W),)
                _close_twin = _err(march()[0], twin_fn()[0])
                k10 = device_ms(new_fn)
                k15 = device_ms(march)
                _emit({"kernel": "K15 march as K10 from x", "T": T,
                       "gs": list(gs), "nu": 2, "dtype": str(dtype)[6:],
                       "max_abs_twin": _close_twin, "march_ms": k15,
                       "k10_ms": k10, "k10_again_ms": device_ms(new_fn),
                       "march_again_ms": device_ms(march)})
        del x, b, W
        torch.cuda.empty_cache()


def _call(so, name, *args):
    err = getattr(so, name)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: error {err}")


def _emit(rec: dict) -> None:
    print(json.dumps(rec), flush=True)


def _err(got, want) -> float:
    return float((got - want).abs().max())


def compare(label, kl, T, dtype, new_fn, old_fn, twin_fn, pair_fn=None,
            extra=None, time_twin=False) -> None:
    """new against old and both against the twin; times (tuples of fields
    from each function), the twin's too with ``time_twin``."""
    new, old, twin = new_fn(), old_fn(), twin_fn()
    torch.cuda.synchronize()
    rec = {"kernel": label, "T": T,
           "gs": list(kl.gs) if hasattr(kl, "gs") else [kl.m], "nu": kl.nu,
           "dtype": str(dtype)[6:], **(extra or {})}
    rec["max_abs_new_old"] = max(_err(a, b) for a, b in zip(new, old))
    for name, got in (("new", new), ("old", old)):
        errs = [(_err(g, w), float(w.abs().max())) for g, w in zip(got, twin)]
        rec[f"max_abs_{name}_twin"] = max(e for e, _ in errs)
        assert all(e <= TOL[dtype] * s for e, s in errs), (label, name, errs)
    del new, old, twin
    fns = {"old": old_fn, "new": new_fn, "pair": pair_fn,
           "twin": twin_fn if time_twin else None}
    times = {"old": [], "new": []}
    for which in ("old", "new", "pair", "twin", "new", "old"):
        if fns[which] is not None:
            times.setdefault(which, []).append(device_ms(fns[which]))
    rec.update({f"{k}_ms": float(np.mean(v)) for k, v in times.items()})
    rec["new_ms_runs"], rec["old_ms_runs"] = times["new"], times["old"]
    _emit(rec)


def occupancy() -> None:
    lib = native.LIB.get()
    # var 2: K15's instantiation that takes the row first (W beyond the L2)
    for (post, var), nu, f64 in ((pv, n, f) for pv in ((0, 0), (0, 1), (1, 0),
                                                       (1, 1), (1, 2))
                                 for n in (2, 3) for f in (0, 1)):
        blocks, nbytes = ctypes.c_int(), ctypes.c_int()
        err = lib.mg_march_occupancy(post, var, nu, f64, ctypes.byref(blocks),
                                     ctypes.byref(nbytes))
        native.check(lib, "mg_march_occupancy", err)
        _emit({"march": ("K7", "K15", "K15 row-first")[var] if post
               else ("K14" if var else "K6"), "nu": nu,
               "dtype": "float64" if f64 else "float32",
               "blocks_per_sm": blocks.value, "smem_bytes": nbytes.value})
    for post, var, nu, f64 in itertools.product((0, 1), (0, 1), (2, 3),
                                                (0, 1)):
        blocks, nbytes, threads, nseg = (ctypes.c_int() for _ in range(4))
        err = lib.mg_march2_occupancy(post, var, nu, f64, 511,
                                      ctypes.byref(blocks),
                                      ctypes.byref(nbytes),
                                      ctypes.byref(threads),
                                      ctypes.byref(nseg))
        native.check(lib, "mg_march2_occupancy", err)
        _emit({"march": "2-D " + (("K7", "K15") if post else ("K6", "K14"))[var],
               "nu": nu, "dtype": "float64" if f64 else "float32", "nx": 511,
               "blocks_per_sm": blocks.value, "smem_bytes": nbytes.value,
               "threads": threads.value})
    entry = None  # ptxas's registers and spills of the 2-D march kernels
    for line in native.LIB.build_log.splitlines():
        if "Compiling entry" in line:
            m = re.search(r"(mg_march2_\w+?_kernel\w*?E[fd])E", line)
            entry = m.group(1) if m else None
        elif entry and ("Used" in line or "spill" in line):
            print("ptxas:", entry, line.split(":", 1)[-1].strip(), flush=True)


def _fields(rng, dtype):
    """A maker of random fields on the card, seeded from ``rng``."""
    gen = torch.Generator(device="cuda").manual_seed(int(rng.integers(1 << 30)))
    return lambda shape: torch.randn(shape, generator=gen, device="cuda",
                                     dtype=dtype)


def run_const(so, lev, msmg, dim, rng) -> None:
    """K6, K7 and the sharded forms (K6 in 2-D, K7) of ``dim``."""
    for dtype in (torch.float32, torch.float64):
        sfx = "f32" if dtype == torch.float32 else "f64"
        mk = _fields(rng, dtype)
        for (T, gs), nu in ((s, n) for s in CONST_SHAPES[dim] for n in (2, 3)):
            kl = MSKernelLevel(lev.A_st, lev.M_st, nu, gs=gs)
            b, x = mk((T,) + gs), mk((T,) + gs)
            ec = mk((T,) + kl.coarse_gs)
            cols = kl.columns(row_params(
                msmg, np.abs(rng.standard_normal(T)) * 20, dtype, "cuda")[0])
            cp = [cols[n].data_ptr() for n in kl._COLS]
            xo, rc = torch.empty_like(b), b.new_empty((T,) + kl.coarse_gs)
            out = torch.empty_like(b)
            pre_chunk = kl._chunk(b, kl.coarse_gs[0])
            post_chunk = kl._chunk(b, gs[0], "post")

            def old_pre():
                _call(so, f"mg_fused_pre_{sfx}", b.data_ptr(), *cp,
                      xo.data_ptr(), rc.data_ptr(), T, *kl._zyx(),
                      kl._op_table(), nu, pre_chunk)
                return xo, rc

            def old_post():
                _call(so, f"mg_fused_post_{sfx}", x.data_ptr(),
                      b.data_ptr(), ec.data_ptr(), *cp, out.data_ptr(), T,
                      *kl._zyx(), kl._op_table(), nu, post_chunk)
                return (out,)

            def pair_pre():
                x0 = kl.smooth(None, b, cols, zero_init=True)
                return x0, kl.residual_restrict(x0, b, cols)

            extra = {"chunk": pre_chunk}
            compare("K6", kl, T, dtype, lambda: kl.fused_pre(b, cols),
                    old_pre, lambda: kl.fused_pre_plain(b, cols), pair_pre,
                    extra)
            extra = {"chunk": post_chunk}
            compare("K7", kl, T, dtype,
                    lambda: (kl.fused_post(x, b, ec, cols),), old_post,
                    lambda: (kl.fused_post_plain(x, b, ec, cols),),
                    lambda: (kl.smooth(kl.prolong_correct(x, ec), b,
                                       cols),), extra)
            del b, x, ec, xo, rc, out
            torch.cuda.empty_cache()
        T, own, h0, rest = SLABS[dim]
        for nu in (2, 3):
            h = max(h0, nu + 1)
            hc = (h + 2) // 2  # the mesh's coarse halo (parallel/explicit2d.py)
            gs = (own + 2 * h,) + rest
            kl = MSKernelLevel(lev.A_st, lev.M_st, nu, gs=gs)
            b, x = mk((T,) + gs), mk((T,) + gs)
            ec = mk((T, own // 2 + 2 * hc) + kl.coarse_gs[1:])
            vm = torch.ones((1,) + gs, dtype=dtype, device="cuda")
            vm[:, :h - 1] = 0  # halo planes beyond the domain
            cols = kl.columns(row_params(
                msmg, np.abs(rng.standard_normal(T)) * 20, dtype, "cuda")[0])
            cp = [cols[n].data_ptr() for n in kl._COLS]
            xo = torch.empty_like(b)
            rc = b.new_empty((T,) + kl._coarse_lead(own // 2))
            out = torch.empty_like(b)
            pre_chunk = kl._chunk(b, own // 2)
            post_chunk = kl._chunk(b, gs[0], "post")
            extra = {"own": own, "h": h, "hc": hc}

            def old_sh_pre():
                _call(so, f"mg_sh_fused_pre_{sfx}", b.data_ptr(),
                      vm.data_ptr(), *cp, xo.data_ptr(), rc.data_ptr(), T,
                      *kl._zyx(), kl._op_table(), nu, own, h, pre_chunk)
                return xo, rc

            def old_sh_post():
                _call(so, f"mg_sh_fused_post_{sfx}", x.data_ptr(),
                      b.data_ptr(), ec.data_ptr(), vm.data_ptr(), *cp,
                      out.data_ptr(), T, *kl._zyx(), kl._op_table(), nu, own,
                      h, hc, post_chunk)
                return (out,)

            if dim == 2:
                compare("K6 sharded", kl, T, dtype,
                        lambda: kl.sh_fused_pre(b, cols, vm, own, h),
                        old_sh_pre,
                        lambda: kl.sh_fused_pre_plain(b, cols, vm, own, h),
                        extra=dict(extra, chunk=pre_chunk))
            compare("K7 sharded", kl, T, dtype,
                    lambda: (kl.sh_fused_post(x, b, ec, cols, vm, own, h,
                                              hc),), old_sh_post,
                    lambda: (kl.sh_fused_post_plain(x, b, ec, cols, vm, own,
                                                    h, hc),),
                    extra=dict(extra, chunk=post_chunk))
            del b, x, ec, xo, rc, out
            torch.cuda.empty_cache()


def var_hierarchy(dim: int):
    """The varcoef solver's Galerkin hierarchy (65³ in 3-D, 129² in 2-D),
    on the card."""
    from ..solver import build_solver

    return build_solver("varcoef3d" if dim == 3 else "varcoef2d",
                        64 if dim == 3 else 128, 5, dtype=torch.float32,
                        device="cuda").msmg


def tiled_weights(var, gs, dtype):
    """W of ``var``'s finest level tiled (or cut) to the grid gs."""
    Aw = var.levels[0].Aw
    grow = [(0, 0)] + [(0, max(n - m, 0)) for n, m in zip(gs, Aw.shape[1:])]
    cut = (slice(None),) + tuple(slice(0, n) for n in gs)
    return torch.as_tensor(np.ascontiguousarray(
        np.pad(Aw, grow, mode="wrap")[cut]), dtype=dtype, device="cuda")


def run_var(so, var, dim, rng) -> None:
    """K14 and K15 of ``dim``: W of the varcoef hierarchy ``var``'s finest
    level tiled to each shape."""
    for dtype in (torch.float32, torch.float64):
        sfx = "f32" if dtype == torch.float32 else "f64"
        mk = _fields(rng, dtype)
        for T, gs in VAR_SHAPES[dim]:
            W = tiled_weights(var, gs, dtype)
            for nu in (2, 3):
                kl = VarMSKernelLevel(var.levels[0], nu, gs=gs)
                b, x = mk((T,) + gs), mk((T,) + gs)
                ec = mk((T,) + kl.coarse_gs)
                cols = kl.columns(var_row_params(
                    var, np.abs(rng.standard_normal(T)) * 20, dtype,
                    "cuda")[0])
                cp = [cols[n].data_ptr() for n in kl._COLS]
                xo, rc = torch.empty_like(b), b.new_empty((T,) + kl.coarse_gs)
                out = torch.empty_like(b)
                pre_chunk = kl._chunk(b, kl.coarse_gs[0])
                post_chunk = kl._chunk(b, gs[0], "post")

                def old_pre():
                    _call(so, f"mg_fused_pre_var_{sfx}", b.data_ptr(),
                          W.data_ptr(), *cp, xo.data_ptr(), rc.data_ptr(), T,
                          *kl._zyx(), *kl._tables(), nu, pre_chunk)
                    return xo, rc

                def old_post():
                    _call(so, f"mg_fused_post_var_{sfx}", x.data_ptr(),
                          b.data_ptr(), ec.data_ptr(), W.data_ptr(), *cp,
                          out.data_ptr(), T, *kl._zyx(), *kl._tables(), nu,
                          post_chunk)
                    return (out,)

                def pair_pre():
                    x0 = kl.smooth(None, b, cols, W, zero_init=True)
                    return x0, kl.residual_restrict(x0, b, cols, W)

                compare("K14", kl, T, dtype,
                        lambda: kl.fused_pre(b, cols, W), old_pre,
                        lambda: kl.fused_pre_plain(b, cols, W), pair_pre,
                        {"chunk": pre_chunk})
                compare("K15", kl, T, dtype,
                        lambda: (kl.fused_post(x, b, ec, cols, W),), old_post,
                        lambda: (kl.fused_post_plain(x, b, ec, cols, W),),
                        lambda: (kl.smooth(kl.prolong_correct(x, ec), b,
                                           cols, W),), {"chunk": post_chunk})
                del b, x, ec, xo, rc, out
                torch.cuda.empty_cache()
            del W


def run_chunks(lev, msmg, var, rng) -> None:
    """This tree's 2-D K6 and K7 (``lev`` of ``msmg``) and K14 and K15 (the
    finest level of ``var``) at the chunk their wrapper picks
    (``march2_chunk``) and at half and twice it."""
    for dtype in (torch.float32, torch.float64):
        mk = _fields(rng, dtype)
        for names, (T, gs), nu in itertools.chain(
                ((("K6", "K7"), s, n) for s in CONST_SHAPES[2]
                 for n in (2, 3)),
                ((("K14", "K15"), s, n) for s in VAR_SHAPES[2]
                 for n in (2, 3))):
            omega = np.abs(rng.standard_normal(T)) * 20
            if names[0] == "K6":
                kl = MSKernelLevel(lev.A_st, lev.M_st, nu, gs=gs)
                cols = kl.columns(row_params(msmg, omega, dtype, "cuda")[0])
                W = ()
            else:
                kl = VarMSKernelLevel(var.levels[0], nu, gs=gs)
                cols = kl.columns(var_row_params(var, omega, dtype,
                                                 "cuda")[0])
                W = (tiled_weights(var, gs, dtype),)
            b, x = mk((T,) + gs), mk((T,) + gs)
            ec = mk((T,) + kl.coarse_gs)
            for stage, n in (("pre", kl.coarse_gs[0]), ("post", gs[0])):
                fn = ((lambda: kl.fused_pre(b, cols, *W)) if stage == "pre"
                      else (lambda: kl.fused_post(x, b, ec, cols, *W)))
                picked = kl._chunk(b, n, stage)
                for chunk in sorted({max(picked // 2, 1), picked,
                                     min(2 * picked, n)}):
                    kl._chunk = lambda *_, c=chunk: c
                    _emit({"kernel": names[stage == "post"],
                           "T": T, "gs": list(gs), "nu": nu,
                           "dtype": str(dtype)[6:], "picked": picked,
                           "chunk": chunk, "ms": device_ms(fn)})
                    del kl._chunk
            del b, x, ec, W
            torch.cuda.empty_cache()


def run_kernels(parent: Path, dims, families, chunks: bool) -> None:
    from ..solver import build_solver

    so = build_parent(parent)
    occupancy()
    rng = np.random.default_rng(0)
    for dim in dims:
        small = build_solver("smooth3d" if dim == 3 else "smooth2d", 8, 1,
                             dtype=torch.float32, device="cuda",
                             inner="mg").msmg
        var = var_hierarchy(dim)
        if "const" in families:
            run_const(so, small.levels[0], small, dim, rng)
        if "var" in families:
            run_var(so, var, dim, rng)
        if dim == 2 and chunks:
            run_chunks(small.levels[0], small, var, rng)


# the solves --solves also traces in this tree, with --traces DIR, and
# those whose runs take the card one at a time (their loads' memory)
TRACED = ("varcoef2d", "smooth2d", "smooth3d-129", "nested-lshape2d")
ALONE = ("smooth3d-129",)
# run.py of the tree in the working directory, given the path P and
# run.py's arguments: after the solver's loads it creates P.ready and waits
# for P.go before it solves
HOLD = """
import os, pathlib, runpy, sys, time
from spacetime_tpu_torch.solver import heateq
hold, loads = sys.argv[1], heateq.HeatSolver.assemble_rhs_host
def held(self, *args, **kwargs):
    out = loads(self, *args, **kwargs)
    pathlib.Path(hold + ".ready").touch()
    while not os.path.exists(hold + ".go"):
        time.sleep(0.05)
    return out
heateq.HeatSolver.assemble_rhs_host = held
sys.argv = ["run.py"] + sys.argv[2:]
runpy.run_module("spacetime_tpu_torch.run", run_name="__main__")
"""


def run_solves(parent: Path, which: str, traces: Path | None = None) -> None:
    """run.py --repeat 3 (or the run's own --repeat) in the parent and this
    tree, in turns: parent, change, change, parent. The runs of a solve
    start two at a time (one at a time where ``ALONE``: their loads fill
    the card's memory), assemble their loads together and solve one after
    the other (``HOLD``), so that no solve shares the card. With
    ``traces``, the second change run of the solves in ``TRACED`` solves
    once more, under ``--profile traces/NAME`` (run.py traces the last
    call); that call is left out of its steady time."""
    import tempfile

    names = which.split(",")
    runs = [r for r in itertools.chain(*SOLVES.values())
            if any(w == "all" or r in SOLVES.get(w, ()) or r[0] == w
                   for w in names)]
    order = (("parent", parent), ("change", REPO), ("change", REPO),
             ("parent", parent))
    with tempfile.TemporaryDirectory() as tmp:
        for name, args in runs:
            step = 1 if name in ALONE else 2
            for first in range(0, len(order), step):
                procs = []
                for k in range(first, first + step):
                    tree, root = order[k]
                    hold = str(Path(tmp) / f"{name}.{k}")
                    traced = traces is not None and k == 2 and name in TRACED
                    repeat = int(dict(zip(args, args[1:])).get("--repeat", 3))
                    extra = (["--repeat", str(repeat + 1), "--profile",
                              str(traces / name)] if traced else [])
                    cmd = [sys.executable, "-c", HOLD, hold, "--device",
                           "cuda", "--dtype", "f32", "--inner", "mg",
                           "--no-error", "--repeat", "3", *args, *extra]
                    procs.append((tree, hold, traced, time.perf_counter(),
                                  subprocess.Popen(
                                      cmd, cwd=root, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True)))
                for tree, hold, _, _, proc in procs:
                    while not Path(hold + ".ready").exists():
                        if proc.poll() is not None:
                            raise RuntimeError(
                                f"{tree} {name}: {proc.stderr.read()[-2000:]}")
                        time.sleep(0.1)
                for tree, hold, traced, t0, proc in procs:
                    Path(hold + ".go").touch()
                    out, err = proc.communicate(timeout=2400)
                    if proc.returncode != 0:
                        raise RuntimeError(f"{tree} {name}: {err[-2000:]}")
                    calls = [(int(i), float(sec)) for i, sec in re.findall(
                        r"solve call \d+: (\d+) iterations, ([0-9.]+) s",
                        out)]
                    timed = calls[1:-1] if traced else calls[1:]
                    rec = {"solve": name, "tree": tree, "iterations":
                           [i for i, _ in calls], "seconds": [sec for _, sec
                                                              in calls],
                           "steady_s": min(sec for _, sec in timed),
                           "wall_s": time.perf_counter() - t0}
                    if traced:
                        busy = re.search(r"device busy .*", out)
                        rec.update(trace=str(traces / name),
                                   busy=busy.group(0) if busy else None)
                    _emit(rec)


def _device_us(e) -> float:
    """An event's device microseconds, in the names of this and older
    PyTorch versions."""
    for name in ("device_time_total", "cuda_time_total"):
        if hasattr(e, name):
            return float(getattr(e, name))
    return 0.0


LABEL = "copies:"  # the prefix of the tool's record_function labels


@contextlib.contextmanager
def _labelled():
    """Every method of ``HeatSolver`` and of the V-cycles, and the wavelet
    transforms and ``pcg`` as the solver calls them, run inside a
    ``record_function`` range named after them, for as long as the context
    lasts (the solver's own code is restored after)."""
    import torch.autograd.profiler as tap

    from ..ops import multigrid, wavelets
    from ..solver import heateq

    def wrap(fn, name):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with tap.record_function(LABEL + name):
                return fn(*args, **kwargs)
        return run

    targets = [(heateq, "pcg")] + [(wavelets, n) for n in (
        "forward", "adjoint", "_forward_gather", "_adjoint_gather",
        "_gemm_axis0")]
    for cls in (heateq.HeatSolver, multigrid._VCycle, multigrid.MultiShiftMG):
        targets += [(cls, n) for n, v in vars(cls).items()
                    if inspect.isfunction(v) and not n.startswith("__")]
    saved = [(owner, n, getattr(owner, n) if not isinstance(owner, type)
              else vars(owner)[n]) for owner, n in targets]
    try:
        for owner, n, fn in saved:
            setattr(owner, n, wrap(fn, f"{getattr(owner, '__name__', '')}."
                                       f"{n}"))
        yield
    finally:
        for owner, n, fn in saved:
            setattr(owner, n, fn)


def copy_callers(events) -> dict:
    """{(innermost label, the op that called aten::copy_): [calls, device
    µs]} over the profiler's ``events`` (``prof.events()``)."""
    out = {}
    for e in events:
        if e.name != "aten::copy_":
            continue
        parent, op, label = e.cpu_parent, None, "(none)"
        while parent is not None:
            if parent.name.startswith(LABEL):
                label = parent.name[len(LABEL):]
                break
            op = op or parent.name
            parent = parent.cpu_parent
        rec = out.setdefault((label, op or "(python)"), [0, 0.0])
        rec[0] += 1
        rec[1] += _device_us(e)
    return out


def trace_copies(traces=COPY_TRACES, device="cuda") -> None:
    """The callers of aten::copy_ in a steady f32 solve of each of
    ``traces``: every copy's innermost labelled solver function
    (`_labelled`) and the op that issued it, with calls and device time
    (`copy_callers`), beside the solve's busy device time."""
    from torch.autograd import DeviceType

    from ..solver import build_solver

    for problem, n, levels, extra in traces:
        s = build_solver(problem, n, levels, dtype=torch.float32,
                         device=device, extra_time_levels=extra, inner="mg")
        s.assemble_rhs_host(torch.float32)
        s.solve(tol=1e-6, compute_error=False)  # warm
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device == "cuda":
            torch.cuda.synchronize()
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with _labelled(), torch.profiler.profile(activities=acts) as prof:
            res = s.solve(tol=1e-6, compute_error=False)
            if device == "cuda":
                torch.cuda.synchronize()
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not e.is_user_annotation)
        callers = copy_callers(prof.events())
        _emit({"copies": problem, "iterations": res.iterations,
               "busy_device_us": busy,
               "copy_device_us": sum(v[1] for v in callers.values()),
               "copy_calls": sum(v[0] for v in callers.values())})
        for (label, op), (calls, us) in sorted(callers.items(),
                                              key=lambda kv: -kv[1][1]):
            _emit({"copies": problem, "caller": label, "op": op,
                   "calls": calls, "device_us": us,
                   "share_of_busy": us / busy if busy else None})
        del s, prof


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent", required=True, type=Path)
    p.add_argument("--dims", default="2,3",
                   help="the dimensions whose kernels are compared")
    p.add_argument("--family", default="const,var",
                   help="the fused stages compared: const (K6, K7), var "
                        "(K14, K15), comma-separated")
    p.add_argument("--chunks", action="store_true",
                   help="time the 2-D K6/K7 at half and twice their chunk")
    p.add_argument("--solves", nargs="?", const="2d", default=None,
                   help="2d, 3d, all, or solves' names (smooth3d-129, "
                        "say), comma-separated")
    p.add_argument("--copies", action="store_true")
    p.add_argument("--solves-only", action="store_true",
                   help="skip the fused stages' comparison")
    p.add_argument("--traces", type=Path, default=None,
                   help="with --solves, trace the solves of TRACED into "
                        "DIR/NAME beside the A/B")
    p.add_argument("--kron", action="store_true",
                   help="K1/K2 against DIR's in place of the fused stages")
    p.add_argument("--pencils", action="store_true",
                   help="with --kron, time K1/K2 at each pencil")
    p.add_argument("--stencil", action="store_true",
                   help="K4/K5 against DIR's in place of the fused stages")
    p.add_argument("--dia", action="store_true",
                   help="K16-K18 against DIR's in place of the fused stages")
    p.add_argument("--var-stencil", action="store_true",
                   help="K11/K12 against DIR's in place of the fused stages")
    p.add_argument("--var-sweep", action="store_true",
                   help="K10 against DIR's chained and tiled sweeps in place "
                        "of the fused stages")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("fused_ab needs an NVIDIA GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    dims = [int(d) for d in args.dims.split(",") if d]
    if args.kron:
        run_kron(args.parent.resolve(), args.pencils)
    elif args.stencil:
        run_stencil(args.parent.resolve())
    elif args.dia:
        run_dia(args.parent.resolve(), args.chunks)
    elif args.var_stencil:
        run_var_stencil(args.parent.resolve(), args.chunks)
    elif args.var_sweep:
        run_var_sweep(args.parent.resolve(), args.chunks)
    elif not args.solves_only:
        run_kernels(args.parent.resolve(), dims, args.family.split(","),
                    args.chunks)
    if args.copies:
        trace_copies()
    if args.solves:
        run_solves(args.parent.resolve(), args.solves, args.traces)
    return 0


if __name__ == "__main__":
    sys.exit(main())
