"""The 3-D fused stages K6, K7, K14 and K15 against an earlier tree's, on one
GPU.

    python -m spacetime_tpu_torch.tools.fused_ab --parent DIR [--solves]

DIR is the root of another checkout of the repository (an unpacked
``git archive`` of an earlier commit, say). Its ``csrc/mg.cu`` and
``csrc/common.cu`` are built with nvcc into ``DIR/build/parent_mg/`` as one
library and loaded beside this tree's kernels, which load as every caller
loads them (``ops.native``). Of DIR's library the tool binds the fused
entry points ``mg_fused_pre``, ``mg_fused_pre_var``, ``mg_fused_post``,
``mg_fused_post_var`` and ``mg_sh_fused_post`` (f32 and f64) with the
signatures of a tree whose pre-stages take the march's chunk and whose
post-stages do not (the z-marching K6/K14 and the brick K7/K15); the
pre-stages get the chunk this tree's wrapper picks.

- ``kernels`` (always): K6 and K7 at 65×63³ and 65×127³, K14 and K15 at
  33×63³ and 33×127³ (the varcoef3d 65³ solver's finest weights, tiled to
  127³), the sharded K7 at the (2 × 2) smooth3d 65³ mesh's finest slab
  17×38×63² (own 32, h 3), ν ∈ {2, 3}, float32 and float64. Each launch of
  this tree and of DIR on the same inputs, max|new − old| and both held to
  the plain twin within 1e-5·max|twin| (f32) and 1e-13 (f64); median
  device times of new, old and the semi-fused pair (K3 from 0 + K8, K9 + K3
  from x, K10 from 0 + K13, K9 + K10 from x; none for the sharded K7,
  whose mesh path runs K9 on the own planes only) in the order old, new,
  pair, new, old. Also the blocks per SM of each march instantiation.
- ``--solves``: steady ``solve`` seconds of smooth3d 65³×32, varcoef3d
  65³×32 and singular3d 65³ J5+4, f32, ``inner="mg"``, by ``run.py
  --repeat 3`` in DIR, this tree, this tree, DIR (one process each).

Prints one JSON line per measurement and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
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
CONST_SHAPES = [(65, (63,) * 3), (65, (127,) * 3)]
VAR_SHAPES = [(33, (63,) * 3), (33, (127,) * 3)]
# (T, own, h, the other extents): the sharded K7's slab
SLAB = (17, 32, 3, (63, 63))
SOLVES = [
    ("smooth3d", ["--problem", "smooth3d", "--space-n", "64",
                  "--time-levels", "5"]),
    ("varcoef3d", ["--problem", "varcoef3d", "--space-n", "64",
                   "--time-levels", "5"]),
    ("singular3d", ["--problem", "singular3d", "--space-n", "64",
                    "--time-levels", "5", "--extra-levels", "4"]),
]


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
    """The parent's fused entry points of library ``so``, bound with that
    tree's signatures."""
    P, I64, I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    grid = [I64, I64, I64, I64, I]
    signatures = {
        "mg_fused_pre": [P] * 7 + grid + [P, I, I, P],
        "mg_fused_pre_var": [P] * 7 + grid + [P, P, I, I, P],
        "mg_fused_post": [P] * 8 + grid + [P, I, P],
        "mg_fused_post_var": [P] * 8 + grid + [P, P, I, P],
        "mg_sh_fused_post": [P] * 9 + grid + [P, I, I, I, I, P],
    }
    for sfx in ("f32", "f64"):
        for name, argtypes in signatures.items():
            fn = getattr(so, f"{name}_{sfx}")
            fn.argtypes, fn.restype = argtypes, I
    return so


def _call(so, name, *args):
    err = getattr(so, name)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: error {err}")


def _emit(rec: dict) -> None:
    print(json.dumps(rec), flush=True)


def _err(got, want) -> float:
    return float((got - want).abs().max())


def compare(label, kl, T, dtype, new_fn, old_fn, twin_fn, pair_fn=None,
            extra=None) -> None:
    """new against old and both against the twin; times (tuples of fields
    from each function)."""
    new, old, twin = new_fn(), old_fn(), twin_fn()
    torch.cuda.synchronize()
    rec = {"kernel": label, "T": T, "gs": list(kl.gs), "nu": kl.nu,
           "dtype": str(dtype)[6:], **(extra or {})}
    rec["max_abs_new_old"] = max(_err(a, b) for a, b in zip(new, old))
    for name, got in (("new", new), ("old", old)):
        errs = [(_err(g, w), float(w.abs().max())) for g, w in zip(got, twin)]
        rec[f"max_abs_{name}_twin"] = max(e for e, _ in errs)
        assert all(e <= TOL[dtype] * s for e, s in errs), (label, name, errs)
    del new, old, twin
    fns = {"old": old_fn, "new": new_fn, "pair": pair_fn}
    times = {"old": [], "new": []}
    for which in ("old", "new", "pair", "new", "old"):
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


def run_const(so, lev, small3, rng) -> None:
    """K6, K7 and the sharded K7."""
    for dtype in (torch.float32, torch.float64):
        sfx = "f32" if dtype == torch.float32 else "f64"
        gen = torch.Generator(device="cuda").manual_seed(int(rng.integers(1 << 30)))
        mk = lambda shape: torch.randn(shape, generator=gen, device="cuda",
                                       dtype=dtype)
        for T, gs in CONST_SHAPES:
            for nu in (2, 3):
                kl = MSKernelLevel(lev.A_st, lev.M_st, nu, gs=gs)
                b, x = mk((T,) + gs), mk((T,) + gs)
                ec = mk((T,) + kl.coarse_gs)
                cols = kl.columns(row_params(
                    small3, np.abs(rng.standard_normal(T)) * 20, dtype,
                    "cuda")[0])
                cp = [cols[n].data_ptr() for n in kl._COLS]
                xo, rc = torch.empty_like(b), b.new_empty((T,) + kl.coarse_gs)
                out = torch.empty_like(b)
                chunk = kl._chunk(T, kl.coarse_gs[0], b.device)

                def old_pre():
                    _call(so, f"mg_fused_pre_{sfx}", b.data_ptr(), *cp,
                          xo.data_ptr(), rc.data_ptr(), T, *kl._zyx(),
                          kl._op_table(), nu, chunk)
                    return xo, rc

                def old_post():
                    _call(so, f"mg_fused_post_{sfx}", x.data_ptr(),
                          b.data_ptr(), ec.data_ptr(), *cp, out.data_ptr(), T,
                          *kl._zyx(), kl._op_table(), nu)
                    return (out,)

                def pair_pre():
                    x0 = kl.smooth(None, b, cols, zero_init=True)
                    return x0, kl.residual_restrict(x0, b, cols)

                compare("K6", kl, T, dtype, lambda: kl.fused_pre(b, cols),
                        old_pre, lambda: kl.fused_pre_plain(b, cols),
                        pair_pre)
                compare("K7", kl, T, dtype,
                        lambda: (kl.fused_post(x, b, ec, cols),), old_post,
                        lambda: (kl.fused_post_plain(x, b, ec, cols),),
                        lambda: (kl.smooth(kl.prolong_correct(x, ec), b,
                                           cols),))
                del b, x, ec, xo, rc, out
                torch.cuda.empty_cache()
        T, own, h, rest = SLAB
        hc = (h + 2) // 2  # the mesh's coarse halo (parallel/explicit2d.py)
        gs = (own + 2 * h,) + rest
        for nu in (2, 3):
            kl = MSKernelLevel(lev.A_st, lev.M_st, nu, gs=gs)
            b, x = mk((T,) + gs), mk((T,) + gs)
            ec = mk((T, own // 2 + 2 * hc) + kl.coarse_gs[1:])
            vm = torch.ones((1,) + gs, dtype=dtype, device="cuda")
            vm[:, :h - 1] = 0  # halo planes beyond the domain
            cols = kl.columns(row_params(
                small3, np.abs(rng.standard_normal(T)) * 20, dtype,
                "cuda")[0])
            cp = [cols[n].data_ptr() for n in kl._COLS]
            out = torch.empty_like(b)

            def old_sh():
                _call(so, f"mg_sh_fused_post_{sfx}", x.data_ptr(),
                      b.data_ptr(), ec.data_ptr(), vm.data_ptr(), *cp,
                      out.data_ptr(), T, *kl._zyx(), kl._op_table(), nu, own,
                      h, hc)
                return (out,)

            compare("K7 sharded", kl, T, dtype,
                    lambda: (kl.sh_fused_post(x, b, ec, cols, vm, own, h,
                                              hc),), old_sh,
                    lambda: (kl.sh_fused_post_plain(x, b, ec, cols, vm, own,
                                                    h, hc),),
                    extra={"own": own, "h": h, "hc": hc})
            del b, x, ec, out


def run_var(so, rng) -> None:
    """K14 and K15."""
    from ..solver import build_solver

    var3 = build_solver("varcoef3d", 64, 5, dtype=torch.float32,
                        device="cuda").msmg
    Aw = var3.levels[0].Aw
    for dtype in (torch.float32, torch.float64):
        sfx = "f32" if dtype == torch.float32 else "f64"
        gen = torch.Generator(device="cuda").manual_seed(int(rng.integers(1 << 30)))
        mk = lambda shape: torch.randn(shape, generator=gen, device="cuda",
                                       dtype=dtype)
        for T, gs in VAR_SHAPES:
            grow = [(0, 0)] + [(0, max(n - m, 0))
                               for n, m in zip(gs, Aw.shape[1:])]
            cut = (slice(None),) + tuple(slice(0, n) for n in gs)
            W = torch.as_tensor(np.ascontiguousarray(
                np.pad(Aw, grow, mode="wrap")[cut]), dtype=dtype,
                device="cuda")
            for nu in (2, 3):
                kl = VarMSKernelLevel(var3.levels[0], nu, gs=gs)
                b, x = mk((T,) + gs), mk((T,) + gs)
                ec = mk((T,) + kl.coarse_gs)
                cols = kl.columns(var_row_params(
                    var3, np.abs(rng.standard_normal(T)) * 20, dtype,
                    "cuda")[0])
                cp = [cols[n].data_ptr() for n in kl._COLS]
                xo, rc = torch.empty_like(b), b.new_empty((T,) + kl.coarse_gs)
                out = torch.empty_like(b)
                chunk = kl._chunk(T, kl.coarse_gs[0], b.device)

                def old_pre():
                    _call(so, f"mg_fused_pre_var_{sfx}", b.data_ptr(),
                          W.data_ptr(), *cp, xo.data_ptr(), rc.data_ptr(), T,
                          *kl._zyx(), *kl._tables(), nu, chunk)
                    return xo, rc

                def old_post():
                    _call(so, f"mg_fused_post_var_{sfx}", x.data_ptr(),
                          b.data_ptr(), ec.data_ptr(), W.data_ptr(), *cp,
                          out.data_ptr(), T, *kl._zyx(), *kl._tables(), nu)
                    return (out,)

                def pair_pre():
                    x0 = kl.smooth(None, b, cols, W, zero_init=True)
                    return x0, kl.residual_restrict(x0, b, cols, W)

                compare("K14", kl, T, dtype,
                        lambda: kl.fused_pre(b, cols, W), old_pre,
                        lambda: kl.fused_pre_plain(b, cols, W), pair_pre)
                compare("K15", kl, T, dtype,
                        lambda: (kl.fused_post(x, b, ec, cols, W),), old_post,
                        lambda: (kl.fused_post_plain(x, b, ec, cols, W),),
                        lambda: (kl.smooth(kl.prolong_correct(x, ec), b,
                                           cols, W),))
                del b, x, ec, xo, rc, out
                torch.cuda.empty_cache()
            del W


def run_kernels(parent: Path) -> None:
    from ..solver import build_solver

    so = build_parent(parent)
    occupancy()
    rng = np.random.default_rng(0)
    small3 = build_solver("smooth3d", 8, 1, dtype=torch.float32,
                          device="cuda", inner="mg").msmg
    run_const(so, small3.levels[0], small3, rng)
    run_var(so, rng)


def run_solves(parent: Path) -> None:
    """run.py --repeat 3 in the parent and this tree, in turns."""
    for name, args in SOLVES:
        for tree, root in (("parent", parent), ("change", REPO),
                           ("change", REPO), ("parent", parent)):
            cmd = [sys.executable, "-m", "spacetime_tpu_torch.run",
                   "--device", "cuda", "--dtype", "f32", "--inner", "mg",
                   "--no-error", "--repeat", "3", *args]
            t0 = time.perf_counter()
            out = subprocess.run(cmd, cwd=root, capture_output=True,
                                 text=True, timeout=900)
            if out.returncode != 0:
                raise RuntimeError(f"{tree} {name}: {out.stderr[-2000:]}")
            calls = [(int(i), float(s)) for i, s in re.findall(
                r"solve call \d+: (\d+) iterations, ([0-9.]+) s", out.stdout)]
            _emit({"solve": name, "tree": tree, "iterations":
                   [i for i, _ in calls], "seconds": [s for _, s in calls],
                   "steady_s": min(s for _, s in calls[1:]),
                   "wall_s": time.perf_counter() - t0})


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent", required=True, type=Path)
    p.add_argument("--solves", action="store_true")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("fused_ab needs an NVIDIA GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    run_kernels(args.parent.resolve())
    if args.solves:
        run_solves(args.parent.resolve())
    return 0


if __name__ == "__main__":
    sys.exit(main())
