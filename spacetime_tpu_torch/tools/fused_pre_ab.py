"""The 3-D fused pre-stages K6 and K14 against an earlier tree's, on one GPU.

    python -m spacetime_tpu_torch.tools.fused_pre_ab --parent DIR [--solves]

DIR is the root of another checkout of the repository (an unpacked
``git archive`` of an earlier commit, say). Its ``csrc/mg.cu`` is built with
nvcc into ``DIR/build/parent_mg/`` and loaded beside this tree's kernels:

- ``kernels`` (always): K6 at 65×63³ and 65×127³, K14 at 33×63³ and 33×127³
  (the varcoef3d 65³ solver's finest weights, tiled to 127³), ν ∈ {2, 3},
  float32 and float64. Each launch of this tree and of DIR on the same
  inputs, max|new − old| and both held to the plain twin within 1e-5·max|twin|
  (f32) and 1e-13 (f64); median device times of new, old and the semi-fused
  pair (K3 from 0 + K8, K10 from 0 + K13) in the order old, new, pair, new,
  old. Also the blocks per SM of each march instantiation.
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

from ..ops import mg_kernels, native
from ..ops.mg_kernels import MSKernelLevel, VarMSKernelLevel
from ..ops.multigrid import row_params, var_row_params
from ..utils.profiling import device_ms

REPO = Path(__file__).resolve().parents[2]
TOL = {torch.float32: 1e-5, torch.float64: 1e-13}
K6_SHAPES = [(65, (63,) * 3), (65, (127,) * 3)]
K14_SHAPES = [(33, (63,) * 3), (33, (127,) * 3)]
SOLVES = [
    ("smooth3d", ["--problem", "smooth3d", "--space-n", "64",
                  "--time-levels", "5"]),
    ("varcoef3d", ["--problem", "varcoef3d", "--space-n", "64",
                   "--time-levels", "5"]),
    ("singular3d", ["--problem", "singular3d", "--space-n", "64",
                    "--time-levels", "5", "--extra-levels", "4"]),
]


def build_parent(parent: Path) -> ctypes.CDLL:
    """DIR's csrc/mg.cu and csrc/common.cu as one library, its fused
    pre-stage entry points bound with their signatures of that tree (no
    chunk argument)."""
    out = parent / "build" / "parent_mg"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libparent_mg.so"
    csrc = parent / "spacetime_tpu_torch" / "csrc"
    cmd = [native._nvcc(), *native.ARCH_FLAGS, "-std=c++17", "-O3",
           "-Xcompiler", "-fPIC", "-shared", "-o", str(lib),
           str(csrc / "mg.cu"), str(csrc / "common.cu")]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    so = ctypes.CDLL(str(lib))
    P, I64, I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    grid = [I64, I64, I64, I64, I]
    for sfx in ("f32", "f64"):
        fn = getattr(so, f"mg_fused_pre_{sfx}")
        fn.argtypes, fn.restype = [P] * 7 + grid + [P, I, P], I
        fn = getattr(so, f"mg_fused_pre_var_{sfx}")
        fn.argtypes, fn.restype = [P] * 7 + grid + [P, P, I, P], I
    return so


def _call(so, name, *args):
    err = getattr(so, name)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: error {err}")


def _emit(rec: dict) -> None:
    print(json.dumps(rec), flush=True)


def _err(got, want) -> float:
    return float((got - want).abs().max())


def compare(label, kl, new_fn, old_fn, twin_fn, pair_fn, dtype, T) -> None:
    """new against old and both against the twin; times."""
    new, old, twin = new_fn(), old_fn(), twin_fn()
    torch.cuda.synchronize()
    rec = {"kernel": label, "T": T, "gs": list(kl.gs), "nu": kl.nu,
           "dtype": str(dtype)[6:]}
    rec["max_abs_new_old"] = max(_err(a, b) for a, b in zip(new, old))
    for name, got in (("new", new), ("old", old)):
        errs = [(_err(g, w), float(w.abs().max())) for g, w in zip(got, twin)]
        rec[f"max_abs_{name}_twin"] = max(e for e, _ in errs)
        assert all(e <= TOL[dtype] * s for e, s in errs), (label, name, errs)
    del new, old, twin
    times = {"old": [], "new": []}
    for which in ("old", "new", "pair", "new", "old"):
        fn = {"old": old_fn, "new": new_fn, "pair": pair_fn}[which]
        times.setdefault(which, []).append(device_ms(fn))
    rec.update({f"{k}_ms": float(np.mean(v)) for k, v in times.items()})
    rec["new_ms_runs"], rec["old_ms_runs"] = times["new"], times["old"]
    _emit(rec)


def run_kernels(parent: Path) -> None:
    from ..solver import build_solver

    so = build_parent(parent)
    lib = native.LIB.get()
    for var in (0, 1):
        for nu in (2, 3):
            for f64 in (0, 1):
                blocks, nbytes = ctypes.c_int(), ctypes.c_int()
                err = lib.mg_march_occupancy(var, nu, f64,
                                             ctypes.byref(blocks),
                                             ctypes.byref(nbytes))
                native.check(lib, "mg_march_occupancy", err)
                _emit({"march": "K14" if var else "K6", "nu": nu,
                       "dtype": "float64" if f64 else "float32",
                       "blocks_per_sm": blocks.value,
                       "smem_bytes": nbytes.value})
    rng = np.random.default_rng(0)
    small3 = build_solver("smooth3d", 8, 1, dtype=torch.float32,
                          device="cuda", inner="mg").msmg
    lev = small3.levels[0]
    for dtype in (torch.float32, torch.float64):
        sfx = "f32" if dtype == torch.float32 else "f64"
        mk = lambda a: torch.as_tensor(a, dtype=dtype, device="cuda")
        for T, gs in K6_SHAPES:
            for nu in (2, 3):
                kl = MSKernelLevel(lev.A_st, lev.M_st, nu, gs=gs)
                b = mk(rng.standard_normal((T,) + gs))
                cols = kl.columns(row_params(
                    small3, np.abs(rng.standard_normal(T)) * 20, dtype,
                    "cuda")[0])
                cp = [cols[n].data_ptr() for n in kl._COLS]
                x, rc = torch.empty_like(b), b.new_empty((T,) + kl.coarse_gs)

                def old():
                    _call(so, f"mg_fused_pre_{sfx}", b.data_ptr(), *cp,
                          x.data_ptr(), rc.data_ptr(), T, *kl._zyx(),
                          kl._op_table(), nu)
                    return x, rc

                def pair():
                    x0 = kl.smooth(None, b, cols, zero_init=True)
                    return x0, kl.residual_restrict(x0, b, cols)

                compare("K6", kl, lambda: kl.fused_pre(b, cols), old,
                        lambda: kl.fused_pre_plain(b, cols), pair, dtype, T)
                del b, x, rc
                torch.cuda.empty_cache()
    var3 = build_solver("varcoef3d", 64, 5, dtype=torch.float32,
                        device="cuda").msmg
    Aw = var3.levels[0].Aw
    for dtype in (torch.float32, torch.float64):
        sfx = "f32" if dtype == torch.float32 else "f64"
        mk = lambda a: torch.as_tensor(a, dtype=dtype, device="cuda")
        for T, gs in K14_SHAPES:
            grow = [(0, 0)] + [(0, max(n - m, 0))
                               for n, m in zip(gs, Aw.shape[1:])]
            cut = (slice(None),) + tuple(slice(0, n) for n in gs)
            W = mk(np.ascontiguousarray(np.pad(Aw, grow, mode="wrap")[cut]))
            for nu in (2, 3):
                kl = VarMSKernelLevel(var3.levels[0], nu, gs=gs)
                b = mk(rng.standard_normal((T,) + gs))
                cols = kl.columns(var_row_params(
                    var3, np.abs(rng.standard_normal(T)) * 20, dtype,
                    "cuda")[0])
                cp = [cols[n].data_ptr() for n in kl._COLS]
                x, rc = torch.empty_like(b), b.new_empty((T,) + kl.coarse_gs)

                def old():
                    _call(so, f"mg_fused_pre_var_{sfx}", b.data_ptr(),
                          W.data_ptr(), *cp, x.data_ptr(), rc.data_ptr(), T,
                          *kl._zyx(), *kl._tables(), nu)
                    return x, rc

                def pair():
                    x0 = kl.smooth(None, b, cols, W, zero_init=True)
                    return x0, kl.residual_restrict(x0, b, cols, W)

                compare("K14", kl, lambda: kl.fused_pre(b, cols, W), old,
                        lambda: kl.fused_pre_plain(b, cols, W), pair, dtype,
                        T)
                del b, x, rc
                torch.cuda.empty_cache()
            del W


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
        print("fused_pre_ab needs an NVIDIA GPU", file=sys.stderr)
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
