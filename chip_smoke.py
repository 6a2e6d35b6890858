#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``spacetime_tpu_torch``) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (every check asserts; any failure exits non-zero):

1. device  — CUDA is required; prints the card's name and power limit.
2. build   — compiles csrc/*.cu with nvcc into build/ (at first use).
3. setup   — the 129²×64 ("cfg2") f32 solver: smooth2d, multigrid inner.
4. kernels — K1 (B) and K2 (Bᵀ), plain and stab-fused, float32 and float64,
             against their plain PyTorch twins at the cfg2 shape (T=64,
             127×127) and a small ragged one (T=5, 9×13); median device
             times of 20 runs at the cfg2 shape.
5. solve   — ``solve(tol=1e-6)``: 16 ± 1 PCG iterations, L2 within 1% of
             5.748e-05.
6. refined — ``solve_refined(tol=1e-8)`` twice: converged in 2 inner rounds
             and 25 ± 2 inner iterations, L2 within 1% of 5.7525e-05; the
             second call's seconds are the steady time.

Launch counters are zeroed just before phase 5 and read after phase 6; each
of the four kernels must have launched there. The last two lines are a JSON
object describing the kernels and ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
SPACE_N, TIME_LEVELS = 128, 6
RAGGED = (5, (9, 13))
REF_SOLVE = {"iterations": 16, "l2": 5.748e-05}
REF_REFINED = {"iterations": 25, "rounds": 2, "l2": 5.7525e-05}
# max|kernel − twin| ≤ tol · max|twin|. f32: FMA contraction and the order
# of the tap sums differ from PyTorch's; f64: the same, at f64 rounding.
TOL = {torch.float32: 1e-5, torch.float64: 1e-13}


def phase(name: str) -> None:
    print(f"\n== {name}", flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from spacetime_tpu_torch.ops import kron, native
    from spacetime_tpu_torch.solver import build_solver
    from spacetime_tpu_torch.utils.profiling import device_ms

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

    phase("3 setup (cfg2: smooth2d 129x129 x 64 steps, f32, inner mg)")
    t0 = time.perf_counter()
    solver = build_solver("smooth2d", SPACE_N, TIME_LEVELS,
                          dtype=torch.float32, device="cuda")
    print(f"setup {time.perf_counter() - t0:.2f} s (m={solver.m}, "
          f"N={solver.N}, inner={solver.inner}, levels="
          f"{[lev.n for lev in solver.msmg.levels]})")

    phase("4 kernels against their plain twins")
    rng = np.random.default_rng(SEED)
    cfg2_taps = solver.taps
    shapes = [(solver.N, cfg2_taps),
              (RAGGED[0], dataclasses.replace(cfg2_taps, gs=RAGGED[1]))]
    results = {}  # (op, dtype) -> {"max_abs_err", "forms": {form: {...}}}
    for dtype in (torch.float32, torch.float64):
        for T, taps in shapes:
            forms = kernel_forms(kron, taps, seeded_inputs(taps, T, dtype, rng))
            for form, (kfn, tfn) in forms.items():
                got, want = kfn(), tfn()
                torch.cuda.synchronize()
                err = max(float((g - w).abs().max()) for g, w in zip(got, want))
                scale = max(float(w.abs().max()) for w in want)
                print(f"  {form:8s} {str(dtype)[6:]:8s} T={T:3d} gs={taps.gs}: "
                      f"max|kernel-twin| {err:.3e} (max|twin| {scale:.3e})")
                assert err <= TOL[dtype] * scale, (form, dtype, T, err, scale)
                op = form.split("_")[0]
                rec = results.setdefault(
                    (op, dtype), {"max_abs_err": 0.0, "forms": {}})
                rec["max_abs_err"] = max(rec["max_abs_err"], err)
                if taps is cfg2_taps:
                    ms = device_ms(kfn)
                    plain_ms = device_ms(tfn)
                    rec["forms"]["stab" if "stab" in form else "plain"] = {
                        "ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
                    }
                    print(f"  {'':8s} {'':8s} kernel {ms:.4f} ms, "
                          f"twin {plain_ms:.4f} ms (median of 20, device)")
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

    phase("5 solve(tol=1e-6), f32")
    kron.reset_launch_counts()
    res = solver.solve(tol=1e-6)
    rel = res.residuals[-1] / res.residuals[0]
    print(f"iterations {res.iterations}, converged {res.converged}, rel "
          f"{rel:.3e}, L2 {res.l2_error:.6e}; solve {res.solve_seconds:.4f} s, "
          f"rhs quadrature {res.rhs_seconds:.2f} s")
    print("launches so far:", kron.launch_counts())
    assert res.converged and rel <= 1e-6
    assert abs(res.iterations - REF_SOLVE["iterations"]) <= 1, res.iterations
    assert abs(res.l2_error / REF_SOLVE["l2"] - 1.0) <= 0.01, res.l2_error

    phase("6 solve_refined(tol=1e-8), f32 inner / f64 legs, twice")
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
    counts = {key: k.launches for key, k in kron.KERNELS.items()}
    print("launches in phases 5-6:", kron.launch_counts())
    assert all(n > 0 for n in counts.values()), counts

    kernels = []
    for (op, dtype), k in kron.KERNELS.items():
        rec = results[(op, dtype)]
        kernels.append({
            "name": k.name,
            "route": "cuda",
            "source": kron.SOURCE,
            "replaces": k.replaces,
            "launches": counts[(op, dtype)],
            "max_abs_err": rec["max_abs_err"],
            "ms": rec["forms"]["stab"]["ms"],
            "plain_ms": rec["forms"]["stab"]["plain_ms"],
            "form": "stab (apply_S); plain form under forms",
            "forms": rec["forms"],
        })
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
