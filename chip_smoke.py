#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``spacetime_tpu_torch``) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (every check asserts; any failure exits non-zero):

1. device   — CUDA is required; prints the card's name and power limit.
2. build    — compiles csrc/*.cu with nvcc into build/ (at first use).
3. setup    — the 129²×64 ("cfg2") f32 solver: smooth2d, multigrid inner.
4. kernels  — K1 (B) and K2 (Bᵀ), plain and stab-fused, float32 and float64,
              against their plain PyTorch twins at the cfg2 shape (T=64,
              127×127), the flagship's (T=128, 511×511) and a small ragged
              one (T=5, 9×13); median device times of 20 runs at the first
              two.
5. mg kernels — K3 (sweep from x and from 0), K4, K5, K6 and K7 against
              their twins in float32 and float64 with ν ∈ {2, 3}, at 511² and
              255² (T=129), 127² (T=65) and a ragged 15×31 (T=5); median
              device times (ν = 2) at 511²×129 and 127²×65.
6. solve    — cfg2 ``solve(tol=1e-6)``: 16 ± 1 PCG iterations, L2 within 1%
              of 5.748e-05.
7. refined  — cfg2 ``solve_refined(tol=1e-8)`` twice: converged in 2 inner
              rounds and 25 ± 2 inner iterations, L2 within 1% of
              5.7525e-05; the second call's seconds are the steady time.
8. flagship — smooth2d at 513²×128 (33.8 MDoF), f32: setup, loads and L2
              seconds; ``solve(tol=1e-6)`` twice, 17 ± 2 iterations and L2
              within 20% of 3.812e-06 (f32 rounding, see REF_FLAGSHIP); one
              ``solve_refined(tol=1e-8)``, converged, L2 within 1% of the
              float64 solve's 3.5877e-06.
9. V(2,1)   — cfg2 with ``mg_nu_post=1`` (the sweep and residual kernels in
              place of the fused stages): ``solve(tol=1e-6)`` within ±1 of
              the JAX package's 17 iterations, then ``solve_refined``.
10. f64     — cfg2 in float64, ``solve(tol=1e-8)``: the JAX package's 21
              iterations ± 1, L2 within 1e-6 of 5.7525369e-05.

Launch counters are zeroed just before each path (phases 6–7, 8, 9, 10) and
read just after it; each path asserts the kernels it must have launched.
The last two lines are a JSON object describing the kernels and
``{"ok": true, "device": ...}``.
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
FLAGSHIP_N, FLAGSHIP_LEVELS = 512, 7
RAGGED = (5, (9, 13))
FLAGSHIP_KRON = (2 ** FLAGSHIP_LEVELS, (FLAGSHIP_N - 1,) * 2)
REF_SOLVE = {"iterations": 16, "l2": 5.748e-05}
REF_REFINED = {"iterations": 25, "rounds": 2, "l2": 5.7525e-05}
# The JAX package at 513²×128, f32, device loads (results_tpu/
# r2_2d_presets.log:2). An f32 solve's L2 at this size carries the rounding
# of the f32 operator (K_Y enters S): loads perturbed by 1e-7 relative moved
# the port's L2 between 3.79e-06 and 4.38e-06 on an H100, so the f32 band is
# 20%. The f64-leg refinement is free of it and is held to 1% of the port's
# float64 solve at this size (21 iterations, L2 3.5877e-06, on an H100); the
# float64 path is held to the JAX package at cfg2 in phase 10.
REF_FLAGSHIP = {"iterations": 17, "l2": 3.812e-06, "l2_band": 0.2,
                "l2_f64": 3.5877e-06}
# The JAX package on the CPU at cfg2, f32, inner="mg", host loads,
# mg_nu_post=1, tol 1e-6 (pallas_kron=False: no level reaches its kernels).
REF_V21 = {"iterations": 17}
# The JAX package on the CPU at cfg2, f64, inner="mg", host loads, tol 1e-8.
REF_F64 = {"iterations": 21, "l2": 5.752536865509208e-05}
# (T, grid) of the multigrid kernel checks: the flagship's fine and first
# coarse level, cfg2's fine level at K_X's row count, and a ragged shape.
MG_SHAPES = [(129, (511, 511)), (129, (255, 255)), (65, (127, 127)),
             (5, (15, 31))]
MG_TIMED = [(129, (511, 511)), (65, (127, 127))]
# max|kernel − twin| ≤ tol · max|twin|. f32: FMA contraction and the order
# of the tap sums differ from PyTorch's; f64: the same, at f64 rounding.
TOL = {torch.float32: 1e-5, torch.float64: 1e-13}


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
    returns a tuple of tensors."""
    X, B, EC, c = x["x"], x["b"], x["ec"], x["cols"]
    return {
        "smooth": ("smooth", lambda: (kl.smooth(X, B, c),),
                   lambda: (kl.smooth_plain(X, B, c),)),
        "smooth_zero": ("smooth",
                        lambda: (kl.smooth(None, B, c, zero_init=True),),
                        lambda: (kl.smooth_plain(None, B, c, zero_init=True),)),
        "residual": ("residual", lambda: (kl.residual(X, B, c),),
                     lambda: (kl.residual_plain(X, B, c),)),
        "apply_A": ("apply", lambda: (kl.apply_A(X),),
                    lambda: (kl.apply_A_plain(X),)),
        "fused_pre": ("fused_pre", lambda: kl.fused_pre(B, c),
                      lambda: kl.fused_pre_plain(B, c)),
        "fused_post": ("fused_post", lambda: (kl.fused_post(X, B, EC, c),),
                       lambda: (kl.fused_post_plain(X, B, EC, c),)),
    }


def mg_inputs(msmg, kl, T, dtype, rng) -> dict:
    """x, b (T, *gs), e_c on the coarse grid, and level-0 columns of random
    shifts, on the card."""
    from spacetime_tpu_torch.ops.multigrid import row_params

    mk = lambda a: torch.as_tensor(a, dtype=dtype, device="cuda")
    omega = np.abs(rng.standard_normal(T)) * 20
    lp = row_params(msmg, omega, dtype, "cuda")[0]
    return {
        "x": mk(rng.standard_normal((T,) + kl.gs)),
        "b": mk(rng.standard_normal((T,) + kl.gs)),
        "ec": mk(rng.standard_normal((T,) + kl.coarse_gs)),
        "cols": kl.columns(lp),
    }


class Paths:
    """Launch counts of K1–K7 per main path: zeroed just before a path,
    read just after it."""

    def __init__(self, kron, mgk):
        self.modules = (kron, mgk)
        self.counts = {}  # path -> {(op, dtype): launches}

    def start(self) -> None:
        for m in self.modules:
            m.reset_launch_counts()

    def stop(self, path: str) -> dict:
        c = {key: k.launches for m in self.modules for key, k in m.KERNELS.items()}
        self.counts[path] = c
        print(f"launches in path {path}:",
              {k.name: k.launches for m in self.modules
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
    from spacetime_tpu_torch.ops import kron, mg_kernels, native
    from spacetime_tpu_torch.ops.mg_kernels import MSKernelLevel
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
    shapes = [(solver.N, cfg2_taps)] + [
        (T, dataclasses.replace(cfg2_taps, gs=gs))
        for T, gs in (FLAGSHIP_KRON, RAGGED)
    ]
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
                if taps.gs != RAGGED[1]:
                    ms = device_ms(kfn)
                    plain_ms = device_ms(tfn)
                    variant = "stab" if "stab" in form else "plain"
                    rec["forms"][f"{variant} {T}x{taps.gs[0]}x{taps.gs[1]}"] = {
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

    phase("5 mg kernels K3-K7 against their plain twins")
    rng = np.random.default_rng(SEED + 1)
    lev0 = solver.msmg.levels[0]
    mg_results = {}  # (op, dtype) -> {"max_abs_err", "forms": {...}}
    for dtype in (torch.float32, torch.float64):
        for T, gs in MG_SHAPES:
            for nu in (2, 3):
                kl = MSKernelLevel(lev0.A_st, lev0.M_st, nu, gs=gs)
                x = mg_inputs(solver.msmg, kl, T, dtype, rng)
                for form, (op, kfn, tfn) in mg_forms(kl, x).items():
                    got, want = kfn(), tfn()
                    torch.cuda.synchronize()
                    rec = mg_results.setdefault(
                        (op, dtype), {"max_abs_err": 0.0, "forms": {}})
                    for g, w in zip(got, want):
                        err = float((g - w).abs().max())
                        scale = float(w.abs().max())
                        assert err <= TOL[dtype] * scale, (
                            form, dtype, T, gs, nu, err, scale)
                        rec["max_abs_err"] = max(rec["max_abs_err"], err)
                    timed = nu == 2 and (T, gs) in MG_TIMED
                    line = (f"  {form:11s} {str(dtype)[6:]:8s} nu={nu} T={T:3d} "
                            f"gs={gs}: max|kernel-twin| {err:.3e} "
                            f"(max|twin| {scale:.3e})")
                    if timed:
                        ms, plain_ms = device_ms(kfn), device_ms(tfn)
                        rec["forms"][f"{form} {T}x{gs[0]}x{gs[1]}"] = {
                            "ms": ms, "plain_ms": plain_ms}
                        line += f"; kernel {ms:.4f} ms, twin {plain_ms:.4f} ms"
                    print(line)
                del x
        torch.cuda.empty_cache()

    paths = Paths(kron, mg_kernels)
    phase("6 solve(tol=1e-6), f32")
    paths.start()
    res = solver.solve(tol=1e-6)
    rel = res.residuals[-1] / res.residuals[0]
    print(f"iterations {res.iterations}, converged {res.converged}, rel "
          f"{rel:.3e}, L2 {res.l2_error:.6e}; solve {res.solve_seconds:.4f} s, "
          f"rhs quadrature {res.rhs_seconds:.2f} s")
    assert res.converged and rel <= 1e-6
    assert abs(res.iterations - REF_SOLVE["iterations"]) <= 1, res.iterations
    assert abs(res.l2_error / REF_SOLVE["l2"] - 1.0) <= 0.01, res.l2_error

    phase("7 solve_refined(tol=1e-8), f32 inner / f64 legs, twice")
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
    f32, f64 = torch.float32, torch.float64
    must = [(op, dt) for op in ("B", "BT") for dt in (f32, f64)]
    must += [(op, f32) for op in ("residual", "apply", "fused_pre", "fused_post")]
    must += [(op, f64) for op in ("residual", "fused_pre", "fused_post")]
    assert all(counts[key] > 0 for key in must), counts
    del solver
    torch.cuda.empty_cache()

    phase(f"8 flagship: smooth2d {FLAGSHIP_N + 1}^2 x {2 ** FLAGSHIP_LEVELS} "
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
    must = [(op, dt) for op in ("B", "BT", "residual", "fused_pre",
                                "fused_post") for dt in (f32, f64)]
    must += [("apply", f32)]
    assert all(counts[key] > 0 for key in must), counts
    del flag, runs, r
    torch.cuda.empty_cache()

    phase("9 V(2,1): cfg2 with mg_nu_post=1, f32")
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
    r = v21.solve_refined(tol=1e-8, compute_error=False)
    print(f"solve_refined: inner iterations {r.iterations} in "
          f"{len(r.residuals) - 1} rounds, converged {r.converged}")
    assert r.converged, r.residuals
    counts = paths.stop("V(2,1)")
    assert all(counts[(op, dt)] > 0 for op in ("smooth", "residual")
               for dt in (f32, f64)), counts
    assert all(counts[(op, dt)] == 0 for op in ("fused_pre", "fused_post")
               for dt in (f32, f64)), counts
    del v21

    phase("10 f64: cfg2 solve(tol=1e-8) in float64")
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
    counts = paths.stop("f64")
    assert all(counts[(op, f64)] > 0 for op in (
        "B", "BT", "residual", "apply", "fused_pre", "fused_post")), counts
    del s64
    phase(None)

    kernels = []
    at = f"stab {FLAGSHIP_KRON[0]}x{FLAGSHIP_KRON[1][0]}x{FLAGSHIP_KRON[1][1]}"
    for (op, dtype), k in kron.KERNELS.items():
        rec = results[(op, dtype)]
        kernels.append({
            "name": k.name,
            "route": "cuda",
            "source": kron.SOURCE,
            "replaces": k.replaces,
            "launches": paths.total((op, dtype)),
            "max_abs_err": rec["max_abs_err"],
            "ms": rec["forms"][at]["ms"],
            "plain_ms": rec["forms"][at]["plain_ms"],
            "form": f"stab (apply_S) at T={FLAGSHIP_KRON[0]}, "
                    f"{FLAGSHIP_KRON[1][0]}x{FLAGSHIP_KRON[1][1]}; "
                    "the other forms under forms",
            "forms": rec["forms"],
        })
    main_form = {"smooth": "smooth", "residual": "residual", "apply": "apply_A",
                 "fused_pre": "fused_pre", "fused_post": "fused_post"}
    for (op, dtype), k in mg_kernels.KERNELS.items():
        rec = mg_results[(op, dtype)]
        at = rec["forms"][f"{main_form[op]} 129x511x511"]
        kernels.append({
            "name": k.name,
            "route": "cuda",
            "source": mg_kernels.SOURCE,
            "replaces": k.replaces,
            "launches": paths.total((op, dtype)),
            "max_abs_err": rec["max_abs_err"],
            "ms": at["ms"],
            "plain_ms": at["plain_ms"],
            "form": f"{main_form[op]}, nu=2, at T=129, 511x511",
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
