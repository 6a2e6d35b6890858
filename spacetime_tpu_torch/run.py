"""Command-line interface of the PyTorch port.

Examples:
    # the 129²×64 mixed-precision solve on the GPU
    python -m spacetime_tpu_torch.run --device cuda --dtype f32 \
        --space-n 128 --time-levels 6 --refined

    # a small f64 solve on the CPU (plain PyTorch twins of the kernels)
    python -m spacetime_tpu_torch.run --device cpu --space-n 32 \
        --time-levels 4 --inner mg

Prints the iteration count, the final relative residual, the L2(I×Ω) error
against the exact solution and per-phase times.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="spacetime_tpu_torch.run",
        description="Space-time minimal-residual heat-equation solver "
                    "(PyTorch / CUDA)",
    )
    p.add_argument("--problem", default="smooth2d")
    p.add_argument("--space-n", type=int, default=64,
                   help="cells per side of the structured spatial mesh")
    p.add_argument("--time-levels", type=int, default=6,
                   help="dyadic time levels (2^J uniform timesteps)")
    p.add_argument("--tol", type=float, default=None,
                   help="relative residual target (default 1e-6, or 1e-8 "
                        "with --refined)")
    p.add_argument("--maxiter", type=int, default=200)
    p.add_argument("--dtype", choices=["f32", "f64"], default="f64")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--inner", choices=["auto", "mg"], default="auto",
                   help="inner spatial solver (auto = mg above 4096 "
                        "spatial unknowns; the dense inverses below that "
                        "are a later slice of the port)")
    p.add_argument("--mg-cycles", type=int, default=3)
    p.add_argument("--mg-cycles-kx", type=int, default=None,
                   help="V-cycles per shifted solve inside K_X (default 2)")
    p.add_argument("--refined", action="store_true",
                   help="mixed-precision refinement: f32 inner PCG inside "
                        "float64 residual legs")
    p.add_argument("--refine-inner-tol", type=float, default=1e-5,
                   metavar="TOL",
                   help="relative tolerance floor of the f32 inner rounds")
    p.add_argument("--no-error", action="store_true",
                   help="skip the L2 error computation")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a torch.profiler trace of the solve into "
                        "DIR/trace.json.gz and write the per-kernel device "
                        "times to DIR/kernels.txt")
    return p


def _profiled(args, device):
    """A torch.profiler context for the solve, or a null context."""
    import contextlib

    import torch

    if not args.profile:
        return contextlib.nullcontext()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _write_profile(prof, path, device, wall_seconds) -> None:
    """Trace and per-kernel table; prints the device's busy share of the
    solve's wall time (the sum of device time over kernels and copies)."""
    import os

    from torch.autograd import DeviceType

    os.makedirs(path, exist_ok=True)
    prof.export_chrome_trace(os.path.join(path, "trace.json.gz"))
    cuda = device.type == "cuda"
    events = prof.key_averages()
    key = "self_device_time_total" if cuda else "self_cpu_time_total"
    table = events.table(sort_by=key, row_limit=40)
    with open(os.path.join(path, "kernels.txt"), "w") as f:
        f.write(table)
    print(table)
    if cuda:
        busy_us = sum(
            e.self_device_time_total for e in events
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation
        )
        launches = sum(
            e.count for e in events
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation
        )
        print(f"{launches} device kernels and copies")
        print(
            f"device busy {busy_us / 1e6:.4f} s of {wall_seconds:.4f} s "
            f"wall ({100 * busy_us / 1e6 / wall_seconds:.1f}%)"
        )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import time

    import numpy as np
    import torch

    from .solver import build_solver
    from .utils import PhaseTimer, resolve_device

    device = resolve_device(args.device)
    timer = PhaseTimer(device)
    dtype = torch.float64 if args.dtype == "f64" else torch.float32
    with timer("setup"):
        solver = build_solver(
            args.problem, args.space_n, args.time_levels, dtype=dtype,
            device=device, inner=args.inner, mg_cycles=args.mg_cycles,
            mg_cycles_kx=args.mg_cycles_kx,
        )
    print(
        f"problem={args.problem} mesh={args.space_n}^{solver.problem.dim} "
        f"(m={solver.m}) timesteps={solver.N} "
        f"-> {(solver.N + 1) * solver.m:,} space-time DoF; device={device}"
        + (f" ({torch.cuda.get_device_name(device)})"
           if device.type == "cuda" else "")
    )
    with timer("loads"):
        # host quadrature of the loads, once per solver, outside the solve
        for dt in {dtype, torch.float64} if args.refined else {dtype}:
            solver.assemble_rhs_host(dt)
    t0 = time.perf_counter()
    with timer("solve"), _profiled(args, device) as prof:
        if args.refined:
            res = solver.solve_refined(
                tol=1e-8 if args.tol is None else args.tol,
                inner_tol=args.refine_inner_tol,
                compute_error=not args.no_error,
            )
        else:
            res = solver.solve(
                tol=1e-6 if args.tol is None else args.tol,
                maxiter=args.maxiter, compute_error=not args.no_error,
            )
    wall = time.perf_counter() - t0
    if args.profile:
        _write_profile(prof, args.profile, device, wall)
    rel = np.asarray(res.residuals) / res.residuals[0]
    kind = "inner PCG iterations" if args.refined else "PCG iterations"
    print(
        f"{kind}: {res.iterations}, converged={res.converged}, "
        f"final relative residual {rel[-1]:.3e}"
    )
    if res.l2_error is not None:
        print(f"L2(IxOmega) error vs exact solution: {res.l2_error:.6e}")
    print("residual history:", " ".join(f"{x:.2e}" for x in rel))
    print(
        f"solve {res.solve_seconds:.4f} s, rhs quadrature "
        f"{res.rhs_seconds:.4f} s, setup {res.setup_seconds:.4f} s"
    )
    print("timings:", timer.summary())
    return 0 if res.converged else 1


if __name__ == "__main__":
    sys.exit(main())
