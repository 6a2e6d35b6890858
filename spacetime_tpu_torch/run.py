"""Command-line interface of the PyTorch port.

Examples:
    # cfg1 (smooth2d, 65² vertices, 64 steps, f64, dense inner solves) on
    # the GPU: the defaults
    python -m spacetime_tpu_torch.run

    # the L-shape at 3.16 MDoF on the GPU: Chebyshev inner solves, every
    # SpMV of A and M the blocked-ELL kernel K20
    python -m spacetime_tpu_torch.run --device cuda --dtype f32 \
        --problem lshape2d --space-n 256 --time-levels 6 --spatial ell

    # the 129²×64 mixed-precision solve on the GPU
    python -m spacetime_tpu_torch.run --device cuda --dtype f32 \
        --space-n 128 --time-levels 6 --refined

    # the 513²×128 flagship solve on the GPU
    python -m spacetime_tpu_torch.run --device cuda --dtype f32 \
        --space-n 512 --time-levels 7

    # the weighted-coefficient (κ, c) 513²×128 solve on the GPU: the
    # Galerkin V-cycle (auto inner = mg above 4096 spatial unknowns)
    python -m spacetime_tpu_torch.run --device cuda --dtype f32 \
        --problem varcoef2d --space-n 512 --time-levels 7

    # the 129³×64 3-D solve (133 MDoF) on the GPU, twice: the second time
    # is the steady one
    python -m spacetime_tpu_torch.run --device cuda --dtype f32 \
        --problem smooth3d --space-n 128 --time-levels 6 --inner mg \
        --no-error --repeat 2

    # the weighted 3-D solve at 129³×32 (67.6 MDoF): every Galerkin level
    # runs the fused stages (K14, K15); --profile DIR traces it
    python -m spacetime_tpu_torch.run --device cuda --dtype f32 \
        --problem varcoef3d --space-n 128 --time-levels 5 --inner mg \
        --no-error --repeat 2

    # a weighted V(2,1) cycle (the semi-fused stages in 2-D)
    python -m spacetime_tpu_torch.run --device cuda --dtype f32 \
        --problem varcoef2d --space-n 128 --time-levels 6 --mg-nu-post 1

    # the singular 3-D problem on a time grid graded toward t = 0: 2^5
    # uniform steps, 4 more bisections at t = 0 (36 steps, 9.25 MDoF)
    python -m spacetime_tpu_torch.run --device cuda --dtype f32 \
        --problem singular3d --space-n 64 --time-levels 5 --extra-levels 4 \
        --inner mg

    # a small f64 solve on the CPU (plain PyTorch twins of the kernels)
    python -m spacetime_tpu_torch.run --device cpu --space-n 32 \
        --time-levels 4 --inner mg

    # the oracle's lshape-32-J5 row on the CPU, blocked ELL, dense inner
    python -m spacetime_tpu_torch.run --device cpu --problem lshape2d \
        --space-n 32 --time-levels 5 --spatial ell

    # the L-shape at 25.2 MDoF on the GPU: the base mesh of 32 cells per
    # side red-refined 4 times, nested multigrid (auto inner = mg on a
    # refinement chain; K16–K18 on every level)
    python -m spacetime_tpu_torch.run --device cuda --dtype f32 \
        --problem lshape2d --space-n 32 --refine 4 --time-levels 7

    # smoothed-aggregation multigrid on the 256-cell L-shape (3.16 MDoF):
    # K16–K18 on the banded fine level, K19/K20 on the aggregated ones
    python -m spacetime_tpu_torch.run --device cuda --dtype f32 \
        --problem lshape2d --space-n 256 --time-levels 6 --inner amg

    # the 513²×128 flagship on a (time 2 × space 2) mesh of four ranks on
    # one card: one process per rank, halos through host memory (gloo)
    python -m spacetime_tpu_torch.run --backend explicit2d --ranks 4 \
        --space-devices 2 --comm gloo --device cuda --dtype f32 \
        --space-n 512 --time-levels 7 --inner mg

    # cfg2 in f64 on a time mesh of four ranks on the CPU
    python -m spacetime_tpu_torch.run --backend explicit --ranks 4 \
        --comm gloo --device cpu --space-n 128 --time-levels 6 --inner mg

Prints the iteration count, the final relative residual, the L2(I×Ω) error
against the exact solution and per-phase times; on a mesh each rank prints
its place and device first.
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
                   help="cells per side of the spatial mesh")
    p.add_argument("--refine", type=int, default=0, metavar="K",
                   help="red-refine the spatial mesh K times, recording the "
                        "refinement chain (the nested multigrid hierarchy "
                        "of inner=mg on unstructured meshes)")
    p.add_argument("--time-levels", type=int, default=6,
                   help="dyadic time levels (2^J uniform timesteps)")
    p.add_argument("--extra-levels", type=int, default=0,
                   help="extra time levels refined toward t=0 (graded grid; "
                        "the singular problems)")
    p.add_argument("--tol", type=float, default=None,
                   help="relative residual target (default 1e-6, or 1e-8 "
                        "with --refined)")
    p.add_argument("--maxiter", type=int, default=200)
    p.add_argument("--dtype", choices=["f32", "f64"], default="f64")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--inner", choices=["auto", "dense", "mg", "cheb", "amg"],
                   default="auto",
                   help="inner spatial solver: dense inverses, multigrid "
                        "(structured grids, or the nested hierarchy of a "
                        "--refine chain), smoothed-aggregation multigrid "
                        "(amg, the flat formats) or Chebyshev polynomials "
                        "(auto = dense at <= 4096 spatial unknowns, mg on "
                        "structured grids and refinement chains, cheb "
                        "otherwise)")
    p.add_argument("--spatial", choices=["auto", "stencil", "vstencil", "dia",
                                         "ell"], default="auto",
                   help="spatial operator format (auto = stencil / vstencil "
                        "on structured grids, dia on the L-shape; ell runs "
                        "the blocked-ELL SpMM kernel K20)")
    p.add_argument("--cheb-eps", type=float, default=1e-3,
                   help="accuracy of the K_Y / K_H Chebyshev polynomials of "
                        "--inner cheb")
    p.add_argument("--mg-cycles", type=int, default=3)
    p.add_argument("--mg-cycles-kx", type=int, default=None,
                   help="V-cycles per shifted solve inside K_X (default 2)")
    p.add_argument("--mg-nu-kx", type=int, default=None,
                   help="Chebyshev smoothing steps per V-cycle inside the "
                        "K_X sandwich only (default: K_Y's 2)")
    p.add_argument("--mg-nu-post", type=int, default=None,
                   help="post-smoothing degree override (V(nu, nu_post) "
                        "cycles, which run the semi-fused stages instead "
                        "of the fused ones). Asymmetric cycles "
                        "are not symmetric preconditioners: keep >= 2 "
                        "cycles with them")
    p.add_argument("--refined", action="store_true",
                   help="mixed-precision refinement: f32 inner PCG inside "
                        "float64 residual legs")
    p.add_argument("--refine-inner-tol", type=float, default=1e-5,
                   metavar="TOL",
                   help="relative tolerance floor of the f32 inner rounds")
    p.add_argument("--no-error", action="store_true",
                   help="skip the L2 error computation")
    p.add_argument("--repeat", type=int, default=1, metavar="K",
                   help="run the solve K times and report each (the last "
                        "is the steady time)")
    p.add_argument("--backend", choices=["serial", "explicit", "explicit2d"],
                   default="serial",
                   help="serial = one device; explicit = a time mesh of "
                        "--ranks ranks; explicit2d = a (time x space) mesh, "
                        "--space-devices ranks on the space axis and the "
                        "rest on time. One process per rank")
    p.add_argument("--ranks", type=int, default=4, metavar="P",
                   help="ranks of the mesh (explicit, explicit2d)")
    p.add_argument("--space-devices", type=int, default=2, metavar="PS",
                   help="space-axis ranks of the explicit2d mesh")
    p.add_argument("--comm", choices=["gloo", "nccl"], default="gloo",
                   help="torch.distributed backend of the mesh: nccl needs "
                        "one card per rank; gloo runs any number of ranks "
                        "per card (halos through host memory) and on the CPU")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a torch.profiler trace of the (last) "
                        "solve into DIR/trace.json.gz and write the "
                        "per-kernel device times to DIR/kernels.txt")
    return p


def _profiled(args, device, last: bool):
    """A torch.profiler context for the last solve call, or a null
    context."""
    import contextlib

    import torch

    if not args.profile or not last:
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


def _main_mesh(args) -> int:
    """A mesh run: the ranks in their own processes (``parallel.launch``);
    rank 0's result printed here."""
    import numpy as np

    from .ops import native
    from .parallel import make_spacetime_mesh, make_time_mesh
    from .parallel.launch import solve_specs, spawn_ranks
    from .utils import resolve_device

    if args.profile or args.refine:
        raise SystemExit("--profile and --refine run on --backend serial")
    if args.backend == "explicit2d":
        if args.ranks % args.space_devices:
            raise SystemExit(f"--ranks {args.ranks} is not a multiple of "
                             f"--space-devices {args.space_devices}")
        mesh = make_spacetime_mesh(args.ranks // args.space_devices,
                                   args.space_devices, args.device)
    else:
        mesh = make_time_mesh(args.ranks, args.device)
    if args.device == "cuda":
        resolve_device("cuda")
        native.build()  # once, here: the ranks load it
    print(f"mesh {dict(mesh.shape)} over {args.comm}:")
    for line in mesh.describe():
        print(" ", line)
    tol = args.tol if args.tol is not None else (1e-8 if args.refined
                                                 else 1e-6)
    run = (("solve_refined", dict(tol=tol, inner_tol=args.refine_inner_tol,
                                  compute_error=False))
           if args.refined else
           ("solve", dict(tol=tol, maxiter=args.maxiter,
                          compute_error=False)))
    kw = dict(inner=args.inner, spatial_format=args.spatial,
              mg_cycles=args.mg_cycles, mg_cycles_kx=args.mg_cycles_kx,
              mg_nu_kx=args.mg_nu_kx, mg_nu_post=args.mg_nu_post)
    spec = dict(problem=args.problem, space_n=args.space_n,
                time_levels=args.time_levels,
                extra_time_levels=args.extra_levels, dtype=args.dtype,
                kw=kw, runs=[run] * args.repeat, loads=True, print=True,
                error=not args.no_error)
    (out,) = spawn_ranks(solve_specs, mesh, args.comm, ([spec],))
    info = out["info"]
    print(f"layout {info}; {(info['N'] + 1) * info['m']:,} space-time DoF")
    for call, r in enumerate(out["runs"], 1):
        print(f"solve call {call}: {r['iterations']} iterations, "
              f"{r['solve_seconds']:.4f} s; rank 0: {r['exchanges']} "
              f"exchanges, {r['bytes_staged'] / 2**20:.1f} MiB staged "
              f"through host memory, {r['comm_seconds']:.4f} s in the "
              "collectives")
    res = out["runs"][-1]
    rel = np.asarray(res["residuals"]) / res["residuals"][0]
    kind = "inner PCG iterations" if args.refined else "PCG iterations"
    print(f"{kind}: {res['iterations']}, converged={res['converged']}, "
          f"final relative residual {rel[-1]:.3e}")
    if res.get("l2_error") is not None:
        print(f"L2(IxOmega) error vs exact solution: {res['l2_error']:.6e}")
    print("residual history:", " ".join(f"{x:.2e}" for x in rel))
    return 0 if res["converged"] else 1


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.backend != "serial":
        return _main_mesh(args)

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
            device=device, refine=args.refine,
            extra_time_levels=args.extra_levels, inner=args.inner,
            spatial_format=args.spatial,
            cheb_eps=args.cheb_eps, mg_cycles=args.mg_cycles,
            mg_cycles_kx=args.mg_cycles_kx, mg_nu_kx=args.mg_nu_kx,
            mg_nu_post=args.mg_nu_post,
        )
    flavor = solver.mg_flavor
    if flavor:
        flavor = (f" ({flavor}: levels "
                  f"{[int(lev.m) for lev in solver.msmg.levels]})")
    print(
        f"problem={args.problem} mesh={args.space_n}^{solver.problem.dim}"
        f"{f' refined {args.refine}x' if args.refine else ''} "
        f"(m={solver.m}) timesteps={solver.N} "
        f"-> {(solver.N + 1) * solver.m:,} space-time DoF; "
        f"format={solver.spatial_format} inner={solver.inner}{flavor or ''}; "
        f"device={device}"
        + (f" ({torch.cuda.get_device_name(device)})"
           if device.type == "cuda" else "")
    )
    with timer("loads"):
        # host quadrature of the loads, once per solver, outside the solve
        for dt in {dtype, torch.float64} if args.refined else {dtype}:
            solver.assemble_rhs_host(dt)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    for call in range(1, args.repeat + 1):
        t0 = time.perf_counter()
        with timer("solve"), _profiled(args, device,
                                       call == args.repeat) as prof:
            if args.refined:
                res = solver.solve_refined(
                    tol=1e-8 if args.tol is None else args.tol,
                    inner_tol=args.refine_inner_tol, compute_error=False,
                )
            else:
                res = solver.solve(
                    tol=1e-6 if args.tol is None else args.tol,
                    maxiter=args.maxiter, compute_error=False,
                )
            # the traced solve's wall, without the profiler's teardown (its
            # event processing, tens of seconds at 10⁶ launches)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            wall = time.perf_counter() - t0
        if args.repeat > 1:
            print(f"solve call {call}: {res.iterations} iterations, "
                  f"{res.solve_seconds:.4f} s")
    if args.profile:
        _write_profile(prof, args.profile, device, wall)
    if not args.no_error and solver.problem.exact is not None:
        # the host error loop, outside the solve's time and trace
        with timer("l2 error"):
            res.l2_error = solver._l2_error(res.U)
    if device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(device) / 2**30
        print(f"peak device memory of the solve: {peak:.2f} GiB")
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
