"""Start the ranks of a mesh, one process each, and run a function on them.

``spawn_ranks(fn, mesh, comm, args)`` starts ``mesh.size`` processes with
``torch.multiprocessing`` (start method ``spawn``), joins them in one
process group on a free localhost port and calls ``fn(comm, *args)`` on
each, ``comm`` its ``parallel.comm.Comm``. It returns rank 0's result. An
exception on any rank becomes the caller's exception (the other ranks are
stopped), so a script that calls it exits non-zero. A mesh of one rank runs
``fn`` in the calling process.

``fn`` must be importable by the children: the entry functions live here
(``solve_specs``), never in a test module, so a rank imports nothing but
torch, numpy, scipy and this package. On the CPU every rank runs torch and
the host BLAS with one thread (several ranks of several test workers share
the cores), on CUDA with the cores over the ranks. CUDA
ranks load the kernel library that the caller built: build it before
spawning (``ops.native.build``), so that the ranks never build it at once.
"""

from __future__ import annotations

import os
import pickle
import shutil
import socket
import sys
import tempfile
import time

import torch

from .comm import Comm
from .mesh import RankMesh


_THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _threads(mesh: RankMesh) -> int:
    """Host threads per rank: one on the CPU (the test workers' ranks share
    the cores), the cores over the ranks on CUDA (host setup and loads)."""
    if mesh.device == "cpu":
        return 1
    return max(1, (os.cpu_count() or 1) // mesh.size)


def _rank_main(rank, fn, mesh, backend, port, out_path, args, timeout):
    torch.set_num_threads(_threads(mesh))
    comm = Comm(mesh, rank, backend, init_method=f"tcp://127.0.0.1:{port}",
                timeout=timeout)
    try:
        result = fn(comm, *args)
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(result, f)
    finally:
        comm.close()


def spawn_ranks(fn, mesh: RankMesh, comm: str = "gloo", args=(),
                timeout: float = 300.0):
    """``fn(comm, *args)`` on every rank of ``mesh`` over the backend
    ``comm``; rank 0's result."""
    if mesh.size == 1:
        c = Comm(mesh, 0, comm)
        try:
            return fn(c, *args)
        finally:
            c.close()
    tmp = tempfile.mkdtemp(prefix="spacetime_ranks_")
    out = os.path.join(tmp, "rank0.pkl")
    # the host BLAS's threads too (the children read these at start;
    # several ranks' thread pools on shared cores contend badly)
    saved = {k: os.environ.get(k) for k in _THREAD_VARS}
    os.environ.update({k: str(_threads(mesh)) for k in _THREAD_VARS})
    try:
        torch.multiprocessing.spawn(
            _rank_main,
            args=(fn, mesh, comm, free_port(), out, tuple(args), timeout),
            nprocs=mesh.size, join=True, start_method="spawn")
        with open(out, "rb") as f:
            return pickle.load(f)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)


# ------------------------------------------------------------ entry points


def _dtype(name):
    return {"f32": torch.float32, "f64": torch.float64}[name]


def build_mesh_solver(comm: Comm, spec: dict):
    """The mesh solver of one spec: ``problem``, ``space_n``,
    ``time_levels``, ``extra_time_levels``, ``dtype`` ("f32"/"f64") and
    the solver's keyword arguments ``kw``; the mesh decides the class
    (``Explicit2DHeatSolver`` on a time × space mesh)."""
    from ..fem import (P1System, domain_mesh, graded_time_grid,
                       uniform_time_grid)
    from ..models import get_problem
    from .explicit import ExplicitHeatSolver
    from .explicit2d import Explicit2DHeatSolver

    problem = get_problem(spec["problem"])
    mesh = domain_mesh(problem.domain, problem.dim, spec["space_n"])
    system = P1System.from_problem(problem, mesh)
    J, extra = spec["time_levels"], spec.get("extra_time_levels", 0)
    grid = (graded_time_grid(J, extra, T=problem.T) if extra
            else uniform_time_grid(J, T=problem.T))
    cls = (Explicit2DHeatSolver if "space" in comm.mesh.axis_names
           else ExplicitHeatSolver)
    return cls(problem, system, grid, comm,
               dtype=_dtype(spec.get("dtype", "f64")), **spec.get("kw", {}))


def _result(res, solver, comm) -> dict:
    out = {k: getattr(res, k) for k in (
        "U", "iterations", "residuals", "precond_residuals", "converged",
        "l2_error", "solve_seconds", "transfer_seconds", "setup_seconds")}
    out["exchanges"] = comm.exchanges
    out["bytes_staged"] = comm.bytes_staged
    out["comm_seconds"] = comm.seconds
    return out


def _kernel_modules():
    from ..ops import dia_kernels, kron, mg_kernels, spmv

    return (kron, mg_kernels, spmv, dia_kernels)


def _launches(comm: Comm) -> dict:
    """The kernel launches counted in this process since the last reset,
    summed over every rank of the mesh: {kernel name: launches}."""
    ks = [k for m in _kernel_modules() for k in m.KERNELS.values()]
    n = torch.tensor([float(k.launches) for k in ks], dtype=torch.float64,
                     device=comm.device)
    total = comm.psum(n, comm.mesh.axis_names).cpu().numpy()
    return {k.name: int(v) for k, v in zip(ks, total) if v}


def solve_specs(comm: Comm, specs: list) -> list:
    """Run each spec on this rank: build its solver, then its ``runs``, a
    list of (method, keyword arguments) with method "solve" or
    "solve_refined"; ``x0="previous"`` warm-starts from the run before.
    Returns, per spec, the runs' results (the gathered iterate U, the
    histories, iterations, seconds, the rank's exchanges and bytes staged
    through the host and seconds in the collectives during the run (the
    gather of the iterate included), the kernel launches of the run summed
    over the ranks) and ``info``: the solver's layout, and the foreign
    packages loaded in the process (none: the check that a rank runs
    without JAX). With ``spec["loads"]`` the loads are assembled before the
    runs (outside their seconds); with ``spec["print"]`` every rank prints
    its place and device, and its launches and exchanges per PCG iteration
    of each run; with ``spec["error"]`` rank 0 adds the L2 error of the
    last run's iterate."""
    out = []
    for spec in specs:
        if spec.get("print"):
            print(f"rank {comm.rank} {comm.coords} on {comm.device}"
                  + (f" ({torch.cuda.get_device_name(comm.device)})"
                     if comm.device.type == "cuda" else ""), flush=True)
        t0 = time.perf_counter()
        solver = build_mesh_solver(comm, spec)
        setup = time.perf_counter() - t0
        t0 = time.perf_counter()
        if spec.get("loads"):
            for dt in {solver.dtype, torch.float64}:
                solver._loads(dt)
        loads = time.perf_counter() - t0
        runs, prev = [], None
        for method, kw in spec.get("runs", [("solve", {})]):
            kw = dict(kw)
            if kw.get("x0") == "previous":
                kw["x0"] = prev
            for m in _kernel_modules():
                m.reset_launch_counts()
            ex0, st0, s0 = comm.exchanges, comm.bytes_staged, comm.seconds
            res = getattr(solver, method)(**kw)
            prev = res.U
            r = _result(res, solver, comm)
            r["exchanges"] -= ex0
            r["bytes_staged"] -= st0
            r["comm_seconds"] -= s0
            mine = {k.name: k.launches for m in _kernel_modules()
                    for k in m.KERNELS.values() if k.launches}
            if spec.get("print") and mine:
                it = max(res.iterations, 1)
                print(f"rank {comm.rank} {comm.coords} {spec['problem']} "
                      f"{method}: per PCG iteration "
                      f"{ {k: round(v / it, 2) for k, v in mine.items()} }, "
                      f"{r['exchanges'] / it:.1f} exchanges, "
                      f"{r['bytes_staged'] / it / 2**20:.2f} MiB staged, "
                      f"{r['comm_seconds']:.4f} s in collectives of "
                      f"{res.solve_seconds + res.transfer_seconds:.4f} s",
                      flush=True)
            r["launches"] = _launches(comm)
            runs.append(r)
        if spec.get("error") and comm.rank == 0:
            runs[-1]["l2_error"] = solver._l2_error(runs[-1]["U"])
        info = dict(solver.layout_info(), setup_seconds=setup,
                    loads_seconds=loads, device=str(comm.device),
                    N=solver.N, m=solver.m,
                    foreign=sorted(m for m in sys.modules
                                   if m.split(".")[0] in ("jax", "jaxlib",
                                                          "spacetime_tpu")))
        out.append({"runs": runs, "info": info})
        del solver
    return out
