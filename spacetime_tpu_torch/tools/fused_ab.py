"""The fused stages K6, K7, K14 and K15 against an earlier tree's, on one
GPU; the 2-D solves against the earlier tree's; the callers of the solves'
copies.

    python -m spacetime_tpu_torch.tools.fused_ab --parent DIR [--dims 2,3]
        [--chunks] [--solves [2d|3d|all]] [--copies]

DIR is the root of another checkout of the repository (an unpacked
``git archive`` of an earlier commit, say). Its ``csrc/mg.cu`` and
``csrc/common.cu`` are built with nvcc into ``DIR/build/parent_mg/`` as one
library and loaded beside this tree's kernels, which load as every caller
loads them (``ops.native``). Of DIR's library the tool binds the fused
entry points ``mg_fused_pre``, ``mg_fused_pre_var``, ``mg_fused_post``,
``mg_fused_post_var``, ``mg_sh_fused_pre`` and ``mg_sh_fused_post`` (f32
and f64) with the signatures of a tree whose fused stages all take the
march's chunk (the 2-D K6/K7/K14/K15 ignoring it); each gets the chunk
this tree's wrapper picks.

- ``kernels`` (always), ν ∈ {2, 3}, float32 and float64: in 2-D (``--dims``
  2) K6 and K7 at 129×511², 129×255² and 65×127² (the 2-D flagship's
  levels at K_X's rows), the sharded K6 and K7 at the (2 × 2) flagship's
  finest slab 65×(256 + 2h)×511 (own 256, h = ν + 1, the mesh's halo), K14
  and K15 at 129×511² (varcoef2d weights tiled to it); in 3-D (``--dims``
  3) K6 and K7 at 65×63³ and 65×127³, K14 and K15 at 33×63³ and 33×127³
  (the varcoef3d 65³ solver's finest weights, tiled to 127³), the sharded
  K7 at the (2 × 2) smooth3d 65³ mesh's finest slab 17×38×63² (own 32, h
  3). Each launch of this tree and of DIR on the same inputs, max|new −
  old| and both held to the plain twin within 1e-5·max|twin| (f32) and
  1e-13 (f64); median device times of new, old and the semi-fused pair (K3
  from 0 + K8, K9 + K3 from x, K10 from 0 + K13, K9 + K10 from x; none for
  the sharded forms, whose mesh path runs K8/K9 on the own planes only)
  in the order old, new, pair, new, old. Also the blocks per SM of each
  march instantiation (the 2-D ones on rows of 511 columns).
- ``--chunks``: the 2-D K6 and K7 of this tree at the chunk of rows the
  wrapper picks (``ops.mg_kernels.march2_chunk``) and at half and twice
  it, at the 2-D shapes, f32 and f64, ν ∈ {2, 3}.
- ``--solves``: steady ``solve`` seconds, f32, ``inner="mg"``, by ``run.py
  --repeat 3`` in DIR, this tree, this tree, DIR (one process each): 2d
  (the default) smooth2d 513²×128, singular2d 513² J7+6, cfg2 (129²×64)
  and varcoef2d 513²×128 (the control: its K14/K15 are not changed); 3d
  smooth3d, varcoef3d and singular3d 65³ J5+4.
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
# (T, grid) of K6/K7 and of K14/K15, by dimension
CONST_SHAPES = {2: [(129, (511, 511)), (129, (255, 255)), (65, (127, 127))],
                3: [(65, (63,) * 3), (65, (127,) * 3)]}
VAR_SHAPES = {2: [(129, (511, 511))], 3: [(33, (63,) * 3), (33, (127,) * 3)]}
# (T, own, h, the other extents) of the sharded stages' slab (h 0: ν + 1)
SLABS = {2: (65, 256, 0, (511,)), 3: (17, 32, 3, (63, 63))}
SOLVES = {
    "2d": [
        ("smooth2d", ["--space-n", "512", "--time-levels", "7"]),
        ("singular2d", ["--problem", "singular2d", "--space-n", "512",
                        "--time-levels", "7", "--extra-levels", "6"]),
        ("cfg2", ["--space-n", "128", "--time-levels", "6"]),
        ("varcoef2d", ["--problem", "varcoef2d", "--space-n", "512",
                       "--time-levels", "7"]),
    ],
    "3d": [
        ("smooth3d", ["--problem", "smooth3d", "--space-n", "64",
                      "--time-levels", "5"]),
        ("varcoef3d", ["--problem", "varcoef3d", "--space-n", "64",
                       "--time-levels", "5"]),
        ("singular3d", ["--problem", "singular3d", "--space-n", "64",
                        "--time-levels", "5", "--extra-levels", "4"]),
    ],
}
# the solves --copies traces: (problem, cells, time levels, extra levels)
COPY_TRACES = [("smooth2d", 512, 7, 0), ("singular2d", 512, 7, 6)]


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
        "mg_fused_post": [P] * 8 + grid + [P, I, I, P],
        "mg_fused_post_var": [P] * 8 + grid + [P, P, I, I, P],
        "mg_sh_fused_pre": [P] * 8 + grid + [P, I, I, I, I, P],
        "mg_sh_fused_post": [P] * 9 + grid + [P, I, I, I, I, I, P],
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
    for post, nu, f64 in ((p, n, f) for p in (0, 1) for n in (2, 3)
                          for f in (0, 1)):
        blocks, nbytes, threads, nseg = (ctypes.c_int() for _ in range(4))
        err = lib.mg_march2_occupancy(post, nu, f64, 511, ctypes.byref(blocks),
                                      ctypes.byref(nbytes),
                                      ctypes.byref(threads),
                                      ctypes.byref(nseg))
        native.check(lib, "mg_march2_occupancy", err)
        _emit({"march": "2-D K7" if post else "2-D K6", "nu": nu,
               "dtype": "float64" if f64 else "float32", "nx": 511,
               "blocks_per_sm": blocks.value, "smem_bytes": nbytes.value,
               "threads": threads.value})


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


def run_var(so, dim, rng) -> None:
    """K14 and K15 of ``dim``: W of the varcoef solver's finest level
    tiled to each shape."""
    from ..solver import build_solver

    var = build_solver("varcoef3d" if dim == 3 else "varcoef2d",
                       64 if dim == 3 else 128, 5, dtype=torch.float32,
                       device="cuda").msmg
    Aw = var.levels[0].Aw
    for dtype in (torch.float32, torch.float64):
        sfx = "f32" if dtype == torch.float32 else "f64"
        mk = _fields(rng, dtype)
        for T, gs in VAR_SHAPES[dim]:
            grow = [(0, 0)] + [(0, max(n - m, 0))
                               for n, m in zip(gs, Aw.shape[1:])]
            cut = (slice(None),) + tuple(slice(0, n) for n in gs)
            W = torch.as_tensor(np.ascontiguousarray(
                np.pad(Aw, grow, mode="wrap")[cut]), dtype=dtype,
                device="cuda")
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
                        lambda: kl.fused_pre_plain(b, cols, W), pair_pre)
                compare("K15", kl, T, dtype,
                        lambda: (kl.fused_post(x, b, ec, cols, W),), old_post,
                        lambda: (kl.fused_post_plain(x, b, ec, cols, W),),
                        lambda: (kl.smooth(kl.prolong_correct(x, ec), b,
                                           cols, W),))
                del b, x, ec, xo, rc, out
                torch.cuda.empty_cache()
            del W


def run_chunks(lev, msmg, rng) -> None:
    """This tree's 2-D K6 and K7 at the chunk their wrapper picks
    (``march2_chunk``) and at half and twice it."""
    for dtype in (torch.float32, torch.float64):
        mk = _fields(rng, dtype)
        for (T, gs), nu in ((s, n) for s in CONST_SHAPES[2] for n in (2, 3)):
            kl = MSKernelLevel(lev.A_st, lev.M_st, nu, gs=gs)
            b, x = mk((T,) + gs), mk((T,) + gs)
            ec = mk((T,) + kl.coarse_gs)
            cols = kl.columns(row_params(
                msmg, np.abs(rng.standard_normal(T)) * 20, dtype, "cuda")[0])
            for stage, n in (("pre", kl.coarse_gs[0]), ("post", gs[0])):
                fn = ((lambda: kl.fused_pre(b, cols)) if stage == "pre" else
                      (lambda: kl.fused_post(x, b, ec, cols)))
                picked = kl._chunk(b, n, stage)
                for chunk in sorted({max(picked // 2, 1), picked,
                                     min(2 * picked, n)}):
                    kl._chunk = lambda *_, c=chunk: c
                    _emit({"kernel": "K6" if stage == "pre" else "K7",
                           "T": T, "gs": list(gs), "nu": nu,
                           "dtype": str(dtype)[6:], "picked": picked,
                           "chunk": chunk, "ms": device_ms(fn)})
                    del kl._chunk
            del b, x, ec
            torch.cuda.empty_cache()


def run_kernels(parent: Path, dims, chunks: bool) -> None:
    from ..solver import build_solver

    so = build_parent(parent)
    occupancy()
    rng = np.random.default_rng(0)
    for dim in dims:
        small = build_solver("smooth3d" if dim == 3 else "smooth2d", 8, 1,
                             dtype=torch.float32, device="cuda",
                             inner="mg").msmg
        run_const(so, small.levels[0], small, dim, rng)
        run_var(so, dim, rng)
        if dim == 2 and chunks:
            run_chunks(small.levels[0], small, rng)


def run_solves(parent: Path, which: str) -> None:
    """run.py --repeat 3 in the parent and this tree, in turns."""
    runs = SOLVES["2d"] + SOLVES["3d"] if which == "all" else SOLVES[which]
    for name, args in runs:
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
    p.add_argument("--chunks", action="store_true",
                   help="time the 2-D K6/K7 at half and twice their chunk")
    p.add_argument("--solves", nargs="?", const="2d", default=None,
                   choices=["2d", "3d", "all"])
    p.add_argument("--copies", action="store_true")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("fused_ab needs an NVIDIA GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    dims = [int(d) for d in args.dims.split(",") if d]
    run_kernels(args.parent.resolve(), dims, args.chunks)
    if args.copies:
        trace_copies()
    if args.solves:
        run_solves(args.parent.resolve(), args.solves)
    return 0


if __name__ == "__main__":
    sys.exit(main())
