"""The plan of the weighted time march (K11, K12 and K10's steps)
against its alternatives, on one GPU.

    python -m spacetime_tpu_torch.tools.var_tune

csrc/mg.cu's plan of ``mg_var_stencil_kernel`` (the 2-D segment
``var_seg``, the pencil ``var_pencil``, the blocks an SM ``var_min_blocks``
and ``kVarStepBlocks``, and where the weights sit) is one choice among a
few that compute the same sums. Each variant of ``VARIANTS`` is this
tree's mg.cu with those lines replaced; each is built with nvcc into
``build/var_tune/NAME/`` (all at once) beside the tree's own plan
("final"), and K11, K12 and K10 (ν = 2, from x and from 0) of each are
timed at ``SHAPES`` in float32 and float64, each with its own plan (its
chunks from its own ``mg_var_stencil_occupancy``), in the order v0 … vN,
vN … v0 by CUDA events (``utils.profiling.device_ms``). Every variant's
output must equal the final plan's bit for bit, and that one its plain
twin within 1e-5·max|twin| (f32) and 1e-13 (f64). Prints one JSON line a
(kernel, dtype, shape): each variant's mean ms and plan (chunk, blocks an
SM, blocks a chunk; K10's of its later step), and ptxas's spills of each
variant's kernels, then the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import itertools
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

from ..ops import native
from ..ops.mg_kernels import VarMSKernelLevel, var_stencil_chunk
from ..ops.multigrid import var_row_params
from ..utils.profiling import device_ms

OUT = native.BUILD_DIR.parent / "var_tune"
# the final plan's lines that the variants replace
SEG = "  return MODE == kVarApply ? 574 : 254;"
PENCIL = "  return DIM == 3 || (MODE != kVarApply && sizeof(T) == 8) ? 2 : 4;"
STEP_BLOCKS = "constexpr int kVarStepBlocks = 2;"
DIM3_BLOCKS = "  if (DIM == 3) return 2;"
# name -> {final line: variant line}
VARIANTS = {
    # K10's steps in 2-D at three blocks an SM (K11's), or one
    "steps-3": {STEP_BLOCKS: "constexpr int kVarStepBlocks = 3;"},
    "steps-1": {STEP_BLOCKS: "constexpr int kVarStepBlocks = 1;"},
    # K10's steps (and K11) on whole rows, as K12
    "steps-wide": {SEG: "  return 574;"},
    # 3-D at one block an SM (no spills in float64)
    "3d-1": {DIM3_BLOCKS: "  if (DIM == 3) return 1;"},
}
# the kernels timed: K11, K12, and K10's sweeps of ν = 2 from x and from 0
FORMS = ("K11", "K12", "K10 from x", "K10 from 0")
# (T, grid): varcoef2d 513²'s two finest levels at K_X's rows, a row of
# many segments, varcoef3d 65³'s finest level at K_X's rows and 129³'s
SHAPES = [(129, (511, 511)), (129, (255, 255)), (33, (255, 1985)),
          (33, (63,) * 3), (33, (127,) * 3)]
TOL = {torch.float32: 1e-5, torch.float64: 1e-13}


def build_variants() -> dict:
    """{name: library} of the final plan and of each variant: mg.cu with the
    variant's lines replaced, with common.cu, one nvcc each, all at once;
    prints ptxas's spills of their K11/K12 kernels."""
    src = (native.CSRC / "mg.cu").read_text()
    jobs = {}
    for name, subs in {"final": {}, **VARIANTS}.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        text = src
        for old, new in subs.items():
            if old not in text:
                raise RuntimeError(f"{name}: csrc/mg.cu lacks {old!r}")
            text = text.replace(old, new)
        (d / "mg.cu").write_text(text)
        cmd = [native._nvcc(), *native.NVCC_FLAGS, "-shared", "-o",
               str(d / "lib.so"), str(d / "mg.cu"),
               str(native.CSRC / "common.cu")]
        jobs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
    libs = {}
    signatures = native.entry_signatures()
    I, P, I64 = ctypes.c_int, ctypes.c_void_p, ctypes.c_int64
    for name, job in jobs.items():
        log, _ = job.communicate()
        if job.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log[-4000:]}")
        entry = None
        for line in log.splitlines():
            if "Compiling entry" in line:
                m = re.search(r"mg_var_stencil_kernelILi(\d)E([fd])Li(\d)E"
                              r"Lb([01])E", line)
                entry = m.groups() if m else None
            elif entry and "spill" in line:
                print(json.dumps({"variant": name, "kernel": entry,
                                  "ptxas": line.split(":", 1)[-1].strip()}))
        so = ctypes.CDLL(str(OUT / name / "lib.so"))
        for op, sfx in itertools.product(("mg_residual_var", "mg_apply_var",
                                          "mg_smooth_var"), ("f32", "f64")):
            fn = getattr(so, f"{op}_{sfx}")
            fn.argtypes, fn.restype = signatures[op], I
        so.mg_var_stencil_occupancy.argtypes = [I, I, I, I, I64, I64, I64, P,
                                                P, P, P]
        so.mg_var_stencil_occupancy.restype = I
        libs[name] = so
    return libs


def plan(so, mode: str, dtype, ntaps: int, gs) -> tuple[int, int]:
    """(blocks an SM, blocks a chunk) of library ``so``'s march in
    ``mode`` (``ops.mg_kernels.VAR_MODES``)."""
    from ..ops.mg_kernels import VAR_MODES

    out = [ctypes.c_int() for _ in range(4)]
    zyx = (1,) * (3 - len(gs)) + tuple(gs)
    err = so.mg_var_stencil_occupancy(VAR_MODES[mode], len(gs),
                                      int(dtype == torch.float64), ntaps,
                                      *zyx, *map(ctypes.byref, out))
    if err != 0:
        raise RuntimeError(f"mg_var_stencil_occupancy: error {err}")
    return max(out[0].value, 1), out[3].value


def _launch(fn, args) -> None:
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__}: error {err}")


def main() -> int:
    if not torch.cuda.is_available():
        print("var_tune needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from ..solver import build_solver
    from .fused_ab import _call, tiled_weights, var_lib_smooth

    t0 = time.perf_counter()
    libs = build_variants()
    print(json.dumps({"built": len(libs),
                      "seconds": time.perf_counter() - t0}), flush=True)
    var = {dim: build_solver("varcoef3d" if dim == 3 else "varcoef2d",
                             64 if dim == 3 else 128, 5, device="cpu").msmg
           for dim in (2, 3)}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(18)
    for dtype, (T, gs) in itertools.product((torch.float32, torch.float64),
                                            SHAPES):
        ms = var[len(gs)]
        kl = VarMSKernelLevel(ms.levels[0], 2, gs=gs)
        W = tiled_weights(ms, gs, dtype)
        gen = torch.Generator(device="cuda").manual_seed(
            int(rng.integers(1 << 30)))
        x, b = (torch.randn((T,) + gs, generator=gen, device="cuda",
                            dtype=dtype) for _ in range(2))
        cols = kl.columns(var_row_params(
            ms, np.abs(rng.standard_normal(T)) * 20, dtype, "cuda")[0])
        vt, pm = kl._tables()
        ntaps, sfx = len(kl.A_vs.disps), str(dtype)[-2:]
        for form in FORMS:
            zero = form == "K10 from 0"
            want = (kl.residual_plain(x, b, cols, W) if form == "K11"
                    else kl.apply_A_plain(x, W) if form == "K12"
                    else kl.smooth_plain(x, b, cols, W, zero_init=zero))
            outs, fns, plans = {}, {}, {}
            for name, so in libs.items():
                def chunk_of(mode, last=False, so=so):
                    resident, tiles = plan(so, mode, dtype, ntaps, gs)
                    return var_stencil_chunk(T, mode, ntaps, resident, tiles,
                                             sms, last)
                mode = {"K11": "residual", "K12": "apply"}.get(form, "step")
                resident, tiles = plan(so, mode, dtype, ntaps, gs)
                plans[name] = {"chunk": chunk_of(mode),
                               "blocks_per_sm": resident, "tiles": tiles}
                out = torch.empty_like(x)
                if form == "K11":
                    fn = getattr(so, f"mg_residual_var_f{sfx}")
                    args = (x.data_ptr(), b.data_ptr(), W.data_ptr(),
                            cols["omega"].data_ptr(), out.data_ptr(), T,
                            *kl._zyx(), vt, pm, chunk_of(mode))
                elif form == "K12":
                    fn = getattr(so, f"mg_apply_var_f{sfx}")
                    args = (x.data_ptr(), W.data_ptr(), out.data_ptr(), T,
                            *kl._zyx(), vt, chunk_of(mode))
                if form.startswith("K10"):
                    fns[name] = lambda so=so, c=chunk_of: var_lib_smooth(
                        _call, so, kl, x, b, W, cols, 2, zero, c)
                    out = fns[name]()
                else:
                    fns[name] = lambda fn=fn, args=args: _launch(fn, args)
                    fns[name]()
                torch.cuda.synchronize()
                outs[name] = out
            scale = float(want.abs().max())
            err = float((outs["final"] - want).abs().max())
            if err > TOL[dtype] * scale:
                raise AssertionError((gs, str(dtype), form, err, scale))
            for name, out in outs.items():
                if not torch.equal(out, outs["final"]):
                    raise AssertionError(f"{name} differs from the final plan")
            times = {name: [] for name in libs}
            for name in list(libs) + list(libs)[::-1]:
                times[name].append(device_ms(fns[name]))
            print(json.dumps({
                "kernel": form, "dtype": str(dtype)[6:],
                "T": T, "gs": list(gs),
                "ms": {n: float(np.mean(v)) for n, v in times.items()},
                "plans": plans}), flush=True)
        del x, b, W, outs, fns
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
