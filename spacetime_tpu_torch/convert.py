"""The JAX solver's params in the port's layout.

``params_from_jax`` takes the params pytree of a JAX ``HeatSolver`` (stencil
path, ``inner="mg"``) with its leaves as numpy arrays, and returns the dict
``spacetime_tpu_torch.solver.HeatSolver.params_for`` builds. The JAX
package pre-broadcasts per-time-row scales to (T, *gs[:-1], 1) and the
kernels' h columns to (T, 1, 128) lanes; the port keeps (T, 1, ..., 1)
columns and (T,) vectors. Tests hold the two solvers' params equal through
this.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.stencil import row_scale


def _rows(a) -> np.ndarray:
    """(T, ...) row-constant array -> its (T,) values."""
    a = np.asarray(a)
    return a.reshape(a.shape[0], -1)[:, 0].copy()


def params_from_jax(tree: dict, device, dtype) -> dict:
    mk = lambda a: torch.tensor(np.asarray(a), dtype=dtype, device=device)
    dim = np.asarray(tree["h_half"]).ndim - 1
    col = lambda a: row_scale(_rows(a), dim, dtype, device)
    p = {k: col(tree[k]) for k in ("h_half", "h_stab", "inv_h")}
    wt = tree["wavelet"]
    if "Wd" in wt:
        p["wavelet"] = {"Wd": mk(wt["Wd"]), "WdT": mk(wt["WdT"])}
    else:
        p["wavelet"] = {
            "levels": [
                {k: mk(np.asarray(lw[k]).reshape(-1)) for k in ("wl", "wr", "s")}
                for lw in wt["levels"]
            ]
        }
    kr = tree.get("kron")
    h128 = _rows(kr["h128"]) if kr is not None else _rows(tree["h_half"])
    hs128 = _rows(kr["hs128"]) if kr is not None else _rows(tree["h_stab"])
    p["kron"] = {"h128": mk(h128), "hs128": mk(hs128)}
    p["mg_cinv_ky"] = mk(tree["mg_cinv_ky"])
    p["mg_cinv"] = [mk(S) for S in tree["mg_cinv"]]
    for name in ("ms_ky", "ms_kx"):
        p[name] = [
            {k: col(lp[k]) for k in ("omega", "inv_diag", "inv_theta", "inv_delta")}
            for lp in tree[name]
        ]
    return p
