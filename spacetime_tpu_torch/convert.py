"""The JAX solver's params in the port's layout.

``params_from_jax`` takes the params pytree of a JAX ``HeatSolver`` with its
leaves as numpy arrays, and returns the dict
``spacetime_tpu_torch.solver.HeatSolver.params_for`` builds for the same
format and inner solver:

- every format: the per-time-row scales and the wavelet tensors (on a
  graded grid the lifting's gather indices ``idx``/``pl``/``pr``,
  ``root_idx`` and ``root_s``, and the level permutation ``perm`` /
  ``inv_perm``, as int64 where they are indices). The JAX
  package pre-broadcasts per-row scales to (T, *gs[:-1], 1) and the
  kernels' h columns and multigrid ``cols`` to (T, 1, 128) lanes; the port
  keeps (T, 1, ..., 1) columns and (T,) vectors;
- ``"stencil"``: ``kron`` (taken from the row scales where the JAX solver
  built no Pallas B/Bᵀ); ``"vstencil"``: the weights ``Aw``; ``"dia"``:
  ``dia_Mv``/``dia_Av``; ``"ell"``: also ``ell_M``/``ell_A``, the JAX
  blocks packed to K20's row-packed layout (``ell_params_from_jax``). A JAX f64 solver on ``"ell"`` holds no ELL arrays (it
  falls back to DIA) and the port's ``"ell"`` format needs them, so only
  f32 JAX trees carry that format over;
- ``inner="dense"``: ``Kx_inv``, ``Minv`` and the ``sandwich`` list;
- ``inner="cheb"``: the Jacobi vectors ``cheb_invA``/``invM``/``invS`` and
  the coefficient rows ``cheb_coefA``/``coefM``/``coefS`` as lists of
  (α_k, β_k) Python floats (the port loops over them where JAX scans);
- ``inner="mg"``: the coarse inverses and each level's row params. A JAX
  level built without Pallas kernels (f64, or below its size gate) has no
  ``cols``; the port's kernels run on every level, so its columns are then
  taken from the level's row params, which hold the same values. The
  weighted tree's levels carry their ``Aw``; its ``cheb_invM`` and
  ``cheb_coefM`` are dropped: M is the constant mass stencil, so the Jacobi
  vector holds one value, and the port's K_H is the constant format's
  stencil Chebyshev, the same recurrence;
- the flat hierarchies (nested red refinement, smoothed aggregation: levels
  with gather transfers ``Pidx``): each level's diagonals, transfers, DIA
  values or ELL gather rows and factored-transfer arrays, ``cheb_invM`` and
  ``cheb_coefM``, and the kernels' values ``kv``: the union-offset DIA
  values (from the level's ``Av``/``Mv`` and the offsets of ``hierarchy``,
  the host structure of either package) or the packed K19/K20 layouts,
  re-laid from the level's gather rows through blocked ELL (the JAX
  kernels' ``plv``/``ellv`` are left: the same values in the TPU's
  layout).

Tests hold the two solvers' params and operators equal through this.

The mesh layouts (``parallel.explicit``, ``parallel.explicit2d``) carry a
global state across to the ranks and back, as the JAX solvers' layout
hooks do (``_dup_rows``, ``_pad_tests`` / ``_pad_all``, ``_prepare_x0``,
``_device_iterate_flat``): ``to_time_layout`` / ``from_time_layout`` (the
duplicated trial rows, the general layout's padding slots zeroed by its
``m_trial``), ``pad_rows`` (the padded test rows), ``pad_planes`` /
``slab`` (the padded plane slabs of the space axis). They index numpy
arrays and torch tensors alike.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.mg_kernels import MSKernelLevel, VarMSKernelLevel
from .ops.multigrid import coef_rows
from .ops.stencil import row_scale


def _rows(a) -> np.ndarray:
    """(T, ...) row-constant array -> its (T,) values."""
    a = np.asarray(a)
    return a.reshape(a.shape[0], -1)[:, 0].copy()


def _flat_level(lp, lev, device, dtype, shared: dict, li: int) -> dict:
    """One level of a flat hierarchy's row params; ``shared`` keeps the
    shift-independent tensors of level ``li`` for the next shift vector."""
    from types import SimpleNamespace

    from .ops.dia_kernels import DiaKernelLevel
    from .ops.spmv import EllKernelLevel

    mk = lambda a: torch.tensor(np.asarray(a), dtype=dtype, device=device)
    ids = lambda a: torch.tensor(np.asarray(a, np.int64), device=device)
    col = lambda a: mk(_rows(a)).reshape(-1, 1)
    q = {k: col(lp[k]) for k in ("omega", "inv_theta", "inv_delta")}
    q["cols"] = {"omega": q["omega"].reshape(-1),
                 "invT": q["inv_theta"].reshape(-1),
                 "invDel": q["inv_delta"].reshape(-1)}
    if li not in shared:
        host = {k: np.asarray(v) for k, v in lp.items()
                if k not in ("omega", "inv_theta", "inv_delta", "cols",
                             "plv", "ellv")}
        a = {k: (ids(v) if k in ("Pidx", "Ridx", "eidx", "agg", "mem_idx")
                 else mk(v)) for k, v in host.items()}
        if "Av" in host:
            ns = SimpleNamespace(fmt="dia", m=host["dA"].shape[0],
                                 offA=lev.offA, offM=lev.offM, **host)
            a["kv"] = DiaKernelLevel(ns, 1).values(ns, dtype, device)
        else:
            ns = SimpleNamespace(fmt="ell", **host)
            a["kv"] = EllKernelLevel(ns).values(ns, dtype, device)
        shared[li] = a
    q.update(shared[li])
    return q


def ell_params_from_jax(ell: dict, m: int, dtype, device) -> dict:
    """K20's packed params (``ops.spmv.packed_params``) of a JAX
    ``EllOperator``'s ``{"blocks", "colidx"}`` for a matrix of ``m`` rows,
    packed from those blocks by ``ops.spmv.pack_blocks``."""
    from .ops.spmv import pack_blocks, packed_params

    packed = pack_blocks([np.asarray(ell["blocks"])],
                         np.asarray(ell["colidx"]), m)
    return packed_params(packed, dtype, device)


def params_from_jax(tree: dict, device, dtype, hierarchy=None) -> dict:
    mk = lambda a: torch.tensor(np.asarray(a), dtype=dtype, device=device)
    dim = np.asarray(tree["h_half"]).ndim - 1
    col = lambda a: row_scale(_rows(a), dim, dtype, device)
    p = {k: col(tree[k]) for k in ("h_half", "h_stab", "inv_h")}
    ids = lambda a: torch.tensor(np.asarray(a, np.int64), device=device)
    wt = tree["wavelet"]
    if "Wd" in wt:
        p["wavelet"] = {"Wd": mk(wt["Wd"]), "WdT": mk(wt["WdT"])}
    else:
        p["wavelet"] = {
            "levels": [
                {k: (ids(v) if k in ("idx", "pl", "pr")
                     else mk(np.asarray(v).reshape(-1)))
                 for k, v in lw.items()}
                for lw in wt["levels"]
            ]
        }
        if "root_idx" in wt:
            p["wavelet"]["root_idx"] = ids(wt["root_idx"])
            p["wavelet"]["root_s"] = mk(np.asarray(wt["root_s"]).reshape(-1))
    for k in ("perm", "inv_perm"):
        if k in tree:
            p[k] = ids(tree[k])
    weighted = "Aw" in tree
    flat = "dia_Mv" in tree
    if weighted:
        p["Aw"] = mk(tree["Aw"])
    elif flat:
        p["dia_Mv"], p["dia_Av"] = mk(tree["dia_Mv"]), mk(tree["dia_Av"])
        m = np.asarray(tree["dia_Mv"]).shape[0]
        for k in ("ell_M", "ell_A"):
            if k in tree:
                p[k] = ell_params_from_jax(tree[k], m, dtype, device)
    else:
        kr = tree.get("kron")
        h128 = _rows(kr["h128"]) if kr is not None else _rows(tree["h_half"])
        hs128 = _rows(kr["hs128"]) if kr is not None else _rows(tree["h_stab"])
        p["kron"] = {"h128": mk(h128), "hs128": mk(hs128)}
    if "Kx_inv" in tree:
        p["Kx_inv"], p["Minv"] = mk(tree["Kx_inv"]), mk(tree["Minv"])
        p["sandwich"] = [mk(S) for S in tree["sandwich"]]
    if "cheb_coefA" in tree:
        for k in ("cheb_invA", "cheb_invM"):
            p[k] = mk(tree[k])
        p["cheb_invS"] = [mk(v) for v in tree["cheb_invS"]]
        p["cheb_coefA"] = coef_rows(tree["cheb_coefA"], dtype)
        p["cheb_coefM"] = coef_rows(tree["cheb_coefM"], dtype)
        p["cheb_coefS"] = [coef_rows(c, dtype) for c in tree["cheb_coefS"]]
    if "ms_ky" not in tree:
        return p
    if "Pidx" in tree["ms_ky"][0]:
        p["mg_cinv_ky"] = mk(tree["mg_cinv_ky"])
        p["mg_cinv"] = [mk(S) for S in tree["mg_cinv"]]
        p["cheb_invM"] = mk(tree["cheb_invM"])
        p["cheb_coefM"] = coef_rows(tree["cheb_coefM"], dtype)
        shared: dict = {}
        for name in ("ms_ky", "ms_kx"):
            p[name] = [_flat_level(lp, lev, device, dtype, shared, li)
                       for li, (lp, lev) in enumerate(
                           zip(tree[name], hierarchy.levels))]
        return p
    if weighted:
        level, rows = VarMSKernelLevel, ("omega", "inv_theta", "inv_delta")
    else:
        level = MSKernelLevel
        rows = ("omega", "inv_diag", "inv_theta", "inv_delta")
    p["mg_cinv_ky"] = mk(tree["mg_cinv_ky"])
    p["mg_cinv"] = [mk(S) for S in tree["mg_cinv"]]
    for name in ("ms_ky", "ms_kx"):
        p[name] = []
        for lp in tree[name]:
            q = {k: col(lp[k]) for k in rows}
            if weighted:
                q["Aw"] = mk(lp["Aw"])
            if "cols" in lp:
                q["cols"] = {k: mk(_rows(v)) for k, v in lp["cols"].items()}
            else:
                q["cols"] = level.columns(q)
            p[name].append(q)
    return p


# ------------------------------------------------------------ mesh layouts


def dup_index(N: int, P: int, R: int) -> np.ndarray:
    """The global trial rows of the duplicated time layout, (P·(R+1),):
    rank d holds rows dR .. dR+R; padding slots clipped to row N."""
    idx = (np.arange(P)[:, None] * R + np.arange(R + 1)[None]).reshape(-1)
    return np.minimum(idx, N)


def to_time_layout(U, N: int, P: int, R: int, m_trial=None):
    """(N+1, ...) per-trial-row array -> (P·(R+1), ...), the ranks' rows
    stacked; ``m_trial`` (the general layout's) zeroes the padding slots."""
    D = U[dup_index(N, P, R)]
    if m_trial is not None:
        m = np.asarray(m_trial).reshape((-1,) + (1,) * (D.ndim - 1))
        D = D * (torch.as_tensor(m, dtype=D.dtype, device=D.device)
                 if isinstance(D, torch.Tensor) else m)
    return D


def from_time_layout(Ud, N: int, P: int, R: int):
    """(P·(R+1), ...) -> (N+1, ...): each rank's first R rows, the last
    rank's slot R, cut to N+1 rows (the general layout's padding)."""
    sel = np.concatenate([
        (np.arange(P)[:, None] * (R + 1) + np.arange(R)[None]).reshape(-1),
        [P * (R + 1) - 1]])
    return Ud[sel[: N + 1]]


def _pad_axis(X, axis: int, n: int):
    if isinstance(X, torch.Tensor):
        pad = [0, 0] * (X.ndim - axis)
        pad[-1] = n - X.shape[axis]
        return torch.nn.functional.pad(X, pad)
    pad = [(0, 0)] * X.ndim
    pad[axis] = (0, n - X.shape[axis])
    return np.pad(X, pad)


def pad_rows(X, rows: int):
    """(N, ...) test rows zero-padded to the P·R rows of the layout."""
    return _pad_axis(X, 0, rows)


def pad_planes(X, Ps: int, Rs: int, axis: int = 1):
    """The leading grid axis (``axis``) zero-padded to P_s·Rs planes."""
    return _pad_axis(X, axis, Ps * Rs)


def slab(Xp, ds: int, Rs: int, axis: int = 1):
    """Space rank ds's Rs planes of a padded array."""
    sl = [slice(None)] * Xp.ndim
    sl[axis] = slice(ds * Rs, (ds + 1) * Rs)
    return Xp[tuple(sl)]
