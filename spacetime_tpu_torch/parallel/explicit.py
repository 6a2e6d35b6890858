"""The explicit time-sharded solver: one rank per time shard, collectives
placed by hand.

The counterpart of ``spacetime_tpu/parallel/explicit.py``
(``ExplicitHeatSolver``), on ``torch.distributed`` (``parallel.comm``)
where the JAX package runs one ``shard_map`` program: every transfer is an
explicit exchange, sum or gather placed where the algorithm needs it, and
each rank runs the port's serial operators on its local block.

Layout: duplicated halo rows. With P ranks and N = P·R time steps, rank d
stores the trial rows [dR, dR+R], R+1 rows, the last one a copy of rank
d+1's first.

- B (trial → test) is local.
- Bᵀ on the local test rows (K2 with T = R, row −1 taken as zero) gives
  partial trial rows: slot 0 lacks V[dR−1]'s part and slot R V[dR+R]'s.
  One exchange of one row each way completes both copies
  (``_exchange_boundary``), and both owners add (left, right) in that
  order, so twin rows stay bitwise equal. The stabilization jump and the
  right-hand side ride the same exchange.
- Dots count the duplicated slot on the last rank only and are summed over
  the ranks (``Comm.psum``, in rank order).
- The wavelet transform runs levelwise: the fine levels (stride s < R) as
  strided slices plus one single-row exchange each, the coarse levels on
  the P + 1 shard-boundary rows, gathered once per transform and applied
  on every rank.
- K_Y and the middle of K_X are the serial multigrid (or dense inverses)
  per time shard: the kernel levels take any number of rows, and the
  coarse solves of K_X select each wavelet level's rows of the shard.

Graded grids, odd rank counts and N_t not divisible by P run on the
general layout (``parallel.general_layout``): R = ceil(N/P) rounded up to
even, padded test rows masked (``_mask_t``), per-level padded index arrays
with one small gather per level that crosses a shard boundary.

The port serves the constant-stencil format (``"stencil"``) with the
``"dense"`` and ``"mg"`` inner solvers and the standard PCG; the other
formats and inner solvers raise ``ValueError``, ``pcg_variant="fused"``
raises ``NotImplementedError`` (ROADMAP.md queue 1 item 6).
"""

from __future__ import annotations

import time as _time

import numpy as np
import torch

from ..convert import from_time_layout, pad_rows, to_time_layout
from ..fem import spacetime_loads
from ..ops import kron
from ..ops.multigrid import row_params
from ..ops.stencil import row_scale
from ..solver.heateq import HeatSolver, _later, _LoadsOn
from .comm import Comm
from .general_layout import build_general_layout


def _wcol(a, ndim: int):
    """(k,) weights -> (k, 1, ...) broadcast over the trailing axes."""
    return a.reshape(a.shape + (1,) * (ndim - 1))


def _with_drop_row(v):
    return torch.cat([v, v.new_zeros((1,) + tuple(v.shape[1:]))])


def _set_drop(v, idx, vals):
    """v.at[idx].set(vals, mode='drop') with idx ≤ R + 1 (= len(v)): the
    scatter goes to a buffer with one more row, which is dropped."""
    ext = _with_drop_row(v)
    ext.index_copy_(0, idx, vals)
    return ext[:-1]


def _add_drop(v, idx, vals):
    ext = _with_drop_row(v)
    ext.index_add_(0, idx, vals)
    return ext[:-1]


class ExplicitHeatSolver(HeatSolver):
    """``HeatSolver`` on one rank of a ``("time",)`` mesh; ``comm`` is the
    rank's ``parallel.comm.Comm``, and the solver runs on its device."""

    _mesh_axes = ("time",)
    _formats = ("stencil",)
    _inners = ("dense", "mg")

    def __init__(self, problem, system, grid, comm: Comm, **kwargs):
        if tuple(comm.mesh.axis_names) != self._mesh_axes:
            raise ValueError(f"{type(self).__name__} runs on a "
                             f"{self._mesh_axes} mesh, not "
                             f"{comm.mesh.axis_names}")
        if kwargs.get("pcg_variant", "standard") == "fused":
            raise _later("pcg_variant='fused' on a mesh", 6,
                         "PCG variants, checkpointing and the rest of the CLI")
        dev = kwargs.pop("device", None)
        if dev is not None and torch.device(dev) != comm.device:
            raise ValueError(f"device {dev} is not the rank's {comm.device}")
        self.comm = comm
        self.P = comm.axis_size("time")
        self.d = comm.axis_index("time")
        self._eparams_cache: dict = {}
        super().__init__(problem, system, grid, device=comm.device, **kwargs)

    # ------------------------------------------------------------- layout

    def _check_supported(self) -> None:
        if self.spatial_format not in self._formats:
            raise ValueError(
                f"the explicit meshes serve constant-stencil structured grids "
                f"(got spatial_format={self.spatial_format!r}); weighted and "
                "unstructured systems run on one device")
        if self.inner not in self._inners:
            raise ValueError(f"inner={self.inner!r} not supported on the "
                             "explicit meshes (use 'dense' or 'mg')")

    def _setup_layout(self) -> None:
        """The time layout: aligned (a uniform dyadic grid, P a power of two
        dividing N) or general."""
        if hasattr(self, "R"):
            return
        self._check_supported()
        N, P = self.N, self.P
        self.aligned = bool(self.wt.is_uniform and P & (P - 1) == 0
                            and N % P == 0)
        if self.aligned:
            self.R = N // P
            self.p_log = P.bit_length() - 1
            self.glay = None
        else:
            self.glay = build_general_layout(self.wt, P)
            self.R = self.glay.R
            self.p_log = None
        self.Np = P * self.R
        self.J = self.wt.num_levels
        self.gs_local = self.gs
        self._setup_space()

    def _setup_space(self) -> None:
        """The spatial layout (the time × space mesh shards it)."""

    def layout_info(self) -> dict:
        return {"aligned": self.aligned, "P": self.P, "R": self.R,
                "Np": self.Np, "gs_local": list(self.gs_local)}

    def _local_trial(self, a, masked: bool = False) -> np.ndarray:
        """This rank's R+1 rows of a per-trial-row array (N+1, ...) in the
        duplicated layout (``convert.to_time_layout``; with ``masked``, the
        general layout's padding slots zero)."""
        R = self.R
        m = None if self.aligned or not masked else self.glay.m_trial
        D = to_time_layout(np.asarray(a), self.N, self.P, R, m)
        return D[self.d * (R + 1):(self.d + 1) * (R + 1)]

    def _local_test(self, a) -> np.ndarray:
        """This rank's R rows of a per-test-row array (N, ...), padded to
        P·R rows with zeros (``convert.pad_rows``)."""
        return pad_rows(np.asarray(a), self.Np)[
            self.d * self.R:(self.d + 1) * self.R]

    # ------------------------------------------------------------- params

    def params_for(self, dtype: torch.dtype) -> dict:
        """This rank's params: per-row columns of its own rows, the
        replicated operators, the wavelet structure of its shard."""
        self._setup_layout()
        if dtype in self._eparams_cache:
            return self._eparams_cache[dtype]
        dev, nd = self.device, len(self.gs_local)
        cast = lambda x: torch.as_tensor(x, dtype=dtype, device=dev).contiguous()
        h = self._host["h"] if self.aligned else self.glay.h_pad
        hl = self._local_test(h)
        ep = {
            "inv_h": row_scale(1.0 / hl, nd, dtype, dev),
            "kron": {"h128": cast(0.5 * hl), "hs128": cast(hl / 16.0)},
        }
        if not self.aligned:
            R = self.R
            ep["mask_test"] = row_scale(
                self.glay.mask_test[self.d * R:(self.d + 1) * R], nd, dtype,
                dev)
            ep["w_dot"] = row_scale(
                self.glay.w_dot[self.d * (R + 1):(self.d + 1) * (R + 1)], nd,
                dtype, dev)
        if self.inner == "dense":
            ep["Kx_inv"] = cast(self._host["Kx_inv"])
            ep["Minv"] = cast(self._host["Minv"])
            ep["sandwich"] = [cast(S) for S in self._host["sandwich"]]
        else:
            ep["mg_cinv_ky"] = cast(self._host["mg_cinv_ky"])
            ep["mg_cinv"] = [cast(S) for S in self._host["mg_cinv"]]
            ep["ms_ky"], ep["ms_kx"] = self._ms_params(dtype)
        self._wavelet_params(ep, dtype)
        self._eparams_cache[dtype] = ep
        return ep

    def _omega_rows(self):
        """This rank's K_Y (test rows) and K_X (trial rows) shift rows."""
        return (self._local_test(self._host["omega_ky"]),
                self._local_trial(self._host["omega_kx"]))

    def _ms_params(self, dtype):
        """Per-level row params of K_Y's and K_X's rows on this rank, with
        the kernel levels' columns."""
        out = []
        for om in self._omega_rows():
            lps = row_params(self.msmg, om, dtype, self.device)
            for lp in lps:
                lp["cols"] = self._kl_ky[0].columns(lp)
            out.append(lps)
        return out

    def _wavelet_params(self, ep, dtype) -> None:
        dev = self.device
        cast = lambda x: torch.as_tensor(x, dtype=dtype, device=dev)
        idx = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.int64,
                                        device=dev)
        if self.aligned:
            fine, coarse = [], []
            for j, lev in enumerate(self.wt.levels, start=1):
                arrays = {"wl": lev.wl, "wr": lev.wr, "s": lev.s}
                if j > self.p_log:
                    k = lev.idx.size // self.P
                    fine.append({n: cast(a[self.d * k:(self.d + 1) * k])
                                 for n, a in arrays.items()})
                else:
                    coarse.append({n: cast(a) for n, a in arrays.items()})
            ep["w_fine"], ep["w_coarse"] = fine, coarse
            return
        d = self.d
        levels = []
        for gl in self.glay.levels:
            lw = {k: idx(getattr(gl, k)[d]) for k in (
                "lmid", "lpl", "lpr", "lpl_tgt", "lpr_tgt", "send_v",
                "send_c", "set_slot", "set_src", "add_slot", "add_src")}
            lw.update({k: cast(getattr(gl, k)[d]) for k in (
                "lwl", "lwr", "ls", "lpl_i0", "lpl_iR", "lpr_i0", "lpr_iR")})
            lw.update({k: idx(getattr(gl, k)) for k in (
                "g_mid", "g_pl", "g_pr", "g_c")})
            lw.update({k: cast(getattr(gl, k)) for k in ("g_wl", "g_wr",
                                                         "g_s")})
            levels.append(lw)
        ep["gw"] = {"levels": levels,
                    "root_slot": idx(self.glay.root_slot[d]),
                    "root_scale": cast(self.glay.root_scale[d])}
        ep["kxl"] = [idx(a[d]) for a in self.glay.kx_lvl]

    # ---------------------------------------------------- local collectives

    def _mask_t(self, X, ep):
        """Zero the padding test rows of the general layout (no-op when
        aligned): they would otherwise reach valid trial rows through Bᵀ."""
        m = ep.get("mask_test")
        return X if m is None else X * m

    def _exchange_boundary(self, part):
        """Complete partial trial rows: global row dR = (rank d−1's slot-R
        partial) + (rank d's slot-0 partial), added in that order on both
        owners."""
        R = self.R
        from_left, from_right = self.comm.exchange("time", part[R], part[0])
        out = part.clone()
        out[0] = from_left + part[0]
        out[R] = part[R] + from_right
        return out

    def _local_dot(self, a, b, ep):
        if not self.aligned:
            return torch.dot((ep["w_dot"] * a).reshape(-1), b.reshape(-1))
        R = self.R
        s = torch.dot(a[:R].reshape(-1), b[:R].reshape(-1))
        if self.d == self.P - 1:
            s = s + torch.dot(a[R].reshape(-1), b[R].reshape(-1))
        return s

    def _dot_axes(self):
        return ("time",)

    def _dot_local(self, a, b, ep):
        """The global inner product: every valid row once (aligned: rows
        0..R−1 on every rank and slot R on the last; general: the 0/1
        weights ``w_dot``), summed over the ranks."""
        return self.comm.psum(self._local_dot(a, b, ep), self._dot_axes())

    # --------------------------------------------------- wavelet (sharded)

    def _gather_boundary(self, y):
        """(R+1, ...) local -> (P+1, ...) gathered shard-boundary rows."""
        both = self.comm.all_gather(y[[0, self.R]], "time", 0)
        both = both.reshape((self.P, 2) + tuple(y.shape[1:]))
        return torch.cat([both[:, 0], both[-1:, 1]])

    def _scatter_boundary(self, y, G):
        y = y.clone()
        y[0] = G[self.d]
        y[self.R] = G[self.d + 1]
        return y

    def _fine_slices(self, j: int):
        """This shard's slot slices of fine level j (rank-uniform: dR ≡ 0
        mod 2s)."""
        s, R = self.N >> j, self.R
        return (slice(s, R, 2 * s), slice(0, R - 2 * s + 1, 2 * s),
                slice(2 * s, R + 1, 2 * s), slice(2 * s, R - 2 * s + 1, 2 * s),
                slice(2 * s, R, 2 * s))

    @staticmethod
    def _coarse_slices(P: int, j: int):
        sk = P >> j
        return (slice(sk, P, 2 * sk), slice(0, P - 2 * sk + 1, 2 * sk),
                slice(2 * sk, P + 1, 2 * sk))

    def _wavelet_forward_local(self, C, ep):
        """The synthesis W on the duplicated layout ((R+1, ...) -> same)."""
        if not self.aligned:
            return self._wavelet_forward_general(C, ep)
        nd, R = C.ndim, self.R
        rs0, rs1 = float(self.wt.root_s[0]), float(self.wt.root_s[1])
        G = self._gather_boundary(C)
        Gv = torch.zeros_like(G)
        Gv[0] = rs0 * G[0]
        Gv[-1] = rs1 * G[-1]
        for j in range(1, self.p_log + 1):
            mid, left, right = self._coarse_slices(self.P, j)
            lw = ep["w_coarse"][j - 1]
            t = _wcol(lw["s"], nd) * G[mid]
            interp = 0.5 * (Gv[left] + Gv[right])
            Gv[left] += _wcol(lw["wl"], nd) * t
            Gv[right] += _wcol(lw["wr"], nd) * t
            Gv[mid] = t + interp
        v = self._scatter_boundary(torch.zeros_like(C), Gv)
        for j in range(self.p_log + 1, self.J + 1):
            mid, left, right, left_int, right_int = self._fine_slices(j)
            lw = ep["w_fine"][j - self.p_log - 1]
            t = _wcol(lw["s"], nd) * C[mid]
            interp = 0.5 * (v[left] + v[right])
            incL = _wcol(lw["wl"], nd) * t
            incR = _wcol(lw["wr"], nd) * t
            v[left_int] += incL[1:]
            v[right_int] += incR[:-1]
            recvL, recvR = self.comm.exchange("time", incR[-1], incL[0])
            v[0] += recvL + incL[0]
            v[R] += incR[-1] + recvR
            v[mid] = t + interp
        return v

    def _wavelet_adjoint_local(self, X, ep):
        """The transpose W' on the duplicated layout."""
        if not self.aligned:
            return self._wavelet_adjoint_general(X, ep)
        nd, R = X.ndim, self.R
        y = X.clone()
        for j in range(self.J, self.p_log, -1):
            mid, left, right, left_int, right_int = self._fine_slices(j)
            lw = ep["w_fine"][j - self.p_log - 1]
            t, a, b = y[mid].clone(), y[left].clone(), y[right].clone()
            ht = 0.5 * t
            y[left_int] += ht[1:]
            y[right_int] += ht[:-1]
            recvL, recvR = self.comm.exchange("time", ht[-1], ht[0])
            y[0] += recvL + ht[0]
            y[R] += ht[-1] + recvR
            y[mid] = _wcol(lw["s"], nd) * (
                t + _wcol(lw["wl"], nd) * a + _wcol(lw["wr"], nd) * b)
        G = self._gather_boundary(y)
        for j in range(self.p_log, 0, -1):
            mid, left, right = self._coarse_slices(self.P, j)
            lw = ep["w_coarse"][j - 1]
            t, a, b = G[mid].clone(), G[left].clone(), G[right].clone()
            G[left] += 0.5 * t
            G[right] += 0.5 * t
            G[mid] = _wcol(lw["s"], nd) * (
                t + _wcol(lw["wl"], nd) * a + _wcol(lw["wr"], nd) * b)
        G[0] *= float(self.wt.root_s[0])
        G[-1] *= float(self.wt.root_s[1])
        return self._scatter_boundary(y, G)

    # ---- the general transform (graded grids, odd P, ragged N_t): per level
    # a local phase (padded index arrays, the boundary-increment exchange)
    # and a gathered phase (one small gather, the same updates on every
    # rank, scattered back to every copy)

    def _g_exchange_incs(self, v, inc0, incR):
        """Add the boundary-slot contributions on both twin copies in
        (left, right) order."""
        recvL, recvR = self.comm.exchange("time", incR, inc0)
        v = v.clone()
        v[0] += recvL + inc0
        v[self.R] += incR + recvR
        return v

    def _g_gather(self, rows):
        """The ranks' stacked send rows, gathered: (P, k, ...)."""
        stacked = torch.cat(rows)
        buf = self.comm.all_gather(stacked, "time", 0)
        return buf.reshape((self.P,) + tuple(stacked.shape))

    def _wavelet_forward_general(self, C, ep):
        gw, R = ep["gw"], self.R
        r = lambda a: _wcol(a, C.ndim)
        tail = tuple(C.shape[1:])
        rs = gw["root_slot"]
        v = _set_drop(torch.zeros_like(C), rs,
                      r(gw["root_scale"]) * C[rs.clamp(0, R)])
        for lw, gl in zip(gw["levels"], self.glay.levels):
            nl, ng = gl.n_local, gl.n_gathered
            ns = gl.send_v.shape[1]
            if nl:
                lmid = lw["lmid"]
                t = r(lw["ls"]) * C[lmid.clamp(0, R)]
                interp = 0.5 * (v[lw["lpl"]] + v[lw["lpr"]])
            if ng:
                # the send happens before any local update: the gathered
                # reads see the state before the level, as the serial ones
                buf = self._g_gather([v[lw["send_v"]], C[lw["send_c"]]])
                Gv = buf[:, :ns].reshape((-1,) + tail)
                Gc = buf[:, ns:].reshape((-1,) + tail)
                tg = r(lw["g_s"]) * Gc[lw["g_c"]]
                new_mid = tg + 0.5 * (Gv[lw["g_pl"]] + Gv[lw["g_pr"]])
                adds = torch.cat([r(lw["g_wl"]) * tg, r(lw["g_wr"]) * tg])
            if nl:
                cl = r(lw["lwl"]) * t
                cr = r(lw["lwr"]) * t
                v = _add_drop(v, lw["lpl_tgt"], cl)
                v = _add_drop(v, lw["lpr_tgt"], cr)
                inc0 = (r(lw["lpl_i0"]) * cl + r(lw["lpr_i0"]) * cr).sum(0)
                incR = (r(lw["lpl_iR"]) * cl + r(lw["lpr_iR"]) * cr).sum(0)
                v = self._g_exchange_incs(v, inc0, incR)
                v = _set_drop(v, lmid, t + interp)
            if ng:
                v = _set_drop(v, lw["set_slot"], new_mid[lw["set_src"]])
                v = _add_drop(v, lw["add_slot"], adds[lw["add_src"]])
        return v

    def _wavelet_adjoint_general(self, X, ep):
        gw, R = ep["gw"], self.R
        r = lambda a: _wcol(a, X.ndim)
        tail = tuple(X.shape[1:])
        y = X
        for lw, gl in zip(reversed(gw["levels"]), reversed(self.glay.levels)):
            nl, ng = gl.n_local, gl.n_gathered
            if nl:
                lmid = lw["lmid"]
                t = y[lmid.clamp(0, R)]
                a = y[lw["lpl"]]
                b = y[lw["lpr"]]
            if ng:
                Gv = self._g_gather([y[lw["send_v"]]]).reshape((-1,) + tail)
                tg = Gv[lw["g_mid"]]
                new_mid = r(lw["g_s"]) * (
                    tg + r(lw["g_wl"]) * Gv[lw["g_pl"]]
                    + r(lw["g_wr"]) * Gv[lw["g_pr"]])
                htg = 0.5 * tg
                adds = torch.cat([htg, htg])
            if nl:
                ht = 0.5 * t
                y = _add_drop(y, lw["lpl_tgt"], ht)
                y = _add_drop(y, lw["lpr_tgt"], ht)
                inc0 = (r(lw["lpl_i0"] + lw["lpr_i0"]) * ht).sum(0)
                incR = (r(lw["lpl_iR"] + lw["lpr_iR"]) * ht).sum(0)
                y = self._g_exchange_incs(y, inc0, incR)
                y = _set_drop(y, lmid, r(lw["ls"]) * (
                    t + r(lw["lwl"]) * a + r(lw["lwr"]) * b))
            if ng:
                y = _set_drop(y, lw["set_slot"], new_mid[lw["set_src"]])
                y = _add_drop(y, lw["add_slot"], adds[lw["add_src"]])
        rs = gw["root_slot"]
        return _set_drop(y, rs, r(gw["root_scale"]) * y[rs.clamp(0, R)])

    # ------------------------------------------------------------ operators

    def _levelwise_local(self, flat, ep, apply_rows):
        """``apply_rows(rows, j)`` on each wavelet level j's slots of the
        (R+1, ...) local layout. Aligned: the interior slots of the fine
        levels are rank-uniform strided slices; the two boundary slots have
        this rank's (coarse) levels. General: the padded slot arrays of
        every level (twin copies on both ranks)."""
        if not self.aligned:
            out = flat
            for j, idx in enumerate(ep["kxl"]):
                if idx.shape[0]:
                    rows = flat[idx.clamp(0, self.R)]
                    out = _set_drop(out, idx, apply_rows(rows, j))
            return out
        out = flat.clone()
        for j in range(self.p_log + 1, self.J + 1):
            s = self.N >> j
            sl = slice(s, self.R, 2 * s)
            out[sl] = apply_rows(flat[sl], j)
        lvl = self.wt.node_level
        for slot in (0, self.R):
            j = int(lvl[self.d * self.R + slot])
            out[slot:slot + 1] = apply_rows(flat[slot:slot + 1], j)
        return out

    def _coarse_by_level(self, bc, p):
        """The coarsest-grid solve of K_X's V-cycle on this shard: each
        wavelet level's slots with their shifted dense inverse."""
        flat = bc.reshape(bc.shape[0], -1)
        return self._levelwise_local(
            flat, p, lambda rows, j: rows @ p["mg_cinv"][j]).reshape(bc.shape)

    def _mid_kx(self, X, ep):
        """The middle of K_X on the (R+1, *gs_local) layout: V-cycles, A
        (K5), V-cycles; or the dense sandwiches."""
        if self.inner == "mg":
            X = self._ms_solve_kx(X, ep)
            X = self._kl_kx[0].apply_A(X)
            return self._ms_solve_kx(X, ep)
        flat = X.reshape(X.shape[0], -1)
        return self._levelwise_local(
            flat, ep, lambda rows, j: rows @ ep["sandwich"][j]
        ).reshape(X.shape)

    def apply_KX(self, Rr, p=None):
        """K_X on the duplicated layout: the sharded wavelet transforms
        around the shard's levelwise middle."""
        p = self.params if p is None else p
        shape = (self.R + 1,) + tuple(self.gs_local)
        C = self._wavelet_adjoint_local(Rr.reshape(shape), p)
        return self._wavelet_forward_local(self._mid_kx(C, p), p)

    def _kron_stab(self, U, ep):
        """(V, W) of the stab-fused K1 on the local rows."""
        kp = ep["kron"]
        return kron.apply_B_stab(U, kp["h128"], kp["hs128"], self.taps)

    def _kron_BT_stab(self, V, W, ep):
        return kron.apply_BT_stab(V, W, ep["kron"]["h128"], self.taps)

    def _kron_BT(self, V, ep):
        return kron.apply_BT(V, ep["kron"]["h128"], self.taps)

    def apply_S(self, U, p=None):
        """S U on the duplicated layout: B and Bᵀ (stab-fused, K1/K2) on the
        local rows, K_Y per shard, the boundary exchange, the trace row on
        the first rank."""
        ep = self.params if p is None else p
        V, W = self._kron_stab(U, ep)
        part = self._kron_BT_stab(self.apply_KY(self._mask_t(V, ep), ep),
                                  self._mask_t(W, ep), ep)
        out = self._exchange_boundary(part)
        if self.d == 0:
            out[0] += self._trace_row(U, ep)[0]
        return out

    def rhs_device(self, gL, gR, u0_vec, p=None):
        """f on the duplicated layout (rank 0 adds the initial-value row)."""
        ep = self.params if p is None else p
        KYg = self.apply_KY(gL + gR, ep)
        part = self._kron_BT(KYg, ep)
        corr = 0.25 * (gL - gR)
        z = self._zrow(gL)
        part = part - torch.cat([z, corr]) + torch.cat([corr, z])
        f = self._exchange_boundary(part)
        if self.d == 0:
            f[0] += self._rhs_row0(u0_vec, ep)
        return f

    def _rhs_row0(self, u0_vec, ep):
        u0g = u0_vec.reshape((1,) + tuple(self.gs))
        return self._spmv_M(self._apply_Minv(u0g, ep), ep)[0]

    # ------------------------------------------------------------- layout

    def _rhs_host_arrays(self):
        """The host quadrature of this rank's test rows only (gL, gR padded
        to R rows) and u0, once per solver."""
        if self._rhs_host is None:
            t0 = _time.perf_counter()
            lo = min(self.d * self.R, self.N)
            hi = min(lo + self.R, self.N)
            gL, gR, u0 = spacetime_loads(
                _LoadsOn(self.problem, self.device), self.system.mesh,
                self.grid, rows=slice(lo, hi))
            self._rhs_host = (pad_rows(gL, self.R), pad_rows(gR, self.R), u0)
            self.rhs_seconds = _time.perf_counter() - t0
        return self._rhs_host

    def _loads(self, dtype):
        """(gL, gR) of this rank's test rows and u0, on its device."""
        if dtype not in self._rhs_dev:
            gL, gR, u0 = self._rhs_host_arrays()
            mk = lambda a: self._to_local_test(a, dtype)
            self._rhs_dev[dtype] = (
                mk(gL), mk(gR),
                torch.as_tensor(u0, dtype=dtype, device=self.device))
        return self._rhs_dev[dtype]

    def _to_local_test(self, rows, dtype):
        """This rank's R test rows (R, m) on its device, (R, *gs)."""
        return torch.as_tensor(rows, dtype=dtype, device=self.device).reshape(
            (self.R,) + tuple(self.gs))

    def _x0(self, x0):
        """A global (N+1, m) warm start as this rank's (R+1, *gs_local) rows
        (padding slots of the general layout zero)."""
        rows = self._local_trial(np.asarray(x0).reshape(self.N + 1, self.m),
                                 masked=True)
        return torch.as_tensor(rows, dtype=self.dtype,
                               device=self.device).reshape(
            (self.R + 1,) + tuple(self.gs))

    def _dot(self, p):
        return lambda a, b: self._dot_local(a, b, p)

    def _norm(self, x, p):
        return torch.sqrt(self._dot_local(x, x, p))

    def _flat(self, U_local) -> np.ndarray:
        """The (N+1, m) global iterate from every rank's rows (on every
        rank): drop the duplicated slots and the padding."""
        allrows = self.comm.all_gather(U_local.contiguous(), "time", 0)
        return from_time_layout(allrows.reshape(-1, self.m), self.N, self.P,
                                self.R).cpu().numpy()
