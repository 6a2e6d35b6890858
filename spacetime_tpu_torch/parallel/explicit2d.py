"""The explicit (time × space) mesh solver: the leading spatial grid axis
sharded over a second ``space`` axis of ranks.

The counterpart of ``spacetime_tpu/parallel/explicit2d.py``
(``Explicit2DHeatSolver``). The time layout, the wavelet transform and the
dots are those of ``parallel.explicit`` (the dots summed over both axes);
space adds padded plane slabs with halo exchanges.

Padded slabs. With P_s space ranks, gs[0] is zero-padded to P_s·Rs, Rs a
multiple of 2^D so that the first D multigrid levels stay shard-aligned
(level l keeps Rs >> l planes per rank, an even count). Padding planes lie
past the Dirichlet boundary, so zeros there are the boundary; what keeps
them zero:

- every stencil application extends its input by halo planes from the
  neighbours (zeros at the mesh ends), applies the serial stencil and crops;
- the smoother's per-plane scales are zero on padding planes, and the
  kernel levels take the 0/1 validity field ``vmask`` (``_sp_vmask_field``)
  that zeroes every update of the sweep there and on halo planes beyond the
  domain, so V-cycle outputs are exactly zero on padding;
- the few outputs assembled outside a smoother (S U, the right-hand side)
  get one 0/1 plane mask.

Multigrid. Levels 0..D−1 run sharded, level D and below are gathered once
per V-cycle and run on every space rank (the serial V-cycle with its kernel
levels). On a sharded level the kernels run on the slab extended by the
halo kw = max(ν, ν_post) + 1 (the interpret-mode contract of the JAX
package, explicit2d.py:600-614), wherever the slab holds it ((Rs >> l) ≥
kw): the fused K6/K7 with ``lead`` where ν = ν_post ∈ {2, 3} and the coarse
slab holds the post-stage's coarse halo, else K3 with ``vmask``, K8 and K9
with ``lead``; K4 starts later cycles, K5 is K_X's middle A. Levels too
thin for the halo run the halo-exchanged PyTorch stencils. On the CPU the
same levels run the twins of the same forms. B and Bᵀ are K1/K2 on the
slab extended by one plane. The dense inner solver gathers the slabs for
its products.

Served: the constant-stencil format on 2-D and 3-D structured grids, inner
"dense" or "mg", any time layout of ``parallel.explicit``; the other formats
and inner solvers raise ``ValueError``, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import time as _time

import numpy as np
import torch
import torch.nn.functional as F

from ..convert import from_time_layout, pad_planes, pad_rows, slab
from ..fem import spacetime_loads
from ..ops import kron
from ..ops.mg_kernels import MSKernelLevel
from ..ops.multigrid import (cheb_smooth, chebyshev_steps,
                             mass_spectral_bounds, transfer)
from ..ops.stencil import grouped_apply, tap, zero_pad
from ..solver.heateq import _LoadsOn
from .explicit import ExplicitHeatSolver


class Explicit2DHeatSolver(ExplicitHeatSolver):
    """``HeatSolver`` on one rank of a ``("time", "space")`` mesh."""

    _mesh_axes = ("time", "space")

    def _setup_space(self) -> None:
        self._dim = len(self.gs)
        if self._dim < 2:
            raise ValueError("spatial sharding needs a >= 2-D grid")
        self.Ps = self.comm.axis_size("space")
        self.ds = self.comm.axis_index("space")
        n0 = self.gs[0]
        if self.inner == "mg":
            levels = self.msmg.levels
            D = 0
            while D < len(levels) and (levels[D].n - 1) >= 4 * self.Ps:
                D += 1
            self._coarse_ext = levels[-1].n // 2 - 1
        else:
            D, self._coarse_ext = 0, None
        self._sp_depth = D
        blk = 1 << D
        self.Rs = blk * int(-(-n0 // (self.Ps * blk)))
        self.gs_local = (self.Rs,) + tuple(self.gs[1:])
        self._slab_taps = dataclasses.replace(
            self.taps, gs=(self.Rs + 2,) + tuple(self.gs[1:]))
        if self.inner == "mg":
            self._minv_center = next(w for w, ds in self._groups_M
                                     if (0,) * self._dim in ds)
            self._minv_bounds = mass_spectral_bounds(self._dim)
            nup = lambda nu: max(nu, nu if self.mg_nu_post is None
                                 else self.mg_nu_post)
            self._sp_kw = {"ky": nup(self.mg_nu) + 1,
                           "kx": nup(self.mg_nu_kx) + 1}
            self._sh_kl = {"ky": self._slab_levels(self.mg_nu,
                                                   self._sp_kw["ky"]),
                           "kx": self._slab_levels(self.mg_nu_kx,
                                                   self._sp_kw["kx"])}

    def _slab_levels(self, nu: int, kw: int):
        """The kernel levels of the sharded levels on their kw-extended
        slabs, None where the slab is thinner than the halo and on the
        gathered levels."""
        out = []
        for lvl, lev in enumerate(self.msmg.levels):
            own = self.Rs >> lvl
            if lvl < self._sp_depth and own >= kw:
                gs = (own + 2 * kw,) + (lev.n - 1,) * (self._dim - 1)
                out.append(MSKernelLevel(lev.A_st, lev.M_st, nu,
                                         nu_post=self.mg_nu_post, gs=gs))
            else:
                out.append(None)
        return out

    def layout_info(self) -> dict:
        info = super().layout_info()
        info.update(Ps=self.Ps, Rs=self.Rs, sp_depth=self._sp_depth)
        if self.inner == "mg":
            info["kw"] = dict(self._sp_kw)
            info["kernel_levels"] = {
                k: [kl is not None for kl in v] for k, v in self._sh_kl.items()}
        return info

    # -------------------------------------------------- spatial collectives

    def _sp_ax(self, X) -> int:
        return X.ndim - self._dim

    def _sp_halo(self, X, k: int = 1):
        """X extended by k planes of the sharded axis on each side, from the
        neighbours (zeros at the mesh ends: the Dirichlet ghost)."""
        ax = self._sp_ax(X)
        n = X.shape[ax]
        left, right = self.comm.exchange(
            "space", X.narrow(ax, n - k, k), X.narrow(ax, 0, k))
        return torch.cat([left, X, right], dim=ax)

    def _sp_crop(self, X, k: int = 1):
        """The owned planes of a k-extended slab (contiguous: the kernels
        take contiguous fields)."""
        ax = self._sp_ax(X)
        return X.narrow(ax, k, X.shape[ax] - 2 * k).contiguous()

    def _sp_gather(self, X, e: int | None = None):
        """Local slabs -> the real planes on every rank (the axis cut to
        ``e``)."""
        ax = self._sp_ax(X)
        G = self.comm.all_gather(X.contiguous(), "space", ax)
        return G.narrow(ax, 0, self.gs[0] if e is None else e).contiguous()

    def _sp_scatter(self, Y, Rs: int | None = None):
        """The real planes -> this rank's slab (padding zero)."""
        ax = self._sp_ax(Y)
        Rs = self.Rs if Rs is None else Rs
        pad = [0, 0] * (Y.ndim - ax)
        pad[-1] = self.Ps * Rs - Y.shape[ax]
        Yp = F.pad(Y, pad)
        return Yp.narrow(ax, self.ds * Rs, Rs).contiguous()

    # ----------------------------------------------------- sharded stencils

    def _st_apply_sh(self, groups, U):
        """A grouped stencil on slabs: one halo plane, the serial stencil on
        the extended slab, crop: on every owned plane what the serial
        operator computes."""
        Ue = self._sp_halo(U, 1)
        gse = tuple(Ue.shape[self._sp_ax(Ue):])
        return self._sp_crop(grouped_apply(groups, gse, Ue), 1)

    def _spmv_M(self, X, p=None):
        return self._st_apply_sh(self._groups_M, X)

    def _spmv_A(self, X, p=None):
        return self._st_apply_sh(self.taps.groups_A, X)

    def _ms_op_sh(self, lvl: int, lp, x):
        """A x + ω⊙M x on level ``lvl``'s slabs: each pair group's tap sum
        on the one-plane halo-extended slab, cropped, times the group's
        weight (ω the level's slab column), in ``ms_op``'s order."""
        xe = self._sp_halo(x, 1)
        ax = self._sp_ax(xe)
        gse = tuple(xe.shape[ax:])
        Up = zero_pad(xe, self._dim)
        out = None
        for (wa, wm), ds in self._mg_ky._pairs[lvl]:
            acc = None
            for disp in ds:
                t = tap(xe, Up, disp, gse)
                acc = t if acc is None else acc + t
            acc = acc.narrow(ax, 1, acc.shape[ax] - 2)
            if wm == 0.0:
                w = wa
            elif wa == 0.0:
                w = lp["omega"] * wm
            else:
                w = wa + lp["omega"] * wm
            out = w * acc if out is None else out + w * acc
        return out

    def _ms_smooth_sh(self, ms, lvl, lp, x, b, nu=None):
        """The sweep on a sharded level without kernels: the scales are zero
        on padding planes, which keeps every update there 0."""
        nu = ms.nu if nu is None else nu
        return cheb_smooth(lambda v: self._ms_op_sh(lvl, lp, v), lp, x, b, nu)

    def _restrict_sh(self, F_):
        """The restriction across the sharded axis: one halo plane from the
        right, the serial transfer on the extended slab (shard offsets are
        even on every sharded level)."""
        ax = self._sp_ax(F_)
        right = self.comm.ppermute(F_.narrow(ax, 0, 1), "space",
                                   [(d + 1, d) for d in range(self.Ps - 1)])
        return transfer(torch.cat([F_, right], dim=ax), self._dim,
                        restrict=True)

    def _interp_sh(self, C):
        """The prolongation: one coarse halo plane from the left, the serial
        transfer, crop to the owned fine planes."""
        ax = self._sp_ax(C)
        n = C.shape[ax]
        left = self.comm.ppermute(C.narrow(ax, n - 1, 1), "space",
                                  [(d, d + 1) for d in range(self.Ps - 1)])
        G = transfer(torch.cat([left, C], dim=ax), self._dim, restrict=False)
        return G.narrow(ax, 2, 2 * n)

    def _plane_mask(self, Rs_l: int, e_l: int, dtype, k: int = 0):
        """(Rs_l + 2k, 1, ...) 0/1: the planes of this rank's k-extended
        slab of Rs_l planes that lie in the domain's e_l real planes (0 on
        grid padding and on halo planes beyond the domain)."""
        gid = self.ds * Rs_l - k + np.arange(Rs_l + 2 * k)
        m = ((gid >= 0) & (gid < e_l)).astype(np.float64)
        return torch.as_tensor(m, dtype=dtype, device=self.device).reshape(
            (Rs_l + 2 * k,) + (1,) * (self._dim - 1))

    def _sp_vmask_field(self, lvl: int, k: int, dtype):
        """The (1, Rs_l + 2k, ...) validity field of this rank's k-extended
        slab on level ``lvl`` (``_plane_mask`` over the level's grid)."""
        e_l = self.msmg.levels[lvl].n - 1
        col = self._plane_mask(self.Rs >> lvl, e_l, dtype, k)
        return col.expand((col.shape[0],) + (e_l,) * (self._dim - 1)
                          ).unsqueeze(0).contiguous()

    # ------------------------------------------------- sharded multigrid

    def _ms_vcycle_sh(self, ms, b, lps, coarse_solve, lvl, kls, kw, vms):
        if lvl == self._sp_depth:
            if lvl == len(ms.msmg.levels):
                out = coarse_solve(self._sp_gather(b, self._coarse_ext))
            else:
                bg = self._sp_gather(b, ms.msmg.levels[lvl].n - 1)
                out = ms.vcycle(bg, lps, coarse_solve, lvl,
                                kernels=self._serial_kl(ms))
            return self._sp_scatter(out, self.Rs >> lvl)
        lp = lps[lvl]
        kl = kls[lvl]
        own, own_c = self.Rs >> lvl, self.Rs >> (lvl + 1)
        hc = (kw + 2) // 2  # the post-stage's coarse halo: 2hc ≥ kw + 1
        fused = (kl is not None and kl.nu == kl.nu_post and 2 <= kl.nu <= 3
                 and own_c >= hc)
        if kl is not None:
            vm = vms(lvl, kw, b.dtype)
            be = self._sp_halo(b, kw)
        if fused:
            xe, rc = kl.sh_fused_pre(be, lp["cols"], vm, own, kw)
            x = self._sp_crop(xe, kw)
            ec = self._ms_vcycle_sh(ms, rc, lps, coarse_solve, lvl + 1, kls,
                                    kw, vms)
            out = kl.sh_fused_post(self._sp_halo(x, kw), be,
                                   self._sp_halo(ec, hc), lp["cols"], vm,
                                   own, kw, hc)
            return self._sp_crop(out, kw)
        if kl is not None:
            x = self._sp_crop(
                kl.smooth(None, be, lp["cols"], zero_init=True, vmask=vm), kw)
            rc = kl.sh_residual_restrict(self._sp_halo(x, kw), be,
                                         lp["cols"], own, kw)
        else:
            x = self._ms_smooth_sh(ms, lvl, lp, None, b)
            rc = self._restrict_sh(b - self._ms_op_sh(lvl, lp, x))
        ec = self._ms_vcycle_sh(ms, rc, lps, coarse_solve, lvl + 1, kls, kw,
                                vms)
        if kl is not None:
            x = kl.sh_prolong_correct(x, self._sp_halo(ec, 1), own, 1)
            return self._sp_crop(
                kl.smooth(self._sp_halo(x, kw), be, lp["cols"], post=True,
                          vmask=vm), kw)
        x = x + self._interp_sh(ec)
        return self._ms_smooth_sh(ms, lvl, lp, x, b, nu=ms.nu_post)

    def _serial_kl(self, ms):
        return self._kl_ky if ms is self._mg_ky else self._kl_kx

    def _ms_solve_sh(self, ms, b, lps, coarse_solve, cycles, which):
        kls, kw = self._sh_kl[which], self._sp_kw[which]
        if self._sp_depth == 0:
            bg = self._sp_gather(b)
            return self._sp_scatter(ms.solve(bg, lps, coarse_solve, cycles,
                                             kernels=self._serial_kl(ms)))
        cache: dict = {}

        def vms(lvl, k, dtype):
            if (lvl, k, dtype) not in cache:
                cache[(lvl, k, dtype)] = self._sp_vmask_field(lvl, k, dtype)
            return cache[(lvl, k, dtype)]

        x = self._ms_vcycle_sh(ms, b, lps, coarse_solve, 0, kls, kw, vms)
        for _ in range(cycles - 1):
            kl = kls[0]
            if kl is not None:
                r = self._sp_crop(kl.residual(self._sp_halo(x, kw),
                                              self._sp_halo(b, kw),
                                              lps[0]["cols"]), kw)
            else:
                r = b - self._ms_op_sh(0, lps[0], x)
            x = x + self._ms_vcycle_sh(ms, r, lps, coarse_solve, 0, kls, kw,
                                       vms)
        return x

    # ------------------------------------------------------------- params

    def params_for(self, dtype: torch.dtype) -> dict:
        self._setup_layout()
        if dtype in self._eparams_cache:
            return self._eparams_cache[dtype]
        ep = super().params_for(dtype)
        ep["sp_mask"] = self._plane_mask(self.Rs, self.gs[0], dtype)
        ep["inv_h"] = ep["inv_h"] * ep["sp_mask"]
        return ep

    def _ms_params(self, dtype):
        """Per-level row params: on the sharded levels (rows, Rs_l, 1, ...)
        slabs zeroed on padding planes, which pins every update of the
        smoother without kernels there to 0; the kernels' (rows,) columns
        are the serial ones (their validity field does the pinning)."""
        out = super()._ms_params(dtype)
        for lps in out:
            for lvl, lp in enumerate(lps[: self._sp_depth]):
                mask = self._plane_mask(self.Rs >> lvl,
                                        self.msmg.levels[lvl].n - 1, dtype)
                for k in MSKernelLevel._COLS.values():
                    lp[k] = lp[k] * mask
        return out

    # ----------------------------------------------------- local operators

    def _zrow(self, like):
        return like.new_zeros((1,) + tuple(self.gs_local))

    def _kron_stab(self, U, ep):
        kp = ep["kron"]
        V, W = kron.apply_B_stab(self._sp_halo(U), kp["h128"], kp["hs128"],
                                 self._slab_taps)
        return self._sp_crop(V), self._sp_crop(W)

    def _kron_BT_stab(self, V, W, ep):
        return self._sp_crop(kron.apply_BT_stab(
            self._sp_halo(V), self._sp_halo(W), ep["kron"]["h128"],
            self._slab_taps))

    def _kron_BT(self, V, ep):
        return self._sp_crop(kron.apply_BT(self._sp_halo(V),
                                           ep["kron"]["h128"],
                                           self._slab_taps))

    def _apply_Minv(self, X, p):
        """K_H ≈ M⁻¹ on slabs: the dense inverse on the gathered planes, or
        the degree-30 stencil Chebyshev of the serial solver with its Jacobi
        scale zeroed on padding planes."""
        if self.inner == "dense":
            lead = tuple(X.shape[: self._sp_ax(X)])
            Y = (self._sp_gather(X).reshape(-1, self.m) @ p["Minv"])
            return self._sp_scatter(Y.reshape(lead + tuple(self.gs)))
        lmin, lmax = self._minv_bounds
        theta, delta = 0.5 * (lmax + lmin), 0.5 * (lmax - lmin)
        invd = (1.0 / self._minv_center) * p["sp_mask"]
        r = invd * X
        d = r / theta
        x = d
        for a, c in chebyshev_steps(theta / delta, 30):
            r = r - invd * self._spmv_M(d, p)
            d = a * d + (c / delta) * r
            x = x + d
        return x

    def apply_KY(self, V, p=None):
        p = self.params if p is None else p
        if self.inner == "dense":
            lead = tuple(V.shape[: self._sp_ax(V)])
            sol = self._sp_gather(V).reshape(-1, self.m) @ p["Kx_inv"]
            sol = self._sp_scatter(sol.reshape(lead + tuple(self.gs)))
        else:
            def coarse(bc):
                return (bc.reshape(bc.shape[0], -1) @ p["mg_cinv_ky"]
                        ).reshape(bc.shape)

            sol = self._ms_solve_sh(self._mg_ky, V, p["ms_ky"], coarse,
                                    self.mg_cycles, "ky")
        return sol * p["inv_h"]

    def _mid_kx(self, X, ep):
        if self.inner == "mg":
            msolve = lambda Z: self._ms_solve_sh(
                self._mg_kx, Z, ep["ms_kx"],
                lambda bc: self._coarse_by_level(bc, ep), self.mg_cycles_kx,
                "kx")
            X = msolve(X)
            kl, kw = self._sh_kl["kx"][0], self._sp_kw["kx"]
            if kl is not None:
                X = self._sp_crop(kl.apply_A(self._sp_halo(X, kw)), kw)
            else:
                X = self._spmv_A(X, ep)
            return msolve(X)
        G = self._sp_gather(X).reshape(X.shape[0], self.m)
        G = self._levelwise_local(G, ep,
                                  lambda rows, j: rows @ ep["sandwich"][j])
        return self._sp_scatter(G.reshape((X.shape[0],) + tuple(self.gs)))

    def apply_S(self, U, p=None):
        p = self.params if p is None else p
        return super().apply_S(U, p) * p["sp_mask"]

    def rhs_device(self, gL, gR, u0_vec, p=None):
        p = self.params if p is None else p
        return super().rhs_device(gL, gR, u0_vec, p) * p["sp_mask"]

    def _rhs_row0(self, u0_vec, ep):
        u0l = self._sp_scatter(u0_vec.reshape((1,) + tuple(self.gs)))
        return self._spmv_M(self._apply_Minv(u0l, ep), ep)[0]

    def _dot_axes(self):
        return ("time", "space")

    # ------------------------------------------------------------- layout

    def _rhs_host_arrays(self):
        """This rank's time rows' loads: each space rank of the time shard
        computes its share of the rows, then they are gathered."""
        if self._rhs_host is None:
            t0 = _time.perf_counter()
            lo = min(self.d * self.R, self.N)
            hi = min(lo + self.R, self.N)
            k = -(-self.R // self.Ps)
            a = min(lo + self.ds * k, hi)
            gL, gR, u0 = spacetime_loads(
                _LoadsOn(self.problem, self.device), self.system.mesh,
                self.grid, rows=slice(a, min(a + k, hi)))
            mine = torch.as_tensor(np.stack([pad_rows(gL, k),
                                             pad_rows(gR, k)]),
                                   device=self.device)
            both = self.comm.all_gather(mine, "space", 1).cpu().numpy()
            self._rhs_host = (both[0, : self.R], both[1, : self.R], u0)
            self.rhs_seconds = _time.perf_counter() - t0
        return self._rhs_host

    def _to_slab(self, X):
        """(T, *gs) -> this rank's (T, Rs, gs[1:]) slab, padding zero
        (``convert.pad_planes`` / ``slab``)."""
        return slab(pad_planes(X, self.Ps, self.Rs), self.ds, self.Rs
                    ).contiguous()

    def _to_local_test(self, rows, dtype):
        return self._to_slab(super()._to_local_test(rows, dtype))

    def _x0(self, x0):
        return self._to_slab(super()._x0(x0))

    def _flat(self, U_local) -> np.ndarray:
        planes = self._sp_gather(U_local)  # (R+1, *gs)
        allrows = self.comm.all_gather(planes.contiguous(), "time", 0)
        return from_time_layout(allrows.reshape(-1, self.m), self.N, self.P,
                                self.R).cpu().numpy()
