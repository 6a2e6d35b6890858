"""The wavelet-in-time transform W (synthesis) and its transpose W' on
tensors, along axis 0.

The host structure comes from ``spacetime_tpu.ops.wavelets.
build_wavelet_transform``; this module holds its device side
(``WaveletTransform.jax_params`` / ``forward_jax`` / ``adjoint_jax`` of the
JAX package):

- float32 (and N+1 ≤ 1025 nodes): the dense (N+1)² synthesis matrix, applied
  as one ``torch.matmul`` over an (N+1, -1) view — a plain product, in full
  float32 (``utils.device`` turns TF32 off);
- float64: the lifting pyramid on strided slices of a uniform dyadic grid,
  in the JAX package's operation order.

Graded grids need the gather form of the lifting; it belongs to the graded
time-grid slice of the port.
"""

from __future__ import annotations

import torch

_DENSE_MAX_NODES = 1025


def _use_dense(wt, dtype) -> bool:
    return dtype != torch.float64 and wt.grid.num_nodes <= _DENSE_MAX_NODES


def wavelet_params(wt, dtype, device) -> dict:
    """The transform's tensors for ``dtype``: {"Wd", "WdT"} (dense) or
    {"levels": [{"wl", "wr", "s"}, ...]} (lifting; (n_j,) per level j)."""
    if not wt.is_uniform:
        raise NotImplementedError(
            "graded time grids need the gather form of the wavelet lifting: "
            "the graded time-grid slice of the port (ROADMAP.md queue 1)"
        )
    mk = lambda a: torch.as_tensor(a, dtype=dtype, device=device).contiguous()
    if _use_dense(wt, dtype):
        Wd = wt.dense()
        return {"Wd": mk(Wd), "WdT": mk(Wd.T)}
    return {
        "levels": [
            {"wl": mk(lev.wl), "wr": mk(lev.wr), "s": mk(lev.s)}
            for lev in wt.levels
        ]
    }


def _gemm_axis0(Wmat, x):
    return torch.matmul(Wmat, x.reshape(x.shape[0], -1)).reshape(x.shape)


def _stride_slices(N: int, j: int):
    s = N >> j
    return (
        slice(s, N, 2 * s),
        slice(0, N - 2 * s + 1, 2 * s),
        slice(2 * s, N + 1, 2 * s),
    )


def forward(wt, c, wp):
    """Synthesis W along axis 0 of ``c`` (N+1, ...)."""
    if "Wd" in wp:
        return _gemm_axis0(wp["Wd"], c)
    r = lambda a: a.reshape(a.shape[:1] + (1,) * (c.ndim - 1))
    N = wt.grid.num_intervals
    v = torch.zeros_like(c)
    v[0] = float(wt.root_s[0]) * c[0]
    v[N] = float(wt.root_s[1]) * c[N]
    for j, lw in enumerate(wp["levels"], start=1):
        mid, left, right = _stride_slices(N, j)
        t = r(lw["s"]) * c[mid]
        interp = 0.5 * (v[left] + v[right])
        v[left] += r(lw["wl"]) * t
        v[right] += r(lw["wr"]) * t
        v[mid] = t + interp
    return v


def adjoint(wt, x, wp):
    """Transpose W' along axis 0 of ``x`` (N+1, ...)."""
    if "WdT" in wp:
        return _gemm_axis0(wp["WdT"], x)
    r = lambda a: a.reshape(a.shape[:1] + (1,) * (x.ndim - 1))
    N = wt.grid.num_intervals
    y = x.clone()
    for j in range(wt.num_levels, 0, -1):
        lw = wp["levels"][j - 1]
        mid, left, right = _stride_slices(N, j)
        t = y[mid].clone()
        a = y[left].clone()
        b = y[right].clone()
        y[left] += 0.5 * t
        y[right] += 0.5 * t
        y[mid] = r(lw["s"]) * (t + r(lw["wl"]) * a + r(lw["wr"]) * b)
    y[0] *= float(wt.root_s[0])
    y[N] *= float(wt.root_s[1])
    return y
