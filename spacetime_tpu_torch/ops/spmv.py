"""The blocked-ELL SpMM, K20, and its pair form K19, batched over time rows.

The counterpart of ``spacetime_tpu/ops/spmv_pallas.py``: for every block
row rb of a ``BlockedEll`` matrix,

    Y[:, rb·br : (rb+1)·br] = Σ_s X[:, colidx[rb, s]·bc : +bc] · blocks[rb, s]ᵀ,

the slots summed in order from slot 0 (``_spmm_call``, spmv_pallas.py:55).
The kernel of csrc/ell.cu does not read the blocks: ``pack_blocks`` keeps,
once at setup, only their nonzeros, in a row-packed (sliced-ELL) layout
(``PackedEll``: rows in slices of one warp, entry k of row 32s + l at
``slice_ptr[s] + 32k + l``, slot then column within a row), and the device
holds that layout alone (``packed_params``). ``spmm`` launches the kernel
for a CUDA tensor (float32 and float64; the TPU ran it at
``Precision.HIGHEST`` in f32 only, and the JAX solver's f64 applications
fall back to DIA, which the H100 does not need) and counts the launch; a
CPU tensor goes to the packed twin ``spmm_packed_plain``, the kernel's
arithmetic entry by entry, batched over rows and T; any other device
raises. The blocked twin ``spmm_plain``, ``BlockedEll.matvec_np``'s loop
in torch (one product per slot batched over the block rows), stays as the
reference form that both are held to. The kernel reads X unpadded,
columns ≥ its width as 0, and writes only the first ``n_out`` columns of
Y (0 past the matrix's rows), so ``EllOperator.apply`` needs neither the
pad copy nor the slice of the JAX package.

K19 (``spmm_pair``, the counterpart of ``spacetime_tpu/ops/ell_pallas.py``
``_spmm_pair_call``) computes (A·X, M·X) for two matrices on one pattern,
so each gather of X feeds both; its twins are ``spmm_pair_packed_plain``
and ``spmm_pair_plain`` (two ``spmm_plain``). ``ell_to_blocked`` re-lays
the smoothed-aggregation coarse levels' ELL gather rows (the A/M union
pattern, P and Pᵀ) in blocked ELL (``level_blocks``), and
``EllKernelLevel`` packs those blocks and applies a level with them:
``op_pair`` by K19, ``interp`` and ``restrict`` by K20. As for K20, the TPU's size gate (``ell_pallas_min_m``) has no
counterpart: every ELL level launches them, in f32 and f64.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from . import native
from .blocked_ell import BlockedEll
from .native import check_tensor

SOURCE = "spacetime_tpu_torch/csrc/ell.cu"
BLOCK = 128  # the blocked format's rows and columns (its default)
WARP = 32  # rows per slice of the packed layout: one warp of the kernel
_OPS = {
    "spmm": ("K20 ell_spmm", "spacetime_tpu/ops/spmv_pallas.py:55"),
    "spmm_pair": ("K19 ell_spmm_pair", "spacetime_tpu/ops/ell_pallas.py:140"),
}
KERNELS = {
    (op, dtype): native.Kernel(f"{name} {sfx}", f"ell_{op}_{sfx}", replaces)
    for op, (name, replaces) in _OPS.items()
    for dtype, sfx in ((torch.float32, "f32"), (torch.float64, "f64"))
}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict[str, int]:
    return {k.name: k.launches for k in KERNELS.values()}


@dataclasses.dataclass(frozen=True)
class PackedEll:
    """One or more matrices on one pattern in the row-packed layout that
    K19 and K20 read. Rows come in slices of ``WARP``; slice s holds w_s =
    (slice_ptr[s+1] − slice_ptr[s]) / WARP entries per row, entry k of row
    WARP·s + l at slice_ptr[s] + WARP·k + l; a short row's pads carry value
    0 in every value array at one of the row's own columns (column 0 in a
    row without entries)."""

    slice_ptr: np.ndarray  # (nrows / WARP + 1,) int32
    col: np.ndarray  # (E,) int32
    vals: np.ndarray  # (nmat, E), the blocks' dtype


def pack_blocks(blocks, colidx, m: int) -> PackedEll:
    """The nonzeros of the blocked-ELL arrays ``blocks`` (each (nrb, nslots,
    br, bc), on one block-column index ``colidx``) of a matrix of ``m``
    rows, as a ``PackedEll`` over the nrb·br rows: an entry is kept where
    any of the arrays is nonzero, in the order slot, then column within
    the block. Raises if a row ≥ m holds one, or if the layout's offsets
    leave int32."""
    blocks = [np.asarray(b) for b in blocks]
    nrb, nslots, br, bc = blocks[0].shape
    if br % WARP:
        raise ValueError(f"block rows {br} are not a multiple of {WARP}")
    colidx = np.asarray(colidx)
    keep = np.zeros((nrb, br, nslots, bc), bool)
    for b in blocks:
        keep |= b.transpose(0, 2, 1, 3) != 0
    # row-major over (block row, row in block, slot, column in block)
    rb, i, s, k = np.nonzero(keep)
    del keep
    row = rb * br + i
    if row.size and int(row.max()) >= m:
        raise ValueError(f"entries in rows ≥ m = {m}")
    nrows = nrb * br
    count = np.bincount(row, minlength=nrows)
    width = count.reshape(-1, WARP).max(axis=1)
    ptr = np.zeros(width.size + 1, np.int64)
    ptr[1:] = np.cumsum(WARP * width)
    cols = colidx[rb, s].astype(np.int64) * bc + k
    # the kernel steps an int32 offset by WARP past the last entry
    if ptr[-1] > np.iinfo(np.int32).max - WARP or (
            cols.size and int(cols.max()) > np.iinfo(np.int32).max):
        raise ValueError(f"{int(ptr[-1])} entries: the packed layout's "
                         "offsets and columns are int32")
    start = np.zeros(nrows + 1, np.int64)
    start[1:] = np.cumsum(count)
    at = ptr[row // WARP] + WARP * (np.arange(row.size) - start[row]) + (
        row % WARP)
    pad = np.zeros(nrows, np.int64)
    has = count > 0
    pad[has] = cols[start[1:][has] - 1]  # each row's last column
    sl = np.repeat(np.arange(width.size), WARP * width)
    col = pad[WARP * sl + (np.arange(int(ptr[-1])) - ptr[sl]) % WARP]
    col[at] = cols
    vals = np.zeros((len(blocks), int(ptr[-1])), np.result_type(*blocks))
    for j, b in enumerate(blocks):
        vals[j, at] = b[rb, s, i, k]
    return PackedEll(ptr.astype(np.int32), col.astype(np.int32), vals)


def packed_params(packed: PackedEll, dtype, device) -> dict:
    """The packed layout on ``device``: ``slice_ptr`` and ``col`` (int32),
    ``vals`` (nmat, E) in ``dtype``. On the CPU also ``twin_col`` and
    ``twin_vals``, the packed twin's gathers (``_twin_gathers``), built
    once here and not on every call."""
    idx = lambda a: torch.as_tensor(a, dtype=torch.int32, device=device)
    p = {"slice_ptr": idx(packed.slice_ptr), "col": idx(packed.col),
         "vals": torch.as_tensor(packed.vals, dtype=dtype,
                                 device=device).contiguous()}
    if torch.device(device).type == "cpu":
        p["twin_col"], p["twin_vals"] = _twin_gathers(p)
    return p


def spmm_plain(X, blocks, colidx, n_out: int):
    """The blocked twin: X (T, n) -> Y (T, n_out); ``colidx`` (nrb, nslots)
    int."""
    nrb, nslots, br, bc = blocks.shape
    T = X.shape[0]
    ncb = -(-max(X.shape[1], int(colidx.max()) * bc + bc) // bc)
    Xb = F.pad(X, (0, ncb * bc - X.shape[1])).reshape(T, ncb, bc)
    idx = colidx.long()
    acc = None
    for s in range(nslots):
        xs = Xb[:, idx[:, s]].transpose(0, 1)  # (nrb, T, bc)
        term = torch.bmm(xs, blocks[:, s].transpose(1, 2))  # (nrb, T, br)
        acc = term if acc is None else acc + term
    return acc.transpose(0, 1).reshape(T, nrb * br)[:, :n_out].contiguous()


def spmm_pair_plain(X, blocksA, blocksM, colidx, n_out: int):
    """K19's blocked twin: (A·X, M·X), each as ``spmm_plain``."""
    return (spmm_plain(X, blocksA, colidx, n_out),
            spmm_plain(X, blocksM, colidx, n_out))


def _twin_gathers(p):
    """Entry k of every row of the packed layout ``p`` as columns (wmax,
    rows) int64 and values (nmat, wmax, rows), value 0 past a slice's
    width."""
    ptr, col, vals = p["slice_ptr"].long(), p["col"].long(), p["vals"]
    dev = vals.device
    width = (ptr[1:] - ptr[:-1]) // WARP
    k = torch.arange(int(width.max()) if width.numel() else 0, device=dev)
    live = k[None, :, None] < width[:, None, None]  # (nslices, wmax, WARP)
    at = torch.where(live, ptr[:-1, None, None] + WARP * k[None, :, None]
                     + torch.arange(WARP, device=dev), 0)
    cols = col[at].transpose(0, 1).reshape(k.numel(), -1)
    v = (vals[:, at] * live).transpose(1, 2).reshape(vals.shape[0],
                                                     k.numel(), -1)
    return cols, v.contiguous()


def _packed_twin(X, p, n_out: int):
    """The kernel's arithmetic on the packed layout ``p``: for each entry
    column k, gather X at every row's k-th column, multiply by its values
    and add, in order; one Y per value array."""
    if "twin_col" in p:
        cols, v = p["twin_col"], p["twin_vals"]
    else:
        cols, v = _twin_gathers(p)
    T, n = X.shape
    ncols = max(n, int(cols.max()) + 1 if cols.numel() else 0)
    Xp = F.pad(X, (0, ncols - n))  # columns ≥ n read as 0
    acc = [X.new_zeros((T, cols.shape[1])) for _ in range(v.shape[0])]
    for kk in range(cols.shape[0]):
        xk = Xp[:, cols[kk]]
        for j, a in enumerate(acc):
            a.addcmul_(xk, v[j, kk])
    return tuple(a[:, :n_out].contiguous() for a in acc)


def spmm_packed_plain(X, p, n_out: int):
    """K20's packed twin: X (T, n) -> Y (T, n_out)."""
    return _packed_twin(X, p, n_out)[0]


def spmm_pair_packed_plain(X, p, n_out: int):
    """K19's packed twin: (A·X, M·X)."""
    return _packed_twin(X, p, n_out)


def _check(op, X, p, nmat: int, n_out: int):
    k = native.kernel_for(KERNELS, "ell", op, X)
    T, n = X.shape
    ptr, col, vals = p["slice_ptr"], p["col"], p["vals"]
    nslices, nent = ptr.shape[0] - 1, col.shape[0]
    if not 1 <= n_out <= WARP * nslices:
        raise ValueError(f"n_out={n_out} outside 1..{WARP * nslices}")
    check_tensor("X", X, X.dtype, X.device, (T, n))
    check_tensor("slice_ptr", ptr, torch.int32, X.device, (nslices + 1,))
    check_tensor("col", col, torch.int32, X.device, (nent,))
    check_tensor("vals", vals, X.dtype, X.device, (nmat, nent))
    return k, T, n, nslices


def spmm(X, p, n_out: int):
    """K20: X (T, n) -> Y (T, n_out) on the packed layout ``p``, columns of
    X at or past n read as 0."""
    if X.device.type == "cpu":
        return spmm_packed_plain(X, p, n_out)
    k, T, n, nslices = _check("spmm", X, p, 1, n_out)
    Y = X.new_empty((T, n_out))
    k.launch(X.device, X.data_ptr(), T, n, p["slice_ptr"].data_ptr(),
             p["col"].data_ptr(), p["vals"].data_ptr(), nslices, Y.data_ptr(),
             n_out)
    return Y


def spmm_pair(X, p, n_out: int):
    """K19: (A·X, M·X) for A and M on one packed pattern ``p`` (``vals``
    (2, E): A's, then M's)."""
    if X.device.type == "cpu":
        return spmm_pair_packed_plain(X, p, n_out)
    k, T, n, nslices = _check("spmm_pair", X, p, 2, n_out)
    YA, YM = X.new_empty((T, n_out)), X.new_empty((T, n_out))
    vals = p["vals"]
    k.launch(X.device, X.data_ptr(), T, n, p["slice_ptr"].data_ptr(),
             p["col"].data_ptr(), vals[0].data_ptr(), vals[1].data_ptr(),
             nslices, YA.data_ptr(), YM.data_ptr(), n_out)
    return YA, YM


class EllOperator:
    """A ``BlockedEll`` matrix on a device: ``apply`` (T, m) -> (T, m) and
    ``apply_padded`` (T, mp) -> (T, nrb·br), both K20. The host keeps the
    blocks (``ell``) and their packed nonzeros (``packed``); the device
    only the packed layout, in ``params`` in ``dtype``; ``params_for``
    gives it in another dtype, which the solver keeps in its params per
    dtype and passes as ``p``."""

    def __init__(self, ell: BlockedEll, dtype=torch.float32, device="cpu"):
        self.ell = ell
        self.m = ell.shape[0]
        self.mp = ell.padded_shape[1]
        self.nrb, self.nslots = ell.colidx.shape
        self.packed = pack_blocks([ell.blocks], ell.colidx, self.m)
        self.dtype, self.device = dtype, device
        self.params = packed_params(self.packed, dtype, device)

    def params_for(self, dtype) -> dict:
        if dtype == self.dtype:
            return self.params
        return packed_params(self.packed, dtype, self.device)

    def apply(self, U, p=None):
        """A·U[t] for every row of U (T, m), on the unpadded rows."""
        p = self.params if p is None else p
        return spmm(U, p, self.m)

    def apply_padded(self, Xp, p=None):
        p = self.params if p is None else p
        return spmm(Xp, p, self.nrb * self.ell.br)


def ell_to_blocked(eidx, vals, br: int, bc: int, ncols: int, valid=None):
    """Fixed-width ELL gather rows as blocked ELL with one block-column index
    shared by every value array (the JAX package's ``ell_to_blocked``):
    ``eidx`` (m, K) column ids, ``vals`` a list of (m, K) arrays on that
    pattern, ``ncols`` the column count; ``valid`` (m, K) marks the live
    entries (default: nonzero in any of ``vals``; pad slots alias column 0
    and must not pull block column 0 in). Returns (colidx (nrb, nslots)
    int32, [blocks (nrb, nslots, br, bc)])."""
    eidx = np.asarray(eidx)
    m, K = eidx.shape
    if valid is None:
        valid = np.zeros((m, K), bool)
        for v in vals:
            valid |= np.asarray(v) != 0
    nrb = -(-m // br)
    ncb = max(1, -(-ncols // bc))
    rows, ks = np.nonzero(valid)
    cols = eidx[rows, ks]
    rb = rows // br
    bcol = cols // bc
    keys = rb.astype(np.int64) * ncb + bcol
    uk = np.unique(keys)
    urb = uk // ncb
    counts = np.bincount(urb, minlength=nrb)
    nslots = max(1, int(counts.max()))
    base = np.zeros(nrb + 1, np.int64)
    base[1:] = np.cumsum(counts)
    colidx = np.zeros((nrb, nslots), np.int32)
    colidx[urb, np.arange(uk.size) - base[urb]] = (uk % ncb).astype(np.int32)
    slot = np.searchsorted(uk, keys) - base[rb]
    out = []
    for v in vals:
        v = np.asarray(v)
        blocks = np.zeros((nrb, nslots, br, bc), v.dtype)
        # ELL rows have unique column ids (CSR provenance): plain scatter
        blocks[rb, slot, rows % br, cols % bc] = v[rows, ks]
        out.append(blocks)
    return colidx, out


def level_blocks(lev) -> dict:
    """An aggregated (ELL-format) level ``lev`` in blocked ELL: ``"op"`` the
    A/M pair on their union pattern, ``"P"`` (m × m_c) and ``"R"`` = Pᵀ,
    each (colidx, [float64 blocks]) from ``ell_to_blocked``."""
    m, mc = int(lev.eidx.shape[0]), int(lev.Ridx.shape[0])
    valid = (np.asarray(lev.ewA) != 0) | (np.asarray(lev.ewM) != 0)
    return {
        "op": ell_to_blocked(lev.eidx, [lev.ewA, lev.ewM], BLOCK, BLOCK, m,
                             valid),
        "P": ell_to_blocked(lev.Pidx, [lev.Pw], BLOCK, BLOCK, mc),
        "R": ell_to_blocked(lev.Ridx, [lev.Rw], BLOCK, BLOCK, m),
    }


class EllKernelLevel:
    """K19 and K20 for one aggregated (ELL-format) level ``lev`` of an
    ``SAMultiShiftMultigrid`` (the JAX package's ``EllPallasLevel``): the
    operator pair on the A/M union pattern, P (m × m_c) and R = Pᵀ. The
    host keeps them packed (``packed``), from ``level_blocks``; ``values``
    puts the packed layouts on a device."""

    kind = "ell"

    def __init__(self, lev):
        if getattr(lev, "fmt", None) != "ell":
            raise ValueError("EllKernelLevel needs ELL level storage")
        self.m = int(lev.eidx.shape[0])
        self.mc = int(lev.Ridx.shape[0])
        rows = {"op": self.m, "P": self.m, "R": self.mc}
        self.packed = {k: pack_blocks(b, c, rows[k])
                       for k, (c, b) in level_blocks(lev).items()}

    def values(self, lev, dtype, device) -> dict:
        return {k: packed_params(pk, dtype, device)
                for k, pk in self.packed.items()}

    def op_pair(self, x, v):
        """K19: (A·x, M·x) on (T, m)."""
        return spmm_pair(x, v["op"], self.m)

    def interp(self, e, v):
        """K20: P·e, (T, m_c) -> (T, m)."""
        return spmm(e, v["P"], self.m)

    def restrict(self, r, v):
        """K20: Pᵀ·r, (T, m) -> (T, m_c)."""
        return spmm(r, v["R"], self.mc)
