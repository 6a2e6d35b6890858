"""The collectives of one rank of a mesh, on ``torch.distributed``.

The counterpart of the ``lax`` collectives that the JAX package's explicit
solvers place by hand (``lax.ppermute``, ``lax.psum``, ``lax.all_gather``,
``lax.axis_index``), as per-rank functions over the mesh's axis subgroups:

- ``ppermute(x, axis, pairs)``: rank at axis index i sends x to j for each
  (i, j) in ``pairs`` and returns what it received, zeros where nothing
  arrives (the mesh ends), as ``lax.ppermute``;
  ``exchange(axis, to_next, to_prev)`` is the forward and backward shift
  of the halo exchanges in one round trip;
- ``psum(x, axes)``: the sum over the ranks of ``axes``, added in rank
  order on every rank, so that every rank gets bitwise the same value (PCG
  steers on these scalars);
- ``all_gather(x, axis, dim)``: the axis's blocks concatenated along
  ``dim`` in axis order (``tiled=True``);
- ``axis_index(axis)``.

The backend is the caller's explicit choice. ``nccl`` takes CUDA tensors
and one card per rank; it raises before the process group starts where
ranks would share a card. ``gloo`` takes CPU tensors in its point-to-point
operations, so on CUDA ranks every operation copies its operands through
pinned host buffers and the results back (``bytes_staged`` counts those
bytes; CPU tensors go as they are): this is how ranks that share one card
exchange halos. The process
group gets a timeout, so a rank that hangs fails the run. A mesh of one
rank starts no process group: every collective is the identity (zeros
from ``ppermute``).
"""

from __future__ import annotations

import datetime
import functools
import time

import torch
import torch.distributed as dist

from .mesh import RankMesh

BACKENDS = ("gloo", "nccl")


def _timed(fn):
    """Add the collective's host wall time (staging copies and the wait for
    the peers included) to ``Comm.seconds``."""
    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(self, *args, **kwargs)
        finally:
            self.seconds += time.perf_counter() - t0
    return wrapper


class Comm:
    def __init__(self, mesh: RankMesh, rank: int = 0, backend: str = "gloo",
                 init_method: str | None = None, timeout: float = 300.0):
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
        self.mesh = mesh
        self.rank = rank
        self.backend = backend
        self.coords = mesh.coords(rank)
        self.device = mesh.device_of(rank)
        if backend == "nccl":
            if self.device.type != "cuda":
                raise ValueError("the nccl backend needs CUDA ranks")
            n = torch.cuda.device_count()
            if n < mesh.size:
                raise ValueError(
                    f"nccl takes one card per rank: {mesh.size} ranks on {n} "
                    "card(s) would share one; use backend='gloo'")
        self.exchanges = 0  # point-to-point rounds (ppermute / exchange)
        self.bytes_staged = 0  # bytes copied device <-> host for gloo
        self.seconds = 0.0  # host wall time inside the collectives
        self._groups: dict[str, object] = {}
        self.distributed = mesh.size > 1
        if not self.distributed:
            return
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        dist.init_process_group(
            backend, init_method=init_method, world_size=mesh.size, rank=rank,
            timeout=datetime.timedelta(seconds=timeout))
        # every rank creates every group, in the same order
        for axis in mesh.axis_names:
            seen = set()
            for r in range(mesh.size):
                ranks = tuple(mesh.axis_ranks(axis, r))
                if ranks in seen:
                    continue
                seen.add(ranks)
                g = dist.new_group(list(ranks))
                if rank in ranks:
                    self._groups[axis] = g

    def close(self) -> None:
        if self.distributed and dist.is_initialized():
            dist.destroy_process_group()

    # ------------------------------------------------------------ helpers

    def axis_index(self, axis: str) -> int:
        return self.coords[axis]

    def axis_size(self, axis: str) -> int:
        return self.mesh.shape[axis]

    def _peer(self, axis: str, index: int) -> int:
        return self.mesh.rank_of(**{**self.coords, axis: index})

    def _staged(self, x) -> bool:
        """Whether x moves through host memory: a CUDA tensor under gloo."""
        return self.backend == "gloo" and x.is_cuda

    def _wire(self, x):
        """x as the backend takes it: a pinned host copy under gloo for a
        CUDA tensor, else x itself (contiguous)."""
        x = x.contiguous()
        if not self._staged(x):
            return x
        buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        buf.copy_(x)
        self.bytes_staged += x.numel() * x.element_size()
        return buf

    def _buffer(self, like):
        """A receive buffer for a tensor like ``like`` (pinned host memory
        under gloo for a CUDA tensor)."""
        if not self._staged(like):
            return torch.empty_like(like, memory_format=torch.contiguous_format)
        return torch.empty(like.shape, dtype=like.dtype, pin_memory=True)

    def _back(self, buf, like):
        """A received buffer on ``like``'s device."""
        if not self._staged(like):
            return buf
        self.bytes_staged += buf.numel() * buf.element_size()
        return buf.to(like.device)

    def _group(self, axes):
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if set(axes) == set(self.mesh.axis_names):
            return None, self.mesh.size  # the world
        if len(axes) != 1:
            raise ValueError(f"axes {axes} of mesh {self.mesh.axis_names}")
        return self._groups[axes[0]], self.axis_size(axes[0])

    # -------------------------------------------------------- collectives

    @_timed
    def ppermute(self, x, axis: str, pairs):
        """``lax.ppermute`` along ``axis``: zeros where no pair sends here."""
        i = self.axis_index(axis)
        dests = [d for s, d in pairs if s == i]
        srcs = [s for s, d in pairs if d == i]
        if len(srcs) > 1:
            raise ValueError(f"pairs {pairs}: index {i} receives twice")
        self.exchanges += 1
        if not self.distributed or not (dests or srcs):
            return torch.zeros_like(x)
        wire = self._wire(x) if dests else None
        ops = [dist.P2POp(dist.isend, wire, self._peer(axis, d))
               for d in dests]
        buf = self._buffer(x) if srcs else None
        if srcs:
            ops.append(dist.P2POp(dist.irecv, buf, self._peer(axis, srcs[0])))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return self._back(buf, x) if srcs else torch.zeros_like(x)

    @_timed
    def exchange(self, axis: str, to_next, to_prev):
        """The forward and backward shifts along ``axis`` in one round trip:
        sends ``to_next`` to index i+1 and ``to_prev`` to i-1; returns
        (from_prev, from_next), what i-1 sent forward and i+1 backward,
        zeros at the mesh ends."""
        i, n = self.axis_index(axis), self.axis_size(axis)
        self.exchanges += 1
        from_prev = from_next = None
        if self.distributed and n > 1:
            ops, bufs = [], {}
            if i + 1 < n:
                ops.append(dist.P2POp(dist.isend, self._wire(to_next),
                                      self._peer(axis, i + 1)))
                bufs["next"] = self._buffer(to_prev)
                ops.append(dist.P2POp(dist.irecv, bufs["next"],
                                      self._peer(axis, i + 1)))
            if i > 0:
                ops.append(dist.P2POp(dist.isend, self._wire(to_prev),
                                      self._peer(axis, i - 1)))
                bufs["prev"] = self._buffer(to_next)
                ops.append(dist.P2POp(dist.irecv, bufs["prev"],
                                      self._peer(axis, i - 1)))
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            if "prev" in bufs:
                from_prev = self._back(bufs["prev"], to_next)
            if "next" in bufs:
                from_next = self._back(bufs["next"], to_prev)
        if from_prev is None:
            from_prev = torch.zeros_like(to_next)
        if from_next is None:
            from_next = torch.zeros_like(to_prev)
        return from_prev, from_next

    @_timed
    def psum(self, x, axes):
        """The sum of x over the ranks of ``axes`` (a name or a tuple),
        added in rank order: bitwise the same on every rank."""
        group, n = self._group(axes)
        if not self.distributed or n == 1:
            return x
        w = self._wire(x.reshape(-1))
        parts = [torch.empty_like(w) for _ in range(n)]
        dist.all_gather(parts, w, group=group)
        s = parts[0]
        for p in parts[1:]:
            s = s + p
        return self._back(s, x).reshape(x.shape)

    @_timed
    def all_gather(self, x, axis: str, dim: int = 0):
        """The blocks of ``axis`` concatenated along ``dim``, in axis order
        (``lax.all_gather(..., tiled=True)``)."""
        group, n = self._group(axis)
        if not self.distributed or n == 1:
            return x
        w = self._wire(x)
        parts = [torch.empty_like(w) for _ in range(n)]
        dist.all_gather(parts, w, group=group)
        return self._back(torch.cat(parts, dim=dim), x)
