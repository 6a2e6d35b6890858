"""Meshes of ranks: one process per shard.

The counterpart of ``spacetime_tpu/parallel/mesh.py``. A mesh names its
axes and their sizes, the ``time`` axis outermost as in the JAX package:
rank r of a (time P × space P_s) mesh sits at time index r // P_s and space
index r % P_s. Rank r runs on ``cuda:(r % torch.cuda.device_count())``, or
on the CPU where the mesh is made with ``device="cpu"`` (the tests); ranks
share a card where there are more ranks than cards.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class RankMesh:
    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]
    device: str = "cuda"

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes) or min(self.sizes) < 1:
            raise ValueError(f"mesh {self.axis_names} x {self.sizes}")
        if self.device not in ("cuda", "cpu"):
            raise ValueError(f"mesh device {self.device!r}: 'cuda' or 'cpu'")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def coords(self, rank: int) -> dict[str, int]:
        """The axis indices of ``rank`` (the last axis fastest)."""
        out = {}
        for name, n in reversed(list(zip(self.axis_names, self.sizes))):
            out[name] = rank % n
            rank //= n
        return {name: out[name] for name in self.axis_names}

    def rank_of(self, **coords) -> int:
        r = 0
        for name, n in zip(self.axis_names, self.sizes):
            r = r * n + coords[name]
        return r

    def axis_ranks(self, axis: str, rank: int) -> list[int]:
        """The ranks of ``rank``'s group along ``axis``, in axis order."""
        c = self.coords(rank)
        return [self.rank_of(**{**c, axis: i})
                for i in range(self.shape[axis])]

    def device_of(self, rank: int) -> torch.device:
        if self.device == "cpu":
            return torch.device("cpu")
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError(
                "a CUDA mesh needs torch.cuda.is_available(); make the mesh "
                "with device='cpu' to run the ranks on the CPU")
        return torch.device("cuda", rank % n)

    def describe(self) -> list[str]:
        """One line per rank: its coordinates and its device."""
        return [
            f"rank {r} ({', '.join(f'{k} {v}' for k, v in self.coords(r).items())})"
            f" -> {self.device_of(r)}"
            for r in range(self.size)
        ]


def make_time_mesh(n: int, device: str = "cuda") -> RankMesh:
    """A mesh of ``n`` ranks over the ``time`` axis."""
    return RankMesh(("time",), (n,), device)


def make_spacetime_mesh(n_time: int, n_space: int,
                        device: str = "cuda") -> RankMesh:
    """A (time × space) mesh: time steps over ``time``, the leading spatial
    grid axis over ``space``."""
    return RankMesh(("time", "space"), (n_time, n_space), device)
