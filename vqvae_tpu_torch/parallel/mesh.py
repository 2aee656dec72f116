"""The (data x code) mesh of ranks (port of ``vqvae_tpu/parallel/mesh.py``).

The JAX package lays devices out in a ``jax.sharding.Mesh`` and lets XLA
insert the collectives. The port runs one process a rank and one device a
rank, so the mesh is a layout of ranks and the collectives are explicit
``torch.distributed`` calls over two kinds of process group:

    rank r sits at (data, code) = (r // n_code, r % n_code)

(the row-major order of ``np.asarray(devices).reshape(n_data, n_code)`` in
``make_2d_mesh``, ``vqvae_tpu/parallel/code_parallel.py:62``).

- the ``data`` group of a rank: the ranks with its code coordinate. The
  batch is split over it; gradients of sharded leaves, assignment counts and
  EMA sums are summed over it.
- the ``code`` group: the ranks with its data coordinate. They see the same
  rows; with ``n_code > 1`` each holds K / n_code rows of the codebook.
- the world: replicated leaves (every conv weight) are reduced over it.

Where JAX spreads one process over its local devices, the port needs one
process for every rank: without ``--distributed`` the world is one rank, and
the mesh is the trivial 1 x 1 one, on which every collective is skipped and
the same training code runs alone. ``make_mesh`` is the counterpart of JAX's
``make_2d_mesh``; the batch is split over ``data`` by the sampler
(``data/sampler.py``'s ``num_shards``/``shard_id``), which draws each data
row's slice of the global batch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist


def mesh_coordinates(rank: int, n_code: int) -> tuple:
    """(data, code) coordinates of ``rank``: the row-major grid of JAX's ``make_2d_mesh``."""
    return rank // n_code, rank % n_code


@dataclass(frozen=True)
class Mesh:
    n_data: int
    n_code: int
    data: int                       # this rank's data coordinate
    code: int                       # this rank's code coordinate
    distributed: bool = False       # collectives run (a process group is up)
    data_group: Any = None          # the ranks with this rank's code coordinate
    code_group: Any = None          # the ranks with this rank's data coordinate

    @property
    def world(self) -> int:
        return self.n_data * self.n_code

    def code_rows(self, k: int) -> slice:
        """The rows of a (K, ...) leaf that this rank holds: all of them unless
        the codebook is sharded, else K / n_code contiguous rows."""
        per = k // self.n_code
        return slice(self.code * per, (self.code + 1) * per)

    def _group(self, axis: str):
        return {"data": self.data_group, "code": self.code_group, "world": None}[axis]

    def psum(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """All-reduce ``t`` in place by sum over ``axis`` ("data", "code" or
        "world"); returns ``t``. No-op off the distributed path."""
        if self.distributed:
            dist.all_reduce(t, group=self._group(axis))
        return t

    def size(self, axis: str) -> int:
        return {"data": self.n_data, "code": self.n_code, "world": self.world}[axis]

    def mean_(self, tensors: list, axis: str) -> None:
        """All-reduce ``tensors`` in place by mean over ``axis``, as one flat
        buffer (one collective for any number of them). No-op off the
        distributed path."""
        if not self.distributed or not tensors:
            return
        flat = self.psum(torch.cat([t.reshape(-1) for t in tensors]), axis).div_(self.size(axis))
        parts = flat.split([t.numel() for t in tensors])
        torch._foreach_copy_(tensors, [part.view_as(t) for part, t in zip(parts, tensors)])

    def gather_code(self, t: torch.Tensor) -> torch.Tensor:
        """All-gather ``t`` over the code group: (n_code, *t.shape), in code order."""
        if not self.distributed or self.n_code == 1:
            return t[None]
        parts = [torch.empty_like(t) for _ in range(self.n_code)]
        dist.all_gather(parts, t.contiguous(), group=self.code_group)
        return torch.stack(parts)


def make_mesh(n_data: Optional[int] = None, n_code: int = 1) -> Mesh:
    """The mesh over every rank of the process group (one rank when none is up).

    ``n_data=None`` takes world // n_code; ``n_data * n_code`` must be the
    world size. Every data and code group is made on every rank, in one order,
    as ``torch.distributed.new_group`` requires.
    """
    if n_code < 1:
        raise ValueError(f"n_code must be >= 1, got {n_code}")
    distributed = dist.is_initialized()
    world = dist.get_world_size() if distributed else 1
    if n_data is None:
        n_data = max(1, world // n_code)
    if n_data * n_code != world:
        if not distributed:
            raise ValueError(
                f"a {n_data} x {n_code} mesh needs {n_data * n_code} ranks and this process is "
                "one: start one process a rank with --distributed (the port runs one device "
                "a process; it does not spread one process over several devices)")
        raise ValueError(f"a {n_data} x {n_code} mesh needs {n_data * n_code} ranks, "
                         f"the process group has {world}")
    rank = dist.get_rank() if distributed else 0
    data, code = mesh_coordinates(rank, n_code)
    data_group = code_group = None
    if distributed:
        for c in range(n_code):
            group = dist.new_group([d * n_code + c for d in range(n_data)])
            if c == code:
                data_group = group
        for d in range(n_data):
            group = dist.new_group([d * n_code + c for c in range(n_code)])
            if d == data:
                code_group = group
    return Mesh(n_data, n_code, data, code, distributed, data_group, code_group)


def put_global(value, mesh: Mesh) -> torch.Tensor:
    """The counterpart of ``make_array_from_callback`` for a leaf of the
    codebook axis: every rank passes the same full host value (K, ...) and
    keeps its rows."""
    t = torch.as_tensor(value)
    return t[mesh.code_rows(t.shape[0])]


__all__ = ["Mesh", "make_mesh", "mesh_coordinates", "put_global"]
