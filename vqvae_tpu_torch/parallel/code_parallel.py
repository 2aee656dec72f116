"""Codebook-parallel quantization over the (data x code) mesh of ranks (port of
``vqvae_tpu/parallel/code_parallel.py``).

The (K, D) codebook is split into ``n_code`` contiguous blocks of rows, one on
each rank of a code group; those ranks see the same rows of z. Per rank:

1. local search over K / n_code codes, with each row's winning score: the
   hand-written kernel on a card (``nearest_code_indices(..., values=True)``,
   the float it compared), the plain version on the CPU. JAX's shard path is
   plain ``jnp`` (``code_parallel.py:78-82``); the port's search on the card
   is its kernel.
2. cross-shard combine: all-gather of the (value, index) pairs over ``code``
   (n_code x N scalars), the winning shard by ``argmin`` over the stack, so
   the lowest shard wins a tie. Shards hold contiguous codes, so that is the
   unsharded search's first minimum: global index = shard * K_loc + local.
3. masked local gather + all-reduce sum over ``code``: each row's z_q comes
   from the one rank that holds its code.

The backward is shard-local (``code_parallel.py:110-122``): each rank
scatter-adds the cotangent rows its shard won into its (K_loc, D) gradient,
and z gets zero, as ``ops/quantizer.py``'s ``nearest_code``.

JAX's ``quantize_sharded`` is ``ops/quantizer.py::quantize`` with a mesh
and this search (``search=partial(nearest_code_sharded, mesh=mesh)``); the
mesh of ranks itself is ``parallel/mesh.py::make_mesh`` (JAX's
``make_2d_mesh``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from vqvae_tpu_torch.ops import cuda_quantizer
from vqvae_tpu_torch.ops.quantizer import nearest_code_values_torch
from vqvae_tpu_torch.ops.scatter import scatter_add_rows
from vqvae_tpu_torch.parallel.mesh import Mesh


def check_divisible(k: int, n: int, mesh: Mesh) -> None:
    """The errors of ``vqvae_tpu/parallel/code_parallel.py:143-150``: K rows
    over the code axis, N global rows (or a global batch) over the data axis."""
    if k % mesh.n_code != 0:
        raise ValueError(f"codebook rows {k} not divisible by code axis {mesh.n_code}")
    if n % mesh.n_data != 0:
        raise ValueError(f"N {n} not divisible by data axis {mesh.n_data}")


def combine_shards(values: torch.Tensor, indices: torch.Tensor, k_local: int):
    """Per-shard (value, local index) stacks (n_code, N) -> (winning shard,
    its local index, global index), each (N,). ``argmin`` over the shards
    takes the first minimum: on a tie the lowest shard, whose codes come
    first (``code_parallel.py:89-91``)."""
    win_shard = values.argmin(0)
    win_local = indices.gather(0, win_shard[None])[0].long()
    return win_shard, win_local, (win_shard * k_local + win_local).to(torch.int32)


def masked_gather(codebook_local: torch.Tensor, win_shard: torch.Tensor,
                  win_local: torch.Tensor, shard: int) -> torch.Tensor:
    """Rows of this shard's codebook for the rows it won, zero elsewhere; the
    sum over the code group is z_q."""
    rows = codebook_local.index_select(0, win_local)
    return torch.where((win_shard == shard)[:, None], rows, torch.zeros_like(rows))


def shard_codebook_grad(g_zq: torch.Tensor, win_shard: torch.Tensor, win_local: torch.Tensor,
                        shard: int, k_local: int) -> torch.Tensor:
    """The backward of ``masked_gather`` summed over the shards, on one shard:
    a scatter-add of the cotangent rows it won into its (K_loc, D) rows."""
    mine = (win_shard == shard)[:, None]
    g = torch.where(mine, g_zq, torch.zeros_like(g_zq))
    return scatter_add_rows(win_local, g, k_local)


def local_search(z_flat: torch.Tensor, codebook_local: torch.Tensor, precision: str):
    """This shard's (indices int32, winning scores fp32): the kernel on a card,
    the plain version on the CPU."""
    if z_flat.is_cuda:
        return cuda_quantizer.nearest_code_indices(z_flat, codebook_local, precision, values=True)
    return nearest_code_values_torch(z_flat, codebook_local, precision)


def exchange_and_combine(indices: torch.Tensor, values: torch.Tensor, mesh: Mesh, k_local: int):
    """All-gather this shard's (value, index) pairs over the code group, as
    one (2, N) fp32 message (the int32 indices travel as their bits), and
    combine them."""
    message = torch.stack([values, indices.view(torch.float32)])
    gathered = mesh.gather_code(message)                     # (n_code, 2, N)
    return combine_shards(gathered[:, 0], gathered[:, 1].view(torch.int32), k_local)


class _ShardedNearestCode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z_flat, codebook_local, precision, mesh):
        k_local = codebook_local.shape[0]
        indices, values = local_search(z_flat, codebook_local, precision)
        win_shard, win_local, global_idx = exchange_and_combine(indices, values, mesh, k_local)
        z_q = mesh.psum(masked_gather(codebook_local, win_shard, win_local, mesh.code), "code")
        ctx.save_for_backward(win_shard, win_local)
        ctx.shard, ctx.k_local = mesh.code, k_local
        ctx.mark_non_differentiable(global_idx)
        return z_q, global_idx

    @staticmethod
    def backward(ctx, g_zq, _g_idx):
        win_shard, win_local = ctx.saved_tensors
        # JAX's shard_map hands each shard 1/n_code of the cotangent of an
        # output replicated over 'code' and psums it back (code_parallel.py:
        # 113-116). Here every rank of a code group ran the same loss on the
        # same rows from the all-reduced z_q, so its autograd already holds
        # the whole cotangent of its rows: no collective.
        d_cb = shard_codebook_grad(g_zq, win_shard, win_local, ctx.shard, ctx.k_local)
        return torch.zeros_like(g_zq), d_cb, None, None


def nearest_code_sharded(z_flat: torch.Tensor, codebook_local: torch.Tensor, mesh: Mesh,
                         precision: str = "highest") -> Tuple[torch.Tensor, torch.Tensor]:
    """Sharded-codebook dist + argmin + gather: this rank's rows (N_loc, D) and
    codebook rows (K_loc, D) -> (z_q (N_loc, D), global indices (N_loc,) int32).

    The indices are the unsharded search's wherever each code's score is the
    same float in and out of its shard; z_q is exactly codebook[idx].
    Differentiable like one_hot(argmin) @ codebook; d/d z_flat is zero.
    """
    return _ShardedNearestCode.apply(z_flat, codebook_local, precision, mesh)


__all__ = [
    "check_divisible",
    "combine_shards",
    "exchange_and_combine",
    "local_search",
    "masked_gather",
    "nearest_code_sharded",
    "shard_codebook_grad",
]
