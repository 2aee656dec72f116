"""Row gathers and scatter-adds that repeat bit for bit.

The JAX package sums rows by index with ``jax.ops.segment_sum`` /
``.at[idx].add`` (the codebook gradient, the EMA sums) and gathers them with
``jnp.take`` (the prior's embedding), whose backward is the same sum. XLA
ops, not Pallas kernels: the port serves them with torch calls, and since a
run must repeat bit for bit ("same seed => bit-identical step", the JAX
package's contract) none of them may add with atomics:

- ``index_add_`` adds with atomics on a CUDA device, and the embedding
  backward (``F.embedding``) does so above 3,072 rows; two runs of one step
  then part in their last bits.
- ``index_put_(accumulate=True)`` is deterministic there but sums each code's
  rows one after the other, which takes milliseconds when most rows share a
  code: the start of every VQ-VAE training run, where a fresh codebook sends
  every latent to one code.

On a card ``scatter_add_rows`` is therefore a one-hot product in float64:
``one_hot(idx).T @ rows``, a cuBLAS DGEMM that takes the same time whatever
the indices (one chunk of rows at a time where the one-hot matrix would pass
64 MB), with every 0/1 product exact, the sum in float64 and one rounding to
the rows' dtype at the end. ``chip_smoke.py`` phase 9 times the three on the
card. The cuBLAS TF32 switch does not touch float64. On the CPU
it is the embedding backward (``aten::embedding_dense_backward``), which adds
each code's rows in the order of the rows: the bits of ``index_add_`` there.
"""

from __future__ import annotations

import torch

# float64 elements of the one-hot matrix of one chunk of rows (64 MB)
_ONE_HOT_ELEMENTS = 1 << 23


def one_hot_sum(indices: torch.Tensor, rows: torch.Tensor, k: int) -> torch.Tensor:
    """(K, D) sums of ``rows`` (N, D) by ``indices`` (N,) as float64 one-hot
    products, chunk by chunk in row order; the result in the rows' dtype."""
    codes = torch.arange(k, device=rows.device, dtype=indices.dtype)
    step = max(1, _ONE_HOT_ELEMENTS // k)
    out = None
    for s in range(0, rows.shape[0], step):
        hot = (indices[s:s + step, None] == codes).to(torch.float64)
        part = rows[s:s + step].to(torch.float64)
        out = hot.T @ part if out is None else out.addmm_(hot.T, part)
    if out is None:
        return rows.new_zeros((k, rows.shape[1]))
    return out.to(rows.dtype)


def scatter_add_rows(indices: torch.Tensor, rows: torch.Tensor, k: int) -> torch.Tensor:
    """Rows (N, D) summed by index (N,) into a new (K, D) tensor, the same
    bits on every run (module docstring)."""
    if rows.is_cuda:
        return one_hot_sum(indices, rows, k)
    return torch.ops.aten.embedding_dense_backward(rows, indices, k, -1, False)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, indices):
        ctx.save_for_backward(indices)
        ctx.k = table.shape[0]
        return table.index_select(0, indices.reshape(-1)).reshape(*indices.shape, table.shape[1])

    @staticmethod
    def backward(ctx, grad):
        (indices,) = ctx.saved_tensors
        g = grad.reshape(-1, grad.shape[-1])
        return scatter_add_rows(indices.reshape(-1), g, ctx.k), None


def gather_rows(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """``F.embedding(indices, table)`` whose backward is ``scatter_add_rows``:
    (K, D) table, integer indices (...) -> (..., D)."""
    return _GatherRows.apply(table, indices)


__all__ = ["gather_rows", "one_hot_sum", "scatter_add_rows"]
