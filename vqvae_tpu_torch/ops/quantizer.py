"""The vector-quantization bottleneck (port of ``vqvae_tpu/ops/quantizer.py``).

Reproduces the reference ``VectorQuantizer.forward`` (reference
models/quantizer.py:29-76) on NHWC latents:

    loss = mean((sg[z_q] - z)^2) + beta * mean((z_q - sg[z])^2)
      (reference ordering: encoder-gradient term first with coefficient 1,
       codebook-gradient term second with coefficient beta; the EMA variant
       keeps only beta * the first term)
    z_q_ste = z + sg[z_q - z]
    perplexity = exp(-sum(p log(p + 1e-10)))

``nearest_code`` is the distance + argmin + gather step, differentiable like
``one_hot(argmin) @ codebook``: the codebook gets a scatter-add of the
cotangent rows, z gets zero. Its forward dispatches on the tensor's device
only: a CUDA tensor goes through the hand-written kernel
(ops/cuda_quantizer.py), a CPU tensor through ``nearest_code_torch``. The
config's ``quantizer_impl`` is not consulted in this slice, and the JAX
package's ``_auto_impl`` thresholds (TPU timings) are not carried over.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from vqvae_tpu_torch.ops import cuda_quantizer


class QuantizeOutput(NamedTuple):
    loss: torch.Tensor          # scalar embedding loss
    z_q: torch.Tensor           # (B, H, W, D) straight-through quantized latents
    perplexity: torch.Tensor    # scalar codebook-usage perplexity
    indices: torch.Tensor       # (B, H, W) int32 code indices
    counts: torch.Tensor        # (K,) per-code assignment counts


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and back: the operand a bf16 product sees."""
    return x.to(torch.bfloat16).to(x.dtype)


def code_scores(
    z_flat: torch.Tensor, codebook: torch.Tensor, precision: str = "highest"
) -> torch.Tensor:
    """(N, K) scores ||e||^2 - 2 z.e in the arithmetic of ``precision``.

    "highest": fp32 product. "default": bf16-rounded operands with fp32
    accumulation (a bf16 x bf16 product is exact in fp32, so an fp32 matmul
    of the rounded values is that arithmetic on any device). "high": the
    bf16x3 split hi.hi + hi.lo + lo.hi (JAX pallas_quantizer.py:64-90).
    ||e||^2 is always taken from the unrounded fp32 codebook.
    """
    z = z_flat.float()
    cb = codebook.float()
    e_sq = (cb * cb).sum(1)[None, :]
    if precision == "highest":
        prods = z @ cb.T
    elif precision == "default":
        prods = _bf16(z) @ _bf16(cb).T
    elif precision == "high":
        z_hi, cb_hi = _bf16(z), _bf16(cb)
        z_lo, cb_lo = _bf16(z - z_hi), _bf16(cb - cb_hi)
        prods = z_hi @ cb_hi.T + z_hi @ cb_lo.T + z_lo @ cb_hi.T
    else:
        raise ValueError(f"precision must be highest, high or default, got {precision!r}")
    return e_sq - 2.0 * prods


def nearest_code_torch(
    z_flat: torch.Tensor, codebook: torch.Tensor, precision: str = "highest"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: (N, D), (K, D) -> (z_q (N, D), indices (N,) int32).

    ``torch.argmin`` returns the first minimum, the tie rule of the kernel.
    """
    indices = code_scores(z_flat, codebook, precision).argmin(1).to(torch.int32)
    return codebook.index_select(0, indices), indices


def compare_assignments(
    z_flat: torch.Tensor,
    codebook: torch.Tensor,
    idx_a: torch.Tensor,
    idx_b: torch.Tensor,
    precision: str = "highest",
    rel_tol: float = 1e-5,
) -> Tuple[int, int, float]:
    """The near-tie rule for two code assignments of the same rows.

    Two implementations that sum in different orders may pick different
    codes only where those codes' scores nearly tie. For every row where
    ``idx_a`` and ``idx_b`` differ, the two codes' scores are recomputed in
    float64 from the operands the mode's arithmetic sees (bf16-rounded, or
    split hi/lo); the row is a near-tie when they differ by at most
    ``rel_tol * (||z||^2 + max ||e||^2)``.

    Returns (mismatches, near-ties among them, largest score gap).
    """
    rows = (idx_a != idx_b).nonzero().flatten()
    if rows.numel() == 0:
        return 0, 0, 0.0
    z, cb = z_flat.float(), codebook.float()
    e_sq = cb.double().pow(2).sum(1)
    if precision == "high":
        z_hi, cb_hi = _bf16(z), _bf16(cb)
        terms = [(z_hi, cb_hi), (z_hi, _bf16(cb - cb_hi)), (_bf16(z - z_hi), cb_hi)]
    elif precision == "default":
        terms = [(_bf16(z), _bf16(cb))]
    else:
        terms = [(z, cb)]

    def score(idx):
        code = idx[rows].long()
        dot = sum((zt[rows].double() * ct[code].double()).sum(1) for zt, ct in terms)
        return e_sq[code] - 2.0 * dot

    gap = (score(idx_a) - score(idx_b)).abs()
    tol = rel_tol * (z[rows].double().pow(2).sum(1) + e_sq.max())
    return int(rows.numel()), int((gap <= tol).sum()), float(gap.max())


class _NearestCode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z_flat, codebook, precision):
        if z_flat.is_cuda:
            z_q, indices = cuda_quantizer.nearest_code_cuda(z_flat, codebook, precision)
        else:
            z_q, indices = nearest_code_torch(z_flat, codebook, precision)
        ctx.save_for_backward(indices)
        ctx.codebook_shape, ctx.codebook_dtype = codebook.shape, codebook.dtype
        ctx.mark_non_differentiable(indices)
        return z_q, indices

    @staticmethod
    def backward(ctx, g_zq, _g_indices):
        (indices,) = ctx.saved_tensors
        # d(one_hot @ E)/dE: scatter-add of cotangent rows into assigned codes
        # (the JAX segment_sum, quantizer.py:171-179); z gets zero.
        d_codebook = g_zq.new_zeros(ctx.codebook_shape, dtype=ctx.codebook_dtype)
        d_codebook.index_add_(0, indices, g_zq.to(ctx.codebook_dtype))
        return torch.zeros_like(g_zq), d_codebook, None


def nearest_code(
    z_flat: torch.Tensor, codebook: torch.Tensor, precision: str = "highest"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """dist + argmin + gather: (N, D), (K, D) -> (z_q (N, D), indices (N,) int32)."""
    return _NearestCode.apply(z_flat, codebook, precision)


def quantize(
    z: torch.Tensor,
    codebook: torch.Tensor,
    beta: float,
    ema: bool = False,
    precision: str = "highest",
) -> QuantizeOutput:
    """The VQ bottleneck on an NHWC latent map z (B, H, W, D), codebook (K, D)."""
    b, h, w, d = z.shape
    k = codebook.shape[0]
    z_q_flat, idx_flat = nearest_code(z.reshape(-1, d).contiguous(), codebook, precision)
    z_q = z_q_flat.reshape(b, h, w, d)
    indices = idx_flat.reshape(b, h, w)

    if ema:
        loss = beta * torch.mean((z_q.detach() - z) ** 2)
    else:
        loss = torch.mean((z_q.detach() - z) ** 2) + beta * torch.mean(
            (z_q - z.detach()) ** 2
        )

    z_q_ste = z + (z_q - z).detach()

    # counted with a scatter-add of ones in z's dtype (the JAX
    # .at[idx].add(1.0)): torch.bincount would read the largest index back
    # to the host on a CUDA tensor, one synchronisation in every train step
    counts = torch.zeros(k, dtype=z.dtype, device=z.device).index_add_(
        0, idx_flat, torch.ones_like(idx_flat, dtype=z.dtype)
    )
    e_mean = counts / idx_flat.shape[0]
    perplexity = torch.exp(-torch.sum(e_mean * torch.log(e_mean + 1e-10)))

    return QuantizeOutput(
        loss=loss, z_q=z_q_ste, perplexity=perplexity, indices=indices, counts=counts
    )


__all__ = [
    "QuantizeOutput",
    "code_scores",
    "compare_assignments",
    "nearest_code",
    "nearest_code_torch",
    "quantize",
]
