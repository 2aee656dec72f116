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
cotangent rows (``ops/scatter.py::scatter_add_rows``, the same bits on every
run), z gets zero. Its forward is chosen by ``impl`` (the config's
``quantizer_impl``), as the JAX ``_dispatch_forward`` chooses:

    "auto", "pallas"  a CUDA tensor launches the hand-written kernel
                      (ops/cuda_quantizer.py, ``kernel_route``'s route) or
                      raises; a CPU tensor takes ``nearest_code_torch``, the
                      kernel's arithmetic (JAX runs its kernel in interpret
                      mode off the TPU)
    "jnp"             ``nearest_code_torch`` on any device: the framework's
                      unfused matmul + argmin, no kernel launch

The JAX package's ``_auto_impl`` thresholds are TPU timings and are not
carried over: "auto" is the kernel on the card.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from vqvae_tpu_torch.config import check_quantizer_impl
from vqvae_tpu_torch.ops import cuda_quantizer
from vqvae_tpu_torch.ops.scatter import scatter_add_rows


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


def nearest_code_values_torch(
    z_flat: torch.Tensor, codebook: torch.Tensor, precision: str = "highest"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the search with its best values: (N, D), (K, D) ->
    (indices (N,) int32, each row's winning score (N,) fp32), the counterpart
    of ``cuda_quantizer.nearest_code_indices(..., values=True)``.

    ``torch.argmin`` returns the first minimum, the tie rule of the kernels,
    and the first NaN (the NaN rule of this plain version, see
    ``ops/cuda_quantizer.py``); the value is the score it picked.
    """
    scores = code_scores(z_flat, codebook, precision)
    indices = scores.argmin(1)
    return indices.to(torch.int32), scores.gather(1, indices[:, None])[:, 0]


def nearest_code_torch(
    z_flat: torch.Tensor, codebook: torch.Tensor, precision: str = "highest"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: (N, D), (K, D) -> (z_q (N, D), indices (N,) int32).

    ``torch.argmin`` returns the first minimum, the tie rule of the kernel.
    """
    indices, _values = nearest_code_values_torch(z_flat, codebook, precision)
    return codebook.index_select(0, indices), indices


def _mode_terms(z: torch.Tensor, cb: torch.Tensor, precision: str) -> list:
    """The (z, e) operand pairs whose products the mode's arithmetic sums."""
    if precision == "high":
        z_hi, cb_hi = _bf16(z), _bf16(cb)
        return [(z_hi, cb_hi), (z_hi, _bf16(cb - cb_hi)), (_bf16(z - z_hi), cb_hi)]
    if precision == "default":
        return [(_bf16(z), _bf16(cb))]
    return [(z, cb)]


def best_value_errors(
    z_flat: torch.Tensor,
    codebook: torch.Tensor,
    values: torch.Tensor,
    precision: str = "highest",
    rel_tol: float = 1e-5,
) -> Tuple[float, int]:
    """How far reported best values lie from each row's least score computed
    in float64 from the operands the mode's arithmetic sees.

    A value summed in another order may differ from that minimum by the
    near-tie bound of ``compare_assignments``, ``rel_tol * (||z||^2 + max
    ||e||^2)``, and no more. Returns (largest absolute difference, rows
    outside the bound).
    """
    z, cb = z_flat.float(), codebook.float()
    e_sq = cb.double().pow(2).sum(1)
    dots = sum(zt.double() @ ct.double().T for zt, ct in _mode_terms(z, cb, precision))
    best = (e_sq[None, :] - 2.0 * dots).min(1).values
    err = (values.double() - best).abs()
    tol = rel_tol * (z.double().pow(2).sum(1) + e_sq.max())
    return float(err.max()), int((err > tol).sum())


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
    terms = _mode_terms(z, cb, precision)

    def score(idx):
        code = idx[rows].long()
        dot = sum((zt[rows].double() * ct[code].double()).sum(1) for zt, ct in terms)
        return e_sq[code] - 2.0 * dot

    gap = (score(idx_a) - score(idx_b)).abs()
    tol = rel_tol * (z[rows].double().pow(2).sum(1) + e_sq.max())
    return int(rows.numel()), int((gap <= tol).sum()), float(gap.max())


def _search_forward(z_flat, codebook, precision: str, impl: str):
    """The forward's dispatch: the kernel on the card unless ``impl`` is
    "jnp", the plain version otherwise (no fallback from the kernel)."""
    if impl != "jnp" and z_flat.is_cuda:
        return cuda_quantizer.nearest_code_cuda(z_flat, codebook, precision)
    return nearest_code_torch(z_flat, codebook, precision)


class _NearestCode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z_flat, codebook, precision, impl):
        z_q, indices = _search_forward(z_flat, codebook, precision, impl)
        ctx.save_for_backward(indices)
        ctx.codebook_shape, ctx.codebook_dtype = codebook.shape, codebook.dtype
        ctx.mark_non_differentiable(indices)
        return z_q, indices

    @staticmethod
    def backward(ctx, g_zq, _g_indices):
        (indices,) = ctx.saved_tensors
        # d(one_hot @ E)/dE: scatter-add of cotangent rows into assigned codes
        # (the JAX segment_sum, quantizer.py:171-179); z gets zero.
        d_codebook = scatter_add_rows(indices, g_zq.to(ctx.codebook_dtype), ctx.codebook_shape[0])
        return torch.zeros_like(g_zq), d_codebook, None, None


def nearest_code(
    z_flat: torch.Tensor, codebook: torch.Tensor, precision: str = "highest", impl: str = "auto"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """dist + argmin + gather: (N, D), (K, D) -> (z_q (N, D), indices (N,) int32)."""
    check_quantizer_impl(impl)
    return _NearestCode.apply(z_flat, codebook, precision, impl)


def quantize(
    z: torch.Tensor,
    codebook: torch.Tensor,
    beta: float,
    ema: bool = False,
    precision: str = "highest",
    mesh=None,
    search: Callable = nearest_code,
) -> QuantizeOutput:
    """The VQ bottleneck on an NHWC latent map z (B, H, W, D), codebook (K, D).

    On a mesh of ranks (``parallel/mesh.py``) z is this rank's rows of the
    global batch and ``codebook`` its rows of the codebook; ``search`` is then
    the sharded search where the codebook is sharded
    (``parallel/code_parallel.py::nearest_code_sharded`` bound to the mesh).
    The loss is this rank's rows'; ``counts`` and the perplexity are the
    global batch's, the counts summed over the mesh's data group. On one
    process (no mesh, or the trivial one) that sum does nothing. The caller
    binds the config's ``quantizer_impl`` into ``search``
    (``partial(nearest_code, impl=...)``).
    """
    b, h, w, d = z.shape
    n_data = 1 if mesh is None else mesh.n_data
    k = codebook.shape[0] * (1 if mesh is None else mesh.n_code)
    z_q_flat, idx_flat = search(z.reshape(-1, d).contiguous(), codebook, precision=precision)
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
    if mesh is not None:
        mesh.psum(counts, "data")
    e_mean = counts / (idx_flat.shape[0] * n_data)
    perplexity = torch.exp(-torch.sum(e_mean * torch.log(e_mean + 1e-10)))

    return QuantizeOutput(
        loss=loss, z_q=z_q_ste, perplexity=perplexity, indices=indices, counts=counts
    )


__all__ = [
    "QuantizeOutput",
    "best_value_errors",
    "code_scores",
    "compare_assignments",
    "nearest_code",
    "nearest_code_torch",
    "nearest_code_values_torch",
    "quantize",
]
