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

    "auto"    on the card, ``_auto_impl``'s measured rule: the hand-written
              kernel (ops/cuda_quantizer.py, ``kernel_route``'s route) unless
              the exact matmul branch ``nearest_code_matmul`` measured
              faster at that (N, K, D) and mode on an H100
              (``artifacts_torch/autotune_h100.json``); ties go to the kernel
    "pallas"  on the card, the kernel, whatever the shape
    "jnp"     on the card, ``nearest_code_matmul``: cuBLAS's product in the
              mode's exact arithmetic, fp32 scores, argmin, gather

On the card every impl follows the kernels' NaN rule: a NaN score is never
chosen, and a row whose scores are all NaN gets code 0. A CPU tensor takes
the plain version ``nearest_code_torch`` under every impl, as JAX's
``_auto_impl`` returns "jnp" off the TPU; it follows ``torch.argmin``'s
rule, the first NaN, as ``jnp.argmin`` does. Such scores arise only in a run
that has already diverged.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from vqvae_tpu_torch.config import check_quantizer_impl
from vqvae_tpu_torch.ops import cuda_quantizer
from vqvae_tpu_torch.ops.conv import conv_fp32_precision
from vqvae_tpu_torch.ops.scatter import scatter_add_rows
from vqvae_tpu_torch.utils.profiling import annotate


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

    The search of a CPU tensor under every impl, and the tests' oracle.
    ``torch.argmin`` returns the first minimum, the tie rule of the kernel,
    and the first NaN: a NaN codebook row takes every row, as under
    ``jnp.argmin`` in the JAX package's CPU path.
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


def nearest_code_matmul(
    z_flat: torch.Tensor, codebook: torch.Tensor, precision: str = "highest"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The matmul branch: (N, D), (K, D) -> (z_q (N, D), indices (N,) int32),
    the counterpart of JAX's ``_nearest_code_fwd_jnp`` (XLA's matmul +
    argmin) and what ``"jnp"`` runs on the card.

    The scores are fp32, ||e||^2 from the unrounded codebook minus 2 z.e in
    the mode's exact arithmetic, as in ``code_scores``: "highest" an fp32
    product with TF32 off; "default" the bf16-rounded operands and "high"
    the three hi/lo pairs side by side along the depth, each an fp32 product
    with TF32 allowed, which is exact for them (a bf16 value is exact in
    TF32, and the product of two is exact in fp32). One ``addmm`` computes
    them; only its order of summation differs from ``code_scores``, so its
    codes differ from the plain version's only at near-ties
    (``compare_assignments``). The TF32 switch is set around that product
    alone, inside ``conv_fp32_precision``'s lock, and restored after.

    NaN rule: the kernels' (ops/cuda_quantizer.py). NaN scores become +inf
    before the argmin, which takes the first minimum, so a NaN score is never
    chosen and a row whose scores are all NaN (or +inf) gets code 0, as a
    kernel's row that never takes a score keeps its start, (+inf, 0).
    """
    if precision not in ("highest", "high", "default"):
        raise ValueError(f"precision must be highest, high or default, got {precision!r}")
    z, cb = z_flat.float(), codebook.float()
    e_sq = (cb * cb).sum(1)
    terms = _mode_terms(z, cb, precision)
    z_cat, cb_cat = terms[0] if len(terms) == 1 else (
        torch.cat([zt for zt, _ in terms], 1), torch.cat([ct for _, ct in terms], 1))
    with conv_fp32_precision("highest" if precision == "highest" else "default"):
        # ||e||^2 as a vector: cuBLASLt adds it in the product's epilogue
        # instead of a pass that first broadcasts it into the output
        scores = torch.addmm(e_sq, z_cat, cb_cat.T, alpha=-2.0)
    inf = float("inf")  # infinities kept as they are: nan_to_num_ would make them finite
    indices = scores.nan_to_num_(nan=inf, posinf=inf, neginf=-inf).argmin(1).to(torch.int32)
    return codebook.index_select(0, indices), indices


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


# Above this the (N, K) fp32 scores are not materialised: "auto" takes the
# kernel, which keeps them on chip. 2 GiB is the largest score matrix the
# sweep measured (artifacts_torch/autotune_h100.json: N = 65,536, K = 8,192,
# on an NVIDIA H100 80GB HBM3 at 700.00 W); beyond it there is no measurement,
# and on an 80 GB card a transient of that size beside a model's activations,
# a caller's batch of z and the branch's own operands is the most "auto"
# should ask for unasked.
_SCORES_BUDGET_BYTES = 2 * 1024**3
# The measured rule (artifacts_torch/autotune_h100.json: python -m
# vqvae_tpu_torch.bench.quantizer --grid, 144 rows; NVIDIA H100 80GB HBM3,
# 700.00 W, torch 2.11.0+cu128). Per mode, the regions (largest N, least
# K * D, least D) where the matmul branch beat the kernel by at least
# bench.quantizer.MARGIN and by more than the row's spread between turns;
# "auto" takes the kernel everywhere else, ties included. The branch is
# chosen only inside the sweep's box (N >= _SWEPT_MIN_N, K * D >= 2^15,
# D >= 64): below it both routes are a handful of launches, unmeasured.
_SWEPT_MIN_N = 2048
_MATMUL_WINS = {
    # "fma" (CUDA cores, 128-row blocks) fills 16 of 132 SMs at N = 2,048 and
    # 32 at 4,096, where cuBLAS's fp32 product wins: (2048, 512, 64) 0.02984
    # against 0.03352 ms (the narrowest win, 11%), (2048, 8192, 256) 0.30904
    # against 1.59031, (4096, 512, 128) 0.04439 against 0.05940; the kernel
    # wins (4096, 512, 64) (0.03410 against 0.03698) and every row from
    # N = 16,384 ((16384, 512, 64): 0.04296 against 0.09940)
    "highest": ((2048, 2**15, 64), (4096, 2**16, 64)),
    # "mma" (tensor cores) loses at D = 256, where its two-plane layout takes
    # 16-code tiles: (2048, 2048, 256) 0.10757 against 0.24031 and (4096,
    # 8192, 256) 0.40279 against 0.87485, and at (2048, 8192, 128) 0.20079
    # against 0.27536; it holds (2048, 4096, 128) (0.12671 against 0.13996,
    # a 9.5% tie), (4096, 8192, 128) and every row from N = 16,384
    "high": ((2048, 2**20, 128), (4096, 2**19, 256)),
    # "mma" at D = 256 (32-code tiles) loses at (2048, 2048, 256) 0.06100
    # against 0.09620, (4096, 4096, 256) 0.15531 against 0.17797 and
    # (2048, 8192, 128) 0.15312 against 0.18039; it holds (4096, 2048, 256)
    # and (2048, 4096, 128) (ties: 0.09342 against 0.09642, 0.09012 against
    # 0.09136) and every row from N = 16,384
    "default": ((2048, 2**19, 256), (2048, 2**20, 128), (4096, 2**20, 256)),
}


def _auto_impl(n: int, k: int, d: int, precision: str, on_card: bool) -> str:
    """The measured-dispatch rule for impl="auto": "pallas" (the kernel) or
    "jnp" (the matmul branch), a pure function of the shape and the mode.
    Off the card it is "jnp", as JAX's is off the TPU."""
    if not on_card:
        return "jnp"
    if 4 * n * k > _SCORES_BUDGET_BYTES:
        return "pallas"
    if n >= _SWEPT_MIN_N and any(n <= max_n and k * d >= min_kd and d >= min_d
                                 for max_n, min_kd, min_d in _MATMUL_WINS[precision]):
        return "jnp"
    return "pallas"


def _route_name(impl: str, precision: str, d: int) -> str:
    """The name of the route that serves a search decided as ``impl``
    ("plain" for a CPU tensor): the kernel's route ("fma" or "mma"),
    "matmul" for the branch, or "plain"."""
    if impl == "pallas":
        return cuda_quantizer.kernel_route(precision, d)
    return {"jnp": "matmul", "plain": "plain"}[impl]


def _search_forward(z_flat, codebook, precision: str, impl: str):
    """The forward's dispatch: on the card "pallas" launches the kernel,
    "jnp" runs the matmul branch and "auto" takes what ``_auto_impl`` says;
    a CPU tensor takes the plain version under every impl. The search runs
    in the span ``search.<route>[<N>x<K>x<D>]`` (``utils/profiling.py``)."""
    (n, d), k = z_flat.shape, codebook.shape[0]
    if not z_flat.is_cuda:
        impl = "plain"
    elif impl == "auto":
        impl = _auto_impl(n, k, d, precision, True)
    with annotate(lambda: f"search.{_route_name(impl, precision, d)}[{n}x{k}x{d}]"):
        if impl == "plain":
            return nearest_code_torch(z_flat, codebook, precision)
        if impl == "pallas":
            return cuda_quantizer.nearest_code_cuda(z_flat, codebook, precision)
        return nearest_code_matmul(z_flat, codebook, precision)


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
        with annotate("search.backward"):
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
    "nearest_code_matmul",
    "nearest_code_torch",
    "nearest_code_values_torch",
    "quantize",
]
