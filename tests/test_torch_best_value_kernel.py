"""The best-value output of both nearest-code kernels
(``nearest_code_indices(..., values=True)``), and the codebook-parallel
combine built on it, on one card.

This file imports neither JAX nor the JAX package, so its ``gpu`` tests run
on a machine that has a card and no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_best_value_kernel.py

Without a card the ``gpu`` tests skip themselves; the CPU tests run
everywhere.

Tolerances, each with its reason:
- indices with values requested: the indices without, bit for bit (the same
  kernel, one more store);
- values: within the near-tie bound of each row's least score in float64,
  ``1e-5 * (||z||^2 + max ||e||^2)`` (``best_value_errors``): the kernel sums
  in its own order;
- a codebook split into contiguous shards, searched shard by shard and
  combined (``code_parallel.combine_shards``): the unsharded call's indices
  and values, bit for bit, on the "fma" route, whose score of a code does not
  depend on where the code sits. On the "mma" route a code's column in an
  8-code tile moves with the shard's offset, so an index may differ there
  only at a near-tie (``compare_assignments``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from vqvae_tpu_torch.ops import cuda_quantizer
from vqvae_tpu_torch.ops.quantizer import (
    best_value_errors,
    compare_assignments,
    nearest_code_values_torch,
)
from vqvae_tpu_torch.parallel.code_parallel import combine_shards

ROUTES = [("highest", "fma"), ("high", "fma"), ("default", "fma"), ("high", "mma"),
          ("default", "mma")]
SHAPES = [(2048, 512, 64), (1000, 300, 48), (37, 512, 64), (1000, 300, 45),
          (1000, 301, 256)]  # the last: D = 256 on the tensor cores too
SPLITS = [(512, 2), (512, 4), (512, 8), (600, 2)]


def _inputs(n, k, d, seed=0, device="cpu"):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(device),
            torch.from_numpy(rng.standard_normal((k, d)).astype(np.float32)).to(device))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card with -m gpu")
    return torch.device("cuda")


def search_shards(z, cb, n_code, precision, route):
    """The kernel on each of ``n_code`` contiguous shards of ``cb``, then the
    combine: (global indices, the winners' values)."""
    k_local = cb.shape[0] // n_code
    found = [cuda_quantizer.nearest_code_indices(z, cb[s * k_local:(s + 1) * k_local].contiguous(),
                                                 precision, route, values=True)
             for s in range(n_code)]
    values = torch.stack([v for _i, v in found])
    win_shard, _win_local, idx = combine_shards(values, torch.stack([i for i, _v in found]), k_local)
    return idx, values.gather(0, win_shard[None])[0]


def test_values_are_refused_on_cpu_tensors():
    """No fallback: a CPU tensor is refused, values or not."""
    z, cb = _inputs(8, 4, 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_quantizer.nearest_code_indices(z, cb, values=True)


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_plain_values_sit_within_the_bound(precision):
    """The check itself, on the plain version: its values are the float32
    minimum of the mode's scores, well inside the float64 bound."""
    z, cb = _inputs(500, 200, 32, seed=3)
    _idx, values = nearest_code_values_torch(z, cb, precision)
    err, outside = best_value_errors(z, cb, values, precision)
    assert outside == 0 and err < 1e-4
    _e, outside = best_value_errors(z, cb, values + 1.0, precision)
    assert outside == len(values)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("precision,route", ROUTES)
def test_kernel_values_on_card(shape, precision, route):
    dev = _card()
    n, k, d = shape
    if route == "mma" and cuda_quantizer.kernel_route(precision, d) != "mma":
        pytest.skip(f"the mma route does not take D = {d}")
    z, cb = _inputs(n, k, d, seed=n + k + d, device=dev)
    before = cuda_quantizer.launches_by_route[route]
    idx, values = cuda_quantizer.nearest_code_indices(z, cb, precision, route, values=True)
    plain = cuda_quantizer.nearest_code_indices(z, cb, precision, route)
    assert cuda_quantizer.launches_by_route[route] == before + 2
    assert values.dtype == torch.float32 and values.shape == (n,)
    assert torch.equal(idx, plain)
    err, outside = best_value_errors(z, cb, values, precision)
    assert outside == 0, f"{outside} values outside the near-tie bound (largest error {err})"
    idx_ref, _v = nearest_code_values_torch(z, cb, precision)
    mism, near, _gap = compare_assignments(z, cb, idx, idx_ref, precision)
    assert mism == near


@pytest.mark.gpu
@pytest.mark.parametrize("k,n_code", SPLITS)
@pytest.mark.parametrize("precision,route", ROUTES)
def test_sharded_search_and_combine_on_card(k, n_code, precision, route):
    dev = _card()
    z, cb = _inputs(4096, k, 64, seed=k + n_code, device=dev)
    idx_all, val_all = cuda_quantizer.nearest_code_indices(z, cb, precision, route, values=True)
    idx, val = search_shards(z, cb, n_code, precision, route)
    if route == "fma":
        assert torch.equal(idx, idx_all) and torch.equal(val, val_all)
    else:
        mism, near, _gap = compare_assignments(z, cb, idx, idx_all, precision)
        assert mism == near
        assert best_value_errors(z, cb, val, precision)[1] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("precision,route", ROUTES)
def test_duplicated_codebook_across_shards_takes_the_lowest_shard(precision, route):
    dev = _card()
    z, base = _inputs(2048, 64, 64, seed=8, device=dev)
    cb = base.repeat(4, 1)  # shard s holds an exact copy of the codes of shard 0
    idx, _val = search_shards(z, cb, 4, precision, route)
    assert int(idx.max()) < 64
