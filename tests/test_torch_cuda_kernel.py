"""The hand-written CUDA nearest-code kernels (vqvae_tpu_torch/csrc/nearest_code.cu
on the CUDA cores, route "fma"; nearest_code_mma.cu on the tensor cores, route "mma").

This file imports neither JAX nor the JAX package, so its ``gpu`` tests run
on a machine that has a card and no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda_kernel.py

(``--noconftest`` skips tests/conftest.py, which sets JAX up.) Without a card
the ``gpu`` tests skip themselves; the wrapper's refusals run everywhere.

The oracle is the plain version ``nearest_code_torch`` on the same card.
Index tolerance: the two sum the products in different orders, so an
assignment may differ only at a near-tie (``compare_assignments``: float64
scores of the two codes within 1e-5 * (||z||^2 + max ||e||^2)). Gathered rows
must be the codebook's own bits.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from vqvae_tpu_torch.ops import cuda_quantizer
from vqvae_tpu_torch.ops.quantizer import compare_assignments, nearest_code, nearest_code_torch

MODES = ["highest", "high", "default"]


def _inputs(n, k, d, seed=0):
    rng = np.random.default_rng(seed)
    return (
        torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)),
        torch.from_numpy(rng.standard_normal((k, d)).astype(np.float32)),
    )


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card with -m gpu")
    return torch.device("cuda")


def test_cuda_wrapper_rejects_cpu_tensors():
    """The kernel wrapper never falls back: a CPU tensor is refused before any
    build or launch, and the launch count does not move."""
    z, cb = _inputs(8, 4, 4)
    before = cuda_quantizer.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_quantizer.nearest_code_cuda(z, cb)
    assert cuda_quantizer.launches == before


def test_nearest_code_on_cpu_takes_the_plain_version():
    """On CPU tensors ``nearest_code`` is the plain version and launches nothing."""
    z, cb = _inputs(50, 30, 8, seed=1)
    before = cuda_quantizer.launches
    zq, idx = nearest_code(z, cb, "highest")
    zq_ref, idx_ref = nearest_code_torch(z, cb, "highest")
    assert torch.equal(idx, idx_ref) and torch.equal(zq, zq_ref)
    assert cuda_quantizer.launches == before


def _nan_case(dev):
    """z (1000, 64) with row 7 NaN; a codebook (512, 64) whose row 300 is NaN."""
    z, cb = _inputs(1000, 512, 64, seed=9)
    z[7] = float("nan")
    cb[300] = float("nan")
    return z.to(dev), cb.to(dev)


@pytest.mark.parametrize("precision", MODES)
def test_plain_version_takes_the_first_nan(precision):
    """The plain version (the CPU path) follows torch.argmin: the first NaN
    score wins, so the NaN codebook row takes every finite row and the NaN
    row of z gets code 0."""
    z, cb = _nan_case("cpu")
    _zq, idx = nearest_code(z, cb, precision)
    want = torch.full((1000,), 300, dtype=torch.int32)
    want[7] = 0
    assert torch.equal(idx, want)


@pytest.mark.gpu
@pytest.mark.parametrize("precision", MODES)
def test_kernels_skip_nan_scores_on_card(precision):
    """The kernels' rule (ops/cuda_quantizer.py): a NaN score is skipped and
    the rest of its tile kept, so no row takes code 300 and every finite row
    gets the nearest of the other codes (near-tie rule); the NaN row of z
    gets code 0. The plain version on the card follows torch.argmin."""
    dev = _card()
    z, cb = _nan_case(dev)
    keep = torch.arange(512, device=dev) != 300
    _, idx_rest = nearest_code_torch(z, cb[keep], precision)
    want = idx_rest + (idx_rest >= 300).int()  # back to the full codebook's numbering
    finite = torch.arange(1000, device=dev) != 7
    for route in dict.fromkeys((cuda_quantizer.kernel_route(precision, 64), "fma")):
        idx = cuda_quantizer.nearest_code_indices(z, cb, precision, route)
        torch.cuda.synchronize()
        assert int(idx[7]) == 0 and not bool((idx == 300).any()), route
        mism, near, gap = compare_assignments(z[finite], cb.nan_to_num(0.0), idx[finite],
                                              want[finite], precision)
        assert mism == near, (route, mism, near, gap)
    _, idx_plain = nearest_code_torch(z, cb, precision)
    want_plain = torch.full((1000,), 300, dtype=torch.int32, device=dev)
    want_plain[7] = 0
    assert torch.equal(idx_plain, want_plain)


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["fma", "mma"])
@pytest.mark.parametrize("precision", MODES)
@pytest.mark.parametrize(
    "shape",
    [(1000, 300, 48), (2048, 512, 64), (257, 70, 256), (4096, 301, 64), (300, 77, 128),
     (1000, 300, 45), (200, 130, 452), (37, 512, 64), (600, 301, 80), (500, 301, 144),
     (1000, 301, 256)],
)
def test_cuda_kernel_vs_plain_on_card(shape, precision, route):
    """Near-tie rule, exact gather, first minimum on a duplicated codebook,
    ragged N and K edges (K = 301 and 77 are no multiples of 8 or of a code
    tile), D up to 452 (walked in chunks), D = 45 (no multiple of 4: the
    CUDA-core kernel's scalar loads), N = 37 (less than a block), and on the
    tensor-core kernel D = 80, 144 and 256 (two, three and four 64-depth
    swizzle atoms, the last two of them part-filled or with narrower code
    tiles), on each route that takes the case."""
    dev = _card()
    assert torch.get_float32_matmul_precision() == "highest"  # the plain version in fp32
    n, k, d = shape
    if route == "mma" and cuda_quantizer.kernel_route(precision, d) != "mma":
        pytest.skip(f"the mma route does not take {precision!r} at D = {d}")
    z, cb = (t.to(dev) for t in _inputs(n, k, d))
    before = cuda_quantizer.launches
    before_route = dict(cuda_quantizer.launches_by_route)
    zq, idx = cuda_quantizer.nearest_code_cuda(z, cb, precision, route)
    torch.cuda.synchronize()
    assert cuda_quantizer.launches == before + 1
    other = "fma" if route == "mma" else "mma"
    assert cuda_quantizer.launches_by_route[route] == before_route[route] + 1
    assert cuda_quantizer.launches_by_route[other] == before_route[other]
    assert idx.dtype == torch.int32 and idx.shape == (n,)
    _, idx_ref = nearest_code_torch(z, cb, precision)
    mism, near, gap = compare_assignments(z, cb, idx, idx_ref, precision)
    assert mism == near, f"{mism - near} of {mism} mismatches are not near-ties (gap {gap})"
    assert torch.equal(zq, cb.index_select(0, idx))
    cb_dup = torch.cat([cb[: k // 2], cb[: k // 2]])
    _, idx_dup = cuda_quantizer.nearest_code_cuda(z, cb_dup, precision, route)
    assert int(idx_dup.max()) < k // 2


@pytest.mark.gpu
def test_default_dispatch_on_card_follows_kernel_route():
    dev = _card()
    for precision, d in (("default", 64), ("highest", 64), ("high", 40)):
        z, cb = (t.to(dev) for t in _inputs(64, 16, d, seed=5))
        route = cuda_quantizer.kernel_route(precision, d)
        before = cuda_quantizer.launches_by_route[route]
        cuda_quantizer.nearest_code_indices(z, cb, precision)
        assert cuda_quantizer.launches_by_route[route] == before + 1
    with pytest.raises(ValueError, match="mma route"):
        cuda_quantizer.nearest_code_indices(z, cb, "high", "mma")


@pytest.mark.gpu
def test_nearest_code_on_card_launches_the_kernel_and_backprops():
    """A CUDA tensor goes through the kernel; the backward scatter-adds the
    cotangent into the codebook rows and gives z a zero gradient."""
    dev = _card()
    z, cb = (t.to(dev).requires_grad_() for t in _inputs(300, 40, 16, seed=2))
    g = torch.randn(300, 16, device=dev)
    before = cuda_quantizer.launches
    zq, idx = nearest_code(z, cb, "highest")
    assert cuda_quantizer.launches == before + 1
    (zq * g).sum().backward()
    want = torch.zeros_like(cb).index_add_(0, idx.long(), g)
    torch.testing.assert_close(cb.grad, want, rtol=0, atol=1e-5)
    assert torch.count_nonzero(z.grad) == 0


@pytest.mark.gpu
def test_cuda_wrapper_rejects_bad_inputs_on_card():
    dev = _card()
    z, cb = (t.to(dev) for t in _inputs(16, 8, 4))
    with pytest.raises(ValueError, match="float32"):
        cuda_quantizer.nearest_code_indices(z.half(), cb)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_quantizer.nearest_code_indices(z.t(), cb[:, :4].t().contiguous())
    with pytest.raises(ValueError, match="depth"):
        cuda_quantizer.nearest_code_indices(z, cb[:, :3].contiguous())
    with pytest.raises(ValueError, match="precision"):
        cuda_quantizer.nearest_code_indices(z, cb, "fast")


@pytest.mark.gpu
@pytest.mark.parametrize("precision", MODES)
def test_jnp_launches_no_kernel_on_card(precision):
    """``quantizer_impl`` on the card: under "jnp" the search is the matmul
    branch and no kernel is launched; under "pallas" one kernel is launched;
    under "auto" what ``_auto_impl`` says; each within the near-tie rule of
    the plain version."""
    from functools import partial

    from vqvae_tpu_torch.ops.quantizer import _auto_impl, quantize

    dev = _card()
    z, cb = (t.to(dev) for t in _inputs(2048, 512, 64, seed=11))
    _zq_ref, idx_ref = nearest_code_torch(z, cb, precision)
    before = cuda_quantizer.launches
    zq, idx = nearest_code(z, cb, precision, impl="jnp")
    q = quantize(z.reshape(32, 8, 8, 64), cb, 0.25, precision=precision, search=partial(nearest_code, impl="jnp"))
    torch.cuda.synchronize()
    assert cuda_quantizer.launches == before
    assert torch.equal(zq, cb.index_select(0, idx)) and torch.equal(q.indices.reshape(-1), idx)
    mism, near, gap = compare_assignments(z, cb, idx, idx_ref, precision)
    assert mism == near, ("jnp", mism, near, gap)
    for impl in ("auto", "pallas"):
        kernel = impl == "pallas" or _auto_impl(2048, 512, 64, precision, True) == "pallas"
        before = cuda_quantizer.launches
        _zq, idx = nearest_code(z, cb, precision, impl=impl)
        torch.cuda.synchronize()
        assert cuda_quantizer.launches == before + int(kernel), impl
        mism, near, gap = compare_assignments(z, cb, idx, idx_ref, precision)
        assert mism == near, (impl, mism, near, gap)


@pytest.mark.gpu
@pytest.mark.parametrize("precision", MODES)
@pytest.mark.parametrize("shape", [(2048, 512, 64), (4096, 2048, 256), (16384, 8192, 128)])
def test_matmul_branch_on_card(shape, precision):
    """The matmul branch against the plain version and both kernels at three
    swept shapes: codes within the near-tie rule, z_q the codebook's rows, no
    kernel launched; with codebook row 300 and z row 7 NaN it follows the
    kernels' NaN rule (no row on code 300, row 7 on code 0)."""
    from vqvae_tpu_torch.ops.quantizer import nearest_code_matmul

    dev = _card()
    n, k, d = shape
    z, cb = (t.to(dev) for t in _inputs(n, k, d, seed=12))
    _zq, idx_ref = nearest_code_torch(z, cb, precision)
    before = cuda_quantizer.launches
    zq, idx = nearest_code_matmul(z, cb, precision)
    torch.cuda.synchronize()
    assert cuda_quantizer.launches == before
    assert torch.equal(zq, cb.index_select(0, idx))
    routes = dict.fromkeys((cuda_quantizer.kernel_route(precision, d), "fma"))
    for other in [idx_ref] + [cuda_quantizer.nearest_code_indices(z, cb, precision, r) for r in routes]:
        mism, near, gap = compare_assignments(z, cb, idx, other, precision)
        assert mism == near, (mism, near, gap)
    z[7], cb[300] = float("nan"), float("nan")
    _zq, idx = nearest_code_matmul(z, cb, precision)
    idx_k = cuda_quantizer.nearest_code_indices(z, cb, precision)
    finite = torch.arange(n, device=dev) != 7
    assert int((idx == 300).sum()) == 0 and int(idx[7]) == 0 and int(idx_k[7]) == 0
    mism, near, gap = compare_assignments(z[finite], cb.nan_to_num(0.0), idx[finite], idx_k[finite], precision)
    assert mism == near, (mism, near, gap)