"""The port's quantizer (vqvae_tpu_torch.ops.quantizer) held against the JAX package.

Inputs come from seeded numpy and go to both frameworks. Oracles: for
"highest", ``nearest_code_jnp`` (fp32 XLA); for "high" and "default",
``nearest_code_pallas(..., interpret=True)``, because XLA on the CPU ignores
``precision="default"`` and would compute those modes in full fp32, while
the interpreted Pallas kernel does the bf16 rounding the mode asks for.

Index tolerance: the two frameworks sum the products in different orders,
so a code assignment may differ only at a near-tie (``compare_assignments``:
the float64 scores of the two codes, in the mode's operands, within
1e-5 * (||z||^2 + max ||e||^2)). Gathered rows must be bit-exact codebook rows.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_tpu.ops.pallas_quantizer import nearest_code_pallas
from vqvae_tpu.ops.quantizer import nearest_code_jnp
from vqvae_tpu.ops.quantizer import quantize as jax_quantize
from vqvae_tpu_torch.ops.quantizer import (
    compare_assignments,
    nearest_code,
    nearest_code_torch,
    quantize,
)

MODES = ["highest", "high", "default"]


def _inputs(n, k, d, seed=0):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((n, d)).astype(np.float32),
        rng.standard_normal((k, d)).astype(np.float32),
    )


def _jax_oracle(z, cb, precision):
    if precision == "highest":
        zq, idx = nearest_code_jnp(jnp.asarray(z), jnp.asarray(cb), precision="highest")
    else:
        zq, idx = nearest_code_pallas(
            jnp.asarray(z), jnp.asarray(cb), interpret=True, precision=precision
        )
    return np.array(zq), np.array(idx)


def _assert_same_codes(z, cb, idx_t, idx_j, precision):
    mism, near, gap = compare_assignments(
        torch.from_numpy(z), torch.from_numpy(cb), idx_t, torch.from_numpy(np.array(idx_j)), precision
    )
    assert mism == near, f"{mism - near} of {mism} index mismatches are not near-ties (gap {gap})"
    assert mism <= max(2, len(z) // 100), f"{mism} near-tie mismatches of {len(z)} rows"


@pytest.mark.parametrize("precision", MODES)
@pytest.mark.parametrize("shape", [(200, 300, 48), (256, 512, 64), (64, 37, 8)])
def test_nearest_code_torch_vs_jax(shape, precision):
    z, cb = _inputs(*shape)
    zq_t, idx_t = nearest_code_torch(torch.from_numpy(z), torch.from_numpy(cb), precision)
    _zq_j, idx_j = _jax_oracle(z, cb, precision)
    assert idx_t.dtype == torch.int32 and idx_t.shape == (shape[0],)
    _assert_same_codes(z, cb, idx_t, idx_j, precision)
    # the gather is exact: rows are the codebook's own bits
    assert np.array_equal(zq_t.numpy(), cb[idx_t.numpy()])


@pytest.mark.parametrize("precision", MODES)
def test_nearest_code_duplicate_codebook_takes_first_minimum(precision):
    """Duplicated rows tie exactly: the first minimum must win, as in torch
    and as in the TPU kernel test (tests/test_tpu_kernel.py:46-49)."""
    n, k, d = 300, 128, 32
    z, cb = _inputs(n, k, d, seed=1)
    cb_dup = np.concatenate([cb[: k // 2], cb[: k // 2]])
    _, idx = nearest_code_torch(torch.from_numpy(z), torch.from_numpy(cb_dup), precision)
    assert int(idx.max()) < k // 2
    _, idx_j = _jax_oracle(z, cb_dup, precision)
    assert int(idx_j.max()) < k // 2
    _assert_same_codes(z, cb_dup, idx, idx_j, precision)


@pytest.mark.parametrize("ema", [False, True])
@pytest.mark.parametrize("precision", ["highest", "default"])
def test_quantize_vs_jax(ema, precision):
    """loss, z_q, perplexity, indices and counts. fp32 reductions over
    2*8*8*16 elements in another order: rtol 1e-5 on the scalars."""
    rng = np.random.default_rng(2)
    z = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    cb = rng.standard_normal((40, 16)).astype(np.float32)
    jq = jax_quantize(jnp.asarray(z), jnp.asarray(cb), 0.25, ema=ema, precision=precision,
                      impl="pallas" if precision != "highest" else "jnp")
    tq = quantize(torch.from_numpy(z), torch.from_numpy(cb), 0.25, ema=ema, precision=precision)
    np.testing.assert_array_equal(tq.indices.numpy(), np.asarray(jq.indices))
    np.testing.assert_array_equal(tq.counts.numpy(), np.asarray(jq.counts))
    np.testing.assert_allclose(tq.z_q.numpy(), np.asarray(jq.z_q), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(tq.loss), float(jq.loss), rtol=1e-5)
    np.testing.assert_allclose(float(tq.perplexity), float(jq.perplexity), rtol=1e-5)
    assert tq.indices.dtype == torch.int32 and tq.counts.dtype == torch.float32


def test_nearest_code_gradients_vs_jax():
    """Scatter-add of the cotangent into the codebook rows, zero to z. The
    scatter sums the same fp32 values in another order: atol 1e-5."""
    from vqvae_tpu.ops.quantizer import nearest_code as jax_nearest_code

    z, cb = _inputs(96, 24, 8, seed=3)
    g = np.random.default_rng(4).standard_normal((96, 8)).astype(np.float32)

    def f(zz, ee):
        zq, _ = jax_nearest_code(zz, ee, "highest", "jnp")
        return jnp.sum(zq * g)

    jgz, jge = jax.grad(f, argnums=(0, 1))(jnp.asarray(z), jnp.asarray(cb))
    tz = torch.from_numpy(z).requires_grad_()
    tcb = torch.from_numpy(cb).requires_grad_()
    zq, _ = nearest_code(tz, tcb, "highest")
    (zq * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(tz.grad.numpy(), np.zeros_like(z))
    np.testing.assert_array_equal(np.asarray(jgz), np.zeros_like(z))
    np.testing.assert_allclose(tcb.grad.numpy(), np.asarray(jge), rtol=0, atol=1e-5)


@pytest.mark.parametrize("ema", [False, True])
def test_quantize_loss_gradients_vs_jax(ema):
    """d(loss)/dz and d(loss)/dcodebook through the straight-through estimator
    and the reference loss ordering, vs jax.grad. fp32, atol 1e-6 (gradients
    are O(1e-3) means of per-element differences)."""
    rng = np.random.default_rng(5)
    z = rng.standard_normal((2, 4, 4, 8)).astype(np.float32)
    cb = rng.standard_normal((20, 8)).astype(np.float32)

    def f(zz, ee):
        q = jax_quantize(zz, ee, 0.25, ema=ema, impl="jnp")
        return q.loss + jnp.sum(q.z_q * 0.1)

    jgz, jge = jax.grad(f, argnums=(0, 1))(jnp.asarray(z), jnp.asarray(cb))
    tz = torch.from_numpy(z).requires_grad_()
    tcb = torch.from_numpy(cb).requires_grad_()
    q = quantize(tz, tcb, 0.25, ema=ema)
    (q.loss + (q.z_q * 0.1).sum()).backward()
    # EMA: the codebook is outside the loss's graph (None here, zeros in JAX)
    tge = torch.zeros_like(tcb) if tcb.grad is None else tcb.grad
    np.testing.assert_allclose(tz.grad.numpy(), np.asarray(jgz), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tge.numpy(), np.asarray(jge), rtol=0, atol=1e-6)
