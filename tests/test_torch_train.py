"""The port's VQ-VAE trainer held against the JAX package's on the same
weights, optimizer state and batches (CPU, tiny widths).

The JAX trainer runs on one CPU device (``MeshConfig(n_data=1)``), so one
device sums the batch as the port does. Weights and state cross over through
the checkpoint bridge: the JAX ``TrainState`` flattened to its key paths
(the JAX writer's own ``_flatten_state``), ``unflatten_tree`` and
``train_state_from_jax``. The fresh JAX codebook is U(-1/K, 1/K), which
sends every latent to one code; the tests replace it by 64 latents of
another batch, so that a batch uses many codes and the scatter-add backward
and the EMA sums have work to do.

Tolerances, each with its reason:
- losses of one step, rtol 1e-5: fp32 on both sides, summation order only;
- gradients, atol 1e-6 + rtol 1e-4: the same, through the backward convs;
- moments after 3 steps, rtol 1e-4 (+ atol 1e-7 / 1e-12 for mu / nu near 0);
- parameters after 3 steps, atol 2 * 3 * lr: the first AMSGrad steps move
  every element by about lr * sign(g), so an element whose gradient is near
  0 can go the other way in round-off and be 2 * lr apart after each step;
- the trajectory's tolerances stand at that test.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_tpu.config import MeshConfig
from vqvae_tpu.config import TrainConfig as JaxTrainConfig
from vqvae_tpu.config import VQVAEConfig as JaxConfig
from vqvae_tpu.data.sampler import ReplacementSampler as JaxReplacementSampler
from vqvae_tpu.train.checkpoint import _flatten_state
from vqvae_tpu.train.vqvae_train import VQVAETrainer as JaxTrainer
from vqvae_tpu_torch.config import TrainConfig, VQVAEConfig
from vqvae_tpu_torch.data.sampler import ReplacementSampler
from vqvae_tpu_torch.ops.conv import conv_fp32_precision
from vqvae_tpu_torch.train.checkpoint import (
    flatten_tree,
    params_to_jax,
    train_state_from_jax,
    train_state_to_jax,
    unflatten_tree,
)
from vqvae_tpu_torch.train.vqvae_train import VQVAETrainer, metrics_to_host

TINY = dict(n_hiddens=16, n_residual_hiddens=8, n_embeddings=64, embedding_dim=16)
VARIANTS = {
    "gradient": {},
    "ema": {"ema_codebook": True},
    "shared": {"share_residual_weights": True},
}
X_VAR = 0.06
BATCH = 16
LR = 3e-4


def _batch(seed: int, n: int = BATCH) -> np.ndarray:
    return np.random.default_rng(seed).uniform(-1, 1, (n, 32, 32, 3)).astype(np.float32)


def _pair(variant: str):
    """A JAX trainer with its state, and a port trainer holding the same state."""
    extra = VARIANTS[variant]
    jt = JaxTrainer(JaxConfig(**TINY, **extra), JaxTrainConfig(batch_size=BATCH),
                    MeshConfig(n_data=1), x_train_var=X_VAR)
    js = jt.init_state(jax.random.PRNGKey(1))
    model = jt.model
    z_e = np.asarray(model.apply({"params": js.params}, jnp.asarray(_batch(99)),
                                 method=model.encode)).reshape(-1, 16)
    codebook = z_e[np.random.default_rng(5).choice(len(z_e), 64, replace=False)]
    js = js._replace(params={**js.params, "codebook": jnp.asarray(codebook)})
    if js.ema_means is not None:
        js = js._replace(ema_means=jnp.asarray(codebook))
    pt = VQVAETrainer(VQVAEConfig(**TINY, **extra), TrainConfig(batch_size=BATCH),
                      x_train_var=X_VAR, device="cpu")
    ps = train_state_from_jax(unflatten_tree(_flatten_state(js)), pt.init_state())
    return jt, js, pt, ps


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def pair(request):
    return (request.param,) + _pair(request.param)


def _jax_loss_and_grads(jt, params, x):
    """``jax.value_and_grad`` of the loss of the JAX trainer's step
    (vqvae_train.py:208-214), through its own model and quantizer."""
    model = jt.model

    def loss_fn(p):
        z_e = model.apply({"params": p}, x, method=model.encode)
        q = jt._quantize(p, z_e)
        x_hat = model.apply({"params": p}, q.z_q, method=model.decode)
        recon = jnp.mean((x_hat - x) ** 2) / jt.x_train_var
        return recon + q.loss, (recon, q.perplexity)

    return jax.value_and_grad(loss_fn, has_aux=True)(params)


def _flat_params(tree):
    return {k: np.asarray(v) for k, v in flatten_tree({"params": tree}).items()}


def test_one_step_losses_and_gradients(pair):
    variant, jt, js, pt, ps = pair
    x = _batch(0)
    (j_loss, (j_recon, j_perp)), j_grads = _jax_loss_and_grads(jt, js.params, jnp.asarray(x))

    model = ps.model
    model.zero_grad(set_to_none=True)
    with conv_fp32_precision(pt.vq_cfg.conv_precision):
        loss, recon, q, _z_e, _x_hat = pt._forward(model, torch.from_numpy(x))
        loss.backward()
    assert float(q.perplexity) > 4.0, "the batch should use several codes"
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    np.testing.assert_allclose(float(recon), float(j_recon), rtol=1e-5)
    np.testing.assert_allclose(float(q.perplexity), float(j_perp), rtol=1e-5)

    named = dict(model.named_parameters())
    assert len(named) == {"gradient": 23, "ema": 23, "shared": 19}[variant]
    if variant == "ema":
        assert model.codebook.grad is None  # the loss does not reach it
    grads = params_to_jax({
        n: p.grad if p.grad is not None else torch.zeros_like(p) for n, p in named.items()})
    got, want = _flat_params(grads), _flat_params(j_grads)
    assert set(got) == set(want)
    if variant == "shared":
        assert "leaf::.params['encoder']['res_stack']['ResidualLayer_0']['conv3x3']" in got
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-6, err_msg=key)
    if variant != "ema":
        cb = got["leaf::.params['codebook']"]
        assert np.count_nonzero(np.abs(cb).sum(1)) > 4  # the scatter-add reached several codes


def test_state_after_three_steps(pair):
    variant, jt, _js, pt, _ps = pair
    _jt, js, _pt, ps = _pair(variant)  # fresh states: the steps change them in place
    for seed in (10, 11, 12):
        x = _batch(seed)
        js, j_m = jt.step(js, x)
        ps, p_m = pt.step(ps, x)
        for name, value in metrics_to_host(p_m).items():
            np.testing.assert_allclose(value, float(j_m[name]), rtol=1e-4, err_msg=name)
    want = {k: np.asarray(v) for k, v in _flatten_state(js).items()}
    got = flatten_tree(train_state_to_jax(ps))
    assert set(got) == set(want)
    assert ps.step == 3 and ps.optimizer.count == 3
    for key, w in want.items():
        g = got[key]
        assert g.shape == w.shape and g.dtype == w.dtype, key
        if key in ("leaf::.step", "leaf::.opt_state[0].count"):
            assert int(g) == int(w) == 3
        elif ".opt_state[0].mu" in key:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-7, err_msg=key)
        elif ".opt_state[0].nu" in key:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-12, err_msg=key)
        elif key.startswith("leaf::.ema_") or (variant == "ema" and key.endswith("['codebook']")):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6, err_msg=key)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=2 * 3 * LR, err_msg=key)
    if variant == "ema":  # the codebook is ema_means / smoothed counts, and no gradient moved it
        for m in ("mu", "nu", "nu_max"):
            assert not got[f"leaf::.opt_state[0].{m}['codebook']"].any()
        counts, means = got["leaf::.ema_counts"], got["leaf::.ema_means"]
        n = counts.sum()
        smoothed = (counts + 1e-5) / (n + 64 * 1e-5) * n
        np.testing.assert_allclose(got["leaf::.params['codebook']"], means / smoothed[:, None],
                                   rtol=1e-5)


def test_trajectory_on_sampler_batches():
    """20 steps on the batches both packages' samplers draw from one seed.

    Per-step loss within rtol 1e-3 over the first 5 steps (round-off, grown
    by the sign-like first AMSGrad steps); later steps drift where a latent's
    two nearest codes nearly tie and the packages pick differently, so the
    last 5 steps are held as a mean, within 5 %.
    """
    jt, js, pt, ps = _pair("gradient")
    data = np.random.default_rng(3).uniform(-1, 1, (200, 32, 32, 3)).astype(np.float32)
    j_sampler = JaxReplacementSampler(len(data), BATCH, seed=4)
    p_sampler = ReplacementSampler(len(data), BATCH, seed=4)
    j_losses, p_losses = [], []
    for _ in range(20):
        ji, pi = j_sampler.next_indices(), p_sampler.next_indices()
        assert np.array_equal(ji, pi)
        js, j_m = jt.step(js, data[ji])
        ps, p_m = pt.step(ps, data[pi])
        j_losses.append(float(j_m["loss"]))
        p_losses.append(float(p_m["loss"]))
    np.testing.assert_allclose(p_losses[:5], j_losses[:5], rtol=1e-3)
    assert abs(np.mean(p_losses[-5:]) / np.mean(j_losses[-5:]) - 1.0) < 0.05
    assert np.isfinite(p_losses).all()


@pytest.mark.parametrize("num_shards", [1, 4])
def test_replacement_sampler_draws_the_jax_packages_indices(num_shards):
    for shard in range(num_shards):
        ours = ReplacementSampler(1000, 32, seed=9, num_shards=num_shards, shard_id=shard)
        theirs = JaxReplacementSampler(1000, 32, seed=9, num_shards=num_shards, shard_id=shard)
        for _ in range(50):
            a, b = ours.next_indices(), theirs.next_indices()
            assert a.dtype == b.dtype and np.array_equal(a, b)
            assert len(a) == 32 // num_shards
    with pytest.raises(ValueError, match="batch_size"):
        ReplacementSampler(10, 32)
    with pytest.raises(ValueError, match="not divisible"):
        ReplacementSampler(100, 30, num_shards=4).next_indices()
