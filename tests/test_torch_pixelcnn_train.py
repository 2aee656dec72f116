"""The port's prior trainer held against the JAX package's on the same
weights, Adam state and batches (CPU, a small width).

The JAX trainer runs on one CPU device (``MeshConfig(n_data=1)``), so one
device sums the batch as the port does. Its state crosses over through the
checkpoint bridge (its own ``_flatten_state``, ``unflatten_tree``,
``train_state_from_jax``).

Tolerances, each measured on these seeds and set about four times above:
- fp32 loss of one step: rtol 1e-6 (measured 1.7e-7 over 10 seeds);
- fp32 gradients: per parameter, the largest error within 4e-6 of the
  largest gradient (measured 1.0e-6);
- bf16 (``compute_dtype="bfloat16"``, ``conv_precision="default"``) loss:
  rtol 2e-4 (measured 4.0e-5); gradients: per parameter, the norm of the
  error within 0.5 of the gradient's norm (measured 0.126). That is the
  spread of bf16 itself: the JAX package's own bf16 gradients differ from
  its fp32 ones by 0.139 on the same measure, and the frameworks round at
  different places;
- state after 1 and 3 steps: parameters atol 1e-6 (measured 2.6e-7: the
  first Adam steps move every element by about lr = 3e-4), moments within
  4e-6 of their largest element (measured 8.3e-7), the count exact;
- Adam against ``optax.adam`` over 60 steps: 2e-7 absolute (measured
  4.1e-8 at most over the three schedules, against moves of 3e-3 to 6e-3).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vqvae_tpu.config import MeshConfig
from vqvae_tpu.config import PixelCNNConfig as JaxPixelCNNConfig
from vqvae_tpu.config import TrainConfig as JaxTrainConfig
from vqvae_tpu.train.checkpoint import _flatten_state
from vqvae_tpu.train.pixelcnn_train import PixelCNNTrainer as JaxPixelCNNTrainer
from vqvae_tpu_torch.config import PixelCNNConfig, TrainConfig
from vqvae_tpu_torch.ops.conv import conv_fp32_precision
from vqvae_tpu_torch.train.checkpoint import (
    flatten_tree,
    params_to_jax,
    train_state_from_jax,
    train_state_to_jax,
    unflatten_tree,
)
from vqvae_tpu_torch.train.optim import Adam
from vqvae_tpu_torch.train.pixelcnn_train import PixelCNNTrainer, draw_seed

from test_torch_optim import _small_schedule, _spike_schedule

SMALL = dict(input_dim=16, dim=16, n_layers=2, n_classes=10, img_dim=4)
MODES = {"fp32": ("float32", "highest"), "bf16": ("bfloat16", "default")}
BATCH = 8
LR = 3e-4


def _pair(mode="fp32", seed=0):
    """A JAX trainer with its fresh state, and a port trainer holding the same state."""
    dtype, precision = MODES[mode]
    jt = JaxPixelCNNTrainer(JaxPixelCNNConfig(**SMALL, compute_dtype=dtype, conv_precision=precision),
                            JaxTrainConfig(batch_size=BATCH), MeshConfig(n_data=1))
    js = jt.init_state(jax.random.PRNGKey(seed))
    pt = PixelCNNTrainer(PixelCNNConfig(**SMALL, compute_dtype=dtype, conv_precision=precision),
                         TrainConfig(batch_size=BATCH), device="cpu")
    ps = train_state_from_jax(unflatten_tree(_flatten_state(js)), pt.init_state())
    return jt, js, pt, ps


def _batch(seed, n=BATCH):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 16, (n, 4, 4)).astype(np.int32),
            rng.integers(0, 10, (n,)).astype(np.int32))


def _port_loss_and_grads(pt, ps, x, label):
    model = ps.model
    model.zero_grad(set_to_none=True)
    with conv_fp32_precision(pt.cfg.conv_precision):
        loss = pt._loss(model, torch.from_numpy(x).long(), torch.from_numpy(label).long())
        loss.backward()
    grads = flatten_tree({"params": params_to_jax({n: p.grad for n, p in model.named_parameters()})})
    return float(loss.detach()), grads


@pytest.mark.parametrize("mode", sorted(MODES))
def test_one_step_loss_and_gradients_vs_jax(mode):
    for seed in range(3):
        jt, js, pt, ps = _pair(mode, seed)
        x, label = _batch(100 + seed)
        j_loss, j_grads = jax.value_and_grad(jt._loss_impl)(js.params, jnp.asarray(x), jnp.asarray(label))
        loss, got = _port_loss_and_grads(pt, ps, x, label)
        want = flatten_tree({"params": jax.tree_util.tree_map(np.asarray, j_grads)})
        assert set(got) == set(want) and len(want) == 2 * 9 + 5
        np.testing.assert_allclose(loss, float(j_loss), rtol=1e-6 if mode == "fp32" else 2e-4)
        for key, w in want.items():
            g = got[key]
            if mode == "fp32":
                assert np.abs(g - w).max() <= 4e-6 * np.abs(w).max(), key
            else:
                assert np.linalg.norm(g - w) <= 0.5 * np.linalg.norm(w), key
        # mask A: the kernel positions that cover the current pixel get exactly 0
        layer0 = ps.model.layer_0
        assert not layer0.vert_stack_w.grad[:, :, -1].any()
        assert not layer0.horiz_stack_w.grad[..., -1].any()
        assert layer0.vert_stack_w.grad[:, :, :-1].abs().sum() > 0


@pytest.mark.parametrize("n_steps", [1, 3])
def test_state_after_steps_vs_jax(n_steps):
    jt, js, pt, ps = _pair()
    for s in range(n_steps):
        x, label = _batch(200 + s)
        js, j_loss = jt.step(js, x, label)
        ps, loss = pt.step(ps, x, label)
        assert loss.shape == () and loss.device.type == "cpu"
        np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-6)
    want = {k: np.asarray(v) for k, v in _flatten_state(js).items()}
    got = flatten_tree(train_state_to_jax(ps))
    assert set(got) == set(want) and len(want) == 3 * 23 + 2  # params, mu, nu, count, step
    assert ps.step == ps.optimizer.count == n_steps
    for key, w in want.items():
        g = got[key]
        assert g.shape == w.shape and g.dtype == w.dtype, key
        if key in ("leaf::.step", "leaf::.opt_state[0].count"):
            assert int(g) == int(w) == n_steps
        elif key.startswith("leaf::.params"):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=key)
        else:
            assert np.abs(g - w).max() <= 4e-6 * np.abs(w).max(), key


def test_masked_kernel_positions_stay_unchanged_under_adam():
    """0 / (0 + eps): a zero gradient leaves a masked position where it was,
    however many updates run, as in the JAX package."""
    _jt, _js, pt, ps = _pair()
    before = ps.model.layer_0.vert_stack_w.detach().clone()
    before_h = ps.model.layer_0.horiz_stack_w.detach().clone()
    for s in range(4):
        ps, _loss = pt.step(ps, *_batch(300 + s))
    after = ps.model.layer_0.vert_stack_w.detach()
    assert torch.equal(after[:, :, -1], before[:, :, -1])
    assert torch.equal(ps.model.layer_0.horiz_stack_w.detach()[..., -1], before_h[..., -1])
    assert not torch.equal(after[:, :, :-1], before[:, :, :-1])
    state = ps.optimizer.state[ps.model.layer_0.vert_stack_w]
    assert not state["exp_avg"][:, :, -1].any() and not state["exp_avg_sq"][:, :, -1].any()


def _mixed_schedule(n_steps=60, dim=32):
    """Gradients of 1e-8 (below eps) with a spike of 1e3 at step 20."""
    rng = np.random.default_rng(13)
    g = (1e-8 * rng.normal(size=(n_steps, dim))).astype(np.float32)
    g[20] = 1e3 * rng.normal(size=dim)
    return g


# tests/test_torch_optim.py's schedules, and one below eps with a spike
SCHEDULES = {"spike": _spike_schedule, "small": _small_schedule, "mixed": _mixed_schedule}


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_adam_follows_optax_adam(schedule):
    grads = SCHEDULES[schedule]()
    tx = optax.adam(LR, b1=0.9, b2=0.999, eps=1e-8)
    params = jnp.zeros(grads.shape[1], jnp.float32)
    state = tx.init(params)
    update = jax.jit(tx.update)
    p = torch.nn.Parameter(torch.zeros(grads.shape[1]))
    opt = Adam([p], lr=LR)
    err = 0.0
    for g in grads:
        updates, state = update(jnp.asarray(g), state, params)
        params = optax.apply_updates(params, updates)
        p.grad = torch.from_numpy(g)
        opt.step()
        err = max(err, float(np.abs(p.detach().numpy() - np.asarray(params)).max()))
    assert err < 2e-7, f"{schedule}: Adam departs from optax.adam by {err}"
    assert opt.count == int(state[0].count) == 60
    np.testing.assert_allclose(opt.state[p]["exp_avg"].numpy(), np.asarray(state[0].mu),
                               rtol=1e-5, atol=1.5e-8)  # measured 3.1e-9 on mu near 0


def test_adam_state_exists_before_the_first_update_and_counts_together():
    a, b = torch.nn.Parameter(torch.ones(3)), torch.nn.Parameter(torch.ones(2, 2))
    opt = Adam([a, b], lr=LR)
    assert opt.count == 0 and set(opt.state[b]) == {"step", "exp_avg", "exp_avg_sq"}
    assert opt.MOMENTS == {"mu": "exp_avg", "nu": "exp_avg_sq"}
    a.grad, b.grad = torch.ones(3), torch.ones(2, 2)
    opt.step()
    assert opt.count == 1
    opt.count = 7
    assert all(int(opt.state[p]["step"]) == 7 for p in (a, b))
    a.grad, b.grad = torch.ones(3), None  # b left out of an update: the counts part
    opt.step()
    with pytest.raises(ValueError, match="disagree"):
        opt.count


def test_steps_and_steps_by_index_equal_single_steps():
    pt = PixelCNNTrainer(PixelCNNConfig(**SMALL), TrainConfig(batch_size=BATCH, seed=3), device="cpu")
    rng = np.random.default_rng(4)
    data = rng.integers(0, 16, (40, 4, 4)).astype(np.int32)
    labels = rng.integers(0, 10, (40,)).astype(np.int32)
    idx = rng.permutation(40)[:24].reshape(3, BATCH)
    a, b, c = (pt.init_state() for _ in range(3))
    a, la = pt.steps(a, data[idx], labels[idx])
    from vqvae_tpu_torch.data.datasets import ArrayDataset

    pt.stage_dataset(ArrayDataset(data, labels), ArrayDataset(data[:16], labels[:16]))
    b, lb = pt.steps_by_index(b, idx)
    singles = []
    for row in idx:
        c, loss = pt.step(c, data[row], labels[row])
        singles.append(float(loss))
    assert la.shape == (3,) and torch.equal(la, lb) and la.tolist() == singles
    for fa, fb, fc in zip(*(flatten_tree(train_state_to_jax(s)).items() for s in (a, b, c))):
        np.testing.assert_array_equal(fa[1], fb[1], err_msg=fa[0])
        np.testing.assert_array_equal(fa[1], fc[1], err_msg=fa[0])
    val_idx = np.arange(16).reshape(2, BATCH)
    by_index = pt.eval_by_index(a, val_idx)
    one_by_one = [float(pt.eval_loss(a, data[r], labels[r])) for r in val_idx]
    assert by_index.tolist() == one_by_one and not by_index.requires_grad
    with pytest.raises(RuntimeError, match="stage_dataset"):
        PixelCNNTrainer(PixelCNNConfig(**SMALL), device="cpu").steps_by_index(a, idx)


def test_generate_follows_the_current_weights():
    """A new cached sampler each call: after an update the draws come from
    the new weights (a sampler kept from before would give the old grids),
    and the cached and full-forward samplers draw the same grids."""
    pt = PixelCNNTrainer(PixelCNNConfig(**SMALL), TrainConfig(batch_size=BATCH, seed=1), device="cpu")
    ps = pt.init_state()
    labels = np.arange(12) % 10
    gen = lambda: torch.Generator().manual_seed(5)  # noqa: E731
    before = pt.generate(ps, labels, gen())
    assert before.shape == (12, 4, 4) and before.dtype == np.int32
    assert before.min() >= 0 and before.max() < 16
    np.testing.assert_array_equal(before, pt.generate(ps, labels, gen(), cached=False))
    with torch.no_grad():
        ps.model.out2_b[3] += 50.0  # code 3 now wins almost every draw
    after = pt.generate(ps, labels, gen())
    assert (after == 3).mean() > 0.9 and (before == 3).mean() < 0.5
    np.testing.assert_array_equal(after, pt.generate(ps, labels, gen(), cached=False))
    # the default generator: seeded from (seed, step), so a call repeats
    np.testing.assert_array_equal(pt.generate(ps, labels), pt.generate(ps, labels))
    np.testing.assert_array_equal(pt.generate(ps, labels),
                                  pt.generate(ps, labels, torch.Generator().manual_seed(draw_seed(1, 0))))
    assert draw_seed(1, 0) == 2**32 and draw_seed(-1, 2**32 + 5) == (2**32 - 1) * 2**32 + 5


def test_trainer_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PixelCNNTrainer(PixelCNNConfig(**SMALL))
