"""The port's GatedPixelCNN prior held against the JAX package's on the same
weights (``params_from_jax``) and inputs, and its loading rules.

Tolerances: fp32 at a small width rtol 1e-4, atol 1e-5 (the JAX package's
own bound between its full forward and its cached decoder); the trained
full-width prior rtol 1e-3, atol 1e-4 (the JAX package's 15-layer bound,
tests/test_pixelcnn_sampler.py:127: its logits reach 700, and fp32 sums
over 15 layers part in the sixth digit); bf16 see ``test_bf16_logits_vs_jax``.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_tpu.config import PixelCNNConfig as JaxPixelCNNConfig
from vqvae_tpu.config import TrainConfig as JaxTrainConfig
from vqvae_tpu.models.pixelcnn import GatedPixelCNN as JaxGatedPixelCNN
from vqvae_tpu.train.checkpoint import load_checkpoint, save_checkpoint
from vqvae_tpu.train.pixelcnn_train import PixelCNNTrainer
from vqvae_tpu_torch.config import PixelCNNConfig
from vqvae_tpu_torch.models.pixelcnn import GatedPixelCNN, draw_codes
from vqvae_tpu_torch.pipelines.viz import load_prior
from vqvae_tpu_torch.train.checkpoint import params_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRIOR_R5 = os.path.join(ROOT, "artifacts/e2e_r5/latent_block_pixelcnn.npz")
SAMPLES_R5 = os.path.join(ROOT, "artifacts/e2e_r5/samples.npz")
SMALL = dict(input_dim=32, dim=16, n_layers=3, n_classes=10, img_dim=8)


def make_pair(seed=0, side=8, **kw):
    """A JAX prior's fresh weights and the port's model carrying them."""
    cfg = dict(SMALL, **kw)
    jax_model = JaxGatedPixelCNN(JaxPixelCNNConfig(**cfg))
    params = jax_model.init(jax.random.PRNGKey(seed), jnp.zeros((1, side, side), jnp.int32),
                            jnp.zeros((1,), jnp.int32))["params"]
    model = GatedPixelCNN(PixelCNNConfig(**cfg))
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)), strict=True)
    return jax_model, params, model.eval()


def grids(n, side=8, input_dim=32, n_classes=10, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, input_dim, (n, side, side)).astype(np.int32),
            rng.integers(0, n_classes, (n,)).astype(np.int32))


def port_logits(model, grid, label):
    with torch.no_grad():
        return model(torch.from_numpy(grid), torch.from_numpy(label)).numpy()


def test_parameter_names_and_layouts_match_the_jax_tree():
    _jm, params, model = make_pair()
    flat = {".".join(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(params)}
    assert set(flat) == set(model.state_dict())
    for name, arr in flat.items():
        got = model.state_dict()[name].numpy()
        if arr.ndim == 4:  # HWIO -> (C_out, C_in, kh, kw)
            arr = arr.transpose(3, 2, 0, 1)
        np.testing.assert_array_equal(got, arr)


@pytest.mark.parametrize("seed", [0, 1])
def test_small_fp32_logits_vs_jax(seed):
    jax_model, params, model = make_pair(seed)
    grid, label = grids(4, seed=seed)
    want = np.asarray(jax_model.apply({"params": params}, jnp.asarray(grid), jnp.asarray(label)))
    got = port_logits(model, grid, label)
    assert got.shape == (4, 8, 8, 32) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_bf16_logits_vs_jax():
    """compute_dtype bfloat16 in both packages (params fp32, cast per op).
    The two frameworks round at different places. Measured on the CPU over
    10 seeds: largest |difference| 0.0054 against logits up to 0.79 (a bf16
    ulp at 0.5 is 0.0039), where fp32 parts by 6e-7. Bound: atol 0.02 plus
    rtol 0.02, about four times the measured spread."""
    for seed in range(5):
        jax_model, params, model = make_pair(seed, compute_dtype="bfloat16")
        grid, label = grids(4, seed=seed)
        want = np.asarray(jax_model.apply({"params": params}, jnp.asarray(grid), jnp.asarray(label)))
        got = port_logits(model, grid, label)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0.02, atol=0.02)


def test_trained_prior_full_width_vs_jax():
    """The e2e_r5 prior (512 codes, dim 64, 15 layers, 1,841,472 parameters)
    on 2 of the grids it drew, with their labels."""
    model, _metrics, hp = load_prior(PRIOR_R5, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == 1_841_472
    samples = np.load(SAMPLES_R5)
    grid, label = samples["codes"][:2], samples["labels"][:2]
    trainer = PixelCNNTrainer(JaxPixelCNNConfig.from_dict(hp), JaxTrainConfig())
    state, _step, _m, _hp = load_checkpoint(PRIOR_R5, trainer.init_state())
    want = np.asarray(trainer.model.apply({"params": state.params}, jnp.asarray(grid),
                                          jnp.asarray(label)))
    np.testing.assert_allclose(port_logits(model, grid, label), want, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("pos", [(0, 0), (0, 5), (3, 0), (4, 4), (7, 7)])
def test_mask_a_causality(pos):
    """Logits at (i, j) do not change when the pixels at or after (i, j) in
    raster order do."""
    _jm, _p, model = make_pair(2)
    grid, label = grids(3, seed=5)
    i, j = pos
    changed = grid.copy().reshape(3, -1)
    changed[:, i * 8 + j:] = (changed[:, i * 8 + j:] + 7) % 32
    a = port_logits(model, grid, label)[:, i, j]
    b = port_logits(model, changed.reshape(grid.shape), label)[:, i, j]
    np.testing.assert_array_equal(a, b)
    if (i, j) != (7, 7):  # and the next pixel does see (i, j)
        n = i * 8 + j + 1
        assert not np.array_equal(port_logits(model, grid, label)[:, n // 8, n % 8],
                                  port_logits(model, changed.reshape(grid.shape), label)[:, n // 8, n % 8])


def test_mask_a_leaves_the_weights_alone():
    _jm, _p, model = make_pair()
    before = model.layer_0.vert_stack_w.detach().clone()
    port_logits(model, *grids(2))
    assert torch.equal(model.layer_0.vert_stack_w, before)
    assert bool(before[:, :, -1].abs().sum() > 0)  # the masked row is stored, not zeroed


def test_reset_parameters_is_seeded():
    a, b = GatedPixelCNN(PixelCNNConfig(**SMALL)), GatedPixelCNN(PixelCNNConfig(**SMALL))
    a.reset_parameters(torch.Generator().manual_seed(4))
    b.reset_parameters(torch.Generator().manual_seed(4))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
        if name.endswith("_b"):
            assert not p.any(), name
    w = a.layer_1.vert_stack_w.detach()  # xavier: U(-b, b), b = sqrt(6 / (fan_in + fan_out))
    bound = (6.0 / (16 * 2 * 3 + 32 * 2 * 3)) ** 0.5
    assert float(w.abs().max()) <= bound and float(w.abs().max()) > 0.9 * bound


def test_draw_codes_follows_the_softmax():
    """Gumbel-max draws: frequencies over 20,000 rows within 4 standard
    errors of softmax(logits), and one seed gives the same draws."""
    logits = torch.tensor([[2.0, 0.5, 0.0, -1.0]]).expand(20_000, 4)
    codes = draw_codes(logits, torch.Generator().manual_seed(0))
    freq = torch.bincount(codes, minlength=4).double() / 20_000
    p = torch.softmax(logits[0].double(), 0)
    assert bool(((freq - p).abs() <= 4 * (p * (1 - p) / 20_000).sqrt()).all()), (freq, p)
    assert torch.equal(codes, draw_codes(logits, torch.Generator().manual_seed(0)))


def _save_prior(path, hyperparameters):
    cfg = JaxPixelCNNConfig(**SMALL)
    trainer = PixelCNNTrainer(cfg, JaxTrainConfig(seed=1))
    state = trainer.init_state()
    save_checkpoint(str(path), state, 3, hyperparameters=hyperparameters)
    return trainer, state


def test_load_prior_from_a_jax_trainer_checkpoint(tmp_path):
    """A JAX trainer's file (parameters and Adam state) loads its
    parameters; a file without hyperparameters needs ``fallback_cfg`` and
    otherwise raises, naming the flags; another configuration's tree raises."""
    path = tmp_path / "prior.npz"
    trainer, state = _save_prior(path, JaxPixelCNNConfig(**SMALL).to_dict())
    model, _m, hp = load_prior(str(path), device="cpu")
    assert model.config == PixelCNNConfig(**SMALL) and hp["n_layers"] == 3
    grid, label = grids(2)
    want = np.asarray(trainer.model.apply({"params": state.params}, jnp.asarray(grid),
                                          jnp.asarray(label)))
    np.testing.assert_allclose(port_logits(model, grid, label), want, rtol=1e-4, atol=1e-5)

    bare = tmp_path / "bare.npz"
    _save_prior(bare, None)
    with pytest.raises(ValueError, match="--n_embeddings, --img_dim, --n_layers"):
        load_prior(str(bare), device="cpu")
    model2, _m, hp2 = load_prior(str(bare), device="cpu", fallback_cfg=PixelCNNConfig(**SMALL))
    assert hp2 == {} and model2.config == PixelCNNConfig(**SMALL)
    with pytest.raises(RuntimeError):  # strict: 4 layers' worth of names for a 3-layer file
        load_prior(str(bare), device="cpu", fallback_cfg=PixelCNNConfig(**dict(SMALL, n_layers=4)))
    with pytest.raises(RuntimeError):  # strict: shapes of another width
        load_prior(str(bare), device="cpu", fallback_cfg=PixelCNNConfig(**dict(SMALL, dim=8)))
