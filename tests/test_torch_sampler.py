"""The port's cached AR sampler held against the JAX package's cached decoder
(teacher-forced logits on the same weights and grids) and against the port's
full forward, and its draws against the full-forward sampler's.

The JAX ``jax.random`` stream cannot be reproduced, so logits are compared
with the JAX package, never samples. Tolerances are the JAX package's own
(tests/test_pixelcnn_sampler.py): rtol 1e-4, atol 1e-5 at 3 layers, rtol
1e-3, atol 1e-4 at 15 layers, rtol 1e-5, atol 1e-6 between the band and the
whole-grid refresh.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_tpu.config import PixelCNNConfig as JaxPixelCNNConfig
from vqvae_tpu.models.pixelcnn_sampler import CachedPixelCNNSampler as JaxCachedSampler
from vqvae_tpu_torch.models.pixelcnn_sampler import CachedPixelCNNSampler

from test_torch_pixelcnn import SMALL, grids, make_pair, port_logits

LAYERS_15 = dict(input_dim=64, dim=32, n_layers=15, n_classes=10, img_dim=8)


def teacher_forced(sampler, grid, label):
    side = grid.shape[1]
    return sampler.generate(torch.from_numpy(label), None, (side, side), len(grid),
                            force_grid=torch.from_numpy(grid)).numpy()


@pytest.mark.parametrize("cfg,rtol,atol", [(SMALL, 1e-4, 1e-5), (LAYERS_15, 1e-3, 1e-4)],
                         ids=["3_layers", "15_layers"])
def test_teacher_forced_logits_vs_jax_and_full_forward(cfg, rtol, atol):
    jax_model, params, model = make_pair(1, **cfg)
    grid, label = grids(4, input_dim=cfg["input_dim"], seed=3)
    got = teacher_forced(CachedPixelCNNSampler(model), grid, label)
    assert got.shape == (4, 8, 8, cfg["input_dim"]) and got.dtype == np.float32
    jax_cached = np.asarray(JaxCachedSampler(JaxPixelCNNConfig(**cfg), params).generate(
        jnp.asarray(label), jax.random.PRNGKey(0), (8, 8), 4, force_grid=jnp.asarray(grid)))
    np.testing.assert_allclose(got, jax_cached, rtol=rtol, atol=atol)
    np.testing.assert_allclose(got, port_logits(model, grid, label), rtol=rtol, atol=atol)


@pytest.mark.parametrize("side", [16, 32])
def test_band_refresh_matches_full_refresh(side):
    _jm, params, model = make_pair(0, side=side)
    grid, label = grids(2, side=side, seed=side)
    full = teacher_forced(CachedPixelCNNSampler(model, row_refresh="full"), grid, label)
    band = teacher_forced(CachedPixelCNNSampler(model, row_refresh="band"), grid, label)
    np.testing.assert_allclose(band, full, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(band, port_logits(model, grid, label), rtol=1e-4, atol=1e-5)
    jax_band = np.asarray(JaxCachedSampler(JaxPixelCNNConfig(**SMALL), params, row_refresh="band")
                          .generate(jnp.asarray(label), jax.random.PRNGKey(0), (side, side), 2,
                                    force_grid=jnp.asarray(grid)))
    np.testing.assert_allclose(band, jax_band, rtol=1e-4, atol=1e-5)


def test_band_geometry_matches_jax():
    for cfg in (SMALL, LAYERS_15):
        jax_model, params, model = make_pair(0, **cfg)
        ours = CachedPixelCNNSampler(model)
        theirs = JaxCachedSampler(JaxPixelCNNConfig(**cfg), params)
        assert ours.band_pad == theirs._band_pad
        assert [ours._use_band(h) for h in (8, 16, 32)] == [theirs._use_band(h) for h in (8, 16, 32)]
    assert CachedPixelCNNSampler(make_pair(0, **LAYERS_15)[2]).band_pad == 17


@pytest.mark.parametrize("n_layers", [2, 3])
def test_sampling_matches_the_full_forward_sampler(n_layers):
    """One torch.Generator seed: the cached sampler and ``GatedPixelCNN.generate``
    (one full forward a pixel) draw identical grids."""
    _jm, _p, model = make_pair(4, n_layers=n_layers)
    label = torch.tensor([0, 1, 2, 3, 4, 5, 6, 9])
    fast = CachedPixelCNNSampler(model).generate(label, torch.Generator().manual_seed(7), (8, 8), 8)
    ref = model.generate(label, torch.Generator().manual_seed(7), (8, 8), 8)
    assert fast.dtype == torch.int32 and fast.shape == (8, 8, 8)
    assert torch.equal(fast, ref)
    assert len(torch.unique(fast)) > 8  # really drawn, not a constant grid
    again = CachedPixelCNNSampler(model).generate(label, torch.Generator().manual_seed(7), (8, 8), 8)
    assert torch.equal(fast, again)
    other = CachedPixelCNNSampler(model).generate(label, torch.Generator().manual_seed(8), (8, 8), 8)
    assert not torch.equal(fast, other)


def test_auto_refresh_equals_full_when_sampling():
    """At 16 x 16 a 2-layer stack takes the band (band_pad 4); its draws
    equal the whole-grid refresh's from one seed."""
    _jm, _p, model = make_pair(3, input_dim=16, dim=8, n_layers=2, n_classes=4, side=16)
    auto = CachedPixelCNNSampler(model)
    assert auto._use_band(16) and not auto._use_band(5)
    label = torch.zeros(4, dtype=torch.long)
    a = auto.generate(label, torch.Generator().manual_seed(11), (16, 16), 4)
    b = CachedPixelCNNSampler(model, row_refresh="full").generate(
        label, torch.Generator().manual_seed(11), (16, 16), 4)
    assert torch.equal(a, b)


def test_sampler_computes_in_fp32_for_a_bf16_config():
    """A bf16 config's cached decode is fp32 (the JAX note at
    pixelcnn_sampler.py:68-72): its logits equal the fp32 model's."""
    _jm, _p, model32 = make_pair(5)
    _jm, _p, model16 = make_pair(5, compute_dtype="bfloat16")
    grid, label = grids(2, seed=2)
    np.testing.assert_array_equal(teacher_forced(CachedPixelCNNSampler(model16), grid, label),
                                  teacher_forced(CachedPixelCNNSampler(model32), grid, label))


def test_sampler_refuses_mismatched_shapes():
    _jm, _p, model = make_pair()
    with pytest.raises(ValueError):
        CachedPixelCNNSampler(model, row_refresh="rows")
    with pytest.raises(ValueError, match="do not match"):
        CachedPixelCNNSampler(model).generate(torch.zeros(3, dtype=torch.long), None, (8, 8), 4)
