"""Train steps that repeat bit for bit (``ops/scatter.py``, ``ops/conv.py``),
the JAX package's contract "same seed => bit-identical step"
(``vqvae_tpu/utils/debug.py``, ``tests/test_train.py::test_determinism_same_seed``).

On the CPU ``scatter_add_rows`` must keep the bits of ``index_add_`` (so no
CPU result of the port moves); its card path, the float64 one-hot product,
runs here too, on CPU tensors, and is held against JAX's ``segment_sum`` and
a float64 sum: JAX's fp32 sum within the textbook bound of a recursive
fp32 sum, the one-hot product within one rounding of the float64 sum.

This file imports JAX only inside the one test that compares with it, so its
``gpu`` tests run on a card with
    python -m pytest --noconftest -m gpu tests/test_torch_determinism.py
and skip themselves, inside the test, where there is none. On the card two
runs of the same 5 updates must give the same parameters, optimizer state
and metrics, 0 difference.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vqvae_tpu_torch.config import PixelCNNConfig, TrainConfig, VQVAEConfig
from vqvae_tpu_torch.data.datasets import ArrayDataset
from vqvae_tpu_torch.ops import scatter
from vqvae_tpu_torch.ops.conv import conv_fp32_precision
from vqvae_tpu_torch.ops.scatter import gather_rows, one_hot_sum, scatter_add_rows
from vqvae_tpu_torch.train.checkpoint import flatten_tree, train_state_to_jax
from vqvae_tpu_torch.train.pixelcnn_train import PixelCNNTrainer
from vqvae_tpu_torch.train.vqvae_train import VQVAETrainer, metrics_to_host

SPREADS = {"spread": 512, "4 codes": 4, "1 code": 1}


def _rows(n=4096, k=512, d=64, spread=512, seed=0):
    g = torch.Generator().manual_seed(seed)
    idx = torch.randint(0, spread, (n,), generator=g, dtype=torch.int32)
    return idx, torch.randn(n, d, generator=g), k


@pytest.mark.parametrize("spread", sorted(SPREADS))
def test_scatter_add_rows_keeps_index_add_bits_on_the_cpu(spread):
    idx, rows, k = _rows(n=16384, spread=SPREADS[spread])
    want = torch.zeros(k, rows.shape[1]).index_add_(0, idx, rows)
    assert torch.equal(scatter_add_rows(idx, rows, k), want)
    assert torch.equal(scatter_add_rows(idx.long(), rows, k), want)


@pytest.mark.parametrize("spread", sorted(SPREADS))
def test_scatter_paths_equal_the_jax_segment_sum(spread):
    """Against the float64 sum: JAX's fp32 ``segment_sum`` and the CPU path
    (``index_add_``'s fp32 sum) within the bound of a recursive fp32 sum,
    n_k * 2**-24 * sum |rows| of each code's n_k rows; the one-hot product
    within one fp32 rounding of it."""
    import jax

    idx, rows, k = _rows(spread=SPREADS[spread], seed=1)
    want = np.asarray(jax.ops.segment_sum(rows.numpy(), idx.numpy(), num_segments=k)).astype(np.float64)
    exact = torch.zeros(k, 64, dtype=torch.float64).index_add_(0, idx, rows.double()).numpy()
    abs_sum = torch.zeros(k, 64, dtype=torch.float64).index_add_(0, idx, rows.double().abs()).numpy()
    n_k = np.bincount(idx.numpy(), minlength=k)[:, None]
    bound = n_k * 2.0 ** -24 * abs_sum + 1e-30
    assert (np.abs(want - exact) <= bound).all()
    got = scatter_add_rows(idx, rows, k)
    assert got.dtype == torch.float32 and got.shape == (k, 64)
    assert (np.abs(got.numpy() - exact) <= bound).all()
    hot = one_hot_sum(idx, rows, k).numpy().astype(np.float64)
    assert (np.abs(hot - exact) <= 2.0 ** -24 * np.abs(exact) + 1e-30).all()


def test_one_hot_sum_in_chunks(monkeypatch):
    idx, rows, k = _rows(n=1000, k=37, d=5, spread=37, seed=2)
    whole = one_hot_sum(idx, rows, k)
    monkeypatch.setattr(scatter, "_ONE_HOT_ELEMENTS", 37 * 64)  # chunks of 64 rows
    chunked = one_hot_sum(idx, rows, k)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=0, atol=1e-6)
    assert torch.equal(one_hot_sum(idx[:0], rows[:0], k), torch.zeros(k, 5))
    assert one_hot_sum(idx, rows.double(), k).dtype == torch.float64


def test_gather_rows_is_an_embedding_lookup():
    table = torch.randn(32, 16, requires_grad=True)
    idx = torch.randint(0, 32, (8, 4, 4))
    out = gather_rows(table, idx)
    assert torch.equal(out, F.embedding(idx, table))
    g = torch.randn(out.shape)
    (ours,) = torch.autograd.grad(out, table, g)
    (theirs,) = torch.autograd.grad(F.embedding(idx, table), table, g)
    assert torch.equal(ours, theirs)


def test_precision_scope_holds_cudnn_to_deterministic_algorithms():
    cudnn = torch.backends.cudnn
    before = cudnn.deterministic
    with conv_fp32_precision("highest"):
        assert cudnn.deterministic is True
        with conv_fp32_precision("default"):
            assert cudnn.deterministic is True
        assert cudnn.deterministic is True
    assert cudnn.deterministic == before


TINY = dict(n_hiddens=16, n_residual_hiddens=8, n_embeddings=64, embedding_dim=16)
SMALL_PRIOR = dict(input_dim=32, dim=16, n_layers=3, img_dim=4)


def _vqvae_twice(device, cfg, batch):
    data = np.random.default_rng(0).uniform(-1, 1, (5 * batch, 32, 32, 3)).astype(np.float32)
    trainer = VQVAETrainer(cfg, TrainConfig(batch_size=batch), device=device)
    trainer.stage_dataset(data)
    runs = []
    for _ in range(2):
        state = trainer.init_state(torch.Generator().manual_seed(11))
        state, m = trainer.steps_by_index(state, np.arange(5 * batch).reshape(5, batch))
        runs.append((flatten_tree(train_state_to_jax(state)), metrics_to_host(m)))
    return runs


def _prior_twice(device, cfg, batch):
    rng = np.random.default_rng(1)
    grids = rng.integers(0, cfg.input_dim, (5 * batch, cfg.img_dim, cfg.img_dim)).astype(np.int32)
    ds = ArrayDataset(grids, rng.integers(0, 10, 5 * batch).astype(np.int32))
    trainer = PixelCNNTrainer(cfg, TrainConfig(batch_size=batch), device=device)
    trainer.stage_dataset(ds, ds)
    runs = []
    for _ in range(2):
        state = trainer.init_state(torch.Generator().manual_seed(11))
        state, losses = trainer.steps_by_index(state, np.arange(5 * batch).reshape(5, batch))
        runs.append((flatten_tree(train_state_to_jax(state)), {"loss": losses.cpu().numpy()}))
    return runs


def _assert_same_runs(runs):
    (state_a, metrics_a), (state_b, metrics_b) = runs
    assert set(state_a) == set(state_b)
    for key in state_a:
        np.testing.assert_array_equal(state_a[key], state_b[key], err_msg=key)
    for key in metrics_a:
        np.testing.assert_array_equal(metrics_a[key], metrics_b[key], err_msg=key)


@pytest.mark.parametrize("ema", [False, True])
def test_vqvae_updates_repeat_bit_for_bit_on_the_cpu(ema):
    _assert_same_runs(_vqvae_twice("cpu", VQVAEConfig(**TINY, ema_codebook=ema), 8))


def test_prior_updates_repeat_bit_for_bit_on_the_cpu():
    _assert_same_runs(_prior_twice("cpu", PixelCNNConfig(**SMALL_PRIOR), 16))


VQ_CARD = {"fp32/highest": {}, "bf16/default": dict(compute_dtype="bfloat16", quantizer_precision="default"),
           "ema": dict(ema_codebook=True)}


@pytest.mark.gpu
@pytest.mark.parametrize("mode", sorted(VQ_CARD))
def test_vqvae_updates_repeat_bit_for_bit_on_the_card(mode):
    """Full width at batch 256, both kernel routes and the EMA codebook."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    _assert_same_runs(_vqvae_twice("cuda", VQVAEConfig(**VQ_CARD[mode]), 256))


@pytest.mark.gpu
@pytest.mark.parametrize(("batch", "impl"), [(32, "auto"), (256, "jnp")])
@pytest.mark.parametrize("precision", ["highest", "default"])
def test_vqvae_updates_repeat_bit_for_bit_through_the_matmul_branch(batch, impl, precision):
    """The matmul branch (cuBLAS's product, one stream, no atomics) repeats
    too: fp32 at batch 32, where "auto" takes it in "highest", and under
    "jnp" at batch 256."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    cfg = VQVAEConfig(quantizer_precision=precision, quantizer_impl=impl)
    _assert_same_runs(_vqvae_twice("cuda", cfg, batch))


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [32, 256])
def test_prior_updates_repeat_bit_for_bit_on_the_card(batch):
    """The full-width prior (512 codes, 15 layers) at the reference's batch
    and at 256 (16,384 rows: the embedding's backward above 3,072 rows)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    _assert_same_runs(_prior_twice("cuda", PixelCNNConfig(), batch))


@pytest.mark.gpu
@pytest.mark.parametrize("spread", sorted(SPREADS))
def test_scatter_add_rows_on_the_card(spread):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    idx, rows, k = _rows(n=16384, spread=SPREADS[spread], seed=3)
    idx, rows = idx.cuda(), rows.cuda()
    got = scatter_add_rows(idx, rows, k)
    assert torch.equal(got, scatter_add_rows(idx, rows, k))
    exact = torch.zeros(k, 64, dtype=torch.float64, device="cuda").index_add_(0, idx, rows.double())
    np.testing.assert_allclose(got.cpu().numpy(), exact.float().cpu().numpy(), rtol=0, atol=1e-6)
