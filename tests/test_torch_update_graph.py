"""The VQ-VAE trainer's update graph (``train/vqvae_train.py::_UpdateGraph``).

On a card the forward and backward of an update are captured once as a CUDA
graph and replayed; on the CPU the update stays eager. The card tests hold
the replayed updates against the eager ones bit for bit and check that the
graph is captured again where it no longer fits. Run them with ``-m gpu``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from vqvae_tpu_torch.config import TrainConfig, VQVAEConfig
from vqvae_tpu_torch.ops import conv_wgrad, cuda_quantizer
from vqvae_tpu_torch.train.vqvae_train import VQVAETrainer, _add_kernel_launches, _kernel_launches

TINY = dict(n_hiddens=16, n_residual_hiddens=8, n_embeddings=64, embedding_dim=16)


def _trainer(device, batch, ema=False, **cfg):
    data = np.random.default_rng(0).uniform(-1, 1, (4 * batch, 32, 32, 3)).astype(np.float32)
    trainer = VQVAETrainer(VQVAEConfig(ema_codebook=ema, **cfg), TrainConfig(batch_size=batch),
                           device=device)
    trainer.stage_dataset(data)
    return trainer, trainer.init_state(torch.Generator().manual_seed(0))


def _rows(batch, k, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.permutation(4 * batch)[:batch] for _ in range(k)])


@pytest.mark.parametrize("ema", [False, True])
def test_the_cpu_update_builds_no_graph(ema):
    trainer, state = _trainer("cpu", 8, ema, **TINY)
    state, metrics = trainer.steps_by_index(state, _rows(8, 2, 1))
    assert trainer._graph is None and state.step == 2
    assert all(torch.isfinite(metrics[name]).all() for name in ("loss", "recon_error", "perplexity"))


def test_kernel_launch_counts_take_back_what_they_add():
    before = _kernel_launches()
    counts = (3, 2, {route: i for i, route in enumerate(cuda_quantizer.ROUTES)})
    _add_kernel_launches(counts)
    assert conv_wgrad.launches == before[0] + 3 and cuda_quantizer.launches == before[1] + 2
    _add_kernel_launches(counts, -1)
    assert _kernel_launches() == before


# -- on the card ---------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card with -m gpu")
    return "cuda"


def _state_tensors(state):
    out = {f"p.{n}": p.detach().clone() for n, p in state.model.named_parameters()}
    for n, p in state.model.named_parameters():
        for key, t in state.optimizer.state[p].items():
            out[f"o.{n}.{key}"] = t.clone()
    if state.ema_counts is not None:
        out["ema_counts"], out["ema_means"] = state.ema_counts.clone(), state.ema_means.clone()
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("ema", [False, True])
def test_replayed_updates_equal_eager_updates_bit_for_bit(ema):
    """Six updates at batch 256, the first eager and the graph captured after
    it, give the eager updates' losses, weights and optimizer moments, bit
    for bit."""
    dev = _card()
    rows = _rows(256, 6, 2)
    graphed, g_state = _trainer(dev, 256, ema)
    eager, e_state = _trainer(dev, 256, ema)
    eager._update = eager._eager_update
    g_state, g_metrics = graphed.steps_by_index(g_state, rows)
    e_state, e_metrics = eager.steps_by_index(e_state, rows)
    torch.cuda.synchronize()
    assert graphed._graph is not None and eager._graph is None
    for name in ("loss", "recon_error", "perplexity"):
        assert torch.equal(g_metrics[name], e_metrics[name]), name
    assert len(set(g_metrics["loss"].tolist())) == 6     # one value an update, not the last six times
    g_all, e_all = _state_tensors(g_state), _state_tensors(e_state)
    assert g_all.keys() == e_all.keys()
    assert [k for k in g_all if not torch.equal(g_all[k], e_all[k])] == []


@pytest.mark.gpu
def test_the_graph_is_captured_again_where_it_no_longer_fits():
    """Gradients set to None from outside, or another batch shape, capture a
    new graph; the updates still equal the eager ones."""
    dev = _card()
    graphed, g_state = _trainer(dev, 128)
    eager, e_state = _trainer(dev, 128)
    eager._update = eager._eager_update
    rows = _rows(128, 2, 3)
    for trainer, state in ((graphed, g_state), (eager, e_state)):
        trainer.steps_by_index(state, rows)
    first = graphed._graph
    g_state.optimizer.zero_grad(set_to_none=True)
    for trainer, state in ((graphed, g_state), (eager, e_state)):
        trainer.steps_by_index(state, rows)
    second = graphed._graph
    for trainer, state in ((graphed, g_state), (eager, e_state)):
        trainer.steps_by_index(state, rows[:, :64])
    torch.cuda.synchronize()
    assert first is not second and graphed._graph is not second
    g_all, e_all = _state_tensors(g_state), _state_tensors(e_state)
    assert [k for k in g_all if not torch.equal(g_all[k], e_all[k])] == []


@pytest.mark.gpu
def test_a_replay_counts_the_kernels_it_launches():
    """The hand-written kernels' counters count a replay's launches: fifteen
    weight gradients and one search an update at batch 256, eager or
    replayed, and none for the capture itself."""
    dev = _card()
    trainer, state = _trainer(dev, 256)
    conv_wgrad.reset_counts()
    before = _kernel_launches()
    trainer.steps_by_index(state, _rows(256, 3, 4))
    torch.cuda.synchronize()
    after = _kernel_launches()
    assert after[0] - before[0] == 15 * 3 and after[1] - before[1] == 3
    assert conv_wgrad.fallbacks == 0
