"""The prior's train state (parameters, Adam's ``mu``/``nu``, ``count``,
``step``) crosses between the two packages' checkpoints in both directions.

Every leaf only changes layout on the way, so leaves are compared bit for
bit. A step taken after a load is held to the tolerances of
tests/test_torch_pixelcnn_train.py (fp32 loss rtol 1e-6).
"""

from __future__ import annotations

import json
import os

import jax
import numpy as np
import pytest
import torch

from vqvae_tpu.config import MeshConfig
from vqvae_tpu.config import PixelCNNConfig as JaxPixelCNNConfig
from vqvae_tpu.config import TrainConfig as JaxTrainConfig
from vqvae_tpu.train import checkpoint as jax_checkpoint
from vqvae_tpu.train.pixelcnn_train import PixelCNNTrainer as JaxPixelCNNTrainer
from vqvae_tpu_torch.config import PixelCNNConfig, TrainConfig
from vqvae_tpu_torch.pipelines.viz import load_prior
from vqvae_tpu_torch.train.checkpoint import (
    flatten_tree,
    load_checkpoint,
    read_checkpoint,
    save_checkpoint,
    train_state_to_jax,
)
from vqvae_tpu_torch.train.pixelcnn_train import PixelCNNTrainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRIOR_R5 = os.path.join(ROOT, "artifacts/e2e_r5/latent_block_pixelcnn.npz")
SMALL = dict(input_dim=16, dim=16, n_layers=2, n_classes=10, img_dim=4)


def _file_arrays(path):
    with np.load(path, allow_pickle=False) as data:
        return {k: np.asarray(data[k]) for k in data.files if k != "__meta__"}


def _meta(path):
    with np.load(path, allow_pickle=False) as data:
        return json.loads(str(data["__meta__"]))


def _batch(seed, n=8):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 16, (n, 4, 4)).astype(np.int32), rng.integers(0, 10, (n,)).astype(np.int32)


def test_e2e_r5_prior_loads_with_its_adam_state_and_saves_back_leaf_for_leaf(tmp_path):
    """The trained full-width prior of the JAX package (422 leaves: 140
    parameters, their mu and nu, count, step; epoch tag 99, 35,541 updates)."""
    meta = _meta(PRIOR_R5)
    pt = PixelCNNTrainer(PixelCNNConfig.from_dict(meta["hyperparameters"]), TrainConfig(), device="cpu")
    ps, epoch, metrics, hp = load_checkpoint(PRIOR_R5, pt.init_state())
    assert epoch == 99 and len(metrics["val_loss"]) == 99 and hp["n_layers"] == 15
    assert ps.step == ps.optimizer.count == 35_541
    assert all(int(ps.optimizer.state[p]["step"]) == 35_541 for p in ps.model.parameters())
    assert sum(p.numel() for p in ps.model.parameters()) == 1_841_472
    nu = ps.optimizer.state[ps.model.layer_3.vert_stack_w]["exp_avg_sq"]
    assert nu.shape == (128, 64, 2, 3) and nu.min() >= 0 and nu.max() > 0
    out = str(tmp_path / "latent_block_pixelcnn.npz")
    save_checkpoint(out, ps, epoch, metrics=metrics, hyperparameters=hp)
    want, got = _file_arrays(PRIOR_R5), _file_arrays(out)
    assert len(want) == 422 and set(got) == set(want)
    assert not any("nu_max" in k for k in got)
    for key in want:
        assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert _meta(out)["n_leaves"] == 422 and _meta(out)["step"] == 99
    # parameters only, as before: read_checkpoint and load_prior skip the moments
    params, step, _m, _hp = read_checkpoint(out)
    assert step == 99 and set(params) == {"embedding", "out1_w", "out1_b", "out2_w", "out2_b"} | {
        f"layer_{i}" for i in range(15)}
    model, _m, _hp = load_prior(out, device="cpu")
    assert torch.equal(model.out2_w, ps.model.out2_w.detach())


def test_port_prior_file_loads_into_the_jax_trainer(tmp_path):
    pt = PixelCNNTrainer(PixelCNNConfig(**SMALL), TrainConfig(seed=4), device="cpu")
    ps = pt.init_state()
    for seed in (1, 2):
        ps, _loss = pt.step(ps, *_batch(seed))
    path = str(tmp_path / "prior.npz")
    save_checkpoint(path, ps, 5, metrics={"train_loss": [1.0], "val_loss": [2.0]},
                    hyperparameters=pt.cfg.to_dict())

    jt = JaxPixelCNNTrainer(JaxPixelCNNConfig(**SMALL), JaxTrainConfig(), MeshConfig(n_data=1))
    js, epoch, metrics, hp = jax_checkpoint.load_checkpoint(path, jt.init_state())
    assert epoch == 5 and metrics == {"train_loss": [1.0], "val_loss": [2.0]}
    assert JaxPixelCNNConfig.from_dict(hp) == JaxPixelCNNConfig(**SMALL)
    assert int(js.step) == 2 and int(js.opt_state[0].count) == 2
    want = flatten_tree(train_state_to_jax(ps))
    got = jax_checkpoint._flatten_state(js)
    assert set(got) == set(want) and len(want) == 3 * 23 + 2
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]), want[key], err_msg=key)
    # and the next step agrees
    x, label = _batch(3)
    js, j_loss = jt.step(jax.device_put(js, jt._rep), x, label)
    ps, loss = pt.step(ps, x, label)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-6)


def test_jax_prior_file_loads_into_the_port(tmp_path):
    jt = JaxPixelCNNTrainer(JaxPixelCNNConfig(**SMALL), JaxTrainConfig(), MeshConfig(n_data=1))
    js = jt.init_state()
    for seed in (1, 2, 3):
        js, _loss = jt.step(js, *_batch(seed))
    path = str(tmp_path / "prior.npz")
    jax_checkpoint.save_checkpoint(path, js, 7, metrics={"val_loss": [3.0]},
                                   hyperparameters=jt.cfg.to_dict())
    pt = PixelCNNTrainer(PixelCNNConfig(**SMALL), TrainConfig(), device="cpu")
    ps, epoch, metrics, _hp = load_checkpoint(path, pt.init_state())
    assert epoch == 7 and metrics == {"val_loss": [3.0]}
    assert ps.step == ps.optimizer.count == 3
    got, want = flatten_tree(train_state_to_jax(ps)), _file_arrays(path)
    assert set(got) == set(want) and len(want) == 3 * 23 + 2
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    mu = ps.optimizer.state[ps.model.layer_1.vert_stack_w]["exp_avg"]
    assert mu.shape == (32, 16, 2, 3) and mu.abs().max() > 0  # live, in torch's layout
    # the loaded Adam takes the next update as the JAX one does
    x, label = _batch(4)
    js, j_loss = jt.step(js, x, label)
    ps, loss = pt.step(ps, x, label)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-6)
    np.testing.assert_allclose(flatten_tree(train_state_to_jax(ps))["leaf::.params['out2_b']"],
                               np.asarray(js.params["out2_b"]), rtol=0, atol=1e-6)


def test_the_moment_set_follows_the_optimizer(tmp_path):
    """A prior template (Adam: mu, nu) refuses a file that also holds
    AMSGrad's nu_max, naming it, and one that lacks nu."""
    ps = PixelCNNTrainer(PixelCNNConfig(**SMALL), TrainConfig(), device="cpu").init_state()
    path = str(tmp_path / "prior.npz")
    save_checkpoint(path, ps, 0)
    arrays = _file_arrays(path)
    with np.load(path, allow_pickle=False) as data:
        meta = str(data["__meta__"])
    nu_max = {k.replace(".nu[", ".nu_max["): v for k, v in arrays.items() if ".opt_state[0].nu[" in k}
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, __meta__=meta, **arrays, **nu_max)
    with pytest.raises(ValueError, match="unexpected leaves.*nu_max"):
        load_checkpoint(bad, ps)
    np.savez(bad, __meta__=meta, **{k: v for k, v in arrays.items() if ".opt_state[0].nu[" not in k})
    with pytest.raises(ValueError, match=r"missing leaves.*\.nu\["):
        load_checkpoint(bad, ps)
