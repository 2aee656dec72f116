"""The port's prior training loop (``train_pixelcnn``) on the CPU: its loss
curves against the JAX package's loop on the same data and initial state,
chunked updates, best-validation saving, resume and per-epoch samples.

Both loops start from one state: the JAX trainer's fresh state, written as
a checkpoint tagged epoch 0 with an empty history, which each package then
resumes from (the resume path the reference lacks; epoch 0 is before the
first epoch, so nothing is replayed). Tolerance of the curves: rtol 4e-7
(measured 8.6e-8 over 2 epochs of 6 updates: fp32 on both sides,
summation order only). Port runs that should take the same updates are
compared bit for bit: on the CPU every sum has a fixed order.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import pytest

from vqvae_tpu.config import MeshConfig
from vqvae_tpu.config import PixelCNNConfig as JaxPixelCNNConfig
from vqvae_tpu.config import TrainConfig as JaxTrainConfig
from vqvae_tpu.data.datasets import ArrayDataset as JaxArrayDataset
from vqvae_tpu.train import checkpoint as jax_checkpoint
from vqvae_tpu.train.pixelcnn_train import PixelCNNTrainer as JaxPixelCNNTrainer
from vqvae_tpu.train.pixelcnn_train import train_pixelcnn as jax_train_pixelcnn
from vqvae_tpu_torch.config import PixelCNNConfig, TrainConfig
from vqvae_tpu_torch.data.datasets import ArrayDataset
from vqvae_tpu_torch.train.checkpoint import flatten_tree, peek_hyperparameters, train_state_to_jax
from vqvae_tpu_torch.train.pixelcnn_train import train_pixelcnn

SMALL = dict(input_dim=16, dim=16, n_layers=2, n_classes=10, img_dim=4)


def _latents(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 16, size=(n, 4, 4)).astype(np.int32),
            rng.integers(0, 10, size=(n,)).astype(np.int32))


TRAIN, VAL = _latents(48, 0), _latents(16, 1)


def _port_data():
    return ArrayDataset(*TRAIN), ArrayDataset(*VAL)


def _train_cfg(**kw):
    return TrainConfig(**{**dict(batch_size=8, epochs=3, log_interval=100, seed=0), **kw})


def _run(tmp_path=None, name="prior.npz", **kw):
    resume = kw.pop("resume", False)
    path = str(tmp_path / name) if tmp_path is not None else None
    return train_pixelcnn(PixelCNNConfig(**SMALL), _train_cfg(**kw), *_port_data(), verbose=False,
                          save_path=path, resume=resume, device="cpu")


def _state_arrays(state):
    return flatten_tree(train_state_to_jax(state))


def _assert_same_state(a, b):
    fa, fb = _state_arrays(a), _state_arrays(b)
    assert set(fa) == set(fb)
    for key in fa:
        np.testing.assert_array_equal(fa[key], fb[key], err_msg=key)


def test_loss_curves_follow_the_jax_loop(tmp_path):
    cfg = JaxPixelCNNConfig(**SMALL)
    jt = JaxPixelCNNTrainer(cfg, JaxTrainConfig(seed=0), MeshConfig(n_data=1))
    start = str(tmp_path / "start.npz")
    jax_checkpoint.save_checkpoint(start, jt.init_state(), 0,
                                   metrics={"train_loss": [], "val_loss": []},
                                   hyperparameters=cfg.to_dict())
    for name in ("jax.npz", "port.npz"):
        shutil.copy(start, tmp_path / name)
    _js, theirs = jax_train_pixelcnn(
        cfg, JaxTrainConfig(batch_size=8, epochs=3, log_interval=100, seed=0),
        JaxArrayDataset(*TRAIN), JaxArrayDataset(*VAL), MeshConfig(n_data=1), verbose=False,
        save_path=str(tmp_path / "jax.npz"), resume=True)
    ps, ours = _run(tmp_path, "port.npz", resume=True)
    for curve in ("train_loss", "val_loss"):
        assert len(ours["history"][curve]) == 2
        np.testing.assert_allclose(ours["history"][curve], theirs["history"][curve], rtol=4e-7,
                                   err_msg=curve)
    assert ours["best_val_loss"] == min(ours["history"]["val_loss"])
    assert ps.step == ps.optimizer.count == 12  # 2 epochs x 48 // 8
    # the two files hold the same leaves under the same epoch tag
    assert peek_tag(tmp_path / "jax.npz") == peek_tag(tmp_path / "port.npz")


def peek_tag(path):
    """(the epoch tag, the sorted keys) of a prior file."""
    with np.load(path, allow_pickle=False) as data:
        return json.loads(str(data["__meta__"]))["step"], sorted(data.files)


def test_chunked_run_equals_the_step_by_step_run():
    s1, a = _run()
    s4, b = _run(steps_per_dispatch=4)  # chunks 4 + 2 an epoch, staged grids
    assert b["trainer"]._device_data is not None and a["trainer"]._device_data is None
    assert a["history"] == b["history"]
    _assert_same_state(s1, s4)


def test_resume_equals_the_uninterrupted_run(tmp_path):
    whole, full = _run(tmp_path, "whole.npz", epochs=4, save=True)
    _run(tmp_path, epochs=2, save=True)  # a run that stops after epoch 1
    assert peek_tag(tmp_path / "prior.npz")[0] == 1
    resumed, rest = _run(tmp_path, epochs=4, save=True, resume=True)
    assert rest["history"] == full["history"] and len(full["history"]["val_loss"]) == 3
    _assert_same_state(whole, resumed)
    assert resumed.step == 18 and peek_tag(tmp_path / "prior.npz")[0] == 3
    assert peek_hyperparameters(str(tmp_path / "prior.npz")) == PixelCNNConfig(**SMALL).to_dict()


def test_saves_only_on_a_best_validation_loss_without_save(tmp_path, capsys):
    """Without -save the file is written when the validation loss is the
    best so far, tagged with that epoch (reference gated_pixelcnn.py:153-169)."""
    _state, out = train_pixelcnn(PixelCNNConfig(**SMALL), _train_cfg(epochs=6, learning_rate=3e-2),
                                 *_port_data(), verbose=True, save_path=str(tmp_path / "p.npz"),
                                 device="cpu")
    val = out["history"]["val_loss"]
    printed = capsys.readouterr().out
    best_epoch = 1 + int(np.argmin(val))
    assert peek_tag(tmp_path / "p.npz")[0] == best_epoch
    saves = printed.count("Saving model!")
    skips = printed.count("Not saving model!")
    assert saves + skips == 5 and saves == sum(v <= min(val[:i + 1]) for i, v in enumerate(val))
    assert skips > 0, "a learning rate of 3e-2 should overfit 48 grids within 5 epochs"


def test_gen_samples_draws_every_epoch_and_replays():
    _s, a = _run(gen_samples=True, steps_per_dispatch=3)
    _s, b = _run(gen_samples=True, steps_per_dispatch=3)
    assert len(a["samples"]) == 2
    for grids in a["samples"]:
        assert grids.shape == (100, 4, 4) and grids.dtype == np.int32
        assert grids.min() >= 0 and grids.max() < 16
    assert not np.array_equal(a["samples"][0], a["samples"][1])  # another epoch, another seed
    for x, y in zip(a["samples"], b["samples"]):
        np.testing.assert_array_equal(x, y)


def test_resume_refuses_other_model_flags(tmp_path):
    _run(tmp_path, epochs=2, save=True)
    with pytest.raises(ValueError, match="n_layers: checkpoint=2 vs flags=3"):
        train_pixelcnn(PixelCNNConfig(**{**SMALL, "n_layers": 3}), _train_cfg(), *_port_data(),
                       verbose=False, save_path=str(tmp_path / "prior.npz"), resume=True, device="cpu")
    # no file yet: a resume starts from epoch 1
    fresh, out = _run(tmp_path, "never_saved.npz", resume=True)
    assert fresh.step == 12 and len(out["history"]["train_loss"]) == 2
    assert os.path.exists(tmp_path / "never_saved.npz")  # epoch 1 is the best so far
