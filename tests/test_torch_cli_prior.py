"""``train-prior`` end to end through the port's command line.

This file imports neither JAX nor the JAX package, so its ``gpu`` test runs
on a card with
    python -m pytest --noconftest -m gpu tests/test_torch_cli_prior.py
and skips itself, inside the test, where there is none.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from vqvae_tpu_torch import cli
from vqvae_tpu_torch.pipelines.viz import load_prior

TINY_FLAGS = ["--n_embeddings", "16", "--img_dim", "4", "--n_layers", "2", "--batch_size", "16",
              "--log_interval", "4"]


def _latent_file(data_dir, n=600):
    """A flat (N, 16) code file as extract-latents writes one: 100 training
    grids of 4 x 4 and the last 500 for validation."""
    os.makedirs(data_dir, exist_ok=True)
    codes = np.random.default_rng(0).integers(0, 16, (n, 16)).astype(np.int32)
    np.save(os.path.join(data_dir, "latent_e_indices.npy"), codes)


def _meta(path):
    with np.load(path, allow_pickle=False) as data:
        return json.loads(str(data["__meta__"]))


def _train_prior(tmp_path, device, *extra):
    data, results = tmp_path / "data", tmp_path / "results"
    _latent_file(str(data))
    rc = cli.main(["train-prior", "--epochs", "3", "-save", "--data_dir", str(data),
                   "--results_dir", str(results), "--device", device, *TINY_FLAGS, *extra])
    return rc, str(results / "latent_block_pixelcnn.npz")


def test_train_prior_on_the_cpu_writes_the_file_and_its_history(tmp_path, capsys):
    rc, path = _train_prior(tmp_path, "cpu", "--steps_per_dispatch", "3", "--gen_samples")
    assert rc == 0
    printed = capsys.readouterr().out
    assert printed.count("Validation Completed!") == 2 and "Iter [4] Loss:" in printed
    assert printed.count("Generated samples (100, 4, 4)") == 2
    meta = _meta(path)
    assert meta["step"] == 2 and meta["n_leaves"] == 3 * 23 + 2
    assert len(meta["metrics"]["train_loss"]) == len(meta["metrics"]["val_loss"]) == 2
    assert np.isfinite(meta["metrics"]["val_loss"]).all()
    assert meta["hyperparameters"] == {"input_dim": 16, "dim": 16, "n_layers": 2, "n_classes": 10,
                                       "img_dim": 4, "compute_dtype": "float32",
                                       "conv_precision": "highest"}
    model, metrics, _hp = load_prior(path, device="cpu")
    assert model.config.input_dim == 16 and metrics == meta["metrics"]
    # --resume with more epochs continues the history from epoch 2
    data, results = tmp_path / "data", tmp_path / "results"
    rc = cli.main(["train-prior", "--epochs", "4", "-save", "--resume", "--data_dir", str(data),
                   "--results_dir", str(results), "--device", "cpu", *TINY_FLAGS])
    assert rc == 0 and "Resumed from" in capsys.readouterr().out
    meta2 = _meta(path)
    assert meta2["step"] == 3 and meta2["metrics"]["val_loss"][:2] == meta["metrics"]["val_loss"]


def test_train_prior_in_bf16_on_the_cpu(tmp_path):
    rc, path = _train_prior(tmp_path, "cpu", "--compute_dtype", "bfloat16", "--conv_precision", "default")
    assert rc == 0
    meta = _meta(path)
    assert meta["hyperparameters"]["compute_dtype"] == "bfloat16"
    assert np.isfinite(meta["metrics"]["train_loss"]).all()


def test_train_prior_refuses_a_missing_card_before_reading(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["train-prior", "--data_dir", str(tmp_path / "nothing-here")])


@pytest.mark.gpu
def test_train_prior_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card with -m gpu")
    rc, path = _train_prior(tmp_path, "cuda", "--steps_per_dispatch", "4")
    assert rc == 0
    meta = _meta(path)
    assert meta["step"] == 2 and np.isfinite(meta["metrics"]["val_loss"]).all()
    model, _m, _hp = load_prior(path, device="cuda")
    assert model.embedding.device.type == "cuda"
