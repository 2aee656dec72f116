"""The port's metric curves and the ``viz`` command, held against the JAX
package's ``pipelines/viz.py``.

- ``smooth`` is scipy's savgol in both packages: equal to 1e-12 (float64,
  the same call).
- ``viz --device cpu`` on a JAX-written checkpoint: its reconstructions
  against the JAX package's ``reconstruct`` on the same images, atol 1e-4
  as for a whole fp32 model in ``tests/test_torch_models.py`` (TF32 off,
  summation order only), with the codes of every image equal (the small
  model's margins are clear of ties), as in ``tests/test_torch_pipeline.py``.
"""

from __future__ import annotations

import builtins
import os

import numpy as np
import pytest
import torch

from vqvae_tpu.config import MeshConfig as JaxMeshConfig
from vqvae_tpu.config import TrainConfig as JaxTrainConfig
from vqvae_tpu.config import VQVAEConfig as JaxConfig
from vqvae_tpu.pipelines import viz as jax_viz
from vqvae_tpu.train.checkpoint import save_checkpoint
from vqvae_tpu.train.vqvae_train import VQVAETrainer as JaxTrainer
from vqvae_tpu_torch import cli
from vqvae_tpu_torch.data.datasets import load_dataset
from vqvae_tpu_torch.pipelines import viz
from vqvae_tpu_torch.pipelines.viz import load_model, plot_metrics, reconstruct, save_image_grid, smooth

SMALL = dict(n_hiddens=16, n_residual_hiddens=8, n_embeddings=32, embedding_dim=8)


def _metrics(n=300):
    return {"recon_errors": list(np.random.default_rng(0).uniform(1, 4, n)),
            "loss_vals": list(np.random.default_rng(1).uniform(1, 50, n)),
            "perplexities": list(np.random.default_rng(2).uniform(1, 100, n))}


@pytest.mark.parametrize("n", [5, 7, 51, 300, 1000])
def test_smooth_equals_the_jax_smooth(n):
    values = np.random.default_rng(n).normal(size=n).cumsum()
    ours = smooth(values)
    assert ours.shape == (n,)
    np.testing.assert_allclose(ours, jax_viz.smooth(values), rtol=0, atol=1e-12)


@pytest.mark.parametrize("n", [3, 6, 40, 200])
def test_smooth_takes_the_largest_odd_window_where_jax_fails(n):
    """Below 201 values an even n (or n < 5) makes the JAX rule's window one
    longer than the series, which scipy refuses; the port takes n - 1."""
    from scipy.signal import savgol_filter

    values = np.random.default_rng(n).normal(size=n).cumsum()
    with pytest.raises(ValueError):
        jax_viz.smooth(values)
    window = n - 1 + n % 2
    np.testing.assert_allclose(smooth(values), savgol_filter(values, window, min(7, window - 2)),
                               rtol=0, atol=1e-12)
    np.testing.assert_array_equal(smooth([1.0, 2.0]), [1.0, 2.0])


def test_plot_metrics_and_grid_write_pngs(tmp_path):
    p = plot_metrics(_metrics(), str(tmp_path / "m" / "metrics.png"))
    assert os.path.getsize(p) > 1000
    short = plot_metrics({"recon_errors": [3.0, 2.0, 1.5], "loss_vals": []}, str(tmp_path / "s.png"))
    assert os.path.getsize(short) > 1000
    imgs = np.random.default_rng(3).uniform(-1, 1, (10, 32, 32, 3)).astype(np.float32)
    assert os.path.getsize(save_image_grid(imgs, str(tmp_path / "grid.png"))) > 1000


def test_pngs_without_matplotlib_raise_a_clear_import_error(monkeypatch, tmp_path):
    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kwargs):
        if name == "matplotlib" or name.startswith("matplotlib."):
            raise ImportError("No module named 'matplotlib'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    with pytest.raises(ImportError, match="matplotlib, which is not installed"):
        plot_metrics(_metrics(10), str(tmp_path / "m.png"))
    with pytest.raises(ImportError, match="matplotlib, which is not installed"):
        save_image_grid(np.zeros((2, 32, 32, 3), np.float32), str(tmp_path / "g.png"))
    assert not os.listdir(tmp_path)
    assert smooth([1.0, 2.0, 3.0, 4.0, 5.0]).shape == (5,)  # scipy alone still serves


def _jax_checkpoint(path, with_metrics=True):
    cfg = JaxConfig(**SMALL)
    trainer = JaxTrainer(cfg, JaxTrainConfig(seed=4), JaxMeshConfig(), x_train_var=0.05)
    state = trainer.init_state()
    save_checkpoint(str(path), state, 7, metrics=_metrics(40) if with_metrics else None,
                    hyperparameters={**cfg.to_dict(), **JaxTrainConfig().to_dict(), "x_train_var": 0.05})
    return trainer, state


def test_viz_command_matches_the_jax_reconstructions(tmp_path, capsys):
    ckpt = tmp_path / "vqvae_small_step7.npz"
    trainer, state = _jax_checkpoint(ckpt)
    out_dir, data_dir = tmp_path / "viz", tmp_path / "data"
    rc = cli.main(["viz", "--checkpoint", str(ckpt), "--out_dir", str(out_dir), "--data_dir",
                   str(data_dir), "--n_images", "12", "--device", "cpu"])
    assert rc == 0
    printed = capsys.readouterr().out
    for name in ("metrics.png", "originals.png", "reconstructions.png"):
        assert f"Wrote {out_dir}/{name}" in printed and os.path.getsize(out_dir / name) > 1000
    batch = load_dataset("CIFAR10", str(data_dir))[1].data[:12]
    model, metrics, _hp = load_model(str(ckpt), device="cpu")
    ours = reconstruct(model, batch)
    theirs = jax_viz.reconstruct(trainer, state, batch)
    with torch.no_grad():
        codes = model.codes(torch.from_numpy(batch)).numpy()
    j_codes = np.asarray(trainer.model.apply({"params": state.params}, batch, method=trainer.model.codes))
    np.testing.assert_array_equal(codes, j_codes.reshape(codes.shape))
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-4)
    assert len(metrics["loss_vals"]) == 40


def test_viz_without_metrics_writes_only_the_images(tmp_path, capsys):
    ckpt = tmp_path / "bare.npz"
    _jax_checkpoint(ckpt, with_metrics=False)
    assert cli.main(["viz", "--checkpoint", str(ckpt), "--out_dir", str(tmp_path / "v"), "--data_dir",
                     str(tmp_path / "data"), "--n_images", "4", "--device", "cpu"]) == 0
    assert sorted(os.listdir(tmp_path / "v")) == ["originals.png", "reconstructions.png"]
    assert "metrics.png" not in capsys.readouterr().out


def test_viz_refuses_a_missing_card(monkeypatch, tmp_path):
    ckpt = tmp_path / "c.npz"
    _jax_checkpoint(ckpt)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["viz", "--checkpoint", str(ckpt), "--out_dir", str(tmp_path / "v")])
    assert viz.VQVAE_FLAGS[0] == "--n_hiddens"
