"""The port's checkpoint reader, dataset, extraction pipeline and CLI, held
against the JAX package, plus the port's import boundary.

Code grids are compared under the near-tie rule (``compare_assignments``) or,
where the small models give clear margins, for equality.
"""

from __future__ import annotations

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_tpu.config import TrainConfig as JaxTrainConfig
from vqvae_tpu.config import VQVAEConfig as JaxConfig
from vqvae_tpu.data.datasets import load_dataset as jax_load_dataset
from vqvae_tpu.pipelines.extract import extract_latents as jax_extract_latents
from vqvae_tpu.train.checkpoint import load_checkpoint, save_checkpoint
from vqvae_tpu.train.vqvae_train import VQVAETrainer
from vqvae_tpu_torch import device as port_device
from vqvae_tpu_torch.config import VQVAEConfig
from vqvae_tpu_torch.data.datasets import load_dataset
from vqvae_tpu_torch.ops.quantizer import compare_assignments
from vqvae_tpu_torch.pipelines.extract import extract_latents
from vqvae_tpu_torch.pipelines.viz import load_model, reconstruct
from vqvae_tpu_torch.train.checkpoint import params_from_jax, read_checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R4 = os.path.join(ROOT, "artifacts/e2e_r4/vqvae_e2e_r4_step4999.npz")

_SMALL = dict(n_hiddens=16, n_residual_hiddens=8, n_residual_layers=1,
              embedding_dim=4, n_embeddings=16, ema_codebook=True)


def _save_small_checkpoint(path):
    """A JAX trainer's full state (params, optimizer, EMA stats), saved by the
    JAX package's own writer."""
    cfg = JaxConfig(**_SMALL)
    trainer = VQVAETrainer(cfg, JaxTrainConfig(seed=3))
    state = trainer.init_state()
    save_checkpoint(str(path), state, 17, metrics={"loss_vals": [1.0]},
                    hyperparameters=cfg.to_dict())
    return trainer, state


def test_checkpoint_reader_on_jax_written_file(tmp_path):
    path = tmp_path / "vqvae_small_step17.npz"
    trainer, state = _save_small_checkpoint(path)
    params, step, metrics, hp = read_checkpoint(str(path))
    assert step == 17 and metrics == {"loss_vals": [1.0]}
    assert VQVAEConfig.from_dict(hp) == VQVAEConfig(**_SMALL)
    flat_j = jax.tree_util.tree_leaves_with_path(state.params)
    assert len(flat_j) == len(jax.tree_util.tree_leaves(params))
    for kp, leaf in flat_j:
        node = params
        for k in kp:
            node = node[k.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))
    # the bridge covers exactly the model's parameters
    model, _m, _hp = load_model(str(path), device="cpu")
    assert set(params_from_jax(params)) == set(model.state_dict())
    np.testing.assert_array_equal(model.codebook.detach().numpy(),
                                  np.asarray(state.params["codebook"]))


def test_load_dataset_bit_identical_to_jax(tmp_path):
    tr, va, var, info = load_dataset("CIFAR10", str(tmp_path))
    jtr, jva, jvar, jinfo = jax_load_dataset("CIFAR10", str(tmp_path))
    assert info == jinfo and info["synthetic"]
    assert var == jvar
    for a, b in ((tr, jtr), (va, jva)):
        assert a.data.dtype == b.data.dtype and np.array_equal(a.data, b.data)
        assert np.array_equal(a.labels, b.labels)
    # BLOCK is ported: without its file in the directory it raises, as JAX's does
    with pytest.raises(FileNotFoundError, match="randact_traj"):
        load_dataset("BLOCK", str(tmp_path))


def test_extract_latents_vs_jax_full_width(tmp_path):
    """The trained full-width e2e_r4 checkpoint on 64 synthetic images with a
    ragged tail batch (64 = 2 x 24 + 16): codes equal except near-ties."""
    data = load_dataset("CIFAR10", str(tmp_path))[1].data[:64]
    model, _m, hp = load_model(R4, device="cpu")
    out = tmp_path / "latents.npy"
    codes = extract_latents(model, data, batch_size=24, out_path=str(out))
    assert codes.shape == (64, 64) and codes.dtype == np.int32
    assert np.array_equal(np.load(out), codes)

    trainer = VQVAETrainer(JaxConfig.from_dict(hp), JaxTrainConfig())
    state, _step, _m2, _hp2 = load_checkpoint(R4, trainer.init_state())
    j_codes = jax_extract_latents(trainer, state, data, batch_size=24)
    with torch.no_grad():
        z_e = model.encode(torch.from_numpy(data)).reshape(-1, 64)
    mism, near, gap = compare_assignments(
        z_e, model.codebook.detach(), torch.from_numpy(codes.reshape(-1)),
        torch.from_numpy(j_codes.reshape(-1)), "highest")
    assert mism == near, f"{mism - near} non-near-tie mismatches (gap {gap})"


def test_reconstruct_matches_forward(tmp_path):
    """``reconstruct`` is encode -> quantize -> decode: the x_hat of forward."""
    path = tmp_path / "small.npz"
    _save_small_checkpoint(path)
    model, _m, _hp = load_model(str(path), device="cpu")
    x = np.random.default_rng(0).uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)
    rec = reconstruct(model, x)
    with torch.no_grad():
        _loss, x_hat, _perp = model(torch.from_numpy(x))
    assert rec.shape == (4, 32, 32, 3) and np.isfinite(rec).all()
    np.testing.assert_array_equal(rec, x_hat.numpy())


def test_cli_extract_latents_cpu_end_to_end(tmp_path):
    """``python -m vqvae_tpu_torch.cli extract-latents --device cpu`` on a
    JAX-written checkpoint: 12,000 grids, the first 64 equal to the JAX model's
    codes (the small model's scores are far from ties)."""
    ckpt = tmp_path / "vqvae_small_step17.npz"
    trainer, state = _save_small_checkpoint(ckpt)
    out = tmp_path / "latents.npy"
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "vqvae_tpu_torch.cli", "extract-latents",
         "--checkpoint", str(ckpt), "--out", str(out), "--extract_batch", "512",
         "--data_dir", str(tmp_path / "data"), "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path), env=env,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    codes = np.load(out)
    assert codes.shape == (12000, 64) and codes.dtype == np.int32
    data = load_dataset("CIFAR10", str(tmp_path / "data"))[0].data[:64]
    model = trainer.model
    j_codes = np.asarray(model.apply({"params": state.params}, jnp.asarray(data),
                                     method=model.codes))
    np.testing.assert_array_equal(codes[:64], j_codes.reshape(64, -1))


_BARE = dict(n_hiddens=16, n_residual_hiddens=8, embedding_dim=16, n_embeddings=64)
_BARE_FLAGS = ["--n_hiddens", "16", "--n_residual_hiddens", "8", "--embedding_dim", "16",
               "--n_embeddings", "64"]


def _run_port_cli(args, cwd):
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.run([sys.executable, "-m", "vqvae_tpu_torch.cli", *args], capture_output=True,
                          text=True, timeout=300, cwd=str(cwd), env=env)


def test_extract_latents_takes_model_flags_for_a_file_without_hyperparameters(tmp_path):
    """A checkpoint saved with hyperparameters=None: the port's extract-latents
    with the JAX command's model flags gives the JAX command's codes (up to
    near-ties); without the flags it fails and names them."""
    import argparse

    from vqvae_tpu.cli import cmd_extract_latents as jax_extract_cmd

    cfg = JaxConfig(**_BARE)
    trainer = VQVAETrainer(cfg, JaxTrainConfig(seed=5))
    ckpt = tmp_path / "bare.npz"
    save_checkpoint(str(ckpt), trainer.init_state(), 0, hyperparameters=None)
    data_dir = tmp_path / "data"
    jax_out, port_out = tmp_path / "jax.npy", tmp_path / "port.npy"
    jax_args = argparse.Namespace(
        checkpoint=str(ckpt), out=str(jax_out), extract_batch=1000, dataset="CIFAR10",
        data_dir=str(data_dir), n_hiddens=16, n_residual_hiddens=8, n_residual_layers=2,
        embedding_dim=16, n_embeddings=64, beta=0.25, share_residual_weights=False)
    assert jax_extract_cmd(jax_args) == 0

    proc = _run_port_cli(["extract-latents", "--checkpoint", str(ckpt), "--out", str(port_out),
                          "--extract_batch", "1000", "--data_dir", str(data_dir), "--device", "cpu",
                          *_BARE_FLAGS], tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    codes, j_codes = np.load(port_out), np.load(jax_out)
    assert codes.shape == j_codes.shape == (12000, 64)
    model, _m, hp = load_model(str(ckpt), device="cpu", fallback_cfg=VQVAEConfig(**_BARE))
    assert hp == {}
    data = load_dataset("CIFAR10", str(data_dir))
    images = np.concatenate([data[0].data, data[1].data])
    with torch.no_grad():
        z_e = torch.cat([model.encode(torch.from_numpy(images[s:s + 2000]))
                         for s in range(0, len(images), 2000)]).reshape(-1, 16)
    mism, near, gap = compare_assignments(z_e, model.codebook.detach(),
                                          torch.from_numpy(codes.reshape(-1)),
                                          torch.from_numpy(j_codes.reshape(-1)), "highest")
    assert mism == near, f"{mism - near} non-near-tie mismatches (gap {gap})"

    proc = _run_port_cli(["extract-latents", "--checkpoint", str(ckpt), "--out",
                          str(tmp_path / "none.npy"), "--data_dir", str(data_dir), "--device", "cpu"],
                         tmp_path)
    assert proc.returncode != 0 and not (tmp_path / "none.npy").exists()
    assert ("stores no hyperparameters: give the model flags it was trained with (--n_hiddens, "
            "--n_residual_hiddens, --n_residual_layers, --embedding_dim, --n_embeddings)") in proc.stderr
    with pytest.raises(ValueError, match="stores no hyperparameters"):
        load_model(str(ckpt), device="cpu")


def test_entry_points_refuse_missing_card(monkeypatch, tmp_path):
    """device="cuda" (the default) raises without a card instead of falling
    back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_device.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_model(R4)
    assert port_device.resolve_device("cpu") == torch.device("cpu")


_IMPORT_CHECK = """
import importlib, pkgutil, sys
import vqvae_tpu_torch
names = [m.name for m in pkgutil.walk_packages(vqvae_tpu_torch.__path__, "vqvae_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "optax", "flax", "vqvae_tpu", "tools"))
print(len(names), "modules")
assert len(names) >= 24, names
for name in ("train.optim", "train.vqvae_train", "train.metrics", "data.sampler", "utils.faults",
             "models.pixelcnn", "models.pixelcnn_sampler", "pipelines.sample", "pipelines.serve",
             "bench", "bench.__main__", "bench.timing", "bench.encode", "bench.train", "bench.prior",
             "bench.quantizer", "bench.sampler", "bench.serve", "bench.parity"):
    assert "vqvae_tpu_torch." + name in names, name
assert not bad, bad
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", _IMPORT_CHECK], capture_output=True,
                          text=True, timeout=120, cwd=ROOT, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
