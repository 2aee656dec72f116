"""The port's training loop on the CPU: chunking, device-resident data,
crash and resume, the metrics file, bf16 mode and the command line.

On the CPU every sum has a fixed order, so runs that should take the same
updates are compared bit for bit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vqvae_tpu_torch import cli
from vqvae_tpu_torch.config import TrainConfig, VQVAEConfig
from vqvae_tpu_torch.data.datasets import ArrayDataset
from vqvae_tpu_torch.pipelines.viz import load_model
from vqvae_tpu_torch.train.checkpoint import (
    flatten_tree,
    peek_hyperparameters,
    train_state_to_jax,
)
from vqvae_tpu_torch.train.vqvae_train import VQVAETrainer, metrics_to_host, train_vqvae
from vqvae_tpu_torch.utils.faults import FaultInjector, InjectedFault

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(n_hiddens=16, n_residual_hiddens=8, n_embeddings=64, embedding_dim=16)


@pytest.fixture(scope="module")
def dataset():
    rng = np.random.default_rng(0)
    data = rng.uniform(-1, 1, (96, 32, 32, 3)).astype(np.float32)
    labels = np.zeros(96, np.int32)
    train = ArrayDataset(data[:80], labels[:80])
    val = ArrayDataset(data[80:], labels[80:])
    return train, val, 0.3, {"name": "uniform", "synthetic": True, "n_train": 80, "n_val": 16}


def _run(dataset, tmp_path, name="run", **kw):
    vq = VQVAEConfig(**TINY, **kw.pop("vq", {}))
    hook, resume = kw.pop("step_hook", None), kw.pop("resume", False)
    cfg = TrainConfig(batch_size=8, n_updates=kw.pop("n_updates", 13), log_interval=5, seed=1,
                      filename=name, results_dir=str(tmp_path), **kw)
    return train_vqvae(vq, cfg, dataset=dataset, verbose=False, resume=resume,
                       step_hook=hook, device="cpu")


def _arrays(state):
    return flatten_tree(train_state_to_jax(state))


def _assert_same_state(a, b):
    fa, fb = _arrays(a), _arrays(b)
    assert set(fa) == set(fb)
    for key in fa:
        np.testing.assert_array_equal(fa[key], fb[key], err_msg=key)


@pytest.mark.parametrize("ema", [False, True], ids=["gradient", "ema"])
def test_chunked_runs_equal_the_step_by_step_run(dataset, tmp_path, ema):
    vq = {"ema_codebook": ema}
    s1, h1, _t = _run(dataset, tmp_path, vq=dict(vq), steps_per_dispatch=1)
    s5, h5, t5 = _run(dataset, tmp_path, vq=dict(vq), steps_per_dispatch=5)
    s5h, h5h, t5h = _run(dataset, tmp_path, vq=dict(vq), steps_per_dispatch=5, device_data=False)
    assert t5._device_data is not None and t5h._device_data is None  # by index / stacked batches
    assert s1.step == s5.step == s5h.step == 13 and s1.optimizer.count == 13
    _assert_same_state(s1, s5)
    _assert_same_state(s1, s5h)
    assert h1.to_dict() == h5.to_dict() == h5h.to_dict() and len(h1.loss_vals) == 13
    assert h1.n_updates == 12


def test_steps_and_steps_by_index_stack_per_step_metrics(dataset):
    train = dataset[0]
    trainer = VQVAETrainer(VQVAEConfig(**TINY), TrainConfig(batch_size=8), 0.3, device="cpu")
    idx = np.arange(24).reshape(3, 8)
    a, b, c = (trainer.init_state(torch.Generator().manual_seed(5)) for _ in range(3))
    a, m_a = trainer.steps(a, train.data[idx])
    trainer.stage_dataset(train.data)
    b, m_b = trainer.steps_by_index(b, idx)
    singles = []
    for row in idx:
        c, m = trainer.step(c, train.data[row])
        assert m["loss"].shape == ()
        singles.append(metrics_to_host(m))
    _assert_same_state(a, b)
    _assert_same_state(a, c)
    host_a, host_b = metrics_to_host(m_a), metrics_to_host(m_b)
    for name in ("loss", "recon_error", "perplexity"):
        assert host_a[name].shape == (3,)
        np.testing.assert_array_equal(host_a[name], host_b[name])
        np.testing.assert_array_equal(host_a[name], [s[name] for s in singles])
    with pytest.raises(RuntimeError, match="stage_dataset"):
        VQVAETrainer(VQVAEConfig(**TINY), TrainConfig(), device="cpu").steps_by_index(a, idx)
    ev = trainer.eval_batch(a, train.data[:4])
    assert ev["x_hat"].shape == (4, 32, 32, 3) and np.isfinite(float(ev["loss"]))
    assert not ev["x_hat"].requires_grad


def _jsonl_steps(path):
    with open(path) as f:
        return [json.loads(line)["step"] for line in f]


@pytest.mark.parametrize("spd", [1, 4])
def test_crash_and_resume_equals_the_uninterrupted_run(dataset, tmp_path, spd):
    whole, h_whole, _t = _run(dataset, tmp_path / "whole", save=True, steps_per_dispatch=spd)
    crash_dir = tmp_path / "crash"
    with pytest.raises(InjectedFault):
        _run(dataset, crash_dir, save=True, steps_per_dispatch=spd, step_hook=FaultInjector(8))
    # checkpoints of steps 0 and 5 are durable; steps 6..8 ran and were lost
    assert sorted(os.listdir(crash_dir)) == [
        "vqvae_run_metrics.jsonl", "vqvae_run_step0.npz", "vqvae_run_step5.npz"]
    assert _jsonl_steps(crash_dir / "vqvae_run_metrics.jsonl") == list(range(9))
    resumed, h_res, _t = _run(dataset, crash_dir, save=True, steps_per_dispatch=spd, resume=True)
    _assert_same_state(whole, resumed)
    assert h_res.to_dict() == h_whole.to_dict()
    # every step once in the metrics file, also those run twice
    assert _jsonl_steps(crash_dir / "vqvae_run_metrics.jsonl") == list(range(13))
    assert _jsonl_steps(tmp_path / "whole" / "vqvae_run_metrics.jsonl") == list(range(13))
    with open(crash_dir / "vqvae_run_metrics.jsonl") as f:
        losses = [json.loads(line)["loss"] for line in f]
    assert losses == h_whole.loss_vals
    # checkpoints at step 0, every log interval and the end; the stored
    # hyperparameters carry both configs and the dataset's
    assert {f for f in os.listdir(crash_dir) if f.endswith(".npz")} == {
        f"vqvae_run_step{s}.npz" for s in (0, 5, 10, 12)}
    hp = peek_hyperparameters(str(crash_dir / "vqvae_run_step12.npz"))
    assert hp["n_hiddens"] == 16 and hp["batch_size"] == 8 and hp["x_train_var"] == 0.3
    assert hp["dataset_info"]["n_train"] == 80 and hp["amsgrad_impl"] == "torch"


def test_resume_refuses_other_model_flags_and_starts_fresh_without_a_file(dataset, tmp_path):
    _run(dataset, tmp_path, save=True, n_updates=6)
    with pytest.raises(ValueError, match="ema_codebook: checkpoint=False vs flags=True"):
        _run(dataset, tmp_path, save=True, resume=True, vq={"ema_codebook": True})
    fresh, h, _t = _run(dataset, tmp_path, name="never_saved", resume=True, n_updates=3)
    assert fresh.step == 3 and len(h.loss_vals) == 3


def test_loss_falls_on_a_fixed_batch(dataset):
    trainer = VQVAETrainer(VQVAEConfig(**TINY), TrainConfig(batch_size=16), 0.3, device="cpu")
    state = trainer.init_state()
    batch = dataset[0].data[:16]
    errors = []
    for _ in range(30):
        state, m = trainer.step(state, batch)
        errors.append(float(m["recon_error"]))
    assert errors[-1] < errors[0] and np.isfinite(errors).all()


def test_bf16_training_runs_and_keeps_fp32_state(dataset):
    vq = VQVAEConfig(**TINY, compute_dtype="bfloat16", quantizer_precision="default")
    trainer = VQVAETrainer(vq, TrainConfig(batch_size=16), 0.3, device="cpu")
    state = trainer.init_state()
    state, m = trainer.steps(state, dataset[0].data[:48].reshape(3, 16, 32, 32, 3))
    host = metrics_to_host(m)
    assert all(np.isfinite(v).all() for v in host.values())
    for p in state.model.parameters():
        assert p.dtype == torch.float32 and torch.isfinite(p).all()
        assert state.optimizer.state[p]["nu_max"].dtype == torch.float32
    assert state.optimizer.state[state.model.encoder.conv1_w]["mu"].abs().max() > 0


def test_trainer_refuses_a_missing_card_and_the_optax_variant(monkeypatch, dataset):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VQVAETrainer(VQVAEConfig(**TINY), TrainConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_vqvae(VQVAEConfig(**TINY), TrainConfig(n_updates=1), dataset=dataset)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["train-vqvae", "--n_updates", "1"])
    with pytest.raises(ValueError, match="comparison variant"):
        VQVAETrainer(VQVAEConfig(**TINY), TrainConfig(amsgrad_impl="optax"),
                     device="cpu").init_state()


def test_cli_train_vqvae_then_extract_latents(tmp_path, capsys):
    results = tmp_path / "results"
    common = ["--data_dir", str(tmp_path / "data"), "--device", "cpu"]
    rc = cli.main([
        "train-vqvae", "--n_updates", "7", "--log_interval", "3", "-save", "--filename", "X",
        "--results_dir", str(results), "--batch_size", "8", "--n_hiddens", "16",
        "--n_residual_hiddens", "8", "--n_embeddings", "64", "--embedding_dim", "16",
        "--steps_per_dispatch", "2", "--ema_codebook", "--quantizer_impl", "pallas", *common])
    assert rc == 0
    printed = capsys.readouterr().out
    assert "Update # 0 " in printed and "Update # 6 " in printed
    assert sorted(f for f in os.listdir(results) if f.endswith(".npz")) == [
        "vqvae_X_step0.npz", "vqvae_X_step3.npz", "vqvae_X_step6.npz"]
    ckpt = str(results / "vqvae_X_step6.npz")
    hp = peek_hyperparameters(ckpt)
    assert hp["ema_codebook"] is True and hp["quantizer_impl"] == "pallas"  # kept, not used
    model, metrics, _hp = load_model(ckpt, device="cpu")
    assert len(metrics["loss_vals"]) == 7 and model.config.n_embeddings == 64
    out = tmp_path / "latents.npy"
    rc = cli.main(["extract-latents", "--checkpoint", ckpt, "--out", str(out),
                   "--extract_batch", "1000", *common])
    assert rc == 0
    codes = np.load(out)
    assert codes.shape == (12000, 64) and codes.dtype == np.int32
    assert codes.min() >= 0 and codes.max() < 64


def test_cli_module_entry_point_runs_in_a_fresh_interpreter(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "vqvae_tpu_torch.cli", "train-vqvae", "--n_updates", "2",
         "--log_interval", "1", "--batch_size", "4", "--n_hiddens", "16",
         "--n_residual_hiddens", "8", "--n_embeddings", "16", "--embedding_dim", "4",
         "--data_dir", str(tmp_path / "data"), "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path), env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Update # 1 " in proc.stdout
    assert not os.path.exists(tmp_path / "results")  # nothing saved without -save
