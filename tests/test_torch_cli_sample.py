"""The port's ``sample`` and ``serve`` commands: flags against the JAX CLI's,
``sample --device cpu`` end to end on small checkpoints written by the JAX
package, the fallback to the model flags for a file without stored
hyperparameters, and the refusal without a card.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vqvae_tpu.cli import build_parser as jax_build_parser
from vqvae_tpu.config import PixelCNNConfig as JaxPixelCNNConfig
from vqvae_tpu.config import TrainConfig as JaxTrainConfig
from vqvae_tpu.config import VQVAEConfig as JaxVQVAEConfig
from vqvae_tpu.pipelines.sample import decode_code_grids as jax_decode_code_grids
from vqvae_tpu.train.checkpoint import save_checkpoint
from vqvae_tpu.train.pixelcnn_train import PixelCNNTrainer
from vqvae_tpu.train.vqvae_train import VQVAETrainer
from vqvae_tpu_torch import cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VQ_SMALL = dict(n_hiddens=16, n_residual_hiddens=8, embedding_dim=16, n_embeddings=64)
PRIOR_SMALL = dict(input_dim=64, dim=16, n_layers=3, img_dim=8)
# what the model flags rebuild for a prior file without hyperparameters: dim = img_dim ** 2
PRIOR_BARE = dict(input_dim=64, dim=16, n_layers=3, img_dim=4)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    vq_cfg = JaxVQVAEConfig(**VQ_SMALL)
    vq_trainer = VQVAETrainer(vq_cfg, JaxTrainConfig(seed=2))
    vq_state = vq_trainer.init_state()
    save_checkpoint(str(d / "vqvae.npz"), vq_state, 9, hyperparameters=vq_cfg.to_dict())
    prior_cfg = JaxPixelCNNConfig(**PRIOR_SMALL)
    save_checkpoint(str(d / "prior.npz"), PixelCNNTrainer(prior_cfg, JaxTrainConfig()).init_state(),
                    4, hyperparameters=prior_cfg.to_dict())
    bare = PixelCNNTrainer(JaxPixelCNNConfig(**PRIOR_BARE), JaxTrainConfig(seed=3)).init_state()
    save_checkpoint(str(d / "prior_bare.npz"), bare, 4, hyperparameters=None)
    return d, vq_trainer, vq_state


def _run(args, cwd):
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.run([sys.executable, "-m", "vqvae_tpu_torch.cli", *args], capture_output=True,
                          text=True, timeout=300, cwd=str(cwd), env=env)


@pytest.mark.parametrize("command", ["extract-latents", "sample", "serve"])
def test_flags_and_defaults_are_the_jax_commands(command):
    """Every flag of the JAX command parses in the port's with the same
    default; the port adds --device (default cuda)."""
    required = {"extract-latents": ["--checkpoint", "c"],
                "sample": ["--vqvae-checkpoint", "v", "--prior-checkpoint", "p"],
                "serve": ["--prior-checkpoint", "p"]}[command]
    theirs = vars(jax_build_parser().parse_args([command, *required]))
    ours = vars(cli.build_parser().parse_args([command, *required]))
    for key in set(theirs) - {"fn"}:
        assert ours[key] == theirs[key], key
    assert ours["device"] == "cuda"


def test_sample_cli_on_the_cpu(checkpoints, tmp_path):
    """12 samples with a PNG grid: shapes, the label cycle, codes in range,
    images equal the JAX decoder's on the drawn codes."""
    d, vq_trainer, vq_state = checkpoints
    out, png = tmp_path / "s" / "s.npz", tmp_path / "grid.png"
    proc = _run(["sample", "--vqvae-checkpoint", str(d / "vqvae.npz"), "--prior-checkpoint",
                 str(d / "prior.npz"), "--n_samples", "12", "--out", str(out), "--png", str(png),
                 "--seed", "3", "--device", "cpu"], tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Saved 12 samples" in proc.stdout and png.stat().st_size > 0
    s = np.load(out)
    assert set(s.files) == {"images", "codes", "labels"}
    assert s["images"].shape == (12, 32, 32, 3) and s["codes"].shape == (12, 8, 8)
    assert s["codes"].dtype == np.int32 and 0 <= s["codes"].min() and s["codes"].max() < 64
    np.testing.assert_array_equal(s["labels"], np.arange(12) % 10)
    assert np.isfinite(s["images"]).all()
    want = jax_decode_code_grids(vq_trainer, vq_state, s["codes"])
    np.testing.assert_allclose(s["images"], want, rtol=0, atol=1e-4)
    again = tmp_path / "again.npz"  # one seed, one draw
    assert _run(["sample", "--vqvae-checkpoint", str(d / "vqvae.npz"), "--prior-checkpoint",
                 str(d / "prior.npz"), "--n_samples", "12", "--out", str(again), "--seed", "3",
                 "--device", "cpu"], tmp_path).returncode == 0
    np.testing.assert_array_equal(np.load(again)["codes"], s["codes"])


def test_sample_cli_prior_without_hyperparameters(checkpoints, tmp_path):
    """A prior file without hyperparameters takes --n_embeddings, --img_dim
    and --n_layers (dim = img_dim ** 2); without them the command fails and
    names them."""
    d, _t, _s = checkpoints
    base = ["sample", "--vqvae-checkpoint", str(d / "vqvae.npz"), "--prior-checkpoint",
            str(d / "prior_bare.npz"), "--n_samples", "3", "--device", "cpu"]
    ok = _run([*base, "--out", str(tmp_path / "ok.npz"), "--n_embeddings", "64", "--img_dim", "4",
               "--n_layers", "3"], tmp_path)
    assert ok.returncode == 0, ok.stderr[-3000:]
    s = np.load(tmp_path / "ok.npz")
    assert s["codes"].shape == (3, 4, 4) and s["images"].shape == (3, 16, 16, 3)
    bad = _run([*base, "--out", str(tmp_path / "bad.npz")], tmp_path)
    assert bad.returncode != 0 and not (tmp_path / "bad.npz").exists()
    assert "(--n_embeddings, --img_dim, --n_layers)" in bad.stderr


def test_sample_and_serve_refuse_a_missing_card(checkpoints, tmp_path, monkeypatch):
    d, _t, _s = checkpoints
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["sample", "--vqvae-checkpoint", str(d / "vqvae.npz"), "--prior-checkpoint",
                  str(d / "prior.npz"), "--out", str(tmp_path / "x.npz")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["serve", "--prior-checkpoint", str(d / "prior.npz"), "--port", "0"])
    assert not (tmp_path / "x.npz").exists()
