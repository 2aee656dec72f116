"""Model loading, reconstruction and image grids (port of
``vqvae_tpu/pipelines/viz.py``; ``smooth`` and ``plot_metrics`` come with a
later slice).

A model is rebuilt from the hyperparameters its checkpoint stores, never
from the caller's flags (the reference notebook's ``load_model``). A file
without them (written with ``hyperparameters=None``) needs ``fallback_cfg``,
which the CLI builds from its model flags; without one the load raises and
names those flags. Loads are strict: a parameter tree of another
configuration raises.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from vqvae_tpu_torch.config import PixelCNNConfig, VQVAEConfig
from vqvae_tpu_torch.device import resolve_device
from vqvae_tpu_torch.models.pixelcnn import GatedPixelCNN
from vqvae_tpu_torch.models.vqvae import VQVAE
from vqvae_tpu_torch.train.checkpoint import params_from_jax, read_checkpoint

VQVAE_FLAGS = ("--n_hiddens", "--n_residual_hiddens", "--n_residual_layers", "--embedding_dim",
               "--n_embeddings")
PRIOR_FLAGS = ("--n_embeddings", "--img_dim", "--n_layers")


def _config(path: str, hp: Dict, cls, fallback_cfg, flags: Tuple[str, ...]):
    if hp:
        return cls.from_dict(hp)
    if fallback_cfg is None:
        raise ValueError(
            f"{path} stores no hyperparameters: give the model flags it was trained "
            f"with ({', '.join(flags)})"
        )
    return fallback_cfg


def _load(path: str, device, cls, model_cls, fallback_cfg, flags):
    dev = resolve_device(device)
    params, _step, metrics, hp = read_checkpoint(path)
    model = model_cls(_config(path, hp, cls, fallback_cfg, flags))
    model.load_state_dict(params_from_jax(params), strict=True)
    return model.to(dev).eval(), metrics, hp


def load_model(checkpoint_path: str, device: str = "cuda",
               fallback_cfg: Optional[VQVAEConfig] = None) -> Tuple[VQVAE, Dict, Dict]:
    """A VQVAE from a checkpoint -> (model in eval mode on ``device``,
    metrics, stored hyperparameters)."""
    return _load(checkpoint_path, device, VQVAEConfig, VQVAE, fallback_cfg, VQVAE_FLAGS)


def load_prior(checkpoint_path: str, device: str = "cuda",
               fallback_cfg: Optional[PixelCNNConfig] = None) -> Tuple[GatedPixelCNN, Dict, Dict]:
    """A GatedPixelCNN prior from a checkpoint -> (model in eval mode on
    ``device``, metrics, stored hyperparameters). Only the parameters are
    read; the trainer's Adam state in the file is left alone."""
    return _load(checkpoint_path, device, PixelCNNConfig, GatedPixelCNN, fallback_cfg, PRIOR_FLAGS)


def reconstruct(model: VQVAE, batch: np.ndarray) -> np.ndarray:
    """Encode -> quantize -> decode a batch (the notebook's ``reconstruct``)."""
    with torch.inference_mode():
        x = torch.from_numpy(np.ascontiguousarray(batch)).to(model.codebook.device)
        q = model.quantize(model.encode(x))
        return model.decode(q.z_q).cpu().numpy()


def save_image_grid(
    images: np.ndarray, out_path: str, n_cols: int = 8, denormalize: bool = True
) -> str:
    """Tile (N, H, W, 3) images (in [-1, 1] if ``denormalize``) into one PNG.
    Needs matplotlib, imported here so that the rest of the module does not."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if denormalize:
        images = np.clip((images + 1.0) / 2.0, 0.0, 1.0)
    n = len(images)
    n_rows = -(-n // n_cols)
    fig, axes = plt.subplots(n_rows, n_cols, figsize=(n_cols * 1.5, n_rows * 1.5))
    axes = np.atleast_2d(axes)
    for i in range(n_rows * n_cols):
        ax = axes[i // n_cols, i % n_cols]
        ax.axis("off")
        if i < n:
            ax.imshow(images[i])
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


__all__ = ["PRIOR_FLAGS", "VQVAE_FLAGS", "load_model", "load_prior", "reconstruct", "save_image_grid"]
