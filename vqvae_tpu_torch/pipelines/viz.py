"""Model loading, metric curves, reconstruction and image grids (port of
``vqvae_tpu/pipelines/viz.py``; the reference's visualization.ipynb as code).

A model is rebuilt from the hyperparameters its checkpoint stores, never
from the caller's flags (the reference notebook's ``load_model``), except
``quantizer_impl``, how the search runs, which the caller gives. A file
without them (written with ``hyperparameters=None``) needs ``fallback_cfg``,
which the CLI builds from its model flags; without one the load raises and
names those flags. Loads are strict: a parameter tree of another
configuration raises.

Figures are written to files. scipy (``smooth``) and matplotlib
(``plot_metrics``, ``save_image_grid``) are imported when those are called,
so nothing else depends on them; without matplotlib the two raise an
``ImportError`` that says so.
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


def _load(path: str, device, cls, model_cls, fallback_cfg, flags, **run_as):
    dev = resolve_device(device)
    params, _step, metrics, hp = read_checkpoint(path)
    model = model_cls(_config(path, hp, cls, fallback_cfg, flags).replace(**run_as))
    model.load_state_dict(params_from_jax(params), strict=True)
    return model.to(dev).eval(), metrics, hp


def load_model(checkpoint_path: str, device: str = "cuda", fallback_cfg: Optional[VQVAEConfig] = None,
               quantizer_impl: str = "auto") -> Tuple[VQVAE, Dict, Dict]:
    """A VQVAE from a checkpoint -> (model in eval mode on ``device``,
    metrics, stored hyperparameters). The model's search runs as
    ``quantizer_impl`` says, whatever the file stores: it is how the search
    runs, not what the model is (the JAX CLI's ``_vqvae_cfg_for_checkpoint``
    loads it as "auto"); the returned hyperparameters keep the stored value."""
    return _load(checkpoint_path, device, VQVAEConfig, VQVAE, fallback_cfg, VQVAE_FLAGS,
                 quantizer_impl=quantizer_impl)


def load_prior(checkpoint_path: str, device: str = "cuda",
               fallback_cfg: Optional[PixelCNNConfig] = None) -> Tuple[GatedPixelCNN, Dict, Dict]:
    """A GatedPixelCNN prior from a checkpoint -> (model in eval mode on
    ``device``, metrics, stored hyperparameters). Only the parameters are
    read; the trainer's Adam state in the file is left alone."""
    return _load(checkpoint_path, device, PixelCNNConfig, GatedPixelCNN, fallback_cfg, PRIOR_FLAGS)


def smooth(values, window: int = 201, order: int = 7) -> np.ndarray:
    """Savitzky-Golay smoothing of a metric curve, as the notebook's
    ``plot_metrics`` (cell 1). A series shorter than the window gets the
    largest odd window that fits; one shorter than 3 is returned as it is.
    (The JAX package takes ``max(5, (n // 2) * 2 + 1)``, one more than an
    even ``n`` or a series under 5, which scipy refuses: its ``viz`` fails on
    a history of 40 updates. For an odd ``n`` of 5 or more the two agree.)"""
    from scipy.signal import savgol_filter

    values = np.asarray(values, dtype=np.float64)
    if len(values) < window:
        window = len(values) - 1 + len(values) % 2
        if window < 3:
            return values
        order = min(order, window - 2)
    return savgol_filter(values, window, order)


def _pyplot():
    """matplotlib's pyplot on the file-only Agg backend, or an ImportError
    that names what needs it."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("plot_metrics and save_image_grid write PNGs with matplotlib, "
                          "which is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_metrics(metrics: Dict, out_path: str) -> str:
    """Raw and smoothed reconstruction-error, loss and perplexity curves in
    one PNG (the notebook's ``plot_metrics``)."""
    plt = _pyplot()
    fig, axes = plt.subplots(1, 3, figsize=(15, 4))
    for ax, key, title in zip(
        axes,
        ["recon_errors", "loss_vals", "perplexities"],
        ["Reconstruction error", "Total loss", "Codebook perplexity"],
    ):
        vals = metrics.get(key, [])
        if len(vals) > 0:
            ax.plot(vals, alpha=0.3, label="raw")
            ax.plot(smooth(vals), label="smoothed")
        ax.set_title(title)
        ax.set_xlabel("update")
        ax.legend()
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def reconstruct(model: VQVAE, batch: np.ndarray) -> np.ndarray:
    """Encode -> quantize -> decode a batch (the notebook's ``reconstruct``)."""
    with torch.inference_mode():
        x = torch.from_numpy(np.ascontiguousarray(batch)).to(model.codebook.device)
        q = model.quantize(model.encode(x))
        return model.decode(q.z_q).cpu().numpy()


def save_image_grid(
    images: np.ndarray, out_path: str, n_cols: int = 8, denormalize: bool = True
) -> str:
    """Tile (N, H, W, 3) images (in [-1, 1] if ``denormalize``) into one PNG."""
    plt = _pyplot()
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


__all__ = ["PRIOR_FLAGS", "VQVAE_FLAGS", "load_model", "load_prior", "plot_metrics", "reconstruct",
           "save_image_grid", "smooth"]
