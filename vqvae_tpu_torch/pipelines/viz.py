"""Model loading and reconstruction (port of ``vqvae_tpu/pipelines/viz.py:29-96``).

Metric plots and image grids come with a later slice.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from vqvae_tpu_torch.config import VQVAEConfig
from vqvae_tpu_torch.device import resolve_device
from vqvae_tpu_torch.models.vqvae import VQVAE
from vqvae_tpu_torch.train.checkpoint import params_from_jax, read_checkpoint


def load_model(checkpoint_path: str, device: str = "cuda") -> Tuple[VQVAE, Dict, Dict]:
    """Rebuild a VQVAE from a checkpoint's STORED hyperparameters, never from
    the caller's flags (the reference notebook's ``load_model``).

    Returns (model in eval mode on ``device``, metrics, hyperparameters).
    """
    dev = resolve_device(device)
    params, _step, metrics, hp = read_checkpoint(checkpoint_path)
    model = VQVAE(VQVAEConfig.from_dict(hp) if hp else VQVAEConfig())
    model.load_state_dict(params_from_jax(params))
    return model.to(dev).eval(), metrics, hp


def reconstruct(model: VQVAE, batch: np.ndarray) -> np.ndarray:
    """Encode -> quantize -> decode a batch (the notebook's ``reconstruct``)."""
    with torch.inference_mode():
        x = torch.from_numpy(np.ascontiguousarray(batch)).to(model.codebook.device)
        q = model.quantize(model.encode(x))
        return model.decode(q.z_q).cpu().numpy()


__all__ = ["load_model", "reconstruct"]
