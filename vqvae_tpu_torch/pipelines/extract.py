"""Latent extraction: dataset -> code-index grids (port of ``vqvae_tpu/pipelines/extract.py``).

Batches run eagerly through ``VQVAE.codes`` on the model's device under
``torch.inference_mode``; the tail batch needs no padding (PyTorch has no
compiled shapes). Each batch is staged to the device once, the index grids
stay there, and one copy brings them back at the end. The result is saved
flat (N, h*w) int32, the layout the LATENT_BLOCK loader reads.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from vqvae_tpu_torch.models.vqvae import VQVAE


def extract_latents(
    model: VQVAE,
    data: np.ndarray,
    batch_size: int = 256,
    out_path: Optional[str] = None,
) -> np.ndarray:
    """Encode ``data`` (N, 32, 32, 3) -> code indices (N, h*w) int32; optionally np.save."""
    device = model.codebook.device
    out = []
    with torch.inference_mode():
        for start in range(0, len(data), batch_size):
            x = torch.from_numpy(np.ascontiguousarray(data[start : start + batch_size]))
            idx = model.codes(x.to(device, non_blocking=True))
            out.append(idx.reshape(idx.shape[0], -1))
        result = torch.cat(out).cpu().numpy().astype(np.int32)

    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        np.save(out_path, result)
    return result


__all__ = ["extract_latents"]
