"""End-to-end sampling (port of ``vqvae_tpu/pipelines/sample.py``): prior draw
of code grids -> codebook lookup -> decoder images.

The draws come from the cached decoder (models/pixelcnn_sampler.py) and an
explicit ``torch.Generator``; the JAX package's ``jax.random`` stream cannot
be reproduced, so the two packages draw different grids from one seed. Also
the notebook's two diagnostic latent samplers (cells 10-12): uniform codes
and codes drawn from the histogram of seen codes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from vqvae_tpu_torch.models.pixelcnn import GatedPixelCNN
from vqvae_tpu_torch.models.pixelcnn_sampler import CachedPixelCNNSampler
from vqvae_tpu_torch.models.vqvae import VQVAE


def decode_code_grids(model: VQVAE, indices) -> np.ndarray:
    """(B, h, w) integer code grids -> (B, 32, 32, 3) fp32 images, through
    ``VQVAE.decode_codes`` (no cast to the compute dtype, as in JAX)."""
    with torch.inference_mode():
        idx = torch.as_tensor(np.asarray(indices), device=model.codebook.device)
        return model.decode_codes(idx).cpu().numpy()


def sample_images(
    vq_model: VQVAE,
    prior: GatedPixelCNN,
    labels,
    generator: Optional[torch.Generator] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """One wave of len(labels) grids -> (images (B, 32, 32, 3), codes (B, h, w) int32)."""
    side = prior.config.img_dim
    labels = torch.as_tensor(np.asarray(labels), device=prior.embedding.device)
    with torch.inference_mode():
        codes = CachedPixelCNNSampler(prior).generate(
            labels, generator, (side, side), labels.shape[0]).cpu().numpy()
    return decode_code_grids(vq_model, codes), codes


def sample_uniform_codes(
    n_embeddings: int, batch: int, grid: Tuple[int, int], generator: torch.Generator
) -> np.ndarray:
    """Uniform code grids (notebook cell 10, the 'scrambled' oracle)."""
    return torch.randint(0, n_embeddings, (batch, *grid), generator=generator,
                         device=generator.device, dtype=torch.int32).cpu().numpy()


def sample_histogram_codes(
    seen_indices: np.ndarray, batch: int, grid: Tuple[int, int], generator: torch.Generator
) -> np.ndarray:
    """Codes drawn from the empirical histogram of seen codes (notebook cells 11-12)."""
    flat = np.asarray(seen_indices).reshape(-1)
    counts = np.bincount(flat, minlength=int(flat.max()) + 1).astype(np.float64)
    probs = torch.from_numpy(counts / counts.sum()).to(generator.device)
    draws = torch.multinomial(probs, batch * int(np.prod(grid)), replacement=True, generator=generator)
    return draws.reshape(batch, *grid).to(torch.int32).cpu().numpy()


__all__ = ["decode_code_grids", "sample_histogram_codes", "sample_images", "sample_uniform_codes"]
