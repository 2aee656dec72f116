"""Weight initializers of a fresh model (port of ``vqvae_tpu/models/initializers.py``).

The reference relies on torch's Conv2d/ConvTranspose2d defaults, which reduce
to U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weights and biases, and on
U(-1/n_e, 1/n_e) for the codebook (reference models/quantizer.py:26-27).
Parity tests copy weights from the JAX model instead of re-initialising: the
two frameworks draw different numbers from the same seed.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


@torch.no_grad()
def torch_conv_init_(t: torch.Tensor, fan_in: int, generator: Optional[torch.Generator] = None):
    """torch's default conv weight/bias init, in place: U(-b, b), b = 1/sqrt(fan_in)."""
    bound = 1.0 / math.sqrt(fan_in)
    return t.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def codebook_init_(t: torch.Tensor, n_embeddings: int, generator: Optional[torch.Generator] = None):
    """Codebook init U(-1/n_e, 1/n_e), in place (reference models/quantizer.py:27)."""
    bound = 1.0 / n_embeddings
    return t.uniform_(-bound, bound, generator=generator)


__all__ = ["torch_conv_init_", "codebook_init_"]
