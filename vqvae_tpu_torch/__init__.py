"""vqvae_tpu_torch — the PyTorch/CUDA port of the vqvae_tpu VQ-VAE engine.

Public functions keep the JAX package's NHWC layout: images (B, 32, 32, 3),
latents (B, h, w, D), codes (B, h, w). Entry points run on the CUDA card
unless the caller passes ``device="cpu"``.
"""

from vqvae_tpu_torch.config import TrainConfig, VQVAEConfig

__all__ = ["TrainConfig", "VQVAEConfig"]
