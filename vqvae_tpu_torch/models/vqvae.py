"""Composite VQ-VAE (port of ``vqvae_tpu/models/vqvae.py``).

Encoder -> 1x1 pre-quantization conv -> VQ bottleneck (the hand-written CUDA
nearest-code kernel on the card) -> Decoder. ``forward`` returns
(embedding_loss, x_hat, perplexity) like the JAX ``__call__``. Public methods
take and return NHWC tensors, as the JAX model does; the conv stacks run NCHW
and convert only here, at the boundary.

Dtype handling follows the JAX model exactly: ``encode`` casts x to
``compute_dtype`` and returns fp32; ``decode`` casts z_q to ``compute_dtype``
and returns fp32; ``decode_codes`` does not cast (JAX vqvae.py:101-104), so
it runs the decoder on the fp32 codebook rows.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import torch
from torch import nn

from vqvae_tpu_torch.config import VQVAEConfig
from vqvae_tpu_torch.models.decoder import Decoder
from vqvae_tpu_torch.models.encoder import Encoder
from vqvae_tpu_torch.models.initializers import codebook_init_, torch_conv_init_
from vqvae_tpu_torch.ops.conv import conv2d
from vqvae_tpu_torch.ops.quantizer import QuantizeOutput, nearest_code, quantize


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1).contiguous()


class VQVAE(nn.Module):
    def __init__(self, config: VQVAEConfig = VQVAEConfig()):
        super().__init__()
        cfg = self.config = config
        self.encoder = Encoder(
            cfg.in_channels, cfg.n_hiddens, cfg.n_residual_layers, cfg.n_residual_hiddens,
            share_residual_weights=cfg.share_residual_weights, precision=cfg.conv_precision,
        )
        self.pre_quant_w = nn.Parameter(torch.empty(cfg.embedding_dim, cfg.n_hiddens, 1, 1))
        self.pre_quant_b = nn.Parameter(torch.empty(cfg.embedding_dim))
        self.codebook = nn.Parameter(torch.empty(cfg.n_embeddings, cfg.embedding_dim))
        self.decoder = Decoder(
            cfg.embedding_dim, cfg.n_hiddens, cfg.n_residual_layers, cfg.n_residual_hiddens,
            share_residual_weights=cfg.share_residual_weights, precision=cfg.conv_precision,
        )
        self.compute_dtype = (
            torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
        )

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Fresh torch-default init (weights loaded from a checkpoint skip this)."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)
        torch_conv_init_(self.pre_quant_w, self.config.n_hiddens, generator)
        torch_conv_init_(self.pre_quant_b, self.config.n_hiddens, generator)
        codebook_init_(self.codebook, self.config.n_embeddings, generator)

    def encode(self, x) -> torch.Tensor:
        """x (B, H, W, 3) -> continuous latents z_e (B, h, w, D), fp32."""
        z_e = self.encoder(_nchw(x.to(self.compute_dtype)))
        z_e = conv2d(z_e, self.pre_quant_w, self.pre_quant_b, precision=self.config.conv_precision)
        return _nhwc(z_e).float()

    def quantize(self, z_e) -> QuantizeOutput:
        cfg = self.config
        return quantize(
            z_e, self.codebook, cfg.beta, ema=cfg.ema_codebook,
            precision=cfg.quantizer_precision, search=partial(nearest_code, impl=cfg.quantizer_impl),
        )

    def codes(self, x) -> torch.Tensor:
        """x -> discrete code indices (B, h, w) int32 (latent extraction)."""
        return self.quantize(self.encode(x)).indices

    def decode(self, z_q) -> torch.Tensor:
        """z_q (B, h, w, D) -> images (B, H, W, 3), fp32."""
        return _nhwc(self.decoder(_nchw(z_q.to(self.compute_dtype)))).float()

    def decode_codes(self, indices) -> torch.Tensor:
        """(B, h, w) code grid -> decoded images (sampling pipeline); no cast."""
        z_q = self.codebook.index_select(0, indices.reshape(-1).long())
        z_q = z_q.reshape(*indices.shape, self.config.embedding_dim)
        return _nhwc(self.decoder(_nchw(z_q)))

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        q = self.quantize(self.encode(x))
        return q.loss, self.decode(q.z_q), q.perplexity


__all__ = ["VQVAE"]
