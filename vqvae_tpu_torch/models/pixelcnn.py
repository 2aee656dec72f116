"""Class-conditional GatedPixelCNN prior (port of ``vqvae_tpu/models/pixelcnn.py``).

The reference's architecture (pixelcnn/models.py:30-143), as the JAX package
has it:

- dual vertical/horizontal gated conv stacks with a class-conditional bias:
  vertical kernel (k//2+1, k) padded (k//2, k//2) and cropped back to H rows,
  horizontal kernel (1, k//2+1) padded (0, k//2) and cropped to W columns;
  ``vert_to_horiz`` (1x1) takes the cropped vertical pre-activation, before
  the class bias and the gate;
- layer 0 mask 'A' (kernel 7, not residual), the rest mask 'B' (kernel 3,
  residual);
- head Conv1x1(dim -> 512) -> ReLU -> Conv1x1(512 -> input_dim);
- xavier-uniform conv weights, zero biases, N(0, 1) embeddings.

Mask A is a multiplicative kernel mask applied in ``forward`` (zero the
vertical kernel's last row and the horizontal kernel's last column), never a
mutation of the weights. Parameters carry the JAX names (``embedding``,
``layer_{i}.vert_stack_w``, ``out1_w`` ...) with conv kernels in torch's
(C_out, C_in, kh, kw) layout, so ``params_from_jax`` of a JAX prior loads
with ``load_state_dict(strict=True)``. The conv stacks run NCHW; ``forward``
takes and returns the JAX model's layouts: (B, H, W) codes in, (B, H, W, K)
fp32 logits out.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vqvae_tpu_torch.config import PixelCNNConfig
from vqvae_tpu_torch.ops.conv import conv2d
from vqvae_tpu_torch.ops.scatter import gather_rows


def layer_geometry(i: int) -> Tuple[str, int, bool]:
    """(mask type, kernel, residual) of layer ``i`` (reference models.py:100-107)."""
    return ("A", 7, False) if i == 0 else ("B", 3, True)


def gate(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """tanh(a) * sigmoid(b) over the two halves of ``dim``."""
    a, b = x.chunk(2, dim=dim)
    return torch.tanh(a) * torch.sigmoid(b)


def draw_codes(logits: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """One categorical draw per row of (B, K) logits, by Gumbel-max: the
    argmax of logits - log(-log(u)), u ~ U[0, 1) of shape (B, K) from
    ``generator``. Both port samplers draw through here, so one seed gives
    both the same grids."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device, dtype=torch.float32)
    return (logits - u.log_().neg_().log_()).argmax(-1)


class GatedMaskedConv2d(nn.Module):
    def __init__(self, mask_type: str, dim: int, kernel: int, residual: bool = True,
                 n_classes: int = 10, precision: Optional[str] = None):
        super().__init__()
        if kernel % 2 != 1:
            raise ValueError("kernel size must be odd")
        d, k = dim, kernel
        self.kernel, self.residual, self.precision = kernel, residual, precision
        self.class_cond_embedding = nn.Parameter(torch.empty(n_classes, 2 * d))
        self.vert_stack_w = nn.Parameter(torch.empty(2 * d, d, k // 2 + 1, k))
        self.vert_stack_b = nn.Parameter(torch.empty(2 * d))
        self.vert_to_horiz_w = nn.Parameter(torch.empty(2 * d, 2 * d, 1, 1))
        self.vert_to_horiz_b = nn.Parameter(torch.empty(2 * d))
        self.horiz_stack_w = nn.Parameter(torch.empty(2 * d, d, 1, k // 2 + 1))
        self.horiz_stack_b = nn.Parameter(torch.empty(2 * d))
        self.horiz_resid_w = nn.Parameter(torch.empty(d, d, 1, 1))
        self.horiz_resid_b = nn.Parameter(torch.empty(d))
        vmask = torch.ones(1, 1, k // 2 + 1, 1)
        hmask = torch.ones(1, 1, 1, k // 2 + 1)
        if mask_type == "A":  # the kernel positions that cover the current pixel
            vmask[:, :, -1] = 0.0
            hmask[..., -1] = 0.0
        self.register_buffer("vert_mask", vmask, persistent=False)
        self.register_buffer("horiz_mask", hmask, persistent=False)

    def masked_kernels(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(vertical, horizontal) kernels with the causal mask applied."""
        return self.vert_stack_w * self.vert_mask, self.horiz_stack_w * self.horiz_mask

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for name, p in self.named_parameters(recurse=False):
            if name == "class_cond_embedding":
                nn.init.normal_(p, generator=generator)
            elif name.endswith("_w"):
                nn.init.xavier_uniform_(p, generator=generator)
            else:
                nn.init.zeros_(p)

    def forward(self, x_v, x_h, label):
        """x_v, x_h: (B, dim, H, W); label: (B,) -> (out_v, out_h), same shapes."""
        k, p = self.kernel, self.precision
        w_vert, w_horiz = self.masked_kernels()
        h_cls = self.class_cond_embedding[label].to(x_v.dtype)[:, :, None, None]
        hgt, wid = x_v.shape[2], x_h.shape[3]
        h_vert = conv2d(x_v, w_vert, self.vert_stack_b, padding=(k // 2, k // 2),
                        precision=p, keep=(hgt, None))
        out_v = gate(h_vert + h_cls)
        h_horiz = conv2d(x_h, w_horiz, self.horiz_stack_b, padding=(0, k // 2),
                         precision=p, keep=(None, wid))
        v2h = conv2d(h_vert, self.vert_to_horiz_w, self.vert_to_horiz_b, precision=p)
        out = gate(v2h + h_horiz + h_cls)
        out_h = conv2d(out, self.horiz_resid_w, self.horiz_resid_b, precision=p)
        if self.residual:
            out_h = out_h + x_h
        return out_v, out_h


class GatedPixelCNN(nn.Module):
    def __init__(self, config: PixelCNNConfig = PixelCNNConfig()):
        super().__init__()
        cfg = self.config = config
        self.embedding = nn.Parameter(torch.empty(cfg.input_dim, cfg.dim))
        for i in range(cfg.n_layers):
            mask_type, kernel, residual = layer_geometry(i)
            self.add_module(f"layer_{i}", GatedMaskedConv2d(
                mask_type, cfg.dim, kernel, residual, cfg.n_classes, precision=cfg.conv_precision))
        self.out1_w = nn.Parameter(torch.empty(512, cfg.dim, 1, 1))
        self.out1_b = nn.Parameter(torch.empty(512))
        self.out2_w = nn.Parameter(torch.empty(cfg.input_dim, 512, 1, 1))
        self.out2_b = nn.Parameter(torch.empty(cfg.input_dim))
        self.compute_dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32

    def layers(self):
        return [getattr(self, f"layer_{i}") for i in range(self.config.n_layers)]

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """A fresh init (reference pixelcnn/models.py:10-17); a checkpoint's
        weights skip this. The numbers are torch's, not the JAX package's."""
        nn.init.normal_(self.embedding, generator=generator)
        for layer in self.layers():
            layer.reset_parameters(generator)
        for w, b in ((self.out1_w, self.out1_b), (self.out2_w, self.out2_b)):
            nn.init.xavier_uniform_(w, generator=generator)
            nn.init.zeros_(b)

    def forward(self, x: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W) integer codes; label: (B,) classes -> (B, H, W, input_dim) fp32 logits."""
        cfg = self.config
        h = gather_rows(self.embedding, x.long()).to(self.compute_dtype).permute(0, 3, 1, 2)
        x_v = x_h = h
        label = label.long()
        for layer in self.layers():
            x_v, x_h = layer(x_v, x_h, label)
        out = F.relu(conv2d(x_h, self.out1_w, self.out1_b, precision=cfg.conv_precision))
        logits = conv2d(out, self.out2_w, self.out2_b, precision=cfg.conv_precision)
        return logits.permute(0, 2, 3, 1).float()

    @torch.no_grad()
    def generate(self, label: torch.Tensor, generator: Optional[torch.Generator],
                 shape: Tuple[int, int] = (8, 8), batch_size: int = 64) -> torch.Tensor:
        """Autoregressive sampling with one full forward per pixel (reference
        semantics, pixelcnn/models.py:129-143): the oracle of the cached
        sampler, not a serving path. One (B, K) draw per pixel in raster
        order (``draw_codes``). -> (B, H, W) int32 codes."""
        hgt, wid = shape
        dev = self.embedding.device
        label = torch.as_tensor(label, device=dev).long()
        x = torch.zeros((batch_size, hgt, wid), dtype=torch.long, device=dev)
        for i in range(hgt):
            for j in range(wid):
                x[:, i, j] = draw_codes(self(x, label)[:, i, j], generator)
        return x.to(torch.int32)


__all__ = ["GatedMaskedConv2d", "GatedPixelCNN", "draw_codes", "gate", "layer_geometry"]
