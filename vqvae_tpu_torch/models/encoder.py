"""Encoder q_theta(z|x) (port of ``vqvae_tpu/models/encoder.py``), NCHW inside.

Conv(3 -> h/2, k4 s2 p1) -> ReLU -> Conv(h/2 -> h, k4 s2 p1) -> ReLU ->
Conv(h -> h, k3 s1 p1) -> ResidualStack. 32x32 input -> 8x8 latent map.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vqvae_tpu_torch.models.initializers import torch_conv_init_
from vqvae_tpu_torch.models.residual import ResidualStack
from vqvae_tpu_torch.ops.conv import conv2d

# (name, C_in, C_out, kernel) of the three convs, the widths as indices into
# (in_dim, h/2, h)
_CONVS = (("conv1", 0, 1, 4), ("conv2", 1, 2, 4), ("conv3", 2, 2, 3))


class Encoder(nn.Module):
    def __init__(
        self,
        in_dim: int,
        h_dim: int,
        n_res_layers: int,
        res_h_dim: int,
        share_residual_weights: bool = False,
        precision: Optional[str] = None,
    ):
        super().__init__()
        self.precision = precision
        widths = (in_dim, h_dim // 2, h_dim)
        self._fan_in = {}
        for name, i, o, k in _CONVS:
            cin, cout = widths[i], widths[o]
            self.register_parameter(f"{name}_w", nn.Parameter(torch.empty(cout, cin, k, k)))
            self.register_parameter(f"{name}_b", nn.Parameter(torch.empty(cout)))
            self._fan_in[name] = cin * k * k
        self.res_stack = ResidualStack(
            h_dim, h_dim, res_h_dim, n_res_layers,
            share_weights=share_residual_weights, precision=precision,
        )

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for name, fan_in in self._fan_in.items():
            torch_conv_init_(getattr(self, f"{name}_w"), fan_in, generator)
            torch_conv_init_(getattr(self, f"{name}_b"), fan_in, generator)

    def forward(self, x):
        p = self.precision
        x = F.relu(conv2d(x, self.conv1_w, self.conv1_b, stride=2, padding=1, precision=p))
        x = F.relu(conv2d(x, self.conv2_w, self.conv2_b, stride=2, padding=1, precision=p))
        x = conv2d(x, self.conv3_w, self.conv3_b, stride=1, padding=1, precision=p)
        return self.res_stack(x)


__all__ = ["Encoder"]
