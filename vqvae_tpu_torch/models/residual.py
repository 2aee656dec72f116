"""Residual blocks (port of ``vqvae_tpu/models/residual.py``), NCHW inside.

The reference layer writes ``x + res_block(x)`` with an INPLACE first ReLU,
which mutates ``x`` before the addition, so the function it computes is

    relu(x) + Conv1x1(ReLU(Conv3x3(relu(x))))

and every trained reference checkpoint encodes that; it is reproduced here.
The stack applies ``n`` layers, then a final ReLU. ``share_weights=True``
reproduces the reference's aliasing of one layer across the whole stack
(reference models/residual.py:44-45).

Parameter names follow the JAX tree (``layer_{i}.conv3x3``; shared:
``ResidualLayer_0.conv3x3``), so ``params_from_jax`` maps names one to one.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vqvae_tpu_torch.models.initializers import torch_conv_init_
from vqvae_tpu_torch.ops.conv import conv2d


class ResidualLayer(nn.Module):
    def __init__(self, in_dim: int, h_dim: int, res_h_dim: int, precision: Optional[str] = None):
        super().__init__()
        self.in_dim, self.res_h_dim = in_dim, res_h_dim
        self.precision = precision
        self.conv3x3 = nn.Parameter(torch.empty(res_h_dim, in_dim, 3, 3))
        self.conv1x1 = nn.Parameter(torch.empty(h_dim, res_h_dim, 1, 1))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        torch_conv_init_(self.conv3x3, self.in_dim * 3 * 3, generator)
        torch_conv_init_(self.conv1x1, self.res_h_dim, generator)

    def forward(self, x):
        xr = F.relu(x)  # the reference's inplace ReLU: the skip carries relu(x)
        h = conv2d(xr, self.conv3x3, stride=1, padding=1, precision=self.precision)
        h = conv2d(F.relu(h), self.conv1x1, stride=1, padding=0, precision=self.precision)
        return xr + h


class ResidualStack(nn.Module):
    def __init__(
        self,
        in_dim: int,
        h_dim: int,
        res_h_dim: int,
        n_res_layers: int,
        share_weights: bool = False,
        precision: Optional[str] = None,
    ):
        super().__init__()
        self.n_res_layers = n_res_layers
        self.share_weights = share_weights
        n_modules = 1 if share_weights else n_res_layers
        prefix = "ResidualLayer_" if share_weights else "layer_"
        for i in range(n_modules):
            self.add_module(f"{prefix}{i}", ResidualLayer(in_dim, h_dim, res_h_dim, precision))

    def _layers(self):
        if self.share_weights:
            return [self.ResidualLayer_0] * self.n_res_layers
        return list(self.children())

    def forward(self, x):
        for layer in self._layers():
            x = layer(x)
        return F.relu(x)


__all__ = ["ResidualLayer", "ResidualStack"]
