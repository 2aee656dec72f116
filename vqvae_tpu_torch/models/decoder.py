"""Decoder p_phi(x|z) (port of ``vqvae_tpu/models/decoder.py``), NCHW inside.

ConvT(e_dim -> h, k3 s1 p1) -> ResidualStack -> ConvT(h -> h/2, k4 s2 p1) ->
ReLU -> ConvT(h/2 -> 3, k4 s2 p1). No output activation. Transposed-conv
weights are stored (C_in, C_out, kh, kw), torch's layout, and torch's default
init counts fan_in = C_out * kh * kw for them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vqvae_tpu_torch.models.initializers import torch_conv_init_
from vqvae_tpu_torch.models.residual import ResidualStack
from vqvae_tpu_torch.ops.conv import conv_transpose2d

# (name, C_in, C_out, kernel) of the three transposed convs, as indices into
# the widths (in_dim, h, h/2, 3)
_CONVTS = (("convt1", 0, 1, 3), ("convt2", 1, 2, 4), ("convt3", 2, 3, 4))


class Decoder(nn.Module):
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
        widths = (in_dim, h_dim, h_dim // 2, 3)
        self._fan_in = {}
        for name, i, o, k in _CONVTS:
            cin, cout = widths[i], widths[o]
            self.register_parameter(f"{name}_w", nn.Parameter(torch.empty(cin, cout, k, k)))
            self.register_parameter(f"{name}_b", nn.Parameter(torch.empty(cout)))
            self._fan_in[name] = cout * k * k
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
        x = conv_transpose2d(x, self.convt1_w, self.convt1_b, stride=1, padding=1, precision=p)
        x = self.res_stack(x)
        x = F.relu(
            conv_transpose2d(x, self.convt2_w, self.convt2_b, stride=2, padding=1, precision=p)
        )
        return conv_transpose2d(x, self.convt3_w, self.convt3_b, stride=2, padding=1, precision=p)


__all__ = ["Decoder"]
