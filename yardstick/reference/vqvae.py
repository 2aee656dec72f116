"""The VQ-VAE of MishaLaskin/vqvae (``models/encoder.py``, ``decoder.py``,
``residual.py``, ``quantizer.py``, ``vqvae.py``; ``main.py`` for the loss),
in plain PyTorch on a dict of parameters named as the program's
``state_dict``, NHWC images in and out.

The residual layer's first ReLU is in place in the source, so the skip
carries relu(x): ``relu(x) + conv1x1(relu(conv3x3(relu(x))))``. The
quantizer is the source's: squared distances, ``argmin``, a one-hot matmul
for z_q, the two-term loss and the straight-through estimator. Departure:
``share_residual_weights=False`` gives each residual layer its own weights
where the source repeats one layer object (the configuration says so).
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from yardstick.reference.params import Spec, uniform_bound


def _res_names(prefix: str, cfg: dict) -> List[str]:
    if cfg["share_residual_weights"]:
        return [f"{prefix}.res_stack.ResidualLayer_0"] * cfg["n_residual_layers"]
    return [f"{prefix}.res_stack.layer_{i}" for i in range(cfg["n_residual_layers"])]


def param_specs(cfg: dict) -> List[Spec]:
    """(name, shape, init, scale) of every leaf, torch's default init."""
    c, h, r, d, k = (cfg["in_channels"], cfg["n_hiddens"], cfg["n_residual_hiddens"],
                     cfg["embedding_dim"], cfg["n_embeddings"])
    specs: List[Spec] = []

    def conv(name, shape, bias=True):
        bound = uniform_bound(shape[1] * shape[2] * shape[3])
        specs.append((f"{name}_w" if bias else name, shape, "uniform", bound))
        if bias:
            out = shape[0] if not name.split(".")[-1].startswith("convt") else shape[1]
            specs.append((f"{name}_b", (out,), "uniform", bound))

    def res_stack(prefix):
        for name in dict.fromkeys(_res_names(prefix, cfg)):
            conv(f"{name}.conv3x3", (r, h, 3, 3), bias=False)
            conv(f"{name}.conv1x1", (h, r, 1, 1), bias=False)

    conv("encoder.conv1", (h // 2, c, 4, 4))
    conv("encoder.conv2", (h, h // 2, 4, 4))
    conv("encoder.conv3", (h, h, 3, 3))
    res_stack("encoder")
    conv("pre_quant", (d, h, 1, 1))
    specs.append(("codebook", (k, d), "uniform", 1.0 / k))
    # transposed convs hold (C_in, C_out, kh, kw); torch's fan_in is C_out * kh * kw
    conv("decoder.convt1", (d, h, 3, 3))
    res_stack("decoder")
    conv("decoder.convt2", (h, h // 2, 4, 4))
    conv("decoder.convt3", (h // 2, c, 4, 4))
    return specs


def _res_stack(p: Dict[str, torch.Tensor], prefix: str, x: torch.Tensor, cfg: dict):
    for name in _res_names(prefix, cfg):
        xr = F.relu(x)
        hidden = F.conv2d(F.relu(F.conv2d(xr, p[f"{name}.conv3x3"], padding=1)), p[f"{name}.conv1x1"])
        x = xr + hidden
    return F.relu(x)


def encode(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: dict) -> torch.Tensor:
    """Images (B, H, W, C) -> z_e (B, h, w, D)."""
    x = x.permute(0, 3, 1, 2)
    x = F.relu(F.conv2d(x, p["encoder.conv1_w"], p["encoder.conv1_b"], stride=2, padding=1))
    x = F.relu(F.conv2d(x, p["encoder.conv2_w"], p["encoder.conv2_b"], stride=2, padding=1))
    x = F.conv2d(x, p["encoder.conv3_w"], p["encoder.conv3_b"], padding=1)
    x = _res_stack(p, "encoder", x, cfg)
    z = F.conv2d(x, p["pre_quant_w"], p["pre_quant_b"])
    return z.permute(0, 2, 3, 1)


def distances(z_flat: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """(N, K) squared distances, the source's formula."""
    return (torch.sum(z_flat ** 2, dim=1, keepdim=True) + torch.sum(codebook ** 2, dim=1)
            - 2 * torch.matmul(z_flat, codebook.t()))


def codes(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: dict) -> torch.Tensor:
    """Images -> (B, h * w) code indices (int64)."""
    z = encode(p, x, cfg)
    idx = torch.argmin(distances(z.reshape(-1, z.shape[-1]), p["codebook"]), dim=1)
    return idx.view(z.shape[0], -1)


def decode(p: Dict[str, torch.Tensor], z_q: torch.Tensor, cfg: dict) -> torch.Tensor:
    x = z_q.permute(0, 3, 1, 2)
    x = F.conv_transpose2d(x, p["decoder.convt1_w"], p["decoder.convt1_b"], stride=1, padding=1)
    x = _res_stack(p, "decoder", x, cfg)
    x = F.relu(F.conv_transpose2d(x, p["decoder.convt2_w"], p["decoder.convt2_b"], stride=2, padding=1))
    x = F.conv_transpose2d(x, p["decoder.convt3_w"], p["decoder.convt3_b"], stride=2, padding=1)
    return x.permute(0, 2, 3, 1)


def loss(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: dict, x_train_var: float) -> torch.Tensor:
    """main.py's training loss: recon / x_train_var + the quantizer's loss."""
    z = encode(p, x, cfg)
    z_flat = z.reshape(-1, z.shape[-1])
    idx = torch.argmin(distances(z_flat, p["codebook"]), dim=1)
    one_hot = torch.zeros(z_flat.shape[0], p["codebook"].shape[0], device=z.device)
    one_hot.scatter_(1, idx[:, None], 1)
    z_q = torch.matmul(one_hot, p["codebook"]).view(z.shape)
    emb_loss = torch.mean((z_q.detach() - z) ** 2) + cfg["beta"] * torch.mean((z_q - z.detach()) ** 2)
    z_q = z + (z_q - z).detach()
    x_hat = decode(p, z_q, cfg)
    return torch.mean((x_hat - x) ** 2) / x_train_var + emb_loss
