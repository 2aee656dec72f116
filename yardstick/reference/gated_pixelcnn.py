"""The class-conditional GatedPixelCNN of MishaLaskin/vqvae
(``pixelcnn/models.py``; the loss of ``pixelcnn/gated_pixelcnn.py``), in
plain PyTorch on a dict of parameters named as the program's ``state_dict``.

Layer 0 has mask 'A' (kernel 7, no residual), the others mask 'B' (kernel 3,
residual). The vertical stack's kernel is (k//2 + 1, k) padded (k//2, k//2)
and cropped back to the grid's rows; the horizontal one (1, k//2 + 1) padded
(0, k//2) and cropped to its columns; ``vert_to_horiz`` takes the cropped
vertical pre-activation; the class embedding is added before each gate
tanh(a) * sigmoid(b). Departure: the source zeroes mask A's last row and
column of the kernels in place before every forward, here they are
multiplied by the mask, which computes the same function and gives the
masked entries no gradient.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from yardstick.reference.params import Spec, xavier_bound


def _geometry(i: int):
    return ("A", 7, False) if i == 0 else ("B", 3, True)


def param_specs(cfg: dict) -> List[Spec]:
    d, k_codes, n_classes = cfg["dim"], cfg["input_dim"], cfg["n_classes"]
    specs: List[Spec] = [("embedding", (k_codes, d), "normal", 1.0)]

    def conv(name, shape):
        specs.append((f"{name}_w", shape, "uniform", xavier_bound(shape)))
        specs.append((f"{name}_b", (shape[0],), "zeros", 0.0))

    for i in range(cfg["n_layers"]):
        _, k, _ = _geometry(i)
        pre = f"layer_{i}"
        specs.append((f"{pre}.class_cond_embedding", (n_classes, 2 * d), "normal", 1.0))
        conv(f"{pre}.vert_stack", (2 * d, d, k // 2 + 1, k))
        conv(f"{pre}.vert_to_horiz", (2 * d, 2 * d, 1, 1))
        conv(f"{pre}.horiz_stack", (2 * d, d, 1, k // 2 + 1))
        conv(f"{pre}.horiz_resid", (d, d, 1, 1))
    conv("out1", (512, d, 1, 1))
    conv("out2", (k_codes, 512, 1, 1))
    return specs


def _gate(x: torch.Tensor) -> torch.Tensor:
    a, b = x.chunk(2, dim=1)
    return torch.tanh(a) * torch.sigmoid(b)


def logits(p: Dict[str, torch.Tensor], x: torch.Tensor, label: torch.Tensor, cfg: dict) -> torch.Tensor:
    """Codes (B, H, W) and classes (B,) -> logits (B, K, H, W)."""
    h = p["embedding"][x].permute(0, 3, 1, 2)
    x_v = x_h = h
    for i in range(cfg["n_layers"]):
        mask, k, residual = _geometry(i)
        pre = f"layer_{i}."
        w_v, w_h = p[pre + "vert_stack_w"], p[pre + "horiz_stack_w"]
        if mask == "A":
            vmask = torch.ones_like(w_v)
            vmask[:, :, -1] = 0
            hmask = torch.ones_like(w_h)
            hmask[:, :, :, -1] = 0
            w_v, w_h = w_v * vmask, w_h * hmask
        cls = p[pre + "class_cond_embedding"][label][:, :, None, None]
        h_vert = F.conv2d(x_v, w_v, p[pre + "vert_stack_b"], padding=(k // 2, k // 2))
        h_vert = h_vert[:, :, :x_v.size(-2), :]
        out_v = _gate(h_vert + cls)
        h_horiz = F.conv2d(x_h, w_h, p[pre + "horiz_stack_b"], padding=(0, k // 2))
        h_horiz = h_horiz[:, :, :, :x_h.size(-1)]
        v2h = F.conv2d(h_vert, p[pre + "vert_to_horiz_w"], p[pre + "vert_to_horiz_b"])
        out = _gate(v2h + h_horiz + cls)
        out_h = F.conv2d(out, p[pre + "horiz_resid_w"], p[pre + "horiz_resid_b"])
        x_v, x_h = out_v, (out_h + x_h if residual else out_h)
    out = F.relu(F.conv2d(x_h, p["out1_w"], p["out1_b"]))
    return F.conv2d(out, p["out2_w"], p["out2_b"])


def loss(p: Dict[str, torch.Tensor], batch, cfg: dict) -> torch.Tensor:
    """The mean cross-entropy over every code of the batch."""
    x, label = batch
    out = logits(p, x, label, cfg)
    k = out.shape[1]
    return F.cross_entropy(out.permute(0, 2, 3, 1).reshape(-1, k), x.reshape(-1))
