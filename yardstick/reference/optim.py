"""The two optimizers, written out per leaf.

``amsgrad``: ``torch.optim.Adam(amsgrad=True)`` of torch 1.1.0, the VQ-VAE
source's optimizer (the raw second moment's running maximum, eps added after
the square root, bias corrections folded into the step size). ``adam``:
``torch.optim.Adam`` of torch 2.x, the prior's. ``b1``, ``b2`` and ``eps``
are the configuration's: its model file's ``optimizer`` gives them.
"""

from __future__ import annotations

import math
from typing import Dict

import torch


def init_state(params: Dict[str, torch.Tensor]) -> dict:
    return {"t": 0, **{key: {n: torch.zeros_like(p) for n, p in params.items()}
                       for key in ("m", "v", "v_max")}}


@torch.no_grad()
def step(kind: str, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor], state: dict,
         lr: float, b1: float, b2: float, eps: float) -> None:
    state["t"] += 1
    t = state["t"]
    bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
    for name, p in params.items():
        g = grads[name] if grads[name] is not None else torch.zeros_like(p)
        m, v = state["m"][name], state["v"][name]
        m.mul_(b1).add_(g, alpha=1.0 - b1)
        v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
        if kind == "amsgrad":
            v_max = state["v_max"][name]
            torch.maximum(v_max, v, out=v_max)
            p.addcdiv_(m, v_max.sqrt().add_(eps), value=-lr * math.sqrt(bc2) / bc1)
        elif kind == "adam":
            p.addcdiv_(m, (v.sqrt() / math.sqrt(bc2)).add_(eps), value=-lr / bc1)
        else:
            raise ValueError(f"unknown optimizer {kind!r}")
