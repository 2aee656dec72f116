"""Seeded weights for a list of parameter specifications.

A specification is ``(name, shape, kind, scale)``: ``kind`` "uniform" draws
U(-scale, scale), "normal" N(0, scale^2), "zeros" zeros. All uniform leaves
come from one ``uniform_`` call over a flat buffer and all normal ones from
one ``normal_`` call, on the device of the generator, so that the weights
are made in two launches whatever the number of leaves.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Spec = Tuple[str, Tuple[int, ...], str, float]


def uniform_bound(fan_in: int) -> float:
    """torch's default conv init: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    return 1.0 / math.sqrt(fan_in)


def xavier_bound(shape: Tuple[int, ...]) -> float:
    """xavier-uniform for a conv weight (C_out, C_in, kh, kw)."""
    receptive = math.prod(shape[2:])
    return math.sqrt(6.0 / (shape[1] * receptive + shape[0] * receptive))


def draw(specs: List[Spec], generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """The weights of ``specs`` drawn from ``generator`` on its device, float32."""
    device = generator.device
    out = {}
    for kind in ("uniform", "normal"):
        leaves = [s for s in specs if s[2] == kind]
        total = sum(math.prod(shape) for _, shape, _, _ in leaves)
        flat = torch.empty(total, device=device)
        if kind == "uniform":
            flat.uniform_(-1.0, 1.0, generator=generator)
        else:
            flat.normal_(0.0, 1.0, generator=generator)
        start = 0
        for name, shape, _, scale in leaves:
            n = math.prod(shape)
            out[name] = flat[start:start + n].view(shape).mul_(scale)
            start += n
    for name, shape, kind, _ in specs:
        if kind == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif kind not in ("uniform", "normal"):
            raise ValueError(f"unknown init {kind!r} for {name}")
    return {name: out[name] for name, _, _, _ in specs}
