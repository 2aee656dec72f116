"""The benchmark's inputs, all made from ``--seed``: weights, data and the
order in which training visits the data.

Weights and data are drawn on the card by ``torch.Generator``s in a few
large calls; the training order is a fresh permutation of the set for each
epoch, drawn on the host, cut into batches (the last, short one dropped).
One seed gives the same inputs in every run, and every seed the same sizes.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from yardstick.reference.params import Spec, draw

# independent streams of one seed
_WEIGHTS, _DATA, _ORDER = 1, 2, 3


def stream(seed: int, which: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 4 + which) % 2**64)
    return gen


def weights(specs: List[Spec], seed: int, device) -> Dict[str, torch.Tensor]:
    return draw(specs, stream(seed, _WEIGHTS, device))


def images(n: int, seed: int, device, side: int = 32) -> Tuple[torch.Tensor, float]:
    """CIFAR-10-shaped images: 8x8 colour fields drawn from U{48..207},
    upsampled 4x, smoothed by one tap down and across, plus N(0, 12^2) noise,
    clipped and truncated to 8 bits, then scaled to [-1, 1] as the
    reference's Normalize(0.5, 0.5). Returns the (n, side, side, 3) float32
    images and the reference's x_train_var, the variance of the 8-bit values
    over 255."""
    gen = stream(seed, _DATA, device)
    cell = side // 8
    base = torch.randint(48, 208, (n, 8, 8, 3), generator=gen, device=device).float()
    up = base.repeat_interleave(cell, 1).repeat_interleave(cell, 2)
    up[:, 1:] = 0.5 * (up[:, 1:] + up[:, :-1])
    up[:, :, 1:] = 0.5 * (up[:, :, 1:] + up[:, :, :-1])
    up += 12.0 * torch.randn(up.shape, generator=gen, device=device)
    u8 = up.clamp_(0, 255).floor_()
    x_train_var = float(u8.double().div(255).var(unbiased=False))
    return u8.mul_(2.0 / 255).sub_(1.0), x_train_var


def code_grids(n: int, side: int, n_codes: int, n_classes: int, seed: int,
               device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n, side, side) codes drawn uniformly from the codebook and (n,) class
    labels, int32, as the latent grids ``extract-latents`` writes."""
    gen = stream(seed, _DATA, device)
    codes = torch.randint(0, n_codes, (n, side, side), generator=gen, device=device, dtype=torch.int32)
    labels = torch.randint(0, n_classes, (n,), generator=gen, device=device, dtype=torch.int32)
    return codes, labels


class EpochOrder:
    """Batches of row indices: each epoch a fresh permutation of ``n`` rows
    cut into batches of ``batch`` (the short tail dropped), so the rows of
    one epoch all differ."""

    def __init__(self, n: int, batch: int, seed: int):
        if batch > n:
            raise ValueError(f"batch {batch} exceeds the {n} rows of the set")
        self.n, self.batch = n, batch
        self._gen = stream(seed, _ORDER, "cpu")
        self._pending = np.empty((0, batch), np.int64)

    def take(self, k: int) -> np.ndarray:
        """The next ``k`` batches, (k, batch) int64."""
        while len(self._pending) < k:
            perm = torch.randperm(self.n, generator=self._gen).numpy()
            whole = (self.n // self.batch) * self.batch
            self._pending = np.concatenate([self._pending, perm[:whole].reshape(-1, self.batch)])
        out, self._pending = self._pending[:k], self._pending[k:]
        return out
