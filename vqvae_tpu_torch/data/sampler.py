"""Batch samplers of the trainers (port of ``vqvae_tpu/data/sampler.py``):
``ReplacementSampler`` for the VQ-VAE, ``EpochSampler`` for the prior.

The same numpy draws in the same order as the JAX package's samplers, so both
packages' trainers see the same batches from the same seed, and a resumed run
can replay the schedule. With shards, every shard derives the same global
batch from the shared stream and takes a contiguous slice of it.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


def _shard_slice(batch: np.ndarray, num_shards: int, shard_id: int) -> np.ndarray:
    if num_shards <= 1:
        return batch
    if len(batch) % num_shards != 0:
        raise ValueError(
            f"global batch {len(batch)} not divisible by num_shards {num_shards}"
        )
    per = len(batch) // num_shards
    return batch[shard_id * per : (shard_id + 1) * per]


class ReplacementSampler:
    """Fresh independent draw per step.

    The reference calls ``next(iter(training_loader))`` every update
    (main.py:70) with shuffle=True: each step takes the first batch of a new
    shuffle, so batches are independent across steps and hold no duplicates
    within. Reproduced with ``choice(replace=False)`` per step.
    """

    def __init__(
        self,
        n: int,
        batch_size: int,
        seed: int = 0,
        num_shards: int = 1,
        shard_id: int = 0,
    ):
        if batch_size > n:
            raise ValueError(f"batch_size {batch_size} > dataset size {n}")
        self.n = int(n)
        self.batch_size = int(batch_size)
        self.num_shards = int(num_shards)
        self.shard_id = int(shard_id)
        self._rng = np.random.default_rng(seed)

    def next_indices(self) -> np.ndarray:
        """This shard's slice of the next global batch (advances the shared
        stream identically on every shard)."""
        batch = self._rng.choice(self.n, size=self.batch_size, replace=False)
        return _shard_slice(batch, self.num_shards, self.shard_id)


class EpochSampler:
    """Epoch traversal with optional shuffle and drop_last, the torch
    DataLoader semantics of the prior's loop (reference gated_pixelcnn.py:80,
    utils.py:61-71). Each ``epoch()`` takes a fresh permutation from the
    shared stream, as a DataLoader re-iterated every epoch reshuffles.
    """

    def __init__(
        self,
        n: int,
        batch_size: int,
        seed: int = 0,
        shuffle: bool = True,
        drop_last: bool = False,
        num_shards: int = 1,
        shard_id: int = 0,
    ):
        self.n = int(n)
        self.batch_size = int(batch_size)
        self.shuffle = bool(shuffle)
        self.drop_last = bool(drop_last)
        self.num_shards = int(num_shards)
        self.shard_id = int(shard_id)
        self._rng = np.random.default_rng(seed)

    def epoch(self) -> Iterator[np.ndarray]:
        """This shard's slice of each batch of one pass over the data."""
        order = self._rng.permutation(self.n) if self.shuffle else np.arange(self.n, dtype=np.int64)
        b = self.batch_size
        end = (self.n // b) * b if self.drop_last else self.n
        for start in range(0, end, b):
            yield _shard_slice(order[start:start + b], self.num_shards, self.shard_id)


__all__ = ["EpochSampler", "ReplacementSampler"]
