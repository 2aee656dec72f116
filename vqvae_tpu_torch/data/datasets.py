"""In-memory datasets (port of ``vqvae_tpu/data/datasets.py``, numpy only).

``load_dataset`` returns ``(train, val, x_train_var, info)`` with images as
float32 NHWC in [-1, 1] (the reference's ToTensor + Normalize(0.5, 0.5),
utils.py:14-16) and ``x_train_var`` the reference's ``np.var(train / 255)``
on the pre-normalization pixels. CIFAR-10 reads the python-pickle batches
under ``<root>/cifar-10-batches-py`` when present; otherwise it generates the
same deterministic synthetic set as the JAX package, bit for bit.
LATENT_BLOCK is the code grids ``extract-latents`` writes, the prior's
training data. BLOCK is not ported yet.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Tuple

import numpy as np


class ArrayDataset:
    """A dataset is just arrays: ``data`` (N, ...) and int ``labels`` (N,)."""

    def __init__(self, data: np.ndarray, labels: np.ndarray):
        if len(data) != len(labels):
            raise ValueError(f"{len(data)} items but {len(labels)} labels")
        self.data = data
        self.labels = labels

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, index):
        return self.data[index], self.labels[index]


def _normalize_images(raw: np.ndarray) -> np.ndarray:
    """uint8 [0, 255] -> float32 [-1, 1]."""
    return (np.asarray(raw, np.float32) / 255.0) * 2.0 - 1.0


_CIFAR_DIR = "cifar-10-batches-py"
_SYNTH_N_TRAIN = 10000
_SYNTH_N_VAL = 2000


def _load_cifar_pickles(batch_dir: str):
    """Parse the standard CIFAR-10 python pickles -> (train u8 NHWC, train
    labels, val u8 NHWC, val labels). The pickles are the dataset's own
    published files, read from the user's data directory."""

    def read(name):
        with open(os.path.join(batch_dir, name), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        x = np.asarray(d[b"data"], np.uint8).reshape(-1, 3, 32, 32)
        return x.transpose(0, 2, 3, 1), np.asarray(d[b"labels"], np.int32)

    xs, ys = zip(*[read(f"data_batch_{i}") for i in range(1, 6)])
    train_x, train_y = np.concatenate(xs), np.concatenate(ys)
    val_x, val_y = read("test_batch")
    return train_x, train_y, val_x, val_y


def _synthetic_cifar(n_train: int, n_val: int, seed: int = 0):
    """Deterministic CIFAR-shaped synthetic images: low-frequency 8x8 colour
    fields upsampled 4x, one-tap smoothing, mild per-pixel noise. The same
    numpy draws in the same order as the JAX package, so the set is
    bit-identical to its own."""
    rng = np.random.default_rng(seed)
    n = n_train + n_val
    base = rng.integers(48, 208, size=(n, 8, 8, 3), dtype=np.int16)
    up = np.repeat(np.repeat(base, 4, axis=1), 4, axis=2)
    sm = up.astype(np.float32)
    sm[:, 1:] = 0.5 * (sm[:, 1:] + sm[:, :-1])
    sm[:, :, 1:] = 0.5 * (sm[:, :, 1:] + sm[:, :, :-1])
    noise = rng.normal(0.0, 12.0, size=sm.shape).astype(np.float32)
    imgs = np.clip(sm + noise, 0, 255).astype(np.uint8)
    labels = rng.integers(0, 10, size=(n,), dtype=np.int32)
    return imgs[:n_train], labels[:n_train], imgs[n_train:], labels[n_train:]


def load_cifar10(root: str = "data") -> Tuple[ArrayDataset, ArrayDataset, float, Dict]:
    """CIFAR-10 train/val with the reference's normalization and variance."""
    batch_dir = os.path.join(root, _CIFAR_DIR)
    synthetic = not os.path.exists(os.path.join(batch_dir, "data_batch_1"))
    if synthetic:
        tx, ty, vx, vy = _synthetic_cifar(_SYNTH_N_TRAIN, _SYNTH_N_VAL)
    else:
        tx, ty, vx, vy = _load_cifar_pickles(batch_dir)
    x_train_var = float(np.var(tx.astype(np.float64) / 255.0))
    train = ArrayDataset(_normalize_images(tx), ty)
    val = ArrayDataset(_normalize_images(vx), vy)
    info = {"name": "CIFAR10", "synthetic": synthetic, "n_train": len(train), "n_val": len(val)}
    return train, val, x_train_var, info


_LATENT_FILE = "latent_e_indices.npy"
_LATENT_N_VAL = 500


def load_latent_block(root: str = "data") -> Tuple[ArrayDataset, ArrayDataset, float, Dict]:
    """The code grids saved by ``extract-latents`` (``<root>/latent_e_indices.npy``),
    int32, the last 500 for validation (reference datasets/block.py:45,
    utils.py:48-58), labels all zero. Flat (N, h*w) grids are reshaped
    square for the prior. The codes are discrete and the loss is a
    cross-entropy, so the variance normalizer is 1.0."""
    path = os.path.join(root, _LATENT_FILE)
    data = np.asarray(np.load(path, allow_pickle=False))
    if data.ndim == 2:
        side = int(round(data.shape[1] ** 0.5))
        if side * side == data.shape[1]:
            data = data.reshape(-1, side, side)
    data = data.astype(np.int32)
    train_x, val_x = data[:-_LATENT_N_VAL], data[-_LATENT_N_VAL:]
    train = ArrayDataset(train_x, np.zeros(len(train_x), np.int32))
    val = ArrayDataset(val_x, np.zeros(len(val_x), np.int32))
    info = {"name": "LATENT_BLOCK", "path": path, "n_train": len(train), "n_val": len(val)}
    return train, val, 1.0, info


def load_dataset(name: str, root: str = "data") -> Tuple[ArrayDataset, ArrayDataset, float, Dict]:
    """Dataset dispatcher (reference utils.py:74-98): CIFAR10 and LATENT_BLOCK."""
    key = name.upper()
    if key == "CIFAR10":
        return load_cifar10(root)
    if key == "LATENT_BLOCK":
        return load_latent_block(root)
    if key == "BLOCK":
        raise ValueError("dataset 'BLOCK' is not ported yet; the port loads CIFAR10 and LATENT_BLOCK")
    raise ValueError(f"unknown dataset {name!r}; expected CIFAR10, BLOCK, or LATENT_BLOCK")


__all__ = ["ArrayDataset", "load_cifar10", "load_dataset", "load_latent_block"]
