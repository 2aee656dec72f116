"""In-memory datasets (port of ``vqvae_tpu/data/datasets.py``, numpy only).

``load_dataset`` returns ``(train, val, x_train_var, info)`` with images as
float32 NHWC in [-1, 1] (the reference's ToTensor + Normalize(0.5, 0.5),
utils.py:14-16) and ``x_train_var`` the reference's ``np.var(train / 255)``
on the pre-normalization pixels. CIFAR-10 reads the python-pickle batches
under ``<root>/cifar-10-batches-py`` when present; otherwise it generates the
same deterministic synthetic set as the JAX package, bit for bit.
BLOCK is the reference's block-world trajectories (the user's own
``<root>/randact_traj_length_100_n_trials_1000_n_contexts_1.npy``), each
first frame resized to 32 x 32 by cv2's bicubic arithmetic. LATENT_BLOCK is
the code grids ``extract-latents`` writes, the prior's training data.
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


_BLOCK_FILE = "randact_traj_length_100_n_trials_1000_n_contexts_1.npy"


def _cv2_cubic_kernel(x: float, a: float = -0.75) -> float:
    """OpenCV's bicubic interpolation kernel (a = -0.75).

    cv2.INTER_CUBIC (reference datasets/block.py:16-17) uses the Keys cubic
    with a = -0.75, not the a = -0.5 Catmull-Rom of PyTorch's and JAX's
    "bicubic"/"cubic" resizes: the two give other pixels."""
    ax = abs(x)
    if ax <= 1.0:
        return ((a + 2.0) * ax - (a + 3.0)) * ax * ax + 1.0
    if ax < 2.0:
        return (((ax - 5.0) * ax + 8.0) * ax - 4.0) * a
    return 0.0


def _cubic_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) resampling matrix of cv2.resize's INTER_CUBIC: the
    half-pixel mapping src = (dst + 0.5) * (n_in / n_out) - 0.5, 4 taps an
    output pixel, borders replicated. The resize is then two small matmuls
    (separable), batched over frames."""
    m = np.zeros((n_out, n_in), np.float64)
    scale = n_in / n_out
    for i in range(n_out):
        fx = (i + 0.5) * scale - 0.5
        sx = int(np.floor(fx))
        t = fx - sx
        for tap, w in enumerate(
            (_cv2_cubic_kernel(1.0 + t), _cv2_cubic_kernel(t),
             _cv2_cubic_kernel(1.0 - t), _cv2_cubic_kernel(2.0 - t))
        ):
            j = min(max(sx - 1 + tap, 0), n_in - 1)
            m[i, j] += w
    return m.astype(np.float32)


def _resize_cubic(frame: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """cv2.INTER_CUBIC resize of one (H, W, C) frame or a batch (N, H, W, C)
    of frames to ``hw`` (reference datasets/block.py:16-17)."""
    x = np.asarray(frame, np.float32)
    batched = x.ndim == 4
    if not batched:
        x = x[None]
    mh = _cubic_resize_matrix(x.shape[1], hw[0])
    mw = _cubic_resize_matrix(x.shape[2], hw[1])
    out = np.einsum("oh,nhwc,pw->nopc", mh, x, mw, optimize=True)
    return out if batched else out[0]


def load_block(root: str = "data") -> Tuple[ArrayDataset, ArrayDataset, float, Dict]:
    """BLOCK: an object array of trajectories whose frame is ``x[0][0][:, :, :3]``,
    resized to 32 x 32, the last tenth for validation, labels all zero
    (reference datasets/block.py:14-21, utils.py:28-46). The file is a
    pickled object array in the reference's format, so it is read with
    ``allow_pickle``: load only a file of your own."""
    path = os.path.join(root, _BLOCK_FILE)
    raw = np.load(path, allow_pickle=True)
    frames = [np.asarray(x[0][0])[:, :, :3].astype(np.float32) for x in raw]
    if len({f.shape for f in frames}) == 1:
        resized = _resize_cubic(np.stack(frames), (32, 32))
    else:
        # frames of several sizes (the reference resizes frame by frame)
        resized = np.stack([_resize_cubic(f, (32, 32)) for f in frames])
    data = np.clip(resized, 0, 255).astype(np.uint8)
    cutoff = len(data) // 10
    train_u8, val_u8 = data[:-cutoff], data[-cutoff:]
    x_train_var = float(np.var(train_u8.astype(np.float64) / 255.0))
    train = ArrayDataset(_normalize_images(train_u8), np.zeros(len(train_u8), np.int32))
    val = ArrayDataset(_normalize_images(val_u8), np.zeros(len(val_u8), np.int32))
    info = {"name": "BLOCK", "path": path, "n_train": len(train), "n_val": len(val)}
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
    """Dataset dispatcher (reference utils.py:74-98)."""
    key = name.upper()
    if key == "CIFAR10":
        return load_cifar10(root)
    if key == "BLOCK":
        return load_block(root)
    if key == "LATENT_BLOCK":
        return load_latent_block(root)
    raise ValueError(f"unknown dataset {name!r}; expected CIFAR10, BLOCK, or LATENT_BLOCK")


__all__ = ["ArrayDataset", "load_block", "load_cifar10", "load_dataset", "load_latent_block"]
