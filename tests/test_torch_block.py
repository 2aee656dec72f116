"""The BLOCK data set of the port (``data/datasets.py::load_block``) held
against the JAX package's on the same synthetic file.

The reference's file (``randact_traj_length_100_n_trials_1000_n_contexts_1.npy``)
is not in the repo, so each test writes one of the same format, as
``tests/test_data.py`` does: an object array whose ``x[0][0]`` is an
(H, W, >= 3) uint8 frame. The resize is the same numpy arithmetic in both
packages (cv2's bicubic with a = -0.75), so images, splits and ``x_train_var``
are compared bit for bit; the resampling matrix is also held against values
worked out by hand.
"""

from __future__ import annotations

import numpy as np
import pytest

from vqvae_tpu.data import datasets as jax_datasets
from vqvae_tpu_torch.data import datasets
from vqvae_tpu_torch.data.datasets import load_block, load_dataset

BLOCK_FILE = "randact_traj_length_100_n_trials_1000_n_contexts_1.npy"


def _write_block(path, n=20, hw=(48, 48), seed=0):
    frames = np.random.default_rng(seed).integers(0, 255, (n, 1, 1, *hw, 4), dtype=np.uint8)
    np.save(path / BLOCK_FILE, frames)


def _write_ragged_block(path):
    """Frames of two sizes, as the reference's per-frame resize allows."""
    rng = np.random.default_rng(3)
    raw = np.empty(10, dtype=object)
    for i in range(10):
        hw = (48, 48) if i % 2 else (17, 23)
        raw[i] = [[rng.integers(0, 255, (*hw, 3), dtype=np.uint8)]]
    np.save(path / BLOCK_FILE, raw, allow_pickle=True)


def _assert_same_sets(ours, theirs):
    (tr, va, var, info), (jtr, jva, jvar, jinfo) = ours, theirs
    assert info == jinfo and var == jvar
    for a, b in ((tr, jtr), (va, jva)):
        assert a.data.dtype == b.data.dtype == np.float32
        np.testing.assert_array_equal(a.data, b.data)
        np.testing.assert_array_equal(a.labels, b.labels)


def test_load_block_equals_the_jax_loader(tmp_path):
    _write_block(tmp_path)
    ours, theirs = load_block(str(tmp_path)), jax_datasets.load_block(str(tmp_path))
    _assert_same_sets(ours, theirs)
    train, val, var, info = ours
    assert len(train) == 18 and len(val) == 2  # the last tenth for validation
    assert train.data.shape[1:] == (32, 32, 3) and 0.0 < var < 1.0
    assert -1.0 <= train.data.min() and train.data.max() <= 1.0
    assert info["name"] == "BLOCK" and info["path"].endswith(BLOCK_FILE)


def test_load_block_with_frames_of_two_sizes_equals_the_jax_loader(tmp_path):
    _write_ragged_block(tmp_path)
    _assert_same_sets(load_block(str(tmp_path)), jax_datasets.load_block(str(tmp_path)))


def test_load_dataset_dispatches_block(tmp_path):
    _write_block(tmp_path, n=30, hw=(40, 36), seed=1)
    _assert_same_sets(load_dataset("BLOCK", str(tmp_path)), load_dataset("block", str(tmp_path)))
    _assert_same_sets(load_dataset("BLOCK", str(tmp_path)),
                      jax_datasets.load_dataset("BLOCK", str(tmp_path)))


@pytest.mark.parametrize("src,dst", [((48, 48), (32, 32)), ((17, 23), (32, 32)), ((8, 8), (32, 32)),
                                     ((64, 40), (32, 32))])
def test_resize_cubic_equals_the_jax_resize(src, dst):
    rng = np.random.default_rng(0)
    frame = rng.uniform(0, 255, (*src, 3)).astype(np.float32)
    np.testing.assert_array_equal(datasets._resize_cubic(frame, dst),
                                  jax_datasets._resize_cubic(frame, dst))
    batch = rng.uniform(0, 255, (5, *src, 3)).astype(np.float32)
    out = datasets._resize_cubic(batch, dst)
    assert out.shape == (5, *dst, 3)
    np.testing.assert_array_equal(out, jax_datasets._resize_cubic(batch, dst))
    np.testing.assert_array_equal(datasets._cubic_resize_matrix(src[0], dst[0]),
                                  jax_datasets._cubic_resize_matrix(src[0], dst[0]))


def test_cubic_kernel_is_cv2s():
    """a = -0.75 (cv2.INTER_CUBIC), not the -0.5 of a "bicubic" resize: half
    way between samples the four taps are (-0.09375, 0.59375, 0.59375,
    -0.09375); every row of the matrix sums to 1; a constant frame stays."""
    assert abs(datasets._cv2_cubic_kernel(0.5) - 0.59375) < 1e-12
    assert abs(datasets._cv2_cubic_kernel(1.5) + 0.09375) < 1e-12
    assert datasets._cv2_cubic_kernel(2.0) == 0.0 and datasets._cv2_cubic_kernel(0.0) == 1.0
    m = datasets._cubic_resize_matrix(4, 8)
    t = 0.25  # output pixel 3 maps to (3 + 0.5) * 0.5 - 0.5 = 1.25
    want = [datasets._cv2_cubic_kernel(x) for x in (1 + t, t, 1 - t, 2 - t)]
    np.testing.assert_allclose(m[3], want, atol=1e-7)
    np.testing.assert_allclose(datasets._cubic_resize_matrix(48, 32).sum(1), 1.0, atol=1e-6)
    flat = np.full((48, 48, 3), 100.0, np.float32)
    np.testing.assert_allclose(datasets._resize_cubic(flat, (32, 32)), 100.0, atol=1e-3)


def test_missing_block_file_raises_as_in_jax(tmp_path):
    with pytest.raises(FileNotFoundError, match=BLOCK_FILE):
        load_block(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        jax_datasets.load_block(str(tmp_path))


def test_train_vqvae_on_block_on_the_cpu(tmp_path):
    """``train-vqvae --dataset BLOCK`` trains on the file: finite metrics,
    checkpoints that name the data set."""
    from vqvae_tpu_torch import cli
    from vqvae_tpu_torch.train.checkpoint import read_state_tree

    _write_block(tmp_path, n=40)
    results = tmp_path / "results"
    rc = cli.main(["train-vqvae", "--dataset", "BLOCK", "--data_dir", str(tmp_path), "--device", "cpu",
                   "--n_hiddens", "16", "--n_residual_hiddens", "8", "--n_embeddings", "32",
                   "--embedding_dim", "8", "--batch_size", "8", "--n_updates", "4",
                   "--log_interval", "3", "--steps_per_dispatch", "2", "-save", "--filename", "blk",
                   "--results_dir", str(results)])
    assert rc == 0
    _tree, step, metrics, hp = read_state_tree(str(results / "vqvae_blk_step3.npz"))
    assert step == 3 and len(metrics["loss_vals"]) == 4 and np.isfinite(metrics["loss_vals"]).all()
    assert hp["dataset"] == "BLOCK" and hp["dataset_info"]["n_train"] == 36
