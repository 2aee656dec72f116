"""The prior's data path of the port held against the JAX package's: the
epoch sampler draws the same indices from one seed, and LATENT_BLOCK loads
the same grids, labels, split and info. Both are exact (integer data)."""

from __future__ import annotations

import numpy as np
import pytest

from vqvae_tpu.data.datasets import load_dataset as jax_load_dataset
from vqvae_tpu.data.sampler import EpochSampler as JaxEpochSampler
from vqvae_tpu_torch.data.datasets import load_dataset, load_latent_block
from vqvae_tpu_torch.data.sampler import EpochSampler


@pytest.mark.parametrize("shuffle,drop_last,num_shards", [
    (True, True, 1), (True, False, 1), (False, True, 1), (False, False, 1),
    (True, True, 2), (False, False, 2),
], ids=["shuffle-drop", "shuffle-keep", "ordered-drop", "ordered-keep",
        "shuffle-drop-2shards", "ordered-keep-2shards"])
def test_epoch_sampler_draws_the_jax_packages_indices(shuffle, drop_last, num_shards):
    n, batch = 203, 16  # a tail batch of 11, dropped or kept
    if num_shards > 1 and not drop_last:
        n = 208  # every batch, the tail too, must split over the shards
    for shard in range(num_shards):
        ours = EpochSampler(n, batch, seed=5, shuffle=shuffle, drop_last=drop_last,
                            num_shards=num_shards, shard_id=shard)
        theirs = JaxEpochSampler(n, batch, seed=5, shuffle=shuffle, drop_last=drop_last,
                                 num_shards=num_shards, shard_id=shard)
        epochs = []
        for _ in range(3):  # a fresh permutation each epoch, the same on both
            a, b = list(ours.epoch()), list(theirs)
            assert len(a) == len(b) == (n // batch if drop_last else -(-n // batch))
            for x, y in zip(a, b):
                assert x.dtype == y.dtype and np.array_equal(x, y)
            epochs.append(np.concatenate(a))
        per = batch // num_shards
        assert all(len(x) == per for x in a[: n // batch])
        if num_shards == 1:
            covered = np.sort(epochs[0])
            assert len(set(covered)) == len(covered)  # no index twice in an epoch
            if not drop_last:
                assert np.array_equal(covered, np.arange(n))
        if shuffle:
            assert not np.array_equal(epochs[0], epochs[1])
        else:
            assert np.array_equal(epochs[0], epochs[1])


def test_epoch_sampler_refuses_a_batch_the_shards_cannot_split():
    with pytest.raises(ValueError, match="not divisible"):
        list(EpochSampler(100, 30, num_shards=4).epoch())


@pytest.mark.parametrize("layout", ["flat", "square"])
def test_load_latent_block_equals_the_jax_packages(tmp_path, layout):
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 512, size=(1200, 64)).astype(np.int64)  # int64 on disk: cast to int32
    if layout == "square":
        codes = codes.reshape(-1, 8, 8)
    np.save(tmp_path / "latent_e_indices.npy", codes)
    ours = load_dataset("LATENT_BLOCK", str(tmp_path))
    theirs = jax_load_dataset("LATENT_BLOCK", str(tmp_path))
    train, val, var, info = ours
    assert var == theirs[2] == 1.0 and info == theirs[3]
    assert info == {"name": "LATENT_BLOCK", "path": str(tmp_path / "latent_e_indices.npy"),
                    "n_train": 700, "n_val": 500}
    for a, b in ((train, theirs[0]), (val, theirs[1])):
        assert a.data.dtype == b.data.dtype == np.int32 and a.data.shape[1:] == (8, 8)
        assert np.array_equal(a.data, b.data) and np.array_equal(a.labels, b.labels)
        assert a.labels.dtype == np.int32 and not a.labels.any()
    np.testing.assert_array_equal(val.data.reshape(500, 64), codes.reshape(-1, 64)[-500:])
    assert load_latent_block(str(tmp_path))[3] == info


def test_load_latent_block_keeps_a_non_square_width_flat(tmp_path):
    np.save(tmp_path / "latent_e_indices.npy", np.arange(600 * 12, dtype=np.int32).reshape(600, 12))
    train, val, _var, _info = load_latent_block(str(tmp_path))
    theirs = jax_load_dataset("LATENT_BLOCK", str(tmp_path))
    assert train.data.shape == (100, 12) and val.data.shape == (500, 12)
    assert np.array_equal(train.data, theirs[0].data)
    with pytest.raises(FileNotFoundError):
        load_latent_block(str(tmp_path / "nowhere"))
