"""The port's codebook parallelism (``vqvae_tpu_torch/parallel``) held against
the JAX package's ``vqvae_tpu/parallel/code_parallel.py`` on its 8-device CPU
mesh, in one process.

The cross-shard combine is tested as the pure function it is, on per-shard
(value, index) stacks from the plain version. ``quantize`` on a mesh (the
port's ``quantize_sharded``) and its backward run on eight threads, one a rank of a 2 x 4 mesh, whose collectives
meet at a barrier (``ThreadMesh``): the same arithmetic as ranks joined by
``torch.distributed``, which ``tests/test_torch_parallel_train.py`` runs in
processes.

Tolerances, each with its reason:
- indices: equal, or a near-tie under ``compare_assignments`` (float64
  scores within 1e-5 * (||z||^2 + max ||e||^2)): the two packages sum the
  products in different orders;
- z_q: exactly ``codebook[idx]`` (a masked gather summed with zeros);
- gradients, rtol 1e-5 + atol 1e-6: fp32 on both sides, the port sums the
  codebook gradient over the data ranks after each rank's own mean, the JAX
  package over the global batch at once.
"""

from __future__ import annotations

import dataclasses
import threading
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_tpu.config import MeshConfig as JaxMeshConfig
from vqvae_tpu.parallel.code_parallel import codebook_sharding
from vqvae_tpu.parallel.code_parallel import make_2d_mesh as jax_make_2d_mesh
from vqvae_tpu.parallel.code_parallel import nearest_code_sharded as jax_nearest_code_sharded
from vqvae_tpu.parallel.code_parallel import quantize_sharded as jax_quantize_sharded
from vqvae_tpu_torch.config import MeshConfig, TrainConfig, VQVAEConfig
from vqvae_tpu_torch.ops.quantizer import code_scores, compare_assignments, nearest_code_values_torch, quantize
from vqvae_tpu_torch.parallel import code_parallel
from vqvae_tpu_torch.parallel.distributed import is_primary_host, maybe_initialize_distributed
from vqvae_tpu_torch.parallel.mesh import Mesh, make_mesh, mesh_coordinates, put_global
from vqvae_tpu_torch.train.vqvae_train import VQVAETrainer

MODES = ["highest", "high", "default"]


def _data(n=256, k=64, d=32, seed=0):
    r = np.random.default_rng(seed)
    return (r.standard_normal((n, d)).astype(np.float32),
            r.standard_normal((k, d)).astype(np.float32))


def _data_rows(x, mesh):
    """This rank's rows of a global batch: its data coordinate's contiguous
    slice, as the sampler's shard draws it."""
    per = len(x) // mesh.n_data
    return x[mesh.data * per:(mesh.data + 1) * per]


def _shard_stacks(z, cb, n_code, precision="highest"):
    """Each shard's plain search with values: (n_code, N) values and local indices."""
    k_local = len(cb) // n_code
    z_t = torch.from_numpy(z)
    found = [nearest_code_values_torch(z_t, torch.from_numpy(cb[s * k_local:(s + 1) * k_local]), precision)
             for s in range(n_code)]
    return torch.stack([v for _i, v in found]), torch.stack([i for i, _v in found]), k_local


# -- the plain version's values -------------------------------------------------


@pytest.mark.parametrize("precision", MODES)
def test_plain_values_are_the_minimum_scores(precision):
    z, cb = map(torch.from_numpy, _data(300, 70, 24, seed=1))
    idx, values = nearest_code_values_torch(z, cb, precision)
    scores = code_scores(z, cb, precision)
    assert idx.dtype == torch.int32 and values.dtype == torch.float32
    assert torch.equal(values, scores.min(1).values)
    assert torch.equal(idx, scores.argmin(1).to(torch.int32))


def test_plain_values_follow_the_first_nan():
    """torch.argmin's rule: the first NaN score wins and its value is NaN, as
    ``min`` gives; a NaN row of z gets code 0."""
    z, cb = map(torch.from_numpy, _data(50, 40, 8, seed=2))
    z[7], cb[30] = float("nan"), float("nan")
    idx, values = nearest_code_values_torch(z, cb)
    assert (idx == 30).sum() == 49 and int(idx[7]) == 0
    assert torch.equal(values.isnan(), code_scores(z, cb).min(1).values.isnan())
    assert bool(values.isnan().all())


# -- the combine against JAX's sharded search -----------------------------------


@pytest.fixture(scope="module")
def jax_mesh():
    return jax_make_2d_mesh(n_data=2, n_code=4)


@pytest.mark.parametrize("seed", [0, 3])
def test_combine_matches_jax_nearest_code_sharded(jax_mesh, seed):
    z, cb = _data(seed=seed)
    _zq, idx_jax = jax_nearest_code_sharded(
        jnp.asarray(z), jax.device_put(jnp.asarray(cb), codebook_sharding(jax_mesh)), jax_mesh)
    values, indices, k_local = _shard_stacks(z, cb, 4)
    win_shard, win_local, idx = code_parallel.combine_shards(values, indices, k_local)
    mism, near, _gap = compare_assignments(torch.from_numpy(z), torch.from_numpy(cb), idx,
                                           torch.from_numpy(np.array(idx_jax)))
    assert mism == near
    # z_q: each shard's masked rows, summed over the code axis
    cb_t = torch.from_numpy(cb)
    z_q = sum(code_parallel.masked_gather(cb_t[s * k_local:(s + 1) * k_local], win_shard, win_local, s)
              for s in range(4))
    assert torch.equal(z_q, cb_t[idx.long()])
    # the same indices as the unsharded plain search, bit for bit
    assert torch.equal(idx, nearest_code_values_torch(torch.from_numpy(z), cb_t)[0])


def test_lowest_shard_wins_a_tie():
    """Four exact copies of a 16-row codebook, one a shard: every index is in
    the first copy (``tests/test_code_parallel.py:89``)."""
    base = np.random.default_rng(4).standard_normal((16, 8)).astype(np.float32)
    cb = np.tile(base, (4, 1))
    z = np.random.default_rng(5).standard_normal((32, 8)).astype(np.float32)
    values, indices, k_local = _shard_stacks(z, cb, 4)
    _ws, _wl, idx = code_parallel.combine_shards(values, indices, k_local)
    assert int(idx.max()) < 16
    assert torch.equal(idx, nearest_code_values_torch(torch.from_numpy(z), torch.from_numpy(cb))[0])


def test_the_combine_message_carries_indices_bit_for_bit():
    """The exchange packs the int32 indices as fp32 bits beside the values."""
    idx = torch.tensor([0, 1, 2**31 - 1, 12345, 7], dtype=torch.int32)
    values = torch.tensor([1.0, float("inf"), -3.5, 0.0, 2.0])
    mesh = Mesh(1, 1, 0, 0)
    win_shard, win_local, out = code_parallel.exchange_and_combine(idx, values, mesh, 5)
    assert torch.equal(out, idx) and not win_shard.any()
    assert torch.equal(win_local, idx.long())


# -- quantize on a mesh of eight threads -----------------------------------------


class _Hub:
    """Where the threads of a ThreadMesh meet: each puts its tensor, all wait,
    each reads its group's, all wait again."""

    def __init__(self, world):
        self.slots = [None] * world
        self.barrier = threading.Barrier(world, timeout=60)

    def exchange(self, rank, t):
        self.slots[rank] = t.detach().clone()
        self.barrier.wait()
        out = list(self.slots)
        self.barrier.wait()
        return out


@dataclass(frozen=True)
class ThreadMesh(Mesh):
    hub: _Hub = None

    def _members(self, axis):
        ranks = range(self.world)
        if axis == "data":
            return [r for r in ranks if mesh_coordinates(r, self.n_code)[1] == self.code]
        if axis == "code":
            return [r for r in ranks if mesh_coordinates(r, self.n_code)[0] == self.data]
        return list(ranks)

    def psum(self, t, axis):
        parts = self.hub.exchange(self.data * self.n_code + self.code, t)
        total = parts[self._members(axis)[0]].clone()
        for r in self._members(axis)[1:]:
            total += parts[r]
        return t.copy_(total)

    def gather_code(self, t):
        parts = self.hub.exchange(self.data * self.n_code + self.code, t)
        return torch.stack([parts[r] for r in self._members("code")])


def _run_ranks(n_data, n_code, fn):
    """fn(mesh) on one thread a rank; returns the results by rank."""
    hub = _Hub(n_data * n_code)
    results, errors = [None] * hub.barrier.parties, []

    def body(rank):
        try:
            d, c = mesh_coordinates(rank, n_code)
            results[rank] = fn(ThreadMesh(n_data, n_code, d, c, True, hub=hub))
        except BaseException as e:  # reported by the caller
            errors.append(e)
            hub.barrier.abort()

    threads = [threading.Thread(target=body, args=(r,)) for r in range(hub.barrier.parties)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results


def test_quantize_on_a_mesh_matches_jax_quantize_sharded(jax_mesh):
    """``quantize`` with a mesh and the sharded search: loss, perplexity,
    counts and indices of the global batch, and the codebook and latent
    gradients of ``q.loss + mean(q.z_q ** 2)`` (the STE path too), against
    JAX ``quantize_sharded`` on its 2 x 4 mesh (``tests/test_code_parallel.py:65``)."""
    r = np.random.default_rng(2)
    z = r.standard_normal((8, 4, 4, 16)).astype(np.float32)
    cb = r.standard_normal((32, 16)).astype(np.float32)

    def loss_jax(z, cb):
        q = jax_quantize_sharded(z, cb, 0.25, jax_mesh)
        return q.loss + jnp.mean(q.z_q ** 2), (q.loss, q.perplexity, q.counts, q.indices)

    (_, (j_loss, j_perp, j_counts, j_idx)), (gz_jax, gcb_jax) = jax.jit(
        jax.value_and_grad(loss_jax, argnums=(0, 1), has_aux=True))(
        jnp.asarray(z), jax.device_put(jnp.asarray(cb), codebook_sharding(jax_mesh)))

    def rank(mesh):
        z_loc = torch.from_numpy(_data_rows(z, mesh)).requires_grad_(True)
        cb_loc = put_global(cb, mesh).requires_grad_(True)
        q = quantize(z_loc, cb_loc, 0.25, mesh=mesh,
                     search=partial(code_parallel.nearest_code_sharded, mesh=mesh))
        (q.loss + torch.mean(q.z_q ** 2)).backward()
        return q, z_loc.grad, cb_loc.grad

    out = _run_ranks(2, 4, rank)
    # the global loss is the mean of the data rows' losses; its gradient the mean of theirs
    loss = np.mean([float(out[d * 4][0].loss.detach()) for d in range(2)])
    np.testing.assert_allclose(loss, float(j_loss), rtol=1e-6)
    for q, _gz, _gcb in out:
        np.testing.assert_allclose(float(q.perplexity), float(j_perp), rtol=1e-6)
        assert np.array_equal(q.counts.numpy(), np.asarray(j_counts))
    idx = np.concatenate([out[d * 4][0].indices.numpy() for d in range(2)])
    assert np.array_equal(idx, np.asarray(j_idx))
    gz = np.concatenate([out[d * 4][1].numpy() for d in range(2)]) / 2
    gcb = np.concatenate([sum(out[d * 4 + c][2] for d in range(2)).numpy() / 2 for c in range(4)])
    np.testing.assert_allclose(gz, np.asarray(gz_jax), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gcb, np.asarray(gcb_jax), rtol=1e-5, atol=1e-6)
    assert np.count_nonzero(np.abs(gcb).sum(1)) > 4


def test_sharded_search_on_threads_equals_the_unsharded_one():
    """``nearest_code_sharded`` over 1 x 4 and 2 x 2 ranks against the plain
    search of the whole codebook: indices equal, z_q the codebook's rows."""
    z, cb = _data(128, 64, 16, seed=6)
    want = nearest_code_values_torch(torch.from_numpy(z), torch.from_numpy(cb))[0]
    for n_data, n_code in ((1, 4), (2, 2)):
        def rank(mesh):
            return code_parallel.nearest_code_sharded(
                torch.from_numpy(_data_rows(z, mesh)), put_global(cb, mesh), mesh)

        out = _run_ranks(n_data, n_code, rank)
        for r, (z_q, idx) in enumerate(out):
            d, _c = mesh_coordinates(r, n_code)
            rows = slice(d * len(z) // n_data, (d + 1) * len(z) // n_data)
            assert torch.equal(idx, want[rows])
            assert torch.equal(z_q, torch.from_numpy(cb)[idx.long()])


# -- layout and errors ------------------------------------------------------------


@pytest.mark.parametrize("n_data,n_code", [(2, 4), (4, 2), (8, 1), (1, 8)])
def test_rank_layout_is_make_2d_meshs_device_grid(n_data, n_code):
    grid = jax_make_2d_mesh(n_data=n_data, n_code=n_code).devices
    for d in range(n_data):
        for c in range(n_code):
            assert mesh_coordinates(int(grid[d, c].id), n_code) == (d, c)


def test_divisibility_and_world_size_errors():
    with pytest.raises(ValueError, match="codebook rows 62 not divisible by code axis 4"):
        code_parallel.check_divisible(62, 256, Mesh(2, 4, 0, 0))
    with pytest.raises(ValueError, match="N 255 not divisible by data axis 2"):
        code_parallel.check_divisible(64, 255, Mesh(2, 4, 0, 0))
    with pytest.raises(ValueError, match="--distributed"):
        make_mesh(n_code=2)
    with pytest.raises(ValueError, match="--distributed"):
        VQVAETrainer(VQVAEConfig(n_embeddings=64), TrainConfig(), device="cpu",
                     mesh_cfg=MeshConfig(n_code=2))
    with pytest.raises(ValueError, match="n_code must be >= 1"):
        make_mesh(n_code=0)


def test_one_process_is_the_trivial_mesh():
    """Without a process group: a 1 x 1 mesh whose collectives do nothing."""
    mesh = make_mesh()
    assert (mesh.n_data, mesh.n_code, mesh.data, mesh.code, mesh.distributed) == (1, 1, 0, 0, False)
    t = torch.arange(4.0)
    assert mesh.psum(t, "world") is t and torch.equal(t, torch.arange(4.0))
    assert torch.equal(mesh.gather_code(t), t[None])
    assert torch.equal(put_global(np.arange(8, dtype=np.float32), Mesh(2, 4, 1, 3)), torch.tensor([6.0, 7.0]))
    assert is_primary_host()
    assert maybe_initialize_distributed(MeshConfig(), "cpu") == torch.device("cpu")
    trainer = VQVAETrainer(VQVAEConfig(n_hiddens=16, n_residual_hiddens=8, n_embeddings=64,
                                       embedding_dim=16), TrainConfig(batch_size=8), device="cpu")
    assert trainer.mesh.world == 1 and not trainer.sharded


@pytest.mark.parametrize("ema", [False, True])
def test_quantize_on_the_trivial_mesh_is_quantize(ema):
    """One process: ``quantize`` with the trivial mesh gives the bits of
    ``quantize`` without one, and the same codebook gradient."""
    z, cb = _data(96, 32, 16, seed=7)
    out = []
    for mesh in (None, make_mesh()):
        z_t = torch.from_numpy(z).reshape(6, 4, 4, 16).requires_grad_(True)
        cb_t = torch.from_numpy(cb).requires_grad_(True)
        q = quantize(z_t, cb_t, 0.25, ema=ema, mesh=mesh)
        (q.loss + torch.mean(q.z_q ** 2)).backward()
        out.append((q, z_t.grad, cb_t.grad))
    (a, gz_a, gcb_a), (b, gz_b, gcb_b) = out
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert torch.equal(gz_a, gz_b)
    # the EMA loss reaches the codebook through no path
    assert (gcb_a is None and gcb_b is None) if ema else torch.equal(gcb_a, gcb_b)


def test_mesh_config_takes_the_jax_dict_and_refuses_other_axis_names():
    """The JAX MeshConfig's dict loads; the port's process groups are named
    'data' and 'code', so another axis name is refused, not ignored."""
    jax_dict = dataclasses.asdict(JaxMeshConfig(n_data=2, n_code=4, distributed=True))
    assert MeshConfig.from_dict(jax_dict) == MeshConfig(n_data=2, n_code=4, distributed=True)
    with pytest.raises(ValueError, match="mesh axes are 'data' and 'code'"):
        MeshConfig(data_axis="batch")
    with pytest.raises(ValueError, match="mesh axes are 'data' and 'code'"):
        MeshConfig.from_dict({**jax_dict, "code_axis": "model"})


def test_nccl_needs_cuda_ranks():
    with pytest.raises(ValueError, match="nccl backend needs CUDA ranks"):
        maybe_initialize_distributed(MeshConfig(distributed=True, backend="nccl"), "cpu")
