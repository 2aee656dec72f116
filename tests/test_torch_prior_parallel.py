"""The prior's data parallelism, run as real processes:
``python -m vqvae_tpu_torch.cli train-prior --device cpu --distributed
--n_data 2`` once a rank, joined by gloo over 127.0.0.1, held against the JAX
package's ``train_pixelcnn`` on its CPU mesh with ``MeshConfig(n_data=2)``.

Both start from one JAX state written as the prior's file tagged epoch 0
with an empty history, and resume from it (epoch 0 is before the first
epoch, so nothing is replayed): a tiny prior (3 layers, 32 codes, 4 x 4
grids) on a synthetic ``latent_e_indices.npy`` of 96 training grids and the
last 500 for validation, global batch 16 (8 a rank), epochs 1 and 2, saving
every epoch; once with ``--steps_per_dispatch 1`` and once with 4 (staged
grids, chunks). Each rank writes a record: its exit code, a digest of its
whole state, and whether it imported JAX. A cluster has 60 s, after which
every rank is killed and the logs are printed.

Tolerances, each with its reason:
- per-epoch train and validation loss, rtol 1e-5: fp32 on both sides, the
  port averages two ranks' means where JAX takes the mean of the global
  batch;
- parameters, atol 2 * updates * lr: Adam's first steps move every element
  by about lr * sign(m / sqrt(v)), so an element whose gradient is near 0
  can go the other way in round-off (as in ``tests/test_torch_parallel_train.py``);
- Adam moments rtol 1e-4 (+ atol 1e-7 for mu, 1e-12 for nu): the same
  round-off through the square and the decay.
The replicas are compared bit for bit, and so are a one-rank group's file
and a run without a group.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vqvae_tpu.config import MeshConfig as JaxMeshConfig
from vqvae_tpu.config import PixelCNNConfig as JaxPixelCNNConfig
from vqvae_tpu.config import TrainConfig as JaxTrainConfig
from vqvae_tpu.data.datasets import load_dataset as jax_load_dataset
from vqvae_tpu.train import checkpoint as jax_checkpoint
from vqvae_tpu.train.pixelcnn_train import PixelCNNTrainer as JaxPixelCNNTrainer
from vqvae_tpu.train.pixelcnn_train import train_pixelcnn as jax_train_pixelcnn
from vqvae_tpu_torch import cli
from vqvae_tpu_torch.config import MeshConfig, PixelCNNConfig, TrainConfig
from vqvae_tpu_torch.train.checkpoint import flatten_tree, load_checkpoint, read_state_tree
from vqvae_tpu_torch.train.pixelcnn_train import PixelCNNTrainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(input_dim=32, dim=16, n_layers=3, img_dim=4)
FLAGS = ["--n_embeddings", "32", "--img_dim", "4", "--n_layers", "3", "--batch_size", "16",
         "--epochs", "3", "--log_interval", "100", "-save", "--device", "cpu"]
N_TRAIN, BATCH, EPOCHS, LR = 96, 16, 2, 3e-4
UPDATES = EPOCHS * N_TRAIN // BATCH
TIMEOUT_S = 60
FILE = "latent_block_pixelcnn.npz"

# one rank: the port's CLI, then a record of the state it ended with
WORKER = """
import hashlib, json, sys
from vqvae_tpu_torch import cli
from vqvae_tpu_torch.train import pixelcnn_train
from vqvae_tpu_torch.train.checkpoint import flatten_tree, train_state_to_jax

real, got = pixelcnn_train.train_pixelcnn, {}

def recording(*args, **kwargs):
    got["out"] = real(*args, **kwargs)
    return got["out"]

pixelcnn_train.train_pixelcnn = recording
rc = cli.main(sys.argv[2:])
state, out = got["out"]
flat = flatten_tree(train_state_to_jax(state))
h = hashlib.sha256()
for key in sorted(flat):
    h.update(key.encode() + flat[key].tobytes())
jax_loaded = any(m.split(".")[0] in ("jax", "jaxlib", "vqvae_tpu") for m in sys.modules)
with open(sys.argv[1], "w") as f:
    json.dump({"rc": rc, "digest": h.hexdigest(), "jax_loaded": jax_loaded,
               "history": out["history"], "step": state.step}, f)
"""


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(args_of_rank, n: int, records, timeout: float = TIMEOUT_S) -> list:
    """Start ``n`` workers with ``args_of_rank(i)``; all must exit 0 within
    ``timeout`` s, else every one is killed and every log printed. Returns
    their records."""
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": ROOT}
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(records[i]), *args_of_rank(i)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for i in range(n)]
    logs, failed = [], False
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
            failed |= p.returncode != 0
    except subprocess.TimeoutExpired:
        failed = True
    finally:
        for p in procs:
            p.kill()
        logs = [p.communicate()[0] if i >= len(logs) else logs[i] for i, p in enumerate(procs)]
    if failed:
        pytest.fail("ranks failed or timed out:\n" + "\n".join(
            f"--- rank {i} (rc {p.returncode}) ---\n{log}" for i, (p, log) in enumerate(zip(procs, logs))))
    out = []
    for i in range(n):
        with open(records[i]) as f:
            out.append(json.load(f))
    return out


def _latent_file(data_dir):
    os.makedirs(data_dir, exist_ok=True)
    codes = np.random.default_rng(0).integers(0, 32, (N_TRAIN + 500, 16)).astype(np.int32)
    np.save(os.path.join(data_dir, "latent_e_indices.npy"), codes)


def _start_file(path):
    cfg = JaxPixelCNNConfig(**SMALL)
    jt = JaxPixelCNNTrainer(cfg, JaxTrainConfig(seed=0), JaxMeshConfig(n_data=1))
    jax_checkpoint.save_checkpoint(str(path), jt.init_state(), 0,
                                   metrics={"train_loss": [], "val_loss": []},
                                   hyperparameters=cfg.to_dict())


@pytest.fixture(scope="module", params=[1, 4])
def cluster(request, tmp_path_factory):
    """Two gloo ranks and the JAX mesh trainer over the same 2 epochs."""
    spd = request.param
    work = tmp_path_factory.mktemp(f"prior_spd{spd}")
    data, port_dir, jax_dir = work / "data", work / "port", work / "jax"
    _latent_file(str(data))
    for d in (port_dir, jax_dir):
        os.makedirs(d)
        _start_file(d / FILE)

    train, val, _var, _info = jax_load_dataset("LATENT_BLOCK", str(data))
    _js, theirs = jax_train_pixelcnn(
        JaxPixelCNNConfig(**SMALL),
        JaxTrainConfig(batch_size=BATCH, epochs=EPOCHS + 1, log_interval=100, seed=0, save=True,
                       steps_per_dispatch=spd),
        train, val, JaxMeshConfig(n_data=2), verbose=False, save_path=str(jax_dir / FILE), resume=True)

    port = _free_port()
    records = run_ranks(lambda i: [
        "train-prior", "--distributed", "--coordinator_address", f"127.0.0.1:{port}",
        "--num_processes", "2", "--process_id", str(i), "--n_data", "2", "--resume",
        "--steps_per_dispatch", str(spd), "--data_dir", str(data), "--results_dir", str(port_dir),
        *FLAGS], 2, [work / f"rank{i}.json" for i in range(2)])
    return theirs["history"], records, str(port_dir / FILE), str(jax_dir / FILE)


def test_per_epoch_losses_follow_the_jax_mesh_trainer(cluster):
    theirs, records, path, _jax_path = cluster
    for r in records:
        assert r["rc"] == 0 and r["step"] == UPDATES
        for curve in ("train_loss", "val_loss"):
            assert len(r["history"][curve]) == EPOCHS
            np.testing.assert_allclose(r["history"][curve], theirs[curve], rtol=1e-5, err_msg=curve)
    _tree, epoch, metrics, _hp = read_state_tree(path)
    assert epoch == EPOCHS and metrics == records[0]["history"]


def test_state_follows_the_jax_mesh_trainer(cluster):
    _theirs, _records, path, jax_path = cluster
    got = flatten_tree(read_state_tree(path)[0])
    want = flatten_tree(read_state_tree(jax_path)[0])
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        assert g.shape == w.shape and g.dtype == w.dtype, key
        if g.dtype.kind in "iu":
            assert np.array_equal(g, w) and int(g.max()) == UPDATES, key
        elif ".mu" in key:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-7, err_msg=key)
        elif ".nu" in key:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-12, err_msg=key)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=2 * UPDATES * LR, err_msg=key)


def test_replicas_are_bit_identical_and_import_no_jax(cluster):
    _theirs, records, _path, _jax_path = cluster
    assert records[0]["digest"] == records[1]["digest"]
    assert not any(r["jax_loaded"] for r in records)


def test_rank0_file_loads_in_both_packages(cluster):
    _theirs, _records, path, _jax_path = cluster
    template = JaxPixelCNNTrainer(JaxPixelCNNConfig(**SMALL), JaxTrainConfig(),
                                  JaxMeshConfig(n_data=1)).init_state()
    j_state, j_epoch, j_metrics, hp = jax_checkpoint.load_checkpoint(path, template)
    assert j_epoch == EPOCHS and hp["n_layers"] == 3 and int(j_state.step) == UPDATES
    pt = PixelCNNTrainer(PixelCNNConfig(**SMALL), TrainConfig(), device="cpu")
    p_state, p_epoch, _m, _hp = load_checkpoint(path, pt.init_state())
    assert p_epoch == EPOCHS and p_state.step == UPDATES and p_state.optimizer.count == UPDATES
    np.testing.assert_array_equal(p_state.model.embedding.detach().numpy(),
                                  np.asarray(j_state.params["embedding"]))


def test_one_rank_group_keeps_the_bits_of_a_run_without_one(tmp_path):
    """A group of one rank runs every collective on the trivial mesh of one
    data rank: its file equals a run's without ``--distributed``, bit for bit."""
    data = tmp_path / "data"
    _latent_file(str(data))
    common = ["--steps_per_dispatch", "2", "--data_dir", str(data), *FLAGS]
    # both in a worker of one thread: the CPU's convs sum in another order
    # with another number of threads
    (alone,) = run_ranks(lambda i: ["train-prior", "--results_dir", str(tmp_path / "alone"), *common],
                         1, [tmp_path / "alone.json"])
    port = _free_port()
    (rec,) = run_ranks(lambda i: ["train-prior", "--distributed", "--coordinator_address",
                                  f"127.0.0.1:{port}", "--num_processes", "1", "--process_id", "0",
                                  "--results_dir", str(tmp_path / "group"), *common], 1,
                       [tmp_path / "rank0.json"])
    assert rec["rc"] == 0 and not rec["jax_loaded"] and rec["digest"] == alone["digest"]
    alone = flatten_tree(read_state_tree(str(tmp_path / "alone" / FILE))[0])
    group = flatten_tree(read_state_tree(str(tmp_path / "group" / FILE))[0])
    assert set(alone) == set(group)
    for key in alone:
        np.testing.assert_array_equal(alone[key], group[key], err_msg=key)


def test_the_prior_mesh_is_one_dimensional():
    with pytest.raises(ValueError, match="n_code must be 1"):
        PixelCNNTrainer(PixelCNNConfig(**SMALL), TrainConfig(), device="cpu",
                        mesh_cfg=MeshConfig(n_code=2))
    with pytest.raises(ValueError, match="one process a rank"):
        PixelCNNTrainer(PixelCNNConfig(**SMALL), TrainConfig(), device="cpu",
                        mesh_cfg=MeshConfig(n_data=2))
    trainer = PixelCNNTrainer(PixelCNNConfig(**SMALL), TrainConfig(), device="cpu")
    assert (trainer.mesh.n_data, trainer.mesh.n_code, trainer.mesh.distributed) == (1, 1, False)


def test_train_prior_parser_takes_the_data_mesh_flags():
    args = cli.build_parser().parse_args([
        "train-prior", "--n_data", "2", "--distributed", "--coordinator_address", "127.0.0.1:1234",
        "--num_processes", "2", "--process_id", "1", "--dist_backend", "gloo"])
    mesh = cli._mesh_cfg(args)
    assert (mesh.n_data, mesh.n_code, mesh.distributed, mesh.coordinator_address,
            mesh.num_processes, mesh.process_id, mesh.backend) == (2, 1, True, "127.0.0.1:1234", 2, 1, "gloo")
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["train-prior", "--n_code", "2"])
    assert torch.distributed.is_available()
