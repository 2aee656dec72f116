"""The port's data- and codebook-parallel training, run as real processes:
``python -m vqvae_tpu_torch.cli train-vqvae --device cpu --distributed`` once
a rank, joined by gloo over 127.0.0.1, held against the JAX package's
``VQVAETrainer`` on its CPU mesh with the same ``MeshConfig`` shape, on the
same batches from one start.

The start is one JAX state written as a step-0 checkpoint, its codebook
replaced by 64 latents of another batch (the fresh U(-1/K, 1/K) codebook
sends every latent to one code; see ``tests/test_torch_train.py``). Every
rank resumes from it, takes 4 updates on its data row's half of each global
batch of 16 (the sampler's shard) and rank 0 writes the full state. The JAX
trainer takes the same 4 updates on the global batches. The workers import
no JAX.

Three clusters, each at most 120 s, after which every rank is killed and the
logs are printed: (n_data, n_code) = (2, 1), (2, 2), and (2, 2) with an EMA
codebook. Tolerances, each with its reason:
- per-step loss, recon_error, perplexity, rtol 1e-5: fp32 on both sides, the
  port reduces each rank's mean over the data ranks where JAX takes the
  mean of the global batch;
- parameters, atol 2 * 4 * lr: the first AMSGrad steps move every element by
  about lr * sign(g), so an element whose gradient is near 0 can go the other
  way in round-off (``tests/test_torch_train.py``);
- moments and EMA statistics, rtol 1e-4 (+ atol 1e-7 for mu, 1e-12 for nu,
  1e-6 for the EMA leaves near 0): the same round-off, through the square
  and the decay.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_tpu.config import MeshConfig as JaxMeshConfig
from vqvae_tpu.config import TrainConfig as JaxTrainConfig
from vqvae_tpu.config import VQVAEConfig as JaxConfig
from vqvae_tpu.data.datasets import load_dataset as jax_load_dataset
from vqvae_tpu.data.sampler import ReplacementSampler as JaxReplacementSampler
from vqvae_tpu.train import checkpoint as jax_checkpoint
from vqvae_tpu.train.vqvae_train import VQVAETrainer as JaxTrainer
from vqvae_tpu_torch.config import TrainConfig, VQVAEConfig
from vqvae_tpu_torch.train.checkpoint import flatten_tree, load_checkpoint, read_state_tree
from vqvae_tpu_torch.train.vqvae_train import VQVAETrainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(n_hiddens=16, n_residual_hiddens=8, n_embeddings=64, embedding_dim=16)
BATCH, UPDATES, LR = 16, 4, 3e-4
TIMEOUT_S = 120
CLUSTERS = {"2x1": (2, 1, {}), "2x2": (2, 2, {}), "2x2-ema": (2, 2, {"ema_codebook": True})}
# a data directory that does not exist: both packages make the same synthetic CIFAR-10 set
DATA_DIR = os.path.join(ROOT, "build", "no_cifar_here")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(args_of_rank, n: int, timeout: float = TIMEOUT_S) -> None:
    """Start ``n`` ranks of ``python -m vqvae_tpu_torch.cli`` with the
    arguments ``args_of_rank(i)``; all must exit 0 within ``timeout`` s. On a
    failure or a timeout every rank is killed and every log printed."""
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-m", "vqvae_tpu_torch.cli", *args_of_rank(i)],
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


def _start_state(jt, extra):
    """The JAX trainer's fresh state with a codebook of 64 latents of another batch."""
    js = jt.init_state(jax.random.PRNGKey(1))
    x = np.random.default_rng(99).uniform(-1, 1, (BATCH, 32, 32, 3)).astype(np.float32)
    params = jax.device_get(js.params)
    z_e = np.asarray(jt.model.apply({"params": params}, jnp.asarray(x),
                                    method=jt.model.encode)).reshape(-1, 16)
    codebook = z_e[np.random.default_rng(5).choice(len(z_e), 64, replace=False)]
    host = jax.device_get(js)._replace(params={**params, "codebook": codebook})
    if extra.get("ema_codebook"):
        host = host._replace(ema_means=codebook.copy())
    return jax.device_put(host, jt._state_shard)


@pytest.fixture(scope="module", params=sorted(CLUSTERS))
def cluster(request, tmp_path_factory):
    """One cluster of ranks and the JAX trainer over the same 4 updates."""
    n_data, n_code, extra = CLUSTERS[request.param]
    cfg = JaxConfig(**TINY, **extra)
    train, _val, x_train_var, _info = jax_load_dataset("CIFAR10", DATA_DIR)
    jt = JaxTrainer(cfg, JaxTrainConfig(batch_size=BATCH),
                    JaxMeshConfig(n_data=n_data, n_code=n_code), x_train_var=x_train_var)
    js = _start_state(jt, extra)
    results = tmp_path_factory.mktemp(f"cluster_{request.param}")
    jax_checkpoint.save_checkpoint(str(results / "vqvae_run_step0.npz"), js, 0,
                                   hyperparameters=cfg.to_dict())

    sampler = JaxReplacementSampler(len(train), BATCH, seed=0)
    sampler.next_indices()  # the resumed run replays the schedule from step 1
    metrics = []
    for _ in range(UPDATES):
        js, m = jt.step(js, train.data[sampler.next_indices()])
        metrics.append({k: float(v) for k, v in m.items()})

    world, port = n_data * n_code, _free_port()
    flags = [f"--{k}={v}" for k, v in TINY.items()] + ["--ema_codebook"] * bool(extra)
    run_ranks(lambda i: [
        "train-vqvae", "--device", "cpu", "--distributed", "--coordinator_address", f"127.0.0.1:{port}",
        "--num_processes", str(world), "--process_id", str(i), "--n_data", str(n_data),
        "--n_code", str(n_code), "--batch_size", str(BATCH), "--n_updates", str(UPDATES + 1),
        "--log_interval", "50", "-save", "--resume", "--filename", "run",
        "--results_dir", str(results), "--data_dir", DATA_DIR, *flags], world)
    return request.param, jt, js, metrics, str(results / f"vqvae_run_step{UPDATES}.npz"), extra


def test_per_step_metrics_follow_the_jax_mesh_trainer(cluster):
    _name, _jt, _js, want, path, _extra = cluster
    _tree, step, metrics, _hp = read_state_tree(path)
    assert step == UPDATES and len(metrics["loss_vals"]) == UPDATES
    for ours, key in (("loss_vals", "loss"), ("recon_errors", "recon_error"),
                      ("perplexities", "perplexity")):
        np.testing.assert_allclose(metrics[ours], [m[key] for m in want], rtol=1e-5, err_msg=key)
    assert metrics["perplexities"][0] > 4.0, "the first batch should use several codes"


def test_state_follows_the_jax_mesh_trainer(cluster):
    name, _jt, js, _metrics, path, extra = cluster
    got = flatten_tree(read_state_tree(path)[0])
    want = {k: np.asarray(v) for k, v in jax_checkpoint._flatten_state(js).items()}
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        assert g.shape == w.shape and g.dtype == w.dtype, key
        if key in ("leaf::.step", "leaf::.opt_state[0].count"):
            assert int(g) == int(w) == UPDATES, key
        elif ".opt_state[0].mu" in key:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-7, err_msg=key)
        elif ".opt_state[0].nu" in key:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-12, err_msg=key)
        elif key.startswith("leaf::.ema_") or (extra and key.endswith("['codebook']")):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6, err_msg=key)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=2 * UPDATES * LR, err_msg=key)
    if extra:  # all 16 x 64 latents of each of the 4 global batches were counted once
        np.testing.assert_allclose(got["leaf::.ema_counts"].sum(),
                                   BATCH * 64 * (1 - 0.99 ** UPDATES), rtol=1e-5)


def test_rank0_file_loads_in_both_packages(cluster):
    """The file of a parallel run is the one-rank format: the JAX package's
    ``load_checkpoint`` reads it into a one-device state, the port's into a
    one-rank state, with the full (K, D) codebook."""
    _name, jt, _js, _metrics, path, extra = cluster
    cfg = JaxConfig(**TINY, **extra)
    template = JaxTrainer(cfg, JaxTrainConfig(batch_size=BATCH), JaxMeshConfig(n_data=1)).init_state()
    j_state, j_step, _m, hp = jax_checkpoint.load_checkpoint(path, template)
    assert j_step == UPDATES and hp["n_embeddings"] == 64
    pt = VQVAETrainer(VQVAEConfig(**TINY, **extra), TrainConfig(batch_size=BATCH), device="cpu")
    p_state, p_step, _m, _hp = load_checkpoint(path, pt.init_state())
    assert p_step == UPDATES and p_state.step == UPDATES and p_state.optimizer.count == UPDATES
    assert p_state.model.codebook.shape == (64, 16)
    np.testing.assert_array_equal(p_state.model.codebook.detach().numpy(),
                                  np.asarray(j_state.params["codebook"]))
    if extra:
        assert torch.equal(p_state.ema_counts, torch.from_numpy(np.asarray(j_state.ema_counts)))


def test_a_rank_without_a_peer_times_out_and_is_reported(tmp_path):
    """A cluster that cannot form (one rank of two) fails within the given
    time with every rank's log, not a hang."""
    port = _free_port()
    with pytest.raises(pytest.fail.Exception, match="ranks failed or timed out"):
        run_ranks(lambda i: ["train-vqvae", "--device", "cpu", "--distributed",
                             "--coordinator_address", f"127.0.0.1:{port}", "--num_processes", "2",
                             "--process_id", "0", "--n_updates", "1", "--data_dir", DATA_DIR,
                             "--results_dir", str(tmp_path)], 1, timeout=15)


def test_workers_import_no_jax():
    """The ranks are the port's CLI, which never imports JAX."""
    code = ("import sys, vqvae_tpu_torch.cli, vqvae_tpu_torch.train.vqvae_train, "
            "vqvae_tpu_torch.parallel.code_parallel; "
            "sys.exit(any(m == 'jax' or m.startswith(('jax.', 'vqvae_tpu.')) or m == 'vqvae_tpu' "
            "for m in sys.modules))")
    assert subprocess.run([sys.executable, "-c", code], cwd=ROOT).returncode == 0


def test_train_vqvae_parser_takes_the_mesh_flags():
    from vqvae_tpu_torch import cli

    args = cli.build_parser().parse_args([
        "train-vqvae", "--n_data", "2", "--n_code", "2", "--distributed", "--coordinator_address",
        "127.0.0.1:1234", "--num_processes", "4", "--process_id", "3", "--dist_backend", "gloo"])
    mesh = cli._mesh_cfg(args)
    assert (mesh.n_data, mesh.n_code, mesh.distributed, mesh.coordinator_address,
            mesh.num_processes, mesh.process_id, mesh.backend) == (2, 2, True, "127.0.0.1:1234", 4, 3, "gloo")
    assert cli._mesh_cfg(cli.build_parser().parse_args(["train-vqvae"])).distributed is False
