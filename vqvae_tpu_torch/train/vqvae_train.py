"""VQ-VAE training (port of ``vqvae_tpu/train/vqvae_train.py``; reference main.py:49-98).

One update is forward, loss, backward, the hand-written torch-1.1 AMSGrad
step and, with an EMA codebook, the EMA update:

    recon_loss = mean((x_hat - x)^2) / x_train_var          (main.py:75-76)
    loss       = recon_loss + embedding_loss

On a CUDA device the forward's nearest-code search is the hand-written kernel
(``ops/cuda_quantizer.py``: route "fma" for the "highest" quantizer mode,
"mma" for "default"/"high"), its backward a scatter-add in a fixed order
(``ops/scatter.py::scatter_add_rows``).

Nothing inside a chunk of updates reads the device back: the step counter
and the optimizer's bias corrections live on the host, the per-step ``loss``,
``recon_error`` and ``perplexity`` stay device scalars, and they cross to the
host stacked, once per chunk, when the training loop asks for them
(``metrics_to_host``). ``steps`` and ``steps_by_index`` are a plain loop of
K updates in the order of K calls of ``step``.

``conv_precision`` is held around the forward AND the backward: autograd
runs the backward convolutions when ``backward()`` is called, and cuDNN reads
the TF32 switch then, so a scope around the forward alone would leave the
gradients of a "highest" run in TF32.

A run repeats bit for bit on the card as on the CPU (the JAX package's
contract, "same seed => bit-identical step"): the codebook gradient and the
EMA sums add without atomics (``scatter_add_rows``), and the precision scope
holds cuDNN to its deterministic algorithms through the backward
(``ops/conv.py``). The assignment counts add ones with ``index_add_``: any
order gives the same integer in fp32 below 2**24.

Data and codebook parallelism (``MeshConfig``, ``parallel/``): one process a
rank over an ``n_data x n_code`` mesh. A rank trains on its data row's slice
of every global batch (the sampler's shard), holds every conv weight whole
and, with ``n_code > 1``, its K / n_code rows of the codebook, of their
AMSGrad moments and of the EMA statistics; the search is then the sharded
one of ``parallel/code_parallel.py``. After ``backward()`` the gradients are
all-reduced once: the replicated leaves summed over the whole world and
divided by its size (so every replica of a weight gets the same bits, even
where two ranks of a data row computed its gradient in another order), the
codebook shard summed over the data group and divided by ``n_data``. The
metrics are the global batch's. Every rank builds the same full state from
the seed and keeps its part; a checkpoint holds the full state, gathered over
the code group and written by rank 0, so a file loads into any mesh shape.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from functools import partial
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from vqvae_tpu_torch.config import MeshConfig, TrainConfig, VQVAEConfig
from vqvae_tpu_torch.data.datasets import load_dataset
from vqvae_tpu_torch.data.sampler import ReplacementSampler
from vqvae_tpu_torch.device import resolve_device
from vqvae_tpu_torch.models.vqvae import VQVAE
from vqvae_tpu_torch.ops.conv import conv_fp32_precision
from vqvae_tpu_torch.ops.quantizer import nearest_code, quantize
from vqvae_tpu_torch.ops.scatter import scatter_add_rows
from vqvae_tpu_torch.parallel.code_parallel import check_divisible, nearest_code_sharded
from vqvae_tpu_torch.parallel.distributed import is_primary_host
from vqvae_tpu_torch.parallel.mesh import make_mesh, put_global
from vqvae_tpu_torch.train.checkpoint import (
    AsyncCheckpointer,
    check_hyperparameters_compatible,
    checkpoint_path,
    latest_checkpoint,
    read_state_tree,
    train_state_from_jax,
    train_state_to_jax,
)
from vqvae_tpu_torch.train.metrics import MetricHistory, MetricLogger, readable_timestamp
from vqvae_tpu_torch.train.optim import TorchAmsgrad, make_optimizer

METRIC_NAMES = ("loss", "recon_error", "perplexity")
# model fields that change the state's tree: a resume must match them
_TREE_FIELDS = (
    "in_channels", "n_hiddens", "n_residual_hiddens", "n_residual_layers",
    "embedding_dim", "n_embeddings", "share_residual_weights", "ema_codebook",
)


@dataclass
class TrainState:
    """What training changes, updated in place by every step."""

    model: VQVAE
    optimizer: TorchAmsgrad
    step: int = 0                                  # completed updates, on the host
    # EMA-codebook statistics (None unless VQVAEConfig.ema_codebook):
    ema_counts: Optional[torch.Tensor] = None      # (K,)   running assignment counts
    ema_means: Optional[torch.Tensor] = None       # (K, D) running sums of assigned latents


def metrics_to_host(metrics: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Per-step metrics (device scalars, or (K,) stacks of them) -> numpy, in
    one transfer."""
    stacked = torch.stack([metrics[name] for name in METRIC_NAMES]).cpu().numpy()
    return dict(zip(METRIC_NAMES, stacked))


class VQVAETrainer:
    """Owns the configs and the update; reusable by the CLI, tests and timing scripts."""

    def __init__(
        self,
        vq_cfg: VQVAEConfig = VQVAEConfig(),
        train_cfg: TrainConfig = TrainConfig(),
        x_train_var: float = 1.0,
        device: str = "cuda",
        generator: Optional[torch.Generator] = None,
        mesh_cfg: MeshConfig = MeshConfig(),
    ):
        self.vq_cfg = vq_cfg
        self.train_cfg = train_cfg
        self.x_train_var = float(x_train_var)
        self.device = resolve_device(device)
        self.generator = generator
        self.mesh = make_mesh(mesh_cfg.n_data, mesh_cfg.n_code)
        check_divisible(vq_cfg.n_embeddings, train_cfg.batch_size, self.mesh)
        self.sharded = self.mesh.n_code > 1
        self._search = partial(nearest_code_sharded, mesh=self.mesh) if self.sharded else nearest_code
        self._device_data: Optional[torch.Tensor] = None

    # -- state ---------------------------------------------------------------

    def init_state(self, generator: Optional[torch.Generator] = None) -> TrainState:
        """A fresh state: torch-default initial weights drawn on the CPU from
        ``generator`` (default: the trainer's, else one seeded with
        ``train_cfg.seed``), zero optimizer moments, EMA means = the codebook.
        Under codebook parallelism every rank draws the whole model and keeps
        its rows of the codebook."""
        gen = generator or self.generator
        if gen is None:
            gen = torch.Generator().manual_seed(self.train_cfg.seed)
        model = VQVAE(self.vq_cfg)
        model.reset_parameters(gen)
        if self.sharded:
            rows = put_global(model.codebook.detach(), self.mesh)
            model.codebook = torch.nn.Parameter(rows.clone())
        model.to(self.device)
        optimizer = make_optimizer(
            model.parameters(), self.train_cfg.learning_rate, self.train_cfg.amsgrad_impl
        )
        state = TrainState(model, optimizer)
        if self.vq_cfg.ema_codebook:
            state.ema_counts = torch.zeros(model.codebook.shape[0], device=self.device)
            state.ema_means = model.codebook.detach().clone()
        return state

    @staticmethod
    def _codebook_leaves(state: TrainState) -> list:
        """(key path in the train-state tree, local tensor) of every leaf that
        codebook parallelism row-shards: the codebook, its moments, the EMA
        statistics."""
        cb = state.model.codebook
        leaves = [(("params", "codebook"), cb.detach())]
        leaves += [(("opt_state", m, "codebook"), state.optimizer.state[cb][key])
                   for m, key in state.optimizer.MOMENTS.items()]
        if state.ema_counts is not None:
            leaves += [(("ema_counts",), state.ema_counts), (("ema_means",), state.ema_means)]
        return leaves

    def state_tree(self, state: TrainState) -> dict:
        """The full train state as a JAX tree (``train_state_to_jax``). Under
        codebook parallelism the sharded leaves are gathered over the code
        group, so every rank must call it."""
        tree = train_state_to_jax(state)
        if self.sharded:
            for path, local in self._codebook_leaves(state):
                full = self.mesh.gather_code(local.contiguous()).flatten(0, 1)
                _parent(tree, path)[path[-1]] = full.cpu().numpy()
        return tree

    def load_tree(self, state: TrainState, tree: dict) -> TrainState:
        """Load a full train-state tree (a checkpoint's, any mesh shape) into
        ``state``; each rank keeps its rows of the sharded leaves."""
        if self.sharded:
            tree = copy.deepcopy(tree)
            for path, _local in self._codebook_leaves(state):
                node = _parent(tree, path)
                node[path[-1]] = put_global(node[path[-1]], self.mesh).numpy()
        return train_state_from_jax(tree, state, what="checkpoint")

    # -- updates -------------------------------------------------------------

    def _quantize(self, model: VQVAE, z_e: torch.Tensor):
        """The VQ bottleneck on the trainer's mesh: the sharded search when
        ``n_code > 1``, counts and perplexity of the global batch (on one
        process, ``model.quantize``'s arithmetic)."""
        cfg = self.vq_cfg
        return quantize(z_e, model.codebook, cfg.beta, ema=cfg.ema_codebook,
                        precision=cfg.quantizer_precision, mesh=self.mesh, search=self._search)

    def _forward(self, model: VQVAE, x: torch.Tensor):
        z_e = model.encode(x)
        q = self._quantize(model, z_e)
        x_hat = model.decode(q.z_q)
        recon = torch.mean((x_hat - x) ** 2) / self.x_train_var
        return recon + q.loss, recon, q, z_e, x_hat

    def _update(self, state: TrainState, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One update of ``state`` in place on a device batch; device scalars out."""
        model, cfg = state.model, self.vq_cfg
        state.optimizer.zero_grad(set_to_none=True)
        with conv_fp32_precision(cfg.conv_precision):
            loss, recon, q, z_e, _x_hat = self._forward(model, x)
            loss.backward()
        self._reduce_gradients(model)
        state.optimizer.step()
        if cfg.ema_codebook:
            self._ema_update(state, z_e.detach(), q)
        state.step += 1
        return {"loss": loss.detach(), "recon_error": recon.detach(),
                "perplexity": q.perplexity.detach()}

    @torch.no_grad()
    def _reduce_gradients(self, model: VQVAE) -> None:
        """On a mesh of ranks: the replicated leaves' gradients summed over the
        world in one flat all-reduce and divided by its size, the codebook
        shard's summed over the data group and divided by ``n_data``."""
        mesh = self.mesh
        if not mesh.distributed:
            return
        mesh.mean_([p.grad for p in model.parameters()
                    if p.grad is not None and not (self.sharded and p is model.codebook)], "world")
        if self.sharded and model.codebook.grad is not None:
            mesh.psum(model.codebook.grad, "data").div_(mesh.n_data)

    @torch.no_grad()
    def _ema_update(self, state: TrainState, z_e: torch.Tensor, q) -> None:
        """EMA codebook update (van den Oord et al. 2017, appendix A.1), after
        the optimizer step, from the latents and assignments of this batch.

        On a mesh: the counts are the global batch's (``q.counts``), the sums
        of the latents are summed over the data group, and a codebook shard
        takes its rows of both; ``n_total`` is the sum over the whole
        codebook, all-reduced over the code group."""
        cfg, mesh = self.vq_cfg, self.mesh
        gamma, eps, k = cfg.ema_decay, cfg.ema_epsilon, cfg.n_embeddings
        z_flat = z_e.reshape(-1, z_e.shape[-1])
        idx, counts = q.indices.reshape(-1).long(), q.counts
        if self.sharded:
            rows = mesh.code_rows(k)
            counts = counts[rows]
            idx = idx - rows.start
            mine = (idx >= 0) & (idx < rows.stop - rows.start)
            z_flat = torch.where(mine[:, None], z_flat, torch.zeros_like(z_flat))
            idx = torch.where(mine, idx, torch.zeros_like(idx))
        z_sums = scatter_add_rows(idx, z_flat, state.ema_means.shape[0])
        mesh.psum(z_sums, "data")
        state.ema_counts.mul_(gamma).add_(counts, alpha=1.0 - gamma)
        state.ema_means.mul_(gamma).add_(z_sums, alpha=1.0 - gamma)
        n_total = state.ema_counts.sum()
        if self.sharded:
            mesh.psum(n_total, "code")
        smoothed = (state.ema_counts + eps) / (n_total + k * eps) * n_total
        state.model.codebook.copy_(state.ema_means / smoothed[:, None])

    def _to_device(self, array, dtype=torch.float32) -> torch.Tensor:
        if not isinstance(array, torch.Tensor):
            array = torch.from_numpy(np.ascontiguousarray(array))
        return array.to(self.device, dtype=dtype, non_blocking=True)

    def _global_metrics(self, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """On a mesh: ``loss`` and ``recon_error`` of this rank's rows averaged
        over the data group, the global batch's (the perplexity already is)."""
        mesh = self.mesh
        if not mesh.distributed or mesh.n_data == 1:
            return metrics
        both = mesh.psum(torch.stack([metrics["loss"], metrics["recon_error"]]), "data")
        both = both / mesh.n_data
        return {**metrics, "loss": both[0], "recon_error": both[1]}

    def step(self, state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One update on ``batch`` (B, H, W, C), this rank's rows of the global
        batch; metrics are device scalars."""
        return state, self._global_metrics(self._update(state, self._to_device(batch)))

    def _run(self, state: TrainState, batches) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        per_step = [self._update(state, x) for x in batches]
        return state, self._global_metrics(
            {name: torch.stack([m[name] for m in per_step]) for name in METRIC_NAMES})

    def steps(self, state: TrainState, batches) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """K = len(batches) updates on stacked batches (K, B, H, W, C), staged
        to the device in one copy (a tensor already there is used as it is).
        Each metric comes back as a (K,) device tensor of per-step values."""
        return self._run(state, self._to_device(batches))

    def stage_dataset(self, data) -> None:
        """Place the training images on the device once."""
        self._device_data = self._to_device(data)

    def steps_by_index(self, state: TrainState, idx) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """K updates whose batches are gathered on the device from the staged
        dataset. idx: (K, B) integers, the only data that crosses over."""
        if self._device_data is None:
            raise RuntimeError("call stage_dataset() before steps_by_index()")
        idx = self._to_device(np.asarray(idx), dtype=torch.int64)
        return self._run(state, (self._device_data.index_select(0, ii) for ii in idx))

    @torch.no_grad()
    def eval_batch(self, state: TrainState, batch) -> Dict[str, torch.Tensor]:
        x = self._to_device(batch)
        with conv_fp32_precision(self.vq_cfg.conv_precision):
            loss, recon, q, _z_e, x_hat = self._forward(state.model, x)
        return {"loss": loss, "recon_error": recon, "perplexity": q.perplexity, "x_hat": x_hat}


def _parent(tree: dict, path: tuple) -> dict:
    for key in path[:-1]:
        tree = tree[key]
    return tree


def train_vqvae(
    vq_cfg: VQVAEConfig = VQVAEConfig(),
    train_cfg: TrainConfig = TrainConfig(),
    mesh_cfg: MeshConfig = MeshConfig(),
    dataset=None,
    verbose: bool = True,
    resume: bool = False,
    step_hook: Optional[Callable[[int], None]] = None,
    device: str = "cuda",
) -> Tuple[TrainState, MetricHistory, VQVAETrainer]:
    """The training loop of main.py:67-98.

    ``dataset``: optional (train, val, x_train_var, info) tuple to skip loading.
    ``resume``: restore the latest step-tagged checkpoint of this run name and
    go on from its step with its metric history, the sampler's schedule
    replayed so the run sees the batches it would have seen.
    ``step_hook``: optional callable(step_index), called after each completed
    update's metrics are logged (the fault-injection point of the tests).
    ``mesh_cfg``: the ranks' mesh (a process group must be up for more than
    one rank, ``parallel/distributed.py``). Each rank draws its data row's
    slice of every global batch and stages the whole set on its device; only
    rank 0 prints, writes the metrics file and writes checkpoints.
    """
    if dataset is None:
        dataset = load_dataset(train_cfg.dataset, train_cfg.data_dir)
    train_ds, _val_ds, x_train_var, info = dataset

    trainer = VQVAETrainer(vq_cfg, train_cfg, x_train_var=x_train_var, device=device,
                           mesh_cfg=mesh_cfg)
    state = trainer.init_state()
    primary = is_primary_host()

    history = MetricHistory()
    name = train_cfg.filename or readable_timestamp()
    start_step = 0
    if resume:
        ckpt = latest_checkpoint(train_cfg.results_dir, name)
        if ckpt is not None:
            check_hyperparameters_compatible(ckpt, vq_cfg.to_dict(), _TREE_FIELDS)
            tree, step, saved_metrics, _hp = read_state_tree(ckpt)
            state = trainer.load_tree(state, tree)
            history = MetricHistory.from_dict(saved_metrics)
            start_step = step + 1
            if verbose and primary:
                print(f"Resumed from {ckpt} at step {step}", flush=True)

    mesh = trainer.mesh
    sampler = ReplacementSampler(len(train_ds), train_cfg.batch_size, seed=train_cfg.seed,
                                 num_shards=mesh.n_data, shard_id=mesh.data)
    for _ in range(start_step):
        sampler.next_indices()
    logger = MetricLogger(
        log_interval=train_cfg.log_interval,
        jsonl_path=(
            f"{train_cfg.results_dir}/vqvae_{name}_metrics.jsonl"
            if train_cfg.save and primary else None
        ),
        is_primary=verbose and primary,
        restored=history,
    )
    hyperparameters = {
        **train_cfg.to_dict(),
        **vq_cfg.to_dict(),
        "x_train_var": x_train_var,
        "dataset_info": info,
    }
    ckpt_writer = AsyncCheckpointer()

    spd = max(1, train_cfg.steps_per_dispatch)
    li = train_cfg.log_interval
    use_device_data = (
        spd > 1
        and train_cfg.device_data
        and train_ds.data.nbytes <= train_cfg.device_data_max_bytes
    )
    if use_device_data:
        trainer.stage_dataset(train_ds.data)
    i = start_step
    try:
        while i < train_cfg.n_updates:
            # Chunks end exactly ON log-interval boundary steps (s % li == 0) so
            # the print and checkpoint cadence is the reference's (main.py:86).
            boundary = i if i % li == 0 else i + (li - i % li)
            k = min(spd, train_cfg.n_updates - i, boundary - i + 1)
            if k == 1:
                state, metrics = trainer.step(state, train_ds.data[sampler.next_indices()])
                metrics = {key: v[None] for key, v in metrics.items()}
            elif use_device_data:
                idx = np.stack([sampler.next_indices() for _ in range(k)])
                state, metrics = trainer.steps_by_index(state, idx)
            else:
                batches = np.stack([train_ds.data[sampler.next_indices()] for _ in range(k)])
                state, metrics = trainer.steps(state, batches)
            host = metrics_to_host(metrics)  # the chunk's one read of the device

            for j in range(k):
                step_idx = i + j
                history.append(
                    float(host["recon_error"][j]), float(host["loss"][j]),
                    float(host["perplexity"][j]), step_idx,
                )
                logger.log_step(history, step_idx)
                if step_hook is not None:
                    step_hook(step_idx)
            i += k
            last = i - 1
            if train_cfg.save and (last % li == 0 or i >= train_cfg.n_updates):
                tree = trainer.state_tree(state)  # a collective under codebook parallelism
                if primary:
                    ckpt_writer.save(
                        checkpoint_path(train_cfg.results_dir, name, last),
                        tree,
                        last,
                        metrics=history.to_dict(),
                        hyperparameters=hyperparameters,
                    )
    finally:
        # a crash mid-loop must still leave the last checkpoint durable for
        # resume-from-latest
        ckpt_writer.wait()
        logger.close()
    return state, history, trainer


__all__ = ["METRIC_NAMES", "TrainState", "VQVAETrainer", "metrics_to_host", "train_vqvae"]
