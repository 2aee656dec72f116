"""VQ-VAE training (port of ``vqvae_tpu/train/vqvae_train.py``; reference main.py:49-98).

One update is forward, loss, backward, the hand-written torch-1.1 AMSGrad
step and, with an EMA codebook, the EMA update:

    recon_loss = mean((x_hat - x)^2) / x_train_var          (main.py:75-76)
    loss       = recon_loss + embedding_loss

On a CUDA device the forward's nearest-code search is the hand-written kernel
(``ops/cuda_quantizer.py``: route "fma" for the "highest" quantizer mode,
"mma" for "default"/"high"), its backward an ``index_add_`` scatter-add.

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

``index_add_`` adds with atomics on a CUDA device, so the codebook gradient
and the EMA sums can differ in their last bits from run to run there; on the
CPU a run repeats bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from vqvae_tpu_torch.config import TrainConfig, VQVAEConfig
from vqvae_tpu_torch.data.datasets import load_dataset
from vqvae_tpu_torch.data.sampler import ReplacementSampler
from vqvae_tpu_torch.device import resolve_device
from vqvae_tpu_torch.models.vqvae import VQVAE
from vqvae_tpu_torch.ops.conv import conv_fp32_precision
from vqvae_tpu_torch.train.checkpoint import (
    AsyncCheckpointer,
    check_hyperparameters_compatible,
    checkpoint_path,
    latest_checkpoint,
    load_checkpoint,
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
    ):
        self.vq_cfg = vq_cfg
        self.train_cfg = train_cfg
        self.x_train_var = float(x_train_var)
        self.device = resolve_device(device)
        self.generator = generator
        self._device_data: Optional[torch.Tensor] = None

    # -- state ---------------------------------------------------------------

    def init_state(self, generator: Optional[torch.Generator] = None) -> TrainState:
        """A fresh state: torch-default initial weights drawn on the CPU from
        ``generator`` (default: the trainer's, else one seeded with
        ``train_cfg.seed``), zero optimizer moments, EMA means = the codebook."""
        gen = generator or self.generator
        if gen is None:
            gen = torch.Generator().manual_seed(self.train_cfg.seed)
        model = VQVAE(self.vq_cfg)
        model.reset_parameters(gen)
        model.to(self.device)
        optimizer = make_optimizer(
            model.parameters(), self.train_cfg.learning_rate, self.train_cfg.amsgrad_impl
        )
        state = TrainState(model, optimizer)
        if self.vq_cfg.ema_codebook:
            state.ema_counts = torch.zeros(self.vq_cfg.n_embeddings, device=self.device)
            state.ema_means = model.codebook.detach().clone()
        return state

    # -- updates -------------------------------------------------------------

    def _forward(self, model: VQVAE, x: torch.Tensor):
        z_e = model.encode(x)
        q = model.quantize(z_e)
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
        state.optimizer.step()
        if cfg.ema_codebook:
            self._ema_update(state, z_e.detach(), q)
        state.step += 1
        return {"loss": loss.detach(), "recon_error": recon.detach(),
                "perplexity": q.perplexity.detach()}

    @torch.no_grad()
    def _ema_update(self, state: TrainState, z_e: torch.Tensor, q) -> None:
        """EMA codebook update (van den Oord et al. 2017, appendix A.1), after
        the optimizer step, from the latents and assignments of this batch."""
        cfg = self.vq_cfg
        gamma, eps, k = cfg.ema_decay, cfg.ema_epsilon, cfg.n_embeddings
        z_flat = z_e.reshape(-1, z_e.shape[-1])
        z_sums = torch.zeros_like(state.ema_means).index_add_(0, q.indices.reshape(-1), z_flat)
        state.ema_counts.mul_(gamma).add_(q.counts, alpha=1.0 - gamma)
        state.ema_means.mul_(gamma).add_(z_sums, alpha=1.0 - gamma)
        n_total = state.ema_counts.sum()
        smoothed = (state.ema_counts + eps) / (n_total + k * eps) * n_total
        state.model.codebook.copy_(state.ema_means / smoothed[:, None])

    def _to_device(self, array, dtype=torch.float32) -> torch.Tensor:
        if not isinstance(array, torch.Tensor):
            array = torch.from_numpy(np.ascontiguousarray(array))
        return array.to(self.device, dtype=dtype, non_blocking=True)

    def step(self, state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One update on ``batch`` (B, H, W, C); metrics are device scalars."""
        return state, self._update(state, self._to_device(batch))

    def _run(self, state: TrainState, batches) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        per_step = [self._update(state, x) for x in batches]
        return state, {name: torch.stack([m[name] for m in per_step]) for name in METRIC_NAMES}

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


def train_vqvae(
    vq_cfg: VQVAEConfig = VQVAEConfig(),
    train_cfg: TrainConfig = TrainConfig(),
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
    """
    if dataset is None:
        dataset = load_dataset(train_cfg.dataset, train_cfg.data_dir)
    train_ds, _val_ds, x_train_var, info = dataset

    trainer = VQVAETrainer(vq_cfg, train_cfg, x_train_var=x_train_var, device=device)
    state = trainer.init_state()

    history = MetricHistory()
    name = train_cfg.filename or readable_timestamp()
    start_step = 0
    if resume:
        ckpt = latest_checkpoint(train_cfg.results_dir, name)
        if ckpt is not None:
            check_hyperparameters_compatible(ckpt, vq_cfg.to_dict(), _TREE_FIELDS)
            state, step, saved_metrics, _hp = load_checkpoint(ckpt, state)
            history = MetricHistory.from_dict(saved_metrics)
            start_step = step + 1
            if verbose:
                print(f"Resumed from {ckpt} at step {step}", flush=True)

    sampler = ReplacementSampler(len(train_ds), train_cfg.batch_size, seed=train_cfg.seed)
    for _ in range(start_step):
        sampler.next_indices()
    logger = MetricLogger(
        log_interval=train_cfg.log_interval,
        jsonl_path=(
            f"{train_cfg.results_dir}/vqvae_{name}_metrics.jsonl" if train_cfg.save else None
        ),
        is_primary=verbose,
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
                ckpt_writer.save(
                    checkpoint_path(train_cfg.results_dir, name, last),
                    state,
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
