"""GatedPixelCNN prior training (port of ``vqvae_tpu/train/pixelcnn_train.py``;
reference pixelcnn/gated_pixelcnn.py:78-169).

One update is the prior's forward over a batch of code grids, the mean
cross-entropy over every code of the batch, backward and plain Adam::

    loss = F.cross_entropy(logits.reshape(-1, K), x.reshape(-1))   (gated_pixelcnn.py:92-97)

which is the JAX package's ``optax.softmax_cross_entropy_with_integer_labels``
and mean. The optimizer is torch's Adam (``train/optim.py::Adam``): for plain
Adam, unlike the VQ-VAE's AMSGrad, torch 2.x's update is optax's.

``conv_precision`` is held around the forward AND ``backward()``, on the
caller's thread, as ``VQVAETrainer`` does: cuDNN reads the TF32 switch when
autograd runs the backward convolutions. Nothing in the backward enters the
scope itself: on a CUDA device the backward runs on autograd's device thread
while the caller holds the scope's lock, and would wait for it forever.

Nothing inside a chunk of updates reads the device back: the per-step losses
stay device scalars and cross to the host stacked, once per chunk, in
``train_pixelcnn``. ``steps`` and ``steps_by_index`` are a plain loop of K
updates in the order of K calls of ``step``.

Data parallelism (``MeshConfig``, ``parallel/``; the JAX trainer's 1-D mesh
over ``data``): one process a rank, ``n_data`` ranks. A rank trains on its
slice of every global batch of ``batch_size`` (the samplers' shard), holds
the whole model and Adam state, and stages the whole grid set (as JAX
replicates it). After ``backward()`` the gradients are all-reduced as one flat
buffer by mean over the ranks, so every rank applies the same update and the
replicas stay bit-identical. The losses a chunk reads back are means over the
ranks, the global batch's, so the history and the best-validation decision
agree on every rank. Rank 0 alone prints and writes the checkpoint; every
rank reads it on resume. A run of one rank (the trivial mesh) skips every
collective and keeps its bits. The prior has no codebook to shard, so
``n_code > 1`` is refused.

Draws. The JAX package folds a counter into a ``PRNGKey`` (the train step in
``generate``, the epoch for the per-epoch samples, from ``seed + 17``); the
port cannot reproduce those bits and seeds a ``torch.Generator`` on the
trainer's device with ``draw_seed(seed, n) = (seed mod 2**32) * 2**32 +
(n mod 2**32)`` instead, so a run's draws replay from its seed.
"""

from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vqvae_tpu_torch.config import MeshConfig, PixelCNNConfig, TrainConfig
from vqvae_tpu_torch.data.datasets import ArrayDataset
from vqvae_tpu_torch.data.sampler import EpochSampler
from vqvae_tpu_torch.device import resolve_device
from vqvae_tpu_torch.models.pixelcnn import GatedPixelCNN
from vqvae_tpu_torch.models.pixelcnn_sampler import CachedPixelCNNSampler
from vqvae_tpu_torch.ops.conv import conv_fp32_precision
from vqvae_tpu_torch.parallel.distributed import is_primary_host
from vqvae_tpu_torch.parallel.mesh import make_mesh
from vqvae_tpu_torch.train.checkpoint import (
    AsyncCheckpointer,
    check_hyperparameters_compatible,
    load_checkpoint,
)
from vqvae_tpu_torch.train.optim import Adam
from vqvae_tpu_torch.utils.profiling import annotate

# model fields that change the state's tree: a resume must match them
_TREE_FIELDS = ("input_dim", "dim", "n_layers", "n_classes")
# labels of the per-epoch samples: 10 of each class (reference gated_pixelcnn.py:143-149)
SAMPLE_LABELS = np.repeat(np.arange(10, dtype=np.int32), 10)


def draw_seed(seed: int, n: int) -> int:
    """The seed of the ``n``-th draw of a run seeded ``seed`` (module docstring)."""
    return (int(seed) % 2**32) * 2**32 + int(n) % 2**32


@dataclass
class PixelCNNState:
    """What training changes, updated in place by every step."""

    model: GatedPixelCNN
    optimizer: Adam
    step: int = 0                                  # completed updates, on the host


class PixelCNNTrainer:
    """Owns the configs and the update; reusable by the CLI, tests and timing scripts."""

    def __init__(
        self,
        cfg: PixelCNNConfig = PixelCNNConfig(),
        train_cfg: TrainConfig = TrainConfig(),
        device: str = "cuda",
        mesh_cfg: MeshConfig = MeshConfig(),
    ):
        self.cfg = cfg
        self.train_cfg = train_cfg
        self.device = resolve_device(device)
        if mesh_cfg.n_code != 1:
            raise ValueError(f"the prior's mesh is 1-D over data; n_code must be 1, got {mesh_cfg.n_code}")
        self.mesh = make_mesh(mesh_cfg.n_data, 1)
        self._device_data: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._device_val: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    # -- state ---------------------------------------------------------------

    def init_state(self, generator: Optional[torch.Generator] = None) -> PixelCNNState:
        """A fresh state: torch-default initial weights (reference
        pixelcnn/models.py:10-17) drawn on the CPU from ``generator`` (default:
        one seeded with ``train_cfg.seed``), zero Adam moments."""
        gen = generator if generator is not None else torch.Generator().manual_seed(self.train_cfg.seed)
        model = GatedPixelCNN(self.cfg)
        model.reset_parameters(gen)
        model.to(self.device)
        return PixelCNNState(model, Adam(model.parameters(), self.train_cfg.learning_rate))

    # -- updates -------------------------------------------------------------

    def _loss(self, model: GatedPixelCNN, x: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
        logits = model(x, label)  # (B, H, W, K) fp32
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), x.reshape(-1))

    def _update(self, state: PixelCNNState, x: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
        """One update of ``state`` in place on a device batch; the loss as a device scalar."""
        state.optimizer.zero_grad(set_to_none=True)
        with conv_fp32_precision(self.cfg.conv_precision):
            with annotate("train.forward"):
                loss = self._loss(state.model, x, label)
            with annotate("train.backward"):
                loss.backward()
        self._reduce_gradients(state.model)
        state.optimizer.step()
        state.step += 1
        return loss.detach()

    @torch.no_grad()
    def _reduce_gradients(self, model: GatedPixelCNN) -> None:
        """On a mesh of ranks: every gradient averaged over the ranks in one
        flat all-reduce."""
        self.mesh.mean_([p.grad for p in model.parameters() if p.grad is not None], "world")

    def _global(self, losses: torch.Tensor) -> torch.Tensor:
        """This rank's losses -> the global batch's: the mean over the data
        ranks (a copy; nothing on one rank)."""
        if not self.mesh.distributed or self.mesh.n_data == 1:
            return losses
        return self.mesh.psum(losses.clone(), "data").div_(self.mesh.n_data)

    def _to_device(self, array) -> torch.Tensor:
        """Codes and labels as int64 on the device (what the embedding
        gather and the cross-entropy take, so no cast per step)."""
        if not isinstance(array, torch.Tensor):
            array = torch.from_numpy(np.ascontiguousarray(array))
        return array.to(self.device, dtype=torch.int64, non_blocking=True)

    def step(self, state: PixelCNNState, x, label) -> Tuple[PixelCNNState, torch.Tensor]:
        """One update on codes ``x`` (B, H, W) with class ``label`` (B,), this
        rank's rows of the global batch; the global batch's loss."""
        with annotate("train.batch"):
            x, label = self._to_device(x), self._to_device(label)
        return state, self._global(self._update(state, x, label))

    def _run(self, state: PixelCNNState, batches) -> Tuple[PixelCNNState, torch.Tensor]:
        return state, self._global(torch.stack([self._update(state, x, label) for x, label in batches]))

    def steps(self, state: PixelCNNState, xs, labels) -> Tuple[PixelCNNState, torch.Tensor]:
        """K = len(xs) updates on stacked batches (K, B, H, W) and labels
        (K, B), staged to the device in one copy each; the (K,) losses."""
        with annotate("train.batch"):
            xs, labels = self._to_device(xs), self._to_device(labels)
        return self._run(state, zip(xs, labels))

    def stage_dataset(self, train_ds: ArrayDataset, val_ds: ArrayDataset) -> None:
        """Place the (small) code grids and labels on the device once."""
        self._device_data = (self._to_device(train_ds.data), self._to_device(train_ds.labels))
        self._device_val = (self._to_device(val_ds.data), self._to_device(val_ds.labels))

    def _gathered(self, staged, idx):
        if staged is None:
            raise RuntimeError("call stage_dataset() before steps_by_index() or eval_by_index()")
        data, labels = staged
        with annotate("train.batch"):
            idx = self._to_device(np.asarray(idx))
        for ii in idx:
            with annotate("train.batch"):
                batch = data.index_select(0, ii), labels.index_select(0, ii)
            yield batch

    def steps_by_index(self, state: PixelCNNState, idx) -> Tuple[PixelCNNState, torch.Tensor]:
        """K updates whose batches are gathered on the device from the staged
        training grids. idx: (K, B) integers, the only data that crosses over."""
        return self._run(state, self._gathered(self._device_data, idx))

    @torch.no_grad()
    def eval_loss(self, state: PixelCNNState, x, label) -> torch.Tensor:
        """The mean cross-entropy of one batch (the global batch's on a mesh), a device scalar."""
        with conv_fp32_precision(self.cfg.conv_precision):
            return self._global(self._loss(state.model, self._to_device(x), self._to_device(label)))

    @torch.no_grad()
    def eval_by_index(self, state: PixelCNNState, idx) -> torch.Tensor:
        """(K,) validation losses of the batches (K, B) gathered from the staged grids."""
        with conv_fp32_precision(self.cfg.conv_precision):
            return self._global(torch.stack([self._loss(state.model, x, label)
                                             for x, label in self._gathered(self._device_val, idx)]))

    # -- sampling ------------------------------------------------------------

    def generate(self, state: PixelCNNState, labels, generator: Optional[torch.Generator] = None,
                 shape: Optional[Tuple[int, int]] = None, cached: bool = True) -> np.ndarray:
        """Autoregressive samples, (B, H, W) int32 codes for the class ``labels``.

        cached=True: the row- and column-cached decoder, built anew on every
        call because it copies the weights when it is made (a sampler kept
        from an earlier epoch would draw from that epoch's weights).
        cached=False: one full forward a pixel (``GatedPixelCNN.generate``,
        the reference's semantics and the oracle). Both draw the same grids
        from one generator. Default generator: ``draw_seed(seed, state.step)``.
        """
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(
                draw_seed(self.train_cfg.seed, state.step))
        shape = shape or (self.cfg.img_dim, self.cfg.img_dim)
        label = torch.as_tensor(np.asarray(labels), device=self.device).long()
        if cached:
            grids = CachedPixelCNNSampler(state.model).generate(label, generator, shape, len(label))
        else:
            grids = state.model.generate(label, generator, shape, len(label))
        return grids.cpu().numpy()


def train_pixelcnn(
    cfg: PixelCNNConfig,
    train_cfg: TrainConfig,
    train_ds: ArrayDataset,
    val_ds: ArrayDataset,
    verbose: bool = True,
    save_path: Optional[str] = None,
    resume: bool = False,
    device: str = "cuda",
    mesh_cfg: MeshConfig = MeshConfig(),
) -> Tuple[PixelCNNState, Dict[str, Any]]:
    """The best-validation epoch loop (reference gated_pixelcnn.py:153-169).

    Epochs run ``range(start_epoch, epochs)`` from 1, as the reference's
    loop. Batches are uniform: the training sampler drops the tail batch,
    and so does validation (unshuffled). After each epoch the state is
    saved to ``save_path`` when ``train_cfg.save`` or the validation loss is
    the best so far, tagged with the epoch.
    ``resume``: restore ``save_path`` (if present) and continue from the
    epoch after its tag, with both samplers' schedules replayed so the run
    sees the batches an uninterrupted run would have.
    ``train_cfg.gen_samples``: 10 samples of each class after every epoch
    (reference gated_pixelcnn.py:143-149) through the cached decoder, from
    ``draw_seed(seed + 17, epoch)``; returned under "samples".
    ``mesh_cfg``: the data ranks (a process group must be up for more than
    one, ``parallel/distributed.py``); each rank draws its slice of every
    global batch, only rank 0 prints and saves.

    Returns (state, {"history", "best_val_loss", "trainer", "samples"}).
    """
    trainer = PixelCNNTrainer(cfg, train_cfg, device=device, mesh_cfg=mesh_cfg)
    state = trainer.init_state()
    mesh = trainer.mesh
    shard = dict(num_shards=mesh.n_data, shard_id=mesh.data)
    train_sampler = EpochSampler(len(train_ds), train_cfg.batch_size, seed=train_cfg.seed,
                                 drop_last=True, **shard)
    val_sampler = EpochSampler(len(val_ds), train_cfg.batch_size, seed=train_cfg.seed + 1,
                               shuffle=False, drop_last=True, **shard)
    primary = is_primary_host()
    verbose = verbose and primary

    best_loss, last_saved = math.inf, -1
    history = {"train_loss": [], "val_loss": []}
    start_epoch = 1
    if resume and save_path and os.path.exists(save_path):
        check_hyperparameters_compatible(save_path, cfg.to_dict(), _TREE_FIELDS)
        state, saved_epoch, saved_hist, _hp = load_checkpoint(save_path, state)
        history = {k: list(saved_hist.get(k, [])) for k in history}
        best_loss = min(history["val_loss"] or [math.inf])
        start_epoch, last_saved = saved_epoch + 1, saved_epoch
        for _ in range(start_epoch - 1):
            for _idx in train_sampler.epoch():
                pass
            for _idx in val_sampler.epoch():
                pass
        if verbose:
            print(f"Resumed from {save_path} at epoch {saved_epoch}", flush=True)

    ckpt_writer = AsyncCheckpointer()
    epoch_samples = []
    spd = max(1, train_cfg.steps_per_dispatch)
    li = train_cfg.log_interval
    if spd > 1:
        trainer.stage_dataset(train_ds, val_ds)
    try:
        for epoch in range(start_epoch, train_cfg.epochs):
            if verbose:
                print(f"\nEpoch {epoch}:", flush=True)
            epoch_losses = []
            t0 = time.time()
            epoch_idx = list(train_sampler.epoch())
            bi = 0
            while bi < len(epoch_idx):
                # chunks end ON the (bi + 1) % li == 0 print boundaries
                k = min(spd, len(epoch_idx) - bi, li - bi % li)
                if spd > 1:
                    state, losses = trainer.steps_by_index(state, np.stack(epoch_idx[bi:bi + k]))
                else:
                    idx = epoch_idx[bi]
                    state, loss = trainer.step(state, train_ds.data[idx], train_ds.labels[idx])
                    losses = loss[None]
                epoch_losses.extend(losses.cpu().tolist())  # the chunk's one read of the device
                bi += k
                if verbose and bi % li == 0:
                    print(f"\tIter [{bi}] Loss: {np.mean(epoch_losses[-li:]):.6f} "
                          f"Time: {time.time() - t0:.2f}", flush=True)
            history["train_loss"].append(float(np.mean(epoch_losses)))

            val_idx = list(val_sampler.epoch())
            if spd > 1 and val_idx:
                val_losses = trainer.eval_by_index(state, np.stack(val_idx)).cpu().tolist()
            else:
                val_losses = [float(trainer.eval_loss(state, val_ds.data[idx], val_ds.labels[idx]))
                              for idx in val_idx]
            cur = float(np.mean(val_losses)) if val_losses else math.inf
            history["val_loss"].append(cur)
            if verbose:
                print(f"Validation Completed!\tLoss: {cur:.6f}", flush=True)

            if train_cfg.save or cur <= best_loss:
                best_loss, last_saved = min(cur, best_loss), epoch
                if save_path and primary:
                    # a copy of the history: the writer thread serialises it
                    # while the next epoch appends
                    ckpt_writer.save(save_path, state, epoch,
                                     metrics={k: list(v) for k, v in history.items()},
                                     hyperparameters=cfg.to_dict())
                    if verbose:
                        print("Saving model!", flush=True)
            elif verbose:
                print(f"Not saving model! Last saved: {last_saved}", flush=True)

            if train_cfg.gen_samples:
                gen = torch.Generator(device=trainer.device).manual_seed(
                    draw_seed(train_cfg.seed + 17, epoch))
                grids = trainer.generate(state, SAMPLE_LABELS, generator=gen)
                epoch_samples.append(grids)
                if verbose:
                    print(f"Generated samples {grids.shape}", flush=True)
    finally:
        # a crash mid-loop still leaves the last checkpoint durable for resume
        ckpt_writer.wait()
    return state, {
        "history": history,
        "best_val_loss": best_loss,
        "trainer": trainer,
        "samples": epoch_samples,
    }


__all__ = ["PixelCNNState", "PixelCNNTrainer", "SAMPLE_LABELS", "draw_seed", "train_pixelcnn"]
