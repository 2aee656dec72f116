"""The benchmark's only contact with the program under test, the port
``vqvae_tpu_torch``: it builds the port's objects from a configuration file
and the benchmark's inputs, and calls the entry points that the cells time.

Each model is a small adapter with the same face: ``dispatch(idx)`` queues
one call of the trainer's ``steps_by_index`` on (k, rows) indices into the
staged set and returns the chunk's (k,) losses on the device without waiting
for them; ``run(idx)`` reads them back, once a chunk, as the port's training
loops do; ``first_gradient()`` is the gradient the optimizer was given, worked out
from its first moment after one update; ``parameters()`` the current
weights by name.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

_B1 = 0.9   # both optimizers' first-moment decay: after one update mu = (1 - b1) * g


def _named(model) -> Dict[str, torch.Tensor]:
    return dict(model.named_parameters())


class VQVAETraining:
    def __init__(self, cfg: dict, traffic: dict, data: torch.Tensor, x_train_var: float,
                 params: Dict[str, torch.Tensor], device, mesh_cfg=None):
        from vqvae_tpu_torch.config import MeshConfig, TrainConfig, VQVAEConfig
        from vqvae_tpu_torch.train.vqvae_train import VQVAETrainer

        train_cfg = TrainConfig(batch_size=traffic["batch_size"], learning_rate=cfg["learning_rate"],
                                steps_per_dispatch=traffic["steps_per_dispatch"])
        self.trainer = VQVAETrainer(VQVAEConfig.from_dict(cfg), train_cfg, x_train_var=x_train_var,
                                    device=str(device), mesh_cfg=mesh_cfg or MeshConfig())
        self.state = self.trainer.init_state()
        self.state.model.load_state_dict(params, strict=True)
        self.trainer.stage_dataset(data)

    def dispatch(self, idx: np.ndarray) -> torch.Tensor:
        self.state, metrics = self.trainer.steps_by_index(self.state, idx)
        return metrics["loss"]

    def run(self, idx: np.ndarray) -> np.ndarray:
        return self.dispatch(idx).cpu().numpy()

    def first_gradient(self) -> Dict[str, torch.Tensor]:
        opt = self.state.optimizer
        key = opt.MOMENTS["mu"]
        return {n: opt.state[p][key] / (1.0 - _B1) for n, p in _named(self.state.model).items()}

    def parameters(self) -> Dict[str, torch.Tensor]:
        return _named(self.state.model)


class PriorTraining:
    def __init__(self, cfg: dict, traffic: dict, data, x_train_var: Optional[float],
                 params: Dict[str, torch.Tensor], device, mesh_cfg=None):
        from vqvae_tpu_torch.config import MeshConfig, PixelCNNConfig, TrainConfig
        from vqvae_tpu_torch.data.datasets import ArrayDataset
        from vqvae_tpu_torch.train.pixelcnn_train import PixelCNNTrainer

        train_cfg = TrainConfig(batch_size=traffic["batch_size"], learning_rate=cfg["learning_rate"],
                                steps_per_dispatch=traffic["steps_per_dispatch"])
        self.trainer = PixelCNNTrainer(PixelCNNConfig.from_dict(cfg), train_cfg, device=str(device),
                                       mesh_cfg=mesh_cfg or MeshConfig())
        self.state = self.trainer.init_state()
        self.state.model.load_state_dict(params, strict=True)
        codes, labels = data
        # the validation set is not read by the timed calls: one grid stands in
        self.trainer.stage_dataset(ArrayDataset(codes, labels), ArrayDataset(codes[:1], labels[:1]))

    def dispatch(self, idx: np.ndarray) -> torch.Tensor:
        self.state, losses = self.trainer.steps_by_index(self.state, idx)
        return losses

    run = VQVAETraining.run
    first_gradient = VQVAETraining.first_gradient
    parameters = VQVAETraining.parameters


TRAINING = {"vqvae": VQVAETraining, "gated_pixelcnn": PriorTraining}


class Extraction:
    """``pipelines.extract.extract_latents`` over a host-resident set."""

    def __init__(self, cfg: dict, params: Dict[str, torch.Tensor], device):
        from vqvae_tpu_torch.config import VQVAEConfig
        from vqvae_tpu_torch.models.vqvae import VQVAE
        from vqvae_tpu_torch.pipelines.extract import extract_latents

        self._extract = extract_latents
        self.model = VQVAE(VQVAEConfig.from_dict(cfg)).to(device)
        self.model.load_state_dict(params, strict=True)

    def run(self, data: np.ndarray, batch_size: int) -> np.ndarray:
        return self._extract(self.model, data, batch_size=batch_size)


def bring_up(n_data: int, rank: int, port: int, device):
    """Join the program's process group the way ``train-vqvae --distributed``
    does (``parallel/distributed.py``); returns the MeshConfig and the
    rank's device."""
    from vqvae_tpu_torch.config import MeshConfig
    from vqvae_tpu_torch.parallel.distributed import maybe_initialize_distributed

    mesh_cfg = MeshConfig(n_data=n_data, n_code=1, distributed=True,
                          coordinator_address=f"localhost:{port}", num_processes=n_data,
                          process_id=rank)
    return mesh_cfg, maybe_initialize_distributed(mesh_cfg, device)


def shut_down():
    from vqvae_tpu_torch.parallel.distributed import shutdown_distributed

    shutdown_distributed()


def build_kernels():
    """Build the port's nvcc library once, before any rank needs it."""
    from vqvae_tpu_torch.ops import cuda_quantizer

    cuda_quantizer.build()
