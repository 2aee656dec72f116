"""The VQ-VAE of MishaLaskin/vqvae on the port's ``VQVAETrainer`` and
``pipelines.extract.extract_latents`` (``models/__init__.py`` lists what a
model file holds)."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from yardstick import flops, inputs
from yardstick.models import TrainingAdapter
from yardstick.reference import vqvae as reference

SMALL = dict(n_hiddens=16, n_residual_hiddens=8, embedding_dim=16, n_embeddings=32)


class Training(TrainingAdapter):
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
        self.b1 = optimizer(cfg)[1]

    def dispatch(self, idx: np.ndarray) -> torch.Tensor:
        self.state, metrics = self.trainer.steps_by_index(self.state, idx)
        return metrics["loss"]


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


def make_data(n: int, cfg: dict, seed: int, device):
    """(n, side, side, 3) images and the reference's x_train_var."""
    return inputs.images(n, seed, device, cfg["image_size"])


def batch(data: torch.Tensor, rows: np.ndarray) -> torch.Tensor:
    return data.index_select(0, torch.from_numpy(rows).to(data.device))


def loss(params, batch, cfg: dict, x_train_var: float) -> torch.Tensor:
    return reference.loss(params, batch, cfg, x_train_var)


def optimizer(cfg: dict):
    """torch 1.1's Adam(amsgrad=True), the source's defaults."""
    return "amsgrad", 0.9, 0.999, 1e-8


def flop_per_item(cfg: dict, kind: str) -> int:
    """An image of a train step (``train``) or of encode + search (``encode``)."""
    keys = ("in_channels", "n_hiddens", "n_residual_hiddens", "n_residual_layers",
            "embedding_dim", "n_embeddings")
    kw = {k: cfg[k] for k in keys}
    kw["img_hw"] = cfg["image_size"]
    if kind == "train":
        return flops.train_step_flops_per_image(**kw)
    if kind == "encode":
        return flops.encode_quantize_flops_per_image(**kw)
    raise ValueError(f"no FLOP formula for a VQ-VAE's {kind!r}")


def rows_per_item(cfg: dict) -> int:
    """Two stride-2 convolutions: a latent row for each 4x4 patch."""
    return (cfg["image_size"] // 4) ** 2
