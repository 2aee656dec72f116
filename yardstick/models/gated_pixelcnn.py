"""The class-conditional GatedPixelCNN prior of MishaLaskin/vqvae on the
port's ``PixelCNNTrainer`` (``models/__init__.py`` lists what a model file
holds)."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from yardstick import flops, inputs
from yardstick.models import TrainingAdapter
from yardstick.reference import gated_pixelcnn as reference

SMALL = dict(dim=16, n_layers=3, input_dim=32)


class Training(TrainingAdapter):
    def __init__(self, cfg: dict, traffic: dict, data, stats: Optional[float],
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
        self.b1 = optimizer(cfg)[1]

    def dispatch(self, idx: np.ndarray) -> torch.Tensor:
        self.state, losses = self.trainer.steps_by_index(self.state, idx)
        return losses


def make_data(n: int, cfg: dict, seed: int, device):
    """(n, side, side) code grids and (n,) class labels; the loss needs no
    statistic of the set."""
    return inputs.code_grids(n, cfg["img_dim"], cfg["input_dim"], cfg["n_classes"], seed, device), None


def batch(data, rows: np.ndarray):
    codes, labels = data
    idx = torch.from_numpy(rows).to(codes.device)
    return codes.index_select(0, idx).long(), labels.index_select(0, idx).long()


def loss(params, batch, cfg: dict, stats=None) -> torch.Tensor:
    return reference.loss(params, batch, cfg)


def optimizer(cfg: dict):
    """torch.optim.Adam's defaults, the source's."""
    return "adam", 0.9, 0.999, 1e-8


def flop_per_item(cfg: dict, kind: str) -> int:
    """A grid of the prior's train step (``prior``)."""
    if kind != "prior":
        raise ValueError(f"no FLOP formula for a GatedPixelCNN's {kind!r}")
    return flops.pixelcnn_train_step_flops_per_grid(
        img_dim=cfg["img_dim"], dim=cfg["dim"], n_layers=cfg["n_layers"], input_dim=cfg["input_dim"])


def rows_per_item(cfg: dict) -> None:
    """The prior sends nothing through the nearest-code search."""
    return None
