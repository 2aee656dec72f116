"""One file a model: ``models/<model>.py``, found by the ``"model"`` of a
configuration file (``spec.Cell.model``). It holds everything the harness
chooses by model:

- ``reference``: the plain module of ``reference/``, which imports nothing
  of the program; its ``param_specs(cfg)`` lists the weights drawn from the
  seed;
- ``Training(cfg, traffic, data, stats, params, device, mesh_cfg)``: the
  program's trainer built on the seeded weights and the set staged on the
  device, with ``dispatch(idx)``, ``run(idx)``, ``first_gradient()`` and
  ``parameters()`` (``TrainingAdapter`` below); ``Extraction(cfg, params,
  device)`` where the model's traffic extracts codes;
- ``make_data(n, cfg, seed, device) -> (data, stats)``: ``n`` items of the
  training set drawn from the seed, and what the loss needs of the whole set
  (None where nothing); ``batch(data, rows)``: the batch of those rows;
- ``loss(params, batch, cfg, stats)``: the reference's loss;
- ``optimizer(cfg) -> (kind, b1, b2, eps)``: the optimizer of
  ``reference/optim.py`` and its constants, which the reference steps with
  and by which ``first_gradient`` reads the gradient out of the first moment;
- ``flop_per_item(cfg, kind)``: model FLOP of one item of the traffic's
  ``flop_kind``, from the frozen formulas of ``flops.py``;
- ``rows_per_item(cfg)``: the latent rows that one item sends through the
  nearest-code search, or None;
- ``SMALL``: the widths that the CPU tests shrink the configuration to.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


class TrainingAdapter:
    """The face that every model's ``Training`` shows the drivers, over the
    port's trainers: ``dispatch(idx)`` queues one call of the trainer's
    ``steps_by_index`` on (k, rows) indices into the staged set and returns
    the chunk's (k,) losses on the device without waiting for them;
    ``run(idx)`` reads them back, once a chunk, as the port's training loops
    do; ``first_gradient()`` is the gradient the optimizer was given, worked
    out from its first moment after one update (``b1`` its decay);
    ``parameters()`` the current weights by name. A subclass sets
    ``trainer``, ``state`` and ``b1``."""

    trainer = state = None
    b1: float

    def dispatch(self, idx: np.ndarray) -> torch.Tensor:
        raise NotImplementedError

    def run(self, idx: np.ndarray) -> np.ndarray:
        return self.dispatch(idx).cpu().numpy()

    def first_gradient(self) -> Dict[str, torch.Tensor]:
        opt = self.state.optimizer
        key = opt.MOMENTS["mu"]
        # after one update the first moment is (1 - b1) * g
        return {n: opt.state[p][key] / (1.0 - self.b1) for n, p in self.parameters().items()}

    def parameters(self) -> Dict[str, torch.Tensor]:
        return dict(self.state.model.named_parameters())
