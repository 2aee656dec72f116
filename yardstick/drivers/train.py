"""Training traffic: ``steps_by_index`` of the configuration's trainer on a
set staged on the card, batches drawn by ``inputs.EpochOrder``, chunks of
``steps_per_dispatch`` updates with one read of the losses a chunk, which
the window makes behind the work (``run.Window``). With
``n_data`` > 1 each rank takes its slice of every global batch.

Set-up draws the weights and the set, builds the trainer and runs its first
three updates through the window's own call (one update, then two), keeping
what the reference check needs: the losses, the first gradient as the
optimizer got it, the weights after the third update. A whole chunk more
warms the window's shape. The window then goes on with the same trainer.
"""

from __future__ import annotations

import numpy as np
import torch

from yardstick import inputs, judge

FIRST_STEPS = 3
# the faults a training cell can have, planted in the reference put in the
# program's place (yardstick/control.py)
FAULTS = ("half_batch", "local_grad")


class TrainCell:
    unit_name = "yardstick.steps_by_index"
    counts = "updates"     # what ``attempted`` and ``failed`` count

    def __init__(self, spec, seed: int, device, rank: int = 0, mesh_cfg=None):
        self.spec, self.seed, self.device, self.rank = spec, seed, torch.device(device), rank
        self.cfg, self.traffic = spec.config, spec.traffic
        self.model = spec.model()
        self.mesh_cfg = mesh_cfg
        self.n_data = self.traffic.get("n_data", 1)
        self.nonfinite = 0

    # -- inputs --------------------------------------------------------------

    def make_inputs(self):
        t = self.traffic
        self.data, self.stats = self.model.make_data(t["n_train"], self.cfg, self.seed, self.device)
        self.params0 = inputs.weights(self.model.reference.param_specs(self.cfg), self.seed, self.device)
        self.order = inputs.EpochOrder(t["n_train"], t["batch_size"], self.seed)
        self.first_rows = self.order.take(FIRST_STEPS)

    def batch(self, rows: np.ndarray):
        return self.model.batch(self.data, rows)

    def loss_fn(self, params, batch):
        return self.model.loss(params, batch, self.cfg, self.stats)

    # -- the program ---------------------------------------------------------

    def _mine(self, rows: np.ndarray) -> np.ndarray:
        per = rows.shape[1] // self.n_data
        return rows[:, self.rank * per:(self.rank + 1) * per]

    def _run(self, rows: np.ndarray) -> np.ndarray:
        with torch.profiler.record_function(self.unit_name):
            losses = self.program.run(self._mine(rows))
        self.nonfinite += int((~np.isfinite(losses)).sum())
        return losses

    def build(self, mark=lambda name: None):
        """The inputs and the program, before its first update."""
        self.make_inputs()
        mark("inputs")
        self.program = self.model.Training(self.cfg, self.traffic, self.data, self.stats, self.params0,
                                           self.device, self.mesh_cfg)
        mark("program")

    def setup(self, mark=lambda name: None):
        self.build(mark)
        losses = list(self._run(self.first_rows[:1]))
        self.first_grad = {n: g.detach().clone() for n, g in self.program.first_gradient().items()}
        losses += list(self._run(self.first_rows[1:]))
        self.first_losses = [float(v) for v in losses]
        self.params3 = {n: p.detach().clone() for n, p in self.program.parameters().items()}
        mark("first updates")
        self._run(self.order.take(self.traffic["steps_per_dispatch"]))
        mark("warm chunk")
        self.nonfinite = 0

    def unit(self):
        """One chunk queued: (updates, images or grids, its losses on the
        device, for ``settle`` once they are there)."""
        k = self.traffic["steps_per_dispatch"]
        with torch.profiler.record_function(self.unit_name):
            losses = self.program.dispatch(self._mine(self.order.take(k)))
        return k, k * self.traffic["batch_size"], losses

    def settle(self, losses: np.ndarray):
        self.nonfinite += int((~np.isfinite(losses)).sum())

    def release(self):
        self.program = None
        torch.cuda.empty_cache()

    # -- the check -----------------------------------------------------------

    def reference(self, mode: str = "ieee", fault: str = None):
        """The reference's first updates on the same global rows, in
        ``mode``'s arithmetic; ``fault`` plants one of ``FAULTS``: half of
        each batch left out, the mean over the rest; or the gradient of the
        first rank's rows alone, the exchange between ranks left out."""
        batches = [self.batch(r) for r in self.first_rows]
        grad_rows = None
        if fault == "half_batch":
            batches = [_cut(b, 0.5) for b in batches]
        elif fault == "local_grad":
            grad_rows = lambda b: _cut(b, 1.0 / self.n_data)  # noqa: E731
        elif fault is not None:
            raise ValueError(f"unknown fault {fault!r}")
        return judge.reference_steps(self.loss_fn, self.params0, batches, self.cfg["learning_rate"],
                                     self.model.optimizer(self.cfg), mode, grad_rows)

    def numbers(self, program_side=None):
        """The compared numbers of the program's first updates (or of
        ``program_side`` = (losses, first gradient, weights) put in its
        place) against the reference."""
        ref = self.reference()
        prog = program_side or (self.first_losses, self.first_grad, self.params3)
        numbers, _left_out = judge.training(*prog, *ref, self.params0)
        return numbers

    def left_out(self):
        ref = self.reference()
        return judge.training(*ref, *ref, self.params0)[1]

    def check(self, limits: dict):
        """(numbers, updates of the window whose loss was not finite)."""
        return self.numbers(), self.nonfinite

    # -- the readings the limits are set from (``control.py``) ---------------

    def program_numbers(self):
        """The numbers of set-up's first updates, once the program is freed."""
        self.release()
        return self.numbers()

    def control_numbers(self, fault: str = None):
        """The reference in the program's place: in TF32, or with ``fault``."""
        self.make_inputs()
        return self.numbers(program_side=self.reference("ieee" if fault else "tf32", fault))


def _cut(batch, share: float):
    if isinstance(batch, tuple):
        return tuple(_cut(b, share) for b in batch)
    return batch[: max(1, int(batch.shape[0] * share))]


CELL = TrainCell
