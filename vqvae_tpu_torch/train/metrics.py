"""Metric history and logging (the port's copy of ``vqvae_tpu/train/metrics.py``, numpy only).

The reference's metric contract (main.py:59-64, 81-98): per-step lists of
recon_errors / loss_vals / perplexities plus an update counter, with windowed
means printed every ``log_interval`` steps, and a JSONL file with one record
per step.

One difference from the JAX package, on purpose: the JSONL file is written
anew when a run starts. A resumed run passes the history it restored from
the checkpoint, whose steps are written first, so every step stands in the
file once (the JAX logger appends, and repeats the steps between the last
checkpoint and the crash).
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


def readable_timestamp() -> str:
    """Same formatting as the reference (utils.py:101-103)."""
    return time.ctime().replace("  ", " ").replace(" ", "_").replace(":", "_").lower()


@dataclass
class MetricHistory:
    """Per-step metric lists (reference ``results`` dict, main.py:59-64)."""

    recon_errors: List[float] = field(default_factory=list)
    loss_vals: List[float] = field(default_factory=list)
    perplexities: List[float] = field(default_factory=list)
    n_updates: int = 0

    def append(self, recon_error: float, loss: float, perplexity: float, step: int):
        self.recon_errors.append(float(recon_error))
        self.loss_vals.append(float(loss))
        self.perplexities.append(float(perplexity))
        self.n_updates = step

    def window_means(self, window: int) -> Dict[str, float]:
        return {
            "recon_error": float(np.mean(self.recon_errors[-window:])),
            "loss": float(np.mean(self.loss_vals[-window:])),
            "perplexity": float(np.mean(self.perplexities[-window:])),
        }

    def record(self, i: int) -> Dict[str, float]:
        """The JSONL record of the i-th step held (-1: the newest)."""
        return {
            "recon_error": self.recon_errors[i],
            "loss": self.loss_vals[i],
            "perplexity": self.perplexities[i],
        }

    def to_dict(self) -> Dict:
        return {
            "recon_errors": list(self.recon_errors),
            "loss_vals": list(self.loss_vals),
            "perplexities": list(self.perplexities),
            "n_updates": self.n_updates,
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "MetricHistory":
        m = cls()
        m.recon_errors = [float(v) for v in d.get("recon_errors", [])]
        m.loss_vals = [float(v) for v in d.get("loss_vals", [])]
        m.perplexities = [float(v) for v in d.get("perplexities", [])]
        m.n_updates = int(d.get("n_updates", 0))
        return m


class MetricLogger:
    """Windowed-mean prints (reference main.py:95-98 cadence) + optional JSONL.

    ``restored``: the history a resumed run starts from (steps 0 .. n-1); its
    records open the new JSONL file.
    """

    def __init__(
        self,
        log_interval: int = 50,
        jsonl_path: Optional[str] = None,
        is_primary: bool = True,
        restored: Optional[MetricHistory] = None,
    ):
        self.log_interval = log_interval
        self.jsonl_path = jsonl_path
        self.is_primary = is_primary
        self._jsonl_file = None
        if jsonl_path:
            os.makedirs(os.path.dirname(jsonl_path) or ".", exist_ok=True)
            self._jsonl_file = open(jsonl_path, "w")
            if restored is not None:
                for step in range(len(restored.loss_vals)):
                    self._write({"step": step, **restored.record(step)})

    def _write(self, rec: Dict) -> None:
        self._jsonl_file.write(json.dumps(rec) + "\n")

    def log_step(self, history: MetricHistory, step: int, extra: Optional[Dict] = None):
        if self._jsonl_file is not None:
            self._write({"step": step, **history.record(-1), **(extra or {})})
        if self.is_primary and step % self.log_interval == 0:
            m = history.window_means(self.log_interval)
            print(
                "Update #", step, "Recon Error:", m["recon_error"], "Loss", m["loss"],
                "Perplexity:", m["perplexity"], flush=True,
            )

    def close(self):
        if self._jsonl_file is not None:
            self._jsonl_file.close()
            self._jsonl_file = None


__all__ = ["MetricHistory", "MetricLogger", "readable_timestamp"]
