"""Fault injection for crash-resume tests (the port's copy of ``vqvae_tpu/utils/faults.py``).

The training loop's contract: crash at any step, run again with
``resume=True``, and training continues from the latest durable checkpoint
with the batch schedule replayed, reaching the state an uninterrupted run
reaches. ``FaultInjector`` plugs into ``train_vqvae(step_hook=...)`` and
simulates the crash by raising ``InjectedFault`` at a chosen step.
"""

from __future__ import annotations


class InjectedFault(RuntimeError):
    """Simulated process failure."""


class FaultInjector:
    """Raise ``InjectedFault`` after completing ``fail_at_step``.

    fires_once: a resumed run sees the same step indices again; by default the
    injector only fires the first time so the retry can proceed past it.
    """

    def __init__(self, fail_at_step: int, fires_once: bool = True):
        self.fail_at_step = int(fail_at_step)
        self.fires_once = bool(fires_once)
        self.fired = False

    def __call__(self, step: int) -> None:
        if step == self.fail_at_step and not (self.fires_once and self.fired):
            self.fired = True
            raise InjectedFault(f"injected fault at step {step}")


__all__ = ["FaultInjector", "InjectedFault"]
