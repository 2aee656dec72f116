"""Debug-mode numerical checks (port of ``vqvae_tpu/utils/debug.py``).

The JAX package turns on ``jax_debug_nans`` and wraps functions with
``checkify``. Their counterpart here is one ``TorchDispatchMode`` that sees
every operator torch runs, forward and backward (autograd hands the mode on
to the threads that run a backward on a card), and checks each floating
output for a NaN or an Inf:

- ``enable_nan_checks()`` pushes it for the calling thread and every
  backward it starts (a dispatch mode is per thread; the training loops run
  on one): the first op that produces a NaN or an Inf raises
  ``FloatingPointError`` naming the op.
- ``checked(fn)`` runs ``fn`` under it and records the first such op instead
  of raising: it returns ``(err, out)``, and ``err.throw()`` raises on the
  host, as a checkify error does.

Each check reads the device back once an op, so both are for debugging only
and stay off every default path. Ops that compute no values (``empty`` and
its kin, views) are not checked: their memory is not yet written.

Determinism, the other half of the JAX module's contract ("same seed =>
bit-identical step"), needs no switch here: the trainers' steps repeat bit
for bit on the card and on the CPU (``ops/scatter.py``, ``ops/conv.py``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# ops whose output is memory not yet written
_UNWRITTEN = ("empty", "new_empty", "empty_like", "empty_strided", "new_empty_strided", "resize_",
              "set_")


def _nonfinite(out) -> bool:
    for t in tree_leaves(out):
        if (isinstance(t, torch.Tensor) and t.is_floating_point() and t.numel()
                and not bool(torch.isfinite(t).all())):
            return True
    return False


class CheckError:
    """The first op that produced a NaN or an Inf, or none (checkify's error)."""

    def __init__(self, op: Optional[str] = None):
        self.op = op

    def get(self) -> Optional[str]:
        """The message, or None when every op's output was finite."""
        return None if self.op is None else f"{self.op} produced a NaN or an Inf"

    def throw(self) -> None:
        if self.op is not None:
            raise FloatingPointError(self.get())

    def __repr__(self) -> str:
        return f"CheckError({self.op!r})"


class _FiniteCheck(TorchDispatchMode):
    """Runs each op, then checks its floating outputs; on the first NaN or
    Inf raises (``record=None``) or records the op's name into ``record``."""

    def __init__(self, record: Optional[CheckError] = None):
        super().__init__()
        self.record = record

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if func.is_view or name in _UNWRITTEN:
            return out
        if (self.record is None or self.record.op is None) and _nonfinite(out):
            if self.record is None:
                raise FloatingPointError(f"{func} produced a NaN or an Inf")
            self.record.op = str(func)
        return out


_enabled: list = []


def enable_nan_checks(enable: bool = True) -> None:
    """NaN and Inf checking of every op this thread runs, and of the backward
    passes it starts (``jax_debug_nans``): the first op whose output is not
    finite raises ``FloatingPointError``.
    Expensive, debug only; ``enable_nan_checks(False)`` turns it off."""
    if enable and not _enabled:
        mode = _FiniteCheck()
        mode.__enter__()
        _enabled.append(mode)
    elif not enable and _enabled:
        _enabled.pop().__exit__(None, None, None)


def checked(fn: Callable) -> Callable:
    """``fn`` with NaN and Inf checks on every op it runs (``checkify``).

    Returns a function of the same signature whose first return value is a
    ``CheckError`` naming the first op that produced a NaN or an Inf::

        step = checked(trainer.step)
        err, (state, metrics) = step(state, batch)
        err.throw()
    """

    def wrapper(*args, **kwargs):
        err = CheckError()
        with _FiniteCheck(err):
            out = fn(*args, **kwargs)
        return err, out

    return wrapper


__all__ = ["CheckError", "checked", "enable_nan_checks"]
