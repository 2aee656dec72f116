"""Adam with AMSGrad in torch-1.1.0 semantics, written by hand
(port of ``vqvae_tpu/train/optim.py:56-106``).

The reference trains with ``optim.Adam(..., amsgrad=True)`` of torch 1.1.0
(reference main.py:55), and the JAX package reproduces that update as
``scale_by_torch_amsgrad``::

    mu     = b1 * mu + (1 - b1) * g
    nu     = b2 * nu + (1 - b2) * g * g
    nu_max = max(nu_max, nu)                       # the RAW second moment
    p     -= lr * sqrt(1 - b2^t) / (1 - b1^t) * mu / (sqrt(nu_max) + eps)

``torch.optim.Adam(amsgrad=True)`` of torch 2.x is NOT this update: it divides
``sqrt(nu_max)`` by ``sqrt(1 - b2^t)`` before it adds ``eps``, so ``eps``
weighs ``1 / sqrt(1 - b2^t)`` times less (32 times at t = 1). With gradients
of 0.05 and more the two agree to round-off; with gradients near ``eps`` they
part (at a gradient scale of 1e-6 by a third of the trajectory over 20
steps), and a VQ-VAE has such gradients: codes that no latent was assigned
to, and biases late in training. So the update is written out here, and
``tests/test_torch_optim.py`` holds it against the JAX package's and shows
that torch 2.x's ``Adam`` departs.

The step count ``t`` is one integer for all parameters and the bias
corrections are reckoned on the host in double precision from it, as torch
1.1.0 does, so an update reads nothing back from the device. The tensor
arithmetic goes through ``torch._foreach_*`` calls over all parameters at
once: a handful of fused launches an update in place of eight small ones
for each of some thirty parameters.
"""

from __future__ import annotations

import math
from typing import Iterable

import torch

_INT32_MAX = 2**31 - 1


class TorchAmsgrad(torch.optim.Optimizer):
    """Adam(amsgrad=True) with torch-1.1.0 semantics (see the module docstring).

    A parameter whose ``.grad`` is None takes a zero gradient, as in optax, so
    its moments exist (and, from zero, stay zero): the codebook under EMA.
    State per parameter: ``mu``, ``nu``, ``nu_max``; ``count`` is the number
    of completed updates, kept per group and equal across groups.
    """

    def __init__(self, params: Iterable, lr: float = 3e-4, betas=(0.9, 0.999),
                 eps: float = 1e-8):
        if lr < 0.0 or eps < 0.0 or not all(0.0 <= b < 1.0 for b in betas):
            raise ValueError(f"invalid hyperparameters lr={lr} betas={betas} eps={eps}")
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps, count=0))
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p] = {name: torch.zeros_like(p) for name in ("mu", "nu", "nu_max")}

    @property
    def count(self) -> int:
        return self.param_groups[0]["count"]

    @count.setter
    def count(self, value: int) -> None:
        for group in self.param_groups:
            group["count"] = int(value)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = group["params"]
            if not params:
                continue
            b1, b2 = group["betas"]
            grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
            mu = [self.state[p]["mu"] for p in params]
            nu = [self.state[p]["nu"] for p in params]
            nu_max = [self.state[p]["nu_max"] for p in params]

            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, grads, alpha=1.0 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
            torch._foreach_maximum_(nu_max, nu)

            t = group["count"] = min(group["count"] + 1, _INT32_MAX)
            step_size = group["lr"] * math.sqrt(1.0 - b2**t) / (1.0 - b1**t)
            denom = torch._foreach_sqrt(nu_max)
            torch._foreach_add_(denom, group["eps"])
            torch._foreach_addcdiv_(params, mu, denom, value=-step_size)
        return loss


def make_optimizer(params: Iterable, learning_rate: float, impl: str = "torch") -> TorchAmsgrad:
    """Adam with AMSGrad, torch-default betas and eps (reference main.py:55).

    ``impl`` is ``TrainConfig.amsgrad_impl``. "torch" is the reference's
    optimizer. "optax" names a variant the JAX package keeps to compare
    against (it maxes the bias-corrected moment); it is no optimizer of the
    reference and the port does not have it.
    """
    if impl == "torch":
        return TorchAmsgrad(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    if impl == "optax":
        raise ValueError(
            "amsgrad_impl='optax' is the JAX package's comparison variant, not the "
            "reference's optimizer; the port has amsgrad_impl='torch' only"
        )
    raise ValueError(f"unknown amsgrad_impl {impl!r} (expected 'torch')")


__all__ = ["TorchAmsgrad", "make_optimizer"]
