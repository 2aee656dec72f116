"""The port's hand-written AMSGrad (``TorchAmsgrad``) held against the JAX
package's ``scale_by_torch_amsgrad`` on identical gradient schedules, and the
evidence that ``torch.optim.Adam(amsgrad=True)`` of torch 2.x is another update.

Tolerance: both run in float32 for 60 steps of about lr = 3e-4 each. They
differ in the rounding of a few fused operations a step and in the bias
corrections (the JAX function reckons them in float32, the port on the host
in double, as torch 1.1.0 did: at t = 1 the float32 ``1 - 0.999**t`` is off
by 1.3e-5 relative, 2e-9 of a step). 1e-6 absolute over the whole
trajectory covers that with room and is far below what a wrong update shows.
"""

from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vqvae_tpu.train.optim import torch_amsgrad
from vqvae_tpu_torch.train.optim import TorchAmsgrad, make_optimizer

LR = 3e-4


def _spike_schedule(n_steps: int = 60, dim: int = 32) -> np.ndarray:
    """Gradients that spike at step ~10 and then decay 100x (the schedule of
    tests/test_optim.py): the regime where AMSGrad variants part."""
    rng = np.random.default_rng(7)
    base = rng.normal(size=(n_steps, dim)).astype(np.float32)
    scale = np.ones(n_steps, dtype=np.float32) * 0.05
    scale[8:14] = 5.0
    scale[14:] = 0.05 * np.exp(-np.arange(n_steps - 14) / 20.0)
    return base * scale[:, None]


def _small_schedule(n_steps: int = 60, dim: int = 32) -> np.ndarray:
    """Gradients of scale 1e-6 with exact zeros: sqrt(nu_max) is of the order
    of eps there, so where eps is added decides the step. A quarter of the
    elements are zero in every step (moments stay zero: 0 / (0 + eps)), a
    quarter of the rest in any one step."""
    rng = np.random.default_rng(11)
    g = (1e-6 * rng.normal(size=(n_steps, dim))).astype(np.float32)
    g[:, : dim // 4] = 0.0
    g[rng.random(size=g.shape) < 0.25] = 0.0
    return g


SCHEDULES = {"spike": _spike_schedule, "small": _small_schedule}


def _run_jax(grads: np.ndarray) -> np.ndarray:
    tx = torch_amsgrad(LR)
    params = jnp.zeros(grads.shape[1], jnp.float32)
    state = tx.init(params)
    update = jax.jit(lambda g, s, p: tx.update(g, s, p))
    traj = []
    for g in grads:
        updates, state = update(jnp.asarray(g), state, params)
        params = optax.apply_updates(params, updates)
        traj.append(np.asarray(params))
    return np.stack(traj)


def _run_torch(make, grads: np.ndarray, dtype=torch.float32) -> np.ndarray:
    p = torch.nn.Parameter(torch.zeros(grads.shape[1], dtype=dtype))
    opt = make([p])
    traj = []
    for g in grads:
        p.grad = torch.from_numpy(g).to(dtype)
        opt.step()
        traj.append(p.detach().numpy().astype(np.float64))
    return np.stack(traj)


def _adam2(params):
    return torch.optim.Adam(params, lr=LR, betas=(0.9, 0.999), eps=1e-8, amsgrad=True)


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_torch_amsgrad_follows_the_jax_package(schedule):
    grads = SCHEDULES[schedule]()
    ours = _run_torch(lambda ps: TorchAmsgrad(ps, lr=LR), grads)
    want = _run_jax(grads)
    err = np.max(np.abs(ours - want))
    assert err < 1e-6, f"{schedule}: TorchAmsgrad departs from scale_by_torch_amsgrad by {err}"


def test_adam_of_torch_2_is_another_update_on_small_gradients():
    """So that nobody replaces the hand-written update with
    ``torch.optim.Adam(amsgrad=True)``: on the small-gradient schedule it
    departs from the JAX package's update by far more than 10x the 1e-6 the
    hand-written one is held to (float64 on both sides, so round-off is not
    the cause), while on the spike schedule (gradients of 0.05 and more, all
    that tests/test_optim.py tries) it agrees."""
    want = _run_jax(_small_schedule())
    ours = _run_torch(lambda ps: TorchAmsgrad(ps, lr=LR), _small_schedule(), torch.float64)
    adam = _run_torch(_adam2, _small_schedule(), torch.float64)
    assert np.max(np.abs(ours - want)) < 1e-6
    assert np.max(np.abs(adam - want)) > 1e-5, np.max(np.abs(adam - want))
    assert np.max(np.abs(adam - want)) > 100 * np.max(np.abs(ours - want))
    spike = _spike_schedule()
    assert np.max(np.abs(_run_torch(_adam2, spike, torch.float64) - _run_jax(spike))) < 5e-6


def test_none_gradient_is_a_zero_gradient():
    """A parameter without a gradient (the codebook under EMA) keeps zero
    moments and does not move, and the shared count still advances."""
    a = torch.nn.Parameter(torch.ones(3))
    b = torch.nn.Parameter(torch.ones(2))
    opt = TorchAmsgrad([a, b], lr=LR)
    for _ in range(3):
        a.grad = torch.tensor([1.0, -2.0, 0.0])
        b.grad = None
        opt.step()
    assert opt.count == 3
    assert torch.equal(b.detach(), torch.ones(2))
    for name in ("mu", "nu", "nu_max"):
        assert torch.equal(opt.state[b][name], torch.zeros(2))
    assert a[0] < 1.0 < a[1] and a[2] == 1.0
    # a gradient that comes and then stays away: the moments decay, the
    # parameter goes on moving, as with an explicit zero gradient
    c = torch.nn.Parameter(torch.ones(1))
    d = torch.nn.Parameter(torch.ones(1))
    oc, od = TorchAmsgrad([c], lr=LR), TorchAmsgrad([d], lr=LR)
    for step in range(4):
        c.grad = torch.ones(1) if step == 0 else None
        d.grad = torch.ones(1) if step == 0 else torch.zeros(1)
        oc.step()
        od.step()
    assert torch.equal(c.detach(), d.detach()) and c.item() < 1.0 - 2 * LR


def test_state_dict_round_trip_and_make_optimizer():
    p = torch.nn.Parameter(torch.zeros(4))
    opt = make_optimizer([p], LR, "torch")
    assert isinstance(opt, TorchAmsgrad) and opt.param_groups[0]["lr"] == LR
    p.grad = torch.arange(4.0)
    opt.step()
    q = torch.nn.Parameter(p.detach().clone())
    opt2 = make_optimizer([q], LR)
    # (load_state_dict keeps the tensors it is given, so hand it copies)
    opt2.load_state_dict(copy.deepcopy(opt.state_dict()))
    assert opt2.count == 1
    p.grad = q.grad = torch.ones(4)
    opt.step()
    opt2.step()
    assert torch.equal(p.detach(), q.detach())
    with pytest.raises(ValueError, match="comparison variant"):
        make_optimizer([p], LR, "optax")
    with pytest.raises(ValueError, match="unknown amsgrad_impl"):
        make_optimizer([p], LR, "adamw")
    with pytest.raises(ValueError):
        TorchAmsgrad([p], lr=-1.0)
