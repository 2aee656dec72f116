"""The port's NaN and Inf checks (``utils/debug.py``) held against the JAX
package's ``checked`` (checkify) and ``enable_nan_checks`` (jax_debug_nans)
on the same functions and inputs, as ``tests/test_utils.py`` holds JAX's.

No tolerance: the checks are yes/no, and the checked functions' outputs
(``log(1) = 0``, a train step's loss) must be exactly the unchecked ones'.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_tpu.utils.debug import checked as jax_checked
from vqvae_tpu_torch.config import TrainConfig, VQVAEConfig
from vqvae_tpu_torch.train.vqvae_train import VQVAETrainer
from vqvae_tpu_torch.utils.debug import CheckError, checked, enable_nan_checks


def _jax_raises(x: float) -> bool:
    err, _out = jax.jit(jax_checked(jnp.log))(jnp.asarray(x))
    try:
        err.throw()
    except Exception:
        return True
    return False


@pytest.mark.parametrize("x", [-1.0, 1.0, -3.0, 2.5])
def test_checked_log_agrees_with_checkify(x):
    """log(-1) is NaN: the port's error raises where checkify's does and is
    silent where it is."""
    err, out = checked(torch.log)(torch.tensor(x))
    j_err, j_out = jax.jit(jax_checked(jnp.log))(jnp.asarray(x))
    port_raises = False
    try:
        err.throw()
    except FloatingPointError as e:
        port_raises = True
        assert "aten.log" in str(e)
    assert port_raises == _jax_raises(x) == (x <= 0)
    if x > 0:
        assert err.get() is None and float(out) == float(np.log(np.float32(x))) == pytest.approx(float(j_out))


def test_checked_also_catches_an_inf():
    """log(0) = -Inf. checkify's float checks look for NaNs and divisions by
    zero only; the port's also stop on an Inf, which jax_debug_infs would."""
    err, out = checked(torch.log)(torch.tensor(0.0))
    assert torch.isinf(out) and err.op == "aten.log.default"
    assert not _jax_raises(0.0)


def test_checked_names_the_first_op():
    """sqrt(x - 2) makes the NaN; the add after it carries it on."""
    def f(x):
        return torch.sqrt(x - 2.0) + 1.0

    err, out = checked(f)(torch.tensor([1.0, 3.0]))
    assert isinstance(err, CheckError) and err.op == "aten.sqrt.default"
    assert torch.isnan(out[0]) and out[1] == 2.0
    with pytest.raises(FloatingPointError, match=r"aten\.sqrt\.default produced a NaN or an Inf"):
        err.throw()


def test_checked_leaves_unwritten_memory_alone():
    """``empty`` may hold any bits until it is written: not a finding."""
    def f():
        t = torch.empty(1 << 16)
        t.fill_(1.0)
        return t.sum()

    err, out = checked(f)()
    assert err.get() is None and float(out) == 65536.0


def test_enable_nan_checks_raises_in_the_forward():
    enable_nan_checks()
    try:
        assert float(torch.log(torch.tensor(2.0))) == pytest.approx(np.log(2.0))
        with pytest.raises(FloatingPointError, match="aten.log"):
            torch.log(torch.tensor(-1.0))
    finally:
        enable_nan_checks(False)
    assert torch.isnan(torch.log(torch.tensor(-1.0)))  # off again


def test_enable_nan_checks_raises_in_the_backward():
    """sqrt at 0 is finite forward, its gradient 1 / (2 sqrt(0)) is Inf."""
    x = torch.tensor([0.0, 4.0], requires_grad=True)
    enable_nan_checks()
    try:
        y = torch.sqrt(x).sum()
        with pytest.raises(FloatingPointError, match="produced a NaN or an Inf"):
            y.backward()
    finally:
        enable_nan_checks(False)
    x.grad = None
    torch.sqrt(x).sum().backward()
    assert torch.isinf(x.grad[0])


def test_enable_nan_checks_like_jax_debug_nans():
    """Both packages raise on the same NaN-making op once the switch is on."""
    jax.config.update("jax_debug_nans", True)
    try:
        with pytest.raises(FloatingPointError):
            jax.jit(jnp.log)(jnp.asarray(-1.0)).block_until_ready()
    finally:
        jax.config.update("jax_debug_nans", False)
    enable_nan_checks(True)
    enable_nan_checks(True)  # twice is once
    try:
        with pytest.raises(FloatingPointError):
            torch.log(torch.tensor(-1.0))
    finally:
        enable_nan_checks(False)
    enable_nan_checks(False)


def test_checked_train_step():
    """A healthy step passes and gives the unchecked step's loss bit for bit;
    a NaN written into the input raises and names an op."""
    cfg = VQVAEConfig(n_hiddens=16, n_residual_hiddens=8, n_embeddings=32, embedding_dim=8)
    trainer = VQVAETrainer(cfg, TrainConfig(batch_size=4), device="cpu")
    x = np.random.default_rng(0).uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)
    _s, plain = trainer.step(trainer.init_state(torch.Generator().manual_seed(3)), x)
    err, (_s, m) = checked(trainer.step)(trainer.init_state(torch.Generator().manual_seed(3)), x)
    err.throw()
    assert torch.equal(m["loss"], plain["loss"])
    x[1, 5, 5, 0] = np.nan
    err, _out = checked(trainer.step)(trainer.init_state(torch.Generator().manual_seed(3)), x)
    with pytest.raises(FloatingPointError, match=r"aten\.\w+"):
        err.throw()
    assert err.op.startswith("aten.")
