"""The fp32 precision scope (``ops/conv.py::conv_fp32_precision``) across
threads: each thread reads back its own values of both process-wide switches
(cuDNN convs and cuBLAS matmuls) inside its scope, and the values from
before the first scope come back at the end. The VQ-VAE trainer nests the
scope around ``backward()``.
"""

from __future__ import annotations

import sys
import threading

import numpy as np
import torch

from vqvae_tpu_torch.config import TrainConfig, VQVAEConfig
from vqvae_tpu_torch.ops import conv
from vqvae_tpu_torch.train.vqvae_train import VQVAETrainer

WANT = {"highest": "ieee", "default": "tf32", "high": "tf32"}


def _switches():
    return torch.backends.cudnn.conv.fp32_precision, torch.backends.cuda.matmul.fp32_precision


def test_scope_sets_and_restores_both_switches():
    before = _switches()
    with conv.conv_fp32_precision("highest"):
        assert _switches() == ("ieee", "ieee")
        with conv.conv_fp32_precision("default"):  # re-entry from the same thread
            assert _switches() == ("tf32", "tf32")
        assert _switches() == ("ieee", "ieee")
    assert _switches() == before
    assert torch.get_float32_matmul_precision() == "highest"  # the legacy reader still reads


def test_two_threads_each_read_back_their_own_precision():
    """One thread holds "highest", the other "default", each re-entering its
    scope 300 times with the interpreter switching threads every 10 us."""
    before = _switches()
    errors, start = [], threading.Barrier(2)

    def worker(precision):
        start.wait()
        want = (WANT[precision],) * 2
        for _ in range(300):
            with conv.conv_fp32_precision(precision):
                for _ in range(3):
                    got = _switches()
                    if got != want:
                        errors.append((precision, got))
                    torch.zeros(4).add_(1.0)  # let the other thread run

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(p,)) for p in ("highest", "default")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive(), "a thread is stuck in the precision scope"
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors[:5]
    assert _switches() == before


def test_scope_is_restored_after_an_error():
    before = _switches()
    try:
        with conv.conv_fp32_precision("default"):
            raise KeyError("inside")
    except KeyError:
        pass
    assert _switches() == before
    entered = threading.Event()  # and another thread can take the scope

    def take():
        with conv.conv_fp32_precision("highest"):
            entered.set()

    t = threading.Thread(target=take)
    t.start()
    t.join(timeout=10)
    assert entered.is_set() and not t.is_alive()


def test_trainer_step_nests_the_scope_around_backward(monkeypatch):
    """VQVAETrainer holds the scope around forward and backward(); the convs
    inside re-enter it from the same thread. While another thread runs
    "default" scopes, every conv of the step, forward and backward, sees
    "ieee"."""
    seen = []
    real_conv2d = torch.nn.functional.conv2d

    class Probe(torch.autograd.Function):
        @staticmethod
        def forward(ctx, y):
            seen.append(("forward", _switches()))
            return y.clone()

        @staticmethod
        def backward(ctx, g):
            seen.append(("backward", _switches()))
            return g

    def probed_conv2d(*a, **kw):
        return Probe.apply(real_conv2d(*a, **kw))

    monkeypatch.setattr(conv.F, "conv2d", probed_conv2d)
    cfg = VQVAEConfig(n_hiddens=16, n_residual_hiddens=8, embedding_dim=8, n_embeddings=16)
    trainer = VQVAETrainer(cfg, TrainConfig(batch_size=2), x_train_var=1.0, device="cpu")
    state = trainer.init_state(torch.Generator().manual_seed(0))
    x = np.random.default_rng(0).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    stop = threading.Event()

    def other():
        while not stop.is_set():
            with conv.conv_fp32_precision("default"):
                pass

    t = threading.Thread(target=other)
    t.start()
    try:
        for _ in range(3):
            trainer.step(state, x)
    finally:
        stop.set()
        t.join(timeout=30)
    assert {kind for kind, _ in seen} == {"forward", "backward"}
    assert all(s == ("ieee", "ieee") for _kind, s in seen), seen[:5]
