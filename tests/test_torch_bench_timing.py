"""The port's timing core (``vqvae_tpu_torch/bench/timing.py``) against the
JAX tools' (``tools/timing.py``): the same fake ``run_timed`` sequences give
the same answers through both. ``time_ms`` needs a card and raises without
one.

On the card: ``python -m pytest --noconftest -m gpu tests/test_torch_bench_timing.py``.
"""

from __future__ import annotations

import pytest
import torch

from tools import timing as jax_tools_timing
from vqvae_tpu_torch.bench import timing

IMPLS = {"tools.timing": jax_tools_timing.interleaved_two_point,
         "vqvae_tpu_torch.bench.timing": timing.interleaved_two_point}


@pytest.mark.parametrize("impl", IMPLS.values(), ids=IMPLS.keys())
def test_two_point_math(impl):
    # lo runs 10 units @ 1ms + 5ms overhead; hi runs 60 units likewise
    times = {10: 0.015, 60: 0.065}
    dt = impl(lambda k: times[k], 10, 60, repeats=3)
    assert abs(dt - 1e-3) < 1e-12  # overhead cancels exactly


@pytest.mark.parametrize("impl", IMPLS.values(), ids=IMPLS.keys())
def test_retry_then_success(impl):
    # the first 2x3 interleaved samples give a negative difference (a hiccup
    # on every hi draw), the second attempt is clean
    seq = iter(
        [0.05, 0.01, 0.05, 0.01, 0.05, 0.01]   # attempt 1: hi < lo -> retry
        + [0.015, 0.065, 0.015, 0.065, 0.015, 0.065]  # attempt 2: clean
    )
    dt = impl(lambda k: next(seq), 10, 60, repeats=3)
    assert abs(dt - 1e-3) < 1e-12


@pytest.mark.parametrize("impl", IMPLS.values(), ids=IMPLS.keys())
def test_raises_after_exhausted_attempts(impl):
    with pytest.raises(RuntimeError, match="non-positive"):
        impl(lambda k: 0.01, 10, 60, repeats=2, attempts=2)


def test_time_ms_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = []
    with pytest.raises(RuntimeError, match="CUDA card"):
        timing.time_ms(lambda: calls.append(1))
    assert calls == []  # nothing ran: no host-clock figure passes for the card's


def test_alternate_takes_turns_and_the_faster_of_two():
    order = []
    fake = {"a": iter([3.0, 1.0]), "b": iter([2.0, 4.0])}

    def timer(name):
        order.append(name)
        return next(fake[name])

    got = timing.alternate({"a": "a", "b": "b"}, timer)
    assert order == ["a", "b", "b", "a"] and got == {"a": 1.0, "b": 2.0}


def test_host_clock_and_sync_on_the_cpu():
    assert timing.host_ms(lambda: sum(range(100)), iters=3, warmup=1) > 0
    assert timing.sync_fn(torch.device("cpu"))() is None
    assert timing.device_line(torch.device("cpu")) == "cpu"
    assert timing.chip_name(torch.device("cpu")) == "cpu"
    assert timing.bf16_mfu(1e6, 1e6, torch.device("cpu")) is None


@pytest.mark.gpu
def test_time_ms_on_the_card():
    """An empty-ish op behind the spin: a positive time shorter than a launch
    at the host's pace; the card named by nvidia-smi."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = torch.ones(1024, device="cuda")
    queued = timing.time_ms(lambda: x.add_(1.0), iters=200)
    paced = timing.time_ms(lambda: x.add_(1.0), iters=200, queue_ahead=False)
    assert 0 < queued <= paced
    dev = torch.device("cuda")
    assert torch.cuda.get_device_name(0) in timing.device_line(dev)
