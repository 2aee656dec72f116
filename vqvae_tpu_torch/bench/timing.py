"""The timing core of every bench of the port (counterpart of ``tools/timing.py``).

Two clocks, for two kinds of work:

- ``interleaved_two_point``: the JAX tools' two-point rule, as it is there.
  The caller's ``run_timed(k)`` runs k units of work, ends in a
  synchronisation of the device (``sync``), and returns the host clock's
  seconds; the difference between a long and a short window cancels what a
  window costs besides its units. What it measures is what a loop of such
  units gets, the host's pace included.
- ``time_ms``: CUDA events around many calls queued behind a device spin,
  so that the card's time alone is measured, not the host's pace of
  queueing. It needs a card and raises without one: a bench run on the CPU
  takes the host clock (``host_ms``) only where its caller passes it.

``alternate`` times several functions in turns (a, b, b, a), so that a drift
of the card's clock falls on all of them alike.
"""

from __future__ import annotations

import subprocess
import sys
import time
from typing import Callable, Optional

import torch

from vqvae_tpu_torch.utils.flops import chip_spec

SPIN_CYCLES = 20_000_000              # device spin (about 11 ms) that lets the host queue ahead


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def interleaved_two_point(
    run_timed: Callable[[int], float],
    lo: int,
    hi: int,
    repeats: int = 9,
    attempts: int = 3,
    floor: float = 1e-8,
) -> float:
    """Seconds per work unit via interleaved min-of-``repeats`` two-point
    timing, with retry + a physical floor against hiccups of the host.

    ``run_timed`` must already be warm (both the lo and hi windows run once)
    before this is called.
    """
    for attempt in range(attempts):
        los, his = [], []
        for _ in range(repeats):
            los.append(run_timed(lo))
            his.append(run_timed(hi))
        dt = (min(his) - min(los)) / (hi - lo)
        if dt > floor:
            return dt
        print(
            f"  WARNING: non-physical per-unit time {dt*1e6:.2f} us "
            f"(min lo {min(los):.4f}s, min hi {min(his):.4f}s) — "
            f"retry {attempt + 1}/{attempts}",
            file=sys.stderr,
            flush=True,
        )
    raise RuntimeError(
        "interleaved_two_point produced a non-positive per-unit time in "
        f"{attempts} attempts; the host is too noisy — enlarge the hi window so it "
        "holds more device work"
    )


def sync_fn(device: torch.device) -> Callable[[], None]:
    """What ends a timed window on ``device``: a synchronisation of the card,
    or nothing on the CPU, whose ops have finished when they return."""
    if device.type == "cuda":
        return torch.cuda.synchronize
    return lambda: None


def time_ms(fn, iters: int = 50, warmup: int = 5, queue_ahead: bool = True) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, from CUDA events.

    With ``queue_ahead`` the card first spins, so the host has queued the
    calls before the first one runs and the events time the card alone. The
    spin must outlast the queueing: if it has ended by the time the last call
    is queued, the timing is made again behind a spin twice as long, and the
    function fails when no spin up to eight times the first is long enough.
    Without ``queue_ahead`` a short kernel is timed at the host's pace.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("time_ms times a CUDA card and there is none; on the CPU pass "
                           "the host clock (host_ms) explicitly")
    for _ in range(warmup):
        fn()
    spin = SPIN_CYCLES
    while True:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        spun = torch.cuda.Event()
        if queue_ahead:
            torch.cuda._sleep(spin)
        spun.record()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        host_was_ahead = not spun.query()  # the card is still spinning
        end.synchronize()
        if host_was_ahead or not queue_ahead:
            return start.elapsed_time(end) / iters
        spin *= 2
        check(spin <= 8 * SPIN_CYCLES, "time_ms: the host never queued its calls ahead of the card")


def host_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean host-clock ms of ``fn`` over ``iters`` calls: the timer of a
    bench driven on the CPU, where ops finish before they return."""
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return 1e3 * (time.perf_counter() - t0) / iters


def alternate_turns(fns: dict, timer: Callable = time_ms) -> dict:
    """Time every function in turn, then again in reverse order (a, b, b, a):
    each one's two turns, in ms."""
    names = list(fns)
    times = {name: [] for name in names}
    for name in names + names[::-1]:
        times[name].append(timer(fns[name]))
    return times


def alternate(fns: dict, timer: Callable = time_ms) -> dict:
    """The faster of each function's two turns of ``alternate_turns``, in ms."""
    return {name: min(ts) for name, ts in alternate_turns(fns, timer).items()}


def bf16_mfu(rate: float, flops: float, device: torch.device) -> Optional[float]:
    """rate x FLOP a unit over the card's dense bf16 peak (``utils/flops.py``);
    None on the CPU and on a card ``chip_spec`` does not list."""
    if device.type != "cuda":
        return None
    spec = chip_spec(torch.cuda.get_device_name(device))
    return rate * flops / spec.peak_bf16_flops if spec is not None else None


def chip_name(device: torch.device) -> str:
    """The card's name as ``chip_spec`` lists it (else as torch gives it), or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    name = torch.cuda.get_device_name(device)
    spec = chip_spec(name)
    return spec.name if spec is not None else name


def device_line(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` gives them, or "cpu": every row carries it, so
    that no number of the CPU passes for a card's."""
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else torch.cuda.current_device()
    return subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


__all__ = ["SPIN_CYCLES", "alternate", "alternate_turns", "bf16_mfu", "check", "chip_name", "device_line",
           "host_ms", "interleaved_two_point", "sync_fn", "time_ms"]
