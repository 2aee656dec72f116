"""Tracing and timing (port of ``vqvae_tpu/utils/profiling.py``).

- ``profile_trace``: a context manager around ``torch.profiler`` (host and,
  where there is a card, CUDA activity) that writes one
  ``<host>_<pid>.<ms>.pt.trace.json`` into ``log_dir`` when it exits: a
  Chrome trace that Perfetto and TensorBoard's profiler plugin open.
- ``annotate``: a named range that shows up in the trace
  (``record_function``), optionally also as an NVTX range.
- ``step_timer``: wall-clock timing fenced by a copy of every tensor of the
  result to the host. ``torch.cuda.synchronize()`` would fence the device
  but says nothing of a tree of results on several devices or streams; a
  copy of each leaf cannot return before that leaf is written.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch
from torch.utils._pytree import tree_map


@contextlib.contextmanager
def profile_trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Trace what runs inside the block into ``log_dir``; yields the profiler
    (its ``key_averages()`` summarises the same events)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    ) as prof:
        yield prof


@contextlib.contextmanager
def annotate(name: str, nvtx: bool = False) -> Iterator[None]:
    """A named range in the profiler's trace; with ``nvtx`` also an NVTX
    range for tools that read those (on a card only)."""
    nvtx = nvtx and torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


class step_timer:
    """Wall-clock timer with a fence::

        with step_timer() as t:
            out = step(...)
            t.fence(out)
        print(t.seconds)
    """

    def __enter__(self):
        self._t0 = time.perf_counter()
        self.seconds: Optional[float] = None
        return self

    def fence(self, tree) -> None:
        """Copy every tensor leaf of ``tree`` to the host."""
        tree_map(lambda x: x.cpu() if isinstance(x, torch.Tensor) else x, tree)

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        return False


__all__ = ["annotate", "profile_trace", "step_timer"]
