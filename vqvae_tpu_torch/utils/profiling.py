"""Tracing (port of ``vqvae_tpu/utils/profiling.py``).

- ``profile_trace``: a context manager around ``torch.profiler`` (host and,
  where there is a card, CUDA activity) that writes one
  ``<host>_<pid>.<ms>.pt.trace.json`` into ``log_dir`` when it exits: a
  Chrome trace that Perfetto and TensorBoard's profiler plugin open.
- ``annotate``: the port's one span. Under a running profiler it is a
  ``record_function`` range, a profiler event on the clock of the device's
  own activity, so that a trace can put each device operation and each idle
  gap down to the spans around it. With no profiler running it costs one
  check: no range is made and no name is formatted. The profiler keeps the
  events and writes them when it stops; there is no store of our own.

The spans of the training update (each opened by the caller's thread, but
``search.backward``, which autograd runs on its own thread on a card):
``train.batch`` (the batch's way to the device), ``train.forward`` (forward
and loss), ``search.<route>[<N>x<K>x<D>]`` (the nearest-code search,
``ops/quantizer.py``), ``train.backward`` (around ``loss.backward()``),
``search.backward``, and on several ranks ``parallel.mean`` (the gradients'
exchange) and ``parallel.psum`` (every all-reduce). A VQ-VAE update on a card
opens the spans inside the update only in the first, eager update of a batch
shape: the later ones replay its CUDA graph, which holds no span.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, ContextManager, Iterator, Union

import torch

_OFF = contextlib.nullcontext()


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


def annotate(name: Union[str, Callable[[], str]]) -> ContextManager:
    """A named range in the profiler's trace while a profiler runs, else a
    shared no-op. ``name`` may be a callable that builds the name; it is
    called only while a profiler runs."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name() if callable(name) else name)


__all__ = ["annotate", "profile_trace"]
