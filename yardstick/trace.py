"""The traced slice of a ``--trace 1`` run and what the per-layer readers see.

The profiler (``torch.profiler``, CPU and CUDA activity) runs over the first
units of the measured window, inside a span named ``WINDOW_SPAN``; its
Chrome trace is written under ``TMPDIR``, read back and deleted. A
``TraceView`` then holds, for the span only:

- the device operations (kernels, copies, sets): name, start, duration, and
  the names of the host ops and spans that launched each one (outermost
  first, matched through the launch's correlation id);
- ``busy_s``, the union of the device operations' intervals, and
  ``window_s``, the span's length;
- the idle gaps between device operations, each named by what the span's
  thread was doing when the gap began.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

WINDOW_SPAN = "yardstick.traced_window"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
_NAMED_CATS = ("cpu_op", "user_annotation")


@dataclass
class DeviceOp:
    name: str
    cat: str
    start: float      # microseconds, the trace's clock
    dur: float
    ancestors: Tuple[str, ...] = ()


@dataclass
class TraceView:
    window_s: float
    busy_s: float
    ops: List[DeviceOp]
    gaps: List[Tuple[str, float]] = field(default_factory=list)   # (host activity, seconds)

    def seconds(self, pred) -> float:
        return sum(op.dur for op in self.ops if pred(op)) * 1e-6

    def breakdown(self, top: int = 10) -> dict:
        by_name: Dict[str, float] = defaultdict(float)
        for op in self.ops:
            by_name[op.name[:100]] += op.dur * 1e-6
        by_gap: Dict[str, float] = defaultdict(float)
        for name, sec in self.gaps:
            by_gap[name] += sec
        order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]  # noqa: E731
        return {"device_ops": [[n, s] for n, s in order(by_name)],
                "idle_gaps": [[n, s] for n, s in order(by_gap)]}


def _host_stacks(host: List[dict]):
    """Per thread, a sweep over nested host events: for each runtime call
    (by correlation id) the names of the ops and spans around it, and the
    named events in start order for the gap queries."""
    by_tid: Dict[object, List[dict]] = defaultdict(list)
    for ev in host:
        by_tid[ev["tid"]].append(ev)
    launch: Dict[int, Tuple[str, ...]] = {}
    for events in by_tid.values():
        events.sort(key=lambda e: (e["ts"], -e.get("dur", 0)))
        stack: List[dict] = []
        for ev in events:
            while stack and stack[-1]["ts"] + stack[-1].get("dur", 0) <= ev["ts"]:
                stack.pop()
            if ev["cat"] in ("cuda_runtime", "cuda_driver"):
                corr = ev.get("args", {}).get("correlation")
                if corr is not None:
                    launch[corr] = tuple(e["name"] for e in stack if e["cat"] in _NAMED_CATS)
            else:
                stack.append(ev)
    return by_tid, launch


def _activity_at(events: List[dict], times: List[float]) -> List[str]:
    """For each time (ascending), the innermost span and op of one thread
    running at that time, as 'span / op' ('idle host' where none runs)."""
    out, stack, i = [], [], 0
    named = [e for e in events if e["cat"] in _NAMED_CATS]
    for t in times:
        while i < len(named) and named[i]["ts"] <= t:
            stack.append(named[i])
            i += 1
        stack = [e for e in stack if e["ts"] + e.get("dur", 0) > t]
        spans = [e["name"] for e in stack if e["cat"] == "user_annotation" and e["name"] != WINDOW_SPAN]
        ops = [e["name"] for e in stack if e["cat"] == "cpu_op"]
        parts = [p for p in (spans[-1] if spans else None, ops[-1] if ops else None) if p]
        out.append(" / ".join(parts) if parts else "idle host")
    return out


def view_from_events(events: List[dict]) -> Optional[TraceView]:
    """The slice inside the last ``WINDOW_SPAN``; None where the trace has
    no such span."""
    spans = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW_SPAN
             and e.get("cat") == "user_annotation"]
    if not spans:
        return None
    span = max(spans, key=lambda e: e["ts"])
    w0, w1 = span["ts"], span["ts"] + span["dur"]
    host = [e for e in events if e.get("ph") == "X" and e.get("cat") in _HOST_CATS]
    by_tid, launch = _host_stacks(host)
    ops = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS and w0 <= e["ts"] < w1:
            corr = e.get("args", {}).get("correlation")
            ops.append(DeviceOp(e["name"], e["cat"], e["ts"], min(e["dur"], w1 - e["ts"]),
                                launch.get(corr, ())))
    ops.sort(key=lambda op: op.start)
    busy, gaps, cursor = 0.0, [], w0
    for op in ops:
        end = op.start + op.dur
        if op.start > cursor:
            gaps.append((cursor, op.start - cursor))
        if end > cursor:
            busy += end - max(op.start, cursor)
            cursor = end
    if w1 > cursor:
        gaps.append((cursor, w1 - cursor))
    names = _activity_at(by_tid[span["tid"]], [g for g, _ in gaps])
    return TraceView(window_s=(w1 - w0) * 1e-6, busy_s=busy * 1e-6, ops=ops,
                     gaps=[(n, d * 1e-6) for n, (_, d) in zip(names, gaps)])


class Tracer:
    """``torch.profiler`` over a slice; ``view()`` once it has stopped."""

    def __init__(self, on_card: bool):
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)

    def start(self):
        self._prof.start()

    def stop(self):
        self._prof.stop()

    def view(self) -> Optional[TraceView]:
        fd, path = tempfile.mkstemp(suffix=".json", prefix="yardstick-trace-")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        return view_from_events(events)
