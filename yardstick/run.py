"""The benchmark's command:

    python -m yardstick --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up makes the cell's inputs from the seed, builds the program (the port
``vqvae_tpu_torch``), runs its first calls and warms every shape the window
uses; ``setup_s`` runs from the process's start to the window's. The window
then queues the cell's timed call, reading each call's results a few calls
behind, until ``--seconds`` have passed, waits for all it queued, and the
end-to-end metric is all of that work over all of that time. After the window
the peak memory is read, the program is released, and the reference check
decides ``correct``. With ``--trace 1`` the profiler records the first
units of the window (the traffic's ``trace_seconds``) and the per-layer
metrics are read from that slice.

A cell on several chips runs one process a rank, this one rank 0, joined as
``train-vqvae --distributed`` joins them (NCCL, a free port on localhost);
each rank takes its slice of every global batch.

The last line of standard output is one JSON object; the numbers compared
and their limits are the last lines of standard error and the line's last
key. Without a card, with fewer cards than the cell asks for, or with JAX or
the JAX package loaded, the command prints no result and exits non-zero.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import socket
import sys
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, Optional

from yardstick import judge
from yardstick import spec as specs

CHECKOUT = specs.ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "vqvae_tpu")


def process_start() -> float:
    """Wall-clock time at which this process started (Linux's /proc)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return boot + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def set_cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths, so
    that only a checkout's first run builds. The port builds its nvcc
    library under ``build/kernels/`` of the checkout itself."""
    build = CHECKOUT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


@dataclass
class SliceInfo:
    """What per-layer readers know of the traced slice besides its trace."""

    steps: int                 # timed calls' updates (training) or batches (extraction)
    items: int                 # images or grids, the global batch's
    chips: int
    sizes: dict                # the configuration
    flop_per_item: float       # the model file's, for the traffic's flop_kind
    arithmetic: str
    peaks: dict
    rows_per_item: Optional[int]   # latent rows an item sends through the search (the model file's)


def chip_peaks(kind: str) -> Optional[dict]:
    with open(specs.ROOT / "peaks.json") as f:
        table = json.load(f)
    return next((c for c in table["chips"] if c["match"] in kind.lower()), None)


# units dispatched beyond the oldest one whose results are not read yet
AHEAD = 2


class Window:
    """The measured window of one rank. A unit is queued without a wait:
    its results (the losses of a training chunk; on several ranks also rank
    0's verdict on whether the window and the traced slice are over,
    broadcast to every rank behind the work) are copied to the host behind
    it and read ``AHEAD`` units later, so that the card is kept fed while
    the host stands still. When the time is up nothing more is queued; the
    window waits for all that was queued and reads its clock after that
    wait, and all of that work counts. On several ranks every rank reads
    the verdict with the same unit, ``AHEAD`` units after rank 0 gave it.
    The traced slice waits for its own units in the same way before its
    span closes."""

    def __init__(self, cell, seconds: float, trace_seconds: Optional[float], on_card: bool,
                 dist_device=None):
        self.cell, self.seconds, self.trace_seconds = cell, seconds, trace_seconds
        self.on_card = on_card
        self.dist_device = dist_device
        self.steps = self.items = 0
        self.slice_steps = self.slice_items = 0
        self.view = None
        self.pending = deque()

    def _post(self, out, flags):
        """Queue the read-back of a unit's device results ``out`` (None for
        a unit that returns on the host) with the verdict ``flags``."""
        import torch

        if self.dist_device is not None:
            verdict = torch.tensor([float(v) for v in flags], pin_memory=self.on_card)
            verdict = verdict.to(self.dist_device, non_blocking=True)
            torch.distributed.broadcast(verdict, 0)
            out = verdict if out is None else torch.cat([verdict, out.float()])
        event = None
        if out is not None and self.on_card:
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            event = torch.cuda.Event(blocking=True)
            event.record(torch.cuda.current_stream(out.device))
            out = host
        self.pending.append((event, out, flags))

    def _settle(self, keep: int):
        """Read the results of the oldest units until ``keep`` are left;
        returns whether any of those read says the window / the slice is
        over (rank 0's verdict on several ranks, this rank's on one)."""
        done = end_trace = False
        while len(self.pending) > keep:
            event, out, flags = self.pending.popleft()
            if event is not None:
                event.synchronize()
            if out is not None:
                out = out.numpy()
                if self.dist_device is not None:
                    flags, out = (bool(v) for v in out[:2]), out[2:]
                self.cell.settle(out)
            d, e = flags
            done, end_trace = done or d, end_trace or e
        return done, end_trace

    def run(self):
        import torch

        from yardstick.trace import WINDOW_SPAN, Tracer

        tracer = None
        if self.trace_seconds is not None:
            tracer = Tracer(self.on_card)
            tracer.start()
            self._post(self.cell.unit()[2], (False, False))   # the profiler's own warm-up
            self._settle(0)
        gc.collect()
        gc.freeze()
        if self.dist_device is not None:
            torch.distributed.barrier()
        self.started = time.time()
        t0 = time.perf_counter()
        span = None
        if tracer is not None:
            span = torch.profiler.record_function(WINDOW_SPAN)
            span.__enter__()
            ts0 = time.perf_counter()
        while True:
            steps, items, out = self.cell.unit()
            self.steps += steps
            self.items += items
            if span is not None:
                self.slice_steps += steps
                self.slice_items += items
            now = time.perf_counter()
            flags = (now - t0 >= self.seconds, span is not None and now - ts0 >= self.trace_seconds)
            self._post(out, flags)
            read = self._settle(AHEAD)
            done, end_trace = flags if self.dist_device is None else read
            if span is not None and (end_trace or done):
                done = self._settle(0)[0] or done
                if self.on_card:
                    torch.cuda.synchronize()
                span.__exit__(None, None, None)
                span = None
                tracer.stop()
            if done:
                break
        self._settle(0)
        if self.on_card:
            torch.cuda.synchronize()
        self.elapsed = time.perf_counter() - t0
        if tracer is not None:
            self.view = tracer.view()


def _measure(cell_spec, seed: int, seconds: float, trace: bool, device, rank: int = 0,
             mesh_cfg=None, dist_device=None):
    import torch

    torch.set_num_threads(2)
    marks = [("imports", time.time())]
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.empty(1, device=device)
        marks.append(("cuda context", time.time()))
    cell = cell_spec.driver()(cell_spec, seed, device, rank, mesh_cfg)
    cell.setup(lambda name: marks.append((name, time.time())))
    if on_card:
        torch.cuda.synchronize(device)
    window = Window(cell, seconds, cell_spec.traffic["trace_seconds"] if trace else None, on_card,
                    dist_device)
    window.run()
    window.marks = marks
    window.memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    cell.release()
    return cell, window


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_main(cell_spec, seed: int, seconds: float, trace: bool, rank: int, world: int,
              port: int, device: str = "cuda"):
    """One rank of a cell on several chips; rank 0 returns its cell and
    window with the ranks' peak memory (the most) and busy and window
    seconds (the mean)."""
    import torch
    import torch.distributed as dist

    from yardstick import program

    mesh_cfg, device = program.bring_up(world, rank, port, device)
    try:
        cell, window = _measure(cell_spec, seed, seconds, trace, device, rank, mesh_cfg, device)
        view = window.view
        stats = torch.tensor([window.memory_peak, view.busy_s if view else 0.0,
                              view.window_s if view else 0.0], dtype=torch.float64, device=device)
        peak = stats[:1].clone()
        dist.all_reduce(peak, op=dist.ReduceOp.MAX)
        dist.all_reduce(stats, op=dist.ReduceOp.SUM)
        window.memory_peak = int(peak.item())
        window.mean_busy_s, window.mean_window_s = (float(v) / world for v in stats[1:].tolist())
    finally:
        program.shut_down()
    return cell, window


def _run_ranks(cell_spec, seed: int, seconds: float, trace: bool, world: int,
               device: str = "cuda"):
    import multiprocessing

    from yardstick import program

    os.environ["NCCL_SHM_DISABLE"] = "1"
    if device == "cuda":
        program.build_kernels()
    port = _free_port()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=rank_main, args=(cell_spec, seed, seconds, trace, r, world, port, device))
             for r in range(1, world)]
    for p in procs:
        p.start()
    try:
        cell, window = rank_main(cell_spec, seed, seconds, trace, 0, world, port, device)
    except BaseException:
        for p in procs:     # the others would wait for rank 0 until the group's timeout
            p.kill()
        raise
    finally:
        for p in procs:
            p.join(timeout=120)
            if p.is_alive():
                p.kill()
                p.join()
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"ranks exited with {bad}")
    return cell, window


def _layer_metrics(cell_spec, cell, window, kind: str) -> Dict[str, dict]:
    view = window.view
    if view is None or view.window_s <= 0:
        raise RuntimeError("the traced slice has no window span")
    cfg, model = cell_spec.config, cell_spec.model()
    info = SliceInfo(steps=window.slice_steps, items=window.slice_items, chips=cell_spec.chips,
                     sizes=cfg, flop_per_item=model.flop_per_item(cfg, cell_spec.traffic["flop_kind"]),
                     arithmetic="float32" if cfg["compute_dtype"] == "float32" else "bfloat16",
                     peaks=chip_peaks(kind) or {}, rows_per_item=model.rows_per_item(cfg))
    out = {}
    for metric, layer in cell_spec.layers.items():
        value = specs.reader(metric, layer, cell_spec.root)(view, info, layer)
        if value is not None:
            out[metric] = {"value": float(value), "unit": layer["unit"]}
    return out


def main(argv=None) -> int:
    started = process_start()
    ap = argparse.ArgumentParser(prog="python -m yardstick", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell_spec = specs.load_cell(args.workload)
    set_cache_dirs()

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell_spec.chips:
        print(f"yardstick: {args.workload} needs {cell_spec.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    trace = bool(args.trace)
    if cell_spec.chips > 1:
        cell, window = _run_ranks(cell_spec, args.seed, args.seconds, trace, cell_spec.chips)
    else:
        cell, window = _measure(cell_spec, args.seed, args.seconds, trace, torch.device("cuda", 0))
        if window.view is not None:
            window.mean_busy_s, window.mean_window_s = window.view.busy_s, window.view.window_s
    setup_s = window.started - started
    prev, phases = started, []
    for name, t in window.marks + [("profiler and gc.freeze" if trace else "gc.freeze", window.started)]:
        phases.append(f"{name} {t - prev:.3f}")
        prev = t
    print(f"setup {setup_s:.3f} s: " + ", ".join(phases), file=sys.stderr)
    numbers, failed = cell.check(cell_spec.limits)
    correct = judge.verdict(numbers, cell_spec.limits)
    kind = torch.cuda.get_device_name(0)
    device = {"platform": "gpu", "kind": kind, "count": cell_spec.chips,
              "memory_peak_bytes": int(window.memory_peak)}
    attempted = window.steps if cell.counts == "updates" else window.items
    result = {"correct": bool(correct and failed == 0), "attempted": int(attempted),
              "failed": int(failed)}
    if trace:
        result["metrics"] = _layer_metrics(cell_spec, cell, window, kind)
        device.update(busy_s=window.mean_busy_s, window_s=window.mean_window_s)
        result["device"] = device
        result["breakdown"] = window.view.breakdown()
    else:
        result["metrics"] = {
            cell_spec.metric: {"value": window.items / window.elapsed,
                               "unit": cell_spec.traffic["unit"]},
            "setup_s": {"value": setup_s, "unit": "s"},
        }
        result["device"] = device
    # a number that is not finite is written as null: JSON has no infinity
    result["checks"] = {k: {"value": numbers[k] if math.isfinite(numbers[k]) else None,
                            "limit": cell_spec.limits[k]} for k in cell_spec.limits}
    found = forbidden_modules()
    if found:
        print(f"yardstick: modules loaded that the benchmark may not load: {', '.join(found)}",
              file=sys.stderr)
        return 4
    print("numbers " + json.dumps(numbers), file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
