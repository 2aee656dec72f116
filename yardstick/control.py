"""The readings that a cell's limits are set from (not run by the benchmark).

    python -m yardstick.control --workload <cell> --program-seeds S... \
        --control-seeds S... [--faults half_batch local_grad] [--out FILE]

- program: the program's own numbers on each seed, at the cell's size and
  through its timed call, with no measured window (training: set-up's first
  three updates; extraction: one pass after set-up's warm pass). On a cell
  of several chips the ranks run as the benchmark runs them, one process a
  rank, all seeds in one process group.
- control: the reference put in the program's place and computed in TF32,
  the precision below the configurations' float32 with TF32 off.
- faults (training): the reference in the program's place with a fault
  planted (``drivers/train.py::FAULTS``).

Each reading is the driver's own (``program_numbers``, ``control_numbers``).

One JSON object: per seed the numbers, and per number the largest program
reading (the lower reading) and the least control and fault readings.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import torch

from yardstick import run
from yardstick import spec as specs


def program_readings(cell_spec, seeds, device, rank=0, mesh_cfg=None):
    out = []
    for seed in seeds:
        t0 = time.perf_counter()
        cell = cell_spec.driver()(cell_spec, seed, device, rank, mesh_cfg)
        cell.setup()
        if rank == 0:
            out.append({"seed": seed, **cell.program_numbers(),
                        "seconds": time.perf_counter() - t0})
        else:
            cell.release()
        del cell
        if mesh_cfg is not None:
            torch.distributed.barrier()
    return out


def _ranked_readings(cell_spec, seeds, rank, world, port, queue):
    from yardstick import program

    mesh_cfg, device = program.bring_up(world, rank, port, "cuda")
    try:
        rows = program_readings(cell_spec, seeds, device, rank, mesh_cfg)
    finally:
        program.shut_down()
    if queue is not None:
        queue.put(rows)
    return rows


def ranked_program_readings(cell_spec, seeds):
    import multiprocessing

    from yardstick import program

    os.environ["NCCL_SHM_DISABLE"] = "1"
    program.build_kernels()
    port = run._free_port()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_ranked_readings, args=(cell_spec, seeds, r, cell_spec.chips, port, None))
             for r in range(1, cell_spec.chips)]
    for p in procs:
        p.start()
    try:
        return _ranked_readings(cell_spec, seeds, 0, cell_spec.chips, port, None)
    finally:
        for p in procs:
            p.join(timeout=300)


def control_readings(cell_spec, seeds, device, fault=None):
    out = []
    for seed in seeds:
        t0 = time.perf_counter()
        numbers = cell_spec.driver()(cell_spec, seed, device).control_numbers(fault)
        out.append({"seed": seed, **numbers, "seconds": time.perf_counter() - t0})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m yardstick.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    run.set_cache_dirs()
    cell_spec = specs.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("yardstick.control: no CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    report = {"workload": args.workload, "device": torch.cuda.get_device_name(0), "limits": cell_spec.limits}
    if args.program_seeds:
        report["program"] = (ranked_program_readings(cell_spec, args.program_seeds)
                             if cell_spec.chips > 1 else
                             program_readings(cell_spec, args.program_seeds, device))
    if args.control_seeds:
        report["control"] = control_readings(cell_spec, args.control_seeds, device)
        for fault in args.faults:
            report[f"fault_{fault}"] = control_readings(cell_spec, args.control_seeds, device, fault)
    summary = {}
    for key in cell_spec.limits:
        row = {}
        for side in ("program", "control", *[f"fault_{f}" for f in args.faults]):
            vals = [r[key] for r in report.get(side, [])]
            if vals:
                row[side] = (max if side == "program" else min)(
                    v if math.isfinite(v) else math.inf for v in vals)
        summary[key] = row
    report["summary"] = summary
    cell = cell_spec.driver()(cell_spec, args.control_seeds[0], device) if args.control_seeds else None
    if hasattr(cell, "left_out"):
        cell.make_inputs()
        report["left_out_of_change"] = cell.left_out()
    text = json.dumps(report, indent=1, default=float)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
