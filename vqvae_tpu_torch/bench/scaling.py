"""Weak scaling of encode + quantize over data-parallel ranks (counterpart of
``tools/bench_scaling.py``).

    python -m vqvae_tpu_torch.bench.scaling [--device cpu] [--out F]
    python -m vqvae_tpu_torch.bench.scaling worker --device cuda --n-ranks 2 --rank 0 --port P   # internal

Every rank holds ``PER_RANK_BATCH`` images of one global batch (the JAX
worker's seeded draws, cut into the ranks' rows) and the whole model (a
default ``VQVAEConfig``: bf16 convs on the card, fp32 on the CPU; weights
from seed 0), and runs ``encode`` then ``quantize``'s indices in a loop. As
in the JAX worker, each call feeds the next: the sum of the global batch's
indices (an all-reduce over the ranks) bumps the images by
``(sum % 7) * 1e-9``. The rate is the global batch over the time of a call,
by the interleaved two-point rule (best of 5 of each window), each window's
time the slowest rank's.

Each rank count runs in a fresh process group of its own processes
(``torch.distributed``, ``init_method`` tcp on 127.0.0.1 and a free port; gloo
on the CPU, NCCL with one card a rank on the card). Rank 0 prints one JSON
line: ``device``, ``n_ranks``, ``global_batch``, ``images_per_sec`` (the
global rate) and its nearest-code kernel launches.

CPU rows run n = 1, 2, 4 ranks on the host's cores, each rank with its
share of the cores: ideal weak scaling there is a flat total rate
(``flat_throughput_ratio`` about 1.0), and a row with more ranks than cores
is ``host_oversubscribed``, as in the JAX tool. Card rows run n = 1, and 2
and 4 only where the machine has that many cards; ``scaling_efficiency`` =
rate(n) / (n * rate(1)) is written for them alone. Ranks that share one card
are never reported as a row of several cards.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from vqvae_tpu_torch.bench import write_rows
from vqvae_tpu_torch.bench.parity import ROOT
from vqvae_tpu_torch.bench.timing import device_line, interleaved_two_point, sync_fn
from vqvae_tpu_torch.config import VQVAEConfig
from vqvae_tpu_torch.device import resolve_device

PER_RANK_BATCH = 128  # weak scaling: global batch = n_ranks * this
CPU_ITERS = (5, 25)
CARD_ITERS = (20, 120)
REPEATS = 5
RANK_COUNTS = (1, 2, 4)
WORKER_TIMEOUT_S = 300
# the JAX tool's payload and row names that the port names otherwise
JAX_NAMES = {"cpu_virtual_mesh": "cpu_ranks", "tpu_1chip": "card_1chip", "backend": "device",
             "n_devices": "n_ranks"}


def worker(device: str, n_ranks: int, rank: int, init_method: str, cfg: Optional[VQVAEConfig] = None,
           iters: Optional[tuple] = None) -> Optional[dict]:
    """One rank: join the group, measure, leave it. Rank 0 returns the row."""
    from vqvae_tpu_torch.bench.encode import encode_quantize, make_model
    from vqvae_tpu_torch.ops import cuda_quantizer

    on_card = device == "cuda"
    if on_card:
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    else:
        dev = torch.device("cpu")
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n_ranks))
    dist.init_process_group("nccl" if on_card else "gloo", init_method=init_method,
                            world_size=n_ranks, rank=rank)
    try:
        cfg = cfg or VQVAEConfig(compute_dtype="bfloat16" if on_card else "float32")
        model = make_model(cfg, dev, seed=0)
        batch = PER_RANK_BATCH * n_ranks
        images = np.random.default_rng(0).normal(size=(batch, 32, 32, 3)).astype(np.float32)
        x0 = torch.from_numpy(images[rank * PER_RANK_BATCH:(rank + 1) * PER_RANK_BATCH]).to(dev)
        sync = sync_fn(dev)

        @torch.inference_mode()
        def run_timed(k: int) -> float:
            x = x0
            sync()
            t0 = time.perf_counter()
            for _ in range(k):
                total = encode_quantize(model, x).sum(dtype=torch.int64)
                dist.all_reduce(total)
                x = x + (total.float() % 7.0) * 1e-9
            sync()
            # every rank takes the slowest rank's time, so all make the same choices
            elapsed = torch.tensor([time.perf_counter() - t0], dtype=torch.float64, device=dev)
            dist.all_reduce(elapsed, op=dist.ReduceOp.MAX)
            return float(elapsed)

        lo, hi = iters or (CARD_ITERS if on_card else CPU_ITERS)
        cuda_quantizer.reset_launch_counts()
        run_timed(lo)
        run_timed(hi)
        per_iter = interleaved_two_point(run_timed, lo, hi, REPEATS)
        if rank != 0:
            return None
        return {"device": dev.type, "n_ranks": n_ranks, "global_batch": batch,
                "images_per_sec": batch / per_iter, "launches": dict(cuda_quantizer.launches_by_route)}
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_workers(device: str, n_ranks: int, timeout: float = WORKER_TIMEOUT_S) -> dict:
    """``n_ranks`` worker processes in a fresh group; rank 0's row. Every
    process is killed if the group has not finished within ``timeout``."""
    port = free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "vqvae_tpu_torch.bench.scaling", "worker", "--device", device,
         "--n-ranks", str(n_ranks), "--rank", str(rank), "--port", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT, env=env)
        for rank in range(n_ranks)]
    deadline = time.time() + timeout
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=max(1.0, deadline - time.time())))
    finally:  # a group cut by the limit leaves no process behind
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    failed = [(rank, p.returncode, err) for rank, (p, (_out, err)) in enumerate(zip(procs, outs))
              if p.returncode != 0]
    if failed:
        rank, rc, err = failed[0]
        raise RuntimeError(f"worker {device} x{n_ranks} rank {rank} exited {rc}:\n{err[-2000:]}")
    return json.loads(outs[0][0].strip().splitlines()[-1])


def payload(cpu_rows: List[dict], card_rows: List[dict], cores: int, card: str) -> dict:
    """The JAX tool's payload (its names mapped by ``JAX_NAMES``) from the rows."""
    base = cpu_rows[0]["images_per_sec"]
    for r in cpu_rows:
        # ranks share the host's cores: ideal is a flat total rate
        r["flat_throughput_ratio"] = r["images_per_sec"] / base
        # more ranks than cores time-slice the host: not the framework's overhead
        r["host_oversubscribed"] = r["n_ranks"] > cores
    card_1 = next((r for r in card_rows if r["n_ranks"] == 1), None)
    for r in card_rows:
        r["scaling_efficiency"] = r["images_per_sec"] / (r["n_ranks"] * card_1["images_per_sec"])
    within = [r["flat_throughput_ratio"] for r in cpu_rows if not r["host_oversubscribed"]]
    return {
        "metric": f"encode_quantize_images_per_sec (weak scaling, per-rank batch {PER_RANK_BATCH})",
        "note": "cpu rows run one process a rank on one host's cores (each rank its share of "
                "them), so ideal is a flat total rate (flat_throughput_ratio ~1.0), not linear "
                "speedup; card rows run one card a rank (NCCL) and apply scaling_efficiency = "
                "rate(n) / (n * rate(1)); ranks sharing one card are never a card row",
        "scaling_efficiency_formula": "rate(n_cards) / (n_cards * rate(1_card))",
        "host_cpu_cores": cores,
        "baseline_target": ">=0.80 from 1 host to 2 hosts (BASELINE.md)",
        "cpu_ranks": cpu_rows,
        "card_1chip": card_1,
        "card_rows": card_rows,
        "card": card,
        "min_flat_throughput_ratio_within_cores": min(within) if within else None,
        "min_flat_throughput_ratio_all": min(r["flat_throughput_ratio"] for r in cpu_rows),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m vqvae_tpu_torch.bench.scaling")
    sub = ap.add_subparsers(dest="cmd")
    pw = sub.add_parser("worker", help="one rank (launched by the tool)")
    pw.add_argument("--device", required=True, choices=["cuda", "cpu"])
    pw.add_argument("--n-ranks", type=int, required=True)
    pw.add_argument("--rank", type=int, required=True)
    pw.add_argument("--port", type=int, required=True)
    ap.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the CPU rows and the card rows; cpu: the CPU rows only")
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args(argv)

    if args.cmd == "worker":
        row = worker(args.device, args.n_ranks, args.rank, f"tcp://127.0.0.1:{args.port}")
        if row is not None:
            print(json.dumps(row), flush=True)
        return 0

    dev = resolve_device(args.device)
    cores = os.cpu_count() or 1
    cpu_rows = []
    for n in RANK_COUNTS:
        cpu_rows.append(launch_workers("cpu", n))
        print(f"cpu, {n} ranks: {cpu_rows[-1]['images_per_sec']:.1f} images/s", flush=True)
    card_rows = []
    if dev.type == "cuda":
        from vqvae_tpu_torch.ops import cuda_quantizer

        print(f"kernels: {cuda_quantizer.build()}", flush=True)  # once, before the ranks load it
        for n in RANK_COUNTS:
            if n > torch.cuda.device_count():
                print(f"card, {n} ranks: skipped ({torch.cuda.device_count()} cards)", flush=True)
                continue
            card_rows.append(launch_workers("cuda", n))
            print(f"card, {n} ranks: {card_rows[-1]['images_per_sec']:.1f} images/s", flush=True)
    write_rows(payload(cpu_rows, card_rows, cores, device_line(dev)), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
