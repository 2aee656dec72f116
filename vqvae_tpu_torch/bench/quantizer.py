"""Nearest-code search micro-benchmark on the card: the hand-written kernels
against their plain version and the matmul branch (counterpart of
``tools/bench_quantizer.py`` and of the kernel-vs-XLA half of
``tools/autotune_quantizer.py``).

    python -m vqvae_tpu_torch.bench.quantizer [--config default big_batch] [--precision highest]
        [--out build/bench/quantizer.json]
    python -m vqvae_tpu_torch.bench.quantizer --grid [--out artifacts_torch/autotune_h100.json]

It times the kernels, so it needs the card (``time_ms`` raises without one).

For each config (the JAX tool's ``CONFIGS``) and mode: the route
``cuda_quantizer.kernel_route`` picks, the other route where its envelope
takes the mode and depth (``mma`` takes ``default`` and ``high`` with D a
multiple of 16 up to 256, so every config runs both kernels in those modes
and ``fma`` alone in ``highest``), the plain version
(``code_scores(...).argmin``) and the matmul branch
(``ops/quantizer.py::nearest_code_matmul``, what ``"jnp"`` runs on the card
and ``"auto"`` where it measured faster), each timed by ``time_ms`` behind a
device spin, in ``alternate``'s turns. Each row carries the least time the
card could take (``bound``) and what binds it.

``--grid`` is the sweep that ``_auto_impl``'s thresholds are fitted to: every
(N, K, D) of ``GRID_N`` x ``GRID_K`` x ``GRID_D`` in every mode (144 rows),
each with both turns of the kernel ``kernel_route`` picks and of the matmul
branch (each with its gather of z_q, as the dispatch runs them), of the
plain version and of the branch's NaN pass alone (``nan_to_num_`` over an
(N, K) fp32 buffer), each route's ``call_ms`` (a call at the host's pace, no
spin), the bound, ``verdict``'s winner, and the codes of the kernel and of
the branch against the plain version's under the near-tie rule
(``compare_assignments``). Run it in a fresh process, alone on the card.

Inputs are random from a seeded generator, made on the device. At
``stress_big`` the plain version's (65,536, 8,192) fp32 scores take 2.1 GB.
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, Optional, Tuple

import torch

from vqvae_tpu_torch.bench import write_rows
from vqvae_tpu_torch.bench.timing import alternate, alternate_turns, device_line, time_ms
from vqvae_tpu_torch.device import resolve_device
from vqvae_tpu_torch.ops import cuda_quantizer
from vqvae_tpu_torch.ops.quantizer import (
    code_scores,
    compare_assignments,
    nearest_code_matmul,
    nearest_code_torch,
)
from vqvae_tpu_torch.utils.flops import H100_SXM

CONFIGS = {
    # (N rows, K codes, D dim): N = batch32 x 8x8 grid
    "default": (2048, 512, 64),
    "stress": (2048, 8192, 256),
    "big_batch": (65536, 512, 64),
    "stress_big": (65536, 8192, 256),
    # mid-size codebooks between the two anchors K*D = 2^15 and 2^21
    "mid17": (2048, 2048, 64),    # K*D = 2^17
    "mid18": (2048, 2048, 128),   # K*D = 2^18
    "mid19": (2048, 4096, 128),   # K*D = 2^19
}
MODES = ("highest", "high", "default")
# the sweep: the fleets' and the reference's 2,048 rows (batch 32), an
# extraction batch of 256 (16,384) and the JAX bench's 1,024 (65,536), across
# the codebooks between the reference's (512, 64) and the JAX tool's stress
GRID_N = (2048, 4096, 16_384, 65_536)
GRID_K = (512, 2048, 4096, 8192)
GRID_D = (64, 128, 256)
# calls a timing of the sweep averages: the plain version and the branch in
# "high" queue some 20 launches a call, and time_ms's 50 calls overflow the
# card's queue of pending launches before the device spin ends
GRID_ITERS = 20
# the matmul branch must beat the kernel by this share, and by more than the
# row's spread between turns, to be chosen; anything less is a tie, and a tie
# goes to the kernel
MARGIN = 0.10


def bound(n: int, k: int, d: int, mode: str):
    """Least time (ms) for the search on an H100 SXM (published peaks,
    ``vqvae_tpu_torch/utils/flops.py``), and what binds it.

    Bytes: z and the codebook read once (fp32, as given), idx written once.
    Operations: 2NKD multiply-adds; "high" does three bf16 products.
    """
    nbytes = 4 * (n * d + k * d + n)
    flops = 2.0 * n * k * d
    if mode == "highest":
        t_ops = flops / H100_SXM.peak_fp32_flops
    else:
        t_ops = (3 if mode == "high" else 1) * flops / H100_SXM.peak_bf16_flops
    t_bytes = nbytes / H100_SXM.hbm_bytes_per_sec
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def routes(mode: str, d: int) -> Tuple[str, ...]:
    """The route the dispatch picks first, then ``fma`` where that is another."""
    return tuple(dict.fromkeys((cuda_quantizer.kernel_route(mode, d), "fma")))


def library_call(z: torch.Tensor, cb: torch.Tensor, mode: str) -> Callable:
    """The matmul branch on these inputs: cuBLAS's product in the mode's exact
    arithmetic, fp32 scores, the kernels' NaN rule, argmin, gather."""
    return lambda: nearest_code_matmul(z, cb, mode)


def verdict(kernel_turns, matmul_turns) -> str:
    """Which route a sweep row says is faster: "jnp" (the matmul branch) where
    its faster turn beats the kernel's by more than the row's spread between
    turns and by at least ``MARGIN``, else "pallas" (the kernel: a tie goes
    to it)."""
    k_ms, m_ms = min(kernel_turns), min(matmul_turns)
    spread = max(max(kernel_turns) - k_ms, max(matmul_turns) - m_ms)
    return "jnp" if k_ms - m_ms > spread and m_ms <= (1.0 - MARGIN) * k_ms else "pallas"


def run(config: str, mode: str = "highest", device="cuda", timer: Callable = time_ms,
        shape: Optional[Tuple[int, int, int]] = None, seed: int = 0) -> dict:
    """One row: every route's ms, the plain and library ms, the bound.

    ``timer`` is ``time_ms`` on the card; a run on the CPU passes the host
    clock (``timing.host_ms``). ``shape`` replaces the config's (N, K, D)."""
    dev = resolve_device(device)
    n, k, d = shape or CONFIGS[config]
    gen = torch.Generator(device=dev).manual_seed(seed)
    z = torch.randn((n, d), generator=gen, device=dev)
    cb = torch.randn((k, d), generator=gen, device=dev)
    picked = routes(mode, d)
    fns = {"plain": lambda: code_scores(z, cb, mode).argmin(1)}
    for route in picked:
        fns[route] = lambda route=route: cuda_quantizer.nearest_code_indices(z, cb, mode, route)
    fns["library"] = library_call(z, cb, mode)
    t = alternate(fns, timer)  # plain, kernels, library, library, kernels, plain
    ms = t[picked[0]]
    b_ms, b_by = bound(n, k, d, mode)
    return {
        "config": config,
        "shape": [n, k, d],
        "precision": mode,
        "route": picked[0],
        "ms": ms,
        "route_ms": {route: t[route] for route in picked},
        "plain_ms": t["plain"],
        "library_ms": t["library"],
        "bound_ms": b_ms,
        "bound_by": b_by,
        "roofline_share": b_ms / ms,
        "rows_per_sec": n / (ms * 1e-3),
        "us_per_call": ms * 1e3,
        "eff_tflops": 2.0 * n * k * d / (ms * 1e-3) / 1e12,
        "device": device_line(dev),
        "timer": "cuda events behind a device spin" if timer is time_ms else "host clock",
    }


def _grid_ms(fn) -> float:
    return time_ms(fn, iters=GRID_ITERS, warmup=3)


def _call_ms(fn) -> float:
    return time_ms(fn, iters=GRID_ITERS, warmup=3, queue_ahead=False)


def grid_row(n: int, k: int, d: int, mode: str, device="cuda", timer: Callable = _grid_ms,
             call_timer: Callable = _call_ms, seed: int = 0) -> dict:
    """One row of the sweep at (N, K, D) and ``mode``: both turns of the
    kernel ``kernel_route`` picks, of the matmul branch, of the plain version
    and of the NaN pass alone; each route's ``call_ms``; the bound;
    ``verdict``; the codes of both routes against the plain version's.

    Both routes are timed as the dispatch runs them, the gather of z_q
    included: ``nearest_code_cuda`` and ``nearest_code_matmul``. ``timer``
    and ``call_timer`` are ``time_ms`` over ``GRID_ITERS`` calls behind a spin
    and without one on the card; a run on the CPU passes the host clock for
    both."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    z = torch.randn((n, d), generator=gen, device=dev)
    cb = torch.randn((k, d), generator=gen, device=dev)
    route = cuda_quantizer.kernel_route(mode, d)
    kernel = lambda: cuda_quantizer.nearest_code_cuda(z, cb, mode, route)  # noqa: E731
    matmul = library_call(z, cb, mode)
    inf = float("inf")
    buf = torch.randn((n, k), generator=gen, device=dev)
    turns = alternate_turns({
        "plain": lambda: code_scores(z, cb, mode).argmin(1),
        "kernel": kernel,
        "matmul": matmul,
        "nan_pass": lambda: buf.nan_to_num_(nan=inf, posinf=inf, neginf=-inf),
    }, timer)
    del buf
    _zq, idx_plain = nearest_code_torch(z, cb, mode)
    agree = {}
    for name, idx in (("kernel", kernel()[1]), ("matmul", matmul()[1])):
        mism, near, gap = compare_assignments(z, cb, idx, idx_plain, mode)
        agree[name] = {"mismatches": mism, "near_ties": near, "max_gap": gap}
    b_ms, b_by = bound(n, k, d, mode)
    return {
        "shape": [n, k, d],
        "precision": mode,
        "route": route,
        "kernel_ms": min(turns["kernel"]),
        "matmul_ms": min(turns["matmul"]),
        "plain_ms": min(turns["plain"]),
        "nan_pass_ms": min(turns["nan_pass"]),
        "turns": turns,
        "kernel_call_ms": call_timer(kernel),
        "matmul_call_ms": call_timer(matmul),
        "bound_ms": b_ms,
        "bound_by": b_by,
        "winner": verdict(turns["kernel"], turns["matmul"]),
        "vs_plain": agree,
    }


def grid(device="cuda", timer: Callable = _grid_ms, call_timer: Callable = _call_ms,
         shapes=None, modes=MODES) -> dict:
    """The sweep: ``grid_row`` at every shape (default ``GRID_N`` x ``GRID_K``
    x ``GRID_D``) and mode, headed by the card's ``nvidia-smi`` line."""
    dev = resolve_device(device)
    shapes = shapes or [(n, k, d) for n in GRID_N for k in GRID_K for d in GRID_D]
    rows = []
    for n, k, d in shapes:
        for mode in modes:
            rows.append(grid_row(n, k, d, mode, dev, timer, call_timer))
            print(f"{rows[-1]['shape']} {mode}: kernel {rows[-1]['kernel_ms']:.5f} ms, matmul "
                  f"{rows[-1]['matmul_ms']:.5f} ms -> {rows[-1]['winner']}", file=sys.stderr, flush=True)
    return {
        "device": device_line(dev),
        "torch": torch.__version__,
        "metric": "nearest-code search ms a call: the kernel kernel_route picks against the matmul "
                  "branch, both turns of alternate (plain, kernel, matmul, NaN pass, and back)",
        "timer": (f"cuda events, mean of {GRID_ITERS} calls behind a device spin (call_ms: no spin)"
                  if timer is _grid_ms else "host clock"),
        "margin": MARGIN,
        "rows": rows,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m vqvae_tpu_torch.bench.quantizer")
    ap.add_argument("--config", type=str, nargs="*", default=list(CONFIGS), choices=sorted(CONFIGS))
    ap.add_argument("--precision", type=str, nargs="*", default=list(MODES), choices=MODES)
    ap.add_argument("--grid", action="store_true",
                    help="the sweep of GRID_N x GRID_K x GRID_D in every mode instead of the configs")
    ap.add_argument("--out", type=str, default=None, help="also write the rows to this JSON file")
    args = ap.parse_args(argv)
    if args.grid:
        write_rows(grid(), args.out)
        return 0
    rows = [run(config, mode) for config in args.config for mode in args.precision]
    write_rows({"metric": "nearest-code search ms a call, kernels vs plain vs the matmul branch",
                "rows": rows}, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
