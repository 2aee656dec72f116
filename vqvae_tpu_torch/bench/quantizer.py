"""Nearest-code search micro-benchmark on the card: the hand-written kernels
against their plain version and one library call (counterpart of
``tools/bench_quantizer.py``).

    python -m vqvae_tpu_torch.bench.quantizer [--config default big_batch] [--precision highest]
        [--out build/bench/quantizer.json]

It times the kernels, so it needs the card (``time_ms`` raises without one).

For each config (the JAX tool's ``CONFIGS``) and mode: the route
``cuda_quantizer.kernel_route`` picks, the other route where its envelope
takes the mode and depth (``mma`` takes ``default`` and ``high`` with D a
multiple of 16 up to 256, so every config runs both kernels in those modes
and ``fma`` alone in ``highest``), the plain version
(``code_scores(...).argmin``) and one PyTorch matmul + argmin, each timed by
``time_ms`` behind a device spin, in ``alternate``'s turns. Each row carries
the least time the card could take (``bound``) and what binds it.

Inputs are random from a seeded generator, made on the device. At
``stress_big`` the plain version's (65,536, 8,192) fp32 scores take 2.1 GB.
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, Optional, Tuple

import torch

from vqvae_tpu_torch.bench import write_rows
from vqvae_tpu_torch.bench.timing import alternate, device_line, time_ms
from vqvae_tpu_torch.device import resolve_device
from vqvae_tpu_torch.ops import cuda_quantizer
from vqvae_tpu_torch.ops.quantizer import code_scores
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
    """One PyTorch matmul + argmin in the mode's operand type (bf16 for
    ``default``), a yardstick the port never calls."""
    e_sq = (cb * cb).sum(1)[None, :]
    if mode == "default":
        cb_bf16 = cb.to(torch.bfloat16)
        return lambda: (e_sq - 2.0 * (z.to(torch.bfloat16) @ cb_bf16.T).float()).argmin(1)
    return lambda: (e_sq - 2.0 * (z @ cb.T)).argmin(1)


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m vqvae_tpu_torch.bench.quantizer")
    ap.add_argument("--config", type=str, nargs="*", default=list(CONFIGS), choices=sorted(CONFIGS))
    ap.add_argument("--precision", type=str, nargs="*", default=list(MODES), choices=MODES)
    ap.add_argument("--out", type=str, default=None, help="also write the rows to this JSON file")
    args = ap.parse_args(argv)
    rows = [run(config, mode) for config in args.config for mode in args.precision]
    write_rows({"metric": "nearest-code search ms a call, kernels vs plain vs library", "rows": rows},
               args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
