"""AR sampling on the card: the cached incremental decoder against the
reference's one full forward a pixel (counterpart of ``tools/bench_sampler.py``).

    python -m vqvae_tpu_torch.bench.sampler [--batch_sizes 256 1024 4096] [--side 8] [--band]
        [--no_naive] [--repeats 6] [--device cpu] [--out build/bench/sampler.json]

The prior is a ``GatedPixelCNN`` at the default config (15 layers, dim 64,
512 codes) with torch-default weights drawn from a seed. Schemes:
``naive_full_forward`` (``GatedPixelCNN.generate``: one full forward a pixel,
the reference's algorithm) and ``cached_incremental``
(``CachedPixelCNNSampler.generate`` with the whole-grid row refresh); with
``band`` the cached decoder runs with both row refreshes, ``full`` and
``band``. Every call draws from a generator seeded alike, so all schemes
draw from one stream (``grids_differing`` counts the grids where a scheme
parts from the first). A row is the best of ``repeats`` calls on the host
clock, each ending in a synchronisation, after one warm-up call.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, Dict

import torch

from vqvae_tpu_torch.bench import write_rows
from vqvae_tpu_torch.bench.timing import device_line, sync_fn
from vqvae_tpu_torch.config import PixelCNNConfig
from vqvae_tpu_torch.device import resolve_device
from vqvae_tpu_torch.models.pixelcnn import GatedPixelCNN
from vqvae_tpu_torch.models.pixelcnn_sampler import CachedPixelCNNSampler


def make_prior(cfg: PixelCNNConfig, device: torch.device, seed: int = 0) -> GatedPixelCNN:
    """A prior with torch-default weights drawn from ``seed``, on ``device``."""
    model = GatedPixelCNN(cfg)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(device).eval()


def schemes(model: GatedPixelCNN, include_band: bool = False,
            include_naive: bool = True) -> Dict[str, Callable]:
    """name -> fn(labels, generator, shape, batch_size) -> (B, H, W) int32 grids."""
    out = {}
    if include_naive:
        out["naive_full_forward"] = model.generate
    for mode in ("full", "band") if include_band else ("full",):
        name = f"cached_incremental_{mode}" if include_band else "cached_incremental"
        out[name] = CachedPixelCNNSampler(model, row_refresh=mode).generate
    return out


def bench(
    batch_size: int,
    side: int = 8,
    repeats: int = 6,
    include_band: bool = False,
    include_naive: bool = True,
    device="cuda",
    cfg: PixelCNNConfig = PixelCNNConfig(),
    seed: int = 0,
) -> dict:
    """One row at (batch_size, side x side grids)."""
    dev = resolve_device(device)
    sync = sync_fn(dev)
    model = make_prior(cfg, dev, seed)
    labels = torch.zeros((batch_size,), dtype=torch.long, device=dev)
    out, first = {}, None
    for name, fn in schemes(model, include_band, include_naive).items():
        def call():
            gen = torch.Generator(device=dev).manual_seed(seed + 1)
            with torch.inference_mode():
                return fn(labels, gen, (side, side), batch_size)

        grids = call()  # warm-up, and the grids the scheme draws
        if first is None:
            first = grids
        best = float("inf")
        for _ in range(repeats):
            sync()
            t0 = time.perf_counter()
            call()
            sync()
            best = min(best, time.perf_counter() - t0)
        out[name] = {
            "grids_per_sec": batch_size / best,
            "ms_per_batch": best * 1e3,
            "grids_differing": int((grids != first).flatten(1).any(1).sum()),
        }
        print(f"{side}x{side}", name, out[name], flush=True)
    cached_best = min(v["ms_per_batch"] for k, v in out.items() if k.startswith("cached"))
    speedup = out["naive_full_forward"]["ms_per_batch"] / cached_best if include_naive else None
    return {"batch_size": batch_size, "side": side, "speedup": speedup, "repeats": repeats,
            "device": device_line(dev), **out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m vqvae_tpu_torch.bench.sampler")
    ap.add_argument("--batch_sizes", type=int, nargs="*", default=[256, 1024, 4096])
    ap.add_argument("--side", type=int, default=8, help="grid side (H=W)")
    ap.add_argument("--band", action="store_true",
                    help="also bench the band-limited row refresh")
    ap.add_argument("--no_naive", action="store_true",
                    help="skip the one-full-forward-a-pixel baseline")
    ap.add_argument("--repeats", type=int, default=6)
    ap.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", type=str, default=None, help="also write the rows to this JSON file")
    args = ap.parse_args(argv)
    rows = [bench(b, args.side, args.repeats, args.band, not args.no_naive, args.device)
            for b in args.batch_sizes]
    write_rows({"metric": f"{args.side}x{args.side} grids/s, cached incremental AR decode vs "
                          "one full forward a pixel", "rows": rows}, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
