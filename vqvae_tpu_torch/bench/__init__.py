"""The port's benchmark (counterpart of the root's ``bench.py`` and of the
measuring tools of ``tools/``), on the CUDA card.

    python -m vqvae_tpu_torch.bench [--device cpu] [--iters_lo 20 --iters_hi 120 --repeats 3]
    python -m vqvae_tpu_torch.cli benchmark [model flags] [--device cpu]

print exactly one JSON line with ``bench.py``'s keys: encode + quantize
images/s at batch 1,024 (``value``: bf16 convs, the fp32 search, route
``fma``; ``serving_value``: the ``default`` search, route ``mma``), their
MFU, ``vs_baseline`` against the pinned torch-CPU rate, the FLOP an image
and the chip, plus ``device`` (the card's name and power limit, or "cpu").
Where ``bench.py`` quotes train-step figures from a committed artifact, this
one measures them at batch 256 (``train.bench_batch``: fp32/``highest`` and
bf16/``default``). On the CPU the device metrics (``mfu``, the device ms)
are None and the rates stand beside ``"device": "cpu"``.

The tools, each ``python -m vqvae_tpu_torch.bench.<name>`` with the JAX
tool's flags, ``--out`` (no default path: without it the rows are printed
only) and, but for the search bench, which times kernels, ``--device``:

- ``timing``: the two-point rule, ``time_ms`` behind a device spin, ``alternate``;
- ``encode``: the unit of work of this line;
- ``train``, ``prior``: the VQ-VAE's and the prior's train steps;
- ``quantizer``: the nearest-code kernels against the plain version;
- ``sampler``: the cached AR sampler against one full forward a pixel;
- ``serve``: the sampling service under concurrent clients;
- ``parity``: the 5,000-update convergence fleets and their verdicts;
- ``e2e``: the reference's whole pipeline at its own scale, and its report;
- ``scaling``: weak scaling of encode + quantize over ranks;
- ``conv_strategy``: the space-to-depth lowering of the k4/s2 convs;
- ``conv_wgrad``: the weight-gradient kernel at the training convolutions.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Tuple

METRIC = "cifar10_encode_quantize_images_per_sec_per_chip"
TRAIN_BATCH = 256


def write_rows(payload: dict, out: Optional[str]) -> None:
    """Print a tool's rows; with ``out``, also write them there. No tool has a
    default path: the JAX package's ``artifacts/`` are not the port's to write."""
    print(json.dumps(payload, indent=2))
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            json.dump(payload, f, indent=2)
        print(f"wrote {out}")


def run(base=None, device="cuda", iters_lo: Optional[int] = None, iters_hi: Optional[int] = None,
        repeats: Optional[int] = None) -> dict:
    """The one line, at the widths of the VQ-VAE config ``base`` (default: the
    reference's). ``iters_lo``/``iters_hi``/``repeats`` replace every timed
    window of the line: the encode points' (bench.py's 20/120, best of 3) and
    the train rows' (the train tool's 10/60 at batch 256, best of 3)."""
    from vqvae_tpu_torch.bench import encode, train
    from vqvae_tpu_torch.bench.timing import chip_name, device_line
    from vqvae_tpu_torch.config import VQVAEConfig
    from vqvae_tpu_torch.device import resolve_device

    base = base or VQVAEConfig()
    dev = resolve_device(device)
    windows: Tuple[int, int] = (iters_lo or encode.ITERS_LO, iters_hi or encode.ITERS_HI)
    repeats = repeats or encode.TIMED_REPEATS
    points = {name: encode.bench_config(cfg, dev, encode.BATCH, *windows, repeats)
              for name, cfg in encode.benchmark_configs(base).items()}
    train_lo, train_hi = train._windows(TRAIN_BATCH)
    train_windows = (iters_lo or train_lo, iters_hi or train_hi)
    train_rows = {dtype: train.bench_batch(TRAIN_BATCH, compute_dtype=dtype, device=dev, base=base,
                                           windows=train_windows, repeats=repeats)
                  for dtype in ("float32", "bfloat16")}
    value, serving = points["value"], points["serving_value"]
    return {
        "metric": METRIC,
        "value": round(value["images_per_sec"], 1),
        "unit": "images/sec/chip",
        "vs_baseline": round(value["images_per_sec"] / encode.torch_baseline(), 2),
        "mfu": value["mfu"],
        "serving_value": round(serving["images_per_sec"], 1),
        "serving_mfu": serving["mfu"],
        "baseline_pinned": os.path.exists(encode.BASELINE_PIN),
        "flops_per_image": value["flops_per_image"],
        "chip": chip_name(dev),
        "device": device_line(dev),
        "device_ms_per_batch": value["device_ms_per_batch"],
        "busy_share": value["busy_share"],
        "serving_device_ms_per_batch": serving["device_ms_per_batch"],
        "serving_busy_share": serving["busy_share"],
        "train_images_per_sec_per_chip_b256": round(train_rows["float32"]["images_per_sec_per_chip"], 1),
        "train_mfu_b256": train_rows["float32"]["train_mfu"],
        "train_bf16_images_per_sec_per_chip_b256": round(
            train_rows["bfloat16"]["images_per_sec_per_chip"], 1),
        "train_step_ms_b256": train_rows["float32"]["step_ms"],
        "train_bf16_step_ms_b256": train_rows["bfloat16"]["step_ms"],
        "windows": {"encode": list(windows), "train": train_rows["float32"]["windows"],
                    "repeats": repeats},
    }


def add_window_flags(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--iters_lo", type=int, default=None,
                    help="short window of every timed loop (default: bench.py's 20 for "
                         "encode, the train tool's 10 at batch 256)")
    ap.add_argument("--iters_hi", type=int, default=None,
                    help="long window (default: 120 for encode, 60 for the train rows)")
    ap.add_argument("--repeats", type=int, default=None,
                    help="best of this many lo/hi pairs (default 3)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m vqvae_tpu_torch.bench")
    add_window_flags(ap)
    ap.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    print(json.dumps(run(None, args.device, args.iters_lo, args.iters_hi, args.repeats)))
    return 0


__all__ = ["METRIC", "TRAIN_BATCH", "add_window_flags", "main", "run", "write_rows"]
