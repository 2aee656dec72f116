"""GatedPixelCNN prior train-step throughput on the card: grids/s and MFU
(counterpart of ``tools/bench_prior.py``).

    python -m vqvae_tpu_torch.bench.prior [--batches 32 256] [--compute_dtype bfloat16]
        [--conv_precision default] [--device cpu] [--out build/bench/prior.json]

``PixelCNNTrainer`` at the prior's full width (15 layers, dim 64, 512 codes,
8 x 8 grids) through its own path: random code grids and labels from a
seeded generator, made on the device and staged once with
``stage_dataset``, then windows of ``steps_by_index`` (``train.StagedSteps``:
the state advances from window to window, nothing is read back, each window
ends in a synchronisation), timed by ``interleaved_two_point``.
``train_mfu`` is grids/s times ``pixelcnn_train_step_flops_per_grid`` over
the card's dense bf16 peak, as the JAX tool reckons it.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Tuple

import numpy as np
import torch

from vqvae_tpu_torch.bench import write_rows
from vqvae_tpu_torch.bench.timing import bf16_mfu, chip_name, device_line, interleaved_two_point, sync_fn
from vqvae_tpu_torch.bench.train import StagedSteps
from vqvae_tpu_torch.config import PixelCNNConfig, TrainConfig
from vqvae_tpu_torch.data.datasets import ArrayDataset
from vqvae_tpu_torch.device import resolve_device
from vqvae_tpu_torch.train.pixelcnn_train import PixelCNNTrainer
from vqvae_tpu_torch.utils.flops import pixelcnn_train_step_flops_per_grid

REPEATS = 9


def _windows(batch_size: int) -> Tuple[int, int]:
    """The JAX tool's two-point step counts."""
    if batch_size >= 1024:
        return 10, 60
    return 30, 180


def flops_per_grid(cfg: PixelCNNConfig) -> int:
    """Train-step FLOP a grid at the config's widths."""
    return pixelcnn_train_step_flops_per_grid(
        img_dim=cfg.img_dim, dim=cfg.dim, n_layers=cfg.n_layers, input_dim=cfg.input_dim)


def staged_steps(batch_size: int, cfg: PixelCNNConfig, steps: int, device="cuda",
                 seed: int = 0) -> StagedSteps:
    """A trainer with ``steps`` batches of seeded random grids and labels
    staged on the device, a fresh state from ``seed``, and their indices."""
    dev = resolve_device(device)
    trainer = PixelCNNTrainer(cfg, TrainConfig(batch_size=batch_size, seed=seed), device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    n, d = steps * batch_size, cfg.img_dim
    grids = torch.randint(0, cfg.input_dim, (n, d, d), generator=gen, device=dev)
    labels = torch.randint(0, cfg.n_classes, (n,), generator=gen, device=dev)
    data = ArrayDataset(grids, labels)
    trainer.stage_dataset(data, data)  # no validation is run: the same tensors stand in
    idx = np.arange(n, dtype=np.int64).reshape(steps, batch_size)
    return StagedSteps(trainer, trainer.init_state(), idx, None, sync_fn(dev))


def bench_batch(
    batch_size: int,
    compute_dtype: str = "float32",
    conv_precision: str = "highest",
    device="cuda",
    base: PixelCNNConfig = PixelCNNConfig(),
    windows: Optional[Tuple[int, int]] = None,
    repeats: int = REPEATS,
    seed: int = 0,
) -> dict:
    dev = resolve_device(device)
    steps_lo, steps_hi = windows or _windows(batch_size)
    cfg = base.replace(compute_dtype=compute_dtype, conv_precision=conv_precision)
    run_timed = staged_steps(batch_size, cfg, steps_hi, dev, seed)
    run_timed(steps_lo)
    run_timed(steps_hi)
    per_step = interleaved_two_point(run_timed, steps_lo, steps_hi, repeats)
    per_chip = batch_size / per_step
    flops = flops_per_grid(cfg)
    return {
        "model": "pixelcnn_prior",
        "batch_size": batch_size,
        "compute_dtype": compute_dtype,
        "conv_precision": conv_precision,
        "step_ms": per_step * 1e3,
        "grids_per_sec_per_chip": per_chip,
        "train_flops_per_grid": flops,
        "train_mfu": bf16_mfu(per_chip, flops, dev),
        "chip": chip_name(dev),
        "device": device_line(dev),
        "windows": [steps_lo, steps_hi],
        "repeats": repeats,
        "note": (
            f"prior at compute_dtype={compute_dtype}, conv_precision={conv_precision} "
            "(the reference trains fp32/highest); data staged on the device; the "
            "8x8 convs of 64 and 128 channels keep the bf16-peak denominator far "
            "above what this shape can fill"
        ),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m vqvae_tpu_torch.bench.prior")
    ap.add_argument("--batches", type=int, nargs="*", default=[32, 256])
    ap.add_argument("--compute_dtype", type=str, nargs="*", default=["float32", "bfloat16"],
                    choices=["float32", "bfloat16"])
    ap.add_argument("--conv_precision", type=str, default="highest",
                    choices=["highest", "high", "default"])
    ap.add_argument("--repeats", type=int, default=REPEATS)
    ap.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", type=str, default=None, help="also write the rows to this JSON file")
    args = ap.parse_args(argv)
    rows = [bench_batch(b, dtype, args.conv_precision, args.device, repeats=args.repeats)
            for dtype in args.compute_dtype for b in args.batches]
    write_rows({"metric": "pixelcnn_prior_train_step_grids_per_sec_per_chip (fwd+bwd+Adam)",
                "rows": rows}, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
