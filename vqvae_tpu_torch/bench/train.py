"""VQ-VAE train-step throughput on the card: forward + backward + AMSGrad,
images/s (counterpart of ``tools/bench_train.py``).

    python -m vqvae_tpu_torch.bench.train [--batches 32 256 1024] [--spds 1 10 50]
        [--compute_dtype float32 bfloat16] [--no-ema] [--device cpu] [--out build/bench/train.json]

Rows: every batch in fp32 (the search in ``highest``) and in bf16 (the
search in ``default``), every batch with the EMA codebook (fp32), and the
``steps_per_dispatch`` sweep at batch 32 (fp32).

It times ``VQVAETrainer`` through its own path: the data (random images from
a seeded generator, made on the device) is staged once with
``stage_dataset``, outside the timed windows, and each window runs
``steps_by_index`` on it, so the (K, B) indices are the only data that
crosses to the device. The state advances from window to window, as the JAX
tool's does: no state is run twice. A window ends in a synchronisation of
the card and reads nothing back. Windows of k steps are timed by
``interleaved_two_point``; ``_windows`` are the JAX tool's.

With ``spd`` None a window is one ``steps_by_index`` call; with ``spd=k`` it
is chunks of k steps, each its own call, as the training loop runs with
``steps_per_dispatch=k`` (a chunk of ``steps_by_index`` is the port's
counterpart of a dispatch).
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional, Tuple

import numpy as np
import torch

from vqvae_tpu_torch.bench import write_rows
from vqvae_tpu_torch.bench.timing import bf16_mfu, chip_name, device_line, interleaved_two_point, sync_fn
from vqvae_tpu_torch.config import TrainConfig, VQVAEConfig
from vqvae_tpu_torch.device import resolve_device
from vqvae_tpu_torch.train.vqvae_train import VQVAETrainer
from vqvae_tpu_torch.utils.flops import train_step_flops_per_image

REPEATS = 9


def _windows(batch_size: int) -> Tuple[int, int]:
    """Two-point step counts per batch size (the JAX tool's): a short and a
    long window, the long one at least 100 ms of work."""
    if batch_size >= 1024:
        return 5, 35
    if batch_size >= 256:
        return 10, 60
    return 20, 120


class StagedSteps:
    """The timed unit of the train benches: ``run_timed(k)`` runs k updates of
    ``state`` through ``trainer.steps_by_index`` on the staged data, in
    chunks of ``spd`` (one call where None), the indices of steps 0..k-1 of
    ``idx`` (K, B), and ends in ``sync``. ``log`` records every window's k,
    in order."""

    def __init__(self, trainer, state, idx: np.ndarray, spd: Optional[int], sync):
        self.trainer, self.state, self.idx, self.spd, self.sync = trainer, state, idx, spd, sync
        self.log = []

    def run(self, k: int) -> None:
        chunk = self.spd or k
        for start in range(0, k, chunk):
            self.state, _ = self.trainer.steps_by_index(self.state, self.idx[start:min(start + chunk, k)])
        self.log.append(k)

    def __call__(self, k: int) -> float:
        self.sync()
        t0 = time.perf_counter()
        self.run(k)
        self.sync()
        return time.perf_counter() - t0


def step_config(base: VQVAEConfig, conv_precision: str, compute_dtype: str, ema: bool) -> VQVAEConfig:
    """The JAX tool's modes: the search in ``highest`` with fp32 convs, in
    ``default`` with bf16 ones."""
    return base.replace(
        conv_precision=conv_precision, compute_dtype=compute_dtype,
        quantizer_precision="highest" if compute_dtype == "float32" else "default",
        ema_codebook=ema)


def flops_per_image(cfg: VQVAEConfig) -> int:
    """Train-step FLOP an image at the config's widths."""
    return train_step_flops_per_image(
        n_hiddens=cfg.n_hiddens, n_residual_hiddens=cfg.n_residual_hiddens,
        n_residual_layers=cfg.n_residual_layers, embedding_dim=cfg.embedding_dim,
        n_embeddings=cfg.n_embeddings)


def staged_steps(batch_size: int, vq_cfg: VQVAEConfig, steps: int, spd: Optional[int] = None,
                 device="cuda", seed: int = 0) -> StagedSteps:
    """A trainer with ``steps`` batches of seeded random images staged on the
    device, a fresh state from ``seed``, and the indices of those batches."""
    dev = resolve_device(device)
    trainer = VQVAETrainer(vq_cfg, TrainConfig(batch_size=batch_size, seed=seed),
                           x_train_var=1.0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    trainer.stage_dataset(torch.randn((steps * batch_size, 32, 32, 3), generator=gen, device=dev))
    idx = np.arange(steps * batch_size, dtype=np.int64).reshape(steps, batch_size)
    return StagedSteps(trainer, trainer.init_state(), idx, spd, sync_fn(dev))


def bench_batch(
    batch_size: int,
    spd: Optional[int] = None,
    conv_precision: str = "highest",
    compute_dtype: str = "float32",
    ema: bool = False,
    device="cuda",
    base: VQVAEConfig = VQVAEConfig(),
    windows: Optional[Tuple[int, int]] = None,
    repeats: int = REPEATS,
    seed: int = 0,
) -> dict:
    """ms a step at ``batch_size``, and the rates and MFU that follow."""
    dev = resolve_device(device)
    steps_lo, steps_hi = windows or _windows(batch_size)
    vq_cfg = step_config(base, conv_precision, compute_dtype, ema)
    run_timed = staged_steps(batch_size, vq_cfg, steps_hi, spd, dev, seed)
    run_timed(steps_lo)  # the first cuDNN calls and the kernels' load
    run_timed(steps_hi)
    per_step = interleaved_two_point(run_timed, steps_lo, steps_hi, repeats)
    per_chip = batch_size / per_step
    flops = flops_per_image(vq_cfg)
    return {
        "batch_size": batch_size,
        "steps_per_dispatch": spd if spd is not None else "window",
        "conv_precision": conv_precision,
        "compute_dtype": compute_dtype,
        "quantizer_precision": vq_cfg.quantizer_precision,
        "ema_codebook": ema,
        "step_ms": per_step * 1e3,
        "images_per_sec_per_chip": per_chip,
        "train_flops_per_image": flops,
        "train_mfu": bf16_mfu(per_chip, flops, dev),
        "chip": chip_name(dev),
        "device": device_line(dev),
        "windows": [steps_lo, steps_hi],
        "repeats": repeats,
        "note": (
            "train_mfu over the dense bf16 peak, as the JAX tool reckons it: an fp32 "
            "step (convs without TF32, the search on the CUDA cores) cannot reach it, "
            "so the share understates the fp32 rows; data staged on the device, "
            "indices the only upload in a window, nothing read back"
        ),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m vqvae_tpu_torch.bench.train")
    ap.add_argument("--batches", type=int, nargs="*", default=[32, 256, 1024])
    ap.add_argument("--spd-batch", type=int, default=32,
                    help="batch size for the steps_per_dispatch sweep")
    ap.add_argument("--spds", type=int, nargs="*", default=[1, 10, 50],
                    help="steps_per_dispatch values to measure (empty list to skip)")
    ap.add_argument("--conv_precision", type=str, default="highest",
                    choices=["highest", "high", "default"])
    ap.add_argument("--compute_dtype", type=str, nargs="*", default=["float32", "bfloat16"],
                    choices=["float32", "bfloat16"],
                    help="a row per batch in each (bfloat16 runs the search in 'default')")
    ap.add_argument("--ema", action=argparse.BooleanOptionalAction, default=True,
                    help="also a row per batch with EMA codebook updates (fp32)")
    ap.add_argument("--repeats", type=int, default=REPEATS)
    ap.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", type=str, default=None, help="also write the rows to this JSON file")
    args = ap.parse_args(argv)
    kw = dict(conv_precision=args.conv_precision, device=args.device, repeats=args.repeats)
    rows = [bench_batch(b, compute_dtype=dtype, **kw)
            for dtype in args.compute_dtype for b in args.batches]
    if args.ema:
        rows += [bench_batch(b, ema=True, **kw) for b in args.batches]
    rows += [bench_batch(args.spd_batch, spd=spd, **kw) for spd in args.spds]
    write_rows({"metric": "vqvae_train_step_images_per_sec_per_chip (fwd+bwd+AMSGrad)",
                "rows": rows}, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
