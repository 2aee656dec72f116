"""Encode + quantize images/s on the card (counterpart of the root's ``bench.py``).

Run by ``python -m vqvae_tpu_torch.bench`` and the ``benchmark`` command.

The workload is ``bench.py``'s: a VQ-VAE at the config's widths, weights
initialised from a seed, a batch of 1,024 random 32 x 32 x 3 images made on
the device from a seeded generator, and the encoder + quantizer
(``VQVAE.codes``: ``encode`` then ``quantize``'s indices) run back to back on
that resident batch, in two configurations: bf16 convs with the fp32
``highest`` search (route ``fma``) and the serving point, the ``default``
search (route ``mma``).

``images_per_sec`` is the wall-clock rate of that loop: k back-to-back calls
ending in a synchronisation, in interleaved windows of 20 and 120 calls, the
best of 3 of each (``interleaved_two_point``); the host's pace of queueing
the launches is in it, as it is in an extraction loop. Beside it:
``device_ms_per_batch``, the card's time for one call behind a device spin
(``time_ms``), and ``busy_share`` = device / wall. ``mfu`` is the rate times
``utils/flops.py``'s encode+quantize FLOP an image over the card's dense bf16
peak; it is None on a card ``chip_spec`` does not know and on the CPU, where
the device metrics are None too.

Eager PyTorch elides no launch, so the JAX loop's serial "bump" (there
against XLA's dead-code elimination of all but the last iteration) is not
needed: every call here runs.
"""

from __future__ import annotations

import json
import os
import time

import torch

from vqvae_tpu_torch.bench.timing import bf16_mfu, interleaved_two_point, sync_fn, time_ms
from vqvae_tpu_torch.config import VQVAEConfig
from vqvae_tpu_torch.device import resolve_device
from vqvae_tpu_torch.models.vqvae import VQVAE
from vqvae_tpu_torch.utils.flops import encode_quantize_flops_per_image

BATCH = 1024
ITERS_LO = 20
ITERS_HI = 120
WARMUP = 2
TIMED_REPEATS = 3
# calls a time_ms reading averages. A call is about 70 launches, and the
# calls must all sit queued behind time_ms's device spin: 20 of them (1,400
# launches) overflowed what the card queues, and the host then waited on the
# card whatever the spin's length
DEVICE_ITERS = 5

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# A pinned torch-CPU rate of the reference's own encode + quantize (batch 64,
# tools/pin_torch_baseline.py, the JAX package's pin): what vs_baseline
# divides by, read only. It is a CPU figure, not a TPU one.
BASELINE_PIN = os.path.join(ROOT, "artifacts", "torch_cpu_baseline.json")
# bench.py's figure where the pin is missing
RECORDED_TORCH_CPU_IMAGES_PER_SEC = 330.0


def torch_baseline() -> float:
    """The pinned torch-CPU reference rate, images/s (bench.py's fallback
    where the file is missing)."""
    if not os.path.exists(BASELINE_PIN):
        return RECORDED_TORCH_CPU_IMAGES_PER_SEC
    with open(BASELINE_PIN) as f:
        return float(json.load(f)["images_per_sec"])


def flops_per_image(cfg: VQVAEConfig) -> int:
    """Encode + quantize FLOP an image at the config's widths."""
    return encode_quantize_flops_per_image(
        n_hiddens=cfg.n_hiddens, n_residual_hiddens=cfg.n_residual_hiddens,
        n_residual_layers=cfg.n_residual_layers, embedding_dim=cfg.embedding_dim,
        n_embeddings=cfg.n_embeddings)


def make_model(cfg: VQVAEConfig, device: torch.device, seed: int = 0) -> VQVAE:
    """A VQ-VAE with torch-default weights drawn from ``seed``, on ``device``."""
    model = VQVAE(cfg)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(device).eval()


def encode_quantize(model: VQVAE, x: torch.Tensor) -> torch.Tensor:
    """bench.py's unit of work: ``encode`` then ``quantize``'s indices, (B, h, w) int32."""
    with torch.inference_mode():
        return model.codes(x)


def bench_config(
    cfg: VQVAEConfig,
    device="cuda",
    batch: int = BATCH,
    iters_lo: int = ITERS_LO,
    iters_hi: int = ITERS_HI,
    repeats: int = TIMED_REPEATS,
    seed: int = 0,
) -> dict:
    """One configuration's row: the wall rate, the device ms a batch, the busy share, mfu."""
    dev = resolve_device(device)
    sync = sync_fn(dev)
    model = make_model(cfg, dev, seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    x = torch.randn((batch, 32, 32, 3), generator=gen, device=dev)

    def run_timed(k: int) -> float:
        sync()
        t0 = time.perf_counter()
        for _ in range(k):
            encode_quantize(model, x)
        sync()
        return time.perf_counter() - t0

    for _ in range(WARMUP):
        run_timed(iters_lo)
    run_timed(iters_hi)
    per_batch = interleaved_two_point(run_timed, iters_lo, iters_hi, repeats)
    rate = batch / per_batch
    device_ms = None
    if dev.type == "cuda":
        device_ms = time_ms(lambda: encode_quantize(model, x), iters=DEVICE_ITERS)
    flops = flops_per_image(cfg)
    return {
        "compute_dtype": cfg.compute_dtype,
        "quantizer_precision": cfg.quantizer_precision,
        "batch": batch,
        "images_per_sec": rate,
        "wall_ms_per_batch": 1e3 * per_batch,
        "device_ms_per_batch": device_ms,
        "busy_share": device_ms / (1e3 * per_batch) if device_ms is not None else None,
        "flops_per_image": flops,
        "mfu": bf16_mfu(rate, flops, dev),
        "windows": [iters_lo, iters_hi],
        "repeats": repeats,
    }


def benchmark_configs(base: VQVAEConfig) -> dict:
    """bench.py's two points at the widths of ``base``: bf16 convs with the
    fp32 search, and the serving point's bf16 search."""
    primary = base.replace(compute_dtype="bfloat16", quantizer_precision="highest")
    return {"value": primary, "serving_value": primary.replace(quantizer_precision="default")}
