#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (vqvae_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written nearest-code kernel from ``vqvae_tpu_torch/csrc`` and
drives the port's main path at full width, in phases; any failed phase stops
the script with a non-zero exit and no result line:

1. the card (nvidia-smi name and power limit) and the kernel's build report
   (``-Xptxas -v``: registers, shared memory, spills);
2. the kernel against its plain PyTorch version on the card, in all three
   precision modes, at the main path's shapes and the TPU kernel test's
   shapes: z_q must be bit-exactly codebook[idx], every index mismatch a
   near-tie (float64 scores within 1e-5 * (||z||^2 + max ||e||^2)), and a
   duplicated codebook must give every index < K/2 (first minimum wins);
3. latent extraction, the main path: the trained bf16 checkpoint
   (artifacts/e2e_r5, "default" quantizer) over the 12,000 synthetic CIFAR
   images at batch 256, which must launch the kernel 47 times; its codes are
   held against the plain version on the same latents under the near-tie rule;
4. reconstruction with the trained fp32/"highest" checkpoint (artifacts/e2e_r4)
   on 1,024 validation images through ``reconstruct`` and ``forward``, held
   against the port on the CPU on 8 images;
5. times with CUDA events at the main path's shapes for each mode: the
   kernel, its bound on an H100 SXM, the plain version, and one PyTorch
   matmul + argmin as a yardstick (the port never calls it);
6. ``torch.profiler`` over an extraction of 2,560 images: device time by
   kernel and the share of the wall time in which the card was busy.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``. Without a CUDA device, or outside the
repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
R4 = os.path.join(ROOT, "artifacts", "e2e_r4", "vqvae_e2e_r4_step4999.npz")
R5 = os.path.join(ROOT, "artifacts", "e2e_r5", "vqvae_e2e_r5_step4999.npz")
MODES = ("highest", "high", "default")
# H100 SXM published peaks (dense): bytes/s of HBM3, FLOP/s by operand type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"fp32": 67e12, "bf16": 989e12}
MAIN_SHAPE = (16_384, 512, 64)        # extraction: batch 256 x 8 x 8 latents
BENCH_SHAPE = (65_536, 512, 64)       # the JAX bench.py batch of 1,024
TPU_TEST_SHAPES = ((2048, 512, 64), (2048, 8192, 256), (1000, 300, 48))
DEVICE = "cuda"


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(n: int, k: int, d: int, mode: str):
    """Least time (ms) for the search on an H100 SXM, and what binds it.

    Bytes: z and the codebook read once (fp32, as given), idx written once.
    Operations: 2NKD multiply-adds; "high" does three bf16 products.
    """
    nbytes = 4 * (n * d + k * d + n)
    flops = 2.0 * n * k * d
    if mode == "highest":
        t_ops = flops / PEAK_FLOPS["fp32"]
    else:
        t_ops = (3 if mode == "high" else 1) * flops / PEAK_FLOPS["bf16"]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def profile_extraction(model, data: np.ndarray) -> None:
    """torch.profiler over ``extract_latents`` (batch 256): device time by
    kernel, and the share of the wall time in which the card ran anything
    (kernels and copies, overlaps merged). The profiler's own cost is in
    the wall time, so the busy share is a lower bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vqvae_tpu_torch.pipelines.extract import extract_latents

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        extract_latents(model, data, batch_size=256)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        print("[6] the profiler saw no device activity: busy share not measured")
        return
    busy, (cur_s, cur_e) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s = s
        cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    print(f"[6] profile of extract_latents over {len(data)} images: wall {wall_us / 1e3:.3f} ms "
          f"(profiler on), device busy {busy / 1e3:.3f} ms = {busy / wall_us:.3f} of wall")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"[6]   {us / 1e3:9.3f} ms  {name[:110]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "vqvae_tpu_torch")):
        print(f"chip_smoke: no vqvae_tpu_torch package beside {__file__}", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from vqvae_tpu_torch.data.datasets import load_dataset
    from vqvae_tpu_torch.ops import cuda_quantizer
    from vqvae_tpu_torch.ops.quantizer import (
        code_scores,
        compare_assignments,
        nearest_code_torch,
    )
    from vqvae_tpu_torch.pipelines.extract import extract_latents
    from vqvae_tpu_torch.pipelines.viz import load_model, reconstruct

    torch.set_float32_matmul_precision("highest")  # the plain version's fp32 matmul
    dev = torch.device(DEVICE)
    t_start = time.perf_counter()

    # -- phase 1: card and build ----------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(smi)  # the card's name and power limit, as nvidia-smi gives them
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")
    t0 = time.perf_counter()
    lib_path = cuda_quantizer.build()
    print(f"[1] built {os.path.relpath(lib_path, ROOT)} in {time.perf_counter() - t0:.1f} s")
    print(cuda_quantizer.build_log.strip())

    # -- phase 2: kernel vs plain on the card ---------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    main_err = None
    for n, k, d in (MAIN_SHAPE, BENCH_SHAPE) + TPU_TEST_SHAPES:
        z = torch.randn(n, d, device=dev, generator=gen)
        cb = torch.randn(k, d, device=dev, generator=gen)
        cb_dup = torch.cat([cb[: k // 2], cb[: k // 2]])
        for mode in MODES:
            zq, idx = cuda_quantizer.nearest_code_cuda(z, cb, mode)
            torch.cuda.synchronize()
            _, idx_ref = nearest_code_torch(z, cb, mode)
            mism, near, gap = compare_assignments(z, cb, idx, idx_ref, mode)
            exact = torch.equal(zq, cb.index_select(0, idx))
            _, idx_dup = cuda_quantizer.nearest_code_cuda(z, cb_dup, mode)
            dup_max = int(idx_dup.max())
            print(f"[2] N={n} K={k} D={d} {mode:8s} mismatches={mism} near_ties={near} "
                  f"max_gap={gap:.3g} gather_exact={exact} dup_max_idx={dup_max} (< {k // 2})")
            check(exact, "z_q is not bit-exactly codebook[idx]")
            check(mism == near, f"{mism - near} index mismatches are not near-ties")
            check(dup_max < k // 2, "duplicate codebook: first minimum did not win")
            if (n, k, d) == MAIN_SHAPE and mode == "default":
                main_err = gap

    # -- phase 3: extraction, the main path -----------------------------------
    model, _metrics, hp = load_model(R5, device=DEVICE)
    check(hp["compute_dtype"] == "bfloat16" and hp["quantizer_precision"] == "default",
          f"unexpected e2e_r5 hyperparameters {hp}")
    train, val, _var, info = load_dataset("CIFAR10", os.path.join(ROOT, "data"))
    data = np.concatenate([train.data, val.data])
    extract_latents(model, data[:256], batch_size=256)  # cuDNN warm-up
    torch.cuda.synchronize()
    cuda_quantizer.launches = 0
    t0 = time.perf_counter()
    codes = extract_latents(model, data, batch_size=256)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches_main = cuda_quantizer.launches
    n_batches = math.ceil(len(data) / 256)
    print(f"[3] extract_latents: {codes.shape} in {dt:.3f} s = {len(data) / dt:.0f} images/s "
          f"(host clock, data staged from host), kernel launches {launches_main}")
    check(launches_main == n_batches, f"expected {n_batches} kernel launches, got {launches_main}")
    rates = []
    for _ in range(2):  # the spread of the host-clock rate
        t0 = time.perf_counter()
        extract_latents(model, data, batch_size=256)
        torch.cuda.synchronize()
        rates.append(len(data) / (time.perf_counter() - t0))
    print(f"[3] two more runs: {rates[0]:.0f} and {rates[1]:.0f} images/s")
    check(codes.shape == (len(data), 64) and codes.min() >= 0 and codes.max() < 512,
          "extracted codes out of shape or range")
    mism_total = near_total = 0
    with torch.inference_mode():
        for s in range(0, len(data), 256):
            x = torch.from_numpy(data[s:s + 256]).to(dev)
            z_e = model.encode(x).reshape(-1, 64)
            _, idx_ref = nearest_code_torch(z_e, model.codebook, "default")
            idx = torch.from_numpy(codes[s:s + 256].reshape(-1)).to(dev)
            mism, near, _gap = compare_assignments(z_e, model.codebook, idx, idx_ref, "default")
            mism_total += mism
            near_total += near
    used = len(np.unique(codes))
    print(f"[3] vs plain on the same latents: mismatches={mism_total} near_ties={near_total}; "
          f"distinct codes used {used} of 512 (the JAX run on a TPU recorded 298, "
          f"artifacts/e2e_r5/README.md; for comparison only)")
    check(mism_total == near_total, "extraction codes disagree with the plain version")

    # -- phase 4: reconstruction, fp32 / highest --------------------------------
    model4, _m4, hp4 = load_model(R4, device=DEVICE)
    check(hp4["compute_dtype"] == "float32" and hp4["quantizer_precision"] == "highest",
          f"unexpected e2e_r4 hyperparameters {hp4}")
    batch = val.data[:1024]
    cuda_quantizer.launches = 0
    rec = reconstruct(model4, batch)
    with torch.inference_mode():
        loss, x_hat, perp = model4(torch.from_numpy(batch).to(dev))
    torch.cuda.synchronize()
    launches_rec = cuda_quantizer.launches
    mse = float(np.mean((rec - batch) ** 2))
    print(f"[4] e2e_r4 on 1024 val images: loss={float(loss):.6f} perplexity={float(perp):.3f} "
          f"recon_mse={mse:.6f} kernel launches {launches_rec}")
    check(rec.shape == batch.shape and np.isfinite(rec).all(), "reconstruction not finite")
    check(math.isfinite(float(loss)) and math.isfinite(float(perp)), "loss/perplexity not finite")
    check(launches_rec == 2, f"expected 2 kernel launches, got {launches_rec}")
    check(float(np.abs(rec - x_hat.cpu().numpy()).max()) <= 1e-5, "reconstruct != forward x_hat")
    # the card against the port on the CPU (TF32 off on the card for "highest")
    model_cpu, _m, _h = load_model(R4, device="cpu")
    small = torch.from_numpy(batch[:8])
    with torch.inference_mode():
        z_gpu = model4.encode(small.to(dev)).cpu()
        z_cpu = model_cpu.encode(small)
        codes_gpu = model4.codes(small.to(dev)).cpu()
        dec_gpu = model4.decode_codes(codes_gpu.to(dev)).cpu()
        dec_cpu = model_cpu.decode_codes(codes_gpu)
    z_err = float((z_gpu - z_cpu).abs().max())
    dec_err = float((dec_gpu - dec_cpu).abs().max())
    print(f"[4] card vs CPU on 8 images: encode max abs {z_err:.3g}, decode_codes max abs {dec_err:.3g}")
    check(z_err <= 1e-3 and dec_err <= 1e-3, "fp32 card results drift from the CPU (TF32 on?)")

    # -- phase 5: times at the main path's shapes -------------------------------
    rows = []
    main_row = None
    for n, k, d in (MAIN_SHAPE, BENCH_SHAPE):
        z = torch.randn(n, d, device=dev, generator=gen)
        cb = torch.randn(k, d, device=dev, generator=gen)
        e_sq = (cb * cb).sum(1)[None, :]
        cb_bf16 = cb.to(torch.bfloat16)
        for mode in MODES:
            if mode == "default":
                library = lambda: (e_sq - 2.0 * (z.to(torch.bfloat16) @ cb_bf16.T).float()).argmin(1)
            else:
                library = lambda: (e_sq - 2.0 * (z @ cb.T)).argmin(1)
            plain = lambda: code_scores(z, cb, mode).argmin(1)
            kernel = lambda: cuda_quantizer.nearest_code_indices(z, cb, mode)
            # alternate plain, kernel, kernel, plain on the same card
            t_plain_a = time_ms(plain)
            t_kernel_a = time_ms(kernel)
            t_kernel_b = time_ms(kernel)
            t_plain_b = time_ms(plain)
            t_lib = time_ms(library)
            b_ms, b_by = bound(n, k, d, mode)
            row = {"shape": [n, k, d], "mode": mode,
                   "ms": min(t_kernel_a, t_kernel_b), "plain_ms": min(t_plain_a, t_plain_b),
                   "library_ms": t_lib, "bound_ms": b_ms, "bound_by": b_by}
            rows.append(row)
            print(f"[5] {json.dumps(row)}")
            if (n, k, d) == MAIN_SHAPE and mode == "default":
                main_row = row
    print(f"[5] card: {smi}; times from CUDA events, mean of 50 launches after 5 warm-up")

    # -- phase 6: where the extraction time goes ------------------------------
    profile_extraction(model, data[:2560])
    print(f"total {time.perf_counter() - t_start:.1f} s")

    kernels = [{
        "name": "nearest_code",
        "route": "cuda",
        "source": "vqvae_tpu_torch/csrc/nearest_code.cu",
        "replaces": "vqvae_tpu/ops/pallas_quantizer.py:93",
        "launches": launches_main,
        "max_abs_err": main_err,
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
