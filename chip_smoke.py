#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (vqvae_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written nearest-code kernels from ``vqvae_tpu_torch/csrc``
(the tensor-core kernel, route "mma", and the CUDA-core kernel, route "fma")
and drives the port's main path at full width, in phases; any failed phase
stops the script with a non-zero exit and no result line:

1. the card (nvidia-smi name and power limit), the kernels' build report
   (``-Xptxas -v``: registers, shared memory, spills) and the count of
   tensor-core instructions in each built kernel;
2. the kernels against their plain PyTorch version on the card, in all three
   precision modes, at the main path's shapes, the TPU kernel test's shapes,
   a ragged-K shape and the CUDA-core kernel's edges (D = 45, D = 452,
   N = 37): for each the route the dispatch picks and, where
   that is "mma", the "fma" route too. z_q must be bit-exactly
   codebook[idx], every index mismatch a near-tie (float64 scores within 1e-5 * (||z||^2 + max ||e||^2)), and a
   duplicated codebook must give every index < K/2 (first minimum wins);
3. latent extraction, the main path: the trained bf16 checkpoint
   (artifacts/e2e_r5, "default" quantizer) over the 12,000 synthetic CIFAR
   images at batch 256, which must launch the "mma" kernel 47 times; its
   codes are held against the plain version on the same latents under the
   near-tie rule;
4. reconstruction with the trained fp32/"highest" checkpoint (artifacts/e2e_r4)
   on 1,024 validation images through ``reconstruct`` and ``forward`` (2
   launches of the "fma" kernel), held against the port on the CPU on 8 images;
5. times with CUDA events at the main path's shapes for each mode: the
   kernel the dispatch picks, the "fma" kernel where that is another, the
   bound on an H100 SXM, the launch floor (an empty kernel), the plain
   version, and one PyTorch matmul + argmin as a yardstick (the port never
   calls it);
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
RAGGED_K_SHAPE = (4096, 301, 64)      # K no multiple of 8, inside the "mma" envelope
# the CUDA-core kernel's edges: D no multiple of 4 with ragged N and K (scalar
# loads), a depth of many chunks, N below one block
FMA_EDGE_SHAPES = ((1000, 300, 45), (1000, 300, 452), (37, 512, 64))
SPIN_CYCLES = 20_000_000              # device spin (about 11 ms) that lets the host queue ahead
DEVICE = "cuda"


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def time_ms(fn, iters: int = 50, warmup: int = 5, queue_ahead: bool = True) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, from CUDA events.

    With ``queue_ahead`` the card first spins, so the host has queued the
    calls before the first one runs and the events time the card alone. The
    spin must outlast the queueing: if it has ended by the time the last call
    is queued, the timing is made again behind a spin twice as long, and the
    function fails when no spin up to eight times the first is long enough.
    Without ``queue_ahead`` a short kernel is timed at the host's pace.
    """
    for _ in range(warmup):
        fn()
    spin = SPIN_CYCLES
    while True:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        spun = torch.cuda.Event()
        if queue_ahead:
            torch.cuda._sleep(spin)
        spun.record()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        host_was_ahead = not spun.query()  # the card is still spinning
        end.synchronize()
        if host_was_ahead or not queue_ahead:
            return start.elapsed_time(end) / iters
        spin *= 2
        check(spin <= 8 * SPIN_CYCLES, "time_ms: the host never queued its calls ahead of the card")


def alternate(fns: dict) -> dict:
    """Time every function in turn, then again in reverse order (a, b, b, a):
    the faster of each one's two turns, in ms."""
    names = list(fns)
    times = {name: [] for name in names}
    for name in names + names[::-1]:
        times[name].append(time_ms(fns[name]))
    return {name: min(ts) for name, ts in times.items()}


def tensor_core_counts(cuda_quantizer, lib_path) -> dict:
    """HMMA (tensor-core) instructions per kernel in the built library's SASS."""
    cuobjdump = os.path.join(os.path.dirname(cuda_quantizer.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            counts[name] = 0
        elif name is not None and "HMMA" in line:
            counts[name] += 1
    return counts


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
    by_name, count = {}, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
            count[e.name] = count.get(e.name, 0) + 1
    print(f"[6] profile of extract_latents over {len(data)} images: wall {wall_us / 1e3:.3f} ms "
          f"(profiler on), device busy {busy / 1e3:.3f} ms = {busy / wall_us:.3f} of wall")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"[6]   {us / 1e3:9.3f} ms  {name[:110]}")
    for name, us in by_name.items():  # the hand-written kernels, wherever they rank
        if "nearest_code" in name or "prepare_codebook" in name:
            print(f"[6] hand-written: {us / 1e3:.3f} ms = {us / busy:.4f} of busy in "
                  f"{count[name]} launches ({us / count[name]:.2f} us each)  {name[:70]}")


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
    hmma = tensor_core_counts(cuda_quantizer, lib_path)
    search = {name: c for name, c in hmma.items() if "nearest_code_mma_kernel" in name}
    others = {name: c for name, c in hmma.items() if name not in search}
    print(f"[1] HMMA instructions in the SASS (cuobjdump): {len(search)} nearest_code_mma_kernel "
          f"variants hold {min(search.values(), default=0)} to {max(search.values(), default=0)} "
          f"each; every other kernel ({len(others)}) {max(others.values(), default=0)} at most")
    check(search and min(search.values()) > 0,
          "a tensor-core search kernel holds no tensor-core instruction")

    # -- phase 2: kernels vs plain on the card --------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    main_err = {}
    for n, k, d in (MAIN_SHAPE, BENCH_SHAPE) + TPU_TEST_SHAPES + (RAGGED_K_SHAPE,) + FMA_EDGE_SHAPES:
        z = torch.randn(n, d, device=dev, generator=gen)
        cb = torch.randn(k, d, device=dev, generator=gen)
        cb_dup = torch.cat([cb[: k // 2], cb[: k // 2]])
        for mode in MODES:
            _, idx_ref = nearest_code_torch(z, cb, mode)
            picked = cuda_quantizer.kernel_route(mode, d)
            for route in dict.fromkeys((picked, "fma")):
                zq, idx = cuda_quantizer.nearest_code_cuda(z, cb, mode, route)
                torch.cuda.synchronize()
                mism, near, gap = compare_assignments(z, cb, idx, idx_ref, mode)
                exact = torch.equal(zq, cb.index_select(0, idx))
                _, idx_dup = cuda_quantizer.nearest_code_cuda(z, cb_dup, mode, route)
                dup_max = int(idx_dup.max())
                print(f"[2] N={n} K={k} D={d} {mode:8s} {route} mismatches={mism} "
                      f"near_ties={near} max_gap={gap:.3g} gather_exact={exact} "
                      f"dup_max_idx={dup_max} (< {k // 2})")
                check(exact, "z_q is not bit-exactly codebook[idx]")
                check(mism == near, f"{mism - near} index mismatches are not near-ties")
                check(dup_max < k // 2, "duplicate codebook: first minimum did not win")
                if (n, k, d) == MAIN_SHAPE:
                    main_err[(mode, route)] = gap

    # a z that starts 4 bytes off a 16-byte boundary takes the CUDA-core
    # kernel's scalar loads and must give the indices of the aligned copy
    z = torch.randn(1000, 64, device=dev, generator=gen)
    cb = torch.randn(300, 64, device=dev, generator=gen)
    z_off = torch.empty(z.numel() + 1, device=dev)[1:].view_as(z).copy_(z)
    for mode in MODES:
        same = torch.equal(cuda_quantizer.nearest_code_indices(z_off, cb, mode, "fma"),
                           cuda_quantizer.nearest_code_indices(z, cb, mode, "fma"))
        print(f"[2] N=1000 K=300 D=64 {mode:8s} fma z at {z_off.data_ptr() % 16} bytes past a "
              f"16-byte boundary: same indices={same}")
        check(same, "the scalar-load path disagrees with the 16-byte-load path")

    # -- phase 3: extraction, the main path -----------------------------------
    model, _metrics, hp = load_model(R5, device=DEVICE)
    check(hp["compute_dtype"] == "bfloat16" and hp["quantizer_precision"] == "default",
          f"unexpected e2e_r5 hyperparameters {hp}")
    train, val, _var, info = load_dataset("CIFAR10", os.path.join(ROOT, "data"))
    data = np.concatenate([train.data, val.data])
    extract_latents(model, data[:256], batch_size=256)  # cuDNN warm-up
    torch.cuda.synchronize()
    cuda_quantizer.reset_launch_counts()
    t0 = time.perf_counter()
    codes = extract_latents(model, data, batch_size=256)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches_main = dict(cuda_quantizer.launches_by_route)
    n_batches = math.ceil(len(data) / 256)
    print(f"[3] extract_latents: {codes.shape} in {dt:.3f} s = {len(data) / dt:.0f} images/s "
          f"(host clock, data staged from host), kernel launches {cuda_quantizer.launches} "
          f"by route {launches_main}")
    check(launches_main == {"mma": n_batches, "fma": 0} and cuda_quantizer.launches == n_batches,
          f"expected {n_batches} launches, all on the mma route, got {launches_main}")
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
    cuda_quantizer.reset_launch_counts()
    rec = reconstruct(model4, batch)
    with torch.inference_mode():
        loss, x_hat, perp = model4(torch.from_numpy(batch).to(dev))
    torch.cuda.synchronize()
    launches_rec = dict(cuda_quantizer.launches_by_route)
    mse = float(np.mean((rec - batch) ** 2))
    print(f"[4] e2e_r4 on 1024 val images: loss={float(loss):.6f} perplexity={float(perp):.3f} "
          f"recon_mse={mse:.6f} kernel launches {launches_rec}")
    check(rec.shape == batch.shape and np.isfinite(rec).all(), "reconstruction not finite")
    check(math.isfinite(float(loss)) and math.isfinite(float(perp)), "loss/perplexity not finite")
    check(launches_rec == {"mma": 0, "fma": 2},
          f"expected 2 launches, both on the fma route, got {launches_rec}")
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
    launch_floor_ms = min(time_ms(cuda_quantizer.launch_empty_kernel) for _ in range(2))
    print(f"[5] launch_floor_ms {launch_floor_ms:.5f} (an empty kernel, queued ahead; {smi})")
    rows = []
    for n, k, d in (MAIN_SHAPE, BENCH_SHAPE):
        z = torch.randn(n, d, device=dev, generator=gen)
        cb = torch.randn(k, d, device=dev, generator=gen)
        e_sq = (cb * cb).sum(1)[None, :]
        cb_bf16 = cb.to(torch.bfloat16)
        for mode in MODES:
            picked = cuda_quantizer.kernel_route(mode, d)
            if mode == "default":
                library = lambda: (e_sq - 2.0 * (z.to(torch.bfloat16) @ cb_bf16.T).float()).argmin(1)
            else:
                library = lambda: (e_sq - 2.0 * (z @ cb.T)).argmin(1)
            fns = {"plain": lambda: code_scores(z, cb, mode).argmin(1)}
            if picked == "mma":
                fns["mma"] = lambda: cuda_quantizer.nearest_code_indices(z, cb, mode, "mma")
            fns["fma"] = lambda: cuda_quantizer.nearest_code_indices(z, cb, mode, "fma")
            fns["library"] = library
            t = alternate(fns)  # plain, kernels, library, library, kernels, plain
            kernel = lambda: cuda_quantizer.nearest_code_indices(z, cb, mode)
            b_ms, b_by = bound(n, k, d, mode)
            row = {"shape": [n, k, d], "mode": mode, "route": picked,
                   "ms": t[picked],
                   "call_ms": time_ms(kernel, queue_ahead=False),
                   "fma_ms": t["fma"], "plain_ms": t["plain"], "library_ms": t["library"],
                   "bound_ms": b_ms, "bound_by": b_by, "launch_floor_ms": launch_floor_ms}
            rows.append(row)
            print(f"[5] {json.dumps(row)}")
    print(f"[5] card: {smi}; times from CUDA events, mean of 50 calls after 5 warm-up, queued "
          f"behind a device spin so the host's pace is not in them (call_ms: without the spin), "
          f"the faster of two turns")
    main_rows = {r["mode"]: r for r in rows if tuple(r["shape"]) == MAIN_SHAPE}

    # -- phase 6: where the extraction time goes ------------------------------
    profile_extraction(model, data[:2560])
    print(f"total {time.perf_counter() - t_start:.1f} s")

    def entry(name, source, route, mode, launches):
        row = main_rows[mode]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": "vqvae_tpu/ops/pallas_quantizer.py:93",
                "launches": launches, "max_abs_err": main_err[(mode, route)],
                "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"]}

    # each kernel at the main shape, in the mode of the path that launches it
    kernels = [
        entry("nearest_code_mma", "vqvae_tpu_torch/csrc/nearest_code_mma.cu", "mma", "default",
              launches_main["mma"]),
        entry("nearest_code", "vqvae_tpu_torch/csrc/nearest_code.cu", "fma", "highest",
              launches_rec["fma"]),
    ]
    check(all(k["launches"] > 0 for k in kernels), "a kernel of the path was never launched")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
