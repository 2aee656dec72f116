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
   duplicated codebook must give every index < K/2 (first minimum wins); and
   the NaN rule (ops/cuda_quantizer.py): with codebook row 300 NaN no route
   picks code 300, a NaN row of z gets code 0, and the plain version takes
   the first NaN;
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
   kernel and the share of the wall time in which the card was busy;
7. training, fp32 / "highest" (the config's default): ``train_vqvae`` over the
   synthetic CIFAR set at batch 256 (16,384 rows a step), 60 updates in
   chunks of 10 with the set staged on the card, saving; it must launch the
   "fma" kernel 60 times, keep every metric finite and lower the
   reconstruction error, and its last checkpoint must reload through
   ``load_model`` and feed ``extract_latents``. One step's gradients on the
   card are held against the port on the CPU (same weights, a batch of 32;
   largest error relative to the parameter's largest gradient at most 1e-4,
   which TF32 in a backward conv would break);
8. training in bf16 / "default" (20 updates, 20 launches of the "mma" kernel)
   and with an EMA codebook in fp32 (20 updates, 20 "fma" launches; the EMA
   counts must sum to 16,384 * (1 - 0.99^20) and the codebook equal
   means / smoothed counts); the same 5 updates run twice from one state, in
   fp32 ("fma"), bf16 ("mma") and with the EMA codebook, must give the same
   train state and metrics, 0 difference;
9. times of a train step (batch 32 and 256 in fp32, 256 in bf16), of the
   optimizer update, the scatter-add backward alone (``index_add_``, as it
   was, beside ``scatter_add_rows``, as it is) and the EMA update alone, and a
   ``torch.profiler`` breakdown of 20 steps at batch 256: records, not checks;
10. the trained prior (artifacts/e2e_r5, 15 layers, 512 codes, fp32 /
   "highest") through the cached sampler: teacher-forced logits on 64 of the
   grids of samples.npz against the port's full forward on the card, and on
   4 against the port on the CPU (rtol 1e-3, atol 1e-4); 64 grids drawn from
   one seed by the cached sampler and by ``GatedPixelCNN.generate`` must be
   identical (at most one grid may part, and only where the top-two gap of
   the perturbed logits at its first differing pixel is under 1e-4), and the
   same seed twice the same grids; the TF32 error of a "default" config;
11. ``sample`` through ``vqvae_tpu_torch.cli.main``: 100 samples with both
   e2e_r5 checkpoints, checked for shapes, labels, code range, finite images;
12. ``serve`` in-process: ``SamplingService`` (batch 64, background loop) and
   ``SamplingHTTPServer`` on 127.0.0.1 with the e2e_r5 decoder; 4 client
   threads send 3 requests each (n_samples 1, 10, 64, 100; decode, b64_u8),
   every response and the service's counters are checked; a wave's ms
   (CUDA events around ``run_wave``, at the host's pace), sampled images/s,
   p50/p99 request latency, occupancy, and a ``torch.profiler`` breakdown of
   one wave. Phases 10 to 12 launch neither nearest-code kernel;
13. the prior's training (``train-prior`` through ``vqvae_tpu_torch.cli.main``)
   at the reference defaults (512 codes, dim 64, 15 layers, batch 32,
   fp32/"highest") on the 12,000 grids phase 3 extracted (the last 500 for
   validation): epochs 1 and 2 in chunks of 50 with per-epoch samples, every
   loss finite, each epoch's validation CE within 0.1 nats of the JAX run's
   (artifacts/prior_bf16_convergence.json), the samples (100, 8, 8) codes in
   [0, 512); a resume to epoch 3 that continues the history; the saved file
   through ``load_prior`` and ``sample``; one epoch in bf16/"default" with
   finite losses; one step's gradients on the card against the CPU (largest
   error relative to each parameter's largest gradient at most 1e-4); the
   same 5 updates twice at batch 32 and 256, 0 difference; and for the record a step's ms, grids/s, host
   queueing, share of the peak (``utils/flops.py``) and peak memory at batch
   32 and 256 in fp32 and bf16, and a ``torch.profiler`` breakdown of 20
   steps at batch 256. It launches neither nearest-code kernel.
14. data and codebook parallelism: both kernels' best-value output against
   the plain version (every mode and route, phase 2's shapes: the indices
   with values equal those without, each value within the near-tie bound of
   the float64 minimum); the codebook split into 2, 4 and 8 contiguous shards
   (and K = 600 into 2), searched shard by shard and combined, against the
   unsharded call (bit for bit on "fma"; "mma" to the near-tie rule), and a
   codebook duplicated across shards; four ranks of ``train-vqvae
   --distributed --n_data 2 --n_code 2`` (gloo, sharing the card; NCCL, a
   card a rank, where there are four cards) (each a process of this script that runs the CLI and writes a record:
   launches, digests of its weights, fingerprints of the latents it searched
   with, times of its steps, gradient all-reduces and combines) for 20
   updates at full width and global batch 256 from one saved state, against
   a one-process run over the first 5 (update 1's perplexity bit for bit
   and its losses within 2 ulps; updates 2-5 losses rtol 1e-6 and the
   perplexity within three near-tie rows; parameters atol 6e-4), the replicated weights bit-identical on all ranks, each rank
   20 "fma" launches, the rank-0 checkpoint through ``load_model`` and
   ``extract_latents``; a bf16/"default" 2 x 2 run (10 "mma" launches a
   rank) and an EMA run (the counts summed over the shards follow the
   decay); one NCCL rank, and two on two cards where there are two.
15. the rest of the package: (a) two ranks of ``train-prior --distributed
   --n_data 2`` at the full width (gloo sharing the card; NCCL, a card a
   rank, where there are two) over one epoch of 44 updates at global batch
   256 on phase 3's grids from one saved epoch-0 state, against one process
   over the same epoch (update 1's loss within 2 ulps, updates 2-5 rtol
   4e-6, validation CE within 1e-4 nats), weights, Adam state and per-epoch
   samples bit-identical on both ranks, each rank's step and all-reduce
   times; (b) ``profile`` through the CLI, 5 steps at batch 256: a trace that
   holds ``train_step_0..4`` and the "fma" kernel, 6 launches; (c) ``viz``
   through the CLI on e2e_r4 and e2e_r5 (1 "fma" and 1 "mma" launch), or,
   where matplotlib is missing, its device part (``load_model``,
   ``reconstruct``, ``smooth``) after the command's ImportError; (d)
   ``train-vqvae --dataset BLOCK``, 20 updates at batch 256 on a synthetic
   BLOCK file: finite metrics, 20 "fma" launches; (e) ``checked`` around a
   train step: nothing on a healthy batch, a NaN in the input named by op.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``. Without a CUDA device, or outside the
repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
R4 = os.path.join(ROOT, "artifacts", "e2e_r4", "vqvae_e2e_r4_step4999.npz")
R5 = os.path.join(ROOT, "artifacts", "e2e_r5", "vqvae_e2e_r5_step4999.npz")
PRIOR_R5 = os.path.join(ROOT, "artifacts", "e2e_r5", "latent_block_pixelcnn.npz")
SAMPLES_R5 = os.path.join(ROOT, "artifacts", "e2e_r5", "samples.npz")
PRIOR_SEED = 1234                     # the draws of phase 10
REQUEST_SIZES = (1, 10, 64, 100)      # phase 12: one client thread each, 3 requests
MODES = ("highest", "high", "default")
MAIN_SHAPE = (16_384, 512, 64)        # extraction: batch 256 x 8 x 8 latents
BENCH_SHAPE = (65_536, 512, 64)       # the JAX bench.py batch of 1,024
TPU_TEST_SHAPES = ((2048, 512, 64), (2048, 8192, 256), (1000, 300, 48))
RAGGED_K_SHAPE = (4096, 301, 64)      # K no multiple of 8, inside the "mma" envelope
# the CUDA-core kernel's edges: D no multiple of 4 with ragged N and K (scalar
# loads), a depth of many chunks, N below one block
FMA_EDGE_SHAPES = ((1000, 300, 45), (1000, 300, 452), (37, 512, 64))
# device items of a profile by the first group whose key their name holds
DEVICE_ITEM_GROUPS = (
    ("hand-written kernels", ("nearest_code", "prepare_codebook")),
    ("copies", ("Memcpy", "Memset")),
    ("cuDNN layout conversions", ("nhwcToNchw", "nchwToNhwc")),
    ("optimizer (foreach)", ("multi_tensor_apply",)),
    ("scatter-add, gathers", ("indexFunc", "index_", "gather", "scatter", "embedding",
                              "indexing_backward")),
    ("softmax, cross-entropy", ("SoftMax", "softmax", "nll_loss")),
    ("convolutions (cuDNN, cuBLAS)", ("fprop", "dgrad", "wgrad", "winograd", "gemm", "convolve",
                                      "cudnn", "cutlass", "nvjet")),
)
TRAIN_BATCH = 256                     # a train step of 16,384 rows
# phase 13: the JAX run's validation CE after epochs 1 and 2 on the e2e_r5
# latents (artifacts/prior_bf16_convergence.json, val_ce_fp32), and the bound
PRIOR_VAL_CE_JAX = (5.607869, 5.606247)
PRIOR_VAL_CE_TOL = 0.1
PRIOR_TRAIN_FLAGS = ()                # train-prior's defaults: 512 codes, dim 64, 15 layers, batch 32
PRIOR_STEP_BATCHES = (32, 256)
SPIN_CYCLES = 20_000_000              # device spin (about 11 ms) that lets the host queue ahead
# phase 14: codebook splits (K, n_code), the parallel runs' global batch, a rank's time limit
SHARD_SPLITS = ((512, 2), (512, 4), (512, 8), (600, 2))
PARALLEL_BATCH = 256
PARALLEL_TIMEOUT_S = 300
# phase 15 (a): the prior's ranks' global batch and the limits of their first
# 5 losses against one process. Update 1 starts from the same weights: the
# mean of two ranks' means of 8,192 codes against one mean of 16,384, at most
# 2 ulps apart. From update 2 the weights part in their last bits (the
# averaged gradient is summed in another order) and the gap about doubles an
# update: 0, 0, 7.7e-8, 3.1e-7, 6.2e-7 in the first call on an H100, which
# repeats bit for bit; 4e-6 leaves six times that.
PRIOR_PARALLEL_BATCH = 256
PRIOR_PAR_UPDATE1_ULPS = 2
PRIOR_PAR_LATER_REL = 4e-6
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
    """Least time (ms) for the search on an H100 SXM (published peaks,
    ``vqvae_tpu_torch/utils/flops.py``), and what binds it.

    Bytes: z and the codebook read once (fp32, as given), idx written once.
    Operations: 2NKD multiply-adds; "high" does three bf16 products.
    """
    from vqvae_tpu_torch.utils.flops import H100_SXM

    nbytes = 4 * (n * d + k * d + n)
    flops = 2.0 * n * k * d
    if mode == "highest":
        t_ops = flops / H100_SXM.peak_fp32_flops
    else:
        t_ops = (3 if mode == "high" else 1) * flops / H100_SXM.peak_bf16_flops
    t_bytes = nbytes / H100_SXM.hbm_bytes_per_sec
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def profile_device(tag: str, what: str, fn, top: int = 12) -> dict:
    """torch.profiler over ``fn()``: device time by kernel, the share of the
    wall time in which the card ran anything (kernels and copies, overlaps
    merged), the hand-written kernels' share and the number of
    device-to-host copies. The profiler's own cost is in the wall time, so
    the busy share is a lower bound. Returns the printed figures (empty
    when the profiler saw no device activity)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    # kernels and copies only: a profiler annotation mirrored onto the device
    # (an optimizer's step, "Optimizer.step#TorchAmsgrad.step") spans the gaps
    # between its kernels. Kernel names hold a "#" too, in their lambdas
    # ("{lambda(float)#1}"), but also a parameter list.
    device_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA
                     and not getattr(e, "is_user_annotation", False)
                     and not ("#" in e.name and "(" not in e.name)]
    spans = sorted((e.time_range.start, e.time_range.end) for e in device_events)
    if not spans:
        print(f"[{tag}] the profiler saw no device activity: busy share not measured")
        return {}
    busy, (cur_s, cur_e) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s = s
        cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    by_name, count = {}, {}
    for e in device_events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
        count[e.name] = count.get(e.name, 0) + 1
    print(f"[{tag}] profile of {what}: wall {wall_us / 1e3:.3f} ms (profiler on), device busy "
          f"{busy / 1e3:.3f} ms = {busy / wall_us:.3f} of wall, {len(by_name)} distinct device "
          f"items in {len(device_events)} launches and copies")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"[{tag}]   {us / 1e3:9.3f} ms  {count[name]:5d} x  {name[:100]}")
    for name, us in by_name.items():  # the hand-written kernels, wherever they rank
        if "nearest_code" in name or "prepare_codebook" in name:
            print(f"[{tag}] hand-written: {us / 1e3:.3f} ms = {us / busy:.4f} of busy in "
                  f"{count[name]} launches ({us / count[name]:.2f} us each)  {name[:70]}")
    groups = {}
    for name, us in by_name.items():
        group = next((g for g, keys in DEVICE_ITEM_GROUPS if any(k in name for k in keys)),
                     "elementwise and reductions")
        groups[group] = groups.get(group, 0.0) + us
    print(f"[{tag}] device time by group, ms (share of the items' sum): " + "; ".join(
        f"{g} {us / 1e3:.3f} ({us / sum(groups.values()):.3f})"
        for g, us in sorted(groups.items(), key=lambda kv: -kv[1])))
    dtoh = sum(c for name, c in count.items() if "Memcpy DtoH" in name)
    print(f"[{tag}] device-to-host copies (Memcpy DtoH): {dtoh}")
    return {"wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3, "busy_share": busy / wall_us,
            "launches": len(device_events), "dtoh": dtoh,
            "groups_ms": {g: us / 1e3 for g, us in groups.items()}}


def relative_gradient_errors(grads: dict, grads_ref: dict) -> dict:
    """Per parameter: the largest absolute error over the largest absolute
    gradient of the reference."""
    return {name: float((grads[name].cpu() - ref).abs().max() / ref.abs().max().clamp_min(1e-30))
            for name, ref in grads_ref.items()}


def first_difference_gaps(logits, grids_a, grids_b, seed: int) -> list:
    """For each grid where two draws from one seed part: its first differing
    pixel and the top-two gap of that pixel's perturbed logits (``logits``:
    teacher-forced on ``grids_a``), with the uniforms replayed from the seed
    (one (B, K) draw per pixel in raster order, as ``draw_codes`` takes them)."""
    b, h, w, k = logits.shape
    differ = (grids_a != grids_b).reshape(b, -1)
    firsts = {int(g): int(differ[g].nonzero()[0]) for g in differ.any(1).nonzero().flatten()}
    gen = torch.Generator(device=logits.device).manual_seed(seed)
    out = []
    for p in range(h * w):
        u = torch.rand((b, k), generator=gen, device=logits.device, dtype=torch.float32)
        for g, first in firsts.items():
            if first == p:
                top = (logits[g, p // w, p % w] - u[g].log().neg().log()).topk(2).values
                out.append({"grid": g, "pixel": [p // w, p % w], "gap": float(top[0] - top[1])})
    return out


def sampling_phases(dev, smi: str) -> dict:
    """Phases 10 to 12: the prior, ``sample`` and ``serve`` at full width on
    the e2e_r5 checkpoints. Returns the numbers of the record."""
    import base64
    import tempfile
    import threading
    import urllib.request

    from vqvae_tpu_torch import cli
    from vqvae_tpu_torch.models.pixelcnn import GatedPixelCNN
    from vqvae_tpu_torch.models.pixelcnn_sampler import CachedPixelCNNSampler
    from vqvae_tpu_torch.ops import cuda_quantizer
    from vqvae_tpu_torch.pipelines.sample import decode_code_grids
    from vqvae_tpu_torch.pipelines.serve import SamplingHTTPServer, SamplingService
    from vqvae_tpu_torch.pipelines.viz import load_model, load_prior

    rows = {}
    cuda_quantizer.reset_launch_counts()

    # -- phase 10: the prior and the cached sampler ---------------------------
    prior, _m, hp = load_prior(PRIOR_R5, device=DEVICE)
    cfg = prior.config
    check(hp["n_layers"] == 15 and hp["dim"] == 64 and hp["input_dim"] == 512
          and cfg.conv_precision == "highest", f"unexpected e2e_r5 prior hyperparameters {hp}")
    samples = np.load(SAMPLES_R5)
    grids = torch.from_numpy(samples["codes"][:64]).to(dev)
    labels = torch.from_numpy(samples["labels"][:64]).to(dev)
    side = cfg.img_dim
    sampler = CachedPixelCNNSampler(prior)
    with torch.inference_mode():
        tf = sampler.generate(labels, None, (side, side), 64, force_grid=grids)
        full = prior(grids, labels)
    torch.cuda.synchronize()
    err = float((tf - full).abs().max())
    rel = float(((tf - full).abs() / full.abs().clamp_min(1e-4)).max())
    close = bool(torch.allclose(tf, full, rtol=1e-3, atol=1e-4))
    rows["teacher_forced_max_abs_err"] = err
    print(f"[10] e2e_r5 prior ({sum(p.numel() for p in prior.parameters())} parameters): "
          f"teacher-forced cached logits vs the full forward on 64 grids: max abs {err:.3g} "
          f"(logits in [{float(full.min()):.1f}, {float(full.max()):.1f}]), largest relative "
          f"{rel:.3g}, allclose(rtol 1e-3, atol 1e-4) {close}")
    check(close, "cached teacher-forced logits disagree with the full forward on the card")
    prior_cpu, _m, _hp = load_prior(PRIOR_R5, device="cpu")
    with torch.inference_mode():
        cpu_full = prior_cpu(grids[:4].cpu(), labels[:4].cpu())
    cpu_err = float((tf[:4].cpu() - cpu_full).abs().max())
    cpu_close = bool(torch.allclose(tf[:4].cpu(), cpu_full, rtol=1e-3, atol=1e-4))
    rows["card_vs_cpu_max_abs_err"] = cpu_err
    print(f"[10] the card's cached logits vs the port's full forward on the CPU, 4 grids: max abs "
          f"{cpu_err:.3g}, allclose {cpu_close} (highest: no TF32 on the card)")
    check(cpu_close, "the card's cached logits drift from the CPU (TF32 on?)")
    # for the record: the same weights with TF32 allowed in the sampler's matmuls and convs
    prior_tf32 = GatedPixelCNN(cfg.replace(conv_precision="default")).to(dev)
    prior_tf32.load_state_dict(prior.state_dict())
    with torch.inference_mode():
        tf_tf32 = CachedPixelCNNSampler(prior_tf32).generate(labels, None, (side, side), 64,
                                                             force_grid=grids)
    print(f"[10]   conv_precision='default' (TF32 allowed): max abs {float((tf_tf32 - full).abs().max()):.3g} "
          f"against the fp32 full forward")

    sample_labels = torch.arange(64, device=dev) % 10
    with torch.inference_mode():
        t0 = time.perf_counter()
        cached = sampler.generate(sample_labels, torch.Generator(device=dev).manual_seed(PRIOR_SEED),
                                  (side, side), 64)
        torch.cuda.synchronize()
        t_cached = time.perf_counter() - t0
        t0 = time.perf_counter()
        oracle = prior.generate(sample_labels, torch.Generator(device=dev).manual_seed(PRIOR_SEED),
                                (side, side), 64)
        torch.cuda.synchronize()
        t_full = time.perf_counter() - t0
        again = sampler.generate(sample_labels, torch.Generator(device=dev).manual_seed(PRIOR_SEED),
                                 (side, side), 64)
        tf_cached = sampler.generate(sample_labels, None, (side, side), 64, force_grid=cached)
    differ = int((cached != oracle).reshape(64, -1).any(1).sum())
    gaps = first_difference_gaps(tf_cached, cached, oracle, PRIOR_SEED)
    rows.update(differing_grids=differ, first_difference_gaps=gaps)
    print(f"[10] 64 grids from seed {PRIOR_SEED}: cached sampler {t_cached:.3f} s, full forward a pixel "
          f"(GatedPixelCNN.generate) {t_full:.3f} s (host clock, first calls); grids that differ "
          f"{differ}, at their first differing pixel {gaps}; the same seed again identical "
          f"{torch.equal(cached, again)}; {len(torch.unique(cached))} distinct codes")
    check(differ == 0 or (differ == 1 and gaps[0]["gap"] < 1e-4),
          "the cached and the full-forward samplers draw different grids")
    check(torch.equal(cached, again), "one seed drew two different sets of grids")
    check(cached.dtype == torch.int32 and int(cached.min()) >= 0 and int(cached.max()) < cfg.input_dim,
          "drawn codes out of range")

    # -- phase 11: sample through the CLI --------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "s.npz")
        t0 = time.perf_counter()
        rc = cli.main(["sample", "--vqvae-checkpoint", R5, "--prior-checkpoint", PRIOR_R5,
                       "--n_samples", "100", "--out", out])
        t_cli = time.perf_counter() - t0
        s = dict(np.load(out))
    distinct = len(np.unique(s["codes"]))
    rows["sample_cli_s"] = t_cli
    print(f"[11] cli sample --n_samples 100: rc {rc}, {t_cli:.3f} s (host clock, loads included); "
          f"images {s['images'].shape}, codes {s['codes'].shape}, {distinct} distinct codes (the JAX "
          f"run drew 284, artifacts/e2e_r5/README.md; a record, not a check)")
    check(rc == 0 and s["images"].shape == (100, 32, 32, 3) and s["codes"].shape == (100, 8, 8),
          "sample wrote the wrong shapes")
    check(np.array_equal(s["labels"], np.arange(100) % 10), "sample's labels do not cycle 0..9")
    check(s["codes"].min() >= 0 and s["codes"].max() < 512 and np.isfinite(s["images"]).all(),
          "sample's codes out of range or images not finite")

    # -- phase 12: serve in-process ------------------------------------------
    vq_model, _m, _hp = load_model(R5, device=DEVICE)
    service = SamplingService(cfg, prior, batch_size=64, seed=0, device=DEVICE)
    service.start()
    server = SamplingHTTPServer(service, lambda c: decode_code_grids(vq_model, c), port=0)
    server.start_background()
    url = "http://%s:%d/sample" % server.address
    latencies, errors, lock = [], [], threading.Lock()

    def client(n):
        for _ in range(3):
            body = json.dumps({"label": n % 10, "n_samples": n, "decode": True}).encode()
            t = time.perf_counter()
            try:
                with urllib.request.urlopen(urllib.request.Request(url, data=body), timeout=300) as r:
                    resp = json.loads(r.read())
                lat = time.perf_counter() - t
                codes = np.asarray(resp["codes"])
                u8 = np.frombuffer(base64.b64decode(resp["images_b64"]), np.uint8)
                good = (codes.shape == (n, side, side) and codes.min() >= 0 and codes.max() < 512
                        and resp["images_shape"] == [n, 32, 32, 3] and u8.size == n * 32 * 32 * 3)
                with lock:
                    latencies.append(lat)
                    if not good:
                        errors.append(f"bad response for n={n}")
            except Exception as e:  # every failure is reported below
                with lock:
                    errors.append(f"n={n}: {e!r}")

    threads = [threading.Thread(target=client, args=(n,)) for n in REQUEST_SIZES]
    try:
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
    finally:
        server.shutdown()
        service.stop()
    check(not any(t.is_alive() for t in threads), "a client thread never finished")
    check(not errors, f"serve: {errors}")
    stats = dict(service.stats)
    want_slots = 3 * sum(REQUEST_SIZES)
    occupancy = stats["slots_used"] / (stats["waves"] * 64)
    lat = np.sort(np.asarray(latencies))
    rows.update(serve_images_per_s=stats["slots_used"] / wall, p50_s=float(np.percentile(lat, 50)),
                p99_s=float(np.percentile(lat, 99)), occupancy=occupancy, waves=stats["waves"])
    print(f"[12] 4 clients x 3 requests (n_samples {REQUEST_SIZES}, decode, b64_u8): {len(lat)} responses "
          f"in {wall:.3f} s; stats {stats}; sampled images/s {stats['slots_used'] / wall:.1f}; latency "
          f"p50 {rows['p50_s']:.3f} s, p99 {rows['p99_s']:.3f} s (max {lat[-1]:.3f}); occupancy "
          f"{occupancy:.3f}")
    check(len(lat) == 12 and stats["slots_used"] == want_slots
          and -(-want_slots // 64) <= stats["waves"] <= 12 * 2,
          f"the service's counters do not add up: {stats}, {want_slots} slots asked for")

    # a wave at the host's pace: CUDA events around run_wave (64 slots), no spin
    wave_ms = []
    for r in range(6):
        service.submit(r % 10, 64)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        service.run_wave()
        end.record()
        end.synchronize()
        wave_ms.append(start.elapsed_time(end))
    rows["wave_ms"] = float(np.median(wave_ms[1:]))
    print(f"[12] a wave of 64 grids (run_wave): {', '.join(f'{t:.3f}' for t in wave_ms)} ms, median of "
          f"the last 5 {rows['wave_ms']:.3f} ms = {64e3 / rows['wave_ms']:.1f} grids/s; card: {smi}")
    service.submit(0, 64)
    profile_device("12", "one wave of 64 grids (run_wave)", service.run_wave, top=16)
    check(cuda_quantizer.launches == 0, "the sampling path launched a nearest-code kernel")
    print(f"[12] nearest-code kernel launches in phases 10-12: {cuda_quantizer.launches} (decode is a gather)")
    return rows


def prior_training_phase(smi: str, codes: np.ndarray) -> dict:
    """Phase 13: the prior's training on the card, on the codes phase 3
    extracted (11,500 training grids, the last 500 for validation).
    Returns the numbers of the record."""
    import tempfile

    from vqvae_tpu_torch import cli
    from vqvae_tpu_torch.config import PixelCNNConfig, TrainConfig
    from vqvae_tpu_torch.data.datasets import load_dataset
    from vqvae_tpu_torch.ops import cuda_quantizer
    from vqvae_tpu_torch.pipelines.viz import load_prior
    from vqvae_tpu_torch.train import pixelcnn_train
    from vqvae_tpu_torch.train.checkpoint import peek_hyperparameters
    from vqvae_tpu_torch.train.pixelcnn_train import PixelCNNTrainer
    from vqvae_tpu_torch.utils.flops import H100_SXM, pixelcnn_train_step_flops_per_grid

    rows = {}
    cuda_quantizer.reset_launch_counts()
    runs, real_train = [], pixelcnn_train.train_pixelcnn

    def recording(*args, **kw):  # train-prior's loop, its return value kept for the checks
        out = real_train(*args, **kw)
        runs.append(out)
        return out

    with tempfile.TemporaryDirectory() as tmp:
        data_dir, results = os.path.join(tmp, "data"), os.path.join(tmp, "results")
        os.makedirs(data_dir)
        np.save(os.path.join(data_dir, "latent_e_indices.npy"), codes)
        common = ["--data_dir", data_dir, "--steps_per_dispatch", "50", *PRIOR_TRAIN_FLAGS]
        saved = os.path.join(results, "latent_block_pixelcnn.npz")
        pixelcnn_train.train_pixelcnn = recording
        try:
            # -- train: epochs 1 and 2, saving every epoch, samples after each
            t0 = time.perf_counter()
            rc = cli.main(["train-prior", "--epochs", "3", "--gen_samples", "-save",
                           "--results_dir", results, *common])
            torch.cuda.synchronize()
            t_train = time.perf_counter() - t0
            state, out = runs[-1]
            hist = out["history"]
            val, losses = hist["val_loss"], hist["train_loss"]
            rows.update(train_prior_s=t_train, train_loss=losses, val_ce=val,
                        updates=state.step, best_val_loss=out["best_val_loss"])
            print(f"[13] train-prior --epochs 3 (epochs 1-2 at batch 32, {state.step} updates, chunks of "
                  f"50, -save, --gen_samples): rc {rc}, {t_train:.3f} s (host clock, validation, samples "
                  f"and checkpoints included); train loss {losses}, validation CE {val}; the JAX run "
                  f"{list(PRIOR_VAL_CE_JAX)} (bound {PRIOR_VAL_CE_TOL} nats)")
            check(rc == 0 and len(val) == 2 and state.step == 2 * ((len(codes) - 500) // 32),
                  f"train-prior did not run 2 epochs: {hist}, {state.step} updates")
            # an epoch's mean is finite only if each of its losses is (all are >= 0)
            check(np.isfinite(losses).all() and np.isfinite(val).all(), f"a prior loss is not finite: {hist}")
            for epoch, (ours, theirs) in enumerate(zip(val, PRIOR_VAL_CE_JAX), start=1):
                check(abs(ours - theirs) <= PRIOR_VAL_CE_TOL,
                      f"epoch {epoch}: validation CE {ours} is not within {PRIOR_VAL_CE_TOL} of the JAX run's {theirs}")
            samples = out["samples"]
            check(len(samples) == 2 and all(g.shape == (100, 8, 8) and g.dtype == np.int32
                                            and g.min() >= 0 and g.max() < 512 for g in samples),
                  "the per-epoch samples are not (100, 8, 8) int32 codes in [0, 512)")
            rows["sample_distinct_codes"] = [len(np.unique(g)) for g in samples]
            print(f"[13] per-epoch samples: {[g.shape for g in samples]}, distinct codes "
                  f"{rows['sample_distinct_codes']}")

            # -- resume: epoch 3 on top of the file of epoch 2
            rc = cli.main(["train-prior", "--epochs", "4", "--resume", "-save",
                           "--results_dir", results, *common])
            state_r, out_r = runs[-1]
            hist_r = out_r["history"]
            print(f"[13] --resume --epochs 4: rc {rc}, validation CE {hist_r['val_loss']}, "
                  f"{state_r.step} updates")
            check(rc == 0 and hist_r["val_loss"][:2] == val and len(hist_r["val_loss"]) == 3
                  and state_r.step == 3 * state.step // 2, "the resumed run did not continue from epoch 2")
            rows["resumed_val_ce"] = hist_r["val_loss"][2]

            # -- reload: the saved file feeds load_prior and sample
            prior, metrics, hp = load_prior(saved, device=DEVICE)
            out_s = os.path.join(tmp, "s.npz")
            rc = cli.main(["sample", "--vqvae-checkpoint", R5, "--prior-checkpoint", saved,
                           "--n_samples", "10", "--out", out_s])
            s = dict(np.load(out_s))
            print(f"[13] the saved prior reloaded ({sum(p.numel() for p in prior.parameters())} parameters, "
                  f"{len(metrics['val_loss'])} epochs of history): sample rc {rc}, codes {s['codes'].shape}, "
                  f"images {s['images'].shape}")
            check(rc == 0 and s["codes"].shape == (10, 8, 8) and s["images"].shape == (10, 32, 32, 3)
                  and np.isfinite(s["images"]).all() and 0 <= s["codes"].min() <= s["codes"].max() < 512,
                  "sampling from the saved prior failed")

            # -- bf16 / default: one epoch
            t0 = time.perf_counter()
            rc = cli.main(["train-prior", "--epochs", "2", "--compute_dtype", "bfloat16",
                           "--conv_precision", "default", "--results_dir", os.path.join(tmp, "bf16"), *common])
            t_bf16 = time.perf_counter() - t0
            hist_b = runs[-1][1]["history"]
            rows.update(bf16_epoch_s=t_bf16, bf16_train_loss=hist_b["train_loss"][0],
                        bf16_val_ce=hist_b["val_loss"][0])
            print(f"[13] bf16/default, 1 epoch: rc {rc}, {t_bf16:.3f} s (host clock), train loss "
                  f"{hist_b['train_loss']}, validation CE {hist_b['val_loss']}")
            check(rc == 0 and np.isfinite(hist_b["train_loss"]).all() and np.isfinite(hist_b["val_loss"]).all(),
                  "bf16 prior training: a loss is not finite")
        finally:
            pixelcnn_train.train_pixelcnn = real_train

        cfg = PixelCNNConfig.from_dict(peek_hyperparameters(saved))
        train_ds, val_ds, _var, _info = load_dataset("LATENT_BLOCK", data_dir)

    # -- one step's gradients, card vs CPU, same weights, a batch of 32 ----------
    x32, l32 = train_ds.data[:32], train_ds.labels[:32]

    def gradients(device, c):
        trainer = PixelCNNTrainer(c, TrainConfig(), device=device)
        st = trainer.init_state(torch.Generator().manual_seed(7))
        trainer.step(st, x32, l32)  # the step moves the weights, not the gradients
        return {n: p.grad.clone() for n, p in st.model.named_parameters()}

    grads_cpu = gradients("cpu", cfg)
    errs = relative_gradient_errors(gradients(DEVICE, cfg), grads_cpu)
    errs_tf32 = relative_gradient_errors(gradients(DEVICE, cfg.replace(conv_precision="default")), grads_cpu)
    worst = max(errs, key=errs.get)
    rows.update(grad_rel_err=errs[worst], grad_rel_err_tf32=max(errs_tf32.values()))
    print(f"[13] gradients of one step, card vs CPU (batch of 32, {len(errs)} parameters): largest error / "
          f"largest gradient, worst {errs[worst]:.3g} ({worst}), median {float(np.median(list(errs.values()))):.3g}; "
          f"with TF32 allowed (conv_precision='default'): worst {rows['grad_rel_err_tf32']:.3g}")
    check(errs[worst] <= 1e-4, f"the prior's gradients on the card drift from the CPU: {errs[worst]}")

    # -- the same 5 updates twice from the same state: 0 difference -------------
    trainer = PixelCNNTrainer(cfg, TrainConfig(), device=DEVICE)
    trainer.stage_dataset(train_ds, val_ds)
    rows["repeat"] = {}
    for batch in (32, 256):  # 256: the embedding's backward sums 16,384 rows
        diff, dloss = same_updates_twice(trainer, np.arange(5 * batch).reshape(5, batch))
        rows["repeat"][batch] = [diff, dloss]
        print(f"[13] the same 5 updates twice from the same state (batch {batch}): largest difference of any "
              f"train-state leaf (weights, Adam moments) {diff:.3g}, of any loss {dloss:.3g}")
        check(diff == 0 and dloss == 0, f"two runs of the same 5 prior updates at batch {batch} part")

    # -- step times, share of the peak, memory, profile (records, not checks) ----
    flops_grid = pixelcnn_train_step_flops_per_grid(img_dim=cfg.img_dim, dim=cfg.dim,
                                                    n_layers=cfg.n_layers, input_dim=cfg.input_dim)
    step_rows = []
    for label, c, peak in (("fp32/highest", cfg, H100_SXM.peak_fp32_flops),
                           ("bf16/default", cfg.replace(compute_dtype="bfloat16", conv_precision="default"),
                            H100_SXM.peak_bf16_flops)):
        for batch in PRIOR_STEP_BATCHES:
            tr = PixelCNNTrainer(c, TrainConfig(batch_size=batch), device=DEVICE)
            st = tr.init_state()
            xb, lb = tr._to_device(train_ds.data[:batch]), tr._to_device(train_ds.labels[:batch])
            fn = lambda: tr.step(st, xb, lb)  # noqa: E731
            ms = min(time_ms(fn, iters=30, warmup=10, queue_ahead=False) for _ in range(2))
            host_ms = math.inf
            for _ in range(2):  # the host alone: its clock around 30 steps, nothing awaited
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(30):
                    fn()
                host_ms = min(host_ms, 1e3 * (time.perf_counter() - t0) / 30)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()  # this state and all else alive in the process
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            peak_mem = torch.cuda.max_memory_allocated()
            row = {"prior_step": label, "batch": batch, "ms": ms, "grids_per_s": 1e3 * batch / ms,
                   "host_queue_ms": host_ms, "gflop": flops_grid * batch / 1e9,
                   "bound_ms": 1e3 * flops_grid * batch / peak,
                   "share_of_peak": flops_grid * batch / (ms / 1e3) / peak,
                   "peak_mem_mb": peak_mem / 2**20, "step_mem_mb": (peak_mem - held) / 2**20}
            step_rows.append(row)
            print(f"[13] {json.dumps(row)}")
    rows["steps"] = step_rows
    print(f"[13] card: {smi}; prior-step times from CUDA events around 30 steps after 10 warm-up, no spin, "
          f"the faster of two turns; host_queue_ms is the host clock around 30 steps with nothing awaited; "
          f"share_of_peak against the H100 SXM's published {H100_SXM.peak_fp32_flops / 1e12:.0f} (fp32) and "
          f"{H100_SXM.peak_bf16_flops / 1e12:.0f} (bf16) TFLOP/s; peak_mem_mb is the process's peak "
          f"allocation over 3 steps, step_mem_mb what the steps added to what was held before them")

    tr = PixelCNNTrainer(cfg, TrainConfig(batch_size=256), device=DEVICE)
    st = tr.init_state()
    tr.stage_dataset(train_ds, val_ds)
    idx20 = np.arange(20 * 256).reshape(20, 256)
    tr.steps_by_index(st, idx20[:5])
    prof = profile_device("13", "20 prior train steps at batch 256, fp32/highest, steps_by_index",
                          lambda: tr.steps_by_index(st, idx20), top=20)
    rows["profile"] = {**prof, "launches_per_step": prof.get("launches", 0) / 20}
    print(f"[13] launches and copies a step {rows['profile']['launches_per_step']:.1f}")
    # the cost of repeating bit for bit: the step at 256 with the arithmetic it had before
    xb, lb = tr._to_device(train_ds.data[:256]), tr._to_device(train_ds.labels[:256])
    turns = {"now": [], "before": []}
    for name in ("now", "before", "before", "now"):
        with previous_arithmetic() if name == "before" else contextlib.nullcontext():
            tr.step(st, xb, lb)
            turns[name].append(time_ms(lambda: tr.step(st, xb, lb), iters=20, warmup=5, queue_ahead=False))
    with previous_arithmetic():
        tr.steps_by_index(st, idx20[:5])
        prof_old = profile_device("13", "the same 20 steps with the arithmetic of before (F.embedding's backward, "
                                  "cuDNN's default algorithms)", lambda: tr.steps_by_index(st, idx20), top=8)
    rows["before_vs_now"] = {"step_ms_now": min(turns["now"]), "step_ms_before": min(turns["before"]),
                             "busy_ms_now": prof.get("busy_ms", 0) / 20,
                             "busy_ms_before": prof_old.get("busy_ms", 0) / 20,
                             "conv_ms_now": conv_ms_per_step(prof, 20),
                             "conv_ms_before": conv_ms_per_step(prof_old, 20)}
    print(f"[13] fp32 prior step at batch 256, the faster of two turns, now against the arithmetic of before: "
          f"{json.dumps(rows['before_vs_now'])} ({smi})")
    check(cuda_quantizer.launches == 0, "the prior's training launched a nearest-code kernel")
    print(f"[13] nearest-code kernel launches in phase 13: {cuda_quantizer.launches}")
    return rows


@contextlib.contextmanager
def previous_arithmetic():
    """The train steps as they were before they repeated bit for bit, for the
    record: ``index_add_`` for the scatter-adds, ``F.embedding``'s backward
    for the prior's embedding, cuDNN's default algorithms inside the
    precision scope."""
    import torch.nn.functional as F

    from vqvae_tpu_torch.models import pixelcnn
    from vqvae_tpu_torch.ops import conv, quantizer
    from vqvae_tpu_torch.parallel import code_parallel
    from vqvae_tpu_torch.train import pixelcnn_train, vqvae_train

    real_scope = conv.conv_fp32_precision

    @contextlib.contextmanager
    def scope(precision):
        with real_scope(precision):
            torch.backends.cudnn.deterministic = False
            yield

    def index_add(indices, rows, k):
        return rows.new_zeros((k, rows.shape[1])).index_add_(0, indices, rows)

    patches = [(m, "conv_fp32_precision", scope) for m in (conv, vqvae_train, pixelcnn_train)]
    patches += [(m, "scatter_add_rows", index_add) for m in (quantizer, code_parallel, vqvae_train)]
    patches.append((pixelcnn, "gather_rows", lambda table, idx: F.embedding(idx, table)))
    saved = [(m, name, getattr(m, name)) for m, name, _new in patches]
    for m, name, new in patches:
        setattr(m, name, new)
    try:
        yield
    finally:
        for m, name, old in saved:
            setattr(m, name, old)


def conv_ms_per_step(prof: dict, steps: int) -> float:
    return prof.get("groups_ms", {}).get("convolutions (cuDNN, cuBLAS)", 0.0) / steps


def same_updates_twice(trainer, idx) -> tuple:
    """Two runs of the same updates (``steps_by_index(idx)``) from one seeded
    state: the largest difference of any leaf of the train state (weights,
    optimizer moments, EMA statistics) and of any per-step metric."""
    from vqvae_tpu_torch.train.checkpoint import flatten_tree, train_state_to_jax

    runs = []
    for _ in range(2):
        st = trainer.init_state(torch.Generator().manual_seed(11))
        st, m = trainer.steps_by_index(st, idx)
        metrics = m if isinstance(m, dict) else {"loss": m}
        runs.append((flatten_tree(train_state_to_jax(st)), {k: v.cpu().numpy() for k, v in metrics.items()}))
    (sa, ma), (sb, mb) = runs
    state_diff = max(float(np.abs(sa[k].astype(np.float64) - sb[k]).max()) for k in sa)
    metric_diff = max(float(np.abs(ma[k].astype(np.float64) - mb[k]).max()) for k in ma)
    return state_diff, metric_diff


def fingerprint(t: torch.Tensor) -> torch.Tensor:
    """Two int64 sums of a float32 tensor's bits (plain and weighted by
    position), on its device: equal tensors, equal prints."""
    bits = t.detach().contiguous().view(torch.int32).reshape(-1).to(torch.int64)
    weights = torch.arange(1, bits.numel() + 1, device=bits.device, dtype=torch.int64)
    return torch.stack([bits.sum(), (bits * weights).sum()])


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def rank_worker(out_path: str, argv: list) -> int:
    """One rank of phase 14: ``vqvae_tpu_torch.cli.main(argv)`` (``train-vqvae
    --distributed ...``) with timers around each update, each gradient
    all-reduce and each cross-shard combine, and a fingerprint of the
    latents of every local search; then a JSON record of the rank at
    ``out_path``."""
    sys.path.insert(0, ROOT)
    import torch.distributed as dist

    from vqvae_tpu_torch import cli
    from vqvae_tpu_torch.ops import cuda_quantizer
    from vqvae_tpu_torch.parallel import code_parallel
    from vqvae_tpu_torch.train import vqvae_train

    spans = Spans("cpu" not in argv)
    prints, captured = [], {}
    real_search, real_train = code_parallel.local_search, vqvae_train.train_vqvae

    def local_search(z_flat, codebook, precision):
        prints.append(fingerprint(z_flat))
        return real_search(z_flat, codebook, precision)

    def train(*args, **kwargs):
        out = real_train(*args, **kwargs)
        captured["backend"] = dist.get_backend() if dist.is_initialized() else None
        captured["state"], captured["trainer"] = out[0], out[2]
        return out

    code_parallel.local_search = local_search
    code_parallel.exchange_and_combine = spans.wrap(code_parallel.exchange_and_combine, "combine")
    vqvae_train.VQVAETrainer._update = spans.wrap(vqvae_train.VQVAETrainer._update, "step")
    vqvae_train.VQVAETrainer._reduce_gradients = spans.wrap(vqvae_train.VQVAETrainer._reduce_gradients,
                                                            "reduce")
    vqvae_train.train_vqvae = train
    cuda_quantizer.reset_launch_counts()
    rc = cli.main(argv)
    ms = spans.ms()
    state, mesh = captured["state"], captured["trainer"].mesh
    named = dict(state.model.named_parameters())
    record = {
        "rc": rc, "rank": mesh.data * mesh.n_code + mesh.code, "data": mesh.data, "code": mesh.code,
        "backend": captured["backend"], "backend_asked": argv[argv.index("--dist_backend") + 1],
        "device": str(captured["trainer"].device), "updates": state.step,
        "launches": dict(cuda_quantizer.launches_by_route),
        "replicated_sha": digest(p for n, p in sorted(named.items()) if n != "codebook"),
        "codebook_sha": digest([named["codebook"]]), "z_prints": [p.tolist() for p in prints],
        "step_ms": ms["step"], "reduce_ms": ms["reduce"], "combine_ms": ms.get("combine", []),
    }
    with open(out_path, "w") as f:
        json.dump(record, f)
    return rc


class Spans:
    """Times of calls by key: CUDA events on a card, the host clock on the CPU."""

    def __init__(self, on_card: bool):
        self.on_card, self.pairs = on_card, {}

    def _stamp(self):
        if self.on_card:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            return event
        return time.perf_counter()

    def wrap(self, fn, key):
        self.pairs.setdefault(key, [])

        def wrapper(*args, **kwargs):
            start = self._stamp()
            out = fn(*args, **kwargs)
            self.pairs[key].append((start, self._stamp()))
            return out
        return wrapper

    def ms(self) -> dict:
        if self.on_card:
            torch.cuda.synchronize()
        return {key: [s.elapsed_time(e) if self.on_card else 1e3 * (e - s) for s, e in pairs]
                for key, pairs in self.pairs.items()}


def prior_rank_worker(out_path: str, argv: list) -> int:
    """One rank of phase 15 (a): ``vqvae_tpu_torch.cli.main(argv)``
    (``train-prior --distributed ...``) with timers around each update and
    each gradient all-reduce, and the global batch's loss of every update;
    then a JSON record of the rank at ``out_path``."""
    sys.path.insert(0, ROOT)
    import torch.distributed as dist

    from vqvae_tpu_torch import cli
    from vqvae_tpu_torch.ops import cuda_quantizer
    from vqvae_tpu_torch.train import pixelcnn_train
    from vqvae_tpu_torch.train.checkpoint import flatten_tree, train_state_to_jax

    spans, captured, losses = Spans("cpu" not in argv), {}, []
    real_train, real_run = pixelcnn_train.train_pixelcnn, pixelcnn_train.PixelCNNTrainer._run

    def train(*args, **kwargs):
        out = real_train(*args, **kwargs)
        captured["backend"] = dist.get_backend() if dist.is_initialized() else None
        captured["state"], captured["out"] = out
        return out

    def run(self, state, batches):
        out = real_run(self, state, batches)
        losses.append(out[1])
        return out

    pixelcnn_train.PixelCNNTrainer._run = run
    pixelcnn_train.PixelCNNTrainer._update = spans.wrap(pixelcnn_train.PixelCNNTrainer._update, "step")
    pixelcnn_train.PixelCNNTrainer._reduce_gradients = spans.wrap(
        pixelcnn_train.PixelCNNTrainer._reduce_gradients, "reduce")
    pixelcnn_train.train_pixelcnn = train
    cuda_quantizer.reset_launch_counts()
    rc = cli.main(argv)
    ms = spans.ms()
    state, out = captured["state"], captured["out"]
    mesh = out["trainer"].mesh
    flat = flatten_tree(train_state_to_jax(state))
    record = {
        "rc": rc, "rank": mesh.data, "backend": captured["backend"],
        "backend_asked": argv[argv.index("--dist_backend") + 1], "device": str(out["trainer"].device),
        "updates": state.step, "launches": dict(cuda_quantizer.launches_by_route),
        "losses": torch.cat(losses).tolist(), "history": out["history"],
        "state_sha": digest(torch.from_numpy(flat[k]) for k in sorted(flat)),
        "samples_sha": digest(torch.from_numpy(g) for g in out["samples"]),
        "step_ms": ms["step"], "reduce_ms": ms["reduce"],
    }
    with open(out_path, "w") as f:
        json.dump(record, f)
    return rc


def run_clusters(clusters: dict, work: str, timeout: float = PARALLEL_TIMEOUT_S, tag: str = "14") -> dict:
    """Start every rank of every cluster at once (``clusters``: name -> list of
    each rank's ``train-vqvae`` arguments), each a ``rank_worker`` process
    logging to ``work``; wait for all. A rank that fails or outlives
    ``timeout`` stops the phase: every rank is killed and the tails of the
    logs printed. Returns name -> the ranks' records."""
    procs = []
    for name, ranks in clusters.items():
        for i, argv in enumerate(ranks):
            out = os.path.join(work, f"{name}_rank{i}.json")
            log = open(os.path.join(work, f"{name}_rank{i}.log"), "w")
            procs.append((name, i, out, log, subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank-worker", out, *argv],
                cwd=ROOT, env={**os.environ, "OMP_NUM_THREADS": "1"}, stdout=log,
                stderr=subprocess.STDOUT)))
    deadline, failed = time.monotonic() + timeout, []
    try:
        for name, i, _out, _log, p in procs:
            try:
                if p.wait(timeout=max(1.0, deadline - time.monotonic())) != 0:
                    failed.append(f"{name} rank {i}: rc {p.returncode}")
            except subprocess.TimeoutExpired:
                failed.append(f"{name} rank {i}: still running after {timeout} s")
    finally:
        for _name, _i, _out, log, p in procs:
            p.kill()
            p.wait()
            log.close()
    if failed:
        for name, i, _out, log, _p in procs:
            with open(log.name) as f:
                print(f"[{tag}] --- {name} rank {i} log (tail) ---\n" + "".join(f.readlines()[-25:]))
        check(False, f"parallel ranks failed: {failed}")
    records = {}
    for name, i, out, _log, _p in procs:
        with open(out) as f:
            records.setdefault(name, []).append(json.load(f))
    return records


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def train_argv(world: int, rank: int, port: int, *flags) -> list:
    return ["train-vqvae", "--distributed", "--coordinator_address", f"127.0.0.1:{port}",
            "--num_processes", str(world), "--process_id", str(rank),
            "--data_dir", os.path.join(ROOT, "data"), "--device", DEVICE, *flags]


def parallel_phase(smi: str, dataset) -> dict:
    """Phase 14: the best-value output, the sharded search and combine on one
    card, and data x codebook parallel training in ranks of their own. The
    2 x 2 clusters run on NCCL, a card a rank, where there are four cards,
    and on gloo otherwise (NCCL refuses two ranks on one card). Returns the
    numbers of the record and each kernel's launches."""
    from vqvae_tpu_torch.config import TrainConfig, VQVAEConfig
    from vqvae_tpu_torch.ops import cuda_quantizer
    from vqvae_tpu_torch.ops.quantizer import best_value_errors, compare_assignments
    from vqvae_tpu_torch.parallel.code_parallel import combine_shards
    from vqvae_tpu_torch.pipelines.extract import extract_latents
    from vqvae_tpu_torch.pipelines.viz import load_model
    from vqvae_tpu_torch.train.checkpoint import flatten_tree, read_state_tree, save_checkpoint
    from vqvae_tpu_torch.train.vqvae_train import VQVAETrainer, train_vqvae

    dev = torch.device(DEVICE)
    backend = "nccl" if torch.cuda.device_count() >= 4 else "gloo"
    rows = {}
    gen = torch.Generator(device=dev).manual_seed(14)

    # -- 1: the best values against the plain version ----------------------------
    worst = {}
    for n, k, d in (MAIN_SHAPE, BENCH_SHAPE) + TPU_TEST_SHAPES + (RAGGED_K_SHAPE,) + FMA_EDGE_SHAPES:
        z = torch.randn(n, d, device=dev, generator=gen)
        cb = torch.randn(k, d, device=dev, generator=gen)
        for mode in MODES:
            for route in dict.fromkeys((cuda_quantizer.kernel_route(mode, d), "fma")):
                idx, values = cuda_quantizer.nearest_code_indices(z, cb, mode, route, values=True)
                same = torch.equal(idx, cuda_quantizer.nearest_code_indices(z, cb, mode, route))
                err, outside = best_value_errors(z, cb, values, mode)
                worst[(mode, route)] = max(worst.get((mode, route), 0.0), err)
                print(f"[14] values N={n} K={k} D={d} {mode:8s} {route}: indices as without values "
                      f"{same}, largest |value - float64 minimum| {err:.3g}, outside the near-tie "
                      f"bound {outside}")
                check(same and outside == 0, f"best values of the {route} kernel in {mode} are wrong")
    rows["value_err"] = {f"{m}/{r}": e for (m, r), e in worst.items()}

    # -- 2: the codebook in contiguous shards, one card ---------------------------
    n = MAIN_SHAPE[0]
    mma_departures = {}
    for k, n_code in SHARD_SPLITS:
        z = torch.randn(n, 64, device=dev, generator=gen)
        cb = torch.randn(k, 64, device=dev, generator=gen)
        k_local = k // n_code
        for mode in MODES:
            for route in dict.fromkeys((cuda_quantizer.kernel_route(mode, 64), "fma")):
                idx_all, val_all = cuda_quantizer.nearest_code_indices(z, cb, mode, route, values=True)
                found = [cuda_quantizer.nearest_code_indices(
                    z, cb[s * k_local:(s + 1) * k_local].contiguous(), mode, route, values=True)
                    for s in range(n_code)]
                values = torch.stack([v for _i, v in found])
                win, _wl, idx = combine_shards(values, torch.stack([i for i, _v in found]), k_local)
                val = values.gather(0, win[None])[0]
                bits = torch.equal(idx, idx_all) and torch.equal(val, val_all)
                mism, near, gap = compare_assignments(z, cb, idx, idx_all, mode)
                val_diff = int((val != val_all).sum())
                print(f"[14] K={k} in {n_code} shards, N={n} {mode:8s} {route}: indices and values as "
                      f"the unsharded call bit for bit {bits}; index mismatches {mism} (near-ties "
                      f"{near}, largest gap {gap:.3g}), values that differ {val_diff}")
                if route == "fma":
                    check(bits, f"the sharded fma search in {mode} departs from the unsharded one")
                else:
                    check(mism == near and best_value_errors(z, cb, val, mode)[1] == 0,
                          f"the sharded mma search in {mode} departs beyond a near-tie")
                    mma_departures[f"{k}/{n_code}/{mode}"] = [mism, val_diff]
            dup = cb[:k_local].repeat(n_code, 1)
            for route in dict.fromkeys((cuda_quantizer.kernel_route(mode, 64), "fma")):
                found = [cuda_quantizer.nearest_code_indices(z, dup[s * k_local:(s + 1) * k_local].contiguous(),
                                                             mode, route, values=True)
                         for s in range(n_code)]
                _w, _l, idx = combine_shards(torch.stack([v for _i, v in found]),
                                             torch.stack([i for i, _v in found]), k_local)
                check(int(idx.max()) < k_local, f"{route} {mode}: a duplicated code left the lowest shard")
    rows["mma_shard_departures"] = mma_departures
    print(f"[14] the mma route's departures from itself when sharded (index mismatches, values that "
          f"differ) by K/n_code/mode: {mma_departures}; a duplicated codebook keeps every index in "
          f"the lowest shard on both routes")

    # the kernel with and without values at the main shape (a record)
    z = torch.randn(MAIN_SHAPE[0], MAIN_SHAPE[2], device=dev, generator=gen)
    cb = torch.randn(MAIN_SHAPE[1], MAIN_SHAPE[2], device=dev, generator=gen)
    rows["values_ms"] = {}
    for mode, route in (("highest", "fma"), ("default", "mma")):
        t = alternate({"without": lambda: cuda_quantizer.nearest_code_indices(z, cb, mode, route),
                       "with": lambda: cuda_quantizer.nearest_code_indices(z, cb, mode, route, values=True)})
        rows["values_ms"][route] = t
        print(f"[14] {route} ({mode}) at {MAIN_SHAPE}: {t['without']:.5f} ms without values, "
              f"{t['with']:.5f} ms with (CUDA events behind a spin; {smi})")

    # -- 3: 2 x 2 ranks training on the card, against one process ---------------
    train, _val, x_train_var, _info = dataset
    work = os.path.join(ROOT, "build", "smoke_parallel")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    vq = VQVAEConfig()
    trainer = VQVAETrainer(vq, TrainConfig(batch_size=PARALLEL_BATCH), x_train_var, device=DEVICE)
    start = trainer.init_state()
    with torch.no_grad():  # a codebook of latents, so that many codes and every shard win rows
        z_e = start.model.encode(torch.from_numpy(train.data[:64]).to(dev)).reshape(-1, vq.embedding_dim)
        pick = torch.from_numpy(np.random.default_rng(14).choice(len(z_e), vq.n_embeddings, replace=False))
        start.model.codebook.copy_(z_e[pick.to(dev)])
    for name in ("single", "par"):
        save_checkpoint(os.path.join(work, f"vqvae_{name}_step0.npz"), trainer.state_tree(start), 0,
                        hyperparameters=vq.to_dict())
    common = ["--batch_size", str(PARALLEL_BATCH), "--log_interval", "5", "--steps_per_dispatch", "5",
              "-save", "--resume", "--results_dir", work]
    cfg1 = TrainConfig(batch_size=PARALLEL_BATCH, n_updates=6, log_interval=5, steps_per_dispatch=5,
                       save=True, filename="single", results_dir=work)
    cuda_quantizer.reset_launch_counts()
    _s1, history1, _t1 = train_vqvae(vq, cfg1, dataset=dataset, resume=True, verbose=False, device=DEVICE)
    torch.cuda.synchronize()
    launches = {"one process": dict(cuda_quantizer.launches_by_route)}
    check(launches["one process"] == {"mma": 0, "fma": 5}, f"one process: {launches['one process']}")

    t0 = time.perf_counter()
    port = free_port()
    flags = ["--n_data", "2", "--n_code", "2", "--dist_backend", backend, "--n_updates", "21",
             "--filename", "par", *common]
    recs = run_clusters({"2x2": [train_argv(4, r, port, *flags) for r in range(4)]}, work)["2x2"]
    rows["cluster_2x2_s"] = time.perf_counter() - t0
    _tree, step, metrics, _hp = read_state_tree(os.path.join(work, "vqvae_par_step20.npz"))
    check(step == 20 and len(metrics["loss_vals"]) == 20, "the 2 x 2 run did not take 20 updates")
    deltas, ulps = {}, {}
    for key in ("loss_vals", "recon_errors", "perplexities"):
        a, b = np.asarray(metrics[key][:5]), np.asarray(getattr(history1, key))
        deltas[key] = (np.abs(a - b) / np.abs(b)).tolist()
        ulps[key] = float(abs(a[0] - b[0]) / np.spacing(np.float32(b[0])))
    print(f"[14] 2 x 2 {backend} ranks, 20 updates at global batch {PARALLEL_BATCH} in "
          f"{rows['cluster_2x2_s']:.3f} s (4 processes, host clock); first 5 against one process, "
          f"relative differences by update: {deltas}; update 1 apart by {ulps} ulps; loss "
          f"{metrics['loss_vals'][0]:.6f} -> {metrics['loss_vals'][-1]:.6f}, perplexity "
          f"{metrics['perplexities'][0]:.3f} -> {metrics['perplexities'][-1]:.3f}")
    rows["update1_ulps"] = ulps
    rows["updates2_5_rel_diff"] = {key: max(d[1:]) for key, d in deltas.items()}
    # Update 1 starts from the same weights and searches bit-identical latents
    # (below: encoded whole and as two halves they agree), so its counts and
    # perplexity are one process's bits; its losses are the mean of two
    # ranks' means of 128 images, one process's a mean of 256, summed in
    # another order: at most 2 ulps apart. From update 2 on the ranks' summed
    # gradients (each rank's mean, then the all-reduce; index_add_ adds with
    # atomics) have parted the weights in their last bits, and a latent near
    # a tie between two codes can take the other one. One such row moves the
    # perplexity by at most ln(N) / N of itself (5.9e-4 at N = 16,384): the
    # bound allows three a step.
    with torch.no_grad():
        x = torch.from_numpy(train.data[:PARALLEL_BATCH]).to(dev)
        z_whole = start.model.encode(x)
        z_halves = torch.cat([start.model.encode(half) for half in x.chunk(2)])
    z_apart = int((z_whole != z_halves).sum())
    rows["latents_whole_vs_halves"] = z_apart
    print(f"[14] the start state's latents of {PARALLEL_BATCH} images encoded at once and as two "
          f"halves of {PARALLEL_BATCH // 2}: {z_apart} of {z_whole.numel()} values differ")
    later = rows["updates2_5_rel_diff"]
    check(ulps["perplexities"] == 0 and max(ulps["loss_vals"], ulps["recon_errors"]) <= 2,
          f"the 2 x 2 run's first update departs from one process: {ulps} ulps")
    check(max(later["loss_vals"], later["recon_errors"]) <= 1e-6
          and later["perplexities"] <= 3 * math.log(64 * PARALLEL_BATCH) / (64 * PARALLEL_BATCH),
          f"the 2 x 2 run departs from one process in updates 2-5: {later}")
    par5 = flatten_tree(read_state_tree(os.path.join(work, "vqvae_par_step5.npz"))[0])
    one5 = flatten_tree(read_state_tree(os.path.join(work, "vqvae_single_step5.npz"))[0])
    param_diff = max(float(np.abs(par5[k] - one5[k]).max()) for k in one5 if ".params" in k)
    rows["params_diff_after_5"] = param_diff
    print(f"[14] parameters after 5 updates, 2 x 2 against one process: largest difference "
          f"{param_diff:.3g} (bound 6e-4)")
    check(set(par5) == set(one5) and param_diff <= 6e-4, "2 x 2 parameters depart")
    by_rank = sorted(recs, key=lambda r: r["rank"])
    check([(r["data"], r["code"]) for r in by_rank] == [(0, 0), (0, 1), (1, 0), (1, 1)],
          "the ranks' mesh coordinates are not row-major")
    check(len({r["replicated_sha"] for r in by_rank}) == 1,
          f"replicated weights differ between ranks: {[r['replicated_sha'] for r in by_rank]}")
    check(all(r["launches"] == {"mma": 0, "fma": r["updates"]} and r["updates"] == 20 for r in by_rank),
          f"each rank should launch the fma kernel once an update: {[r['launches'] for r in by_rank]}")
    for c in (0, 1):  # the two ranks holding one codebook shard hold the same bits
        check(by_rank[c]["codebook_sha"] == by_rank[2 + c]["codebook_sha"],
              f"codebook shard {c} differs between its data ranks")
    same_z = all(by_rank[2 * d]["z_prints"] == by_rank[2 * d + 1]["z_prints"] for d in (0, 1))
    print(f"[14] after 20 updates: replicated weights bit-identical on all 4 ranks "
          f"({by_rank[0]['replicated_sha']}); each codebook shard the same on its 2 data ranks; "
          f"ranks of a data row searched with bit-identical latents in every update: {same_z}; "
          f"launches {[r['launches'] for r in by_rank]}")
    check(same_z, "two ranks of a data row searched with different latents")
    timing, cards = {}, len({r["device"] for r in by_rank})
    for r in by_rank:
        t = {key: float(np.median(r[key][1:])) for key in ("step_ms", "reduce_ms", "combine_ms")}
        timing[r["rank"]] = t
        print(f"[14] rank {r['rank']} ({r['data']}, {r['code']}) on {r['device']}, "
              f"{r['backend']}: median of updates 2-20: step {t['step_ms']:.3f} ms, gradient "
              f"all-reduce {t['reduce_ms']:.3f} ms, combine {t['combine_ms']:.3f} ms (CUDA events; "
              f"4 ranks on {cards} card(s){': no scaling figure' if cards == 1 else ''}; {smi})")
    rows["rank_ms"] = timing
    model20, _m, _hp = load_model(os.path.join(work, "vqvae_par_step20.npz"), DEVICE)
    codes = extract_latents(model20, train.data[:2560], batch_size=256)
    check(model20.codebook.shape == (512, 64) and codes.shape == (2560, 64)
          and 0 <= codes.min() <= codes.max() < 512, "the 2 x 2 checkpoint does not reload")
    print(f"[14] rank 0's checkpoint of step 20 through load_model and extract_latents: codes "
          f"{codes.shape}, {len(np.unique(codes))} distinct")
    launches["2x2"] = [r["launches"] for r in by_rank]

    # bf16 / default (mma) and EMA in 2 x 2, one NCCL rank (two on two cards), at once
    def fresh(name, updates=10):
        return ["--batch_size", str(PARALLEL_BATCH), "--log_interval", "10", "--steps_per_dispatch", "5",
                "--n_updates", str(updates), "-save", "--filename", name, "--results_dir", work]

    p_bf16, p_ema, p_nccl = free_port(), free_port(), free_port()
    clusters = {
        "bf16": [train_argv(4, r, p_bf16, "--n_data", "2", "--n_code", "2", "--dist_backend", backend,
                            "--compute_dtype", "bfloat16", "--quantizer_precision", "default",
                            *fresh("bf16")) for r in range(4)],
        "ema": [train_argv(4, r, p_ema, "--n_data", "2", "--n_code", "2", "--dist_backend", backend,
                           "--ema_codebook", *fresh("ema")) for r in range(4)],
        "nccl": [train_argv(1, 0, p_nccl, "--dist_backend", "nccl", *fresh("nccl", 5))],
    }
    two_cards = torch.cuda.device_count() >= 2
    if two_cards:
        p_two = free_port()
        clusters["nccl2"] = [train_argv(2, r, p_two, "--n_data", "1", "--n_code", "2", "--dist_backend",
                                        "nccl", *fresh("nccl2")) for r in range(2)]
    t0 = time.perf_counter()
    recs = run_clusters(clusters, work)
    rows["clusters_s"] = time.perf_counter() - t0
    for name, want in (("bf16", {"mma": 10, "fma": 0}), ("ema", {"mma": 0, "fma": 10}),
                       ("nccl", {"mma": 0, "fma": 5})):
        got = [r["launches"] for r in recs[name]]
        check(all(g == want for g in got), f"{name}: launches {got}, expected {want} a rank")
        launches[name] = got
    check(all(r["backend"] == r["backend_asked"] for runs in recs.values() for r in runs),
          "a run did not use the backend it asked for")
    check(len(recs["nccl"][0]["reduce_ms"]) == 5, "the NCCL rank did not all-reduce every update")
    for name in ("bf16", "ema", "nccl") + (("nccl2",) if two_cards else ()):
        last = 4 if name == "nccl" else 9
        tree, step, m, _hp = read_state_tree(os.path.join(work, f"vqvae_{name}_step{last}.npz"))
        check(step == last and np.isfinite(m["loss_vals"]).all() and np.isfinite(m["perplexities"]).all(),
              f"{name}: a metric is not finite or the run stopped early")
        print(f"[14] {name}: {last + 1} updates, loss {m['loss_vals'][0]:.6f} -> {m['loss_vals'][-1]:.6f}, "
              f"launches {[r['launches'] for r in recs[name]]}, backend {recs[name][0]['backend']}")
        if name == "ema":
            counts = tree["ema_counts"]
            want_sum = 64 * PARALLEL_BATCH * (1.0 - 0.99 ** 10)
            rows["ema_counts_sum"] = float(counts.sum())
            print(f"[14] ema: counts over both shards sum to {counts.sum():.3f} "
                  f"({64 * PARALLEL_BATCH} * (1 - 0.99^10) = {want_sum:.3f}), shape {counts.shape}")
            check(counts.shape == (512,) and abs(counts.sum() / want_sum - 1.0) <= 1e-4,
                  "the sharded EMA counts do not follow the decay")
    if two_cards:
        launches["nccl2"] = [r["launches"] for r in recs["nccl2"]]
        print(f"nccl_two_ranks: run on 2 cards, launches {launches['nccl2']}")
    else:
        print("nccl_two_ranks: not run, 1 card")
    rows["launches"] = launches
    print(f"[14] bf16, EMA and NCCL runs together: {rows['clusters_s']:.3f} s (host clock)")
    return rows


def prior_parallel_phase(smi: str, codes: np.ndarray, work: str) -> dict:
    """Phase 15 (a): two ranks of ``train-prior --distributed --n_data 2`` at
    the full width on phase 3's grids, against one process over the same
    epoch from one saved epoch-0 state. Returns the numbers of the record."""
    from vqvae_tpu_torch import cli
    from vqvae_tpu_torch.config import PixelCNNConfig, TrainConfig
    from vqvae_tpu_torch.pipelines.viz import load_prior
    from vqvae_tpu_torch.train import pixelcnn_train
    from vqvae_tpu_torch.train.checkpoint import flatten_tree, read_state_tree, save_checkpoint

    rows = {}
    cfg = PixelCNNConfig(input_dim=512, dim=64, n_layers=15, img_dim=8)
    data_dir = os.path.join(work, "data")
    os.makedirs(data_dir)
    np.save(os.path.join(data_dir, "latent_e_indices.npy"), codes)
    start = pixelcnn_train.PixelCNNTrainer(cfg, TrainConfig(), device=DEVICE).init_state()
    grad_mb = 4 * sum(p.numel() for p in start.model.parameters()) / 1e6  # one fp32 all-reduce
    for name in ("single", "par"):
        os.makedirs(os.path.join(work, name))
        save_checkpoint(os.path.join(work, name, "latent_block_pixelcnn.npz"), start, 0,
                        metrics={"train_loss": [], "val_loss": []}, hyperparameters=cfg.to_dict())
    common = ["--epochs", "2", "--batch_size", str(PRIOR_PARALLEL_BATCH), "--steps_per_dispatch", "11",
              "--log_interval", "44", "--resume", "-save", "--gen_samples", "--data_dir", data_dir]

    # one process over the same epoch, its per-update losses recorded
    losses, real_run = [], pixelcnn_train.PixelCNNTrainer._run
    runs, real_train = [], pixelcnn_train.train_pixelcnn

    def run(self, state, batches):
        out = real_run(self, state, batches)
        losses.append(out[1])
        return out

    def recording(*args, **kwargs):
        out = real_train(*args, **kwargs)
        runs.append(out)
        return out

    pixelcnn_train.PixelCNNTrainer._run, pixelcnn_train.train_pixelcnn = run, recording
    try:
        t0 = time.perf_counter()
        rc = cli.main(["train-prior", "--results_dir", os.path.join(work, "single"), *common])
        torch.cuda.synchronize()
        rows["single_s"] = time.perf_counter() - t0
    finally:
        pixelcnn_train.PixelCNNTrainer._run, pixelcnn_train.train_pixelcnn = real_run, real_train
    single_state, single_out = runs[-1]
    single_losses = torch.cat(losses).tolist()
    single_val = single_out["history"]["val_loss"][0]
    check(rc == 0 and single_state.step == len(single_losses) == (len(codes) - 500) // PRIOR_PARALLEL_BATCH,
          f"one process did not take one epoch: {single_state.step} updates")

    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    port = free_port()
    argv = [["train-prior", "--distributed", "--coordinator_address", f"127.0.0.1:{port}",
             "--num_processes", "2", "--process_id", str(r), "--n_data", "2", "--dist_backend", backend,
             "--device", DEVICE, "--results_dir", os.path.join(work, "par"), *common] for r in range(2)]
    t0 = time.perf_counter()
    recs = sorted(run_clusters({"prior": argv}, work, tag="15")["prior"], key=lambda r: r["rank"])
    rows["ranks_s"] = time.perf_counter() - t0
    for r in recs:
        check(r["rc"] == 0 and r["updates"] == len(single_losses) and r["backend"] == r["backend_asked"]
              and r["launches"] == {"mma": 0, "fma": 0},
              f"prior rank {r['rank']}: rc {r['rc']}, {r['updates']} updates, backend {r['backend']}, "
              f"launches {r['launches']}")
    ours, theirs = np.asarray(recs[0]["losses"][:5]), np.asarray(single_losses[:5])
    rel = (np.abs(ours - theirs) / np.abs(theirs)).tolist()
    ulps = float(abs(ours[0] - theirs[0]) / np.spacing(np.float32(theirs[0])))
    val_diff = abs(recs[0]["history"]["val_loss"][0] - single_val)
    rows.update(update1_ulps=ulps, updates2_5_rel_diff=max(rel[1:]), val_ce=recs[0]["history"]["val_loss"][0],
                val_ce_single=single_val, val_ce_diff=val_diff, backend=backend)
    print(f"[15] train-prior --distributed --n_data 2 ({backend}, {torch.cuda.device_count()} card(s)), one epoch "
          f"of {recs[0]['updates']} updates at global batch {PRIOR_PARALLEL_BATCH} from one saved epoch-0 state in "
          f"{rows['ranks_s']:.3f} s (2 processes, host clock; one process {rows['single_s']:.3f} s): first 5 "
          f"losses {ours.tolist()} against one process {theirs.tolist()}: relative {rel}, update 1 {ulps} ulps; "
          f"validation CE {recs[0]['history']['val_loss'][0]:.6f} against {single_val:.6f} "
          f"(|difference| {val_diff:.3g}, bound 1e-4)")
    check(ulps <= PRIOR_PAR_UPDATE1_ULPS and max(rel[1:]) <= PRIOR_PAR_LATER_REL,
          f"the prior's ranks depart from one process in updates 1-5: {ulps} ulps, {rel}")
    check(val_diff <= 1e-4, f"the prior's ranks' validation CE departs by {val_diff}")
    check(recs[0]["state_sha"] == recs[1]["state_sha"] and recs[0]["samples_sha"] == recs[1]["samples_sha"],
          f"the prior's replicas differ: {[(r['state_sha'], r['samples_sha']) for r in recs]}")
    print(f"[15] replicas after the epoch: weights and Adam state bit-identical on both ranks "
          f"({recs[0]['state_sha']}); per-epoch samples from one seed identical ({recs[0]['samples_sha']})")
    timing = {}
    for r in recs:
        t = {key: float(np.median(r[key][1:])) for key in ("step_ms", "reduce_ms")}
        timing[r["rank"]] = t
        print(f"[15] prior rank {r['rank']} on {r['device']}, {r['backend']}: median of updates 2-"
              f"{r['updates']}: step {t['step_ms']:.3f} ms, gradient all-reduce ({grad_mb:.2f} MB) "
              f"{t['reduce_ms']:.3f} ms (CUDA events; {smi})")
    rows["rank_ms"] = timing
    par_file = os.path.join(work, "par", "latent_block_pixelcnn.npz")
    _tree, epoch, metrics, _hp = read_state_tree(par_file)
    prior, _m, _hp = load_prior(par_file, DEVICE)
    single_flat = flatten_tree(read_state_tree(os.path.join(work, "single", "latent_block_pixelcnn.npz"))[0])
    par_flat = flatten_tree(_tree)
    params_diff = max(float(np.abs(par_flat[k] - single_flat[k]).max()) for k in single_flat if ".params" in k)
    rows["params_diff"] = params_diff
    print(f"[15] rank 0's file: epoch {epoch}, history {metrics}, through load_prior "
          f"({sum(p.numel() for p in prior.parameters())} parameters); parameters against one process after "
          f"the epoch: largest difference {params_diff:.3g}")
    check(epoch == 1 and metrics == recs[0]["history"], "rank 0's prior file is not the epoch's")
    return rows


def rest_phase(smi: str, dataset, codes: np.ndarray) -> dict:
    """Phase 15: the prior's ranks (a), ``profile`` (b), ``viz`` (c), training
    on BLOCK (d) and ``checked`` around a train step (e). Returns the numbers
    of the record and each kernel's launches."""
    import importlib.util
    import tempfile

    from vqvae_tpu_torch import cli
    from vqvae_tpu_torch.config import TrainConfig, VQVAEConfig
    from vqvae_tpu_torch.data.datasets import load_dataset
    from vqvae_tpu_torch.ops import cuda_quantizer
    from vqvae_tpu_torch.pipelines.viz import load_model, reconstruct, smooth
    from vqvae_tpu_torch.train.checkpoint import read_state_tree
    from vqvae_tpu_torch.train.vqvae_train import VQVAETrainer
    from vqvae_tpu_torch.utils.debug import checked

    rows, launches = {}, {}
    data_dir = os.path.join(ROOT, "data")
    with tempfile.TemporaryDirectory() as tmp:
        # -- (a) the prior's data parallelism -----------------------------------
        t0 = time.perf_counter()
        rows["prior_ranks"] = prior_parallel_phase(smi, codes, os.path.join(tmp, "prior"))
        rows["a_s"] = time.perf_counter() - t0

        # -- (b) profile through the CLI -------------------------------------------
        trace = os.path.join(tmp, "trace")
        cuda_quantizer.reset_launch_counts()
        t0 = time.perf_counter()
        rc = cli.main(["profile", "--batch_size", str(TRAIN_BATCH), "--profile_steps", "5",
                       "--trace_dir", trace, "--data_dir", data_dir])
        rows["b_s"] = time.perf_counter() - t0
        launches["profile"] = dict(cuda_quantizer.launches_by_route)
        files = [f for f in os.listdir(trace) if f.endswith(".pt.trace.json")]
        with open(os.path.join(trace, files[0])) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
        steps = sorted(n for n in names if n.startswith("train_step_"))
        kernel = sorted(n for n in names if "nearest_code_kernel" in n)
        print(f"[15] profile --batch_size {TRAIN_BATCH} --profile_steps 5: rc {rc}, {rows['b_s']:.3f} s, trace "
              f"{files} ({os.path.getsize(os.path.join(trace, files[0])) / 2**20:.1f} MB, {len(names)} distinct "
              f"names) holds {steps} and {kernel[:1]}; kernel launches {launches['profile']}")
        check(rc == 0 and len(files) == 1 and steps == [f"train_step_{i}" for i in range(5)] and kernel,
              "the profile trace lacks a step or the fma kernel")
        check(launches["profile"] == {"mma": 0, "fma": 6}, f"profile: launches {launches['profile']}")

        # -- (c) viz on both trained checkpoints --------------------------------------
        have_mpl = importlib.util.find_spec("matplotlib") is not None
        for name, ckpt, route in (("e2e_r4", R4, "fma"), ("e2e_r5", R5, "mma")):
            out_dir = os.path.join(tmp, "viz", name)
            cuda_quantizer.reset_launch_counts()
            if have_mpl:
                rc = cli.main(["viz", "--checkpoint", ckpt, "--out_dir", out_dir, "--data_dir", data_dir,
                               "--n_images", "16"])
                written = sorted(os.listdir(out_dir))
                print(f"[15] viz {name}: rc {rc}, wrote {written}")
                check(rc == 0 and written == ["metrics.png", "originals.png", "reconstructions.png"],
                      f"viz {name} failed")
            else:
                try:
                    cli.main(["viz", "--checkpoint", ckpt, "--out_dir", out_dir, "--data_dir", data_dir])
                    check(False, "viz ran without matplotlib")
                except ImportError as e:
                    print(f"[15] viz {name}: matplotlib is not installed on this machine ({e}); "
                          f"running viz's device part instead: load_model, reconstruct, smooth")
                cuda_quantizer.reset_launch_counts()
                model, metrics, hp = load_model(ckpt, DEVICE)
                _tr, val, _v, _i = load_dataset(hp.get("dataset", "CIFAR10"), data_dir)
                rec = reconstruct(model, val.data[:16])
                curves = {k: smooth(metrics[k]) for k in ("recon_errors", "loss_vals", "perplexities")}
                print(f"[15] viz {name} (device part): reconstructions {rec.shape}, mse "
                      f"{float(np.mean((rec - val.data[:16]) ** 2)):.6f}; smoothed curves of "
                      f"{ {k: len(v) for k, v in curves.items()} } updates, last recon_error "
                      f"{curves['recon_errors'][-1]:.4f}")
                check(rec.shape == (16, 32, 32, 3) and np.isfinite(rec).all()
                      and all(np.isfinite(v).all() for v in curves.values()), f"viz {name}: not finite")
            launches[f"viz {name}"] = dict(cuda_quantizer.launches_by_route)
            want = {"mma": 0, "fma": 0, route: 1}
            check(launches[f"viz {name}"] == want, f"viz {name}: launches {launches[f'viz {name}']}, want {want}")

        # -- (d) train-vqvae on a synthetic BLOCK file ---------------------------------
        block_dir, results = os.path.join(tmp, "block"), os.path.join(tmp, "block_results")
        os.makedirs(block_dir)
        frames = np.random.default_rng(15).integers(0, 255, (1000, 1, 1, 48, 48, 4), dtype=np.uint8)
        np.save(os.path.join(block_dir, "randact_traj_length_100_n_trials_1000_n_contexts_1.npy"), frames)
        cuda_quantizer.reset_launch_counts()
        t0 = time.perf_counter()
        rc = cli.main(["train-vqvae", "--dataset", "BLOCK", "--data_dir", block_dir, "--batch_size",
                       str(TRAIN_BATCH), "--n_updates", "20", "--log_interval", "10", "--steps_per_dispatch",
                       "10", "-save", "--filename", "block", "--results_dir", results])
        rows["d_s"] = time.perf_counter() - t0
        launches["block"] = dict(cuda_quantizer.launches_by_route)
        _tree, step, m, hp = read_state_tree(os.path.join(results, "vqvae_block_step19.npz"))
        print(f"[15] train-vqvae --dataset BLOCK (1,000 synthetic 48 x 48 frames, 900 for training), 20 "
              f"updates at batch {TRAIN_BATCH}: rc {rc}, {rows['d_s']:.3f} s, loss {m['loss_vals'][0]:.6f} -> "
              f"{m['loss_vals'][-1]:.6f}, x_train_var {hp['x_train_var']:.6f}, launches {launches['block']}")
        check(rc == 0 and step == 19 and len(m["loss_vals"]) == 20 and hp["dataset"] == "BLOCK"
              and all(np.isfinite(m[k]).all() for k in ("loss_vals", "recon_errors", "perplexities")),
              "training on BLOCK failed or a metric is not finite")
        check(launches["block"] == {"mma": 0, "fma": 20}, f"BLOCK: launches {launches['block']}")

    # -- (e) checked around one train step -------------------------------------------
    train, _val, x_train_var, _info = dataset
    trainer = VQVAETrainer(VQVAEConfig(), TrainConfig(batch_size=32), x_train_var, device=DEVICE)
    x = torch.from_numpy(train.data[:32]).to(DEVICE)
    cuda_quantizer.reset_launch_counts()
    t0 = time.perf_counter()
    err, (_st, m) = checked(trainer.step)(trainer.init_state(), x)
    rows["e_checked_step_s"] = time.perf_counter() - t0
    x_bad = x.clone()
    x_bad[3, 7, 7, 1] = float("nan")
    err_bad, _out = checked(trainer.step)(trainer.init_state(), x_bad)
    launches["checked"] = dict(cuda_quantizer.launches_by_route)
    try:
        err_bad.throw()
        raised = None
    except FloatingPointError as e:
        raised = str(e)
    print(f"[15] checked(trainer.step), fp32 batch 32: healthy batch -> {err!r}, loss {float(m['loss']):.6f} "
          f"({rows['e_checked_step_s']:.3f} s with a check after every op); a NaN written into the input -> "
          f"throw() raised {raised!r}; launches {launches['checked']}")
    check(err.get() is None and math.isfinite(float(m["loss"])), f"a healthy step was flagged: {err!r}")
    check(raised is not None and raised.startswith("aten."), "a NaN in the input was not caught")
    check(launches["checked"] == {"mma": 0, "fma": 2}, f"checked: launches {launches['checked']}")
    rows["launches"] = launches
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "vqvae_tpu_torch")):
        print(f"chip_smoke: no vqvae_tpu_torch package beside {__file__}", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from vqvae_tpu_torch.config import TrainConfig, VQVAEConfig
    from vqvae_tpu_torch.data.datasets import load_dataset
    from vqvae_tpu_torch.ops import cuda_quantizer
    from vqvae_tpu_torch.ops.quantizer import (
        code_scores,
        compare_assignments,
        nearest_code_torch,
    )
    from vqvae_tpu_torch.ops.scatter import scatter_add_rows
    from vqvae_tpu_torch.pipelines.extract import extract_latents
    from vqvae_tpu_torch.pipelines.viz import load_model, reconstruct
    from vqvae_tpu_torch.train.vqvae_train import VQVAETrainer, train_vqvae

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

    # NaN scores (the rule in ops/cuda_quantizer.py): codebook row 300 NaN, z row 7 NaN
    n, k, d = MAIN_SHAPE
    z = torch.randn(n, d, device=dev, generator=gen)
    cb = torch.randn(k, d, device=dev, generator=gen)
    z[7], cb[300] = float("nan"), float("nan")
    keep, finite = torch.arange(k, device=dev) != 300, torch.arange(n, device=dev) != 7
    for mode in MODES:
        _, idx_plain = nearest_code_torch(z, cb, mode)
        plain_rule = bool((idx_plain[finite] == 300).all()) and int(idx_plain[7]) == 0
        _, rest = nearest_code_torch(z, cb[keep], mode)
        want = rest + (rest >= 300).int()  # the nearest code other than 300
        for route in dict.fromkeys((cuda_quantizer.kernel_route(mode, d), "fma")):
            idx = cuda_quantizer.nearest_code_indices(z, cb, mode, route)
            mism, near, _gap = compare_assignments(z[finite], cb.nan_to_num(0.0), idx[finite],
                                                   want[finite], mode)
            picked_nan = int((idx == 300).sum())
            print(f"[2] NaN codebook row 300, NaN z row 7, N={n} {mode:8s} {route}: rows on code 300 "
                  f"{picked_nan}, z row 7 -> code {int(idx[7])}, vs nearest other code mismatches={mism} "
                  f"near_ties={near}; plain version: first NaN (300 for finite rows, 0 for row 7) "
                  f"{plain_rule}")
            check(picked_nan == 0 and int(idx[7]) == 0 and mism == near,
                  f"the {route} kernel breaks the NaN rule in mode {mode}")
            check(plain_rule, "the plain version does not take the first NaN")

    # -- phase 3: extraction, the main path -----------------------------------
    model, _metrics, hp = load_model(R5, device=DEVICE)
    check(hp["compute_dtype"] == "bfloat16" and hp["quantizer_precision"] == "default",
          f"unexpected e2e_r5 hyperparameters {hp}")
    train, val, x_train_var, info = load_dataset("CIFAR10", os.path.join(ROOT, "data"))
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
    profile_device("6", "extract_latents over 2560 images",
                   lambda: extract_latents(model, data[:2560], batch_size=256))

    # -- phase 7: training, fp32 / highest (route fma) --------------------------
    dataset = (train, val, x_train_var, info)
    results = os.path.join(ROOT, "build", "smoke_results")
    shutil.rmtree(results, ignore_errors=True)
    cfg7 = TrainConfig(batch_size=TRAIN_BATCH, n_updates=60, log_interval=20, steps_per_dispatch=10,
                       save=True, filename="smoke_fp32", results_dir=results)
    cuda_quantizer.reset_launch_counts()
    t0 = time.perf_counter()
    state7, history7, trainer7 = train_vqvae(VQVAEConfig(), cfg7, dataset=dataset, device=DEVICE)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches_fp32 = dict(cuda_quantizer.launches_by_route)
    first = float(np.mean(history7.recon_errors[:10]))
    last = float(np.mean(history7.recon_errors[-10:]))
    print(f"[7] train_vqvae fp32/highest: 60 updates at batch {TRAIN_BATCH} in {dt:.3f} s (host clock, first "
          f"cuDNN calls and 4 checkpoints included), kernel launches {launches_fp32}; recon_error "
          f"mean of steps 0-9 {first:.6f}, of steps 50-59 {last:.6f}; loss {history7.loss_vals[0]:.6f} "
          f"-> {history7.loss_vals[-1]:.6f}; perplexity {history7.perplexities[0]:.3f} -> "
          f"{history7.perplexities[-1]:.3f}")
    check(launches_fp32 == {"mma": 0, "fma": 60}, f"expected 60 fma launches, got {launches_fp32}")
    check(state7.step == 60 and state7.optimizer.count == 60 and len(history7.loss_vals) == 60,
          "the run did not take 60 updates")
    check(trainer7._device_data is not None and trainer7._device_data.device.type == dev.type,
          "the training set was not staged on the card")
    check(all(np.isfinite(v).all() for v in
              (history7.loss_vals, history7.recon_errors, history7.perplexities)),
          "a training metric is not finite")
    check(last < first, "the reconstruction error did not fall over 60 updates")
    saved = sorted(f for f in os.listdir(results) if f.endswith(".npz"))
    check(saved == [f"vqvae_smoke_fp32_step{s}.npz" for s in (0, 20, 40, 59)],
          f"unexpected checkpoints {saved}")
    model7, metrics7, hp7 = load_model(os.path.join(results, "vqvae_smoke_fp32_step59.npz"), DEVICE)
    check(len(metrics7["loss_vals"]) == 60 and hp7["batch_size"] == TRAIN_BATCH, "checkpoint metadata")
    check(torch.equal(model7.codebook, state7.model.codebook.detach()), "checkpoint != final state")
    codes7 = extract_latents(model7, data[:2560], batch_size=256)
    print(f"[7] checkpoint of step 59 reloaded: extract_latents {codes7.shape}, "
          f"{len(np.unique(codes7))} distinct codes")
    check(codes7.shape == (len(data[:2560]), 64) and codes7.min() >= 0 and codes7.max() < 512,
          "codes from the trained checkpoint out of shape or range")

    # one step's gradients on the card against the port on the CPU: the same
    # initial weights (drawn on the CPU from one seed) and a batch of 32 whose
    # codes agree on both (a near-tie flip would move a codebook row's gradient)
    def gradients(trainer, x):
        state = trainer.init_state(torch.Generator().manual_seed(7))
        state, _m = trainer.step(state, x)  # the step moves the weights, not the gradients
        return {n: p.grad.clone() for n, p in state.model.named_parameters()}

    cpu_trainer = VQVAETrainer(VQVAEConfig(), TrainConfig(), x_train_var, device="cpu")
    gpu_trainer = VQVAETrainer(VQVAEConfig(), TrainConfig(), x_train_var, device=DEVICE)
    for start in range(0, 32 * 8, 32):
        x32 = train.data[start:start + 32]
        with torch.no_grad():
            probe_cpu = cpu_trainer.init_state(torch.Generator().manual_seed(7)).model
            probe_gpu = gpu_trainer.init_state(torch.Generator().manual_seed(7)).model
            same = torch.equal(probe_cpu.codes(torch.from_numpy(x32)),
                               probe_gpu.codes(torch.from_numpy(x32).to(dev)).cpu())
        if same:
            break
    check(same, "no batch of 32 among 8 gives the same codes on the card and the CPU")
    grads_cpu = gradients(cpu_trainer, x32)
    errs = relative_gradient_errors(gradients(gpu_trainer, x32), grads_cpu)
    worst = max(errs, key=errs.get)
    print(f"[7] gradients of one step, card vs CPU (batch of 32 from image {start}, "
          f"{len(errs)} parameters): largest error / largest gradient, worst {errs[worst]:.3g} "
          f"({worst}), median {float(np.median(list(errs.values()))):.3g}")
    # for the record: the same with TF32 allowed everywhere, and with the
    # scope held around the forward only (backward at the process default)
    tf32_trainer = VQVAETrainer(VQVAEConfig(conv_precision="default"), TrainConfig(), x_train_var,
                                device=DEVICE)
    errs_tf32 = relative_gradient_errors(gradients(tf32_trainer, x32), grads_cpu)
    st = gpu_trainer.init_state(torch.Generator().manual_seed(7))
    loss, *_ = gpu_trainer._forward(st.model, torch.from_numpy(x32).to(dev))  # convs scope themselves
    loss.backward()
    errs_fwd = relative_gradient_errors(
        {n: p.grad for n, p in st.model.named_parameters()}, grads_cpu)
    print(f"[7]   conv_precision='default' (TF32 allowed): worst {max(errs_tf32.values()):.3g}; "
          f"'highest' scoped around the forward only, backward at the process default "
          f"(torch.backends.cudnn.conv.fp32_precision = "
          f"{torch.backends.cudnn.conv.fp32_precision!r}): worst {max(errs_fwd.values()):.3g}")
    check(errs[worst] <= 1e-4, f"gradients on the card drift from the CPU (TF32 in a backward conv?): {errs[worst]}")

    # the same 5 updates twice from the same state: bit for bit
    idx5 = np.stack([np.arange(i * TRAIN_BATCH, (i + 1) * TRAIN_BATCH) for i in range(5)])
    repeats = {"fp32/highest (fma)": same_updates_twice(trainer7, idx5)}

    # -- phase 8: training in bf16 / default (route mma) and with an EMA codebook ---
    cfg8 = TrainConfig(batch_size=TRAIN_BATCH, n_updates=20, log_interval=20, steps_per_dispatch=10)
    vq_bf16 = VQVAEConfig(compute_dtype="bfloat16", quantizer_precision="default")
    cuda_quantizer.reset_launch_counts()
    state8, history8, _t8 = train_vqvae(vq_bf16, cfg8, dataset=dataset, device=DEVICE)
    torch.cuda.synchronize()
    launches_bf16 = dict(cuda_quantizer.launches_by_route)
    print(f"[8] train_vqvae bf16/default: 20 updates at batch {TRAIN_BATCH}, kernel launches {launches_bf16}; "
          f"recon_error {history8.recon_errors[0]:.6f} -> {history8.recon_errors[-1]:.6f}, "
          f"loss {history8.loss_vals[0]:.6f} -> {history8.loss_vals[-1]:.6f}")
    check(launches_bf16 == {"mma": 20, "fma": 0}, f"expected 20 mma launches, got {launches_bf16}")
    check(np.isfinite(history8.loss_vals).all() and np.isfinite(history8.perplexities).all(),
          "bf16 training metrics not finite")
    check(all(p.dtype == torch.float32 and bool(torch.isfinite(p).all())
              for p in state8.model.parameters()), "bf16 training: parameters not finite fp32")

    vq_ema = VQVAEConfig(ema_codebook=True)
    cuda_quantizer.reset_launch_counts()
    state_e, history_e, _te = train_vqvae(vq_ema, cfg8, dataset=dataset, device=DEVICE)
    torch.cuda.synchronize()
    launches_ema = dict(cuda_quantizer.launches_by_route)
    counts_sum = float(state_e.ema_counts.sum())
    want_sum = 64 * TRAIN_BATCH * (1.0 - vq_ema.ema_decay ** 20)
    n_tot = state_e.ema_counts.sum()
    smoothed = ((state_e.ema_counts + vq_ema.ema_epsilon)
                / (n_tot + vq_ema.n_embeddings * vq_ema.ema_epsilon) * n_tot)
    cb_err = float((state_e.model.codebook.detach() - state_e.ema_means / smoothed[:, None]).abs().max())
    print(f"[8] train_vqvae EMA fp32/highest: 20 updates, kernel launches {launches_ema}; "
          f"ema_counts.sum() {counts_sum:.3f} ({64 * TRAIN_BATCH} * (1 - 0.99^20) = {want_sum:.3f}); "
          f"|codebook - means / smoothed| max {cb_err:.3g}; loss {history_e.loss_vals[0]:.6f} -> "
          f"{history_e.loss_vals[-1]:.6f}")
    check(launches_ema == {"mma": 0, "fma": 20}, f"expected 20 fma launches, got {launches_ema}")
    check(np.isfinite(history_e.loss_vals).all(), "EMA training metrics not finite")
    check(abs(counts_sum / want_sum - 1.0) <= 1e-4, "EMA counts do not follow the decay")
    check(cb_err <= 1e-5, "the EMA codebook is not means / smoothed counts")
    check(all(not bool(state_e.optimizer.state[state_e.model.codebook][m].any())
              for m in ("mu", "nu", "nu_max")), "the EMA codebook has optimizer moments")
    repeats["bf16/default (mma)"] = same_updates_twice(_t8, idx5)
    repeats["EMA, fp32/highest (fma)"] = same_updates_twice(_te, idx5)
    for name, (diff, dmetric) in repeats.items():
        print(f"[8] the same 5 updates twice from the same state, {name}, batch {TRAIN_BATCH}: largest "
              f"difference of any train-state leaf {diff:.3g}, of any metric {dmetric:.3g}")
    check(all(d == 0 and m == 0 for d, m in repeats.values()),
          f"two runs of the same 5 updates part: {repeats}")

    # -- phase 9: times of the train step and its parts (records, not checks) ----
    def step_timer(vq_cfg, batch):
        trainer = VQVAETrainer(vq_cfg, TrainConfig(batch_size=batch), x_train_var, device=DEVICE)
        state = trainer.init_state()
        x = torch.from_numpy(train.data[:batch]).to(dev)
        return trainer, state, x, (lambda: trainer.step(state, x))

    step_rows = []
    for label, vq_cfg, batch in (("fp32/highest", VQVAEConfig(), 32),
                                 ("fp32/highest", VQVAEConfig(), TRAIN_BATCH),
                                 ("bf16/default", vq_bf16, TRAIN_BATCH)):
        _tr, _st, _x, fn = step_timer(vq_cfg, batch)
        # a step is thousands of times a launch: no spin; the events see the
        # card's time or the host's pace of queueing the step, whichever is longer
        ms = min(time_ms(fn, iters=30, warmup=10, queue_ahead=False) for _ in range(2))
        host_ms = math.inf
        for _ in range(2):  # the host alone: its clock around 30 steps, nothing awaited
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(30):
                fn()
            host_ms = min(host_ms, 1e3 * (time.perf_counter() - t0) / 30)
        torch.cuda.synchronize()
        row = {"train_step": label, "batch": batch, "ms": ms, "images_per_s": 1e3 * batch / ms,
               "host_queue_ms": host_ms}
        step_rows.append(row)
        print(f"[9] {json.dumps(row)}")
    trainer9, state9, x9, step9 = step_timer(VQVAEConfig(), TRAIN_BATCH)
    step9()
    opt_ms = min(time_ms(state9.optimizer.step, queue_ahead=False) for _ in range(2))
    n_params = sum(p.numel() for p in state9.model.parameters())
    print(f"[9] optimizer update alone ({len(list(state9.model.parameters()))} parameters, "
          f"{n_params} elements, torch._foreach_*): {opt_ms:.5f} ms a call at the host's pace")
    n, k, d = 64 * TRAIN_BATCH, 512, 64  # a train step's rows, = MAIN_SHAPE at batch 256
    g = torch.randn(n, d, device=dev, generator=gen)
    with torch.no_grad():
        q9 = state9.model.quantize(state9.model.encode(x9))
    spread = torch.randint(0, k, (n,), device=dev, generator=gen, dtype=torch.int32)
    narrow = spread % 4
    real = q9.indices.reshape(-1)
    acc = torch.zeros(k, d, device=dev)
    scatter_rows = {}
    for name, idx in (("uniform over 512 codes", spread), ("4 codes", narrow),
                      (f"a fresh model's assignments, {len(torch.unique(real))} codes", real)):
        t = alternate({"index_add_": lambda: acc.zero_().index_add_(0, idx, g),
                       "scatter_add_rows": lambda: scatter_add_rows(idx, g, k)})
        # the deterministic alternative not taken: one code's rows summed in turn
        t["index_put_"] = time_ms(lambda: acc.zero_().index_put_((idx.long(),), g, accumulate=True),
                                  iters=5, warmup=1, queue_ahead=False)
        same = torch.equal(scatter_add_rows(idx, g, k), scatter_add_rows(idx, g, k))
        scatter_rows[name] = t
        print(f"[9] scatter-add backward alone, ({n}, {d}) rows into ({k}, {d}), indices {name}: "
              f"zero + index_add_ (atomics, before) {t['index_add_']:.5f} ms, scatter_add_rows "
              f"(float64 one-hot product, now) {t['scatter_add_rows']:.5f} ms, both behind a spin; "
              f"zero + index_put_(accumulate=True) {t['index_put_']:.5f} ms at the host's pace; "
              f"scatter_add_rows twice bit-identical {same}")
        check(same, "scatter_add_rows gave two results for one input")
    ema_trainer, ema_state, _x, ema_step = step_timer(vq_ema, TRAIN_BATCH)
    ema_step()
    with torch.no_grad():
        z9 = ema_state.model.encode(x9)
        q_ema = ema_state.model.quantize(z9)
    t_ema = time_ms(lambda: ema_trainer._ema_update(ema_state, z9, q_ema), queue_ahead=False)
    print(f"[9] EMA update alone (sums by scatter_add_rows, decay, smoothing, codebook overwrite) at "
          f"({n}, {k}, {d}): {t_ema:.5f} ms a call at the host's pace")
    print(f"[9] card: {smi}; train-step times from CUDA events around 30 steps after 10 warm-up, "
          f"no spin, the faster of two turns; host_queue_ms is the host clock around 30 steps "
          f"with nothing awaited, the faster of two turns")
    idx20 = np.stack([np.arange(i * TRAIN_BATCH, (i + 1) * TRAIN_BATCH) for i in range(20)])
    trainer9.stage_dataset(train.data)
    trainer9.steps_by_index(state9, idx20[:5])
    prof9 = profile_device("9", f"20 train steps at batch {TRAIN_BATCH}, fp32/highest, steps_by_index",
                           lambda: trainer9.steps_by_index(state9, idx20), top=24)
    # the cost of repeating bit for bit: the same step with the arithmetic it had before
    turns = {"now": [], "before": []}
    for name in ("now", "before", "before", "now"):
        with previous_arithmetic() if name == "before" else contextlib.nullcontext():
            step9()
            turns[name].append(time_ms(step9, iters=30, warmup=5, queue_ahead=False))
    with previous_arithmetic():
        trainer9.steps_by_index(state9, idx20[:5])
        prof9_old = profile_device("9", f"the same 20 steps with the arithmetic of before (index_add_, cuDNN's "
                                   f"default algorithms)", lambda: trainer9.steps_by_index(state9, idx20), top=8)
    print(f"[9] fp32/highest step at batch {TRAIN_BATCH}, the faster of two turns: now {min(turns['now']):.3f} ms, "
          f"with the arithmetic of before {min(turns['before']):.3f} ms; device busy a step (profiler on) now "
          f"{prof9.get('busy_ms', 0) / 20:.3f} ms, before {prof9_old.get('busy_ms', 0) / 20:.3f} ms; convolutions "
          f"a step now {conv_ms_per_step(prof9, 20):.3f} ms, before {conv_ms_per_step(prof9_old, 20):.3f} ms "
          f"({smi})")
    t_prior = time.perf_counter()
    prior_rows = sampling_phases(dev, smi)
    print(f"[12] phases 10-12 took {time.perf_counter() - t_prior:.1f} s; {json.dumps(prior_rows)}")
    t_train_prior = time.perf_counter()
    train_rows = prior_training_phase(smi, codes)
    print(f"[13] phase 13 took {time.perf_counter() - t_train_prior:.1f} s; {json.dumps(train_rows)}")
    t_parallel = time.perf_counter()
    parallel_rows = parallel_phase(smi, dataset)
    print(f"[14] phase 14 took {time.perf_counter() - t_parallel:.1f} s; {json.dumps(parallel_rows)}")
    t_rest = time.perf_counter()
    rest_rows = rest_phase(smi, dataset, codes)
    print(f"[15] phase 15 took {time.perf_counter() - t_rest:.1f} s; {json.dumps(rest_rows)}")
    print(f"total {time.perf_counter() - t_start:.1f} s")

    def parallel_launches(route):  # phase 14's main-path launches, every rank's
        return sum(counts[route] for runs in parallel_rows["launches"].values()
                   for counts in (runs if isinstance(runs, list) else [runs]))

    def rest_launches(route):  # phase 15's launches: profile, viz, BLOCK, checked
        return sum(counts[route] for counts in rest_rows["launches"].values())

    def entry(name, source, route, mode, launches):
        row = main_rows[mode]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": "vqvae_tpu/ops/pallas_quantizer.py:93",
                "launches": launches, "max_abs_err": main_err[(mode, route)],
                "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"]}

    # each kernel at the main shape, in the mode of the paths that launch it;
    # its launches summed over those paths, each counted from zero
    kernels = [
        entry("nearest_code_mma", "vqvae_tpu_torch/csrc/nearest_code_mma.cu", "mma", "default",
              launches_main["mma"] + launches_bf16["mma"] + parallel_launches("mma") + rest_launches("mma")),
        entry("nearest_code", "vqvae_tpu_torch/csrc/nearest_code.cu", "fma", "highest",
              launches_rec["fma"] + launches_fp32["fma"] + launches_ema["fma"] + parallel_launches("fma")
              + rest_launches("fma")),
    ]
    check(all(k["launches"] > 0 for k in kernels), "a kernel of the path was never launched")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 3 and sys.argv[1] == "--rank-worker":
        worker = prior_rank_worker if sys.argv[3] == "train-prior" else rank_worker
        sys.exit(worker(sys.argv[2], sys.argv[3:]))
    sys.exit(main())
