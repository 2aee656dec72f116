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
   which TF32 in a backward conv would break), and the same 5 updates run
   twice show how far atomics let two runs part;
8. training in bf16 / "default" (20 updates, 20 launches of the "mma" kernel)
   and with an EMA codebook in fp32 (20 updates, 20 "fma" launches; the EMA
   counts must sum to 16,384 * (1 - 0.99^20) and the codebook equal
   means / smoothed counts);
9. times of a train step (batch 32 and 256 in fp32, 256 in bf16), of the
   optimizer update, the scatter-add backward and the EMA update alone, and a
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
   one wave. Phases 10 to 12 launch neither nearest-code kernel.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``. Without a CUDA device, or outside the
repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

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
# device items of a profile by the first group whose key their name holds
DEVICE_ITEM_GROUPS = (
    ("hand-written kernels", ("nearest_code", "prepare_codebook")),
    ("copies", ("Memcpy", "Memset")),
    ("cuDNN layout conversions", ("nhwcToNchw", "nchwToNhwc")),
    ("optimizer (foreach)", ("multi_tensor_apply",)),
    ("scatter-add, gathers", ("indexFunc", "index_", "gather", "scatter")),
    ("convolutions (cuDNN, cuBLAS)", ("fprop", "dgrad", "wgrad", "winograd", "gemm", "convolve",
                                      "cudnn", "cutlass", "nvjet")),
)
TRAIN_BATCH = 256                     # a train step of 16,384 rows
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


def profile_device(tag: str, what: str, fn, top: int = 12) -> None:
    """torch.profiler over ``fn()``: device time by kernel, the share of the
    wall time in which the card ran anything (kernels and copies, overlaps
    merged), the hand-written kernels' share and the number of
    device-to-host copies. The profiler's own cost is in the wall time, so
    the busy share is a lower bound."""
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
        return
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
    from vqvae_tpu_torch.pipelines.extract import extract_latents
    from vqvae_tpu_torch.pipelines.viz import load_model, reconstruct
    from vqvae_tpu_torch.train.vqvae_train import VQVAETrainer, metrics_to_host, train_vqvae

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

    # atomics: the same 5 updates twice from the same state
    idx5 = np.stack([np.arange(i * TRAIN_BATCH, (i + 1) * TRAIN_BATCH) for i in range(5)])
    finals = []
    for _ in range(2):
        st = trainer7.init_state(torch.Generator().manual_seed(11))
        st, m5 = trainer7.steps_by_index(st, idx5)
        finals.append(([p.detach().clone() for p in st.model.parameters()], metrics_to_host(m5)))
    diff = max(float((a - b).abs().max()) for a, b in zip(finals[0][0], finals[1][0]))
    dloss = float(np.abs(finals[0][1]["loss"] - finals[1][1]["loss"]).max())
    print(f"[7] the same 5 updates twice from the same state (batch {TRAIN_BATCH}): largest parameter "
          f"difference {diff:.3g}, largest loss difference {dloss:.3g} (index_add_ adds with atomics)")

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
    for name, idx in (("uniform over 512 codes", spread), ("4 codes", narrow),
                      (f"a fresh model's assignments, {len(torch.unique(real))} codes", real)):
        t_scatter = time_ms(lambda: acc.zero_().index_add_(0, idx, g))
        print(f"[9] scatter-add backward alone, zero + index_add_ of ({n}, {d}) into ({k}, {d}), "
              f"indices {name}: {t_scatter:.5f} ms")
    ema_trainer, ema_state, _x, ema_step = step_timer(vq_ema, TRAIN_BATCH)
    ema_step()
    with torch.no_grad():
        z9 = ema_state.model.encode(x9)
        q_ema = ema_state.model.quantize(z9)
    t_ema = time_ms(lambda: ema_trainer._ema_update(ema_state, z9, q_ema), queue_ahead=False)
    print(f"[9] EMA update alone (sums by index_add_, decay, smoothing, codebook overwrite) at "
          f"({n}, {k}, {d}): {t_ema:.5f} ms a call at the host's pace")
    print(f"[9] card: {smi}; train-step times from CUDA events around 30 steps after 10 warm-up, "
          f"no spin, the faster of two turns; host_queue_ms is the host clock around 30 steps "
          f"with nothing awaited, the faster of two turns")
    idx20 = np.stack([np.arange(i * TRAIN_BATCH, (i + 1) * TRAIN_BATCH) for i in range(20)])
    trainer9.stage_dataset(train.data)
    trainer9.steps_by_index(state9, idx20[:5])
    profile_device("9", f"20 train steps at batch {TRAIN_BATCH}, fp32/highest, steps_by_index",
                   lambda: trainer9.steps_by_index(state9, idx20), top=24)
    t_prior = time.perf_counter()
    prior_rows = sampling_phases(dev, smi)
    print(f"[12] phases 10-12 took {time.perf_counter() - t_prior:.1f} s; {json.dumps(prior_rows)}")
    print(f"total {time.perf_counter() - t_start:.1f} s")

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
              launches_main["mma"] + launches_bf16["mma"]),
        entry("nearest_code", "vqvae_tpu_torch/csrc/nearest_code.cu", "fma", "highest",
              launches_rec["fma"] + launches_fp32["fma"] + launches_ema["fma"]),
    ]
    check(all(k["launches"] > 0 for k in kernels), "a kernel of the path was never launched")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
