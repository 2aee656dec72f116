"""Another lowering of the encoder's k4/s2 convolutions, measured on the card
(counterpart of ``tools/bench_conv_strategy.py``).

    python -m vqvae_tpu_torch.bench.conv_strategy [--batch 256] [--dtype bfloat16] [--out F] [--device cpu]

A (k=4, s=2, p=1) convolution equals a space-to-depth(2) rearrangement
followed by a (k=2, s=1) VALID convolution over four times the channels:
the same multiply-adds, summed in another order. On the TPU the JAX tool
tried it to deepen the contraction the MXU sees; here it asks whether cuDNN
runs the (k=2, s=1) form over 4x the channels faster than the strided one.

``check_exact`` holds the rewrite against the standard convolution in fp32
with TF32 off (relative error < 1e-5, the JAX tool's bound). ``bench`` times
the two encoder k4/s2 convolutions (3 -> 64 and 64 -> 128, ReLU after each)
both ways at the serving configuration (bf16, batch 256), each call feeding
the next through the JAX tool's serial dependency: the wall time of a call by
the interleaved two-point rule (``us_per_call``, as the JAX tool reports it)
and, on the card, the card's time of a call behind a device spin
(``device_us_per_call``). Nothing in the port calls the rewrite: the JAX
package wired no flag for it either.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from vqvae_tpu_torch.bench import write_rows
from vqvae_tpu_torch.bench.timing import check, device_line, interleaved_two_point, sync_fn, time_ms
from vqvae_tpu_torch.device import resolve_device
from vqvae_tpu_torch.ops.conv import conv2d, conv_fp32_precision

EXACT_SHAPES = ((3, 64, 32), (64, 128, 16))  # (C_in, C_out, H = W), the encoder's two k4/s2 convs
EXACT_BATCH = 4
EXACT_REL_TOL = 1e-5
ITERS_LO, ITERS_HI, REPEATS = 100, 600, 9
DEVICE_ITERS = 20


def conv4s2_space_to_depth(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
                           precision: Optional[str] = None) -> torch.Tensor:
    """(k=4, s=2, p=1) conv as space-to-depth(2) + (k=2, s=1) VALID conv.

    x: (N, C, H, W) with H, W even; w: (F, C, 4, 4); output (N, F, H/2, W/2).
    Output pixel o reads padded input rows 2o .. 2o + 3, which are the two
    2 x 2 blocks o and o + 1: packed into channels in the order (ri, rj, c),
    the window is a VALID 2 x 2 conv over (H/2 + 1, W/2 + 1) blocks. The
    kernel is repacked to match, w[f, c, 2bi+ri, 2bj+rj] -> wb[f, (ri, rj, c),
    bi, bj] (the JAX tool's w[2bi+ri, 2bj+rj, c, f] -> wb[bi, bj, (ri, rj, c),
    f] in torch's OIHW layout).
    """
    n, c, h, wd = x.shape
    f = w.shape[0]
    xp = F.pad(x, (1, 1, 1, 1))
    hb, wb_ = (h + 2) // 2, (wd + 2) // 2
    xb = (xp.reshape(n, c, hb, 2, wb_, 2)          # (n, c, bi, ri, bj, rj)
          .permute(0, 3, 5, 1, 2, 4)               # (n, ri, rj, c, bi, bj)
          .reshape(n, 4 * c, hb, wb_))
    wb = (w.reshape(f, c, 2, 2, 2, 2)              # (f, c, bi, ri, bj, rj)
          .permute(0, 3, 5, 1, 2, 4)               # (f, ri, rj, c, bi, bj)
          .reshape(f, 4 * c, 2, 2))
    return conv2d(xb, wb, b, stride=1, padding=0, precision=precision)


def check_exact(device="cuda") -> dict:
    """The rewrite against ``conv2d(stride=2, padding=1)`` in fp32, TF32 off,
    on the JAX tool's inputs (the same numpy draws, NHWC turned NCHW); the
    largest error relative to the largest output, per shape. Raises above
    ``EXACT_REL_TOL``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    errors = {}
    with conv_fp32_precision("highest"):
        for c, f, hw in EXACT_SHAPES:
            x = torch.from_numpy(rng.normal(size=(EXACT_BATCH, hw, hw, c)).astype(np.float32))
            w = torch.from_numpy(rng.normal(size=(4, 4, c, f)).astype(np.float32))
            x, w = x.permute(0, 3, 1, 2).contiguous().to(dev), w.permute(3, 2, 0, 1).contiguous().to(dev)
            ref = conv2d(x, w, stride=2, padding=1, precision="highest")
            alt = conv4s2_space_to_depth(x, w, precision="highest")
            err = float((ref - alt).abs().max() / ref.abs().max())
            print(f"  c={c:3d} f={f:3d} hw={hw}: max rel err {err:.2e}", flush=True)
            check(err < EXACT_REL_TOL, f"space-to-depth rewrite is not numerically faithful: {err:.2e}")
            errors[f"c{c}_f{f}_hw{hw}"] = err
    return errors


def flops(batch: int) -> int:
    """The two convs' FLOP at ``batch`` (the JAX tool's count)."""
    return 2 * batch * (16 * 16 * 64 * 4 * 4 * 3 + 8 * 8 * 128 * 4 * 4 * 64)


def bench(batch: int = 256, dtype: str = "bfloat16", device="cuda", iters_lo: int = ITERS_LO,
          iters_hi: int = ITERS_HI, repeats: int = REPEATS) -> dict:
    """Both lowerings of the encoder's two k4/s2 convs: us a call on the wall
    (two-point) and, on the card, of card time."""
    dev = resolve_device(device)
    sync = sync_fn(dev)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    rng = np.random.default_rng(0)
    x0 = torch.from_numpy(rng.normal(size=(batch, 32, 32, 3)).astype(np.float32))
    w1 = torch.from_numpy((rng.normal(size=(4, 4, 3, 64)) * 0.1).astype(np.float32))
    w2 = torch.from_numpy((rng.normal(size=(4, 4, 64, 128)) * 0.1).astype(np.float32))
    x0 = x0.permute(0, 3, 1, 2).contiguous().to(dev, tdt)
    w1, w2 = (w.permute(3, 2, 0, 1).contiguous().to(dev, tdt) for w in (w1, w2))

    def std(z):
        h = F.relu(conv2d(z, w1, stride=2, padding=1))
        return F.relu(conv2d(h, w2, stride=2, padding=1))

    def s2d(z):
        return F.relu(conv4s2_space_to_depth(F.relu(conv4s2_space_to_depth(z, w1)), w2))

    rows = {}
    for name, fn in (("standard_k4s2", std), ("space_to_depth_k2s1", s2d)):
        # the output (B, 128, 8, 8) cannot feed (B, 3, 32, 32): a cheap
        # broadcast back to the input's shape keeps the serial dependency
        state = [x0]

        def call(fn=fn, state=state):
            z = state[0]
            state[0] = z + 1e-6 * fn(z).mean() * torch.ones_like(z)

        def run_timed(k: int) -> float:
            state[0] = x0
            sync()
            t0 = time.perf_counter()
            for _ in range(k):
                call()
            sync()
            return time.perf_counter() - t0

        with torch.inference_mode():
            run_timed(iters_lo)
            run_timed(iters_hi)
            dt = interleaved_two_point(run_timed, iters_lo, iters_hi, repeats)
            device_us = 1e3 * time_ms(call, iters=DEVICE_ITERS) if dev.type == "cuda" else None
        rows[name] = {"us_per_call": dt * 1e6, "eff_tflops": flops(batch) / dt / 1e12,
                      "device_us_per_call": device_us,
                      "device_eff_tflops": flops(batch) / device_us / 1e6 if device_us else None}
        print(f"{name:22s}: {dt * 1e6:9.1f} us on the wall, "
              f"{'%.1f' % device_us if device_us else 'not measured'} us of card "
              f"({rows[name]['eff_tflops']:.2f} eff TFLOP/s)", flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m vqvae_tpu_torch.bench.conv_strategy")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print("correctness (fp32, TF32 off):", flush=True)
    errors = check_exact(dev)
    rows = bench(args.batch, args.dtype, dev)
    std, s2d = rows["standard_k4s2"], rows["space_to_depth_k2s1"]
    write_rows({
        "experiment": "k4s2 conv lowering: standard vs space-to-depth (tools/bench_conv_strategy.py)",
        "batch": args.batch,
        "dtype": args.dtype,
        "backend": dev.type,
        "device": device_line(dev),
        "torch": torch.__version__,
        "exact_max_rel_err": errors,
        "rows": rows,
        "speedup_s2d": std["us_per_call"] / s2d["us_per_call"],
        "device_speedup_s2d": (std["device_us_per_call"] / s2d["device_us_per_call"]
                               if std["device_us_per_call"] else None),
    }, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
