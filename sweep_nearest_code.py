#!/usr/bin/env python3
"""Block shapes of the tensor-core nearest-code kernel, measured on one CUDA card.

    python3 sweep_nearest_code.py

The port ships one block shape of ``vqvae_tpu_torch/csrc/nearest_code_mma.cu``
(128 rows of z, two warps sharing a row's codes). This script compiles that
source three times into a temporary directory, with ``-DVQ_ROW_WARPS`` and
``-DVQ_CODE_SPLIT`` set to 4x2 (the shipped shape), 4x1 and 2x2 (64 rows), and
prints one JSON line per (mode, N, K) at D = 64 with, for each shape, the
device time of a call in ms (``chip_smoke.time_ms``: CUDA events over 50 calls
queued behind a device spin) and the median device time in microseconds of its
two kernels, the codebook prepare and the search (``torch.profiler``). K at
fixed N separates the fixed cost from the cost per 128-code chunk; N at fixed
K shows less than one wave, one wave and several. Every shape must return the
shipped shape's indices. The first line is the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

import torch

from chip_smoke import time_ms
from vqvae_tpu_torch.ops import cuda_quantizer

SHAPES = ((4, 2), (4, 1), (2, 2))  # (VQ_ROW_WARPS, VQ_CODE_SPLIT), the shipped one first
K_AT_N = [(16_384, k) for k in (128, 256, 512, 1024, 2048, 4096)]
N_AT_K = [(n, 512) for n in (128, 2048, 16_896, 33_792, 65_536, 262_144)]


def build_shapes(tmp: str) -> dict:
    """One library per block shape, all compiled together."""
    src = str(cuda_quantizer.CSRC / "nearest_code_mma.cu")
    paths = {shape: os.path.join(tmp, "mma_%dx%d.so" % shape) for shape in SHAPES}
    procs = [
        subprocess.Popen([cuda_quantizer.nvcc_path(), *cuda_quantizer.NVCC_FLAGS[:-2], "-shared",
                          f"-DVQ_ROW_WARPS={rw}", f"-DVQ_CODE_SPLIT={cs}", "-o", paths[rw, cs], src])
        for rw, cs in SHAPES
    ]
    if any(proc.wait() != 0 for proc in procs):
        raise SystemExit("sweep_nearest_code: nvcc failed")
    libs = {}
    for shape, path in paths.items():
        lib = ctypes.CDLL(path)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.vq_nearest_code_mma.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr]
        lib.vq_nearest_code_mma.restype = i32
        libs[shape] = lib
    return libs


def search(lib, z: torch.Tensor, cb: torch.Tensor, mode: str) -> torch.Tensor:
    """One call of a shape's library, as ``cuda_quantizer.nearest_code_indices`` makes it."""
    (n, d), k = z.shape, cb.shape[0]
    idx = torch.empty((n,), dtype=torch.int32, device=z.device)
    scratch = torch.empty((cuda_quantizer.mma_scratch_bytes(k, d, mode),), dtype=torch.uint8,
                          device=z.device)
    err = lib.vq_nearest_code_mma(z.data_ptr(), cb.data_ptr(), idx.data_ptr(), scratch.data_ptr(),
                                  n, k, d, cuda_quantizer.MODES[mode],
                                  torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"launch failed with CUDA error {err}")
    return idx


def kernel_us(fn, iters: int = 30) -> dict:
    """Median device time (us) of the prepare and the search kernel over ``iters`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    spans = {"prepare": [], "search": []}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            for key, tag in (("prepare", "prepare_codebook"), ("search", "nearest_code_mma")):
                if tag in e.name:
                    spans[key].append(e.time_range.elapsed_us())
    return {f"{key}_us": round(sorted(v)[len(v) // 2], 2) for key, v in spans.items() if v}


def main() -> int:
    if not torch.cuda.is_available():
        print("sweep_nearest_code: no CUDA device is available", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_shapes(tmp)
        for mode in ("default", "high"):
            for n, k in K_AT_N + N_AT_K:
                z = torch.randn(n, 64, device=dev, generator=gen)
                cb = torch.randn(k, 64, device=dev, generator=gen)
                want = search(libs[SHAPES[0]], z, cb, mode)
                row = {"mode": mode, "n": n, "k": k, "d": 64}
                for shape, lib in libs.items():
                    fn = lambda: search(lib, z, cb, mode)
                    if not torch.equal(fn(), want):
                        raise SystemExit(f"shape {shape} disagrees with the shipped shape at {row}")
                    row["%dx%d" % (32 * shape[0], shape[1])] = {
                        "ms": round(time_ms(fn), 5), **kernel_us(fn)}
                print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
