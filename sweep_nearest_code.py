#!/usr/bin/env python3
"""Block shapes of the two nearest-code kernels, measured on one CUDA card.

    python3 sweep_nearest_code.py [fma] [ablate] [mma]

(all three parts when none is named). The port ships one block shape of each
kernel. This script compiles each source at its candidate shapes into a
temporary directory (``-D`` macros, all compilers started together) and times
them at D = 64; every shape must return the shipped shape's indices. The first
line is the card's name and power limit. Times are device times of a call in
ms (``chip_smoke.time_ms``: CUDA events over 50 calls queued behind a device
spin).

``fma``: ``vqvae_tpu_torch/csrc/nearest_code.cu`` (CUDA cores; shipped: 128
rows of z a block, 8 rows a thread, the depth staged 32 at a time) at
``-DVQ_BLOCK_ROWS`` x ``-DVQ_THREAD_ROWS`` x ``-DVQ_DEPTH_CHUNK`` (see
``FMA_SHAPES``), in ``highest``, over K = 128 ... 8,192 at N = 16,384 and
N = 2,048 ... 262,144 at K = 512: the registers and spills of each shape's
three kernels (``-Xptxas -v``), then one JSON line per (N, K).

``ablate``: where the CUDA-core kernel's time goes. Copies of the shipped
source with one part of the work taken out (``ABLATIONS``: text replacements,
each of which must match exactly once) are timed in ``highest`` at K = 512
and 1,024 (N = 16,384), and the difference, the cost of four more code tiles,
is printed as microseconds per tile. The copies return wrong indices; only
their times are read.

``mma``: ``vqvae_tpu_torch/csrc/nearest_code_mma.cu`` (tensor cores; shipped:
128 rows, two warps sharing a row's codes) at ``-DVQ_ROW_WARPS`` x
``-DVQ_CODE_SPLIT`` = 4x2, 4x1 and 2x2 (64 rows), in ``default`` and ``high``.
One JSON line per (mode, N, K) with, for each shape, the call's time and the
median device time in microseconds of its two kernels, the codebook prepare
and the search (``torch.profiler``). K at fixed N separates the fixed cost
from the cost per 128-code chunk; N at fixed K shows less than one wave, one
wave and several.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

import torch

from chip_smoke import time_ms
from vqvae_tpu_torch.ops import cuda_quantizer

SHAPES = ((4, 2), (4, 1), (2, 2))  # (VQ_ROW_WARPS, VQ_CODE_SPLIT), the shipped one first
K_AT_N = [(16_384, k) for k in (128, 256, 512, 1024, 2048, 4096)]
N_AT_K = [(n, 512) for n in (128, 2048, 16_896, 33_792, 65_536, 262_144)]
# (VQ_BLOCK_ROWS, VQ_THREAD_ROWS, VQ_DEPTH_CHUNK) of the CUDA-core kernel, the
# shipped one first; a block has 16 * rows / thread rows threads
FMA_SHAPES = ((128, 8, 32), (128, 8, 64), (128, 8, 16), (64, 8, 32), (64, 4, 32))
FMA_K_AT_N = [(16_384, k) for k in (128, 256, 512, 1024, 2048, 4096, 8192)]
FMA_N_AT_K = [(n, 512) for n in (2048, 8192, 16_384, 16_896, 32_768, 65_536, 262_144)]

# Parts of nearest_code.cu taken out, as (old text, new text) pairs.
_LOADS_OUT = [
    ("        load_fragment<MODE>(f1, zq, eq, 1);\n",
     "        if (q == 0) load_fragment<MODE>(f1, zq, eq, 1);\n"),
    ("        load_fragment<MODE>(f0, zq, eq, 2);\n", ""),
    ("        load_fragment<MODE>(f1, zq, eq, 3);\n", ""),
    ("        if (q + 1 < kPiecesPerRow) load_fragment<MODE>(f0, z_next, e_next, 0);\n", ""),
]
_FMAS_OUT = [  # 16 FMAs and 6 adds a depth step instead of 64 FMAs; every operand still used
    ("  for (int i = 0; i < kRowsPerThread; ++i)\n#pragma unroll\n"
     "    for (int jj = 0; jj < kCodesPerThread; ++jj) {\n",
     "  for (int i = 2; i < kRowsPerThread; ++i) acc[i][0] += f.a[0][i];\n#pragma unroll\n"
     "  for (int i = 0; i < 2; ++i)\n#pragma unroll\n"
     "    for (int jj = 0; jj < kCodesPerThread; ++jj) {\n"),
]
_STAGING_OUT = [  # only the second unit is staged; the barrier stays
    ("    if (more) {  // in flight under the FMAs\n",
     "    if (more && tile == 0 && chunk == 0) {\n"),
    ("    if (more) {\n      if (!resident) put_z(stage ^ 1, zv);\n",
     "    if (more && tile == 0 && chunk == 0) {\n      if (!resident) put_z(stage ^ 1, zv);\n"),
]
_ARGMIN_OUT = [  # only the last tile's scores are compared
    ("    if (chunk == chunks - 1) {\n      // The tile's scores are whole.",
     "    if (chunk == chunks - 1 && tile == tiles - 1) {\n      // The tile's scores are whole."),
]
ABLATIONS = {
    "shipped": [],
    "loads_out": _LOADS_OUT,
    "fmas_out": _FMAS_OUT,
    "staging_out": _STAGING_OUT,
    "argmin_out": _ARGMIN_OUT,
    "staging_argmin_out": _STAGING_OUT + _ARGMIN_OUT,
    "loads_staging_argmin_out": _LOADS_OUT + _STAGING_OUT + _ARGMIN_OUT,
    "fmas_staging_argmin_out": _FMAS_OUT + _STAGING_OUT + _ARGMIN_OUT,
}


def compile_all(jobs: dict, tmp: str) -> dict:
    """``jobs``: key -> (source path, extra nvcc arguments). Every source is
    compiled into a library of its own, all compilers started together;
    returns key -> (loaded library, the compiler's ``-Xptxas -v`` report)."""
    paths = {key: os.path.join(tmp, f"lib{i}.so") for i, key in enumerate(jobs)}
    procs = {
        key: subprocess.Popen([cuda_quantizer.nvcc_path(), *cuda_quantizer.NVCC_FLAGS, "-shared",
                               *defines, "-o", paths[key], str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for key, (src, defines) in jobs.items()
    }
    logs = {key: proc.communicate()[0] for key, proc in procs.items()}
    if any(proc.returncode != 0 for proc in procs.values()):
        raise SystemExit("sweep_nearest_code: nvcc failed\n" + "".join(logs.values()))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    libs = {}
    for key, path in paths.items():
        lib = ctypes.CDLL(path)
        if hasattr(lib, "vq_nearest_code_mma"):
            lib.vq_nearest_code_mma.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr]
            lib.vq_nearest_code_mma.restype = i32
        else:
            lib.vq_nearest_code.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr]
            lib.vq_nearest_code.restype = i32
        libs[key] = (lib, logs[key])
    return libs


def ablated_sources(tmp: str) -> dict:
    """The shipped CUDA-core source with each ablation applied, written into ``tmp``."""
    shipped = (cuda_quantizer.CSRC / "nearest_code.cu").read_text()
    jobs = {}
    for name, edits in ABLATIONS.items():
        text = shipped
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"ablation {name}: {old!r} matches {text.count(old)} times")
            text = text.replace(old, new)
        path = os.path.join(tmp, f"nearest_code_{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        jobs[name] = (path, [])
    return jobs


def search_fma(lib, z: torch.Tensor, cb: torch.Tensor, mode: str) -> torch.Tensor:
    """One call of a shape's CUDA-core library, as ``nearest_code_indices`` makes it."""
    (n, d), k = z.shape, cb.shape[0]
    idx = torch.empty((n,), dtype=torch.int32, device=z.device)
    err = lib.vq_nearest_code(z.data_ptr(), cb.data_ptr(), idx.data_ptr(), None, n, k, d,
                              cuda_quantizer.MODES[mode], torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"launch failed with CUDA error {err}")
    return idx


def search(lib, z: torch.Tensor, cb: torch.Tensor, mode: str) -> torch.Tensor:
    """One call of a shape's library, as ``cuda_quantizer.nearest_code_indices`` makes it."""
    (n, d), k = z.shape, cb.shape[0]
    idx = torch.empty((n,), dtype=torch.int32, device=z.device)
    scratch = torch.empty((cuda_quantizer.mma_scratch_bytes(k, d, mode),), dtype=torch.uint8,
                          device=z.device)
    err = lib.vq_nearest_code_mma(z.data_ptr(), cb.data_ptr(), idx.data_ptr(), None,
                                  scratch.data_ptr(),
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
    parts = sys.argv[1:] or ["fma", "ablate", "mma"]
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def inputs(n, k):
        return (torch.randn(n, 64, device=dev, generator=gen),
                torch.randn(k, 64, device=dev, generator=gen))

    with tempfile.TemporaryDirectory() as tmp:
        jobs = {}
        if "fma" in parts:
            for shape in FMA_SHAPES:
                jobs["fma", shape] = (cuda_quantizer.CSRC / "nearest_code.cu", [
                    "-DVQ_BLOCK_ROWS=%d" % shape[0], "-DVQ_THREAD_ROWS=%d" % shape[1],
                    "-DVQ_DEPTH_CHUNK=%d" % shape[2]])
        if "ablate" in parts:
            for name, job in ablated_sources(tmp).items():
                jobs["ablate", name] = job
        if "mma" in parts:
            for shape in SHAPES:
                jobs["mma", shape] = (cuda_quantizer.CSRC / "nearest_code_mma.cu", [
                    "-DVQ_ROW_WARPS=%d" % shape[0], "-DVQ_CODE_SPLIT=%d" % shape[1]])
        built = compile_all(jobs, tmp)

        if "fma" in parts:
            fma_libs = {shape: built["fma", shape][0] for shape in FMA_SHAPES}
            for shape in FMA_SHAPES:  # the three kernels of a shape, one per mode
                log = built["fma", shape][1]
                print(json.dumps({
                    "kernel": "fma", "shape": shape,
                    "registers": sorted(int(r) for r in re.findall(r"Used (\d+) registers", log)),
                    "spill_store_bytes": sum(int(b) for b in
                                             re.findall(r"(\d+) bytes spill stores", log)),
                }), flush=True)
            for n, k in FMA_K_AT_N + FMA_N_AT_K:
                z, cb = inputs(n, k)
                want = search_fma(fma_libs[FMA_SHAPES[0]], z, cb, "highest")
                row = {"kernel": "fma", "mode": "highest", "n": n, "k": k, "d": 64}
                for shape, lib in fma_libs.items():
                    fn = lambda: search_fma(lib, z, cb, "highest")
                    if not torch.equal(fn(), want):
                        raise SystemExit(f"fma shape {shape} disagrees with the shipped shape at {row}")
                    row["%dx%dx%d" % shape] = round(time_ms(fn), 5)
                print(json.dumps(row), flush=True)

        if "ablate" in parts:
            data = {k: inputs(16_384, k) for k in (512, 1024)}
            for name in ABLATIONS:
                lib = built["ablate", name][0]
                ms = {k: time_ms(lambda: search_fma(lib, z, cb, "highest"))
                      for k, (z, cb) in data.items()}
                print(json.dumps({
                    "kernel": "fma", "ablation": name, "mode": "highest", "n": 16_384, "d": 64,
                    "k512_ms": round(ms[512], 5), "k1024_ms": round(ms[1024], 5),
                    "us_per_tile": round(1e3 * (ms[1024] - ms[512]) / 4, 3)}), flush=True)

        if "mma" in parts:
            libs = {shape: built["mma", shape][0] for shape in SHAPES}
            for mode in ("default", "high"):
                for n, k in K_AT_N + N_AT_K:
                    z, cb = inputs(n, k)
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
