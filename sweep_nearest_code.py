#!/usr/bin/env python3
"""Block shapes of the two nearest-code kernels, measured on one CUDA card.

    python3 sweep_nearest_code.py [fma] [ablate] [mma] [mma_ablate]

(all four parts when none is named). The port ships one block shape of each
kernel. This script compiles each source at its candidate shapes into a
temporary directory (``-D`` macros, all compilers started together) and times
them at D = 64 (the tensor-core kernel also at D = 256); every shape must
return the shipped shape's indices. The first line is the card's name and
power limit. Times are device times of a call in ms
(``vqvae_tpu_torch.bench.timing.time_ms``: CUDA events over 50 calls queued
behind a device spin).

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

``mma``: ``vqvae_tpu_torch/csrc/nearest_code_mma.cu`` (tensor cores, one
kernel a call: ``wgmma`` from shared memory, bulk-copied code tiles) at
``-DVQ_WARPGROUPS`` = 2 (128 rows a block, shipped) and 1 (64 rows), beside
the ``mma.sync`` kernel it replaced, kept as
``vqvae_tpu_torch/csrc/variants/nearest_code_mma_sync.cu`` (a prepare kernel
and a search kernel, at its shipped 128-row shape; D up to 128), in
``default`` and ``high``. First the registers, spills and compiler-injected
waits of each shape's kernels (``-Xptxas -v``); then one JSON line per
(mode, N, K, D), the kernels timed in turns (baseline, shapes, shapes,
baseline). The shapes must return the shipped shape's indices bit for bit;
the baseline may differ from them only at near-ties. N in {2,048, 16,384,
65,536} at K = 512 shows less than one wave, one wave and several; K at
N = 16,384 separates the fixed cost from the cost per code tile; D = 256
rows (no baseline) are the JAX tool's ``stress`` and ``stress_big``.

``mma_ablate``: where the tensor-core kernel's time goes. Copies of the
shipped source with one part of the work taken out (``MMA_ABLATIONS``: the
bulk copies after the first two tiles, the rounding of tiles after the first
two, the argmin but for one accumulator, the products) and the source with
a third fp32 stage in its copy ring (``-DVQ_RAW_STAGES=3``), timed in turns in
``default`` at the rows of ``MMA_ABLATION_ROWS``. The copies return wrong
indices; only their times are read.
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

from vqvae_tpu_torch.bench.timing import alternate, time_ms
from vqvae_tpu_torch.ops import cuda_quantizer

MMA_SHAPES = (2, 1)  # VQ_WARPGROUPS, the shipped one first
MMA_ROWS = ([(n, 512, 64) for n in (2048, 16_384, 65_536)]
            + [(16_384, k, 64) for k in (64, 4096)]
            + [(2048, 8192, 256), (65_536, 8192, 256)])
BASELINE = cuda_quantizer.CSRC / "variants" / "nearest_code_mma_sync.cu"
BASELINE_MAX_D = 128
MMA_ABLATION_ROWS = [(16_384, 512, 64), (65_536, 512, 64), (2048, 8192, 256), (65_536, 8192, 256)]
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
# Parts of nearest_code_mma.cu taken out, as (old text, new text) pairs.
_MMA_FETCH_OUT = [  # only the first kRawStages tiles are fetched (and waited for)
    ("    if (tid == 0 && c + 2 + kRawStages < tiles) fetch(c + 2 + kRawStages);\n", ""),
    ("    if (tid == 0 && kRawStages < tiles) fetch(kRawStages);\n", ""),
    ("    if (tid == 0 && kRawStages + 1 < tiles) fetch(kRawStages + 1);\n", ""),
    ("    mbar_wait(bars + 8 * s, (uint32_t)(c / kRawStages) & 1u);\n",
     "    if (c < kRawStages) mbar_wait(bars + 8 * s, (uint32_t)(c / kRawStages) & 1u);\n"),
]
_MMA_CONVERT_OUT = [  # tiles after the first two are waited for, not rounded
    ("    mbar_wait(bars + 8 * s, (uint32_t)(c / kRawStages) & 1u);\n",
     "    mbar_wait(bars + 8 * s, (uint32_t)(c / kRawStages) & 1u);\n    if (c >= 2) return;\n"),
]
_MMA_SEARCH_OUT = [  # one accumulator of a tile is still read, so its products stay
    ("      search<true>(c, cur);\n", "      best_v[0] = fminf(best_v[0], cur[0]);\n"),
    ("      search<false>(c, cur);\n", "      best_v[0] = fminf(best_v[0], cur[0]);\n"),
]
_MMA_WGMMA_OUT = [
    ("      Wgmma<TN>::mma(acc, smem_desc(a), smem_desc(b), ks > 0);\n", ""),
    ("        Wgmma<TN>::mma(acc, smem_desc(a), smem_desc(b + L::kTilePlane), 1);\n", ""),
    ("        Wgmma<TN>::mma(acc, smem_desc(a + L::kZPlane), smem_desc(b), 1);\n", ""),
]
MMA_ABLATIONS = {
    "shipped": [],
    "fetch_out": _MMA_FETCH_OUT,
    "convert_out": _MMA_CONVERT_OUT,
    "search_out": _MMA_SEARCH_OUT,
    "wgmma_out": _MMA_WGMMA_OUT,
    "convert_search_out": _MMA_CONVERT_OUT + _MMA_SEARCH_OUT,
    "fetch_convert_search_out": _MMA_FETCH_OUT[:3] + [
        ("    mbar_wait(bars + 8 * s, (uint32_t)(c / kRawStages) & 1u);\n",
         "    if (c < kRawStages) mbar_wait(bars + 8 * s, (uint32_t)(c / kRawStages) & 1u);\n"
         "    if (c >= 2) return;\n")] + _MMA_SEARCH_OUT,
}
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
        if os.path.basename(str(jobs[key][0])) == BASELINE.name:  # one more argument, its scratch
            lib.vq_nearest_code_mma.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr]
            lib.vq_nearest_code_mma.restype = i32
        elif hasattr(lib, "vq_nearest_code_mma"):
            lib.vq_nearest_code_mma.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr]
            lib.vq_nearest_code_mma.restype = i32
        else:
            lib.vq_nearest_code.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr]
            lib.vq_nearest_code.restype = i32
        libs[key] = (lib, logs[key])
    return libs


def ablated_sources(tmp: str, source: str = "nearest_code.cu", ablations: dict = ABLATIONS) -> dict:
    """A shipped source (the CUDA-core one by default) with each ablation
    applied, written into ``tmp``."""
    shipped = (cuda_quantizer.CSRC / source).read_text()
    jobs = {}
    for name, edits in ablations.items():
        text = shipped
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"ablation {name}: {old!r} matches {text.count(old)} times")
            text = text.replace(old, new)
        path = os.path.join(tmp, f"{source[:-3]}_{name}.cu")
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
    err = lib.vq_nearest_code_mma(z.data_ptr(), cb.data_ptr(), idx.data_ptr(), None, n, k, d,
                                  cuda_quantizer.MODES[mode],
                                  torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"launch failed with CUDA error {err}")
    return idx


def search_baseline(lib, z: torch.Tensor, cb: torch.Tensor, mode: str) -> torch.Tensor:
    """One call of the ``mma.sync`` baseline with the scratch it reads: ||e||^2
    (K fp32, padded to 4 values), the codebook as bf16 and, for ``high``, the
    bf16 of its remainder (allocated per call, as its wrapper did)."""
    (n, d), k = z.shape, cb.shape[0]
    idx = torch.empty((n,), dtype=torch.int32, device=z.device)
    nbytes = 4 * ((k + 3) // 4 * 4) + 2 * k * d * (2 if mode == "high" else 1)
    scratch = torch.empty((nbytes,), dtype=torch.uint8, device=z.device)
    err = lib.vq_nearest_code_mma(z.data_ptr(), cb.data_ptr(), idx.data_ptr(), None,
                                  scratch.data_ptr(), n, k, d, cuda_quantizer.MODES[mode],
                                  torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"launch failed with CUDA error {err}")
    return idx


def ptxas_report(log: str) -> dict:
    """Registers (least, most), spill-store bytes and compiler-injected
    wgmma waits over a library's kernels."""
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    return {"registers": [min(regs), max(regs)] if regs else None,
            "spill_store_bytes": sum(int(b) for b in re.findall(r"(\d+) bytes spill stores", log)),
            "injected_waits": log.count("C7517")}


def main() -> int:
    if not torch.cuda.is_available():
        print("sweep_nearest_code: no CUDA device is available", file=sys.stderr)
        return 1
    parts = sys.argv[1:] or ["fma", "ablate", "mma", "mma_ablate"]
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def inputs(n, k, d=64):
        return (torch.randn(n, d, device=dev, generator=gen),
                torch.randn(k, d, device=dev, generator=gen))

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
            for shape in MMA_SHAPES:
                jobs["mma", shape] = (cuda_quantizer.CSRC / "nearest_code_mma.cu",
                                      ["-DVQ_WARPGROUPS=%d" % shape])
            jobs["mma", "baseline"] = (BASELINE, [])
        if "mma_ablate" in parts:
            for name, job in ablated_sources(tmp, "nearest_code_mma.cu", MMA_ABLATIONS).items():
                jobs["mma_ablate", name] = job
            jobs["mma_ablate", "raw_stages_3"] = (cuda_quantizer.CSRC / "nearest_code_mma.cu",
                                                  ["-DVQ_RAW_STAGES=3"])
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
            from vqvae_tpu_torch.ops.quantizer import compare_assignments

            for key in [*MMA_SHAPES, "baseline"]:
                print(json.dumps({"kernel": "mma", "shape": key, **ptxas_report(built["mma", key][1])}),
                      flush=True)
            baseline = built["mma", "baseline"][0]
            for mode in ("default", "high"):
                for n, k, d in MMA_ROWS:
                    z, cb = inputs(n, k, d)
                    want = search(built["mma", MMA_SHAPES[0]][0], z, cb, mode)
                    row = {"mode": mode, "n": n, "k": k, "d": d}
                    fns = {}
                    if d <= BASELINE_MAX_D:
                        fns["mma_sync"] = lambda: search_baseline(baseline, z, cb, mode)
                        mism, near, _gap = compare_assignments(z, cb, fns["mma_sync"](), want, mode)
                        if mism != near:
                            raise SystemExit(f"the baseline departs beyond a near-tie at {row}")
                    for shape in MMA_SHAPES:
                        fns["%d_rows" % (64 * shape)] = (
                            lambda lib=built["mma", shape][0]: search(lib, z, cb, mode))
                        if not torch.equal(fns["%d_rows" % (64 * shape)](), want):
                            raise SystemExit(f"shape {shape} disagrees with the shipped shape at {row}")
                    row.update({name: round(ms, 5) for name, ms in alternate(fns).items()})
                    print(json.dumps(row), flush=True)

        if "mma_ablate" in parts:
            names = [*MMA_ABLATIONS, "raw_stages_3"]
            for name in names:
                print(json.dumps({"kernel": "mma", "ablation": name,
                                  **ptxas_report(built["mma_ablate", name][1])}), flush=True)
            for n, k, d in MMA_ABLATION_ROWS:
                z, cb = inputs(n, k, d)
                fns = {name: (lambda lib=built["mma_ablate", name][0]: search(lib, z, cb, "default"))
                       for name in names}
                row = {"kernel": "mma", "mode": "default", "n": n, "k": k, "d": d}
                row.update({name: round(ms, 5) for name, ms in alternate(fns).items()})
                print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
