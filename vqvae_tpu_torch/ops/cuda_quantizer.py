"""Wrapper of the hand-written CUDA nearest-code kernel (``csrc/nearest_code.cu``).

The counterpart of ``vqvae_tpu/ops/pallas_quantizer.py``. The kernel is
built from the repository's source with ``nvcc`` at first use, into
``build/kernels/`` at the repository root, as a shared library with a plain C
interface loaded through ``ctypes``. Nothing is compiled or loaded at import:
the CPU tests import this module on machines without ``nvcc``.

``launches`` counts the kernel's launches, so a run can show that its main
path went through the kernel; only ``nearest_code_indices`` adds to it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Tuple

import torch

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "nearest_code.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
MODES = {"highest": 0, "high": 1, "default": 2}
# Largest dynamic shared memory a block may use on Hopper (227 KB).
MAX_SMEM_BYTES = 232_448

launches = 0
build_log = ""
_lib = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def build() -> Path:
    """Compile the kernel library (once per source and flags) and return its path.

    The ``-Xptxas -v`` report (registers, shared memory, spills) is kept in
    ``build_log``.
    """
    global build_log
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    lib_path = BUILD_DIR / f"libnearest_code_{digest[:16]}.so"
    if lib_path.exists():
        build_log = f"(cached) {lib_path}"
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
    os.close(fd)
    try:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib_path


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.vq_nearest_code.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.vq_nearest_code.restype = ctypes.c_int
        lib.vq_nearest_code_smem_bytes.argtypes = [ctypes.c_int]
        lib.vq_nearest_code_smem_bytes.restype = ctypes.c_size_t
        lib.vq_error_string.argtypes = [ctypes.c_int]
        lib.vq_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check_inputs(z_flat: torch.Tensor, codebook: torch.Tensor, precision: str) -> None:
    if precision not in MODES:
        raise ValueError(f"precision must be one of {sorted(MODES)}, got {precision!r}")
    for name, t in (("z_flat", z_flat), ("codebook", codebook)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if z_flat.device != codebook.device:
        raise ValueError(f"z_flat on {z_flat.device}, codebook on {codebook.device}")
    if z_flat.shape[1] != codebook.shape[1]:
        raise ValueError(
            f"depth mismatch: z_flat {tuple(z_flat.shape)}, codebook {tuple(codebook.shape)}"
        )
    if codebook.shape[0] == 0:
        raise ValueError("codebook is empty")
    if max(z_flat.shape[0], codebook.shape[0]) >= 2**31:
        raise ValueError("N and K must fit in int32")


def nearest_code_indices(
    z_flat: torch.Tensor, codebook: torch.Tensor, precision: str = "highest"
) -> torch.Tensor:
    """Launch the kernel: (N, D), (K, D) fp32 CUDA -> (N,) int32 nearest-code indices."""
    global launches
    _check_inputs(z_flat, codebook, precision)
    n, d = z_flat.shape
    k = codebook.shape[0]
    idx = torch.empty((n,), dtype=torch.int32, device=z_flat.device)
    if n == 0:
        return idx
    lib = _library()
    if lib.vq_nearest_code_smem_bytes(d) > MAX_SMEM_BYTES:
        raise ValueError(f"embedding depth {d} needs more shared memory than a block has")
    with torch.cuda.device(z_flat.device):
        err = lib.vq_nearest_code(
            z_flat.data_ptr(), codebook.data_ptr(), idx.data_ptr(),
            n, k, d, MODES[precision], torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"nearest_code kernel launch failed: {lib.vq_error_string(err).decode()}"
        )
    launches += 1
    return idx


def nearest_code_cuda(
    z_flat: torch.Tensor, codebook: torch.Tensor, precision: str = "highest"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, D), (K, D) -> (z_q (N, D), indices (N,) int32) on the card.

    The row gather is an exact ``index_select`` outside the kernel, as the
    JAX wrapper gathers with ``jnp.take`` (pallas_quantizer.py:250).
    """
    idx = nearest_code_indices(z_flat, codebook, precision)
    return codebook.index_select(0, idx), idx


__all__ = ["build", "nearest_code_cuda", "nearest_code_indices", "launches"]
