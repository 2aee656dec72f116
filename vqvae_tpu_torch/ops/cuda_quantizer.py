"""Wrapper of the hand-written CUDA nearest-code kernels (``csrc/*.cu``).

The counterpart of ``vqvae_tpu/ops/pallas_quantizer.py``. Two kernels compute
the same function, and ``kernel_route`` picks one from (precision, D) alone:

``"mma"``  ``csrc/nearest_code_mma.cu``: the products on the tensor cores
           (``mma.sync`` on bf16 operands, fp32 sums). Takes ``default`` and
           ``high`` with D a multiple of 16 up to ``MMA_MAX_D``. A call is a
           small prepare kernel over the codebook and the search kernel.
``"fma"``  ``csrc/nearest_code.cu``: fp32 FMAs on the CUDA cores, 8 x 8 scores a
           thread. Takes every mode and every depth: it walks the depth in
           chunks, and a block keeps its rows of z in shared memory where all
           their chunks fit and stages them chunk by chunk where they do not
           (``fma_smem_bytes``). Serves ``highest`` and what ``"mma"`` does
           not take.

The sources are built with ``nvcc`` at first use, into ``build/kernels/`` at
the repository root, as one shared library with a plain C interface loaded
through ``ctypes``. Nothing is compiled or loaded at import: the CPU tests
import this module on machines without ``nvcc``.

NaN scores. Both kernels start each row from (+inf, code 0) and take a
score only when it is strictly less than the best so far, so a NaN score is
never chosen: the kernels skip a NaN code and keep the rest of its tile, and
a row whose scores are all NaN (a NaN in z) gets code 0. The plain version
(``ops/quantizer.py::nearest_code_torch``, the CPU path) follows
``torch.argmin``, which returns the first NaN: a NaN codebook row takes every
row. The JAX package has two rules of its own: ``jnp.argmin`` returns the
first NaN, and its Pallas kernel skips the whole code tile whose minimum is
NaN (``pallas_quantizer.py:123``). Such scores arise only in a run that has
already diverged; ``tests/test_torch_cuda_kernel.py`` pins the rule.

``launches`` counts calls that launched a kernel and ``launches_by_route``
splits it by route, so a run can show that its main path went through a
kernel; only ``nearest_code_indices`` adds to them (one per call, also where
the call is two kernels).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
MODES = {"highest": 0, "high": 1, "default": 2}
ROUTES = ("mma", "fma")
# Largest dynamic shared memory a block may use on Hopper (227 KB).
MAX_SMEM_BYTES = 232_448
# The tensor-core kernel holds a warp's rows of z in registers: D / 16 depth
# steps of 8 registers ("high": 16), so its depth is capped.
MMA_MAX_D = 128
# The CUDA-core kernel's tile, as ``csrc/nearest_code.cu`` fixes it: rows of z a
# block owns, codes per tile, depths staged per chunk.
FMA_BLOCK_ROWS = 128
FMA_TILE_CODES = 128
FMA_DEPTH_CHUNK = 32

launches = 0
launches_by_route = {route: 0 for route in ROUTES}
build_log = ""
_lib = None


def reset_launch_counts() -> None:
    global launches
    launches = 0
    for route in ROUTES:
        launches_by_route[route] = 0


def kernel_route(precision: str, d: int) -> str:
    """Which kernel serves (precision, D): a pure function, decided here only."""
    if precision not in MODES:
        raise ValueError(f"precision must be one of {sorted(MODES)}, got {precision!r}")
    if precision != "highest" and d % 16 == 0 and 16 <= d <= MMA_MAX_D:
        return "mma"
    return "fma"


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def sources(csrc: Path = CSRC) -> list:
    return sorted(csrc.glob("*.cu"))


def source_digest(csrc: Path = CSRC, flags: Tuple[str, ...] = NVCC_FLAGS) -> str:
    """Hash of every file under ``csrc`` (name and bytes) and of the flags."""
    h = hashlib.sha256(" ".join(flags).encode())
    for path in sorted(p for p in csrc.rglob("*") if p.is_file()):
        h.update(path.relative_to(csrc).as_posix().encode() + b"\0")
        h.update(path.read_bytes() + b"\0")
    return h.hexdigest()


def build() -> Path:
    """Compile the kernel library (once per sources and flags) and return its path.

    Every source is compiled by its own ``nvcc``, all started together, and
    the objects are linked into one library. The ``-Xptxas -v`` reports
    (registers, shared memory, spills) are kept in ``build_log``.
    """
    global build_log
    lib_path = BUILD_DIR / f"libnearest_code_{source_digest(CSRC, NVCC_FLAGS)[:16]}.so"
    if lib_path.exists():
        build_log = f"(cached) {lib_path}"
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objects = [os.path.join(tmp, src.stem + ".o") for src in sources()]
        procs = [
            subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources(), objects)
        ]
        logs = [proc.communicate()[0] for proc in procs]
        build_log = "".join(logs)
        for src, proc in zip(sources(), procs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} ({proc.returncode}):\n{build_log}")
        out = os.path.join(tmp, "lib.so")
        link = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", out, *objects],
                              capture_output=True, text=True)
        build_log += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError(f"nvcc failed to link ({link.returncode}):\n{build_log}")
        os.replace(out, lib_path)
    return lib_path


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.vq_nearest_code.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, ptr]
        lib.vq_nearest_code.restype = i32
        lib.vq_nearest_code_mma.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr]
        lib.vq_nearest_code_mma.restype = i32
        lib.vq_empty_kernel.argtypes = [ptr]
        lib.vq_empty_kernel.restype = i32
        lib.vq_error_string.argtypes = [i32]
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


def resolve_route(route: Optional[str], precision: str, d: int) -> str:
    """The route a call takes: ``kernel_route`` for None, else the route asked
    for, which raises ``ValueError`` where the mode or the depth rules it out."""
    picked = kernel_route(precision, d)
    if route is None:
        return picked
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES} or None, got {route!r}")
    if route == "mma" and picked != "mma":
        raise ValueError(
            f"the mma route takes 'default' and 'high' with D a multiple of 16 up to "
            f"{MMA_MAX_D}, not precision {precision!r} with D = {d}"
        )
    return route


def mma_scratch_bytes(k: int, d: int, precision: str) -> int:
    """Scratch of one tensor-core call, laid out as ``nearest_code_mma.cu`` reads
    it: ||e||^2 (K fp32, padded to a multiple of 4), then the codebook as bf16
    and, for ``high``, the bf16 of its remainder."""
    return 4 * ((k + 3) // 4 * 4) + 2 * k * d * (2 if precision == "high" else 1)


def fma_smem_bytes(d: int, precision: str) -> int:
    """Dynamic shared memory of one block of the CUDA-core kernel at depth D,
    as ``nearest_code.cu`` reckons it (``Layout`` and ``launch``). A slot holds
    one depth chunk, depth-major (``high``: a hi and a lo plane). The block has
    two slots of code chunks that take turns, ||e||^2 of two code tiles, and
    for z either a slot for every chunk of the depth (z resident, where that
    fits in ``MAX_SMEM_BYTES``) or two that take turns. No depth is refused:
    beyond the resident envelope the figure stops growing."""
    if precision not in MODES:
        raise ValueError(f"precision must be one of {sorted(MODES)}, got {precision!r}")
    if d < 1:
        raise ValueError(f"embedding depth must be positive, got {d}")
    planes = 2 if precision == "high" else 1
    z_slot = planes * FMA_DEPTH_CHUNK * FMA_BLOCK_ROWS
    e_slot = planes * FMA_DEPTH_CHUNK * FMA_TILE_CODES

    def nbytes(z_slots: int) -> int:
        return 4 * (z_slots * z_slot + 2 * e_slot + 2 * FMA_TILE_CODES)

    chunks = -(-d // FMA_DEPTH_CHUNK)
    resident = chunks <= (MAX_SMEM_BYTES - nbytes(0)) // (4 * z_slot)
    return nbytes(chunks if resident else 2)


def _raise_on(err: int, lib, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: {lib.vq_error_string(err).decode()}")


def nearest_code_indices(
    z_flat: torch.Tensor, codebook: torch.Tensor, precision: str = "highest",
    route: Optional[str] = None,
) -> torch.Tensor:
    """Launch a kernel: (N, D), (K, D) fp32 CUDA -> (N,) int32 nearest-code indices.

    ``route`` None takes ``kernel_route(precision, D)``; an explicit route that
    the mode or the depth does not allow raises ``ValueError``.
    """
    global launches
    _check_inputs(z_flat, codebook, precision)
    n, d = z_flat.shape
    k = codebook.shape[0]
    route = resolve_route(route, precision, d)
    if route == "mma" and z_flat.data_ptr() % 8:
        raise ValueError("the mma route reads z_flat in 8-byte pairs: its storage is misaligned")
    idx = torch.empty((n,), dtype=torch.int32, device=z_flat.device)
    if n == 0:
        return idx
    lib = _library()
    mode = MODES[precision]
    with torch.cuda.device(z_flat.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route == "mma":
            scratch = torch.empty(
                (mma_scratch_bytes(k, d, precision),), dtype=torch.uint8, device=z_flat.device,
            )
            err = lib.vq_nearest_code_mma(
                z_flat.data_ptr(), codebook.data_ptr(), idx.data_ptr(), scratch.data_ptr(),
                n, k, d, mode, stream,
            )
        else:
            err = lib.vq_nearest_code(
                z_flat.data_ptr(), codebook.data_ptr(), idx.data_ptr(), n, k, d, mode, stream,
            )
    _raise_on(err, lib, f"nearest_code {route} kernel")
    launches += 1
    launches_by_route[route] += 1
    return idx


def nearest_code_cuda(
    z_flat: torch.Tensor, codebook: torch.Tensor, precision: str = "highest",
    route: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, D), (K, D) -> (z_q (N, D), indices (N,) int32) on the card.

    The row gather is an exact ``index_select`` outside the kernel, as the
    JAX wrapper gathers with ``jnp.take`` (pallas_quantizer.py:250).
    """
    idx = nearest_code_indices(z_flat, codebook, precision, route)
    return codebook.index_select(0, idx), idx


def launch_empty_kernel() -> None:
    """Launch a kernel that does nothing on the current device's current
    stream: the launch floor that the smoke script times beside the kernels'
    bounds."""
    lib = _library()
    with torch.cuda.device(torch.cuda.current_device()):
        err = lib.vq_empty_kernel(torch.cuda.current_stream().cuda_stream)
    _raise_on(err, lib, "empty kernel")


__all__ = [
    "build", "fma_smem_bytes", "kernel_route", "launch_empty_kernel", "launches", "launches_by_route",
    "mma_scratch_bytes", "nearest_code_cuda", "nearest_code_indices", "reset_launch_counts", "resolve_route",
    "source_digest",
]
