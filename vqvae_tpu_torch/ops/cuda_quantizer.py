"""Wrapper of the hand-written CUDA nearest-code kernels (``csrc/*.cu``).

The counterpart of ``vqvae_tpu/ops/pallas_quantizer.py``. Two kernels compute
the same function, and ``kernel_route`` picks one from (precision, D) alone:

``"mma"``  ``csrc/nearest_code_mma.cu``: the products on the tensor cores
           (``wgmma`` on bf16 operands read from shared memory, fp32 sums).
           Takes ``default`` and ``high`` with D a multiple of 16 up to
           ``MMA_MAX_D``. A call is one kernel; each block rounds the code
           tiles it multiplies (``mma_smem_bytes``), so nothing is allocated
           besides the outputs.
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
a row whose scores are all NaN (a NaN in z) gets code 0. This is the rule of
every impl on the card: the matmul branch
(``ops/quantizer.py::nearest_code_matmul``, "jnp", and "auto" where the
measured rule sends a shape to it) turns NaN scores into +inf before its
argmin and gives the same codes. The plain version
(``ops/quantizer.py::nearest_code_torch``, the CPU path under every impl)
follows ``torch.argmin``, which returns the first NaN: a NaN codebook row
takes every row, as ``jnp.argmin`` does in the JAX package's CPU path. The
JAX package's Pallas kernel has a rule of its own: it skips the whole code
tile whose minimum is NaN (``pallas_quantizer.py:123``). Such scores arise
only in a run that has already diverged; ``tests/test_torch_cuda_kernel.py``
and ``tests/test_torch_auto_impl.py`` pin the rules.

Best values. On request (``nearest_code_indices(..., values=True)``) either
kernel also writes each row's winning score, the float it compared:
||e||^2 - 2 z.e in the mode's arithmetic, +inf for a row that never took a
score. A codebook-parallel combine (``parallel/code_parallel.py``) holds
these against the other shards' minima; a score recomputed from the gathered
row would sum in another order and could flip a tie across shards. Without
the request the kernels get a null pointer and do what they did before.

``launches`` counts calls that launched a kernel and ``launches_by_route``
splits it by route, so a run can show that its main path went through a
kernel; only ``nearest_code_indices`` adds to them (one per call).
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
# The tensor-core kernel's block, as ``csrc/nearest_code_mma.cu`` fixes it:
# warpgroups (64 rows of z each), bf16 code tiles and fp32 code stages in its
# rings, the alignment of its swizzled operand tiles; the deepest D it takes
# (its rows of z sit in shared memory, which the deepest "high" layout fills).
MMA_WARPGROUPS = 2
MMA_TILE_STAGES = 3
MMA_RAW_STAGES = 2
MMA_ATOM_ALIGN = 1024
MMA_MAX_D = 256
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
        lib.vq_nearest_code.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr]
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


def _mma_layout_bytes(d: int, planes: int, tile_codes: int) -> int:
    atoms = -(-d // 64)  # 128-byte swizzle atoms of 64 bf16 depths
    rows = 64 * MMA_WARPGROUPS
    return (planes * atoms * 128 * rows                           # the block's rows of z
            + MMA_TILE_STAGES * planes * atoms * 128 * tile_codes  # bf16 code tiles
            + MMA_RAW_STAGES * tile_codes * d * 4                  # fp32 code tiles
            + MMA_TILE_STAGES * tile_codes * 4                     # their ||e||^2
            + MMA_RAW_STAGES * 8                                   # one mbarrier a stage
            + MMA_ATOM_ALIGN)                                      # slack to align the base


def mma_tile_codes(d: int, precision: str) -> int:
    """Codes in one tile of the tensor-core kernel at depth D: 64, or 32 / 16
    where a deep layout would not fit (``tile_codes`` in the source)."""
    planes = 2 if precision == "high" else 1
    for codes in (64, 32):
        if _mma_layout_bytes(d, planes, codes) <= MAX_SMEM_BYTES:
            return codes
    return 16


def mma_smem_bytes(d: int, precision: str) -> int:
    """Dynamic shared memory of one block of the tensor-core kernel at depth D,
    as ``nearest_code_mma.cu`` reckons it (``Layout``, ``tile_codes``): the
    block's rows of z as bf16 (``high``: a hi and a lo plane) in 128-byte
    swizzle atoms of 64 depths, three bf16 code tiles, two fp32 code tiles as
    the bulk copies land them, ||e||^2 of each bf16 tile, one mbarrier per
    fp32 tile and 1,024 bytes that align the base. Only the "mma" route's
    modes and depths have a figure."""
    if resolve_route("mma", precision, d) != "mma":
        raise ValueError(f"no mma layout for precision {precision!r} at D = {d}")
    return _mma_layout_bytes(d, 2 if precision == "high" else 1, mma_tile_codes(d, precision))


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
    route: Optional[str] = None, values: bool = False,
):
    """Launch a kernel: (N, D), (K, D) fp32 CUDA -> (N,) int32 nearest-code indices,
    or with ``values`` (indices, (N,) fp32 winning scores).

    ``route`` None takes ``kernel_route(precision, D)``; an explicit route that
    the mode or the depth does not allow raises ``ValueError``.
    """
    global launches
    _check_inputs(z_flat, codebook, precision)
    n, d = z_flat.shape
    k = codebook.shape[0]
    route = resolve_route(route, precision, d)
    if route == "mma":
        if z_flat.data_ptr() % 16 or codebook.data_ptr() % 16:
            raise ValueError("the mma route reads z_flat and codebook in 16-byte pieces: "
                             "a storage is misaligned")
        if mma_smem_bytes(d, precision) > MAX_SMEM_BYTES:
            raise ValueError(f"the mma layout at D = {d} exceeds {MAX_SMEM_BYTES} bytes")
    idx = torch.empty((n,), dtype=torch.int32, device=z_flat.device)
    best = torch.empty((n,), dtype=torch.float32, device=z_flat.device) if values else None
    if n == 0:
        return (idx, best) if values else idx
    best_ptr = best.data_ptr() if values else None
    lib = _library()
    mode = MODES[precision]
    with torch.cuda.device(z_flat.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route == "mma":
            err = lib.vq_nearest_code_mma(
                z_flat.data_ptr(), codebook.data_ptr(), idx.data_ptr(), best_ptr, n, k, d, mode,
                stream,
            )
        else:
            err = lib.vq_nearest_code(
                z_flat.data_ptr(), codebook.data_ptr(), idx.data_ptr(), best_ptr, n, k, d, mode,
                stream,
            )
    _raise_on(err, lib, f"nearest_code {route} kernel")
    launches += 1
    launches_by_route[route] += 1
    return (idx, best) if values else idx


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
    "mma_smem_bytes", "mma_tile_codes", "nearest_code_cuda", "nearest_code_indices", "reset_launch_counts", "resolve_route",
    "source_digest",
]
