"""Wrapper of the hand-written weight-gradient kernel (``csrc/conv_wgrad.cu``).

The fp32 weight gradient of a 2-D convolution, or of a transposed one, on
the CUDA cores, as an implicit GEMM with a deterministic split of K in one
launch (the source says how). ``ops/conv.py`` routes every fp32 "highest"
training convolution's weight gradient here (``conv.wgrad_route``); cuDNN
keeps the forward and the data gradient.

``weight_grad(a, b, kh, kw, stride, padding, keep)`` computes
``dW[m, c, r, s] = sum over (n, p, q) of a[n, m, p, q] * b[n, c, p*sh - ph + r,
q*sw - pw + s]`` over the positions p < keep[0], q < keep[1] of a: for a
convolution a is the output's gradient and b the input; for a transposed
convolution a is the input and b the output's gradient. Its plain version,
for CPU tensors and the tests, is ``conv.plain_wgrad``.

The tile of dW a block owns, the number of slices of K and their grouping
come from the shape alone (``plan``), so a shape is summed in one fixed
order on every call. The workspace of partial tiles and the counters are
allocated once for each device and stream and grown when a larger shape
comes; the kernel leaves the counters at zero, so nothing is cleared per
call. A call makes no host-device synchronisation: one launch on the
current stream and ``torch.empty`` for dW.

The kernel is compiled with the nearest-code kernels into one library
(``cuda_quantizer.build``), at first use. ``launches`` counts its launches;
``fallbacks`` counts fp32 training convolutions on a card whose weight
gradient went to cuDNN (a precision that allows TF32), which ``ops/conv.py``
adds to.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from vqvae_tpu_torch.ops import cuda_quantizer

# As csrc/conv_wgrad.cu fixes them: positions of K a stage holds, the floats
# after each depth's line of a stage, stages of the ring, threads of a block,
# and the tiles it instantiates.
CHUNK = 32
PAD = 4
STAGES = 3
THREADS = 256
TILES = ((128, 128), (128, 64), (64, 128), (64, 64), (128, 32), (32, 128))
# The H100 SXM: SMs, shared memory of an SM and what each block reserves of
# it, registers of an SM (the kernel caps a thread at 128).
SMS = 132
SM_SMEM_BYTES = 233_472
BLOCK_RESERVED_BYTES = 1024
SM_REGISTERS = 65_536
THREAD_REGISTERS = 128
# The tiles a dW is cut into where the padding allows (measured on the H100:
# fewer, larger tiles need so many slices that summing them costs more), the
# least chunks of K a slice takes, and the most slices one group sums before
# the group sums are summed.
MIN_TILES = 3
MIN_SLICE_CHUNKS = 4
MAX_GROUP = 16
INT32_MAX = 2**31 - 1

launches = 0
fallbacks = 0
_lib = None
_workspaces: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor, int, int]] = {}


class Plan(NamedTuple):
    bm: int          # rows of dW a block owns
    bn: int          # columns of dW a block owns
    slices: int      # S: slices of K
    k_slice: int     # positions of K a slice covers, a multiple of CHUNK
    group_size: int  # slices a group sums
    groups: int


def smem_bytes(bm: int, bn: int) -> int:
    """Dynamic shared memory of a block (``Tile::kSmemBytes``): the ring of
    staged chunks of A's rows and B's columns, and the columns' offsets and
    windows."""
    return STAGES * CHUNK * (bm + PAD + bn + PAD) * 4 + bn * 8


def blocks_per_sm(bm: int, bn: int) -> int:
    """Blocks of one tile that an SM holds at once, by shared memory and by
    registers."""
    by_smem = SM_SMEM_BYTES // (smem_bytes(bm, bn) + BLOCK_RESERVED_BYTES)
    return max(1, min(by_smem, SM_REGISTERS // (THREAD_REGISTERS * THREADS)))


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def plan(m: int, n: int, k: int) -> Plan:
    """The kernel's tiling of a dW of (m, n) summed over k positions: a pure
    function of the shape.

    The tile is one that pads dW least; among those, the largest that cuts dW
    into at least MIN_TILES tiles, else the one that cuts it into the most (the
    squarer on a tie): a small dW in small tiles needs fewer slices, and so
    fewer partial tiles to sum. The slices fill the card's resident blocks
    once, each of at least MIN_SLICE_CHUNKS chunks; they are summed in groups
    of about sqrt(S) (at most MAX_GROUP), so that no block reads more than
    about 2 sqrt(S) partial tiles."""
    if min(m, n, k) < 1:
        raise ValueError(f"empty weight gradient: m={m}, n={n}, k={k}")

    def tiles_of(t):
        return _cdiv(m, t[0]) * _cdiv(n, t[1])

    least = min(tiles_of(t) * t[0] * t[1] for t in TILES)
    fits = [t for t in TILES if tiles_of(t) * t[0] * t[1] == least]
    enough = [t for t in fits if tiles_of(t) >= MIN_TILES]
    if enough:
        bm, bn = max(enough, key=lambda t: (t[0] * t[1], -abs(t[0] - t[1])))
    else:
        bm, bn = max(fits, key=lambda t: (tiles_of(t), -abs(t[0] - t[1])))
    tiles = tiles_of((bm, bn))
    chunks = _cdiv(k, CHUNK)
    slices = max(1, min(SMS * blocks_per_sm(bm, bn) // tiles, chunks // MIN_SLICE_CHUNKS))
    per = _cdiv(chunks, slices)
    slices = _cdiv(chunks, per)
    group = min(MAX_GROUP, max(1, math.isqrt(slices - 1) + 1)) if slices > 1 else 1
    return Plan(bm, bn, slices, per * CHUNK, group, _cdiv(slices, group))


def workspace_floats(p: Plan, m: int, n: int) -> Tuple[int, int]:
    """(floats of partial tiles, counters) a call of this plan needs."""
    if p.slices == 1:
        return 0, 0
    tiles = _cdiv(m, p.bm) * _cdiv(n, p.bn)
    return (p.slices + p.groups) * tiles * p.bm * p.bn, tiles * (p.groups + 1)


class _Geometry(ctypes.Structure):
    # the fields of csrc/conv_wgrad.cu's Geometry, in its order
    _fields_ = [(name, ctypes.c_int) for name in (
        "batch", "m", "c", "kh", "kw", "n", "p_keep", "q_keep", "h", "w",
        "stride_h", "stride_w", "pad_h", "pad_w",
        "a_sn", "a_sc", "a_sh", "a_sw", "b_sn", "b_sc", "b_sh", "b_sw",
        "k", "k_slice", "slices", "group_size", "groups")]


def pair(v) -> Tuple[int, int]:
    """(v, v) of an int, else the first two of a sequence, as ints."""
    return (int(v), int(v)) if isinstance(v, int) else (int(v[0]), int(v[1]))


def _reach(shape, strides) -> int:
    """The largest element offset that a tensor's strides reach."""
    return sum((size - 1) * stride for size, stride in zip(shape, strides))


@functools.lru_cache(maxsize=None)
def geometry(a_shape, a_strides, b_shape, b_strides, kh, kw, stride, padding, keep):
    """The checked geometry of a call (the kernel's ``Geometry``), its plan,
    dW's shape and the floats and counters of its workspace, built once a
    shape and strides. (None, None, dW's shape, (0, 0)) for an empty sum."""
    if len(a_shape) != 4 or len(b_shape) != 4 or a_shape[0] != b_shape[0]:
        raise ValueError(f"a (B, M, P, Q) and b (B, C, H, W), got {tuple(a_shape)} and {tuple(b_shape)}")
    if max(_reach(a_shape, a_strides), _reach(b_shape, b_strides)) > INT32_MAX or b_shape[2] >= 2**14:
        raise ValueError("the kernel indexes a and b with 32-bit offsets and rows below 2**14")
    batch, m, p, q = a_shape
    c, h, w = b_shape[1], b_shape[2], b_shape[3]
    p_keep = p if keep[0] is None else min(p, keep[0])
    q_keep = q if keep[1] is None else min(q, keep[1])
    n = c * kh * kw
    k = batch * p_keep * q_keep
    if k == 0 or m == 0 or n == 0:
        return None, None, (m, c, kh, kw), (0, 0)
    pl = plan(m, n, k)
    g = _Geometry(batch, m, c, kh, kw, n, p_keep, q_keep, h, w, *pair(stride), *pair(padding),
                  *a_strides, *b_strides, k, pl.k_slice, pl.slices, pl.group_size, pl.groups)
    return g, pl, (m, c, kh, kw), workspace_floats(pl, m, n)


def library():
    """The built library with its C interface declared, loaded once."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(cuda_quantizer.build()))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.vq_conv_wgrad.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, ptr]
        lib.vq_conv_wgrad.restype = i32
        lib.vq_error_string.argtypes = [i32]
        lib.vq_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _workspace(device: torch.device, stream: int, floats: int, counters: int) -> Tuple[int, int]:
    """Pointers to the device's and stream's partial tiles and counters,
    grown to the call."""
    key = (device.index, stream)
    have = _workspaces.get(key)
    if have is None or have[0].numel() < floats or have[1].numel() < counters:
        old_f, old_c = (0, 0) if have is None else (have[0].numel(), have[1].numel())
        part = torch.empty(max(floats, old_f), dtype=torch.float32, device=device)
        cnt = torch.zeros(max(counters, old_c), dtype=torch.int32, device=device)
        have = _workspaces[key] = (part, cnt, part.data_ptr(), cnt.data_ptr())
    return have[2], have[3]


def weight_grad(a: torch.Tensor, b: torch.Tensor, kh: int, kw: int, stride=1, padding=0,
                keep: Tuple[Optional[int], Optional[int]] = (None, None)) -> torch.Tensor:
    """Launch the kernel: a (B, M, P, Q), b (B, C, H, W) fp32 on one card ->
    dW (M, C, kh, kw) fp32."""
    global launches
    dev = a.device
    if dev.type != "cuda" or b.device != dev:
        raise ValueError(f"a and b must be on one CUDA device, got {dev} and {b.device}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(f"a and b must be float32, got {a.dtype} and {b.dtype}")
    g, pl, shape, (floats, counters) = geometry(a.shape, a.stride(), b.shape, b.stride(), kh, kw,
                                                stride, padding, keep)
    dw = torch.empty(shape, dtype=torch.float32, device=dev)
    if g is None:
        return dw.zero_()
    if torch.cuda.current_device() != dev.index:
        with torch.cuda.device(dev):
            return weight_grad(a, b, kh, kw, stride, padding, keep)
    lib = _lib or library()
    # the current stream's handle, without the Stream object that
    # torch.cuda.current_stream builds (some microseconds a call)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    part, cnt = _workspace(dev, stream, floats, counters) if floats else (None, None)
    err = lib.vq_conv_wgrad(a.data_ptr(), b.data_ptr(), dw.data_ptr(), part, cnt,
                            ctypes.addressof(g), pl.bm, pl.bn, stream)
    if err != 0:
        raise RuntimeError(f"conv_wgrad launch failed: {lib.vq_error_string(err).decode()}")
    launches += 1
    return dw


def reset_counts() -> None:
    global launches, fallbacks
    launches = fallbacks = 0


__all__ = ["Plan", "blocks_per_sm", "fallbacks", "geometry", "launches", "library", "pair", "plan",
           "reset_counts", "smem_bytes", "weight_grad", "workspace_floats"]
