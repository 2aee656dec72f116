"""The reference's float32 arithmetic, scoped to a ``with`` block.

``"ieee"`` is float32 with TF32 off in cuDNN's convolutions and cuBLAS's
matmuls (the configurations' arithmetic); ``"tf32"`` lets both use TF32, the
next precision below, which is what the control of the correctness check
computes in. The per-operator precision switches are used, as the program
uses them: torch refuses a later read of either kind of switch once the two
kinds have been mixed in one process.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def fp32(mode: str = "ieee"):
    if mode not in ("ieee", "tf32"):
        raise ValueError(f"mode must be 'ieee' or 'tf32', got {mode!r}")
    cudnn, matmul = torch.backends.cudnn.conv, torch.backends.cuda.matmul
    prev = cudnn.fp32_precision, matmul.fp32_precision
    cudnn.fp32_precision = matmul.fp32_precision = mode
    try:
        yield
    finally:
        cudnn.fp32_precision, matmul.fp32_precision = prev
