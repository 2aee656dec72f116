"""2-D convolutions with torch operator semantics (port of ``vqvae_tpu/ops/conv.py``).

The JAX file flips kernels and dilates the input to reach torch's
ConvTranspose2d semantics; here ``F.conv2d``/``F.conv_transpose2d`` have them
natively, so these are thin wrappers over cuDNN (the convs are XLA ops in the
JAX package, not Pallas kernels). They take NCHW activations and torch-layout
weights: conv (C_out, C_in, kh, kw), transposed conv (C_in, C_out, kh, kw).

As in the JAX ops, weights are cast to the input's dtype and the bias is
added after the convolution in the output's dtype (JAX conv.py:57-64).

``precision`` scopes the fp32 arithmetic of cuDNN's convolutions and of
cuBLAS's matmuls to the call: "highest" turns TF32 off (cuDNN allows it by
default), "high" and "default" allow it. It changes nothing for bf16 inputs.

Both switches are process-wide in torch, so ``conv_fp32_precision`` holds a
process-wide re-entrant lock from its entry to its exit: a thread that opens
a scope waits until no other thread is inside one, and reads back its own
values inside its scope (a sampler thread under the prior's precision, a
decode thread under the VQ-VAE's). Re-entry from the same thread is allowed
and restores the outer values on exit.

The scope also holds cuDNN to its deterministic algorithms
(``torch.backends.cudnn.deterministic``): the default weight-gradient
algorithm adds with atomics, so two runs of the same step parted in their
last bits. It is set on entry and restored on exit like the precision
switches, never as a side effect of importing the module.

The scope of a call covers its forward convolution only. Autograd runs the
backward convolutions when ``backward()`` is called, and cuDNN reads the
switches then, so code that takes gradients holds ``conv_fp32_precision``
around the forward and ``backward()`` itself (``VQVAETrainer`` does).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch
import torch.nn.functional as F


# one lock for the process, as the switches it guards are the process's
_PRECISION_LOCK = threading.RLock()


@contextlib.contextmanager
def conv_fp32_precision(precision: Optional[str]):
    """Scope TF32 use of fp32 convolutions (cuDNN) and matmuls (cuBLAS), and
    cuDNN's deterministic algorithms, to a ``with`` block, serialized across
    threads."""
    # torch's per-operator precision API only: mixing it with the legacy
    # allow_tf32 flags raises on a later read
    value = "ieee" if precision == "highest" else "tf32"
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    with _PRECISION_LOCK:
        prev = cudnn.conv.fp32_precision, matmul.fp32_precision, cudnn.deterministic
        cudnn.conv.fp32_precision = matmul.fp32_precision = value
        cudnn.deterministic = True
        try:
            yield
        finally:
            cudnn.conv.fp32_precision, matmul.fp32_precision, cudnn.deterministic = prev


def _add_bias(y, b):
    if b is None:
        return y
    return y + b.to(y.dtype).view(1, -1, 1, 1)


def conv2d(x, w, b=None, stride=1, padding=0, precision: Optional[str] = None):
    """torch Conv2d semantics. x: (N, C_in, H, W); w: (C_out, C_in, kh, kw)."""
    with conv_fp32_precision(precision):
        y = F.conv2d(x, w.to(x.dtype), None, stride=stride, padding=padding)
    return _add_bias(y, b)


def conv_transpose2d(x, w, b=None, stride=1, padding=0, precision: Optional[str] = None):
    """torch ConvTranspose2d semantics. x: (N, C_in, H, W); w: (C_in, C_out, kh, kw).

    Output size (H - 1) * stride - 2 * padding + kh, as in the reference
    decoder (reference models/decoder.py:27-35).
    """
    with conv_fp32_precision(precision):
        y = F.conv_transpose2d(x, w.to(x.dtype), None, stride=stride, padding=padding)
    return _add_bias(y, b)


__all__ = ["conv2d", "conv_transpose2d", "conv_fp32_precision"]
