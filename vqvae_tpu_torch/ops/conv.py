"""2-D convolutions with torch operator semantics (port of ``vqvae_tpu/ops/conv.py``).

The JAX file flips kernels and dilates the input to reach torch's
ConvTranspose2d semantics; here ``F.conv2d``/``F.conv_transpose2d`` have them
natively, so these are thin wrappers over cuDNN (the convs are XLA ops in the
JAX package, not Pallas kernels). They take NCHW activations and torch-layout
weights: conv (C_out, C_in, kh, kw), transposed conv (C_in, C_out, kh, kw).

As in the JAX ops, weights are cast to the input's dtype and the bias is
added after the convolution in the output's dtype (JAX conv.py:57-64).

``precision`` scopes cuDNN's fp32 arithmetic to the call: "highest" turns
TF32 off (cuDNN allows it by default), "high" and "default" allow it. It
changes nothing for bf16 inputs. Nothing is set process-wide.

The scope of a call covers its forward convolution only. Autograd runs the
backward convolutions when ``backward()`` is called, and cuDNN reads the
switch then, so code that takes gradients holds ``conv_fp32_precision``
around the forward and ``backward()`` itself (``VQVAETrainer`` does).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def conv_fp32_precision(precision: Optional[str]):
    """Scope cuDNN's TF32 use for fp32 convolutions to a ``with`` block."""
    # torch's per-operator precision API (mixing it with the legacy
    # cudnn.allow_tf32 flag raises on a later read, so only this one is used)
    flags = torch.backends.cudnn.conv
    prev = flags.fp32_precision
    flags.fp32_precision = "ieee" if precision == "highest" else "tf32"
    try:
        yield
    finally:
        flags.fp32_precision = prev


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
