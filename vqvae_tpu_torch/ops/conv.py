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

Weight gradients. cuDNN's deterministic weight-gradient algorithms were the
largest device operations of fp32 training on an H100, so the weight
gradient of an fp32 "highest" training convolution on a card goes to a
hand-written deterministic kernel (``ops/conv_wgrad.py``,
``csrc/conv_wgrad.cu``); cuDNN keeps the forward and the data gradient.
``wgrad_route`` decides from what the call shows, never from a model: the
kernel for fp32 CUDA tensors at "highest" with a gradient to take; cuDNN as
before on a card for bf16 and for the precisions that allow TF32 (counted
in ``conv_wgrad.fallbacks`` where fp32 weights take a gradient); ``F.conv2d``
as before on the CPU. Calls without a weight gradient to take (extraction,
the sampler, the service) call ``F.conv2d`` before any routing. The
kernel's launch sits in the span ``conv.wgrad`` (``utils/profiling.py``),
opened on autograd's thread.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from vqvae_tpu_torch.ops import conv_wgrad
from vqvae_tpu_torch.utils.profiling import annotate


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


def plain_wgrad(a: torch.Tensor, b: torch.Tensor, kh: int, kw: int, stride=1, padding=0,
                keep: Tuple[Optional[int], Optional[int]] = (None, None)) -> torch.Tensor:
    """The kernel's function in plain PyTorch (unfold + one matmul), in a's
    dtype: dW[m, c, r, s] = sum over (n, p, q) of a[n, m, p, q] * b[n, c,
    p*sh - ph + r, q*sw - pw + s] over the positions p < keep[0], q < keep[1]
    of a (``conv_wgrad.weight_grad``). For a convolution a is the output's
    gradient and b its input; for a transposed convolution a is its input and
    b the output's gradient. The kernel's yardstick in the tests and on the
    card (``bench/conv_wgrad.py``)."""
    bsz, m, p, q = a.shape
    c = b.shape[1]
    cols = F.unfold(b, (kh, kw), padding=conv_wgrad.pair(padding), stride=conv_wgrad.pair(stride))
    cols = cols.reshape(bsz, c * kh * kw, p, q)
    p_keep = p if keep[0] is None else min(p, keep[0])
    q_keep = q if keep[1] is None else min(q, keep[1])
    a_k = a[:, :, :p_keep, :q_keep].permute(1, 0, 2, 3).reshape(m, -1)
    cols_k = cols[:, :, :p_keep, :q_keep].permute(1, 0, 2, 3).reshape(c * kh * kw, -1)
    return (a_k @ cols_k.t()).reshape(m, c, kh, kw)


def wgrad_route(device_type: str, dtype: Optional[torch.dtype], precision: Optional[str],
                wants_wgrad: bool) -> str:
    """Where a convolution's weight gradient goes, from what the call shows
    (its device, its dtype, its precision, and whether grad is enabled for a
    weight that requires it): "kernel" (``_KernelWgradConv``, the weight
    gradient from ``conv_wgrad.weight_grad``) for fp32 on a card at
    "highest" with a weight gradient to take; "plain" (``F.conv2d`` as it
    is, autograd's CPU gradient) on the CPU; "cudnn" (``F.conv2d`` as it is)
    for every other call on a card: bf16, a precision that allows TF32, or
    no weight gradient to take."""
    if device_type != "cuda":
        return "plain"
    if precision == "highest" and dtype == torch.float32 and wants_wgrad:
        return "kernel"
    return "cudnn"


class _KernelWgradConv(torch.autograd.Function):
    """A convolution (or a transposed one) whose forward is ``F.conv2d``
    (``F.conv_transpose2d``) as it is, and whose backward takes the data
    gradient from ``aten.convolution_backward`` and the weight gradient from
    the hand-written kernel: CUDA tensors only (``wgrad_route``). ``keep``
    (rows, columns; None: all) is the part of the output that the caller
    keeps: the rest carries a zero gradient, which the kernel skips."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, transposed, keep):
        ctx.save_for_backward(x, w)
        ctx.geometry = stride, padding, transposed, keep
        conv = F.conv_transpose2d if transposed else F.conv2d
        return conv(x, w, None, stride=stride, padding=padding)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        stride, padding, transposed, keep = ctx.geometry
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # cuDNN reads the precision switches that the caller's scope holds
            # around backward() (the module's docstring); a scope opened here,
            # on autograd's thread, would wait on the caller's lock
            dx = torch.ops.aten.convolution_backward.default(
                dy, x, w, None, conv_wgrad.pair(stride), conv_wgrad.pair(padding), (1, 1),
                transposed, (0, 0), 1, (True, False, False))[0]
        if ctx.needs_input_grad[1]:
            a, b = (x, dy) if transposed else (dy, x)
            with annotate("conv.wgrad"):
                dw = conv_wgrad.weight_grad(a, b, w.shape[2], w.shape[3], stride, padding, keep)
        return dx, dw, None, None, None, None


def _conv(x, w, stride, padding, transposed: bool, precision: Optional[str], keep):
    conv = F.conv_transpose2d if transposed else F.conv2d
    if not (w.requires_grad and torch.is_grad_enabled()):
        return conv(x, w.to(x.dtype), None, stride=stride, padding=padding)
    # the kernel takes fp32 operands alike; a weight cast to x's dtype does not
    dtype = x.dtype if w.dtype == x.dtype else None
    route = wgrad_route(x.device.type, dtype, precision, True)
    if route == "kernel":
        return _KernelWgradConv.apply(x, w, stride, padding, transposed, keep)
    if route == "cudnn" and x.dtype == torch.float32:
        conv_wgrad.fallbacks += 1
    return conv(x, w.to(x.dtype), None, stride=stride, padding=padding)


def _crop(y, keep):
    rows, cols = keep
    if rows is not None:
        y = y[:, :, :rows]
    if cols is not None:
        y = y[:, :, :, :cols]
    return y


def conv2d(x, w, b=None, stride=1, padding=0, precision: Optional[str] = None,
           keep: Tuple[Optional[int], Optional[int]] = (None, None)):
    """torch Conv2d semantics. x: (N, C_in, H, W); w: (C_out, C_in, kh, kw).

    ``keep`` (rows, columns; None: all) crops the output to its first rows
    and columns after the bias, as the prior's causal stacks do."""
    with conv_fp32_precision(precision):
        y = _conv(x, w, stride, padding, False, precision, keep)
    y = _add_bias(y, b)
    return y if keep == (None, None) else _crop(y, keep)


def conv_transpose2d(x, w, b=None, stride=1, padding=0, precision: Optional[str] = None):
    """torch ConvTranspose2d semantics. x: (N, C_in, H, W); w: (C_in, C_out, kh, kw).

    Output size (H - 1) * stride - 2 * padding + kh, as in the reference
    decoder (reference models/decoder.py:27-35).
    """
    with conv_fp32_precision(precision):
        y = _conv(x, w, stride, padding, True, precision, (None, None))
    return _add_bias(y, b)


__all__ = ["conv2d", "conv_fp32_precision", "conv_transpose2d", "plain_wgrad", "wgrad_route"]
