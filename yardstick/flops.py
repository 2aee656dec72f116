"""The yardstick's frozen FLOP formulas: a copy of the port's
``utils/flops.py`` as it stood when the benchmark was defined, so that a
later change to the program cannot change what a rate is divided by.
``tests/test_yardstick_harness.py`` holds the copy equal to the program's at
both configurations' widths.

FLOP convention: 1 multiply-add = 2 FLOPs. Conv FLOPs = 2 * out_pixels *
C_out * (kh * kw * C_in) per image; the quantizer distance matmul =
2 * rows * K * D.
"""

from __future__ import annotations

from typing import Tuple


def conv_flops(out_h: int, out_w: int, c_in: int, c_out: int, kh: int, kw: int) -> int:
    return 2 * out_h * out_w * c_out * kh * kw * c_in


def encoder_flops_per_image(
    img_hw: int = 32,
    in_channels: int = 3,
    n_hiddens: int = 128,
    n_residual_hiddens: int = 32,
    n_residual_layers: int = 2,
) -> int:
    """FLOPs of the reference encoder stack (models/encoder.py:24-40) per image."""
    h = img_hw
    half = n_hiddens // 2
    total = conv_flops(h // 2, h // 2, in_channels, half, 4, 4)          # k4 s2
    total += conv_flops(h // 4, h // 4, half, n_hiddens, 4, 4)           # k4 s2
    total += conv_flops(h // 4, h // 4, n_hiddens, n_hiddens, 3, 3)      # k3 s1
    res = conv_flops(h // 4, h // 4, n_hiddens, n_residual_hiddens, 3, 3)
    res += conv_flops(h // 4, h // 4, n_residual_hiddens, n_hiddens, 1, 1)
    return total + n_residual_layers * res


def quantizer_flops_per_image(
    img_hw: int = 32,
    embedding_dim: int = 64,
    n_embeddings: int = 512,
    n_hiddens: int = 128,
) -> int:
    """Pre-quant 1x1 conv + distance matmul FLOPs per image (8x8 latent grid)."""
    g = img_hw // 4  # two stride-2 convs
    pre = conv_flops(g, g, n_hiddens, embedding_dim, 1, 1)
    dist = 2 * g * g * n_embeddings * embedding_dim
    return pre + dist


def conv_transpose_flops(in_h: int, in_w: int, c_in: int, c_out: int, kh: int, kw: int) -> int:
    """Each input pixel scatters a kh*kw*c_out stencil (2 FLOPs per MAC)."""
    return 2 * in_h * in_w * c_in * kh * kw * c_out


def decoder_flops_per_image(
    img_hw: int = 32,
    out_channels: int = 3,
    n_hiddens: int = 128,
    n_residual_hiddens: int = 32,
    n_residual_layers: int = 2,
    embedding_dim: int = 64,
) -> int:
    """FLOPs of the reference decoder stack (models/decoder.py:22-36) per image."""
    g = img_hw // 4  # latent grid side
    half = n_hiddens // 2
    total = conv_transpose_flops(g, g, embedding_dim, n_hiddens, 3, 3)   # k3 s1
    res = conv_flops(g, g, n_hiddens, n_residual_hiddens, 3, 3)
    res += conv_flops(g, g, n_residual_hiddens, n_hiddens, 1, 1)
    total += n_residual_layers * res
    total += conv_transpose_flops(g, g, n_hiddens, half, 4, 4)           # k4 s2
    total += conv_transpose_flops(g * 2, g * 2, half, out_channels, 4, 4)  # k4 s2
    return total


def _pick(kw: dict, names: Tuple[str, ...]) -> dict:
    return {k: kw[k] for k in names if k in kw}


_ENC_KEYS = ("img_hw", "in_channels", "n_hiddens", "n_residual_hiddens", "n_residual_layers")
_DEC_KEYS = ("img_hw", "out_channels", "n_hiddens", "n_residual_hiddens", "n_residual_layers",
             "embedding_dim")
_Q_KEYS = ("img_hw", "embedding_dim", "n_embeddings", "n_hiddens")


def train_step_flops_per_image(**kw) -> int:
    """Analytic fwd+bwd FLOPs per image of the full VQ-VAE training step.

    Convs count 3x forward (output grad + input grad + weight grad are each
    a same-size contraction); the quantizer distance matmul is forward-only
    (its backward is a scatter-add, O(N*D) not O(N*K*D)); losses/optimizer
    are O(params) noise.
    """
    conv_fwd = encoder_flops_per_image(**_pick(kw, _ENC_KEYS)) + decoder_flops_per_image(
        **_pick(kw, _DEC_KEYS))
    # pre-quant 1x1 conv is inside quantizer_flops; split it out for the 3x rule
    q = quantizer_flops_per_image(**_pick(kw, _Q_KEYS))
    g = kw.get("img_hw", 32) // 4
    pre = conv_flops(g, g, kw.get("n_hiddens", 128), kw.get("embedding_dim", 64), 1, 1)
    dist = q - pre
    return 3 * (conv_fwd + pre) + dist


def pixelcnn_flops_per_grid(
    img_dim: int = 8,
    dim: int = 64,
    n_layers: int = 15,
    input_dim: int = 512,
) -> int:
    """Forward FLOPs of the GatedPixelCNN prior per (img_dim, img_dim) code
    grid (reference pixelcnn/models.py:88-127: 15 gated layers — layer 0
    kernel 7, rest kernel 3 — each with vert (k//2+1, k), horiz (1, k//2+1),
    vert_to_horiz 1x1 and residual 1x1 convs, then the 1x1 output head)."""
    total = 0
    for i in range(n_layers):
        k = 7 if i == 0 else 3
        total += conv_flops(img_dim, img_dim, dim, 2 * dim, k // 2 + 1, k)  # vert
        total += conv_flops(img_dim, img_dim, 2 * dim, 2 * dim, 1, 1)       # v2h
        total += conv_flops(img_dim, img_dim, dim, 2 * dim, 1, k // 2 + 1)  # horiz
        total += conv_flops(img_dim, img_dim, dim, dim, 1, 1)               # resid
    total += conv_flops(img_dim, img_dim, dim, 512, 1, 1)                   # head
    total += conv_flops(img_dim, img_dim, 512, input_dim, 1, 1)
    return total


def pixelcnn_train_step_flops_per_grid(**kw) -> int:
    """fwd+bwd+Adam FLOPs per grid: convs count 3x forward (same 3-pass rule
    as train_step_flops_per_image); CE/softmax and the optimizer are
    O(B*H*W*K) / O(params) noise against the conv stack."""
    return 3 * pixelcnn_flops_per_grid(**kw)


def encode_quantize_flops_per_image(**kw) -> int:
    return encoder_flops_per_image(**_pick(kw, _ENC_KEYS)) + quantizer_flops_per_image(
        **_pick(kw, _Q_KEYS))
