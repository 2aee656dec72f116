"""The port's FLOP formulas equal the JAX package's (integers, exact), and
its chip table resolves the H100's name as ``torch.cuda.get_device_name``
gives it."""

from __future__ import annotations

import pytest

from vqvae_tpu.utils import flops as jax_flops
from vqvae_tpu_torch.utils import flops

FORMULAS = [
    ("conv_flops", [dict(out_h=8, out_w=8, c_in=64, c_out=128, kh=4, kw=7)]),
    ("conv_transpose_flops", [dict(in_h=16, in_w=16, c_in=64, c_out=3, kh=4, kw=4)]),
    ("encoder_flops_per_image", [{}, dict(img_hw=64, n_hiddens=32, n_residual_layers=3)]),
    ("decoder_flops_per_image", [{}, dict(img_hw=64, embedding_dim=16, out_channels=1)]),
    ("quantizer_flops_per_image", [{}, dict(n_embeddings=1024, embedding_dim=32)]),
    ("encode_quantize_flops_per_image", [{}, dict(n_hiddens=64, n_embeddings=256)]),
    ("train_step_flops_per_image", [{}, dict(img_hw=64, n_hiddens=64, embedding_dim=16)]),
    ("pixelcnn_flops_per_grid", [{}, dict(img_dim=4, dim=16, n_layers=2, input_dim=16)]),
    ("pixelcnn_train_step_flops_per_grid", [{}, dict(img_dim=16, n_layers=5)]),
]


@pytest.mark.parametrize("name,cases", FORMULAS, ids=[n for n, _ in FORMULAS])
def test_formula_equals_the_jax_packages(name, cases):
    for kw in cases:
        ours, theirs = getattr(flops, name)(**kw), getattr(jax_flops, name)(**kw)
        assert isinstance(ours, int) and ours == theirs, (name, kw)


def test_every_jax_formula_is_ported():
    ported = {n for n, _ in FORMULAS}
    jax_formulas = {n for n in jax_flops.__all__ if n.endswith("_flops") or "_flops_per_" in n}
    assert jax_formulas == ported


def test_prior_step_reckoning():
    """The numbers the prior's roofline rests on: 228.1 MFLOP a grid
    forward at full width, three times that a train step."""
    assert flops.pixelcnn_flops_per_grid() == 228_065_280
    assert flops.pixelcnn_train_step_flops_per_grid() == 3 * 228_065_280


def test_chip_spec_resolves_the_h100():
    spec = flops.chip_spec("NVIDIA H100 80GB HBM3")
    assert spec is flops.H100_SXM
    assert (spec.peak_fp32_flops, spec.peak_bf16_flops, spec.hbm_bytes_per_sec) == (67e12, 989e12, 3.35e12)
    assert flops.chip_spec("nvidia h100 sxm5 80gb") is flops.H100_SXM
    for other in ("NVIDIA H100 PCIe", "NVIDIA H100 NVL", "NVIDIA A100-SXM4-80GB", "TPU v5 lite"):
        assert flops.chip_spec(other) is None, other
