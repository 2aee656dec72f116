"""The port's convs and models held against the JAX package on the same weights.

Weights come from the JAX modules' own ``init`` (or the trained checkpoints
in ``artifacts/``) and cross over through ``params_from_jax``; inputs are
seeded numpy. Public functions of both packages are NHWC; the port's conv ops
are NCHW, so their test transposes at the boundary.

Tolerances: fp32 paths run the JAX convs at precision "highest" and the port
with TF32 off, so they differ only by summation order: atol 1e-5 per conv,
1e-4 through a whole model. The bf16 checkpoint (e2e_r5) rounds every conv
output to bf16 (8-bit mantissa), and XLA and torch round at different
places, so it has its own looser bounds (see that test).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_tpu.config import VQVAEConfig as JaxConfig
from vqvae_tpu.models.decoder import Decoder as JaxDecoder
from vqvae_tpu.models.encoder import Encoder as JaxEncoder
from vqvae_tpu.models.residual import ResidualStack as JaxResidualStack
from vqvae_tpu.models.vqvae import VQVAE as JaxVQVAE
from vqvae_tpu.ops import conv as jax_conv
from vqvae_tpu_torch.config import VQVAEConfig
from vqvae_tpu_torch.data.datasets import load_dataset
from vqvae_tpu_torch.models.decoder import Decoder
from vqvae_tpu_torch.models.encoder import Encoder
from vqvae_tpu_torch.models.residual import ResidualStack
from vqvae_tpu_torch.models.vqvae import VQVAE
from vqvae_tpu_torch.ops import conv
from vqvae_tpu_torch.ops.quantizer import compare_assignments
from vqvae_tpu_torch.pipelines.viz import load_model
from vqvae_tpu_torch.train.checkpoint import params_from_jax, read_checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R4 = os.path.join(ROOT, "artifacts/e2e_r4/vqvae_e2e_r4_step4999.npz")
R5 = os.path.join(ROOT, "artifacts/e2e_r5/vqvae_e2e_r5_step4999.npz")


def _nhwc_to_nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _images(n, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (n, 32, 32, 3)).astype(np.float32)


# (kernel, stride, padding) of every conv and transposed conv of the model
@pytest.mark.parametrize("k,s,p", [(4, 2, 1), (3, 1, 1), (1, 1, 0)])
def test_conv2d_vs_jax(k, s, p):
    rng = np.random.default_rng(k)
    x = rng.standard_normal((2, 16, 16, 6)).astype(np.float32)
    w = rng.standard_normal((k, k, 6, 5)).astype(np.float32)
    b = rng.standard_normal((5,)).astype(np.float32)
    want = np.asarray(jax_conv.conv2d(x, w, b, stride=s, padding=p, precision="highest"))
    got = conv.conv2d(_nhwc_to_nchw(x), params_from_jax({"conv_w": w})["conv_w"],
                      torch.from_numpy(b), stride=s, padding=p, precision="highest")
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("k,s,p", [(3, 1, 1), (4, 2, 1)])
def test_conv_transpose2d_vs_jax(k, s, p):
    rng = np.random.default_rng(10 + k)
    x = rng.standard_normal((2, 8, 8, 6)).astype(np.float32)
    w = rng.standard_normal((k, k, 6, 5)).astype(np.float32)
    b = rng.standard_normal((5,)).astype(np.float32)
    want = np.asarray(jax_conv.conv_transpose2d(x, w, b, stride=s, padding=p, precision="highest"))
    got = conv.conv_transpose2d(_nhwc_to_nchw(x), params_from_jax({"convt_w": w})["convt_w"],
                                torch.from_numpy(b), stride=s, padding=p, precision="highest")
    assert got.shape == (2, 5) + want.shape[1:3]
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=1e-5)


def test_conv_precision_is_scoped():
    """The TF32 setting is restored after the call, whatever it was."""
    flags = torch.backends.cudnn.conv
    before = flags.fp32_precision
    with conv.conv_fp32_precision("highest"):
        assert flags.fp32_precision == "ieee"
    assert flags.fp32_precision == before
    with conv.conv_fp32_precision("default"):
        assert flags.fp32_precision == "tf32"
    assert flags.fp32_precision == before


def _carry(jax_module, torch_module, x_nhwc):
    params = jax_module.init(jax.random.PRNGKey(0), jnp.asarray(x_nhwc))["params"]
    torch_module.load_state_dict(params_from_jax(params))
    return params


@pytest.mark.parametrize("share", [False, True])
def test_residual_stack_vs_jax(share):
    x = np.random.default_rng(1).standard_normal((2, 8, 8, 16)).astype(np.float32)
    jm = JaxResidualStack(16, 16, 8, 3, share_weights=share, precision="highest")
    tm = ResidualStack(16, 16, 8, 3, share_weights=share, precision="highest")
    params = _carry(jm, tm, x)
    assert len(list(tm.parameters())) == (2 if share else 6)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    got = tm(_nhwc_to_nchw(x)).permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_encoder_vs_jax():
    x = _images(2)
    jm = JaxEncoder(3, 16, 2, 8, precision="highest")
    tm = Encoder(3, 16, 2, 8, precision="highest")
    params = _carry(jm, tm, x)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    got = tm(_nhwc_to_nchw(x)).permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_decoder_vs_jax():
    z = np.random.default_rng(2).standard_normal((2, 8, 8, 4)).astype(np.float32)
    jm = JaxDecoder(4, 16, 2, 8, precision="highest")
    tm = Decoder(4, 16, 2, 8, precision="highest")
    params = _carry(jm, tm, z)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(z)))
    got = tm(_nhwc_to_nchw(z)).permute(0, 2, 3, 1).detach().numpy()
    assert got.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


_SMALL = dict(n_hiddens=16, n_residual_hiddens=8, n_residual_layers=2,
              embedding_dim=4, n_embeddings=24)


@pytest.mark.parametrize("share,ema", [(False, False), (True, True)])
def test_small_vqvae_vs_jax(share, ema):
    """Every public method of the model, at a small width, on JAX init weights."""
    cfg = dict(_SMALL, share_residual_weights=share, ema_codebook=ema)
    jm = JaxVQVAE(JaxConfig(**cfg))
    tm = VQVAE(VQVAEConfig(**cfg))
    x = _images(4, seed=3)
    params = _carry(jm, tm, x)
    p = {"params": params}
    xt = torch.from_numpy(x)
    with torch.no_grad():
        loss, x_hat, perp = tm(xt)
        z_e = tm.encode(xt)
        codes = tm.codes(xt)
        from_codes = tm.decode_codes(codes)
    j_loss, j_xhat, j_perp = jm.apply(p, jnp.asarray(x))
    np.testing.assert_allclose(z_e.numpy(), np.asarray(jm.apply(p, jnp.asarray(x), method=jm.encode)),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jm.apply(p, jnp.asarray(x), method=jm.codes)))
    np.testing.assert_allclose(x_hat.numpy(), np.asarray(j_xhat), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    np.testing.assert_allclose(float(perp), float(j_perp), rtol=1e-5)
    j_from_codes = jm.apply(p, jnp.asarray(codes.numpy()), method=jm.decode_codes)
    np.testing.assert_allclose(from_codes.numpy(), np.asarray(j_from_codes), rtol=0, atol=1e-5)


def test_fresh_init_is_seeded_and_in_range():
    """A fresh model draws its weights from an explicit generator: the same
    seed gives the same weights, and every draw lies in its torch-default bound."""
    cfg = VQVAEConfig(**_SMALL)
    a, b = VQVAE(cfg), VQVAE(cfg)
    a.reset_parameters(torch.Generator().manual_seed(7))
    b.reset_parameters(torch.Generator().manual_seed(7))
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), name
    assert float(a.codebook.detach().abs().max()) <= 1.0 / cfg.n_embeddings
    assert float(a.encoder.conv1_w.detach().abs().max()) <= 1.0 / np.sqrt(3 * 4 * 4)
    assert float(a.decoder.convt3_w.detach().abs().max()) <= 1.0 / np.sqrt(3 * 4 * 4)


def _checkpoint_pair(path):
    model, _metrics, hp = load_model(path, device="cpu")
    params, _step, _m, _hp = read_checkpoint(path)
    return model, JaxVQVAE(JaxConfig.from_dict(hp)), {"params": params}


def test_full_width_e2e_r4_checkpoint_vs_jax():
    """The trained fp32/highest checkpoint at full width (h=128, K=512, D=64)
    on 8 validation images: codes equal except near-ties, x_hat atol 1e-4."""
    model, jm, p = _checkpoint_pair(R4)
    assert model.config.n_hiddens == 128 and model.config.n_embeddings == 512
    x = load_dataset("CIFAR10", os.path.join(ROOT, "no-cifar-here"))[1].data[:8]
    xt = torch.from_numpy(x)
    with torch.no_grad():
        z_e = model.encode(xt)
        codes = model.codes(xt)
        loss, x_hat, perp = model(xt)
    j_codes = np.array(jm.apply(p, jnp.asarray(x), method=jm.codes))
    mism, near, gap = compare_assignments(
        z_e.reshape(-1, 64), model.codebook.detach(), codes.reshape(-1),
        torch.from_numpy(j_codes.reshape(-1)), "highest")
    assert mism == near, f"{mism - near} non-near-tie code mismatches (gap {gap})"
    # x_hat on the images whose code grids agree (a near-tie flip moves one
    # image's reconstruction); the batch scalars only when every code agrees
    same = (codes.numpy() == j_codes).all(axis=(1, 2))
    assert same.sum() >= 7, f"{8 - same.sum()} of 8 images have a flipped code"
    j_loss, j_xhat, j_perp = jm.apply(p, jnp.asarray(x))
    np.testing.assert_allclose(x_hat.numpy()[same], np.asarray(j_xhat)[same], rtol=0, atol=1e-4)
    if same.all():
        np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-4)
        np.testing.assert_allclose(float(perp), float(j_perp), rtol=1e-4)
    # the decoder alone, on the JAX codes
    with torch.no_grad():
        dec = model.decode_codes(torch.from_numpy(j_codes))
    j_dec = jm.apply(p, jnp.asarray(j_codes), method=jm.decode_codes)
    np.testing.assert_allclose(dec.numpy(), np.asarray(j_dec), rtol=0, atol=1e-4)


def test_full_width_e2e_r5_bf16_checkpoint_vs_jax():
    """The bf16/EMA/"default"-quantizer checkpoint at full width, 64 images.

    bf16 keeps 8 mantissa bits and every conv output is rounded to it; XLA and
    torch round at different places across the 9 encoder convs. Bounds, set
    from a bf16 ulp at the latents' magnitude (|z_e| < 32, ulp 0.125):
    z_e max abs error 0.25 and RMS error below 2e-3 of z_e's RMS; on
    identical z_q the decoder agrees to 8e-3 (two bf16 ulps at |x| < 1); at
    least 97% of the codes agree (a one-ulp move of z_e flips near-ties).
    """
    model, jm, p = _checkpoint_pair(R5)
    assert model.compute_dtype == torch.bfloat16
    x = load_dataset("CIFAR10", os.path.join(ROOT, "no-cifar-here"))[1].data[:64]
    xt = torch.from_numpy(x)
    j_z = np.asarray(jm.apply(p, jnp.asarray(x), method=jm.encode))
    j_q = jm.apply(p, jnp.asarray(j_z), method=jm.quantize)
    j_xhat = np.asarray(jm.apply(p, j_q.z_q, method=jm.decode))
    with torch.no_grad():
        z_e = model.encode(xt)
        codes = model.codes(xt)
        x_hat = model.decode(torch.from_numpy(np.array(j_q.z_q)))
    assert z_e.dtype == torch.float32 and x_hat.dtype == torch.float32
    dz = np.abs(z_e.numpy() - j_z)
    assert dz.max() <= 0.25
    assert np.sqrt((dz ** 2).mean()) <= 2e-3 * np.sqrt((j_z ** 2).mean())
    np.testing.assert_allclose(x_hat.numpy(), j_xhat, rtol=0, atol=8e-3)
    agree = (codes.numpy() == np.asarray(j_q.indices)).mean()
    assert agree >= 0.97, agree
