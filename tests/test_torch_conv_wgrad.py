"""The hand-written weight-gradient kernel and its routing
(vqvae_tpu_torch/csrc/conv_wgrad.cu, ops/conv_wgrad.py, ops/conv.py).

This file imports neither JAX nor the JAX package, so its ``gpu`` tests run
on a machine that has a card and no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_conv_wgrad.py

Without a card the ``gpu`` tests skip themselves inside the test. The CPU
tests hold the plain version (``conv.plain_wgrad``, which the kernel's
function is) and the autograd function around it against autograd's own
gradients at every training convolution of both models, and pin the
routing rule and the kernel's plan. On the card the kernel is held against
the plain version in float64 within the bound of a recursive fp32 sum:
2**-24 * (k_slice + S + 2) * the float64 sum of |a| |b| over each element's
terms (a slice sums k_slice terms in order, then S partials are summed).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vqvae_tpu_torch.bench import conv_wgrad as bench
from vqvae_tpu_torch.config import PixelCNNConfig, TrainConfig, VQVAEConfig
from vqvae_tpu_torch.ops import conv, conv_wgrad

CONVS = {**{f"vqvae.{k}": (v, 256) for k, v in bench.VQVAE_CONVS.items()},
         **{f"prior.{k}": (v, bench.PRIOR_BATCH) for k, v in bench.PRIOR_CONVS.items()}}


def _operands(spec, batch, seed=0, dtype=torch.float32, device="cpu"):
    """x, w, and the gradient of the kept output of a training convolution."""
    x_chw, w_shape, stride, padding, transposed, keep, _count = spec
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((batch, *x_chw), generator=g, dtype=dtype).to(device)
    w = torch.randn(w_shape, generator=g, dtype=dtype).to(device)
    _a, _b, out = bench.shapes(spec, batch)
    rows = out[2] if keep[0] is None else keep[0]
    cols = out[3] if keep[1] is None else keep[1]
    dy = torch.randn((*out[:2], rows, cols), generator=g, dtype=dtype).to(device)
    return x, w, dy


def _reference(spec, x, w, b=None):
    _x, _w, stride, padding, transposed, keep, _c = spec
    fn = F.conv_transpose2d if transposed else F.conv2d
    return conv._crop(fn(x, w, b, stride=stride, padding=padding), keep)


@pytest.mark.parametrize("name", sorted(CONVS))
def test_plain_wgrad_equals_autograds_weight_gradient(name):
    """The kernel's function, in plain PyTorch, is autograd's weight gradient
    of the (transposed) convolution, the cropped positions of dy skipped."""
    spec, _batch = CONVS[name]
    x, w, dy = _operands(spec, 3, dtype=torch.float64)
    w.requires_grad_(True)
    (want,) = torch.autograd.grad(_reference(spec, x, w), w, dy)
    _x, w_shape, stride, padding, transposed, keep, _c = spec
    a, b = (x, _full(dy, spec, x)) if transposed else (_full(dy, spec, x), x)
    got = conv.plain_wgrad(a, b, w_shape[2], w_shape[3], stride, padding, keep)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=1e-12)


def _full(dy, spec, x):
    """dy of the whole output, zero outside the kept part (as the crop's
    backward leaves it)."""
    _a, _b, out = bench.shapes(spec, x.shape[0])
    full = dy.new_zeros(out)
    full[:, :, :dy.shape[2], :dy.shape[3]] = dy
    return full


@pytest.mark.parametrize("name", sorted(CONVS))
def test_function_gradients_equal_autograd_on_the_cpu(name, monkeypatch):
    """x, w and b gradients through the kernel's autograd function, with the
    plain version standing in for the kernel on the CPU, and the bias added
    after it, against F.conv2d's (F.conv_transpose2d's) autograd."""
    monkeypatch.setattr(conv_wgrad, "weight_grad", conv.plain_wgrad)
    spec, _batch = CONVS[name]
    x, w, dy = _operands(spec, 2, seed=1)
    b = torch.randn(w.shape[1] if spec[4] else w.shape[0])
    leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
    want = torch.autograd.grad(_reference(spec, *leaves), leaves, dy)
    mine = [t.clone().requires_grad_(True) for t in (x, w, b)]
    _x, _w, stride, padding, transposed, keep, _c = spec
    y = conv._KernelWgradConv.apply(mine[0], mine[1], stride, padding, transposed, keep)
    got = torch.autograd.grad(conv._crop(conv._add_bias(y, mine[2]), keep), mine, dy)
    for g_got, g_want, what in zip(got, want, "xwb"):
        np.testing.assert_allclose(g_got.numpy(), g_want.numpy(), rtol=2e-5, atol=2e-5, err_msg=what)


ROUTES = {
    "fp32 highest with a gradient, card": (("cuda", torch.float32, "highest", True), "kernel"),
    "bf16, card": (("cuda", torch.bfloat16, "highest", True), "cudnn"),
    "fp32 high (TF32), card": (("cuda", torch.float32, "high", True), "cudnn"),
    "fp32 default (TF32), card": (("cuda", torch.float32, "default", True), "cudnn"),
    "fp32 no precision (TF32), card": (("cuda", torch.float32, None, True), "cudnn"),
    "fp32 highest without a gradient, card": (("cuda", torch.float32, "highest", False), "cudnn"),
    "weight cast to x's dtype, card": (("cuda", None, "highest", True), "cudnn"),
    "fp32 highest with a gradient, cpu": (("cpu", torch.float32, "highest", True), "plain"),
    "bf16 default, cpu": (("cpu", torch.bfloat16, "default", False), "plain"),
}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_route_follows_what_the_call_shows(case):
    args, want = ROUTES[case]
    assert conv.wgrad_route(*args) == want


def test_cpu_convolutions_keep_autograds_own_path():
    """On the CPU conv2d and conv_transpose2d call F.conv2d as they are: the
    graph holds autograd's convolution node, and nothing is counted."""
    conv_wgrad.reset_counts()
    x = torch.randn(2, 4, 8, 8, requires_grad=True)
    w = torch.randn(6, 4, 3, 3, requires_grad=True)
    y = conv.conv2d(x, w, padding=1, precision="highest")
    assert type(y.grad_fn).__name__ == "ConvolutionBackward0"
    wt = torch.randn(4, 6, 4, 4, requires_grad=True)
    yt = conv.conv_transpose2d(x, wt, stride=2, padding=1, precision="highest")
    assert type(yt.grad_fn).__name__ == "ConvolutionBackward0"
    (y.sum() + yt.sum()).backward()
    assert conv_wgrad.launches == 0 and conv_wgrad.fallbacks == 0


@pytest.mark.parametrize("why", ["no_grad", "frozen weight"])
def test_calls_without_a_weight_gradient_are_not_routed(why, monkeypatch):
    """Extraction, the sampler and the service take no weight gradient: their
    convolutions call F.conv2d before any routing, and their outputs are
    F.conv2d's."""
    def refuse(*args):
        raise AssertionError("routed")

    monkeypatch.setattr(conv, "wgrad_route", refuse)
    x, w, b = torch.randn(2, 3, 8, 8), torch.randn(4, 3, 2, 3), torch.randn(4)
    wt = torch.randn(3, 5, 4, 4)
    with torch.no_grad() if why == "no_grad" else torch.enable_grad():
        y = conv.conv2d(x, w, b, padding=(1, 1), precision="highest", keep=(8, None))
        yt = conv.conv_transpose2d(x, wt, b[:1].expand(5), stride=2, padding=1, precision="highest")
    assert torch.equal(y, F.conv2d(x, w, b, padding=(1, 1))[:, :, :8])
    assert torch.equal(yt, F.conv_transpose2d(x, wt, b[:1].expand(5), stride=2, padding=1))


@pytest.mark.parametrize("keep", [(5, None), (None, 6), (5, 6)])
def test_keep_crops_after_the_bias(keep):
    x, w, b = torch.randn(2, 3, 8, 8), torch.randn(4, 3, 2, 3), torch.randn(4)
    want = F.conv2d(x, w, b, padding=(1, 1))[:, :, :keep[0], :keep[1]]
    assert torch.equal(conv.conv2d(x, w, b, padding=(1, 1), keep=keep), want)


SHAPES = sorted({bench.gemm_shape(spec, batch)
                 for convs, batches in ((bench.VQVAE_CONVS, bench.VQVAE_BATCHES + (8,)),
                                        (bench.PRIOR_CONVS, (bench.PRIOR_BATCH, 8)))
                 for spec in convs.values() for batch in batches} | {(3, 5, 7), (200, 300, 31)})


@pytest.mark.parametrize("mnk", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plan_is_a_pure_function_of_the_shape(mnk):
    """S >= 1 slices of whole chunks that cover K with none empty, groups that
    cover the slices, a tile the kernel instantiates inside 227 KB of shared
    memory, and the same plan on every call."""
    m, n, k = mnk
    p = conv_wgrad.plan(m, n, k)
    conv_wgrad.plan.cache_clear()
    assert conv_wgrad.plan(m, n, k) == p
    assert (p.bm, p.bn) in conv_wgrad.TILES
    assert conv_wgrad.smem_bytes(p.bm, p.bn) <= 232_448
    assert p.slices >= 1 and p.k_slice % conv_wgrad.CHUNK == 0
    assert p.k_slice * p.slices >= k > p.k_slice * (p.slices - 1)
    assert p.groups == -(-p.slices // p.group_size) and p.group_size <= max(1, p.slices)
    floats, counters = conv_wgrad.workspace_floats(p, m, n)
    tiles = -(-m // p.bm) * -(-n // p.bn)
    assert (floats, counters) == ((0, 0) if p.slices == 1 else
                                  ((p.slices + p.groups) * tiles * p.bm * p.bn, tiles * (p.groups + 1)))
    if tiles * p.slices > 1:
        assert tiles * p.slices <= conv_wgrad.SMS * conv_wgrad.blocks_per_sm(p.bm, p.bn)


def test_kernel_wrapper_refuses_cpu_tensors():
    before = conv_wgrad.launches
    with pytest.raises(ValueError, match="CUDA"):
        conv_wgrad.weight_grad(torch.randn(2, 4, 8, 8), torch.randn(2, 3, 8, 8), 3, 3, 1, 1)
    assert conv_wgrad.launches == before


# -- on the card ---------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card with -m gpu")
    return torch.device("cuda")


def _kernel_operands(spec, batch, dev, seed):
    x, _w, dy = _operands(spec, batch, seed=seed, device=dev)
    full = _full(dy, spec, x)
    return (x, full) if spec[4] else (full, x)


# ragged edges: tiles, windows and chunks that do not divide, strides and
# paddings that differ by axis, a crop of both axes
RAGGED = {
    "ragged.conv": (((3, 13, 11), (7, 3, 3, 5), (2, 1), (1, 2), False, (None, None), 1), 5),
    "ragged.convt": (((6, 7, 9), (6, 5, 4, 3), 2, (1, 0), True, (None, None), 1), 5),
    "ragged.crop": (((33, 9, 10), (130, 33, 3, 4), 1, (2, 3), False, (6, 7), 1), 37),
}
CARD_CONVS = {**CONVS, **RAGGED,
              **{f"vqvae.{k}@512": (v, 512) for k, v in bench.VQVAE_CONVS.items()}}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CARD_CONVS))
def test_kernel_against_the_plain_version_in_float64(name):
    dev = _card()
    spec, batch = CARD_CONVS[name]
    a, b = _kernel_operands(spec, batch, dev, seed=3)
    got = bench.kernel(a, b, spec).double()
    want = bench.plain(a.double(), b.double(), spec)
    p = conv_wgrad.plan(*bench.gemm_shape(spec, batch))
    assert ((got - want).abs() <= bench.bound(a, b, spec, p)).all()


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CONVS))
def test_kernel_repeats_bit_for_bit_while_another_stream_runs(name):
    """Two calls give the same bits, and so does a third while a second stream
    keeps SMs busy, so that the blocks finish in another order."""
    dev = _card()
    spec, batch = CONVS[name]
    a, b = _kernel_operands(spec, batch, dev, seed=4)
    call = lambda: bench.kernel(a, b, spec)  # noqa: E731
    first, second = call(), call()
    side, big = torch.cuda.Stream(), torch.randn(4096, 4096, device=dev)
    with torch.cuda.stream(side):
        for _ in range(4):
            big = big @ big.t() * 1e-3
    third = call()
    torch.cuda.synchronize()
    assert torch.equal(first, second) and torch.equal(first, third)


def _vqvae_trainer(dev):
    from vqvae_tpu_torch.train.vqvae_train import VQVAETrainer

    data = np.random.default_rng(0).uniform(-1, 1, (512, 32, 32, 3)).astype(np.float32)
    trainer = VQVAETrainer(VQVAEConfig(), TrainConfig(batch_size=256), device=dev)
    trainer.stage_dataset(data)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    return trainer, state, trainer._device_data[:256]


def _prior_trainer(dev):
    from vqvae_tpu_torch.train.pixelcnn_train import PixelCNNTrainer

    trainer = PixelCNNTrainer(PixelCNNConfig(), TrainConfig(batch_size=1024), device=dev)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 512, (1024, 8, 8))).to(dev)
    label = torch.from_numpy(rng.integers(0, 10, 1024)).to(dev)
    return trainer, state, (x, label)


TRAINERS = {"vqvae_b256": (_vqvae_trainer, 15), "prior_b1024": (_prior_trainer, 62)}


@pytest.mark.gpu
@pytest.mark.parametrize("model", sorted(TRAINERS))
def test_an_update_launches_the_kernel_once_a_convolution_without_a_sync(model):
    """After a warm-up update, a whole update under
    ``set_sync_debug_mode("error")`` (no host-device synchronisation) launches
    the kernel once for each training convolution and leaves cuDNN none."""
    dev = _card()
    make, convs = TRAINERS[model]
    trainer, state, batch = make(dev)
    update = (lambda: trainer._update(state, batch)) if model.startswith("vqvae") else \
        (lambda: trainer._update(state, *batch))
    update()
    torch.cuda.synchronize()
    conv_wgrad.reset_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        update()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert conv_wgrad.launches == convs and conv_wgrad.fallbacks == 0


def test_sweep_ablations_apply_to_the_shipped_source():
    """``bench/conv_wgrad.py ablate`` times copies of the source with parts
    taken out by text replacement: each must still match it exactly once."""
    source = bench.SOURCE.read_text()
    assert bench.ABLATIONS["shipped"] == []
    for name, edits in bench.ABLATIONS.items():
        for old, new in edits:
            assert source.count(old) == 1 and old != new, name
