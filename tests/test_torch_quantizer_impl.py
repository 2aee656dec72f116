"""The config's ``quantizer_impl`` chooses the nearest-code search's forward
(``ops/quantizer.py``), as the JAX ``_dispatch_forward`` does: on the card
"pallas" launches the hand-written kernel, "jnp" runs the matmul branch
(``nearest_code_matmul``) and "auto" takes what ``_auto_impl``'s measured
rule says for the shape and mode; on the CPU every value takes the plain
version.

On the CPU the dispatch is driven as on the card with a CPU tensor that
reports lying on the card (``_OnCard``), the kernels' launcher
(``cuda_quantizer.nearest_code_cuda``) replaced by the plain version, counted
by route, and the matmul branch counted. The value must reach that dispatch
through ``VQVAE.quantize``, the trainer and the CLI; unknown values are
refused with the flag named. A checkpoint keeps its stored value in its
hyperparameters, but the loaded model searches as the caller asks ("auto" by
default), as the JAX CLI's ``_vqvae_cfg_for_checkpoint`` loads it. The
card's own case is
``tests/test_torch_cuda_kernel.py::test_jnp_launches_no_kernel_on_card``.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import pytest
import torch

from vqvae_tpu_torch import cli
from vqvae_tpu_torch.config import QUANTIZER_IMPLS, TrainConfig, VQVAEConfig
from vqvae_tpu_torch.models.vqvae import VQVAE
from vqvae_tpu_torch.ops import cuda_quantizer, quantizer
from vqvae_tpu_torch.train.vqvae_train import VQVAETrainer

TINY = dict(n_hiddens=16, n_residual_hiddens=8, embedding_dim=16, n_embeddings=64)
# a swept shape on each side of "auto"'s rule: (shape, mode, what the rule says)
AUTO_SHAPES = [((16_384, 512, 64), "highest", "pallas"), ((2048, 8192, 256), "highest", "jnp")]
TINY_FLAGS = ["--n_hiddens", "16", "--n_residual_hiddens", "8", "--embedding_dim", "16",
              "--n_embeddings", "64"]


class _OnCard(torch.Tensor):
    """A CPU tensor that reports lying on the card."""

    @property
    def is_cuda(self):
        return True


@pytest.fixture
def card(monkeypatch):
    """(impl of every dispatch, route of every launch, rows of every call of
    the matmul branch): the dispatch spied on, the launcher the counted plain
    version, the branch counted."""
    seen, launched, branched = [], [], []
    dispatch, branch = quantizer._search_forward, quantizer.nearest_code_matmul

    def spy(z_flat, codebook, precision, impl):
        seen.append(impl)
        return dispatch(z_flat, codebook, precision, impl)

    def launcher(z_flat, codebook, precision="highest", route=None):
        launched.append(cuda_quantizer.kernel_route(precision, z_flat.shape[1]))
        return quantizer.nearest_code_torch(z_flat, codebook, precision)

    def counted_branch(z_flat, codebook, precision="highest"):
        branched.append(z_flat.shape[0])
        return branch(z_flat, codebook, precision)

    monkeypatch.setattr(quantizer, "_search_forward", spy)
    monkeypatch.setattr(cuda_quantizer, "nearest_code_cuda", launcher)
    monkeypatch.setattr(quantizer, "nearest_code_matmul", counted_branch)
    return seen, launched, branched


def _on_card(impl, n, k, d, precision="highest"):
    """What the dispatch does on the card: "pallas" (the kernel) or "jnp"."""
    return quantizer._auto_impl(n, k, d, precision, True) if impl == "auto" else impl


def _latents(seed=0, d=16, k=64):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((2, 4, 4, d)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((k, d)).astype(np.float32)))


def _search(impl):
    return partial(quantizer.nearest_code, impl=impl)


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("impl", QUANTIZER_IMPLS)
def test_dispatch_on_the_card(card, impl, precision):
    """"pallas" launches the route ``kernel_route`` picks, once; "jnp" runs the
    matmul branch and launches nothing; "auto" does what ``_auto_impl`` says
    for the shape. The codes are the plain version's, near-ties aside."""
    seen, launched, branched = card
    z, cb = _latents()
    q = quantizer.quantize(z.as_subclass(_OnCard), cb, 0.25, precision=precision, search=_search(impl))
    assert seen == [impl]
    kernel = _on_card(impl, 32, 64, 16, precision) == "pallas"
    assert launched == ([cuda_quantizer.kernel_route(precision, 16)] if kernel else [])
    assert branched == ([] if kernel else [32])
    _zq, idx = quantizer.nearest_code_torch(z.reshape(-1, 16), cb, precision)
    mism, near, _gap = quantizer.compare_assignments(z.reshape(-1, 16), cb, q.indices.reshape(-1), idx,
                                                     precision)
    assert mism == near


@pytest.mark.parametrize(("shape", "precision", "want"), AUTO_SHAPES)
def test_auto_goes_where_the_rule_says(card, shape, precision, want):
    """"auto" on the card at a swept shape on each side of the rule: the
    branch where it measured faster, the kernel elsewhere."""
    seen, launched, branched = card
    n, k, d = shape
    assert quantizer._auto_impl(n, k, d, precision, True) == want
    rng = np.random.default_rng(6)
    z = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    cb = torch.from_numpy(rng.standard_normal((k, d)).astype(np.float32))
    _zq, idx = quantizer.nearest_code(z.as_subclass(_OnCard), cb, precision, impl="auto")
    assert seen == ["auto"]
    assert launched == ([cuda_quantizer.kernel_route(precision, d)] if want == "pallas" else [])
    assert branched == ([] if want == "pallas" else [n])


def test_auto_shapes_go_both_ways():
    assert {want for _shape, _precision, want in AUTO_SHAPES} == {"jnp", "pallas"}


def test_jnp_on_the_card_is_the_matmul_branch(monkeypatch):
    """On the card "jnp" runs ``nearest_code_matmul``, not the plain version,
    which is the CPU's."""
    def refuse(*_a, **_k):
        raise AssertionError("jnp on the card reached the plain version")

    z, cb = _latents(7)
    want = quantizer.nearest_code_matmul(z.reshape(-1, 16), cb, "highest")
    monkeypatch.setattr(quantizer, "nearest_code_torch", refuse)
    zq, idx = quantizer.nearest_code(z.reshape(-1, 16).as_subclass(_OnCard), cb, impl="jnp")
    assert torch.equal(idx, want[1]) and torch.equal(zq.as_subclass(torch.Tensor), want[0])


def test_jnp_never_calls_the_launcher(monkeypatch):
    """Under "jnp" the launcher is not reached, on the card as on the CPU, and
    the codebook still gets its scatter-add gradient."""
    def refuse(*_a, **_k):
        raise AssertionError("jnp reached the kernel launcher")

    monkeypatch.setattr(cuda_quantizer, "nearest_code_cuda", refuse)
    monkeypatch.setattr(cuda_quantizer, "nearest_code_indices", refuse)
    z, cb = _latents(1)
    cb.requires_grad_(True)
    for zz in (z, z.as_subclass(_OnCard)):
        before = cuda_quantizer.launches
        q = quantizer.quantize(zz, cb, 0.25, search=_search("jnp"))
        q.loss.backward()
        assert cuda_quantizer.launches == before
        assert cb.grad is not None and torch.isfinite(cb.grad).all()
        cb.grad = None


def test_on_the_cpu_every_impl_is_the_plain_version(monkeypatch):
    """CPU tensors never reach the launcher nor the matmul branch, whatever
    the value."""
    def refuse(*_a, **_k):
        raise AssertionError("a CPU tensor reached the kernel launcher")

    monkeypatch.setattr(cuda_quantizer, "nearest_code_cuda", refuse)
    monkeypatch.setattr(quantizer, "nearest_code_matmul", refuse)
    z, cb = _latents(2)
    outs = [quantizer.quantize(z, cb, 0.25, search=_search(impl)) for impl in QUANTIZER_IMPLS]
    for q in outs[1:]:
        assert torch.equal(q.indices, outs[0].indices) and torch.equal(q.z_q, outs[0].z_q)


@pytest.mark.parametrize("impl", QUANTIZER_IMPLS)
def test_impl_reaches_the_dispatch_through_the_model(card, impl):
    seen, launched, branched = card
    model = VQVAE(VQVAEConfig(**TINY, quantizer_impl=impl))
    model.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 32, 32, 3)).astype(np.float32))
    model.codes(x)
    assert seen == [impl] and launched == [] and branched == []  # a CPU tensor takes the plain version
    model.codes(x.as_subclass(_OnCard))
    kernel = _on_card(impl, 128, 64, 16) == "pallas"
    assert seen == [impl] * 2 and len(launched) == int(kernel) and len(branched) == int(not kernel)


@pytest.mark.parametrize("impl", QUANTIZER_IMPLS)
def test_impl_reaches_the_dispatch_through_the_trainer(card, impl):
    seen, launched, _branched = card
    trainer = VQVAETrainer(VQVAEConfig(**TINY, quantizer_impl=impl), TrainConfig(batch_size=4),
                           device="cpu")
    state = trainer.init_state()
    x = np.random.default_rng(4).standard_normal((3, 4, 32, 32, 3)).astype(np.float32)
    trainer.steps(state, x)
    assert seen == [impl] * 3 and launched == []


@pytest.mark.parametrize("impl", QUANTIZER_IMPLS)
def test_impl_reaches_the_dispatch_through_the_cli(card, impl, tmp_path):
    seen, launched, _branched = card
    rc = cli.main(["train-vqvae", "--n_updates", "2", "--batch_size", "4", "--log_interval", "1",
                   "--quantizer_impl", impl, "--data_dir", str(tmp_path / "data"), "--device", "cpu",
                   *TINY_FLAGS])
    assert rc == 0
    assert seen == [impl] * 2 and launched == []


def test_unknown_impl_is_refused_naming_the_flag(capsys):
    z, cb = _latents(5)
    with pytest.raises(ValueError, match="quantizer_impl"):
        VQVAEConfig(quantizer_impl="xla")
    with pytest.raises(ValueError, match="quantizer_impl"):
        quantizer.quantize(z, cb, 0.25, search=_search("xla"))
    with pytest.raises(ValueError, match="quantizer_impl"):
        quantizer.nearest_code(z.reshape(-1, 16), cb, impl="xla")
    with pytest.raises(SystemExit):
        cli.main(["train-vqvae", "--quantizer_impl", "xla", "--device", "cpu"])
    assert "--quantizer_impl" in capsys.readouterr().err


def test_a_jax_checkpoint_keeps_its_impl(card, tmp_path, monkeypatch):
    """A checkpoint the JAX package wrote with quantizer_impl="jnp" loads in
    the port with that value in its hyperparameters; the loaded model
    searches by "auto"'s rule on the card unless the caller asks for "jnp",
    and the CLI's load commands pass their ``--quantizer_impl``."""
    from vqvae_tpu.config import TrainConfig as JaxTrainConfig
    from vqvae_tpu.config import VQVAEConfig as JaxVQVAEConfig
    from vqvae_tpu.train.checkpoint import save_checkpoint
    from vqvae_tpu.train.vqvae_train import VQVAETrainer as JaxVQVAETrainer

    from vqvae_tpu_torch.pipelines.viz import load_model

    seen, launched, branched = card
    jax_cfg = JaxVQVAEConfig(**TINY, quantizer_impl="jnp")
    path = str(tmp_path / "vqvae.npz")
    save_checkpoint(path, JaxVQVAETrainer(jax_cfg, JaxTrainConfig(seed=1)).init_state(), 3,
                    hyperparameters=jax_cfg.to_dict())
    model, _metrics, hp = load_model(path, device="cpu")
    assert hp["quantizer_impl"] == "jnp" and model.config.quantizer_impl == "auto"
    model.codes(torch.zeros(1, 32, 32, 3).as_subclass(_OnCard))
    auto = ["fma"] if _on_card("auto", 64, 64, 16) == "pallas" else []
    assert seen == ["auto"] and launched == auto and len(branched) == 1 - len(auto)
    model, _metrics, hp = load_model(path, device="cpu", quantizer_impl="jnp")
    assert hp["quantizer_impl"] == "jnp" and model.config.quantizer_impl == "jnp"
    model.codes(torch.zeros(1, 32, 32, 3).as_subclass(_OnCard))
    assert seen == ["auto", "jnp"] and launched == auto and len(branched) == 2 - len(auto)

    import vqvae_tpu_torch.pipelines.viz as viz

    asked = []

    def load(checkpoint, device="cuda", fallback_cfg=None, quantizer_impl="auto"):
        asked.append(quantizer_impl)
        raise StopIteration

    monkeypatch.setattr(viz, "load_model", load)
    for argv in (["extract-latents", "--checkpoint", path], ["viz", "--checkpoint", path],
                 ["sample", "--vqvae-checkpoint", path, "--prior-checkpoint", path]):
        for impl in ("auto", "jnp"):
            with pytest.raises(StopIteration):
                cli.main([*argv, "--quantizer_impl", impl, "--device", "cpu"])
    assert asked == ["auto", "jnp"] * 3
