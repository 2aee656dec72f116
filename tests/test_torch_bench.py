"""The port's benchmark (``vqvae_tpu_torch/bench``, ``cli.py benchmark``) on
the CPU at small widths.

- the unit of work of ``bench.py`` (encode, then quantize's indices) on
  weights carried from a JAX ``VQVAE`` gives the JAX package's indices;
- the FLOP counts the rows divide by are the JAX formulas';
- ``benchmark --device cpu`` prints one JSON line with ``bench.py``'s keys,
  ``"device": "cpu"`` and no device metric; without a card and without
  ``--device cpu`` it raises;
- the train benches stage their data once and advance one state from
  window to window; the sampler's schemes draw the same grids; the serve
  bench answers every request; the quantizer bench keeps the JAX tool's
  configs and names the route the dispatch gives.

JAX and the JAX package's tools are imported inside the tests that hold the
port against them, so that the ``gpu`` test runs on the card with
``python -m pytest --noconftest -m gpu tests/test_torch_bench.py``.
"""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vqvae_tpu_torch import cli
from vqvae_tpu_torch.bench import encode, prior as prior_bench, quantizer as quantizer_bench
from vqvae_tpu_torch.bench import sampler as sampler_bench, serve as serve_bench, timing
from vqvae_tpu_torch.bench import train as train_bench
from vqvae_tpu_torch.config import PixelCNNConfig, TrainConfig, VQVAEConfig
from vqvae_tpu_torch.ops import cuda_quantizer
from vqvae_tpu_torch.ops.quantizer import compare_assignments, nearest_code_torch
from vqvae_tpu_torch.train.pixelcnn_train import PixelCNNTrainer
from vqvae_tpu_torch.train.vqvae_train import VQVAETrainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(n_hiddens=16, n_residual_hiddens=8, embedding_dim=16, n_embeddings=64)
SMALL_FLAGS = ["--n_hiddens", "16", "--n_residual_hiddens", "8", "--embedding_dim", "16",
               "--n_embeddings", "64"]
PRIOR_SMALL = PixelCNNConfig(input_dim=16, dim=16, n_layers=2, img_dim=4)
TOOLS = ("train", "prior", "quantizer", "sampler", "serve")


def _bench_py_keys() -> set:
    """The keys bench.py's ``main`` writes into its line: the ``out`` dict's
    and every ``out[...] =`` (read from its source, which imports JAX)."""
    tree = ast.parse(open(os.path.join(ROOT, "bench.py")).read())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    keys = set()
    for node in ast.walk(main):
        if isinstance(node, ast.Assign) and any(isinstance(t, ast.Name) and t.id == "out"
                                                for t in node.targets):
            keys |= {k.value for k in node.value.keys}
        if isinstance(node, ast.Subscript) and isinstance(node.value, ast.Name) \
                and node.value.id == "out" and isinstance(node.ctx, ast.Store):
            keys.add(node.slice.value)
    return keys


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_encode_quantize_equals_bench_py_unit(precision):
    """bench.py's encode_quantize (JAX ``encode`` then ``quantize``) and the
    port's on the same carried weights and seeded images. The convs run in
    fp32: XLA and torch round bf16 convs at different places (the e2e_r5
    bounds of test_torch_models.py), which would hide the search's parity."""
    import jax
    import jax.numpy as jnp

    from vqvae_tpu.config import VQVAEConfig as JaxConfig
    from vqvae_tpu.models.vqvae import VQVAE as JaxVQVAE
    from vqvae_tpu_torch.models.vqvae import VQVAE
    from vqvae_tpu_torch.train.checkpoint import params_from_jax

    x = np.random.default_rng(5).standard_normal((8, 32, 32, 3)).astype(np.float32)
    jm = JaxVQVAE(JaxConfig(**SMALL, quantizer_precision=precision))
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x[:1]))["params"]
    z_e = jm.apply({"params": params}, jnp.asarray(x), method=jm.encode)
    want = np.asarray(jm.apply({"params": params}, z_e, method=jm.quantize).indices)

    model = VQVAE(VQVAEConfig(**SMALL, quantizer_precision=precision))
    model.load_state_dict(params_from_jax(params))
    got = encode.encode_quantize(model.eval(), torch.from_numpy(x))
    assert got.dtype == torch.int32 and got.shape == want.shape == (8, 8, 8)
    if precision == "highest":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        with torch.no_grad():
            z = model.encode(torch.from_numpy(x)).reshape(-1, 16)
        mism, near, gap = compare_assignments(z, model.codebook.detach(), got.reshape(-1),
                                              torch.from_numpy(want.reshape(-1).copy()), precision)
        assert mism == near, f"{mism - near} mismatches are not near-ties (gap {gap})"


@pytest.mark.parametrize("name", ["encode", "train", "prior"])
def test_flop_counts_equal_the_jax_formulas_at_full_width(name):
    from vqvae_tpu.utils import flops as jax_flops

    ours, theirs = {
        "encode": (encode.flops_per_image(VQVAEConfig()), jax_flops.encode_quantize_flops_per_image()),
        "train": (train_bench.flops_per_image(VQVAEConfig()), jax_flops.train_step_flops_per_image()),
        "prior": (prior_bench.flops_per_grid(PixelCNNConfig()),
                  jax_flops.pixelcnn_train_step_flops_per_grid()),
    }[name]
    assert ours == theirs and ours > 0


def test_benchmark_cli_on_the_cpu_prints_one_line():
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "vqvae_tpu_torch.cli", "benchmark", "--device", "cpu", *SMALL_FLAGS,
         "--iters_lo", "1", "--iters_hi", "2", "--repeats", "1"],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1, proc.stdout
    line = json.loads(lines[0])
    assert (_bench_py_keys() - {"train_source"}) | {"device"} <= set(line)
    assert line["metric"] == "cifar10_encode_quantize_images_per_sec_per_chip"
    assert line["device"] == "cpu" and line["chip"] == "cpu"
    for key in ("mfu", "serving_mfu", "train_mfu_b256", "device_ms_per_batch", "busy_share"):
        assert line[key] is None, key
    for key in ("value", "serving_value", "train_images_per_sec_per_chip_b256",
                "train_bf16_images_per_sec_per_chip_b256"):
        assert np.isfinite(line[key]) and line[key] > 0, key
    assert line["flops_per_image"] == encode.flops_per_image(VQVAEConfig(**SMALL))


def test_benchmark_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["benchmark", *SMALL_FLAGS])


def _count_calls(monkeypatch, cls, name):
    calls = []
    orig = getattr(cls, name)

    def counted(self, *a, **kw):
        calls.append(1)
        return orig(self, *a, **kw)

    monkeypatch.setattr(cls, name, counted)
    return calls


def _keep_made(monkeypatch, module):
    made = []
    orig = module.staged_steps

    def keep(*a, **kw):
        made.append(orig(*a, **kw))
        return made[-1]

    monkeypatch.setattr(module, "staged_steps", keep)
    return made


def _same_tensors(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def _optimizer_tensors(opt) -> dict:
    return {f"{i}.{k}": v for i, st in enumerate(opt.state.values()) for k, v in st.items()
            if isinstance(v, torch.Tensor)}


def test_train_bench_stages_once_and_advances_one_state(monkeypatch):
    staged = _count_calls(monkeypatch, VQVAETrainer, "stage_dataset")
    made = _keep_made(monkeypatch, train_bench)
    row = train_bench.bench_batch(4, device="cpu", base=VQVAEConfig(**SMALL), windows=(1, 3), repeats=2)
    assert len(staged) == 1 and len(made) == 1
    run = made[0]
    assert run.log[:2] == [1, 3] and len(run.log) >= 6 and run.state.step == sum(run.log)
    assert row["step_ms"] > 0 and row["train_mfu"] is None and row["device"] == "cpu"

    # the same index sequence through steps_by_index called directly
    cfg = train_bench.step_config(VQVAEConfig(**SMALL), "highest", "float32", False)
    trainer = VQVAETrainer(cfg, TrainConfig(batch_size=4, seed=0), x_train_var=1.0, device="cpu")
    gen = torch.Generator().manual_seed(0)
    trainer.stage_dataset(torch.randn((3 * 4, 32, 32, 3), generator=gen))
    state = trainer.init_state()
    for k in run.log:
        state, _ = trainer.steps_by_index(state, run.idx[:k])
    assert _same_tensors(dict(state.model.state_dict()), dict(run.state.model.state_dict()))
    assert _same_tensors(_optimizer_tensors(state.optimizer), _optimizer_tensors(run.state.optimizer))


def test_prior_bench_stages_once_and_advances_one_state(monkeypatch):
    staged = _count_calls(monkeypatch, PixelCNNTrainer, "stage_dataset")
    made = _keep_made(monkeypatch, prior_bench)
    row = prior_bench.bench_batch(4, device="cpu", base=PRIOR_SMALL, windows=(1, 3), repeats=2)
    assert len(staged) == 1 and len(made) == 1
    run = made[0]
    assert run.log[:2] == [1, 3] and len(run.log) >= 6 and run.state.step == sum(run.log)
    assert row["grids_per_sec_per_chip"] > 0 and row["train_mfu"] is None

    trainer = PixelCNNTrainer(PRIOR_SMALL, TrainConfig(batch_size=4, seed=0), device="cpu")
    gen = torch.Generator().manual_seed(0)
    grids = torch.randint(0, 16, (12, 4, 4), generator=gen)
    labels = torch.randint(0, 10, (12,), generator=gen)
    from vqvae_tpu_torch.data.datasets import ArrayDataset

    trainer.stage_dataset(ArrayDataset(grids, labels), ArrayDataset(grids, labels))
    state = trainer.init_state()
    for k in run.log:
        state, _ = trainer.steps_by_index(state, run.idx[:k])
    assert _same_tensors(dict(state.model.state_dict()), dict(run.state.model.state_dict()))
    assert _same_tensors(_optimizer_tensors(state.optimizer), _optimizer_tensors(run.state.optimizer))


def test_sampler_schemes_draw_the_same_grids():
    model = sampler_bench.make_prior(PRIOR_SMALL, torch.device("cpu"), seed=0)
    labels = torch.arange(6) % 10
    drawn = {}
    for name, fn in sampler_bench.schemes(model, include_band=True).items():
        with torch.inference_mode():
            drawn[name] = fn(labels, torch.Generator().manual_seed(3), (4, 4), 6)
    assert set(drawn) == {"naive_full_forward", "cached_incremental_full", "cached_incremental_band"}
    first = drawn["naive_full_forward"]
    assert first.shape == (6, 4, 4) and int(first.max()) < 16
    for name, grids in drawn.items():
        assert torch.equal(grids, first), name
    row = sampler_bench.bench(6, side=4, repeats=1, device="cpu", cfg=PRIOR_SMALL)
    assert row["speedup"] > 0 and row["cached_incremental"]["grids_differing"] == 0


def test_serve_bench_answers_every_request():
    row = serve_bench.run_bench(wave_batch=8, n_clients=2, requests_per_client=3,
                                mixed_sizes=(1, 5, 9), decode_every=2, prior_layers=2,
                                device="cpu", prior_cfg=PRIOR_SMALL.replace(img_dim=8),
                                vq_cfg=VQVAEConfig(**SMALL))
    assert row["requests"] == 6 and row["waves"] >= 1
    assert 0 < row["latency_p50_ms"] <= row["latency_p99_ms"]
    assert 0 < row["wave_occupancy"] <= 1 and row["grids_per_sec"] > 0
    assert row["latency_decode_p50_ms"] is not None and row["device"] == "cpu"


def test_serve_bench_fails_when_a_request_fails(monkeypatch):
    """A client that dies fails the bench; it does not shrink the sample."""
    def refuse(*a, **kw):
        raise ConnectionError("dropped")

    orig = serve_bench.one_request
    calls = []

    def flaky(conn, label, n, decode, image_format="b64_u8"):
        calls.append(n)
        if len(calls) == 4:  # the second timed request
            refuse()
        return orig(conn, label, n, decode, image_format)

    monkeypatch.setattr(serve_bench, "one_request", flaky)
    with pytest.raises(RuntimeError, match="requests answered"):
        serve_bench.run_bench(wave_batch=4, n_clients=1, requests_per_client=3, mixed_sizes=(1, 2),
                              decode_every=0, prior_layers=2, device="cpu",
                              prior_cfg=PRIOR_SMALL, vq_cfg=VQVAEConfig(**SMALL))


def test_quantizer_configs_are_the_jax_tools():
    from tools.bench_quantizer import CONFIGS

    assert quantizer_bench.CONFIGS == CONFIGS


@pytest.mark.parametrize("mode", ["highest", "high", "default"])
@pytest.mark.parametrize("d", [16, 256])
def test_quantizer_rows_name_the_dispatched_route(monkeypatch, mode, d):
    """On the CPU the kernels' launcher is replaced by the plain version,
    counted by route, and the host clock is passed explicitly."""
    seen = []

    def plain(z, cb, precision, route=None):
        seen.append(route)
        return nearest_code_torch(z, cb, precision)[1]

    monkeypatch.setattr(cuda_quantizer, "nearest_code_indices", plain)
    timer = lambda fn: timing.host_ms(fn, iters=2, warmup=1)  # noqa: E731
    row = quantizer_bench.run("default", mode, "cpu", timer=timer, shape=(64, 32, d))
    picked = cuda_quantizer.kernel_route(mode, d)
    assert row["route"] == picked and list(row["route_ms"])[0] == picked
    assert set(row["route_ms"]) == ({"mma", "fma"} if picked == "mma" else {"fma"})
    assert set(seen) == set(row["route_ms"])
    assert (row["bound_ms"], row["bound_by"]) == quantizer_bench.bound(64, 32, d, mode)
    assert row["timer"] == "host clock" and row["device"] == "cpu"


@pytest.mark.parametrize("tool", TOOLS)
def test_tools_write_no_file_by_default(monkeypatch, tool):
    """``--out`` has no default: the JAX package's artifacts/ stay untouched."""
    import argparse
    import importlib

    module = importlib.import_module(f"vqvae_tpu_torch.bench.{tool}")
    parse, seen = argparse.ArgumentParser.parse_args, {}

    def capture(self, argv=None, namespace=None):
        seen["out"] = parse(self, argv, namespace).out
        raise KeyboardInterrupt  # stop before anything is measured

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(KeyboardInterrupt):
        module.main([])
    assert seen == {"out": None}


@pytest.mark.gpu
def test_benchmark_on_the_card():
    """The one line at small windows on the card: the card named, every MFU
    at most 1.05, both kernels launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from vqvae_tpu_torch.bench import run

    cuda_quantizer.reset_launch_counts()
    line = run(None, "cuda", iters_lo=2, iters_hi=6, repeats=1)
    assert torch.cuda.get_device_name(0) in line["device"]
    for key in ("mfu", "serving_mfu", "train_mfu_b256"):
        assert 0 < line[key] <= 1.05, key
    assert cuda_quantizer.launches_by_route["fma"] > 0 and cuda_quantizer.launches_by_route["mma"] > 0
