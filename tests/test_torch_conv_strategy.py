"""The space-to-depth lowering of the k4/s2 convs (``vqvae_tpu_torch/bench/conv_strategy.py``,
the port of ``tools/bench_conv_strategy.py``): the rewrite against torch's
strided conv and against the JAX tool's rewrite on the same numpy inputs."""

from __future__ import annotations

import functools
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vqvae_tpu_torch.bench import conv_strategy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_bench_conv_strategy", os.path.join(ROOT, "tools", "bench_conv_strategy.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(batch: int, c_in: int, hw: int, c_out: int = 32, seed: int = 0):
    """NHWC images and an HWIO kernel (the JAX layout) and a bias, from one numpy
    draw. The kernel is scaled by 1 / sqrt(fan-in), as a conv layer's weights
    are initialised, so the outputs are of order one and an absolute bound
    reads as a relative one."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, hw, hw, c_in)).astype(np.float32)
    w = (rng.normal(size=(4, 4, c_in, c_out)) / np.sqrt(16 * c_in)).astype(np.float32)
    b = rng.normal(size=(c_out,)).astype(np.float32)
    return x, w, b


def _torch(x, w, b):
    return (torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(),
            torch.from_numpy(w).permute(3, 2, 0, 1).contiguous(), torch.from_numpy(b))


@pytest.mark.parametrize("c_in,hw", [(3, 32), (64, 16)])
@pytest.mark.parametrize("batch", [1, 3])
def test_rewrite_equals_the_strided_conv(batch, c_in, hw):
    x, w, b = _torch(*_inputs(batch, c_in, hw))
    ref = F.conv2d(x, w, b, stride=2, padding=1)
    alt = conv_strategy.conv4s2_space_to_depth(x, w, b, precision="highest")
    assert alt.shape == ref.shape == (batch, 32, hw // 2, hw // 2)
    assert float((alt - ref).abs().max() / ref.abs().max()) < 1e-5


@pytest.mark.parametrize("c_in,hw", [(3, 32), (64, 16)])
@pytest.mark.parametrize("batch", [1, 3])
def test_rewrite_against_the_jax_tool(batch, c_in, hw):
    tool = _jax_tool()
    x, w, b = _inputs(batch, c_in, hw, seed=1)
    jax_out = np.asarray(tool.conv4s2_space_to_depth(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                                     precision="highest"))
    port = conv_strategy.conv4s2_space_to_depth(*_torch(x, w, b), precision="highest")
    np.testing.assert_allclose(port.permute(0, 2, 3, 1).numpy(), jax_out, atol=1e-5, rtol=0)


def test_check_exact_on_the_cpu():
    errors = conv_strategy.check_exact("cpu")
    assert set(errors) == {"c3_f64_hw32", "c64_f128_hw16"}
    assert all(0 <= e < conv_strategy.EXACT_REL_TOL for e in errors.values())


def test_main_writes_the_jax_tools_keys_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(conv_strategy, "bench",
                        functools.partial(conv_strategy.bench, iters_lo=1, iters_hi=2, repeats=1))
    out = tmp_path / "conv.json"
    assert conv_strategy.main(["--batch", "2", "--device", "cpu", "--out", str(out)]) == 0
    import json

    payload = json.load(open(out))
    # the JAX tool's payload keys, plus the exactness errors and the torch version
    assert {"experiment", "batch", "dtype", "backend", "device", "rows", "speedup_s2d"} <= set(payload)
    assert payload["device"] == payload["backend"] == "cpu" and payload["batch"] == 2
    for name in ("standard_k4s2", "space_to_depth_k2s1"):
        row = payload["rows"][name]
        assert row["us_per_call"] > 0 and row["eff_tflops"] > 0
        assert row["device_us_per_call"] is None  # no card: not measured
    assert payload["device_speedup_s2d"] is None and payload["speedup_s2d"] > 0
    assert conv_strategy.flops(256) == 2 * 256 * (16 * 16 * 64 * 48 + 8 * 8 * 128 * 1024)


def test_the_tool_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        conv_strategy.main([])
